// SAME 3x3 convolution, stride 1, NHWC float32, for Hopper (sm_90a): the
// forward with bias + activation, and the input gradient (dx) of the same
// conv, as one implicit GEMM on the tensor cores.
//
// Replaces the Pallas TPU kernel s2s_ismr_tpu/kernels/conv.py:_conv_kernel
// (called through _conv_call from the forward and from the custom VJP's dx).
//
//   forward:  out[m, o] = act(b[o] + sum_k A[m, k] * w[k, o])
//             A[m, k]   = x[n, h+dy-1, w+dx-1, c],  m = (n, h, w),
//                         k = (dy*3 + dx)*C + c   (zero outside the image)
//   dx mode:  dx[m, c]  = sum_k G[m, k] * w[2-dy, 2-dx, c, o],
//             G[m, k]   = g'[n, h+dy-1, w+dx-1, o], k = (dy*3 + dx)*O + o,
//             g' = g * ELU'(out) = g * (out > 0 ? 1 : out + 1) for an ELU
//             conv (read from the saved forward output), else g.
//
// What bounds it: at the U-Net's widths a call does at most ~85 MFLOP and
// moves at most a few MB, so the least time the card could take is 0.1-1.3
// us (f32 FLOP or bytes), below the ~1 us a trivial kernel takes to launch
// and end. A launch is latency-bound: its time is a fixed part (launch,
// prologue, first loads, epilogue), the serial chain of its K loop, and,
// on the large maps, the bytes its A loads read. Measured, and fitted as
// the wrapper's tile cost model, by kernels/conv_bench.py (PERF.md).
//
// Three tile families, picked per call by the wrapper (kernels/conv.py,
// _pick_tile: the least modelled time among the tiles whose preconditions
// hold), all in one launch per call:
//
//  gather  Implicit GEMM over flattened pixels: M = N*H*W rows (images and
//          rows share a tile, so a 4x4 map wastes no columns), the GEMM's
//          N = output channels, K = 9*Cin tap-major in chunks of 64. A is
//          gathered per tap from the NHWC input by cp.async straight into
//          shared memory (zfill gives the halo's zeros), the weight tile
//          likewise, in a ring of 2-3 stages (as deep as keeps two blocks
//          on an SM). 16-byte copies where Cin % 4 == 0, 4-byte otherwise.
//          Tiles BM x BN of 4 warps; small tiles let the warps split each
//          chunk and add their partial tiles in shared memory in a fixed
//          order. Every input pixel is read once per tap.
//  halo    For maps 8 to BM wide and at most CK (16-32) staged channels:
//          the U-Net's top levels, where each pixel's 9 gathers dominated.
//          A block owns R = BM / W whole image rows of one image (R*W GEMM
//          rows of its BM, the rest masked) and BN output channels. It
//          stages the (R+2) x (W+2) halo box of its input in shared memory
//          once, and all nine taps read it at shifted offsets, so each
//          pixel is read (R+2)(W+2)/(R*W) times per n-tile, not 9. The box
//          is loaded by the Tensor Memory Accelerator where the staged
//          channel count is a multiple of 4 (a tiled tensor map over the
//          NHWC tensor, 5-D with the lane as its outer dimension; start
//          coordinates (0, -1, h0-1, n): the out-of-bounds zero fill is
//          the SAME padding), completing on an mbarrier while the block
//          stages the weights; elsewhere by 4-byte cp.async. The dx mode of
//          an ELU conv stages
//          g and the saved output and turns the box into g' = g * ELU'(out)
//          once per staged pixel. Products by wgmma (m64nBNk8, TF32, A from
//          registers: each thread reads its fragment at the tap's offset in
//          the box, so the im2col happens in registers; B from shared
//          memory, hi and lo tiles in the K-major core-matrix layout).
//  halo_mma The same halo tile with mma.sync m16n8k8 products, read from
//          the same registers and B tiles: the yardstick of the wgmma body.
//  split   For small M and large K (M <= 128, K >= 576: the deep U-Net
//          bottlenecks, 1x1 to 4x4 maps). A cluster of S blocks shares one
//          gather tile; rank r walks its 1/S of the K chunks. The partial
//          tiles are reduced through distributed shared memory in rank
//          order, each rank reducing and storing a slice of the tile (bias
//          and ELU once per element). No atomics, no second pass.
//
// Shared by all:
//  - 3xTF32 (a = a_hi + a_lo; acc += a_lo*b_hi + a_hi*b_lo + a_hi*b_hi), so
//    the error stays at the f32 level (rtol 1e-4 / atol 1e-5 against
//    float64). Each chunk's products are summed in fresh accumulators and
//    then added, round-to-nearest, into the f32 total; a small tile gives
//    each of the three terms its own accumulator (three short chains).
//  - Deterministic sums: every reduction runs in a fixed order, so a launch
//    sums in the same order every time (a winner reloaded from disk
//    replays its predictions bit for bit).
//  - The dx mode reads the adjoint itself: tap (dy, dx) of the adjoint is
//    w[2-dy][2-dx][c][o], read from the forward's (3,3,C,O) weights with O
//    as the reduction; no flipped or transposed copy is made. The blocks
//    of the first output-channel tile write g' once per pixel, for dw and
//    db.
//  - Lane mode: the counterpart of the Pallas kernel under jax.vmap. The
//    lane is the grid's z axis; every operand has a lane stride in floats
//    (64-bit), 0 for an operand all lanes share. A block reads its lane's
//    operands at an offset and does exactly the work of a one-lane launch
//    of that lane, so with the same tile lane i is bit for bit the
//    one-lane result. Limits hold per lane.
//
// The kernel allocates nothing and runs on the caller's stream. The C entry
// points return a CUDA error code (a refused launch, a tile whose
// preconditions fail, a tensor map that does not encode) so the caller can
// raise. The tensor maps are encoded on the host per launch through the
// driver entry point cuTensorMapEncodeTiled (the library links only the
// runtime) and passed as __grid_constant__ parameters; a map holds its
// tensor's address, so a launch captured in a CUDA graph replays on the
// same buffers.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;          // 4 warps: one warpgroup
constexpr int kBK = 64;                // k values per chunk (conv.py, _BK)
constexpr int kMaxStages = 3;          // cp.async ring depth, at most
constexpr int kQuads = kBK / 4;        // 16-byte quads per chunk row
constexpr int kRowStride = kBK + 4;    // smem floats per A row / dx-B row
constexpr int kHaloBlocks = 4;         // halo blocks per SM, registers
constexpr int kHaloSmem = 200 * 1024;  // halo tiles' dynamic smem, at most
constexpr int kMaxDevices = 64;

enum Family { kGather = 0, kHalo = 1, kHaloMma = 2, kSplit = 3 };

// tile table: family, BM, BN, WM x WN warps over the tile (the rest split
// each K chunk; halo tiles: 4 x 1), cluster size S of a split tile
struct Tile { int family, bm, bn, wm, wn, split; };
constexpr Tile kTiles[] = {
    {kGather, 64, 8, 4, 1, 1},     // 0: warp 16x8
    {kGather, 16, 8, 1, 1, 1},     // 1: warp 16x8, K split 4
    {kGather, 64, 16, 4, 1, 1},    // 2: warp 16x16
    {kGather, 32, 16, 2, 1, 1},    // 3: warp 16x16, K split 2
    {kGather, 16, 16, 1, 1, 1},    // 4: warp 16x16, K split 4
    {kGather, 64, 32, 2, 2, 1},    // 5: warp 32x16
    {kGather, 32, 32, 2, 1, 1},    // 6: warp 16x32, K split 2
    {kGather, 16, 32, 1, 1, 1},    // 7: warp 16x32, K split 4
    {kHalo, 64, 8, 4, 1, 1},       // 8: R = 64 / W rows
    {kHalo, 64, 16, 4, 1, 1},      // 9
    {kHalo, 128, 8, 4, 1, 1},      // 10: R = 128 / W rows
    {kHalo, 128, 16, 4, 1, 1},     // 11
    {kHalo, 64, 32, 4, 1, 1},      // 12
    {kHaloMma, 128, 8, 4, 1, 1},   // 13
    {kHaloMma, 128, 16, 4, 1, 1},  // 14
    {kSplit, 16, 32, 1, 1, 4},     // 15: tile 7 over a cluster of 4
    {kSplit, 16, 32, 1, 1, 8},     // 16: tile 7 over a cluster of 8
};
constexpr int kNumTiles = sizeof(kTiles) / sizeof(kTiles[0]);

// staged channels a halo tile takes, at most (its B tiles hold 9 * CK k)
__host__ __device__ constexpr int halo_ck(int bn) { return bn >= 32 ? 16 : 32; }

struct Params {
  // one lane's operands; lane z reads and writes them offset by z * the
  // operand's lane stride below
  const float* a;        // (N,H,W,Cin): x (forward) or g (dx mode)
  const float* act_out;  // dx mode, ELU conv: saved output (N,H,W,Cin)
  const float* w;        // (3,3,C,O) of the forward conv
  const float* bias;     // forward: (Cout,) or null
  float* y;              // (N,H,W,Cout)
  float* gp;             // dx mode, ELU conv: g' (N,H,W,Cin)
  int N, H, W, Cin, Cout;
  int M, K;              // M = N*H*W, K = 9*Cin
  float inv_cin, inv_hw, inv_w;   // 1 / Cin, 1 / (H*W), 1 / W for fdiv
  int elu;               // forward: ELU epilogue; dx mode: ELU' on A
  int vec_a, vec_b;      // gather: 16-byte copies for A / B
  // halo: rows per block, smem floats per staged pixel and per staged
  // box, the B tiles' k extent, TMA (else cp.async) and the rank of each
  // tensor map (5: a lane dimension; 4: shared or one lane)
  int R, cs, box, kp, tma, rank_a, rank_o;
  // lane strides in floats (0: shared by every lane)
  long long lane_a, lane_o, lane_w, lane_b, lane_y, lane_gp;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// src_bytes = 0 writes zeros and reads nothing (the halo, the ragged edge)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---- mbarriers and TMA (the halo tiles)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, unsigned parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n}\n"
      : "=r"(ok) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return ok != 0;
}

// a load that never completes traps (a launch error) instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (int i = 0; !mbar_try(bar, parity); ++i)
    if (i > (1 << 22)) __trap();
}

// the box at coordinates (c, w, h, n[, lane]) of `map` into dst; completes
// on bar
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         uint64_t* bar, int rank, int c,
                                         int w, int h, int n, int lane) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if (rank == 5)
    asm volatile(
        "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
        :: "r"(smem_addr(dst)), "l"(m), "r"(c), "r"(w), "r"(h), "r"(n),
           "r"(lane), "r"(smem_addr(bar)) : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(smem_addr(dst)), "l"(m), "r"(c), "r"(w), "r"(h), "r"(n),
           "r"(smem_addr(bar)) : "memory");
}

// generic-proxy writes to shared memory made visible to the async proxy
// (wgmma's B reads, the next TMA write of the same stage)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// x = hi + lo, both TF32 (the tensor cores read the top 19 bits)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
  const float r = x - __uint_as_float(h);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(l) : "f"(r));
  hi = h;
  lo = l;
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- wgmma (the halo tiles): m64nNk8, TF32, A from registers (the
// m16n8k8 A fragment of warp w at rows 16w..16w+15), B by descriptor, D in
// registers (d[4j + e] is the m16n8 C fragment j of warp w)
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r) :: "memory");
}
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// no swizzle, K-major: core matrices of 8 rows x 16 bytes (128 bytes each),
// `lbo` bytes apart along K, `sbo` bytes apart along N
__device__ __forceinline__ uint64_t gmma_desc(const float* p, unsigned lbo,
                                              unsigned sbo) {
  uint64_t d = (smem_addr(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  return d;                        // base offset 0, layout type 0
}

__device__ __forceinline__ void wgmma(float (&d)[4], const uint32_t (&a)[4],
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[8], const uint32_t (&a)[4],
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[16], const uint32_t (&a)[4],
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// a / d for 0 <= a, a + d < 2^22, from inv = 1.0f / d: (a + 0.5) / d lies
// at least 0.5 / d from an integer, and the float product is off by less
// than (a + d) * 2^-23 / d (the wrapper keeps N*H*W <= 2,000,000)
__device__ __forceinline__ int fdiv(int a, float inv) {
  return __float2int_rz((static_cast<float>(a) + 0.5f) * inv);
}

// packed (h << 16 | w) of pixel m, or h = 0x7fff (outside every image)
// for m past the last pixel
__device__ __forceinline__ int pixel_hw(int m, const Params& p) {
  if (m >= p.M) return 0x7fff << 16;
  const int hw = m - fdiv(m, p.inv_hw) * (p.H * p.W);
  const int h = fdiv(hw, p.inv_w);
  return (h << 16) | (hw - h * p.W);
}

__device__ __forceinline__ float elu_grad_scale(float out) {
  return out > 0.f ? 1.f : out + 1.f;
}

__device__ __forceinline__ float epilogue(float v, const float* bias, int n,
                                          int Cout, int elu) {
  if (bias != nullptr && n < Cout) v += bias[n];
  return elu ? (v > 0.f ? v : expm1f(v)) : v;
}

// ======================= gather and split tiles =========================

// floats of one pipeline stage: A, the saved output (dx + ELU), B
template <int BM, int BN, bool DX>
__host__ __device__ constexpr int b_floats() {
  return DX ? BN * kRowStride : kBK * (BN == 8 ? 8 : BN + 8);
}

template <int BM, int BN, bool DX>
__host__ __device__ int stage_floats(bool has_o) {
  return BM * kRowStride * (has_o ? 2 : 1) + b_floats<BM, BN, DX>();
}

// ring depth of a tile: kMaxStages, or fewer where the ring would pass
// 110 KB (in the dx mode, with the saved output beside g), so that two
// blocks still fit on an SM; never fewer than 2. Measured: a deeper ring
// that costs a block per SM is slower (PERF.md, PR 3).
template <int BM, int BN, bool DX>
__host__ __device__ constexpr int stages() {
  constexpr int a = BM * kRowStride * (DX ? 2 : 1);
  constexpr int fit = (110 * 1024 / 4) / (a + b_floats<BM, BN, DX>());
  return fit < 2 ? 2 : (fit < kMaxStages ? fit : kMaxStages);
}

// S = 1: one block per tile (gather). S > 1: a cluster of S blocks per
// tile along x (split); rank r walks chunks [r*C/S, (r+1)*C/S).
template <int BM, int BN, int WM, int WN, int S, bool DX>
__global__ void __launch_bounds__(kThreads)
conv3x3_mma_kernel(const Params p) {
  constexpr int kStages = stages<BM, BN, DX>();
  constexpr int KS = kThreads / 32 / (WM * WN);   // warps splitting K
  constexpr int TM = BM / WM, TN = BN / WN;       // warp tile
  constexpr int MI = TM / 16, NI = TN / 8;        // m16n8 fragments
  constexpr int SB = DX ? kRowStride : (BN == 8 ? 8 : BN + 8);  // B stride
  static_assert(KS >= 1 && KS * WM * WN * 32 == kThreads, "warp layout");
  static_assert(MI >= 1 && NI >= 1 && TM % 16 == 0 && TN % 8 == 0, "tile");
  static_assert(BM % 16 == 0 && BM <= kThreads, "A copy mapping");

  extern __shared__ __align__(16) float smem[];
  const bool has_o = DX && p.elu;
  const int sa = BM * kRowStride;                 // A floats per stage
  const int so = has_o ? sa : 0;
  const int stage = sa + so + b_floats<BM, BN, DX>();

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wk = warp / (WM * WN);
  const int wm = (warp % (WM * WN)) / WN, wn = warp % WN;
  const int m0 = (S > 1 ? blockIdx.x / S : blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int H = p.H, W = p.W, Cin = p.Cin, Cout = p.Cout, K = p.K;
  // this block's lane
  const long long lz = blockIdx.z;
  const float* const pa = p.a + lz * p.lane_a;
  const float* const pact = p.act_out + lz * p.lane_o;
  const float* const pw = p.w + lz * p.lane_w;
  const float* const pbias =
      p.bias == nullptr ? nullptr : p.bias + lz * p.lane_b;
  float* const py = p.y + lz * p.lane_y;
  float* const pgp = p.gp + lz * p.lane_gp;
  const int all_chunks = (K + kBK - 1) / kBK;
  int rank = 0;
  if constexpr (S > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  const int cbeg = rank * all_chunks / S;
  const int nchunks = (rank + 1) * all_chunks / S - cbeg;

  // ---- A gather: pixel coordinates of this thread's rows, packed h<<16|w;
  // rows past M get h = 0x7fff, outside every image
  // vec: quad tid % kQuads of rows tid / kQuads + kRowStep * i
  constexpr int kRowStep = kThreads / kQuads;
  constexpr int kVecRows = BM / kRowStep;
  static_assert(BM % kRowStep == 0, "A copy mapping");
  int hw[kVecRows];
#pragma unroll
  for (int i = 0; i < kVecRows; ++i) {
    const int m = m0 + tid / kQuads + kRowStep * i;
    hw[i] = pixel_hw(m, p);
  }

  auto load_chunk = [&](int chunk, int slot) {
    float* As = smem + slot * stage;
    float* Os = As + sa;
    float* Bs = As + sa + so;
    const int k0 = chunk * kBK;
    if (p.vec_a) {
      const int q = tid % kQuads;
      const int k = k0 + 4 * q;
      const bool kv = k < K;
      const int tap = kv ? fdiv(k, p.inv_cin) : 0;
      const int ci = k - tap * Cin;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const int delta = (dy * W + dx) * Cin + ci;
#pragma unroll
      for (int i = 0; i < kVecRows; ++i) {
        const int r = tid / kQuads + kRowStep * i;
        const int hh = (hw[i] >> 16) + dy, ww = (hw[i] & 0xffff) + dx;
        const bool v = kv && hh >= 0 && hh < H && ww >= 0 && ww < W;
        const int off = v ? (m0 + r) * Cin + delta : 0;
        cp_async16(As + r * kRowStride + 4 * q, pa + off, v ? 16 : 0);
        if (has_o)
          cp_async16(Os + r * kRowStride + 4 * q, pact + off,
                     v ? 16 : 0);
      }
    } else {
      // 4-byte copies: one row per thread, kBK*BM/kThreads k values each
      constexpr int kPer = kBK * BM / kThreads;
      const int r = tid % BM;
      const int kk0 = (tid / BM) * kPer;
      const int m = m0 + r;
      const int hwp = pixel_hw(m, p);
      const int h = hwp >> 16, w = hwp & 0xffff;
      int k = k0 + kk0;
      int tap = fdiv(k, p.inv_cin), ci = k - tap * Cin;
      for (int j = 0; j < kPer; ++j, ++k) {
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        const int hh = h + dy, ww = w + dx;
        const bool v = k < K && hh >= 0 && hh < H && ww >= 0 && ww < W;
        const int off = v ? (m + dy * W + dx) * Cin + ci : 0;
        cp_async4(As + r * kRowStride + kk0 + j, pa + off, v ? 4 : 0);
        if (has_o)
          cp_async4(Os + r * kRowStride + kk0 + j, pact + off,
                    v ? 4 : 0);
        if (++ci == Cin) { ci = 0; ++tap; }
      }
    }
    // ---- B tile
    if (!DX) {
      // w as the (K, Cout) matrix, row-major: Bs[k][n]
      if (p.vec_b) {
        for (int idx = tid; idx < kBK * BN / 4; idx += kThreads) {
          const int kk = idx / (BN / 4), n = 4 * (idx % (BN / 4));
          const bool v = k0 + kk < K && n0 + n < Cout;
          const int off = v ? (k0 + kk) * Cout + n0 + n : 0;
          cp_async16(Bs + kk * SB + n, pw + off, v ? 16 : 0);
        }
      } else {
        for (int idx = tid; idx < kBK * BN; idx += kThreads) {
          const int kk = idx / BN, n = idx % BN;
          const bool v = k0 + kk < K && n0 + n < Cout;
          const int off = v ? (k0 + kk) * Cout + n0 + n : 0;
          cp_async4(Bs + kk * SB + n, pw + off, v ? 4 : 0);
        }
      }
    } else {
      // the adjoint: B[k = (tap, o)][n = c] = w[8 - tap][c][o]; Bs[n][k]
      if (p.vec_b) {
        for (int idx = tid; idx < BN * kBK / 4; idx += kThreads) {
          const int n = idx / kQuads, kk = 4 * (idx % kQuads);
          const int k = k0 + kk;
          const bool v = k < K && n0 + n < Cout;
          const int tap = v ? fdiv(k, p.inv_cin) : 0;
          const int off = v ? ((8 - tap) * Cout + n0 + n) * Cin
                                  + (k - tap * Cin) : 0;
          cp_async16(Bs + n * SB + kk, pw + off, v ? 16 : 0);
        }
      } else {
        for (int idx = tid; idx < BN * kBK; idx += kThreads) {
          const int n = idx / kBK, kk = idx % kBK;
          const int k = k0 + kk;
          const bool v = k < K && n0 + n < Cout;
          const int tap = v ? fdiv(k, p.inv_cin) : 0;
          const int off = v ? ((8 - tap) * Cout + n0 + n) * Cin
                                  + (k - tap * Cin) : 0;
          cp_async4(Bs + n * SB + kk, pw + off, v ? 4 : 0);
        }
      }
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) load_chunk(cbeg + s, s);
    cp_async_commit();
  }

  const bool write_gp = has_o && blockIdx.y == 0;
  const int kc0 = 4 * Cin, kc1 = 5 * Cin;     // the centre tap's k range

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kStages - 2>();
    if (has_o) {
      // ELU' on the elements this thread copied (the wait made its own
      // copies of chunk c visible to it): A becomes g' in place, once per
      // block, before the barrier publishes it to the other warps
      float* Aw = smem + (c % kStages) * stage;
      const float* Ow = Aw + sa;
      if (p.vec_a) {
#pragma unroll
        for (int i = 0; i < kVecRows; ++i) {
          const int o = (tid / kQuads + kRowStep * i) * kRowStride
                        + 4 * (tid % kQuads);
          float4 a = *reinterpret_cast<float4*>(Aw + o);
          const float4 s = *reinterpret_cast<const float4*>(Ow + o);
          a.x *= elu_grad_scale(s.x);
          a.y *= elu_grad_scale(s.y);
          a.z *= elu_grad_scale(s.z);
          a.w *= elu_grad_scale(s.w);
          *reinterpret_cast<float4*>(Aw + o) = a;
        }
      } else {
        constexpr int kPer = kBK * BM / kThreads;
        const int o = (tid % BM) * kRowStride + (tid / BM) * kPer;
        for (int j = 0; j < kPer; ++j)
          Aw[o + j] *= elu_grad_scale(Ow[o + j]);
      }
    }
    __syncthreads();
    if (c + kStages - 1 < nchunks)
      load_chunk(cbeg + c + kStages - 1, (c + kStages - 1) % kStages);
    cp_async_commit();

    const float* As = smem + (c % kStages) * stage;
    const float* Bs = As + sa + so;
    const int k0 = (cbeg + c) * kBK;

    if (write_gp && k0 < kc1 && k0 + kBK > kc0) {
      // g' of the centre tap (dy = dx = 1) is g' at the tile's own pixels
      for (int idx = tid; idx < BM * kBK; idx += kThreads) {
        const int r = idx / kBK, kk = idx % kBK;
        const int k = k0 + kk;
        if (k >= kc0 && k < kc1 && m0 + r < p.M)
          pgp[(m0 + r) * Cin + (k - kc0)] =
              As[r * kRowStride + kk];
      }
    }

    // this chunk's products; a small warp tile gives each of the three
    // 3xTF32 terms its own accumulator, so its mma are not one serial chain
    constexpr int kChains = MI * NI <= 2 ? 3 : 1;
    float part[kChains][MI][NI][4];
#pragma unroll
    for (int q = 0; q < kChains; ++q)
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[q][i][j][e] = 0.f;

    // k8 steps s0 + wk of the chunk are this warp's
#pragma unroll
    for (int s0 = 0; s0 < kBK / 8; s0 += KS) {
      const int kb = 8 * (s0 + wk);
      if (k0 + kb >= K) break;
      uint32_t ahi[MI][4], alo[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int r = wm * TM + i * 16 + gid;
        const int offs[4] = {r * kRowStride + kb + tig,
                             (r + 8) * kRowStride + kb + tig,
                             r * kRowStride + kb + tig + 4,
                             (r + 8) * kRowStride + kb + tig + 4};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(As[offs[e]], ahi[i][e], alo[i][e]);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = wn * TN + j * 8 + gid;
        float b0, b1;
        if (DX) {
          b0 = Bs[n * SB + kb + tig];
          b1 = Bs[n * SB + kb + tig + 4];
        } else {
          b0 = Bs[(kb + tig) * SB + n];
          b1 = Bs[(kb + tig + 4) * SB + n];
        }
        uint32_t b0h, b0l, b1h, b1l;
        split_tf32(b0, b0h, b0l);
        split_tf32(b1, b1h, b1l);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma_tf32(part[0][i][j], alo[i], b0h, b1h);
          mma_tf32(part[1 % kChains][i][j], ahi[i], b0l, b1l);
          mma_tf32(part[2 % kChains][i][j], ahi[i], b0h, b1h);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = part[0][i][j][e];
#pragma unroll
          for (int q = 1; q < kChains; ++q) s += part[q][i][j][e];
          acc[i][j][e] += s;
        }
  }
  cp_async_wait<0>();

  // ---- K split: warps wk > 0 hand their tiles to wk == 0 through shared
  // memory, which adds them in the order wk = 1, 2, 3
  if (KS > 1) {
    __syncthreads();                       // the ring is free again
    float* red = smem;                     // (KS-1) x BM x BN
    if (wk > 0) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = wm * TM + i * 16 + gid + (e >> 1) * 8;
            const int n = wn * TN + j * 8 + 2 * tig + (e & 1);
            red[((wk - 1) * BM + r) * BN + n] = acc[i][j][e];
          }
    }
    __syncthreads();
    if (wk == 0) {
#pragma unroll
      for (int s = 0; s < KS - 1; ++s)
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = wm * TM + i * 16 + gid + (e >> 1) * 8;
              const int n = wn * TN + j * 8 + 2 * tig + (e & 1);
              acc[i][j][e] += red[(s * BM + r) * BN + n];
            }
    }
  }

  if constexpr (S > 1) {
    // ---- cluster split: each block's tile into its shared memory, then
    // rank r reduces elements r*128 + tid (stride S*128) over ranks 0..S-1
    // in rank order, adds bias, applies ELU and stores
    cg::cluster_group cluster = cg::this_cluster();
    float* mine = smem + (KS - 1) * BM * BN;
    __syncthreads();                       // the ring and red are free
    if (wk == 0) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = wm * TM + i * 16 + gid + (e >> 1) * 8;
            const int n = wn * TN + j * 8 + 2 * tig + (e & 1);
            mine[r * BN + n] = acc[i][j][e];
          }
    }
    cluster.sync();
    for (int idx = rank * kThreads + tid; idx < BM * BN;
         idx += S * kThreads) {
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < S; ++j) v += cluster.map_shared_rank(mine, j)[idx];
      const int m = m0 + idx / BN, n = n0 + idx % BN;
      if (m < p.M && n < Cout)
        py[m * Cout + n] = DX ? v : epilogue(v, pbias, n, Cout, p.elu);
    }
    cluster.sync();                        // peers read this block's tile
    return;
  }
  if (KS > 1 && wk > 0) return;

  // ---- epilogue: bias, ELU, store
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int m = m0 + wm * TM + i * 16 + gid + 8 * h2;
      if (m >= p.M) continue;
      float* row = py + m * Cout;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = n0 + wn * TN + j * 8 + 2 * tig;
        float z[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = acc[i][j][2 * h2 + e];
          z[e] = DX ? v : epilogue(v, pbias, n + e, Cout, p.elu);
        }
        if ((Cout & 1) == 0 && n + 1 < Cout) {
          *reinterpret_cast<float2*>(row + n) = make_float2(z[0], z[1]);
        } else {
          if (n < Cout) row[n] = z[0];
          if (n + 1 < Cout) row[n + 1] = z[1];
        }
      }
    }
  }
}

// ============================ halo tiles ================================

// WG: wgmma products, else mma.sync. One warpgroup; warp w owns GEMM rows
// 16w..16w+15 of each 64-row slice. A halo tile stages all Cin <= CK
// channels at once (measured: a halo tile over several channel chunks
// lost to the gather tiles at every shape it could take; PERF.md).
// Shared memory: the B hi and lo tiles (BN x kp each, kp = 9 Cin rounded
// up to 8), then the box and the saved output's box beside it. At most
// kHaloBlocks blocks' registers fit an SM together.
template <int BM, int BN, bool DX, bool WG>
__global__ void __launch_bounds__(kThreads, kHaloBlocks)
conv3x3_halo_kernel(const Params p, const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_o) {
  constexpr int MT = BM / 64, NI = BN / 8;
  constexpr int kChains = MT * NI <= 2 ? 3 : 1;
  constexpr int kFold = kBK / 8;    // k8 steps per fresh accumulator

  // the boxes start on 128-byte boundaries (TMA's destinations)
  extern __shared__ __align__(16) float smem_raw[];
  float* const smem =
      smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127) / 4;
  __shared__ __align__(8) uint64_t full;
  const bool has_o = DX && p.elu;
  const int kp = p.kp, SBO = 8 * kp;          // floats between n-groups
  float* const Bhi = smem;
  float* const Blo = smem + BN * kp;
  float* const A = smem + 2 * BN * kp;        // the box, g' in dx + ELU
  float* const O = A + p.box;                 // the saved output's box

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int H = p.H, W = p.W, R = p.R, Cst = p.Cin, Cout = p.Cout;
  const int CS = p.cs, BW = W + 2;
  const int rblocks = (H + R - 1) / R;
  const int img = blockIdx.x / rblocks;
  const int h0 = (blockIdx.x - img * rblocks) * R;
  const int n0 = blockIdx.y * BN;
  const long long lz = blockIdx.z;
  const float* const pa = p.a + lz * p.lane_a;
  const float* const pact = p.act_out + lz * p.lane_o;
  const float* const pw = p.w + lz * p.lane_w;
  const float* const pbias =
      p.bias == nullptr ? nullptr : p.bias + lz * p.lane_b;
  float* const py = p.y + lz * p.lane_y;
  float* const pgp = p.gp + lz * p.lane_gp;

  // this thread's GEMM rows: the box offset of their tap (0, 0) and their
  // pixel (-1: masked)
  int base[MT][2], pix[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int m = mt * 64 + warp * 16 + gid + 8 * h2;
      const int r = m / W, w = m - r * W;
      const bool v = r < R && h0 + r < H;
      base[mt][h2] = v ? (r * BW + w) * CS : 0;
      pix[mt][h2] = v ? (img * H + h0 + r) * W + w : -1;
    }

  if (p.tma && tid == 0) {
    mbar_init(&full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();                   // the barrier, before any wait on it

  // ---- the box (and the saved output's): TMA by one thread, completing
  // on the mbarrier, or 4-byte cp.async by all
  if (p.tma) {
    if (tid == 0) {
      const unsigned bytes = 4u * (R + 2) * BW * CS;
      mbar_expect_tx(&full, has_o ? 2 * bytes : bytes);
      tma_load(A, &map_a, &full, p.rank_a, 0, -1, h0 - 1, img,
               static_cast<int>(lz));
      if (has_o)
        tma_load(O, &map_o, &full, p.rank_o, 0, -1, h0 - 1, img,
                 static_cast<int>(lz));
    }
  } else {
    const int n = (R + 2) * BW * Cst;
    for (int idx = tid; idx < n; idx += kThreads) {
      const int px = idx / Cst, c = idx - px * Cst;
      const int i = px / BW, j = px - i * BW;
      const int hh = h0 - 1 + i, ww = j - 1;
      const bool v = hh >= 0 && hh < H && ww >= 0 && ww < W;
      const int off = v ? ((img * H + hh) * W + ww) * Cst + c : 0;
      cp_async4(A + px * CS + c, pa + off, v ? 4 : 0);
      if (has_o) cp_async4(O + px * CS + c, pact + off, v ? 4 : 0);
    }
    cp_async_commit();
  }

  // ---- B into the hi and lo tiles while the box loads: k = tap * Cst + c
  // < 9 * Cst (zero past that, up to kp, and past Cout), K-major core
  // matrices: (n, k) at (n / 8) * SBO + (k / 4) * 32 + (n % 8) * 4 + k % 4
  // floats. The dx mode reads the adjoint w[8 - tap][n][c], k-contiguous;
  // the forward w[tap][c][n], n-contiguous. Up to 16 loads in flight per
  // thread (one round for BN = 16 at Cst = 8, or BN = 8 at 16).
  {
    constexpr int kUnroll = 16;
    const int kc = 9 * Cst, total = BN * kp;
    const float inv_c = 1.0f / static_cast<float>(Cst);
    const float inv_k = 1.0f / static_cast<float>(kp);
    auto nk = [&](int idx, int& n, int& k) {
      if (DX) { n = fdiv(idx, inv_k); k = idx - n * kp; }
      else { k = idx / BN; n = idx - k * BN; }
    };
    for (int i0 = tid; i0 < total; i0 += kUnroll * kThreads) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        int n, k;
        nk(i0 + u * kThreads, n, k);
        const bool ok = i0 + u * kThreads < total && k < kc && n0 + n < Cout;
        const int tap = ok ? fdiv(k, inv_c) : 0;
        const int c = k - tap * Cst;
        const int off = !ok ? 0
                        : DX ? ((8 - tap) * Cout + n0 + n) * Cst + c
                             : (tap * Cst + c) * Cout + n0 + n;
        v[u] = ok ? __ldg(pw + off) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i0 + u * kThreads >= total) break;
        int n, k;
        nk(i0 + u * kThreads, n, k);
        const int o = (n >> 3) * SBO + (k >> 2) * 32 + (n & 7) * 4 + (k & 3);
        uint32_t hi, lo;
        split_tf32(v[u], hi, lo);
        Bhi[o] = __uint_as_float(hi);
        Blo[o] = __uint_as_float(lo);
      }
    }
  }

  if (p.tma) mbar_wait(&full, 0);
  else cp_async_wait<0>();
  if (has_o) {
    // g' = g * ELU'(out) once per staged element; with TMA every thread
    // sees the whole box after its wait, with cp.async its own copies
    if (p.tma) {
      const int n4 = (R + 2) * BW * CS / 4;
      for (int idx = tid; idx < n4; idx += kThreads) {
        float4 g = reinterpret_cast<float4*>(A)[idx];
        const float4 s = reinterpret_cast<const float4*>(O)[idx];
        g.x *= elu_grad_scale(s.x);
        g.y *= elu_grad_scale(s.y);
        g.z *= elu_grad_scale(s.z);
        g.w *= elu_grad_scale(s.w);
        reinterpret_cast<float4*>(A)[idx] = g;
      }
    } else {
      const int n = (R + 2) * BW * Cst;
      for (int idx = tid; idx < n; idx += kThreads) {
        const int px = idx / Cst, c = idx - px * Cst;
        A[px * CS + c] *= elu_grad_scale(O[px * CS + c]);
      }
    }
  }
  fence_proxy_async();
  __syncthreads();                   // box (g') and B tiles ready
  if (has_o && blockIdx.y == 0) {
    // g' at the block's own pixels
    const int n = R * W * Cst;
    for (int idx = tid; idx < n; idx += kThreads) {
      const int px = idx / Cst, c = idx - px * Cst;
      const int r = px / W, w = px - r * W;
      if (h0 + r < H)
        pgp[((img * H + h0 + r) * W + w) * Cst + c] =
            A[((r + 1) * BW + w + 1) * CS + c];
    }
  }

  float acc[MT][NI * 4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < NI * 4; ++e) acc[mt][e] = 0.f;

  // ---- the products: k = tap * Cst + c in k8 steps; each thread tracks
  // its two k columns (tig, tig + 4) as (tap, c) and their box offset (-1
  // past K). Every kFold steps (64 k) the fresh accumulators are added
  // into the total, as in the gather tiles.
  const int steps = (9 * Cst + 7) / 8;
  int tap0 = tig / Cst, c0 = tig - tap0 * Cst;
  int tap1 = (tig + 4) / Cst, c1 = tig + 4 - tap1 * Cst;
  auto toff = [&](int tap, int c) {
    if (tap >= 9) return -1;
    const int dy = (tap * 11) >> 5;          // tap / 3 for tap < 9
    return (dy * BW + tap - 3 * dy) * CS + c;
  };
  auto advance = [&](int& tap, int& c) {
    c += 8;
    while (c >= Cst) { c -= Cst; ++tap; }
  };
  // the A fragment of the next step, split into hi and lo
  auto fragment = [&](uint32_t (&hi)[MT][4], uint32_t (&lo)[MT][4]) {
    const int o0 = toff(tap0, c0), o1 = toff(tap1, c1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float v[4] = {
          o0 >= 0 ? A[base[mt][0] + o0] : 0.f,
          o0 >= 0 ? A[base[mt][1] + o0] : 0.f,
          o1 >= 0 ? A[base[mt][0] + o1] : 0.f,
          o1 >= 0 ? A[base[mt][1] + o1] : 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(v[e], hi[mt][e], lo[mt][e]);
    }
    advance(tap0, c0);
    advance(tap1, c1);
  };

  float part[kChains][MT][NI * 4];
  uint32_t ahi0[MT][4], alo0[MT][4], ahi1[MT][4], alo1[MT][4];
  for (int s0 = 0; s0 < steps; s0 += kFold) {
    const int s1 = min(s0 + kFold, steps);
#pragma unroll
    for (int ch = 0; ch < kChains; ++ch)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < NI * 4; ++e) part[ch][mt][e] = 0.f;

    if constexpr (WG) {
      // two fragment buffers: step s + 1 is built while step s's group
      // is in flight; each buffer is rewritten only after the group that
      // read it has completed
      auto issue_step = [&](int s, uint32_t (&hi)[MT][4],
                            uint32_t (&lo)[MT][4]) {
        const uint64_t dhi = gmma_desc(Bhi + s * 64, 128, SBO * 4);
        const uint64_t dlo = gmma_desc(Blo + s * 64, 128, SBO * 4);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            reg_fence(hi[mt][e]);
            reg_fence(lo[mt][e]);
          }
        wg_fence();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          wgmma(part[0][mt], lo[mt], dhi);
          wgmma(part[1 % kChains][mt], hi[mt], dlo);
          wgmma(part[2 % kChains][mt], hi[mt], dhi);
        }
        wg_commit();
      };
#pragma unroll 1
      for (int s = s0; s < s1; s += 2) {
        wg_wait<1>();
        fragment(ahi0, alo0);
        issue_step(s, ahi0, alo0);
        if (s + 1 < s1) {
          wg_wait<1>();
          fragment(ahi1, alo1);
          issue_step(s + 1, ahi1, alo1);
        }
      }
      wg_wait<0>();
#pragma unroll
      for (int ch = 0; ch < kChains; ++ch)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < NI * 4; ++e) reg_fence(part[ch][mt][e]);
    } else {
#pragma unroll 1
      for (int s = s0; s < s1; ++s) {
        fragment(ahi0, alo0);
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int o = j * SBO + 2 * s * 32 + gid * 4 + tig;
          const uint32_t b0h = __float_as_uint(Bhi[o]);
          const uint32_t b1h = __float_as_uint(Bhi[o + 32]);
          const uint32_t b0l = __float_as_uint(Blo[o]);
          const uint32_t b1l = __float_as_uint(Blo[o + 32]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_tf32(&part[0][mt][4 * j], alo0[mt], b0h, b1h);
            mma_tf32(&part[1 % kChains][mt][4 * j], ahi0[mt], b0l, b1l);
            mma_tf32(&part[2 % kChains][mt][4 * j], ahi0[mt], b0h, b1h);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < NI * 4; ++e) {
        float s = part[0][mt][e];
#pragma unroll
        for (int ch = 1; ch < kChains; ++ch) s += part[ch][mt][e];
        acc[mt][e] += s;
      }
  }

  // ---- epilogue: bias, ELU, store (acc[mt][4j + e]: row gid + 8 (e / 2),
  // column 8j + 2 tig + e % 2 of the warp's 16 rows)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      if (pix[mt][h2] < 0) continue;
      float* row = py + static_cast<long long>(pix[mt][h2]) * Cout;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = n0 + j * 8 + 2 * tig;
        float z[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = acc[mt][4 * j + 2 * h2 + e];
          z[e] = DX ? v : epilogue(v, pbias, n + e, Cout, p.elu);
        }
        if ((Cout & 1) == 0 && n + 1 < Cout) {
          *reinterpret_cast<float2*>(row + n) = make_float2(z[0], z[1]);
        } else {
          if (n < Cout) row[n] = z[0];
          if (n + 1 < Cout) row[n + 1] = z[1];
        }
      }
    }
  }
}

// ============================== host side ===============================

// the dynamic shared memory limit is an attribute of the kernel on each
// device (lanes of a mesh run on several cards, from several host
// threads: setting it twice is harmless)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* allowed) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes > 48 * 1024 && bytes > allowed[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    allowed[dev] = bytes;
  }
  return cudaSuccess;
}

// gather (S = 1) and split (S > 1: a cluster of S blocks along x) tiles;
// a split tile takes M <= 128 and K >= 576 and at most one block per K
// chunk
template <int BM, int BN, int WM, int WN, int S, bool DX>
cudaError_t launch_gather(const Params& p, int lanes, cudaStream_t stream) {
  constexpr int KS = kThreads / 32 / (WM * WN);
  if (S > 1 && (p.M > 128 || p.K < 576 || S > (p.K + kBK - 1) / kBK))
    return cudaErrorInvalidValue;
  const bool has_o = DX && p.elu;
  const int pipe = stages<BM, BN, DX>() * stage_floats<BM, BN, DX>(has_o);
  const int red = (KS - 1) * BM * BN + (S > 1 ? BM * BN : 0);
  const size_t bytes = sizeof(float) * (pipe > red ? pipe : red);
  auto kernel = conv3x3_mma_kernel<BM, BN, WM, WN, S, DX>;
  static size_t allowed[kMaxDevices] = {};
  cudaError_t e = allow_smem(kernel, bytes, allowed);
  if (e != cudaSuccess) return e;
  dim3 grid(S * ((p.M + BM - 1) / BM), (p.Cout + BN - 1) / BN, lanes);
  if constexpr (S == 1) {
    kernel<<<grid, kThreads, bytes, stream>>>(p);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = S;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kernel, p);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// the NHWC tensor t (lanes of `lane` floats apart, or shared) as a tensor
// map of (C, W, H, N[, L]) with a (box_c, W + 2, R + 2, 1[, 1]) box; rank
// 5 only for a tensor with a lane dimension
cudaError_t encode_map(CUtensorMap* map, int* rank, const float* t,
                       const Params& p, long long lane, int lanes) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  *rank = lane != 0 && lanes > 1 ? 5 : 4;
  const cuuint64_t C = p.Cin;
  const cuuint64_t dims[5] = {C, static_cast<cuuint64_t>(p.W),
                              static_cast<cuuint64_t>(p.H),
                              static_cast<cuuint64_t>(p.N),
                              static_cast<cuuint64_t>(lanes)};
  const cuuint64_t strides[4] = {4 * C, 4 * C * p.W, 4 * C * p.W * p.H,
                                 4 * static_cast<cuuint64_t>(lane)};
  const cuuint32_t box[5] = {static_cast<cuuint32_t>(p.cs),
                             static_cast<cuuint32_t>(p.W + 2),
                             static_cast<cuuint32_t>(p.R + 2), 1, 1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, *rank,
                        const_cast<float*>(t), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the geometry of a halo tile at p's shape; false where its
// preconditions fail (a map narrower than 8 or wider than BM, more staged
// channels than CK, too much shared memory). TMA where the staged channel
// count is a multiple of 4 and the staged tensors lie on 16-byte
// boundaries (the box's channel extent is then Cin + 4, the pad read as
// zeros and unused: bank-conflict-free taps); 4-byte cp.async elsewhere
// (an odd channel stride).
template <int BM, int BN>
bool halo_geometry(Params* p, bool has_o, size_t* bytes) {
  if (p->W < 8 || p->W > BM || p->Cin > halo_ck(BN)) return false;
  p->R = BM / p->W < p->H ? BM / p->W : p->H;
  const auto aligned = [](const void* t, long long lane) {
    return reinterpret_cast<uintptr_t>(t) % 16 == 0 && lane % 4 == 0;
  };
  p->tma = p->Cin % 4 == 0 && aligned(p->a, p->lane_a)
           && (!has_o || aligned(p->act_out, p->lane_o));
  p->cs = p->tma ? p->Cin + 4 : (p->Cin | 1);
  p->kp = (9 * p->Cin + 7) / 8 * 8;
  const int px = (p->R + 2) * (p->W + 2);
  p->box = (px * p->cs + 31) / 32 * 32;
  *bytes = 128 + sizeof(float) * (2 * BN * p->kp
                                  + p->box * (has_o ? 2 : 1));
  return *bytes <= static_cast<size_t>(kHaloSmem);
}

template <int BM, int BN, bool DX, bool WG>
cudaError_t launch_halo(Params p, int lanes, cudaStream_t stream) {
  const bool has_o = DX && p.elu;
  size_t bytes = 0;
  if (!halo_geometry<BM, BN>(&p, has_o, &bytes)) return cudaErrorInvalidValue;
  CUtensorMap map_a = {}, map_o = {};
  p.rank_a = p.rank_o = 4;
  if (p.tma) {
    cudaError_t e = encode_map(&map_a, &p.rank_a, p.a, p, p.lane_a, lanes);
    if (e == cudaSuccess && has_o)
      e = encode_map(&map_o, &p.rank_o, p.act_out, p, p.lane_o, lanes);
    if (e != cudaSuccess) return e;
  }
  auto kernel = conv3x3_halo_kernel<BM, BN, DX, WG>;
  static size_t allowed[kMaxDevices] = {};
  cudaError_t e = allow_smem(kernel, bytes, allowed);
  if (e != cudaSuccess) return e;
  dim3 grid(p.N * ((p.H + p.R - 1) / p.R), (p.Cout + BN - 1) / BN, lanes);
  kernel<<<grid, kThreads, bytes, stream>>>(p, map_a, map_o);
  return cudaGetLastError();
}

template <int I, bool DX>
cudaError_t launch_tile(const Params& p, int lanes, cudaStream_t s) {
  constexpr Tile t = kTiles[I];
  if constexpr (t.family == kHalo || t.family == kHaloMma)
    return launch_halo<t.bm, t.bn, DX, t.family == kHalo>(p, lanes, s);
  else
    return launch_gather<t.bm, t.bn, t.wm, t.wn, t.split, DX>(p, lanes, s);
}

template <bool DX, int... I>
cudaError_t dispatch(int tile, const Params& p, int lanes, cudaStream_t s,
                     std::integer_sequence<int, I...>) {
  cudaError_t e = cudaErrorInvalidValue;
  ((tile == I ? (e = launch_tile<I, DX>(p, lanes, s), 0) : 0), ...);
  return e;
}

}  // namespace

extern "C" {

// The tile table, for the wrapper's selection rule: returns the number of
// tiles; fills (family, bm, bn, wm, wn, split) of tile `i` when
// 0 <= i < that number.
int s2s_conv3x3_tile(int i, int* family, int* bm, int* bn, int* wm, int* wn,
                     int* split) {
  if (i >= 0 && i < kNumTiles) {
    *family = kTiles[i].family;
    *bm = kTiles[i].bm; *bn = kTiles[i].bn;
    *wm = kTiles[i].wm; *wn = kTiles[i].wn;
    *split = kTiles[i].split;
  }
  return kNumTiles;
}

// k values per chunk of the gather and split tiles' K loop, for the
// wrapper's cost model.
int s2s_conv3x3_chunk() { return kBK; }

// One launch over `lanes` lanes (grid z; 1 for a one-lane launch). All
// tensors contiguous float32 on the device; lane z of an operand starts
// `lane_*` floats after lane 0 (0 for an operand every lane shares; a NULL
// operand's stride is ignored).
//   forward (dx = 0): a = x (N,H,W,Cin), w (3,3,Cin,Cout), b (Cout,) or
//     NULL, y (N,H,W,Cout); act_out and gp NULL; elu = ELU epilogue.
//   dx mode (dx = 1): a = g (N,H,W,Cin) with Cin = the forward's O, w the
//     forward's (3,3,Cout,Cin) as it is, y = dx (N,H,W,Cout); for an ELU
//     conv (elu = 1) act_out = the saved forward output (N,H,W,Cin) and
//     gp = g' (N,H,W,Cin) is written; b NULL.
// Limits (checked by the caller), per lane: 1 <= Cin, Cout <= 384;
// H, W <= 16384; N*H*W <= 2,000,000 (fdiv, 32-bit indices); lanes <= 65535.
// A tile whose preconditions fail returns cudaErrorInvalidValue.
int s2s_conv3x3_f32(const float* a, const float* act_out, const float* w,
                    const float* b, float* y, float* gp, int N, int H, int W,
                    int Cin, int Cout, int dx, int elu, int tile, int lanes,
                    long long lane_a, long long lane_o, long long lane_w,
                    long long lane_b, long long lane_y, long long lane_gp,
                    void* stream) {
  Params p = {};
  p.a = a; p.act_out = act_out; p.w = w; p.bias = b; p.y = y; p.gp = gp;
  p.N = N; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout;
  p.M = N * H * W; p.K = 9 * Cin;
  p.inv_cin = 1.0f / static_cast<float>(Cin);
  p.inv_hw = 1.0f / static_cast<float>(H * W);
  p.inv_w = 1.0f / static_cast<float>(W);
  p.elu = elu;
  p.vec_a = Cin % 4 == 0;
  p.vec_b = dx ? Cin % 4 == 0 : Cout % 4 == 0;
  p.lane_a = lane_a;
  p.lane_o = act_out == nullptr ? 0 : lane_o;
  p.lane_w = lane_w;
  p.lane_b = b == nullptr ? 0 : lane_b;
  p.lane_y = lane_y;
  p.lane_gp = gp == nullptr ? 0 : lane_gp;
  if (dx && elu && (act_out == nullptr || gp == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes < 1 || lanes > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto seq = std::make_integer_sequence<int, kNumTiles>{};
  return static_cast<int>(dx ? dispatch<true>(tile, p, lanes, s, seq)
                             : dispatch<false>(tile, p, lanes, s, seq));
}

const char* s2s_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
