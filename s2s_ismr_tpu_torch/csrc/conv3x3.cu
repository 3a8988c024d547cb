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
// What bounds it: at the U-Net's widths (C, O <= 96, H, W <= 32, batch 16)
// a call does at most ~85 MFLOP and moves at most a few MB, so the least
// time the card could take is 0.1-1.3 us (f32 FLOP or bytes), below the
// ~1 us a trivial kernel takes to launch and end. With a few blocks per SM
// and a few warps per scheduler, a launch is latency-bound: its time is a
// fixed part (~4 us: launch, prologue, first loads, epilogue), the serial
// chain of its K loop (per chunk: wait, barrier, address arithmetic, the
// next copies, dependent mma), and, at the 32x32 maps, the L2 bytes of the
// A gathers (each input pixel is read once per tap). Measured, and fitted
// as the wrapper's tile cost model, by kernels/conv_bench.py (PERF.md).
// Each choice below works on one of those:
//
//  1. Implicit GEMM over flattened pixels: M = N*H*W rows (images and rows
//     share a tile, so a 4x4 map wastes no columns: a 64-row tile holds
//     four images), the GEMM's N = output channels, K = 9*Cin tap-major,
//     the order of the (9C, O) weight matrix. The K loop stops at 9*Cin:
//     chunks of 64 k values may span taps, the last chunk is zero-filled
//     and k8 steps past K are skipped. Tile BM x BN from a small table
//     (kTiles below), picked per call by the wrapper (kernels/conv.py,
//     _pick_tile, a cost model fitted to measured times) from (M, Cout,
//     K): narrow layers get 8- or 16-wide tiles (no idle warps on O = 8,
//     12, 16), and small maps get 16-row tiles whose four warps split K,
//     which shortens the serial chain and still fills the card.
//  2. Tensor cores at float32 accuracy: mma.sync m16n8k8 TF32 with the
//     3xTF32 split (a = a_hi + a_lo; acc += a_lo*b_hi + a_hi*b_lo +
//     a_hi*b_hi), so the error stays at the f32 level (rtol 1e-4 / atol
//     1e-5 against float64). Each chunk's products are summed in fresh
//     tensor-core accumulators and then added, round-to-nearest, into the
//     f32 total, so the tensor cores' own rounding of the sum never sees
//     the whole of K; a small warp tile gives each of the three terms its
//     own accumulator, so its mma are three short chains, not one long one.
//  3. Asynchronous copies: A is gathered per tap from the NHWC input by
//     cp.async straight into shared memory (zfill gives the halo's zeros;
//     no im2col in device memory), the weight tile likewise, in a ring of
//     2-3 stages (as deep as keeps two blocks on an SM) so the next chunks
//     load while the current one multiplies. 16-byte copies where the
//     channel count allows (Cin % 4 == 0), 4-byte copies otherwise (C = 1,
//     the first conv).
//     Index arithmetic is 32-bit and divides by a float reciprocal (fdiv):
//     on the latency-bound chain every instruction counts.
//  4. Deterministic sums, no atomics: tiles that split K between the warps
//     of a block add the partial tiles in shared memory in a fixed order,
//     so a launch sums in the same order every time (a winner reloaded
//     from disk replays its predictions bit for bit).
//  5. Epilogue in registers: bias and ELU (expm1f); each quad of lanes
//     stores 32 contiguous bytes of one pixel's output channels.
//  6. The dx mode reads the adjoint itself: tap (dy, dx) of the adjoint is
//     w[2-dy][2-dx][c][o], read from the forward's (3,3,C,O) weights with O
//     as the reduction; no flipped or transposed copy is made. For an ELU
//     conv it also stages the saved output beside g, and each thread turns
//     the g it copied into g' = g * ELU'(out) in shared memory before the
//     barrier; the blocks of the first output-channel tile write g' once
//     per pixel (from the centre tap), for dw and db.
//
//  7. Lane mode: the counterpart of the Pallas kernel under jax.vmap (the
//     batching rule adds a lane axis to its grid, so each lane runs with
//     its own weights). The lane is the grid's z axis; every operand has a
//     lane stride in floats (64-bit), 0 for an operand all lanes share
//     (the x of a winner forward). A block reads its lane's operands
//     through pointers offset once at entry, and does exactly the work of
//     a one-lane launch of that lane, so with the same tile lane i is bit
//     for bit the one-lane result. Limits hold per lane.
//
// The kernel allocates nothing and runs on the caller's stream. The C entry
// points return cudaGetLastError() so the caller can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;          // 4 warps
constexpr int kBK = 64;                // k values per chunk (conv.py, _BK)
constexpr int kMaxStages = 3;          // cp.async ring depth, at most
constexpr int kQuads = kBK / 4;        // 16-byte quads per chunk row
constexpr int kRowStride = kBK + 4;    // smem floats per A row / dx-B row

// tile table: BM, BN, WM x WN warps over the tile, the rest split K
struct Tile { int bm, bn, wm, wn; };
constexpr Tile kTiles[] = {
    {64, 8, 4, 1},    // 0: warp 16x8
    {32, 8, 2, 1},    // 1: warp 16x8, K split 2
    {16, 8, 1, 1},    // 2: warp 16x8, K split 4
    {128, 16, 4, 1},  // 3: warp 32x16
    {64, 16, 4, 1},   // 4: warp 16x16
    {32, 16, 2, 1},   // 5: warp 16x16, K split 2
    {16, 16, 1, 1},   // 6: warp 16x16, K split 4
    {64, 32, 2, 2},   // 7: warp 32x16
    {32, 32, 2, 1},   // 8: warp 16x32, K split 2
    {16, 32, 1, 1},   // 9: warp 16x32, K split 4
};
constexpr int kNumTiles = sizeof(kTiles) / sizeof(kTiles[0]);

struct Params {
  // one lane's operands; lane z reads and writes them offset by z * the
  // operand's lane stride below
  const float* a;        // (N,H,W,Cin): x (forward) or g (dx mode)
  const float* act_out;  // dx mode, ELU conv: saved output (N,H,W,Cin)
  const float* w;        // (3,3,C,O) of the forward conv
  const float* bias;     // forward: (Cout,) or null
  float* y;              // (N,H,W,Cout)
  float* gp;             // dx mode, ELU conv: g' (N,H,W,Cin)
  int H, W, Cin, Cout;
  int M, K;              // M = N*H*W, K = 9*Cin
  float inv_cin, inv_hw, inv_w;   // 1 / Cin, 1 / (H*W), 1 / W for fdiv
  int elu;               // forward: ELU epilogue; dx mode: ELU' on A
  int vec_a, vec_b;      // 16-byte copies for A / B
  // lane strides in floats (0: shared by every lane)
  long long lane_a, lane_o, lane_w, lane_b, lane_y, lane_gp;
};

__device__ __forceinline__ unsigned smem_addr(const float* p) {
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
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
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

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

template <int BM, int BN, int WM, int WN, bool DX>
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
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
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
  const int nchunks = (K + kBK - 1) / kBK;

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
    if (s < nchunks) load_chunk(s, s);
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
      load_chunk(c + kStages - 1, (c + kStages - 1) % kStages);
    cp_async_commit();

    const float* As = smem + (c % kStages) * stage;
    const float* Bs = As + sa + so;
    const int k0 = c * kBK;

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
    if (wk > 0) return;
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
          float v = acc[i][j][2 * h2 + e];
          if (!DX) {
            if (pbias != nullptr && n + e < Cout) v += pbias[n + e];
            if (p.elu) v = v > 0.f ? v : expm1f(v);
          }
          z[e] = v;
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

constexpr int kMaxDevices = 64;

template <int BM, int BN, int WM, int WN, bool DX>
cudaError_t launch(const Params& p, int lanes, cudaStream_t stream) {
  constexpr int KS = kThreads / 32 / (WM * WN);
  const bool has_o = DX && p.elu;
  const int pipe = stages<BM, BN, DX>() * stage_floats<BM, BN, DX>(has_o);
  const int red = (KS - 1) * BM * BN;
  const size_t bytes = sizeof(float) * (pipe > red ? pipe : red);
  auto kernel = conv3x3_mma_kernel<BM, BN, WM, WN, DX>;
  // the shared-memory limit is an attribute of the kernel on each device
  // (lanes of a mesh run on several cards, from several host threads:
  // setting it twice is harmless)
  static size_t allowed[kMaxDevices] = {};
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
  dim3 grid((p.M + BM - 1) / BM, (p.Cout + BN - 1) / BN, lanes);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

static_assert(kNumTiles == 10, "dispatch lists every tile");

template <bool DX>
cudaError_t dispatch(int tile, const Params& p, int lanes, cudaStream_t s) {
  switch (tile) {
#define S2S_TILE(I)                                                     \
  case I:                                                               \
    return launch<kTiles[I].bm, kTiles[I].bn, kTiles[I].wm, kTiles[I].wn, \
                  DX>(p, lanes, s);
    S2S_TILE(0) S2S_TILE(1) S2S_TILE(2) S2S_TILE(3) S2S_TILE(4)
    S2S_TILE(5) S2S_TILE(6) S2S_TILE(7) S2S_TILE(8) S2S_TILE(9)
#undef S2S_TILE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The tile table, for the wrapper's selection rule: returns the number of
// tiles; fills (bm, bn, wm, wn) of tile `i` when 0 <= i < that number.
int s2s_conv3x3_tile(int i, int* bm, int* bn, int* wm, int* wn) {
  if (i >= 0 && i < kNumTiles) {
    *bm = kTiles[i].bm; *bn = kTiles[i].bn;
    *wm = kTiles[i].wm; *wn = kTiles[i].wn;
  }
  return kNumTiles;
}

// k values per chunk of the K loop, for the wrapper's cost model.
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
int s2s_conv3x3_f32(const float* a, const float* act_out, const float* w,
                    const float* b, float* y, float* gp, int N, int H, int W,
                    int Cin, int Cout, int dx, int elu, int tile, int lanes,
                    long long lane_a, long long lane_o, long long lane_w,
                    long long lane_b, long long lane_y, long long lane_gp,
                    void* stream) {
  Params p;
  p.a = a; p.act_out = act_out; p.w = w; p.bias = b; p.y = y; p.gp = gp;
  p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout;
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
  return static_cast<int>(dx ? dispatch<true>(tile, p, lanes, s)
                             : dispatch<false>(tile, p, lanes, s));
}

const char* s2s_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
