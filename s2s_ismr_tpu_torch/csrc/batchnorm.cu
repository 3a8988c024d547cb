// Train-mode weighted BatchNorm, float32, channel last, for Hopper (sm_90):
// the forward (batch statistics, normalization, running update) in one
// launch and its backward (dx, dscale, dbias) in one launch.
//
// Replaces no TPU kernel. The JAX package writes BatchNorm as plain array
// algebra (s2s_ismr_tpu/models/layers.py) and XLA fused it on the TPU; eager
// PyTorch does not, so autograd turned each layer into ~16 forward and ~37
// backward launches over the same few hundred KB (about a third of a
// one-lane 32x32 U-Net step's device time). These two kernels take their
// place in the one-lane training programs.
//
//   x (rows, C), rows = N * per_sample (an NHWC map or an (N, F) matrix),
//   w (N,) sample weights, row r weighted by w[r / per_sample]:
//     tot  = max(sum(w) * per_sample, 1)
//     mean = sum_r w_r x_r / tot
//     var  = sum_r w_r (x_r - mean)^2 / tot         (two passes, biased)
//     inv  = 1 / sqrt(var + 1e-3)
//     y    = (x - mean) * inv * scale + bias
//     running stats r = 0.99 r + 0.01 stat, in place, when sum(w) > 0
//   backward, with A = sum_r g_r, B = sum_r g_r xhat_r, xhat = (x-mean)*inv,
//   W = sum(w) * per_sample, k1 = inv * scale:
//     dbias = A, dscale = B,
//     dx_r  = k1 g_r - (w_r / tot) (k1 B xhat_r + k1 A - K3),
//     K3    = inv^2 scale B mean (tot - W) / tot   (0 unless W < 1)
//   the closed form of autograd's gradient of the same formula (a float64
//   mirror of it is tested against autograd in tests/test_torch_batchnorm.py).
//
// What bounds it: latency, then bytes. A layer is 16 K - 786 K floats
// (0.06-3.1 MB), just written by the conv before it and resident in the
// 50 MB L2, with a few operations per element: the bytes take 0.04-2.8 us
// at 3.35 TB/s, below what a chain of dependent steps (loads, block
// barriers, cluster barriers) takes. So each direction is one launch with
// as few such steps as the statistics allow:
//  - one cluster of S blocks of 512 threads (S = 1 to 16, from rows x C:
//    cluster_size below) walks the rows, block `rank` taking every
//    S-th group of rr rows; a thread holds one column group of 4 channels
//    (16-byte loads; 1 channel when C % 4 != 0) and loads 4 of its rows
//    before it uses them;
//  - a block's per-channel sums: the lanes of a column group in a warp by
//    shuffles, then the warps (or, above 32 column groups, the thread rows)
//    in order through shared memory;
//  - the blocks' partials are combined through distributed shared memory:
//    every block adds the S partials in rank order, so each block holds the
//    same bits and no second launch or atomic is needed;
//  - the forward reads x for the sums, the squared deviations from the
//    mean (two passes, as the plain version) and the normalization, the
//    backward g and x for A and sum(g x) (B = inv (sum(g x) - mean A); the
//    products are exact in float64) and for dx; where a thread has at most
//    4 rows its loads stay in registers from the first pass to the last;
//  - the per-channel inputs (scale, bias, running statistics, the
//    forward's mean and inv) are loaded at the start, used after the
//    cluster barrier.
// Every reduction runs in a fixed order, so a launch repeats bit for bit.
// The tensors are float32 (no TF32 anywhere); the sums are accumulated, and
// the per-channel statistics and coefficients computed, in float64, so that
// each result is one float32 rounding of nearly exact sums (the plain
// version rounds every op) and 1e-3 enters the variance unrounded. The
// per-element work is float32: y = fmaf(x - mean, inv * scale, bias), and
// dx from the per-channel coefficients by two fmaf.
//
// The kernel allocates nothing and runs on the caller's stream; the C entry
// point returns a CUDA error code so the caller can raise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kU = 4;                  // rows a thread loads before using
constexpr int kMaxCluster = 16;
constexpr int kClusterRows = 2;        // rows a thread sums, at most, where
                                       // the cluster size allows
constexpr int kClusterChannels = 8192; // S C, at most: each block adds S
                                       // partials per channel
constexpr int kMaxChannels = 2048;
// channels a thread finishes after the cluster barrier, at most
constexpr int kPerThread = kMaxChannels / kThreads;
constexpr int kMaxDevices = 64;
constexpr double kMomentum = 0.99;
constexpr double kEps = 1e-3;

struct BnParams {
  const float* x;
  const float* g;          // backward: the gradient of y
  const float* w;          // (n,) sample weights
  const float* scale;
  const float* bias;
  float* out;              // forward: y; backward: dx
  float* run_mean;         // forward: updated in place
  float* run_var;
  double* save_mean;       // written by the forward, read by the backward
  double* save_inv;
  float* dscale;           // backward
  float* dbias;
  int rows, C, n, per_sample;
  int cw;      // column groups (V floats each) of a chunk: a power of two
               // up to 32, else up to kThreads
  int rr;      // thread rows: kThreads / cw
  int chunks;  // chunks of cw column groups
};

template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// split cluster barrier: arrive when done reading the peers' shared
// memory, wait before exiting (a peer may still read this block's)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The sample weights' sum, the same order in every block, in two steps so
// that the loads overlap the first pass: the first warp's loads and lane
// sums, then (by every thread) the warp's sum through `slot`.
__device__ __forceinline__ float weight_part(const BnParams& p) {
  float s = 0.f;
  if (threadIdx.x < 32)
    for (int i = threadIdx.x; i < p.n; i += 32) s += p.w[i];
  return s;
}

__device__ float weight_sum(float part, float* slot) {
  if (threadIdx.x < 32) {
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_down_sync(0xffffffffu, part, off);
    if (threadIdx.x == 0) *slot = part;
  }
  __syncthreads();
  return *slot;
}

// This thread's place in chunk `chunk`: its column group's first channel
// c0 and its thread row tr; `on` when both exist.
struct Place {
  int col, tr, c0;
  bool on;
};

template <int V>
__device__ __forceinline__ Place place(const BnParams& p, int chunk) {
  Place q;
  q.col = threadIdx.x % p.cw;
  q.tr = threadIdx.x / p.cw;
  q.c0 = V * (chunk * p.cw + q.col);
  q.on = q.tr < p.rr && q.c0 < p.C;
  return q;
}

// Walks this block's rows of the thread row tr (rank * rr + tr, stepping
// S * rr) kU at a time: load(u, r) for each row of the batch (unless
// `reload` is false: the batch is still in registers), then use(u, r);
// r = -1 past the last row.
template <class L, class F>
__device__ __forceinline__ void walk(const BnParams& p, int rank, int S,
                                     int tr, bool reload, L load, F use) {
  const int step = S * p.rr;
  for (int r0 = rank * p.rr + tr; r0 < p.rows; r0 += kU * step) {
    if (reload) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int r = r0 + u * step;
        load(u, r < p.rows ? r : -1);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = r0 + u * step;
      use(u, r < p.rows ? r : -1);
    }
  }
}

// The block's NA per-channel sums of chunk `chunk` into part[a * C + c],
// from each thread's sums s of its rows, in a fixed order: up to 32 column
// groups, the lanes of a column group in a warp by shuffles, then the 16
// warps in order; above 32, the thread rows in order.
template <int V, int NA>
__device__ void block_sums(const BnParams& p, double (&s)[NA][V],
                           double* red, double* part, int chunk) {
  const int t = threadIdx.x, lane = t & 31;
  const Place q = place<V>(p, chunk);
  const int span = p.cw * V;
  int groups = p.rr;
  int g = q.tr;
  if (p.cw <= 32) {
    for (int off = 16; off >= p.cw; off >>= 1)
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int v = 0; v < V; ++v)
          s[a][v] += __shfl_xor_sync(0xffffffffu, s[a][v], off);
    groups = kWarps;
    g = lane < p.cw ? t >> 5 : -1;
  }
  if (g >= 0 && g < groups) {
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int v = 0; v < V; ++v)
        red[(a * groups + g) * span + q.col * V + v] = s[a][v];
  }
  __syncthreads();
  for (int e = t; e < NA * span; e += kThreads) {
    const int a = e / span, j = e % span;
    const int c = chunk * span + j;
    double sum = 0.0;
    for (int k = 0; k < groups; ++k) sum += red[(a * groups + k) * span + j];
    if (c < p.C) part[a * p.C + c] = sum;
  }
  __syncthreads();                      // red is reused
}

// the S blocks' partials of entry i, added in rank order (the loads
// issued together; a rank past S adds an exact 0)
__device__ __forceinline__ double rank_sum(cg::cluster_group& cluster,
                                           double* part, int i, int S) {
  double v[kMaxCluster];
#pragma unroll
  for (int j = 0; j < kMaxCluster; ++j)
    v[j] = j < S ? cluster.map_shared_rank(part, j)[i] : 0.0;
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < kMaxCluster; ++j) s += v[j];
  return s;
}

template <int V>
__device__ __forceinline__ void zero(float (&v)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = 0.f;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    bn_train_fwd_kernel(const BnParams p) {
  extern __shared__ double smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = p.C, t = threadIdx.x;
  double* red = smem;                     // 2 kThreads V
  double* part = red + 2 * kThreads * V;  // 2C: sums, squared deviations
  double* mean = part + 2 * C;            // C
  float* meanf = reinterpret_cast<float*>(mean + C);  // C
  float* k1 = meanf + C;                  // C: inv * scale
  float* bias = k1 + C;                   // C
  float* slot = bias + C;                 // the weights' sum
  // with one chunk and at most kU rows a thread, the rows stay in
  // registers from the first pass to the last
  const bool kept = p.chunks == 1 && p.rows <= kU * S * p.rr;
  float xv[kU][V];
  double wr[kU];
  const auto load_x = [&](const Place& q, int u, int r) {
    if (r < 0) {
      zero<V>(xv[u]);
      wr[u] = 0.0;
      return;
    }
    load<V>(p.x + static_cast<size_t>(r) * C + q.c0, xv[u]);
    wr[u] = __ldg(p.w + r / p.per_sample);
  };
  const float wpart = weight_part(p);
  // channel t + k kThreads: scale, bias, running mean and var, loaded now
  // and used once the statistics are known
  float pre[kPerThread][4];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int c = t + k * kThreads;
    if (c < C) {
      pre[k][0] = p.scale[c];
      pre[k][1] = p.bias[c];
      pre[k][2] = p.run_mean[c];
      pre[k][3] = p.run_var[c];
    }
  }

  for (int chunk = 0; chunk < p.chunks; ++chunk) {
    const Place q = place<V>(p, chunk);
    double s[1][V] = {};
    if (q.on)
      walk(p, rank, S, q.tr, true,
           [&](int u, int r) { load_x(q, u, r); },
           [&](int u, int) {
#pragma unroll
             for (int v = 0; v < V; ++v)
               s[0][v] = fma(wr[u], double(xv[u][v]), s[0][v]);
           });
    block_sums<V, 1>(p, s, red, part, chunk);
  }
  const float wsum = weight_sum(wpart, slot);
  const double tot = fmaxf(wsum * static_cast<float>(p.per_sample), 1.f);
  const double rtot = 1.0 / tot;
  cluster.sync();
  for (int c = t; c < C; c += kThreads) {
    mean[c] = rank_sum(cluster, part, c, S) * rtot;
    meanf[c] = static_cast<float>(mean[c]);
  }
  __syncthreads();

  for (int chunk = 0; chunk < p.chunks; ++chunk) {
    const Place q = place<V>(p, chunk);
    double s[1][V] = {};
    if (q.on)
      walk(p, rank, S, q.tr, !kept,
           [&](int u, int r) { load_x(q, u, r); },
           [&](int u, int) {
#pragma unroll
             for (int v = 0; v < V; ++v) {
               const double d = double(xv[u][v]) - mean[q.c0 + v];
               s[0][v] = fma(wr[u] * d, d, s[0][v]);
             }
           });
    block_sums<V, 1>(p, s, red, part + C, chunk);
  }
  cluster.sync();
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int c = t + k * kThreads;
    if (c >= C) continue;
    const double var = rank_sum(cluster, part + C, c, S) * rtot;
    const double inv = rsqrt(var + kEps);
    k1[c] = static_cast<float>(inv * pre[k][0]);
    bias[c] = pre[k][1];
    if (rank == 0) {
      p.save_mean[c] = mean[c];
      p.save_inv[c] = inv;
      if (wsum > 0.f) {
        p.run_mean[c] = static_cast<float>(kMomentum * pre[k][2] +
                                           (1.0 - kMomentum) * mean[c]);
        p.run_var[c] = static_cast<float>(kMomentum * pre[k][3] +
                                          (1.0 - kMomentum) * var);
      }
    }
  }
  cluster_arrive();                       // done with the peers' partials
  __syncthreads();

  for (int chunk = 0; chunk < p.chunks; ++chunk) {
    const Place q = place<V>(p, chunk);
    if (!q.on) continue;
    walk(p, rank, S, q.tr, !kept,
         [&](int u, int r) { load_x(q, u, r); },
         [&](int u, int r) {
           if (r < 0) return;
           float yv[V];
#pragma unroll
           for (int v = 0; v < V; ++v)
             yv[v] = fmaf(xv[u][v] - meanf[q.c0 + v], k1[q.c0 + v],
                          bias[q.c0 + v]);
           store<V>(p.out + static_cast<size_t>(r) * C + q.c0, yv);
         });
  }
  cluster_wait();
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    bn_train_bwd_kernel(const BnParams p) {
  extern __shared__ double smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = p.C, t = threadIdx.x;
  double* red = smem;                     // 2 kThreads V
  double* part = red + 2 * kThreads * V;  // 2C: sum(g), sum(g x)
  float* meanf = reinterpret_cast<float*>(part + 2 * C);  // C
  float* invf = meanf + C;                // C
  float* k1 = invf + C;                   // C: inv * scale
  float* kb = k1 + C;                     // C: k1 B / tot
  float* ka = kb + C;                     // C: (k1 A - K3) / tot
  float* slot = ka + C;                   // the weights' sum
  const bool kept = p.chunks == 1 && p.rows <= kU * S * p.rr;
  float gv[kU][V], xv[kU][V], wr[kU];
  const auto load_gx = [&](const Place& q, int u, int r) {
    if (r < 0) {
      zero<V>(gv[u]);
      zero<V>(xv[u]);
      wr[u] = 0.f;
      return;
    }
    const size_t off = static_cast<size_t>(r) * C + q.c0;
    load<V>(p.g + off, gv[u]);
    load<V>(p.x + off, xv[u]);
    wr[u] = __ldg(p.w + r / p.per_sample);
  };
  const float wpart = weight_part(p);
  // channel t + k kThreads: the forward's mean and inv, and scale
  double pre[kPerThread][3];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int c = t + k * kThreads;
    if (c < C) {
      pre[k][0] = p.save_mean[c];
      pre[k][1] = p.save_inv[c];
      pre[k][2] = p.scale[c];
    }
  }

  // A = sum(g) and sum(g x), whose products are exact in float64, so that
  // B = sum(g xhat) = inv (sum(g x) - mean A) needs no statistics here
  for (int chunk = 0; chunk < p.chunks; ++chunk) {
    const Place q = place<V>(p, chunk);
    double s[2][V] = {};
    if (q.on)
      walk(p, rank, S, q.tr, true,
           [&](int u, int r) { load_gx(q, u, r); },
           [&](int u, int) {
#pragma unroll
             for (int v = 0; v < V; ++v) {
               s[0][v] += gv[u][v];
               s[1][v] = fma(double(gv[u][v]), double(xv[u][v]), s[1][v]);
             }
           });
    block_sums<V, 2>(p, s, red, part, chunk);
  }
  const float wsum = weight_sum(wpart, slot);
  const double wtot = wsum * static_cast<float>(p.per_sample);
  const double tot = fmax(wtot, 1.0);
  const double rtot = 1.0 / tot;
  cluster.sync();
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int c = t + k * kThreads;
    if (c >= C) continue;
    const double mean = pre[k][0], inv = pre[k][1];
    const double a = rank_sum(cluster, part, c, S);
    const double b = inv * (rank_sum(cluster, part + C, c, S) - mean * a);
    if (rank == 0) {
      p.dbias[c] = static_cast<float>(a);
      p.dscale[c] = static_cast<float>(b);
    }
    const double kc = inv * pre[k][2];
    const double k3 = kc * inv * b * mean * (tot - wtot) * rtot;
    meanf[c] = static_cast<float>(mean);
    invf[c] = static_cast<float>(inv);
    k1[c] = static_cast<float>(kc);
    kb[c] = static_cast<float>(kc * b * rtot);
    ka[c] = static_cast<float>((kc * a - k3) * rtot);
  }
  cluster_arrive();                       // done with the peers' partials
  __syncthreads();

  for (int chunk = 0; chunk < p.chunks; ++chunk) {
    const Place q = place<V>(p, chunk);
    if (!q.on) continue;
    walk(p, rank, S, q.tr, !kept,
         [&](int u, int r) { load_gx(q, u, r); },
         [&](int u, int r) {
           if (r < 0) return;
           float dx[V];
#pragma unroll
           for (int v = 0; v < V; ++v) {
             const int c = q.c0 + v;
             const float xh = (xv[u][v] - meanf[c]) * invf[c];
             dx[v] = fmaf(k1[c], gv[u][v], -wr[u] * fmaf(kb[c], xh, ka[c]));
           }
           store<V>(p.out + static_cast<size_t>(r) * C + q.c0, dx);
         });
  }
  cluster_wait();
}

// red (2 kThreads V doubles), the partials and the forward's mean (3C
// doubles), the float32 coefficients (5C floats) and the weights' sum
size_t smem_bytes(int V, int C) {
  return sizeof(double) * (2 * static_cast<size_t>(kThreads) * V + 3 * C) +
         sizeof(float) * (5 * C + 1);
}

// the dynamic shared memory limit and the cluster size above 8 are
// attributes of a kernel on each device (set once per device; lanes of a
// mesh launch from several host threads, and setting them twice is
// harmless)
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int V, bool* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_bytes(V, kMaxChannels)));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  done[dev] = true;
  return cudaSuccess;
}

// Blocks in the launch's one cluster: the least power of two that leaves
// each thread at most kClusterRows rows, within kMaxCluster and
// kClusterChannels / C (fitted to the main path's shapes on an H100,
// PERF.md). rr is the block's thread rows.
int cluster_size(int rows, int C, int rr) {
  const int want = (rows + kClusterRows * rr - 1) / (kClusterRows * rr);
  int cap = kClusterChannels / C;
  cap = cap < 1 ? 1 : cap > kMaxCluster ? kMaxCluster : cap;
  int s = 1;
  while (s < want && 2 * s <= cap) s <<= 1;
  return s;
}

template <int V>
cudaError_t launch(const BnParams& p, bool bwd, int S, cudaStream_t stream) {
  auto kernel = bwd ? bn_train_bwd_kernel<V> : bn_train_fwd_kernel<V>;
  static bool done[2][kMaxDevices] = {};
  cudaError_t e = prepare(kernel, V, done[bwd]);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(V, p.C);
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
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch of the forward (bwd = 0) or the backward (bwd = 1) over one
// cluster of `cluster` blocks (1 to 16; 0 or less: cluster_size's choice
// for the shape). All tensors contiguous on the
// device, float32 but for save_mean and save_inv (C,), float64: x (rows, C)
// and, for the backward, g (rows, C); w (n,) with rows = n * per_sample;
// scale (C,); bias (C,) for the forward (the backward reads none). The
// forward writes out = y (rows, C), save_mean and save_inv = 1 / sqrt(var +
// eps), and updates run_mean and run_var (C,) in place when sum(w) > 0; the
// backward reads save_mean and save_inv and writes out = dx (rows, C),
// dscale and dbias (C,). Limits: 1 <= C <= 2048, rows * C < 2^31. Anything
// else returns cudaErrorInvalidValue.
int s2s_batchnorm_f32(int bwd, const float* x, const float* g, const float* w,
                      const float* scale, const float* bias, float* out,
                      float* run_mean, float* run_var, double* save_mean,
                      double* save_inv, float* dscale, float* dbias, int rows,
                      int C, int n, int per_sample, int cluster,
                      void* stream) {
  if (C < 1 || C > kMaxChannels || rows < 1 || n < 1 || per_sample < 1 ||
      static_cast<long long>(n) * per_sample != rows ||
      static_cast<long long>(rows) * C >= (1LL << 31) ||
      cluster > kMaxCluster || (bwd && g == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(bwd ? g : x);
  const int V = C % 4 == 0 && addr % 16 == 0 ? 4 : 1;
  BnParams p = {};
  p.x = x; p.g = g; p.w = w; p.scale = scale; p.bias = bias; p.out = out;
  p.run_mean = run_mean; p.run_var = run_var;
  p.save_mean = save_mean; p.save_inv = save_inv;
  p.dscale = dscale; p.dbias = dbias;
  p.rows = rows; p.C = C; p.n = n; p.per_sample = per_sample;
  const int groups = C / V;
  p.cw = 1;
  while (p.cw < groups && p.cw < 32) p.cw <<= 1;
  if (groups > 32) p.cw = groups < kThreads ? groups : kThreads;
  p.rr = kThreads / p.cw;
  p.chunks = (groups + p.cw - 1) / p.cw;
  if (cluster < 1) cluster = cluster_size(rows, C, p.rr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(V == 4 ? launch<4>(p, bwd != 0, cluster, s)
                                 : launch<1>(p, bwd != 0, cluster, s));
}

}  // extern "C"
