// Fused SAME 3x3 convolution + bias + activation, NHWC float32, for Hopper.
//
// Replaces the Pallas TPU kernel s2s_ismr_tpu/kernels/conv.py:_conv_kernel
// (called through _conv_call). One launch computes
//
//   out[n,h,w,o] = act(b[o] + sum_{dy,dx,c} x[n,h+dy-1,w+dx-1,c] * k[dy,dx,c,o])
//
// with zero outside the image, act in {identity, ELU}. k is HWIO (3,3,C,O),
// contiguous, i.e. the (9C, O) matrix of the JAX kernel. The same kernel
// computes the input gradient of the conv (180-degree-rotated, C<->O
// transposed taps, no bias, identity act).
//
// What bounds it here: at the U-Net's widths (C, O <= 96, H, W <= 32, batch
// 16) a call moves at most a few MB (largest slice map 16x32x32x64x4 B =
// 4 MB) and does a few MFLOP, so it is bound by launch latency and by f32
// FMA issue, not by bytes. The design therefore aims at no idle lanes and no
// bank conflicts rather than at data reuse:
//   * one block per (n, output row h, 32-column tile, 32-output-channel tile);
//     the 32 lanes of a warp own 32 consecutive output channels, so weight
//     reads from shared memory are conflict-free and output stores coalesce;
//   * the four warps of the block split the columns, 8 columns per thread,
//     accumulated in f32 registers;
//   * the three input rows (with a one-pixel zero halo) and the 9 x CC x 32
//     weight slice are staged in shared memory, CC = 16 input channels per
//     pass, looping over C; each input value read is a warp broadcast.
// No tensor cores: a wgmma / TF32 or bf16 version is later work.
//
// The kernel allocates nothing and runs on the caller's stream. The C entry
// point returns cudaGetLastError() so the caller can raise on a refused
// launch.

#include <cuda_runtime.h>

namespace {

constexpr int kTileO = 32;               // output channels per block (= lanes)
constexpr int kWarps = 4;                // warps per block
constexpr int kTileW = 32;               // output columns per block
constexpr int kPerThread = kTileW / kWarps;   // columns per thread
constexpr int kChunkC = 16;              // input channels staged per pass

__global__ void __launch_bounds__(kTileO * kWarps)
conv3x3_bias_act_kernel(const float* __restrict__ x,
                        const float* __restrict__ k,
                        const float* __restrict__ b,
                        float* __restrict__ out,
                        int H, int W, int C, int O, int n_wtiles, int elu) {
  __shared__ float xs[3][kTileW + 2][kChunkC];
  __shared__ float ks[9][kChunkC][kTileO];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * kTileO + lane;
  const int o0 = (blockIdx.x / n_wtiles) * kTileO;
  const int w0 = (blockIdx.x % n_wtiles) * kTileW;
  const int h = blockIdx.y;
  const int n = blockIdx.z;

  float acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kChunkC) {
    // input rows h-1..h+1, columns w0-1..w0+kTileW, channels c0..c0+kChunkC-1
    for (int i = tid; i < 3 * (kTileW + 2) * kChunkC; i += kTileO * kWarps) {
      const int cc = i % kChunkC;
      const int col = (i / kChunkC) % (kTileW + 2);
      const int r = i / (kChunkC * (kTileW + 2));
      const int hh = h + r - 1, ww = w0 + col - 1, c = c0 + cc;
      float v = 0.f;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W && c < C)
        v = x[((static_cast<size_t>(n) * H + hh) * W + ww) * C + c];
      xs[r][col][cc] = v;
    }
    for (int i = tid; i < 9 * kChunkC * kTileO; i += kTileO * kWarps) {
      const int oo = i % kTileO;
      const int cc = (i / kTileO) % kChunkC;
      const int tap = i / (kTileO * kChunkC);
      const int c = c0 + cc, o = o0 + oo;
      ks[tap][cc][oo] = (c < C && o < O)
          ? k[(static_cast<size_t>(tap) * C + c) * O + o] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int cc = 0; cc < kChunkC; ++cc) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float kv = ks[dy * 3 + dx][cc][lane];
#pragma unroll
          for (int j = 0; j < kPerThread; ++j)
            acc[j] = fmaf(xs[dy][warp + j * kWarps + dx][cc], kv, acc[j]);
        }
      }
    }
    __syncthreads();
  }

  const int o = o0 + lane;
  if (o >= O) return;
  const float bias = b ? b[o] : 0.f;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int col = w0 + warp + j * kWarps;
    if (col < W) {
      float z = acc[j] + bias;
      if (elu) z = z > 0.f ? z : expm1f(z);
      out[((static_cast<size_t>(n) * H + h) * W + col) * O + o] = z;
    }
  }
}

}  // namespace

extern "C" {

// x (N,H,W,C), k (3,3,C,O), b (O,) or NULL for no bias, out (N,H,W,O): all
// contiguous float32 on the device. act: 0 = identity, 1 = ELU.
// Grid limits: H and N at most 65535 (checked by the caller).
int s2s_conv3x3_bias_act_f32(const float* x, const float* k, const float* b,
                             float* out, int N, int H, int W, int C, int O,
                             int act, void* stream) {
  const int n_wtiles = (W + kTileW - 1) / kTileW;
  const int n_otiles = (O + kTileO - 1) / kTileO;
  dim3 grid(n_otiles * n_wtiles, H, N);
  dim3 block(kTileO, kWarps);
  conv3x3_bias_act_kernel<<<grid, block, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      x, k, b, out, H, W, C, O, n_wtiles, act);
  return static_cast<int>(cudaGetLastError());
}

const char* s2s_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
