// Kernel C1: the middle of the Conformer's conv module (wav2vec 2.0 Conformer,
// `Wav2Vec2ConformerConvolutionModule`), everything between its two pointwise
// convolutions in one launch a layer (wrapper:
// mmla_audio_torch/ops/cuda_conformer_conv.py):
//
//   g[t, c]   = y[t, c] * sigmoid(y[t, C + c])                  GLU, zero for t outside [0, T)
//   z[t, c]   = bias[c] + sum_{k < 31} taps[k, c] * g[t + k - 15, c]
//   out[t, c] = z * sigmoid(z)                                   swish
//
// for each batch row, with `taps` the depthwise convolution's weights and
// `bias` the shift of eval BatchNorm folded into them (w' = w gamma / sqrt(var +
// eps), b' = beta - mean gamma / sqrt(var + eps); the wrapper's fold).  The
// convolution runs over all T rows, padded frames included, as Hugging Face's.
//
// Replaces no TPU kernel: the JAX package has no Conformer.  It replaces the
// port's earlier path of four to five launches a layer (GLU, cuDNN's grouped
// direct convolution, BatchNorm, SiLU and layout copies), in which every
// intermediate made a round trip to device memory.
//
// Layouts: y (B, T, 2C) float32 contiguous, channels last (the pointwise_conv1
// product; 16-byte aligned, C % 4 == 0); taps (31, C) contiguous, tap by
// channel; bias (C,); out (B, T, C) contiguous, which pointwise_conv2 reads
// with no transpose.  Arithmetic in fp32 FMAs (no tensor core), whatever the
// TF32 policy: at least as exact as the stated TF32.
//
// Bound: bytes.  y is read once and out written once: at B = 64, T = 127, C =
// 1024, 66.6 MB + 33.3 MB, 29.8 us at 3.35 TB/s; the 31-tap FMAs are 0.52
// GFLOP, ~8 us on the CUDA cores.
//
// Design.  A CTA of 256 threads owns one batch row, a tile of `ct` channels
// (32 or 64; the wrapper picks it so that the grid fills the card) and a
// tile of `tt` time rows (the whole T up to 256; longer rows in near-equal
// tiles).  It loads y's two halves for its channels with 16-byte loads (ct / 4
// threads read a row's 4 ct contiguous bytes of each half), four loads a
// thread in flight, forms the GLU and writes it to shared memory.  The halo:
// shared row r holds time t0 - 15 + r, for the tile's tt rows and the 15 rows
// either side; a row outside [0, T) is written as zeros (the convolution's
// padding), so the taps never test a bound, and a tile of a longer T reads its
// neighbours' 30 rows again (12 % more at T = 511).  Each thread then takes one
// channel, its 31 taps in registers, and runs of 8 consecutive outputs: a run
// reads 38 shared rows (conflict-free: a warp reads 32 adjacent channels of one
// row) into 8 fp32 accumulators started at the bias, applies swish and stores
// each output row of 32 channels as one 128-byte segment.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTaps = 31;
constexpr int kHalo = (kTaps - 1) / 2;
constexpr int kThreads = 256;
constexpr int kRun = 8;                    // outputs a thread computes in one pass
constexpr int kLoads = 4;                  // 16-byte loads of each half in flight a thread
constexpr int kMaxTile = 256;              // time rows a CTA

__host__ __device__ inline int padded_rows(int tt) {
  return (tt + kRun - 1) / kRun * kRun + 2 * kHalo;
}

__device__ inline float glu(float a, float gate) { return a / (1.f + expf(-gate)); }

__global__ void __launch_bounds__(kThreads)
    conformer_conv_kernel(const float* __restrict__ y, const float* __restrict__ taps,
                          const float* __restrict__ bias, float* __restrict__ out, int T, int C,
                          int ct, int tt) {
  extern __shared__ float4 smem4[];
  const float* g = reinterpret_cast<const float*>(smem4);
  const int c0 = blockIdx.x * ct, t0 = blockIdx.y * tt, b = blockIdx.z;
  const int quads = ct / 4, rows = padded_rows(tt), total = rows * quads;
  const float* yb = y + (long long)b * T * 2 * C;

  // GLU of rows t0 - 15 .. into shared memory, zeros outside [0, T) and C
  for (int e0 = threadIdx.x; e0 < total; e0 += kLoads * kThreads) {
    float4 a[kLoads], s[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * kThreads, r = e / quads, c = c0 + 4 * (e % quads);
      const int t = t0 - kHalo + r;
      a[u] = s[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < total && t >= 0 && t < T && c < C) {
        const float* src = yb + (long long)t * 2 * C + c;
        a[u] = __ldg(reinterpret_cast<const float4*>(src));
        s[u] = __ldg(reinterpret_cast<const float4*>(src + C));
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * kThreads;
      if (e < total)
        smem4[e] = make_float4(glu(a[u].x, s[u].x), glu(a[u].y, s[u].y), glu(a[u].z, s[u].z),
                               glu(a[u].w, s[u].w));
    }
  }
  __syncthreads();

  const int ch = threadIdx.x % ct, groups = kThreads / ct, c = c0 + ch;
  if (c >= C) return;                      // no barrier follows
  float w[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) w[k] = __ldg(taps + k * C + c);
  const float bc = __ldg(bias + c);
  const int n = min(tt, T - t0);
  for (int r0 = threadIdx.x / ct * kRun; r0 < n; r0 += groups * kRun) {
    float acc[kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i) acc[i] = bc;
    // output r0 + i reads shared rows r0 + i .. r0 + i + 30 (times t - 15 .. t + 15)
    const float* src = g + r0 * ct + ch;
#pragma unroll
    for (int j = 0; j < kRun + kTaps - 1; ++j) {
      const float v = src[j * ct];
#pragma unroll
      for (int i = 0; i < kRun; ++i)
        if (j - i >= 0 && j - i < kTaps) acc[i] = fmaf(w[j - i], v, acc[i]);
    }
    float* dst = out + ((long long)b * T + t0 + r0) * C + c;
#pragma unroll
    for (int i = 0; i < kRun; ++i)
      if (r0 + i < n) dst[(long long)i * C] = acc[i] / (1.f + expf(-acc[i]));
  }
}

}  // namespace

// Launch C1 on `stream` (layouts above; every pointer on the card, y 16-byte
// aligned): grid (C / ct, T / tt, B), both rounded up.  `ct` 32 or 64
// channels a CTA, `tt` 1 .. 256 time rows.  Returns the cudaError_t of the
// launch (0 on success), cudaErrorInvalidValue for sizes it does not take.
extern "C" int conformer_conv_launch(const float* y, const float* taps, const float* bias,
                                     float* out, int B, int T, int C, int ct, int tt,
                                     void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || C <= 0 || C % 4 != 0 ||
      (ct != 32 && ct != 64) || tt <= 0 || tt > kMaxTile)
    return (int)cudaErrorInvalidValue;
  const int smem = padded_rows(tt) * ct * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(conformer_conv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + ct - 1) / ct, (T + tt - 1) / tt, B);
  conformer_conv_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(y, taps, bias, out, T, C,
                                                                        ct, tt);
  return (int)cudaGetLastError();
}
