// Overlap featurizer for Hopper (sm_90a): float PCM windows -> quantized ZCR images.
//
// Replaces the TPU kernels `_kernel` (wrapper `_pallas_impl`) and
// `_kernel_grouped` (wrapper `_pallas_impl_grouped`) of
// mmla_audio_tpu/ops/pallas_features.py, public `overlap_model_input_pallas`.
// Per window: reflect-padded framing, Hann-windowed real DFT, power, mel
// projection (mel columns pre-reversed on the host, so rows come out
// flipped), power_to_db (ref = window max, amin 1e-10, top_db 80), min-max
// normalize, ZCR on edge-padded frames (/win), PNG quantize
// floor(clip(x, 0, 1) * 255).  Output (B, 3, M, T) float32 holding integers
// 0..255; R = ZCR, G = B = 1 - norm.
//
// What bounds it: at the default geometry (24000 samples, win 400, hop 160,
// 151 frames, 201 bins, 128 mels) one window needs ~56 MFLOP of fp32 (DFT
// 48.6, mel 7.8), reads 96 KB of signal and writes 232 KB.  The DFT bases
// (2 x 400 x 201 f32, 643 KB) and the mel matrix (103 KB) are shared by all
// windows and stay in L2; the loop is bound by the latency of those basis
// loads, so every basis value read feeds kFrames = 40 FMAs.
//
// Design: one CTA holds G windows (G = 1, 2 or 4, the template parameter;
// the TPU kernel's "group").  Each DFT pass computes F = 40 / G frames of
// each of its G windows, so a thread accumulates 40 frames whichever G is
// (registers allow ~40, see PERF.md) and the G windows share each basis load.
// Each pass stages only its span of each window's reflect-padded signal,
// (F - 1) * hop + win samples (26.5 KB at G = 1).  The window's (M, T) mel
// tile (77 KB) stays in shared memory at G = 1 (137 KB per CTA); it does not
// fit G times, so at G > 1 it goes to plane 1 of the window's own output
// image and the epilogue reads it back from L2 (61-71 KB per CTA, two CTAs
// per SM: the register file is the limit).  Frames are exactly T per window; the TPU
// kernel's padding to 152 rows was sublane tiling and is not copied.  A CTA
// whose last group is partial neither reads nor writes past the batch.  All
// arithmetic is IEEE fp32 on the CUDA cores (no tensor cores, so no TF32), as
// the TPU kernel ran its GEMMs at Precision.HIGHEST; every G gives the same
// bits, since each (frame, bin) and (frame, mel) sum runs in the same order.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 40;        // frames per DFT pass over all G windows (multiple of 8)
constexpr int kStage = 8;          // staged samples in flight per thread
constexpr float kAmin = 1e-10f;    // power_to_db amin
constexpr float kSnap = 1e-10f;    // zero_crossing_rate threshold
constexpr float kTopDb = 80.0f;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct MinOp {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};

// Reduce over the block; every thread gets the result.
template <class Op>
__device__ float block_reduce(float v, Op op, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();                 // earlier readers of scratch are done
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = scratch[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) v = op(v, scratch[w]);
  return v;
}

__device__ inline float quantize(float x) {
  return floorf(fminf(fmaxf(x, 0.0f), 1.0f) * 255.0f);
}

// power_to_db before the top_db clamp.  The __f*_rn intrinsics keep nvcc
// from contracting into FMAs, so the rounding matches the reference's
// separate multiply and subtract.
__device__ inline float to_db(float mel, float ref_db) {
  return __fsub_rn(__fmul_rn(10.0f, log10f(fmaxf(mel, kAmin))), ref_db);
}

// Staged samples per window: one pass's frames.
__host__ __device__ inline int span_of(int G, int hop, int win) {
  return round4((kFrames / G - 1) * hop + win);
}

template <int G>
__global__ void __launch_bounds__(kThreads)
overlap_features_kernel(const float* __restrict__ y, long long row_stride, int B, int n,
                        const float* __restrict__ cosb, const float* __restrict__ sinb,
                        const float* __restrict__ melb, float* out,
                        int win, int hop, int T, int M) {
  constexpr int F = kFrames / G;             // frames of each window per pass
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int half = win / 2;
  const int bins = win / 2 + 1;
  const int pstride = round4(bins);
  const int span = span_of(G, hop, win);
  float* sig = smem;                         // (G, span) reflect-padded samples
  float* pw = sig + G * span;                // (kFrames, pstride) power spectrum, row g * F + f
  float* zcr = pw + kFrames * pstride;       // (G, T)
  float* scratch = zcr + round4(G * T);      // (32,) reduction scratch
  float* melt = scratch + 32;                // (M, T) mel tile, G = 1 only

  const int b0 = blockIdx.x * G;
  const int MT = M * T;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;

  for (int t0 = 0; t0 < T; t0 += F) {
    const int nf = min(F, T - t0);           // frames of this pass
    const int len = (nf - 1) * hop + win;    // padded samples they cover
    const int origin = t0 * hop - half;      // signal index of the span's first sample
    __syncthreads();                         // the previous pass is done with sig and pw

    // 1. stage each window's span, reflect padding by index arithmetic (the
    // TPU version pre-gathered frames); windows past the batch stage zeros.
    // Each thread issues its loads before its stores, so they are in flight
    // together.
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float* yg = y + (long long)(b0 + g) * row_stride;
      const bool live = b0 + g < B;
      for (int p0 = 0; p0 < span; p0 += kStage * kThreads) {
        float v[kStage];
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
          const int p = p0 + u * kThreads + tid;
          int i = origin + p;
          if (i < 0) i = -i;
          else if (i >= n) i = 2 * (n - 1) - i;
          v[u] = live && p < len ? yg[i] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
          const int p = p0 + u * kThreads + tid;
          if (p < span) sig[g * span + p] = v[u];
        }
      }
    }
    __syncthreads();

    // 2. zero-crossing rate on edge-padded frames: one warp per frame.
    // Edge padding clamps the signal index; the clamped sample lies in the
    // span.  signbit(|z| <= snap ? 0 : z) is z < -snap.
    for (int r = warp; r < G * nf; r += nwarps) {
      const int g = r / nf, t = t0 + (r - g * nf);
      const float* s = sig + g * span - origin;
      int cnt = 0;
      for (int j = lane; j < win - 1; j += 32) {
        const int i0 = t * hop + j - half;
        const float a = s[min(max(i0, 0), n - 1)];
        const float b = s[min(max(i0 + 1, 0), n - 1)];
        cnt += (a < -kSnap) != (b < -kSnap);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
      if (lane == 0) zcr[g * T + t] = (float)cnt / (float)win;   // librosa divides by win
    }

    // 3. DFT power of the pass's frames; a ragged last pass repeats a frame
    for (int k = tid; k < bins; k += blockDim.x) {
      float re[kFrames], im[kFrames];
      int base[kFrames];
#pragma unroll
      for (int r = 0; r < kFrames; ++r) {
        re[r] = 0.0f;
        im[r] = 0.0f;
        base[r] = (r / F) * span + min(r % F, nf - 1) * hop;
      }
      for (int j = 0; j < win; j += 4) {
        const float c0 = cosb[(j + 0) * bins + k], s0 = sinb[(j + 0) * bins + k];
        const float c1 = cosb[(j + 1) * bins + k], s1 = sinb[(j + 1) * bins + k];
        const float c2 = cosb[(j + 2) * bins + k], s2 = sinb[(j + 2) * bins + k];
        const float c3 = cosb[(j + 3) * bins + k], s3 = sinb[(j + 3) * bins + k];
#pragma unroll
        for (int r = 0; r < kFrames; ++r) {
          const float4 x = *reinterpret_cast<const float4*>(sig + base[r] + j);
          re[r] = fmaf(x.x, c0, re[r]);
          im[r] = fmaf(x.x, s0, im[r]);
          re[r] = fmaf(x.y, c1, re[r]);
          im[r] = fmaf(x.y, s1, im[r]);
          re[r] = fmaf(x.z, c2, re[r]);
          im[r] = fmaf(x.z, s2, im[r]);
          re[r] = fmaf(x.w, c3, re[r]);
          im[r] = fmaf(x.w, s3, im[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kFrames; ++r)
        pw[r * pstride + k] = __fadd_rn(__fmul_rn(re[r], re[r]), __fmul_rn(im[r], im[r]));
    }
    __syncthreads();

    // 4. mel power into the tile (G = 1) or plane 1 of each window's image;
    // each item: one mel row m for 8 consecutive rows of pw
    for (int q = tid; q < M * (kFrames / 8); q += blockDim.x) {
      const int m = q % M, r0 = (q / M) * 8;
      float acc[8];
#pragma unroll
      for (int f = 0; f < 8; ++f) acc[f] = 0.0f;
      int b = 0;
      for (; b + 4 <= bins; b += 4) {
        const float w0 = melb[(b + 0) * M + m], w1 = melb[(b + 1) * M + m];
        const float w2 = melb[(b + 2) * M + m], w3 = melb[(b + 3) * M + m];
#pragma unroll
        for (int f = 0; f < 8; ++f) {
          const float4 p = *reinterpret_cast<const float4*>(pw + (r0 + f) * pstride + b);
          acc[f] = fmaf(p.x, w0, acc[f]);
          acc[f] = fmaf(p.y, w1, acc[f]);
          acc[f] = fmaf(p.z, w2, acc[f]);
          acc[f] = fmaf(p.w, w3, acc[f]);
        }
      }
      for (; b < bins; ++b) {
        const float w = melb[b * M + m];
#pragma unroll
        for (int f = 0; f < 8; ++f) acc[f] = fmaf(pw[(r0 + f) * pstride + b], w, acc[f]);
      }
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        const int g = (r0 + f) / F, fr = (r0 + f) % F;
        if (fr < nf && b0 + g < B) {
          float* dst = G == 1 ? melt : out + ((long long)(b0 + g) * 3 + 1) * MT;
          dst[m * T + t0 + fr] = acc[f];
        }
      }
    }
  }
  __syncthreads();                           // mel planes written and visible to the block

  // 5. per window: power_to_db with ref = window max, top_db clamp, min-max
  // normalize, image planes (3, M, T): R = ZCR, G = B = 1 - norm.  At G > 1
  // the mel plane is read three times from L2; the loops are unrolled so
  // that each thread keeps 8 loads in flight.  With
  // hi = max(db) and lo = max(min(db), hi - top_db), the clamped values'
  // extremes are exactly the one-window reference's.
  for (int g = 0; g < G && b0 + g < B; ++g) {
    float* ob = out + (long long)(b0 + g) * 3 * MT;
    const float* mel = G == 1 ? melt : ob + MT;
    float v = -INFINITY;
#pragma unroll 8
    for (int i = tid; i < MT; i += blockDim.x) v = fmaxf(v, mel[i]);
    const float ref = block_reduce(v, MaxOp(), scratch);
    const float ref_db = __fmul_rn(10.0f, log10f(fmaxf(ref, kAmin)));
    float lo = INFINITY, hi = -INFINITY;
#pragma unroll 8
    for (int i = tid; i < MT; i += blockDim.x) {
      const float d = to_db(mel[i], ref_db);
      lo = fminf(lo, d);
      hi = fmaxf(hi, d);
    }
    lo = block_reduce(lo, MinOp(), scratch);
    hi = block_reduce(hi, MaxOp(), scratch);
    const float floor_db = __fsub_rn(hi, kTopDb);
    lo = fmaxf(lo, floor_db);
    const float diff = __fsub_rn(hi, lo);
#pragma unroll 8
    for (int i = tid; i < MT; i += blockDim.x) {
      const float d = fmaxf(to_db(mel[i], ref_db), floor_db);
      const float norm = diff > 0.0f ? __fdiv_rn(__fsub_rn(d, lo), diff) : 0.0f;
      const float gb = quantize(__fsub_rn(1.0f, norm));
      ob[i] = quantize(zcr[g * T + i % T]);
      ob[MT + i] = gb;
      ob[2 * MT + i] = gb;
    }
  }
}

template <int G>
int launch(const float* y, long long row_stride, int B, int n, const float* cosb,
           const float* sinb, const float* melb, float* out, int win, int hop, int T,
           int M, cudaStream_t stream) {
  const int bins = win / 2 + 1;
  const size_t floats = (size_t)G * span_of(G, hop, win) + (size_t)kFrames * round4(bins) +
                        round4(G * T) + 32 + (G == 1 ? (size_t)round4(M * T) : 0);
  const size_t smem = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(overlap_features_kernel<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  overlap_features_kernel<G><<<(B + G - 1) / G, kThreads, smem, stream>>>(
      y, row_stride, B, n, cosb, sinb, melb, out, win, hop, T, M);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`.  y: (B, row_stride) float32 rows, the first n samples of
// each row used.  cosb/sinb: (win, win/2+1) Hann-windowed DFT bases.  melb:
// (win/2+1, M) mel filterbank, columns reversed.  out: (B, 3, M, T) float32.
// group: windows per CTA, 1, 2 or 4.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int overlap_features_launch(const float* y, long long row_stride, int B, int n,
                                       const float* cosb, const float* sinb,
                                       const float* melb, float* out,
                                       int win, int hop, int T, int M, int group,
                                       void* stream) {
  if (B <= 0 || n <= win / 2 || win % 4 != 0 || hop % 4 != 0 || T <= 0 || M <= 0 ||
      (T - 1) * hop + win > n + 2 * (win / 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (group) {
    case 1: return launch<1>(y, row_stride, B, n, cosb, sinb, melb, out, win, hop, T, M, s);
    case 2: return launch<2>(y, row_stride, B, n, cosb, sinb, melb, out, win, hop, T, M, s);
    case 4: return launch<4>(y, row_stride, B, n, cosb, sinb, melb, out, win, hop, T, M, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
