// Overlap featurizer for Hopper (sm_90a): float PCM windows -> quantized ZCR images.
//
// Replaces the TPU kernels `_kernel` (wrapper `_pallas_impl`) and
// `_kernel_grouped` (wrapper `_pallas_impl_grouped`) of
// mmla_audio_tpu/ops/pallas_features.py, public `overlap_model_input_pallas`.
// Per window: reflect-padded framing, periodic-Hann window, power spectrum,
// mel projection (rows in image order, i.e. flipped), power_to_db (ref =
// window max, amin 1e-10, top_db 80), min-max normalize, ZCR on edge-padded
// frames (/win), PNG quantize floor(clip(x, 0, 1) * 255).  Output (B, 3, M, T)
// float32 holding integers 0..255; R = ZCR, G = B = 1 - norm.
//
// The TPU kernels ran the DFT and the mel projection as dense GEMMs on the
// MXU: 56 MFLOP a window at the default geometry (24000 samples, win 400,
// hop 160, 151 frames, 201 bins, 128 mels).  The function needs ~30x less:
// a real FFT of 400 points is a 200-point complex FFT of z[n] = x[2n] +
// i x[2n+1] (radix 5, 5, 8) and a split step, and the mel matrix has 394
// nonzeros of 25,728, one contiguous band of 1..9 bins a row.  The least
// time is then the bytes: 96 KB of samples in, 232 KB of image out a window.
// What bounds this kernel is the SM's instruction issue and the latency of
// each frame's dependent steps (framing, three butterfly stages, split,
// mel band; each warp's steps wait on shared memory), not memory: a
// window takes ~50 us on one SM whatever the batch (PERF.md).
//
// Design: one warp owns one frame at a time.  It reads its samples from
// global memory (L1/L2: neighbouring frames overlap; a frame inside the
// signal reads each sample pair once, as 8 bytes), windows and packs them
// into a per-warp buffer, runs Stockham stages ping-pong between two
// per-warp buffers in shared memory (only __syncwarp between stages; radix
// 2, 3, 4, 5 and 8 written out, any other prime factor of win/2 up to 17 by
// `stage_generic` from the twiddle table), forms
// the 201 powers, and each lane sums four mel rows side by side over their
// bands.  ZCR is a ballot over the loaded samples' signs.  Each mel value
// goes into the window's (M, T) tile as 10 log10(max(mel, amin)); the warp
// also keeps the window's max mel and min/max of that log, so the epilogue
// needs one pass: dB = log - ref_db is monotone in the log, so its extremes
// are those of the log shifted.  The host tables (window, twiddles
// exp(-2 pi i m / win) computed in float64 and rounded to f32, FFT plan, mel
// bands) are `feature_tables` in ops/cuda_features.py.  A CTA has 1024
// threads: 32 warps hide each other's latency, the most the register file
// holds at 64 registers (one CTA an SM, 184 KB of shared memory); a longer
// window whose per-warp buffers do not fit halves the block until they do.
//
// G (the TPU kernel's "group") windows per CTA: at G = 1 the tile stays in
// shared memory (77 KB); at G > 1 it goes to plane 1 of each window's own
// output image and the epilogue reads it back from L2.  G > 1 was slower at
// every batch measured and is not picked.  Every G gives the same bits: each
// value is computed by the same code whatever warp or CTA runs it, and the
// statistics are max/min.  A CTA whose last group is partial neither reads
// nor writes past the batch.  All arithmetic is IEEE fp32 on the CUDA cores
// (no tensor cores, no TF32).  The banded mel sum runs in ascending bin order
// with fmaf, as the dense sum did: the bins it skips have weight exactly 0,
// which leaves fmaf's sum unchanged.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kAmin = 1e-10f;    // power_to_db amin
constexpr float kSnap = 1e-10f;    // zero_crossing_rate threshold
constexpr float kTopDb = 80.0f;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

__device__ inline float quantize(float x) {
  return floorf(fminf(fmaxf(x, 0.0f), 1.0f) * 255.0f);
}

__device__ inline float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
__device__ inline float2 operator+(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ inline float2 operator-(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ inline float2 operator*(float s, float2 a) { return make_float2(s * a.x, s * a.y); }
__device__ inline float2 mul_mi(float2 a) { return make_float2(a.y, -a.x); }   // -i a

// In-place forward DFT of R points, exp(-2 pi i r s / R).
template <int R> __device__ inline void dft(float2* a);

template <> __device__ inline void dft<2>(float2* a) {
  const float2 t = a[1];
  a[1] = a[0] - t;
  a[0] = a[0] + t;
}

template <> __device__ inline void dft<3>(float2* a) {
  const float s = 0.86602540378443865f;          // sin(2 pi / 3)
  const float2 t1 = a[1] + a[2], t2 = a[1] - a[2];
  const float2 b = a[0] - 0.5f * t1;
  const float2 c = s * mul_mi(t2);
  a[0] = a[0] + t1;
  a[1] = b + c;
  a[2] = b - c;
}

template <> __device__ inline void dft<4>(float2* a) {
  const float2 b0 = a[0] + a[2], b1 = a[0] - a[2];
  const float2 b2 = a[1] + a[3], b3 = mul_mi(a[1] - a[3]);
  a[0] = b0 + b2;
  a[2] = b0 - b2;
  a[1] = b1 + b3;
  a[3] = b1 - b3;
}

template <> __device__ inline void dft<5>(float2* a) {
  const float c1 = 0.30901699437494742f, c2 = -0.80901699437494742f;  // cos(2 pi / 5), cos(4 pi / 5)
  const float s1 = 0.95105651629515357f, s2 = 0.58778525229247313f;   // sin(2 pi / 5), sin(4 pi / 5)
  const float2 t1 = a[1] + a[4], t2 = a[2] + a[3];
  const float2 t3 = a[1] - a[4], t4 = a[2] - a[3];
  const float2 b1 = a[0] + c1 * t1 + c2 * t2;
  const float2 b2 = a[0] + c2 * t1 + c1 * t2;
  const float2 d1 = mul_mi(s1 * t3 + s2 * t4);
  const float2 d2 = mul_mi(s2 * t3 - s1 * t4);
  a[0] = a[0] + t1 + t2;
  a[1] = b1 + d1;
  a[4] = b1 - d1;
  a[2] = b2 + d2;
  a[3] = b2 - d2;
}

template <> __device__ inline void dft<8>(float2* a) {
  const float h = 0.70710678118654752f;          // sqrt(1/2)
  const float2 b0 = a[0] + a[4], b1 = a[0] - a[4];
  const float2 b2 = a[2] + a[6], b3 = mul_mi(a[2] - a[6]);
  const float2 b4 = a[1] + a[5], b5 = a[1] - a[5];
  const float2 b6 = a[3] + a[7], b7 = mul_mi(a[3] - a[7]);
  const float2 e0 = b0 + b2, e2 = b0 - b2, e1 = b1 + b3, e3 = b1 - b3;   // DFT4 of the even
  const float2 o0 = b4 + b6, o2 = b4 - b6, o1 = b5 + b7, o3 = b5 - b7;   // and odd points
  const float2 w1 = make_float2(h * (o1.x + o1.y), h * (o1.y - o1.x));   // W8 o1
  const float2 w2 = mul_mi(o2);                                          // W8^2 o2
  const float2 w3 = make_float2(h * (o3.y - o3.x), -h * (o3.x + o3.y));  // W8^3 o3
  a[0] = e0 + o0;
  a[4] = e0 - o0;
  a[1] = e1 + w1;
  a[5] = e1 - w1;
  a[2] = e2 + w2;
  a[6] = e2 - w2;
  a[3] = e3 + w3;
  a[7] = e3 - w3;
}

// One Stockham stage of radix R over an n2-point sequence; p is the product
// of the earlier stages' radices.  Butterfly i reads x[i + r S] (S = n2 / R),
// twiddles input r by W^(k r) with k = i mod p and W = exp(-2 pi i / (p R))
// (table index k r tstep, tstep = win / (p R)), and writes y[(i - k) R + k +
// r p].  The 32 lanes of the warp share the butterflies.
template <int R>
__device__ inline void stage(const float2* x, float2* y, int n2, int p, int tstep,
                             const float2* tw, int lane) {
  const int S = n2 / R;
  for (int i = lane; i < S; i += 32) {
    const int k = i % p;
    float2 a[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = x[i + r * S];
    if (k != 0) {
#pragma unroll
      for (int r = 1; r < R; ++r) a[r] = cmul(a[r], tw[k * r * tstep]);
    }
    dft<R>(a);
    const int j = (i - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) y[j + r * p] = a[r];
  }
}

// The same stage for an odd prime R that has no written-out DFT (7 up to
// MAX_RADIX of ops/cuda_features.py), read and written as `stage` does.
// Output r of butterfly i is sum_q x[i + q S] W^(q (k + r p)): the input
// twiddle W^(k q) and the R-point DFT's root exp(-2 pi i q r / R) are one
// entry of the twiddle table, index q (k + r p) tstep mod win (k + r p < p R,
// so the step is below win).  R^2 complex multiply-adds a butterfly, R a
// point, against 2 to 4 for the written-out radices; only windows whose half
// has such a factor run it.
__device__ inline void stage_generic(const float2* x, float2* y, int n2, int R, int p,
                                     int tstep, int win, const float2* tw, int lane) {
  const int S = n2 / R;
  for (int i = lane; i < S; i += 32) {
    const int k = i % p;
    const int j = (i - k) * R + k;
    for (int r = 0; r < R; ++r) {
      const int step = (k + r * p) * tstep;
      float2 acc = x[i];
      int t = 0;
      for (int q = 1; q < R; ++q) {
        t += step;
        if (t >= win) t -= win;
        acc = acc + cmul(x[i + q * S], tw[t]);
      }
      y[j + r * p] = acc;
    }
  }
}

__device__ inline int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * (n - 1) - i : i);
}

// Window statistics a warp kept over its frames: max mel, min and max of
// 10 log10(max(mel, amin)); merged into stats[(g, warp)] by lane 0.
__device__ inline void flush_stats(float mx, float lmn, float lmx, float* slot, int lane) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    lmn = fminf(lmn, __shfl_xor_sync(kFull, lmn, o));
    lmx = fmaxf(lmx, __shfl_xor_sync(kFull, lmx, o));
  }
  if (lane == 0) {
    slot[0] = mx;
    slot[1] = lmn;
    slot[2] = lmx;
  }
}

constexpr int kRows = 4;           // mel rows a lane sums at once

// Shared memory of one CTA, in floats.
__host__ __device__ inline size_t smem_floats(int win, int T, int M, int K, int G, int nwarps) {
  return (size_t)2 * win                       // twiddles (win float2)
         + (size_t)nwarps * 2 * win            // two buffers of win/2 float2 per warp
         + round4(K * M) + round4(2 * M)       // mel band weights, first bins and sizes
         + round4(G * T)                       // quantized ZCR (G, T)
         + round4(G * nwarps * 3)              // statistics (G, nwarps, 3)
         + (G == 1 ? (size_t)round4(M * T) : 0);  // the window's tile, G = 1
}

// ftab: float32 [window (win)] [twiddles (win, 2)] [mel weights (K, M)];
// itab: int32 [radices (nrad)] [mel first bin (M)] [mel band size (M)].
template <bool kTileInSmem>
__global__ void __launch_bounds__(1024)
overlap_features_kernel(const float* __restrict__ y, long long row_stride, int B, int n,
                        const float* __restrict__ ftab, const int* __restrict__ itab,
                        float* out, int win, int hop, int T, int M, int K, int nrad, int G) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int n2 = win / 2;
  float2* tw = reinterpret_cast<float2*>(smem4);            // (win,)
  float2* za = tw + win + warp * win;                       // this warp's two buffers
  float2* zb = za + n2;
  float* melw = reinterpret_cast<float*>(tw + win + nwarps * win);  // (K, M)
  int* mel_first = reinterpret_cast<int*>(melw + round4(K * M));     // (M,)
  int* mel_count = mel_first + M;                                    // (M,)
  float* zq = melw + round4(K * M) + round4(2 * M);         // (G, T)
  float* stats = zq + round4(G * T);                        // (G, nwarps, 3)
  float* tile = stats + round4(G * nwarps * 3);             // (M, T), G = 1

  const float2* window2 = reinterpret_cast<const float2*>(ftab);
  const int b0 = blockIdx.x * G;
  const int MT = M * T;

  for (int i = tid; i < win; i += blockDim.x)
    tw[i] = __ldg(reinterpret_cast<const float2*>(ftab + win) + i);
  for (int i = tid; i < K * M; i += blockDim.x) melw[i] = __ldg(ftab + 3 * win + i);
  for (int i = tid; i < 2 * M; i += blockDim.x) mel_first[i] = __ldg(itab + nrad + i);
  for (int i = tid; i < G * nwarps; i += blockDim.x) {
    stats[3 * i] = -INFINITY;
    stats[3 * i + 1] = INFINITY;
    stats[3 * i + 2] = -INFINITY;
  }
  __syncthreads();

  // frames: warp w takes frames w, w + nwarps, ... of the CTA's G windows
  int cur = -1;
  float mx = -INFINITY, lmn = INFINITY, lmx = -INFINITY;
  for (int f = warp; f < G * T; f += nwarps) {
    const int g = f / T, t = f - g * T;
    if (b0 + g >= B) break;
    if (g != cur) {
      if (cur >= 0) flush_stats(mx, lmn, lmx, stats + 3 * (cur * nwarps + warp), lane);
      cur = g;
      mx = -INFINITY;
      lmn = INFINITY;
      lmx = -INFINITY;
    }
    const float* yg = y + (long long)(b0 + g) * row_stride;
    const int i0 = t * hop - n2;                 // the frame's first signal index
    __syncwarp();                                // the last frame's readers are done

    // 1-2. the frame windowed and packed as z[p] = x[2p] + i x[2p+1], and
    // the zero crossings of the edge-padded frame: sample j is negative
    // when below -snap (|x| <= snap snaps to +0); a ballot gives 32 samples'
    // signs at a time.  A frame inside the signal (no padding: reflect and
    // edge agree) reads each sample pair once, as 8 bytes.
    int cnt = 0;
    unsigned prev = 0;                           // sign of the previous chunk's last sample
    if (i0 >= 0 && i0 + win <= n && (reinterpret_cast<uintptr_t>(yg + i0) & 7) == 0) {
      const float2* y2 = reinterpret_cast<const float2*>(yg + i0);
      for (int c = 0; c < n2; c += 32) {
        const int p = c + lane;
        const bool in = p < n2;
        const float2 v = in ? __ldg(y2 + p) : make_float2(0.0f, 0.0f);
        if (in) {
          const float2 w = __ldg(window2 + p);
          za[p] = make_float2(__fmul_rn(v.x, w.x), __fmul_rn(v.y, w.y));
        }
        const unsigned e = __ballot_sync(kFull, in && v.x < -kSnap);   // samples 2p
        const unsigned o = __ballot_sync(kFull, in && v.y < -kSnap);   // samples 2p + 1
        const unsigned valid = __ballot_sync(kFull, in);
        unsigned d = e ^ ((o << 1) | prev);      // pairs (2p - 1, 2p)
        if (c == 0) d &= ~1u;                    // sample 0 has no predecessor
        cnt += __popc((e ^ o) & valid) + __popc(d & valid);
        prev = o >> 31;
      }
    } else {
      for (int p = lane; p < n2; p += 32) {      // reflect padding
        const float2 w = __ldg(window2 + p);
        const float a = __ldg(yg + reflect(i0 + 2 * p, n));
        const float b = __ldg(yg + reflect(i0 + 2 * p + 1, n));
        za[p] = make_float2(__fmul_rn(a, w.x), __fmul_rn(b, w.y));
      }
      for (int c = 0; c < win; c += 32) {        // edge padding
        const int j = c + lane;
        const bool in = j < win;
        const float v = in ? __ldg(yg + min(max(i0 + j, 0), n - 1)) : 0.0f;
        const unsigned neg = __ballot_sync(kFull, in && v < -kSnap);
        const unsigned valid = __ballot_sync(kFull, in);
        unsigned d = (neg ^ ((neg << 1) | prev)) & valid;
        if (c == 0) d &= ~1u;
        cnt += __popc(d);
        prev = neg >> 31;
      }
    }
    if (lane == 0) zq[g * T + t] = quantize((float)cnt / (float)win);   // librosa divides by win
    __syncwarp();

    // 3. n2-point complex FFT, Stockham stages ping-pong between za and zb
    float2* src = za;
    float2* dst = zb;
    for (int s = 0, p = 1; s < nrad; ++s) {
      const int R = __ldg(itab + s);
      const int tstep = win / (p * R);
      switch (R) {
        case 2: stage<2>(src, dst, n2, p, tstep, tw, lane); break;
        case 3: stage<3>(src, dst, n2, p, tstep, tw, lane); break;
        case 4: stage<4>(src, dst, n2, p, tstep, tw, lane); break;
        case 5: stage<5>(src, dst, n2, p, tstep, tw, lane); break;
        case 8: stage<8>(src, dst, n2, p, tstep, tw, lane); break;
        default: stage_generic(src, dst, n2, R, p, tstep, win, tw, lane); break;
      }
      __syncwarp();
      float2* tmp = src;
      src = dst;
      dst = tmp;
      p *= R;
    }

    // 4. split into the real FFT's bins 0..n2: X[k] = E[k] + W^k O[k] with
    // E = (Z[k] + conj Z[n2-k]) / 2, O = (Z[k] - conj Z[n2-k]) / 2i; power
    float* pw = reinterpret_cast<float*>(dst);
    for (int k = lane; k <= n2; k += 32) {
      const float2 a = src[k == n2 ? 0 : k];
      const float2 b = src[k == 0 ? 0 : n2 - k];
      const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
      const float2 o = make_float2(0.5f * (a.y + b.y), -0.5f * (a.x - b.x));
      const float2 x = e + cmul(o, tw[k]);
      pw[k] = __fadd_rn(__fmul_rn(x.x, x.x), __fmul_rn(x.y, x.y));
    }
    __syncwarp();

    // 5. mel rows over their bands, ascending bins, fmaf from 0 as the dense
    // sum; a lane runs kRows rows' sums side by side (rows m0 + 32 r); the
    // tile takes 10 log10(max(mel, amin))
    float* dst_tile = kTileInSmem ? tile : out + ((long long)(b0 + g) * 3 + 1) * MT;
    for (int m0 = lane; m0 < M; m0 += 32 * kRows) {
      float acc[kRows];
      int first[kRows], count[kRows];
      int nb = 0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int m = m0 + 32 * r;
        first[r] = m < M ? mel_first[m] : 0;
        count[r] = m < M ? mel_count[m] : 0;
        acc[r] = 0.0f;
        nb = max(nb, count[r]);
      }
      for (int j = 0; j < nb; ++j) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (j < count[r]) acc[r] = fmaf(pw[first[r] + j], melw[j * M + m0 + 32 * r], acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int m = m0 + 32 * r;
        if (m < M) {
          const float l = __fmul_rn(10.0f, log10f(fmaxf(acc[r], kAmin)));
          mx = fmaxf(mx, acc[r]);
          lmn = fminf(lmn, l);
          lmx = fmaxf(lmx, l);
          dst_tile[m * T + t] = l;
        }
      }
    }
  }
  if (cur >= 0) flush_stats(mx, lmn, lmx, stats + 3 * (cur * nwarps + warp), lane);
  __syncthreads();                               // tiles, ZCR and statistics visible

  // 6. per window: ref = max mel; dB = log - ref_db, clamped at hi - top_db;
  // min-max normalize; planes R = ZCR, G = B = 1 - norm.  Since rounding
  // log - ref_db is monotone in log, hi and lo come from the log's extremes
  // exactly as from a pass over the dB values.
  for (int g = 0; g < G && b0 + g < B; ++g) {
    float ref = -INFINITY, lo_l = INFINITY, hi_l = -INFINITY;
    for (int w = 0; w < nwarps; ++w) {
      const float* s = stats + 3 * (g * nwarps + w);
      ref = fmaxf(ref, s[0]);
      lo_l = fminf(lo_l, s[1]);
      hi_l = fmaxf(hi_l, s[2]);
    }
    const float ref_db = __fmul_rn(10.0f, log10f(fmaxf(ref, kAmin)));
    const float hi = __fsub_rn(hi_l, ref_db);
    const float floor_db = __fsub_rn(hi, kTopDb);
    const float lo = fmaxf(__fsub_rn(lo_l, ref_db), floor_db);
    const float diff = __fsub_rn(hi, lo);
    float* ob = out + (long long)(b0 + g) * 3 * MT;
    const float* lg = kTileInSmem ? tile : ob + MT;
    const float* zg = zq + g * T;
    const int step = blockDim.x % T;
    int t = tid % T;
#pragma unroll 4
    for (int i = tid; i < MT; i += blockDim.x) {
      const float d = fmaxf(__fsub_rn(lg[i], ref_db), floor_db);
      const float norm = diff > 0.0f ? __fdiv_rn(__fsub_rn(d, lo), diff) : 0.0f;
      const float gb = quantize(__fsub_rn(1.0f, norm));
      ob[i] = zg[t];
      ob[MT + i] = gb;
      ob[2 * MT + i] = gb;
      t += step;
      if (t >= T) t -= T;
    }
  }
}

}  // namespace

// Launch on `stream`.  y: (B, row_stride) float32 rows, the first n samples of
// each row used.  ftab / itab: the tables of `feature_tables` (see the
// kernel).  out: (B, 3, M, T) float32.  group: windows per CTA, 1, 2 or 4.
// The block is 1024 threads, halved (down to 256) while its shared memory
// does not fit the device (the per-warp buffers grow with the window).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int overlap_features_launch(const float* y, long long row_stride, int B, int n,
                                       const float* ftab, const int* itab, float* out,
                                       int win, int hop, int T, int M, int K, int nrad,
                                       int group, void* stream) {
  const int half = win / 2;
  if (B <= 0 || win < 2 || win % 2 != 0 || n <= half || hop <= 0 || T <= 0 || M <= 0 ||
      K <= 0 || nrad < 0 || (T - 1) * hop + win > n + 2 * half)
    return (int)cudaErrorInvalidValue;
  if (group != 1 && group != 2 && group != 4) return (int)cudaErrorInvalidValue;
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  int threads = 1024;
  size_t smem = smem_floats(win, T, M, K, group, threads / 32) * sizeof(float);
  while (smem > (size_t)limit && threads > 256) {
    threads /= 2;
    smem = smem_floats(win, T, M, K, group, threads / 32) * sizeof(float);
  }
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  const int grid = (B + group - 1) / group;
  cudaStream_t s = (cudaStream_t)stream;
  if (group == 1) {
    err = cudaFuncSetAttribute(overlap_features_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    overlap_features_kernel<true><<<grid, threads, smem, s>>>(
        y, row_stride, B, n, ftab, itab, out, win, hop, T, M, K, nrad, 1);
  } else {
    err = cudaFuncSetAttribute(overlap_features_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    overlap_features_kernel<false><<<grid, threads, smem, s>>>(
        y, row_stride, B, n, ftab, itab, out, win, hop, T, M, K, nrad, group);
  }
  return (int)cudaGetLastError();
}
