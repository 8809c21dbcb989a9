// The stationary denoise on the card: the STFT and ISTFT of every frame as
// a real FFT (D1) and the gate mask's smoothing (D2).  Together they make
// the denoise of a window the same bits whether it runs alone or in a batch.
//
// Neither replaces a Pallas kernel.  D1 replaces the JAX package's
// _stft_ri and _istft (mmla_audio_tpu/ops/denoise.py:139, :174), two dense
// DFT products that XLA runs as GEMMs; D2 the two smoothing products of
// reduce_noise (:381-383).  A library GEMM picks its algorithm, and with it
// the order of its sums, by the product's shape; a batch folds into the
// GEMM's M, so a window's spectrum differed in its last bits between a
// batch and the window alone, and the int16 re-quantization turned a few of
// those into a step of one.
//
// D1, stft_rfft_kernel and istft_irfft_kernel: n_fft = 1024 only (the
// wrapper refuses any other size).  One plan serves every frame: the real
// frame of 1024 points is a complex sequence of 512, z[n] = x[2n] +
// i x[2n+1], transformed by a 512-point Stockham FFT of three radix-8
// stages (Ns = 1, 8, 64) in shared memory, 64 threads a frame (one radix-8
// butterfly a thread a stage), 4 frames a block; then a post-pass splits
// Z into the 513 bins, X[k] = E[k] + W^k O[k] with E = (Z[k] +
// conj Z[512-k]) / 2, O = (Z[k] - conj Z[512-k]) / 2i, W = e^{-2 pi i /
// 1024}.  The inverse runs the same steps backwards: Z'[k] = (X[k] +
// conj X[512-k]) + i W^{-k} (X[k] - conj X[512-k]) (the imaginary parts at
// DC and Nyquist ignored, as the inverse bases ignore them), z = conj(FFT(
// conj Z')) / 1024, x[2n] = Re z[n], x[2n+1] = Im z[n]: the unwindowed
// inverse rDFT, whose c / n_fft weights (c = 2 but at DC and Nyquist) the
// factor 1/1024 and the pairing of k with 512 - k carry.
//
// Precision: float32 in and out, float64 inside.  The gate compares each
// bin's |X|^2 with a threshold, and a quiet bin near it sits far below the
// frame's largest bin, so an fp32 transform (FFT or dense product alike)
// errs there by ~1e-5 of the bin and decides some near-ties against the
// exact spectrum; a flipped bin moves up to 16 int16 steps around it.  In
// float64 the transform is exact to well below the one rounding of each
// output to float32, so the card's spectrum, and every gate decision on
// it, is that of the exact DFT of its float32 input.  The frame times the
// float32 window is exact in float64, every twiddle is read from one
// float64 table, e^{-2 pi i t / 1024} for t < 1024 (W512^t is entry 2t; the
// radix-8 butterfly's sqrt(1/2) is entry 128), and the wrapper's plan is
// that table, (cos, sin) pairs, followed by the 1024-point periodic Hann
// window (its float32 values), one float64 pointer for both kernels.  A
// frame's sequence of operations depends on nothing but the frame: the
// grid grows with M and nothing else does, so a window's bits are the same
// alone and in any batch.
//
// Frame t of window g is read straight from the signal, sample t * hop -
// 512 + s of row g (contiguous rows of n), reflected at both ends as the
// centered STFT's reflect padding would (the wrapper requires n > 512), and
// windowed (periodic Hann) as it is loaded; re and im land in two planes
// of one (2, M, 513) output, M = rows * frames.
//
// Bound: bytes.  A frame's FFT is ~33 kFLOP against 4.1 kB of spectrum
// written (STFT) or read (ISTFT) and 4 kB of frame written (ISTFT) or 1 kB
// of new signal read (STFT, hop 256), ~3 FLOP a byte; even as float64 FMAs
// it stays below the card's ridge.  What the design does about it is to
// touch device memory once: neither the padded signal nor the frame matrix
// is built, each input is read once (overlapping frames share the L1 and
// L2) and each output written once, with unit stride across a frame's
// threads, and every intermediate stays in shared memory.
//
// D2, smooth_mask_stream_kernel: the gate mask smoothed by the outer
// triangular kernel as two banded passes, frequency (taps vf, zero-padded
// "same") and then time (taps vt, zero-padded "same" within the window).
// It replaces the dense (K, K) and (T, T) matrices (8.1 GB for the time
// matrix of a 12-minute recording).  Bound: bytes, the mask read and the
// result written once, 8 bytes a bin; the 40 multiply-adds a bin of the
// (33, 7) taps are ~7 us of the CUDA cores' fp32 rate at B=64, under the
// 14 us of bytes, and every FMA leaves the register file for nothing but
// its operands.  The design: a block streams a strip of one window's
// frames once, at one tile of bins with a halo of nf / 2 bins a side.
// Each input row arrives by cp.async in a ring of kSmoothStages rows in
// shared memory, three rows ahead of the row in work, so no load waits on
// the math; a thread owns 6 consecutive bins of a row and reads the 38
// staged values they need once (float2, no bank conflicts) for 6 x 33
// FMAs with the taps in registers; the frequency pass runs once a row into
// a register ring of nt rows, and each output goes from a register to
// device memory.  Shared memory is ~9 KB a block (a tile of 16 frames
// staged whole, 22 x 513 floats twice, took 90 KB), nothing grows with T,
// and a strip recomputes the nt - 1 halo rows of the time band (6 of 16
// frames at B=64).  What is left bounds it by instruction issue (an
// estimate from the source, not from its SASS): a thread's 240 FMAs a row
// come with ~100 loads, copies, stores and loop instructions.  The host (ops/cuda_denoise.py::smooth_plan)
// picks the strip and the tile to fill the SMs.  Every output is summed as
// before, s = fmaf(vf[d], x[j + cf - d], s) over ascending d (out-of-range
// bins read the ring's zero columns, and fmaf(v, 0, s) is s), then the
// time taps over ascending d: its bits depend on the taps alone, never on
// the strip, the tile or the batch, so a window's smoothing is the same
// alone and in any batch.  Other odd tap counts take
// smooth_mask_generic_kernel (one thread an output, nt * nf FMAs), in the
// same order.

#include <cuda_runtime.h>

namespace {

constexpr int kFftN = 1024;               // n_fft
constexpr int kHalf = kFftN / 2;          // complex points
constexpr int kBins = kHalf + 1;
constexpr int kFrameThreads = 64;         // one radix-8 butterfly each
constexpr int kFramesPerBlock = 4;
constexpr int kFftThreads = kFrameThreads * kFramesPerBlock;
// one padding double every 8: the stage stores (stride 8, then runs of 8
// at stride 64) and the loads (unit stride) meet few bank conflicts
constexpr int kPadded = kHalf + kHalf / 8;

__device__ __forceinline__ int pidx(int i) { return i + (i >> 3); }

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double2 cmul(double2 a, double2 w) {
  return make_double2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
// a * (-i)
__device__ __forceinline__ double2 mul_mi(double2 a) {
  return make_double2(a.y, -a.x);
}

__device__ __forceinline__ void dft4(double2& u0, double2& u1, double2& u2,
                                     double2& u3) {
  const double2 p0 = cadd(u0, u2), p1 = csub(u0, u2);
  const double2 q0 = cadd(u1, u3), q1 = mul_mi(csub(u1, u3));
  u0 = cadd(p0, q0);
  u1 = cadd(p1, q1);
  u2 = csub(p0, q0);
  u3 = csub(p1, q1);
}

// In-register DFT of 8 points, V[q] = sum_r v[r] e^{-2 pi i r q / 8}: a
// radix-2 split (v[r] +- v[r+4], the difference times W8^r), then two
// 4-point DFTs giving the even and the odd outputs.
__device__ __forceinline__ void dft8(double2* v, double c) {
  double2 a0 = cadd(v[0], v[4]), a1 = cadd(v[1], v[5]);
  double2 a2 = cadd(v[2], v[6]), a3 = cadd(v[3], v[7]);
  double2 b0 = csub(v[0], v[4]);
  const double2 d1 = csub(v[1], v[5]), d2 = csub(v[2], v[6]),
                d3 = csub(v[3], v[7]);
  double2 b1 = make_double2(c * (d1.x + d1.y), c * (d1.y - d1.x));
  double2 b2 = mul_mi(d2);
  double2 b3 = make_double2(c * (d3.y - d3.x), -(c * (d3.x + d3.y)));
  dft4(a0, a1, a2, a3);
  dft4(b0, b1, b2, b3);
  v[0] = a0; v[2] = a1; v[4] = a2; v[6] = a3;
  v[1] = b0; v[3] = b1; v[5] = b2; v[7] = b3;
}

// The 512-point FFT of one frame: on entry v[r] = z[j + 64 r], on return
// v[r] = Z[j + 64 r].  Stockham, radix 8: at stage Ns the butterfly j reads
// j + 64 r, multiplies input r by W_{8 Ns}^{r (j mod Ns)} and writes output
// q at (j / Ns) * 8 Ns + (j mod Ns) + q Ns.  Every thread of the block
// calls it (it holds barriers).
__device__ __forceinline__ void fft512(double2* v, double* sre, double* sim,
                                       int j, const double2* __restrict__ tw,
                                       double c) {
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int ns = s == 0 ? 1 : (s == 1 ? 8 : 64);
    if (s > 0) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = pidx(j + 64 * r);
        v[r] = make_double2(sre[i], sim[i]);
      }
      const int k = j % ns;
#pragma unroll
      for (int r = 1; r < 8; ++r)      // W512^e is table entry 2e
        v[r] = cmul(v[r], __ldg(tw + 2 * r * k * (kHalf / (8 * ns))));
    }
    dft8(v, c);
    if (s == 2) break;
    __syncthreads();                   // every load of the stage is done
    const int base = (j / ns) * 8 * ns + j % ns;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = pidx(base + q * ns);
      sre[i] = v[q].x;
      sim[i] = v[q].y;
    }
    __syncthreads();
  }
}

// Sample i of a row of n, reflected into [0, n) (n > 512 >= the overhang).
__device__ __forceinline__ long long reflect(long long i, long long n) {
  return i < 0 ? -i : (i >= n ? 2 * (n - 1) - i : i);
}

// D1 forward: the M = rows * frames windowed frames of y (contiguous rows
// of n) -> out (2, M, 513), the re plane then the im plane.
__global__ void __launch_bounds__(kFftThreads)
stft_rfft_kernel(const float* __restrict__ y, long long n, int frames,
                 int hop, int M, const double* __restrict__ plan,
                 float* __restrict__ out) {
  const double2* tw = reinterpret_cast<const double2*>(plan);
  const double* window = plan + 2 * kFftN;
  __shared__ double sre[kFramesPerBlock][kPadded];
  __shared__ double sim[kFramesPerBlock][kPadded];
  const int slot = threadIdx.x / kFrameThreads;
  const int j = threadIdx.x % kFrameThreads;
  const long long m = static_cast<long long>(blockIdx.x) * kFramesPerBlock +
                      slot;
  const bool valid = m < M;
  const double c = __ldg(tw + kFftN / 8).x;
  double2 v[8];
  const float* src = y;
  long long start = 0;
  if (valid) {
    src += (m / frames) * n;
    start = (m % frames) * static_cast<long long>(hop) - kHalf;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int s = 2 * (j + 64 * r);
    // a float32 sample times a float32 window value: exact in float64
    v[r] = valid ? make_double2(
                       src[reflect(start + s, n)] * __ldg(window + s),
                       src[reflect(start + s + 1, n)] * __ldg(window + s + 1))
                 : make_double2(0.0, 0.0);
  }
  double* re = sre[slot];
  double* im = sim[slot];
  fft512(v, re, im, j, tw, c);
  __syncthreads();                     // the last stage's loads are done
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = pidx(j + 64 * r);
    re[i] = v[r].x;
    im[i] = v[r].y;
  }
  __syncthreads();
  if (!valid) return;
  float* row_re = out + m * kBins;
  float* row_im = out + (M + m) * kBins;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int k = j + 64 * q;
    const int i = pidx(k), i2 = pidx((kHalf - k) & (kHalf - 1));
    const double ar = re[i], ai = im[i], br = re[i2], bi = im[i2];
    const double er = 0.5 * (ar + br), ei = 0.5 * (ai - bi);
    const double2 o = make_double2(0.5 * (ai + bi), 0.5 * (br - ar));
    const double2 wo = cmul(o, __ldg(tw + k));
    row_re[k] = static_cast<float>(er + wo.x);   // the one rounding to fp32
    row_im[k] = static_cast<float>(ei + wo.y);
  }
  if (j == 0) {                        // Nyquist: E[0] - O[0], real
    row_re[kHalf] = static_cast<float>(re[0] - im[0]);
    row_im[kHalf] = 0.f;
  }
}

// D1 inverse: re, im (M, 513) contiguous -> out (M, 1024), the unwindowed
// inverse rDFT of each row.
__global__ void __launch_bounds__(kFftThreads)
istft_irfft_kernel(const float* __restrict__ re,
                   const float* __restrict__ im, int M,
                   const double* __restrict__ plan, float* __restrict__ out) {
  const double2* tw = reinterpret_cast<const double2*>(plan);
  __shared__ double sre[kFramesPerBlock][kPadded];
  __shared__ double sim[kFramesPerBlock][kPadded];
  const int slot = threadIdx.x / kFrameThreads;
  const int j = threadIdx.x % kFrameThreads;
  const long long m = static_cast<long long>(blockIdx.x) * kFramesPerBlock +
                      slot;
  const bool valid = m < M;
  const double c = __ldg(tw + kFftN / 8).x;
  double2 v[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int k = j + 64 * r;
    if (!valid) {
      v[r] = make_double2(0.0, 0.0);
      continue;
    }
    const float* xr = re + m * kBins;
    const float* xi = im + m * kBins;
    // X[k] and X[512 - k]; the imaginary parts at DC and Nyquist ignored
    const double ar = xr[k], ai = k == 0 ? 0.0 : xi[k];
    const double br = xr[kHalf - k], bi = k == 0 ? 0.0 : xi[kHalf - k];
    const double2 e = make_double2(ar + br, ai - bi);
    const double2 d = make_double2(ar - br, ai + bi);
    const double2 w = __ldg(tw + k);
    // W^{-k} = conj(w)
    const double2 o =
        make_double2(d.x * w.x + d.y * w.y, d.y * w.x - d.x * w.y);
    // conj(E + i O)
    v[r] = make_double2(e.x - o.y, -(e.y + o.x));
  }
  fft512(v, sre[slot], sim[slot], j, tw, c);
  if (!valid) return;
  float* row = out + m * kFftN;
  constexpr double kScale = 1.0 / kFftN;          // exact: a power of two
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int n = j + 64 * r;
    *reinterpret_cast<float2*>(row + 2 * n) =
        make_float2(static_cast<float>(v[r].x * kScale),
                    static_cast<float>(-v[r].y * kScale));
  }
}

// D2 (see the head of the file).  The streaming instance's geometry: bins
// a thread, rows in flight in a block's staging ring, bins a block at most.
constexpr int kSmoothR = 6;
constexpr int kSmoothStages = 4;                 // a power of two
constexpr int kSmoothMaxTile = 768;              // 128 threads
constexpr int kSmoothMaxThreads = kSmoothMaxTile / kSmoothR;
constexpr int kSmoothGenericThreads = 128;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D2, streaming: block (x, y, z) smooths frames [x * strip, + strip) of
// window y at bins [z * tile, + tile).  It walks input rows t0 - CT ...
// t0 + n_out + CT - 1 once: row i lands by cp.async in stage i % kSmoothStages
// of a ring in shared memory (bins k0 - CF ... k0 + tile + CF - 1, the
// columns outside [0, K) zero), kSmoothStages - 1 rows ahead of the row
// being computed.  Thread j owns bins k0 + 6 j ... + 5: it reads the
// 6 + NF - 1 staged values they need into registers, runs the frequency
// pass into slot i % NT of a register ring of NT rows, and, once the ring
// holds rows i - NT + 1 ... i, the time pass of output frame t0 + i - 2 CT,
// stored straight from the registers (a warp's six stores cover its 768
// bytes of the row).  The frame loop is unrolled by NT so that every ring
// slot is a compile-time register.
template <int NF, int NT>
__global__ void __launch_bounds__(kSmoothMaxThreads)
smooth_mask_stream_kernel(const float* __restrict__ mask,
                          float* __restrict__ out, int T, int K,
                          const float* __restrict__ vf,
                          const float* __restrict__ vt, int strip, int tile) {
  constexpr int CF = NF / 2, CT = NT / 2;
  constexpr int R = kSmoothR;
  constexpr int W = R + NF - 1;             // staged values a thread reads
  static_assert(W % 2 == 0, "float2 loads of the staged values");
  extern __shared__ float stage[];          // kSmoothStages x width
  const int width = tile + 2 * CF;          // even: tile % 6 == 0

  const int t0 = blockIdx.x * strip, k0 = blockIdx.z * tile;
  const long long base = static_cast<long long>(blockIdx.y) * T * K;
  const int n_out = min(strip, T - t0);
  const int rows = n_out + 2 * CT;
  const int n_tile = min(tile, K - k0);
  // staged bins [lo, hi) sit at columns [lo - k0 + CF, hi - k0 + CF)
  const int lo = max(k0 - CF, 0), hi = min(k0 + tile + CF, K);
  const int pl = lo - k0 + CF, ph = hi - k0 + CF;
  const int tid = threadIdx.x;
  const bool active = R * tid < n_tile;

  for (int s = 0; s < kSmoothStages; ++s)
    for (int p = tid; p < width; p += blockDim.x)
      if (p < pl || p >= ph) stage[s * width + p] = 0.f;
  float tf[NF], tt[NT];
#pragma unroll
  for (int d = 0; d < NF; ++d) tf[d] = __ldg(vf + d);
#pragma unroll
  for (int d = 0; d < NT; ++d) tt[d] = __ldg(vt + d);
  __syncthreads();                          // the zeros before any copy

  // input row i (frame t0 - CT + i) into its stage; rows outside the
  // window are never read, but every call commits one group
  auto issue = [&](int i) {
    const int t = t0 - CT + i;
    if (i < rows && t >= 0 && t < T) {
      // bin k at column k - k0 + CF of the stage
      const int off = (i & (kSmoothStages - 1)) * width + CF - k0;
      const float* src = mask + base + static_cast<long long>(t) * K;
      for (int k = lo + tid; k < hi; k += blockDim.x)
        cp_async4(stage + (off + k), src + k);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int i = 0; i < kSmoothStages - 1; ++i) issue(i);
  float ring[NT][R];
  for (int ib = 0; ib < rows; ib += NT) {
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      const int i = ib + q;                 // slot q holds row i
      if (i >= rows) break;
      cp_async_wait<kSmoothStages - 2>();   // this thread's copies of row i
      __syncthreads();                      // everyone's; row i - 1 read
      issue(i + kSmoothStages - 1);
      const int t = t0 - CT + i;
      if (active && t >= 0 && t < T) {
        const float2* x = reinterpret_cast<const float2*>(
            stage + (i & (kSmoothStages - 1)) * width + R * tid);
        float w[W];
#pragma unroll
        for (int m = 0; m < W / 2; ++m) {
          const float2 v = x[m];
          w[2 * m] = v.x;
          w[2 * m + 1] = v.y;
        }
        // bin j + r + CF - d sits at w[r + 2 CF - d]
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float s = 0.f;
#pragma unroll
          for (int d = 0; d < NF; ++d) s = fmaf(tf[d], w[r + 2 * CF - d], s);
          ring[q][r] = s;
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) ring[q][r] = 0.f;
      }
      if (active && i >= 2 * CT) {
        // frame t - CT: taps d = 0 ... NT - 1 on rows i, i - 1, ...
        float* dst = out + base + static_cast<long long>(t - CT) * K + k0 +
                     R * tid;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float s = 0.f;
#pragma unroll
          for (int d = 0; d < NT; ++d)
            s = fmaf(tt[d], ring[(q - d + NT) % NT][r], s);
          if (R * tid + r < n_tile) dst[r] = s;
        }
      }
    }
  }
}

// D2, any odd tap counts: one thread an output, the frequency pass of each
// of the nt frames recomputed from the mask (nt * nf multiply-adds an
// output), in the streaming instance's order.  Block x smooths row x of
// the (groups * T) rows.
__global__ void __launch_bounds__(kSmoothGenericThreads)
smooth_mask_generic_kernel(const float* __restrict__ mask,
                           float* __restrict__ out, int T, int K,
                           const float* __restrict__ vf, int nf,
                           const float* __restrict__ vt, int nt) {
  const int ct = nt / 2, cf = nf / 2;
  const long long m = blockIdx.x;
  const long long g = m / T;
  const int t = static_cast<int>(m - g * T);
  const float* win = mask + g * T * K;
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    float s = 0.f;
    for (int d = 0; d < nt; ++d) {
      const int tt = t + ct - d;
      float f = 0.f;
      if (tt >= 0 && tt < T) {
        const float* x = win + static_cast<long long>(tt) * K;
        for (int e = 0; e < nf; ++e) {
          const int i = j + cf - e;
          if (i >= 0 && i < K) f = fmaf(__ldg(vf + e), __ldg(x + i), f);
        }
      }
      s = fmaf(__ldg(vt + d), f, s);
    }
    out[m * K + j] = s;
  }
}

}  // namespace

extern "C" {

// Return cudaGetLastError() after the launch (0 on success).  plan
// (float64): the 1024 twiddles e^{-2 pi i t / 1024} as (cos, sin) pairs,
// then the 1024-point window.
int stft_rfft_launch(const float* y, long long n, int frames, int hop, int M,
                     const double* plan, float* out, cudaStream_t stream) {
  if (M <= 0 || frames <= 0 || n <= kHalf)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (M + kFramesPerBlock - 1) / kFramesPerBlock;
  stft_rfft_kernel<<<blocks, kFftThreads, 0, stream>>>(y, n, frames, hop, M,
                                                      plan, out);
  return static_cast<int>(cudaGetLastError());
}

int istft_irfft_launch(const float* re, const float* im, int M,
                       const double* plan, float* out, cudaStream_t stream) {
  if (M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (M + kFramesPerBlock - 1) / kFramesPerBlock;
  istft_irfft_kernel<<<blocks, kFftThreads, 0, stream>>>(re, im, M, plan,
                                                        out);
  return static_cast<int>(cudaGetLastError());
}

// mask and out: (groups, T, K) contiguous; vf (nf,), vt (nt,) odd lengths
// on the card.  (nf, nt) = (33, 7) streams (strip frames and tile bins a
// block, tile a positive multiple of 6 up to 768); any other pair takes the
// generic kernel, which ignores strip and tile.
int smooth_mask_launch(const float* mask, float* out, int groups, int T,
                       int K, const float* vf, int nf, const float* vt,
                       int nt, int strip, int tile, cudaStream_t stream) {
  if (groups <= 0 || T <= 0 || K <= 0 || nf <= 0 || nt <= 0 ||
      nf % 2 == 0 || nt % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nf == 33 && nt == 7) {
    if (strip <= 0 || tile <= 0 || tile % kSmoothR || tile > kSmoothMaxTile ||
        groups > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    const int threads = (tile / kSmoothR + 31) / 32 * 32;
    const size_t smem = static_cast<size_t>(kSmoothStages) *
                        (tile + 2 * (33 / 2)) * sizeof(float);   // < 48 KB
    const dim3 grid((T + strip - 1) / strip, groups, (K + tile - 1) / tile);
    smooth_mask_stream_kernel<33, 7><<<grid, threads, smem, stream>>>(
        mask, out, T, K, vf, vt, strip, tile);
  } else {
    const long long rows = static_cast<long long>(groups) * T;
    if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    smooth_mask_generic_kernel<<<static_cast<unsigned>(rows),
                                 kSmoothGenericThreads, 0, stream>>>(
        mask, out, T, K, vf, nf, vt, nt);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
