// Kernel E1: one layer of WavLM's conv encoder (Conv1d, LayerNorm over the
// output channels, exact GELU) in one launch, channels-last in and out
// (wrapper: mmla_audio_torch/ops/cuda_conv_encoder.py).
//
// Replaces no TPU kernel: the JAX package has no WavLM.  It was added because
// the plain path (cuDNN's convolution on (B, C, T), a transpose, LayerNorm, a
// transpose back, GELU) reads and writes every layer's activations five times
// over, and layer 0's are 8,191 x 512 floats a window (1.07 GB at B = 64).
// Here a layer reads its input once, holds the convolution's sums in
// registers through the LayerNorm and the GELU, and writes its output once.
//
//   out[b, t, n] = gelu(LN_n(sum_{j < k, c < C} x[b, s t + j, c] w[n, c, j]))
//   LN_n(y) = (y_n - mean_n y) / sqrt(var_n y + eps) * gamma[n] + beta[n]
//   gelu(y) = y / 2 * (1 + erf(y / sqrt 2))
//
// (the convolution's bias, where there is one, added before the LayerNorm.)
// Layouts: out (B, T_out, N) contiguous, T_out = (T_in - k) / s + 1.
//
// Two kernels; the input width alone picks one (`conv_route` in the
// wrapper):
//
// * C == 1 (layer 0, k 10, stride 5): `wavlm_conv_samples_kernel`, a
//   stencil of k fp32 FMAs an output, bound by its store (16.8 MB a
//   window).  A block of 8 warps takes a strip of 256 frames of one row: the
//   strip's samples and the (k, N) weights, bias and LayerNorm vectors go to
//   shared memory; a warp computes 4 frames at once, lane l channels
//   128 j + 4 l .. + 3, so each weight vector read serves 4 frames and each
//   frame's store is 512 contiguous bytes a j.  Mean and variance (two
//   passes, fp32) are warp shuffles.  x: samples (B, L), rows `xs` floats
//   apart; w: (k, N), the weight's taps by channel.
// * C % 32 == 0 (layers 1-6, k 3 or 2, stride 2): `wavlm_conv_gemm_kernel`,
//   an implicit GEMM with no im2col.  Channels-last, output frame t's
//   operand row is the k C contiguous floats from input frame s t, so A is
//   x itself at a row stride of s C; B is the weight repacked once to
//   (N, k C), K contiguous (w[n, c, j] at n k C + j C + c), beside its
//   copy rounded to TF32 for one pass: (2, N, k C).  A cluster of
//   two blocks owns 128 frames of one row by all N output channels, each
//   block one half of them: 2 x N / 128 warps, warp (i, j) frames 64 i ..
//   and channels 64 j .. of its half, its 64 x 64 sums, 128 a thread, in
//   registers.  So the LayerNorm's row statistics are reductions inside
//   the cluster: shuffles over a row's four lanes, shared memory across a
//   block's warps, then each block adds the other's partial sums through
//   distributed shared memory; two passes (mean, then the centred squares)
//   in fp32.  Each block reads 128 x 32 of A and N/2 x 32 of B a stage (48
//   KB at N = 512, 2.1 MFLOP; one block of 64 frames by all 512 channels
//   reads 72 KB for the same products, and ran 8 % slower on the H100).  K
//   streams in stages of 32 through a ring of three by cp.async (144 KB),
//   each stage's copies issued in two halves between the k16 steps of the
//   stage two before it (a ring of four, or the copies all at once, ran
//   2-4 % slower).  Products are mma.sync m16n8k8 in TF32 (`wgmma` would
//   reach further: on the H100 the layers run at 124-138 TFLOP/s, 193
//   with the copies left out, of TF32's 495); a thread's fragments of one k16
//   step are one 16-byte load a row: the MMA's k-columns t and t + 4 of
//   steps 0 and 1 are read from columns 4t .. 4t + 3, the same permutation
//   for A and B, so the sum is the same.  Rows are 128 bytes, their 16-byte
//   chunks swizzled by the row's parity (chunk ^ 4 on odd rows), so the 8
//   lanes of each load phase hit 32 different banks.  Each operand is
//   rounded to TF32 (nearest; the weight's copy once, when it is packed);
//   with SPLIT (TF32 not allowed) the products run in 3xTF32 on the exact
//   weight, a b = ah bh + ah bl + al bh, fp32 to rounding.  Frames
//   past T_out in a row's last tile read frame T_out - 1 and are not
//   stored; a tile never straddles two rows.
//
// Bound, WavLM Large at B = 64 (`perfbench/counts/wavlm_conv.py`): 12.56
// GFLOP a window, 804 GFLOP, 1.62 ms at 495 TFLOP/s of TF32; the bytes
// (samples in, weights, last output) 44 MB, 0.013 ms.  The products bind.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBM = 128;                   // output frames a GEMM block
constexpr int kBK = 32;                    // K a pipeline stage
constexpr int kWM = 64;                    // output frames a warp
constexpr int kWN = 64;                    // output channels a warp
constexpr int kStages = 3;
constexpr int kGemmThreads = 256;          // at N = 512: 2 x 4 warps
constexpr int kMaxN = 512;
constexpr int kStrip = 256;                // frames a samples block
constexpr int kFrames = 4;                 // frames a warp computes at once
constexpr int kSampleThreads = 256;

__device__ inline void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v rounded to TF32 (nearest, ties away, as cvt.rna.tf32.f32)
__device__ inline unsigned rna(float v) { return (__float_as_uint(v) + 0x1000u) & 0xffffe000u; }

// hi = tf32(v); with SPLIT also lo = tf32(v - hi)
template <bool SPLIT>
__device__ inline void split4(const float4 v, unsigned (&hi)[4], unsigned (&lo)[4]) {
  const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = rna(f[i]);
    if (SPLIT) lo[i] = rna(f[i] - __uint_as_float(hi[i]));
  }
}

// c += a b: A 16 x 8 (a0..a3: rows g, g + 8, g, g + 8; columns t, t, t + 4,
// t + 4), B 8 x 8 (b0, b1: rows t, t + 4; column g), C 16 x 8 (c0..c3: rows
// g, g, g + 8, g + 8; columns 2t, 2t + 1, 2t, 2t + 1), g = lane / 4, t = lane % 4.
__device__ inline void mma_tf32(float (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ inline float gelu(float y) { return 0.5f * y * (1.f + erff(y * 0.70710678118654752f)); }

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- layer 0: C == 1 ---------------------------------------------------------

template <int J>
__global__ void __launch_bounds__(kSampleThreads, 2)
    wavlm_conv_samples_kernel(const float* __restrict__ x, long long xs, const float* __restrict__ w,
                              const float* __restrict__ bias, const float* __restrict__ gamma,
                              const float* __restrict__ beta, float* __restrict__ out, int L,
                              int k, int s, int T_out, float eps) {
  constexpr int N = 128 * J;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                        // k x N
  float* vs = ws + k * N;                  // gamma, beta, bias: 3 x N
  float* xsm = vs + 3 * N;                 // the strip's samples
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y, f0 = blockIdx.x * kStrip;
  const int span = s * (kStrip - 1) + k;
  for (int e = threadIdx.x; e < k * N / 4; e += kSampleThreads)
    reinterpret_cast<float4*>(ws)[e] = reinterpret_cast<const float4*>(w)[e];
  for (int e = threadIdx.x; e < N; e += kSampleThreads) {
    vs[e] = gamma[e];
    vs[N + e] = beta[e];
    vs[2 * N + e] = bias ? bias[e] : 0.f;
  }
  const long long i0 = (long long)s * f0;
  const float* xb = x + (long long)b * xs;
  for (int e = threadIdx.x; e < span; e += kSampleThreads)
    xsm[e] = i0 + e < L ? xb[i0 + e] : 0.f;
  __syncthreads();

  const float4* w4 = reinterpret_cast<const float4*>(ws);
  const float4* v4 = reinterpret_cast<const float4*>(vs);
  for (int fb = warp * kFrames; fb < kStrip && f0 + fb < T_out; fb += 8 * kFrames) {
    float acc[kFrames][J][4];
#pragma unroll
    for (int fr = 0; fr < kFrames; ++fr)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float4 bv = v4[(2 * N) / 4 + 32 * j + lane];
        acc[fr][j][0] = bv.x;
        acc[fr][j][1] = bv.y;
        acc[fr][j][2] = bv.z;
        acc[fr][j][3] = bv.w;
      }
    for (int kk = 0; kk < k; ++kk) {
      float sm[kFrames];
#pragma unroll
      for (int fr = 0; fr < kFrames; ++fr) sm[fr] = xsm[s * (fb + fr) + kk];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float4 wv = w4[kk * (N / 4) + 32 * j + lane];
#pragma unroll
        for (int fr = 0; fr < kFrames; ++fr) {
          acc[fr][j][0] = fmaf(sm[fr], wv.x, acc[fr][j][0]);
          acc[fr][j][1] = fmaf(sm[fr], wv.y, acc[fr][j][1]);
          acc[fr][j][2] = fmaf(sm[fr], wv.z, acc[fr][j][2]);
          acc[fr][j][3] = fmaf(sm[fr], wv.w, acc[fr][j][3]);
        }
      }
    }
#pragma unroll
    for (int fr = 0; fr < kFrames; ++fr) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) sum += acc[fr][j][q];
      const float mean = warp_sum(sum) / N;
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float d = acc[fr][j][q] - mean;
          sq += d * d;
        }
      const float rstd = rsqrtf(warp_sum(sq) / N + eps);
      const int f = f0 + fb + fr;
      if (f >= T_out) continue;
      float* dst = out + ((long long)b * T_out + f) * N;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float4 gv = v4[32 * j + lane], be = v4[N / 4 + 32 * j + lane];
        float4 o;
        o.x = gelu((acc[fr][j][0] - mean) * rstd * gv.x + be.x);
        o.y = gelu((acc[fr][j][1] - mean) * rstd * gv.y + be.y);
        o.z = gelu((acc[fr][j][2] - mean) * rstd * gv.z + be.z);
        o.w = gelu((acc[fr][j][3] - mean) * rstd * gv.w + be.w);
        reinterpret_cast<float4*>(dst)[32 * j + lane] = o;
      }
    }
  }
}

template <int J>
int samples_launch(const float* x, long long xs, const float* w, const float* bias,
                   const float* gamma, const float* beta, float* out, int B, int L, int k,
                   int s, int T_out, float eps, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * ((k + 3) * 128 * J + s * (kStrip - 1) + k);
  cudaError_t err = cudaFuncSetAttribute(wavlm_conv_samples_kernel<J>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_out + kStrip - 1) / kStrip, B);
  wavlm_conv_samples_kernel<J><<<grid, kSampleThreads, smem, stream>>>(
      x, xs, w, bias, gamma, beta, out, L, k, s, T_out, eps);
  return (int)cudaGetLastError();
}

// ---- layers 1-6: C % 32 == 0 ---------------------------------------------------

template <bool SPLIT>
__global__ void __launch_bounds__(kGemmThreads, 1)
    wavlm_conv_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           const float* __restrict__ bias, const float* __restrict__ gamma,
                           const float* __restrict__ beta, float* __restrict__ out, int T_in,
                           int C, int N, int k, int s, int T_out, float eps) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int BN = N / 2, warps_n = BN / kWN, nthreads = 64 * warps_n;
  const int half = blockIdx.x & 1, t0 = (blockIdx.x >> 1) * kBM, b = blockIdx.y;
  const int wm0 = (warp / warps_n) * kWM, wn0 = (warp % warps_n) * kWN;
  const int K = k * C, KT = K / kBK;
  const int stage = (kBM + BN) * kBK;
  const float* xb = x + (long long)b * T_in * C;
  // the weight's exact copy for 3xTF32, its TF32 copy for one pass
  const float* wh = w + ((SPLIT ? 0LL : (long long)N) + (long long)half * BN) * K;

  // part `part` of `parts` of stage kt's copies into ring slot `slot`
  auto load_part = [&](int slot, int kt, int part, int parts) {
    float* As = smem + slot * stage;
    float* Bs = As + kBM * kBK;
    const int k0 = kt * kBK, na = kBM * 8 / parts, nb = BN * 8 / parts;
    for (int e = part * na + tid; e < (part + 1) * na; e += nthreads) {
      const int r = e >> 3, c = e & 7;
      const long long tr = min(t0 + r, T_out - 1);
      cp_async16(As + r * kBK + ((c ^ ((r & 1) << 2)) << 2), xb + s * tr * C + k0 + 4 * c);
    }
    for (int e = part * nb + tid; e < (part + 1) * nb; e += nthreads) {
      const int r = e >> 3, c = e & 7;
      cp_async16(Bs + r * kBK + ((c ^ ((r & 1) << 2)) << 2), wh + (long long)r * K + k0 + 4 * c);
    }
  };

  float acc[4][8][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < KT) load_part(st, st, 0, 1);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                       // stage kt landed; stage kt - 1 read by all
    const int nk = kt + kStages - 1;       // the stage whose copies go out now
    const float* As = smem + (kt % kStages) * stage + wm0 * kBK;
    const float* Bs = smem + (kt % kStages) * stage + (kBM + wn0) * kBK;
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      // this thread's 16 bytes of a row in k16 step j (every fragment row
      // has the parity of g)
      const int off = ((4 * j + t) ^ ((g & 1) << 2)) << 2;
      unsigned ah[4][2][4], al[4][2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          split4<SPLIT>(*reinterpret_cast<const float4*>(As + (mt * 16 + g + 8 * h) * kBK + off),
                        ah[mt][h], al[mt][h]);
      // half of the next stage's copies a step, between the loads of the
      // fragments and the products, not all at once
      if (nk < KT) load_part(nk % kStages, nk, j, kBK / 16);
      // B a column tile at a time, the next one's load issued before this
      // one's products
      float4 next = *reinterpret_cast<const float4*>(Bs + g * kBK + off);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float4 bv = next;
        if (nt + 1 < 8) next = *reinterpret_cast<const float4*>(Bs + ((nt + 1) * 8 + g) * kBK + off);
        unsigned bh[4], bl[4];
        if (SPLIT) {
          split4<true>(bv, bh, bl);
        } else {                           // B is rounded to TF32 already
          bh[0] = __float_as_uint(bv.x);
          bh[1] = __float_as_uint(bv.y);
          bh[2] = __float_as_uint(bv.z);
          bh[3] = __float_as_uint(bv.w);
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const unsigned bfh[2] = {bh[2 * q], bh[2 * q + 1]};
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            const unsigned afh[4] = {ah[mt][0][2 * q], ah[mt][1][2 * q], ah[mt][0][2 * q + 1],
                                     ah[mt][1][2 * q + 1]};
            if (SPLIT) {
              const unsigned bfl[2] = {bl[2 * q], bl[2 * q + 1]};
              const unsigned afl[4] = {al[mt][0][2 * q], al[mt][1][2 * q], al[mt][0][2 * q + 1],
                                       al[mt][1][2 * q + 1]};
              mma_tf32(acc[mt][nt], afl, bfh);
              mma_tf32(acc[mt][nt], afh, bfl);
            }
            mma_tf32(acc[mt][nt], afh, bfh);
          }
        }
      }
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();                         // the ring is free: reuse it

  // LayerNorm over the rows, two passes: red[warp column][row] this block's
  // partial sums, part[pass][row] their sum over the block's half of the
  // channels, read by the other block of the cluster too; stat[pass][row]
  // the row's mean, then rstd
  float* red = smem;                       // kMaxN / 2 / kWN x kBM
  float* part = red + (kMaxN / 2 / kWN) * kBM;   // 2 x kBM
  float* stat = part + 2 * kBM;            // 2 x kBM
  const float* other = cluster.map_shared_rank(part, cluster.block_rank() ^ 1);
  const int col0 = half * BN + wn0 + 2 * t;
  if (bias) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 bv = *reinterpret_cast<const float2*>(bias + col0 + nt * 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        acc[mt][nt][0] += bv.x;
        acc[mt][nt][1] += bv.y;
        acc[mt][nt][2] += bv.x;
        acc[mt][nt][3] += bv.y;
      }
    }
  }
  float mean[4][2], rstd[4][2];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float v = acc[mt][nt][2 * h + c];
            p += pass == 0 ? v : (v - mean[mt][h]) * (v - mean[mt][h]);
          }
        p += __shfl_xor_sync(0xffffffffu, p, 1);
        p += __shfl_xor_sync(0xffffffffu, p, 2);
        if (t == 0) red[(wn0 / kWN) * kBM + wm0 + mt * 16 + g + 8 * h] = p;
      }
    __syncthreads();
    for (int r = tid; r < kBM; r += nthreads) {
      float sum = 0.f;
      for (int v = 0; v < warps_n; ++v) sum += red[v * kBM + r];
      part[pass * kBM + r] = sum;
    }
    cluster.sync();                        // both halves' partial sums written
    for (int r = tid; r < kBM; r += nthreads) {
      // the same sum in both blocks: a + b == b + a
      const float sum = part[pass * kBM + r] + other[pass * kBM + r];
      stat[pass * kBM + r] = pass == 0 ? sum / N : rsqrtf(sum / N + eps);
    }
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = stat[pass * kBM + wm0 + mt * 16 + g + 8 * h];
        if (pass == 0)
          mean[mt][h] = v;
        else
          rstd[mt][h] = v;
      }
  }
  cluster.sync();                          // the other block has read `part`
  float2 gm[8], be[8];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    gm[nt] = *reinterpret_cast<const float2*>(gamma + col0 + nt * 8);
    be[nt] = *reinterpret_cast<const float2*>(beta + col0 + nt * 8);
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tt = t0 + wm0 + mt * 16 + g + 8 * h;
      if (tt >= T_out) continue;
      float* dst = out + ((long long)b * T_out + tt) * N + col0;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float y0 = (acc[mt][nt][2 * h] - mean[mt][h]) * rstd[mt][h] * gm[nt].x + be[nt].x;
        const float y1 = (acc[mt][nt][2 * h + 1] - mean[mt][h]) * rstd[mt][h] * gm[nt].y + be[nt].y;
        *reinterpret_cast<float2*>(dst + nt * 8) = make_float2(gelu(y0), gelu(y1));
      }
    }
}

template <bool SPLIT>
int gemm_launch(const float* x, const float* w, const float* bias, const float* gamma,
                const float* beta, float* out, int B, int T_in, int C, int N, int k, int s,
                int T_out, float eps, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * kStages * (kBM + N / 2) * kBK;
  cudaError_t err = cudaFuncSetAttribute(wavlm_conv_gemm_kernel<SPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * ((T_out + kBM - 1) / kBM), B);
  cfg.blockDim = dim3(64 * (N / 2 / kWN));
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;            // the two halves of the channels
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, wavlm_conv_gemm_kernel<SPLIT>, x, w, bias, gamma, beta, out,
                           T_in, C, N, k, s, T_out, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Layer 0 (one input channel) on `stream`: x samples (B, L) at row stride
// `xs` floats, w (k, N) taps by channel, bias (N,) or null, gamma and beta
// (N,), out (B, T_out, N); N = 128, 256, 384 or 512.  Every pointer on the
// card, w 16-byte aligned.  Returns the cudaError_t of the launch (0 on
// success), cudaErrorInvalidValue for sizes it does not take.
extern "C" int wavlm_conv_samples_launch(const float* x, long long xs, const float* w,
                                         const float* bias, const float* gamma,
                                         const float* beta, float* out, int B, int L, int N,
                                         int k, int s, int T_out, float eps, void* stream) {
  if (B <= 0 || B > 65535 || k <= 0 || s <= 0 || L < k || T_out != (L - k) / s + 1 ||
      N % 128 != 0 || N <= 0 || N > kMaxN || xs < L)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (N / 128) {
    case 1: return samples_launch<1>(x, xs, w, bias, gamma, beta, out, B, L, k, s, T_out, eps, st);
    case 2: return samples_launch<2>(x, xs, w, bias, gamma, beta, out, B, L, k, s, T_out, eps, st);
    case 3: return samples_launch<3>(x, xs, w, bias, gamma, beta, out, B, L, k, s, T_out, eps, st);
    default: return samples_launch<4>(x, xs, w, bias, gamma, beta, out, B, L, k, s, T_out, eps, st);
  }
}

// Layers 1-6 on `stream`: x (B, T_in, C) contiguous, w (2, N, k C) (the
// weight's (N, C, k) repacked with K = j C + c contiguous, then the same
// rounded to TF32), bias (N,) or
// null, gamma and beta (N,), out (B, T_out, N); C % 32 == 0, N % 128 == 0,
// N <= 512.  Every pointer on the card and 16-byte aligned.  `split` != 0:
// the products in 3xTF32, else one TF32 pass.  Returns the cudaError_t of
// the launch (0 on success), cudaErrorInvalidValue for sizes it does not
// take.
extern "C" int wavlm_conv_gemm_launch(const float* x, const float* w, const float* bias,
                                      const float* gamma, const float* beta, float* out, int B,
                                      int T_in, int C, int N, int k, int s, int T_out, float eps,
                                      int split, void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || C % kBK != 0 || N <= 0 || N % (2 * kWN) != 0 ||
      N > kMaxN ||
      k <= 0 || s <= 0 || T_in < k || T_out != (T_in - k) / s + 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (split) return gemm_launch<true>(x, w, bias, gamma, beta, out, B, T_in, C, N, k, s, T_out, eps, st);
  return gemm_launch<false>(x, w, bias, gamma, beta, out, B, T_in, C, N, k, s, T_out, eps, st);
}
