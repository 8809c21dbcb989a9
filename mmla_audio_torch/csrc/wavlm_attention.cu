// Kernel A1: WavLM's self-attention with its gated relative position bias,
// one launch a layer (wrapper: mmla_audio_torch/ops/cuda_attention.py).
//
// Replaces no TPU kernel: the JAX package has no WavLM.  It was added because
// the plain path materialises the gated bias, a (B * H, T, T) float32 tensor a
// layer (66 MB at B = 64, T = 127), writes the scores beside it and reads
// both back through the softmax; here the bias and the mask are applied to
// scores held in registers, and neither leaves the chip.
//
//   out[b, i, h, :] = sum_j p_ij v[b, h, j, :],
//   p_ij = softmax over j < len[b] of  q[b, h, i, :] . k[b, h, j, :] / 8
//                                      + gate[b, h, i] * bias[h, j - i + T - 1]
//
// Layouts: element (b, h, t, d) of q, k and v at b*sb + h*sh + t*st + d (one
// set of strides for the three, d contiguous, every stride a multiple of 4);
// gate (b, h, t) at b*gb + h*gh + t*gt; bias (H, 2T - 1) contiguous: layer 0's
// table E[h, bucket(j - i)] for j - i = -(T - 1) .. T - 1; lens (B,) int32,
// the keys a row attends to (1 <= len); out (B, T, H, 64) contiguous, so that
// the output projection reads it as (B, T, H * 64) without a copy.
//
// Design.  A CTA of four warps takes 64 query rows of one (b, h), warp w the
// 16 rows 16w .. 16w + 15, its Q fragments (scaled by 1/8, which is exact) in
// registers.  Keys stream through shared memory 64 at a time, only up to
// len[b]: K at a row stride of 68 floats and V at 72, so that the B fragments
// of mma.sync m16n8k8 fall in 32 different banks.  For each tile a warp forms
// its 16 x 64 scores on the tensor cores (8 key tiles x 8 steps of d), adds
// gate x bias and masks keys past len in registers, keeps a running maximum
// and sum a row (fp32, the accumulator rescaled when the maximum moves),
// writes the probabilities to its own shared strip in the A-fragment layout's
// order and multiplies them into V (8 tiles of d x 8 steps of keys).  Dots run
// in TF32, each operand rounded to nearest; with SPLIT (TF32 not allowed),
// in 3xTF32: a b = ah bh + ah bl + al bh, fp32 to rounding.
//
// Bound (bytes: q, k, v, out once, gate, table, lens): at B = 64, T = 127,
// H = 16, 4.23 GFLOP, 8.5 us at 495 TFLOP/s of TF32, and 133.7 MB, 39.9 us
// at 3.35 TB/s: the bytes bind.  Each CTA reads its (b, h)'s K and V once per
// 64 query rows (twice at T = 127); the second read mostly hits L2.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kHead = 64;                  // head size
constexpr int kRows = 64;                  // query rows a CTA
constexpr int kKeys = 64;                  // keys a tile
constexpr int kWarps = kRows / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kQS = kHead + 4;             // row stride of Q, K and P tiles
constexpr int kVS = kHead + 8;             // row stride of the V tile
constexpr int kSmemFloats = kRows * kQS + kKeys * kQS + kKeys * kVS + kWarps * 16 * kQS;
constexpr int kSmemBytes = kSmemFloats * (int)sizeof(float);

// v rounded to TF32 (nearest, ties away, as cvt.rna.tf32.f32): the tensor
// cores ignore the low 13 bits.
__device__ inline unsigned rna(float v) { return (__float_as_uint(v) + 0x1000u) & 0xffffe000u; }

// c += a b: A 16 x 8 (a0..a3: rows g, g + 8, g, g + 8; columns t, t, t + 4,
// t + 4), B 8 x 8 (b0, b1: rows t, t + 4; column g), C 16 x 8 (c0..c3: rows
// g, g, g + 8, g + 8; columns 2t, 2t + 1, 2t, 2t + 1), g = lane / 4, t = lane % 4.
__device__ inline void mma_tf32(float (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b on fp32 operands: one TF32 pass, or 3xTF32 with SPLIT.
template <bool SPLIT>
__device__ inline void mma_f32(float (&c)[4], const float (&a)[4], const float (&b)[2]) {
  unsigned ah[4], bh[2];
#pragma unroll
  for (int r = 0; r < 4; ++r) ah[r] = rna(a[r]);
#pragma unroll
  for (int r = 0; r < 2; ++r) bh[r] = rna(b[r]);
  if (SPLIT) {
    unsigned al[4], bl[2];
#pragma unroll
    for (int r = 0; r < 4; ++r) al[r] = rna(a[r] - __uint_as_float(ah[r]));
#pragma unroll
    for (int r = 0; r < 2; ++r) bl[r] = rna(b[r] - __uint_as_float(bh[r]));
    mma_tf32(c, al, bh);
    mma_tf32(c, ah, bl);
  }
  mma_tf32(c, ah, bh);
}

// rows [r0, r0 + 64) of one (b, h)'s q, k or v into a shared tile of row
// stride `stride`, times `scale`; rows at or past `limit` are zeros.
__device__ inline void load_tile(float* tile, int stride, const float* src, long long st, int r0,
                                 int limit, float scale) {
  for (int e = threadIdx.x; e < 64 * (kHead / 4); e += kThreads) {
    const int r = e / (kHead / 4), c = (e % (kHead / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < limit) x = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) * st + c);
    float* d = tile + r * stride + c;
    d[0] = x.x * scale;
    d[1] = x.y * scale;
    d[2] = x.z * scale;
    d[3] = x.w * scale;
  }
}

__device__ inline float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ inline float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <bool SPLIT>
__global__ void __launch_bounds__(kThreads)
    wavlm_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ gate,
                           const float* __restrict__ bias, const int* __restrict__ lens,
                           float* __restrict__ out, int H, int T, long long sb, long long sh,
                           long long st, long long gb, long long gh, long long gt) {
  extern __shared__ float smem[];
  float* sq = smem;                        // kRows x kQS
  float* sk = sq + kRows * kQS;            // kKeys x kQS
  float* sv = sk + kKeys * kQS;            // kKeys x kVS
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sp = sv + kKeys * kVS + warp * 16 * kQS;   // this warp's 16 x 64 probabilities
  const int g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const long long base = (long long)b * sb + (long long)h * sh;
  const int len = min(lens[b], T);

  load_tile(sq, kQS, q + base, st, i0, T, 0.125f);
  __syncthreads();
  float qa[kHead / 8][4];
  const float* qw = sq + warp * 16 * kQS;
#pragma unroll
  for (int ks = 0; ks < kHead / 8; ++ks) {
    qa[ks][0] = qw[g * kQS + ks * 8 + t];
    qa[ks][1] = qw[(g + 8) * kQS + ks * 8 + t];
    qa[ks][2] = qw[g * kQS + ks * 8 + t + 4];
    qa[ks][3] = qw[(g + 8) * kQS + ks * 8 + t + 4];
  }
  // this thread's two rows: their gates, and layer 0's bias table at j - i
  const int ri[2] = {i0 + warp * 16 + g, i0 + warp * 16 + g + 8};
  float gi[2];
  const float* brow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool real = ri[r] < T;
    gi[r] = real ? gate[(long long)b * gb + (long long)h * gh + (long long)ri[r] * gt] : 0.f;
    brow[r] = bias + (long long)h * (2 * T - 1) + (T - 1) - (real ? ri[r] : 0);
  }

  float o[kHead / 8][4];
#pragma unroll
  for (int n = 0; n < kHead / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j0 = 0; j0 < len; j0 += kKeys) {
    __syncthreads();                       // the last tile's readers are done
    load_tile(sk, kQS, k + base, st, j0, T, 1.f);
    load_tile(sv, kVS, v + base, st, j0, T, 1.f);
    __syncthreads();
    float s[kKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kHead / 8; ++ks) {
        const float bf[2] = {sk[(n * 8 + g) * kQS + ks * 8 + t],
                             sk[(n * 8 + g) * kQS + ks * 8 + t + 4]};
        mma_f32<SPLIT>(s[n], qa[ks], bf);
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1, j = j0 + n * 8 + 2 * t + (c & 1);
        s[n][c] = j < len ? s[n][c] + gi[r] * brow[r][j] : -INFINITY;
        mx[r] = fmaxf(mx[r], s[n][c]);
      }
    float scale[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // key j0 < len lies in this tile, so every row's maximum is finite
      const float mn = fmaxf(m[r], row_max(mx[r]));
      scale[r] = expf(m[r] - mn);
      m[r] = mn;
      l[r] *= scale[r];
    }
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        s[n][c] = expf(s[n][c] - m[r]);
        l[r] += s[n][c];
      }
      o[n][0] *= scale[0];
      o[n][1] *= scale[0];
      o[n][2] *= scale[1];
      o[n][3] *= scale[1];
      *reinterpret_cast<float2*>(sp + g * kQS + n * 8 + 2 * t) = make_float2(s[n][0], s[n][1]);
      *reinterpret_cast<float2*>(sp + (g + 8) * kQS + n * 8 + 2 * t) =
          make_float2(s[n][2], s[n][3]);
    }
    __syncwarp();
#pragma unroll
    for (int ks = 0; ks < kKeys / 8; ++ks) {
      const float pa[4] = {sp[g * kQS + ks * 8 + t], sp[(g + 8) * kQS + ks * 8 + t],
                           sp[g * kQS + ks * 8 + t + 4], sp[(g + 8) * kQS + ks * 8 + t + 4]};
#pragma unroll
      for (int n = 0; n < kHead / 8; ++n) {
        const float bf[2] = {sv[(ks * 8 + t) * kVS + n * 8 + g],
                             sv[(ks * 8 + t + 4) * kVS + n * 8 + g]};
        mma_f32<SPLIT>(o[n], pa, bf);
      }
    }
    __syncwarp();                          // the strip is rewritten next tile
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / row_sum(l[r]);
    if (ri[r] >= T) continue;
    float* dst = out + (((long long)b * T + ri[r]) * H + h) * kHead + 2 * t;
#pragma unroll
    for (int n = 0; n < kHead / 8; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) =
          make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

template <bool SPLIT>
int launch(const float* q, const float* k, const float* v, const float* gate, const float* bias,
           const int* lens, float* out, int B, int H, int T, long long sb, long long sh,
           long long st, long long gb, long long gh, long long gt, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(wavlm_attention_kernel<SPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kRows - 1) / kRows, H, B);
  wavlm_attention_kernel<SPLIT><<<grid, kThreads, kSmemBytes, stream>>>(
      q, k, v, gate, bias, lens, out, H, T, sb, sh, st, gb, gh, gt);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch A1 on `stream` (layouts above; every pointer on the card, q, k and
// v 16-byte aligned).  `split` != 0: the dots in 3xTF32, else one TF32
// pass.  Returns the cudaError_t of the launch (0 on success),
// cudaErrorInvalidValue for sizes it does not take.
extern "C" int wavlm_attention_launch(const float* q, const float* k, const float* v,
                                      const float* gate, const float* bias, const int* lens,
                                      float* out, int B, int H, int T, long long sb, long long sh,
                                      long long st, long long gb, long long gh, long long gt,
                                      int split, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || T <= 0 || (sb | sh | st) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (split) return launch<true>(q, k, v, gate, bias, lens, out, B, H, T, sb, sh, st, gb, gh, gt, s);
  return launch<false>(q, k, v, gate, bias, lens, out, B, H, T, sb, sh, st, gb, gh, gt, s);
}
