// Kernel A2: the Conformer's self-attention with Transformer-XL relative
// positions (wav2vec 2.0 Conformer, position_embeddings_type "relative"), one
// launch a layer (wrapper: mmla_audio_torch/ops/cuda_conformer_attention.py).
//
// Replaces no TPU kernel: the JAX package has no Conformer.  It was added
// because the plain path (transformers' `_apply_relative_embeddings`)
// materialises the positional scores (q + v_h) . p_h as a (B, H, T, 2T - 1)
// tensor, pads and copies it for the "rel shift", adds it to a (B, H, T, T)
// tensor of content scores and reads both back through the softmax: ~130 MB
// of round trips a layer at B = 64, T = 127.  Here both terms and the mask
// live in registers and shared memory, and neither leaves the chip.
//
//   out[b, i, h, :] = sum_j prob_ij v[b, h, j, :],  prob_ij = softmax over
//   j < len[b] of ((q_i + u_h) . k_j + (q_i + w_h) . p[h, j - i + T - 1]) / 8
//
// with q_i = q[b, h, i, :], u = pos_bias_u, w = pos_bias_v.
//
// Layouts: element (b, h, t, d) of q, k and v at b*sb + h*sh + t*st + d (one
// set of strides for the three, d contiguous, every stride a multiple of 4);
// u and w (H, 64) contiguous; p (H, 2T - 1, 64) contiguous, the layer's
// linear_pos of the sinusoids of relative positions T - 1 .. -(T - 1) (so that
// row j - i + T - 1 is position i - j); lens (B,) int32, the keys a row attends
// to (1 <= len); out (B, T, H, 64) contiguous, so that the output projection
// reads it as (B, T, H * 64) without a copy.
//
// Design: A1's (csrc/wavlm_attention.cu).  A CTA of four warps takes 64 query
// rows of one (b, h), warp w the 16 rows 16w .. 16w + 15, with two sets of Q
// fragments in registers: (q + u) / 8 and (q + w) / 8 (1/8 is exact).  Keys
// stream through shared memory 64 at a time, only up to len[b], K at a row
// stride of 68 floats and V at 72 (conflict-free B fragments of mma.sync
// m16n8k8).  With a key tile comes the band of the position table it needs:
// the 127 rows p[j - i + T - 1] for the tile's 64 queries and 64 keys.  Warp w
// multiplies its (q + w) rows into the 80 rows of the band its own queries
// reach (10 key tiles of 8; 1.25 times the products of the band it uses),
// writes that 16 x 80 product to its shared strip, and reads back for each
// score (i, j) its column j - i + 15 - the rel shift as an index, with no
// copy.  The content scores come from (q + u) and the K tile as in A1; the
// sum, the mask of keys past len, the running maximum and sum a row (fp32, the
// accumulator rescaled when the maximum moves) and the product with V are
// A1's.  The strip then holds the probabilities in the A-fragment layout's
// order.  Dots run in TF32, each operand rounded to nearest; with SPLIT (TF32
// not allowed), in 3xTF32: a b = ah bh + ah bl + al bh, fp32 to rounding.
//
// Bound (bytes: q, k, v, out once, the table, u, w and lens): at B = 64,
// T = 127, H = 16, three products of T^2 d a head (q.k, the used band of
// q.p, prob.v) are 6.34 GFLOP, 12.8 us at 495 TFLOP/s of TF32, and 133.7 MB,
// 39.9 us at 3.35 TB/s: the bytes bind.  Each CTA reads its (b, h)'s K, V and
// band once per 64 query rows (twice at T = 127); the second read mostly hits
// L2.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kHead = 64;                  // head size
constexpr int kRows = 64;                  // query rows a CTA
constexpr int kKeys = 64;                  // keys a tile
constexpr int kWarps = kRows / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kBand = 128;                 // rows of the position band a tile (127 used)
constexpr int kReach = 80;                 // band rows a warp's 16 queries reach (79 used)
constexpr int kQS = kHead + 4;             // row stride of the Q, K and band tiles
constexpr int kVS = kHead + 8;             // row stride of the V tile
constexpr int kGS = kReach + 4;            // row stride of a warp's strip
constexpr int kSmemFloats =
    kRows * kQS + kKeys * kQS + kKeys * kVS + kBand * kQS + kWarps * 16 * kGS;
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

// `rows` rows from r0 of a (., 64) matrix of row stride st into a shared
// tile of row stride `stride`; rows outside [0, limit) are zeros.
__device__ inline void load_rows(float* tile, int stride, const float* src, long long st, int r0,
                                 int rows, int limit) {
  for (int e = threadIdx.x; e < rows * (kHead / 4); e += kThreads) {
    const int r = e / (kHead / 4), c = (e % (kHead / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r >= 0 && r0 + r < limit)
      x = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) * st + c);
    *reinterpret_cast<float4*>(tile + r * stride + c) = x;
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
    conformer_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ u,
                               const float* __restrict__ w, const float* __restrict__ p,
                               const int* __restrict__ lens, float* __restrict__ out, int H,
                               int T, long long sb, long long sh, long long st) {
  extern __shared__ float smem[];
  float* sq = smem;                        // kRows x kQS
  float* sk = sq + kRows * kQS;            // kKeys x kQS
  float* sv = sk + kKeys * kQS;            // kKeys x kVS
  float* sb_ = sv + kKeys * kVS;           // kBand x kQS: the position band
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* strip = sb_ + kBand * kQS + warp * 16 * kGS;   // this warp's 16 x kGS
  const int g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const long long base = (long long)b * sb + (long long)h * sh;
  const float* ph = p + (long long)h * (2 * T - 1) * kHead;
  const int len = min(lens[b], T);

  load_rows(sq, kQS, q + base, st, i0, kRows, T);
  __syncthreads();
  // (q + u) / 8 and (q + w) / 8 as A fragments
  float qu[kHead / 8][4], qw[kHead / 8][4];
  const float* qs = sq + warp * 16 * kQS;
#pragma unroll
  for (int ks = 0; ks < kHead / 8; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = g + 8 * (r & 1), col = ks * 8 + t + 4 * (r >> 1);
      const float x = qs[row * kQS + col];
      qu[ks][r] = (x + u[h * kHead + col]) * 0.125f;
      qw[ks][r] = (x + w[h * kHead + col]) * 0.125f;
    }
  }
  const int ri[2] = {i0 + warp * 16 + g, i0 + warp * 16 + g + 8};
  // the first band row this warp's queries reach, within the tile's band
  const float* band = sb_ + (48 - 16 * warp) * kQS;

  float o[kHead / 8][4];
#pragma unroll
  for (int n = 0; n < kHead / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j0 = 0; j0 < len; j0 += kKeys) {
    __syncthreads();                       // the last tile's readers are done
    load_rows(sk, kQS, k + base, st, j0, kKeys, T);
    load_rows(sv, kVS, v + base, st, j0, kKeys, T);
    // band row c holds p[j0 - i0 - 63 + T - 1 + c], position i - j of query
    // i0 + il and key j0 + jl where c = jl - il + 63
    load_rows(sb_, kQS, ph, kHead, j0 - i0 - 63 + T - 1, kBand, 2 * T - 1);
    __syncthreads();
    // the positional products of this warp's 16 queries and its 80 band rows,
    // row r and column c' = jl - r + 15 of the strip
#pragma unroll
    for (int n = 0; n < kReach / 8; ++n) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < kHead / 8; ++ks) {
        const float bf[2] = {band[(n * 8 + g) * kQS + ks * 8 + t],
                             band[(n * 8 + g) * kQS + ks * 8 + t + 4]};
        mma_f32<SPLIT>(c, qw[ks], bf);
      }
      *reinterpret_cast<float2*>(strip + g * kGS + n * 8 + 2 * t) = make_float2(c[0], c[1]);
      *reinterpret_cast<float2*>(strip + (g + 8) * kGS + n * 8 + 2 * t) = make_float2(c[2], c[3]);
    }
    // the content products with the K tile
    float s[kKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kHead / 8; ++ks) {
        const float bf[2] = {sk[(n * 8 + g) * kQS + ks * 8 + t],
                             sk[(n * 8 + g) * kQS + ks * 8 + t + 4]};
        mma_f32<SPLIT>(s[n], qu[ks], bf);
      }
    }
    __syncwarp();                          // the strip is written
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1, rl = g + 8 * r, jl = n * 8 + 2 * t + (c & 1);
        s[n][c] = j0 + jl < len ? s[n][c] + strip[rl * kGS + jl - rl + 15] : -INFINITY;
        mx[r] = fmaxf(mx[r], s[n][c]);
      }
    __syncwarp();                          // the strip is read
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
      *reinterpret_cast<float2*>(strip + g * kGS + n * 8 + 2 * t) = make_float2(s[n][0], s[n][1]);
      *reinterpret_cast<float2*>(strip + (g + 8) * kGS + n * 8 + 2 * t) =
          make_float2(s[n][2], s[n][3]);
    }
    __syncwarp();
#pragma unroll
    for (int ks = 0; ks < kKeys / 8; ++ks) {
      const float pa[4] = {strip[g * kGS + ks * 8 + t], strip[(g + 8) * kGS + ks * 8 + t],
                           strip[g * kGS + ks * 8 + t + 4], strip[(g + 8) * kGS + ks * 8 + t + 4]};
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
int launch(const float* q, const float* k, const float* v, const float* u, const float* w,
           const float* p, const int* lens, float* out, int B, int H, int T, long long sb,
           long long sh, long long st, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conformer_attention_kernel<SPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kRows - 1) / kRows, H, B);
  conformer_attention_kernel<SPLIT><<<grid, kThreads, kSmemBytes, stream>>>(
      q, k, v, u, w, p, lens, out, H, T, sb, sh, st);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch A2 on `stream` (layouts above; every pointer on the card, q, k, v and
// p 16-byte aligned).  `split` != 0: the dots in 3xTF32, else one TF32 pass.
// Returns the cudaError_t of the launch (0 on success), cudaErrorInvalidValue
// for sizes it does not take.
extern "C" int conformer_attention_launch(const float* q, const float* k, const float* v,
                                          const float* u, const float* w, const float* p,
                                          const int* lens, float* out, int B, int H, int T,
                                          long long sb, long long sh, long long st, int split,
                                          void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || T <= 0 || (sb | sh | st) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (split) return launch<true>(q, k, v, u, w, p, lens, out, B, H, T, sb, sh, st, s);
  return launch<false>(q, k, v, u, w, p, lens, out, B, H, T, sb, sh, st, s);
}
