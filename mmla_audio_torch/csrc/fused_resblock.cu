// Fused non-pooling pre-activation residual block for Hopper (sm_90a), inference.
//
// Replaces the TPU kernel `_fused_block_kernel` of
// benchmarks/fused_block_probe.py (wrapper `fused_block`), and with it the
// seven launches of an unfused `ResBlock2D(pool=False)` in eval mode
// (mmla_audio_torch/models/overlap.py):
//
//   t   = elu(x * g1 + bb1)                 BatchNorm 0 folded to a scale and shift
//   y   = conv3x3(t, zero pad 1) + b1
//   t2  = elu(y * g2 + bb2)                 BatchNorm 1 folded
//   out = x + conv(4,1)(t2, zero pad 1 above, 2 below) + b2
//
// x, out: (B, C, H, W) float32, NCHW.  k1: (3, 3, C, C) and k2: (4, 1, C, C),
// HWIO, so the output channels of one tap are contiguous.  Vectors: (C,).
// The convolutions zero-pad the activated tensors: a halo pixel outside the
// image is 0, not elu(bb).
//
// What bounds it: one sample of a block is 2 * 13 * C^2 * H * W = 129.5
// MFLOP at every stage of the full-width model (C = 32 at 64x76, 64 at
// 32x38, 128 at 16x19), with 0.6 MB of activations in and out: ~200 FLOP a
// byte, so at any batch it is bound by arithmetic, not by device memory.
// On the CUDA cores (67 TFLOP/s fp32) that bound is 0.93 ms at B = 480; on
// the tensor cores in 3xTF32 (three TF32 products for one fp32 one, 495
// TFLOP/s) 0.38 ms.
//
// Two kernels; the width alone picks one (`block_route` in
// ops/cuda_resblock.py), and the wrapper passes the tile plan.
//
// * C % 8 == 0, every stage of the model: `mma_kernel`, an implicit GEMM
//   on the tensor cores.  Each convolution is a GEMM over a tile in shared
//   memory: M = pixels, N = output channels, K = (tap, input channel); a tap
//   is an address offset into the tile, so no im2col is written, and the
//   activated middle tile never leaves shared memory.  The instruction is
//   mma.sync m16n8k8 in TF32; each operand is split into hi = tf32(v) and
//   lo = tf32(v - hi) and the product summed as lo*hi + hi*lo + hi*hi in
//   fp32, which keeps fp32's accuracy (the plain version's 1e-4 of max|ref|
//   holds; one TF32 product would not).  A CTA of 8 warps computes `rows` x
//   `cols` output pixels of one sample, all C channels; only the middle
//   rows inside the image are computed, so a plan of whole image columns
//   computes no middle row twice.  Tiles are pixel-major with a channel
//   stride of C + 4, so one ldmatrix.x4 gives a warp its A fragment without
//   bank conflicts; weight rows have a stride of C + 8 (C + 16 when C / 8 is
//   odd), so the B fragment loads are conflict-free too.  The weights
//   stream through two buffers of `kc` rows with cp.async, the next chunk
//   in flight while the warps compute on this one.  A warp owns MT m16
//   tiles by 32 output channels, and its k-step has no branch, so the
//   compiler interleaves the 4 MT independent mma chains.  The epilogues
//   run in fp32 on the CUDA cores from the accumulator fragments; the
//   residual is added in a last pass over shared memory, which reads x
//   where it writes out.  The plan (`plan_block_tiles`) keeps a CTA under
//   113 KB so that two share an SM.  On the H100 at B = 480 it takes
//   2.1-2.5 ms a shape: the k-steps run the tensor cores at about a third
//   of their TF32 rate, and about half the time is staging, epilogues and
//   the weight chunks' L2 latency (PERF.md).
// * any other width: `ffma_kernel`, fp32 FMAs on the CUDA cores.  One CTA
//   computes kRows = 4 output rows by `cols` columns; shared memory holds
//   the activated input tile (kRows + 5 rows, cols + 2 columns) and the
//   middle tile (kRows + 3 rows), so 3 middle rows of 4 are computed twice.
//   A warp owns 32 x P pixels (lane-strided, conflict-free) and Q output
//   channels, Q the largest of 4, 2, 1 dividing C; the conv3x3 weights
//   stream through shared memory kCi input channels at a time,
//   double-buffered with cp.async; the conv(4,1) weights are read through
//   L1.  One CTA per SM.
//
// The TPU kernel's pixel packing, lane rolls and block-diagonal weights
// were for 128-lane registers and are not copied.  TMA and wgmma are later
// work: wgmma's 64-row warpgroup tiles and shared-memory descriptors do not
// fit the per-tap shifted view of the tile simply.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;           // output rows per CTA
constexpr int kMid = kRows + 3;    // middle rows: (4,1) taps reach 1 above, 2 below
constexpr int kIn = kRows + 5;     // input rows: plus the 3x3 halo
constexpr int kP1 = 5;             // pixels per thread in conv3x3
constexpr int kP2 = 3;             // pixels per thread in conv(4,1)
constexpr int kStage = 8;          // input loads in flight per thread
constexpr int kCi = 4;             // conv3x3 input channels per weight chunk

__host__ __device__ inline long long round4(long long x) { return (x + 3) & ~3LL; }

// Shared-memory floats of one CTA: the activated input tile (C, kIn, cols +
// 2), the middle tile (C, kMid, cols), then two weight chunks (kCi, 9, C)
// at a 16-byte boundary.
__host__ __device__ inline long long tile_floats(int C, int cols) {
  return round4((long long)C * (kIn * (cols + 2) + kMid * cols));
}
__host__ inline long long smem_bytes(int C, int cols) {
  return (tile_floats(C, cols) + 2LL * kCi * 9 * C) * (long long)sizeof(float);
}

__device__ inline float elu(float v) { return v > 0.0f ? v : expm1f(v); }

__device__ inline float affine(float v, float g, float b) {
  return __fadd_rn(__fmul_rn(v, g), b);
}

__device__ inline void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ inline void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Start copying the chunk of k1 (3, 3, C, C) for input channels c0 .. c0 +
// kCi - 1 into wb as (kCi, 9, C): row (cl, tap) of wb is k1's contiguous row
// (tap, c0 + cl, :).  One commit group per chunk.
__device__ inline void stage_weights(const float* __restrict__ k1, int C, int c0, float* wb) {
  const int rows = min(kCi, C - c0) * 9;
  if ((C & 3) == 0) {
    const int n4 = C >> 2;
    for (int e = threadIdx.x; e < rows * n4; e += kThreads) {
      const int row = e / n4, c = (e - row * n4) * 4;
      const int cl = row / 9, tap = row - cl * 9;
      cp_async16(wb + row * C + c, k1 + ((long long)tap * C + c0 + cl) * C + c);
    }
  } else {
    for (int e = threadIdx.x; e < rows * C; e += kThreads) {
      const int row = e / C, c = e - row * C;
      const int cl = row / 9, tap = row - cl * 9;
      cp_async4(wb + e, k1 + ((long long)tap * C + c0 + cl) * C + c);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Q consecutive weights at p (16-byte aligned when Q % 4 == 0).
template <int Q, bool kGlobal>
__device__ inline void load_q(const float* p, float (&w)[Q]) {
  if constexpr (Q % 4 == 0) {
#pragma unroll
    for (int q4 = 0; q4 < Q / 4; ++q4) {
      const float4 v = kGlobal ? __ldg(reinterpret_cast<const float4*>(p) + q4)
                               : reinterpret_cast<const float4*>(p)[q4];
      w[4 * q4 + 0] = v.x;
      w[4 * q4 + 1] = v.y;
      w[4 * q4 + 2] = v.z;
      w[4 * q4 + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) w[q] = kGlobal ? __ldg(p + q) : p[q];
  }
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
ffma_kernel(const float* __restrict__ x, float* __restrict__ out,
                      const float* __restrict__ k1, const float* __restrict__ b1,
                      const float* __restrict__ k2, const float* __restrict__ b2,
                      const float* __restrict__ g1, const float* __restrict__ bb1,
                      const float* __restrict__ g2, const float* __restrict__ bb2,
                      int C, int H, int W, int cols) {
  const int co_blocks = C / Q;
  extern __shared__ float4 smem4[];
  const int CP = cols + 2;                   // input tile row with its side columns
  const int tplane = kIn * CP;
  const int mplane = kMid * cols;
  float* t = reinterpret_cast<float*>(smem4);  // (C, kIn, cols + 2) activated input
  float* mid = t + C * tplane;                 // (C, kMid, cols) activated middle rows
  float* wbuf = t + tile_floats(C, cols);      // (2, kCi, 9, C) conv3x3 weights
  const int wchunk = kCi * 9 * C;

  const int col_tiles = (W + cols - 1) / cols;
  const int r0 = (blockIdx.x / col_tiles) * kRows;   // first output row; input row i is r0 - 2 + i
  const int w0 = (blockIdx.x % col_tiles) * cols;    // first output column; input column j is w0 - 1 + j
  const long long HW = (long long)H * W;
  const float* xb = x + (long long)blockIdx.y * C * HW;
  float* ob = out + (long long)blockIdx.y * C * HW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  stage_weights(k1, C, 0, wbuf);             // the first chunk lands during step 1

  // 1. t = elu(x * g1 + bb1), zero outside the image and in the side
  // columns.  Each thread issues kStage loads before it stores, so they are
  // in flight together; the first barrier of step 2 publishes t.
  for (int i0 = 0; i0 < C * tplane; i0 += kStage * kThreads) {
    float v[kStage];
    bool inside[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = i0 + u * kThreads + tid;
      const int c = i / tplane, rem = i - c * tplane;
      const int rr = rem / CP, col = rem - rr * CP;
      const int row = r0 - 2 + rr, w = w0 - 1 + col;
      inside[u] = i < C * tplane && row >= 0 && row < H && w >= 0 && w < W;
      v[u] = inside[u] ? xb[c * HW + (long long)row * W + w] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = i0 + u * kThreads + tid;
      const int c = i / tplane;
      if (i < C * tplane)
        t[i] = inside[u] ? elu(affine(v[u], __ldg(g1 + c), __ldg(bb1 + c))) : 0.0f;
    }
  }

  // 2. middle row mr (image row r0 - 1 + mr): elu((conv3x3(t) + b1) * g2 + bb2),
  // zero outside the image; middle columns past W feed no output.  The
  // conv3x3 weights pass through shared memory kCi input channels at a time,
  // double-buffered: while the warps compute on one chunk, cp.async brings
  // the next.  All warps go through the chunks together (a barrier per
  // chunk), so items go out in rounds of one per warp.
  const int npix1 = kMid * cols;
  const int nchunk1 = (npix1 + 32 * kP1 - 1) / (32 * kP1);
  const int items1 = nchunk1 * co_blocks;
  for (int round = 0; round < items1; round += kWarps) {
    const int item = round + warp;
    const bool active = item < items1;
    const int chunk = active ? item / co_blocks : 0;
    const int co0 = active ? (item - chunk * co_blocks) * Q : 0;
    int pix[kP1], base[kP1];
#pragma unroll
    for (int p = 0; p < kP1; ++p) {
      pix[p] = chunk * 32 * kP1 + p * 32 + lane;
      const int px = pix[p] < npix1 ? pix[p] : 0;
      const int mr = px / cols;
      base[p] = mr * CP + (px - mr * cols);  // tap (0, 0) of middle pixel px
    }
    float acc[kP1][Q];
#pragma unroll
    for (int p = 0; p < kP1; ++p)
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[p][q] = 0.0f;
    for (int c0 = 0; c0 < C; c0 += kCi) {
      float* wb = wbuf + ((c0 / kCi) & 1) * wchunk;
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();                       // chunk c0 landed; the other buffer is free
      if (c0 + kCi < C) stage_weights(k1, C, c0 + kCi, wbuf + (((c0 / kCi) + 1) & 1) * wchunk);
      if (active) {
#pragma unroll
        for (int cl = 0; cl < kCi; ++cl) {
          if (c0 + cl >= C) break;
          const float* tc = t + (c0 + cl) * tplane;
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const int dh = tap / 3, dw = tap % 3;
            float wv[Q];
            load_q<Q, false>(wb + (cl * 9 + tap) * C + co0, wv);
#pragma unroll
            for (int p = 0; p < kP1; ++p) {
              const float a = tc[base[p] + dh * CP + dw];
#pragma unroll
              for (int q = 0; q < Q; ++q) acc[p][q] = fmaf(a, wv[q], acc[p][q]);
            }
          }
        }
      }
    }
    __syncthreads();                         // every warp is done with both buffers
    if (round + kWarps < items1) stage_weights(k1, C, 0, wbuf);
    if (!active) continue;
#pragma unroll
    for (int p = 0; p < kP1; ++p) {
      if (pix[p] >= npix1) continue;
      const int row = r0 - 1 + pix[p] / cols;
      const bool inside = row >= 0 && row < H;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int co = co0 + q;
        mid[co * mplane + pix[p]] =
            inside ? elu(affine(acc[p][q] + __ldg(b1 + co), __ldg(g2 + co), __ldg(bb2 + co)))
                   : 0.0f;
      }
    }
  }
  __syncthreads();

  // 3. output pixel (o, j) (image row r0 + o, column w0 + j): x + conv(4,1)(mid)
  // + b2; middle rows o .. o + 3 are image rows r0 + o - 1 .. r0 + o + 2
  const int ncols = min(cols, W - w0);
  const int npix2 = min(kRows, H - r0) * cols;
  const int nchunk2 = (npix2 + 32 * kP2 - 1) / (32 * kP2);
  for (int item = warp; item < nchunk2 * co_blocks; item += kWarps) {
    const int chunk = item / co_blocks, co0 = (item - chunk * co_blocks) * Q;
    int pix[kP2];
#pragma unroll
    for (int p = 0; p < kP2; ++p) pix[p] = chunk * 32 * kP2 + p * 32 + lane;
    float acc[kP2][Q];
#pragma unroll
    for (int p = 0; p < kP2; ++p)
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[p][q] = 0.0f;
    for (int ci = 0; ci < C; ++ci) {
      const float* mc = mid + ci * mplane;
#pragma unroll
      for (int kh = 0; kh < 4; ++kh) {
        float wv[Q];
        load_q<Q, true>(k2 + (kh * C + ci) * C + co0, wv);
#pragma unroll
        for (int p = 0; p < kP2; ++p) {
          const float a = mc[(pix[p] < npix2 ? pix[p] : 0) + kh * cols];
#pragma unroll
          for (int q = 0; q < Q; ++q) acc[p][q] = fmaf(a, wv[q], acc[p][q]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kP2; ++p) {
      const int o = pix[p] / cols, j = pix[p] - o * cols;
      if (pix[p] >= npix2 || j >= ncols) continue;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int co = co0 + q;
        const long long idx = co * HW + (long long)(r0 + o) * W + w0 + j;
        ob[idx] = xb[idx] + (acc[p][q] + __ldg(b2 + co));
      }
    }
  }
}

template <int Q>
int launch(const float* x, float* out, const float* k1, const float* b1, const float* k2,
           const float* b2, const float* g1, const float* bb1, const float* g2,
           const float* bb2, int B, int C, int H, int W, cudaStream_t stream) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // the widest tile that fits, then equal tiles over the row
  int cols = W;
  while (cols > 0 && smem_bytes(C, cols) > limit) --cols;
  if (cols == 0) return (int)cudaErrorInvalidValue;
  const int col_tiles = (W + cols - 1) / cols;
  cols = (W + col_tiles - 1) / col_tiles;
  const long long smem = smem_bytes(C, cols);
  err = cudaFuncSetAttribute(ffma_kernel<Q>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((H + kRows - 1) / kRows) * col_tiles, B);
  ffma_kernel<Q><<<grid, kThreads, smem, stream>>>(x, out, k1, b1, k2, b2, g1, bb1, g2, bb2, C,
                                                  H, W, cols);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core kernel, C % 8 == 0: 3xTF32 mma.sync implicit GEMM.

constexpr int kNT = 4;             // n8 tiles of a warp item: 32 output channels

// Channel stride of the pixel-major tiles: (C + 4) / 4 is odd, so the 8
// pixels x 4 channels of an A fragment load fall in 32 different banks.
__host__ __device__ inline int act_stride(int C) { return C + 4; }
// Row stride of a weight chunk: an odd multiple of 8, so the 4 rows x 8
// channels of a B fragment load fall in 32 different banks.
__host__ __device__ inline int w_stride(int C) { return C + (((C >> 3) & 1) ? 16 : 8); }

// Shared-memory floats of one CTA: the activated input tile ((rows + 5) x
// (cols + 2) pixels), the middle tile ((rows + 3) x cols), then two weight
// chunks of kc rows.  ops/cuda_resblock.py::block_smem_bytes is the same.
__host__ __device__ inline long long mma_tile_floats(int C, int rows, int cols) {
  return ((long long)(rows + 5) * (cols + 2) + (long long)(rows + 3) * cols) * act_stride(C);
}
__host__ inline long long mma_smem_bytes(int C, int rows, int cols, int kc) {
  return (mma_tile_floats(C, rows, cols) + 2LL * kc * w_stride(C)) * (long long)sizeof(float);
}

// v (fp32 bits) = hi + lo to 22 of its 24 bits: hi = tf32(v), lo = tf32(v -
// hi), both rounded to nearest, ties away, as cvt.rna.tf32.f32 rounds; for
// any v but a NaN the integer form gives the same bits without the compare
// and select that cvt spends on its Inf test.  The tensor cores ignore the
// low 13 bits of a TF32 operand, so lo is not masked.
__device__ inline void split_tf32(unsigned v, unsigned& hi, unsigned& lo) {
  hi = (v + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(v) - __uint_as_float(hi)) + 0x1000u;
}

// r[j] = this lane's element (row lane / 4, 32-bit column lane % 4) of the
// 8 x 4 matrix whose 16-byte rows lanes 8j .. 8j + 7 address.
__device__ inline void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
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

// The weight chunks in the order a CTA consumes them: every round of
// conv3x3 items reads k1 (9C rows of C) from its first row, then every round
// of conv(4,1) items reads k2 (4C rows).  Chunk q goes to buffer q & 1.
struct WeightStream {
  const float* w1;
  const float* w2;
  int n1, n2;                // chunks in one pass over k1, over k2
  int len1, len;             // chunks of all conv3x3 rounds; of both convolutions
  int kc, ws, C;
};

// Start copying chunk q into its buffer; one commit group.
__device__ inline void stage_chunk(const WeightStream& s, int q, float* wbuf) {
  const bool first = q < s.len1;
  const float* w = first ? s.w1 : s.w2;
  const int K = (first ? 9 : 4) * s.C;
  const int k0 = (first ? q % s.n1 : (q - s.len1) % s.n2) * s.kc;
  const int n = min(s.kc, K - k0), c4 = s.C >> 2;
  float* wb = wbuf + (q & 1) * s.kc * s.ws;
  for (int e = threadIdx.x; e < n * c4; e += kThreads) {
    const int r = e / c4, c = (e - r * c4) * 4;
    cp_async16(wb + r * s.ws + c, w + (long long)(k0 + r) * s.C + c);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// A GEMM's warp items: MT m16 tiles by kNT n8 tiles each.
__device__ inline int gemm_items(int M, int C, int mt) {
  return ((((M + 15) >> 4) + mt - 1) / mt) * ((C + 31) >> 5);
}

// One convolution as an implicit GEMM over the shared-memory tile `src`
// (pixel-major, channel stride C + 4).  Row p of A (p < M) is the tile pixel
// at row row0 + p / cols, column p % cols of a tile `pitch` pixels wide; its
// column k = tap * C + ci is that pixel shifted by the tap (tw taps to a
// tile row), channel ci.  B is the weights, K = taps * C rows, streamed
// through `wbuf`; q counts the chunks consumed.  Items go out in rounds of
// one per warp, each round a pass over all of K; epi(p, n, v_n, v_n+1)
// takes the results.  The k-step has no branch: rows past M read row 0 and
// n8 tiles past C multiply zeros, and the epilogue drops both, so the
// compiler can interleave the independent mma chains.
template <int MT, class Epi>
__device__ inline void conv_gemm(const float* src, int M, int K, int cols, int row0, int pitch,
                                 int tw, const WeightStream& ws, float* wbuf, int& q, Epi epi) {
  const int C = ws.C, cs = act_stride(C);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ngroups = (C + 31) >> 5;
  const unsigned src_addr = (unsigned)__cvta_generic_to_shared(src);
  const int items = gemm_items(M, C, MT);
  const int nchunks = (K + ws.kc - 1) / ws.kc;
  for (int round = 0; round < items; round += kWarps) {
    const int item = round + warp;
    const bool active = item < items;
    const int m0 = active ? (item / ngroups) * MT : 0;
    const int n0 = active ? (item % ngroups) * 32 : 0;
    // the shared-memory byte address of the 16-byte row this lane gives
    // ldmatrix: pixel (lane & 7) + 8 ((lane >> 3) & 1) of the m16 tile,
    // channels 4 (lane >> 4) .. + 3 (matrices a0..a3: pixels +0 / +8 by
    // channels +0 / +4)
    unsigned abase[MT];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      int p = (m0 + mi) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      p = p < M ? p : 0;                     // rows past M compute row 0 again, unused
      const int r = p / cols;
      abase[mi] = src_addr + 4u * (((row0 + r) * pitch + p - r * cols) * cs + (lane >> 4) * 4);
    }
    float acc[MT][kNT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.0f;
    int tap = 0, ci = 0, tap_off = 0;        // k = tap * C + ci of the next k-step
    for (int c = 0; c < nchunks; ++c, ++q) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();                       // chunk q landed; the other buffer is free
      if (q + 1 < ws.len) stage_chunk(ws, q + 1, wbuf);
      if (!active) continue;
      const float* wb = wbuf + (q & 1) * ws.kc * ws.ws + t * ws.ws + n0 + g;
      const int nk = min(ws.kc, K - c * ws.kc);
#pragma unroll(MT < 3 ? 2 : 1)             // two k-steps in flight would spill at MT = 3
      for (int kk = 0; kk < nk; kk += 8) {
        unsigned bh[kNT][2], bl[kNT][2];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const bool in = n0 + nt * 8 < C;
          split_tf32(in ? __float_as_uint(wb[kk * ws.ws + nt * 8]) : 0u, bh[nt][0], bl[nt][0]);
          split_tf32(in ? __float_as_uint(wb[(kk + 4) * ws.ws + nt * 8]) : 0u, bh[nt][1],
                     bl[nt][1]);
        }
        const unsigned off = 4u * (tap_off + ci);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          unsigned a[4], ah[4], al[4];
          ldmatrix_x4(a, abase[mi] + off);
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[e], al[e]);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            mma_tf32(acc[mi][nt], al, bh[nt]);   // small products first
            mma_tf32(acc[mi][nt], ah, bl[nt]);
            mma_tf32(acc[mi][nt], ah, bh[nt]);
          }
        }
        ci += 8;
        if (ci == C) {
          ci = 0;
          ++tap;
          tap_off = ((tap / tw) * pitch + tap % tw) * cs;
        }
      }
    }
    if (!active) continue;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (m0 + mi) * 16 + g + 8 * h;
        if (p >= M) continue;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          if (n0 + nt * 8 < C)
            epi(p, n0 + nt * 8 + 2 * t, acc[mi][nt][2 * h], acc[mi][nt][2 * h + 1]);
      }
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 2)
mma_kernel(const float* __restrict__ x, float* __restrict__ out,
           const float* __restrict__ k1, const float* __restrict__ b1,
           const float* __restrict__ k2, const float* __restrict__ b2,
           const float* __restrict__ g1, const float* __restrict__ bb1,
           const float* __restrict__ g2, const float* __restrict__ bb2,
           int C, int H, int W, int rows, int cols, int kc) {
  extern __shared__ float4 smem4[];
  const int cs = act_stride(C), pitch = cols + 2;
  float* tin = reinterpret_cast<float*>(smem4);      // (rows + 5) x pitch activated input pixels
  float* mid = tin + (rows + 5) * pitch * cs;        // (rows + 3) x cols activated middle pixels
  float* wbuf = tin + mma_tile_floats(C, rows, cols);  // 2 x kc weight rows
  const int col_tiles = (W + cols - 1) / cols;
  const int r0 = (blockIdx.x / col_tiles) * rows;    // input row i: image row r0 - 2 + i
  const int w0 = (blockIdx.x % col_tiles) * cols;    // input column j: image column w0 - 1 + j
  const long long HW = (long long)H * W;
  const float* xb = x + (long long)blockIdx.y * C * HW;
  float* ob = out + (long long)blockIdx.y * C * HW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // Middle row m is image row r0 - 1 + m; only those inside the image are
  // computed (rows mr_lo .. mr_hi - 1), the others are 0.
  const int mr_lo = max(0, 1 - r0), mr_hi = min(rows + 3, H + 1 - r0);
  const int M1 = (mr_hi - mr_lo) * cols, M2 = min(rows, H - r0) * cols;
  WeightStream ws;
  ws.w1 = k1;
  ws.w2 = k2;
  ws.n1 = (9 * C + kc - 1) / kc;
  ws.n2 = (4 * C + kc - 1) / kc;
  ws.len1 = (gemm_items(M1, C, MT) + kWarps - 1) / kWarps * ws.n1;
  ws.len = ws.len1 + (gemm_items(M2, C, MT) + kWarps - 1) / kWarps * ws.n2;
  ws.kc = kc;
  ws.ws = w_stride(C);
  ws.C = C;
  stage_chunk(ws, 0, wbuf);                  // lands during the staging

  // 1. tin = elu(x * g1 + bb1), 0 outside the image.  A warp takes 8
  // neighbouring pixels of 4 channels (32-byte global segments, stores to
  // 32 banks); kStage loads in flight a thread.
  const int npix = (rows + 5) * pitch, pblocks = (npix + 7) >> 3;
  const int units = (C >> 2) * pblocks;
  for (int u0 = warp; u0 < units; u0 += kWarps * kStage) {
    float v[kStage];
    int at[kStage], ch[kStage];
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int u = u0 + s * kWarps;
      const int c = (u / pblocks) * 4 + (lane >> 3), p = (u % pblocks) * 8 + (lane & 7);
      const int rr = p / pitch, col = p - rr * pitch;
      const int row = r0 - 2 + rr, w = w0 - 1 + col;
      const bool inside = u < units && p < npix && row >= 0 && row < H && w >= 0 && w < W;
      at[s] = u < units && p < npix ? p * cs + c : -1;
      ch[s] = inside ? c : -1;
      v[s] = inside ? xb[c * HW + (long long)row * W + w] : 0.0f;
    }
#pragma unroll
    for (int s = 0; s < kStage; ++s)
      if (at[s] >= 0)
        tin[at[s]] = ch[s] >= 0 ? elu(affine(v[s], __ldg(g1 + ch[s]), __ldg(bb1 + ch[s]))) : 0.0f;
  }
  for (int i = tid; i < mr_lo * cols * cs; i += kThreads) mid[i] = 0.0f;
  for (int i = mr_hi * cols * cs + tid; i < (rows + 3) * cols * cs; i += kThreads) mid[i] = 0.0f;

  // 2. middle = elu((conv3x3(tin) + b1) * g2 + bb2); the first barrier of the
  // GEMM publishes tin.
  int q = 0;
  float* mid_rows = mid + mr_lo * cols * cs;
  conv_gemm<MT>(tin, M1, 9 * C, cols, mr_lo, pitch, 3, ws, wbuf, q,
                [&](int p, int n, float v0, float v1) {
                  float2 r;
                  r.x = elu(affine(v0 + __ldg(b1 + n), __ldg(g2 + n), __ldg(bb2 + n)));
                  r.y = elu(affine(v1 + __ldg(b1 + n + 1), __ldg(g2 + n + 1), __ldg(bb2 + n + 1)));
                  *reinterpret_cast<float2*>(mid_rows + p * cs + n) = r;
                });

  // 3. conv(4,1)(middle) + b2 into tin, which step 2 has done with: output
  // row o, tap kh reads middle row o + kh.  The first barrier of the GEMM
  // publishes the middle tile.
  conv_gemm<MT>(mid, M2, 4 * C, cols, 0, cols, 1, ws, wbuf, q,
                [&](int p, int n, float v0, float v1) {
                  float2 r;
                  r.x = v0 + __ldg(b2 + n);
                  r.y = v1 + __ldg(b2 + n + 1);
                  *reinterpret_cast<float2*>(tin + p * cs + n) = r;
                });
  __syncthreads();

  // 4. out = x + tin, in the staging's pattern: x is read where it is
  // written, kStage loads in flight a thread.
  const int ncols = min(cols, W - w0), opix = M2, oblocks = (opix + 7) >> 3;
  const int ounits = (C >> 2) * oblocks;
  for (int u0 = warp; u0 < ounits; u0 += kWarps * kStage) {
    float v[kStage];
    long long at[kStage];
    int sp[kStage];
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int u = u0 + s * kWarps;
      const int c = (u / oblocks) * 4 + (lane >> 3), p = (u % oblocks) * 8 + (lane & 7);
      const int o = p / cols, j = p - o * cols;
      const bool valid = u < ounits && p < opix && j < ncols;
      at[s] = valid ? c * HW + (long long)(r0 + o) * W + w0 + j : -1;
      sp[s] = p * cs + c;
      v[s] = valid ? xb[at[s]] : 0.0f;
    }
#pragma unroll
    for (int s = 0; s < kStage; ++s)
      if (at[s] >= 0) ob[at[s]] = v[s] + tin[sp[s]];
  }
}

template <int MT>
int launch_mma(const float* x, float* out, const float* k1, const float* b1, const float* k2,
               const float* b2, const float* g1, const float* bb1, const float* g2,
               const float* bb2, int B, int C, int H, int W, int rows, int cols, int kc,
               cudaStream_t stream) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const long long smem = mma_smem_bytes(C, rows, cols, kc);
  if (smem > limit) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(mma_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mma_kernel<MT>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((H + rows - 1) / rows) * ((W + cols - 1) / cols), B);
  mma_kernel<MT><<<grid, kThreads, smem, stream>>>(x, out, k1, b1, k2, b2, g1, bb1, g2, bb2, C,
                                                   H, W, rows, cols, kc);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch the FFMA kernel on `stream`; every pointer is a contiguous float32
// array on the card, the weights 16-byte aligned.  Any C % 8 != 0 (the
// tensor-core kernel takes the others) whose smallest tile (4 rows x 1
// column) fits the card's shared memory: C <= 548 on Hopper.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int fused_resblock_launch(const float* x, float* out, const float* k1,
                                     const float* b1, const float* k2, const float* b2,
                                     const float* g1, const float* bb1, const float* g2,
                                     const float* bb2, int B, int C, int H, int W,
                                     void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || C % 8 == 0 || H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (C % 4 == 0) return launch<4>(x, out, k1, b1, k2, b2, g1, bb1, g2, bb2, B, C, H, W, s);
  if (C % 2 == 0) return launch<2>(x, out, k1, b1, k2, b2, g1, bb1, g2, bb2, B, C, H, W, s);
  return launch<1>(x, out, k1, b1, k2, b2, g1, bb1, g2, bb2, B, C, H, W, s);
}

// Launch the tensor-core kernel on `stream` with the tile plan the caller
// chose (ops/cuda_resblock.py::plan_block_tiles): `rows` x `cols` output
// pixels a CTA, warp items of `mt` m16 tiles (1 to 3), weight chunks of `kc`
// rows.  Pointers as for fused_resblock_launch.  Any C % 8 == 0; returns
// cudaErrorInvalidValue for a plan that does not fit the card's shared
// memory, else the cudaError_t of the launch.
extern "C" int fused_resblock_mma_launch(const float* x, float* out, const float* k1,
                                         const float* b1, const float* k2, const float* b2,
                                         const float* g1, const float* bb1, const float* g2,
                                         const float* bb2, int B, int C, int H, int W, int rows,
                                         int cols, int mt, int kc, void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || C % 8 != 0 || H <= 0 || W <= 0 || rows <= 0 ||
      rows > H || cols <= 0 || cols > W || kc <= 0 || kc % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mt) {
    case 1: return launch_mma<1>(x, out, k1, b1, k2, b2, g1, bb1, g2, bb2, B, C, H, W, rows, cols, kc, s);
    case 2: return launch_mma<2>(x, out, k1, b1, k2, b2, g1, bb1, g2, bb2, B, C, H, W, rows, cols, kc, s);
    case 3: return launch_mma<3>(x, out, k1, b1, k2, b2, g1, bb1, g2, bb2, B, C, H, W, rows, cols, kc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
