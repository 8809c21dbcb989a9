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
// What bounds it: one sample of a block is ~130 MFLOP at every stage of the
// full-width model (C = 32 at 64x76, 64 at 32x38, 128 at 16x19: C^2 H W is
// the same), with 0.6 MB of activations in and out.  At any batch it is
// FMA-bound, if the loads are hidden.
//
// Design: one CTA computes a tile of kRows = 4 output rows by `cols` columns
// of one sample, all C output channels.  Shared memory holds the activated
// input tile it needs (kRows + 5 rows, cols + 2 columns) and the activated
// middle tile (kRows + 3 rows): the middle tensor never reaches device
// memory, at the cost of computing 3 middle rows twice per 4 (conv3x3 work
// x1.75).  `cols` is the whole row W when the tile fits the card's shared
// memory (158-165 KB of tiles plus 9-37 KB of weight chunks at the
// full-width model's three stages); for a wider C x W the row is cut into
// equal column tiles.  In both convolutions a warp
// owns 32 x P pixels (lane-strided, so the shared-memory reads are
// conflict-free) and Q output channels, Q the largest of 16, 8, 4, 2, 1 that
// divides C; per input channel and tap a thread reads P activations and Q
// weights (broadcast float4 loads when Q is a multiple of 4), then does P x Q
// FMAs.  The conv3x3 weights (576 KB at C = 128) stream through shared
// memory in chunks of kCi input channels, double-buffered with cp.async; the
// conv(4,1) weights are read through L1.  P = 5 for conv3x3 and 3 for
// conv(4,1) give exactly one item to each of the 8 warps at the three
// full-width stages.  C is a template constant at those stages' widths (32,
// 64, 128: the constant index arithmetic is 3-5 % faster at B = 200) and a
// run-time argument at any other.  IEEE fp32 FMAs on the CUDA cores; tensor
// cores, TMA and wgmma are later work.  The TPU kernel's pixel packing, lane
// rolls and block-diagonal weights were for 128-lane registers and are not
// copied.

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

template <int Q, int kC>
__global__ void __launch_bounds__(kThreads)
fused_resblock_kernel(const float* __restrict__ x, float* __restrict__ out,
                      const float* __restrict__ k1, const float* __restrict__ b1,
                      const float* __restrict__ k2, const float* __restrict__ b2,
                      const float* __restrict__ g1, const float* __restrict__ bb1,
                      const float* __restrict__ g2, const float* __restrict__ bb2,
                      int c_arg, int H, int W, int cols) {
  const int C = kC ? kC : c_arg;             // kC = 0: C known at run time only
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

template <int Q, int kC = 0>
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
  err = cudaFuncSetAttribute(fused_resblock_kernel<Q, kC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((H + kRows - 1) / kRows) * col_tiles, B);
  fused_resblock_kernel<Q, kC><<<grid, kThreads, smem, stream>>>(x, out, k1, b1, k2, b2, g1, bb1,
                                                             g2, bb2, C, H, W, cols);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; every pointer is a contiguous float32 array on the
// card, the weights 16-byte aligned.  Any C whose smallest tile (4 rows x 1
// column) fits the card's shared memory: C <= 548 on Hopper.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int fused_resblock_launch(const float* x, float* out, const float* k1,
                                     const float* b1, const float* k2, const float* b2,
                                     const float* g1, const float* bb1, const float* g2,
                                     const float* bb2, int B, int C, int H, int W,
                                     void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 32) return launch<16, 32>(x, out, k1, b1, k2, b2, g1, bb1, g2, bb2, B, C, H, W, s);
  if (C == 64) return launch<16, 64>(x, out, k1, b1, k2, b2, g1, bb1, g2, bb2, B, C, H, W, s);
  if (C == 128) return launch<16, 128>(x, out, k1, b1, k2, b2, g1, bb1, g2, bb2, B, C, H, W, s);
  if (C % 16 == 0) return launch<16>(x, out, k1, b1, k2, b2, g1, bb1, g2, bb2, B, C, H, W, s);
  if (C % 8 == 0) return launch<8>(x, out, k1, b1, k2, b2, g1, bb1, g2, bb2, B, C, H, W, s);
  if (C % 4 == 0) return launch<4>(x, out, k1, b1, k2, b2, g1, bb1, g2, bb2, B, C, H, W, s);
  if (C % 2 == 0) return launch<2>(x, out, k1, b1, k2, b2, g1, bb1, g2, bb2, B, C, H, W, s);
  return launch<1>(x, out, k1, b1, k2, b2, g1, bb1, g2, bb2, B, C, H, W, s);
}
