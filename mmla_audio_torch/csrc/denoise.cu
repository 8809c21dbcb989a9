// The stationary denoise's products on the card: two kernels that make the
// denoise of a window the same bits whether it runs alone or in a batch.
//
// Neither replaces a Pallas kernel.  The JAX package's denoise
// (mmla_audio_tpu/ops/denoise.py: _stft_ri, _istft, and the two smoothing
// products in reduce_noise) is XLA GEMMs; the port ran them through
// torch.matmul, and cuBLAS picks its algorithm, and with it the order in
// which a dot product is summed, by the GEMM's shape.  A batch folds into
// the GEMM's M, so a window's spectrum differed in its last bits between a
// batch and the window alone, and the int16 re-quantization turned a few of
// those into a step of one.
//
// D1, fixed_order_gemm_kernel: C (M, N) = A (M, K) @ B (K, N) in IEEE fp32
// FFMA on the CUDA cores (no TF32, whatever the caller's precision policy).
// Every output element is accumulated by one thread, over k = 0 .. K-1 in
// ascending order, one fmaf a term, starting from +0; the tile shape is a
// constant, there is no split-K and one instance serves every M.  So an
// output depends only on its A row, its B column and K: never on M, on the
// row's place in the batch or on the grid.  The K tail is zero-filled in
// shared memory (fmaf(0, 0, s) == s).  Row m of A is read at
//   A + (m / rows_per_group) * group_stride + (m % rows_per_group) * row_stride
// so the STFT reads its frames straight from the reflect-padded signal
// (rows_per_group = frames a window, group_stride = the padded length,
// row_stride = hop): the (M, n_fft) frame matrix is never built.
//
// Bound: at n_fft 1024 the STFT is 2 * M * 1024 * 1026 FLOP against
// 4 * (1024 + 1026) bytes a row (a live window's 183 frames: 385 MFLOP
// against 1.5 MB), so operations bound it, far above the card's ridge.  The
// design is the classic register-blocked SGEMM: a 128 x 128 output tile per
// 256-thread block, 8 x 8 outputs a thread, K in steps of 8 through two
// shared-memory buffers with the next step's loads held in registers.  A
// per-frame real FFT would do about 80x less work; that is the next design.
//
// D2, smooth_mask_kernel: the gate mask smoothed by the outer triangular
// kernel as two banded passes, frequency (taps vf, zero-padded "same") and
// then time (taps vt, zero-padded "same" within the window), each summed
// over ascending taps.  It replaces the dense (K, K) and (T, T) matrices
// (8.1 GB for the time matrix of a 12-minute recording).  A block takes
// tile_t frames of one window and all K bins: it stages the tile's frames
// and nt - 1 halo frames in shared memory, runs the frequency pass over all
// of them into a second buffer, then the time pass.  Bound: bytes (the mask
// read and written once, 8 bytes a bin); memory does not grow with T.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;     // output rows a block
constexpr int kBN = 128;     // output columns a block
constexpr int kBK = 8;       // K a step
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fixed_order_gemm_kernel(const float* __restrict__ A, long long rows_per_group,
                        long long group_stride, long long row_stride, int M,
                        int K, const float* __restrict__ B, int N,
                        float* __restrict__ C) {
  __shared__ __align__(16) float As[2][kBK][kBM];
  __shared__ __align__(16) float Bs[2][kBK][kBN];
  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // loads: A as 128 rows x 8 k (4 consecutive k a thread), B as 8 k x 128
  // columns (4 consecutive columns a thread)
  const int a_row = tid >> 1, a_k = (tid & 1) * 4;
  const long long am = m0 + a_row;
  const bool a_ok = am < M;
  const float* a_src = A;
  if (a_ok)
    a_src += (am / rows_per_group) * group_stride +
             (am % rows_per_group) * row_stride;
  const int b_k = tid >> 5, b_n = (tid & 31) * 4;
  float ra[4], rb[4];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + a_k + i;
      ra[i] = (a_ok && k < K) ? a_src[k] : 0.f;
    }
    const int k = k0 + b_k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + b_n + j;
      rb[j] = (k < K && n < N) ? B[static_cast<long long>(k) * N + n] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[buf][a_k + i][a_row] = ra[i];
    *reinterpret_cast<float4*>(&Bs[buf][b_k][b_n]) =
        make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  // outputs: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns likewise
  const int ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int steps = (K + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps) load((s + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read in step s - 1, before its barrier
    if (s + 1 < steps) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
    float* row = C + m * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N) row[n] = acc[i][j];
    }
  }
}

constexpr int kSmoothThreads = 256;

__global__ void __launch_bounds__(kSmoothThreads)
smooth_mask_kernel(const float* __restrict__ mask, float* __restrict__ out,
                   int T, int K, const float* __restrict__ vf, int nf,
                   const float* __restrict__ vt, int nt, int tile_t) {
  extern __shared__ float smem[];
  const int ct = nt / 2, cf = nf / 2;
  const int rows = tile_t + 2 * ct;
  float* in = smem;                 // rows x K: frames t0 - ct .. t0 + tile_t + ct - 1
  float* fr = smem + rows * K;      // the same frames after the frequency pass
  const long long base = static_cast<long long>(blockIdx.y) * T * K;
  const int t0 = blockIdx.x * tile_t;

  for (int idx = threadIdx.x; idx < rows * K; idx += blockDim.x) {
    const int r = idx / K, j = idx - r * K;
    const int t = t0 - ct + r;
    in[idx] = (t >= 0 && t < T) ? mask[base + static_cast<long long>(t) * K + j]
                                : 0.f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * K; idx += blockDim.x) {
    const int r = idx / K, j = idx - r * K;
    const float* x = in + r * K;
    float s = 0.f;
    for (int d = 0; d < nf; ++d) {
      const int i = j + cf - d;
      if (i >= 0 && i < K) s = fmaf(vf[d], x[i], s);
    }
    fr[idx] = s;
  }
  __syncthreads();
  const int n_out = min(tile_t, T - t0);
  for (int idx = threadIdx.x; idx < n_out * K; idx += blockDim.x) {
    const int r = idx / K, j = idx - r * K;
    // frame t0 + r + ct - d sits at row r + 2 * ct - d of the buffer
    float s = 0.f;
    for (int d = 0; d < nt; ++d) s = fmaf(vt[d], fr[(r + 2 * ct - d) * K + j], s);
    out[base + static_cast<long long>(t0 + r) * K + j] = s;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int fixed_order_gemm_launch(const float* A, long long rows_per_group,
                            long long group_stride, long long row_stride,
                            int M, int K, const float* B, int N, float* C,
                            cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || rows_per_group <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  fixed_order_gemm_kernel<<<grid, kThreads, 0, stream>>>(
      A, rows_per_group, group_stride, row_stride, M, K, B, N, C);
  return static_cast<int>(cudaGetLastError());
}

// mask and out: (groups, T, K) contiguous; vf (nf,), vt (nt,) odd lengths.
int smooth_mask_launch(const float* mask, float* out, int groups, int T,
                       int K, const float* vf, int nf, const float* vt,
                       int nt, int tile_t, cudaStream_t stream) {
  if (groups <= 0 || T <= 0 || K <= 0 || tile_t <= 0 || nf % 2 == 0 ||
      nt % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      2 * static_cast<size_t>(tile_t + nt - 1) * K * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      smooth_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + tile_t - 1) / tile_t, groups);
  smooth_mask_kernel<<<grid, kSmoothThreads, smem, stream>>>(
      mask, out, T, K, vf, nf, vt, nt, tile_t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
