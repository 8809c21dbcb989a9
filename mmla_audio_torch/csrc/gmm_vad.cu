// G1: the GMM VAD's per-frame adaptation scan (vad/gmm.py), one warp a
// stream.
//
// Replaces the frame loop of mmla_audio_tpu/vad/gmm.py::gmm_vad (a lax.scan
// over a window's 85 frames, gmm.py:233-265), which in plain torch ops is
// about 60 small launches a frame.  It is the port's own kernel: the JAX
// package has no Pallas kernel here (XLA compiled the scan).
//
// Input of a stream: its band log energies (T, 6), its frame energies (T,)
// and its state row of 54 floats (noise_mean, noise_std, speech_mean,
// speech_std as (6, 2) row-major, then min_track (6,)).  Output: the
// decisions (T,) as 0/1 bytes and the final state row.
//
// Layout: lane l < 12 holds band l / 2, component l % 2 of both mixtures in
// registers, and its band's min_track (duplicated in the band's two
// lanes).  Each frame:
//   * log N(e; m, s) + log 0.5 of this lane's component for speech and
//     noise, the two components combined by a shuffle with the partner lane
//     (log-sum-exp: max + log(exp(a - max) + exp(b - max)), torch's order);
//   * the weighted log-LR sum of the six bands: each band's term read from
//     its even lane by shuffles, summed in band order;
//   * any band's log-LR above the local threshold (a ballot), the
//     min-energy gate;
//   * the update: the winning component (argmin |e - m| / s, the first on a
//     tie, partner by shuffle) moves toward e, every std clipped to [1, 12],
//     the noise means clamped to min_track + 6 and the speech means kept 4 dB
//     above the larger noise mean.
// The state is read once and written once; the energies of frame t + 1 are
// loaded while frame t computes.
//
// Precision: every update operation is an explicit round-to-nearest
// intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn), which nvcc never contracts
// into an FMA, in the order of the plain loop's torch operations, so the
// state equals the plain loop's bit for bit given the same decisions.  logf
// and expf are the precise library functions (no --use_fast_math); they may
// round differently from the CPU's, which moves a decision only at a
// threshold margin of a few ulps.  Rows are independent warps: a row's bits
// do not depend on the batch.
//
// Bound: a few KB a stream, far below the serial chain of 85 frames, each
// one frame's dependent latency (a division, three log/exp, the shuffles
// and the update's ~20 dependent operations); chip_smoke.py's
// g1_chain_ms derives it from this source.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBands = 6;
constexpr int kSlots = 54;
constexpr int kLanes = 2 * kBands;
constexpr int kWarps = 4;                       // streams a block
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLogSqrt2Pi = 0.9189385f;
constexpr float kLogHalf = -0.69314718055994530942f;
constexpr float kMinEnergyDb = 10.0f;

// the spectrum weights 6 ... 16 over their sum, rounded once to fp32 (as
// numpy's float64 quotient cast to float32)
__constant__ float kWeight[kBands] = {
    float(6.0 / 66.0), float(8.0 / 66.0), float(10.0 / 66.0),
    float(12.0 / 66.0), float(14.0 / 66.0), float(16.0 / 66.0)};

// log(0.5 N(e; m0, s0) + 0.5 N(e; m1, s1)) of this lane's band; both lanes
// of the band get the same bits
__device__ __forceinline__ float log_mix(float e, float m, float s,
                                         int comp) {
  const float z = __fdiv_rn(__fsub_rn(e, m), s);
  float c = __fsub_rn(__fsub_rn(__fmul_rn(__fmul_rn(-0.5f, z), z), logf(s)),
                      kLogSqrt2Pi);
  c = __fadd_rn(c, kLogHalf);
  const float other = __shfl_xor_sync(kFull, c, 1);
  const float a = comp == 0 ? c : other;
  const float b = comp == 0 ? other : c;
  const float mx = fmaxf(a, b);
  const float sum = __fadd_rn(expf(__fsub_rn(a, mx)), expf(__fsub_rn(b, mx)));
  return __fadd_rn(logf(sum), mx);
}

// one mixture's update at `rate`: the winner moves toward e, every std is
// clipped
__device__ __forceinline__ void update(float e, float rate, int comp,
                                       float& m, float& s) {
  const float z = __fdiv_rn(fabsf(__fsub_rn(e, m)), s);
  const float other = __shfl_xor_sync(kFull, z, 1);
  const bool win = comp == 0 ? !(other < z) : (z < other);
  if (win) {
    m = __fadd_rn(m, __fmul_rn(rate, __fsub_rn(e, m)));
    s = __fadd_rn(s, __fmul_rn(rate, __fsub_rn(fabsf(__fsub_rn(e, m)), s)));
  }
  s = fminf(fmaxf(s, 1.0f), 12.0f);
}

__global__ void __launch_bounds__(kWarps * 32)
gmm_vad_kernel(const float* __restrict__ energies,
               const float* __restrict__ total_db,
               const float* __restrict__ states_in, int B, int T,
               float g_thr, float l_thr, int adapt,
               uint8_t* __restrict__ decisions,
               float* __restrict__ states_out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;                           // the whole warp
  const bool active = lane < kLanes;
  const int band = active ? lane >> 1 : 0;
  const int comp = lane & 1;
  const float w = kWeight[band];
  const float* st = states_in + static_cast<size_t>(row) * kSlots;
  // idle lanes carry a harmless mixture (mean 0, std 1)
  float nm = 0.f, ns = 1.f, sm = 0.f, ss = 1.f, mt = 0.f;
  if (active) {
    nm = st[lane];
    ns = st[kLanes + lane];
    sm = st[2 * kLanes + lane];
    ss = st[3 * kLanes + lane];
    mt = st[4 * kLanes + band];
  }
  const float* e_row = energies + static_cast<size_t>(row) * T * kBands;
  const float* t_row = total_db + static_cast<size_t>(row) * T;
  uint8_t* d_row = decisions + static_cast<size_t>(row) * T;
  float e_next = 0.f, tot_next = 0.f;
  if (T > 0) {
    e_next = active ? e_row[band] : 0.f;
    tot_next = t_row[0];
  }
  for (int t = 0; t < T; ++t) {
    const float e = e_next;
    const float tot = tot_next;
    if (t + 1 < T) {
      e_next = active ? e_row[(t + 1) * kBands + band] : 0.f;
      tot_next = t_row[t + 1];
    }
    const float llr = __fsub_rn(log_mix(e, sm, ss, comp),
                                log_mix(e, nm, ns, comp));
    const float term = __fmul_rn(w, llr);
    float weighted = __shfl_sync(kFull, term, 0);
#pragma unroll
    for (int b = 1; b < kBands; ++b)
      weighted = __fadd_rn(weighted, __shfl_sync(kFull, term, 2 * b));
    const bool local = __ballot_sync(kFull, active && llr > l_thr) != 0u;
    const bool speech = (weighted > g_thr || local) && tot > kMinEnergyDb;
    if (lane == 0) d_row[t] = speech ? 1 : 0;
    if (!adapt) continue;
    mt = fminf(__fadd_rn(__fmul_rn(mt, 0.998f), __fmul_rn(0.002f, e)), e);
    update(e, speech ? 0.0f : 0.05f, comp, nm, ns);
    update(e, speech ? 0.05f : 0.0f, comp, sm, ss);
    nm = fminf(nm, __fadd_rn(mt, 6.0f));
    const float nmax = fmaxf(nm, __shfl_xor_sync(kFull, nm, 1));
    sm = fmaxf(sm, __fadd_rn(nmax, 4.0f));
  }
  if (active) {
    float* out = states_out + static_cast<size_t>(row) * kSlots;
    out[lane] = nm;
    out[kLanes + lane] = ns;
    out[2 * kLanes + lane] = sm;
    out[3 * kLanes + lane] = ss;
    if (comp == 0) out[4 * kLanes + band] = mt;
  }
}

}  // namespace

// B streams of T frames: energies (B, T, 6), total_db (B, T), states_in
// (B, 54) float32 -> decisions (B, T) uint8, states_out (B, 54).  Returns
// the launch's cudaError_t.
extern "C" int gmm_vad_launch(const float* energies, const float* total_db,
                              const float* states_in, int B, int T,
                              float g_thr, float l_thr, int adapt,
                              uint8_t* decisions, float* states_out,
                              cudaStream_t stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kWarps - 1) / kWarps;
  gmm_vad_kernel<<<blocks, kWarps * 32, 0, stream>>>(
      energies, total_db, states_in, B, T, g_thr, l_thr, adapt, decisions,
      states_out);
  return static_cast<int>(cudaGetLastError());
}
