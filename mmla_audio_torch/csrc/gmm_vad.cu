// G1: the GMM VAD of whole windows (vad/gmm.py), from a window's samples
// to its decisions and final state row in one launch.
//
// Replaces the device code of mmla_audio_tpu/vad/gmm.py::gmm_vad
// (gmm.py:217-266): band_log_energies (a cascade of 64-tap causal FIRs,
// gmm.py:139-174), the frame energies, and the adaptation scan (a lax.scan
// over the window's frames, gmm.py:233-265).  The JAX package has no Pallas
// kernel here (XLA compiled all three); in plain torch ops the filterbank
// is ~110 launches a window and the scan ~100 a frame.
//
// Input of a stream: its samples (n,), int16 scale, and its state row of 54
// floats (noise_mean, noise_std, speech_mean, speech_std as (6, 2)
// row-major, then min_track (6,)).  Output: the decisions (T,) as 0/1
// bytes, T = n // frame_len, the final state row, and optionally the band
// log energies (T, 6) and frame energies (T,).  A second entry
// (gmm_vad_launch) takes the energies instead of the samples and runs the
// scan alone.
//
// The filterbank.  Six half-band splits (each two 64-tap FIRs on the even
// and odd samples, high = up - lo, low = up + lo, decimated by 2) and the
// 80 Hz FIR, every signal in shared memory, none in global memory:
//   x (16 kHz) -> x8 -> hp24, lp02 -> (b23, b34), (b12, lp01) ->
//   (b051, lp005) -> (b0205, lp0025) -> b008 = hp80(lp0025).
// The window is cut into chunks of frames.  A plan (vad/gmm.py::g1_plan,
// one row a chunk, the same for every stream) gives each signal's index
// range for the chunk: keep (the first index held), clo (the first index
// computed), hi (one past the last).  A chunk that continues a CTA's span
// carries [keep, clo) of every signal over from the last chunk (the
// 63-sample history of each FIR, or a band frame's start); the first chunk
// of a span computes that halo instead (zeros below index 0, as the plain
// version's left padding).  Each output is one thread's fmaf chain over its
// 64 taps in ascending order, whatever the chunk, span or thread, so every
// signal's bits and every energy's are the same in any layout: a row's
// results do not depend on the batch.  A thread computes R consecutive
// outputs from a sliding window of its parent in registers (one 8-byte
// shared load feeds 2R FMAs; R odd, so a half-warp's loads hit 16
// distinct bank pairs); the taps lie in constant memory (constant-bank
// operands of the FFMAs).
//
// Energies: each band frame's mean of squares (an fmaf chain), its
// 10 log10(max(., 1e-10)), and each frame's energy (a warp's strided fmaf
// chains summed by a fixed shuffle tree), into shared memory (E, 8 floats a
// frame).
//
// Layout by batch.  One CTA a stream (cluster = 1): warp 0 runs the scan,
// warps 1-8 the filterbank; the filter warps hand each chunk's energies to
// the scan warp through two E slots and named barriers (FULL/EMPTY), so the
// scan of chunk k runs under the filterbank of chunk k + 1.  A cluster of
// K CTAs a stream (small batches): CTA r computes the r-th span of frames
// (halo included) and writes its energies into the lead CTA's E through
// distributed shared memory; after a cluster barrier the lead's warp 0 scans
// the whole window.
//
// The scan.  Lane l holds one mixture component: speech (l < 16) or noise
// (l >= 16), band (l & 15) / 2, component l & 1 (lanes 12-15 and 28-31
// idle), its mean, std, log std and its band's min_track.  Each frame:
//   * log N(e; m, s) + log 0.5 of the lane's component, combined with the
//     partner component's by a shuffle (log-sum-exp, torch's order); the
//     band's log-LR is the speech lane's minus the noise lane's (xor 16);
//   * the weighted log-LR sum: each band's term from lane 2b by shuffles,
//     summed in band order; any band's log-LR above the local threshold (a
//     ballot); the min-energy gate;
//   * off the dependent path, both successor states: "speech" (the speech
//     lanes adapted at rate 0.05, the noise lanes at rate 0) and "silence"
//     (the reverse), each with its clamps (noise means to min_track + 6,
//     speech means 4 dB above the larger noise mean) and its log std, in
//     the same basic block as the decision and without a branch, so the
//     compiler interleaves the two paths; the decision then only selects
//     one.  The frame has one IEEE division, (e - m) / s: the update's
//     |e - m| / s is its absolute value, bit for bit, as s > 0.
// Every update operation is an explicit round-to-nearest intrinsic
// (__fadd_rn, __fmul_rn, __fdiv_rn), which nvcc never contracts into an FMA,
// in the order of the plain loop's torch operations, so given the same
// energies and decisions the state is the plain loop's bit for bit.  logf,
// expf and log10f are the precise library functions (no --use_fast_math);
// they may round differently from the CPU's, which moves a decision only at
// a threshold margin of a few ulps.
//
// Bound: 11.7 MFLOP of FIR a 40,960-sample window (its splits over 89,600
// input samples at 128 FLOP each, and the 80 Hz FIR) on the CUDA cores,
// 164 KB of samples read once; the scan's serial chain of T frames, each
// one frame's dependent latency (a division, three log/exp, the shuffles,
// the select); chip_smoke.py's g1_bound and g1_chain_ms derive both from
// this source.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBands = 6;
constexpr int kSlots = 54;
constexpr int kLanes = 2 * kBands;              // a mixture's lanes
constexpr int kTaps = 64;
constexpr int kFilterWarps = 8;
constexpr int kFilterThreads = 32 * kFilterWarps;
constexpr int kThreads = 32 + kFilterThreads;   // warp 0 scans
constexpr int kBuffers = 13;
constexpr int kGroups = 8;
constexpr int kRowInts = 32;    // a plan row: f0, f1, start, keep, clo, hi
constexpr int kEStride = 8;     // E: 6 bands, the frame energy, a pad
constexpr int kMaxCluster = 8;
constexpr int kRowWarps = 4;    // the energies-in entry: streams a block
constexpr int kRowFrames = 128; // frames staged in shared memory at once
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLogSqrt2Pi = 0.9189385f;
constexpr float kLogHalf = -0.69314718055994530942f;
constexpr float kMinEnergyDb = 10.0f;
// named barriers: 0 is __syncthreads
constexpr int kBarFilter = 1, kBarFull = 2, kBarEmpty = 4;

// buffers: x, x8, hp24, lp02, b23, b34, b12, lp01, b051, lp005, b0205,
// lp0025, b008; groups (a plan range each): x, x8, S2 (hp24, lp02), S3a
// (b23, b34), S3b (b12, lp01), S4 (b051, lp005), S5 (b0205, lp0025), S6
// (b008)
enum Buf { kX, kX8, kHp24, kLp02, kB23, kB34, kB12, kLp01, kB051, kLp005,
           kB0205, kLp0025, kB008 };

// the spectrum weights 6 ... 16 over their sum, rounded once to fp32 (as
// numpy's float64 quotient cast to float32)
__constant__ float kWeight[kBands] = {
    float(6.0 / 66.0), float(8.0 / 66.0), float(10.0 / 66.0),
    float(12.0 / 66.0), float(14.0 / 66.0), float(16.0 / 66.0)};

// the FIR taps reversed (the correlation form of vad/gmm.py::_corr), set
// once a device by the launcher: each FFMA reads its tap as a constant-bank
// operand
struct Taps {
  float up[kTaps];      // the upper allpass, a = 0.64
  float lo[kTaps];      // the lower allpass, a = 0.17
  float hp[kTaps];      // the 80 Hz high-pass
};
__constant__ Taps c_taps;

// shared-memory layout and the plan's partition over a cluster
struct Layout {
  int buf[kBuffers];    // float offset of each buffer
  int e_off;            // float offset of E
  int cluster;          // CTAs a stream
  int slot_frames;      // one CTA a stream: frames an E slot
  int rank_rows[kMaxCluster + 1];   // plan rows of each rank
};

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// R consecutive outputs [i0, i0 + R) of a half-band split of parent P (P
// points at parent index pk): up = upper FIR of the even samples, lo =
// lower FIR of the odd samples, each an fmaf chain over its taps in
// ascending order; high = up - lo to H (if any), low = up + lo to L (both
// pointing at output index ok)
template <int R>
__device__ __forceinline__ void split_item(const float* P, int pk, float* H,
                                           float* L, int ok, int i0) {
  const float2* p2 =
      reinterpret_cast<const float2*>(P + (2 * (i0 - (kTaps - 1)) - pk));
  float up[R], lo[R];
#pragma unroll
  for (int r = 0; r < R; ++r) up[r] = lo[r] = 0.0f;
#pragma unroll
  for (int u = 0; u < kTaps - 1 + R; ++u) {
    const float2 v = p2[u];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = u - r;
      if (k >= 0 && k < kTaps) {
        up[r] = fmaf(c_taps.up[k], v.x, up[r]);
        lo[r] = fmaf(c_taps.lo[k], v.y, lo[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (H != nullptr) H[i0 - ok + r] = __fsub_rn(up[r], lo[r]);
    L[i0 - ok + r] = __fadd_rn(up[r], lo[r]);
  }
}

// R consecutive outputs of the 80 Hz FIR of parent P into O
template <int R>
__device__ __forceinline__ void hp80_item(const float* P, int pk, float* O,
                                          int ok, int i0) {
  const float* p = P + (i0 - (kTaps - 1) - pk);
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll
  for (int u = 0; u < kTaps - 1 + R; ++u) {
    const float v = p[u];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = u - r;
      if (k >= 0 && k < kTaps) acc[r] = fmaf(c_taps.hp[k], v, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) O[i0 - ok + r] = acc[r];
}

// a mean of squares in dB, as frame_energy: 10 log10(max(sum / m, 1e-10))
__device__ __forceinline__ float to_db(float sum, int m) {
  return __fmul_rn(10.0f, log10f(fmaxf(__fdiv_rn(sum, float(m)), 1e-10f)));
}

// one chunk's range of a group, from its plan row
struct Range {
  int keep, clo, hi;
};

__device__ __forceinline__ Range range_of(const int* row, int g) {
  return {__ldg(row + 3 + g), __ldg(row + 3 + kGroups + g),
          __ldg(row + 3 + 2 * kGroups + g)};
}

// the plan group of buffer b
__host__ __device__ constexpr int group_of(int b) {
  return b < 2 ? b : (b >> 1) + 1;
}

// The scan of `count` frames whose energies lie in E (kEStride floats a
// frame), decisions to dec[0, count).  This lane's mixture component in m, s
// (its log std in logs) and its band's min_track in mt, updated in place.
__device__ void scan_frames(const float* E, int count, uint8_t* dec,
                            float g_thr, float l_thr, bool adapt, float& m,
                            float& s, float& logs, float& mt) {
  const int lane = threadIdx.x & 31;
  const int j = lane & 15;
  const bool active = j < kLanes;
  const bool noise = lane >= 16;
  const int band = active ? j >> 1 : 0;
  const int comp = j & 1;
  const float w = kWeight[band];
  if (count <= 0) return;
  float e_next = E[band], tot_next = E[kBands];
  bool mine = false;      // lane l: the decision of frame 32 q + l
  for (int t = 0; t < count; ++t) {
    const float e = e_next;
    const float tot = tot_next;
    if (t + 1 < count) {
      e_next = E[(t + 1) * kEStride + band];
      tot_next = E[(t + 1) * kEStride + kBands];
    }
    // the frame's one division: z = (e - m) / s; the update's |e - m| / s
    // is |z| bit for bit (round-to-nearest is symmetric, s > 0)
    const float d = __fsub_rn(e, m);
    const float z = __fdiv_rn(d, s);
    // both successors first, off the decision's path: the winner (argmin
    // |z|, the first on a tie) moves toward e at rate 0.05 (adapted) or 0
    // (kept), every std clipped; "speech": speech lanes adapted, noise lanes
    // kept; "silence": the reverse; noise means clamped to min_track + 6,
    // speech means kept 4 dB above the larger noise mean
    const float mt_new =
        fminf(__fadd_rn(__fmul_rn(mt, 0.998f), __fmul_rn(0.002f, e)), e);
    const float zz = fabsf(z);
    const float zo = __shfl_xor_sync(kFull, zz, 1);
    const bool win = comp == 0 ? !(zo < zz) : (zz < zo);
    const float ma_w = __fadd_rn(m, __fmul_rn(0.05f, d));
    const float sa_w = __fadd_rn(
        s, __fmul_rn(0.05f, __fsub_rn(fabsf(__fsub_rn(e, ma_w)), s)));
    const float mk_w = __fadd_rn(m, __fmul_rn(0.0f, d));
    const float sk_w = __fadd_rn(
        s, __fmul_rn(0.0f, __fsub_rn(fabsf(__fsub_rn(e, mk_w)), s)));
    const float ma = win ? ma_w : m, mk = win ? mk_w : m;
    const float sa = fminf(fmaxf(win ? sa_w : s, 1.0f), 12.0f);
    const float sk = fminf(fmaxf(win ? sk_w : s, 1.0f), 12.0f);
    const float ceil_n = __fadd_rn(mt_new, 6.0f);
    float m_sp = noise ? fminf(mk, ceil_n) : ma;
    float m_si = noise ? fminf(ma, ceil_n) : mk;
    const float s_sp = noise ? sk : sa, s_si = noise ? sa : sk;
    float nx_sp = fmaxf(m_sp, __shfl_xor_sync(kFull, m_sp, 1));
    float nx_si = fmaxf(m_si, __shfl_xor_sync(kFull, m_si, 1));
    nx_sp = __shfl_xor_sync(kFull, nx_sp, 16);   // the noise lanes' maxima
    nx_si = __shfl_xor_sync(kFull, nx_si, 16);
    m_sp = noise ? m_sp : fmaxf(m_sp, __fadd_rn(nx_sp, 4.0f));
    m_si = noise ? m_si : fmaxf(m_si, __fadd_rn(nx_si, 4.0f));
    const float ls_sp = logf(s_sp), ls_si = logf(s_si);
    // the decision: log(0.5 N(e; m0, s0) + 0.5 N(e; m1, s1)) of this
    // lane's mixture
    float c = __fsub_rn(__fsub_rn(__fmul_rn(__fmul_rn(-0.5f, z), z), logs),
                        kLogSqrt2Pi);
    c = __fadd_rn(c, kLogHalf);
    const float other = __shfl_xor_sync(kFull, c, 1);
    const float a = comp == 0 ? c : other;
    const float b = comp == 0 ? other : c;
    const float mx = fmaxf(a, b);
    const float lm = __fadd_rn(
        logf(__fadd_rn(expf(__fsub_rn(a, mx)), expf(__fsub_rn(b, mx)))), mx);
    const float lm_x = __shfl_xor_sync(kFull, lm, 16);
    const float llr = noise ? __fsub_rn(lm_x, lm) : __fsub_rn(lm, lm_x);
    const float term = __fmul_rn(w, llr);
    float weighted = __shfl_sync(kFull, term, 0);
#pragma unroll
    for (int q = 1; q < kBands; ++q)
      weighted = __fadd_rn(weighted, __shfl_sync(kFull, term, 2 * q));
    const bool local = __ballot_sync(kFull, active && llr > l_thr) != 0u;
    const bool speech = (weighted > g_thr || local) && tot > kMinEnergyDb;
    // the decision selects the successor (none without adaptation)
    if (adapt) {
      m = speech ? m_sp : m_si;
      s = speech ? s_sp : s_si;
      logs = speech ? ls_sp : ls_si;
      mt = mt_new;
    }
    // decisions leave 32 frames at a time, a byte a lane
    mine = lane == (t & 31) ? speech : mine;
    if ((t & 31) == 31 || t + 1 == count) {
      if (lane <= (t & 31)) dec[(t & ~31) + lane] = mine ? 1 : 0;
    }
  }
}

// this lane's slots of a state row: (mean, std) of its mixture component
__device__ __forceinline__ void lane_slots(int lane, int& mi, int& si) {
  const int j = lane & 15;
  mi = (lane >= 16 ? 0 : 2 * kLanes) + j;
  si = mi + kLanes;
}

__device__ __forceinline__ void load_state(const float* st, float& m,
                                           float& s, float& logs, float& mt) {
  const int lane = threadIdx.x & 31;
  m = 0.0f;   // idle lanes carry a harmless mixture (mean 0, std 1)
  s = 1.0f;
  mt = 0.0f;
  if ((lane & 15) < kLanes) {
    int mi, si;
    lane_slots(lane, mi, si);
    m = st[mi];
    s = st[si];
    mt = st[4 * kLanes + ((lane & 15) >> 1)];
  }
  logs = logf(s);
}

__device__ __forceinline__ void store_state(float* out, float m, float s,
                                            float mt) {
  const int lane = threadIdx.x & 31;
  if ((lane & 15) < kLanes) {
    int mi, si;
    lane_slots(lane, mi, si);
    out[mi] = m;
    out[si] = s;
    if (lane < 16 && (lane & 1) == 0) out[4 * kLanes + (lane >> 1)] = mt;
  }
}

// flags
constexpr int kAdapt = 1, kScan = 2;

__global__ void __launch_bounds__(kThreads)
g1_kernel(const float* __restrict__ x, long long n, int T, int fl,
          const int* __restrict__ plan, const __grid_constant__ Layout lay,
          const float* __restrict__ states_in, float g_thr, float l_thr,
          int flags, uint8_t* __restrict__ decisions,
          float* __restrict__ states_out, float* __restrict__ bands_out,
          float* __restrict__ tot_out) {
  extern __shared__ __align__(16) float smem[];
  const int K = lay.cluster;
  const int rank = K > 1 ? static_cast<int>(blockIdx.x) % K : 0;
  const int row = blockIdx.x / K;
  const bool scan = (flags & kScan) != 0;
  const int warp = threadIdx.x >> 5;
  float* E = smem + lay.e_off;
  const int r0 = lay.rank_rows[rank], r1 = lay.rank_rows[rank + 1];
  if (K > 1) cg::this_cluster().sync();   // every CTA's shared memory live

  if (warp == 0) {
    // the scan warp
    if (K > 1) cg::this_cluster().sync(); // every span's energies in E
    if (!scan || rank != 0) return;
    float m, s, logs, mt;
    load_state(states_in + static_cast<size_t>(row) * kSlots, m, s, logs,
               mt);
    uint8_t* d_row = decisions + static_cast<size_t>(row) * T;
    const bool adapt = (flags & kAdapt) != 0;
    if (K == 1) {
      for (int c = r0; c < r1; ++c) {
        const int k = c - r0;
        const int f0 = __ldg(plan + c * kRowInts);
        const int f1 = __ldg(plan + c * kRowInts + 1);
        bar_sync(kBarFull + (k & 1), kThreads);
        scan_frames(E + (k & 1) * lay.slot_frames * kEStride, f1 - f0,
                    d_row + f0, g_thr, l_thr, adapt, m, s, logs, mt);
        if (c + 2 < r1) bar_arrive(kBarEmpty + (k & 1), kThreads);
      }
    } else {
      scan_frames(E, T, d_row, g_thr, l_thr, adapt, m, s, logs, mt);
    }
    store_state(states_out + static_cast<size_t>(row) * kSlots, m, s, mt);
    return;
  }

  // the filter warps
  const int tid = threadIdx.x - 32;
  const int fwarp = warp - 1;
  const int flane = threadIdx.x & 31;
  const float* x_row = x + static_cast<size_t>(row) * n;
  float* buf[kBuffers];
#pragma unroll
  for (int b = 0; b < kBuffers; ++b) buf[b] = smem + lay.buf[b];
  float* E_dst = E;
  if (K > 1) E_dst = cg::this_cluster().map_shared_rank(E, 0);
  const int m8 = fl / 8, m16 = fl / 16, m32 = fl / 32;
  int prev_keep[kGroups];
  for (int c = r0; c < r1; ++c) {
    const int k = c - r0;
    const int* rp = plan + c * kRowInts;
    const int f0 = __ldg(rp), f1 = __ldg(rp + 1);
    const bool start = __ldg(rp + 2) != 0;
    const int nf = f1 - f0;
    Range rg[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) rg[g] = range_of(rp, g);
    // carry [keep, clo) of every buffer to its front, or at a span's start
    // zero [keep, 0) (the plain version's left padding)
#pragma unroll
    for (int b = 0; b < kBuffers; ++b) {
      const Range r = rg[group_of(b)];
      if (start) {
        for (int i = tid; i < -r.keep; i += kFilterThreads) buf[b][i] = 0.0f;
      } else {
        const int shift = r.keep - prev_keep[group_of(b)];
        if (shift > 0)
          for (int i = tid; i < r.clo - r.keep; i += kFilterThreads)
            buf[b][i] = buf[b][i + shift];
      }
    }
#pragma unroll
    for (int g = 0; g < kGroups; ++g) prev_keep[g] = rg[g].keep;
    bar_sync(kBarFilter, kFilterThreads);
    // the chunk's new samples
    {
      const Range r = rg[0];
      for (int i = r.clo + tid; i < r.hi; i += kFilterThreads)
        buf[kX][i - r.keep] = __ldg(x_row + i);
    }
    // the scan has consumed this E slot's last chunk
    if (K == 1 && scan && k >= 2)
      bar_sync(kBarEmpty + (k & 1), kThreads);
    else
      bar_sync(kBarFilter, kFilterThreads);
    float* e_chunk = K == 1 ? E_dst + (k & 1) * lay.slot_frames * kEStride
                            : E_dst + f0 * kEStride;
    // S1: x -> x8 (the 8-16 kHz half dropped); the frame energies
    {
      const Range p = rg[0], r = rg[1];
      const int items = (r.hi - r.clo + 6) / 7;
      for (int it = tid; it < items; it += kFilterThreads)
        split_item<7>(buf[kX], p.keep, nullptr, buf[kX8], r.keep,
                      r.clo + 7 * it);
      for (int f = fwarp; f < nf; f += kFilterWarps) {
        const float* xs = buf[kX] + ((f0 + f) * fl - p.keep);
        float acc = 0.0f;
        for (int i = flane; i < fl; i += 32) acc = fmaf(xs[i], xs[i], acc);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, o));
        if (flane == 0) {
          const float db = to_db(acc, fl);
          e_chunk[f * kEStride + kBands] = db;
          if (tot_out != nullptr)
            tot_out[static_cast<size_t>(row) * T + f0 + f] = db;
        }
      }
    }
    bar_sync(kBarFilter, kFilterThreads);
    // S2: x8 -> hp24, lp02
    {
      const Range p = rg[1], r = rg[2];
      const int items = (r.hi - r.clo + 6) / 7;
      for (int it = tid; it < items; it += kFilterThreads)
        split_item<7>(buf[kX8], p.keep, buf[kHp24], buf[kLp02], r.keep,
                      r.clo + 7 * it);
    }
    bar_sync(kBarFilter, kFilterThreads);
    // S3a: hp24 -> b23, b34 (hp24 is spectrally inverted); S3b: lp02 ->
    // b12, lp01
    {
      const Range p = rg[2], ra = rg[3], rb = rg[4];
      const int ia = (ra.hi - ra.clo + 6) / 7;
      const int items = ia + (rb.hi - rb.clo + 6) / 7;
      for (int it = tid; it < items; it += kFilterThreads) {
        if (it < ia)
          split_item<7>(buf[kHp24], p.keep, buf[kB23], buf[kB34], ra.keep,
                        ra.clo + 7 * it);
        else
          split_item<7>(buf[kLp02], p.keep, buf[kB12], buf[kLp01], rb.keep,
                        rb.clo + 7 * (it - ia));
      }
    }
    bar_sync(kBarFilter, kFilterThreads);
    // S4: lp01 -> b051, lp005
    {
      const Range p = rg[4], r = rg[5];
      const int items = (r.hi - r.clo + 2) / 3;
      for (int it = tid; it < items; it += kFilterThreads)
        split_item<3>(buf[kLp01], p.keep, buf[kB051], buf[kLp005], r.keep,
                      r.clo + 3 * it);
    }
    bar_sync(kBarFilter, kFilterThreads);
    // S5: lp005 -> b0205, lp0025
    {
      const Range p = rg[5], r = rg[6];
      const int items = (r.hi - r.clo + 2) / 3;
      for (int it = tid; it < items; it += kFilterThreads)
        split_item<3>(buf[kLp005], p.keep, buf[kB0205], buf[kLp0025], r.keep,
                      r.clo + 3 * it);
    }
    bar_sync(kBarFilter, kFilterThreads);
    // S6: lp0025 -> b008 (80-250 Hz)
    {
      const Range p = rg[6], r = rg[7];
      const int items = (r.hi - r.clo + 2) / 3;
      for (int it = tid; it < items; it += kFilterThreads)
        hp80_item<3>(buf[kLp0025], p.keep, buf[kB008], r.keep,
                     r.clo + 3 * it);
    }
    bar_sync(kBarFilter, kFilterThreads);
    // the band energies, low band first: b008, b0205 (500 Hz), b051 (1 kHz),
    // b12, b23, b34 (2 kHz)
    for (int it = tid; it < nf * kBands; it += kFilterThreads) {
      const int f = it / kBands, band = it - f * kBands;
      const int b = band == 0   ? kB008
                    : band == 1 ? kB0205
                    : band == 2 ? kB051
                    : band == 3 ? kB12
                    : band == 4 ? kB23
                                : kB34;
      const int m = band < 2 ? m32 : band == 2 ? m16 : m8;
      const int keep = __ldg(rp + 3 + group_of(b));
      const float* sig = smem + lay.buf[b] + ((f0 + f) * m - keep);
      float acc = 0.0f;
      for (int i = 0; i < m; ++i) acc = fmaf(sig[i], sig[i], acc);
      const float db = to_db(acc, m);
      e_chunk[f * kEStride + band] = db;
      if (bands_out != nullptr)
        bands_out[(static_cast<size_t>(row) * T + f0 + f) * kBands + band] =
            db;
    }
    if (K == 1 && scan) bar_arrive(kBarFull + (k & 1), kThreads);
    bar_sync(kBarFilter, kFilterThreads);
  }
  if (K > 1) cg::this_cluster().sync();   // the spans' energies are in E
}

// The scan alone, from energies in global memory: a warp a stream, each
// chunk of kRowFrames frames staged in shared memory first.
__global__ void __launch_bounds__(kRowWarps * 32)
g1_rows_kernel(const float* __restrict__ energies,
               const float* __restrict__ total_db,
               const float* __restrict__ states_in, int B, int T,
               float g_thr, float l_thr, int adapt,
               uint8_t* __restrict__ decisions,
               float* __restrict__ states_out) {
  __shared__ __align__(16) float stage[kRowWarps][kRowFrames * kEStride];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int row = blockIdx.x * kRowWarps + w;
  if (row >= B) return;                           // the whole warp
  float m, s, logs, mt;
  load_state(states_in + static_cast<size_t>(row) * kSlots, m, s, logs, mt);
  const float* e_row = energies + static_cast<size_t>(row) * T * kBands;
  const float* t_row = total_db + static_cast<size_t>(row) * T;
  uint8_t* d_row = decisions + static_cast<size_t>(row) * T;
  float* E = stage[w];
  for (int t0 = 0; t0 < T; t0 += kRowFrames) {
    const int cnt = min(kRowFrames, T - t0);
    for (int i = lane; i < cnt * kBands; i += 32)
      E[(i / kBands) * kEStride + i % kBands] = e_row[t0 * kBands + i];
    for (int i = lane; i < cnt; i += 32)
      E[i * kEStride + kBands] = t_row[t0 + i];
    __syncwarp();
    scan_frames(E, cnt, d_row + t0, g_thr, l_thr, adapt != 0, m, s, logs,
                mt);
    __syncwarp();
  }
  store_state(states_out + static_cast<size_t>(row) * kSlots, m, s, mt);
}

}  // namespace

// B windows of n samples (x (B, n) float32, int16 scale) at frame_len fl, T
// = n // fl frames; the plan's rows (int32, kRowInts a row) and layout
// (layout: the 13 buffer offsets, E's offset, the cluster size, the frames
// an E slot, the cluster's kMaxCluster + 1 rank row bounds; taps: the
// upper, lower and 80 Hz taps reversed, 64 each); states_in (B, 54) ->
// decisions (B, T) uint8 and states_out (B, 54) (flags & 2, the scan; flags
// & 1, adaptation), bands_out (B, T, 6) and tot_out (B, T) where not null.
// Returns the launch's cudaError_t.
extern "C" int gmm_vad_windows_launch(
    const float* x, long long n, int B, int T, int fl, const int* plan,
    const int* layout, const float* taps_host, int smem_bytes,
    const float* states_in, float g_thr, float l_thr, int flags,
    uint8_t* decisions, float* states_out, float* bands_out, float* tot_out,
    cudaStream_t stream) {
  if (B <= 0) return 0;
  Layout lay;
  for (int b = 0; b < kBuffers; ++b) lay.buf[b] = layout[b];
  lay.e_off = layout[kBuffers];
  lay.cluster = layout[kBuffers + 1];
  lay.slot_frames = layout[kBuffers + 2];
  for (int r = 0; r <= kMaxCluster; ++r)
    lay.rank_rows[r] = layout[kBuffers + 3 + r];
  if (lay.cluster < 1 || lay.cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool taps_set[64] = {};
  if (dev < 64 && !taps_set[dev]) {
    Taps taps;
    for (int k = 0; k < kTaps; ++k) {
      taps.up[k] = taps_host[k];
      taps.lo[k] = taps_host[kTaps + k];
      taps.hp[k] = taps_host[2 * kTaps + k];
    }
    err = cudaMemcpyToSymbol(c_taps, &taps, sizeof(Taps));
    if (err != cudaSuccess) return static_cast<int>(err);
    taps_set[dev] = true;
  }
  err = cudaFuncSetAttribute(
      g1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * lay.cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(lay.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = lay.cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, g1_kernel, x, n, T, fl, plan, lay,
                           states_in, g_thr, l_thr, flags, decisions,
                           states_out, bands_out, tot_out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// B streams of T frames: energies (B, T, 6), total_db (B, T), states_in
// (B, 54) float32 -> decisions (B, T) uint8, states_out (B, 54).  Returns
// the launch's cudaError_t.
extern "C" int gmm_vad_launch(const float* energies, const float* total_db,
                              const float* states_in, int B, int T,
                              float g_thr, float l_thr, int adapt,
                              uint8_t* decisions, float* states_out,
                              cudaStream_t stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kRowWarps - 1) / kRowWarps;
  g1_rows_kernel<<<blocks, kRowWarps * 32, 0, stream>>>(
      energies, total_db, states_in, B, T, g_thr, l_thr, adapt, decisions,
      states_out);
  return static_cast<int>(cudaGetLastError());
}
