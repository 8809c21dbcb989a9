// The multiplexer's per-stream voice-activity chain on the card: two kernels.
//
// W1, webrtc_vad_kernel, replaces mmla_audio_tpu/vad/webrtc.py:580
// (webrtc_vad_frames: an int32 lax.scan over samples, vmapped over the
// multiplexer's stream batch).  W2, vad_collect_warp_kernel, replaces
// mmla_audio_tpu/vad/collector.py:48 (collect_mask: a lax.scan over frames).
// Neither replaces a Pallas kernel.
//
// W1 is the fixed-point webrtcvad engine of csrc/host/webrtcvad.cpp
// (wv_process -> downsampling -> calc_vad_8khz -> calculate_features ->
// gmm_probability), one block of four warps a stream.  The block loads its
// stream's 265-slot state row (the layout of wv_get_state / wv_set_state,
// the int16 slots truncated as wv_set_state truncates them) into shared
// memory, runs the window's frames and stores the row back, so a row
// written by the host engine and one written here are interchangeable bit
// for bit.  Rows whose index is n_states or more are padding: they read and
// write no state and their decisions are 0.  The caller guarantees that no
// two rows of a launch share a state index.
//
// What bounds W1 is its longest serial dependency chain, not bytes (a row
// reads 81,600 B of samples and reads and writes 1,060 B of state).  The
// engine is 13 sample-serial IIR chains, each truncated to int16 every
// sample: the 2:1 decimator's two all-pass halves (even and odd samples,
// state ds), the two all-pass halves of each of the five band splits
// (upper and lower state), the 80 Hz high-pass; then six sub-band energies
// and the six-channel GMM, serial only across frames.  The filterbank never
// reads the GMM state and the GMM never reads the filterbank's.  So the
// block is a pipeline of four warps, one frame a stage, a tick a frame:
//   warp 0  frame f:      the decimator, one lane a half (frame_len / 2
//                         steps each), or the copy of an 8 kHz frame;
//   warp 1  frame f - 1:  the 2 kHz split (two lanes), then the 3 kHz and
//                         1 kHz splits of its halves (four lanes);
//   warp 2  frame f - 2:  the 500 Hz and 250 Hz splits and the high-pass,
//                         then the six log energies on six lanes and the
//                         total energy over channels 5, 4, 3, 2, 1, 0 in
//                         the engine's order (each step reads the sum so
//                         far);
//   warp 3  frame f - 3:  the GMM, one lane a channel (its probabilities,
//                         its 16-slot minimum table, its means and stds),
//                         the vote over channels by warp shuffles (int32
//                         sums wrap, so their order keeps the bits), the
//                         hangover on lane 0; then it stages frame f + 1's
//                         samples in shared memory.
// Stages hand frames on through shared buffers of two slots (the frame's
// parity), and a barrier ends each tick.  Every chain keeps its state in the
// shared state row and carries it from frame to frame exactly as the
// engine does (the all-pass states truncated to int16 between frames).
// Every s16() truncation and every shift stays where the host engine has
// it.  The floor is the decimator's chain: frame_len / 2 dependent steps a
// frame, 20,400 a 2.55 s window at 30 ms frames, each a handful of
// dependent integer operations; the other stages hide under it.
//
// Signed overflow: the host engine is compiled with -fwrapv and relies on
// two's-complement wraparound (Q-format products, sums of products, left
// shifts of negative values).  Signed overflow is undefined in device code,
// so every operation here that can leave the int32 range is done in uint32
// and converted back (wrap_*), and every int16 store goes through s16(),
// which wraps explicitly.  Right shifts of negative values are arithmetic
// in nvcc as in g++.
//
// W2 is the reference's vad_collector hysteresis (record_on_pc.py:229-295,
// the port's vad/collector.py::collect_mask) over one row of per-frame
// decisions: a ring of ``ring`` frames, NOTTRIGGERED -> TRIGGERED when more
// than ``thresh`` of the ring is voiced (the ring is kept retroactively),
// TRIGGERED -> NOTTRIGGERED when more than ``thresh`` is unvoiced, the ring
// cleared at both.  Bound: a launch.  The bytes are 178 a row at T = 85
// (the decisions and the count in, the keep flags and the count out), and
// the machine is serial in frames, a few dependent integer operations a
// frame.  vad_collect_warp_kernel (a ring of 1 ... 32 frames) runs one
// warp a row, four rows a block: the warp reads 32 decisions at a time,
// coalesced, and turns them into a word with __ballot_sync (frames at or
// past n_valid cleared); every lane then runs the same trigger machine over
// the word, the ring's voiced count one __popcll of the last two words
// masked to the ring, and builds the keep flags as a bitmask, the ring's
// bits set at once at a trigger; a finished word's flags go out one byte a
// lane, coalesced, and the kept count is a sum of __popc.  Rows of any
// length loop over words.  A longer ring takes vad_collect_kernel, one
// thread a row that recounts the ring from the decisions.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNumChannels = 6;
constexpr int kTableSize = 12;
constexpr int kStateSlots = 265;

// vad_core.c tables (indexed at run time: constant memory).
__constant__ int16_t kSpectrumWeight[kNumChannels] = {6, 8, 10, 12, 14, 16};
__constant__ int16_t kMinimumDifference[kNumChannels] = {
    544, 544, 576, 576, 576, 576};
__constant__ int16_t kMaximumSpeech[kNumChannels] = {
    11392, 11392, 11520, 11520, 11520, 11520};
__constant__ int16_t kMaximumNoise[kNumChannels] = {
    9216, 9088, 8960, 8832, 8704, 8576};
__constant__ int16_t kNoiseDataWeights[kTableSize] = {
    34, 62, 72, 66, 53, 25, 94, 66, 56, 62, 75, 103};
__constant__ int16_t kSpeechDataWeights[kTableSize] = {
    48, 82, 45, 87, 50, 47, 80, 46, 83, 41, 78, 81};
__constant__ int16_t kOffsetVector[kNumChannels] = {
    368, 368, 272, 176, 176, 176};
// Mode thresholds, [mode][10 ms, 20 ms, 30 ms].
__constant__ int16_t kOverHangMax1[4][3] = {
    {8, 4, 3}, {8, 4, 3}, {6, 3, 2}, {6, 3, 2}};
__constant__ int16_t kOverHangMax2[4][3] = {
    {14, 7, 5}, {14, 7, 5}, {9, 5, 3}, {9, 5, 3}};
__constant__ int16_t kLocalThreshold[4][3] = {
    {24, 21, 24}, {37, 32, 37}, {82, 78, 82}, {94, 94, 94}};
__constant__ int16_t kGlobalThreshold[4][3] = {
    {57, 48, 57}, {100, 80, 100}, {285, 260, 285}, {1100, 1050, 1100}};

// Scalars (immediates).
constexpr int32_t kNoiseUpdateConst = 655;     // Q15
constexpr int32_t kSpeechUpdateConst = 6554;   // Q15
constexpr int32_t kBackEta = 154;              // Q8
constexpr int16_t kMaxSpeechFrames = 6;
constexpr int16_t kMinStd = 384;
constexpr int16_t kMinEnergy = 10;
constexpr int32_t kLogConst = 24660;           // 160*log10(2), Q9
constexpr int16_t kLogEnergyIntPart = 14336;   // 14 in Q10
constexpr int32_t kHpZero0 = 6631, kHpZero1 = -13262, kHpZero2 = 6631;
constexpr int32_t kHpPole1 = -7756, kHpPole2 = 5620;
constexpr int32_t kAllPassQ15Upper = 20972, kAllPassQ15Lower = 5571;
constexpr int32_t kAllPassQ13Upper = 5243, kAllPassQ13Lower = 1392;
constexpr int32_t kSmoothingDown = 6553;       // 0.2, Q15
constexpr int32_t kSmoothingUp = 32439;        // 0.99, Q15
constexpr int32_t kCompVar = 22005;
constexpr int32_t kLog2Exp = 5909;             // log2(e), Q12

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wrap_mul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wrap_shl(int32_t a, int s) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) << s);
}
// C int16_t store of an int32 value.
__device__ __forceinline__ int16_t s16(int32_t x) {
  return static_cast<int16_t>(((x & 0xFFFF) ^ 0x8000) - 0x8000);
}

__device__ __forceinline__ int32_t div_w32_w16(int32_t num, int32_t den) {
  // WebRtcSpl_DivW32W16: truncation toward zero, as C's `/`.
  if (den == 0) return 0x7FFFFFFF;
  return num / den;
}

__device__ __forceinline__ int norm_w32(int32_t a) {
  // WebRtcSpl_NormW32 (0 for 0): leading sign bits less one.
  if (a == 0) return 0;
  return __clz(a < 0 ? ~a : a) - 1;
}

__device__ __forceinline__ int norm_u32(uint32_t a) {
  return a == 0 ? 0 : __clz(a);
}

// Slots of the state row (wv_get_state's order).  All hold int16 values
// but the decimator's two int32 states and the frame counter.
constexpr int kDsSlot = 0, kUpperSlot = 2, kLowerSlot = 7, kHpSlot = 12;
constexpr int kNoiseMeansSlot = 16, kSpeechMeansSlot = 28;
constexpr int kNoiseStdsSlot = 40, kSpeechStdsSlot = 52;
constexpr int kLowValueSlot = 64, kAgeSlot = 160, kMeanValueSlot = 256;
constexpr int kFrameCounterSlot = 262, kOverHangSlot = 263;
constexpr int kNumOfSpeechSlot = 264;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFullMask = 0xFFFFFFFFu;
// the largest frame: 480 samples at 16 kHz, 240 at 8 kHz after decimation
constexpr int kMaxFrame = 480, kMaxNb = 240;

// --- vad_gaussian.c ---------------------------------------------------------

__device__ int32_t gaussian_probability(int16_t inp, int16_t mean,
                                        int16_t std, int16_t* delta) {
  int32_t tmp32 = 131072 + (std >> 1);
  int16_t inv_std = s16(div_w32_w16(tmp32, std));          // Q10
  int16_t tmp16 = s16(inv_std >> 2);                       // Q8
  int16_t inv_std2 = s16((tmp16 * tmp16) >> 2);            // Q14
  tmp16 = s16(wrap_shl(inp, 3));                           // Q7
  tmp16 = s16(tmp16 - mean);                               // Q7
  *delta = s16((inv_std2 * tmp16) >> 10);                  // Q11
  tmp32 = (*delta * tmp16) >> 9;                           // Q10
  int32_t exp_value = 0;
  if (tmp32 < kCompVar) {
    tmp16 = s16(wrap_mul(kLog2Exp, tmp32) >> 12);          // Q10
    tmp16 = s16(-tmp16);
    exp_value = 0x0400 | (tmp16 & 0x03FF);
    tmp16 = s16(~tmp16);
    tmp16 = s16(tmp16 >> 10);
    tmp16 = s16(tmp16 + 1);
    exp_value >>= tmp16;
  }
  return wrap_mul(inv_std, exp_value);                     // Q20
}

__device__ int get_scaling_square(const int16_t* v, int n) {
  int nbits = 32 - __clz(n);                   // len(vector).bit_length()
  int32_t smax = 0;
  for (int i = 0; i < n; ++i) {
    int32_t sabs = v[i] > 0 ? v[i] : -v[i];
    if (sabs > smax) smax = sabs;
  }
  if (smax == 0) return 0;
  int t = norm_w32(smax * smax);
  return t > nbits ? 0 : nbits - t;
}

__device__ int32_t energy(const int16_t* v, int n, int* scaling) {
  *scaling = get_scaling_square(v, n);
  int32_t en = 0;
  for (int i = 0; i < n; ++i) en = wrap_add(en, (v[i] * v[i]) >> *scaling);
  return en;
}

// --- vad_sp.c: the 2:1 decimator ---------------------------------------------

// Every chain's length is a multiple of kChunk (frame_len / 2 = 80, 160 or
// 240 for the decimator; n / 2 ... n / 16 = 5 ... 120 for the splits).  A
// chain reads its inputs a chunk ahead into registers, so no shared-memory
// load sits on its dependency chain.
constexpr int kChunk = 5;

// One half of downsampling(): the all-pass chain over the even (half 0,
// upper coefficient) or odd (half 1, lower) samples of a 16 kHz frame,
// its int32 state carried in st[kDsSlot + half].  out[i] is this half's
// term of the 8 kHz sample i (the engine adds the halves).
__device__ void decimate_half(const int16_t* __restrict__ in, int half_len,
                              int half, int32_t* __restrict__ st,
                              int16_t* __restrict__ out) {
  const int32_t coef = half ? kAllPassQ13Lower : kAllPassQ13Upper;
  int32_t state = st[kDsSlot + half];
  int32_t x[kChunk], next[kChunk];
#pragma unroll
  for (int k = 0; k < kChunk; ++k) next[k] = in[2 * k + half];
  for (int c = 0; c < half_len; c += kChunk) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) x[k] = next[k];
    if (c + kChunk < half_len) {
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        next[k] = in[2 * (c + kChunk + k) + half];
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int16_t t = s16(wrap_add(state >> 1, (coef * x[k]) >> 14));
      state = wrap_sub(x[k], (coef * t) >> 12);
      out[c + k] = t;
    }
  }
  st[kDsSlot + half] = state;
}

// --- vad_filterbank.c -------------------------------------------------------

// all_pass_filter_out over in[parity], in[parity + 2], ...: ``len`` outputs,
// the int16 state in the slot *state.
__device__ void all_pass(const int16_t* __restrict__ in, int parity, int len,
                         int32_t coef, int32_t* __restrict__ state,
                         int16_t* __restrict__ out) {
  int32_t state32 = wrap_shl(*state, 16);                          // Q15
  int32_t x[kChunk], next[kChunk];
#pragma unroll
  for (int k = 0; k < kChunk; ++k) next[k] = in[parity + 2 * k];
  for (int c = 0; c < len; c += kChunk) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) x[k] = next[k];
    if (c + kChunk < len) {
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        next[k] = in[parity + 2 * (c + kChunk + k)];
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int32_t tmp32 = wrap_add(state32, coef * x[k]);
      const int16_t tmp16 = s16(tmp32 >> 16);                      // Q(-1)
      out[c + k] = tmp16;
      state32 = wrap_sub(x[k] * (1 << 14), coef * tmp16);          // Q14
      state32 = wrap_mul(state32, 2);                              // Q15
    }
  }
  *state = s16(state32 >> 16);
}

// One of split_filter's two chains on a lane: half 0 the upper chain (even
// samples, state upper[band]), half 1 the lower chain (odd samples, state
// lower[band]).  The lanes of a warp that run chains run this one call
// with their own arguments, so their steps issue together.
__device__ void split_chain(const int16_t* in, int n, int band, int half,
                            int32_t* st, int16_t* out) {
  all_pass(in, half, n >> 1, half ? kAllPassQ15Lower : kAllPassQ15Upper,
           st + (half ? kLowerSlot : kUpperSlot) + band, out);
}

// split_filter's sum and difference of the two chains, over the warp.
__device__ void split_join(const int16_t* u, const int16_t* l, int len,
                           int lane, int16_t* hp, int16_t* lp) {
  for (int i = lane; i < len; i += 32) {
    hp[i] = s16(u[i] - l[i]);
    lp[i] = s16(l[i] + u[i]);
  }
}

__device__ void high_pass_filter(const int16_t* in, int n, int32_t* state,
                                 int16_t* out) {
  for (int i = 0; i < n; ++i) {
    const int32_t x = in[i];
    int32_t tmp32 = kHpZero0 * x;
    tmp32 = wrap_add(tmp32, kHpZero1 * state[0]);
    tmp32 = wrap_add(tmp32, kHpZero2 * state[1]);
    state[1] = state[0];
    state[0] = s16(x);
    tmp32 = wrap_sub(tmp32, kHpPole1 * state[2]);
    tmp32 = wrap_sub(tmp32, kHpPole2 * state[3]);
    state[3] = state[2];
    state[2] = s16(tmp32 >> 14);
    out[i] = s16(state[2]);
  }
}

// log_of_energy without its total-energy update: the feature, and what
// the update needs (whether the energy is nonzero, the normalized energy
// and the total right shifts).
struct BandEnergy {
  int32_t nonzero, en, rshifts;
};

__device__ int16_t log_energy(const int16_t* data, int n, int16_t offset,
                              BandEnergy* out) {
  int tot_rshifts = 0;
  uint32_t en = static_cast<uint32_t>(energy(data, n, &tot_rshifts));
  out->nonzero = en != 0;
  if (en == 0) return offset;
  const int normalizing_rshifts = 17 - norm_u32(en);
  int16_t log2_energy = kLogEnergyIntPart;
  tot_rshifts += normalizing_rshifts;
  if (normalizing_rshifts < 0) {
    en <<= -normalizing_rshifts;
  } else {
    en >>= normalizing_rshifts;
  }
  log2_energy = s16(log2_energy +
                    static_cast<int32_t>((en & 0x00003FFFu) >> 4));  // Q10
  int16_t log_energy = s16(((kLogConst * log2_energy) >> 19)
                           + ((tot_rshifts * kLogConst) >> 9));
  if (log_energy < 0) log_energy = 0;
  out->en = static_cast<int32_t>(en);
  out->rshifts = tot_rshifts;
  return s16(log_energy + offset);
}

// The total energy, log_of_energy's updates in the engine's order
// (channels 5, 4, 3, 2, 1, 0): each step reads the sum so far.
__device__ int16_t total_energy(const BandEnergy* band) {
  int16_t total = 0;
  for (int c = kNumChannels - 1; c >= 0; --c) {
    if (!band[c].nonzero || total > kMinEnergy) continue;
    if (band[c].rshifts >= 0) {
      total = s16(total + kMinEnergy + 1);
    } else {
      total = s16(total + s16(static_cast<int32_t>(
                  static_cast<uint32_t>(band[c].en) >> -band[c].rshifts)));
    }
  }
  return total;
}

// --- vad_core.c -------------------------------------------------------------

__device__ int16_t find_minimum(int32_t* st, int16_t feature_value,
                                int channel) {
  const int offset = channel << 4;
  int32_t* age = st + kAgeSlot + offset;
  int32_t* smallest = st + kLowValueSlot + offset;
  int16_t current_median = 1600;
  int32_t alpha = 0;

  for (int i = 0; i < 16; ++i) {
    if (age[i] != 100) {
      age[i] = s16(age[i] + 1);
    } else {
      for (int j = i; j < 15; ++j) {
        smallest[j] = smallest[j + 1];
        age[j] = age[j + 1];
      }
      age[15] = 101;
      smallest[15] = 10000;
    }
  }

  int position = -1;
  if (feature_value < smallest[15]) {
    position = 15;
    while (position > 0 && feature_value < smallest[position - 1]) --position;
  }
  if (position > -1) {
    for (int i = 15; i > position; --i) {
      smallest[i] = smallest[i - 1];
      age[i] = age[i - 1];
    }
    smallest[position] = feature_value;
    age[position] = 1;
  }

  const int32_t frame_counter = st[kFrameCounterSlot];
  int32_t* mean_value = st + kMeanValueSlot + channel;
  if (frame_counter > 2) {
    current_median = s16(smallest[2]);
  } else if (frame_counter > 0) {
    current_median = s16(smallest[0]);
  }

  if (frame_counter > 0) {
    alpha = (current_median < *mean_value) ? kSmoothingDown : kSmoothingUp;
  }
  int32_t tmp32 = wrap_mul(alpha + 1, *mean_value);
  tmp32 = wrap_add(tmp32, wrap_mul(32767 - alpha, current_median));
  tmp32 = wrap_add(tmp32, 16384);
  *mean_value = s16(tmp32 >> 15);
  return s16(*mean_value);
}

__device__ int32_t weighted_average(int32_t* data, int channel,
                                    int16_t offset, bool speech) {
  int32_t result = 0;
  for (int k = 0; k < 2; ++k) {
    const int g = channel + k * kNumChannels;
    data[g] = s16(data[g] + offset);
    const int32_t w = speech ? kSpeechDataWeights[g] : kNoiseDataWeights[g];
    result = wrap_add(result, data[g] * w);
  }
  return result;
}

// gmm_probability for one frame, one lane a channel (lanes 0-5 of the
// calling warp; the whole warp calls it).  The decision lands on lane 0.
__device__ int16_t gmm_frame(int32_t* st, const int16_t* features,
                             int16_t total_power, int fl_index, int mode,
                             int lane) {
  const int channel = lane;
  const bool active = lane < kNumChannels;
  const int16_t individual_test = kLocalThreshold[mode][fl_index];
  const int16_t total_test = kGlobalThreshold[mode][fl_index];
  int16_t vadflag = 0;

  if (total_power > kMinEnergy) {
    int16_t delta_n[2] = {0, 0}, delta_s[2] = {0, 0};
    int16_t ngprvec[2] = {0, 0}, sgprvec[2] = {0, 0};
    int32_t weighted_llr = 0;
    int flag = 0;
    const int16_t feature = active ? features[channel] : 0;
    if (active) {
      int32_t h0_test = 0, h1_test = 0;
      int32_t noise_probability[2], speech_probability[2];
      for (int k = 0; k < 2; ++k) {
        const int g = channel + k * kNumChannels;
        int32_t prob = gaussian_probability(
            feature, s16(st[kNoiseMeansSlot + g]),
            s16(st[kNoiseStdsSlot + g]), &delta_n[k]);
        noise_probability[k] = wrap_mul(kNoiseDataWeights[g], prob);
        h0_test = wrap_add(h0_test, noise_probability[k]);        // Q27
        prob = gaussian_probability(
            feature, s16(st[kSpeechMeansSlot + g]),
            s16(st[kSpeechStdsSlot + g]), &delta_s[k]);
        speech_probability[k] = wrap_mul(kSpeechDataWeights[g], prob);
        h1_test = wrap_add(h1_test, speech_probability[k]);       // Q27
      }
      const int shifts_h0 = h0_test == 0 ? 31 : norm_w32(h0_test);
      const int shifts_h1 = h1_test == 0 ? 31 : norm_w32(h1_test);
      const int16_t log_likelihood_ratio = s16(shifts_h0 - shifts_h1);
      weighted_llr = log_likelihood_ratio * kSpectrumWeight[channel];
      flag = (log_likelihood_ratio * 4) > individual_test;

      const int16_t h0 = s16(h0_test >> 12);                      // Q15
      if (h0 > 0) {
        const int32_t tmp1_s32 = static_cast<int32_t>(
            (static_cast<uint32_t>(noise_probability[0]) & 0xFFFFF000u) << 2);
        ngprvec[0] = s16(div_w32_w16(tmp1_s32, h0));              // Q14
        ngprvec[1] = s16(16384 - ngprvec[0]);
      } else {
        ngprvec[0] = 16384;
      }
      const int16_t h1 = s16(h1_test >> 12);                      // Q15
      if (h1 > 0) {
        const int32_t tmp1_s32 = static_cast<int32_t>(
            (static_cast<uint32_t>(speech_probability[0]) & 0xFFFFF000u)
            << 2);
        sgprvec[0] = s16(div_w32_w16(tmp1_s32, h1));              // Q14
        sgprvec[1] = s16(16384 - sgprvec[0]);
      }
    }
    // the vote: the engine sums the weighted ratios over channels 0..5 in
    // int32 (wrapping addition: any order gives the same bits)
    int32_t sum_log_likelihood_ratios = weighted_llr;
    for (int o = 16; o > 0; o >>= 1)
      sum_log_likelihood_ratios = wrap_add(
          sum_log_likelihood_ratios,
          __shfl_xor_sync(kFullMask, sum_log_likelihood_ratios, o));
    vadflag = __any_sync(kFullMask, flag) ? 1 : 0;
    if (sum_log_likelihood_ratios >= total_test) vadflag |= 1;

    // Sequential model update, one lane a channel: a channel's update reads
    // and writes only its own slots (maxspe, carried from channel to
    // channel in the engine, is the previous channel's constant)
    if (active) {
      const int16_t maxspe = channel == 0 ? 12800
                                          : kMaximumSpeech[channel - 1];
      const int16_t feature_minimum = find_minimum(st, feature, channel);
      int32_t noise_global_mean = weighted_average(st + kNoiseMeansSlot,
                                                   channel, 0, false);
      const int16_t tmp1_s16 = s16(noise_global_mean >> 6);       // Q8

      for (int k = 0; k < 2; ++k) {
        const int gaussian = channel + k * kNumChannels;
        const int16_t nmk = s16(st[kNoiseMeansSlot + gaussian]);
        const int16_t smk = s16(st[kSpeechMeansSlot + gaussian]);
        int16_t nsk = s16(st[kNoiseStdsSlot + gaussian]);
        int16_t ssk = s16(st[kSpeechStdsSlot + gaussian]);

        int16_t nmk2 = nmk;
        if (!vadflag) {
          const int16_t delt = s16((ngprvec[k] * delta_n[k]) >> 11);
          nmk2 = s16(nmk + s16((delt * kNoiseUpdateConst) >> 22));
        }

        const int16_t ndelt = s16(wrap_sub(wrap_shl(feature_minimum, 4),
                                           tmp1_s16));            // Q8
        int16_t nmk3 = s16(nmk2 + s16((ndelt * kBackEta) >> 9));  // Q7

        int16_t tmp_s16 = s16((k + 5) << 7);
        if (nmk3 < tmp_s16) nmk3 = tmp_s16;
        tmp_s16 = s16((72 + k - channel) << 7);
        if (nmk3 > tmp_s16) nmk3 = tmp_s16;
        st[kNoiseMeansSlot + gaussian] = nmk3;

        if (vadflag) {
          const int16_t delt = s16((sgprvec[k] * delta_s[k]) >> 11);
          tmp_s16 = s16((delt * kSpeechUpdateConst) >> 21);       // Q8
          int16_t smk2 = s16(smk + ((tmp_s16 + 1) >> 1));         // Q7
          const int16_t maxmu = s16(maxspe + 640);
          if (smk2 > maxmu) smk2 = maxmu;
          st[kSpeechMeansSlot + gaussian] = smk2;

          tmp_s16 = s16((smk + 4) >> 3);                          // Q4
          tmp_s16 = s16(feature - tmp_s16);                       // Q4
          int32_t tmp1_s32 = (delta_s[k] * tmp_s16) >> 3;         // Q12
          int32_t tmp2_s32 = tmp1_s32 - 4096;
          tmp_s16 = s16(sgprvec[k] >> 2);
          tmp1_s32 = wrap_mul(tmp_s16, tmp2_s32);                 // Q24
          tmp2_s32 = tmp1_s32 >> 4;                               // Q20
          if (tmp2_s32 > 0) {
            tmp_s16 = s16(div_w32_w16(tmp2_s32, ssk * 10));
          } else {
            tmp_s16 = s16(div_w32_w16(wrap_sub(0, tmp2_s32), ssk * 10));
            tmp_s16 = s16(-tmp_s16);
          }
          tmp_s16 = s16(tmp_s16 + 128);
          ssk = s16(ssk + (tmp_s16 >> 8));
          if (ssk < kMinStd) ssk = kMinStd;
          st[kSpeechStdsSlot + gaussian] = ssk;
        } else {
          int16_t t16 = s16(feature - (nmk >> 3));                // Q4
          int32_t tmp1_s32 = (delta_n[k] * t16) >> 3;             // Q12
          int32_t tmp2_s32 = tmp1_s32 - 4096;
          t16 = s16((ngprvec[k] + 2) >> 2);
          tmp2_s32 = wrap_mul(t16, tmp2_s32);                     // Q24
          tmp1_s32 = tmp2_s32 >> 14;                              // Q20
          if (tmp1_s32 > 0) {
            t16 = s16(div_w32_w16(tmp1_s32, nsk));
          } else {
            t16 = s16(div_w32_w16(wrap_sub(0, tmp1_s32), nsk));
            t16 = s16(-t16);
          }
          t16 = s16(t16 + 32);
          nsk = s16(nsk + (t16 >> 6));
          if (nsk < kMinStd) nsk = kMinStd;
          st[kNoiseStdsSlot + gaussian] = nsk;
        }
      }

      noise_global_mean = weighted_average(st + kNoiseMeansSlot, channel, 0,
                                           false);
      int32_t speech_global_mean = weighted_average(st + kSpeechMeansSlot,
                                                    channel, 0, true);
      const int16_t diff = s16(s16(speech_global_mean >> 9)
                               - s16(noise_global_mean >> 9));
      if (diff < kMinimumDifference[channel]) {
        const int16_t tmp_s16 = s16(kMinimumDifference[channel] - diff);
        const int16_t tmp1 = s16((13 * tmp_s16) >> 2);
        const int16_t tmp2 = s16((3 * tmp_s16) >> 2);
        speech_global_mean = weighted_average(st + kSpeechMeansSlot, channel,
                                              tmp1, true);
        noise_global_mean = weighted_average(st + kNoiseMeansSlot, channel,
                                             s16(-tmp2), false);
      }

      int16_t tmp2_s16 = s16(speech_global_mean >> 7);
      if (tmp2_s16 > kMaximumSpeech[channel]) {
        tmp2_s16 = s16(tmp2_s16 - kMaximumSpeech[channel]);
        for (int k = 0; k < 2; ++k) {
          const int g = kSpeechMeansSlot + channel + k * kNumChannels;
          st[g] = s16(st[g] - tmp2_s16);
        }
      }
      tmp2_s16 = s16(noise_global_mean >> 7);
      if (tmp2_s16 > kMaximumNoise[channel]) {
        tmp2_s16 = s16(tmp2_s16 - kMaximumNoise[channel]);
        for (int k = 0; k < 2; ++k) {
          const int g = kNoiseMeansSlot + channel + k * kNumChannels;
          st[g] = s16(st[g] - tmp2_s16);
        }
      }
    }
    __syncwarp();                  // every channel read the frame counter
    if (lane == 0)
      st[kFrameCounterSlot] = wrap_add(st[kFrameCounterSlot], 1);
  }

  if (lane != 0) return 0;
  int16_t over_hang = s16(st[kOverHangSlot]);
  int16_t num_of_speech = s16(st[kNumOfSpeechSlot]);
  if (!vadflag) {
    if (over_hang > 0) {
      vadflag = s16(2 + over_hang);
      over_hang = s16(over_hang - 1);
    }
    num_of_speech = 0;
  } else {
    num_of_speech = s16(num_of_speech + 1);
    if (num_of_speech > kMaxSpeechFrames) {
      num_of_speech = kMaxSpeechFrames;
      over_hang = kOverHangMax2[mode][fl_index];
    } else {
      over_hang = kOverHangMax1[mode][fl_index];
    }
  }
  st[kOverHangSlot] = over_hang;
  st[kNumOfSpeechSlot] = num_of_speech;
  return vadflag;
}

// W1: x (B rows, row_stride apart) of T frames each; states (n_states, 265).
// One block of kThreads a row; the pipeline's tick t runs frame t on warp 0
// down to frame t - 3 on warp 3.
__global__ void __launch_bounds__(kThreads)
webrtc_vad_kernel(const int16_t* __restrict__ x, long long row_stride, int T,
                  int frame_len, int rate16, int mode,
                  int32_t* __restrict__ states, int n_states,
                  const int32_t* __restrict__ idx,
                  uint8_t* __restrict__ decisions) {
  __shared__ int32_t st[kStateSlots];
  __shared__ int16_t raw[2][kMaxFrame];        // staged input frames
  __shared__ int16_t da[kMaxNb], db[kMaxNb];   // the decimator's halves
  __shared__ int16_t nb[2][kMaxNb];            // 8 kHz frames
  __shared__ int16_t u1[kMaxNb / 2], l1[kMaxNb / 2];
  __shared__ int16_t hp1[kMaxNb / 2], lp1[kMaxNb / 2];
  __shared__ int16_t u2[kMaxNb / 4], l2[kMaxNb / 4];
  __shared__ int16_t u3[kMaxNb / 4], l3[kMaxNb / 4];
  __shared__ int16_t hp2[2][kMaxNb / 4], lp2[2][kMaxNb / 4];
  __shared__ int16_t hp3[2][kMaxNb / 4], lp3[2][kMaxNb / 4];
  __shared__ int16_t u4[kMaxNb / 8], l4[kMaxNb / 8];
  __shared__ int16_t hp4[kMaxNb / 8], lp4[kMaxNb / 8];
  __shared__ int16_t u5[kMaxNb / 16], l5[kMaxNb / 16];
  __shared__ int16_t hp5[kMaxNb / 16], lp5[kMaxNb / 16];
  __shared__ int16_t hp80[kMaxNb / 16];
  __shared__ BandEnergy band[kNumChannels];
  __shared__ int16_t features[2][kNumChannels];
  __shared__ int16_t power[2];

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint8_t* dec = decisions + static_cast<long long>(b) * T;
  const int row = idx[b];
  if (row < 0 || row >= n_states) {
    for (int f = threadIdx.x; f < T; f += kThreads) dec[f] = 0;
    return;
  }
  int32_t* slots = states + static_cast<long long>(row) * kStateSlots;
  for (int i = threadIdx.x; i < kStateSlots; i += kThreads) {
    const int32_t v = slots[i];
    st[i] = (i < kUpperSlot || i == kFrameCounterSlot) ? v : s16(v);
  }
  const int16_t* samples = x + static_cast<long long>(b) * row_stride;
  const int n = rate16 ? frame_len >> 1 : frame_len;       // 8 kHz samples
  const int fl_index = n == 80 ? 0 : (n == 160 ? 1 : 2);
  if (T > 0)
    for (int i = threadIdx.x; i < frame_len; i += kThreads)
      raw[0][i] = __ldg(samples + i);
  __syncthreads();

  for (int t = 0; t < T + kWarps - 1; ++t) {
    const int f = t - warp;                  // this warp's frame
    const int p = f & 1;
    if (f >= 0 && f < T) {
      if (warp == 0) {
        if (rate16) {
          if (lane < 2) decimate_half(raw[p], n, lane, st, lane ? db : da);
          __syncwarp();
          for (int i = lane; i < n; i += 32) nb[p][i] = s16(da[i] + db[i]);
        } else {
          for (int i = lane; i < n; i += 32) nb[p][i] = raw[p][i];
        }
      } else if (warp == 1) {
        // split at 2000 Hz, then at 3000 Hz (upper) and 1000 Hz (lower)
        if (lane < 2) split_chain(nb[p], n, 0, lane, st, lane ? l1 : u1);
        __syncwarp();
        split_join(u1, l1, n >> 1, lane, hp1, lp1);
        __syncwarp();
        if (lane < 4) {
          int16_t* const outs[4] = {u2, l2, u3, l3};
          split_chain(lane < 2 ? hp1 : lp1, n >> 1, 1 + (lane >> 1), lane & 1,
                      st, outs[lane]);
        }
        __syncwarp();
        split_join(u2, l2, n >> 2, lane, hp2[p], lp2[p]);
        split_join(u3, l3, n >> 2, lane, hp3[p], lp3[p]);
      } else if (warp == 2) {
        // split at 500 Hz and 250 Hz, then remove 0-80 Hz
        if (lane < 2) split_chain(lp3[p], n >> 2, 3, lane, st, lane ? l4 : u4);
        __syncwarp();
        split_join(u4, l4, n >> 3, lane, hp4, lp4);
        __syncwarp();
        if (lane < 2) split_chain(lp4, n >> 3, 4, lane, st, lane ? l5 : u5);
        __syncwarp();
        split_join(u5, l5, n >> 4, lane, hp5, lp5);
        __syncwarp();
        if (lane == 0) high_pass_filter(lp5, n >> 4, st + kHpSlot, hp80);
        __syncwarp();
        if (lane < kNumChannels) {
          const int16_t* data[kNumChannels] = {hp80, hp5, hp4, hp3[p],
                                               lp2[p], hp2[p]};
          const int len = lane >= 3 ? n >> 2 : (lane == 2 ? n >> 3 : n >> 4);
          features[p][lane] = log_energy(data[lane], len,
                                         kOffsetVector[lane], &band[lane]);
        }
        __syncwarp();
        if (lane == 0) power[p] = total_energy(band);
      } else {
        const int16_t flag = gmm_frame(st, features[p], power[p], fl_index,
                                       mode, lane);
        if (lane == 0) dec[f] = flag > 0 ? 1 : 0;
      }
    }
    if (warp == kWarps - 1 && t + 1 < T) {   // stage frame t + 1
      const int16_t* frame = samples + static_cast<long long>(t + 1) *
                                           frame_len;
      for (int i = lane; i < frame_len; i += 32)
        raw[(t + 1) & 1][i] = __ldg(frame + i);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < kStateSlots; i += kThreads) slots[i] = st[i];
}

// W2 (see the head of the file), one warp a row for a ring of 1 ... 32
// frames.  Bits 0 ... 31 of dbits and kbits are the decisions and keep
// flags of word w - 1 (frames 32 (w - 1) ...), bits 32 ... 63 those of word
// w.  Every lane runs the same trigger machine on the same words, so the
// machine needs no broadcast; lane l writes frame 32 w + l of a finished
// word.
constexpr int kCollectWarps = 4;

__global__ void __launch_bounds__(kCollectWarps * 32)
vad_collect_warp_kernel(const uint8_t* __restrict__ decisions, int B, int T,
                        const int32_t* __restrict__ n_valid, double thresh,
                        int ring, uint8_t* __restrict__ keep,
                        int32_t* __restrict__ kept) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kCollectWarps + (threadIdx.x >> 5);
  if (b >= B) return;                          // the whole warp
  const uint8_t* d = decisions + static_cast<long long>(b) * T;
  uint8_t* k = keep + static_cast<long long>(b) * T;
  const int nv = min(max(n_valid[b], 0), T);
  const int words = (T + 31) >> 5;
  unsigned long long dbits = 0, kbits = 0;
  bool triggered = false;
  int start = 0, total = 0;                    // first frame in the ring
  for (int w = 0; w < words; ++w) {
    const int base = w << 5;
    const int f = base + lane;
    const bool voiced = f < nv && d[f] != 0;   // frames past n_valid: 0
    dbits |= static_cast<unsigned long long>(
                 __ballot_sync(0xffffffffu, voiced)) << 32;
    const int end = min(base + 32, nv);
    for (int i = base; i < end; ++i) {
      // the ring is frames [lo, i]: bits [q, p] (q >= 1 as ring <= 32)
      const int p = i - base + 32;
      const int q = max(start, i - ring + 1) - base + 32;
      const unsigned long long win = (~0ull >> (63 - p)) & (~0ull << q);
      const int voiced_n = __popcll(dbits & win);
      if (!triggered) {
        if (static_cast<double>(voiced_n) > thresh) {
          triggered = true;
          kbits |= win;                        // the ring, retroactively
          start = i + 1;
        }
      } else {
        kbits |= 1ull << p;
        if (static_cast<double>(p - q + 1 - voiced_n) > thresh) {
          triggered = false;
          start = i + 1;
        }
      }
    }
    if (w > 0) {                               // word w - 1 is final
      const unsigned done = static_cast<unsigned>(kbits);
      k[f - 32] = (done >> lane) & 1u;
      total += __popc(done);
    }
    dbits >>= 32;
    kbits >>= 32;
  }
  if (words > 0) {
    const unsigned done = static_cast<unsigned>(kbits);
    const int f = ((words - 1) << 5) + lane;
    if (f < T) k[f] = (done >> lane) & 1u;
    total += __popc(done);
  }
  if (lane == 0) kept[b] = total;
}

// W2 for any other ring: one thread a row walks its T decisions and
// recounts the ring (consecutive frames, read back from the decisions).
__global__ void vad_collect_kernel(const uint8_t* __restrict__ decisions,
                                   int B, int T,
                                   const int32_t* __restrict__ n_valid,
                                   double thresh, int ring,
                                   uint8_t* __restrict__ keep,
                                   int32_t* __restrict__ kept) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t* d = decisions + static_cast<long long>(b) * T;
  uint8_t* k = keep + static_cast<long long>(b) * T;
  for (int t = 0; t < T; ++t) k[t] = 0;
  int nv = min(max(n_valid[b], 0), T);
  bool triggered = false;
  int start = 0;                               // first frame in the ring
  for (int i = 0; i < nv; ++i) {
    int occ = min(i - start + 1, ring);
    int voiced = 0;
    for (int j = i - occ + 1; j <= i; ++j) voiced += d[j] != 0;
    if (!triggered) {
      if (static_cast<double>(voiced) > thresh) {
        triggered = true;
        for (int j = i - occ + 1; j <= i; ++j) k[j] = 1;
        start = i + 1;
      }
    } else {
      k[i] = 1;
      if (static_cast<double>(occ - voiced) > thresh) {
        triggered = false;
        start = i + 1;
      }
    }
  }
  int n = 0;
  for (int t = 0; t < T; ++t) n += k[t];
  kept[b] = n;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int webrtc_vad_launch(const int16_t* x, long long row_stride, int B, int T,
                      int frame_len, int rate16, int mode, int32_t* states,
                      int n_states, const int32_t* idx, uint8_t* decisions,
                      cudaStream_t stream) {
  if (B <= 0 || T < 0 || frame_len > kMaxFrame ||
      (rate16 ? frame_len >> 1 : frame_len) > kMaxNb)
    return static_cast<int>(cudaErrorInvalidValue);
  webrtc_vad_kernel<<<B, kThreads, 0, stream>>>(
      x, row_stride, T, frame_len, rate16, mode, states, n_states, idx,
      decisions);
  return static_cast<int>(cudaGetLastError());
}

int vad_collect_launch(const uint8_t* decisions, int B, int T,
                       const int32_t* n_valid, double thresh, int ring,
                       uint8_t* keep, int32_t* kept, cudaStream_t stream) {
  if (B <= 0 || T < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (ring >= 1 && ring <= 32) {
    const int blocks = (B + kCollectWarps - 1) / kCollectWarps;
    vad_collect_warp_kernel<<<blocks, kCollectWarps * 32, 0, stream>>>(
        decisions, B, T, n_valid, thresh, ring, keep, kept);
  } else {
    constexpr int kCollectThreads = 128;
    const int blocks = (B + kCollectThreads - 1) / kCollectThreads;
    vad_collect_kernel<<<blocks, kCollectThreads, 0, stream>>>(
        decisions, B, T, n_valid, thresh, ring, keep, kept);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
