// The multiplexer's per-stream voice-activity chain on the card: two kernels.
//
// W1, webrtc_vad_kernel, replaces mmla_audio_tpu/vad/webrtc.py:580
// (webrtc_vad_frames: an int32 lax.scan over samples, vmapped over the
// multiplexer's stream batch).  W2, vad_collect_kernel, replaces
// mmla_audio_tpu/vad/collector.py:48 (collect_mask: a lax.scan over frames).
// Neither replaces a Pallas kernel.
//
// W1 is the fixed-point webrtcvad engine of csrc/host/webrtcvad.cpp
// (wv_process -> downsampling -> calc_vad_8khz -> calculate_features ->
// gmm_probability), one thread a stream.  The thread loads its stream's
// 265-slot state row (the layout of wv_get_state / wv_set_state), runs the
// window's frames in order and stores the row back, so a row written by the
// host engine and one written here are interchangeable bit for bit.  Rows
// whose index is n_states or more are padding: they read and write no state
// and their decisions are 0.  The caller guarantees that no two rows of a
// launch share a state index.
//
// What bounds W1 on this card is its serial dependency chain, not bytes: a
// row reads 81,600 B of samples and reads and writes 1,060 B of state, but
// the filterbank is a cascade of sample-serial IIRs whose state is
// truncated to int16 every sample, and the GMM update of a frame depends on
// the previous frame's.  The design does nothing about the chain beyond
// keeping one stream on one thread with its state in registers and local
// memory; spreading a stream over lanes (the six sub-bands, the pipelined
// filter stages) is later work.  ``rows_per_block`` sets how many streams
// share a block (one a lane); 1 gives each stream a warp of its own.
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
// cleared at both.  One thread a row walks its T decisions; the ring holds
// consecutive frames, so it is read back from the decisions themselves.

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

struct VadState {
  int32_t ds[2];
  int16_t upper[5];
  int16_t lower[5];
  int16_t hp[4];
  int16_t noise_means[kTableSize];
  int16_t speech_means[kTableSize];
  int16_t noise_stds[kTableSize];
  int16_t speech_stds[kTableSize];
  int16_t low_value[16 * kNumChannels];
  int16_t age[16 * kNumChannels];
  int16_t mean_value[kNumChannels];
  int32_t frame_counter;
  int16_t over_hang;
  int16_t num_of_speech;
};

// wv_set_state.
__device__ void load_state(VadState* st, const int32_t* in) {
  int i = 0;
  for (int j = 0; j < 2; ++j) st->ds[j] = in[i++];
  for (int j = 0; j < 5; ++j) st->upper[j] = s16(in[i++]);
  for (int j = 0; j < 5; ++j) st->lower[j] = s16(in[i++]);
  for (int j = 0; j < 4; ++j) st->hp[j] = s16(in[i++]);
  for (int j = 0; j < kTableSize; ++j) st->noise_means[j] = s16(in[i++]);
  for (int j = 0; j < kTableSize; ++j) st->speech_means[j] = s16(in[i++]);
  for (int j = 0; j < kTableSize; ++j) st->noise_stds[j] = s16(in[i++]);
  for (int j = 0; j < kTableSize; ++j) st->speech_stds[j] = s16(in[i++]);
  for (int j = 0; j < 96; ++j) st->low_value[j] = s16(in[i++]);
  for (int j = 0; j < 96; ++j) st->age[j] = s16(in[i++]);
  for (int j = 0; j < kNumChannels; ++j) st->mean_value[j] = s16(in[i++]);
  st->frame_counter = in[i++];
  st->over_hang = s16(in[i++]);
  st->num_of_speech = s16(in[i++]);
}

// wv_get_state.
__device__ void store_state(const VadState* st, int32_t* out) {
  int i = 0;
  for (int j = 0; j < 2; ++j) out[i++] = st->ds[j];
  for (int j = 0; j < 5; ++j) out[i++] = st->upper[j];
  for (int j = 0; j < 5; ++j) out[i++] = st->lower[j];
  for (int j = 0; j < 4; ++j) out[i++] = st->hp[j];
  for (int j = 0; j < kTableSize; ++j) out[i++] = st->noise_means[j];
  for (int j = 0; j < kTableSize; ++j) out[i++] = st->speech_means[j];
  for (int j = 0; j < kTableSize; ++j) out[i++] = st->noise_stds[j];
  for (int j = 0; j < kTableSize; ++j) out[i++] = st->speech_stds[j];
  for (int j = 0; j < 96; ++j) out[i++] = st->low_value[j];
  for (int j = 0; j < 96; ++j) out[i++] = st->age[j];
  for (int j = 0; j < kNumChannels; ++j) out[i++] = st->mean_value[j];
  out[i++] = st->frame_counter;
  out[i++] = st->over_hang;
  out[i++] = st->num_of_speech;
}

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

// --- vad_sp.c ---------------------------------------------------------------

// 2:1 all-pass decimation of one 16 kHz frame read from device memory.
__device__ void downsampling(const int16_t* __restrict__ in, int n,
                             int16_t* out, int32_t* state) {
  int32_t tmp32_1 = state[0];
  int32_t tmp32_2 = state[1];
  int half = n >> 1;
  for (int i = 0; i < half; ++i) {
    int32_t x0 = __ldg(in + 2 * i);
    int32_t x1 = __ldg(in + 2 * i + 1);
    int16_t t1 = s16(wrap_add(tmp32_1 >> 1, (kAllPassQ13Upper * x0) >> 14));
    tmp32_1 = wrap_sub(x0, (kAllPassQ13Upper * t1) >> 12);
    int16_t t2 = s16(wrap_add(tmp32_2 >> 1, (kAllPassQ13Lower * x1) >> 14));
    out[i] = s16(t1 + t2);
    tmp32_2 = wrap_sub(x1, (kAllPassQ13Lower * t2) >> 12);
  }
  state[0] = tmp32_1;
  state[1] = tmp32_2;
}

__device__ int16_t find_minimum(VadState* st, int16_t feature_value,
                                int channel) {
  int offset = channel << 4;
  int16_t* age = st->age + offset;
  int16_t* smallest = st->low_value + offset;
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

  if (st->frame_counter > 2) {
    current_median = smallest[2];
  } else if (st->frame_counter > 0) {
    current_median = smallest[0];
  }

  if (st->frame_counter > 0) {
    alpha = (current_median < st->mean_value[channel]) ? kSmoothingDown
                                                       : kSmoothingUp;
  }
  int32_t tmp32 = wrap_mul(alpha + 1, st->mean_value[channel]);
  tmp32 = wrap_add(tmp32, wrap_mul(32767 - alpha, current_median));
  tmp32 = wrap_add(tmp32, 16384);
  st->mean_value[channel] = s16(tmp32 >> 15);
  return st->mean_value[channel];
}

// --- vad_filterbank.c -------------------------------------------------------

__device__ void all_pass_filter_out(const int16_t* in, int stride_offset,
                                    int length, int32_t coef, int16_t* state,
                                    int16_t* out) {
  int32_t state32 = wrap_shl(*state, 16);                          // Q15
  for (int i = 0; i < length; ++i) {
    int32_t x = in[stride_offset + 2 * i];
    int32_t tmp32 = wrap_add(state32, coef * x);
    int16_t tmp16 = s16(tmp32 >> 16);                              // Q(-1)
    out[i] = tmp16;
    state32 = wrap_sub(x * (1 << 14), coef * tmp16);               // Q14
    state32 = wrap_mul(state32, 2);                                // Q15
  }
  *state = s16(state32 >> 16);
}

__device__ void split_filter(const int16_t* in, int n, int16_t* state_u,
                             int16_t* state_l, int16_t* hp, int16_t* lp) {
  int half = n >> 1;
  all_pass_filter_out(in, 0, half, kAllPassQ15Upper, state_u, hp);
  all_pass_filter_out(in, 1, half, kAllPassQ15Lower, state_l, lp);
  for (int i = 0; i < half; ++i) {
    int16_t tmp = hp[i];
    hp[i] = s16(hp[i] - lp[i]);
    lp[i] = s16(lp[i] + tmp);
  }
}

__device__ void high_pass_filter(const int16_t* in, int n, int16_t* state,
                                 int16_t* out) {
  for (int i = 0; i < n; ++i) {
    int32_t x = in[i];
    int32_t tmp32 = kHpZero0 * x;
    tmp32 = wrap_add(tmp32, kHpZero1 * state[0]);
    tmp32 = wrap_add(tmp32, kHpZero2 * state[1]);
    state[1] = state[0];
    state[0] = s16(x);
    tmp32 = wrap_sub(tmp32, kHpPole1 * state[2]);
    tmp32 = wrap_sub(tmp32, kHpPole2 * state[3]);
    state[3] = state[2];
    state[2] = s16(tmp32 >> 14);
    out[i] = state[2];
  }
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

__device__ int16_t log_of_energy(const int16_t* data, int n, int16_t offset,
                                 int16_t* total_energy) {
  int tot_rshifts = 0;
  uint32_t en = static_cast<uint32_t>(energy(data, n, &tot_rshifts));
  if (en != 0) {
    int normalizing_rshifts = 17 - norm_u32(en);
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
    log_energy = s16(log_energy + offset);
    if (*total_energy <= kMinEnergy) {
      if (tot_rshifts >= 0) {
        *total_energy = s16(*total_energy + kMinEnergy + 1);
      } else {
        *total_energy = s16(*total_energy +
                            s16(static_cast<int32_t>(en >> -tot_rshifts)));
      }
    }
    return log_energy;
  }
  return offset;
}

__device__ int16_t calculate_features(VadState* st, const int16_t* data_in,
                                      int n, int16_t* features) {
  int16_t total_energy = 0;
  int16_t buf_hp[120], buf_lp[120];
  int16_t buf2_hp[60], buf2_lp[60];
  int16_t buf3_hp[30], buf3_lp[30];
  int16_t buf4_hp[15], buf4_lp[15];
  int16_t hp80[15];

  // Split at 2000 Hz and downsample.
  split_filter(data_in, n, &st->upper[0], &st->lower[0], buf_hp, buf_lp);
  int half = n >> 1;
  // Upper band: split at 3000 Hz.
  split_filter(buf_hp, half, &st->upper[1], &st->lower[1], buf2_hp, buf2_lp);
  features[5] = log_of_energy(buf2_hp, half >> 1, kOffsetVector[5],
                              &total_energy);
  features[4] = log_of_energy(buf2_lp, half >> 1, kOffsetVector[4],
                              &total_energy);
  // Lower band: split at 1000 Hz.
  split_filter(buf_lp, half, &st->upper[2], &st->lower[2], buf2_hp, buf2_lp);
  features[3] = log_of_energy(buf2_hp, half >> 1, kOffsetVector[3],
                              &total_energy);
  // Split at 500 Hz.
  split_filter(buf2_lp, half >> 1, &st->upper[3], &st->lower[3], buf3_hp,
               buf3_lp);
  features[2] = log_of_energy(buf3_hp, half >> 2, kOffsetVector[2],
                              &total_energy);
  // Split at 250 Hz.
  split_filter(buf3_lp, half >> 2, &st->upper[4], &st->lower[4], buf4_hp,
               buf4_lp);
  features[1] = log_of_energy(buf4_hp, half >> 3, kOffsetVector[1],
                              &total_energy);
  // Remove 0-80 Hz.
  high_pass_filter(buf4_lp, half >> 3, st->hp, hp80);
  features[0] = log_of_energy(hp80, half >> 3, kOffsetVector[0],
                              &total_energy);
  return total_energy;
}

// --- vad_core.c -------------------------------------------------------------

__device__ int32_t weighted_average(int16_t* data, int channel,
                                    int16_t offset, bool speech) {
  int32_t result = 0;
  for (int k = 0; k < 2; ++k) {
    int g = channel + k * kNumChannels;
    data[g] = s16(data[g] + offset);
    int32_t w = speech ? kSpeechDataWeights[g] : kNoiseDataWeights[g];
    result = wrap_add(result, data[g] * w);
  }
  return result;
}

__device__ int16_t gmm_probability(VadState* st, const int16_t* features,
                                   int16_t total_power, int fl_index,
                                   int mode) {
  int16_t vadflag = 0;
  int16_t delta_n[kTableSize] = {0};
  int16_t delta_s[kTableSize] = {0};
  int16_t ngprvec[kTableSize] = {0};
  int16_t sgprvec[kTableSize] = {0};

  int16_t overhead1 = kOverHangMax1[mode][fl_index];
  int16_t overhead2 = kOverHangMax2[mode][fl_index];
  int16_t individual_test = kLocalThreshold[mode][fl_index];
  int16_t total_test = kGlobalThreshold[mode][fl_index];

  if (total_power > kMinEnergy) {
    int32_t sum_log_likelihood_ratios = 0;
    int32_t noise_probability[2];
    int32_t speech_probability[2];
    for (int channel = 0; channel < kNumChannels; ++channel) {
      int32_t h0_test = 0;
      int32_t h1_test = 0;
      for (int k = 0; k < 2; ++k) {
        int gaussian = channel + k * kNumChannels;
        int32_t prob = gaussian_probability(
            features[channel], st->noise_means[gaussian],
            st->noise_stds[gaussian], &delta_n[gaussian]);
        noise_probability[k] = wrap_mul(kNoiseDataWeights[gaussian], prob);
        h0_test = wrap_add(h0_test, noise_probability[k]);        // Q27
        prob = gaussian_probability(
            features[channel], st->speech_means[gaussian],
            st->speech_stds[gaussian], &delta_s[gaussian]);
        speech_probability[k] = wrap_mul(kSpeechDataWeights[gaussian], prob);
        h1_test = wrap_add(h1_test, speech_probability[k]);       // Q27
      }
      int shifts_h0 = h0_test == 0 ? 31 : norm_w32(h0_test);
      int shifts_h1 = h1_test == 0 ? 31 : norm_w32(h1_test);
      int16_t log_likelihood_ratio = s16(shifts_h0 - shifts_h1);

      sum_log_likelihood_ratios = wrap_add(
          sum_log_likelihood_ratios,
          log_likelihood_ratio * kSpectrumWeight[channel]);
      if ((log_likelihood_ratio * 4) > individual_test) vadflag = 1;

      int16_t h0 = s16(h0_test >> 12);                            // Q15
      if (h0 > 0) {
        int32_t tmp1_s32 = static_cast<int32_t>(
            (static_cast<uint32_t>(noise_probability[0]) & 0xFFFFF000u) << 2);
        ngprvec[channel] = s16(div_w32_w16(tmp1_s32, h0));        // Q14
        ngprvec[channel + kNumChannels] = s16(16384 - ngprvec[channel]);
      } else {
        ngprvec[channel] = 16384;
      }
      int16_t h1 = s16(h1_test >> 12);                            // Q15
      if (h1 > 0) {
        int32_t tmp1_s32 = static_cast<int32_t>(
            (static_cast<uint32_t>(speech_probability[0]) & 0xFFFFF000u) << 2);
        sgprvec[channel] = s16(div_w32_w16(tmp1_s32, h1));        // Q14
        sgprvec[channel + kNumChannels] = s16(16384 - sgprvec[channel]);
      }
    }

    if (sum_log_likelihood_ratios >= total_test) vadflag |= 1;

    // Sequential model update.
    int16_t maxspe = 12800;
    for (int channel = 0; channel < kNumChannels; ++channel) {
      int16_t feature_minimum = find_minimum(st, features[channel], channel);

      int32_t noise_global_mean =
          weighted_average(st->noise_means, channel, 0, false);
      int16_t tmp1_s16 = s16(noise_global_mean >> 6);             // Q8

      for (int k = 0; k < 2; ++k) {
        int gaussian = channel + k * kNumChannels;
        int16_t nmk = st->noise_means[gaussian];
        int16_t smk = st->speech_means[gaussian];
        int16_t nsk = st->noise_stds[gaussian];
        int16_t ssk = st->speech_stds[gaussian];

        int16_t nmk2 = nmk;
        if (!vadflag) {
          int16_t delt = s16((ngprvec[gaussian] * delta_n[gaussian]) >> 11);
          nmk2 = s16(nmk + s16((delt * kNoiseUpdateConst) >> 22));
        }

        int16_t ndelt = s16(wrap_sub(wrap_shl(feature_minimum, 4),
                                     tmp1_s16));                  // Q8
        int16_t nmk3 = s16(nmk2 + s16((ndelt * kBackEta) >> 9));  // Q7

        int16_t tmp_s16 = s16((k + 5) << 7);
        if (nmk3 < tmp_s16) nmk3 = tmp_s16;
        tmp_s16 = s16((72 + k - channel) << 7);
        if (nmk3 > tmp_s16) nmk3 = tmp_s16;
        st->noise_means[gaussian] = nmk3;

        if (vadflag) {
          int16_t delt = s16((sgprvec[gaussian] * delta_s[gaussian]) >> 11);
          tmp_s16 = s16((delt * kSpeechUpdateConst) >> 21);       // Q8
          int16_t smk2 = s16(smk + ((tmp_s16 + 1) >> 1));         // Q7
          int16_t maxmu = s16(maxspe + 640);
          if (smk2 > maxmu) smk2 = maxmu;
          st->speech_means[gaussian] = smk2;

          tmp_s16 = s16((smk + 4) >> 3);                          // Q4
          tmp_s16 = s16(features[channel] - tmp_s16);             // Q4
          int32_t tmp1_s32 = (delta_s[gaussian] * tmp_s16) >> 3;  // Q12
          int32_t tmp2_s32 = tmp1_s32 - 4096;
          tmp_s16 = s16(sgprvec[gaussian] >> 2);
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
          st->speech_stds[gaussian] = ssk;
        } else {
          int16_t t16 = s16(features[channel] - (nmk >> 3));      // Q4
          int32_t tmp1_s32 = (delta_n[gaussian] * t16) >> 3;      // Q12
          int32_t tmp2_s32 = tmp1_s32 - 4096;
          t16 = s16((ngprvec[gaussian] + 2) >> 2);
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
          st->noise_stds[gaussian] = nsk;
        }
      }

      noise_global_mean =
          weighted_average(st->noise_means, channel, 0, false);
      int32_t speech_global_mean =
          weighted_average(st->speech_means, channel, 0, true);
      int16_t diff = s16(s16(speech_global_mean >> 9)
                         - s16(noise_global_mean >> 9));
      if (diff < kMinimumDifference[channel]) {
        int16_t tmp_s16 = s16(kMinimumDifference[channel] - diff);
        int16_t tmp1 = s16((13 * tmp_s16) >> 2);
        int16_t tmp2 = s16((3 * tmp_s16) >> 2);
        speech_global_mean =
            weighted_average(st->speech_means, channel, tmp1, true);
        noise_global_mean =
            weighted_average(st->noise_means, channel, s16(-tmp2), false);
      }

      maxspe = kMaximumSpeech[channel];
      int16_t tmp2_s16 = s16(speech_global_mean >> 7);
      if (tmp2_s16 > maxspe) {
        tmp2_s16 = s16(tmp2_s16 - maxspe);
        for (int k = 0; k < 2; ++k) {
          int g = channel + k * kNumChannels;
          st->speech_means[g] = s16(st->speech_means[g] - tmp2_s16);
        }
      }
      tmp2_s16 = s16(noise_global_mean >> 7);
      if (tmp2_s16 > kMaximumNoise[channel]) {
        tmp2_s16 = s16(tmp2_s16 - kMaximumNoise[channel]);
        for (int k = 0; k < 2; ++k) {
          int g = channel + k * kNumChannels;
          st->noise_means[g] = s16(st->noise_means[g] - tmp2_s16);
        }
      }
    }
    st->frame_counter = wrap_add(st->frame_counter, 1);
  }

  if (!vadflag) {
    if (st->over_hang > 0) {
      vadflag = s16(2 + st->over_hang);
      st->over_hang = s16(st->over_hang - 1);
    }
    st->num_of_speech = 0;
  } else {
    st->num_of_speech = s16(st->num_of_speech + 1);
    if (st->num_of_speech > kMaxSpeechFrames) {
      st->num_of_speech = kMaxSpeechFrames;
      st->over_hang = overhead2;
    } else {
      st->over_hang = overhead1;
    }
  }
  return vadflag;
}

// W1: x (B rows, row_stride apart) of T frames each; states (n_states, 265).
__global__ void webrtc_vad_kernel(const int16_t* __restrict__ x,
                                  long long row_stride, int B, int T,
                                  int frame_len, int rate16, int mode,
                                  int32_t* __restrict__ states, int n_states,
                                  const int32_t* __restrict__ idx,
                                  uint8_t* __restrict__ decisions) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  uint8_t* dec = decisions + static_cast<long long>(b) * T;
  int row = idx[b];
  if (row < 0 || row >= n_states) {
    for (int f = 0; f < T; ++f) dec[f] = 0;
    return;
  }
  int32_t* slots = states + static_cast<long long>(row) * kStateSlots;
  VadState st;
  load_state(&st, slots);
  const int16_t* samples = x + static_cast<long long>(b) * row_stride;
  int n8k = rate16 ? frame_len >> 1 : frame_len;
  int fl_index = n8k == 80 ? 0 : (n8k == 160 ? 1 : 2);
  int16_t nb[240];
  int16_t features[kNumChannels];
  for (int f = 0; f < T; ++f) {
    const int16_t* frame = samples + static_cast<long long>(f) * frame_len;
    if (rate16) {
      downsampling(frame, frame_len, nb, st.ds);
    } else {
      for (int i = 0; i < frame_len; ++i) nb[i] = __ldg(frame + i);
    }
    int16_t total_power = calculate_features(&st, nb, n8k, features);
    int16_t flag = gmm_probability(&st, features, total_power, fl_index, mode);
    dec[f] = flag > 0 ? 1 : 0;
  }
  store_state(&st, slots);
}

// W2: decisions (B, T) -> keep (B, T), kept frames (B,); frames at or past
// n_valid[b] do not exist.
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
                      int rows_per_block, cudaStream_t stream) {
  int blocks = (B + rows_per_block - 1) / rows_per_block;
  webrtc_vad_kernel<<<blocks, rows_per_block, 0, stream>>>(
      x, row_stride, B, T, frame_len, rate16, mode, states, n_states, idx,
      decisions);
  return static_cast<int>(cudaGetLastError());
}

int vad_collect_launch(const uint8_t* decisions, int B, int T,
                       const int32_t* n_valid, double thresh, int ring,
                       uint8_t* keep, int32_t* kept, cudaStream_t stream) {
  constexpr int kThreads = 128;
  int blocks = (B + kThreads - 1) / kThreads;
  vad_collect_kernel<<<blocks, kThreads, 0, stream>>>(
      decisions, B, T, n_valid, thresh, ring, keep, kept);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
