// Full WebRTC voice-activity detector, fixed-point, host-native.
//
// Why this exists alongside the JAX engine (mmla_audio_tpu/vad/webrtc.py):
// the filterbank is a cascade of sample-serial int16 IIRs.  On the TPU that
// work is dependency-chain-bound on the scalar path (~99 ms of a 102 ms
// B=1 engine step, measured by benchmarks/webrtc_profile.py; an 8-way scan
// unroll was neutral because the serial op count is invariant).  On the
// host CPU the same ~0.5M chained integer ops take well under a
// millisecond.  So: single-stream / offline host paths call this engine;
// batched device serving keeps the vmapped JAX engine where each scan step
// amortizes into a (B,)-lane VPU op.
//
// The algorithm is a line-for-line translation of the project's
// transcription golden (tests/golden/webrtc_vad_ref.py — WebRTC's
// published vad_core.c / vad_filterbank.c / vad_sp.c / vad_gaussian.c
// semantics, all published tables).  Bit-parity against the golden AND the
// JAX engine is pinned by tests/test_vad_native.py.  Compile with -fwrapv:
// the golden's s32()/s16() wraps rely on two's-complement wraparound.
//
// Reference behavior served: webrtcvad.Vad(3) at
// /root/reference/OverlapDetection/scripts/record_on_pc.py:33,229-295.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kNumChannels = 6;
constexpr int kNumGaussians = 2;
constexpr int kTableSize = kNumChannels * kNumGaussians;

// vad_core.c tables.
constexpr int16_t kSpectrumWeight[kNumChannels] = {6, 8, 10, 12, 14, 16};
constexpr int16_t kNoiseUpdateConst = 655;     // Q15
constexpr int16_t kSpeechUpdateConst = 6554;   // Q15
constexpr int16_t kBackEta = 154;              // Q8
constexpr int16_t kMinimumDifference[kNumChannels] = {
    544, 544, 576, 576, 576, 576};             // Q5
constexpr int16_t kMaximumSpeech[kNumChannels] = {
    11392, 11392, 11520, 11520, 11520, 11520}; // Q7
constexpr int16_t kMaximumNoise[kNumChannels] = {
    9216, 9088, 8960, 8832, 8704, 8576};       // Q7
constexpr int16_t kNoiseDataWeights[kTableSize] = {
    34, 62, 72, 66, 53, 25, 94, 66, 56, 62, 75, 103};
constexpr int16_t kSpeechDataWeights[kTableSize] = {
    48, 82, 45, 87, 50, 47, 80, 46, 83, 41, 78, 81};
constexpr int16_t kNoiseDataMeans[kTableSize] = {
    6738, 4892, 7065, 6715, 6771, 3369, 7646, 3863, 7820, 7266, 5020, 4362};
constexpr int16_t kSpeechDataMeans[kTableSize] = {
    8306, 10085, 10078, 11823, 11843, 6309,
    9473, 9571, 10879, 7581, 8180, 7483};
constexpr int16_t kNoiseDataStds[kTableSize] = {
    378, 1064, 493, 582, 688, 593, 474, 697, 475, 688, 421, 455};
constexpr int16_t kSpeechDataStds[kTableSize] = {
    555, 505, 567, 524, 585, 1231, 509, 828, 492, 1540, 1079, 850};
constexpr int16_t kMaxSpeechFrames = 6;
constexpr int16_t kMinStd = 384;
constexpr int16_t kMinEnergy = 10;

// Mode thresholds, indexed [10 ms, 20 ms, 30 ms].
constexpr int16_t kOverHangMax1[4][3] = {
    {8, 4, 3}, {8, 4, 3}, {6, 3, 2}, {6, 3, 2}};
constexpr int16_t kOverHangMax2[4][3] = {
    {14, 7, 5}, {14, 7, 5}, {9, 5, 3}, {9, 5, 3}};
constexpr int16_t kLocalThreshold[4][3] = {
    {24, 21, 24}, {37, 32, 37}, {82, 78, 82}, {94, 94, 94}};
constexpr int16_t kGlobalThreshold[4][3] = {
    {57, 48, 57}, {100, 80, 100}, {285, 260, 285}, {1100, 1050, 1100}};

// vad_filterbank.c.
constexpr int16_t kLogConst = 24660;           // 160*log10(2), Q9
constexpr int16_t kLogEnergyIntPart = 14336;   // 14 in Q10
constexpr int16_t kHpZeroCoefs[3] = {6631, -13262, 6631};   // Q14
constexpr int16_t kHpPoleCoefs[3] = {16384, -7756, 5620};   // Q14
constexpr int16_t kAllPassCoefsQ15[2] = {20972, 5571};      // 0.64, 0.17
constexpr int16_t kOffsetVector[kNumChannels] = {368, 368, 272, 176, 176, 176};

// vad_sp.c.
constexpr int16_t kAllPassCoefsQ13[2] = {5243, 1392};       // 0.64, 0.17
constexpr int16_t kSmoothingDown = 6553;       // 0.2, Q15
constexpr int16_t kSmoothingUp = 32439;        // 0.99, Q15

// vad_gaussian.c.
constexpr int16_t kCompVar = 22005;
constexpr int16_t kLog2Exp = 5909;             // log2(e), Q12

inline int16_t s16(int32_t x) { return static_cast<int16_t>(x); }

inline int32_t div_w32_w16(int32_t num, int32_t den) {
  // WebRtcSpl_DivW32W16: C integer division truncates toward zero.
  if (den == 0) return 0x7FFFFFFF;
  return num / den;
}

inline int norm_w32(int32_t a) {
  // WebRtcSpl_NormW32 (0 for 0).
  if (a == 0) return 0;
  uint32_t v = static_cast<uint32_t>(a < 0 ? ~a : a);
  if (v == 0) return 31;                       // a == -1
  int b = 0;
  while (v >> b) ++b;                          // bit_length
  return 31 - b;
}

inline int norm_u32(uint32_t a) {
  if (a == 0) return 0;
  int b = 0;
  while (a >> b) ++b;
  return 32 - b;
}

struct VadInst {
  int32_t vad;
  int32_t frame_counter;
  int16_t over_hang;
  int16_t num_of_speech;
  int32_t downsampling_filter_states[2];
  int16_t noise_means[kTableSize];
  int16_t speech_means[kTableSize];
  int16_t noise_stds[kTableSize];
  int16_t speech_stds[kTableSize];
  int16_t low_value_vector[16 * kNumChannels];
  int16_t index_vector[16 * kNumChannels];
  int16_t upper_state[5];
  int16_t lower_state[5];
  int16_t hp_filter_state[4];
  int16_t mean_value[kNumChannels];
  int16_t over_hang_max_1[3];
  int16_t over_hang_max_2[3];
  int16_t individual[3];
  int16_t total[3];
};

void set_mode(VadInst* st, int mode) {
  for (int i = 0; i < 3; ++i) {
    st->over_hang_max_1[i] = kOverHangMax1[mode][i];
    st->over_hang_max_2[i] = kOverHangMax2[mode][i];
    st->individual[i] = kLocalThreshold[mode][i];
    st->total[i] = kGlobalThreshold[mode][i];
  }
}

void init_core(VadInst* st, int mode) {
  std::memset(st, 0, sizeof(VadInst));
  st->vad = 1;
  std::memcpy(st->noise_means, kNoiseDataMeans, sizeof(kNoiseDataMeans));
  std::memcpy(st->speech_means, kSpeechDataMeans, sizeof(kSpeechDataMeans));
  std::memcpy(st->noise_stds, kNoiseDataStds, sizeof(kNoiseDataStds));
  std::memcpy(st->speech_stds, kSpeechDataStds, sizeof(kSpeechDataStds));
  for (int i = 0; i < 16 * kNumChannels; ++i) {
    st->low_value_vector[i] = 10000;
    st->index_vector[i] = 100;
  }
  for (int i = 0; i < kNumChannels; ++i) st->mean_value[i] = 1600;
  set_mode(st, mode);
}

// --- vad_gaussian.c ---------------------------------------------------------

int32_t gaussian_probability(int16_t inp, int16_t mean, int16_t std,
                             int16_t* delta) {
  int32_t tmp32 = 131072 + (std >> 1);
  int16_t inv_std = s16(div_w32_w16(tmp32, std));          // Q10
  int16_t tmp16 = inv_std >> 2;                            // Q8
  int16_t inv_std2 = s16((tmp16 * tmp16) >> 2);            // Q14
  tmp16 = s16(inp << 3);                                   // Q7
  tmp16 = s16(tmp16 - mean);                               // Q7
  *delta = s16((inv_std2 * tmp16) >> 10);                  // Q11
  tmp32 = (*delta * tmp16) >> 9;                           // Q10
  int32_t exp_value = 0;
  if (tmp32 < kCompVar) {
    tmp16 = s16((kLog2Exp * tmp32) >> 12);                 // Q10
    tmp16 = s16(-tmp16);
    exp_value = 0x0400 | (tmp16 & 0x03FF);
    tmp16 = s16(~tmp16);
    tmp16 >>= 10;
    tmp16 = s16(tmp16 + 1);
    exp_value >>= tmp16;
  }
  return inv_std * exp_value;                              // Q20
}

// --- vad_sp.c ---------------------------------------------------------------

void downsampling(const int16_t* in, int n, int16_t* out, int32_t* state) {
  int32_t tmp32_1 = state[0];
  int32_t tmp32_2 = state[1];
  int half = n >> 1;
  for (int i = 0; i < half; ++i) {
    int32_t x0 = in[2 * i];
    int32_t x1 = in[2 * i + 1];
    int16_t t1 = s16((tmp32_1 >> 1) + ((kAllPassCoefsQ13[0] * x0) >> 14));
    out[i] = t1;
    tmp32_1 = x0 - ((kAllPassCoefsQ13[0] * t1) >> 12);
    int16_t t2 = s16((tmp32_2 >> 1) + ((kAllPassCoefsQ13[1] * x1) >> 14));
    out[i] = s16(out[i] + t2);
    tmp32_2 = x1 - ((kAllPassCoefsQ13[1] * t2) >> 12);
  }
  state[0] = tmp32_1;
  state[1] = tmp32_2;
}

int16_t find_minimum(VadInst* st, int16_t feature_value, int channel) {
  int offset = channel << 4;
  int16_t* age = st->index_vector + offset;
  int16_t* smallest = st->low_value_vector + offset;
  int16_t current_median = 1600;
  int16_t alpha = 0;

  for (int i = 0; i < 16; ++i) {
    if (age[i] != 100) {
      age[i] += 1;
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
  int32_t tmp32 = (alpha + 1) * st->mean_value[channel];
  tmp32 += (32767 - alpha) * current_median;
  tmp32 += 16384;
  st->mean_value[channel] = s16(tmp32 >> 15);
  return st->mean_value[channel];
}

// --- vad_filterbank.c -------------------------------------------------------

void all_pass_filter_out(const int16_t* in, int stride_offset, int length,
                         int16_t coef, int16_t* state, int16_t* out) {
  int32_t state32 = static_cast<int32_t>(*state) * (1 << 16);     // Q15
  for (int i = 0; i < length; ++i) {
    int32_t x = in[stride_offset + 2 * i];
    int32_t tmp32 = state32 + coef * x;
    int16_t tmp16 = s16(tmp32 >> 16);                             // Q(-1)
    out[i] = tmp16;
    state32 = x * (1 << 14) - coef * tmp16;                       // Q14
    state32 *= 2;                                                 // Q15
  }
  *state = s16(state32 >> 16);
}

void split_filter(const int16_t* in, int n, int16_t* state_u, int16_t* state_l,
                  int16_t* hp, int16_t* lp) {
  int half = n >> 1;
  all_pass_filter_out(in, 0, half, kAllPassCoefsQ15[0], state_u, hp);
  all_pass_filter_out(in, 1, half, kAllPassCoefsQ15[1], state_l, lp);
  for (int i = 0; i < half; ++i) {
    int16_t tmp = hp[i];
    hp[i] = s16(hp[i] - lp[i]);
    lp[i] = s16(lp[i] + tmp);
  }
}

void high_pass_filter(const int16_t* in, int n, int16_t* state, int16_t* out) {
  for (int i = 0; i < n; ++i) {
    int32_t x = in[i];
    int32_t tmp32 = kHpZeroCoefs[0] * x;
    tmp32 += kHpZeroCoefs[1] * state[0];
    tmp32 += kHpZeroCoefs[2] * state[1];
    state[1] = state[0];
    state[0] = s16(x);
    tmp32 -= kHpPoleCoefs[1] * state[2];
    tmp32 -= kHpPoleCoefs[2] * state[3];
    state[3] = state[2];
    state[2] = s16(tmp32 >> 14);
    out[i] = state[2];
  }
}

int get_scaling_square(const int16_t* v, int n) {
  int nbits = 0;
  while (n >> nbits) ++nbits;                  // len(vector).bit_length()
  int32_t smax = 0;
  for (int i = 0; i < n; ++i) {
    int32_t sabs = v[i] > 0 ? v[i] : -v[i];
    if (sabs > smax) smax = sabs;
  }
  if (smax == 0) return 0;
  int t = norm_w32(smax * smax);
  return t > nbits ? 0 : nbits - t;
}

int32_t energy(const int16_t* v, int n, int* scaling) {
  *scaling = get_scaling_square(v, n);
  int32_t en = 0;
  for (int i = 0; i < n; ++i) en += (v[i] * v[i]) >> *scaling;
  return en;
}

int16_t log_of_energy(const int16_t* data, int n, int16_t offset,
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
    log2_energy = s16(log2_energy + ((en & 0x00003FFFu) >> 4));   // Q10
    int16_t log_energy = s16(((kLogConst * log2_energy) >> 19)
                             + ((tot_rshifts * kLogConst) >> 9));
    if (log_energy < 0) log_energy = 0;
    log_energy = s16(log_energy + offset);
    if (*total_energy <= kMinEnergy) {
      if (tot_rshifts >= 0) {
        *total_energy = s16(*total_energy + kMinEnergy + 1);
      } else {
        *total_energy =
            s16(*total_energy + s16(static_cast<int32_t>(en >> -tot_rshifts)));
      }
    }
    return log_energy;
  }
  return offset;
}

int16_t calculate_features(VadInst* st, const int16_t* data_in, int n,
                           int16_t* features) {
  int16_t total_energy = 0;
  int16_t buf_hp[120], buf_lp[120];
  int16_t buf2_hp[60], buf2_lp[60];
  int16_t buf3_hp[30], buf3_lp[30];
  int16_t buf4_hp[15], buf4_lp[15];
  int16_t hp80[15];

  // Split at 2000 Hz and downsample.
  split_filter(data_in, n, &st->upper_state[0], &st->lower_state[0],
               buf_hp, buf_lp);
  int half = n >> 1;
  // Upper band: split at 3000 Hz.
  split_filter(buf_hp, half, &st->upper_state[1], &st->lower_state[1],
               buf2_hp, buf2_lp);
  features[5] = log_of_energy(buf2_hp, half >> 1, kOffsetVector[5],
                              &total_energy);
  features[4] = log_of_energy(buf2_lp, half >> 1, kOffsetVector[4],
                              &total_energy);
  // Lower band: split at 1000 Hz.
  split_filter(buf_lp, half, &st->upper_state[2], &st->lower_state[2],
               buf2_hp, buf2_lp);
  features[3] = log_of_energy(buf2_hp, half >> 1, kOffsetVector[3],
                              &total_energy);
  // Split at 500 Hz.
  split_filter(buf2_lp, half >> 1, &st->upper_state[3], &st->lower_state[3],
               buf3_hp, buf3_lp);
  features[2] = log_of_energy(buf3_hp, half >> 2, kOffsetVector[2],
                              &total_energy);
  // Split at 250 Hz.
  split_filter(buf3_lp, half >> 2, &st->upper_state[4], &st->lower_state[4],
               buf4_hp, buf4_lp);
  features[1] = log_of_energy(buf4_hp, half >> 3, kOffsetVector[1],
                              &total_energy);
  // Remove 0-80 Hz.
  high_pass_filter(buf4_lp, half >> 3, st->hp_filter_state, hp80);
  features[0] = log_of_energy(hp80, half >> 3, kOffsetVector[0],
                              &total_energy);
  return total_energy;
}

// --- vad_core.c -------------------------------------------------------------

int32_t weighted_average(int16_t* data, int channel, int16_t offset,
                         const int16_t* weights) {
  int32_t result = 0;
  for (int k = 0; k < kNumGaussians; ++k) {
    int g = channel + k * kNumChannels;
    data[g] = s16(data[g] + offset);
    result += data[g] * weights[g];
  }
  return result;
}

int16_t gmm_probability(VadInst* st, const int16_t* features,
                        int16_t total_power, int frame_length) {
  int16_t vadflag = 0;
  int16_t delta_n[kTableSize] = {0};
  int16_t delta_s[kTableSize] = {0};
  int16_t ngprvec[kTableSize] = {0};
  int16_t sgprvec[kTableSize] = {0};

  int fl_index = frame_length == 80 ? 0 : (frame_length == 160 ? 1 : 2);
  int16_t overhead1 = st->over_hang_max_1[fl_index];
  int16_t overhead2 = st->over_hang_max_2[fl_index];
  int16_t individual_test = st->individual[fl_index];
  int16_t total_test = st->total[fl_index];

  if (total_power > kMinEnergy) {
    int32_t sum_log_likelihood_ratios = 0;
    int32_t noise_probability[kNumGaussians];
    int32_t speech_probability[kNumGaussians];
    for (int channel = 0; channel < kNumChannels; ++channel) {
      int32_t h0_test = 0;
      int32_t h1_test = 0;
      for (int k = 0; k < kNumGaussians; ++k) {
        int gaussian = channel + k * kNumChannels;
        int32_t prob = gaussian_probability(
            features[channel], st->noise_means[gaussian],
            st->noise_stds[gaussian], &delta_n[gaussian]);
        noise_probability[k] = kNoiseDataWeights[gaussian] * prob;
        h0_test += noise_probability[k];                          // Q27
        prob = gaussian_probability(
            features[channel], st->speech_means[gaussian],
            st->speech_stds[gaussian], &delta_s[gaussian]);
        speech_probability[k] = kSpeechDataWeights[gaussian] * prob;
        h1_test += speech_probability[k];                         // Q27
      }
      int shifts_h0 = h0_test == 0 ? 31 : norm_w32(h0_test);
      int shifts_h1 = h1_test == 0 ? 31 : norm_w32(h1_test);
      int16_t log_likelihood_ratio = s16(shifts_h0 - shifts_h1);

      sum_log_likelihood_ratios +=
          log_likelihood_ratio * kSpectrumWeight[channel];
      if ((log_likelihood_ratio * 4) > individual_test) vadflag = 1;

      int16_t h0 = s16(h0_test >> 12);                            // Q15
      if (h0 > 0) {
        int32_t tmp1_s32 = (noise_probability[0] & 0xFFFFF000) << 2;
        ngprvec[channel] = s16(div_w32_w16(tmp1_s32, h0));        // Q14
        ngprvec[channel + kNumChannels] = s16(16384 - ngprvec[channel]);
      } else {
        ngprvec[channel] = 16384;
      }
      int16_t h1 = s16(h1_test >> 12);                            // Q15
      if (h1 > 0) {
        int32_t tmp1_s32 = (speech_probability[0] & 0xFFFFF000) << 2;
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
          weighted_average(st->noise_means, channel, 0, kNoiseDataWeights);
      int16_t tmp1_s16 = s16(noise_global_mean >> 6);             // Q8

      for (int k = 0; k < kNumGaussians; ++k) {
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

        int16_t ndelt = s16((feature_minimum << 4) - tmp1_s16);   // Q8
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
          tmp_s16 = sgprvec[gaussian] >> 2;
          tmp1_s32 = tmp_s16 * tmp2_s32;                          // Q24
          tmp2_s32 = tmp1_s32 >> 4;                               // Q20
          if (tmp2_s32 > 0) {
            tmp_s16 = s16(div_w32_w16(tmp2_s32, ssk * 10));
          } else {
            tmp_s16 = s16(div_w32_w16(-tmp2_s32, ssk * 10));
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
          t16 = (ngprvec[gaussian] + 2) >> 2;
          tmp2_s32 = t16 * tmp2_s32;                              // Q24
          tmp1_s32 = tmp2_s32 >> 14;                              // Q20
          if (tmp1_s32 > 0) {
            t16 = s16(div_w32_w16(tmp1_s32, nsk));
          } else {
            t16 = s16(div_w32_w16(-tmp1_s32, nsk));
            t16 = s16(-t16);
          }
          t16 = s16(t16 + 32);
          nsk = s16(nsk + (t16 >> 6));
          if (nsk < kMinStd) nsk = kMinStd;
          st->noise_stds[gaussian] = nsk;
        }
      }

      noise_global_mean =
          weighted_average(st->noise_means, channel, 0, kNoiseDataWeights);
      int32_t speech_global_mean =
          weighted_average(st->speech_means, channel, 0, kSpeechDataWeights);
      int16_t diff = s16(s16(speech_global_mean >> 9)
                         - s16(noise_global_mean >> 9));
      if (diff < kMinimumDifference[channel]) {
        int16_t tmp_s16 = s16(kMinimumDifference[channel] - diff);
        int16_t tmp1_s16 = s16((13 * tmp_s16) >> 2);
        int16_t tmp2_s16 = s16((3 * tmp_s16) >> 2);
        speech_global_mean = weighted_average(
            st->speech_means, channel, tmp1_s16, kSpeechDataWeights);
        noise_global_mean = weighted_average(
            st->noise_means, channel, s16(-tmp2_s16), kNoiseDataWeights);
      }

      maxspe = kMaximumSpeech[channel];
      int16_t tmp2_s16 = s16(speech_global_mean >> 7);
      if (tmp2_s16 > maxspe) {
        tmp2_s16 = s16(tmp2_s16 - maxspe);
        for (int k = 0; k < kNumGaussians; ++k) {
          int g = channel + k * kNumChannels;
          st->speech_means[g] = s16(st->speech_means[g] - tmp2_s16);
        }
      }
      tmp2_s16 = s16(noise_global_mean >> 7);
      if (tmp2_s16 > kMaximumNoise[channel]) {
        tmp2_s16 = s16(tmp2_s16 - kMaximumNoise[channel]);
        for (int k = 0; k < kNumGaussians; ++k) {
          int g = channel + k * kNumChannels;
          st->noise_means[g] = s16(st->noise_means[g] - tmp2_s16);
        }
      }
    }
    st->frame_counter += 1;
  }

  if (!vadflag) {
    if (st->over_hang > 0) {
      vadflag = s16(2 + st->over_hang);
      st->over_hang -= 1;
    }
    st->num_of_speech = 0;
  } else {
    st->num_of_speech += 1;
    if (st->num_of_speech > kMaxSpeechFrames) {
      st->num_of_speech = kMaxSpeechFrames;
      st->over_hang = overhead2;
    } else {
      st->over_hang = overhead1;
    }
  }
  return vadflag;
}

int16_t calc_vad_8khz(VadInst* st, const int16_t* frame, int n) {
  int16_t features[kNumChannels];
  int16_t total_power = calculate_features(st, frame, n, features);
  st->vad = gmm_probability(st, features, total_power, n);
  return static_cast<int16_t>(st->vad);
}

// State export layout (int32 per slot), matching the JAX WebRtcVadState
// field order so cross-engine state equivalence is testable directly:
// ds(2) upper(5) lower(5) hp(4) nm(12) sm(12) ns(12) ss(12)
// low_values(96) ages(96) mean_value(6) frame_counter over_hang
// num_of_speech  => 265 slots.
constexpr int kStateSlots = 265;

}  // namespace

extern "C" {

void* wv_create(int mode) {
  if (mode < 0 || mode > 3) return nullptr;
  VadInst* st = new VadInst;
  init_core(st, mode);
  return st;
}

void wv_destroy(void* inst) { delete static_cast<VadInst*>(inst); }

int wv_set_mode(void* inst, int mode) {
  if (mode < 0 || mode > 3) return -1;
  set_mode(static_cast<VadInst*>(inst), mode);
  return 0;
}

// Per-frame decisions over contiguous frames; returns number of frames
// processed, or -1 on invalid frame geometry.  ``decisions`` gets the raw
// vadflag (0 = non-speech, >0 = speech, matching is_speech(...) > 0).
int64_t wv_process(void* inst, const int16_t* samples, int64_t n_samples,
                   int frame_len, int sample_rate, uint8_t* decisions) {
  VadInst* st = static_cast<VadInst*>(inst);
  bool rate16 = sample_rate == 16000;
  if (!rate16 && sample_rate != 8000) return -1;
  if (rate16) {
    if (frame_len != 160 && frame_len != 320 && frame_len != 480) return -1;
  } else {
    if (frame_len != 80 && frame_len != 160 && frame_len != 240) return -1;
  }
  int64_t n_frames = n_samples / frame_len;
  int16_t nb[240];
  for (int64_t f = 0; f < n_frames; ++f) {
    const int16_t* frame = samples + f * frame_len;
    int16_t flag;
    if (rate16) {
      downsampling(frame, frame_len, nb, st->downsampling_filter_states);
      flag = calc_vad_8khz(st, nb, frame_len >> 1);
    } else {
      flag = calc_vad_8khz(st, frame, frame_len);
    }
    decisions[f] = flag > 0 ? 1 : 0;
  }
  return n_frames;
}

int wv_state_slots(void) { return kStateSlots; }

void wv_get_state(void* inst, int32_t* out) {
  VadInst* st = static_cast<VadInst*>(inst);
  int i = 0;
  for (int j = 0; j < 2; ++j) out[i++] = st->downsampling_filter_states[j];
  for (int j = 0; j < 5; ++j) out[i++] = st->upper_state[j];
  for (int j = 0; j < 5; ++j) out[i++] = st->lower_state[j];
  for (int j = 0; j < 4; ++j) out[i++] = st->hp_filter_state[j];
  for (int j = 0; j < kTableSize; ++j) out[i++] = st->noise_means[j];
  for (int j = 0; j < kTableSize; ++j) out[i++] = st->speech_means[j];
  for (int j = 0; j < kTableSize; ++j) out[i++] = st->noise_stds[j];
  for (int j = 0; j < kTableSize; ++j) out[i++] = st->speech_stds[j];
  for (int j = 0; j < 96; ++j) out[i++] = st->low_value_vector[j];
  for (int j = 0; j < 96; ++j) out[i++] = st->index_vector[j];
  for (int j = 0; j < kNumChannels; ++j) out[i++] = st->mean_value[j];
  out[i++] = st->frame_counter;
  out[i++] = st->over_hang;
  out[i++] = st->num_of_speech;
}

void wv_set_state(void* inst, const int32_t* in) {
  VadInst* st = static_cast<VadInst*>(inst);
  int i = 0;
  for (int j = 0; j < 2; ++j) st->downsampling_filter_states[j] = in[i++];
  for (int j = 0; j < 5; ++j) st->upper_state[j] = s16(in[i++]);
  for (int j = 0; j < 5; ++j) st->lower_state[j] = s16(in[i++]);
  for (int j = 0; j < 4; ++j) st->hp_filter_state[j] = s16(in[i++]);
  for (int j = 0; j < kTableSize; ++j) st->noise_means[j] = s16(in[i++]);
  for (int j = 0; j < kTableSize; ++j) st->speech_means[j] = s16(in[i++]);
  for (int j = 0; j < kTableSize; ++j) st->noise_stds[j] = s16(in[i++]);
  for (int j = 0; j < kTableSize; ++j) st->speech_stds[j] = s16(in[i++]);
  for (int j = 0; j < 96; ++j) st->low_value_vector[j] = s16(in[i++]);
  for (int j = 0; j < 96; ++j) st->index_vector[j] = s16(in[i++]);
  for (int j = 0; j < kNumChannels; ++j) st->mean_value[j] = s16(in[i++]);
  st->frame_counter = in[i++];
  st->over_hang = s16(in[i++]);
  st->num_of_speech = s16(in[i++]);
}

}  // extern "C"
