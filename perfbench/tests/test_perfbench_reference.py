"""The frozen reference against the program's plain versions at small
sizes on the CPU, and the vectorised detector against the pure-Python
transcription of WebRTC's VAD.  (The tests may import the program; the
reference may not.)"""

import sys

import numpy as np
import pytest
import torch

from perfbench import gen
from perfbench.reference import chain, overlap, speaker
from perfbench.reference.webrtc import WebRtcRows
from perfbench.tests.conftest import REPO

sys.path.insert(0, str(REPO / "tests" / "golden"))

OVERLAP_MODEL = dict(input_scale=1.0, stem_filters=16,
                     stage_filters=[32, 64, 128], blocks_per_stage=3,
                     lstm_units=256, num_classes=2, bn_eps=1e-3)
OVERLAP_FEATURE = dict(sample_rate=16000, win_ms=25.0, hop_ms=10.0,
                       n_mels=128, time_dim=150)
SPEAKER_MODEL = dict(stem_filters=32, stem_kernel=4,
                     stage_filters=[32, 64, 128], blocks_per_stage=3,
                     lstm_units=256, avg_pool=4, bn_eps=1e-3, head_units=4)
SPEAKER_FEATURE = dict(sample_rate=16000, win_ms=25.0, hop_ms=10.0,
                       n_fft=512, n_filt=26, n_cep=13, ceplifter=22,
                       preemph=0.97, delta_n=2, max_frames=256)


def signals(rows, n, seed=0):
    """int16 test signals: quiet noise, gated noise bursts, clipped noise,
    a gated tone, silence, full-scale square noise."""
    r = np.random.RandomState(seed)
    t = np.arange(n)
    x = np.stack([r.randn(n) * 30,
                  r.randn(n) * 3000 * (np.sin(t / 3000) > 0),
                  np.clip(r.randn(n) * 20000, -32768, 32767),
                  (np.sin(2 * np.pi * 200 * t / 16000) * 8000
                   + r.randn(n) * 100) * (np.sin(t / 5000) > -0.3),
                  np.zeros(n),
                  np.where(r.rand(n) < 0.5, 32767, -32768)])
    return np.resize(x, (rows, n)).astype(np.int16)


def test_webrtc_rows_match_the_transcription_bit_for_bit():
    from webrtc_vad_ref import WebRtcVadRef

    x = signals(6, 480 * 40 * 2).astype(np.int64)
    refs = [WebRtcVadRef(3) for _ in range(6)]
    rows = WebRtcRows(6, 3)
    for half in (slice(0, 480 * 40), slice(480 * 40, None)):
        got = rows.decisions(x[:, half])
        want = np.array([[refs[r].is_speech(x[r, half][i * 480:(i + 1) * 480])
                          for i in range(40)] for r in range(6)])
        np.testing.assert_array_equal(got, want)
    for r, ref in enumerate(refs):
        one = rows.take([r])
        assert one.noise_means[0].ravel().tolist() == ref.noise_means
        assert one.speech_stds[0].ravel().tolist() == ref.speech_stds
        assert one.low_value[0].ravel().tolist() == ref.low_value_vector
        assert one.age[0].ravel().tolist() == ref.index_vector
        assert one.ds_state[0].tolist() == ref.downsampling_filter_states
        assert one.hp[0].tolist() == ref.hp_filter_state
        assert int(one.over_hang[0]) == ref.over_hang


def test_webrtc_rows_match_the_programs_engine():
    from mmla_audio_torch.vad.native import NativeWebRtcVad, native_available

    if not native_available():
        pytest.skip("the program's host engine does not build here")
    x = signals(6, 480 * 85, seed=3)
    rows = WebRtcRows(6, 3)
    got = rows.decisions(x)
    for r in range(6):
        want = NativeWebRtcVad(3).decisions(x[r], frame_len=480,
                                            sample_rate=16000)
        np.testing.assert_array_equal(got[r], want)


def test_chain_matches_the_programs_plain_chain():
    """Denoise (within one int16 step of the program's float64 plain
    chain on a few samples), collector and trim (exactly)."""
    from mmla_audio_torch.core.config import DenoiseConfig
    from mmla_audio_torch.ops.denoise import (noise_threshold, quantize_i16,
                                              reduce_noise_plain)
    from mmla_audio_torch.vad.collector import vad_trim

    pool = gen.conversations(7, 2, 6.0)
    raw = np.stack([pool.samples(0, 1000, 40960), pool.samples(1, 0, 40960)])
    noise = pool.noise[int(pool.profile[0])]
    thr = chain.noise_threshold(noise, "cpu")
    got = chain.denoise(raw, thr.expand(2, -1), "cpu")
    cfg = DenoiseConfig()
    nt = noise_threshold(torch.from_numpy(noise.astype(np.float64) / 32768),
                         cfg)
    want = quantize_i16(reduce_noise_plain(
        torch.from_numpy(raw.astype(np.float64) / 32768), nt, cfg)).numpy()
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    dec = WebRtcRows(2).decisions(got[:, :85 * 480])
    trimmed, kept = chain.trim(got, chain.collector_keep(dec))
    for r in range(2):
        t, k = vad_trim(torch.from_numpy(got[r].astype(np.float32)), 40960,
                        torch.from_numpy(dec[r]))
        assert k == kept[r]
        np.testing.assert_array_equal(t.numpy(), trimmed[r].astype(np.float32))


def test_overlap_image_and_model_match_the_program():
    from mmla_audio_torch.core.config import OverlapModelConfig
    from mmla_audio_torch.models.overlap import OverlapResBLSTM
    from mmla_audio_torch.ops.features import overlap_model_input

    pool = gen.conversations(8, 2, 4.0)
    win = np.stack([pool.samples(0, 0, 40960), pool.samples(1, 5, 40960)])
    win[1, 30000:] = 0                      # a trimmed window's zeros
    got = overlap.image(win, OVERLAP_FEATURE, "cpu")
    want = overlap_model_input(torch.from_numpy(
        win[:, :24000].astype(np.float32) / 32768.0))
    d = (got - want).abs()
    assert d.max() <= 1 and (d > 0).float().mean() < 0.005
    spec = overlap.param_spec(OVERLAP_MODEL)
    sd = gen.weights(spec, 11, "cpu")
    model = OverlapResBLSTM(OverlapModelConfig())
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(s) for k, (s, _) in spec.items()}
    model.load_state_dict(sd)
    model.eval()
    with torch.no_grad():
        ref = overlap.forward(sd, want, OVERLAP_MODEL)
        prog = model(want)
    assert float((ref - prog).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_speaker_features_and_model_match_the_program():
    from mmla_audio_torch.core.config import SpeakerModelConfig
    from mmla_audio_torch.models.speaker import SpeakerResBLSTM
    from mmla_audio_torch.ops.features import speaker_feature_batch

    pool = gen.conversations(9, 2, 4.0)
    win = np.stack([pool.samples(0, 0, 40960), pool.samples(1, 0, 40960)])
    kept = np.array([40800, 12000])
    win[1, 12000:] = 0
    got = speaker.features(win, kept, SPEAKER_FEATURE, "cpu")
    want, _ = speaker_feature_batch(torch.from_numpy(win.astype(np.float32)),
                                    torch.from_numpy(kept))
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())
    spec = speaker.param_spec(SPEAKER_MODEL)
    sd = gen.weights(spec, 12, "cpu")
    model = SpeakerResBLSTM(SpeakerModelConfig(), head_units=4)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(s) for k, (s, _) in spec.items()}
    model.load_state_dict(sd)
    model.eval()
    with torch.no_grad():
        ref = speaker.forward(sd, want, SPEAKER_MODEL)
        prog = model(want)
    assert float((ref - prog).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_fused_block_gap_separates_its_stated_precision_from_one_tf32_pass():
    """The program's plain fused block against the reference's on the same
    input reads at fp32 rounding; with its operands rounded to TF32, as one
    TF32 pass reads them, and in bfloat16, far above."""
    import json

    from mmla_audio_torch.ops.cuda_resblock import fused_resblock_plain

    from perfbench.reference.overlap import tf32_round
    from perfbench.system import System
    from perfbench.tests.conftest import REPO as root

    config = json.loads((root / "perfbench" / "configs" / "overlap.json")
                        .read_text())
    system = System(config, 2 ** 35 + 3, "cpu")
    g = torch.Generator().manual_seed(0)
    sound, tf32 = [], []
    fused = [b for b in system.pred.model.blocks if not b.pool]
    shapes = [(32, 64, 76)] * 2 + [(64, 32, 38)] * 2 + [(128, 16, 19)] * 2
    for blk, shape in zip(fused, shapes):
        x = torch.randn((1,) + shape, generator=g)
        ops = blk.fused_operands()
        sound.append((x[0], fused_resblock_plain(x, *ops)[0]))
        tf32.append((x[0], fused_resblock_plain(
            tf32_round(x), *[tf32_round(o) if o.ndim == 4 else o
                             for o in ops])[0]))
    limit = config["limits"]["b3_gap"]
    assert max(system.block_gaps({(0, 0): sound})) < limit / 100
    assert max(system.block_gaps({(0, 0): tf32})) > 3 * limit
    assert max(system.block_gaps({(0, 0): sound}, "bf16")) > 30 * limit
