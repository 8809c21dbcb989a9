"""The port's GMM VAD (``mmla_audio_torch/vad/gmm.py``) against the JAX
package's (``mmla_audio_tpu/vad/gmm.py``) on the CPU, where ``gmm_vad``
takes the plain frame loop (G1, its CUDA kernel, is held against that loop
in ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 12).

Inputs are made with numpy from seeds and go through both packages:

* the filterbank's FIR taps against the IIR recursion (atol 1e-9, as
  ``tests/test_vad_gmm.py``); ``band_log_energies`` on speech, noise and
  the six pure tones of ``test_band_routing``, the same loudest band, every
  band within 60 dB of its frame's loudest at rtol 1e-5, atol 1e-4 dB (the
  64-tap sums run in another order), and every band's linear energy within
  1e-5 of the loudest band's.  A pure tone's stop bands lie 100 to 190 dB
  below its band: their FIR outputs are cancellations whose fp32 rounding
  scales with the tone, so the two packages there differ by up to 0.05 dB,
  as far as either lies from the same filterbank in float64 (JAX up to
  0.03 dB);
* ``gmm_init_from_noise`` (atol 1e-4);
* ``gmm_vad`` through ``params.gmm_state_from_numpy`` at ``adapt`` True
  and False and aggressiveness 0-3: decisions equal wherever the margins
  (|weighted log-LR - its threshold| and |max band log-LR - its
  threshold|, from the port's plain loop, which follows JAX's within
  ulps) exceed 1e-3, the final state within atol 1e-4 (the band energies'
  differences, carried by the mixtures at rate 0.05);
* JAX's behaviour tests re-run on the port: speech kept and noise
  rejected, moderate-SNR speech kept, aggressiveness monotone, the
  min-energy gate, state threading;
* ``preprocess_window(gmm_state=)`` (``tests/test_vad_gmm.py``'s inputs):
  the same kept count, the trimmed windows within 1 int16 step (the two
  packages' denoise differ by one step in a few samples);
* ``vad_trim``, which ends the GMM path, against the golden collector
  (``tests/golden/vad_ref.py``) on the random and alternating patterns of
  ``tests/test_exactness_extra.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmla_audio_tpu.core.config import PipelineConfig as JaxPipelineConfig
from mmla_audio_tpu.ops.denoise import noise_threshold as jax_noise_threshold
from mmla_audio_tpu.streaming.session import \
    preprocess_window as jax_preprocess_window
from mmla_audio_tpu.vad import gmm as jgmm
from mmla_audio_torch.core.config import PipelineConfig, VadConfig
from mmla_audio_torch.ops.denoise import noise_threshold
from mmla_audio_torch.params import gmm_state_from_numpy, gmm_state_to_numpy
from mmla_audio_torch.streaming.session import preprocess_window
from mmla_audio_torch.vad import gmm
from mmla_audio_torch.vad.collector import vad_trim
from tests.conftest import synth_speech_i16
from tests.golden.vad_ref import vad_collector_indices

torch.set_num_threads(1)

E_RTOL, E_ATOL = 1e-5, 1e-4
STOPBAND_DB = 60.0
INIT_ATOL = 1e-4
MARGIN, STATE_ATOL = 1e-3, 1e-4
N = 40960


def _iir_allpass(x, a):
    """y[n] = a x[n] + s;  s = x[n] - a y[n]."""
    y = np.zeros_like(x)
    s = 0.0
    for i in range(len(x)):
        y[i] = a * x[i] + s
        s = x[i] - a * y[i]
    return y


@pytest.mark.parametrize("a", [0.64, 0.17])
def test_allpass_fir_matches_iir(a):
    x = np.random.RandomState(0).randn(400)
    y_fir = np.convolve(x, gmm._allpass_fir(a))[: len(x)]
    np.testing.assert_allclose(y_fir, _iir_allpass(x, a), atol=1e-9)


def test_fir_taps_match_jax():
    np.testing.assert_array_equal(gmm._hp80_fir(), jgmm._hp80_fir())
    for a in (0.64, 0.17):
        np.testing.assert_array_equal(gmm._allpass_fir(a),
                                      jgmm._allpass_fir(a))
    assert gmm.GMM_THRESHOLDS == jgmm.GMM_THRESHOLDS


def _signal(kind):
    rng = np.random.RandomState(3)
    if kind == "speech":
        return synth_speech_i16(N, seed=1).astype(np.float32)
    if kind == "noise":
        return (rng.randn(N) * 100).astype(np.float32)
    t = np.arange(16000) / 16000
    return (np.sin(2 * np.pi * int(kind) * t) * 8000).astype(np.float32)


@pytest.mark.parametrize("kind", ["speech", "noise", "150", "350", "700",
                                  "1500", "2500", "3500"])
def test_band_log_energies_match_jax(kind):
    x = _signal(kind)
    ref = np.asarray(jgmm.band_log_energies(jnp.asarray(x)))
    got = gmm.band_log_energies(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (len(x) // 480, 6)
    loud = ref >= ref.max(-1, keepdims=True) - STOPBAND_DB
    np.testing.assert_allclose(got[loud], ref[loud], rtol=E_RTOL,
                               atol=E_ATOL)
    # every band, the stop bands too, in linear energy against the frame's
    # loudest band
    lin = lambda db: 10.0 ** (db.astype(np.float64) / 10.0)   # noqa: E731
    scale = lin(ref).max(-1, keepdims=True)
    assert float((np.abs(lin(got) - lin(ref)) / scale).max()) <= E_RTOL
    assert np.argmax(got.mean(0)) == np.argmax(ref.mean(0))
    if kind.isdigit():          # the webrtcvad band layout
        want = {150: 0, 350: 1, 700: 2, 1500: 3, 2500: 4, 3500: 5}[int(kind)]
        assert np.argmax(got.mean(0)) == want


def test_band_log_energies_batch_equals_rows():
    x = np.stack([_signal("speech"), _signal("noise")])
    got = gmm.band_log_energies(torch.from_numpy(x))
    for b in range(2):
        torch.testing.assert_close(got[b], gmm.band_log_energies(
            torch.from_numpy(x[b])), rtol=0, atol=0)


@pytest.mark.parametrize("level", [0.0, 30.0, 100.0])
def test_gmm_init_matches_jax(level):
    rng = np.random.RandomState(int(level))
    noise = (rng.randn(160000) * level).astype(np.int16)
    ref = jgmm.gmm_init_from_noise(noise)
    got = gmm.gmm_init_from_noise(noise, device="cpu")
    for name in gmm.GmmVadState._fields:
        t = getattr(got, name)
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_allclose(t.numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=INIT_ATOL, err_msg=name)


def test_gmm_state_numpy_round_trip():
    st = gmm.gmm_init_from_noise(
        (np.random.RandomState(0).randn(32000) * 50).astype(np.int16),
        device="cpu")
    d = gmm_state_to_numpy(st)
    assert set(d) == set(jgmm.GmmVadState._fields)
    back = gmm_state_from_numpy(jgmm.GmmVadState(**d))
    for a, b in zip(st, back):
        assert torch.equal(a, b)
    rows = gmm.state_rows(st)
    assert rows.shape == (gmm.GMM_STATE_SLOTS,)
    for a, b in zip(st, gmm.state_from_rows(rows)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def calibrated():
    """A calibrated JAX state and a moderate-SNR mixture, whose decisions
    are neither all speech nor all silence."""
    rng = np.random.RandomState(0)
    noise = (rng.randn(160000) * 100).astype(np.int16)
    speech = synth_speech_i16(N, seed=2).astype(np.float32) * 0.15
    speech[N // 3: N // 2] = 0.0
    mix = speech + rng.randn(N).astype(np.float32) * 100
    return jgmm.gmm_init_from_noise(noise), mix


@pytest.mark.parametrize("adapt", [True, False])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_gmm_vad_matches_jax(calibrated, mode, adapt):
    jstate, mix = calibrated
    jd, jst = jgmm.gmm_vad(jnp.asarray(mix), jstate, aggressiveness=mode,
                           adapt=adapt)
    st = gmm_state_from_numpy({k: np.asarray(v)
                               for k, v in jstate._asdict().items()})
    got, got_st = gmm.gmm_vad(torch.from_numpy(mix), st,
                              aggressiveness=mode, adapt=adapt)
    x = torch.from_numpy(mix)
    _, _, margins = gmm.gmm_vad_rows_plain(
        gmm.band_log_energies(x)[None], gmm.total_db(x)[None],
        gmm.state_rows(st)[None], mode, adapt, with_margins=True)
    clear = (margins[0] > MARGIN).all(-1).numpy()
    jd = np.asarray(jd)
    assert got.dtype == torch.bool and got.shape == jd.shape == (N // 480,)
    np.testing.assert_array_equal(got.numpy()[clear], jd[clear])
    assert clear.mean() > 0.9
    assert 0 < jd.mean() < 1
    for name in gmm.GmmVadState._fields:
        np.testing.assert_allclose(getattr(got_st, name).numpy(),
                                   np.asarray(getattr(jst, name)), rtol=0,
                                   atol=STATE_ATOL, err_msg=name)


def test_gmm_vad_rows_plain_batch_equals_rows(calibrated):
    """The plain version over many rows at once equals each row alone, and
    ``gmm_vad_rows`` takes it for CPU tensors."""
    jstate, mix = calibrated
    st = gmm_state_from_numpy(jstate)
    x = torch.from_numpy(np.stack([mix, mix[::-1].copy(), mix * 0.1]))
    e, tot = gmm.band_log_energies(x), gmm.total_db(x)
    rows = gmm.state_rows(st).expand(3, -1).contiguous()
    rows[1] += 1.0
    dec, out = gmm.gmm_vad_rows(e, tot, rows, 3, True)
    for b in range(3):
        d1, o1 = gmm.gmm_vad_rows_plain(e[b:b + 1], tot[b:b + 1],
                                        rows[b:b + 1], 3, True)
        assert torch.equal(dec[b], d1[0]) and torch.equal(out[b], o1[0])


def test_gmm_vad_rows_refuses_bad_arguments():
    e, tot = torch.zeros(2, 5, 6), torch.zeros(2, 5)
    rows = torch.zeros(2, gmm.GMM_STATE_SLOTS)
    with pytest.raises(ValueError, match="aggressiveness"):
        gmm.gmm_vad_rows(e, tot, rows, 4)
    with pytest.raises(ValueError, match="states"):
        gmm.gmm_vad_rows(e, tot, rows[:, :53], 3)
    with pytest.raises(ValueError, match="unsupported device"):
        gmm.gmm_vad_rows(e.to("meta"), tot.to("meta"), rows.to("meta"), 3)


# JAX's behaviour tests (tests/test_vad_gmm.py), re-run on the port
def _state(level, seed=0):
    rng = np.random.RandomState(seed)
    return gmm.gmm_init_from_noise(
        (rng.randn(160000) * level).astype(np.int16), device="cpu"), rng


def test_detects_speech_rejects_noise():
    st, rng = _state(100)
    speech = synth_speech_i16(N, seed=1).astype(np.float32)
    mix = speech + rng.randn(N).astype(np.float32) * 100
    d_s, _ = gmm.gmm_vad(torch.from_numpy(mix), st, aggressiveness=3)
    d_n, _ = gmm.gmm_vad(torch.from_numpy(
        rng.randn(N).astype(np.float32) * 100), st, aggressiveness=3)
    assert d_s.float().mean() > 0.9
    assert d_n.float().mean() < 0.1


def test_detects_moderate_snr_speech():
    st, rng = _state(60.0)
    sp = synth_speech_i16(N, seed=5).astype(np.float32)
    sp *= 60.0 * 10 ** (10 / 20.0) / np.sqrt(np.mean(sp ** 2))
    mix = sp + rng.randn(N).astype(np.float32) * 60.0
    d, _ = gmm.gmm_vad(torch.from_numpy(mix), st, aggressiveness=3)
    assert d.float().mean() > 0.5


def test_aggressiveness_monotone():
    st, rng = _state(100)
    sp = synth_speech_i16(N, seed=2).astype(np.float32) * 0.15
    mix = torch.from_numpy(sp + rng.randn(N).astype(np.float32) * 100)
    fracs = [float(gmm.gmm_vad(mix, st, aggressiveness=m)[0].float().mean())
             for m in range(4)]
    assert all(fracs[i] >= fracs[i + 1] for i in range(3)), fracs


def test_min_energy_gate():
    st = gmm.gmm_init_from_noise(np.zeros(160000, np.int16), device="cpu")
    d, _ = gmm.gmm_vad(torch.zeros(N) + 0.5, st, aggressiveness=0)
    assert not d.any()


def test_state_threading_adapts():
    st0, _ = _state(80, seed=1)
    speech = torch.from_numpy(synth_speech_i16(N, seed=3).astype(np.float32))
    _, st1 = gmm.gmm_vad(speech, st0, aggressiveness=3)
    assert not torch.allclose(st1.speech_mean, st0.speech_mean)
    _, st2 = gmm.gmm_vad(speech, st0, aggressiveness=3, adapt=False)
    assert torch.equal(st2.noise_mean, st0.noise_mean)
    # the input state is never written
    _, st3 = gmm.gmm_vad(speech, st0, aggressiveness=3)
    assert torch.equal(st3.speech_mean, st1.speech_mean)


def test_gmm_vad_refuses_a_state_elsewhere():
    st, _ = _state(50)
    with pytest.raises(ValueError, match="the state on"):
        gmm.gmm_vad(torch.zeros(N, device="meta"), st)


def test_gmm_demoted_from_serving_config():
    with pytest.raises(ValueError, match="demoted to a benchmark probe"):
        VadConfig(decision="gmm")


@pytest.fixture(scope="module")
def probe_inputs():
    """``tests/test_vad_gmm.py::test_preprocess_window_gmm_probe``'s."""
    rng = np.random.RandomState(0)
    noise = (rng.randn(160000) * 25).astype(np.int16)
    speech = synth_speech_i16(N, seed=2).astype(np.float32)
    quiet = (rng.randn(N) * 25).astype(np.float32)
    return noise, {"speech": speech, "quiet": quiet}


@pytest.mark.parametrize("which", ["speech", "quiet"])
def test_preprocess_window_gmm_matches_jax(probe_inputs, which):
    noise, windows = probe_inputs
    raw = windows[which]
    jcfg = JaxPipelineConfig()
    jnt = jax_noise_threshold(jnp.asarray(noise.astype(np.float32) / 32768.0),
                              jcfg.denoise)
    jt, jn, _ = jax_preprocess_window(
        jnp.asarray(raw), jnt, jnp.asarray(30.0, jnp.float32), jcfg,
        gmm_state=jgmm.gmm_init_from_noise(noise))
    cfg = PipelineConfig()
    nt = noise_threshold(torch.from_numpy(noise.astype(np.float32) / 32768.0),
                         cfg.denoise)
    got, n = preprocess_window(raw.astype(np.int16), nt, cfg,
                               gmm_state=gmm.gmm_init_from_noise(
                                   noise, device="cpu"))
    assert n == int(jn)
    if which == "speech":
        assert n >= cfg.vad.silent_samples
    else:
        assert n < cfg.vad.silent_samples
    assert float(np.abs(got.numpy() - np.asarray(jt)).max()) <= 1.0


def _trim_case(is_speech):
    """``vad_trim`` of a window whose frame i holds the value i + 1 (plus
    one sample, so that every frame exists), against the golden."""
    T, fl = len(is_speech), 480
    buf = torch.from_numpy(np.concatenate(
        [np.repeat(np.arange(1, T + 1), fl), [0]]).astype(np.float32))
    out, n = vad_trim(buf, buf.shape[0], torch.tensor(is_speech), fl)
    idx = vad_collector_indices(list(is_speech))
    want = np.zeros(len(buf), np.float32)
    want[: len(idx) * fl] = np.repeat(np.asarray(idx) + 1, fl)
    assert n == len(idx) * fl
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("seed", range(12))
def test_vad_trim_random_patterns_match_golden(seed):
    rng = np.random.RandomState(100 + seed)
    T = rng.randint(10, 200)
    p = rng.choice([0.2, 0.5, 0.8, 0.95])
    _trim_case(rng.rand(T) < p)


def test_vad_trim_alternating_matches_golden():
    _trim_case(np.array([True, False] * 40))
