"""WavLM Large as the overlap detector (``models/wavlm.py``), on the CPU at a
tiny width (hidden 64, 4 heads of 16, 2 layers, conv dims 32; the bucket
count 320 and distance 800 kept) on seeded random weights, against the
plain reference ``tests/wavlm_reference.py``, which shares no code with
the port: the logits on rows of different kept counts, the bucket
function, kernel A1's plain version, a row's independence of its batch,
and ``Multiplexer(kind="wavlm")`` end to end."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mmla_audio_torch.analyze.logs import OVERLAP_LABELS
from mmla_audio_torch.core import config as port_config
from mmla_audio_torch.inference import WavLMPredictor
from mmla_audio_torch.models.wavlm import (WavLMForSequenceClassification,
                                           relative_position_bucket,
                                           split_input, wavlm_input_batch)
from mmla_audio_torch.ops.cuda_attention import (wavlm_attention,
                                                 wavlm_attention_plain)
from mmla_audio_torch.streaming import multiplex as mx
from mmla_audio_torch.streaming.capture import PrefilledCapture
from mmla_audio_torch.streaming.multiplex import Multiplexer
from tests import wavlm_reference as ref

torch.set_num_threads(1)

WIN = 40960
TINY = port_config.WavLMConfig(hidden_size=64, num_hidden_layers=2,
                               num_attention_heads=4, intermediate_size=128,
                               conv_dim=(32,) * 7, classifier_proj_size=16)
# kept counts: whole, most, just over and under the silent gate (4,000), a
# row with one frame (400), none (399) and no sample at all
KEPT = np.array([40960, 30000, 4001, 3000, 400, 399, 0])


def synth_speech_i16(n: int, seed: int = 0) -> np.ndarray:
    """Speech-like int16 PCM: drifting tones and noise (the card tests
    import this module, so it does not take ``tests/conftest.py``'s)."""
    r = np.random.RandomState(seed)
    t = np.arange(n) / 16000
    y = sum(r.uniform(0.2, 1.0) * np.sin(2 * np.pi * (r.uniform(80, 2000)
            + r.uniform(-30, 30) * t) * t + r.uniform(0, 6.28))
            for _ in range(4)) + 0.05 * r.randn(n)
    return (y * 0.3 / np.abs(y).max() * 20000).astype(np.int16)


def seeded_state_dict(cfg=TINY, seed=0) -> dict:
    """Seeded weights of every parameter: normals scaled by fan-in, norms'
    scales and the gates' constants around 1, the bucket table at 0.5 so
    that the position bias moves the scores."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, p in WavLMForSequenceClassification(cfg).state_dict().items():
        shape = tuple(p.shape)
        z = rng.randn(*shape).astype(np.float32)
        if name.endswith(("layer_norm.weight", "weight_g",
                          "gru_rel_pos_const")):
            v = 1.0 + 0.2 * z
        elif name.endswith("rel_attn_embed.weight"):
            v = 0.5 * z
        elif p.ndim == 1:
            v = 0.1 * z
        else:
            v = z / np.sqrt(np.prod(shape[1:]))
        out[name] = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    return out


def windows(kept=KEPT, seed=0) -> np.ndarray:
    """Trimmed windows at int16 scale, zero beyond each kept count."""
    x = np.stack([synth_speech_i16(WIN, seed=seed + b).astype(np.float32)
                  for b in range(len(kept))])
    x[np.arange(WIN)[None, :] >= np.asarray(kept)[:, None]] = 0.0
    return x


@pytest.fixture(scope="module")
def model():
    m = WavLMForSequenceClassification(TINY).eval()
    m.load_state_dict(seeded_state_dict())
    return m


def _logits(model, trimmed, kept):
    x = wavlm_input_batch(torch.from_numpy(trimmed), torch.from_numpy(kept))
    with torch.no_grad():
        return model(*split_input(x))


def test_input_is_the_reference_normalisation():
    trimmed = windows()
    x = wavlm_input_batch(torch.from_numpy(trimmed), torch.from_numpy(KEPT))
    samples, n = split_input(x)
    assert n.tolist() == KEPT.tolist()
    # float32 sums over 40,960 samples against float64
    assert torch.allclose(samples, ref.normalize(trimmed, KEPT), atol=1e-5)
    assert not samples[-1].any() and torch.isfinite(samples).all()


def test_logits_match_the_reference(model):
    trimmed = windows()
    got = _logits(model, trimmed, KEPT)
    want = ref.forward(seeded_state_dict(), ref.normalize(trimmed, KEPT),
                       KEPT, TINY)
    assert torch.isfinite(got).all()
    # both float32, sums in other orders (the reference's attention is
    # F.multi_head_attention_forward): rounding only
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("rel,want", [
    (0, 0), (1, 161), (-1, 1), (79, 239), (-79, 79), (80, 240), (-80, 80),
    (81, 240), (-81, 80), (126, 255), (-126, 95), (800, 319), (-800, 159),
    (1000, 319), (-1000, 159)])
def test_bucket_function(rel, want):
    """Hand-computed: 160 buckets a side, exact below 80, then 80 + 80
    log(|r| / 80) / log(10), floored, at most 159; 160 added for r > 0."""
    r = torch.tensor([rel])
    assert relative_position_bucket(r, 320, 800).item() == want
    assert ref.bucket(r, 320, 800).item() == want


def test_attention_plain_version_matches_the_reference():
    """A1's plain version (what its wrapper runs on the CPU) against the
    gated bias materialised as Hugging Face builds it and
    ``scaled_dot_product_attention`` with the padded keys masked."""
    g = torch.Generator().manual_seed(3)
    B, H, T, d = 3, 4, 37, 16
    q, k, v = (torch.randn(B, H, T, d, generator=g) for _ in range(3))
    gate = 1.0 + 2.0 * torch.rand(B, H, T, generator=g)
    table = torch.randn(320, H, generator=g)
    lens = torch.tensor([37, 20, 1], dtype=torch.int32)
    pos = torch.arange(T)
    bias_hf = F.embedding(ref.bucket(pos[None, :] - pos[:, None]),
                          table).permute(2, 0, 1)                # (H, T, T)
    mask = gate[..., None] * bias_hf
    mask = mask.masked_fill((pos[None, :] >= lens[:, None])[:, None, None],
                            float("-inf"))
    want = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    bias = table[ref.bucket(torch.arange(-(T - 1), T))].t().contiguous()
    got = wavlm_attention(q, k, v, gate, bias, lens)
    assert torch.allclose(got, wavlm_attention_plain(q, k, v, gate, bias,
                                                     lens))
    # float32 softmax and products in other orders
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_a_row_is_independent_of_its_batch(model):
    """Padded frames are masked as keys and left out of the mean: each row
    alone gives its logits in the batch, whatever the other rows hold."""
    trimmed = windows()
    batch = _logits(model, trimmed, KEPT)
    other = windows(seed=50)
    for b in (0, 2, 4):
        alone = _logits(model, trimmed[b: b + 1], KEPT[b: b + 1])
        swapped = trimmed.copy()
        swapped[b + 1:] = other[b + 1:]
        mixed = _logits(model, swapped, KEPT)
        # float32 products at another batch size
        assert torch.allclose(alone[0], batch[b], rtol=1e-5, atol=1e-5)
        assert torch.allclose(mixed[b], batch[b], rtol=1e-5, atol=1e-5)


def test_multiplexer_labels_are_the_references(tmp_path, monkeypatch):
    pred = WavLMPredictor(seeded_state_dict(), TINY, device="cpu")
    mux = Multiplexer(pred, tmp_path, kind="wavlm", bucket=4,
                      cfg=port_config.PipelineConfig(), device="cpu")
    seen = []
    real = mx.wavlm_input_batch

    def kept(trimmed, n, *a):
        seen.append(([s.name for s in mux._pending_streams], trimmed.clone(),
                     n.clone()))
        return real(trimmed, n, *a)

    monkeypatch.setattr(mx, "wavlm_input_batch", kept)
    noise = (np.random.RandomState(1).randn(160000) * 15).astype(np.int16)
    streams = [mux.add_stream(f"s{s}", PrefilledCapture(np.concatenate(
        [synth_speech_i16(WIN, seed=10 * s + w) for w in range(2)])), noise)
        for s in range(3)]
    assert mux.run_until_exhausted() == 6
    want = {s.name: [] for s in streams}
    for names, trimmed, n in seen:
        n = n.numpy()
        logits = ref.forward(seeded_state_dict(),
                             ref.normalize(trimmed.numpy(), n), n, TINY)
        for name, c, i in zip(names, n, logits.argmax(-1)):
            want[name].append("silent" if c < 4000
                              else OVERLAP_LABELS[str(int(i))])
    got = {s.name: [r[1] for r in s.results] for s in streams}
    assert got == want
    assert {"overlapped", "non-overlapped"} & set(sum(got.values(), []))
    # two batches padded to the bucket: 127 frames a row computed
    stats = pred.frame_stats()
    assert stats["batches"] == len(seen) == 2
    assert stats["computed"] == 2 * 4 * 127
    assert 0 < stats["valid"] <= 6 * 127
