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
from mmla_audio_torch import inference
from mmla_audio_torch.inference import WavLMPredictor
from mmla_audio_torch.models.wavlm import (WavLMForSequenceClassification,
                                           relative_position_bucket,
                                           split_input, wavlm_input_batch)
from mmla_audio_torch.ops.cuda_attention import (wavlm_attention,
                                                 wavlm_attention_plain)
from mmla_audio_torch.ops.cuda_conv_encoder import (conv_args, conv_route,
                                                    pack_conv_weight,
                                                    round_tf32,
                                                    wavlm_conv,
                                                    wavlm_conv_plain)
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
    real = inference.wavlm_input_batch

    def kept(trimmed, n, *a):
        seen.append(([s.name for s in mux._pending_streams], trimmed.clone(),
                     n.clone()))
        return real(trimmed, n, *a)

    monkeypatch.setattr(inference, "wavlm_input_batch", kept)
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


# -- kernel E1's plain version, layout and checks -----------------------------

class TransposingConvLayer(torch.nn.Module):
    """The conv encoder's layer as it was before E1: conv on (B, C, T), a
    transpose, LayerNorm, a transpose back, GELU."""

    def __init__(self, layer):
        super().__init__()
        self.conv, self.layer_norm = layer.conv, layer.layer_norm

    def forward(self, x):
        x = self.conv(x)
        return F.gelu(self.layer_norm(x.transpose(1, 2)).transpose(1, 2))


def transposing_encoder(model, samples):
    """(B, L) -> (B, T, C) through ``TransposingConvLayer``s."""
    x = samples[:, None]
    for layer in model.feature_extractor.conv_layers:
        x = TransposingConvLayer(layer)(x)
    return x.transpose(1, 2)


def _samples(kept=KEPT[:3]):
    x = wavlm_input_batch(torch.from_numpy(windows(kept)),
                          torch.from_numpy(kept))
    return split_input(x)


@pytest.mark.parametrize("width", [32, 512])
def test_plain_conv_encoder_equals_the_transposing_stack(width):
    """Channels-last through ``wavlm_conv`` on the CPU (its plain version)
    gives the transposing stack's bits, layer by layer; at width 512 the
    first three layers (WavLM Large's)."""
    cfg = port_config.WavLMConfig(conv_dim=(width,) * 7)
    m = WavLMForSequenceClassification(cfg).eval()
    m.load_state_dict(seeded_state_dict(cfg, seed=2))
    samples, _ = _samples()
    layers = m.feature_extractor.conv_layers[:7 if width == 32 else 3]
    old, new = samples[:, None], samples[..., None]
    with torch.no_grad():
        for layer in layers:
            old = TransposingConvLayer(layer)(old)
            new = layer(new)
            assert new.is_contiguous()
            assert torch.equal(new, old.transpose(1, 2))


def test_conv_encoder_output_feeds_the_projection_to_the_same_logits(model):
    """The channels-last encoder, fed to the projection as it is, gives
    the logits of the transposing stack's output transposed, bit for bit."""
    samples, n = _samples(KEPT)
    with torch.no_grad():
        got = model(samples, n)
        feats = model.feature_extractor(samples)
        assert torch.equal(feats, transposing_encoder(model, samples))
        real = model.feature_extractor.forward
        model.feature_extractor.forward = lambda x: transposing_encoder(
            model, x)
        try:
            want = model(samples, n)
        finally:
            model.feature_extractor.forward = real
    assert torch.equal(got, want)


@pytest.mark.parametrize("c_in,k", [(1, 10), (32, 3), (512, 2)])
def test_weight_repack_round_trips(c_in, k):
    """``pack_conv_weight``: (k, C_out) for one input channel, else (2,
    C_out, k C_in) with K = j C_in + c, the second copy rounded to TF32;
    the layout's inverse gives the weight back."""
    w = torch.randn(128, c_in, k, generator=torch.Generator().manual_seed(k))
    p = pack_conv_weight(w)
    assert p.is_contiguous()
    if c_in == 1:
        assert p.shape == (k, 128) and torch.equal(p[k - 1], w[:, 0, k - 1])
    else:
        assert p.shape == (2, 128, k * c_in)
        assert torch.equal(p[0, 7, (k - 1) * c_in + 5], w[7, 5, k - 1])
        assert torch.equal(p[1], round_tf32(p[0]))
    back = p.t()[:, None, :] if c_in == 1 \
        else p[0].view(128, k, c_in).permute(0, 2, 1)
    assert torch.equal(back, w)


def test_round_tf32_rounds_to_nearest_ties_away():
    """11 bits kept after the leading one: 1 + 2^-10 is kept, 1 + 2^-11 (a
    tie) rounds away from zero, 1 + 2^-12 rounds down; signs kept."""
    x = torch.tensor([1 + 2 ** -10, 1 + 2 ** -11, 1 + 2 ** -12,
                      -(1 + 2 ** -11), 3.0, 0.0, 1 + 3 * 2 ** -12])
    want = torch.tensor([1 + 2 ** -10, 1 + 2 ** -10, 1.0, -(1 + 2 ** -10),
                         3.0, 0.0, 1 + 2 ** -10])
    assert torch.equal(round_tf32(x), want)
    y = torch.randn(1000, generator=torch.Generator().manual_seed(1))
    r = round_tf32(y)
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((r - y).abs() <= y.abs() * 2 ** -11).all()


def test_state_dict_keeps_its_names_and_shapes_after_a_forward(model):
    """The repacked weights are not parameters or buffers: the state dict
    keeps Hugging Face's names and shapes and loads strictly."""
    want = {k: tuple(v.shape) for k, v in seeded_state_dict().items()}
    samples, n = _samples()
    with torch.no_grad():
        model(samples, n)
    for layer in model.feature_extractor.conv_layers:
        layer.packed()
    sd = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert "feature_extractor.conv_layers.0.conv.weight" in sd
    assert "feature_extractor.conv_layers.6.layer_norm.bias" in sd
    assert not any("pack" in k for k in sd)
    model.load_state_dict(sd, strict=True)


def test_packed_weight_is_made_once_and_follows_the_weight():
    m = WavLMForSequenceClassification(TINY).eval()
    layer = m.feature_extractor.conv_layers[1]
    first = layer.packed()
    assert layer.packed() is first
    with torch.no_grad():
        layer.conv.weight.mul_(2.0)
    again = layer.packed()
    assert again is not first and torch.equal(again, 2.0 * first)
    m.load_state_dict(seeded_state_dict())
    assert torch.equal(layer.packed(), pack_conv_weight(layer.conv.weight))


@pytest.mark.parametrize("c_in,c_out,want", [
    (1, 512, "samples"), (1, 128, "samples"), (1, 64, None),
    (512, 512, "gemm"), (32, 128, "gemm"), (512, 384, "gemm"),
    (512, 640, None), (48, 128, None), (32, 64, None)])
def test_conv_route_depends_on_the_widths_alone(c_in, c_out, want):
    assert conv_route(c_in, c_out) == want


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """An unsupported device raises in ``wavlm_conv``; widths, dtype, shape
    and layout in ``conv_args``, which it runs before every launch."""
    w = torch.randn(512, 512, 3)
    ln = torch.ones(512), torch.zeros(512)
    x = torch.randn(2, 31, 512)
    assert conv_args(x, w, *ln, 2) == ("gemm", 15)
    w0 = torch.randn(512, 1, 10)
    assert conv_args(torch.randn(2, 31)[..., None], w0, *ln, 5) \
        == ("samples", 5)
    with pytest.raises(ValueError, match="along a row"):
        conv_args(x[..., :1], w0, *ln, 5)
    with pytest.raises(ValueError, match="unsupported device"):
        wavlm_conv(x.to("meta"), w.to("meta"), *(t.to("meta") for t in ln),
                   2)
    with pytest.raises(ValueError, match="float32"):
        conv_args(x.double(), w, *ln, 2)
    with pytest.raises(ValueError, match="multiple of 128"):
        conv_args(x, torch.randn(32, 512, 3), torch.ones(32),
                  torch.zeros(32), 2)
    with pytest.raises(ValueError, match="cannot take"):
        conv_args(x[:, :2], w, *ln, 2)
    with pytest.raises(ValueError, match="contiguous"):
        conv_args(x.transpose(0, 1).contiguous().transpose(0, 1), w, *ln, 2)
    with pytest.raises(ValueError, match="packed"):
        conv_args(x, w, *ln, 2, packed=torch.randn(2, 512, 512 * 2))
    with pytest.raises(ValueError, match="norm_weight"):
        conv_args(x, w, torch.ones(256), ln[1], 2)
    with pytest.raises(ValueError, match=r"\(B, T, C_in\)"):
        conv_args(x[0], w, *ln, 2)


def test_cpu_forward_launches_no_kernel(model):
    """The CPU path is the plain version: neither E1's counters nor A1's
    move."""
    before = (wavlm_conv.launches, wavlm_conv.launches_split,
              wavlm_attention.launches)
    samples, n = _samples()
    with torch.no_grad():
        model(samples, n)
    assert (wavlm_conv.launches, wavlm_conv.launches_split,
            wavlm_attention.launches) == before


def test_e1_launches_inside_a_dispatcher_operator():
    """The card path launches through ``mmla_audio::wavlm_conv``, an
    operator with a CUDA kernel alone, so that a profiler ties E1's kernels
    to an operator as it ties aten's; the CPU path never calls it."""
    from torch._C import _dispatch_has_kernel_for_dispatch_key as has_kernel

    op = torch.ops.mmla_audio.wavlm_conv.default
    assert [a.name for a in op._schema.arguments] == [
        "x", "packed", "bias", "norm_weight", "norm_bias", "c_out", "k",
        "stride", "t_out", "eps", "split"]
    assert has_kernel("mmla_audio::wavlm_conv", "CUDA")
    assert not has_kernel("mmla_audio::wavlm_conv", "CPU")
    with pytest.raises(NotImplementedError):
        op(torch.randn(2, 31, 512), torch.randn(2, 512, 1536), None,
           torch.ones(512), torch.zeros(512), 512, 3, 2, 15, 1e-5, False)


def test_conv_plain_adds_the_bias_before_the_layer_norm():
    g = torch.Generator().manual_seed(8)
    x = torch.randn(2, 40, 64, generator=g)
    w, b = torch.randn(128, 64, 3, generator=g), torch.randn(128, generator=g)
    gamma, beta = torch.rand(128, generator=g) + 0.5, torch.randn(128)
    got = wavlm_conv_plain(x, w, gamma, beta, 2, 1e-5, b)
    y = F.conv1d(x.transpose(1, 2), w, stride=2).transpose(1, 2) + b
    want = F.gelu(F.layer_norm(y, (128,), gamma, beta, 1e-5))
    assert got.shape == (2, 19, 128)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
