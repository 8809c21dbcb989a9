"""wav2vec 2.0 Conformer Large as the overlap detector
(``models/conformer.py``), on the CPU at a tiny width (hidden 64, 4 heads of
16, 2 layers, FFN 128, conv dims 32; the depthwise kernel 31 kept) on
seeded random weights: against the plain reference
``tests/conformer_reference.py``, which shares no code with the port, on
rows of different kept counts; the reference against ``transformers``'
``Wav2Vec2ConformerForSequenceClassification`` on the same state dict;
kernel A2's plain version against the rel shift materialised; kernel C1's
plain version with BatchNorm folded into its taps against the unfused GLU,
convolution, BatchNorm and SiLU; the position tables and the folded taps
made once; and the predictor through ``Multiplexer``, ``predict`` and
``WavLMSession``."""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mmla_audio_torch import inference
from mmla_audio_torch.analyze.logs import OVERLAP_LABELS
from mmla_audio_torch.core import config as port_config
from mmla_audio_torch.inference import ConformerPredictor
from mmla_audio_torch.models.conformer import (
    Wav2Vec2ConformerForSequenceClassification, relative_positions)
from mmla_audio_torch.models.wavlm import split_input, wavlm_input_batch
from mmla_audio_torch.ops.cuda_attention import wavlm_attention
from mmla_audio_torch.ops.cuda_conformer_attention import (
    conformer_attention, conformer_attention_plain)
from mmla_audio_torch.ops.cuda_conformer_conv import (
    c1_plan, conformer_conv, conformer_conv_plain, fold_batch_norm)
from mmla_audio_torch.ops.cuda_conv_encoder import wavlm_conv
from mmla_audio_torch.streaming.capture import PrefilledCapture
from mmla_audio_torch.streaming.multiplex import Multiplexer
from tests import conformer_reference as ref
from tests.test_torch_wavlm import synth_speech_i16

torch.set_num_threads(1)

WIN = 40960
SHORT = 12800                  # 39 frames: the reference tests' windows
TINY = port_config.ConformerConfig(hidden_size=64, num_hidden_layers=2,
                                   num_attention_heads=4,
                                   intermediate_size=128, conv_dim=(32,) * 7,
                                   classifier_proj_size=16)
# kept counts of SHORT windows: whole, most, a few frames, one frame (400),
# none (399), no sample at all (a bucket's padding row)
KEPT = np.array([12800, 9000, 2000, 400, 399, 0])


def seeded_state_dict(cfg=TINY, seed=0) -> dict:
    """Seeded weights of every parameter and statistic: normals scaled by
    fan-in, LayerNorm scales around 1, BatchNorm running means around 0
    and variances in [0.5, 2), ``pos_bias_u`` and ``pos_bias_v`` at 0.5 so
    that they move the scores."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, p in Wav2Vec2ConformerForSequenceClassification(
            cfg).state_dict().items():
        shape = tuple(p.shape)
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros((), dtype=torch.int64)
            continue
        z = rng.randn(*shape).astype(np.float32)
        if name.endswith("running_var"):
            v = 0.5 + 1.5 * rng.rand(*shape)
        elif name.endswith(("layer_norm.weight", "batch_norm.weight")):
            v = 1.0 + 0.2 * z
        elif name.endswith(("pos_bias_u", "pos_bias_v")):
            v = 0.5 * z
        elif p.ndim == 1:
            v = 0.1 * z
        else:
            v = z / np.sqrt(np.prod(shape[1:]))
        out[name] = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    return out


def windows(kept=KEPT, n=SHORT, seed=0) -> np.ndarray:
    """Trimmed windows at int16 scale, zero beyond each kept count."""
    x = np.stack([synth_speech_i16(n, seed=seed + b).astype(np.float32)
                  for b in range(len(kept))])
    x[np.arange(n)[None, :] >= np.asarray(kept)[:, None]] = 0.0
    return x


@pytest.fixture(scope="module")
def model():
    m = Wav2Vec2ConformerForSequenceClassification(TINY).eval()
    m.load_state_dict(seeded_state_dict())
    return m


def _logits(model, trimmed, kept):
    x = wavlm_input_batch(torch.from_numpy(trimmed), torch.from_numpy(kept))
    with torch.no_grad():
        return model(*split_input(x))


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("rows", ["all", "whole", "padded"])
def test_logits_match_the_reference(model, rows, seed):
    """Rows with padding, a row with one frame, one under a frame and a
    bucket's padding row, alone and together; both float32 with sums in
    other orders (the reference rel-shifts the positional scores and runs
    the conv module channels-first): rounding only."""
    pick = {"all": slice(None), "whole": slice(0, 1),
            "padded": slice(1, None)}[rows]
    kept = KEPT[pick]
    trimmed = windows(kept, seed=seed)
    got = _logits(model, trimmed, kept)
    want = ref.forward(seeded_state_dict(), ref.normalize(trimmed, kept),
                       kept, TINY)
    assert torch.isfinite(got).all() and got.shape == (len(kept), 2)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def _hf_model(cfg=TINY):
    """``transformers``' classifier at ``cfg``'s widths (its positional
    convolution built, as Hugging Face always builds it)."""
    os.environ.setdefault("USE_TF", "0")
    from transformers.models.wav2vec2_conformer import (
        configuration_wav2vec2_conformer as hf_config,
        modeling_wav2vec2_conformer as hf_model)

    c = hf_config.Wav2Vec2ConformerConfig(
        hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        intermediate_size=cfg.intermediate_size, conv_dim=cfg.conv_dim,
        conv_kernel=cfg.conv_kernel, conv_stride=cfg.conv_stride,
        conv_bias=cfg.conv_bias, feat_extract_norm=cfg.feat_extract_norm,
        hidden_act=cfg.hidden_act,
        conv_depthwise_kernel_size=cfg.conv_depthwise_kernel_size,
        position_embeddings_type=cfg.position_embeddings_type,
        max_source_positions=cfg.max_source_positions,
        layer_norm_eps=cfg.layer_norm_eps, use_weighted_layer_sum=True,
        classifier_proj_size=cfg.classifier_proj_size,
        num_labels=cfg.num_labels, mask_time_prob=0.0,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    return hf_model.Wav2Vec2ConformerForSequenceClassification(c).eval()


PREFIX = "wav2vec2_conformer."


@pytest.fixture(scope="module")
def hf():
    """(Hugging Face's model with the seeded weights, its whole state dict
    under the port's names, the positional convolution's keys included)."""
    m = _hf_model()
    sd = seeded_state_dict()
    full = {}
    for k, v in m.state_dict().items():
        name = k[len(PREFIX):] if k.startswith(PREFIX) else k
        full[name] = sd.get(name, v)
    m.load_state_dict({(PREFIX + k if k.startswith(("feature_", "encoder."))
                        else k): v for k, v in full.items()})
    return m, full


@pytest.mark.parametrize("kept", [[12800, 12800], [12800, 9000, 2000],
                                  [4000, 12800, 700]],
                         ids=["whole", "padded", "short"])
def test_reference_matches_transformers(hf, kept):
    """The reference's logits are Hugging Face's on the same weights and
    input, its attention mask the kept samples (rows of whole frames: Hugging
    Face attends to every frame of a row with none)."""
    m, _ = hf
    kept = np.asarray(kept)
    trimmed = windows(kept, seed=3)
    x = ref.normalize(trimmed, kept)
    mask = (torch.arange(SHORT)[None, :] < torch.from_numpy(kept)[:, None])
    with torch.no_grad():
        want = m(x, attention_mask=mask.long()).logits
    got = ref.forward(seeded_state_dict(), x, kept, TINY)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_port_loads_hugging_faces_state_dict_and_drops_the_unused_conv(hf):
    """Hugging Face's whole state dict, its never-applied positional
    convolution among it, loads strictly by name; those keys are dropped,
    and the port's logits are Hugging Face's."""
    m, full = hf
    assert any(k.startswith("encoder.pos_conv_embed.") for k in full)
    port = Wav2Vec2ConformerForSequenceClassification(TINY).eval()
    port.load_state_dict(full, strict=True)
    assert not any("pos_conv" in k for k in port.state_dict())
    kept = np.array([12800, 9000])
    trimmed = windows(kept, seed=4)
    mask = (torch.arange(SHORT)[None, :] < torch.from_numpy(kept)[:, None])
    with torch.no_grad():
        want = m(ref.normalize(trimmed, kept),
                 attention_mask=mask.long()).logits
    got = _logits(port, trimmed, kept)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("T", [1, 2, 39, 127])
def test_positions_are_hugging_faces(T):
    """The port's sinusoids, the reference's and the centre ``2T - 1`` rows
    of Hugging Face's table, bit for bit; row ``T - 1`` is position 0."""
    os.environ.setdefault("USE_TF", "0")
    from transformers.models.wav2vec2_conformer import (
        configuration_wav2vec2_conformer as hf_config,
        modeling_wav2vec2_conformer as hf_model)

    emb = hf_model.Wav2Vec2ConformerRelPositionalEmbedding(
        hf_config.Wav2Vec2ConformerConfig(hidden_size=64,
                                          max_source_positions=200))
    want = emb(torch.zeros(1, T, 64))[0]
    assert torch.equal(relative_positions(T, 64), want)
    assert torch.equal(ref.sinusoids(T, 64), want)
    assert torch.equal(want[T - 1, 0::2], torch.zeros(32))


def _operands(B, H, T, d, seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, H, T, d, generator=g) for _ in range(3))
    u, w = (0.5 * torch.randn(H, d, generator=g) for _ in range(2))
    p = torch.randn(H, 2 * T - 1, d, generator=g)
    lens = torch.randint(1, T + 1, (B,), generator=g, dtype=torch.int32)
    lens[0] = T
    return q, k, v, u, w, p, lens


def _rel_shift_attention(q, k, v, u, w, p, lens):
    """Hugging Face's form: all 2T - 1 positional scores, padded with a
    zero column, viewed and sliced, added, masked, softmaxed."""
    B, H, T, d = q.shape
    ac = (q + u[:, None]) @ k.transpose(-1, -2)
    bd = (q + w[:, None]) @ p.transpose(-1, -2)[None]
    pad = torch.zeros(B, H, T, 1)
    bd = torch.cat([pad, bd], -1).view(B, H, 2 * T, T)[:, :, 1:]
    bd = bd.reshape(B, H, T, 2 * T - 1)[..., :T]
    scores = (ac + bd) / d ** 0.5
    keys = torch.arange(T)[None, :] >= lens[:, None]
    scores = scores.masked_fill(keys[:, None, None], float("-inf"))
    return torch.softmax(scores, -1) @ v


@pytest.mark.parametrize("B,H,T,d", [(3, 4, 37, 16), (2, 2, 1, 8),
                                     (2, 3, 64, 64), (1, 2, 127, 64)])
def test_a2_plain_version_matches_the_rel_shift(B, H, T, d):
    """A2's plain version (what its wrapper runs on the CPU) gathers the
    positional score of (i, j) at row j - i + T - 1: Hugging Face's rel
    shift, to float32 rounding."""
    ops = _operands(B, H, T, d, seed=T)
    got = conformer_attention(*ops)
    assert torch.equal(got, conformer_attention_plain(*ops))
    want = _rel_shift_attention(*ops)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_a2_reads_row_j_minus_i_plus_T_minus_1():
    """One head, one query row against a table whose row m is m: the
    positional score of key j is (q + w) . p[j - i + T - 1]."""
    T, d = 5, 4
    q = torch.zeros(1, 1, T, d)
    q[0, 0, :, 0] = 1.0
    k = torch.zeros(1, 1, T, d)
    v = torch.arange(T, dtype=torch.float32)[None, None, :, None].expand(
        1, 1, T, d).contiguous()                       # value j is j
    p = torch.zeros(1, 2 * T - 1, d)
    p[0, :, 0] = torch.arange(2 * T - 1, dtype=torch.float32) * 2.0
    lens = torch.tensor([T], dtype=torch.int32)
    zero = torch.zeros(1, d)
    out = conformer_attention_plain(q, k, v, zero, zero, p, lens)
    for i in range(T):
        s = torch.tensor([(j - i + T - 1) * 2.0 / d ** 0.5 for j in range(T)])
        want = (torch.softmax(s, 0) * torch.arange(T)).sum()
        assert torch.allclose(out[0, 0, i, 0], want, rtol=1e-6)


@pytest.mark.parametrize("b", [0, 2, 3])
def test_a_row_is_independent_of_its_batch(model, b):
    """Padded frames are masked as keys and left out of the mean; the
    depthwise convolution reaches only a row's own frames: each row alone
    gives its logits in the batch, whatever the other rows hold."""
    trimmed = windows()
    batch = _logits(model, trimmed, KEPT)
    alone = _logits(model, trimmed[b: b + 1], KEPT[b: b + 1])
    swapped = trimmed.copy()
    swapped[b + 1:] = windows(seed=50)[b + 1:]
    mixed = _logits(model, swapped, KEPT)
    # float32 products at another batch size
    assert torch.allclose(alone[0], batch[b], rtol=1e-5, atol=1e-5)
    assert torch.allclose(mixed[b], batch[b], rtol=1e-5, atol=1e-5)


def test_conv_module_is_the_channels_first_one(model):
    """The channels-last conv module (pointwise as ``F.linear``, the
    depthwise convolution over a channels-last view) against the
    reference's channels-first one with BatchNorm written out."""
    layer = model.encoder.layers[1]
    x = torch.randn(3, 39, 64, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = layer.conv_module(x)
    want = ref.conv_module(x, seeded_state_dict(),
                           "encoder.layers.1.conv_module.", 31)
    assert got.is_contiguous() and got.shape == x.shape
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def _conv_operands(B, T, C=64, K=31, seed=0):
    """The pointwise product ``y (B, T, 2C)``, a depthwise weight and
    BatchNorm's four tensors with running statistics away from 0 and 1."""
    g = torch.Generator().manual_seed(seed)
    y = 2.0 * torch.randn(B, T, 2 * C, generator=g)
    weight = torch.randn(C, 1, K, generator=g) / K ** 0.5
    mean = 0.3 * torch.randn(C, generator=g)
    var = 0.5 + 1.5 * torch.rand(C, generator=g)
    gamma = 1.0 + 0.2 * torch.randn(C, generator=g)
    beta = 0.1 * torch.randn(C, generator=g)
    return y, weight, mean, var, gamma, beta


def _fold(weight, mean, var, gamma, beta, eps=1e-5):
    """C1's taps and bias from BatchNorm's tensors written out."""
    scale = gamma.double() / torch.sqrt(var.double() + eps)
    return fold_batch_norm(weight, scale, beta.double() - mean * scale)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("T", [1, 15, 31, 127])
def test_c1_plain_version_matches_the_unfused_stack(T, B):
    """C1's plain version (what its wrapper runs on the CPU) on the folded
    taps against the path it replaced: GLU, the depthwise ``F.conv2d`` over
    a channels-last ``(B, C, 1, T)`` view, ``F.batch_norm`` on the running
    statistics, SiLU; every row convolved, T shorter than the kernel
    too."""
    y, weight, mean, var, gamma, beta = _conv_operands(B, T, seed=T + B)
    C, K = weight.shape[0], weight.shape[-1]
    z = F.conv2d(F.glu(y, dim=-1).transpose(1, 2).unsqueeze(2),
                 weight.unsqueeze(2), padding=(0, (K - 1) // 2), groups=C)
    z = F.batch_norm(z, mean, var, gamma, beta, False, 0.0, 1e-5)
    want = F.silu(z).squeeze(2).transpose(1, 2)
    taps, bias = _fold(weight, mean, var, gamma, beta)
    assert taps.shape == (K, C) and taps.is_contiguous()
    got = conformer_conv(y, taps, bias)
    assert torch.equal(got, conformer_conv_plain(y, taps, bias))
    assert got.shape == (B, T, C) and got.is_contiguous()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_conv_module_folds_once_a_weight_version():
    """Each conv module folds its BatchNorm into the taps at its first
    forward and not at later ones; an in-place change of ``running_var``
    or of the depthwise weight (a new ``_version``), or new weights loaded,
    folds again; the folded taps stay out of the state dict and the CPU
    path launches no kernel."""
    m = Wav2Vec2ConformerForSequenceClassification(TINY).eval()
    m.load_state_dict(seeded_state_dict())
    conv = [layer.conv_module for layer in m.encoder.layers]
    assert [c.fold_builds for c in conv] == [0, 0]
    before = conformer_conv.launches
    trimmed = windows(KEPT[:2])
    first = _logits(m, trimmed, KEPT[:2])
    for _ in range(2):
        assert torch.equal(_logits(m, trimmed, KEPT[:2]), first)
    assert [c.fold_builds for c in conv] == [1, 1]
    assert conformer_conv.launches == before
    bn = conv[1].batch_norm
    taps, bias = conv[1].folded()
    with torch.no_grad():
        bn.running_var.mul_(2.0)
    assert conv[1].folded()[0] is not taps
    assert [c.fold_builds for c in conv] == [1, 2]
    want = _fold(conv[1].depthwise_conv.weight, bn.running_mean,
                 bn.running_var, bn.weight, bn.bias, bn.eps)
    assert all(torch.allclose(a, b, rtol=1e-6, atol=1e-7)
               for a, b in zip(conv[1].folded(), want))
    with torch.no_grad():
        conv[0].depthwise_conv.weight.add_(0.01)
    _logits(m, trimmed, KEPT[:2])
    assert [c.fold_builds for c in conv] == [2, 2]
    m.load_state_dict(seeded_state_dict())
    assert torch.equal(_logits(m, trimmed, KEPT[:2]), first)
    assert [c.fold_builds for c in conv] == [3, 3]
    assert not any("fold" in k or "taps" in k for k in m.state_dict())


@pytest.mark.parametrize("batch,T,sms,want", [
    (64, 127, 132, (64, 127)), (8, 127, 132, (32, 127)),
    (1, 1, 132, (32, 1)), (8, 511, 132, (64, 256)), (1, 511, 132, (32, 256)),
    (2, 300, 1, (64, 150))])
def test_c1_plan_fills_the_card(batch, T, sms, want):
    """64 channels a CTA where the grid still gives every multiprocessor a
    CTA (bucket 64 at C = 1024: 1,024 CTAs), else 32 (bucket 8: 128 CTAs
    at 64 channels, 256 at 32; bucket 8 at T = 511: 256 at 64); the whole
    T a CTA up to 256 rows, longer rows in near-equal tiles."""
    assert c1_plan(batch, T, 1024, sms) == want


def test_c1_launches_inside_a_dispatcher_operator():
    """The card path launches through ``mmla_audio::conformer_conv``, an
    operator with a CUDA kernel alone; the CPU path never calls it, and a
    tensor of another device is refused."""
    from torch._C import _dispatch_has_kernel_for_dispatch_key as has_kernel

    op = torch.ops.mmla_audio.conformer_conv.default
    assert [a.name for a in op._schema.arguments] == [
        "y", "taps", "bias", "c_tile", "t_tile"]
    assert has_kernel("mmla_audio::conformer_conv", "CUDA")
    assert not has_kernel("mmla_audio::conformer_conv", "CPU")
    y, weight, mean, var, gamma, beta = _conv_operands(1, 5)
    taps, bias = _fold(weight, mean, var, gamma, beta)
    with pytest.raises(NotImplementedError):
        op(y, taps, bias, 64, 5)
    with pytest.raises(ValueError, match="unsupported device"):
        conformer_conv(y.to("meta"), taps.to("meta"), bias.to("meta"))


def test_position_tables_are_made_once_a_length():
    """One build for all layers at a length, reused by every forward;
    another length, or new weights, build again."""
    m = Wav2Vec2ConformerForSequenceClassification(TINY).eval()
    m.load_state_dict(seeded_state_dict())
    assert m.table_builds == 0
    trimmed = windows(KEPT[:2])
    first = _logits(m, trimmed, KEPT[:2])
    tables = m.position_tables(39, "cpu")
    assert m.table_builds == 1 and len(tables) == TINY.num_hidden_layers
    assert tables[0].shape == (4, 77, 16) and tables[0].is_contiguous()
    for _ in range(2):
        assert torch.equal(_logits(m, trimmed, KEPT[:2]), first)
    assert m.table_builds == 1 and m.position_tables(39, "cpu") is tables
    _logits(m, windows(KEPT[:2], n=WIN), np.array([WIN, 9000]))
    assert m.table_builds == 2
    m.load_state_dict(seeded_state_dict(seed=1))
    _logits(m, windows(KEPT[:2], n=WIN), np.array([WIN, 9000]))
    assert m.table_builds == 3
    want = m.encoder.layers[1].self_attn.linear_pos(relative_positions(
        127, 64)).view(253, 4, 16).transpose(0, 1)
    assert torch.equal(m.position_tables(127, "cpu")[1], want)


def test_state_dict_has_hugging_faces_names(model):
    sd = model.state_dict()
    for name in ("encoder.layers.0.ffn1.intermediate_dense.weight",
                 "encoder.layers.1.self_attn.linear_pos.weight",
                 "encoder.layers.0.self_attn.pos_bias_u",
                 "encoder.layers.0.conv_module.depthwise_conv.weight",
                 "encoder.layers.1.conv_module.batch_norm.running_var",
                 "feature_extractor.conv_layers.6.conv.bias",
                 "encoder.layer_norm.weight", "layer_weights"):
        assert name in sd, name
    assert sd["encoder.layers.0.conv_module.depthwise_conv.weight"].shape \
        == (64, 1, 31)
    assert not any("pos_conv" in k or "pack" in k or "table" in k
                   for k in sd)


def test_cpu_forward_launches_no_kernel(model):
    """The CPU path is the plain version: neither A2's, E1's nor A1's
    counters move."""
    before = (conformer_attention.launches, wavlm_conv.launches,
              wavlm_attention.launches)
    _logits(model, windows(KEPT[:2]), KEPT[:2])
    assert (conformer_attention.launches, wavlm_conv.launches,
            wavlm_attention.launches) == before


def test_a2_launches_inside_a_dispatcher_operator():
    """The card path launches through ``mmla_audio::conformer_attention``,
    an operator with a CUDA kernel alone, beside E1's; the CPU path never
    calls it."""
    from torch._C import _dispatch_has_kernel_for_dispatch_key as has_kernel

    op = torch.ops.mmla_audio.conformer_attention.default
    assert [a.name for a in op._schema.arguments] == [
        "q", "k", "v", "u", "w", "p", "lens", "split"]
    assert has_kernel("mmla_audio::conformer_attention", "CUDA")
    assert not has_kernel("mmla_audio::conformer_attention", "CPU")
    assert has_kernel("mmla_audio::wavlm_conv", "CUDA")
    with pytest.raises(NotImplementedError):
        op(*_operands(1, 1, 3, 64, seed=1), False)


def test_a2_wrapper_refuses_an_unsupported_device():
    ops = [t.to("meta") for t in _operands(1, 2, 5, 64, seed=1)]
    with pytest.raises(ValueError, match="unsupported device"):
        conformer_attention(*ops)


def test_model_refuses_what_the_port_does_not_build():
    import dataclasses

    for change in (dict(position_embeddings_type="rotary"),
                   dict(feat_extract_norm="group"), dict(hidden_act="gelu")):
        with pytest.raises(ValueError, match="the port builds"):
            Wav2Vec2ConformerForSequenceClassification(
                dataclasses.replace(TINY, **change))
    with pytest.raises(ValueError, match="odd"):
        Wav2Vec2ConformerForSequenceClassification(
            dataclasses.replace(TINY, conv_depthwise_kernel_size=30))
    m = Wav2Vec2ConformerForSequenceClassification(
        dataclasses.replace(TINY, max_source_positions=20))
    with pytest.raises(ValueError, match="max_source_positions"):
        m.position_tables(39, "cpu")


def test_spans_name_the_attention_and_conv_module(model):
    """Under a profiler each layer opens ``model.attention`` and
    ``model.conv_module`` inside its ``model.layer``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _logits(model, windows(KEPT[:1]), KEPT[:1])
    names = [e.name for e in prof.events()]
    for name in ("model.encoder", "model.layers", "model.head"):
        assert names.count(name) == 1, name
    for name in ("model.layer", "model.attention", "model.conv_module"):
        assert names.count(name) == TINY.num_hidden_layers, name


def test_published_widths_are_the_defaults():
    cfg = port_config.ConformerConfig()
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.intermediate_size, cfg.conv_depthwise_kernel_size) == \
        (1024, 24, 16, 4096, 31)
    with torch.device("meta"):
        m = Wav2Vec2ConformerForSequenceClassification(cfg)
    n = sum(p.numel() for p in m.parameters())
    # ~610 M parameters, 2.44 GB in float32
    assert 6.0e8 < n < 6.2e8


def test_multiplexer_labels_are_predicts(tmp_path, monkeypatch):
    """``Multiplexer(ConformerPredictor)`` labels each window as ``predict``
    labels the trimmed window its normalisation was given, and as the
    reference does where the top two logits are clear; no branch of the
    multiplexer knows the kind."""
    pred = ConformerPredictor(seeded_state_dict(), TINY, device="cpu")
    mux = Multiplexer(pred, tmp_path, kind="conformer", bucket=4,
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
    monkeypatch.setattr(inference, "wavlm_input_batch", real)
    want = {s.name: [] for s in streams}
    for names, trimmed, n in seen:
        labels, _ = pred.predict(trimmed, n)
        x = ref.normalize(trimmed.numpy(), n.numpy())
        logits = ref.forward(seeded_state_dict(), x, n.numpy(), TINY)
        for name, label, c, lg in zip(names, labels.tolist(), n.tolist(),
                                      logits):
            assert c < 4000 or int(lg.argmax()) == label
            want[name].append("silent" if label < 0
                              else OVERLAP_LABELS[str(label)])
    got = {s.name: [r[1] for r in s.results] for s in streams}
    assert got == want
    assert {"overlapped", "non-overlapped"} & set(sum(got.values(), []))
    # two batches padded to the bucket, and predict's two of them again
    stats = pred.frame_stats()
    assert len(seen) == 2 and stats["batches"] == 4
    assert stats["computed"] == 4 * 4 * 127
    # the model was built once for all of it: one table build a length
    assert pred.model.table_builds == 1


def test_wavlm_session_serves_the_conformer(tmp_path):
    """``WavLMSession`` takes any raw-waveform predictor: the Conformer's
    labels through the live session are ``predict``'s of the trimmed
    windows the session decided on."""
    from mmla_audio_torch.streaming.session import WavLMSession

    pred = ConformerPredictor(seeded_state_dict(), TINY, device="cpu")
    pcm = np.concatenate([synth_speech_i16(WIN, seed=60 + w)
                          for w in range(2)])
    noise = (np.random.RandomState(2).randn(160000) * 15).astype(np.int16)
    sess = WavLMSession(pred, PrefilledCapture(pcm), tmp_path,
                        cfg=port_config.PipelineConfig())
    sess.set_noise_profile(noise)
    scored = []
    real = pred.score

    def score(samples, n):
        scored.append((torch.as_tensor(samples).clone(),
                       torch.as_tensor(n).clone()))
        return real(samples, n)

    pred.score = score
    rows = sess.run(max_windows=2)
    assert len(rows) == 2
    for (samples, n), row in zip(scored, rows):
        label, _ = pred.predict(samples, n)
        label = label.reshape(-1)[0].item()
        assert row[1] == ("silent" if label < 0
                          else OVERLAP_LABELS[str(label)])
