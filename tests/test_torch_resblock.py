"""The fused residual block's plain version (``fused_resblock_plain``, the CUDA
kernels' reference) and ``ResBlock2D``'s folded operands, held against the
TPU probe's Pallas kernel (interpret mode), the probe's XLA block, and the
JAX ``ResBlock2D`` in eval; the kernels' route rule and the tensor-core
kernel's tile plan.

Tolerance rtol 1e-4, atol 1e-5: fp32 accumulation order (no TF32 on the
CPU), as tests/test_torch_model.py.
"""

import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmla_audio_tpu.models.overlap import ResBlock2D as JaxBlock
from mmla_audio_torch.core.config import OverlapModelConfig
from mmla_audio_torch.inference import OverlapPredictor
from mmla_audio_torch.models.overlap import ResBlock2D
from mmla_audio_torch.ops.cuda_resblock import (FUSED_MAX_CHANNELS,
                                                MMA_TILE_M, SM_SHARED_BYTES,
                                                block_route, block_smem_bytes,
                                                block_tilings,
                                                check_block_width, fold_bn,
                                                fused_resblock_cuda,
                                                fused_resblock_plain,
                                                plan_block_tiles)

torch.set_num_threads(1)

PROBE = Path(__file__).resolve().parent.parent / "benchmarks" / \
    "fused_block_probe.py"
TOL = dict(rtol=1e-4, atol=1e-5)
H100_SMS = 132
FULL_WIDTH = [(32, 64, 76), (64, 32, 38), (128, 16, 19)]


@pytest.fixture(scope="module")
def probe():
    """The probe module in interpret mode (it reads PROBE_CPU on import)."""
    os.environ["PROBE_CPU"] = "1"
    spec = importlib.util.spec_from_file_location("fused_block_probe", PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.INTERPRET
    return mod


def _probe_case(probe, nb):
    rng = np.random.RandomState(0)
    plain, packed = probe.make_params(rng)
    x = rng.randn(nb, probe.H, probe.W, probe.C).astype(np.float32)
    return x, plain, packed


def _port(x_nhwc, plain):
    """The probe's NHWC input and (1, C) vectors -> the port's operands."""
    k1, b1, k2, b2, g1, bb1, g2, bb2 = (torch.from_numpy(np.asarray(a))
                                        for a in plain)
    x = torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))
    vec = [v.reshape(-1) for v in (b1, b2, g1, bb1, g2, bb2)]
    return x, (k1, vec[0], k2, vec[1], vec[2], vec[3], vec[4], vec[5])


def test_plain_matches_pallas_kernel(probe):
    x, plain, packed = _probe_case(probe, nb=2)
    ref = probe.run_fused(x, packed, 2)                    # (2, 64, 76, 32)
    xt, ops = _port(x, plain)
    got = fused_resblock_plain(xt, *ops).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, ref, **TOL)


def test_plain_matches_xla_block(probe):
    x, plain, _ = _probe_case(probe, nb=2)
    ref = np.asarray(probe.xla_block(jnp.asarray(x),
                                     *[jnp.asarray(p) for p in plain]))
    xt, ops = _port(x, plain)
    got = fused_resblock_plain(xt, *ops).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, ref, **TOL)


def _jax_block(C, H, W, seed):
    """JAX ResBlock2D(C) variables, every leaf perturbed from a seed (BN at
    identity would hide a swapped mean and variance), and an input."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, H, W, C).astype(np.float32)
    variables = JaxBlock(filters=C).init(jax.random.PRNGKey(seed),
                                         jnp.asarray(x))

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        name = jax.tree_util.keystr(path)
        if "'var'" in name or "'scale'" in name:
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        return (a + rng.normal(0.0, 0.1, a.shape)).astype(np.float32)

    return x, jax.tree_util.tree_map_with_path(perturb, variables)


def _port_block(variables, C):
    """The JAX block's variables loaded into the port's ResBlock2D."""
    p, s = variables["params"], variables["batch_stats"]
    block = ResBlock2D(C, C).eval()
    sd = {}
    for j in (0, 1):
        k = np.asarray(p[f"Conv_{j}"]["kernel"])
        sd[f"conv{j}.weight"] = np.transpose(k, (3, 2, 0, 1))
        sd[f"conv{j}.bias"] = p[f"Conv_{j}"]["bias"]
        bn_p = p[f"KerasBatchNorm_{j}"]["BatchNorm_0"]
        bn_s = s[f"KerasBatchNorm_{j}"]["BatchNorm_0"]
        sd[f"bn{j}.weight"], sd[f"bn{j}.bias"] = bn_p["scale"], bn_p["bias"]
        sd[f"bn{j}.running_mean"] = bn_s["mean"]
        sd[f"bn{j}.running_var"] = bn_s["var"]
        sd[f"bn{j}.num_batches_tracked"] = np.array(0)
    block.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in sd.items()})
    return block


@pytest.mark.parametrize("C,H,W", [(64, 6, 5), (128, 5, 4)])
def test_plain_matches_jax_resblock(C, H, W):
    x, variables = _jax_block(C, H, W, seed=C)
    ref = np.asarray(JaxBlock(filters=C).apply(variables, jnp.asarray(x)))
    block = _port_block(variables, C)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        fused = fused_resblock_plain(xt, *block.fused_operands())
        unfused = block(xt)
    np.testing.assert_allclose(fused.numpy().transpose(0, 2, 3, 1), ref, **TOL)
    np.testing.assert_allclose(unfused.numpy().transpose(0, 2, 3, 1), ref,
                               **TOL)


def test_fold_bn_matches_eval_batchnorm():
    block = _port_block(_jax_block(64, 3, 3, seed=1)[1], 64)
    x = torch.randn(2, 64, 3, 3, generator=torch.Generator().manual_seed(0))
    g, b = fold_bn(block.bn0)
    with torch.no_grad():
        ref = block.bn0(x)
        got = x * g[:, None, None] + b[:, None, None]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_fused_operands_follow_weight_updates():
    block = _port_block(_jax_block(64, 3, 3, seed=2)[1], 64)
    first = block.fused_operands()
    assert block.fused_operands() is first             # cached
    assert first[0].shape == (3, 3, 64, 64) and first[2].shape == (4, 1, 64, 64)
    with torch.no_grad():
        block.bn1.running_var.mul_(2.0)                # in-place update
    second = block.fused_operands()
    assert second is not first
    assert not torch.equal(second[6], first[6])        # g2 refolded
    block.load_state_dict(block.state_dict())          # copies in place
    assert block.fused_operands() is not second


def test_cpu_forward_takes_the_plain_composition():
    """On the CPU the block never reaches the kernel wrapper's launch; the
    wrapper itself serves CPU tensors with the plain version."""
    block = _port_block(_jax_block(64, 4, 3, seed=3)[1], 64)
    x = torch.randn(1, 64, 4, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = block(x)
        b = fused_resblock_cuda(x, *block.fused_operands())
    assert fused_resblock_cuda.launches == 0
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("channels,ok", [(1, True), (6, True), (128, True),
                                         (FUSED_MAX_CHANNELS, True),
                                         (FUSED_MAX_CHANNELS + 1, False),
                                         (0, False)])
def test_block_width_bound(channels, ok):
    """The kernel's smallest tile (4 rows x 1 column) of a width fits 227 KB
    of shared memory up to FUSED_MAX_CHANNELS; a predictor for the card
    refuses a wider model when it is built, before any weights load."""
    assert 424 * FUSED_MAX_CHANNELS <= 227 * 1024 < 424 * (FUSED_MAX_CHANNELS
                                                          + 1)
    cfg = OverlapModelConfig(stage_filters=(4, channels))
    if ok:
        check_block_width(channels)
        return
    with pytest.raises(ValueError, match="fused residual block"):
        check_block_width(channels)
    with pytest.raises(ValueError, match="fused residual block"):
        OverlapPredictor({}, cfg, device="cuda")


@pytest.mark.parametrize("channels,route", [
    (3, "ffma"), (4, "ffma"), (8, "mma"), (12, "ffma"), (32, "mma"),
    (64, "mma"), (128, "mma"), (256, "mma")])
def test_block_route(channels, route):
    """Every width with C % 8 == 0 takes the tensor-core kernel, any other
    the FFMA kernel: the rule looks at the width only."""
    assert block_route(channels) == route


def _check_plan(plan, C, H, W, smem_limit):
    assert plan.rows * plan.row_tiles >= H > plan.rows * (plan.row_tiles - 1)
    assert plan.cols * plan.col_tiles >= W > plan.cols * (plan.col_tiles - 1)
    assert plan.mt in MMA_TILE_M and plan.kc % 8 == 0 and plan.kc > 0
    assert plan.smem_bytes == block_smem_bytes(C, plan.rows, plan.cols,
                                               plan.kc)
    assert plan.smem_bytes <= 227 * 1024
    assert plan.ctas_per_sm * (plan.smem_bytes + 1024) <= smem_limit


@pytest.mark.parametrize("batch", [1, 64, 200, 480])
@pytest.mark.parametrize("C,H,W", FULL_WIDTH)
def test_plan_full_width(C, H, W, batch):
    """At the full-width model's stages the tiles cover the image exactly,
    fit Hopper's shared memory, and let two CTAs share an SM; from B=64 on,
    whole image columns (no middle row computed twice)."""
    plan = plan_block_tiles(C, H, W, SM_SHARED_BYTES, batch, H100_SMS)
    _check_plan(plan, C, H, W, SM_SHARED_BYTES)
    assert plan.ctas_per_sm >= 2
    assert 2 * (plan.smem_bytes + 1024) <= SM_SHARED_BYTES
    if batch >= 64:
        assert plan.rows == H and plan.kc >= 24


@pytest.mark.parametrize("smem_limit", [SM_SHARED_BYTES, 160_000, 100_000])
@pytest.mark.parametrize("C,H,W", [(128, 64, 76), (256, 16, 19),
                                   (FUSED_MAX_CHANNELS // 8 * 8, 16, 19)])
def test_plan_respects_limit(C, H, W, smem_limit):
    """A wide block on a large image, or a card with less shared memory,
    gets tiles that fit; one CTA per SM only when two cannot fit."""
    for batch in (1, 480):
        plan = plan_block_tiles(C, H, W, smem_limit, batch, H100_SMS)
        _check_plan(plan, C, H, W, smem_limit)
        if smem_limit == SM_SHARED_BYTES:
            assert plan.ctas_per_sm == 2


def test_plan_rejects_ffma_widths():
    with pytest.raises(ValueError, match="C % 8 == 0"):
        plan_block_tiles(12, 8, 9, SM_SHARED_BYTES, 1, H100_SMS)


@pytest.mark.parametrize("batch", [1, 8, 64])
@pytest.mark.parametrize("C,H,W", FULL_WIDTH)
def test_plan_is_last_tiling_of_one_wave(C, H, W, batch):
    """The tilings start at whole image columns and, as they go, compute no
    fewer middle rows an output row and give no fewer CTAs; the plan is the
    last whose CTAs fit one to an SM, or the first if none does."""
    tilings = block_tilings(C, H, W)
    assert tilings[0].rows == H
    recompute = [min(p.rows + 3, H) / p.rows for p in tilings]
    ctas = [batch * p.row_tiles * p.col_tiles for p in tilings]
    assert recompute == sorted(recompute) and ctas == sorted(ctas)
    plan = plan_block_tiles(C, H, W, SM_SHARED_BYTES, batch, H100_SMS)
    i = tilings.index(plan)
    if ctas[0] > H100_SMS:
        assert i == 0
    else:
        assert ctas[i] <= H100_SMS
        assert i + 1 == len(tilings) or ctas[i + 1] > H100_SMS
