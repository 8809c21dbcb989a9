"""The port's tensor parallelism: ``parallel.param_shardings`` against the
JAX package's rule, and ``Trainer.fit`` on a mesh whose model axis spans
processes (``distributed.global_mesh(n_model=2)``) in two gloo processes
on the CPU, the ``two_ranks`` pattern of ``tests/test_torch_dcn.py``.

The two workers join one process group over a local socket, build a (1, 2)
mesh (one data coordinate, the parameters split in two) and run, from one
seeded narrow speaker model and Keras RMSprop:

* ``shard_params``: each rank's block of every split parameter;
* one step (one batch of 8 rows), against the one-process fit of the same
  batch (within 1e-6: the ranks compute the whole gradient, so the only
  difference could be the gather);
* three epochs of 22 rows at batch 8 (a partial last batch, a validation
  split), history and every parameter and statistic against the
  one-process fit within rtol 1e-5;
* the optimizer's state after the fit: for every split parameter only its
  block, on both ranks, the two blocks together the parameter's rows.

The workers run once for the module; each test reads its part.  Every
worker is bounded by ``communicate(timeout=...)`` and all are killed on a
timeout.  Skips only where a local socket cannot bind.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mmla_audio_tpu.parallel import make_mesh as jax_make_mesh
from mmla_audio_tpu.parallel import param_shardings as jax_param_shardings
from mmla_audio_torch.core.config import SpeakerModelConfig
from mmla_audio_torch.models.speaker import SpeakerResBLSTM, l2_penalty
from mmla_audio_torch.parallel import make_mesh, param_shardings, shard_params
from mmla_audio_torch.params import speaker_tree_from_state_dict
from mmla_audio_torch.train import losses, optimizers
from mmla_audio_torch.train.trainer import Trainer
from tests.test_torch_dcn import _free_port
from tests.test_torch_model import as_port
from tests.test_torch_train import NARROW, toy_data

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
WORKER_TIMEOUT = 240
CPU = torch.device("cpu")
CFG = as_port(NARROW)
LR = 1e-3
EPOCHS, ROWS, BATCH = 3, 22, 8
STEP_ATOL = 1e-6
FIT_RTOL, FIT_ATOL = 1e-5, 1e-6
# the (2, 2) grid: SGD (no preconditioner to amplify the data axis's other
# summation order), at the tolerance of tests/test_torch_dcn.py
GRID_LR, GRID_RTOL, GRID_ATOL = 1e-2, 1e-4, 1e-5

_WORKER = r"""
import sys

import torch

torch.set_num_threads(1)
coord, pid, inp, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]

from mmla_audio_torch.core.config import SpeakerModelConfig
from mmla_audio_torch.models.speaker import SpeakerResBLSTM, l2_penalty
from mmla_audio_torch.parallel import distributed as dist, shard_params
from mmla_audio_torch.train import losses, optimizers
from mmla_audio_torch.train.trainer import Trainer

dist.initialize(coord, 2, pid, device="cpu")
mesh = dist.global_mesh(n_model=2, device="cpu")
assert mesh.devices.shape == (1, 2), mesh.devices.shape
assert mesh.group is not None and mesh.model_group is not None
data = torch.load(inp, weights_only=False)
cfg = SpeakerModelConfig(**data["cfg"])
res = {"blocks": {k: v[0] for k, v in shard_params(
    data["sd"], mesh).items()}}


def trainer():
    model = SpeakerResBLSTM(cfg)
    model.load_state_dict(data["sd"])
    return Trainer(model, optimizers.rmsprop(data["lr"]),
                   losses.keras_categorical_crossentropy,
                   extra_penalty_fn=lambda m: l2_penalty(m, cfg),
                   device="cpu")


tr = trainer()
tr.fit(data["x"][:8], data["y"][:8], epochs=1, batch_size=8, mesh=mesh)
res["step"] = tr.variables_of()
tr = trainer()
res["hist"] = tr.fit(data["x"], data["y"], epochs=data["epochs"],
                     batch_size=8, x_val=data["xv"], y_val=data["yv"],
                     permutations=data["perms"], mesh=mesh)
res["fit"] = tr.variables_of()
names = {id(p): n for n, p in tr.model.named_parameters()}
blocks = {id(b) for _, b in tr._blocks.pairs}
# every master's optimizer state shapes; the split ones' blocks after the fit
res["state"] = [(tuple(m.shape), id(m) in blocks,
                 {k: tuple(v.shape) for k, v in tr.optimizer.state[m].items()
                  if isinstance(v, torch.Tensor) and v.ndim})
                for m in tr._blocks.masters]
res["blocks_after"] = {names[id(p)]: b.detach().clone()
                       for p, b in tr._blocks.pairs}
torch.save(res, out)
torch.distributed.destroy_process_group()
"""


def _trainer(sd):
    model = SpeakerResBLSTM(CFG)
    model.load_state_dict(sd)
    return Trainer(model, optimizers.rmsprop(LR),
                   losses.keras_categorical_crossentropy,
                   extra_penalty_fn=lambda m: l2_penalty(m, CFG),
                   device="cpu")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both workers' results by rank, and the one-process references."""
    tmp = tmp_path_factory.mktemp("tp")
    torch.manual_seed(7)
    sd = SpeakerResBLSTM(CFG).state_dict()
    x, y = toy_data(ROWS, seed=21)
    xv, yv = toy_data(6, seed=22)
    rng = np.random.RandomState(23)
    perms = [rng.permutation(-(-ROWS // BATCH) * BATCH)
             for _ in range(EPOCHS)]
    case = dict(cfg=dataclasses.asdict(CFG), sd=sd, lr=LR, epochs=EPOCHS,
                perms=perms, **{k: torch.from_numpy(v) for k, v in
                                dict(x=x, y=y, xv=xv, yv=yv).items()})
    procs = _spawn(tmp, _WORKER, 2, case)
    try:
        # the one-process references, while the workers run
        tr = _trainer(sd)
        tr.fit(case["x"][:8], case["y"][:8], epochs=1, batch_size=BATCH)
        step = tr.variables_of()
        tr = _trainer(sd)
        hist = tr.fit(case["x"], case["y"], epochs=EPOCHS, batch_size=BATCH,
                      x_val=case["xv"], y_val=case["yv"], permutations=perms)
        refs = dict(sd=sd, step=step, hist=hist, fit=tr.variables_of())
    finally:
        outs = _collect(procs, tmp)
    return outs, refs


def _spawn(tmp, source, world, case):
    """Start ``world`` workers running ``source`` on ``case``."""
    coord = f"127.0.0.1:{_free_port()}"
    inp = tmp / "inputs.pt"
    torch.save(case, inp)
    worker = tmp / "worker.py"
    worker.write_text(source)
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    return [subprocess.Popen(
        [sys.executable, str(worker), coord, str(pid), str(inp),
         str(tmp / f"out{pid}.pt"), str(world)], cwd=str(REPO), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in range(world)]


def _collect(procs, tmp):
    """Wait for the workers (each bounded, all killed on a timeout) and
    read their results by rank."""
    logs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=WORKER_TIMEOUT)
            logs.append(err.decode(errors="replace")[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if any(p.returncode for p in procs):
        raise AssertionError(
            f"workers failed rc={[p.returncode for p in procs]}:\n"
            + "\n---\n".join(logs))
    return [torch.load(tmp / f"out{pid}.pt", weights_only=False)
            for pid in range(len(procs))]


_GRID_WORKER = r"""
import sys

import torch

torch.set_num_threads(1)
coord, pid, inp, out, world = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
    sys.argv[4], int(sys.argv[5])

from mmla_audio_torch.core.config import SpeakerModelConfig
from mmla_audio_torch.models.speaker import SpeakerResBLSTM, l2_penalty
from mmla_audio_torch.parallel import distributed as dist
from mmla_audio_torch.train import losses
from mmla_audio_torch.train.trainer import Trainer

dist.initialize(coord, world, pid, device="cpu")
mesh = dist.global_mesh(n_model=2, device="cpu")
data = torch.load(inp, weights_only=False)
cfg = SpeakerModelConfig(**data["cfg"])
model = SpeakerResBLSTM(cfg)
model.load_state_dict(data["sd"])
tr = Trainer(model, lambda p: torch.optim.SGD(p, lr=data["lr"]),
             losses.keras_categorical_crossentropy,
             extra_penalty_fn=lambda m: l2_penalty(m, cfg), device="cpu")
hist = tr.fit(data["x"], data["y"], epochs=data["epochs"], batch_size=8,
              permutations=data["perms"], mesh=mesh)
torch.save({"hist": hist, "sd": tr.variables_of(),
            "shape": mesh.devices.shape,
            "groups": (torch.distributed.get_rank(mesh.group),
                       torch.distributed.get_rank(mesh.model_group))}, out)
torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def grid_ranks(tmp_path_factory):
    """Four workers on a (2, 2) grid fitting with SGD (the batch split over
    the data axis, the parameters over the model axis), and the
    one-process fit."""
    tmp = tmp_path_factory.mktemp("tp4")
    torch.manual_seed(8)
    sd = SpeakerResBLSTM(CFG).state_dict()
    x, y = toy_data(ROWS, seed=31)
    rng = np.random.RandomState(32)
    perms = [rng.permutation(-(-ROWS // BATCH) * BATCH) for _ in range(2)]
    case = dict(cfg=dataclasses.asdict(CFG), sd=sd, lr=GRID_LR, epochs=2,
                perms=perms, x=torch.from_numpy(x), y=torch.from_numpy(y))
    procs = _spawn(tmp, _GRID_WORKER, 4, case)
    try:
        model = SpeakerResBLSTM(CFG)
        model.load_state_dict(sd)
        tr = Trainer(model, lambda p: torch.optim.SGD(p, lr=GRID_LR),
                     losses.keras_categorical_crossentropy,
                     extra_penalty_fn=lambda m: l2_penalty(m, CFG),
                     device="cpu")
        hist = tr.fit(case["x"], case["y"], epochs=2, batch_size=BATCH,
                      permutations=perms)
        ref = (hist, tr.variables_of(), sd)
    finally:
        outs = _collect(procs, tmp)
    return outs, ref


def test_two_by_two_grid_fit_equals_unsplit(grid_ranks):
    """A (2, 2) grid: rank r at (r // 2, r % 2), its data and model groups;
    the fit equals the one-process fit at the tolerance of the data-parallel
    fit (``tests/test_torch_dcn.py``: the gradients are summed across two
    ranks in another order), every rank's parameters the same bits."""
    outs, (hist, sd, init) = grid_ranks
    for r, out in enumerate(outs):
        assert out["shape"] == (2, 2)
        assert out["groups"] == (r // 2, r % 2)
        for key in ("loss", "acc"):
            np.testing.assert_allclose(out["hist"][key], hist[key],
                                       rtol=GRID_RTOL, atol=GRID_ATOL)
        for k, v in sd.items():
            torch.testing.assert_close(out["sd"][k], v, rtol=GRID_RTOL,
                                       atol=GRID_ATOL, msg=k)
            assert torch.equal(out["sd"][k], outs[0]["sd"][k]), k
    moved = max(float((sd[k] - init[k].float()).abs().max())
                for k in sd if init[k].is_floating_point())
    assert moved > 100 * GRID_ATOL


def _fill(cfg, head_units=None):
    """A model's state dict with each tensor filled with its own index + 1,
    so that a converted leaf names its tensor."""
    sd = SpeakerResBLSTM(cfg, head_units).state_dict()
    return {k: torch.full_like(v, float(i + 1)) if v.is_floating_point()
            else v for i, (k, v) in enumerate(sd.items())}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("width,n_model", [("narrow", 2), ("narrow", 4),
                                           ("full", 2), ("full", 4)])
def test_param_shardings_match_jax(width, n_model):
    """The port's rule splits exactly the tensors that JAX's rule splits on
    the converted tree (each JAX leaf traced to its tensor by value), and
    replicates the rest."""
    cfg = CFG if width == "narrow" else SpeakerModelConfig()
    sd = _fill(cfg)
    names = list(sd)
    ours = param_shardings(sd, make_mesh(8 // n_model, n_model,
                                         devices=[CPU] * 8))
    jmesh = jax_make_mesh(8 // n_model, n_model)
    tree = speaker_tree_from_state_dict(sd, cfg)
    theirs = jax_param_shardings(tree, jmesh)
    specs = dict(_leaves(theirs))
    split_jax, seen = set(), set()
    for path, leaf in _leaves(tree):
        spec = specs[path].spec
        if np.ndim(leaf) < 2:
            assert all(a is None for a in spec), path
            continue
        name = names[int(np.asarray(leaf).flat[0]) - 1]
        seen.add(name)
        if any(a is not None for a in spec):
            split_jax.add(name)
    split_ours = {n for n, d in ours.items() if d is not None}
    assert split_ours == split_jax
    assert all(ours[n] == 0 for n in split_ours)
    assert seen == {n for n, t in sd.items() if t.ndim >= 2}
    assert split_ours, "the rule split nothing"


def test_param_shardings_module_and_axis_of_one():
    model = SpeakerResBLSTM(CFG)
    got = param_shardings(model, make_mesh(4, 2, devices=[CPU] * 8))
    assert set(got) == {n for n, _ in model.named_parameters()}
    assert got["head.weight"] is None and got["head.bias"] is None
    assert not any(param_shardings(model, make_mesh(
        devices=[CPU] * 8)).values())


def test_shard_params_one_process():
    """In one process each name has one block per model coordinate, on the
    first data row's devices; the blocks of a split tensor rebuild it."""
    sd = SpeakerResBLSTM(CFG).state_dict()
    mesh = make_mesh(4, 2, devices=[CPU] * 8)
    blocks = shard_params(sd, mesh)
    split = param_shardings(sd, mesh)
    for name, t in sd.items():
        assert len(blocks[name]) == 2
        if split[name] is None:
            assert all(torch.equal(b, t) for b in blocks[name])
        else:
            assert torch.equal(torch.cat(blocks[name]), t)


def test_shard_params_across_ranks(two_ranks):
    outs, refs = two_ranks
    for name, t in refs["sd"].items():
        got = [out["blocks"][name] for out in outs]
        if got[0].shape == t.shape:
            assert all(torch.equal(g, t) for g in got), name
        else:
            assert torch.equal(torch.cat(got), t), name


def test_one_step_equals_unsplit(two_ranks):
    outs, refs = two_ranks
    for out in outs:
        for k, v in refs["step"].items():
            torch.testing.assert_close(out["step"][k], v, rtol=0,
                                       atol=STEP_ATOL, msg=k)
    # the step moved the parameters well beyond the tolerance
    moved = max(float((refs["step"][k] - refs["sd"][k].float()).abs().max())
                for k in refs["step"] if refs["sd"][k].is_floating_point())
    assert moved > 100 * STEP_ATOL


def test_three_epochs_equal_unsplit(two_ranks):
    outs, refs = two_ranks
    for out in outs:
        for key in ("loss", "acc", "val_loss", "val_acc"):
            np.testing.assert_allclose(out["hist"][key], refs["hist"][key],
                                       rtol=FIT_RTOL, atol=FIT_ATOL,
                                       err_msg=key)
        for k, v in refs["fit"].items():
            torch.testing.assert_close(out["fit"][k], v, rtol=FIT_RTOL,
                                       atol=FIT_ATOL, msg=k)
    for k in refs["fit"]:
        assert torch.equal(outs[0]["fit"][k], outs[1]["fit"][k]), k


def test_optimizer_state_holds_only_blocks(two_ranks):
    """Each rank's optimizer steps its blocks: the state of every split
    parameter is its block's shape (half the rows), that of every other
    parameter the whole parameter's; the two ranks' blocks after the fit
    are the fitted parameter's two halves."""
    outs, refs = two_ranks
    split = {n for n, d in param_shardings(SpeakerResBLSTM(CFG), make_mesh(
        1, 2, devices=[CPU] * 2)).items() if d is not None}
    whole = {n: tuple(p.shape)
             for n, p in SpeakerResBLSTM(CFG).named_parameters()
             if p.requires_grad}
    for out in outs:
        assert set(out["blocks_after"]) == split
        n_split = sum(is_block for _, is_block, _ in out["state"])
        assert n_split == len(split) and len(out["state"]) == len(whole)
        for shape, is_block, state in out["state"]:
            assert state and all(s == shape for s in state.values())
        for name, block in out["blocks_after"].items():
            assert 2 * block.shape[0] == whole[name][0]
    for name in split:
        torch.testing.assert_close(
            torch.cat([outs[0]["blocks_after"][name],
                       outs[1]["blocks_after"][name]]),
            refs["fit"][name], rtol=FIT_RTOL, atol=FIT_ATOL, msg=name)
