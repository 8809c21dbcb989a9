"""The port's multi-process data parallelism (``parallel/distributed.py``,
``Trainer.fit(mesh=)``) in two gloo processes on the CPU, the counterpart of
``tests/test_dcn.py`` and ``tests/test_parallel_training.py``.

Two worker processes join one process group over a local socket, build
``global_mesh`` (a data axis of one device a rank) and run, in turn:

* ``host_local_batch_to_global`` of each rank's half of a batch and a
  ``DataParallel`` row program on it (each rank gets its own rows; a
  reduction over the batch raises);
* one ``train_step`` of a linear model on each rank's half with the
  gradients all-reduced, against ``jax.grad`` of the whole batch's mean
  squared error (atol 1e-6);
* ``Trainer.fit(mesh=)`` with SGD, dropout active, train-mode BatchNorm, the
  Keras l2 penalty and a partial last batch, from a host-local corpus,
  against the port's one-process fit of the whole corpus (history and
  parameters rtol 1e-4 / atol 1e-5, the tolerance of ``test_dcn.py``;
  both ranks' parameters equal bit for bit);
* ``Trainer.fit(mesh=)`` with RMSprop and JAX's permutations against JAX's
  ``Trainer.fit(mesh=make_mesh())`` on its 8 CPU devices, at the
  tolerances and trunk-conv-bias rule of ``tests/test_torch_train.py``
  (dropout off: the two frameworks draw different masks).

The workers run once for the module; each test reads its part.  Every
worker is bounded by ``communicate(timeout=...)`` and all are killed on a
timeout.  Skips only where a local socket cannot bind.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmla_audio_tpu.models.speaker import SpeakerResBLSTM as JaxSpeaker
from mmla_audio_tpu.models.speaker import l2_penalty as jax_l2_penalty
from mmla_audio_tpu.parallel import make_mesh as jax_make_mesh
from mmla_audio_tpu.train import losses as jax_losses
from mmla_audio_tpu.train import optimizers as jax_optimizers
from mmla_audio_tpu.train.trainer import Trainer as JaxTrainer
from mmla_audio_torch.models.speaker import SpeakerResBLSTM, l2_penalty
from mmla_audio_torch.params import speaker_tree_from_state_dict
from mmla_audio_torch.train import losses
from mmla_audio_torch.train.trainer import Trainer
from tests.test_torch_model import as_port
from tests.test_torch_speaker import perturbed_speaker_tree
from tests.test_torch_train import (NARROW, _jax_permutations,
                                    assert_trees_close, port_model,
                                    toy_data)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
WORKER_TIMEOUT = 240
# the SGD fit: the narrow model with its dropouts on, 22 rows at batch 8
# (the last batch 6 real rows + 2 padding), the corpus 11 rows a rank
DROPOUT = dataclasses.replace(as_port(NARROW), dropout_trunk=0.25,
                              dropout_head=0.2)
SGD_LR = 1e-2

_WORKER = r"""
import sys

import torch

torch.set_num_threads(1)
coord, pid, inp, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]

from mmla_audio_torch.core.config import SpeakerModelConfig
from mmla_audio_torch.models.speaker import SpeakerResBLSTM, l2_penalty
from mmla_audio_torch.parallel import DataParallel
from mmla_audio_torch.parallel import distributed as dist
from mmla_audio_torch.train import losses, optimizers
from mmla_audio_torch.train.trainer import Trainer

dist.initialize(coord, 2, pid, device="cpu")
dist.initialize(coord, 2, pid, device="cpu")          # idempotent
assert dist.process_info() == (pid, 2), dist.process_info()
mesh = dist.global_mesh(device="cpu")
assert mesh.devices.shape == (2, 1) and mesh.group is not None
data = torch.load(inp, weights_only=False)
res = {}

# a host-local batch and a row program: each rank holds and gets its rows
full = torch.arange(16 * 5, dtype=torch.float32).reshape(16, 5)
mine = full[pid * 8:(pid + 1) * 8]
xg = dist.host_local_batch_to_global(mine.numpy(), mesh)
assert xg.shape == (16, 5) and len(xg.shards) == 1
assert torch.equal(xg.shards[0], mine)
state = torch.arange(5, dtype=torch.float32) + 1.0
res["rows"] = DataParallel(lambda s, x: x @ s, mesh)(state, xg)
res["gathered"] = xg.gather()
try:
    DataParallel(lambda s, x: (x @ s).mean(), mesh)(state, xg)
    res["reduction"] = "ran"
except ValueError:
    res["reduction"] = "raised"

# the gradient all-reduce: one step on this rank's half of 32 rows
lin = data["linear"]
model = torch.nn.Linear(8, 1, bias=False)
with torch.no_grad():
    model.weight.copy_(lin["w"].T)
tr = Trainer(model, lambda p: torch.optim.SGD(p, lr=0.0),
             lambda o, t: ((o - t) ** 2).sum(-1), device="cpu")
half = slice(pid * 16, (pid + 1) * 16)
tr.train_step(lin["x"][half], lin["y"][half], torch.ones(16),
              torch.tensor(32.0), pid == 0, mesh.group)
res["grad"] = model.weight.grad.T.clone()

def fit(case, tx, per_rank):
    c = data[case]
    cfg = SpeakerModelConfig(**c["cfg"])
    model = SpeakerResBLSTM(cfg)
    model.load_state_dict(c["sd"])
    tr = Trainer(model, tx, losses.keras_categorical_crossentropy,
                 extra_penalty_fn=lambda m: l2_penalty(m, cfg), device="cpu")
    x, y = c["x"], c["y"]
    if per_rank:
        n = x.shape[0] // 2
        x, y = (dist.host_local_batch_to_global(a[pid * n:(pid + 1) * n],
                                                mesh) for a in (x, y))
    hist = tr.fit(x, y, epochs=2, batch_size=8, x_val=c.get("xv"),
                  y_val=c.get("yv"), permutations=c.get("perms"), mesh=mesh)
    return {"hist": hist, "sd": tr.variables_of()}

res["sgd"] = fit("sgd", lambda p: torch.optim.SGD(p, lr=data["sgd"]["lr"]),
                 True)
res["jax"] = fit("jax", optimizers.rmsprop(1e-4), False)
torch.save(res, out)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", 0))
        except OSError:
            pytest.skip("local sockets cannot bind here")
        return s.getsockname()[1]


def _sgd_case():
    """The SGD fit's seeded model and corpus (22 rows) and validation."""
    torch.manual_seed(4)
    sd = SpeakerResBLSTM(DROPOUT).state_dict()
    x, y = toy_data(22, seed=11)
    xv, yv = toy_data(6, seed=12)
    return dict(cfg=dataclasses.asdict(DROPOUT), sd=sd, lr=SGD_LR,
                **{k: torch.from_numpy(v) for k, v in
                   dict(x=x, y=y, xv=xv, yv=yv).items()})


def _port_single_fit(case):
    """The one-process fit the two ranks must equal."""
    model = SpeakerResBLSTM(DROPOUT)
    model.load_state_dict(case["sd"])
    tr = Trainer(model, lambda p: torch.optim.SGD(p, lr=SGD_LR),
                 losses.keras_categorical_crossentropy,
                 extra_penalty_fn=lambda m: l2_penalty(m, DROPOUT),
                 device="cpu")
    hist = tr.fit(case["x"], case["y"], epochs=2, batch_size=8,
                  x_val=case["xv"], y_val=case["yv"])
    return hist, tr.variables_of()


def _jax_mesh_fit(tree, x, y, rng):
    """JAX's data-parallel fit on its 8 CPU devices."""
    jt = JaxTrainer(JaxSpeaker(NARROW), jax_optimizers.rmsprop(1e-4),
                    jax_losses.keras_categorical_crossentropy,
                    extra_penalty_fn=lambda p: jax_l2_penalty(p, NARROW))
    state = jt.init_state(jax.tree_util.tree_map(jnp.asarray, tree))
    state, hist = jt.fit(state, x, y, epochs=2, batch_size=8, rng=rng,
                         mesh=jax_make_mesh())
    ref = {"params": state.params, "batch_stats": state.batch_stats}
    return hist, jax.tree_util.tree_map(np.asarray, ref)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Run both workers once; (their results by rank, the references)."""
    tmp = tmp_path_factory.mktemp("dcn")
    coord = f"127.0.0.1:{_free_port()}"
    rng = np.random.RandomState(1)
    linear = {k: torch.from_numpy(rng.randn(*shape).astype(np.float32))
              for k, shape in (("w", (8, 1)), ("x", (32, 8)),
                               ("y", (32, 1)))}
    sgd = _sgd_case()
    tree = perturbed_speaker_tree(NARROW, seed=5, input_shape=(64, 39))
    jx, jy = toy_data(24, seed=8)
    jrng = jax.random.PRNGKey(3)
    jax_case = dict(cfg=dataclasses.asdict(as_port(NARROW)),
                    sd=port_model(tree).state_dict(),
                    x=torch.from_numpy(jx), y=torch.from_numpy(jy),
                    perms=_jax_permutations(jrng, 2, 24))
    inp = tmp / "inputs.pt"
    torch.save(dict(linear=linear, sgd=sgd, jax=jax_case), inp)
    worker = tmp / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, str(worker), coord, str(pid), str(inp),
         str(tmp / f"out{pid}.pt")], cwd=str(REPO), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in range(2)]
    try:
        # the references, while the workers run
        refs = dict(
            linear=linear,
            sgd=_port_single_fit(sgd),
            jax=_jax_mesh_fit(tree, jx, jy, jrng),
            grad=np.asarray(jax.grad(
                lambda w, a, b: jnp.mean((a @ w - b) ** 2))(
                    *(jnp.asarray(linear[k].numpy())
                      for k in ("w", "x", "y")))))
        logs = []
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
    outs = [torch.load(tmp / f"out{pid}.pt", weights_only=False)
            for pid in range(2)]
    return outs, refs


def test_host_local_batch_and_data_parallel(two_ranks):
    outs, _ = two_ranks
    full = torch.arange(16 * 5, dtype=torch.float32).reshape(16, 5)
    state = torch.arange(5, dtype=torch.float32) + 1.0
    for pid, out in enumerate(outs):
        torch.testing.assert_close(out["rows"],
                                   full[pid * 8:(pid + 1) * 8] @ state,
                                   rtol=1e-6, atol=0)
        assert torch.equal(out["gathered"], full)
        assert out["reduction"] == "raised"


def test_gradient_all_reduce_matches_jax(two_ranks):
    """Each rank's half-batch gradient, normalised by the global row count
    and summed over the ranks, is ``jax.grad`` of the whole batch's mean."""
    outs, refs = two_ranks
    for out in outs:
        np.testing.assert_allclose(out["grad"].numpy(), refs["grad"],
                                   atol=1e-6)


def test_two_process_fit_matches_single_process(two_ranks):
    """SGD, dropout on, BatchNorm, l2 penalty, a partial last batch, a
    host-local corpus: equal to the one-process fit of the whole corpus."""
    outs, refs = two_ranks
    hist, sd = refs["sgd"]
    for out in outs:
        for key in ("loss", "acc", "val_loss", "val_acc"):
            np.testing.assert_allclose(out["sgd"]["hist"][key], hist[key],
                                       rtol=1e-4, atol=1e-5, err_msg=key)
        assert out["sgd"]["sd"].keys() == sd.keys()
        for k in sd:
            np.testing.assert_allclose(out["sgd"]["sd"][k].numpy(),
                                       sd[k].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    # the parameters moved well beyond the tolerance
    moved = max(float((sd[k].float() - v.float()).abs().max())
                for k, v in _sgd_case()["sd"].items())
    assert moved > 100 * 1e-5
    for k, v in outs[0]["sgd"]["sd"].items():       # the ranks agree exactly
        assert torch.equal(v, outs[1]["sgd"]["sd"][k]), k


def test_two_process_mesh_fit_matches_jax_mesh_fit(two_ranks):
    """The port's fit across two processes against JAX's across its 8 CPU
    devices, JAX's permutations injected: history rtol 1e-4, the trees at
    ``test_torch_train``'s tolerances (6 RMSprop steps at 1e-4)."""
    outs, refs = two_ranks
    hist, ref = refs["jax"]
    for out in outs:
        np.testing.assert_allclose(out["jax"]["hist"]["loss"], hist["loss"],
                                   rtol=1e-4)
        assert out["jax"]["hist"]["acc"] == pytest.approx(hist["acc"],
                                                          abs=1e-6)
        got = speaker_tree_from_state_dict(out["jax"]["sd"], as_port(NARROW))
        assert_trees_close(got, ref, steps=6, lr=1e-4)
