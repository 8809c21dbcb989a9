"""The port's meshes and one-process data parallelism on the CPU, against
the JAX package's on its 8-device virtual CPU mesh (the counterpart of
``tests/test_parallel.py``'s data-parallel cases), the single-process paths
of ``parallel/distributed.py``, and the mesh rules of ``Trainer.fit``.

A port mesh on the CPU lists ``torch.device("cpu")`` once a shard.
Tolerances: ``DataParallel`` inference probabilities atol 2e-5 against
JAX's (``test_parallel.py``'s), labels equal; against the port's own
unsplit predictor labels equal, probabilities atol 1e-6 (each shard runs
the same row-independent program, but the CPU's convolution kernels block
their sums by the batch, so a 2-row shard rounds otherwise than the 16-row
batch); a one-device mesh fit bit for bit the ``mesh=None`` fit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmla_audio_tpu.core.config import OverlapModelConfig
from mmla_audio_tpu.inference import OverlapPredictor as JaxPredictor
from mmla_audio_tpu.parallel import DataParallel as JaxDataParallel
from mmla_audio_tpu.parallel import distributed as jax_dist
from mmla_audio_tpu.parallel import make_mesh as jax_make_mesh
from mmla_audio_tpu.parallel import shard_batch as jax_shard_batch
from mmla_audio_torch.core.config import MeshConfig
from mmla_audio_torch.inference import OverlapPredictor
from mmla_audio_torch.parallel import (DataParallel, ShardedBatch,
                                       batch_sharding, distributed,
                                       make_mesh, replicate_tree, replicated,
                                       shard_batch)
from mmla_audio_torch.params import overlap_state_dict_from_jax
from mmla_audio_torch.train import losses, optimizers
from mmla_audio_torch.train.trainer import Trainer
from tests.test_torch_model import as_port, perturbed_tree
from tests.test_torch_train import port_model, toy_data

torch.set_num_threads(1)

CPU = torch.device("cpu")


def test_mesh_shapes_match_jax():
    """-1 takes every device, explicit sizes win, too few devices raise."""
    for kw in ({}, {"n_data": 4, "n_model": 2}, {"n_data": 2}):
        ours = make_mesh(devices=[CPU] * 8, **kw)
        theirs = jax_make_mesh(**kw)
        assert ours.devices.shape == theirs.devices.shape
        assert ours.axis_names == tuple(theirs.axis_names)
        assert ours.shape == dict(theirs.shape)
    cfg = MeshConfig(data_axis="batch", model_parallel=2)
    assert make_mesh(cfg=cfg, devices=[CPU] * 6).shape == {"batch": 3,
                                                            "model": 2}
    with pytest.raises(ValueError, match="need 4x3 devices"):
        make_mesh(4, 3, devices=[CPU] * 8)
    assert make_mesh(devices=[CPU] * 2) == make_mesh(devices=["cpu"] * 2)
    assert make_mesh(devices=[CPU] * 2) != make_mesh(devices=[CPU] * 4)


def test_make_mesh_needs_a_card_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_shard_batch_places_on_axis():
    """Equal row blocks, one a data-axis device, as JAX's shards are; the
    sharding compares equal to ``batch_sharding``; rows that do not divide
    raise."""
    mesh = make_mesh(devices=[CPU] * 8)
    x = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    xs = shard_batch(x, mesh)
    assert isinstance(xs, ShardedBatch) and xs.shape == (16, 4)
    assert xs.sharding == batch_sharding(mesh) != replicated(mesh)
    ref = jax_shard_batch(x, jax_make_mesh())
    theirs = sorted((s.index[0].start or 0, np.asarray(s.data))
                    for s in ref.addressable_shards)
    assert len(xs.shards) == len(theirs) == 8
    for got, (_, want) in zip(xs.shards, theirs):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(xs.gather().numpy(), x)
    with pytest.raises(ValueError, match="do not divide"):
        shard_batch(x[:12], mesh)


def test_replicate_tree_one_copy_per_distinct_device():
    mesh = make_mesh(devices=[CPU] * 4)
    model = torch.nn.Linear(3, 2)
    reps = replicate_tree(model, mesh)
    assert list(reps) == [CPU]
    assert reps[CPU] is model                    # already on its device
    tree = {"a": torch.ones(2), "b": {"c": torch.zeros(3)}}
    got = replicate_tree(tree, mesh)[CPU]
    assert torch.equal(got["b"]["c"], tree["b"]["c"])


@pytest.fixture(scope="module")
def predictors():
    """JAX's and the port's predictor of one perturbed narrow tree."""
    cfg = OverlapModelConfig(stage_filters=(4, 4, 8), lstm_units=8)
    tree = perturbed_tree(cfg, seed=0)
    return (JaxPredictor(jax.tree_util.tree_map(jnp.asarray, tree),
                         model_cfg=cfg),
            OverlapPredictor(overlap_state_dict_from_jax(tree, as_port(cfg)),
                             as_port(cfg), device="cpu"))


def test_data_parallel_inference_matches_jax(predictors):
    """The port's predictor on an 8-shard CPU mesh against JAX's
    ``DataParallel`` on its 8 CPU devices (labels equal, probabilities
    atol 2e-5) and against its own unsplit ``predict`` (labels equal,
    probabilities atol 1e-6)."""
    jax_pred, pred = predictors
    rng = np.random.RandomState(0)
    buf = (rng.randn(16, 40960) * 3000).astype(np.float32)
    n = np.full(16, 40960, np.int32)
    n[3] = 1000                                   # one silent window
    ref_labels, ref_probs = JaxDataParallel(jax_pred.lower_fn(),
                                            jax_make_mesh())(
        jax_pred.variables, jnp.asarray(buf), jnp.asarray(n))
    labels, probs = DataParallel(pred.lower_fn(),
                                 make_mesh(devices=[CPU] * 8))(
        pred.model, torch.from_numpy(buf), torch.from_numpy(n))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_labels))
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref_probs),
                               atol=2e-5)
    whole_labels, whole_probs = pred.predict(buf, n)
    assert torch.equal(labels, whole_labels) and labels[3] == -1
    np.testing.assert_allclose(probs.numpy(), whole_probs.numpy(),
                               atol=1e-6)


def test_data_parallel_refuses_a_reduction_over_the_batch():
    mesh = make_mesh(devices=[CPU] * 4)
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    w = torch.ones(3)
    rows = DataParallel(lambda s, a: a @ s, mesh)(w, x)
    assert torch.equal(rows, x @ w)
    with pytest.raises(ValueError, match="batch axis"):
        DataParallel(lambda s, a: (a @ s).sum(), mesh)(w, x)
    with pytest.raises(ValueError, match="batch axis"):
        DataParallel(lambda s, a: (a @ s, (a @ s)[:1]), mesh)(w, x)


def test_distributed_single_process_paths():
    """No process group: ``initialize`` is a no-op (twice), the rank is
    (0, 1), ``global_mesh`` is ``make_mesh`` over this process's devices and
    ``host_local_batch_to_global`` is ``shard_batch``, as in JAX's."""
    jax_dist.initialize()
    distributed.initialize(device="cpu")
    distributed.initialize(device="cpu")
    assert not distributed._initialized
    assert distributed.process_info() == jax_dist.process_info() == (0, 1)
    mesh = distributed.global_mesh(device="cpu")
    assert mesh.devices.shape == (1, 1) and mesh.group is None
    x = np.random.RandomState(0).randn(16, 5).astype(np.float32)
    xg = distributed.host_local_batch_to_global(x, mesh)
    np.testing.assert_array_equal(xg.gather().numpy(), x)
    np.testing.assert_array_equal(
        xg.gather().numpy(),
        np.asarray(jax_dist.host_local_batch_to_global(x, jax_make_mesh())))
    assert xg.sharding == batch_sharding(mesh)


def test_initialize_env_autodiscovery(monkeypatch):
    """torchrun's environment (``WORLD_SIZE`` > 1 with ``MASTER_ADDR``)
    joins through ``init_process_group``'s env:// default; a world of one
    or no master skips; explicit arguments go through tcp:// with all
    three; a partial set raises."""
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)

    def reset():
        monkeypatch.setattr(distributed, "_initialized", False)
        calls.clear()

    reset()
    distributed.initialize(device="cpu")            # clean environment
    assert not calls and not distributed._initialized
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    distributed.initialize(device="cpu")            # a world of one
    assert not calls and not distributed._initialized
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR")
    distributed.initialize(device="cpu")            # no master
    assert not calls
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("RANK", "1")
    distributed.initialize(device="cpu")
    assert calls == [(("gloo",), {})] and distributed._initialized
    distributed.initialize(device="cpu")            # idempotent
    assert len(calls) == 1

    reset()
    distributed.initialize("10.0.0.1:8476", 2, 1, device="cpu")
    assert calls == [(("gloo",), {"init_method": "tcp://10.0.0.1:8476",
                                  "world_size": 2, "rank": 1})]
    reset()
    with pytest.raises(ValueError, match="must be given together"):
        distributed.initialize(coordinator_address="10.0.0.1:8476")
    with pytest.raises(ValueError, match="must be given together"):
        distributed.initialize(num_processes=2, process_id=0)
    assert not calls and not distributed._initialized


def test_initialize_nccl_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(distributed, "_initialized", False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize("127.0.0.1:1", 1, 0)
    assert not torch.distributed.is_initialized()


def _trainer(tree, seed=0):
    return Trainer(port_model(tree), optimizers.rmsprop(1e-4),
                   losses.keras_categorical_crossentropy, device="cpu",
                   seed=seed)


@pytest.fixture(scope="module")
def narrow_tree():
    from tests.test_torch_speaker import perturbed_speaker_tree
    from tests.test_torch_train import NARROW

    return perturbed_speaker_tree(NARROW, seed=5, input_shape=(64, 39))


def test_fit_one_device_mesh_is_the_unsplit_fit(narrow_tree):
    """A one-process mesh of one device (listed once or several times)
    runs exactly as ``mesh=None``: the same history and parameters, bit for
    bit."""
    x, y = toy_data(10, seed=2)
    runs = []
    for mesh in (None, make_mesh(devices=[CPU]),
                 make_mesh(devices=[CPU] * 2)):
        tr = _trainer(narrow_tree)
        runs.append((tr.fit(x, y, epochs=2, batch_size=4, mesh=mesh),
                     tr.variables_of()))
    for hist, sd in runs[1:]:
        assert hist == runs[0][0]
        assert all(torch.equal(sd[k], runs[0][1][k]) for k in sd)


def test_fit_mesh_rules(narrow_tree):
    """A model axis over 1 (tensor parallelism) raises; so do a one-process
    mesh of several devices, a batch that does not divide by the data axis
    and a mesh on another device than the trainer's."""
    tr = _trainer(narrow_tree)
    x, y = toy_data(8, seed=3)
    cases = [(make_mesh(4, 2, devices=[CPU] * 8), 8, "tensor parallelism"),
             (make_mesh(devices=[CPU] * 4), 6, "does not divide")]
    cuda_like = make_mesh(devices=[CPU, CPU])
    cuda_like.devices[1, 0] = torch.device("meta")
    cases.append((cuda_like, 8, "one process a card"))
    other = make_mesh(devices=[torch.device("meta")])
    cases.append((other, 8, "the mesh is on meta"))
    for mesh, bs, msg in cases:
        with pytest.raises(ValueError, match=msg):
            tr.fit(x, y, epochs=1, batch_size=bs, mesh=mesh)
