"""The port's ``Multiplexer(mesh=)`` on the CPU (the counterpart of
``tests/test_multiplex.py``'s mesh cases): each batch split over a
one-process mesh's data axis (``[cpu] * k``) against the JAX package's
multiplexer on its 8-device mesh and against the port's unsplit
``mesh=None`` run.  Labels equal; the stacked webrtcvad rows equal bit for
bit (with the live denoise at 0 passes against JAX, as
``test_torch_multiplex.py`` holds them; at the default passes against the
port's unsplit run, whose denoise is the same function of each row).
"""

import dataclasses

import numpy as np
import pytest
import torch

from mmla_audio_tpu.core import config as jax_config
from mmla_audio_tpu.parallel import make_mesh as jax_make_mesh
from mmla_audio_tpu.streaming.multiplex import Multiplexer as JaxMultiplexer
from mmla_audio_torch.parallel import make_mesh
from mmla_audio_torch.streaming.capture import PrefilledCapture
from mmla_audio_torch.streaming.multiplex import Multiplexer
from mmla_audio_torch.vad import webrtc
from tests.test_torch_model import as_port
from tests.test_torch_multiplex import (CFG, PORT_CFG, _conversations,
                                        _noise, _Windows, overlap, speaker)

torch.set_num_threads(1)

CPU = torch.device("cpu")
__all__ = ["overlap", "speaker"]          # the fixtures, shared


def _serve(pred, tmp_path, name, cfg, mesh, kind="overlap", bucket=8,
           jax=False):
    """The three conversations of ``test_torch_multiplex`` through one
    multiplexer; (labels per stream, the multiplexer)."""
    convs = _conversations()
    if jax:
        mux = JaxMultiplexer(pred, tmp_path / name, kind=kind, bucket=bucket,
                             cfg=cfg, mesh=mesh)
    else:
        mux = Multiplexer(pred, tmp_path / name, kind=kind, bucket=bucket,
                          cfg=cfg, device="cpu", mesh=mesh)
    for s, ws in enumerate(convs):
        cap = _Windows(ws) if jax else PrefilledCapture(np.concatenate(ws))
        mux.add_stream(f"s{s}", cap, _noise(seed=s))
    assert mux.run_until_exhausted() == 9
    return [[r[1] for r in s.results] for s in mux.streams], mux


def test_mesh_multiplexer_matches_jax_mesh(overlap, tmp_path):
    """The overlap kind with webrtc at bucket 8: JAX on its 8-device mesh,
    the port unsplit, on 2 shards and on 8 shards."""
    denoise = dataclasses.replace(jax_config.DenoiseConfig(), passes_live=0)
    jax_cfg = jax_config.PipelineConfig(overlap_model=CFG, denoise=denoise)
    port_cfg = dataclasses.replace(PORT_CFG, denoise=as_port(denoise))
    ref, ref_mux = _serve(overlap[0], tmp_path, "jax", jax_cfg,
                          jax_make_mesh(), jax=True)
    rows = webrtc.state_rows_from_jax({
        k: np.asarray(v) for k, v in ref_mux._webrtc_states._asdict().items()})
    assert any("silent" in ls for ls in ref)
    for name, mesh in (("none", None),
                       ("two", make_mesh(devices=[CPU] * 2)),
                       ("eight", make_mesh(devices=[CPU] * 8))):
        labels, mux = _serve(overlap[1], tmp_path, name, port_cfg, mesh)
        assert labels == ref, name
        np.testing.assert_array_equal(mux._webrtc_states.numpy(), rows,
                                      err_msg=name)
        assert (mux._replicas is None) == (mesh is None)


def test_mesh_multiplexer_default_chain_equals_unsplit(overlap, tmp_path):
    """At the default live denoise: a 4-shard split (bucket 4, the ladder's
    batches cut into blocks of one row) and a one-device mesh, which is the
    unsplit path itself, against ``mesh=None``."""
    base, base_mux = _serve(overlap[1], tmp_path, "none", PORT_CFG, None,
                            bucket=4)
    for name, mesh in (("one", make_mesh(devices=[CPU])),
                       ("four", make_mesh(devices=[CPU] * 4))):
        labels, mux = _serve(overlap[1], tmp_path, name, PORT_CFG, mesh,
                             bucket=4)
        assert labels == base, name
        assert torch.equal(mux._webrtc_states, base_mux._webrtc_states)
        assert (mux._replicas is None) == (name == "one")


def test_energy_speaker_kind_on_mesh(speaker, tmp_path):
    """The energy decision and the speaker kind through the split program
    (JAX's ``DataParallel`` path), numeric labels: equal to JAX's."""
    vad = jax_config.VadConfig(decision="energy")
    jax_cfg = jax_config.PipelineConfig(vad=vad)
    port_cfg = dataclasses.replace(PORT_CFG, vad=as_port(vad))
    ref, _ = _serve(speaker[0], tmp_path, "jax", jax_cfg, jax_make_mesh(),
                    kind="speaker", jax=True)
    labels, mux = _serve(speaker[1], tmp_path, "port", port_cfg,
                         make_mesh(devices=[CPU] * 2), kind="speaker")
    assert labels == ref and mux._webrtc_states is None
    assert {lab for ls in labels for lab in ls} <= {"0", "1", "silent"}


def test_mesh_rules(overlap, tmp_path):
    """A bucket the data axis does not divide, a mesh whose first device is
    not the multiplexer's, and a mesh across processes all raise."""
    pred = overlap[1]
    with pytest.raises(ValueError, match="every bucket"):
        Multiplexer(pred, tmp_path / "a", buckets=(2, 8), device="cpu",
                    mesh=make_mesh(devices=[CPU] * 4))
    with pytest.raises(ValueError, match="first device"):
        Multiplexer(pred, tmp_path / "b", bucket=8, device="cpu",
                    mesh=make_mesh(devices=["meta", "cpu"]))
    mesh = make_mesh(devices=[CPU] * 2)
    spanning = dataclasses.replace(mesh, group=object())
    with pytest.raises(ValueError, match="spans processes"):
        Multiplexer(pred, tmp_path / "c", bucket=8, device="cpu",
                    mesh=spanning)
