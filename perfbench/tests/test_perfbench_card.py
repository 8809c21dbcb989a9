"""On the card: a short run of each cell at its own load comes out
correct, and the control (the reference at the precision below the
configuration's, in the program's place) fails at least one number; with
kernel B3 in one TF32 pass, where the configuration states 3xTF32, the
run comes out not correct."""

import argparse
import time

import pytest

from perfbench import check, harness
from perfbench.faults import FAULTS

CELLS = ["overlap.backlog", "overlap.session"]


def _run(card, name, control):
    from mmla_audio_torch import _build
    from mmla_audio_torch.utils.compile_cache import enable_compile_cache

    enable_compile_cache(harness.CACHE)
    _build.cuda_libraries()
    work, config, traffic = harness.cell(harness.manifest(), name)
    args = argparse.Namespace(workload=name, seed=2 ** 31 + 99, seconds=3.0,
                              trace=0)
    out, _ = harness.run_cell(work, config, traffic, args,
                              time.perf_counter(), card, control=control)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails(card, name):
    out = _run(card, name, control=True)
    assert out["correct"], out["checks"]
    limits = {n: c["limit"] for n, c in out["checks"].items()}
    ctl = [(n, out["control"][n], limits[n]) for n in limits]
    assert not check.passed(ctl), ctl


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_b3_in_one_tf32_pass_is_not_correct(card, monkeypatch, name):
    FAULTS["b3_tf32"](monkeypatch)
    out = _run(card, name, control=False)
    assert not out["correct"], out["checks"]
