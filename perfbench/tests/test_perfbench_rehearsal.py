"""A cell's whole run on the CPU at a tiny size, through the program's
plain versions: it reports no device number, comes out correct, and comes
out not correct with the timed path broken underneath (the detector state
left unchanged, the denoised window in bfloat16, half of each batch never
logged, an answer altered where the model produces it, one image a batch
altered where the featurizer produces it).  Besides the cells of ``BENCHMARK.json``, the drivers and
kinds that no cell runs yet (``live``, ``speaker``) are rehearsed here."""

import argparse
import json
import time

import pytest
import torch

from perfbench import harness
from perfbench.faults import FAULTS

SMALL = {
    "overlap.backlog": {"streams": 8, "buckets": [8], "warmup_ticks": 1,
                        "check_streams": 4, "check_windows": 3,
                        "pool_conversations": 4},
    "overlap.session": {"warmup_windows": 2, "check_windows": 24,
                        "pool_conversations": 2},
    "overlap.live": {"streams": 4, "buckets": [4], "ring_windows": 4,
                     "warmup_periods": 1.0, "check_streams": 4,
                     "check_windows": 3, "pool_conversations": 2,
                     "grace_s": 60.0},
    "speaker.backlog": {"streams": 8, "buckets": [8], "warmup_ticks": 1,
                        "check_streams": 8, "check_windows": 3,
                        "pool_conversations": 4},
}
# the plain versions on a shared CPU: long enough for the comparison's
# floor of windows whatever the host's load
SECONDS = {"overlap.live": 8.0, "overlap.session": 6.0}


@pytest.fixture(autouse=True)
def _few_threads():
    """Few host threads, as a benchmark run has."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _pieces(name: str):
    """The cell's entry, configuration and mix: from ``BENCHMARK.json``, or
    for a cell it does not hold, the files its name gives."""
    bench = harness.manifest()
    if any(w["name"] == name for w in bench["workloads"]):
        return harness.cell(bench, name)
    config, traffic = name.split(".", 1)
    work = {"name": name, "config": config, "traffic": traffic, "chips": 1}
    return (work,
            json.loads((harness.ROOT / "configs" / f"{config}.json")
                       .read_text()),
            json.loads((harness.ROOT / "traffic" / f"{traffic}.json")
                       .read_text()))


def rehearse(name: str, **more):
    work, config, traffic = _pieces(name)
    traffic.update(SMALL[name], **more)
    args = argparse.Namespace(workload=name, seed=2 ** 33 + 17,
                              seconds=SECONDS.get(name, 3.0), trace=0)
    out, _ = harness.run_cell(work, config, traffic, args,
                              time.perf_counter(), torch.device("cpu"))
    return out


@pytest.mark.parametrize("name", sorted(SMALL))
def test_rehearsal_is_correct_and_reports_no_device_number(name):
    out = rehearse(name)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "cpu"
    assert out["device"]["memory_peak_bytes"] is None
    assert out["metrics"] == {}
    assert out["attempted"] > 0 and out["failed"] == 0
    _, config, _ = _pieces(name)
    held = [n for n in ("missing", "denoise_mismatch", "trim_mismatch",
                        "feature_mismatch", "logit_gap", "rounding_ratio",
                        "label_mismatch", "compared")
            if n in config["limits"]]
    assert list(out["checks"]) == held


CASES = [("overlap.backlog", "state_unchanged"),
         ("overlap.backlog", "denoise_bf16"),
         ("overlap.backlog", "half_batch"),
         ("overlap.backlog", "answer_altered"),
         ("overlap.backlog", "feature_altered"),
         ("overlap.session", "state_unchanged"),
         ("overlap.session", "denoise_bf16"),
         ("overlap.session", "answer_altered"),
         ("overlap.session", "feature_altered")]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{n}-{f}" for n, f in CASES])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    out = rehearse(name)
    assert not out["correct"], out["checks"]


def test_one_altered_image_a_batch_fails_the_featurizer_alone(monkeypatch):
    """One window a batch is wrong: the featurizer's share, taken on every
    window from the trimmed window the program featurized, sees it."""
    FAULTS["feature_altered"](monkeypatch)
    out = rehearse("overlap.backlog", check_streams=8)
    checks = out["checks"]
    assert checks["feature_mismatch"]["value"] > \
        checks["feature_mismatch"]["limit"]


@pytest.mark.parametrize("name", ["overlap.backlog", "overlap.session"])
def test_each_chain_stage_fails_its_own_number(monkeypatch, name):
    """The detector's state never carried fails the detector's exact
    count, on the program's own denoised windows, and not the denoise's
    share; the denoise in bfloat16 fails the denoise's share, and not the
    detector's count."""
    with monkeypatch.context() as mp:
        FAULTS["state_unchanged"](mp)
        checks = rehearse(name)["checks"]
    assert checks["trim_mismatch"]["value"] > 0, checks
    assert checks["denoise_mismatch"]["value"] <= \
        checks["denoise_mismatch"]["limit"], checks
    FAULTS["denoise_bf16"](monkeypatch)
    checks = rehearse(name)["checks"]
    assert checks["denoise_mismatch"]["value"] > \
        checks["denoise_mismatch"]["limit"], checks
    assert checks["trim_mismatch"]["value"] == 0, checks
