"""A later change adds a configuration, its kind, a traffic mix, the
driver of a new kind of load, metrics and a cell as new files and entries:
in a copy of the benchmark the harness finds them by name, and no file
that was there changes."""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

from perfbench import harness

PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from perfbench import counts, drivers, harness
from perfbench.system import kind_module
work, config, traffic = harness.cell(harness.manifest(), "probe.burst")
run = drivers.load(traffic["driver"])(None, traffic, 7, 1.0, False, None,
                                      0.0)
class Ctx:
    pass
ctx = Ctx()
ctx.run = run
print(json.dumps([work["config"], config["kind"], traffic["driver"],
                  traffic["streams"], traffic["phase_spread"],
                  harness.reader("probe_ms.burst")(ctx),
                  harness.reader("probe_s")(ctx),
                  kind_module(config["kind"]).label_name(1),
                  counts.model_flops(config["kind"], {}, {}),
                  harness.applies({"workloads": ["probe.burst"]},
                                  "probe.burst")]))
"""

DRIVER = """
from perfbench.drivers import Run


def run(system, traffic, seed, seconds, trace, dirs, t_start):
    out = Run(seconds=seconds)
    out.notes["ticks"] = traffic["streams"] // 41
    return out
"""

KIND = """
FEATURIZERS = ()


def label_name(label):
    return "probe" if label >= 0 else "silent"
"""


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_new_config_kind_mix_driver_metric_and_cell_are_files_and_entries(
        tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__",
                                                  ".kernel_cache"))
    shutil.copy(harness.REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(root / "perfbench")
    pb = root / "perfbench"
    base = json.loads((pb / "configs" / "overlap.json").read_text())
    (pb / "configs" / "probe.json").write_text(json.dumps(
        dict(base, kind="probe")))
    (pb / "kinds" / "probe.py").write_text(KIND)
    (pb / "counts" / "probe.py").write_text(
        "def model_flops(model, feature):\n    return 3.0\n")
    # a mix of a new kind of load: every stream in step
    (pb / "traffic" / "burst.json").write_text(json.dumps(
        dict(json.loads((pb / "traffic" / "live.json").read_text()),
             driver="probe", streams=123, phase_spread=0.0)))
    (pb / "drivers" / "probe.py").write_text(DRIVER)
    (pb / "metrics" / "probe_ms.burst.py").write_text(
        "def read(ctx):\n    return ctx.run.notes['ticks'] * 2.5\n")
    (pb / "metrics" / "probe_s.py").write_text(
        "def read(ctx):\n    return ctx.run.seconds\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="probe",
                                 file="perfbench/configs/probe.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="probe.burst",
                                   config="probe", traffic="burst"))
    bench["end_to_end"].append(dict(bench["end_to_end"][0], name="probe_s",
                                    unit="s", workloads=["probe.burst"]))
    bench["per_layer"].append(dict(bench["per_layer"][0],
                                   name="probe_ms.burst", moves="probe_s",
                                   workloads=["probe.burst"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", PROBE, str(root)],
                         capture_output=True, text=True, timeout=120,
                         cwd=root, check=True)
    assert json.loads(out.stdout) == ["probe", "probe", "probe", 123, 0.0,
                                      7.5, 1.0, "probe", 3.0, True]
    after = _digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    root = tmp_path / "bare"
    shutil.copytree(harness.ROOT, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__",
                                                  ".kernel_cache"))
    shutil.copy(harness.REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "overlap.backlog", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=root)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
