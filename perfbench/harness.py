"""The benchmark's harness: finds a cell's configuration, traffic mix,
driver and metric readers by name, runs the cell and prints its one result
line.

Everything a cell uses is found from ``BENCHMARK.json`` by name:

* the configuration: ``configs[].file`` (``perfbench/configs/<name>.json``),
  whose ``kind`` names ``perfbench/kinds/<kind>.py`` (the program's
  predictor and session) and ``perfbench/reference/<kind>.py``;
* the traffic mix: ``perfbench/traffic/<traffic>.json``, whose ``driver``
  names ``perfbench/drivers/<driver>.py``;
* a metric, end-to-end or per-layer: ``perfbench/metrics/<name>.py``, whose
  ``read(ctx)`` returns the number, or None when it finds nothing to read.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
CACHE = ROOT / ".kernel_cache"         # the program's kernel builds
FORBIDDEN = ("jax", "jaxlib", "flax", "mmla_audio_tpu", "benchmarks")
CHAIN_KERNELS = ("stft_rfft_kernel", "istft_irfft_kernel", "smooth_mask",
                 "webrtc_vad_kernel", "vad_collect")
D1_KERNELS = ("stft_rfft_kernel", "istft_irfft_kernel")
# the host threads a run's libraries may use (OpenMP, BLAS, torch's
# intra-op pool): a run is one process with few threads, so that its host
# work does not wait on threads of its own
THREADS = 1
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")

__all__ = ["manifest", "cell", "load_json", "Context", "main"]


def manifest() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def cell(bench: dict, name: str) -> tuple:
    """(workload entry, configuration, traffic mix) of cell ``name``."""
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = load_json(REPO / conf["file"])
    traffic = load_json(ROOT / "traffic" / f"{work['traffic']}.json")
    return work, config, traffic


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def reader(name: str):
    """The ``read`` function of ``perfbench/metrics/<name>.py``."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Modules loaded whose top-level name is one the port must not load."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (``inf`` counts as the largest)."""
    v = sorted(values)
    if not v:
        return float("nan")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


class Context:
    """What a metric reader reads: the run (host counters, the tap), the
    system, and the traced stretch's device and host events."""

    def __init__(self, run, system, traffic):
        self.run, self.system, self.traffic = run, system, traffic
        self.device_events, self.host_events = [], []
        self.window_s = self.busy_s = None
        self.traced_windows = 0
        self.traced_batches: list = []
        trace = run.trace
        if trace is None:
            return
        from torch.autograd import DeviceType

        from perfbench.drivers import Tracer

        (_, a), (_, b) = trace["start"], trace["end"]
        self.traced_windows = b["windows"] - a["windows"]
        self.traced_batches = run.tap.batches[a["batches"]: b["batches"]]
        marks = {e.name: e.time_range.start for e in trace["events"]
                 if e.name in (Tracer.OPEN, Tracer.CLOSE)}
        lo, hi = marks[Tracer.OPEN], marks[Tracer.CLOSE]
        self.window_s = (hi - lo) / 1e6
        for e in trace["events"]:
            s, t = max(e.time_range.start, lo), min(e.time_range.end, hi)
            if t <= s:
                continue
            span = (s, t, e.name)
            if e.device_type == DeviceType.CUDA:
                if not e.is_user_annotation:
                    self.device_events.append(span)
            elif e.name not in marks:
                self.host_events.append(span)
        self.device_events.sort()
        self.host_events.sort()
        busy, end = 0, -math.inf
        for s, e, _ in self.device_events:
            busy += max(0, e - max(s, end))
            end = max(end, e)
        self.busy_s = busy / 1e6

    def kernels(self):
        """(name, seconds) of the traced device kernels (no copies)."""
        return [(n, (e - s) / 1e6) for s, e, n in self.device_events
                if not n.startswith(("Memcpy", "Memset"))]

    def device_s(self, pick) -> float:
        return sum(d for n, d in self.kernels() if pick(n))

    def breakdown(self) -> dict:
        """The ten device operations of most time, and the ten longest
        idle stretches of the device by what the host was doing (the
        innermost host event across the gap's middle)."""
        ops = Counter()
        for n, d in self.kernels():
            ops[n[:120]] += d
        gaps = Counter()
        starts = [s for s, _, _ in self.host_events]
        end = None
        for s, e, _ in self.device_events:
            if end is not None and s > end:
                mid = (s + end) / 2
                i = bisect.bisect_right(starts, mid)
                label = "host: nothing traced"
                near = self.host_events[max(0, i - 200):i]
                for hs, he, hn in reversed(near):
                    if he >= mid:
                        label = hn
                        break
                gaps[label[:120]] += (s - end) / 1e6
            end = e if end is None else max(end, e)
        return {"device_ops": [[n, v] for n, v in ops.most_common(10)],
                "idle_gaps": [[n, v] for n, v in gaps.most_common(10)]}


def _finite(v):
    """A number JSON can hold (NaN and infinities as None)."""
    return v if isinstance(v, int) or math.isfinite(v) else None


def _to_cpu(v):
    """A kept value with its tensors on the host (tuples kept whole)."""
    if isinstance(v, tuple):
        return tuple(_to_cpu(x) for x in v)
    return v.cpu() if hasattr(v, "cpu") else v


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None, t_start=None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    bench = manifest()
    work, config, traffic = cell(bench, args.workload)

    import torch

    torch.set_num_threads(THREADS)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < work["chips"]:
        print(f"perfbench: {work['name']} needs {work['chips']} CUDA "
              f"device(s); found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    from mmla_audio_torch import _build
    from mmla_audio_torch.utils.compile_cache import enable_compile_cache

    if enable_compile_cache(CACHE) is None:
        return 2
    _build.cuda_libraries()
    _build.host_library()
    result, checks = run_cell(work, config, traffic, args, t_start,
                              torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(f"checks: {checks}", file=sys.stderr)
    print(json.dumps(result))
    return 0


def exit_now(code: int) -> None:
    """Flush and leave without the interpreter's teardown, in which the
    profiler's library has crashed after a traced run."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def _start_profiler_once(device) -> None:
    """The profiler's first start in a process takes seconds (CUPTI comes
    up): take it in set-up, so that the traced stretch starts on time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)


def run_cell(work, config, traffic, args, t_start, device,
             control: bool = False):
    """Run one cell on ``device``: (the result line's object, the checks'
    line).  On a CPU device (a rehearsal) it reports no device number.
    ``control`` adds the control's numbers under ``control`` (the
    calibration's, never the benchmark's runs)."""
    import torch

    from perfbench import check, drivers
    from perfbench.system import System

    on_card = device.type == "cuda"
    system = System(config, args.seed, device)
    tmp = Path(tempfile.mkdtemp(prefix="perfbench-",
                                dir=os.environ.get("TMPDIR")))
    if args.trace and on_card:
        _start_profiler_once(device)
    try:
        run = drivers.load(traffic["driver"])(
            system, traffic, args.seed, args.seconds, bool(args.trace), tmp,
            t_start)
        if on_card:
            torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) if on_card else None
        run.tap.detach()
        run.tap.kept = {k: _to_cpu(v) for k, v in run.tap.kept.items()}
        run.tap.blocks = {k: [_to_cpu(c) for c in v]
                          for k, v in run.tap.blocks.items()}
        run.tap.denoised = {k: _to_cpu(v)
                            for k, v in run.tap.denoised.items()}
        run.notes.pop("mux", None)
        run.notes.pop("caps", None)
        run.notes.pop("session", None)
        if on_card:
            torch.cuda.empty_cache()
        ctx = Context(run, system, traffic)
        bench = manifest()
        metrics = {}
        if not on_card:
            pass                  # a rehearsal reports no measured number
        elif args.trace:
            for m in bench["per_layer"]:
                if applies(m, work["name"]):
                    v = reader(m["name"])(ctx)
                    if v is not None:
                        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            for m in bench["end_to_end"]:
                if applies(m, work["name"]):
                    v = reader(m["name"])(ctx)
                    if v is not None:
                        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        ref = check.replay(system, run, system.cfg.audio.window_samples)
        numbers = check.compare(system, run, ref, config["limits"])
        ok = check.passed(numbers) and run.attempted > 0
        lat = [x for x in run.latencies if x != math.inf]
        if lat:
            print(f"latency: median {percentile(lat, 50) * 1e3:.3f} ms, "
                  f"p95 {percentile(run.latencies, 95) * 1e3:.3f} ms over "
                  f"{len(run.latencies)} windows", file=sys.stderr)
        if "thirds_ms" in run.notes:
            print(f"median latency by thirds of the window: "
                  f"{run.notes['thirds_ms']} ms", file=sys.stderr)
        if run.lateness:
            print(f"generator lateness: median "
                  f"{percentile(run.lateness, 50) * 1e3:.3f} ms, p95 "
                  f"{percentile(run.lateness, 95) * 1e3:.3f} ms, max "
                  f"{max(run.lateness) * 1e3:.3f} ms", file=sys.stderr)
        print("printed, not held: " + check.numbers_line(
            [x for x in numbers if x[2] is None]), file=sys.stderr)
        held = [x for x in numbers if x[2] is not None]
        if on_card:
            print(f"card: {power_limit()}", file=sys.stderr)
            device_info = {"platform": "gpu",
                           "kind": torch.cuda.get_device_name(device),
                           "count": 1, "memory_peak_bytes": int(peak)}
        else:
            device_info = {"platform": "cpu", "kind": "cpu rehearsal",
                           "count": 0, "memory_peak_bytes": None}
        out = {"correct": ok, "attempted": run.attempted,
               "failed": run.failed, "metrics": metrics,
               "device": device_info}
        if args.trace:
            print(f"trace: {len(ctx.device_events)} device events, "
                  f"{len(ctx.host_events)} host events, "
                  f"{ctx.traced_windows} windows in "
                  f"{ctx.window_s} s", file=sys.stderr)
            device_info["busy_s"] = ctx.busy_s or 0.0
            device_info["window_s"] = ctx.window_s or 0.0
            out["breakdown"] = ctx.breakdown()
        if control:
            out["control"] = {n: _finite(v) for n, v, _ in check.control(
                system, run, ref, config["limits"],
                config["control_precision"])}
            out["unheld"] = {n: _finite(v) for n, v, lim in numbers
                             if lim is None}
            out["notes"] = {k: v for k, v in run.notes.items()
                            if k in ("thirds_ms",)}
            if run.lateness:
                out["notes"]["lateness_p95_ms"] = \
                    percentile(run.lateness, 95) * 1e3
        out["checks"] = {n: {"value": _finite(v), "limit": lim}
                         for n, v, lim in held}
        return out, check.numbers_line(held)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
