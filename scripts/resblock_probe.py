"""Build report, checks and tile-plan sweep of the fused residual block
kernels on one CUDA card.

    env PYTHONPATH=. python3 scripts/resblock_probe.py build
    env PYTHONPATH=. python3 scripts/resblock_probe.py sweep [--batches 1 8] [--plan C,rows,cols,mt,kc ...]
    env PYTHONPATH=. python3 scripts/resblock_probe.py ablate [--batches 480] [--sass PATH]

``build``: compiles ``csrc/fused_resblock.cu`` with ``-Xptxas -v`` and prints
each kernel's registers, shared memory and spills; then holds both routes
against ``fused_resblock_plain`` (TF32 off, max |diff| <= 1e-4 * max |ref|):
the tensor-core kernel at the full-width model's three shapes at B=1 and 8,
on the plan the wrapper picks, on every other warp tile (``mt``) and on the
tilings before and after it in ``block_tilings``, the FFMA kernel at C=12.

``sweep``: CUDA-event times at each shape and batch of those plans and of
each ``--plan`` given for the shape's C, in turns with the plain version and
the unfused ``ResBlock2D`` (cuDNN), TF32 off.  Each plan's output is checked
first.

``ablate``: attributes the tensor-core kernel's time.  Variants of
``csrc/fused_resblock.cu`` with one part changed or removed (textual edits
in ``ABLATIONS``, each built into its own library) are timed in turns with
the unchanged source on the wrapper's plan; the instruction mix of the
kernels' SASS is printed, and the SASS written to ``--sass`` if given.  The
unchanged source and ``trunc_split`` are held to the limit; ``one_mma`` (one
TF32 product, no 3xTF32) has its error printed beside the limit, which it is
expected to miss; the others remove a part and are only timed.  An edit of
the source lines that ``ABLATIONS`` rewrites stops the mode with the name of
the ablation to update.

Every line names the card (``nvidia-smi`` name and power limit).  Without a
CUDA device the script stops before doing anything.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (BLOCK_SHAPES, block_error, log,  # noqa: E402
                        seeded_block, time_ms)
from mmla_audio_torch import _build  # noqa: E402
from mmla_audio_torch.ops.cuda_resblock import (  # noqa: E402
    MMA_TILE_M, SM_SHARED_BYTES, BlockPlan, block_smem_bytes, block_tilings,
    fused_resblock_cuda, fused_resblock_plain, plan_block_tiles)
from mmla_audio_torch.precision import fp32_policy  # noqa: E402


def launch_plan(x, ops, plan: BlockPlan) -> torch.Tensor:
    """The tensor-core kernel on a given plan (the wrapper picks its own)."""
    B, C, H, W = x.shape
    out = torch.empty_like(x)
    lib = _build.cuda_library("fused_resblock")
    err = lib.fused_resblock_mma_launch(
        x.data_ptr(), out.data_ptr(), *(a.data_ptr() for a in ops), B, C, H,
        W, plan.rows, plan.cols, plan.mt, plan.kc,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"plan {plan}: cudaError {err}")
    return out


def check(name, got, ref):
    err, limit, ok = block_error(got, ref)
    log(f"  {name}: max |diff| {err:.3g} (limit {limit:.3g}) "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def wrapper_plan(C, H, W, batch, sms) -> BlockPlan:
    return plan_block_tiles(C, H, W, SM_SHARED_BYTES, batch, sms)


def other_plans(C, H, W, batch, sms, extra=()):
    """The wrapper's plan, the tilings before and after it in
    ``block_tilings``, the wrapper's tiling at each other mt, then
    ``extra``: ``(C, rows, cols, mt, kc)`` plans of this C."""
    tilings = block_tilings(C, H, W, SM_SHARED_BYTES)
    best = wrapper_plan(C, H, W, batch, sms)
    i = tilings.index(best)
    out = [best] + [tilings[j] for j in (i - 1, i + 1)
                    if 0 <= j < len(tilings)]
    out += [best._replace(mt=m) for m in MMA_TILE_M if m != best.mt]
    for c, rows, cols, mt, kc in extra:
        if c == C:
            out.append(BlockPlan(rows, cols, -(-H // rows), -(-W // cols), mt,
                                 kc, block_smem_bytes(C, rows, cols, kc), 2))
    return out


def ptxas_report():
    src = _build.CUDA_KERNELS["fused_resblock"][0]
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             f"{tmp}/lib.so", str(src)], capture_output=True, text=True,
            timeout=600)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    kernel = None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = subprocess.run(["c++filt", m.group(1)],
                                    capture_output=True, text=True
                                    ).stdout.strip()
        elif kernel and ("registers" in line or "spill" in line):
            log(f"  {kernel}: {line.split(':', 1)[-1].strip()}")


def cmd_build(device, rng):
    log("[build] nvcc -Xptxas -v")
    ptxas_report()
    sms = sm_count(device)
    ok = True
    for C, H, W in BLOCK_SHAPES:
        block = seeded_block(C, device, rng)
        ops = block.fused_operands()
        for batch in (1, 8):
            x = torch.from_numpy(rng.randn(batch, C, H, W).astype(
                np.float32)).to(device)
            with torch.no_grad(), fp32_policy(False):
                ref = fused_resblock_plain(x, *ops)
                log(f"[check] C={C} {H}x{W} B={batch} wrapper plan "
                    f"{wrapper_plan(C, H, W, batch, sms)}")
                ok &= check("wrapper", fused_resblock_cuda(x, *ops), ref)
                for plan in other_plans(C, H, W, batch, sms)[1:]:
                    ok &= check(f"{plan}", launch_plan(x, ops, plan), ref)
    block = seeded_block(12, device, rng)
    x = torch.from_numpy(rng.randn(8, 12, 8, 9).astype(np.float32)).to(device)
    with torch.no_grad(), fp32_policy(False):
        before = fused_resblock_cuda.launches_mma
        got = fused_resblock_cuda(x, *block.fused_operands())
        log(f"[check] FFMA route C=12 8x9 B=8 (tensor-core launches "
            f"{fused_resblock_cuda.launches_mma - before})")
        ok &= check("ffma", got, fused_resblock_plain(x,
                                                      *block.fused_operands()))
    return ok


def cmd_sweep(device, rng, batches, extra):
    sms = sm_count(device)
    ok = True
    for C, H, W in BLOCK_SHAPES:
        block = seeded_block(C, device, rng)
        ops = block.fused_operands()
        for batch in batches:
            x = torch.from_numpy(rng.randn(batch, C, H, W).astype(
                np.float32)).to(device)
            reps = 20 if batch <= 64 else 5
            with torch.no_grad(), fp32_policy(False):
                ref = fused_resblock_plain(x, *ops)
                plans = other_plans(C, H, W, batch, sms, extra)
                for plan in plans:
                    ok &= check(f"C={C} B={batch} {plan}",
                                launch_plan(x, ops, plan), ref)
                # plain, unfused, each plan, each plan back, unfused, plain
                plain = [time_ms(fused_resblock_plain, x, *ops, reps=reps)]
                unfused = [time_ms(block.forward_unfused, x, reps=reps)]
                times = {p: [] for p in plans}
                for plan in plans + plans[::-1]:
                    times[plan].append(time_ms(launch_plan, x, ops, plan,
                                               reps=reps))
                unfused.append(time_ms(block.forward_unfused, x, reps=reps))
                plain.append(time_ms(fused_resblock_plain, x, *ops,
                                     reps=reps))
            log(f"[sweep] C={C} {H}x{W} B={batch}: plain {plain[0]:.4f}/"
                f"{plain[1]:.4f} ms, unfused ResBlock2D {unfused[0]:.4f}/"
                f"{unfused[1]:.4f} ms")
            for i, plan in enumerate(plans):
                t = times[plan]
                log(f"  {'wrapper ' if i == 0 else ''}rows={plan.rows} "
                    f"cols={plan.cols} mt={plan.mt} kc={plan.kc} smem="
                    f"{block_smem_bytes(C, plan.rows, plan.cols, plan.kc)}: "
                    f"{t[0]:.4f}/{t[1]:.4f} ms")
    return ok


# name -> textual edits of csrc/fused_resblock.cu
ABLATIONS = {
    # round toward zero: hi = v with its low 13 bits cleared, lo = v - hi
    "trunc_split": [(
        "  hi = (v + 0x1000u) & 0xffffe000u;\n"
        "  lo = __float_as_uint(__uint_as_float(v) - __uint_as_float(hi)) + 0x1000u;",
        "  hi = v & 0xffffe000u;\n"
        "  lo = __float_as_uint(__uint_as_float(v) - __uint_as_float(hi));")],
    # one TF32 product instead of three
    "one_mma": [(
        "            mma_tf32(acc[mi][nt], al, bh[nt]);   // small products first\n"
        "            mma_tf32(acc[mi][nt], ah, bl[nt]);\n", "")],
    # fragment loads and splits kept, no mma
    "no_mma": [(
        "            mma_tf32(acc[mi][nt], al, bh[nt]);   // small products first\n"
        "            mma_tf32(acc[mi][nt], ah, bl[nt]);\n"
        "            mma_tf32(acc[mi][nt], ah, bh[nt]);\n",
        "            acc[mi][nt][0] += __uint_as_float(al[0] ^ al[1] ^ al[2] ^ al[3]"
        " ^ ah[0] ^ ah[1] ^ ah[2] ^ ah[3] ^ bh[nt][0] ^ bh[nt][1] ^ bl[nt][0]"
        " ^ bl[nt][1]);\n")],
    # no k-steps: staging, weight streaming, barriers and epilogues only
    "no_ksteps": [("      if (!active) continue;\n      const float* wb",
                   "      continue;\n      const float* wb")],
    # elu without expm1f
    "no_expm1": [("return v > 0.0f ? v : expm1f(v);",
                  "return v > 0.0f ? v : v;")],
}


def cmd_ablate(device, rng, batches, sass_path):
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    sms = sm_count(device)
    names = ["base"] + list(ABLATIONS)
    with tempfile.TemporaryDirectory() as tmp:
        src = _build.CUDA_KERNELS["fused_resblock"][0].read_text()
        for name in names:
            text = src
            for old, new in ABLATIONS.get(name, []):
                if old not in text:
                    raise RuntimeError(f"ablation {name}: its text is no "
                                       f"longer in the source; update "
                                       f"ABLATIONS")
                text = text.replace(old, new)
            Path(tmp, f"{name}.cu").write_text(text)

        def build(name):
            subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                            f"{tmp}/lib{name}.so", f"{tmp}/{name}.cu"],
                           check=True, capture_output=True, timeout=600)

        with ThreadPoolExecutor(len(names)) as pool:
            list(pool.map(build, names))
        cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
        sass = subprocess.run([str(cuobjdump), "-sass", f"{tmp}/libbase.so"],
                              capture_output=True, text=True).stdout
        if sass_path:
            sass_path.parent.mkdir(parents=True, exist_ok=True)
            sass_path.write_text(sass)
        libs = {}
        for name in names:
            lib = ctypes.CDLL(f"{tmp}/lib{name}.so")
            fn = lib.fused_resblock_mma_launch
            fn.restype = ctypes.c_int
            fn.argtypes = _build.CUDA_KERNELS["fused_resblock"][1][
                "fused_resblock_mma_launch"]
            libs[name] = fn
    log_sass_mix(sass)

    def run(fn, x, ops, plan):
        B, C, H, W = x.shape
        out = torch.empty_like(x)
        err = fn(x.data_ptr(), out.data_ptr(), *(a.data_ptr() for a in ops),
                 B, C, H, W, plan.rows, plan.cols, plan.mt, plan.kc,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"cudaError {err}")
        return out

    ok = True
    for C, H, W in BLOCK_SHAPES:
        block = seeded_block(C, device, rng)
        ops = block.fused_operands()
        for batch in batches:
            x = torch.from_numpy(rng.randn(batch, C, H, W).astype(
                np.float32)).to(device)
            plan = wrapper_plan(C, H, W, batch, sms)
            reps = 20 if batch <= 64 else 5
            with torch.no_grad(), fp32_policy(False):
                ref = fused_resblock_plain(x, *ops)
                for n in ("base", "trunc_split"):
                    ok &= check(f"C={C} B={batch} {n} {plan}",
                                run(libs[n], x, ops, plan), ref)
                err, limit, _ = block_error(run(libs["one_mma"], x, ops,
                                                plan), ref)
                log(f"  C={C} B={batch} one_mma: max |diff| {err:.3g}, "
                    f"{err / limit:.3g}x the limit {limit:.3g}")
                times = {n: [] for n in names}
                for n in names + names[::-1]:
                    times[n].append(time_ms(run, libs[n], x, ops, plan,
                                            reps=reps))
            log(f"[ablate] C={C} {H}x{W} B={batch} rows={plan.rows} "
                f"cols={plan.cols} mt={plan.mt} kc={plan.kc}: " + ", ".join(
                    f"{n} {t[0]:.4f}/{t[1]:.4f}" for n, t in times.items())
                + " ms")
    return ok


def log_sass_mix(sass):
    """Instruction counts of each mma_kernel's SASS, by opcode."""
    from collections import Counter

    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if "mma_kernel" not in name:
            continue
        ops = Counter(m.group(1).split(".")[0] for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)",
            block))
        log(f"[sass] {name}: {sum(ops.values())} instructions; " + ", ".join(
            f"{k} {v}" for k, v in ops.most_common(24)))


def main() -> int:
    if not torch.cuda.is_available():
        print("resblock_probe: no CUDA device", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser()
    parser.add_argument("mode", choices=("build", "sweep", "ablate"))
    parser.add_argument("--batches", type=int, nargs="+",
                        default=[1, 64, 200, 480])
    parser.add_argument("--plan", type=lambda v: tuple(map(int,
                                                           v.split(","))),
                        nargs="+", default=[], metavar="C,rows,cols,mt,kc",
                        help="sweep: time these plans too")
    parser.add_argument("--sass", type=Path,
                        help="ablate: write the kernels' SASS here")
    args = parser.parse_args()
    device = torch.device("cuda", 0)
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True).stdout.strip())
    _build.cuda_libraries()
    rng = np.random.RandomState(7)
    ok = {"build": lambda: cmd_build(device, rng),
          "sweep": lambda: cmd_sweep(device, rng, args.batches, args.plan),
          "ablate": lambda: cmd_ablate(device, rng, args.batches,
                                        args.sass)}[
              args.mode]()
    log("ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
