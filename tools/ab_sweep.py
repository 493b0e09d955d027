#!/usr/bin/env python3
"""Time K3's chunk sweep and K5's combination against a parent commit's, in
one process on one NVIDIA GPU.

    python3 tools/ab_sweep.py [PARENT_DIR] [PAIRS]

PARENT_DIR holds the parent's ``triflow_tpu_torch`` package (default
``build/ab_parent``); where it is missing and the checkout is a git
repository, it is unpacked there from commit ``9a91eee`` (``git archive``),
the commit before K3's staged sweep and K5's cached launch path.  Both
packages load in this process, the parent's under another name, each
building its kernels from its own ``csrc/`` into its own ``build/``.

On the same inputs (K2's factor of random diagonally dominant bands, one
random right-hand side) it times K3's sweep (``thomas.thomas_sweep``, the
whole wrapper) at KS N = 2^20 (s = 2, one grid; ``make_plan``'s plan and
the parent's C = 4096), at the falling film's N = 10^6 (s = 6, three
fields) and at config 5 (B = 1024 members of KS N = 10^5), and K5
(``combine.combine``: A = 7 arrays, R = 2 rows, KS 2^20's shape) beside
one ``torch.mm`` of the same coefficients over stacked operands; float64
and float32; CUDA-event ms per call over back-to-back calls, in the order
parent, this, this, parent, PAIRS times (default 2).
It checks that both sweeps give the same y, and reads K5's device µs per
launch from ``torch.profiler`` (20 launches alone).  Prints the card's
name and power limit, one line per measurement, then one JSON line with
every mean.
"""

import importlib.util
import json
import subprocess
import sys
import tarfile
import io
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from triflow_tpu_torch.ops import (chunked, combine, kernel_checks,  # noqa: E402
                                   thomas)

PARENT_COMMIT = "9a91eee"


def load_parent(path: Path):
    """The parent's ``triflow_tpu_torch`` package, imported as
    ``parent_port`` (its modules import each other relatively)."""
    pkg = path / "triflow_tpu_torch"
    if not pkg.exists():
        if not (ROOT / ".git").exists():
            raise SystemExit(f"{pkg} is missing and {ROOT} is no git checkout")
        blob = subprocess.run(["git", "-C", str(ROOT), "archive", PARENT_COMMIT,
                               "triflow_tpu_torch"], capture_output=True,
                              check=True).stdout
        path.mkdir(parents=True, exist_ok=True)
        with tarfile.open(fileobj=io.BytesIO(blob)) as tar:
            tar.extractall(path)
    spec = importlib.util.spec_from_file_location(
        "parent_port", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_port"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("parent_port.ops.thomas"), \
        importlib.import_module("parent_port.ops.combine")


def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(fn, name, launches=20):
    """Device µs per launch of kernels whose name holds ``name`` over
    ``launches`` calls of fn alone; None where the profiler kept another
    number of them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    times = [ev.time_range.end - ev.time_range.start for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA and name in ev.name]
    return sum(times) / launches if len(times) == launches else None


#: (name, W, nvar, N, B, chunk count or None for make_plan's, calls timed):
#: KS 2^20 also at the parent's plan (C = 4096; make_plan's moved with the
#: refit of its cost to the staged sweep)
SWEEPS = [("ks 2^20", 5, 1, 1 << 20, 1, None, 20),
          ("ks 2^20 C=4096", 5, 1, 1 << 20, 1, 4096, 20),
          ("film 10^6", 5, 3, 10 ** 6, 1, None, 5),
          ("config 5", 5, 1, 10 ** 5, 1024, None, 3)]


def main():
    args = sys.argv[1:]
    parent_dir = Path(args[0]) if args else ROOT / "build" / "ab_parent"
    pairs = int(args[1]) if len(args) > 1 else 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card {smi}", flush=True)
    old_thomas, old_combine = load_parent(parent_dir)
    means = {}

    def turns(what, old, new, iters):
        got = {"parent": [], "this": []}
        for _ in range(pairs):
            for side, fn in (("parent", old), ("this", new), ("this", new),
                             ("parent", old)):
                got[side].append(cuda_ms(fn, iters))
        for side, ms in got.items():
            means[f"{what} {side}"] = sum(ms) / len(ms)
        print(f"  {what}: parent " + " / ".join(f"{m:.4f}" for m in got["parent"])
              + " ms, this " + " / ".join(f"{m:.4f}" for m in got["this"])
              + f" ms; this / parent {means[f'{what} this'] / means[f'{what} parent']:.3f}",
              flush=True)

    for dtype in (torch.float64, torch.float32):
        dt = str(dtype).replace("torch.", "")
        for name, W, nvar, N, B, C, iters in SWEEPS:
            plan = (chunked.make_plan(N, nvar, W // 2, True, B) if C is None
                    else chunked.plan_with(N, nvar, W // 2, True, C, B))
            bands = kernel_checks.random_bands(W, nvar, N, dtype, "cuda")
            if B > 1:
                bands = bands.expand(B, *bands.shape).contiguous()
            fact = thomas.spike_factor(bands, 1.0, -0.3, plan)
            del bands
            gen = torch.Generator(device="cuda").manual_seed(0)
            rhs = torch.randn(((B,) if B > 1 else ()) + (nvar, N), dtype=dtype,
                              device="cuda", generator=gen)
            y_old = old_thomas.thomas_sweep(fact, rhs, plan)[0]
            y_new = thomas.thomas_sweep(fact, rhs, plan)[0]
            gap = float((y_new - y_old).abs().max() / y_old.abs().max())
            del y_old, y_new
            sp = thomas.sweep_plan(plan.s, rhs.element_size(), plan.Mc, plan.C, B)
            print(f"K3 sweep {name} {dt}: s={plan.s} C={plan.C} Mc={plan.Mc} B={B}, "
                  f"{sp}; relative gap {gap:.2e}", flush=True)
            turns(f"K3 sweep {name} {dt}",
                  lambda: old_thomas.thomas_sweep(fact, rhs, plan),
                  lambda: thomas.thomas_sweep(fact, rhs, plan), iters)
            del fact, rhs
        n = 1 << 20
        gen = torch.Generator(device="cuda").manual_seed(1)
        rows = torch.randn(2, 7, generator=gen, device="cuda").tolist()
        rows[0][0], rows[1][0], rows[1][3] = 1.0, 1.0, 0.0
        arrays = [torch.randn(1, n, dtype=dtype, device="cuda", generator=gen)
                  for _ in range(7)]
        coefs = torch.tensor(rows, dtype=dtype, device="cuda")
        stacked = torch.stack(arrays).view(7, -1)
        if not all(torch.equal(a, b) for a, b in zip(
                old_combine.combine(rows, arrays), combine.combine(rows, arrays))):
            raise SystemExit(f"K5 {dt}: the two combinations differ")
        print(f"K5 combine ks 2^20 {dt} (A = 7, R = 2):", flush=True)
        turns(f"K5 combine {dt}", lambda: old_combine.combine(rows, arrays),
              lambda: combine.combine(rows, arrays), 50)
        turns(f"torch.mm {dt}", lambda: torch.mm(coefs, stacked),
              lambda: torch.mm(coefs, stacked), 50)
        for side, fn in (("parent", lambda: old_combine.combine(rows, arrays)),
                         ("this", lambda: combine.combine(rows, arrays))):
            us = device_us(fn, "combine")
            means[f"K5 combine {dt} {side} device us"] = us
            print(f"  K5 combine {dt} {side}: "
                  + (f"{us:.3f} device us per launch" if us is not None
                     else "device us not measured (the profiler dropped launches)"),
                  flush=True)
    print(json.dumps({"card": smi, "means_ms": means}))


if __name__ == "__main__":
    main()
