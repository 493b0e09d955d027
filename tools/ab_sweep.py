#!/usr/bin/env python3
"""Time K2's factor, K4's factor and solve with shifts, K3's chunk sweep
and K5's combination against a parent commit's, in one process on one
NVIDIA GPU.

    python3 tools/ab_sweep.py [PARENT_DIR] [PAIRS] [GRID ...]

PARENT_DIR holds the parent's ``triflow_tpu_torch`` package (default
``build/ab_parent``); where it is missing and the checkout is a git
repository, it is unpacked there from commit ``a79eea9`` (``git archive``),
the commit before K3's tiled correction and K4's narrow factor across the
card (K2, K4's solve with shifts and wide factor, K3's sweep and K5 are
the same in both, so their pairs show the noise of the measurement).
GRID words keep only the grids whose name holds one of them (``film``: the falling film's).  Both
packages load in this process, the parent's under another name, each
building its kernels from its own ``csrc/`` into its own ``build/``.

On the same inputs (random diagonally dominant bands; the plain reduced
factor of K2's and, on a Woodbury plan, its closure; one random
right-hand side) it times, on each grid of ``GRIDS`` and under its chunk
plan: K2 (``thomas.spike_factor``, the whole wrapper), K4's factor
(``pcr.pcr_factor``), its solve with shifts (``pcr.pcr_solve_shift``),
K3's sweep (``thomas.thomas_sweep``) and K3's correction
(``thomas.spike_correct`` of the sweep's y with ``add_to``, timed on copies
of its inputs taken in turn, ``COLD_BYTES`` of them, so that each call
reads its inputs from memory and not from L2); the grids are
KS N = 2^20 (s = 2, one grid, block-cyclic: ``make_plan``'s plan and C =
1024 and 4096), KS N = 10^6 (Woodbury), the padded ring of KS N = 999983
(its 1534 chunks of 1000168 nodes under the narrow cost before its refit
to the tiled correction and the factor across the card, 2041 of 1000090
after), Burgers N = 10^6 (s = 1), the falling
film (s = 6, three fields: K2's and K4's
wide factors) at N = 10^6 under ``make_plan``'s plan and at C = 500, 1000,
2000 and 4000 (Woodbury), at N = 2^20 at C = 512, 2048 and 4096, and at
8192 chunks of 2^15 nodes (block-cyclic), and config 5 (B = 1024 members
of KS N = 10^5); and K5 (``combine.combine``: A = 7 arrays, R = 2 rows, KS
2^20's shape) beside one ``torch.mm`` of the same coefficients over
stacked operands; float64 and float32; CUDA-event ms per call over
back-to-back calls, in the order parent, this, this, parent, PAIRS times
(default 2).  It checks that both give the same outputs (K2's five row
arrays and reduced couplings, K4's level operators and Dinv, its shifts,
K3's y and corrected x: bit for bit, or within the solver pieces' limits, 1e-10 of the
largest entry in float64 and 1e-4 in float32, printed beside), and
reads each kernel's device µs per launch from ``torch.profiler`` (20
launches alone).  Prints the card's name and power limit, one line per
measurement, then one JSON line with every mean.
"""

import importlib.util
import itertools
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
                                   pcr, thomas)

PARENT_COMMIT = "a79eea9"
#: bytes the inputs of K3's correction rotate over when timed: twice the
#: H100's 50 MB L2, so that each call reads its inputs from memory
COLD_BYTES = 100 * 2 ** 20


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
    return tuple(importlib.import_module(f"parent_port.ops.{name}")
                 for name in ("thomas", "pcr", "combine"))


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


def device_us(fn, name, launches=20, tries=5):
    """Device µs per launch of kernels whose name holds ``name`` over
    ``launches`` calls of fn alone; a window in which the profiler kept
    another number of them is measured again, and after ``tries`` windows
    the result is None."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        times = [ev.time_range.end - ev.time_range.start for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA and name in ev.name]
        if len(times) == launches:
            return sum(times) / launches
    return None


#: (name, W, nvar, N, B, chunk count or None for make_plan's, calls timed)
GRIDS = [("ks 2^20", 5, 1, 1 << 20, 1, None, 20),
         ("ks 2^20 C=1024", 5, 1, 1 << 20, 1, 1024, 20),
         ("ks 2^20 C=4096", 5, 1, 1 << 20, 1, 4096, 20),
         ("ks 10^6", 5, 1, 10 ** 6, 1, None, 20),
         ("ks ring 999983 C=1534", 5, 1, 1000168, 1, 1534, 20),
         ("ks ring 999983 C=2041", 5, 1, 1000090, 1, 2041, 20),
         ("burgers 10^6", 3, 1, 10 ** 6, 1, None, 20),
         ("film 10^6", 5, 3, 10 ** 6, 1, None, 5),
         ("film 10^6 C=500", 5, 3, 10 ** 6, 1, 500, 5),
         ("film 10^6 C=1000", 5, 3, 10 ** 6, 1, 1000, 5),
         ("film 10^6 C=2000", 5, 3, 10 ** 6, 1, 2000, 5),
         ("film 10^6 C=4000", 5, 3, 10 ** 6, 1, 4000, 5),
         ("film 2^20 C=512", 5, 3, 1 << 20, 1, 512, 5),
         ("film 2^20 C=2048", 5, 3, 1 << 20, 1, 2048, 5),
         ("film 2^20 C=4096", 5, 3, 1 << 20, 1, 4096, 5),
         ("film 2^15 C=8192", 5, 3, 1 << 15, 1, 8192, 5),
         ("config 5", 5, 1, 10 ** 5, 1024, None, 3)]


def gap(new, old):
    """"equal" where every tensor of ``new`` is bit for bit ``old``'s, else
    the largest difference relative to the largest entry."""
    if all(torch.equal(a, b) for a, b in zip(new, old)):
        return "equal"
    return "relative gap %.2e" % max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))
                                     for a, b in zip(new, old))


def main():
    args = sys.argv[1:]
    parent_dir = Path(args[0]) if args else ROOT / "build" / "ab_parent"
    pairs = int(args[1]) if len(args) > 1 else 2
    words = args[2:]
    grids = [g for g in GRIDS if not words or any(w in g[0] for w in words)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card {smi}", flush=True)
    old_thomas, old_pcr, old_combine = load_parent(parent_dir)
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

    def on_device(what, old, new, name):
        for side, fn in (("parent", old), ("this", new)):
            us = device_us(fn, name)
            means[f"{what} {side} device us"] = us
            print(f"  {what} {side}: "
                  + (f"{us:.3f} device us per launch" if us is not None
                     else "device us not measured (the profiler dropped launches)"),
                  flush=True)

    for dtype in (torch.float64, torch.float32):
        dt = str(dtype).replace("torch.", "")
        suffix = "f64" if dtype == torch.float64 else "f32"
        item = torch.finfo(dtype).bits // 8
        for name, W, nvar, N, B, C, iters in grids:
            plan = (chunked.make_plan(N, nvar, W // 2, True, B) if C is None
                    else chunked.plan_with(N, nvar, W // 2, True, C, B))
            bands = kernel_checks.random_bands(W, nvar, N, dtype, "cuda")
            if B > 1:
                bands = bands.expand(B, *bands.shape).contiguous()
            where = (f"{name} {dt}: s={plan.s} C={plan.C} Mc={plan.Mc} B={B} "
                     f"woodbury={plan.woodbury}")
            # K2
            f_new = thomas.spike_factor(bands, 1.0, -0.3, plan)
            f_old = old_thomas.spike_factor(bands, 1.0, -0.3, plan)
            fp = thomas.factor_plan(plan.nvar, plan.halo, item, plan.Mc, plan.C, B)
            print(f"K2 factor {where}, {fp}; {gap(f_new, f_old)}", flush=True)
            del f_old
            turns(f"K2 factor {name} {dt}",
                  lambda: old_thomas.spike_factor(bands, 1.0, -0.3, plan),
                  lambda: thomas.spike_factor(bands, 1.0, -0.3, plan), iters)
            on_device(f"K2 factor {name} {dt}",
                      lambda: old_thomas.spike_factor(bands, 1.0, -0.3, plan),
                      lambda: thomas.spike_factor(bands, 1.0, -0.3, plan), "spike_factor")
            del bands
            fact = f_new
            # K4's factor of the reduced system
            red = pcr.pcr_factor(fact.Lred, fact.Ured, plan.cyclic)
            r_old = old_pcr.pcr_factor(fact.Lred, fact.Ured, plan.cyclic)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            route = pcr.factor_route(2 * plan.s, plan.C)
            if route == "wide":
                kp = pcr.factor_plan_wide(plan.C, 2 * plan.s, B, sms, pcr._grid_blocks(
                    pcr.WIDE_LIB, suffix, 2 * plan.s))
            elif route == "grid":
                kp = pcr.factor_plan_grid(plan.C, 2 * plan.s, B, sms, pcr._grid_blocks(
                    pcr.LIB, suffix, 2 * plan.s))
            else:
                kp = "one block per member"
            print(f"K4 factor {where}, {kp}; {gap(red, r_old)}", flush=True)
            del r_old
            turns(f"K4 factor {name} {dt}",
                  lambda: old_pcr.pcr_factor(fact.Lred, fact.Ured, plan.cyclic),
                  lambda: pcr.pcr_factor(fact.Lred, fact.Ured, plan.cyclic), iters)
            on_device(f"K4 factor {name} {dt}",
                      lambda: old_pcr.pcr_factor(fact.Lred, fact.Ured, plan.cyclic),
                      lambda: pcr.pcr_factor(fact.Lred, fact.Ured, plan.cyclic), "pcr_factor")
            # K4's solve with shifts
            wood = pcr.woodbury(red, fact.Lred, fact.Ured) if plan.woodbury else ()
            gen = torch.Generator(device="cuda").manual_seed(0)
            lead = (B,) if B > 1 else ()
            yred = torch.randn(lead + (2 * plan.s, plan.C), dtype=dtype, device="cuda",
                               generator=gen)
            s_new = pcr.pcr_solve_shift(red, yred, plan.wrap, *wood)
            s_old = old_pcr.pcr_solve_shift(red, yred, plan.wrap, *wood)
            sp = pcr.solve_plan(plan.C, 2 * plan.s, B, item)
            print(f"K4 solve_shift {where}, {sp}; {gap(s_new, s_old)}", flush=True)
            turns(f"K4 solve_shift {name} {dt}",
                  lambda: old_pcr.pcr_solve_shift(red, yred, plan.wrap, *wood),
                  lambda: pcr.pcr_solve_shift(red, yred, plan.wrap, *wood), 5 * iters)
            on_device(f"K4 solve_shift {name} {dt}",
                      lambda: old_pcr.pcr_solve_shift(red, yred, plan.wrap, *wood),
                      lambda: pcr.pcr_solve_shift(red, yred, plan.wrap, *wood),
                      "pcr_solve_shift")
            del red, wood, yred, s_new, s_old
            # K3's sweep (the same kernel in both: the noise of the pairs)
            rhs = torch.randn(lead + (nvar, N), dtype=dtype, device="cuda", generator=gen)
            y_new = thomas.thomas_sweep(fact, rhs, plan)
            y_old = old_thomas.thomas_sweep(fact, rhs, plan)
            print(f"K3 sweep {where}; {gap(y_new, y_old)}", flush=True)
            del y_new, y_old
            turns(f"K3 sweep {name} {dt}",
                  lambda: old_thomas.thomas_sweep(fact, rhs, plan),
                  lambda: thomas.thomas_sweep(fact, rhs, plan), iters)
            # K3's correction, on the sweep's y and random neighbour unknowns
            y, _ = thomas.thomas_sweep(fact, rhs, plan)
            xm1, xp1 = (torch.randn(lead + (plan.s, plan.C), dtype=dtype, device="cuda",
                                    generator=gen) for _ in range(2))
            x_new = thomas.spike_correct(fact, y, xm1, xp1, plan, add_to=rhs)
            x_old = old_thomas.spike_correct(fact, y, xm1, xp1, plan, add_to=rhs)
            cp = thomas.correct_plan(plan.s, item, plan.Mc, plan.C, B)
            print(f"K3 correct {where}, {cp}; {gap((x_new,), (x_old,))}", flush=True)
            del x_new, x_old
            # timed on inputs cold in L2: copies that span COLD_BYTES, in turn
            nbytes = B * (3 * plan.nvar * plan.Np + 2 * plan.Mc * plan.s ** 2 * plan.C
                          + 2 * plan.s * plan.C) * item
            copies = 1 if nbytes >= COLD_BYTES else 1 + -(-COLD_BYTES // nbytes)
            sets = [(fact, y, xm1, xp1, rhs)] + [
                (fact._replace(W=fact.W.clone(), V=fact.V.clone()), y.clone(), xm1.clone(),
                 xp1.clone(), rhs.clone()) for _ in range(copies - 1)]

            def cold(mod):
                turn = itertools.cycle(sets)

                def go():
                    f_, y_, m_, p_, a_ = next(turn)
                    return mod.spike_correct(f_, y_, m_, p_, plan, add_to=a_)
                return go

            turns(f"K3 correct {name} {dt}", cold(old_thomas), cold(thomas),
                  5 * iters * copies)
            on_device(f"K3 correct {name} {dt}", cold(old_thomas), cold(thomas),
                      "spike_correct")
            del fact, rhs, y, xm1, xp1, sets
            torch.cuda.empty_cache()
        if words:
            continue
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
        on_device(f"K5 combine {dt}", lambda: old_combine.combine(rows, arrays),
                  lambda: combine.combine(rows, arrays), "combine")
    print(json.dumps({"card": smi, "means_ms": means}))


if __name__ == "__main__":
    main()
