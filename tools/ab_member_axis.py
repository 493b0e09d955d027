#!/usr/bin/env python3
"""Time the PyTorch port's single-grid paths in two checkouts, in turns on
one NVIDIA GPU: what an ensemble's member axis costs one grid.

    python3 tools/ab_member_axis.py OTHER_CHECKOUT [PAIRS]

runs OTHER, this checkout, this checkout, OTHER (PAIRS times, default 1),
each in a process of its own (one ``triflow_tpu_torch`` per process; the
first process of each checkout builds its kernels), and prints one JSON
line per run: the card's name, and per dtype the CUDA-event ms of one
fixed RODASPR step of KS at N = 10^6 (K1-K5, Woodbury plan), that step's
device µs per kernel function (``torch.profiler`` over 5 steps, template
arguments dropped), the CUDA-event ms of every kernel entry at that
step's shapes, the device µs per launch (``torch.profiler`` over 20
launches alone) of the banded matvec K7 on that step's bands and state
and, in float64 where the checkout has it, of the df64 residual K8 on the
same bands and state with a right-hand side of its own, of one Theta step of Burgers at N =
10^6 and of every kernel entry at its shapes, with the host's ms to
enqueue one Theta step (host clock over 20 unsynchronised steps), of one
K6 RODASPR step of the README model (N = 200, ``device_fixed_scan`` of
100 steps), and of one K6 adaptive output step of KS at N = 2^13 (tol
1e-3, from t = 0).  Then one JSON line per measurement: its mean over
OTHER's runs and over this checkout's, this against OTHER in per cent,
and the spread (max - min over mean, per cent) within each side.
"""

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

KS = ("-dxxU - dxxxxU - U * dxU", "U", [])
BURGERS = ("-U * dxU + nu * dxxU", "U", ["nu"])
README = ("k * dxxU - c * dxU", "U", ["k", "c"])


def cuda_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def entries(b, u, helpers, pstack, x, plan, beta, scale):
    """{kernel entry: callable} of one implicit stage's kernels on a grid:
    K1's F (with a bias) and J, K2, K4 (factor, the Woodbury set-up where
    the plan has one, the per-stage solve), K3's sweep and correction, and
    K5's two-row combination of six arrays (a RODASPR stage's sums)."""
    from triflow_tpu_torch.ops import combine, pcr, thomas

    bands = b.J_bands(u, helpers, pstack, x, periodic=True)
    sp = thomas.spike_factor(bands, 1.0, beta, plan)
    red = pcr.pcr_factor(sp.Lred, sp.Ured, plan.cyclic)
    wood = pcr.woodbury(red, sp.Lred, sp.Ured) if plan.woodbury else ()
    rhs = b.F(u, helpers, pstack, x, periodic=True, scale=scale, bias=u)
    y, yred = thomas.thomas_sweep(sp, rhs, plan)
    xm1, xp1 = pcr.pcr_solve_shift(red, yred, True, *wood)
    arrays = [u + k for k in range(6)]
    rows = [[1.0, 0.5, -0.25, 0.125, 2.0, -1.0], [0.0, 0.3, 0.7, -0.2, 0.1, 0.4]]
    out = {
        "K1.F": lambda: b.F(u, helpers, pstack, x, periodic=True, scale=scale, bias=u),
        "K1.J": lambda: b.J_bands(u, helpers, pstack, x, periodic=True),
        "K2.spike_factor": lambda: thomas.spike_factor(bands, 1.0, beta, plan),
        "K4.pcr_factor": lambda: pcr.pcr_factor(sp.Lred, sp.Ured, plan.cyclic),
        "K3.thomas_sweep": lambda: thomas.thomas_sweep(sp, rhs, plan),
        "K4.pcr_solve_shift": lambda: pcr.pcr_solve_shift(red, yred, True, *wood),
        "K3.spike_correct": lambda: thomas.spike_correct(sp, y, xm1, xp1, plan,
                                                         add_to=u),
        "K5.combine": lambda: combine.combine(rows, arrays),
    }
    if plan.woodbury:
        out["K4.pcr_solve (woodbury)"] = lambda: pcr.woodbury(red, sp.Lred, sp.Ured)
    return out


def kernel_us(torch, fn, name, launches=20, tries=3):
    """Device µs per launch of the kernel whose name holds ``name``; a
    window in which the profiler did not record every launch (it can drop
    a window's events) is measured again, and raises after ``tries``."""
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
    raise RuntimeError(f"the profiler recorded {len(times)} of {launches} {name} launches")


def device_us(torch, fn, steps=5):
    """{kernel function: device µs per call of fn} under torch.profiler,
    and their sum under "busy"."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = re.sub(r"^void\s+", "", ev.name.replace("(anonymous namespace)::", ""))
        name = re.match(r"[\w:]*", name).group(0).split("::")[-1] or ev.name
        dur = (ev.time_range.end - ev.time_range.start) / steps
        out[name] = out.get(name, 0.0) + dur
        out["busy"] = out.get("busy", 0.0) + dur
    return out


def run(root):
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from triflow_tpu_torch import Model, schemes
    from triflow_tpu_torch.ops import chunked, pcr, thomas
    from triflow_tpu_torch.utils.convert import state_from_numpy

    # build every library the run needs at once (one nvcc each)
    from concurrent.futures import ThreadPoolExecutor

    from triflow_tpu_torch.ops import combine, matvec

    try:
        from triflow_tpu_torch.ops import mixed
    except ImportError:  # a checkout from before K8
        mixed = None
    backends = [Model(*eqs).backend for eqs in (KS, BURGERS, README)]
    # one job per nvcc run (a checkout before libraries built by dtype: load)
    jobs = [job for lib in (thomas.FACTOR_LIB, thomas.SOLVE_LIB, pcr.LIB, combine.LIB,
                            matvec.LIB) + ((mixed.LIB,) if mixed else ())
            for job in getattr(lib, "builds", lambda lib=lib: [lib.load])()]
    jobs += [b.stencil.load for b in backends] + [b.megastep.load for b in backends[::2]]
    with ThreadPoolExecutor(len(jobs)) as pool:
        for fut in [pool.submit(job) for job in jobs]:
            fut.result()

    def state(eqs, fields, pars, dtype):
        model = Model(*eqs, double=dtype == torch.float64, device="cuda")
        f, p = state_from_numpy(fields, pars, model)
        return model, f, p

    out = {"checkout": str(root), "card": torch.cuda.get_device_name(0)}
    for dt_name, dtype in (("float64", torch.float64), ("float32", torch.float32)):
        N = 10 ** 6
        i = np.arange(N)
        u0 = np.cos(2 * np.pi * 10 * i / N) + 0.1 * np.random.RandomState(0).randn(N)
        model, fields, pars = state(KS, {"x": 0.5 * i, "U": u0}, {"periodic": True}, dtype)
        ros = schemes.RODASPR(model, time_stepping=False, tol=None)
        out[f"{dt_name} ks N=10^6 rodaspr step ms"] = cuda_ms(
            torch, lambda: ros(0.0, fields, 0.05, pars), 20)
        for name, us in device_us(torch, lambda: ros(0.0, fields, 0.05, pars)).items():
            out[f"{dt_name} ks N=10^6 rodaspr step device {name} us"] = us
        b = model.backend
        u, helpers, x = b.split_fields(fields)
        pstack = b.pack_pars(pars, x)
        gdt = 0.25 * 0.05
        for name, fn in entries(b, u, helpers, pstack, x, chunked.make_plan(N, 1, 2, True),
                                -gdt, gdt).items():
            out[f"{dt_name} ks N=10^6 {name} ms"] = cuda_ms(torch, fn, 20)
        bands = b.J_bands(u, helpers, pstack, x, periodic=True)
        out[f"{dt_name} ks N=10^6 K7.matvec device us"] = kernel_us(
            torch, lambda: matvec.banded_matvec(bands, u, True, gdt), "matvec_")
        if mixed is not None and dtype == torch.float64:
            rhs = 0.5 * u
            out[f"{dt_name} ks N=10^6 K8.residual device us"] = kernel_us(
                torch, lambda: mixed.mixed_residual(bands, u, rhs, gdt, True),
                "mixed_residual")
        model, fields, pars = state(BURGERS, {"x": 0.5 * i, "U": np.cos(2 * np.pi * i / N * 4)},
                                    {"periodic": True, "nu": 0.5}, dtype)
        theta = schemes.Theta(model, theta=1.0)
        out[f"{dt_name} burgers N=10^6 theta step ms"] = cuda_ms(
            torch, lambda: theta(0.0, fields, 0.05, pars), 20)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(20):
            theta(0.0, fields, 0.05, pars)
        out[f"{dt_name} burgers N=10^6 theta step host enqueue ms"] = (
            time.perf_counter() - start) * 1e3 / 20
        torch.cuda.synchronize()
        b = model.backend
        u, helpers, x = b.split_fields(fields)
        pstack = b.pack_pars(pars, x)
        for name, fn in entries(b, u, helpers, pstack, x, chunked.make_plan(N, 1, 1, True),
                                -0.05, 0.05).items():
            out[f"{dt_name} burgers N=10^6 {name} ms"] = cuda_ms(torch, fn, 20)
        xr = np.linspace(0, 1, 200)
        model, fields, pars = state(README, {"x": xr, "U": np.cos(2 * np.pi * xr * 5)},
                                    {"periodic": False, "k": 1e-3, "c": 3e-3}, dtype)
        b = model.backend
        u, helpers, x = b.split_fields(fields)
        args = (u, helpers, b.pack_pars(pars, x), x)
        scan = schemes.RODASPR(model, time_stepping=False, tol=None).device_fixed_scan(
            200, periodic=False)
        out[f"{dt_name} readme N=200 K6 rodaspr step us"] = 10 * cuda_ms(
            torch, lambda: scan(0.0, *args, 5.0, 100), 3)
        N = 1 << 13
        i = np.arange(N)
        u0 = np.cos(2 * np.pi * 10 * i / N) + 0.1 * np.random.RandomState(0).randn(N)
        model, fields, pars = state(KS, {"x": 0.5 * i, "U": u0}, {"periodic": True}, dtype)
        out[f"{dt_name} ks N=2^13 K6 adaptive output step ms"] = cuda_ms(
            torch, lambda: schemes.RODASPR(model, tol=1e-3)(0.0, fields, 1.0, pars), 2)
    print(json.dumps(out), flush=True)


def summary(runs):
    """One JSON line per measurement: each side's mean, this against the
    other in per cent, each side's spread in per cent."""
    for key in runs["this"][0]:
        if not key.endswith(("ms", "us")) or any(key not in r for rs in runs.values()
                                                  for r in rs):
            continue
        sides = {side: [r[key] for r in rs] for side, rs in runs.items()}
        mean = {side: statistics.fmean(v) for side, v in sides.items()}
        print(json.dumps({
            "measurement": key, "other_mean": mean["other"], "this_mean": mean["this"],
            "this_vs_other_pct": 100 * (mean["this"] / mean["other"] - 1),
            "other_spread_pct": 100 * (max(sides["other"]) - min(sides["other"]))
            / mean["other"],
            "this_spread_pct": 100 * (max(sides["this"]) - min(sides["this"]))
            / mean["this"]}), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--run":
        return run(Path(sys.argv[2]).resolve())
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    this = Path(__file__).resolve().parents[1]
    pairs = int(sys.argv[2]) if len(sys.argv) == 3 else 1
    runs = {"other": [], "this": []}
    for _ in range(pairs):
        for side, root in (("other", other), ("this", this), ("this", this),
                           ("other", other)):
            proc = subprocess.run([sys.executable, __file__, "--run", str(root)],
                                  check=True, stdout=subprocess.PIPE, text=True)
            print(proc.stdout, end="", flush=True)
            runs[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    summary(runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
