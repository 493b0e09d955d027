#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero with no result):

0. the card's name and power limit; build every kernel from ``csrc/``, one
   nvcc per source, all at once; registers and spills of each library and
   of the s = 2 solver instantiations the KS path runs.
1. each kernel against its plain PyTorch version on CUDA tensors, f64 and
   f32: the checks of ``triflow_tpu_torch.ops.kernel_checks`` at small and
   odd shapes, then at the shapes of the main paths below.
2. the main paths through ``Simulation`` on ``device="cuda"``, f32 and f64:
   the Theta path (Burgers N = 2^20, 10 steps; the README model N = 200
   with its Dirichlet hook, to t = 50), then the Rosenbrock path:
   Kuramoto-Sivashinsky at N = 2^20 with ``RODASPR`` at a fixed dt
   (4 steps of 0.05) and adaptive (tol 1e-3, 2 output steps of 1.0), the
   README model through ``Simulation``'s defaults (RODASPR, adaptive) and
   through example 01's call (Theta with step doubling).  Every kernel
   entry must have launched in this phase; the results must be finite and
   agree with the port's CPU f64 run (plain versions) of the same case, in
   f64 with the same number of attempts in every output step.
3. timing with CUDA events at N = 2^20: ms per Theta step (Burgers) and
   per fixed RODASPR step (KS) with cell updates per second, ms per
   adaptive attempt, each kernel entry against its plain version at the KS
   path's shapes, K5 against one ``torch.mm`` over pre-stacked operands,
   and a ``torch.profiler`` breakdown of the Theta and RODASPR steps by
   kernel.

The last three lines are the kernels' JSON record (launches in phase 2,
largest error against the plain version, f32 ms of kernel, plain version,
bound and library call, with f64 beside them), the card's ``nvidia-smi``
name and power limit, and ``{"ok": true, "device": {...}}``.
"""

import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import sympy as sp
import torch

from triflow_tpu_torch import Model, Simulation, schemes
from triflow_tpu_torch.ops import (_build, _launch, chunked, combine, kernel_checks,
                                   pcr, stencil, thomas)
from triflow_tpu_torch.utils.convert import state_from_numpy

N_BIG = 1 << 20
BURGERS = ("-U * dxU + nu * dxxU", "U", ["nu"])
README = ("k * dxxU - c * dxU", "U", ["k", "c"])
KS = ("-dxxU - dxxxxU - U * dxU", "U", [])
DTYPES = {"float64": torch.float64, "float32": torch.float32}

#: the card's rates (NVIDIA H100 SXM data sheet, at the 700 W limit):
#: device memory, and the non-tensor-core float32 and float64 peaks
BYTES_PER_S = 3.35e12
OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}

#: kernel entry -> (route, source, the TPU kernel it replaces)
KERNELS = {
    "K1.F": ("cuda", "triflow_tpu_torch/csrc/stencil.cu",
             "triflow_tpu/ops/folded.py:469 eval_F_folded"),
    "K1.J": ("cuda", "triflow_tpu_torch/csrc/stencil.cu",
             "triflow_tpu/ops/folded.py:667 eval_J_folded"),
    "K2.spike_factor": ("cuda", "triflow_tpu_torch/csrc/spike_factor.cu",
                        "triflow_tpu/ops/folded.py:902 factor_sweeps_folded + "
                        "triflow_tpu/ops/pallas_thomas.py:322 _bwd_factor_call_cols"),
    "K3.thomas_sweep": ("cuda", "triflow_tpu_torch/csrc/spike_solve.cu",
                        "triflow_tpu/ops/pallas_thomas.py:729 chunked_solve_flat"),
    "K3.spike_correct": ("cuda", "triflow_tpu_torch/csrc/spike_solve.cu",
                         "triflow_tpu/ops/pallas_thomas.py:729 chunked_solve_flat "
                         "(spike correction of triflow_tpu/ops/folded.py:1478)"),
    "K4.pcr_factor": ("cuda", "triflow_tpu_torch/csrc/pcr.cu",
                      "triflow_tpu/ops/pallas_pcr.py:246 pcr_factor_fused_sub"),
    "K4.pcr_solve_shift": ("cuda", "triflow_tpu_torch/csrc/pcr.cu",
                           "triflow_tpu/ops/pallas_pcr.py:298 interface_shift_solve"),
    "K5.combine": ("cuda", "triflow_tpu_torch/csrc/combine.cu",
                   "triflow_tpu/ops/folded.py:543 combine_folded"),
}

#: substrings of the device kernels' names in a profiler trace
TRACE_NAMES = {"stencil_F": "K1.F", "stencil_J": "K1.J", "spike_factor": "K2.spike_factor",
               "thomas_sweep": "K3.thomas_sweep", "spike_correct": "K3.spike_correct",
               "pcr_factor": "K4.pcr_factor", "pcr_solve": "K4.pcr_solve_shift",
               "combine_kernel": "K5.combine"}


def log(msg):
    print(msg, flush=True)


def burgers_case(N=N_BIG):
    i = np.arange(N)
    return ({"x": i * 0.5, "U": np.cos(2 * np.pi * i / N * 4)},
            dict(periodic=True, nu=0.5), 0.05, 10 * 0.05, None)


def ks_case(dt, tmax, N=N_BIG):
    """bench.py's KS state: x = 0.5 i, cos(20 pi i / N) + 0.1 randn (seed 0)."""
    i = np.arange(N)
    rng = np.random.RandomState(0)
    return ({"x": 0.5 * i, "U": np.cos(2 * np.pi * 10 * i / N) + 0.1 * rng.randn(N)},
            dict(periodic=True), dt, tmax, None)


def dirichlet(t, fields, pars):
    fields["U"][0] = 1.0
    fields["U"][-1] = 0.0
    return fields, pars


def readme_case():
    x = np.linspace(0, 1, 200)
    return ({"x": x, "U": np.cos(2 * np.pi * x * 5)},
            dict(periodic=False, k=1e-3, c=3e-3), 5.0, 50.0, dirichlet)


THETA = dict(scheme=schemes.Theta, theta=1.0, time_stepping=False)

#: (name, equations, case, Simulation kwargs, f32 tolerance, f64 tolerance)
CASES = [
    ("burgers N=2^20 theta", BURGERS, burgers_case(), THETA, 1e-4, 1e-10),
    ("readme N=200 theta", README, readme_case(), THETA, 1e-3, 1e-10),
    ("ks N=2^20 rodaspr fixed (4 x 0.05)", KS, ks_case(0.05, 0.2),
     dict(scheme=schemes.RODASPR, time_stepping=False, tol=None), 1e-4, 1e-9),
    ("ks N=2^20 rodaspr adaptive tol 1e-3 (2 x 1.0)", KS, ks_case(1.0, 2.0),
     dict(tol=1e-3), 1e-2, 1e-9),
    ("readme N=200 Simulation defaults (rodaspr)", README, readme_case(), {}, 1e-2,
     1e-9),
    ("readme N=200 example 01 (theta, step doubling)", README, readme_case(),
     dict(scheme=schemes.Theta, theta=1.0), 1e-2, 1e-9),
]


def run_simulation(eqs, case, device, dtype, kwargs):
    """(output steps, final u, attempts in each output step)."""
    fields_np, pars, dt, tmax, hook = case
    model = Model(*eqs, double=dtype == torch.float64, device=device)
    fields, pars_t = state_from_numpy(fields_np, pars, model)
    sim = Simulation(model, fields, pars_t, dt=dt, tmax=tmax,
                     hook=hook or schemes.null_hook, **kwargs)
    attempts = []
    for t, fields in sim:
        attempts.append(getattr(sim._scheme, "_internal_iter", None))
    if sim.status != "finished" or not np.isclose(t, tmax):
        raise RuntimeError(f"simulation ended at t={t} with status {sim.status}")
    return sim.i, fields["U"], attempts


def cuda_ms(fn, iters):
    """Mean ms of fn() over iters launches, after a warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase0():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"phase 0: card {smi}; torch {torch.__version__} CUDA {torch.version.cuda}")
    start = time.perf_counter()
    stencils = [Model(*eqs).backend.stencil for eqs in (BURGERS, README, KS)]
    jobs = [lib.load for lib in (thomas.FACTOR_LIB, thomas.SOLVE_LIB, pcr.LIB,
                                 combine.LIB)]
    jobs += [st.load for st in stencils]
    with ThreadPoolExecutor(len(jobs)) as pool:
        for fut in [pool.submit(job) for job in jobs]:
            fut.result()
    log(f"phase 0: built {len(jobs)} libraries in "
        f"{time.perf_counter() - start:.1f} s (nvcc: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(_build.build_seconds.items()))
        + ")")
    for path in sorted(_build.BUILD_DIR.glob("*.log")):
        regs, spills, fn, s2 = [], [], None, []
        for line in path.read_text().splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
            elif int((re.findall(r"(\d+) bytes spill stores", line) or ["0"])[0]):
                spills.append(f"{fn} ({line.strip()})")
            elif "Used" in line and "registers" in line:
                n = int(line.split("Used")[1].split()[0])
                regs.append(n)
                # the s = 2 instantiations of K2/K3 and S2 = 4 of K4 (the KS path)
                if fn and (("spike" in fn or "thomas" in fn) and "Li2E" in fn
                           or "pcr" in fn and "Li4E" in fn):
                    s2.append(f"{fn}: {n}")
        log(f"  ptxas {path.stem}: {len(regs)} kernels, at most {max(regs, default=0)} "
            f"registers; spills: {'; '.join(spills) or 'none'}")
        for entry in s2:
            log(f"    registers {entry}")
    return smi


def path_inputs(eqs, case, dtype):
    """A model on the card, its state, and the inputs each kernel gets on
    the path's first step."""
    fields_np, pars, dt, _, _ = case
    model = Model(*eqs, double=dtype == torch.float64, device="cuda")
    fields, pars_t = state_from_numpy(fields_np, pars, model)
    b = model.backend
    u, helpers, x = b.split_fields(fields)
    pstack = b.pack_pars(pars_t, x)
    return model, fields, pars_t, (u, helpers, pstack, x), dt


def rodaspr_rows():
    """The final combination's rows of RODASPR, as the scheme emits them."""
    ros = schemes.RODASPR(Model(*KS, device="cpu"))
    m = [float(v) for v in ros._m_t]
    d = [float(a - b) for a, b in zip(ros._m_t, ros._m_pred_t)]
    return [[1.0] + m, [0.0] + d], float(ros._gamma[0, 0])


def phase1():
    log("phase 1: kernels against their plain versions")
    small = kernel_checks.run_all("cuda")
    for dt_name, res in small.items():
        log(f"  small shapes {dt_name}: " + json.dumps(res))
    rows, _ = rodaspr_rows()
    errs = {}
    for dt_name, dtype in DTYPES.items():
        res = dict(small[dt_name])
        model, _, _, args, dt = path_inputs(BURGERS, burgers_case(), dtype)
        kernel_checks.check_stencil(model, N_BIG, True, "cuda", results=res)
        bands = model.backend.J_bands(*args, periodic=True)
        kernel_checks.check_solver(bands, 1.0, -dt, True, results=res)
        rm = Model(*README, double=dtype == torch.float64, device="cuda")
        kernel_checks.check_stencil(rm, 200, False, "cuda", results=res)
        fields, pars = state_from_numpy(readme_case()[0], readme_case()[1], rm)
        u, helpers, x = rm.backend.split_fields(fields)
        rbands = rm.backend.J_bands(u, helpers, rm.backend.pack_pars(pars, x), x,
                                    periodic=False)
        kernel_checks.check_solver(rbands, 1.0, -5.0, False, results=res)
        # the KS path: F with bias and J at s = 2, the s = 2 solver, K5 at
        # A = 7, R = 2 and at every stage's A, R = 2
        km, _, _, kargs, kdt = path_inputs(KS, ks_case(0.05, 0.2), dtype)
        kernel_checks.check_stencil(km, N_BIG, True, "cuda", results=res)
        kbands = km.backend.J_bands(*kargs, periodic=True)
        kernel_checks.check_solver(kbands, 1.0, -0.25 * kdt, True, results=res)
        rng = np.random.default_rng(1)
        for A in range(2, 8):
            arrays = [torch.tensor(rng.standard_normal((1, N_BIG)), dtype=dtype,
                                   device="cuda") for _ in range(A)]
            stage_rows = [row[:A] for row in rows] if A < 7 else rows
            kernel_checks.check_combine(stage_rows, arrays, res)
        log(f"  main-path shapes {dt_name}: " + json.dumps(res))
        errs[dt_name] = res
    return errs


def phase2():
    log("phase 2: the main paths through Simulation on the card")
    _launch.reset_counters()
    runs = {}
    for name, eqs, case, kwargs, _, _ in CASES:
        for dt_name, dtype in DTYPES.items():
            torch.cuda.synchronize()
            start = time.perf_counter()
            steps, u, attempts = run_simulation(eqs, case, "cuda", dtype, kwargs)
            torch.cuda.synchronize()
            runs[(name, dt_name)] = (steps, u, attempts, time.perf_counter() - start)
    launches = _launch.counts()
    log("  launches: " + json.dumps(launches))
    missing = [k for k in KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the main paths: {missing}")
    for name, eqs, case, kwargs, tol32, tol64 in CASES:
        start = time.perf_counter()
        steps_ref, u_ref, att_ref = run_simulation(eqs, case, "cpu", torch.float64,
                                                   kwargs)
        cpu_s = time.perf_counter() - start
        scale = float(u_ref.abs().max())
        _, _, dt, tmax, _ = case
        log(f"  {name}: horizon {tmax:g} in output steps of {dt:g}; CPU f64 "
            f"attempts per output step {att_ref} ({cpu_s:.1f} s)")
        for dt_name in DTYPES:
            steps, u, attempts, secs = runs[(name, dt_name)]
            if not bool(torch.isfinite(u).all()) or u.shape != u_ref.shape:
                raise RuntimeError(f"{name} {dt_name}: non-finite or misshapen")
            err = float((u.double().cpu() - u_ref).abs().max()) / scale
            tol = tol32 if dt_name == "float32" else tol64
            log(f"    {dt_name}: {steps} steps in {secs:.3f} s wall (first call, "
                f"launch included); attempts per output step {attempts}; "
                f"max|u - u_cpu_f64| / max|u| = {err:.3e} (tolerance {tol:.0e})")
            if steps != steps_ref or not err <= tol:
                raise RuntimeError(f"{name} {dt_name}: disagrees with the CPU run")
            if dt_name == "float64" and attempts != att_ref:
                raise RuntimeError(f"{name} f64: attempts {attempts} differ from the "
                                   f"CPU run's {att_ref}")
    return launches


def bound(nbytes, ops, dtype):
    """(bound ms, what bounds it): bytes over the memory rate against
    operations over the dtype's peak."""
    t_bytes = nbytes / BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def expr_ops(exprs):
    return sum(int(sp.count_ops(e)) for e in exprs)


def ks_pairs(dtype):
    """Kernel entry -> (kernel call, plain call, bytes, operations, library
    call or None), on the inputs of the first fixed RODASPR step of KS at
    N = 2^20 (g00 dt = 0.0125)."""
    model, _, _, (u, helpers, pstack, x), dt = path_inputs(KS, ks_case(0.05, 0.2), dtype)
    b, sysm = model.backend, model.system
    item = torch.finfo(dtype).bits // 8
    rows, g00 = rodaspr_rows()
    gdt = g00 * dt
    plan = chunked.make_plan(N_BIG, 1, 2, True)
    s, C, Mc, W, nlev = plan.s, plan.C, plan.Mc, plan.W, pcr.n_levels(plan.C)
    M = N_BIG // plan.g
    nvar = sysm.nvar
    n_in = (nvar + len(sysm.help_funcs) + len(sysm.pars) + 1) * N_BIG
    rng = np.random.default_rng(2)
    bias = torch.tensor(rng.standard_normal((nvar, N_BIG)), dtype=dtype, device="cuda")
    bands = b.J_bands(u, helpers, pstack, x, periodic=True)
    sp_ = thomas.spike_factor(bands, 1.0, -gdt, plan)
    red = pcr.pcr_factor(sp_.Lred, sp_.Ured, True)
    rhs = b.F(u, helpers, pstack, x, periodic=True, scale=gdt, bias=bias)
    y, yred = thomas.thomas_sweep(sp_, rhs, plan)
    xm1, xp1 = pcr.pcr_solve_shift(red, yred, True)
    arrays = [u] + [torch.tensor(rng.standard_normal((nvar, N_BIG)) * 1e-3, dtype=dtype,
                                 device="cuda") for _ in range(6)]
    A, R = len(arrays), len(rows)
    coefs = torch.tensor(rows, dtype=dtype, device="cuda")
    stacked = torch.stack(arrays).view(A, -1)
    blk = s * s * C
    return {
        "K1.F": (lambda: b.F(u, helpers, pstack, x, periodic=True, scale=gdt, bias=bias),
                 lambda: stencil.eval_F_plain(b, u, helpers, pstack, x, True, gdt, bias),
                 (n_in + 2 * nvar * N_BIG) * item,
                 (expr_ops(sysm.F_exprs) + 2 * nvar) * N_BIG, None),
        "K1.J": (lambda: b.J_bands(u, helpers, pstack, x, periodic=True),
                 lambda: b.J_bands_impl(u, helpers, pstack, x, periodic=True),
                 (n_in + W * nvar * nvar * N_BIG) * item,
                 expr_ops(sysm.J_band_exprs.values()) * N_BIG, None),
        # rows: a block inverse and three block products per supernode row
        "K2.spike_factor": (lambda: thomas.spike_factor(bands, 1.0, -gdt, plan),
                            lambda: thomas.spike_factor_plain(bands, 1.0, -gdt, plan),
                            (W * nvar * nvar * N_BIG + 5 * Mc * blk
                             + 2 * (2 * s) ** 2 * C) * item, 8 * s ** 3 * M, None),
        "K3.thomas_sweep": (lambda: thomas.thomas_sweep(sp_, rhs, plan),
                            lambda: thomas.thomas_sweep_plain(sp_, rhs, plan),
                            (3 * Mc * blk + 2 * nvar * N_BIG + 2 * s * C) * item,
                            6 * s * s * M, None),
        "K4.pcr_factor": (lambda: pcr.pcr_factor(sp_.Lred, sp_.Ured, True),
                          lambda: pcr.pcr_factor_plain(sp_.Lred, sp_.Ured, True),
                          (2 * (2 * s) ** 2 * C + (2 * nlev + 1) * (2 * s) ** 2 * C)
                          * item, 12 * (2 * s) ** 3 * C * nlev, None),
        "K4.pcr_solve_shift": (lambda: pcr.pcr_solve_shift(red, yred, True),
                               lambda: pcr.pcr_solve_shift_plain(red, yred, True),
                               ((2 * nlev + 1) * (2 * s) ** 2 * C + 4 * s * C) * item,
                               4 * (2 * s) ** 2 * C * nlev, None),
        "K3.spike_correct": (lambda: thomas.spike_correct(sp_, y, xm1, xp1, plan),
                             lambda: thomas.spike_correct_plain(sp_, y, xm1, xp1, plan),
                             (2 * nvar * N_BIG + 2 * Mc * blk + 2 * s * C) * item,
                             4 * s * nvar * N_BIG, None),
        "K5.combine": (lambda: combine.combine(rows, arrays),
                       lambda: combine.combine_plain(rows, arrays),
                       (A + R) * nvar * N_BIG * item, 2 * A * R * nvar * N_BIG,
                       lambda: torch.mm(coefs, stacked)),
    }


def profile_step(scheme, fields, pars, dt, steps=5):
    """Device µs per step by kernel, busy and idle share of the device span,
    from torch.profiler over ``steps`` whole fixed steps; None when the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    scheme(0.0, fields, dt, pars)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            scheme(0.0, fields, dt, pars)
        torch.cuda.synchronize()
    by_name, busy, first, last = {}, 0.0, None, None
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = ev.time_range.end - ev.time_range.start
        first = ev.time_range.start if first is None else min(first, ev.time_range.start)
        last = ev.time_range.end if last is None else max(last, ev.time_range.end)
        key = next((k for sub, k in TRACE_NAMES.items() if sub in ev.name), "other")
        by_name[key] = by_name.get(key, 0.0) + dur
        busy += dur
    if not busy:
        return None
    span = last - first
    return {"us_per_step": {k: v / steps for k, v in sorted(by_name.items())},
            "busy_us_per_step": busy / steps, "span_us_per_step": span / steps,
            "idle_share": 1.0 - busy / span}


def log_profile(what, dt_name, prof):
    if prof is None:
        log(f"  profiler {what} {dt_name}: no device time recorded; breakdown "
            "not measured")
    else:
        log(f"  profiler {what} {dt_name}: " + json.dumps(prof))


def phase3():
    log("phase 3: timing at N = 2^20 (CUDA events)")
    times = {}
    for dt_name, dtype in DTYPES.items():
        times[dt_name] = {}
        # the Theta path (Burgers), as before
        model, fields, pars_t, _, dt = path_inputs(BURGERS, burgers_case(), dtype)
        scheme = schemes.Theta(model, theta=1.0)
        step_ms = cuda_ms(lambda: scheme(0.0, fields, dt, pars_t), 20)
        log(f"  theta step burgers {dt_name}: {step_ms:.4f} ms/step, "
            f"{N_BIG / (step_ms * 1e-3):.4e} cell-updates/s")
        log_profile("theta step burgers", dt_name, profile_step(scheme, fields, pars_t, dt))
        # the Rosenbrock path (KS): fixed step, adaptive attempts
        model, fields, pars_t, _, dt = path_inputs(KS, ks_case(0.05, 0.2), dtype)
        ros = schemes.RODASPR(model, time_stepping=False, tol=None)
        ros_ms = cuda_ms(lambda: ros(0.0, fields, dt, pars_t), 10)
        log(f"  rodaspr fixed step ks {dt_name}: {ros_ms:.4f} ms/step, "
            f"{N_BIG / (ros_ms * 1e-3):.4e} cell-updates/s")
        times[dt_name]["rodaspr_step_ms"] = ros_ms
        for rep in range(2):
            ada = schemes.RODASPR(model, tol=1e-3)
            t, f, attempts = 0.0, fields, []
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(2):
                t, f = ada(t, f, 1.0, pars_t)
                attempts.append(ada._internal_iter)
            torch.cuda.synchronize()
            secs = time.perf_counter() - start
            log(f"  rodaspr adaptive ks {dt_name} (run {rep}): {secs * 1e3 / sum(attempts):.4f} "
                f"ms per attempt, attempts per output step {attempts} "
                f"(host clock, synchronised)")
        times[dt_name]["ms_per_attempt"] = secs * 1e3 / sum(attempts)
        log_profile("rodaspr fixed step ks", dt_name, profile_step(ros, fields, pars_t, dt))
        for name, (kern, plain, nbytes, ops, library) in ks_pairs(dtype).items():
            # plain, kernel, kernel, plain: drift in clocks shows as a spread
            p1, k1, k2, p2 = (cuda_ms(f, 5) for f in (plain, kern, kern, plain))
            lib_ms = min(cuda_ms(library, 5) for _ in range(2)) if library else None
            b_ms, b_by = bound(nbytes, ops, dtype)
            times[dt_name][name] = (min(k1, k2), min(p1, p2), b_ms, b_by, lib_ms)
            log(f"  {name} {dt_name}: kernel {k1:.4f}/{k2:.4f} ms, plain "
                f"{p1:.4f}/{p2:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} bytes, "
                f"{ops} operations)"
                + (f", library {lib_ms:.4f} ms" if lib_ms is not None else ""))
        # small N is latency: host clock around each synchronised step
        rm = Model(*README, double=dtype == torch.float64, device="cuda")
        fields_np, pars, rdt, _, hook = readme_case()
        rf, rp = state_from_numpy(fields_np, pars, rm)
        for label, rs in (("theta", schemes.Theta(rm, theta=1.0)),
                          ("rodaspr fixed", schemes.RODASPR(rm, time_stepping=False,
                                                            tol=None))):
            lat = []
            for _ in range(51):
                start = time.perf_counter()
                rs(0.0, rf, rdt, rp, hook=hook)
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - start)
            lat = sorted(lat[1:])
            log(f"  readme N=200 {label} step {dt_name}: median {lat[25] * 1e3:.4f} ms "
                f"(p10 {lat[5] * 1e3:.4f}, p90 {lat[45] * 1e3:.4f}), host clock")
    return times


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    smi = phase0()
    errs = phase1()
    launches = phase2()
    times = phase3()
    record = []
    for name, (route, source, replaces) in KERNELS.items():
        e32, e64 = errs["float32"][name], errs["float64"][name]
        k32, p32, b32, by32, l32 = times["float32"][name]
        k64, p64, b64, _, l64 = times["float64"][name]
        record.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max(e32, e64),
            "ms": k32, "plain_ms": p32, "bound_ms": b32, "bound_by": by32,
            "library_ms": l32,
            "max_abs_err_f32": e32, "max_abs_err_f64": e64,
            "ms_f64": k64, "plain_ms_f64": p64, "bound_ms_f64": b64,
            "library_ms_f64": l64,
        })
    print(json.dumps({"kernels": record}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
