#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero with no result):

0. the card's name and power limit; build every kernel from ``csrc/``, one
   nvcc per source, all at once (K1 and K6 once per model); registers and
   spills of each library, of the s = 2 solver instantiations the KS path
   runs, and of K6 at s = 1, 2 and 4 in both dtypes.
1. each kernel against its plain PyTorch version on CUDA tensors, f64 and
   f32: first the readings behind the limit on K6's adapted dt (eight
   seeds, and the gap of an err twice too large), then the checks of
   ``triflow_tpu_torch.ops.kernel_checks`` at small and odd shapes (K6 at
   the shapes of ``tests/test_torch_megastep.py``), then at the shapes of
   the main paths below.
2. the main paths through ``Simulation`` on ``device="cuda"``, f32 and f64,
   each case driven with the launch counts set to 0 just before it and read
   just after: the Theta path (Burgers at the reference's N = 10^6, 10
   steps, and N = 2^20, 4 steps; the README model N = 200 with its
   Dirichlet hook, to t = 50, through K6), then the Rosenbrock path:
   Kuramoto-Sivashinsky at N = 10^6 with ``RODASPR`` at a fixed dt (4
   steps of 0.05) and adaptive (tol 1e-3, 2 output steps of 1.0), at
   N = 2^20 the same with 2 steps and 1 output step, KS at N = 2^13 (K6) and
   10^4 (K1-K5) adaptive the same way with no hook, Burgers at N = 10^4
   adaptive through K6, the README model through ``Simulation``'s defaults
   (RODASPR, adaptive, K6 steps) and through example 01's call (Theta with
   step doubling).  Each case's chunk plan is the one named in ``CASES``:
   the power-of-two grids close their ring block-cyclic, the others
   (N = 10^6, 10^4) through the Woodbury correction, whose set-up
   launches K4.pcr_solve once per factor on the multi-launch path and
   runs inside K6 on K6's.  The large cases must launch every entry of
   K1-K5 they need, the small ones K6 alone; the results must be finite
   and agree with the port's CPU f64 run (plain versions) of the same
   case, in f64 with the same number of attempts in every output step.
3. timing with CUDA events at N = 2^20 and 10^6: ms per Theta step
   (Burgers) and per fixed RODASPR step (KS) with cell updates per second,
   ms per adaptive attempt, each kernel entry against its plain version at
   the KS path's shapes (K4.pcr_solve, the Woodbury set-up, and the
   Woodbury correction of K4.pcr_solve_shift at 10^6), K5 against one
   ``torch.mm`` over pre-stacked operands, and a ``torch.profiler``
   breakdown of the Theta and RODASPR steps by kernel; then the small
   grids: the KS N = 10^4 and Burgers N = 10^4 (K6, Woodbury) adaptive
   output steps, the README step at N = 200 per
   synchronised step (K6 and the multi-launch path) and K6's step under
   ``torch.profiler``, ``device_fixed_scan`` at 100 steps, the KS N = 2^13 adaptive output step, K6's chunk-count
   sweeps with a cost fit per block size (behind its plan), and the
   crossover sweeps N = 2^10 .. 2^16 of fixed RODASPR and Theta steps,
   K6 against the multi-launch path, for Burgers (s = 1), KS (s = 2) and
   the two-variable model (s = 4), behind K6's gate per block size.

The last three lines are the kernels' JSON record (launches in phase 2,
largest error against the plain version, f32 ms of kernel, plain version,
bound and library call, with f64 beside them; K4.pcr_solve at KS
N = 10^6, the others at KS N = 2^20), the card's ``nvidia-smi``
name and power limit, and ``{"ok": true, "device": {...}}``.
"""

import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import sympy as sp
import torch

from triflow_tpu_torch import Model, Simulation, schemes
from triflow_tpu_torch.core.rosenbrock import adaptive_controller
from triflow_tpu_torch.ops import (_build, _launch, chunked, combine, kernel_checks,
                                   megastep, pcr, stencil, thomas)
from triflow_tpu_torch.utils.convert import state_from_numpy

N_BIG = 1 << 20
N_REF = 10 ** 6  # the reference benchmark's headline grids (bench.py)
N_REF_SMALL = 10 ** 4
BURGERS = ("-U * dxU + nu * dxxU", "U", ["nu"])
README = ("k * dxxU - c * dxU", "U", ["k", "c"])
KS = ("-dxxU - dxxxxU - U * dxU", "U", [])
TWO_VAR = kernel_checks.MEGA_MODELS["two_var"]
N_SMALL = 1 << 13
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
    "K4.pcr_solve": ("cuda", "triflow_tpu_torch/csrc/pcr.cu",
                     "triflow_tpu/ops/pallas_pcr.py:408 pcr_solve_fused_sub"),
    "K5.combine": ("cuda", "triflow_tpu_torch/csrc/combine.cu",
                   "triflow_tpu/ops/folded.py:543 combine_folded"),
    "K6.step": ("cuda", "triflow_tpu_torch/csrc/megastep.cu",
                "triflow_tpu/ops/megastep.py:1491 _launch"),
    "K6.adaptive": ("cuda", "triflow_tpu_torch/csrc/megastep.cu",
                    "triflow_tpu/ops/megastep.py:1242 row_adaptive_step_folded"),
}
#: the kernel entries of the multi-launch path on a block-cyclic plan; a
#: Woodbury plan adds K4.pcr_solve
MULTI_LAUNCH = [k for k in KERNELS if not k.startswith("K6") and k != "K4.pcr_solve"]
THETA_KERNELS = [k for k in MULTI_LAUNCH if k != "K5.combine"]
WOOD = ["K4.pcr_solve"]

#: substrings of the device kernels' names in a profiler trace
TRACE_NAMES = {"stencil_F": "K1.F", "stencil_J": "K1.J", "spike_factor": "K2.spike_factor",
               "thomas_sweep": "K3.thomas_sweep", "spike_correct": "K3.spike_correct",
               "pcr_factor": "K4.pcr_factor", "pcr_solve_shift": "K4.pcr_solve_shift",
               "pcr_solve_kernel": "K4.pcr_solve",
               "combine_kernel": "K5.combine", "step_kernel": "K6.step",
               "adaptive_kernel": "K6.adaptive"}


def log(msg):
    print(msg, flush=True)


def burgers_case(N=N_BIG, dt=0.05, tmax=10 * 0.05):
    i = np.arange(N)
    return ({"x": i * 0.5, "U": np.cos(2 * np.pi * i / N * 4)},
            dict(periodic=True, nu=0.5), dt, tmax, None)


def ks_case(dt, tmax, N=N_BIG):
    """bench.py's KS state: x = 0.5 i, cos(20 pi i / N) + 0.1 randn (seed 0)."""
    i = np.arange(N)
    rng = np.random.RandomState(0)
    return ({"x": 0.5 * i, "U": np.cos(2 * np.pi * 10 * i / N) + 0.1 * rng.randn(N)},
            dict(periodic=True), dt, tmax, None)


def two_var_case(dt, tmax, N):
    """The two-variable model's state of the reference's megastep tests."""
    rng = np.random.RandomState(3)
    i = np.arange(N)
    h, q = (1.2 + 0.1 * np.cos(2 * np.pi * i / N * 5 + k) + 0.01 * rng.randn(N)
            for k in range(2))
    return {"x": i * 0.5, "h": h, "q": q}, dict(periodic=True), dt, tmax, None


def dirichlet(t, fields, pars):
    fields["U"][0] = 1.0
    fields["U"][-1] = 0.0
    return fields, pars


def readme_case():
    x = np.linspace(0, 1, 200)
    return ({"x": x, "U": np.cos(2 * np.pi * x * 5)},
            dict(periodic=False, k=1e-3, c=3e-3), 5.0, 50.0, dirichlet)


THETA = dict(scheme=schemes.Theta, theta=1.0, time_stepping=False)

#: K6's chunk-count sweeps, one cost fit each (megastep.plan_cost_us has
#: the RODASPR fits by block size s): (name, grids as (equations, case),
#: table)
CHUNK_SWEEPS = [
    ("rodaspr s=1", [(README, readme_case()), (BURGERS, burgers_case(N_SMALL))],
     kernel_checks.rodaspr_table(False)),
    ("rodaspr s=2", [(KS, ks_case(0.05, 0.2, N)) for N in (512, 2048, N_SMALL, 1 << 15)],
     kernel_checks.rodaspr_table(False)),
    ("rodaspr s=4", [(TWO_VAR, two_var_case(0.02, 0.2, N)) for N in (1024, N_SMALL)],
     kernel_checks.rodaspr_table(False)),
    ("theta s=2", [(KS, ks_case(0.05, 0.2, N_SMALL))], megastep.theta_table(1.0)),
]
#: the crossover sweep, K6 against the multi-launch path: (name,
#: equations, case of N, block size s) by scheme, at N = 2^e
SWEEP_MODELS = [("burgers", BURGERS, burgers_case, 1),
                ("ks", KS, lambda N: ks_case(0.05, 0.2, N), 2),
                ("two-var", TWO_VAR, lambda N: two_var_case(0.02, 0.2, N), 4)]
SWEEP_SCHEMES = {"rodaspr": lambda m: schemes.RODASPR(m, time_stepping=False, tol=None),
                 "theta": lambda m: schemes.Theta(m, theta=1.0)}
SWEEP_EXPONENTS = range(10, 17)

#: (name, equations, case, Simulation kwargs, f32 tolerance, f64 tolerance,
#: the kernel entries the case must launch (the grids K6's gate admits step
#: through K6 alone, the others through K1-K5 alone), and the plan the
#: grid must take: (route, C, Woodbury))
CASES = [
    ("burgers N=2^20 theta (4 steps)", BURGERS, burgers_case(N_BIG, 0.05, 4 * 0.05), THETA,
     1e-4, 1e-10, THETA_KERNELS, ("chunked", 4096, False)),
    ("burgers N=10^6 theta", BURGERS, burgers_case(N_REF), THETA, 1e-4, 1e-10,
     THETA_KERNELS + WOOD, ("chunked", 4000, True)),
    ("readme N=200 theta", README, readme_case(), THETA, 1e-3, 1e-10, ["K6.step"],
     ("megastep", 100, False)),
    ("ks N=2^20 rodaspr fixed (2 x 0.05)", KS, ks_case(0.05, 0.1),
     dict(scheme=schemes.RODASPR, time_stepping=False, tol=None), 1e-4, 1e-9, MULTI_LAUNCH,
     ("chunked", 4096, False)),
    ("ks N=10^6 rodaspr fixed (4 x 0.05)", KS, ks_case(0.05, 0.2, N_REF),
     dict(scheme=schemes.RODASPR, time_stepping=False, tol=None), 1e-4, 1e-9,
     MULTI_LAUNCH + WOOD, ("chunked", 2500, True)),
    ("ks N=2^20 rodaspr adaptive tol 1e-3 (1 x 1.0)", KS, ks_case(1.0, 1.0),
     dict(tol=1e-3), 1e-2, 1e-9, MULTI_LAUNCH, ("chunked", 4096, False)),
    ("ks N=10^6 rodaspr adaptive tol 1e-3 (2 x 1.0)", KS, ks_case(1.0, 2.0, N_REF),
     dict(tol=1e-3), 1e-2, 1e-9, MULTI_LAUNCH + WOOD, ("chunked", 2500, True)),
    ("ks N=2^13 rodaspr adaptive tol 1e-3 (2 x 1.0), no hook", KS,
     ks_case(1.0, 2.0, N_SMALL), dict(tol=1e-3), 1e-2, 1e-9, ["K6.adaptive"],
     ("megastep", 256, False)),
    ("ks N=10^4 rodaspr adaptive tol 1e-3 (2 x 1.0), no hook", KS,
     ks_case(1.0, 2.0, N_REF_SMALL), dict(tol=1e-3), 1e-2, 1e-9, MULTI_LAUNCH + WOOD,
     ("chunked", 500, True)),
    ("burgers N=10^4 rodaspr adaptive tol 1e-3 (2 x 1.0), no hook", BURGERS,
     burgers_case(N_REF_SMALL, 1.0, 2.0), dict(tol=1e-3), 1e-2, 1e-9, ["K6.adaptive"],
     ("megastep", 250, True)),
    ("readme N=200 Simulation defaults (rodaspr)", README, readme_case(), {}, 1e-2,
     1e-9, ["K6.step"], ("megastep", 100, False)),
    ("readme N=200 example 01 (theta, step doubling)", README, readme_case(),
     dict(scheme=schemes.Theta, theta=1.0), 1e-2, 1e-9, ["K6.step"],
     ("megastep", 100, False)),
]


def case_plan(eqs, case, route):
    """The chunk plan the case's grid takes on its route."""
    fields_np, pars, _, _, _ = case
    sysm = Model(*eqs, device="cpu").system
    N = len(fields_np["x"])
    if route == "megastep":
        return megastep.plan_for(N, sysm.nvar, sysm.halo, pars["periodic"])
    return chunked.make_plan(N, sysm.nvar, sysm.halo, pars["periodic"])


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


def ptxas_report(path):
    """(function, registers, stack bytes, spill store bytes) of every kernel
    and non-inlined function in an nvcc ``-Xptxas -v`` log."""
    out, fn, stack, spill = [], None, 0, 0
    for line in path.read_text().splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for")[-1].strip()
        elif "bytes stack frame" in line:
            stack = int(re.findall(r"(\d+) bytes stack frame", line)[0])
            spill = int((re.findall(r"(\d+) bytes spill stores", line) or ["0"])[0])
        elif "Used" in line and "registers" in line:
            out.append((fn, int(line.split("Used")[1].split()[0]), stack, spill))
            stack = spill = 0
    return out


def phase0():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"phase 0: card {smi}; torch {torch.__version__} CUDA {torch.version.cuda}")
    start = time.perf_counter()
    models = [Model(*eqs).backend for eqs in (BURGERS, README, KS, TWO_VAR)]
    jobs = [lib.load for lib in (thomas.FACTOR_LIB, thomas.SOLVE_LIB, pcr.LIB,
                                 combine.LIB)]
    jobs += [b.stencil.load for b in models] + [b.megastep.load for b in models]
    with ThreadPoolExecutor(len(jobs)) as pool:
        for fut in [pool.submit(job) for job in jobs]:
            fut.result()
    log(f"phase 0: built {len(jobs)} libraries in "
        f"{time.perf_counter() - start:.1f} s (nvcc: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(_build.build_seconds.items()))
        + ")")
    mega_logs = {}
    for b, label in zip(models, ("s=1 burgers", "s=1 readme", "s=2 ks",
                                 "s=4 two-variable")):
        mega_logs[Path(b.megastep.lib._name).with_suffix(".log")] = label
    for path in sorted(_build.BUILD_DIR.glob("*.log")):
        report = ptxas_report(path)
        spills = [f"{fn} ({sp} bytes spill stores)" for fn, _, _, sp in report if sp]
        log(f"  ptxas {path.stem}: {len(report)} kernels, at most "
            f"{max((r for _, r, _, _ in report), default=0)} registers; spills: "
            f"{'; '.join(spills) or 'none'}")
        for fn, regs, stack, spill in report:
            # the s = 2 instantiations of K2/K3 and S2 = 4 of K4 (the KS path)
            if fn and (("spike" in fn or "thomas" in fn) and "Li2E" in fn
                       or "pcr" in fn and "Li4E" in fn):
                log(f"    registers {fn}: {regs}")
            if path in mega_logs:
                log(f"    K6 {mega_logs[path]} {fn}: {regs} registers, {stack} bytes "
                    f"stack, {spill} bytes spill stores")
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
    off = []
    for dt_name, dtype in DTYPES.items():
        limit = kernel_checks.TOL[dtype]["dt"]
        for case, rows in kernel_checks.adaptive_dt_readings("cuda", dtype).items():
            gaps = [g for _, g, _, _, _ in rows]
            caught = [not same or bad > limit for _, _, _, bad, same in rows]
            log(f"  K6.adaptive dt_i readings {case} {dt_name} (seed: kernel gap, "
                "attempts equal; err x 2 gap, attempts equal): "
                + "; ".join(f"{sd}: {g:.3e} {a}; {b:.3e} {c}" for sd, g, a, b, c in rows)
                + f" -> largest kernel gap {max(gaps):.3e}, limit {limit:.0e}, "
                f"wrong err caught in {sum(caught)} of {len(rows)}")
            if max(gaps) > limit or not all(a for _, _, a, _, _ in rows):
                off.append(f"{case} {dt_name}")
    if off:
        raise RuntimeError(f"K6.adaptive dt_i or attempts off the plain version: {off}")
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
        # K6 on the small KS path of phase 2 (N = 2^13, its state and plan)
        sm, _, _, sargs, _ = path_inputs(KS, ks_case(1.0, 2.0, N_SMALL), dtype)
        kernel_checks.check_megastep(sm, N_SMALL, True, 0.05, "cuda", res,
                                     adaptive=(1.0, 1e-6, 1e-3), state=sargs)
        # the reference's grids, Woodbury plans: the solver at Burgers and KS
        # N = 10^6 and KS N = 10^4, K6 on Burgers N = 10^4
        for eqs, case, g00 in ((BURGERS, burgers_case(N_REF), 1.0),
                               (KS, ks_case(0.05, 0.2, N_REF), 0.25),
                               (KS, ks_case(0.05, 0.2, N_REF_SMALL), 0.25)):
            wm, _, _, wargs, wdt = path_inputs(eqs, case, dtype)
            wbands = wm.backend.J_bands(*wargs, periodic=True)
            kernel_checks.check_solver(wbands, 1.0, -g00 * wdt, True, results=res)
        bm, _, _, bargs, _ = path_inputs(BURGERS, burgers_case(N_REF_SMALL, 1.0, 2.0), dtype)
        kernel_checks.check_megastep(bm, N_REF_SMALL, True, 0.05, "cuda", res,
                                     adaptive=(1.0, 1e-6, 1e-3), state=bargs)
        log(f"  main-path shapes {dt_name}: " + json.dumps(res))
        errs[dt_name] = res
    return errs


def phase2():
    log("phase 2: the main paths through Simulation on the card")
    runs, launches = {}, dict.fromkeys(KERNELS, 0)
    for name, eqs, case, kwargs, _, _, needs, (route, C, wood) in CASES:
        plan = case_plan(eqs, case, route)
        if plan is None or (plan.C, plan.woodbury) != (C, wood):
            raise RuntimeError(f"{name}: plan {plan} on the {route} route, expected C={C} "
                               f"woodbury={wood}")
        log(f"  {name}: plan C={plan.C} Mc={plan.Mc} cyclic={plan.cyclic} "
            f"woodbury={plan.woodbury} ({route})")
        for dt_name, dtype in DTYPES.items():
            torch.cuda.synchronize()
            _launch.reset_counters()
            start = time.perf_counter()
            steps, u, attempts = run_simulation(eqs, case, "cuda", dtype, kwargs)
            torch.cuda.synchronize()
            secs = time.perf_counter() - start
            counts = _launch.counts()
            runs[(name, dt_name)] = (steps, u, attempts, secs)
            log(f"  {name} {dt_name}: launches "
                + json.dumps({k: v for k, v in counts.items() if v}))
            missing = [k for k in needs if counts[k] <= 0]
            small = any(k.startswith("K6") for k in needs)
            others = [k for k in KERNELS if k not in needs and counts[k]
                      and (small or k.startswith("K6"))]
            if missing or others:
                raise RuntimeError(f"{name} {dt_name}: kernels not launched {missing}, "
                                   f"launched off this path {others}")
            if "K6.adaptive" in needs and counts["K6.adaptive"] != steps:
                raise RuntimeError(f"{name} {dt_name}: {counts['K6.adaptive']} K6 "
                                   f"adaptive launches for {steps} output steps")
            # the Woodbury set-up: one launch per factor on the multi-launch
            # path, none on a block-cyclic plan (inside K6 on K6's route)
            factors = counts["K2.spike_factor"] if wood and route == "chunked" else 0
            if counts["K4.pcr_solve"] != factors:
                raise RuntimeError(f"{name} {dt_name}: {counts['K4.pcr_solve']} K4.pcr_solve "
                                   f"launches for {counts['K2.spike_factor']} factors")
            for k in KERNELS:
                launches[k] += counts[k]
    log("  launches over phase 2: " + json.dumps(launches))
    for name, eqs, case, kwargs, tol32, tol64, _, _ in CASES:
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


def ks_pairs(dtype, N=N_BIG):
    """Kernel entry -> (kernel call, plain call, bytes, operations, library
    call or None), on the inputs of the first fixed RODASPR step of KS at
    N (g00 dt = 0.0125); on a Woodbury plan with K4.pcr_solve (the set-up)
    and, timed beside the corrected solve, K4.pcr_solve_shift without the
    correction."""
    model, _, _, (u, helpers, pstack, x), dt = path_inputs(KS, ks_case(0.05, 0.2, N), dtype)
    b, sysm = model.backend, model.system
    item = torch.finfo(dtype).bits // 8
    rows, g00 = rodaspr_rows()
    gdt = g00 * dt
    plan = chunked.make_plan(N, 1, 2, True)
    s, C, Mc, W, nlev = plan.s, plan.C, plan.Mc, plan.W, pcr.n_levels(plan.C)
    s2 = 2 * s
    M = N // plan.g
    nvar = sysm.nvar
    n_in = (nvar + len(sysm.help_funcs) + len(sysm.pars) + 1) * N
    rng = np.random.default_rng(2)
    bias = torch.tensor(rng.standard_normal((nvar, N)), dtype=dtype, device="cuda")
    bands = b.J_bands(u, helpers, pstack, x, periodic=True)
    sp_ = thomas.spike_factor(bands, 1.0, -gdt, plan)
    red = pcr.pcr_factor(sp_.Lred, sp_.Ured, plan.cyclic)
    wood = pcr.woodbury(red, sp_.Lred, sp_.Ured) if plan.woodbury else ()
    rhs = b.F(u, helpers, pstack, x, periodic=True, scale=gdt, bias=bias)
    y, yred = thomas.thomas_sweep(sp_, rhs, plan)
    xm1, xp1 = pcr.pcr_solve_shift(red, yred, plan.wrap, *wood)
    arrays = [u] + [torch.tensor(rng.standard_normal((nvar, N)) * 1e-3, dtype=dtype,
                                 device="cuda") for _ in range(6)]
    A, R = len(arrays), len(rows)
    coefs = torch.tensor(rows, dtype=dtype, device="cuda")
    stacked = torch.stack(arrays).view(A, -1)
    blk = s * s * C
    red_bytes = (2 * nlev + 1) * s2 * s2 * C
    # the Woodbury correction reads Z's entries at the 2s shifted rows of
    # every chunk and the capacitance inverse
    wood_bytes = (s2 * s2 * C + s2 * s2) if plan.woodbury else 0
    pairs = {
        "K1.F": (lambda: b.F(u, helpers, pstack, x, periodic=True, scale=gdt, bias=bias),
                 lambda: stencil.eval_F_plain(b, u, helpers, pstack, x, True, gdt, bias),
                 (n_in + 2 * nvar * N) * item,
                 (expr_ops(sysm.F_exprs) + 2 * nvar) * N, None),
        "K1.J": (lambda: b.J_bands(u, helpers, pstack, x, periodic=True),
                 lambda: b.J_bands_impl(u, helpers, pstack, x, periodic=True),
                 (n_in + W * nvar * nvar * N) * item,
                 expr_ops(sysm.J_band_exprs.values()) * N, None),
        # rows: a block inverse and three block products per supernode row
        "K2.spike_factor": (lambda: thomas.spike_factor(bands, 1.0, -gdt, plan),
                            lambda: thomas.spike_factor_plain(bands, 1.0, -gdt, plan),
                            (W * nvar * nvar * N + 5 * Mc * blk
                             + 2 * s2 ** 2 * C) * item, 8 * s ** 3 * M, None),
        "K3.thomas_sweep": (lambda: thomas.thomas_sweep(sp_, rhs, plan),
                            lambda: thomas.thomas_sweep_plain(sp_, rhs, plan),
                            (3 * Mc * blk + 2 * nvar * N + 2 * s * C) * item,
                            6 * s * s * M, None),
        "K4.pcr_factor": (lambda: pcr.pcr_factor(sp_.Lred, sp_.Ured, plan.cyclic),
                          lambda: pcr.pcr_factor_plain(sp_.Lred, sp_.Ured, plan.cyclic),
                          (2 * s2 ** 2 * C + red_bytes) * item, 12 * s2 ** 3 * C * nlev,
                          None),
        "K4.pcr_solve_shift": (lambda: pcr.pcr_solve_shift(red, yred, plan.wrap, *wood),
                               lambda: pcr.pcr_solve_shift_plain(red, yred, plan.wrap, *wood),
                               (red_bytes + wood_bytes + 4 * s * C) * item,
                               4 * s2 ** 2 * C * nlev + (4 * s * s2 * C if wood else 0),
                               None),
        "K3.spike_correct": (lambda: thomas.spike_correct(sp_, y, xm1, xp1, plan),
                             lambda: thomas.spike_correct_plain(sp_, y, xm1, xp1, plan),
                             (2 * nvar * N + 2 * Mc * blk + 2 * s * C) * item,
                             4 * s * nvar * N, None),
        "K5.combine": (lambda: combine.combine(rows, arrays),
                       lambda: combine.combine_plain(rows, arrays),
                       (A + R) * nvar * N * item, 2 * A * R * nvar * N,
                       lambda: torch.mm(coefs, stacked)),
    }
    if plan.woodbury:
        # the set-up: 2s columns through every level and Dinv, the
        # capacitance's Gauss-Jordan; reads the factor and two corner
        # blocks, writes Z and cap_inv
        pairs["K4.pcr_solve"] = (
            lambda: pcr.woodbury(red, sp_.Lred, sp_.Ured),
            lambda: pcr.woodbury_plain(red, sp_.Lred, sp_.Ured),
            (red_bytes + 2 * s2 * s + s2 * s2 * C + s2 * s2) * item,
            s2 * C * (4 * s2 * s2 * nlev + 2 * s2 * s2) + 2 * s2 ** 3, None)
        pairs["K4.pcr_solve_shift without the correction"] = (
            lambda: pcr.pcr_solve_shift(red, yred, True),
            lambda: pcr.pcr_solve_shift_plain(red, yred, True),
            (red_bytes + 4 * s * C) * item, 4 * s2 ** 2 * C * nlev, None)
    return plan, pairs


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
    log("phase 3: timing at N = 2^20 and 10^6 (CUDA events)")
    times = {}
    for dt_name, dtype in DTYPES.items():
        times[dt_name] = {}
        for N in (N_BIG, N_REF):
            grid = "N=2^20" if N == N_BIG else "N=10^6"
            # the Theta path (Burgers)
            model, fields, pars_t, _, dt = path_inputs(BURGERS, burgers_case(N), dtype)
            scheme = schemes.Theta(model, theta=1.0)
            step_ms = cuda_ms(lambda: scheme(0.0, fields, dt, pars_t), 20)
            log(f"  theta step burgers {grid} {dt_name}: {step_ms:.4f} ms/step, "
                f"{N / (step_ms * 1e-3):.4e} cell-updates/s")
            log_profile(f"theta step burgers {grid}", dt_name,
                        profile_step(scheme, fields, pars_t, dt))
            # the Rosenbrock path (KS): fixed step, adaptive attempts
            model, fields, pars_t, _, dt = path_inputs(KS, ks_case(0.05, 0.2, N), dtype)
            ros = schemes.RODASPR(model, time_stepping=False, tol=None)
            ros_ms = cuda_ms(lambda: ros(0.0, fields, dt, pars_t), 10)
            log(f"  rodaspr fixed step ks {grid} {dt_name}: {ros_ms:.4f} ms/step, "
                f"{N / (ros_ms * 1e-3):.4e} cell-updates/s")
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
                log(f"  rodaspr adaptive ks {grid} {dt_name} (run {rep}): "
                    f"{secs * 1e3 / sum(attempts):.4f} ms per attempt, attempts per output "
                    f"step {attempts} (host clock, synchronised)")
            log_profile(f"rodaspr fixed step ks {grid}", dt_name,
                        profile_step(ros, fields, pars_t, dt))
            plan, pairs = ks_pairs(dtype, N)
            log(f"  kernels at ks {grid}: plan C={plan.C} Mc={plan.Mc} "
                f"woodbury={plan.woodbury}")
            for name, (kern, plain, nbytes, ops, library) in pairs.items():
                # plain, kernel, kernel, plain: drift in clocks shows as a spread
                p1, k1, k2, p2 = (cuda_ms(f, 5) for f in (plain, kern, kern, plain))
                lib_ms = min(cuda_ms(library, 5) for _ in range(2)) if library else None
                b_ms, b_by = bound(nbytes, ops, dtype)
                if N == N_BIG or name == "K4.pcr_solve":
                    times[dt_name][name] = (min(k1, k2), min(p1, p2), b_ms, b_by, lib_ms)
                log(f"  {name} {grid} {dt_name}: kernel {k1:.4f}/{k2:.4f} ms, plain "
                    f"{p1:.4f}/{p2:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} bytes, "
                    f"{ops} operations)"
                    + (f", library {lib_ms:.4f} ms" if lib_ms is not None else ""))
    return times


def latency_ms(step, n=51):
    """(median, p10, p90) ms of one synchronised call of step(), host clock,
    after one warm-up call."""
    lat = []
    for _ in range(n):
        start = time.perf_counter()
        step()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - start)
    lat = sorted(lat[1:])
    k = len(lat)
    return lat[k // 2] * 1e3, lat[k // 10] * 1e3, lat[(9 * k) // 10] * 1e3


def multi_launch(scheme, N, periodic):
    """The scheme with K6's plan withheld for the grid: the K1-K5 path."""
    scheme._mega_plans[(N, periodic)] = None
    return scheme


def step_scalars(table, dt, T):
    """(factor shift, F scale) of one step of ``dt`` with ``table``, in
    the model's dtype ``T``: -g00 dt and g00 dt for a ROW table, -theta dt
    and dt for the theta table."""
    if len(table.stages) == 1:
        return -table.g00 * float(T(dt)), float(T(dt))
    gdt = float(T(table.g00) * T(dt))
    return -gdt, gdt


def k6_work(model, plan, table, dtype, attempts=1):
    """(bytes, operations) of K6 on these inputs: each input read once and
    the state written once; per attempt the operations of J, the factor,
    the PCR factor, and per stage the combinations its table row really
    makes (none where the stage's input is u, a bias only where the row
    has one), F, the sweep, the reduced solve and the correction, then the
    final rows over their columns and err's max."""
    sysm = model.system
    N, nvar, s, C, M = plan.N, sysm.nvar, plan.s, plan.C, plan.M
    s2, nlev, n = 2 * s, pcr.n_levels(plan.C), nvar * plan.N
    item = torch.finfo(dtype).bits // 8
    n_in = (nvar + len(sysm.help_funcs) + len(sysm.pars) + 1) * N
    f_ops = expr_ops(sysm.F_exprs) * N
    solve = 6 * s * s * M + 4 * s2 * s2 * C * nlev + 4 * s * n
    per_step = (expr_ops(sysm.J_band_exprs.values()) * N + 8 * s ** 3 * M
                + 12 * s2 ** 3 * C * nlev)
    for a_row, c_row in table.stages:
        combos = 0 if megastep._is_u(a_row) else 2 * len(a_row) * n
        if c_row is not None:
            combos += 2 * len(c_row) * n
        per_step += combos + f_ops + (1 + (c_row is not None)) * n + solve
    per_step += sum(2 * len(row) * n for row in table.final)
    per_step += 2 * n * (len(table.final) - 1)
    return (n_in + n) * item + 32, attempts * per_step


def fit_cost(points):
    """Least-squares fit of us = a * (rows walked per thread) + b * (PCR
    levels x passes) + c_M over (M, C, us) points, one intercept c_M per
    grid (its per-node work); returns (a, b, relative residual of each
    point)."""
    grids = sorted({M for M, _, _ in points})
    rows, ys = [], []
    for M, C, us in points:
        passes = -(-C // megastep.BLOCK_THREADS)
        rows.append([passes * (M // C), passes * pcr.n_levels(C)]
                    + [float(M == m) for m in grids])
        ys.append(us)
    A, y = np.array(rows), np.array(ys)
    fit = np.linalg.lstsq(A, y, rcond=None)[0]
    return fit[0], fit[1], list(np.abs(A @ fit - y) / y)


def phase3_small():
    """The small grids: K6 against the multi-launch path, the gate and the
    cost model, K6's entries against their plain versions."""
    log("phase 3: small grids (K6)")
    times, sweep = {}, {}
    ros_table = kernel_checks.rodaspr_table(False)
    for dt_name, dtype in DTYPES.items():
        times[dt_name] = {}
        rm = Model(*README, double=dtype == torch.float64, device="cuda")
        fields_np, pars, rdt, _, hook = readme_case()
        rf, rp = state_from_numpy(fields_np, pars, rm)
        makers = (("theta", lambda: schemes.Theta(rm, theta=1.0)),
                  ("rodaspr fixed",
                   lambda: schemes.RODASPR(rm, time_stepping=False, tol=None)))
        for label, make in makers:
            k6, multi = make(), multi_launch(make(), 200, False)
            res = {}
            for route, sch in (("K6", k6), ("multi-launch", multi), ("multi-launch", multi),
                               ("K6", k6)):
                res.setdefault(route, []).append(
                    latency_ms(lambda: sch(0.0, rf, rdt, rp, hook=hook)))
            for route, runs in res.items():
                log(f"  readme N=200 {label} step {dt_name} {route}: median "
                    + " / ".join(f"{m:.4f}" for m, _, _ in runs) + " ms (p10 "
                    + " / ".join(f"{a:.4f}" for _, a, _ in runs) + ", p90 "
                    + " / ".join(f"{b:.4f}" for _, _, b in runs)
                    + "), host clock per synchronised step, two runs")
            # nsteps = 100 fixed steps in one launch
            u, helpers, x = rm.backend.split_fields(rf)
            pstack = rm.backend.pack_pars(rp, x)
            scan = k6.device_fixed_scan(200, periodic=False)
            ms = cuda_ms(lambda: scan(0.0, u, helpers, pstack, x, rdt, 100), 5)
            log(f"  readme N=200 {label} device_fixed_scan {dt_name}: "
                f"{ms * 10:.4f} us per step at nsteps = 100 (CUDA events)")
        log_profile("readme N=200 rodaspr fixed K6 step", dt_name,
                    profile_step(schemes.RODASPR(rm, time_stepping=False, tol=None),
                                 rf, rp, rdt))
        # K6.step against its plain version at the README RODASPR step
        plan = megastep.plan_for(200, 1, 1, False)
        u, helpers, x = rm.backend.split_fields(rf)
        args = (u, helpers, rm.backend.pack_pars(rp, x), x)
        T = np.float64 if dtype == torch.float64 else np.float32
        gdt = float(T(ros_table.g00) * T(rdt))
        k_fn = lambda: megastep.step(rm.backend, plan, ros_table, False, *args, -gdt, gdt)
        p_fn = lambda: megastep.step_plain(rm.backend, plan, ros_table, False, *args,
                                           -gdt, gdt)
        p1, k1, k2, p2 = (cuda_ms(f, 5) for f in (p_fn, k_fn, k_fn, p_fn))
        nbytes, ops = k6_work(rm, plan, ros_table, dtype)
        b_ms, b_by = bound(nbytes, ops, dtype)
        times[dt_name]["K6.step"] = (min(k1, k2), min(p1, p2), b_ms, b_by, None)
        log(f"  K6.step readme N=200 rodaspr {dt_name}: kernel {k1:.4f}/{k2:.4f} ms, "
            f"plain {p1:.4f}/{p2:.4f} ms, bound {b_ms:.6f} ms ({b_by}: {nbytes} bytes, "
            f"{ops} operations), plan C={plan.C} Mc={plan.Mc}")
        # the small KS path: adaptive output steps through K6
        km, kfields, kpars, kargs, _ = path_inputs(KS, ks_case(1.0, 2.0, N_SMALL), dtype)
        for rep in range(2):
            ada = schemes.RODASPR(km, tol=1e-3)
            t, f, per = 0.0, kfields, []
            for _ in range(2):
                torch.cuda.synchronize()
                start = time.perf_counter()
                t, f = ada(t, f, 1.0, kpars)
                torch.cuda.synchronize()
                per.append(((time.perf_counter() - start) * 1e3, ada._internal_iter))
            log(f"  ks N=2^13 adaptive output step {dt_name} (run {rep}): "
                + ", ".join(f"{ms:.4f} ms for {it} attempts" for ms, it in per)
                + " (host clock, synchronised)")
        scan = schemes.RODASPR(km, time_stepping=False, tol=None).device_fixed_scan(N_SMALL)
        ms = cuda_ms(lambda: scan(0.0, *kargs, 0.05, 100), 3)
        log(f"  ks N=2^13 rodaspr device_fixed_scan {dt_name}: {ms * 10:.4f} us per step "
            "at nsteps = 100 (CUDA events)")
        # the reference's N = 10^4 grids, Woodbury plans: KS (K1-K5, above
        # K6's s = 2 gate) and Burgers (K6)
        for label, eqs, case in (("ks N=10^4", KS, ks_case(1.0, 2.0, N_REF_SMALL)),
                                 ("burgers N=10^4 (K6)", BURGERS,
                                  burgers_case(N_REF_SMALL, 1.0, 2.0))):
            wm, wfields, wpars, wargs, _ = path_inputs(eqs, case, dtype)
            for rep in range(2):
                ada = schemes.RODASPR(wm, tol=1e-3)
                t, f, per = 0.0, wfields, []
                for _ in range(2):
                    torch.cuda.synchronize()
                    start = time.perf_counter()
                    t, f = ada(t, f, 1.0, wpars)
                    torch.cuda.synchronize()
                    per.append(((time.perf_counter() - start) * 1e3, ada._internal_iter))
                log(f"  {label} adaptive output step {dt_name} (run {rep}): "
                    + ", ".join(f"{ms:.4f} ms for {it} attempts" for ms, it in per)
                    + " (host clock, synchronised)")
        bm, _, _, bargs, _ = path_inputs(BURGERS, burgers_case(N_REF_SMALL), dtype)
        scan = schemes.RODASPR(bm, time_stepping=False, tol=None).device_fixed_scan(
            N_REF_SMALL)
        ms = cuda_ms(lambda: scan(0.0, *bargs, 0.05, 100), 3)
        log(f"  burgers N=10^4 (K6, woodbury) rodaspr device_fixed_scan {dt_name}: "
            f"{ms * 10:.4f} us per step at nsteps = 100 (CUDA events)")
        kplan = megastep.plan_for(N_SMALL, 1, 2, True)
        table = kernel_checks.rodaspr_table()
        a_args = (adaptive_controller, km.backend, kplan, table, True, *kargs, 0.0, 1.0,
                  1e-6, 1e-3, 0.9, None, None)
        attempts = megastep.row_adaptive_step(*a_args)[2]
        p1, k1, k2, p2 = (cuda_ms(lambda: fn(*a_args), 2) for fn in (
            megastep.adaptive_plain, megastep.row_adaptive_step,
            megastep.row_adaptive_step, megastep.adaptive_plain))
        nbytes, ops = k6_work(km, kplan, table, dtype, attempts)
        b_ms, b_by = bound(nbytes, ops, dtype)
        times[dt_name]["K6.adaptive"] = (min(k1, k2), min(p1, p2), b_ms, b_by, None)
        log(f"  K6.adaptive ks N=2^13 first output step ({attempts} attempts) {dt_name}: "
            f"kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, bound {b_ms:.6f} ms "
            f"({b_by}: {nbytes} bytes, {ops} operations), plan C={kplan.C} Mc={kplan.Mc}")
        # the chunk-count sweeps behind megastep.plan_cost_us, one fit each
        for fit_name, grids, tb in CHUNK_SWEEPS:
            points, grids_of = [], {}
            for eqs, case in grids:
                model, _, _, cargs, cdt = path_inputs(eqs, case, dtype)
                sysm = model.system
                N, periodic = cargs[-1].shape[-1], case[1]["periodic"]
                g = max(sysm.halo, 1)
                M = N // g
                beta, scale = step_scalars(tb, cdt, T)
                cands = [C for C in chunked._divisors(M) if M // C >= 2
                         and (not periodic or (C >= 8 and C & (C - 1) == 0))]
                row = []
                for C in cands:
                    cp = chunked.plan_with(N, sysm.nvar, sysm.halo, periodic, C)
                    # 20 steps in one launch: the device time of a step, not the host's
                    us = 1e3 / 20 * cuda_ms(lambda: megastep.step(
                        model.backend, cp, tb, periodic, *cargs, beta, scale, 20), 3)
                    points.append((M, C, us))
                    row.append(f"C={C}: {us:.2f}")
                grids_of[M] = (N, sysm.nvar, sysm.halo, periodic)
                log(f"  K6 {fit_name} step by chunk count {dt_name} N={N} (us per step, "
                    "20 steps per launch, CUDA events): " + ", ".join(row))
            a, b, resid = fit_cost(points)
            log(f"  K6 cost fit {fit_name} {dt_name}: {a:.4f} us per row walked, "
                f"{b:.4f} us per PCR level pass (one intercept per grid), relative "
                f"residuals max {max(resid):.4f} rms {np.sqrt(np.mean(np.square(resid))):.4f}; "
                f"plan_cost_us has {megastep.ROW_US} and {megastep.LEVEL_US}")
            for M, (N, nvar, halo, periodic) in sorted(grids_of.items()):
                meas = {C: us for m, C, us in points if m == M}
                passes = {C: -(-C // megastep.BLOCK_THREADS) for C in meas}
                fit_c = min(meas, key=lambda C: passes[C] * (a * (M // C)
                                                             + b * pcr.n_levels(C)))
                best = min(meas, key=meas.get)
                plan_c = megastep.make_plan(N, nvar, halo, periodic).C
                log(f"    M={M}: the fit's plan C={fit_c} ({meas[fit_c]:.2f} us), "
                    f"megastep.make_plan's C={plan_c} ({meas[plan_c]:.2f} us), measured "
                    f"best C={best} ({meas[best]:.2f} us)")
        # the crossover: fixed steps, K6 against the multi-launch path, for
        # each block size and scheme
        for label, eqs, make_case, s_blk in SWEEP_MODELS:
            for sch_name, make in SWEEP_SCHEMES.items():
                model = Model(*eqs, double=dtype == torch.float64, device="cuda")
                sysm = model.system
                for e in SWEEP_EXPONENTS:
                    N = 1 << e
                    fields_np, pars, dt, _, _ = make_case(N)
                    fields, pars_t = state_from_numpy(fields_np, pars, model)
                    k6 = make(model)
                    k6._mega_plans[(N, True)] = megastep.make_plan(N, sysm.nvar, sysm.halo,
                                                                   True)
                    multi = multi_launch(make(model), N, True)
                    m1, k1, k2, m2 = (cuda_ms(lambda: sch(0.0, fields, dt, pars_t), 10)
                                      for sch in (multi, k6, k6, multi))
                    sweep.setdefault((s_blk, sch_name), {}).setdefault(N, []).append(
                        min(k1, k2) < min(m1, m2))
                    log(f"  {label} (s={s_blk}) N=2^{e} {sch_name} fixed step {dt_name}: "
                        f"K6 {k1:.4f}/{k2:.4f} ms, multi-launch {m1:.4f}/{m2:.4f} ms "
                        "(CUDA events over 10 steps)")
    for (s_blk, sch_name), by_n in sorted(sweep.items()):
        wins = [N for N in sorted(by_n) if all(all(by_n[M]) for M in by_n if M <= N)]
        log(f"  crossover s={s_blk} {sch_name}: K6 faster at every N up to "
            f"{max(wins, default=0)} in both dtypes (the gate megastep.MAX_N[{s_blk}] is "
            f"{megastep.MAX_N.get(s_blk)})")
    return times


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    smi = phase0()
    errs = phase1()
    launches = phase2()
    times = phase3()
    for dt_name, small in phase3_small().items():
        times[dt_name].update(small)
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
