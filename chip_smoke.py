#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero with no result):

0. the card's name and power limit; build every kernel from ``csrc/``.
1. each kernel against its plain PyTorch version on CUDA tensors, f64 and
   f32: the checks of ``triflow_tpu_torch.ops.kernel_checks`` at small and
   odd shapes, then at the shapes of the main path below.
2. the main path: ``Simulation(..., scheme=Theta, theta=1,
   time_stepping=False)`` on ``device="cuda"`` for Burgers at N = 2^20
   (10 output steps) and for the README advection-diffusion model at
   N = 200 with its Dirichlet hook (to t = 50), in f32 and f64.  Every
   kernel entry must have launched; the results must be finite and agree
   with the port's CPU f64 run (plain versions) of the same case.
3. timing with CUDA events: ms per theta step and cell updates per second
   at N = 2^20, and each kernel entry against its plain version there.

The last three lines are the kernels' JSON record (launches on the main
path, largest error against the plain version, and f32 ms of kernel and
plain version, with f64 beside them), the card's ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from triflow_tpu_torch import Model, Simulation, schemes
from triflow_tpu_torch.ops import _build, _launch, chunked, kernel_checks, pcr, thomas
from triflow_tpu_torch.utils.convert import state_from_numpy

N_BIG = 1 << 20
BURGERS = ("-U * dxU + nu * dxxU", "U", ["nu"])
README = ("k * dxxU - c * dxU", "U", ["k", "c"])
DTYPES = {"float64": torch.float64, "float32": torch.float32}

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
}


def log(msg):
    print(msg, flush=True)


def burgers_case(N=N_BIG):
    i = np.arange(N)
    return ({"x": i * 0.5, "U": np.cos(2 * np.pi * i / N * 4)},
            dict(periodic=True, nu=0.5), 0.05, 10 * 0.05, None)


def dirichlet(t, fields, pars):
    fields["U"][0] = 1.0
    fields["U"][-1] = 0.0
    return fields, pars


def readme_case():
    x = np.linspace(0, 1, 200)
    return ({"x": x, "U": np.cos(2 * np.pi * x * 5)},
            dict(periodic=False, k=1e-3, c=3e-3), 5.0, 50.0, dirichlet)


def run_simulation(eqs, case, device, dtype):
    fields_np, pars, dt, tmax, hook = case
    model = Model(*eqs, double=dtype == torch.float64, device=device)
    fields, pars_t = state_from_numpy(fields_np, pars, model)
    sim = Simulation(model, fields, pars_t, dt=dt, tmax=tmax,
                     scheme=schemes.Theta, theta=1.0, time_stepping=False,
                     hook=hook or schemes.null_hook)
    t, fields = sim.run(progress=False)
    if sim.status != "finished" or not np.isclose(t, tmax):
        raise RuntimeError(f"simulation ended at t={t} with status {sim.status}")
    return sim.i, fields["U"]


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
    stencils = [Model(*eqs).backend.stencil
                for eqs in (BURGERS, README, kernel_checks.STENCIL_MODELS["ks"])]
    jobs = [lib.load for lib in (thomas.FACTOR_LIB, thomas.SOLVE_LIB, pcr.LIB)]
    jobs += [st.load for st in stencils]
    with ThreadPoolExecutor(len(jobs)) as pool:
        for fut in [pool.submit(job) for job in jobs]:
            fut.result()
    log(f"phase 0: built {len(jobs)} libraries in "
        f"{time.perf_counter() - start:.1f} s (nvcc: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(_build.build_seconds.items()))
        + ")")
    for path in sorted(_build.BUILD_DIR.glob("*.log")):
        regs, spills, fn = [], [], None
        for line in path.read_text().splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
            elif int((re.findall(r"(\d+) bytes spill stores", line) or ["0"])[0]):
                spills.append(f"{fn} ({line.strip()})")
            elif "Used" in line and "registers" in line:
                regs.append(int(line.split("Used")[1].split()[0]))
        log(f"  ptxas {path.stem}: {len(regs)} kernels, at most {max(regs, default=0)} "
            f"registers; spills: {'; '.join(spills) or 'none'}")
    return smi


def main_path_inputs(dtype):
    """Burgers at N = 2^20 on the card: the model, its state and the inputs
    each kernel gets on the main path's first step."""
    fields_np, pars, dt, _, _ = burgers_case()
    model = Model(*BURGERS, double=dtype == torch.float64, device="cuda")
    fields, pars_t = state_from_numpy(fields_np, pars, model)
    b = model.backend
    u, helpers, x = b.split_fields(fields)
    pstack = b.pack_pars(pars_t, x)
    return model, (u, helpers, pstack, x), dt


def phase1():
    log("phase 1: kernels against their plain versions")
    small = kernel_checks.run_all("cuda")
    for dt_name, res in small.items():
        log(f"  small shapes {dt_name}: " + json.dumps(res))
    errs = {}
    for dt_name, dtype in DTYPES.items():
        res = {}
        model, args, dt = main_path_inputs(dtype)
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
        log(f"  main-path shapes {dt_name}: " + json.dumps(res))
        errs[dt_name] = res
    return errs


def phase2():
    log("phase 2: the main path through Simulation on the card")
    cases = [("burgers N=2^20", BURGERS, burgers_case(), {"float32": 1e-4}),
             ("readme N=200", README, readme_case(), {"float32": 1e-3})]
    _launch.reset_counters()
    runs = {}
    for name, eqs, case, _ in cases:
        for dt_name, dtype in DTYPES.items():
            torch.cuda.synchronize()
            start = time.perf_counter()
            steps, u = run_simulation(eqs, case, "cuda", dtype)
            torch.cuda.synchronize()
            runs[(name, dt_name)] = (steps, u, time.perf_counter() - start)
    launches = _launch.counts()
    log("  launches: " + json.dumps(launches))
    missing = [k for k in KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the main path: {missing}")
    for name, eqs, case, tols in cases:
        steps_ref, u_ref = run_simulation(eqs, case, "cpu", torch.float64)
        scale = float(u_ref.abs().max())
        for dt_name in DTYPES:
            steps, u, secs = runs[(name, dt_name)]
            if not bool(torch.isfinite(u).all()) or u.shape != u_ref.shape:
                raise RuntimeError(f"{name} {dt_name}: non-finite or misshapen")
            err = float((u.double().cpu() - u_ref).abs().max()) / scale
            tol = tols.get(dt_name, 1e-10)
            log(f"  {name} {dt_name}: {steps} steps in {secs:.3f} s wall "
                f"(first call, build and launch included); max|u - u_cpu_f64| "
                f"/ max|u| = {err:.3e} (tolerance {tol:.0e})")
            if steps != steps_ref or not err <= tol:
                raise RuntimeError(f"{name} {dt_name}: disagrees with the CPU run")
    return launches


def phase3():
    log("phase 3: timing at N = 2^20 (CUDA events)")
    times = {}
    for dt_name, dtype in DTYPES.items():
        model, (u, helpers, pstack, x), dt = main_path_inputs(dtype)
        b = model.backend
        scheme = schemes.Theta(model, theta=1.0)
        fields_np, pars, _, _, _ = burgers_case()
        fields, pars_t = state_from_numpy(fields_np, pars, model)
        step_ms = cuda_ms(lambda: scheme(0.0, fields, dt, pars_t), 20)
        log(f"  theta step {dt_name}: {step_ms:.4f} ms/step, "
            f"{N_BIG / (step_ms * 1e-3):.4e} cell-updates/s")
        plan = chunked.make_plan(N_BIG, 1, 1, True)
        bands = b.J_bands(u, helpers, pstack, x, periodic=True)
        sp = thomas.spike_factor(bands, 1.0, -dt, plan)
        red = pcr.pcr_factor(sp.Lred, sp.Ured, True)
        rhs = b.F(u, helpers, pstack, x, periodic=True, scale=dt)
        y, yred = thomas.thomas_sweep(sp, rhs, plan)
        xm1, xp1 = pcr.pcr_solve_shift(red, yred, True)
        pairs = {
            "K1.F": (lambda: b.F(u, helpers, pstack, x, periodic=True, scale=dt),
                     lambda: dt * b.F_impl(u, helpers, pstack, x, periodic=True)),
            "K1.J": (lambda: b.J_bands(u, helpers, pstack, x, periodic=True),
                     lambda: b.J_bands_impl(u, helpers, pstack, x, periodic=True)),
            "K2.spike_factor": (
                lambda: thomas.spike_factor(bands, 1.0, -dt, plan),
                lambda: thomas.spike_factor_plain(bands, 1.0, -dt, plan)),
            "K4.pcr_factor": (lambda: pcr.pcr_factor(sp.Lred, sp.Ured, True),
                              lambda: pcr.pcr_factor_plain(sp.Lred, sp.Ured, True)),
            "K3.thomas_sweep": (lambda: thomas.thomas_sweep(sp, rhs, plan),
                                lambda: thomas.thomas_sweep_plain(sp, rhs, plan)),
            "K4.pcr_solve_shift": (
                lambda: pcr.pcr_solve_shift(red, yred, True),
                lambda: pcr.pcr_solve_shift_plain(red, yred, True)),
            "K3.spike_correct": (
                lambda: thomas.spike_correct(sp, y, xm1, xp1, plan, add_to=u),
                lambda: thomas.spike_correct_plain(sp, y, xm1, xp1, plan, add_to=u)),
        }
        times[dt_name] = {"step_ms": step_ms}
        for name, (kern, plain) in pairs.items():
            # plain, kernel, kernel, plain: drift in clocks shows as a spread
            p1, k1, k2, p2 = (cuda_ms(f, 5) for f in (plain, kern, kern, plain))
            times[dt_name][name] = (min(k1, k2), min(p1, p2))
            log(f"  {name} {dt_name}: kernel {k1:.4f}/{k2:.4f} ms, "
                f"plain {p1:.4f}/{p2:.4f} ms")
        # small N is latency: host clock around each synchronised step
        rm = Model(*README, double=dtype == torch.float64, device="cuda")
        fields_np, pars, rdt, _, hook = readme_case()
        rf, rp = state_from_numpy(fields_np, pars, rm)
        rs = schemes.Theta(rm, theta=1.0)
        lat = []
        for _ in range(51):
            start = time.perf_counter()
            rs(0.0, rf, rdt, rp, hook=hook)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - start)
        lat = sorted(lat[1:])
        log(f"  readme N=200 theta step {dt_name}: median {lat[25] * 1e3:.4f} ms "
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
        record.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max(e32, e64),
            "max_abs_err_f32": e32, "max_abs_err_f64": e64,
            "ms": times["float32"][name][0], "plain_ms": times["float32"][name][1],
            "ms_f64": times["float64"][name][0],
            "plain_ms_f64": times["float64"][name][1],
        })
    print(json.dumps({"kernels": record}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
