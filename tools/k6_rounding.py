#!/usr/bin/env python3
"""Where K6's adaptive entries round apart, on one NVIDIA GPU.

    python3 tools/k6_rounding.py OTHER_DIR [time]

OTHER_DIR holds another checkout's ``triflow_tpu_torch`` package (the
parent's, or a variant of this one), loaded beside this checkout's as in
``tools/ab_sweep.py``.  Without ``time``, in both dtypes: on the adaptive
grids of ``kernel_checks.CLUSTER_CASES``, the one-grid adaptive output step
at every cluster size through the adaptive entry and through the scan
kernel (one member), equal across sizes or not; the adaptive entry's first
attempt at the fixed dt, accepted (tol 1e30), against the step entry's
step, bit for bit, at every size, and the same in OTHER_DIR; then
``ab_sweep.K6_CASES``' KS and README step and scan cases and the KS 2^13
adaptive output step against OTHER_DIR's, bit for bit or their gap.  With
``time``: device µs (``torch.profiler``) of one grid's adaptive output step
at README N = 200 (C = 25), KS 2^13 (C = 256) and KS N = 256 (C = 64)
through OTHER_DIR's adaptive entry, this checkout's adaptive entry and this
checkout's scan kernel, twice each in turns.  Prints the card's name and
power limit first.
"""

import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import ab_sweep as ab  # noqa: E402  (puts this checkout first on sys.path)

from triflow_tpu_torch import Model  # noqa: E402
from triflow_tpu_torch.core.rosenbrock import adaptive_controller  # noqa: E402
from triflow_tpu_torch.ops import chunked, kernel_checks as kc, megastep  # noqa: E402


def scan_route(b, plan, tab, periodic, u, h, p, x, t, dt, idt, tol, cp):
    """One grid's adaptive output step through the scan kernel (one
    member, a shared dt): (u, dt_i, attempts, status)."""
    out, info = megastep._launch(
        "adaptive_scan", megastep.SCAN_LAUNCHES, b, plan, tab, periodic, u, h, p, x,
        megastep._reals(g00=tab.g00, t=float(t), dt=float(dt), internal_dt=float(idt),
                        tol=float(tol), safety=0.9, dt_min=None),
        nsteps=1, max_iter=None, dt_min=None, kind=megastep.SHARED_KIND, cluster=cp)
    info = info.cpu().numpy()
    T = megastep._np_type(u)
    return out, T(info[0, 1]), int(info[0, 2]), int(info[0, 3])


def same(a, b):
    return torch.equal(a[0], b[0]) and (float(a[1]), a[2], a[3]) == (float(b[1]), b[2], b[3])


def differs(a, b):
    return "equal" if torch.equal(a, b) else "differs %.2e" % float((a - b).abs().max())


def sizes(plan, dtype):
    for K in megastep.CLUSTER_SIZES:
        try:
            cp = megastep.cluster_plan(plan, 6, dtype, 1, False, K=K)
        except ValueError:
            continue
        yield f"K={K}{' one' if cp.one else ''}", cp


def check(old_port, dtype):
    oms = importlib.import_module("parent_port.ops.megastep")
    okc = importlib.import_module("parent_port.ops.kernel_checks")
    orb = importlib.import_module("parent_port.core.rosenbrock")
    ochunked = importlib.import_module("parent_port.ops.chunked")
    dtn = str(dtype).replace("torch.", "")
    T = np.float64 if dtype == torch.float64 else np.float32
    ros = kc.rodaspr_table()
    for name, N, periodic, C, fdt, adaptive in kc.CLUSTER_CASES:
        if adaptive is None:
            continue
        double = dtype == torch.float64
        m = Model(*kc.MEGA_MODELS[name], double=double, device="cuda")
        om = old_port.Model(*kc.MEGA_MODELS[name], double=double, device="cuda")
        b = m.backend
        sysm = b.system
        plan = chunked.plan_with(N, sysm.nvar, sysm.halo, periodic, C)
        oplan = ochunked.plan_with(N, sysm.nvar, sysm.halo, periodic, C)
        args = kc.mega_state(m, N, periodic, "cuda")
        out_dt, idt, tol = adaptive
        a = (adaptive_controller, b, plan, ros, periodic, *args, 0.0, out_dt, idt, tol, 0.9,
             None, None)
        for route in ("adaptive entry", "scan_kernel"):
            res = {}
            for key, cp in sizes(plan, dtype):
                res[key] = (megastep.row_adaptive_step(*a, cluster=cp) if route != "scan_kernel"
                            else scan_route(b, plan, ros, periodic, *args, 0.0, out_dt, idt, tol,
                                            cp))
            ref = next(iter(res.values()))
            print(f"  across K {name} N={N} C={C} {route} {dtn}: " + "; ".join(
                f"{k}: " + ("equal" if same(v, ref) else f"dt {float(v[1])!r} attempts {v[2]} "
                            f"(first {float(ref[1])!r})") for k, v in res.items()), flush=True)
        dt = T(fdt)
        gdt = float(T(ros.g00) * dt)
        for key, cp in sizes(plan, dtype):
            st = megastep.step(b, plan, ros, periodic, *args, -gdt, gdt, cluster=cp)[0]
            ad = megastep.row_adaptive_step(adaptive_controller, b, plan, ros, periodic, *args,
                                            0.0, float(dt), float(dt), 1e30, 0.9, None, None,
                                            cluster=cp)
            sc = scan_route(b, plan, ros, periodic, *args, 0.0, float(dt), float(dt), 1e30, cp)
            print(f"  first attempt against the step {name} N={N} C={C} {key} {dtn}: adaptive "
                  f"entry {differs(ad[0], st)} (attempts {ad[2]}), scan_kernel "
                  f"{differs(sc[0], st)} (attempts {sc[2]})", flush=True)
        otab = okc.rodaspr_table()
        ost = oms.step(om.backend, oplan, otab, periodic, *args, -gdt, gdt)[0]
        oad = oms.row_adaptive_step(orb.adaptive_controller, om.backend, oplan, otab, periodic,
                                    *args, 0.0, float(dt), float(dt), 1e30, 0.9, None, None)
        st = megastep.step(b, plan, ros, periodic, *args, -gdt, gdt)[0]
        print(f"  other first attempt against its step {name} N={N} C={C} {dtn}: "
              f"{differs(oad[0], ost)} (attempts {oad[2]}); this step against the other's: "
              f"{'equal' if torch.equal(st, ost) else 'differs'}", flush=True)
    for case in ab.K6_CASES:
        if case[1] in ("ks", "readme") and case[-1] in ("step", "step_err", "steps100", "shared",
                                                          "member"):
            old, new = ab.k6_sides(old_port, case, dtype)[:2]
            print(f"  {case[0]} {dtn} against the other: {ab.k6_gap(new(), old())}", flush=True)
    case = next(c for c in ab.K6_CASES if c[-1] == "adaptive")
    old, new, _, same_plan, _ = ab.k6_sides(old_port, case, dtype)
    o = old()
    print(f"  {case[0]} {dtn} adaptive entry against the other: {ab.k6_gap(new(), o)}",
          flush=True)
    m = Model(*ab.K6_MODELS["ks"], double=dtype == torch.float64, device="cuda")
    args = ab.k6_state(m, 1 << 13, True, 1)
    cp = megastep.cluster_plan(same_plan, 6, dtype, 1, False)
    sc = scan_route(m.backend, same_plan, kc.rodaspr_table(), True, *args, 0.0, 1.0, 1e-6, 1e-3,
                    cp)
    print(f"  {case[0]} {dtn} scan_kernel against the other: {ab.k6_gap(sc, o)}", flush=True)


def timing(old_port, dtype):
    oms = importlib.import_module("parent_port.ops.megastep")
    okc = importlib.import_module("parent_port.ops.kernel_checks")
    orb = importlib.import_module("parent_port.core.rosenbrock")
    ochunked = importlib.import_module("parent_port.ops.chunked")
    dtn = str(dtype).replace("torch.", "")
    for name, N, C in (("readme", 200, 25), ("ks", 1 << 13, 256), ("ks", 256, 64)):
        double = dtype == torch.float64
        m = Model(*kc.MEGA_MODELS[name], double=double, device="cuda")
        om = old_port.Model(*kc.MEGA_MODELS[name], double=double, device="cuda")
        b = m.backend
        sysm = b.system
        periodic = name == "ks"
        plan = chunked.plan_with(N, sysm.nvar, sysm.halo, periodic, C)
        oplan = ochunked.plan_with(N, sysm.nvar, sysm.halo, periodic, C)
        args = kc.mega_state(m, N, periodic, "cuda")
        ros = kc.rodaspr_table()
        odt, idt, tol = (5.0, 1e-6, 1e-1) if name == "readme" else (1.0, 1e-6, 1e-3)
        cp = megastep.cluster_plan(plan, 6, dtype, 1, False)

        def fa():
            return megastep.row_adaptive_step(adaptive_controller, b, plan, ros, periodic, *args,
                                              0.0, odt, idt, tol, 0.9, None, None)

        def fs():
            return scan_route(b, plan, ros, periodic, *args, 0.0, odt, idt, tol, cp)

        def fo():
            return oms.row_adaptive_step(orb.adaptive_controller, om.backend, oplan,
                                         okc.rodaspr_table(), periodic, *args, 0.0, odt, idt,
                                         tol, 0.9, None, None)

        print(f"{name} N={N} C={C} K={cp.K} one={cp.one} {dtn}: attempts this {fa()[2]} scan "
              f"{fs()[2]} other {fo()[2]}; scan against the adaptive entry "
              f"{ab.k6_gap(fs(), fa())}", flush=True)
        for _ in range(2):
            for side, fn, kern in (("other adaptive entry", fo, "adaptive_kernel"),
                                   ("this adaptive entry", fa, ("adaptive_kernel", "scan_kernel")),
                                   ("this scan_kernel", fs, "scan_kernel")):
                us = None
                for k in (kern if isinstance(kern, tuple) else (kern,)):
                    us = ab.device_us(fn, k)
                    if us is not None:
                        break
                print(f"  {name} N={N} {dtn} {side}: {us} device us", flush=True)


def main():
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card {smi}", flush=True)
    old_port = ab.load_parent(Path(sys.argv[1]).resolve())[3]
    run = timing if sys.argv[2:] == ["time"] else check
    for dtype in (torch.float32, torch.float64):
        run(old_port, dtype)
    print("done", flush=True)


if __name__ == "__main__":
    main()
