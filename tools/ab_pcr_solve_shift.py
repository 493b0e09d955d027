#!/usr/bin/env python3
"""Time the PyTorch port's per-stage reduced solve (kernel K4's
``pcr_solve_shift``) and its whole fixed RODASPR step in two checkouts, in
turns on one NVIDIA GPU.

    python3 tools/ab_pcr_solve_shift.py OTHER_CHECKOUT [MORE ...]

runs the others, this checkout, this checkout, and the others in reverse
(OTHER, this, this, OTHER for one), each in a process of its own (one
``triflow_tpu_torch`` per process), and prints one JSON line per run: the card's name, and per dtype the CUDA-event ms of
``pcr_solve_shift`` and of one ``RODASPR(time_stepping=False)`` step on
the inputs of the first KS step at N = 2^20 (block-cyclic plan), and in a
checkout whose plans carry ``woodbury`` also at N = 10^6 (with and without
the Woodbury correction).  Each checkout builds its own kernels.
"""

import json
import subprocess
import sys
from pathlib import Path

KS = ("-dxxU - dxxxxU - U * dxU", "U", [])


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


def run(root):
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from triflow_tpu_torch import Model, schemes
    from triflow_tpu_torch.ops import chunked, pcr, thomas
    from triflow_tpu_torch.utils.convert import state_from_numpy

    out = {"checkout": str(root), "card": torch.cuda.get_device_name(0)}
    for dt_name, dtype in (("float64", torch.float64), ("float32", torch.float32)):
        for N in (1 << 20, 10 ** 6):
            plan = chunked.make_plan(N, 1, 2, True) if N == 1 << 20 or hasattr(
                chunked.Plan, "woodbury") else None
            if plan is None:
                continue
            i = np.arange(N)
            u0 = np.cos(2 * np.pi * 10 * i / N) + 0.1 * np.random.RandomState(0).randn(N)
            model = Model(*KS, double=dtype == torch.float64, device="cuda")
            fields, pars = state_from_numpy({"x": 0.5 * i, "U": u0}, {"periodic": True},
                                            model)
            b = model.backend
            u, helpers, x = b.split_fields(fields)
            pstack = b.pack_pars(pars, x)
            gdt = 0.25 * 0.05
            bands = b.J_bands(u, helpers, pstack, x, periodic=True)
            sp = thomas.spike_factor(bands, 1.0, -gdt, plan)
            red = pcr.pcr_factor(sp.Lred, sp.Ured, plan.cyclic)
            rhs = b.F(u, helpers, pstack, x, periodic=True, scale=gdt)
            _, yred = thomas.thomas_sweep(sp, rhs, plan)
            key = f"{dt_name} N={N} C={plan.C}"
            out[f"{key} pcr_solve_shift ms"] = cuda_ms(
                torch, lambda: pcr.pcr_solve_shift(red, yred, True), 20)
            if getattr(plan, "woodbury", False):
                wood = pcr.woodbury(red, sp.Lred, sp.Ured)
                out[f"{key} pcr_solve_shift with the Woodbury correction ms"] = cuda_ms(
                    torch, lambda: pcr.pcr_solve_shift(red, yred, True, *wood), 20)
            ros = schemes.RODASPR(model, time_stepping=False, tol=None)
            out[f"{key} rodaspr step ms"] = cuda_ms(
                torch, lambda: ros(0.0, fields, 0.05, pars), 10)
    print(json.dumps(out), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--run":
        return run(Path(sys.argv[2]).resolve())
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    roots = [Path(a).resolve() for a in sys.argv[1:]]
    roots.append(Path(__file__).resolve().parents[1])
    for root in roots + roots[::-1]:
        subprocess.run([sys.executable, __file__, "--run", str(root)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
