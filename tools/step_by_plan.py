#!/usr/bin/env python3
"""Time whole fixed steps of the PyTorch port under chosen chunk plans, on
one NVIDIA GPU.

    python3 tools/step_by_plan.py

At the reference benchmark's N = 10^6 (Burgers with Theta, theta = 1;
Kuramoto-Sivashinsky with a fixed-dt RODASPR step), in float32 and
float64, times a step under the plan ``chunked.make_plan`` picks (a
Woodbury plan there) and under the least-cost block-cyclic plan (a
power-of-two chunk count >= 8, the only periodic plan without the Woodbury
closure), with N = 2^20's plan beside them.  Prints the card's
``nvidia-smi`` name and power limit, then one JSON line per case: the
chunk plan, and for three runs the CUDA-event ms per step and the host's
ms per step to enqueue it (both over the same steps, after two warm-up
steps).
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from triflow_tpu_torch import Model, schemes  # noqa: E402
from triflow_tpu_torch.ops import chunked  # noqa: E402
from triflow_tpu_torch.utils.convert import state_from_numpy  # noqa: E402

#: (name, equations, halo, parameters, scheme, dt, initial U of the node
#: index i and N): the states of chip_smoke.py's cases
MODELS = [
    ("burgers theta", ("-U * dxU + nu * dxxU", "U", ["nu"]), 1,
     {"periodic": True, "nu": 0.5}, lambda m: schemes.Theta(m, theta=1.0), 0.05,
     lambda i, N: np.cos(2 * np.pi * i / N * 4)),
    ("ks rodaspr fixed", ("-dxxU - dxxxxU - U * dxU", "U", []), 2,
     {"periodic": True}, lambda m: schemes.RODASPR(m, time_stepping=False, tol=None), 0.05,
     lambda i, N: np.cos(2 * np.pi * 10 * i / N)
     + 0.1 * np.random.RandomState(0).randn(N)),
]


def block_cyclic_plan(N, halo):
    M = N // halo
    cands = [C for C in chunked.chunk_counts(N, halo, True)
             if C >= chunked.MIN_CYCLIC_C and C & (C - 1) == 0]
    C = min(cands, key=lambda C: (chunked.plan_cost_us(M, C), C))
    return chunked.plan_with(N, 1, halo, True, C)


def time_steps(step, n):
    """(events ms, host enqueue ms) per step over n steps."""
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    host = (time.perf_counter() - t0) / n * 1e3
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, host


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for name, eqs, halo, pars_np, make_scheme, dt, u0 in MODELS:
        for dtype in (torch.float32, torch.float64):
            model = Model(*eqs, double=dtype == torch.float64, device="cuda")
            for N in (10 ** 6, 1 << 20):
                plans = [chunked.make_plan(N, 1, halo, True)]
                if plans[0].woodbury:
                    plans.append(block_cyclic_plan(N, halo))
                i = np.arange(N)
                fields, pars = state_from_numpy({"x": 0.5 * i, "U": u0(i, N)},
                                                pars_np, model)
                for plan in plans:
                    scheme = make_scheme(model)
                    scheme._plans[(N, True)] = plan
                    for _ in range(2):
                        scheme(0.0, fields, dt, pars)
                    n = 20 if plan.Mc <= 1024 else 3
                    runs = [time_steps(lambda: scheme(0.0, fields, dt, pars), n)
                            for _ in range(3)]
                    print(json.dumps({
                        "case": name, "dtype": str(dtype).split(".")[-1], "N": N,
                        "C": plan.C, "Mc": plan.Mc, "woodbury": plan.woodbury,
                        "steps": n, "events ms per step": [r[0] for r in runs],
                        "host enqueue ms per step": [r[1] for r in runs]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
