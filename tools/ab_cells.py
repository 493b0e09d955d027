#!/usr/bin/env python3
"""Time the smoke's cells in two checkouts, in turns on one NVIDIA GPU: a
whole step of each cell before and after a change.

    python3 tools/ab_cells.py OTHER_CHECKOUT [PAIRS] [WORD ...]

runs OTHER, this checkout, this checkout, OTHER (PAIRS times, default 1),
each in a process of its own that imports that checkout's
``triflow_tpu_torch`` and ``chip_smoke.py`` (the cells' states and
parameters come from the checkout's own smoke; the first process of each
checkout builds its kernels, all at once).  Each process prints one JSON
line: the card's name and, per dtype, under each checkout's own chunk
plans (``make_plan``, ``megatheta.plan_for``): the CUDA-event ms of one
fixed RODASPR step of KS at N = 10^6 (dt 0.05, Woodbury), at N = 2^20
(block-cyclic) and at N = 999983 (a padded ring), of one Theta step of
Burgers at N = 10^6, of one fixed RODASPR step of config 5 (B = 1024 KS
members at N = 10^5, ``Ensemble.steps(3, 0.05)``), of one fixed RODASPR
step of the s = 6 falling film at N = 10^6 and 2^20 (dt 0.5), of one step of
the opt-in two-pass theta step (K9) on Burgers at N = 10^6, and of one fixed
RODASPR step with ``refine=1`` (K7's cells: KS at N = 10^6, dt 0.05, and
the advection-diffusion trajectory's N = 1024, dt 0.01); and the
host-clock ms per attempt of one adaptive RODASPR output step (tol 1e-3,
t = 0 to 1) of KS at N = 10^6 and 2^20, with its attempts; and each
cell's chunk count.  Then one JSON line per measurement: its mean over
OTHER's runs and over this checkout's, this against OTHER in per cent,
and the spread (max - min over mean, per cent) within each side.  WORD
arguments keep only the cells whose label holds one of them (e.g.
``"ks N=10^6" "config 5"``).
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def run(root, words=()):
    sys.path.insert(0, str(root))
    from concurrent.futures import ThreadPoolExecutor

    import torch

    import chip_smoke as cs
    from triflow_tpu_torch import Model, schemes
    from triflow_tpu_torch.ops import combine, matvec, pcr, thomas

    def want(label):
        return not words or any(w in label for w in words)

    # build every library the run needs at once (one nvcc each; a checkout
    # before libraries built by dtype: their load)
    jobs = [job for lib in (thomas.FACTOR_LIB, thomas.SOLVE_LIB, pcr.LIB, combine.LIB,
                            thomas.FACTOR_WIDE_LIB, thomas.SOLVE_WIDE_LIB, pcr.WIDE_LIB,
                            matvec.LIB)
            for job in getattr(lib, "builds", lambda lib=lib: [lib.load])()]
    for eqs in (cs.KS, cs.BURGERS, cs.FILM, cs.README):
        for double in (True, False):
            b = Model(*eqs, double=double).backend
            jobs.append(b.stencil.load)
            if eqs is cs.BURGERS:
                jobs.append(b.megatheta.load)
    with ThreadPoolExecutor(len(jobs)) as pool:
        for fut in [pool.submit(job) for job in jobs]:
            fut.result()

    out = {"checkout": str(root), "card": torch.cuda.get_device_name(0)}
    for dt_name, dtype in cs.DTYPES.items():
        for label, eqs, case in (
                ("ks N=10^6 rodaspr fixed", cs.KS, cs.ks_case(0.05, 0.2, cs.N_REF)),
                ("ks N=2^20 rodaspr fixed", cs.KS, cs.ks_case(0.05, 0.2, cs.N_BIG)),
                ("ks N=999983 rodaspr fixed", cs.KS, cs.ks_case(0.05, 0.2, cs.N_ODD)),
                ("burgers N=10^6 theta", cs.BURGERS, cs.burgers_case(cs.N_REF)),
                ("film N=10^6 rodaspr fixed", cs.FILM, cs.film_case(cs.N_REF)),
                ("film N=2^20 rodaspr fixed", cs.FILM, cs.film_case(cs.N_BIG)),
                ("ks N=10^6 rodaspr fixed refine=1", cs.KS, cs.ks_case(0.05, 0.2, cs.N_REF)),
                ("advdiff N=1024 rodaspr fixed refine=1", cs.README, cs.advdiff_case())):
            if not want(label):
                continue
            model, fields, pars, _, dt = cs.path_inputs(eqs, case, dtype)
            step = (schemes.Theta(model, theta=1.0) if "theta" in label
                    else schemes.RODASPR(model, time_stepping=False, tol=None,
                                         refine=1 if "refine" in label else 0))
            N = len(case[0]["x"])
            out[f"{dt_name} {label} ms"] = cs.cuda_ms(lambda: step(0.0, fields, dt, pars),
                                                      50 if N < 10 ** 4 else 10)
            out[f"{dt_name} {label} C"] = step._plan(N, True).C
            if label.startswith("ks") and N != cs.N_ODD and "refine" not in label:
                ada = schemes.RODASPR(model, tol=1e-3)
                ada(0.0, fields, 1.0, pars)  # warm-up
                torch.cuda.synchronize()
                start = time.perf_counter()
                ada(0.0, fields, 1.0, pars)
                torch.cuda.synchronize()
                attempts = ada._internal_iter
                name = label.replace("fixed", "adaptive tol 1e-3")
                out[f"{dt_name} {name} ms per attempt"] = (
                    (time.perf_counter() - start) * 1e3 / attempts)
                out[f"{dt_name} {name} attempts"] = attempts
            del model, fields, pars, step
            torch.cuda.empty_cache()
        if want("config 5 rodaspr fixed"):
            ens = cs.make_ensemble(1024, 10 ** 5, 0, 10, dtype, "cuda",
                                   dict(scheme=schemes.RODASPR, time_stepping=False, tol=None))
            out[f"{dt_name} config 5 rodaspr fixed ms"] = cs.cuda_ms(
                lambda: ens.steps(3, 0.05), 2) / 3
            out[f"{dt_name} config 5 rodaspr fixed C"] = ens._scheme._plan(10 ** 5, True,
                                                                           1024).C
            del ens
            torch.cuda.empty_cache()
        if want("K9 burgers N=10^6 step"):
            _, plan, step, args = cs.megatheta_entry(cs.BURGERS, cs.burgers_case(cs.N_REF),
                                                     "cuda", dtype, True)
            u = args[0]
            out[f"{dt_name} K9 burgers N=10^6 step ms"] = cs.cuda_ms(lambda: step(u), 10)
            out[f"{dt_name} K9 burgers N=10^6 step C"] = plan.C
    print(json.dumps(out), flush=True)


def summary(runs):
    """One JSON line per measurement: each side's mean, this against the
    other in per cent, each side's spread in per cent."""
    for key in runs["this"][0]:
        if not key.endswith(("ms", "attempt", "attempts", " C")) or any(
                key not in r for rs in runs.values() for r in rs):
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
    if len(sys.argv) >= 3 and sys.argv[1] == "--run":
        return run(Path(sys.argv[2]).resolve(), sys.argv[3:])
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    this = Path(__file__).resolve().parents[1]
    pairs = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    words = sys.argv[3:]
    runs = {"other": [], "this": []}
    for _ in range(pairs):
        for side, root in (("other", other), ("this", this), ("this", this),
                           ("other", other)):
            proc = subprocess.run([sys.executable, __file__, "--run", str(root), *words],
                                  check=True, stdout=subprocess.PIPE, text=True)
            print(proc.stdout, end="", flush=True)
            runs[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    summary(runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
