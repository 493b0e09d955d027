#!/usr/bin/env python3
"""The launch plans of K3's staged sweep and of K5, swept on one NVIDIA GPU.

    python3 tools/sweep_plans.py

K3 (``thomas.thomas_sweep``'s C entry, called with each plan): chunks per
block CB in 4, 8, 16, 32, rows per stage R in 2, 4, 8, the forward results
kept in shared memory or streamed through y (where the shared memory fits
200 KB), at KS N = 2^20 (C = 4096 and 1024), the falling film's N = 10^6
(s = 6, C = 500) and config 5 (B = 1024 x KS N = 10^5, C = 100); CUDA-event
ms per launch, each plan's y against ``thomas.sweep_plan``'s, and the plan
``sweep_plan`` picks.  K5 (``combine.combine``'s C entry at KS 2^20's shape,
A = 7, R = 2): device µs per launch (``torch.profiler``) on 16-byte aligned
arrays and on arrays one element off (float32's float4 path and the scalar
path), for grids capped at 1..32 blocks per SM through the SM count the
entry is given.  Float64 and float32.  Prints the card's name and power
limit first.
"""

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from triflow_tpu_torch.ops import (chunked, combine, kernel_checks,  # noqa: E402
                                   thomas)
from triflow_tpu_torch.ops._launch import sm_count, stream_of, suffix  # noqa: E402

#: (name, W, nvar, N, B, C)
GRIDS = [("ks 2^20", 5, 1, 1 << 20, 1, 4096), ("ks 2^20", 5, 1, 1 << 20, 1, 1024),
         ("film 10^6", 5, 3, 10 ** 6, 1, 500), ("config 5", 5, 1, 10 ** 5, 1024, 100)]


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


def device_us(fn, name, launches=20, tries=3):
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
    return float("nan")


def sweep_k3(dtype):
    for name, W, nvar, N, B, C in GRIDS:
        plan = chunked.plan_with(N, nvar, W // 2, True, C, B)
        bands = kernel_checks.random_bands(W, nvar, N, dtype, "cuda")
        if B > 1:
            bands = bands.expand(B, *bands.shape).contiguous()
        fact = thomas.spike_factor(bands, 1.0, -0.3, plan)
        del bands
        rhs = torch.randn(((B,) if B > 1 else ()) + (nvar, N), dtype=dtype, device="cuda")
        ref = thomas.thomas_sweep(fact, rhs, plan)[0]
        item = rhs.element_size()
        pick = thomas.sweep_plan(plan.s, item, plan.Mc, plan.C, B, sm_count(rhs))
        lib = thomas.SOLVE_LIB if plan.s <= thomas.NARROW_S else thomas.SOLVE_WIDE_LIB
        fn = lib.fn(f"tf_thomas_sweep_{suffix(dtype)}", 6, 9)
        y = torch.empty_like(rhs)
        yred = torch.empty(((B,) if B > 1 else ()) + (2 * plan.s, plan.C), dtype=dtype,
                           device="cuda")
        print(f"K3 {name} C={C} Mc={plan.Mc} B={B} {dtype}: sweep_plan picks {pick}",
              flush=True)
        for CB in (4, 8, 16, 32):
            for R in (2, 4, 8):
                for keep in (False, True):
                    smem = thomas.sweep_smem(plan.s, item, plan.Mc, CB, R, keep)
                    if smem > 200 * 1024:
                        continue

                    def go(CB=CB, R=R, keep=keep):
                        rc = fn(fact.fac.data_ptr(), fact.Dhinv.data_ptr(),
                                fact.DU.data_ptr(), rhs.data_ptr(), y.data_ptr(),
                                yred.data_ptr(), plan.Np, plan.nvar, plan.g, plan.Mc,
                                plan.C, B, CB, R, int(keep), stream_of(rhs))
                        lib.check(rc, "K3 sweep")

                    ms = cuda_ms(go, 10)
                    same = torch.equal(y, ref)
                    print(f"  CB={CB} R={R} keep={keep} smem={smem}: {ms:.4f} ms"
                          + ("" if same else " (y differs from sweep_plan's)"), flush=True)
        del fact, rhs, ref, y


def sweep_k5(dtype):
    n = 1 << 20
    rows = [[1.0, 0.3, -0.2, 0.5, 0.1, 0.7, -0.4], [1.0, 0.2, 0.0, 0.1, 0.4, -0.3, 0.9]]
    block, _ = combine._coef_block(rows, 7, dtype)
    fn = combine.LIB.fn(f"tf_combine_{suffix(dtype)}", 11, 4)
    for label, offset in (("aligned", 0), ("one element off", 1)):
        arrays = [torch.randn(n + offset, dtype=dtype, device="cuda")[offset:]
                  for _ in range(7)]
        outs = [torch.empty_like(arrays[0]) for _ in range(2)]
        sms = sm_count(arrays[0])
        # the entry caps its grid at 4 blocks per SM on the float4 path
        # (aligned float32), 16 on the scalar path: the SM count it is given
        # sets the cap
        per_given = 4 if dtype == torch.float32 and not offset else 16
        for per_sm in (1, 2, 4, 8, 16, 32):
            given = max(1, sms * per_sm // per_given)

            def go(given=given):
                rc = fn(block, *(a.data_ptr() for a in arrays), None, outs[0].data_ptr(),
                        outs[1].data_ptr(), 7, 2, n, given, stream_of(arrays[0]))
                combine.LIB.check(rc, "K5 combine")

            print(f"K5 {dtype} {label}, grid capped at {per_sm} blocks per SM: "
                  f"{device_us(go, 'combine'):.3f} device us per launch", flush=True)


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card {smi}", flush=True)
    for dtype in (torch.float64, torch.float32):
        sweep_k5(dtype)
        sweep_k3(dtype)


if __name__ == "__main__":
    main()
