#!/usr/bin/env python3
"""The launch plans of K2's staged walk, K4's cluster solve with shifts, K3's
staged sweep and K5, and of K2's and K4's wide factors, swept on one
NVIDIA GPU.

    python3 tools/sweep_plans.py [k2] [k4] [k3] [k5] [k2w] [k4w] [k3c] [k4n] [steps]

(the first four without arguments).  K2 (``thomas.spike_factor``'s C entry,
called with each plan): chunks per block CB in 1..32, rows per stage R in
2, 4, 8, the forward results kept in shared memory or streamed through the
factor's rows (where the shared memory fits 200 KB), at KS N = 2^20 (C =
1024 and 4096), KS N = 10^6 (C = 1000) and config 5 (B = 1024 x KS N =
10^5, C = 100); each plan's factor against ``thomas.factor_plan``'s.  K4
(``pcr.pcr_solve_shift``'s C entry): CTAs per cluster K in 1, 2, 4, 8, 16
and tiles of Ct chunks, at the same grids (KS 10^6 with its Woodbury
correction), each with its planned ring of D operator slabs and with 3 and 2;
each plan's shifts against ``pcr.solve_plan``'s.  K3
(``thomas.thomas_sweep``'s C entry): chunks per block CB in 4, 8, 16, 32,
rows per stage R in 2, 4, 8, the forward results kept in shared memory or
streamed through y (where the shared memory fits 200 KB), at KS N = 2^20
(C = 4096 and 1024), the falling film's N = 10^6 (s = 6, C = 500) and
config 5 (B = 1024 x KS N = 10^5, C = 100); each plan's y against
``thomas.sweep_plan``'s.  CUDA-event ms per launch, and the plan the
planner picks.  K5 (``combine.combine``'s C entry at KS 2^20's shape, A =
7, R = 2): device µs per launch (``torch.profiler``) on 16-byte aligned
arrays and on arrays one element off (float32's float4 path and the scalar
path), for grids capped at 1..32 blocks per SM through the SM count the
entry is given.  K2's wide walk (``k2w``, the film's s = 6 at N = 10^6, C
= 500, and at 2^20 and 2^15 up to C = 8192): rows per stage R in 1, 2, 4,
8, the forward results kept or streamed, against ``thomas.factor_plan``'s;
K4's wide factor (``k4w``, the same chunk counts): grids of one, two and
four CTAs an SM, against ``pcr.factor_plan_wide``'s; device µs beside each.
K3's tiled correction (``k3c``): chunks per block and rows per block at
the cells' plans (KS 2^20, 10^6, the ring 999983, Burgers, config 5, the
film); K4's narrow factor (``k4n``, the same narrow plans and config 5's C
= 100 at B = 4, 16, 64, 132 and 256 members): one block per member, and
the grid on grids of 1..8 CTAs an SM; device µs.  ``steps``: the
whole-step chunk-count sweeps behind ``chunked``'s cost constants, run
through ``chip_smoke.py`` (``narrow_sweeps``: KS at N = 10^6 with the
non-negative fit of ROW_US / LEVEL_US / SLAB_US, KS 2^20, Burgers 10^6;
``film_sweep`` and ``film_fit``: the film at N = 10^6 and 2^20 with the
fit of the wide constants).
Float64 and float32.  Prints the card's name and power limit first.
"""

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from triflow_tpu_torch.ops import (chunked, combine, kernel_checks,  # noqa: E402
                                   pcr, thomas)
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


#: (name, W, nvar, N, B, C) of the K2 and K4 sweeps
GRIDS_24 = [("ks 2^20", 5, 1, 1 << 20, 1, 1024), ("ks 2^20", 5, 1, 1 << 20, 1, 4096),
            ("ks 10^6", 5, 1, 10 ** 6, 1, 1000), ("config 5", 5, 1, 10 ** 5, 1024, 100)]


def _bands(W, nvar, N, B, dtype):
    bands = kernel_checks.random_bands(W, nvar, N, dtype, "cuda")
    return bands.expand(B, *bands.shape).contiguous() if B > 1 else bands


def sweep_k2(dtype):
    for name, W, nvar, N, B, C in GRIDS_24:
        plan = chunked.plan_with(N, nvar, W // 2, True, C, B)
        bands = _bands(W, nvar, N, B, dtype)
        ref = thomas.spike_factor(bands, 1.0, -0.3, plan)
        out = [torch.empty_like(t) for t in ref]
        item = bands.element_size()
        pick = thomas.factor_plan(nvar, W // 2, item, plan.Mc, C, B, sm_count(bands))
        fn = thomas.FACTOR_LIB.fn(f"tf_spike_factor_{suffix(dtype)}", 9, 11, 2)
        print(f"K2 {name} C={C} Mc={plan.Mc} B={B} {dtype}: factor_plan picks {pick}",
              flush=True)
        for CB in (1, 2, 4, 8, 16, 32):
            for R in (2, 4, 8):
                for keep in (False, True):
                    smem = thomas.factor_smem(nvar, W // 2, item, plan.Mc, CB, R, keep)
                    if smem > 200 * 1024:
                        continue

                    def go(CB=CB, R=R, keep=keep):
                        rc = fn(bands.data_ptr(), *(t.data_ptr() for t in out), 0, N, nvar,
                                plan.g, plan.halo, plan.Mc, C, int(plan.wrap), B, CB, R,
                                int(keep), 1.0, -0.3, stream_of(bands))
                        thomas.FACTOR_LIB.check(rc, "K2 factor")

                    ms = cuda_ms(go, 5)
                    same = all(torch.equal(a, b) for a, b in zip(out, ref))
                    print(f"  CB={CB} R={R} keep={keep} smem={smem}: {ms:.4f} ms"
                          + ("" if same else " (differs from factor_plan's)"), flush=True)
        del bands, ref, out


def sweep_k4(dtype):
    for name, W, nvar, N, B, C in GRIDS_24:
        plan = chunked.plan_with(N, nvar, W // 2, True, C, B)
        fact = thomas.spike_factor(_bands(W, nvar, N, B, dtype), 1.0, -0.3, plan)
        red = pcr.pcr_factor(fact.Lred, fact.Ured, plan.cyclic)
        wood = pcr.woodbury(red, fact.Lred, fact.Ured) if plan.woodbury else ()
        del fact
        s2, item = 2 * plan.s, red.Dinv.element_size()
        yred = torch.randn(((B,) if B > 1 else ()) + (s2, C), dtype=dtype, device="cuda")
        ref = pcr.pcr_solve_shift(red, yred, plan.wrap, *wood)
        out = [torch.empty_like(t) for t in ref]
        pick = pcr.solve_plan(C, s2, B, item, sm_count(yred))
        fn = pcr.LIB.fn(f"tf_pcr_solve_shift_{suffix(dtype)}", 8, 9)
        print(f"K4 {name} C={C} B={B} woodbury={plan.woodbury} {dtype}: solve_plan picks "
              f"{pick}", flush=True)
        for K in (1, 2, 4, 8, 16):
            try:
                base = pcr.solve_plan(C, s2, B, item, sm_count(yred), K)
            except ValueError:
                continue
            for Ct, D in sorted({(base.Ct, base.D), (base.Ct, 3), (base.Ct, 2),
                                 (max(1, base.Ct // 2), base.D)}):
                sp = base._replace(Ct=Ct, D=D, threads=-(-s2 * Ct // 32) * 32,
                                   smem=pcr.solve_smem(s2, item, base.Cc, Ct, D))

                def go(sp=sp):
                    rc = fn(red.alphas.data_ptr(), red.betas.data_ptr(), red.Dinv.data_ptr(),
                            yred.data_ptr(), wood[0].data_ptr() if wood else 0,
                            wood[1].data_ptr() if wood else 0, out[0].data_ptr(),
                            out[1].data_ptr(), C, s2, int(plan.wrap), B, sp.K, sp.Cc, sp.Ct,
                            sp.D, sp.threads, stream_of(yred))
                    pcr.LIB.check(rc, "K4 solve_shift")

                ms = cuda_ms(go, 20)
                same = all(torch.equal(a, b) for a, b in zip(out, ref))
                print(f"  K={sp.K} Cc={sp.Cc} Ct={sp.Ct} D={sp.D} threads={sp.threads} "
                      f"smem={sp.smem}: {ms:.4f} ms"
                      + ("" if same else " (differs from solve_plan's)"), flush=True)
        del red, wood, yred, ref, out


#: (name, N, C) of the film's wide sweeps (s = 6, S2 = 12)
GRIDS_WIDE = [("film 10^6", 10 ** 6, 500), ("film 2^20", 1 << 20, 512),
              ("film 2^20", 1 << 20, 2048), ("film 2^20", 1 << 20, 4096),
              ("film 2^15", 1 << 15, 8192)]


def sweep_k2w(dtype):
    """K2's wide walk at the film's grids: rows per stage R, the forward
    results kept or streamed, against ``thomas.factor_plan``'s."""
    for name, N, C in GRIDS_WIDE:
        plan = chunked.plan_with(N, 3, 2, True, C)
        bands = _bands(5, 3, N, 1, dtype)
        ref = thomas.spike_factor(bands, 1.0, -0.3, plan)
        out = [torch.empty_like(t) for t in ref]
        item = bands.element_size()
        pick = thomas.factor_plan(3, 2, item, plan.Mc, C, 1, sm_count(bands))
        fn = thomas.FACTOR_WIDE_LIB.fn(f"tf_spike_factor_{suffix(dtype)}", 9, 11, 2)
        print(f"K2 wide {name} C={C} Mc={plan.Mc} {dtype}: factor_plan picks {pick}",
              flush=True)
        for R in (1, 2, 4, 8):
            for keep in (False, True):
                smem = thomas.factor_smem(3, 2, item, plan.Mc, pick.CB, R, keep)
                if smem > 220 * 1024:
                    continue

                def go(R=R, keep=keep):
                    rc = fn(bands.data_ptr(), *(t.data_ptr() for t in out), 0, N, 3, 2, 2,
                            plan.Mc, C, int(plan.wrap), 1, pick.CB, R, int(keep), 1.0, -0.3,
                            stream_of(bands))
                    thomas.FACTOR_WIDE_LIB.check(rc, "K2 wide factor")

                ms = cuda_ms(go, 3)
                same = all(torch.equal(a, b) for a, b in zip(out, ref))
                print(f"  R={R} keep={keep} smem={smem}: {ms:.4f} ms "
                      f"({device_us(go, 'spike_factor', 5):.1f} device us)"
                      + ("" if same else " (differs from factor_plan's)"), flush=True)
        del bands, ref, out


def sweep_k4w(dtype):
    """K4's wide factor at the film's chunk counts: cooperative grids of one,
    two and four CTAs an SM (as many as the pairs need and the card holds),
    against ``pcr.factor_plan_wide``'s factor."""
    for name, N, C in GRIDS_WIDE:
        Mc = 4
        plan = chunked.plan_with(2 * C * Mc, 3, 2, True, C)
        fact = thomas.spike_factor(_bands(5, 3, 2 * C * Mc, 1, dtype), 1.0, -0.3, plan)
        ref = pcr.pcr_factor(fact.Lred, fact.Ured, plan.cyclic)
        out = [torch.empty_like(t) for t in ref]
        sfx = suffix(dtype)
        sms = sm_count(ref.Dinv)
        held = pcr._grid_blocks(pcr.WIDE_LIB, sfx, 12)
        pick = pcr.factor_plan_wide(C, 12, 1, sms, held)
        scratch = torch.empty((7, C, 12, 12), dtype=dtype, device="cuda")
        fn = pcr.WIDE_LIB.fn(f"tf_pcr_factor_wide_{sfx}", 6, 5)
        print(f"K4 wide factor {name} C={C} cyclic={plan.cyclic} {dtype}: the card holds "
              f"{held} CTAs an SM; factor_plan_wide picks {pick}", flush=True)
        gpc = pcr.factor_groups(12, pcr.FACTOR_WIDE_THREADS)
        for ctas in sorted({min(-(-C // gpc), sms * per) for per in (1, 2, 4) if per <= held}):
            def go(ctas=ctas):
                rc = fn(fact.Lred.data_ptr(), fact.Ured.data_ptr(), out[0].data_ptr(),
                        out[1].data_ptr(), out[2].data_ptr(), scratch.data_ptr(), C, 12,
                        int(plan.cyclic), 1, ctas, stream_of(scratch))
                pcr.WIDE_LIB.check(rc, "K4 wide factor")

            ms = cuda_ms(go, 10)
            same = all(torch.equal(a, b) for a, b in zip(out, ref))
            print(f"  grid of {ctas} CTAs: {ms:.4f} ms "
                  f"({device_us(go, 'pcr_factor', 10):.1f} device us)"
                  + ("" if same else " (differs from the plan's)"), flush=True)
        del fact, ref, out, scratch


#: (name, W, nvar, N, B, C) of the correction and narrow factor sweeps:
#: the cells' plans (KS 2^20 and 10^6, the ring N = 999983 on its padded
#: 1534 chunks, Burgers 2^20 and 10^6, config 5, the film 10^6)
GRIDS_K3C = [("ks 2^20", 5, 1, 1 << 20, 1, 1024), ("ks 10^6", 5, 1, 10 ** 6, 1, 1000),
             ("ks ring 999983", 5, 1, 1000168, 1, 1534),
             ("burgers 2^20", 3, 1, 1 << 20, 1, 2048), ("burgers 10^6", 3, 1, 10 ** 6, 1, 2000),
             ("config 5", 5, 1, 10 ** 5, 1024, 100), ("film 10^6", 5, 3, 10 ** 6, 1, 1000)]


def sweep_k3c(dtype):
    """K3's tiled correction: chunks per block CB in 8, 16, 32 by rows per
    block R in 4..64, at ``GRIDS_K3C``'s plans
    (film included), device µs per launch, each output against
    ``thomas.correct_plan``'s."""
    for name, W, nvar, N, B, C in GRIDS_K3C:
        plan = chunked.plan_with(N, nvar, W // 2, True, C, B)
        lead = (B,) if B > 1 else ()
        rows = (*lead, plan.Mc, plan.s, plan.s, C)
        fact = kernel_checks.banded.SpikeFactor(
            None, None, None, torch.randn(rows, dtype=dtype, device="cuda"),
            torch.randn(rows, dtype=dtype, device="cuda"), None, None)
        y = torch.randn((*lead, nvar, plan.Np), dtype=dtype, device="cuda")
        xm1, xp1 = (torch.randn((*lead, plan.s, C), dtype=dtype, device="cuda")
                    for _ in range(2))
        ref = thomas.spike_correct(fact, y, xm1, xp1, plan)
        item = y.element_size()
        pick = thomas.correct_plan(plan.s, item, plan.Mc, C, B)
        lib = thomas.SOLVE_LIB if plan.s <= thomas.NARROW_S else thomas.SOLVE_WIDE_LIB
        fn = lib.fn(f"tf_spike_correct_{suffix(dtype)}", 7, 9)
        out = torch.empty_like(y)
        print(f"K3 correction {name} C={C} Mc={plan.Mc} B={B} {dtype}: correct_plan picks "
              f"{pick}", flush=True)
        for CB in (8, 16, 32):
            for R in (4, 8, 16, 32, 64):
                def go(CB=CB, R=R):
                    rc = fn(y.data_ptr(), fact.W.data_ptr(), fact.V.data_ptr(),
                            xm1.data_ptr(), xp1.data_ptr(), 0, out.data_ptr(), plan.Np,
                            plan.nvar, plan.g, plan.Mc, C, 0, B, CB, R, stream_of(y))
                    lib.check(rc, "K3 correction")

                us = device_us(go, "spike_correct")
                same = torch.equal(out, ref)
                print(f"  CB={CB} R={R}: {us:.2f} device us"
                      + ("" if same else " (differs from correct_plan's)"), flush=True)
        del fact, y, xm1, xp1, ref, out
        torch.cuda.empty_cache()


#: (name, W, nvar, N, B, C) of the narrow factor's sweep: the narrow plans
#: of ``GRIDS_K3C``; for the crossover of the grid and the one block per
#: member (``pcr.factor_route``), config 5's C = 100 at fewer members, one
#: grid of KS (s2 = 4) and Burgers (s2 = 2) at C = 64..512, and KS's C =
#: 1000 at 16 and 132 members
GRIDS_K4N = [g for g in GRIDS_K3C if g[2] * max(g[1] // 2, 1) <= thomas.NARROW_S] + [
    (f"config 5 B={B}", 5, 1, 10 ** 5, B, 100) for B in (4, 16, 64, 132, 256)] + [
    (f"{name} C={C}", W, 1, None, 1, C) for name, W in (("ks", 5), ("burgers", 3))
    for C in (64, 128, 256, 512)] + [
    (f"ks C=1000 B={B}", 5, 1, None, B, 1000) for B in (16, 132)]


def sweep_k4n(dtype):
    """K4's narrow factor at ``GRIDS_K4N``: the one block per member, and
    the grid (its body fixed by s2) on grids of 1, 2, 4 and 8 CTAs an SM
    (as many as the pairs need and the card holds); device µs per launch,
    each output against the plain factor's (bit for bit, or the largest
    gap)."""
    for name, W, nvar, N, B, C in GRIDS_K4N:
        Mc = 2
        plan = chunked.plan_with(2 * C * Mc * (W // 2), nvar, W // 2, True, C, B)
        bands = kernel_checks.random_bands(W, nvar, plan.N, dtype, "cuda")
        if B > 1:
            bands = bands.expand(B, *bands.shape).contiguous()
        fact = thomas.spike_factor(bands, 1.0, -0.3, plan)
        del bands
        s2, sfx = 2 * plan.s, suffix(dtype)
        want = pcr.pcr_factor_plain(fact.Lred, fact.Ured, plan.cyclic)
        sms = sm_count(fact.Lred)
        print(f"K4 narrow factor {name} C={C} B={B} s2={s2} cyclic={plan.cyclic} {dtype}: "
              f"route {pcr.factor_route(s2, C)}", flush=True)

        def report(label, go):
            got = go()
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            gap = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))
                      for a, b in zip(got, want))
            print(f"  {label}: {device_us(go, 'pcr_factor', 10):.1f} device us; "
                  + ("bit-equal to the plain factor" if same else f"gap {gap:.2e}"),
                  flush=True)

        report("one block per member", lambda: pcr._factor(fact.Lred, fact.Ured, plan.cyclic,
                                                          "members"))
        lead = (B,) if B > 1 else ()
        nlev = pcr.n_levels(C)
        held = pcr._grid_blocks(pcr.LIB, sfx, s2)
        pick = pcr.factor_plan_grid(C, s2, B, sms, held)
        per_cta = pcr.grid_pairs_per_cta(s2)
        fn = pcr.LIB.fn(f"tf_pcr_factor_grid_{sfx}", 6, 5)
        for per in (1, 2, 4, 8):
            if per > held:
                continue
            ctas = min(-(-B * C // per_cta), sms * per)

            def go(ctas=ctas):
                ops = torch.empty((2, *lead, nlev, s2, s2, C), dtype=dtype, device="cuda")
                Dinv = torch.empty((*lead, s2, s2, C), dtype=dtype, device="cuda")
                scratch = torch.empty((7, B * C, s2, s2), dtype=dtype, device="cuda")
                rc = fn(fact.Lred.data_ptr(), fact.Ured.data_ptr(), ops[0].data_ptr(),
                        ops[1].data_ptr(), Dinv.data_ptr(), scratch.data_ptr(), C, s2,
                        int(plan.cyclic), B, ctas, stream_of(Dinv))
                pcr.LIB.check(rc, "K4 narrow factor")
                return pcr.PcrFactor(ops[0], ops[1], Dinv)

            report(f"grid ({'a thread' if s2 == 2 else 'lane groups'} per pair), {ctas} CTAs "
                   f"({per} an SM; the card holds {held}; plan {pick})", go)
        del fact, want
        torch.cuda.empty_cache()


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
    which = sys.argv[1:] or ["k2", "k4", "k3", "k5"]
    if "steps" in which:
        # the whole-step chunk sweeps behind the plans' cost constants
        import chip_smoke as cs

        cs.narrow_sweeps()
        points = []
        for dt_name, dtype in cs.DTYPES.items():
            cs.film_sweep(dt_name, dtype, points)
        cs.film_fit(points)
        which = [w for w in which if w != "steps"]
    sweeps = {"k2": sweep_k2, "k4": sweep_k4, "k3": sweep_k3, "k5": sweep_k5,
              "k2w": sweep_k2w, "k4w": sweep_k4w, "k3c": sweep_k3c, "k4n": sweep_k4n}
    for dtype in (torch.float64, torch.float32):
        for key in which:
            sweeps[key](dtype)


if __name__ == "__main__":
    main()
