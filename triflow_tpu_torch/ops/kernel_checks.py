"""Each kernel against its plain version on CUDA tensors, on the same
inputs: the checks behind ``tests/test_torch_kernels.py`` and phase 1 of
``chip_smoke.py``.

Inputs are made with numpy from a seed.  Tolerances: float64 F and J within
1e-12 of max|F| (max|J|), float64 solver pieces within 1e-10 of the largest
entry; float32 F and J within 1e-5 of the largest entry, float32 solver
pieces within 1e-4, and the float32 solve's residual ``|A x - b| / |b|``
within 1e-4.  float32 is looser because FMA contraction and summation order
differ between the kernel and torch.  K5 (combine) rounds every product and
sum as its plain version does, in the same order, so it should agree to
the last bit; it is held to 1e-15 (f64) and 1e-6 (f32) of the largest
entry, a few units in the last place.  K6 (the whole step) is held to the
solver tolerances, its ``nsteps = 3`` launch bit for bit to three launches
of one step, and its adaptive entry to the same attempts and status as
the plain controller, with u within the solver tolerances and err (of the
step entry) within them at the scale of max|u|.  The adapted dt_i is held
to 1e-8 relative in float64 and to 0.2 in float32, not to the solver
tolerances: err is a difference of stage solutions that cancel down to the
size of tol, so it carries the solve's rounding times the condition number
of ``I - g00 dt J`` over err's own size; dt goes as ``err**-1/2`` and feeds
the next attempt, so the gap grows over the output step's attempts.  The
limits rest on ``adaptive_dt_readings`` (PERF.md): over eight seeds on an
H100 the kernel-to-plain gap reached 2.9e-10 (float64) and 0.13 (float32,
KS), while an err twice too large moves dt_i by 0.12 and more and changes
the attempts on KS, and moves it by 0.23 and more on the README grid; in
float32 on KS the two ranges meet, and it is the equal attempts that
catch a wrong err there.

K4's Woodbury set-up and R-column solve across the card, and K1's tiled F
and J, are also held bit for bit to the bodies they replace, launched
alone: the one-block body (K6's) and the per-node F and J bodies
(``check_setup``, ``check_tiled_F``, ``check_tiled_J``).

K7 (the banded matvec) is held to the F/J tolerance of the size of its
terms, ``max |scale| |A| |v|``, not of its result: the product of J's
bands with a smooth state cancels to far below its terms; on the card
also bit for bit to the per-node body of before its tiles
(``matvec.banded_matvec_nodes``), which sums the same terms in the same
order.

The df64 mode's kernels (float64 only): K8 (the mixed solve's residual,
rounded to float32) is held entry by entry to one float32 ulp of its
plain version's |r| plus 1e-13 of the entry's terms ``|coef| sum |a| |k|
+ |rhs| + |k|`` (the two round the same double value to float32, and a
residual that cancels far below its terms may sit on a rounding
boundary); K6's mixed entry to the solver tolerance or to twice the
mixed solve's own residue, whichever is larger: its float32 solves differ
from the plain version's in rounding, and n residual passes leave a
residue of about (float32 eps x condition)^(n + 1) of the float64 step,
so two runs of the mixed solve may differ by up to both their residues.
The residue is the plain mixed step's distance from the plain float64
step (on the CPU: 2.7e-10 relative for Theta on the README grid at dt =
5 with one pass, where I - 5 J is stiff; 1e-13 and below on KS at dt =
0.0625).  Its ``nsteps = 3`` launch is held bit for bit to three
launches.

K9 (the two-pass theta step) is held to the solver tolerances: each
entry against its plain version on the same inputs (the correction pass
on the plain interface solve's unknowns), the whole K9 step against its
plain version, and the plain step against the plain K1-K4 step (K2's
factor, K3's sweep and correction that adds the state) on the same plan.

The member axis (``run_batched``): K1's F, F_terms and J, K2-K4 and K6's
entries on B = 4 members with per-member parameters, shifts and scales,
against their plain versions at the same tolerances; K6's adaptive entries
with a shared dt and per member (the same attempts per member as the plain
controllers), and its adaptive scan bit for bit against the same number
of adaptive launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import (banded, chunked, combine, matvec, megastep, megatheta, mixed, pcr,
               stencil, thomas)

TOL = {torch.float64: {"FJ": 1e-12, "solve": 1e-10, "combine": 1e-15,
                       "dt": 1e-8},
       torch.float32: {"FJ": 1e-5, "solve": 1e-4, "combine": 1e-6,
                       "dt": 0.2}}

#: (equations, dependent variables, parameters) the K1 checks compile
STENCIL_MODELS = {
    "burgers": ("-U * dxU + nu * dxxU", "U", ["nu"]),
    "readme": ("k * dxxU - c * dxU", "U", ["k", "c"]),
    "ks": ("-dxxU - dxxxxU - U * dxU", "U", []),
}

#: the models of the K6 checks, one per block size s = 1, 2, 4
MEGA_MODELS = {
    "readme": STENCIL_MODELS["readme"],
    "ks": STENCIL_MODELS["ks"],
    "two_var": (["-dxq", "-dx(q**2/h) - h * dxxxh + q / h"], ["h", "q"], []),
}


class CheckFailed(AssertionError):
    pass


def _err(got, want, scale=None):
    """(max abs error, max abs error relative to ``scale``, by default
    max|want|)."""
    got, want = got.double(), want.double()
    abs_err = float((got - want).abs().max()) if want.numel() else 0.0
    if scale is None:
        scale = float(want.abs().max()) if want.numel() else 0.0
    return abs_err, abs_err / max(scale, 1e-300)


def _record(results, name, got, want, tol, what, scale=None):
    abs_err, rel = _err(got, want, scale)
    if not rel <= tol:
        raise CheckFailed(f"{name} {what}: relative error {rel:.3e} > {tol:.0e}")
    prev = results.get(name, 0.0)
    results[name] = max(prev, abs_err)


#: a step's result is held on its increment only where one ulp of the state
#: is at most this share of the limit on the increment; below that, the
#: state's rounding hides a wrong increment
RESOLVED_SHARE = 0.25


def increment_error(got, want, u0, tol, what):
    """(max abs error, max abs error relative to max|want - u0|): a step's
    result (or that of several steps) ``got`` against ``want``, held on the
    increment it makes from u0.  Raises CheckFailed where one ulp of
    max|u0| in got's dtype exceeds ``RESOLVED_SHARE * tol`` of that
    increment: there no limit ``tol`` could fail a wrong increment."""
    eps = torch.finfo(got.dtype).eps
    got, want, u0 = (a.double().cpu() for a in (got, want, u0))
    inc = float((want - u0).abs().max())
    ulp = eps * float(u0.abs().max())
    if not ulp <= RESOLVED_SHARE * tol * inc:
        raise CheckFailed(f"{what}: the increment max|du| = {inc:.3e} is within "
                          f"{ulp / inc:.1e} of the state's ulp, too small to be held "
                          f"to {tol:.0e}")
    return _err(got - u0, want - u0, inc)


def _record_step(results, name, got, want, u0, tol, what):
    abs_err, rel = increment_error(got, want, u0, tol, f"{name} {what}")
    if not rel <= tol:
        raise CheckFailed(f"{name} {what}: error {rel:.3e} of the increment > {tol:.0e}")
    results[name] = max(results.get(name, 0.0), abs_err)


def check_stencil(model, N, periodic, device, seed=0, results=None):
    """K1's F (with a scale, then with a scale and a bias) and J entries
    against their plain versions on random inputs of the model's dtype."""
    results = {} if results is None else results
    b = model.backend
    dtype = b.dtype
    rng = np.random.default_rng(seed)
    sysm = b.system

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    u = t(rng.standard_normal((sysm.nvar, N)))
    helpers = t(rng.standard_normal((len(sysm.help_funcs), N)))
    pstack = t(0.5 + rng.random((len(sysm.pars), 1)) * np.ones((1, N)))
    x = t(np.linspace(0.0, 0.001 * N, N))
    tol = TOL[dtype]["FJ"]
    scale = 0.05
    F_k = b.F(u, helpers, pstack, x, periodic=periodic, scale=scale)
    F_p = scale * b.F_impl(u, helpers, pstack, x, periodic=periodic)
    _record(results, "K1.F", F_k, F_p, tol, f"N={N} periodic={periodic}")
    bias = t(rng.standard_normal((sysm.nvar, N)))
    F_k = b.F(u, helpers, pstack, x, periodic=periodic, scale=scale, bias=bias)
    F_p = stencil.eval_F_plain(b, u, helpers, pstack, x, periodic, scale, bias)
    _record(results, "K1.F", F_k, F_p, tol,
            f"N={N} periodic={periodic} with bias")
    J_k = b.J_bands(u, helpers, pstack, x, periodic=periodic)
    J_p = b.J_bands_impl(u, helpers, pstack, x, periodic=periodic)
    _record(results, "K1.J", J_k, J_p, tol, f"N={N} periodic={periodic}")
    return results


def check_combine(rows, arrays, results=None):
    """K5 against its plain version on the same arrays."""
    results = {} if results is None else results
    tol = TOL[arrays[0].dtype]["combine"]
    what = (f"A={len(arrays)} R={len(rows)} shape={tuple(arrays[0].shape)} "
            f"rows={rows}")
    got = combine.combine(rows, arrays)
    want = combine.combine_plain(rows, arrays)
    for g, w in zip(got, want):
        _record(results, "K5.combine", g, w, tol, what)
    return results


#: (nvar, N) shapes of the K5 checks: N neither a multiple of the block
#: (256) nor of a warp, and two variables
COMBINE_SHAPES = [(1, 1000), (2, 777), (1, 4096)]


def combine_cases(rng):
    """(rows, n_arrays) of the K5 checks: A from 1 to 7, R of 1 and 2,
    rows with zero and unit coefficients and a row that is all zero."""
    cases = []
    for A in range(1, 8):
        for R in (1, 2):
            rows = rng.standard_normal((R, A)).tolist()
            rows[0][0] = 1.0
            if A > 2:
                rows[-1][1] = 0.0
            cases.append(rows)
    cases.append([[0.0, 0.0, 1.0], [0.0, 0.0, 0.0]])
    cases.append([[1.0, 1.0], [1.0, -1.0]])
    return cases


def check_all_combines(device, dtype, results=None, seed=0):
    results = {} if results is None else results
    rng = np.random.default_rng(seed)
    for shape in COMBINE_SHAPES:
        for rows in combine_cases(rng):
            arrays = [torch.tensor(rng.standard_normal(shape), dtype=dtype,
                                   device=device) for _ in rows[0]]
            check_combine(rows, arrays, results)
    return results


def check_combine_exact(rows, arrays, results=None, what=""):
    """K5 equal to its plain version bit for bit (``torch.equal``)."""
    results = {} if results is None else results
    got = combine.combine(rows, arrays)
    want = combine.combine_plain(rows, arrays)
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise CheckFailed(f"K5.combine {what}: not bit for bit equal to its "
                              f"plain version (max gap {_err(g, w)[0]:.3e})")
        _record(results, "K5.combine", g, w, 0.0, what)
    return results


def check_combines_exact(device, dtype, results=None, seed=0):
    """K5 bit for bit at the RODASPR rows on KS 2^20's shape (A = 7, R =
    2; the 16-byte vector path), on arrays whose start is not 16-byte
    aligned (the scalar path) and at a length with a vector tail."""
    results = {} if results is None else results
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((2, 7)).tolist()
    rows[0][0], rows[1][0], rows[1][3] = 1.0, 1.0, 0.0
    for n, offset in ((1 << 20, 0), (4099, 1), (4099, 0), (10 ** 6 + 3, 2)):
        arrays = [torch.tensor(rng.standard_normal(n + offset), dtype=dtype,
                               device=device)[offset:] for _ in range(7)]
        check_combine_exact(rows, arrays, results, f"n={n} offset={offset}")
    return results


def check_combine_dt_exact(rows, arrays, dt, results=None, what=""):
    """K5 with every column but the first weighed by ``dt`` (the explicit
    RK family's rows) equal to its plain version bit for bit; ``dt`` one
    number, or one per member (a (B,) tensor: the members body, recorded as
    ``K5.combine_members``)."""
    results = {} if results is None else results
    cols = tuple(range(1, len(arrays)))
    name = "K5.combine_members" if isinstance(dt, torch.Tensor) else "K5.combine"
    got = combine.combine(rows, arrays, dt, cols)
    want = combine.combine_plain(rows, arrays, dt, cols)
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise CheckFailed(f"{name} {what}: not bit for bit equal to its "
                              f"plain version (max gap {_err(g, w)[0]:.3e})")
        _record(results, name, g, w, 0.0, what)
    return results


def erk_rows(a, b, b_pred):
    """The K5 rows of one explicit RK step of tableau (a, b, b_pred): each
    stage input's ``[1] + a[i, :i]`` over u and the i stages before it, and
    the final ``[1] + b`` (with ``b_pred``, ``[0] + (b - b_pred)`` too) over
    u and all s stages, zero coefficients kept."""
    s = len(b)
    rows = [[[1.0] + [float(c) for c in a[i, :i]]] for i in range(1, s)]
    final = [[1.0] + [float(c) for c in b]]
    if b_pred is not None:
        final.append([0.0] + [float(c) for c in np.asarray(b) - b_pred])
    return rows + [final]


#: step sizes of the ERK checks, none exact in float32
ERK_DTS = (1.234567e-5, 0.1 / 3)


def check_erk_combines(shape, device, dtype, results=None, seed=0, B=None):
    """K5 bit for bit its plain version with the rows of RK4, BS32 and
    DOPRI5 (every stage input and the final rows over u and all stages, 8
    arrays for DOPRI5) at ``shape`` and each of ``ERK_DTS``; with ``B``
    members, a scalar dt and one dt per member (the members body)."""
    from ..core import schemes

    results = {} if results is None else results
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    for tableau in (schemes.rk4_tableau, schemes.bs32_tableau,
                    schemes.dopri5_tableau):
        a, b, b_pred = tableau()
        arrays = [torch.tensor(rng.standard_normal(lead + tuple(shape)),
                               dtype=dtype, device=device)
                  for _ in range(len(b) + 1)]
        for rows in erk_rows(a, b, b_pred):
            cols = arrays[:len(rows[0])]
            for dt in ERK_DTS:
                what = (f"{tableau.__name__} A={len(cols)} R={len(rows)} "
                        f"shape={tuple(cols[0].shape)} dt={dt}")
                check_combine_dt_exact(rows, cols, dt, results, what)
                if B is not None:
                    dts = torch.tensor(dt * (1 + rng.random(B)), dtype=dtype,
                                       device=device)
                    check_combine_dt_exact(rows, cols, dts, results,
                                           what + " per member")
    return results


#: (W, nvar) of each block size s = nvar * max(W // 2, 1), 1..8
SWEEP_BLOCKS = {1: (3, 1), 2: (5, 1), 3: (3, 3), 4: (9, 1), 5: (3, 5),
                6: (5, 3), 7: (3, 7), 8: (5, 4)}
#: (C, Mc, B) of the sweep checks: Mc = 2, odd, no multiple of the stage
#: rows, and (None) long enough that the forward results stream through y
#: in both types (``sweep_plan``: Mc s > 3072 at 4 chunks per block); C no
#: multiple of the chunks per block; with and without members
SWEEP_SHAPES = [(3, 2, 1), (37, 13, 1), (5, 37, 3), (40, 9, 1), (3, None, 1),
                (2, 301, 2)]


def check_sweep(W, nvar, C, Mc, B, dtype, device, seed=0, results=None):
    """K3's sweep against its plain version on K2's factor of random bands
    (B members, or one grid for B = 1) and a random right-hand side."""
    results = {} if results is None else results
    g = max(W // 2, 1)
    N = C * Mc * g
    plan = chunked.plan_with(N, nvar, W // 2, False, C, B)
    sp_ = thomas.sweep_plan(plan.s, torch.finfo(dtype).bits // 8, Mc, C, B)
    what = (f"s={plan.s} C={C} Mc={Mc} B={B} CB={sp_.CB} R={sp_.R} "
            f"persist={sp_.persist}")
    if B > 1:
        bands = torch.stack([random_bands(W, nvar, N, dtype, device, seed + b)
                             for b in range(B)])
    else:
        bands = random_bands(W, nvar, N, dtype, device, seed)
    fact = thomas.spike_factor(bands, 1.0, -0.3, plan)
    rng = np.random.default_rng(seed)
    lead = (B,) if B > 1 else ()
    rhs = torch.tensor(rng.standard_normal((*lead, nvar, N)), dtype=dtype,
                       device=device)
    y_k, yred_k = thomas.thomas_sweep(fact, rhs, plan)
    y_p, yred_p = thomas.thomas_sweep_plain(fact, rhs, plan)
    name = solver_entry("K3.thomas_sweep", plan.s)
    tol = TOL[dtype]["solve"]
    _record(results, name, y_k, y_p, tol, what)
    _record(results, name, yred_k, yred_p, tol, f"yred {what}")
    return results


def check_all_sweeps(device, dtype, results=None, blocks=SWEEP_BLOCKS):
    """``check_sweep`` at every block size of ``blocks`` and shape of
    ``SWEEP_SHAPES``."""
    results = {} if results is None else results
    for s, (W, nvar) in blocks.items():
        for i, (C, Mc, B) in enumerate(SWEEP_SHAPES):
            check_sweep(W, nvar, C, Mc or 3073 // s + 1, B, dtype, device,
                        seed=10 * s + i, results=results)
    return results


#: (W, nvar, N, periodic, C, B) of the staged K2 checks, at every narrow
#: block size s = 1..4: rings closed block-cyclic (a power of two C >= 8)
#: and by the Woodbury correction, acyclic grids, padded plans (a ring
#: closed at the system level and an edge grid), members with their own
#: shifts, Mc = 1, 2 and odd, C no multiple of the chunks per block,
#: chunks long enough (the last of each s) that the forward results stream
#: through the factor's rows in both types (``thomas.factor_plan``: 3 Mc
#: s^2 CB values over 48 KB), and B = 4 x KS N = 10^5's plan, whose shared
#: memory sits just under 48 KB (with the kernel's static arrays, over)
FACTOR_CASES = [
    (3, 1, 4096, True, 16, 1), (3, 1, 3000, True, 12, 1), (3, 1, 2000, False, 10, 1),
    (3, 1, 1001, True, 10, 1), (3, 1, 999, False, 7, 4), (3, 1, 600, True, 6, 4),
    (3, 1, 40, True, 40, 1), (3, 1, 15003, False, 3, 1),
    (5, 1, 4096, True, 64, 1), (5, 1, 1000, True, 20, 1), (5, 1, 1200, False, 5, 4),
    (5, 1, 1003, True, 10, 1), (5, 1, 2048, True, 8, 4), (5, 1, 74, True, 37, 1),
    (5, 1, 9006, False, 3, 1),
    (3, 3, 1024, True, 8, 1), (3, 3, 900, True, 9, 1), (3, 3, 500, False, 5, 4),
    (3, 3, 301, True, 7, 1), (3, 3, 2400, True, 3, 2),
    (5, 2, 2048, True, 16, 1), (5, 2, 1200, True, 12, 4), (5, 2, 1000, False, 4, 1),
    (5, 2, 803, True, 9, 1), (3, 4, 512, True, 8, 4), (3, 4, 600, False, 6, 1),
    (5, 2, 2400, True, 3, 1), (5, 1, 100000, True, 500, 4),
]


def check_factor(W, nvar, N, periodic, C, B, dtype, device, seed=0, results=None):
    """K2 against its plain version on the plan of C chunks (per member, of
    B) of random bands: each member with its own factor shift, and on a
    padded or ring plan the padded system (``chunked.padded_system``), as
    ``chunked.factor`` gives them to K2."""
    results = {} if results is None else results
    halo = W // 2
    plan = chunked.plan_with(N, nvar, halo, periodic, C, B)
    item = torch.finfo(dtype).bits // 8
    what = (f"s={plan.s} N={N} C={C} Mc={plan.Mc} B={B} cyclic={plan.cyclic} "
            f"woodbury={plan.woodbury} Np={plan.Np} ring={plan.ring}")
    if plan.s <= thomas.NARROW_S:
        what += f" {thomas.factor_plan(nvar, halo, item, plan.Mc, C, B)}"
    if B > 1:
        bands = torch.stack([random_bands(W, nvar, N, dtype, device, seed + b, beta=-0.2)
                             for b in range(B)])
        beta = torch.tensor(np.linspace(-0.3, -0.2, B), dtype=dtype, device=device)
    else:
        bands, beta = random_bands(W, nvar, N, dtype, device, seed), -0.3
    alpha = 1.0
    if plan.padded or plan.ring:
        bands, _ = chunked.padded_system(alpha, beta, bands, plan)
        alpha, beta = 0.0, 1.0
    got = thomas.spike_factor(bands, alpha, beta, plan)
    want = thomas.spike_factor_plain(bands, alpha, beta, plan)
    name = solver_entry("K2.spike_factor", plan.s)
    for part, g, w in zip(got._fields, got, want):
        _record(results, name, g, w, TOL[dtype]["solve"], f"{part} {what}")
    return results


def check_all_factors(device, dtype, results=None, cases=FACTOR_CASES):
    """``check_factor`` at every case of ``cases``."""
    results = {} if results is None else results
    for i, case in enumerate(cases):
        check_factor(*case, dtype, device, seed=i, results=results)
    return results


#: (s, C, B, periodic) of the cluster solve checks, at every interface
#: block size s2 = 2s = 2..16 (bands of ``SWEEP_BLOCKS[s]``): chunk counts
#: whose ``pcr.solve_plan`` takes one CTA (C <= 64 at one grid, or many
#: members) and clusters of several CTAs (C = 300: 5, C = 1024: 16, C =
#: 1000: 16 CTAs of 63 chunks, the last of 55); rings closed block-cyclic
#: (C = 1024, 64) and by the Woodbury correction, acyclic grids; C = 2 and
#: 3 (one level); members
SHIFT_CASES = [(s, C, B, periodic) for s in range(1, 9) for C, B, periodic in (
    (64, 1, True), (300, 1, True), (1024, 1, True), (1000, 1, False), (3, 1, True),
    (2, 1, False), (130, 4, True), (100, 200, True))]


def check_shift(s, C, B, periodic, dtype, device, seed=0, results=None):
    """K4's solve with shifts against its plain version, on the plain
    reduced factor of random bands at block size s (``SWEEP_BLOCKS``, 2
    rows per chunk; B members), a random right-hand side and, on a Woodbury
    plan, the plain closure."""
    results = {} if results is None else results
    W, nvar = SWEEP_BLOCKS[s]
    g = max(W // 2, 1)
    N = 2 * C * g
    plan = chunked.plan_with(N, nvar, W // 2, periodic, C, B)
    lead = (B,) if B > 1 else ()
    bands = torch.stack([random_bands(W, nvar, N, dtype, device, seed + b)
                         for b in range(B)]) if B > 1 else \
        random_bands(W, nvar, N, dtype, device, seed)
    sp_ = thomas.spike_factor_plain(bands, 1.0, -0.3, plan)
    red = pcr.pcr_factor_plain(sp_.Lred, sp_.Ured, plan.cyclic)
    wood = pcr.woodbury_plain(red, sp_.Lred, sp_.Ured) if plan.woodbury else ()
    rng = np.random.default_rng(seed)
    yred = torch.tensor(rng.standard_normal((*lead, 2 * s, C)), dtype=dtype,
                        device=device)
    sp = pcr.solve_plan(C, 2 * s, B, torch.finfo(dtype).bits // 8)
    what = (f"s2={2 * s} C={C} B={B} cyclic={plan.cyclic} woodbury={plan.woodbury} "
            f"{sp}")
    got = pcr.pcr_solve_shift(red, yred, plan.wrap, *wood)
    want = pcr.pcr_solve_shift_plain(red, yred, plan.wrap, *wood)
    name = solver_entry("K4.pcr_solve_shift", s)
    for part, g_, w in zip(("xm1", "xp1"), got, want):
        _record(results, name, g_, w, TOL[dtype]["solve"], f"{part} {what}")
    return results


def check_all_shifts(device, dtype, results=None, cases=SHIFT_CASES):
    """``check_shift`` at every case of ``cases``."""
    results = {} if results is None else results
    for i, case in enumerate(cases):
        check_shift(*case, dtype, device, seed=i, results=results)
    return results


#: (C, Mc, B) of K3's tiled correction checks (``thomas.correct_plan``:
#: blocks of CB = 32 chunks, or B C rounded up to a power of two, by R =
#: 256 // CB rows), at every block size s = 1..8 (``SWEEP_BLOCKS``): one
#: chunk in one and in two row tiles (R = 256), two and three chunks, a
#: part-full last group (C = 37), Mc no multiple of R (13, 9, 37, 300),
#: chunk groups that straddle members (B = 3 x 40) and B = 1024 members
CORRECT_SHAPES = [(1, 13, 1), (1, 300, 1), (2, 9, 1), (3, 37, 1), (37, 13, 1),
                  (40, 9, 3), (5, 3, 1024)]


def check_correct(s, C, Mc, B, dtype, device, seed=0, results=None):
    """K3's correction against its plain version at block size s (nvar and
    halo of ``SWEEP_BLOCKS``), C chunks of Mc rows, B members (one grid for
    B = 1), on random spikes, right-hand side y and neighbour unknowns (the
    correction is the same algebra on any plan), without and with
    ``add_to``."""
    results = {} if results is None else results
    W, nvar = SWEEP_BLOCKS[s]
    N = C * Mc * max(W // 2, 1)
    plan = chunked.plan_with(N, nvar, W // 2, False, C, B)
    rng = np.random.default_rng(seed)
    lead = (B,) if B > 1 else ()

    def rand(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=dtype, device=device)

    rows = (*lead, Mc, s, s, C)
    fact = banded.SpikeFactor(None, None, None, rand(*rows), rand(*rows), None, None)
    y, add = rand(*lead, nvar, N), rand(*lead, nvar, N)
    xm1, xp1 = rand(*lead, s, C), rand(*lead, s, C)
    cp = thomas.correct_plan(s, torch.finfo(dtype).bits // 8, Mc, C, B)
    what = f"s={s} nvar={nvar} C={C} Mc={Mc} B={B} {cp}"
    name = solver_entry("K3.spike_correct", s)
    for add_to in (None, add):
        got = thomas.spike_correct(fact, y, xm1, xp1, plan, add_to)
        want = thomas.spike_correct_plain(fact, y, xm1, xp1, plan, add_to)
        _record(results, name, got, want, TOL[dtype]["solve"],
                f"{what} add_to={add_to is not None}")
    return results


def check_all_corrections(device, dtype, results=None, blocks=SWEEP_BLOCKS,
                          shapes=CORRECT_SHAPES):
    """``check_correct`` at every block size of ``blocks`` and shape of
    ``shapes``."""
    results = {} if results is None else results
    for s in blocks:
        for i, (C, Mc, B) in enumerate(shapes):
            check_correct(s, C, Mc, B, dtype, device, seed=10 * s + i, results=results)
    return results


#: (s, C, B, periodic) of the narrow factor checks at s2 = 2s = 2..8, each
#: by the route ``pcr.factor_route`` picks: one block per member at one
#: chunk (no level), two and three (one and two levels, acyclic), C = 64
#: and 128 block-cyclic (``pcr.FACTOR_MEMBERS_MAX_C``); the grid at C =
#: 1024 block-cyclic, 1000 and KS 10^6's ring on 1534 chunks (Woodbury
#: plans, factored acyclic), 1000 acyclic, and B = 4 x 130 members
GRID_FACTOR_CASES = [(s, C, B, periodic) for s in range(1, 5) for C, B, periodic in (
    (1, 1, False), (2, 1, False), (3, 1, True), (64, 1, True), (128, 1, True),
    (1024, 1, True), (1000, 1, True), (1534, 1, True), (1000, 1, False), (130, 4, True))]


def check_grid_factor(s, C, B, periodic, dtype, device, seed=0, results=None):
    """K4's narrow factor (``pcr.pcr_factor``, by the route and body its
    shape picks) against its plain version on the reduced system of K2's
    plain factor of random bands (``SWEEP_BLOCKS[s]``, 2 rows per chunk; B
    members with their own bands)."""
    results = {} if results is None else results
    W, nvar = SWEEP_BLOCKS[s]
    N = 2 * C * max(W // 2, 1)
    plan = chunked.plan_with(N, nvar, W // 2, periodic, C, B)
    bands = torch.stack([random_bands(W, nvar, N, dtype, device, seed + b)
                         for b in range(B)]) if B > 1 else \
        random_bands(W, nvar, N, dtype, device, seed)
    sp_ = thomas.spike_factor_plain(bands, 1.0, -0.3, plan)
    want = pcr.pcr_factor_plain(sp_.Lred, sp_.Ured, plan.cyclic)
    got = pcr.pcr_factor(sp_.Lred, sp_.Ured, plan.cyclic)
    what = f"s2={2 * s} C={C} B={B} cyclic={plan.cyclic} route={pcr.factor_route(2 * s, C)}"
    for part, g_, w in zip(got._fields, got, want):
        _record(results, factor_entry(s, C), g_, w, TOL[dtype]["solve"], f"{part} {what}")
    return results


def check_all_grid_factors(device, dtype, results=None, cases=GRID_FACTOR_CASES):
    """``check_grid_factor`` at every case of ``cases``."""
    results = {} if results is None else results
    for i, case in enumerate(cases):
        check_grid_factor(*case, dtype, device, seed=i, results=results)
    return results


#: (N, B) of K1's tiled F checks (tiles of 256 nodes): fewer nodes than the
#: halo spans on each side (N = 2, 3: the closure wraps more than once), a
#: part-full tile (5, 255), a tile and a node (257), a node short of two
#: tiles (511), many tiles and a part-full last (4099); B = 4 and 1024
#: members
TILED_F_SHAPES = [(2, 1), (3, 1), (5, 1), (255, 1), (257, 1), (511, 1), (4099, 1),
                  (257, 4), (1000, 4), (300, 1024)]


def check_tiled_F(model, N, B, periodic, device, seed=0, results=None):
    """K1's tiled F entry (a scale and a bias, per-member scales on
    members) and F_terms (RODASPR's last stage) against their plain
    versions at N nodes and B members; on the card, F also bit for bit
    against K6's per-node body launched alone (``stencil.cu``:
    ``tf_stencil_F_nodes_*``) and F_terms of the one term (1, 0, u)
    against F without a bias."""
    results = {} if results is None else results
    b = model.backend
    dtype = b.dtype
    rng = np.random.default_rng(seed)
    u, helpers, pstack, x = _tiled_inputs(b, N, B, rng, device)
    t = functools.partial(torch.tensor, dtype=dtype, device=device)
    bias = t(rng.standard_normal(u.shape))
    scale = t(0.05 * (1.0 + np.arange(B))) if B > 1 else 0.05
    tol = TOL[dtype]["FJ"]
    what = f"N={N} B={B} periodic={periodic}"
    got = b.F(u, helpers, pstack, x, periodic=periodic, scale=scale, bias=bias)
    _record(results, "K1.F", got, stencil.eval_F_plain(
        b, u, helpers, pstack, x, periodic, scale, bias), tol, f"{what} with bias")
    plain_F = b.F(u, helpers, pstack, x, periodic=periodic, scale=scale)
    _record(results, "K1.F", plain_F, stencil.eval_F_plain(
        b, u, helpers, pstack, x, periodic, scale), tol, what)
    stages = [t(1e-2 * rng.standard_normal(u.shape)) for _ in range(5)]
    coefs = [(1.0, 0.0), (0.75, 0.3), (0.0, -1.2), (1.0, 1.0), (2.5, 0.0), (-0.4, 0.7)]
    terms = [(a, c, arr) for (a, c), arr in zip(coefs, [u] + stages)]
    _record(results, "K1.F_terms",
            b.F_terms(terms, helpers, pstack, x, periodic=periodic, scale=scale),
            stencil.eval_F_terms_plain(b, terms, helpers, pstack, x, periodic, scale),
            tol, what)
    if torch.device(device).type == "cuda":
        for bias_ in (None, bias):
            want = stencil.eval_F_nodes(b, u, helpers, pstack, x, periodic, scale, bias_)
            got = b.F(u, helpers, pstack, x, periodic=periodic, scale=scale, bias=bias_)
            if not torch.equal(got, want):
                raise CheckFailed(f"K1.F {what} bias={bias_ is not None}: not bit for bit "
                                  "K6's per-node body")
        one = b.F_terms([(1.0, 0.0, u)], helpers, pstack, x, periodic=periodic, scale=scale)
        if not torch.equal(one, plain_F):
            raise CheckFailed(f"K1.F_terms {what}: one unit term is not bit for bit F")
    return results


#: (N, B) of K1's tiled J checks beyond ``TILED_F_SHAPES``: more members
#: than a grid's y takes (65535), so that blocks go on to a second member
TILED_J_MEMBERS = [(3, 66000)]


def check_tiled_J(model, N, B, periodic, device, seed=0, results=None):
    """K1's tiled J entry against its plain version at N nodes and B
    members; on the card also bit for bit against K6's per-node body
    launched alone (``stencil.cu``: ``tf_stencil_J_nodes_*``), which
    evaluates the same expressions on the same operands and folds the
    edge with the same code (``stencil.cuh: fold_edges``)."""
    results = {} if results is None else results
    b = model.backend
    u, helpers, pstack, x = _tiled_inputs(b, N, B, np.random.default_rng(seed), device)
    what = f"N={N} B={B} periodic={periodic}"
    got = b.J_bands(u, helpers, pstack, x, periodic=periodic)
    _record(results, "K1.J", got, b.J_bands_impl(u, helpers, pstack, x, periodic=periodic),
            TOL[b.dtype]["FJ"], what)
    if torch.device(device).type == "cuda":
        if not torch.equal(got, stencil.eval_J_nodes(b, u, helpers, pstack, x, periodic)):
            raise CheckFailed(f"K1.J {what}: not bit for bit K6's per-node body")
    return results


def check_all_tiled_J(device, dtype, results=None,
                      shapes=TILED_F_SHAPES + TILED_J_MEMBERS):
    """``check_tiled_J`` on every model of ``STENCIL_MODELS`` at every
    shape, periodic and edge: the edge fold on first and last tiles that
    are full, part-full or the whole grid."""
    return _on_stencil_models(check_tiled_J, device, dtype, results, shapes)


def _tiled_inputs(backend, N, B, rng, device):
    """(u, helpers, pstack, x) of K1's tiled checks: random rows of B
    members (none for one grid), parameters constant along the grid."""
    sysm = backend.system
    lead = (B,) if B > 1 else ()
    t = functools.partial(torch.tensor, dtype=backend.dtype, device=device)
    return (t(rng.standard_normal((*lead, sysm.nvar, N))),
            t(rng.standard_normal((*lead, len(sysm.help_funcs), N))),
            t(0.5 + rng.random((*lead, len(sysm.pars), 1)) * np.ones((1, N))),
            t(np.linspace(0.0, 0.001 * N, N)))


def _on_stencil_models(check, device, dtype, results, shapes):
    """``check`` on every model of ``STENCIL_MODELS`` (halos 1 and 2) at
    every (N, B) of ``shapes``, periodic and edge."""
    from ..core.model import Model

    results = {} if results is None else results
    for name, (eqs, dep, pars) in STENCIL_MODELS.items():
        model = Model(eqs, dep, pars, double=dtype == torch.float64, device=device)
        for i, (N, B) in enumerate(shapes):
            for periodic in (True, False):
                check(model, N, B, periodic, device, seed=i, results=results)
    return results


def check_all_tiled_F(device, dtype, results=None, shapes=TILED_F_SHAPES):
    """``check_tiled_F`` on every model of ``STENCIL_MODELS`` at every
    shape, periodic and edge."""
    return _on_stencil_models(check_tiled_F, device, dtype, results, shapes)


#: (s, C, B) of the Woodbury set-up checks: every block size s = 1..8 (the
#: narrow and the wide library) at C = 2 and 3 (one and two levels), a
#: prime (7), a part-full last CTA (130) and 1000 chunks, B = 4 members of
#: 100; then the cells' plans (KS 10^6's C = 2000, the ring's 2041,
#: Burgers' 2500, the film's 1000) and config 5's C = 100 at B = 132 and
#: 1024
SETUP_CASES = [(s, C, B) for s in range(1, 9) for C, B in (
    (2, 1), (3, 1), (7, 1), (130, 1), (1000, 1), (100, 4))] + [
    (2, 2000, 1), (2, 2041, 1), (1, 2500, 1), (6, 1000, 1), (2, 100, 132), (2, 100, 1024)]


def setup_entry(s, C, B):
    """The name K4's R-column solve and Woodbury set-up record at block
    size s on C chunks of B members: the route ``pcr.cols_route`` picks."""
    if pcr.cols_route(2 * s, C, B) == "members":
        return "K4.pcr_solve_members"
    return solver_entry("K4.pcr_solve", s)


def check_setup(s, C, B, dtype, device, seed=0, results=None):
    """K4's Woodbury set-up (Z and cap_inv) and R-column solve (R = 1, 3
    and 2s random columns) by the route their shape picks, against their
    plain versions on the plain acyclic factor of K2's plain reduced
    system of random bands (``SWEEP_BLOCKS[s]``, 2 rows per chunk, a
    ring; B members with their own bands); on the card also bit for bit
    against the one-block-per-member body (pcr.cuh, K6's; the route
    "members") on both routes' shapes."""
    results = {} if results is None else results
    W, nvar = SWEEP_BLOCKS[s]
    N = 2 * C * max(W // 2, 1)
    plan = chunked.plan_with(N, nvar, W // 2, True, C, B)
    lead = (B,) if B > 1 else ()
    bands = torch.stack([random_bands(W, nvar, N, dtype, device, seed + b)
                         for b in range(B)]) if B > 1 else \
        random_bands(W, nvar, N, dtype, device, seed)
    sp_ = thomas.spike_factor_plain(bands, 1.0, -0.3, plan)
    del bands
    red = pcr.pcr_factor_plain(sp_.Lred, sp_.Ured, False)
    s2, route = 2 * s, pcr.cols_route(2 * s, C, B)
    name, tol = setup_entry(s, C, B), TOL[dtype]["solve"]
    what = f"s2={s2} C={C} B={B} route={route}"
    got = pcr.woodbury(red, sp_.Lred, sp_.Ured)
    want = pcr.woodbury_plain(red, sp_.Lred, sp_.Ured)
    for part, g_, w in zip(("Z", "cap_inv"), got, want):
        _record(results, name, g_, w, tol, f"woodbury {part} {what}")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        old = (torch.empty_like(got[0]), torch.empty_like(got[1]))
        pcr._launch_cols(red, None, sp_.Lred, sp_.Ured, *old, s2, B, "members")
        if not all(torch.equal(a, b) for a, b in zip(got, old)):
            raise CheckFailed(f"K4 woodbury {what}: not bit for bit the one-block body")
    rng = np.random.default_rng(seed)
    for R in (1, 3, s2):
        cols = torch.tensor(rng.standard_normal((*lead, R, s2, C)), dtype=dtype,
                            device=device)
        out = pcr.pcr_solve(red, cols)
        _record(results, name, out, pcr.pcr_solve_plain(red, cols), tol, f"R={R} {what}")
        if cuda:
            old = torch.empty_like(out)
            pcr._launch_cols(red, cols, None, None, old, None, R, B, "members")
            if not torch.equal(out, old):
                raise CheckFailed(f"K4 pcr_solve R={R} {what}: not bit for bit the "
                                  "one-block body")
    return results


def check_all_setups(device, dtype, results=None, cases=SETUP_CASES):
    """``check_setup`` at every case of ``cases``."""
    results = {} if results is None else results
    for i, case in enumerate(cases):
        check_setup(*case, dtype, device, seed=i, results=results)
    return results


def random_bands(W, nvar, N, dtype, device, seed=0, beta=-0.3):
    """Bands of a J whose ``I + beta*J`` is diagonally dominant."""
    rng = np.random.default_rng(seed)
    bands = rng.standard_normal((W, nvar, nvar, N))
    for m in range(nvar):
        bands[W // 2, m, m] -= 3.0 * W * nvar / abs(beta)
    return torch.tensor(bands, dtype=dtype, device=device)


def check_matvec(bands, v, periodic, scale=1.0, results=None, what=""):
    """K7 against its plain version on the same bands, vector and scale, at
    the F/J tolerance of the size of the terms, ``max |scale| |A| |v|``:
    a product that cancels (J u of a smooth state) carries the rounding of
    its terms, which the two versions sum in different orders; on the card
    also bit for bit against the per-node body of before the tiles
    (``matvec.banded_matvec_nodes``)."""
    results = {} if results is None else results
    got = matvec.banded_matvec(bands, v, periodic, scale)
    want = matvec.banded_matvec_plain(bands, v, periodic, scale)
    terms = matvec.banded_matvec_plain(bands.abs(), v.abs(), periodic,
                                       abs(scale))
    kind = "per-member" if isinstance(scale, torch.Tensor) else "number"
    what = f"bands {tuple(bands.shape)} periodic={periodic} scale {kind} {what}"
    _record(results, "K7.matvec", got, want, TOL[v.dtype]["FJ"], what,
            scale=float(terms.max()))
    if v.is_cuda and not torch.equal(got, matvec.banded_matvec_nodes(bands, v, periodic,
                                                                    scale)):
        raise CheckFailed(f"K7.matvec {what}: not bit for bit the per-node body")
    return results


#: (nvar, W, N) of K7's small-shape checks: one to three variables, three
#: band widths (the tiled body's compile-time shapes), a grid narrower than
#: a warp and odd (7: scalar loads), grids under one tile (64) and over
#: several, no multiple of a tile (1000); then shapes not compiled in,
#: which the entry runs on the per-node body (four variables, W = 9), and
#: the compile-time one's scalar loads on a grid of many tiles (1001)
MATVEC_SHAPES = [(nvar, W, N) for nvar in (1, 2, 3) for W in (3, 5, 7)
                 for N in (7, 64, 1000)] + [(4, 3, 1000), (2, 9, 999), (1, 5, 1001)]


def offset_view(a):
    """``a`` as a contiguous view one element into a larger buffer: no
    row of it starts on a 16-byte boundary."""
    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    view = buf[1:].view(a.shape)
    view.copy_(a)
    return view


def check_all_matvecs(device, dtype, results=None, seed=0):
    """K7 at every ``MATVEC_SHAPES`` shape, edge and periodic, for one grid
    (a number scale) and B = 4 members (a number and a per-member scale);
    at N = 1000 also on bands and v one element off a 16-byte boundary."""
    results = {} if results is None else results
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    for nvar, W, N in MATVEC_SHAPES:
        for lead in ((), (BATCH,)):
            bands = t(rng.standard_normal((*lead, W, nvar, nvar, N)))
            v = t(rng.standard_normal((*lead, nvar, N)))
            scales = [0.3] + ([t(rng.standard_normal(BATCH))] if lead else [])
            for periodic in (True, False):
                for scale in scales:
                    check_matvec(bands, v, periodic, scale, results)
            if N == 1000:
                check_matvec(offset_view(bands), offset_view(v), True, scales[-1],
                             results, "unaligned")
    return results


#: K8's limit in units of its terms (the module doc)
MIXED_TERMS_TOL = 1e-13


def check_mixed_residual(bands, k, rhs, coef, periodic, results=None,
                         what=""):
    """K8 against its plain version on the same float64 operands: every
    entry within one float32 ulp of the plain |r| plus ``MIXED_TERMS_TOL``
    of its terms.  Records the largest absolute gap."""
    results = {} if results is None else results
    got = mixed.mixed_residual(bands, k, rhs, coef, periodic)
    want = mixed.mixed_residual_plain(bands, k, rhs, coef, periodic)
    c = coef.abs() if isinstance(coef, torch.Tensor) else abs(coef)
    terms = (matvec.banded_matvec_plain(bands.abs(), k.abs(), periodic, c)
             + rhs.abs() + k.abs())
    mag = want.abs()
    ulp = (torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag)
    gap = (got.double() - want.double()).abs()
    ratio = float((gap / (ulp.double() + MIXED_TERMS_TOL * terms)).max()) \
        if gap.numel() else 0.0
    kind = "per-member" if isinstance(coef, torch.Tensor) else "number"
    if got.dtype != torch.float32 or not ratio <= 1.0:
        raise CheckFailed(f"K8.residual bands {tuple(bands.shape)} periodic="
                          f"{periodic} coef {kind} {what}: {ratio:.3e} of the "
                          "limit")
    results["K8.residual"] = max(results.get("K8.residual", 0.0),
                                 float(gap.max()) if gap.numel() else 0.0)
    return results


def check_all_mixed_residuals(device, results=None, seed=0):
    """K8 at every ``MATVEC_SHAPES`` shape, edge and periodic, for one grid
    (a number coef) and B = 4 members (a number and a per-member coef)."""
    results = {} if results is None else results
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=torch.float64, device=device)

    for nvar, W, N in MATVEC_SHAPES:
        for lead in ((), (BATCH,)):
            bands = t(rng.standard_normal((*lead, W, nvar, nvar, N)))
            k, rhs = (t(rng.standard_normal((*lead, nvar, N))) for _ in range(2))
            coefs = [0.3] + ([t(rng.standard_normal(BATCH))] if lead else [])
            for periodic in (True, False):
                for coef in coefs:
                    check_mixed_residual(bands, k, rhs, coef, periodic, results)
    return results


def solver_entry(name, s):
    """The name a K2-K4 entry's check records at block size s: the wide
    libraries' launches count apart (``thomas.pick``), and so do their
    errors."""
    return f"{name}_wide" if s > thomas.NARROW_S else name


def factor_entry(s, C):
    """The name K4's factor records at block size s on C chunks: its wide
    entry, the one block per member (``pcr.factor_route``) or the narrow
    grid's."""
    if pcr.factor_route(2 * s, C) == "members":
        return "K4.pcr_factor_members"
    return solver_entry("K4.pcr_factor", s)


def check_solver(bands, alpha, beta, periodic, seed=0, results=None,
                 plan=None):
    """K2, K4 (factor; the R-column solve; on a Woodbury plan the closure's
    set-up; solve with shifts) and K3 (sweep, correction) against their
    plain versions on the same inputs, then the kernels' whole solve by its
    residual.  ``bands`` are J's bands on the card.  On a padded plan the
    pieces work on the padded system (``chunked.padded_system``: the
    kernels' inputs on that plan), the solve on the grid's own."""
    results = {} if results is None else results
    W, nvar, _, N = bands.shape
    dtype, device = bands.dtype, bands.device
    tol = TOL[dtype]["solve"]
    if plan is None:
        plan = chunked.make_plan(N, nvar, W // 2, periodic)
    what = (f"N={N} s={plan.s} C={plan.C} Mc={plan.Mc} cyclic={plan.cyclic} "
            f"woodbury={plan.woodbury} Np={plan.Np} ring={plan.ring}")

    def n(name):
        return solver_entry(name, plan.s)

    rng = np.random.default_rng(seed)
    Np = plan.Np
    rhs = torch.tensor(rng.standard_normal((nvar, N)), dtype=dtype, device=device)
    add = torch.tensor(rng.standard_normal((nvar, Np)), dtype=dtype, device=device)
    rhs_p = torch.nn.functional.pad(rhs, (0, Np - N))
    A_p, a_p, b_p = bands, alpha, beta
    if plan.padded or plan.ring:
        A_p, _ = chunked.padded_system(alpha, beta, bands, plan)
        a_p, b_p = 0.0, 1.0

    sp_k = thomas.spike_factor(A_p, a_p, b_p, plan)
    sp_p = thomas.spike_factor_plain(A_p, a_p, b_p, plan)
    for got, want in zip(sp_k, sp_p):
        _record(results, n("K2.spike_factor"), got, want, tol, what)

    red_k = pcr.pcr_factor(sp_p.Lred, sp_p.Ured, plan.cyclic)
    red_p = pcr.pcr_factor_plain(sp_p.Lred, sp_p.Ured, plan.cyclic)
    for got, want in zip(red_k, red_p):
        _record(results, factor_entry(plan.s, plan.C), got, want, tol, what)
    wood = ()
    if plan.woodbury:
        # the acyclic factor of the ring's reduced system ignores its
        # corner blocks: held against the plain factor with them masked
        Lm, Um = sp_p.Lred.clone(), sp_p.Ured.clone()
        Lm[..., 0] = 0.0
        Um[..., -1] = 0.0
        for got, want in zip(red_k, pcr.pcr_factor_plain(Lm, Um, False)):
            _record(results, factor_entry(plan.s, plan.C), got, want, tol, f"masked {what}")
        wood = pcr.woodbury_plain(red_p, sp_p.Lred, sp_p.Ured)
        for got, want in zip(pcr.woodbury(red_p, sp_p.Lred, sp_p.Ured), wood):
            _record(results, n("K4.pcr_solve"), got, want, tol, f"woodbury {what}")
    cols = torch.tensor(rng.standard_normal((2 * plan.s, 2 * plan.s, plan.C)),
                        dtype=dtype, device=device)
    _record(results, n("K4.pcr_solve"), pcr.pcr_solve(red_p, cols),
            pcr.pcr_solve_plain(red_p, cols), tol, f"R={2 * plan.s} {what}")

    y_k, yred_k = thomas.thomas_sweep(sp_p, rhs_p, plan)
    y_p, yred_p = thomas.thomas_sweep_plain(sp_p, rhs_p, plan)
    _record(results, n("K3.thomas_sweep"), y_k, y_p, tol, what)
    _record(results, n("K3.thomas_sweep"), yred_k, yred_p, tol, what)

    sh_k = pcr.pcr_solve_shift(red_p, yred_p, plan.wrap, *wood)
    sh_p = pcr.pcr_solve_shift_plain(red_p, yred_p, plan.wrap, *wood)
    for got, want in zip(sh_k, sh_p):
        _record(results, n("K4.pcr_solve_shift"), got, want, tol, what)

    # the kernel takes contiguous arrays, as K3's sweep writes y (the plain
    # sweep's y is a view where C = 1)
    x_k = thomas.spike_correct(sp_p, y_p.contiguous(), *sh_p, plan, add_to=add)
    x_p = thomas.spike_correct_plain(sp_p, y_p, *sh_p, plan, add_to=add)
    _record(results, n("K3.spike_correct"), x_k, x_p, tol, what)

    x = chunked.factor(alpha, beta, bands, periodic, plan).solve(rhs)
    A = torch.zeros_like(bands).double()
    A += beta * bands.double()
    A[W // 2, torch.arange(nvar), torch.arange(nvar)] += alpha
    resid = (matvec.banded_matvec_plain(A, x.double(), periodic)
             - rhs.double())
    res = float(resid.norm() / rhs.double().norm())
    if not res <= tol:
        raise CheckFailed(f"solve residual {res:.3e} > {tol:.0e} ({what})")
    results["residual"] = max(results.get("residual", 0.0), res)
    return results


def mega_state(model, N, periodic, device, seed=0):
    """(u, helpers, pstack, x) of the K6 checks, as the parity tests make
    them: the README grid and parameters, KS on [0, 32 pi) with noise, and
    the two-variable model of the reference's megastep tests.  A ``seed``
    above 0 draws other noise (and adds noise of 1e-2 to the README's
    state)."""
    b = model.backend
    sysm = b.system

    def t(a):
        return torch.tensor(np.asarray(a), dtype=b.dtype, device=device)

    if sysm.pars:  # the README model
        x = np.linspace(0, 1, N)
        u = np.cos(2 * np.pi * x * 5)[None]
        if seed:
            u = u + 1e-2 * np.random.default_rng(seed).standard_normal(N)
        pars = np.array([[1e-3], [3e-3]]) * np.ones((1, N))
    elif sysm.nvar == 1:  # KS
        x = np.linspace(0, 32 * np.pi, N, endpoint=False)
        u = (np.cos(x / 16) + 0.1 * np.random.default_rng(seed).standard_normal(N))[None]
        pars = np.zeros((0, N))
    else:
        rng = np.random.RandomState(3 + seed)
        i = np.arange(N)
        x = 0.5 * i
        u = np.stack([1.2 + 0.1 * np.cos(2 * np.pi * i / N * 5 + k)
                      + 0.01 * rng.randn(N) for k in range(sysm.nvar)])
        pars = np.zeros((0, N))
    return t(u), t(np.zeros((len(sysm.help_funcs), N))), t(pars), t(x)


def rodaspr_table(with_err=True):
    """K6's table of RODASPR (the default scheme), from its coefficients."""
    from ..core.rosenbrock import rodaspr_coefficients, transformed

    alpha, gamma, b, b_pred = rodaspr_coefficients()
    return megastep.row_table(*transformed(alpha, gamma, b, b_pred),
                              gamma[0, 0], with_err)


def _adaptive(fn, model, plan, periodic, args, adaptive, table):
    """``fn`` (K6's adaptive entry or its plain version) on one output step
    of RODASPR from t = 0: (u, dt_i, niter, status)."""
    from ..core.rosenbrock import adaptive_controller

    out_dt, internal_dt, atol = adaptive
    return fn(adaptive_controller, model.backend, plan, table, periodic, *args,
              0.0, out_dt, internal_dt, atol, 0.9, None, None)


def _dt_gap(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


def check_megastep(model, N, periodic, dt, device, results=None,
                   adaptive=None, state=None):
    """K6's step entry (RODASPR, Theta at theta = 1 and 0.5) and its
    3-step launch against the plain versions; with ``adaptive = (output
    dt, internal dt, tol)`` its adaptive entry against the plain
    controller.  ``dt`` is the fixed steps' dt; ``state`` (u, helpers,
    pstack, x) defaults to ``mega_state``."""
    results = {} if results is None else results
    b = model.backend
    dtype = b.dtype
    T = np.float64 if dtype == torch.float64 else np.float32
    sysm = b.system
    plan = megastep.make_plan(N, sysm.nvar, sysm.halo, periodic)
    what = (f"N={N} s={plan.s} C={plan.C} Mc={plan.Mc} cyclic={plan.cyclic} "
            f"woodbury={plan.woodbury} {dtype}")
    tol = TOL[dtype]["solve"]
    args = mega_state(model, N, periodic, device) if state is None else state
    ros = rodaspr_table()
    gdt = float(T(ros.g00) * T(dt))
    dt = float(T(dt))
    cases = [("rodaspr", ros, -gdt, gdt),
             ("theta=1", megastep.theta_table(1.0), -dt, dt),
             ("theta=0.5", megastep.theta_table(0.5), -0.5 * dt, dt)]
    for name, table, beta, scale in cases:
        u_k, err_k = megastep.step(b, plan, table, periodic, *args, beta, scale)
        u_p, err_p = megastep.step_plain(b, plan, table, periodic, *args, beta,
                                         scale)
        _record(results, "K6.step", u_k, u_p, tol, f"{name} {what}")
        if len(table.final) == 2:
            _record(results, "K6.step", err_k, err_p, tol, f"{name} err {what}",
                    scale=float(u_p.abs().max()))
        u3 = megastep.step(b, plan, table, periodic, *args, beta, scale, nsteps=3)[0]
        seq = args[0]
        for _ in range(3):
            seq = megastep.step(b, plan, table, periodic, seq, *args[1:], beta,
                                scale)[0]
        if not torch.equal(u3, seq):
            raise CheckFailed(f"K6.step {name} {what}: 3 steps in one launch differ "
                              "from 3 launches")
        want3 = megastep.scan_plain(b, plan, table, periodic, *args, beta, scale, 3)
        _record(results, "K6.step", u3, want3, tol, f"{name} 3 steps {what}")
        # the same launch writing each step into its snapshot slot
        snap = torch.empty((3,) + tuple(args[0].shape), dtype=dtype, device=device)
        megastep.step(b, plan, table, periodic, *args, beta, scale, nsteps=3, snap=snap)
        seq = args[0]
        for k in range(3):
            seq = megastep.step(b, plan, table, periodic, seq, *args[1:], beta,
                                scale)[0]
            if not torch.equal(snap[k], seq):
                raise CheckFailed(f"K6.step {name} {what}: snapshot {k} of a 3-step "
                                  "launch differs from its step launched alone")
    if adaptive is not None:
        check_snapshots(model, plan, periodic, args, adaptive, ros, results, what)
        got, want = (_adaptive(fn, model, plan, periodic, args, adaptive, ros)
                     for fn in (megastep.row_adaptive_step,
                                megastep.adaptive_plain))
        if got[2:] != want[2:]:
            raise CheckFailed(f"K6.adaptive {what}: (attempts, status) {got[2:]} "
                              f"against the plain controller's {want[2:]}")
        _record(results, "K6.adaptive", got[0], want[0], tol, f"u {what}")
        gap = _dt_gap(got[1], want[1])
        if not gap <= TOL[dtype]["dt"]:
            raise CheckFailed(f"K6.adaptive dt_i {what}: relative error {gap:.3e} "
                              f"> {TOL[dtype]['dt']:.0e}")
        results["K6.adaptive dt_i"] = max(results.get("K6.adaptive dt_i", 0.0), gap)
        results["K6.adaptive attempts"] = got[2]
    return results


def check_snapshots(model, plan, periodic, args, adaptive, table, results, what,
                    nsteps=3):
    """K6's adaptive scan of one grid with per-output-step snapshots
    (K6.adaptive_snapshots): its final state bit for bit the scan's
    without snapshots, its last snapshot that state, and each snapshot's
    state, time, attempts and status against the plain version's (the
    states within the solver tolerance, dt_i within the dt limit)."""
    from ..core.rosenbrock import adaptive_controller

    dtype = model.backend.dtype
    tol = TOL[dtype]["solve"]
    out_dt, internal_dt, atol = adaptive
    a_args = (adaptive_controller, model.backend, plan, table, periodic, *args, 0.0,
              out_dt, internal_dt, atol, 0.9, None, None, nsteps)
    bare = megastep.adaptive_scan(*a_args)
    got = megastep.adaptive_scan(*a_args, snapshots=True)
    # the plain version on the same tensors (on the card: torch operations
    # on CUDA tensors)
    want_snap = (torch.zeros_like(got[-1][0]), np.zeros_like(got[-1][1]))
    megastep.adaptive_scan_plain(*a_args, snap=want_snap)
    want = (None, want_snap)
    states, rows = got[-1]
    if not (torch.equal(got[0], bare[0]) and got[1:4] == bare[1:4]):
        raise CheckFailed(f"K6.adaptive_snapshots {what}: the final state or the "
                          "controller differs from the scan without snapshots")
    if not torch.equal(states[got[1] - 1], got[0]):
        raise CheckFailed(f"K6.adaptive_snapshots {what}: the last snapshot is not "
                          "the final state")
    w_states, w_rows = want[-1]
    if not (np.array_equal(rows[:, 2:], w_rows[:, 2:])
            and np.array_equal(rows[:, 0], w_rows[:, 0])):
        raise CheckFailed(f"K6.adaptive_snapshots {what}: (t_i, attempts, status) "
                          f"{rows[:, [0, 2, 3]].tolist()} against the plain "
                          f"version's {w_rows[:, [0, 2, 3]].tolist()}")
    gap = float(np.max(np.abs(rows[:, 1] - w_rows[:, 1]) / np.abs(w_rows[:, 1])))
    if not gap <= TOL[dtype]["dt"]:
        raise CheckFailed(f"K6.adaptive_snapshots dt_i {what}: relative error "
                          f"{gap:.3e} > {TOL[dtype]['dt']:.0e}")
    for k in range(got[1]):
        _record(results, "K6.adaptive_snapshots", states[k], w_states[k].to(states),
                tol, f"output step {k} {what}")
    return results


def check_megastep_mixed(model, N, periodic, dt, device, results=None,
                         state=None, passes=(1, 2)):
    """K6's mixed entry (RODASPR and Theta at theta = 1, each residual
    pass count of ``passes``) and its 3-step launch against the plain
    version, on a float64 model: u and err within the solver tolerance,
    three steps in one launch bit for bit equal to three launches.
    ``state`` (u, helpers, pstack, x) defaults to ``mega_state``."""
    results = {} if results is None else results
    b = model.backend
    sysm = b.system
    plan = megastep.make_plan(N, sysm.nvar, sysm.halo, periodic)
    what = (f"N={N} s={plan.s} C={plan.C} Mc={plan.Mc} cyclic={plan.cyclic} "
            f"woodbury={plan.woodbury}")
    tol = TOL[torch.float64]["solve"]
    args = mega_state(model, N, periodic, device) if state is None else state
    ros = rodaspr_table()
    dt = float(np.float32(dt))
    gdt = ros.g00 * dt
    for n in passes:
        for name, table, beta, scale in (
                ("rodaspr", ros, -gdt, gdt),
                ("theta=1", megastep.theta_table(1.0), -dt, dt)):
            u_k, err_k = megastep.step_mixed(b, plan, table, periodic, *args,
                                             beta, scale, n)
            u_p, err_p = megastep.step_plain(b, plan, table, periodic, *args,
                                             beta, scale, n)
            u_f = megastep.step_plain(b, plan, table, periodic, *args, beta,
                                      scale)[0]
            # the limit: the solver tolerance, or twice the mixed solve's
            # residue (module doc)
            lim = max(tol, 2.0 * _err(u_p, u_f)[1])
            tag = f"{name} passes={n} {what}"
            _record(results, "K6.step_mixed", u_k, u_p, lim, tag)
            if len(table.final) == 2:
                _record(results, "K6.step_mixed", err_k, err_p, lim,
                        f"err {tag}", scale=float(u_p.abs().max()))
            u3 = megastep.step_mixed(b, plan, table, periodic, *args, beta,
                                     scale, n, nsteps=3)[0]
            seq = args[0]
            for _ in range(3):
                seq = megastep.step_mixed(b, plan, table, periodic, seq,
                                          *args[1:], beta, scale, n)[0]
            if not torch.equal(u3, seq):
                raise CheckFailed(f"K6.step_mixed {tag}: 3 steps in one launch "
                                  "differ from 3 launches")
            want3 = megastep.scan_plain(b, plan, table, periodic, *args, beta,
                                        scale, 3, n)
            full3 = megastep.scan_plain(b, plan, table, periodic, *args, beta,
                                        scale, 3)
            _record(results, "K6.step_mixed", u3, want3,
                    max(tol, 2.0 * _err(want3, full3)[1]), f"3 steps {tag}")
    return results


#: (model, N, periodic, dt) of the mixed entry's checks: s = 1, 2, 4, edge,
#: block-cyclic and Woodbury rings
MIXED_CASES = [("readme", 200, False, 5.0), ("ks", 256, True, 0.0625),
               ("ks", 200, True, 0.0625), ("two_var", 512, True, 0.02)]


def check_all_mixed(device, results=None):
    """K8 at the small shapes and K6's mixed entry at ``MIXED_CASES``, on
    df64 models (float64)."""
    from ..core.model import Model

    results = {} if results is None else results
    check_all_mixed_residuals(device, results)
    for name, N, periodic, dt in MIXED_CASES:
        model = Model(*MEGA_MODELS[name], double="df64", device=device)
        check_megastep_mixed(model, N, periodic, dt, device, results)
    return results


def adaptive_dt_readings(device, dtype, seeds=range(8)):
    """The readings behind the adapted dt's tolerance: for each seed of the
    state (README N = 200 and KS N = 256, the adaptive cases below), the
    relative dt_i gap of K6's adaptive entry to its plain version, and the
    gap a wrong err gives (the plain step with its error row doubled,
    against the plain step).  Returns {case: [(seed, kernel gap, attempts
    equal, wrong-err gap, attempts equal), ...]}."""
    from ..core.model import Model

    out = {}
    for name, N, periodic, _, adaptive in MEGA_CASES:
        if adaptive is None:
            continue
        model = Model(*MEGA_MODELS[name], double=dtype == torch.float64,
                      device=device)
        sysm = model.system
        plan = megastep.make_plan(N, sysm.nvar, sysm.halo, periodic)
        table = rodaspr_table()
        wrong = table._replace(final=(table.final[0],
                                      tuple(2.0 * c for c in table.final[1])))
        rows = []
        for seed in seeds:
            args = mega_state(model, N, periodic, device, seed)
            got, want, bad = (_adaptive(fn, model, plan, periodic, args, adaptive, tb)
                              for fn, tb in ((megastep.row_adaptive_step, table),
                                             (megastep.adaptive_plain, table),
                                             (megastep.adaptive_plain, wrong)))
            rows.append((seed, _dt_gap(got[1], want[1]), got[2:] == want[2:],
                         _dt_gap(bad[1], want[1]), bad[2:] == want[2:]))
        out[f"{name} N={N}"] = rows
    return out


#: (model, N, periodic, fixed dt, adaptive (output dt, internal dt, tol) or
#: None): the test shapes, s = 1, 2 and 4, and rings closed block-cyclic
#: (KS N = 256, the two-variable N = 512) and by the Woodbury correction
#: (C = 250, 25 and 15 chunks)
MEGA_CASES = [("readme", 200, False, 5.0, (5.0, 1e-6, 1e-1)),
              ("ks", 256, True, 0.05, (1.0, 1e-6, 1e-3)),
              ("two_var", 512, True, 0.02, None),
              ("two_var", 512, False, 0.02, None),
              ("readme", 1000, True, 0.5, None),
              ("ks", 200, True, 0.05, None),
              ("two_var", 600, True, 0.02, None)]


def check_all_megasteps(device, dtype, results=None):
    from ..core.model import Model

    results = {} if results is None else results
    for name, N, periodic, dt, adaptive in MEGA_CASES:
        model = Model(*MEGA_MODELS[name], double=dtype == torch.float64,
                      device=device)
        check_megastep(model, N, periodic, dt, device, results, adaptive)
    return results


#: (model, N, periodic, chunk count, fixed dt, adaptive (output dt,
#: internal dt, tol) or None) of K6's cluster checks: every cluster size
#: on a plan each can hold (chunk counts not divisible by K where K = 16
#: still gives every CTA a chunk): an edge grid (s = 1, C = 125), rings
#: block-cyclic (KS, C = 64 with the adaptive case of MEGA_CASES, C = 128)
#: and one closed by the Woodbury correction (KS, C = 125), s = 4 on a
#: Woodbury ring (C = 200) and an edge grid (C = 128); KS at 2 to 4 rows a
#: chunk and at N = 500, 512 a dt of 0.005, where float32 resolves a step
#: well inside the solver tolerance (KS at N = 2048 and dt 0.05 rounds
#: by 1.5e-3 on the card, plain against plain float64; N = 500 at 0.05
#: by 1.3e-4, kernel against plain)
CLUSTER_CASES = [("readme", 1000, False, 125, 0.5, (0.5, 1e-6, 1e-1)),
                 ("ks", 256, True, 64, 0.05, (1.0, 1e-6, 1e-3)),
                 ("ks", 512, True, 128, 0.005, None),
                 ("ks", 500, True, 125, 0.005, None),
                 ("two_var", 1200, True, 200, 0.02, None),
                 ("two_var", 1024, False, 128, 0.02, None)]
#: K6's cluster checks of B members (the step on a Woodbury ring, the step
#: and the adaptive scan with a shared dt and per member on the adaptive
#: case of BATCH_MEGA_CASES), and of the mixed entry
CLUSTER_MEMBER_CASES = [("ks", 500, True, 125, 0.005, None),
                        ("ks", 256, True, 64, 0.05, (1.0, 1e-6, 1e-3))]
CLUSTER_MIXED_CASES = [("ks", 512, True, 128, 0.0625), ("ks", 500, True, 125, 0.0625),
                       ("two_var", 1200, True, 200, 0.02)]


def _same(outs, what):
    """Raise unless every output of ``outs`` ({cluster size: tuple of
    tensors or numbers}) equals the first's bit for bit."""
    ks = sorted(outs)
    first = outs[ks[0]]
    for k in ks[1:]:
        for a, b in zip(first, outs[k]):
            same = (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else np.array_equal(np.asarray(a), np.asarray(b)))
            if not same:
                raise CheckFailed(f"{what}: K = {k} differs from K = {ks[0]}")


def check_clusters(device, dtype, results=None, sizes=None, B=None, skipped=None):
    """K6 on every cluster size of ``sizes`` (``megastep.CLUSTER_SIZES``)
    that holds each of ``CLUSTER_CASES`` (a size that cannot is skipped
    and listed): the step entry (RODASPR, Theta) and its 3-step launch,
    the adaptive entry, B members' step and adaptive scans (a shared dt
    and per member) and, in float64, the mixed entry; each against its
    plain version within the solver tolerance, the adaptive ones with
    equal attempts; every cluster size's outputs of every entry bit for
    bit equal to the others' (only where the working set lives changes
    with K), and the adaptive entry's first attempt, accepted, bit for bit
    the step entry's step.
    Returns {kernel entry: max abs error}; the sizes that hold no member
    are appended to ``skipped``."""
    from ..core.model import Model
    from ..core.rosenbrock import adaptive_controller, member_controller

    results = {} if results is None else results
    skipped = [] if skipped is None else skipped
    sizes = megastep.CLUSTER_SIZES if sizes is None else sizes
    B = BATCH if B is None else B
    T = np.float64 if dtype == torch.float64 else np.float32
    tol = TOL[dtype]["solve"]
    ros = rodaspr_table()

    def clusters(plan, n_stages, mixed=False):
        out = {}
        for K in sizes:
            try:
                out[K] = megastep.cluster_plan(plan, n_stages, torch.float64 if mixed
                                               else dtype, plan.B, mixed, K=K)
            except ValueError:
                skipped.append(f"K={K} N={plan.N} C={plan.C} s={plan.s} B={plan.B}"
                               f"{' mixed' if mixed else ''} {dtype}")
        return out

    for name, N, periodic, C, dt, adaptive in CLUSTER_CASES:
        model = Model(*MEGA_MODELS[name], double=dtype == torch.float64, device=device)
        b = model.backend
        sysm = b.system
        plan = chunked.plan_with(N, sysm.nvar, sysm.halo, periodic, C)
        what = f"N={N} s={plan.s} C={C} woodbury={plan.woodbury} {dtype}"
        args = mega_state(model, N, periodic, device)
        gdt = float(T(ros.g00) * T(dt))
        for tname, table, beta, scale in (("rodaspr", ros, -gdt, gdt),
                                          ("theta=1", megastep.theta_table(1.0),
                                           -float(T(dt)), float(T(dt)))):
            want = megastep.step_plain(b, plan, table, periodic, *args, beta, scale)
            want3 = megastep.scan_plain(b, plan, table, periodic, *args, beta, scale, 3)
            outs = {}
            for K, cp in clusters(plan, len(table.stages)).items():
                got = megastep.step(b, plan, table, periodic, *args, beta, scale,
                                    cluster=cp)
                got3 = megastep.step(b, plan, table, periodic, *args, beta, scale, 3,
                                     cluster=cp)[0]
                _record(results, "K6.step", got[0], want[0], tol, f"{tname} K={K} {what}")
                _record(results, "K6.step", got3, want3, tol,
                        f"{tname} 3 steps K={K} {what}")
                outs[K] = (got[0], got[1], got3)
            _same(outs, f"K6.step {tname} {what}")
        if adaptive is not None:
            out_dt, internal_dt, atol = adaptive
            a_args = (adaptive_controller, b, plan, ros, periodic, *args, 0.0, out_dt,
                      internal_dt, atol, 0.9, None, None)
            want = megastep.adaptive_plain(*a_args)
            outs = {}
            for K, cp in clusters(plan, len(ros.stages)).items():
                got = megastep.row_adaptive_step(*a_args, cluster=cp)
                if got[2:] != want[2:]:
                    raise CheckFailed(f"K6.adaptive K={K} {what}: (attempts, status) "
                                      f"{got[2:]} against the plain {want[2:]}")
                _record(results, "K6.adaptive", got[0], want[0], tol, f"K={K} {what}")
                if not _dt_gap(got[1], want[1]) <= TOL[dtype]["dt"]:
                    raise CheckFailed(f"K6.adaptive dt_i K={K} {what}")
                outs[K] = got
            _same(outs, f"K6.adaptive {what}")
            # the first attempt at the fixed dt, accepted (tol huge), is one
            # step of the step entry's arithmetic, bit for bit
            for K, cp in clusters(plan, len(ros.stages)).items():
                got = megastep.row_adaptive_step(
                    adaptive_controller, b, plan, ros, periodic, *args, 0.0, float(T(dt)),
                    float(T(dt)), 1e30, 0.9, None, None, cluster=cp)
                want = megastep.step(b, plan, ros, periodic, *args, -gdt, gdt, cluster=cp)[0]
                if got[2] != 1 or not torch.equal(got[0], want):
                    raise CheckFailed(f"K6.adaptive K={K} {what}: the first attempt accepted "
                                      "is not bit for bit the step entry's step")
    for name, N, periodic, C, dt, adaptive in CLUSTER_MEMBER_CASES:
        model = Model(*MEGA_MODELS[name], double=dtype == torch.float64, device=device)
        b = model.backend
        sysm = b.system
        plan = chunked.plan_with(N, sysm.nvar, sysm.halo, periodic, C, B)
        what = f"B={B} N={N} C={C} {dtype}"
        args = mega_members(model, N, periodic, device, B)
        dts = np.asarray(dt * (1.0 + 0.25 * np.arange(B)), dtype=T)
        gdt_b = megastep.gdt_of(T, ros.g00, dts, device)
        want = megastep.step_plain(b, plan, ros, periodic, *args, -gdt_b, gdt_b)
        outs = {}
        for K, cp in clusters(plan, len(ros.stages)).items():
            got = megastep.step(b, plan, ros, periodic, *args, -gdt_b, gdt_b, cluster=cp)
            _record(results, "K6.step", got[0], want[0], tol, f"K={K} {what}")
            outs[K] = got
        _same(outs, f"K6.step {what}")
        if adaptive is None:
            continue
        out_dt, internal_dt, atol = adaptive
        for per_member, ctl in ((False, adaptive_controller), (True, member_controller)):
            mode = "per-member" if per_member else "shared"
            a_args = (ctl, b, plan, ros, periodic, *args, 0.0, out_dt, internal_dt, atol,
                      0.9, None, None)
            plain = megastep.adaptive_scan_plain(*a_args, 2, per_member=per_member)
            outs = {}
            for K, cp in clusters(plan, len(ros.stages)).items():
                got = megastep.adaptive_scan(*a_args, 2, per_member=per_member,
                                             attempts=True, cluster=cp)
                _record(results, "K6.adaptive_scan", got[0], plain[0], tol,
                        f"{mode} K={K} {what}")
                if not np.array_equal(got[4], plain[4]):
                    raise CheckFailed(f"K6.adaptive_scan {mode} K={K} {what}: attempts "
                                      f"{got[4]} against the plain {plain[4]}")
                outs[K] = (got[0], got[2], got[4], got[3], got[1])
            _same(outs, f"K6.adaptive_scan {mode} {what}")
    if dtype != torch.float64:
        return results
    for name, N, periodic, C, dt in CLUSTER_MIXED_CASES:
        model = Model(*MEGA_MODELS[name], double="df64", device=device)
        b = model.backend
        sysm = b.system
        plan = chunked.plan_with(N, sysm.nvar, sysm.halo, periodic, C)
        what = f"mixed N={N} s={plan.s} C={C}"
        args = mega_state(model, N, periodic, device)
        dt = float(np.float32(dt))
        gdt = ros.g00 * dt
        want = megastep.step_plain(b, plan, ros, periodic, *args, -gdt, gdt, 1)
        outs = {}
        for K, cp in clusters(plan, len(ros.stages), mixed=True).items():
            got = megastep.step_mixed(b, plan, ros, periodic, *args, -gdt, gdt, 1,
                                      cluster=cp)
            _record(results, "K6.step_mixed", got[0], want[0], tol, f"K={K} {what}")
            outs[K] = got
        _same(outs, f"K6.step_mixed {what}")
    return results


def megatheta_state(model, N, device, seed=0):
    """(u, helpers, pstack, x) of the K9 checks: the reference benchmark's
    Burgers grid (x = 0.5 i, cos(8 pi i / N), nu = 0.5; KS takes the same
    x and u) with noise of 0.05 from ``seed``."""
    b = model.backend
    sysm = b.system
    i = np.arange(N)
    u = (np.cos(2 * np.pi * i / N * 4)
         + 0.05 * np.random.default_rng(seed).standard_normal(N))[None]

    def t(a):
        return torch.tensor(np.asarray(a), dtype=b.dtype, device=device)

    return (t(u), t(np.zeros((len(sysm.help_funcs), N))),
            t(np.full((len(sysm.pars), N), 0.5)), t(0.5 * i))


def check_megatheta(model, N, dt, theta, device, results=None, plan=None):
    """K9's interface and correct entries and its whole step (with K4)
    against their plain versions, and its plain step against the plain
    K1-K4 step, on ``plan`` (default ``megatheta.plan_for``) of a periodic
    grid at ``megatheta_state``; the steps are held on the increment they
    make (``increment_error``)."""
    results = {} if results is None else results
    b = model.backend
    sysm = b.system
    tol = TOL[b.dtype]["solve"]
    if plan is None:
        plan = megatheta.plan_for(N, sysm.nvar, sysm.halo)
    what = (f"N={N} s={plan.s} C={plan.C} Mc={plan.Mc} cyclic={plan.cyclic} "
            f"woodbury={plan.woodbury} theta={theta} {b.dtype}")
    args = megatheta_state(model, N, device)
    u = args[0]
    beta, dts = megatheta.scalars(b.dtype, theta, dt)
    got = megatheta.interface(b, plan, *args, beta, dts)
    want = megatheta.interface_plain(b, plan, *args, beta, dts)
    for g, w in zip(got, want):
        _record(results, "K9.interface", g, w, tol, what)
    Lred, Ured, yred = want
    red = pcr.pcr_factor_plain(Lred, Ured, plan.cyclic)
    wood = pcr.woodbury_plain(red, Lred, Ured) if plan.woodbury else ()
    shifts = pcr.pcr_solve_shift_plain(red, yred, plan.wrap, *wood)
    _record_step(results, "K9.correct",
                 megatheta.correct(b, plan, *args, beta, dts, *shifts),
                 megatheta.correct_plain(b, plan, *args, beta, dts, *shifts), u,
                 tol, what)
    plain = megatheta.step_plain(b, plan, theta, *args, dt)
    _record_step(results, "K9 step", megatheta.theta_step(b, plan, theta, *args, dt),
                 plain, u, tol, what)
    # the K1-K4 route's plain step on the same plan
    solve = megastep._plain_solver(b.J_bands_impl(*args, periodic=True), beta,
                                   plan, True, None)
    _record_step(results, "K9 plain step against K1-K4's", plain,
                 u + solve(stencil.eval_F_plain(b, *args, True, dts)), u, tol,
                 what)
    return results


#: (model, N, chunk count or None for plan_for's, dt, theta) of K9's
#: small-shape checks: block sizes 1 and 2; Woodbury (C = 2, 10, 20, 300)
#: and block-cyclic (C = 8, 64) rings; chunks that split raggedly over the
#: warp's 32 lanes (Mc = 50, 100, 500), chunks of fewer than two rows a
#: lane (Mc = 2, 32, 50), and the most rows a chunk takes at each block
#: size (``megatheta.MAX_MC``: Mc = 4096 at s = 1, 2048 at s = 2); and a
#: model whose bodies read x
MEGATHETA_CASES = [("burgers", 1000, None, 0.05, 1.0),
                   ("burgers", 4096, None, 0.05, 0.5),
                   ("burgers", 1000, 2, 0.05, 1.0),
                   ("burgers", 1000, 20, 0.05, 1.0),
                   ("burgers", 800, 8, 0.05, 1.0),
                   ("burgers", 2048, 2, 0.05, 1.0),
                   ("burgers", 8192, 2, 0.05, 1.0),
                   ("ks", 1200, 300, 0.05, 1.0),
                   ("ks", 4096, None, 0.05, 1.0),
                   ("ks", 4096, 64, 0.05, 1.0),
                   ("ks", 2000, 10, 0.05, 1.0),
                   ("ks", 4096, 2, 0.01, 0.5),
                   ("ks", 8192, 2, 0.01, 0.5),
                   ("forced", 1200, 4, 0.05, 1.0)]
#: the K9 checks' models: K1's, and Burgers forced by sin(x), whose bodies
#: read x (K9 stages x only for such a model: ``TF_USES_X``)
MEGATHETA_MODELS = {**STENCIL_MODELS,
                    "forced": ("-U * dxU + nu * dxxU + sin(x)", "U", ["nu"])}


def check_all_megathetas(device, dtype, results=None):
    from ..core.model import Model

    results = {} if results is None else results
    for name, N, C, dt, theta in MEGATHETA_CASES:
        model = Model(*MEGATHETA_MODELS[name], double=dtype == torch.float64,
                      device=device)
        sysm = model.system
        plan = megatheta.plan_for(N, sysm.nvar, sysm.halo, C)
        check_megatheta(model, N, dt, theta, device, results, plan)
    return results


#: (W, nvar, N, periodic): block sizes 1, 2 and 4, acyclic, and rings
#: closed block-cyclic (power-of-two plans) and by the Woodbury correction
#: (plans of 125, 4, 120 and 30 chunks)
SOLVER_CASES = [(3, 1, 4096, True), (3, 1, 4000, False), (5, 1, 4096, True),
                (5, 1, 2000, False), (3, 2, 2048, True), (3, 2, 1200, False),
                (3, 1, 1000, True), (5, 1, 200, True), (3, 2, 1200, True),
                (5, 2, 2048, True), (5, 2, 600, True), (5, 2, 1000, False)]


def run_all(device, dtypes=(torch.float64, torch.float32)):
    """Every check above at small and odd shapes, both dtypes (the df64
    mode's K8 and mixed entry with float64); returns {dtype name: {kernel
    entry: max abs error}}."""
    from ..core.model import Model

    out = {}
    for dtype in dtypes:
        results = {}
        for name, (eqs, dep, pars) in STENCIL_MODELS.items():
            model = Model(eqs, dep, pars, double=dtype == torch.float64,
                          device=device)
            for N in (1000, 4096):
                for periodic in (True, False):
                    check_stencil(model, N, periodic, device, results=results)
        for i, (W, nvar, N, periodic) in enumerate(SOLVER_CASES):
            bands = random_bands(W, nvar, N, dtype, device, seed=i)
            check_solver(bands, 1.0, -0.3, periodic, seed=i, results=results)
        check_all_combines(device, dtype, results)
        check_erk_combines((2, 777), device, dtype, results)
        check_erk_combines((2, 1000), device, dtype, results, B=4)
        check_all_matvecs(device, dtype, results)
        check_all_megasteps(device, dtype, results)
        check_all_megathetas(device, dtype, results)
        # K4's narrow factor and Woodbury set-up for an ensemble of 132
        # members at config 5's C = 100 (one block per member,
        # ``pcr.factor_route`` and ``cols_route``)
        check_grid_factor(2, 100, 132, True, dtype, device, results=results)
        check_setup(2, 100, 132, dtype, device, results=results)
        if dtype == torch.float64:
            check_all_mixed(device, results)
        out[str(dtype).replace("torch.", "")] = results
    return out


# ----------------------------------------------------------- member axis

#: the members of the batched checks
BATCH = 4


def _member_stack(fn, B):
    """Stack each component of ``fn(b)`` over the members b < B."""
    parts = [fn(b) for b in range(B)]
    return tuple(torch.stack([p[k] for p in parts])
                 for k in range(len(parts[0])))


def check_stencil_batched(model, N, periodic, device, B=BATCH, seed=0,
                          results=None):
    """K1's F (per-member scale and a bias), F_terms (RODASPR's last
    stage: six terms with unit, zero and scaled coefficients) and J on B
    members against their plain versions."""
    results = {} if results is None else results
    b = model.backend
    dtype = b.dtype
    rng = np.random.default_rng(seed)
    sysm = b.system

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    u = t(rng.standard_normal((B, sysm.nvar, N)))
    helpers = t(rng.standard_normal((B, len(sysm.help_funcs), N)))
    pstack = t(0.5 + rng.random((B, len(sysm.pars), 1)) * np.ones((1, N)))
    x = t(np.linspace(0.0, 0.001 * N, N))
    tol = TOL[dtype]["FJ"]
    what = f"B={B} N={N} periodic={periodic}"
    scale = t(0.05 * (1.0 + np.arange(B)))
    bias = t(rng.standard_normal((B, sysm.nvar, N)))
    F_k = b.F(u, helpers, pstack, x, periodic=periodic, scale=scale, bias=bias)
    F_p = stencil.eval_F_plain(b, u, helpers, pstack, x, periodic, scale, bias)
    _record(results, "K1.F", F_k, F_p, tol, f"{what} per-member scale")
    stages = [t(1e-2 * rng.standard_normal((B, sysm.nvar, N))) for _ in range(5)]
    coefs = [(1.0, 0.0), (0.75, 0.3), (0.0, -1.2), (1.0, 1.0), (2.5, 0.0),
             (-0.4, 0.7)]
    terms = [(a, c, arr) for (a, c), arr in zip(coefs, [u] + stages)]
    for sc in (0.0125, scale):
        got = b.F_terms(terms, helpers, pstack, x, periodic=periodic, scale=sc)
        want = stencil.eval_F_terms_plain(b, terms, helpers, pstack, x,
                                          periodic, sc)
        _record(results, "K1.F_terms", got, want, tol, what)
    return check_J(b, u, helpers, pstack, x, periodic, what, results)


def check_J(backend, u, helpers, pstack, x, periodic, what, results=None):
    """K1's J entry against its plain version on the given inputs ((B,)
    rows, N)."""
    results = {} if results is None else results
    J_k = backend.J_bands(u, helpers, pstack, x, periodic=periodic)
    J_p = backend.J_bands_impl(u, helpers, pstack, x, periodic=periodic)
    _record(results, "K1.J", J_k, J_p, TOL[backend.dtype]["FJ"], what)
    return results


def check_solver_pieces(bands, beta, plan, rhs, add, seed=0, results=None):
    """K2 (factor of ``I + beta*J``, beta a number or one per member), K4
    (PCR factor, the Woodbury set-up on a Woodbury plan, an R-column
    solve, the per-stage solve and shifts) and K3 (sweep of ``rhs``,
    correction added to ``add``) on J's bands ((B,) W, nvar, nvar, N)
    against their plain versions, each kernel on its plain inputs."""
    results = {} if results is None else results
    dtype, device = bands.dtype, bands.device
    tol = TOL[dtype]["solve"]
    lead = tuple(bands.shape[:-4])
    what = (f"B={plan.B} N={plan.N} s={plan.s} C={plan.C} Mc={plan.Mc} "
            f"cyclic={plan.cyclic} woodbury={plan.woodbury}")

    def n(name):
        return solver_entry(name, plan.s)

    rng = np.random.default_rng(seed)
    sp_k = thomas.spike_factor(bands, 1.0, beta, plan)
    sp_p = thomas.spike_factor_plain(bands, 1.0, beta, plan)
    for got, want in zip(sp_k, sp_p):
        _record(results, n("K2.spike_factor"), got, want, tol, what)
    red_k = pcr.pcr_factor(sp_p.Lred, sp_p.Ured, plan.cyclic)
    red_p = pcr.pcr_factor_plain(sp_p.Lred, sp_p.Ured, plan.cyclic)
    for got, want in zip(red_k, red_p):
        _record(results, factor_entry(plan.s, plan.C), got, want, tol, what)
    wood = ()
    if plan.woodbury:
        wood = pcr.woodbury_plain(red_p, sp_p.Lred, sp_p.Ured)
        for got, want in zip(pcr.woodbury(red_p, sp_p.Lred, sp_p.Ured), wood):
            _record(results, n("K4.pcr_solve"), got, want, tol, f"woodbury {what}")
    cols = torch.tensor(rng.standard_normal((*lead, 2 * plan.s, 2 * plan.s,
                                             plan.C)), dtype=dtype, device=device)
    _record(results, n("K4.pcr_solve"), pcr.pcr_solve(red_p, cols),
            pcr.pcr_solve_plain(red_p, cols), tol, f"R={2 * plan.s} {what}")
    y_k, yred_k = thomas.thomas_sweep(sp_p, rhs, plan)
    y_p, yred_p = thomas.thomas_sweep_plain(sp_p, rhs, plan)
    _record(results, n("K3.thomas_sweep"), y_k, y_p, tol, what)
    _record(results, n("K3.thomas_sweep"), yred_k, yred_p, tol, what)
    sh_k = pcr.pcr_solve_shift(red_p, yred_p, plan.wrap, *wood)
    sh_p = pcr.pcr_solve_shift_plain(red_p, yred_p, plan.wrap, *wood)
    for got, want in zip(sh_k, sh_p):
        _record(results, n("K4.pcr_solve_shift"), got, want, tol, what)
    # the kernel takes contiguous arrays, as K3's sweep writes y (the plain
    # sweep's y is a view where C = 1)
    x_k = thomas.spike_correct(sp_p, y_p.contiguous(), *sh_p, plan, add_to=add)
    x_p = thomas.spike_correct_plain(sp_p, y_p, *sh_p, plan, add_to=add)
    _record(results, n("K3.spike_correct"), x_k, x_p, tol, what)
    return results


def check_solver_batched(W, nvar, N, periodic, dtype, device, B=BATCH,
                         seed=0, results=None, C=None):
    """K2-K4 on B members of random bands, each with its own factor shift,
    against their plain versions (``check_solver_pieces``), and each
    member's solve by its residual; on ``chunked.make_plan``'s plan, or
    with C on C chunks per member."""
    results = {} if results is None else results
    tol = TOL[dtype]["solve"]
    bands = torch.stack([random_bands(W, nvar, N, dtype, device,
                                      seed=seed + b, beta=-0.2)
                         for b in range(B)])
    betas = torch.tensor(np.linspace(-0.3, -0.2, B), dtype=dtype,
                         device=device)
    plan = (chunked.make_plan(N, nvar, W // 2, periodic, B) if C is None
            else chunked.plan_with(N, nvar, W // 2, periodic, C, B))
    what = (f"B={B} N={N} s={plan.s} C={plan.C} cyclic={plan.cyclic} "
            f"woodbury={plan.woodbury}")
    rng = np.random.default_rng(seed)
    rhs = torch.tensor(rng.standard_normal((B, nvar, N)), dtype=dtype,
                       device=device)
    add = torch.tensor(rng.standard_normal((B, nvar, N)), dtype=dtype,
                       device=device)
    check_solver_pieces(bands, betas, plan, rhs, add, seed, results)
    x = chunked.factor(1.0, betas, bands, periodic, plan).solve(rhs)
    for b in range(B):
        A = float(betas[b]) * bands[b].double()
        A[W // 2, torch.arange(nvar), torch.arange(nvar)] += 1.0
        resid = (matvec.banded_matvec_plain(A, x[b].double(), periodic)
                 - rhs[b].double())
        res = float(resid.norm() / rhs[b].double().norm())
        if not res <= tol:
            raise CheckFailed(f"member {b} solve residual {res:.3e} > "
                              f"{tol:.0e} ({what})")
        results["residual"] = max(results.get("residual", 0.0), res)
    return results


def mega_members(model, N, periodic, device, B=BATCH):
    """(u, helpers, pstack, x) of B members: ``mega_state`` of seeds
    0 .. B-1, x shared."""
    u, h, p = _member_stack(
        lambda b: mega_state(model, N, periodic, device, seed=b)[:3], B)
    return u, h, p, mega_state(model, N, periodic, device)[3]


def check_megastep_batched(model, N, periodic, dt, device, results=None,
                           adaptive=None, B=BATCH):
    """K6 on B members: the step entry with a shared and with per-member
    shifts (RODASPR, Theta), its 3-step launch bit for bit against three
    launches; with ``adaptive = (output dt, internal dt, tol)`` one
    adaptive output step with a shared dt and per member (B members run
    the scan kernel) against the plain controllers (equal attempts and
    status, dt_i within the dt limit), and the adaptive scan of two output
    steps bit for bit against two one-step launches, per mode."""
    from ..core.rosenbrock import adaptive_controller, member_controller

    results = {} if results is None else results
    b = model.backend
    dtype = b.dtype
    T = np.float64 if dtype == torch.float64 else np.float32
    sysm = b.system
    plan = megastep.plan_for(N, sysm.nvar, sysm.halo, periodic, B)
    if plan is None:
        plan = megastep.make_plan(N, sysm.nvar, sysm.halo, periodic)._replace(B=B)
    what = (f"B={B} N={N} s={plan.s} C={plan.C} woodbury={plan.woodbury} "
            f"{dtype}")
    tol = TOL[dtype]["solve"]
    args = mega_members(model, N, periodic, device, B)
    ros = rodaspr_table()
    dts = np.asarray(dt * (1.0 + 0.25 * np.arange(B)), dtype=T)
    gdt_b = megastep.gdt_of(T, ros.g00, dts, device)
    cases = [("rodaspr", ros, -float(T(ros.g00) * T(dt)), float(T(ros.g00) * T(dt))),
             ("rodaspr per-member", ros, -gdt_b, gdt_b),
             ("theta=1", megastep.theta_table(1.0), -float(T(dt)), float(T(dt)))]
    for name, table, beta, scale in cases:
        u_k, err_k = megastep.step(b, plan, table, periodic, *args, beta, scale)
        u_p, err_p = megastep.step_plain(b, plan, table, periodic, *args, beta,
                                         scale)
        _record(results, "K6.step", u_k, u_p, tol, f"{name} {what}")
        if len(table.final) == 2:
            _record(results, "K6.step", err_k, err_p, tol, f"{name} err {what}",
                    scale=float(u_p.abs().max()))
        u3 = megastep.step(b, plan, table, periodic, *args, beta, scale, nsteps=3)[0]
        seq = args[0]
        for _ in range(3):
            seq = megastep.step(b, plan, table, periodic, seq, *args[1:], beta,
                                scale)[0]
        if not torch.equal(u3, seq):
            raise CheckFailed(f"K6.step {name} {what}: 3 steps in one launch "
                              "differ from 3 launches")
    if adaptive is None:
        return results
    out_dt, internal_dt, atol = adaptive
    for per_member, ctl in ((False, adaptive_controller), (True, member_controller)):
        mode = "per-member" if per_member else "shared"
        a_args = (ctl, b, plan, ros, periodic, *args, 0.0, out_dt, internal_dt,
                  atol, 0.9, None, None)
        got = megastep.row_adaptive_step(*a_args, per_member=per_member)
        want = megastep.adaptive_plain(*a_args, per_member=per_member)
        if not (np.array_equal(got[2], want[2]) and got[3] == want[3]):
            raise CheckFailed(f"K6.adaptive_scan {mode} one output step {what}: "
                              f"(attempts, status) {got[2:]} against the plain "
                              f"controller's {want[2:]}")
        _record(results, "K6.adaptive_scan", got[0], want[0], tol,
                f"u {mode} one output step {what}")
        gap = float(np.max(np.abs(np.asarray(got[1], np.float64)
                                  - np.asarray(want[1], np.float64))
                           / np.abs(np.asarray(want[1], np.float64))))
        if not gap <= TOL[dtype]["dt"]:
            raise CheckFailed(f"K6.adaptive_scan {mode} dt_i {what}: relative "
                              f"error {gap:.3e} > {TOL[dtype]['dt']:.0e}")
        results["K6.adaptive_scan dt_i"] = max(
            results.get("K6.adaptive_scan dt_i", 0.0), gap)
        # two output steps in one scan against two adaptive launches
        scan = megastep.adaptive_scan(*a_args, 2, per_member=per_member,
                                      attempts=True)
        one = megastep.row_adaptive_step(*a_args, per_member=per_member)
        two = megastep.row_adaptive_step(
            ctl, b, plan, ros, periodic, one[0], *args[1:], T(0.0) + T(out_dt),
            out_dt, one[1], atol, 0.9, None, None, per_member=per_member)
        if not (torch.equal(scan[0], two[0]) and np.array_equal(scan[2], two[1])
                and scan[1] == 2):
            raise CheckFailed(f"K6.adaptive_scan {mode} {what}: 2 output steps "
                              "in one launch differ from 2 one-step launches")
        plain = megastep.adaptive_scan_plain(*a_args, 2, per_member=per_member)
        _record(results, "K6.adaptive_scan", scan[0], plain[0], tol,
                f"{mode} {what}")
        if not np.array_equal(scan[4], plain[4]):
            raise CheckFailed(f"K6.adaptive_scan {mode} {what}: attempts "
                              f"{scan[4]} against the plain {plain[4]}")
    return results


#: (W, nvar, N, periodic) of the batched solver checks: block-cyclic and
#: Woodbury rings, s = 1, 2 (and 4), and an acyclic grid
BATCH_SOLVER_CASES = [(5, 1, 1024, True), (5, 1, 1000, True), (3, 2, 1200, True),
                      (5, 2, 600, True), (3, 1, 2000, False)]
#: (model, N, periodic, dt, adaptive) of the batched K6 checks
BATCH_MEGA_CASES = [("ks", 256, True, 0.05, (1.0, 1e-6, 1e-3)),
                    ("ks", 200, True, 0.05, (1.0, 1e-6, 1e-3)),
                    ("readme", 200, False, 5.0, (5.0, 1e-6, 1e-1)),
                    ("two_var", 600, True, 0.02, None)]


def run_batched(device, dtypes=(torch.float64, torch.float32), B=BATCH):
    """The member-axis checks at small shapes, both dtypes; returns
    {dtype name: {kernel entry: max abs error}}."""
    from ..core.model import Model

    out = {}
    for dtype in dtypes:
        results = {}
        for name in ("burgers", "ks", "readme"):
            model = Model(*STENCIL_MODELS[name], double=dtype == torch.float64,
                          device=device)
            for periodic in (True, False):
                check_stencil_batched(model, 1000, periodic, device, B,
                                      results=results)
        for i, (W, nvar, N, periodic) in enumerate(BATCH_SOLVER_CASES):
            check_solver_batched(W, nvar, N, periodic, dtype, device, B, seed=i,
                                 results=results)
        # the solver cases' few chunks take K4's one block per member; the
        # grid factor across the card on B members of 130 chunks
        check_grid_factor(2, 130, B, True, dtype, device, results=results)
        for name, N, periodic, dt, adaptive in BATCH_MEGA_CASES:
            model = Model(*MEGA_MODELS[name], double=dtype == torch.float64,
                          device=device)
            check_megastep_batched(model, N, periodic, dt, device, results,
                                   adaptive, B)
        out[str(dtype).replace("torch.", "")] = results
    return out


# ------------------------------------------------------ wide block sizes

#: (W, nvar, N, periodic, C) of the wide solver checks: block sizes s = 5
#: (3, 5), 6 (5, 3), 7 (3, 7) and 8 ((5, 4) and (3, 8)), each on a ring
#: closed block-cyclic (a power of two C >= 8), a ring closed by the
#: Woodbury correction and an acyclic grid, with up to 256 rows per chunk
#: and chunk counts that leave the last warp of K2's and K4's lane groups
#: part full (one chunk, at s = 8).  At s = 6 and 8, chunk counts whose K4
#: factor spans many CTAs (``pcr.factor_plan_wide``): the film's C = 500 on
#: a Woodbury ring, 512 block-cyclic, 600 at s2 = 16, and C = 1 (a ring
#: closed at the system level), 2 and 3 (one and two levels); K2's plans
#: there (``thomas.factor_plan``: CB = 32 // s chunks per block) leave B C
#: no multiple of CB (512, 12) and Mc no multiple of the stage rows R (3,
#: 4, 5)
WIDE_SOLVER_CASES = [
    (3, 5, 4096, True, 16), (3, 5, 3000, True, 12), (3, 5, 2000, False, 10),
    (5, 3, 4096, True, 8), (5, 3, 6000, True, 12), (5, 3, 2000, False, 5),
    (3, 7, 2048, True, 8), (3, 7, 1500, True, 6), (3, 7, 1000, False, 4),
    (5, 4, 2048, True, 8), (5, 4, 3000, True, 6), (5, 4, 1200, False, 3),
    (3, 8, 2048, True, 16), (3, 8, 1000, True, 5), (3, 8, 800, False, 4),
    (3, 8, 64, False, 1),
    (5, 3, 4000, True, 500), (5, 3, 3072, True, 512), (5, 3, 60, True, 1),
    (5, 3, 48, True, 2), (5, 3, 90, False, 3), (3, 8, 3000, True, 600),
]
#: the same on the card only, where K4's wide factor takes several passes
#: of its grid: 4096 block-cyclic and float64's most chunks at s2 = 12
#: (8192) and 16 (4096), Mc = 2 (on the CPU the plain versions, held to
#: themselves, take a minute)
WIDE_LARGE_CASES = [(5, 3, 16384, True, 4096), (5, 3, 32768, True, 8192),
                    (3, 8, 8192, True, 4096)]
#: (W, nvar, N, periodic, C) of the wide member-axis checks (B = BATCH): s =
#: 6 and 8, block-cyclic and Woodbury rings on ``chunked.make_plan``'s
#: plans (C None), and B C = 2048 pairs at s = 6 (C = 512)
WIDE_BATCH_CASES = [(5, 3, 2048, True, None), (5, 3, 1200, True, None),
                    (3, 8, 1024, True, None), (3, 8, 1000, True, None),
                    (5, 3, 3072, True, 512)]


def run_wide(device, dtypes=(torch.float64, torch.float32), B=BATCH):
    """K2-K4 at the wide block sizes, one grid (``WIDE_SOLVER_CASES``, and
    on the card ``WIDE_LARGE_CASES``) and B members (``WIDE_BATCH_CASES``),
    both dtypes; returns {dtype name: {kernel entry: max abs error}}."""
    cases = WIDE_SOLVER_CASES + (WIDE_LARGE_CASES if torch.device(device).type == "cuda"
                                 else [])
    out = {}
    for dtype in dtypes:
        results = {}
        for i, (W, nvar, N, periodic, C) in enumerate(cases):
            bands = random_bands(W, nvar, N, dtype, device, seed=i)
            plan = chunked.plan_with(N, nvar, W // 2, periodic, C)
            check_solver(bands, 1.0, -0.3, periodic, seed=i, results=results,
                         plan=plan)
        for i, (W, nvar, N, periodic, C) in enumerate(WIDE_BATCH_CASES):
            check_solver_batched(W, nvar, N, periodic, dtype, device, B, seed=i,
                                 results=results, C=C)
        out[str(dtype).replace("torch.", "")] = results
    return out


# ------------------------------------------------------- K6's Kahan carry

def member_copies(state, B):
    """B members made from one grid's (u, helpers, pstack, x): member b's u
    is u * (1 + 0.05 b), x shared."""
    u, h, p, x = state
    scale = 1.0 + 0.05 * torch.arange(B, dtype=u.dtype, device=u.device)
    return (u[None] * scale[:, None, None], h[None].expand(B, *h.shape).contiguous(),
            p[None].expand(B, *p.shape).contiguous(), x)


def _k6_args(model, N, periodic, device, B, state):
    """(plan, (u, helpers, pstack, x)) of a K6 check of B members: one
    grid's ``state`` (``mega_state`` by default) copied into B members
    (``member_copies``) where B > 1."""
    sysm = model.backend.system
    plan = megastep.plan_for(N, sysm.nvar, sysm.halo, periodic, B)
    if plan is None:
        plan = megastep.make_plan(N, sysm.nvar, sysm.halo, periodic)._replace(B=B)
    one = mega_state(model, N, periodic, device) if state is None else state
    return plan, (one if B == 1 else member_copies(one, B))


def seeded_carry(u, seed=0):
    """A nonzero Kahan carry for u: each node a residual below half an ulp
    of its value (eps/2 |u| times a normal draw, clipped to +-1).  Folding
    a step's own result into a zero carry leaves the carry zero (the
    residual of u + (u_new - u) is exact in these runs), so a check that
    must see the carry's arithmetic starts from this one."""
    eps = float(torch.finfo(u.dtype).eps)
    g = np.random.default_rng(seed).standard_normal(tuple(u.shape)).clip(-1, 1)
    return (0.5 * eps) * u * torch.as_tensor(g, dtype=u.dtype, device=u.device)


def check_compensated(model, N, periodic, dt, device, results=None,
                      adaptive=None, B=1, state=None):
    """K6's entries with a Kahan carry (counted as K6.compensated), each
    started from a nonzero carry (``seeded_carry``).

    Bit for bit: the step entry's 3 RODASPR steps against three launches
    without the carry folded by ``ops.compensated.kahan_update`` (state and
    carry); with ``adaptive = (output dt, internal dt, tol)``, the adaptive
    entry's output step and the adaptive scan's two (shared dt, and per
    member for B > 1; the second output step starts from a zero carry)
    against the controller replayed on the host with every attempt one
    launch of the step entry and every accepted state folded by
    ``kahan_update`` (``megastep.adaptive_scan_plain`` with
    ``step_fn=megastep.step``): u, the carry, dt_i, attempts and status.
    The carries out of the step entry and of one output step must be
    nonzero.  Against the plain versions with the carry (``scan_plain``,
    ``adaptive_plain``, ``adaptive_scan_plain``): u to the solver
    tolerance, the carries to |u| times it, equal attempts and status,
    dt_i within the dt limit."""
    from ..core.rosenbrock import adaptive_controller, member_controller
    from .compensated import kahan_update

    results = {} if results is None else results
    b = model.backend
    dtype = b.dtype
    T = np.float64 if dtype == torch.float64 else np.float32
    tol = TOL[dtype]["solve"]
    plan, args = _k6_args(model, N, periodic, device, B, state)
    u = args[0]
    what = f"N={N} B={B} C={plan.C} s={plan.s} {dtype}"
    fixed = rodaspr_table(False)
    gdt = float(T(fixed.g00) * T(dt))
    seed = seeded_carry(u)
    carry = seed.clone()
    got = megastep.step(b, plan, fixed, periodic, *args, -gdt, gdt, nsteps=3,
                        carry=carry)[0]
    seq, c = u, seed.clone()
    for _ in range(3):
        u2 = megastep.step(b, plan, fixed, periodic, seq, *args[1:], -gdt, gdt)[0]
        seq, c = kahan_update(seq, c, u2)
    if not (torch.equal(got, seq) and torch.equal(carry, c)):
        raise CheckFailed(f"K6.compensated step {what}: 3 steps with the carry "
                          "differ from 3 launches folded by kahan_update")
    if not bool((carry != 0).any()):
        raise CheckFailed(f"K6.compensated step {what}: the carry stayed zero")
    c_p = seed.clone()
    want = megastep.scan_plain(b, plan, fixed, periodic, *args, -gdt, gdt, 3,
                               carry=c_p)
    _record(results, "K6.compensated", got, want, tol, f"step {what}")
    scale = float(want.abs().max())
    _record(results, "K6.compensated", carry, c_p, tol, f"step carry {what}",
            scale=scale)
    if adaptive is None:
        return results
    out_dt, internal_dt, atol = adaptive
    modes = [(False, adaptive_controller)] + ([(True, member_controller)]
                                              if B > 1 else [])
    for per_member, ctl in modes:
        a_args = (ctl, b, plan, rodaspr_table(), periodic, *args, 0.0, out_dt,
                  internal_dt, atol, 0.9, None, None)
        for nsteps in (1, 2):
            entry = (f"{'adaptive' if nsteps == 1 else 'adaptive_scan'} "
                     f"{'per-member' if per_member else 'shared'} {what}")
            ck = seed.clone()
            if nsteps == 1:
                u_k, dt_k, att_k, st_k = megastep.row_adaptive_step(
                    *a_args, per_member=per_member, carry=ck)
            else:
                u_k, _, dt_k, st_k, att_k = megastep.adaptive_scan(
                    *a_args, nsteps, per_member=per_member, attempts=True,
                    carry=ck)
            runs = {}
            for name, step_fn in (("replay", megastep.step),
                                  ("plain", megastep.step_plain)):
                c_r = seed.clone()
                u_r, _, dt_r, st_r, att_r = megastep.adaptive_scan_plain(
                    *a_args, nsteps, per_member=per_member, carry=c_r,
                    step_fn=step_fn)
                runs[name] = u_r, c_r, dt_r, st_r, att_r
                if not (np.array_equal(att_k, att_r) and st_k == st_r):
                    raise CheckFailed(
                        f"K6.compensated {entry}: (attempts, status) "
                        f"{(att_k, st_k)} against the {name} controller's "
                        f"{(att_r, st_r)}")
            u_r, c_r, dt_r = runs["replay"][:3]
            if not (torch.equal(u_k, u_r) and torch.equal(ck, c_r)
                    and np.array_equal(np.asarray(dt_k, T), np.asarray(dt_r, T))):
                raise CheckFailed(
                    f"K6.compensated {entry}: u, carry or dt_i not bit for bit "
                    "the controller replayed on step-entry launches folded by "
                    "kahan_update")
            if nsteps == 1 and not bool((ck != 0).any()):
                raise CheckFailed(f"K6.compensated {entry}: the carry came out zero")
            u_p, c_p, dt_p = runs["plain"][:3]
            _record(results, "K6.compensated", u_k, u_p, tol, f"{entry} u")
            _record(results, "K6.compensated", ck, c_p, tol, f"{entry} carry",
                    scale=float(u_p.abs().max()))
            gap = float(np.max(np.abs(np.asarray(dt_k, np.float64)
                                      - np.asarray(dt_p, np.float64))
                               / np.abs(np.asarray(dt_p, np.float64))))
            if not gap <= TOL[dtype]["dt"]:
                raise CheckFailed(f"K6.compensated {entry} dt_i: relative error "
                                  f"{gap:.3e} > {TOL[dtype]['dt']:.0e}")
            results["K6.compensated dt_i"] = max(
                results.get("K6.compensated dt_i", 0.0), gap)
    return results


#: (model, N, periodic, fixed dt, adaptive) of the small carry checks: the
#: one-CTA body (README, s = 1), a cluster (KS, s = 2, with rejected
#: attempts in every mode) and s = 4.  The output steps are short enough
#: that a seeded carry outlives them (a step that moves u by O(1) absorbs
#: it); the tolerances are far enough above float32 rounding that the plain
#: float32 runs keep their attempts when u is perturbed by an ulp (README at
#: tol 1e-4 or below does not), so the kernel's rounding keeps them too
COMPENSATED_CASES = [("readme", 200, False, 0.5, (0.2, 1e-6, 1e-3)),
                     ("ks", 256, True, 0.05, (0.1, 1e-6, 1e-3)),
                     ("two_var", 600, True, 0.02, None)]


def check_all_compensated(device, dtype, results=None, B=BATCH):
    """``check_compensated`` at ``COMPENSATED_CASES``, one grid and B
    members (the adaptive case per member too)."""
    from ..core.model import Model

    results = {} if results is None else results
    for name, N, periodic, dt, adaptive in COMPENSATED_CASES:
        model = Model(*MEGA_MODELS[name], double=dtype == torch.float64,
                      device=device)
        for members in (1, B):
            check_compensated(model, N, periodic, dt, device, results, adaptive,
                              members)
    return results


def check_mixed_members(W, nvar, N, periodic, device, results=None, B=BATCH,
                        passes=1, seed=0):
    """The mixed solve of B members with their own coef
    (``mixed.MixedFactorization`` on float64 bands ((B,) W, nvar, nvar, N):
    K2 and K4 in float32 with each member's shift, K3 and K4's solves in
    float32, K8 per pass) against its plain version on the same plan
    (``megastep._plain_solver``'s mixed solve, ``mixed solve members``) and
    each member against its one-grid factorization (``mixed solve members
    alone``), to the float64 solve tolerance of max|k|."""
    results = {} if results is None else results
    tol = TOL[torch.float64]["solve"]
    bands = torch.stack([random_bands(W, nvar, N, torch.float64, device, seed=seed + b)
                         for b in range(B)])
    rng = np.random.default_rng(seed)
    rhs = torch.tensor(rng.standard_normal((B, nvar, N)), dtype=torch.float64,
                       device=device)
    coef = torch.tensor(0.1 + 0.05 * np.arange(B), dtype=torch.float64, device=device)
    plan = chunked.make_plan(N, nvar, W // 2, periodic, B)
    if plan.padded or plan.ring:
        raise ValueError(f"mixed members: N = {N} takes a padded plan")
    what = f"W={W} nvar={nvar} N={N} B={B} C={plan.C} periodic={periodic}"
    got = mixed.MixedFactorization(bands, coef, periodic, plan, passes).solve(rhs)
    want = megastep._plain_solver(bands, -coef, plan, periodic, passes)(rhs)
    _record(results, "mixed solve members", got, want, tol, what)
    one = chunked.make_plan(N, nvar, W // 2, periodic)
    for b in range(B):
        alone = mixed.MixedFactorization(bands[b], float(coef[b]), periodic, one,
                                         passes).solve(rhs[b])
        _record(results, "mixed solve members alone", got[b], alone, tol,
                f"member {b} {what}")
    return results


#: (W, nvar, N, periodic) of the member-axis mixed solve checks: the KS
#: ensemble's block (s = 2) on a block-cyclic and a Woodbury ring, and s = 4
MIXED_MEMBER_CASES = [(5, 1, 8192, True), (5, 1, 10000, True), (3, 2, 1200, False)]


def check_all_mixed_members(device, results=None):
    """``check_mixed_members`` at ``MIXED_MEMBER_CASES``."""
    results = {} if results is None else results
    for i, (W, nvar, N, periodic) in enumerate(MIXED_MEMBER_CASES):
        check_mixed_members(W, nvar, N, periodic, device, results, seed=i)
    return results
