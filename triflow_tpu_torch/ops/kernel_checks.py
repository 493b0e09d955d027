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
"""

from __future__ import annotations

import numpy as np
import torch

from . import chunked, combine, megastep, pcr, stencil, thomas

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


def random_bands(W, nvar, N, dtype, device, seed=0, beta=-0.3):
    """Bands of a J whose ``I + beta*J`` is diagonally dominant."""
    rng = np.random.default_rng(seed)
    bands = rng.standard_normal((W, nvar, nvar, N))
    for m in range(nvar):
        bands[W // 2, m, m] -= 3.0 * W * nvar / abs(beta)
    return torch.tensor(bands, dtype=dtype, device=device)


def banded_matvec(A_bands, x, periodic):
    """``A @ x`` for banded A (W, nvar, nvar, N) and x (nvar, N)."""
    W, _, _, N = A_bands.shape
    h = W // 2
    out = torch.zeros_like(x)
    for k in range(W):
        off = k - h
        if periodic:
            xs = torch.roll(x, -off, dims=-1)
        else:
            xs = torch.zeros_like(x)
            lo, hi = max(0, -off), min(N, N - off)
            xs[:, lo:hi] = x[:, lo + off:hi + off]
        out += torch.einsum("mni,ni->mi", A_bands[k], xs)
    return out


def check_solver(bands, alpha, beta, periodic, seed=0, results=None,
                 plan=None):
    """K2, K4 (factor; the R-column solve; on a Woodbury plan the closure's
    set-up; solve with shifts) and K3 (sweep, correction) against their
    plain versions on the same inputs, then the kernels' whole solve by its
    residual.  ``bands`` are J's bands on the card."""
    results = {} if results is None else results
    W, nvar, _, N = bands.shape
    dtype, device = bands.dtype, bands.device
    tol = TOL[dtype]["solve"]
    if plan is None:
        plan = chunked.make_plan(N, nvar, W // 2, periodic)
    what = (f"N={N} s={plan.s} C={plan.C} cyclic={plan.cyclic} "
            f"woodbury={plan.woodbury}")
    rng = np.random.default_rng(seed)
    rhs = torch.tensor(rng.standard_normal((nvar, N)), dtype=dtype, device=device)
    add = torch.tensor(rng.standard_normal((nvar, N)), dtype=dtype, device=device)

    sp_k = thomas.spike_factor(bands, alpha, beta, plan)
    sp_p = thomas.spike_factor_plain(bands, alpha, beta, plan)
    for got, want in zip(sp_k, sp_p):
        _record(results, "K2.spike_factor", got, want, tol, what)

    red_k = pcr.pcr_factor(sp_p.Lred, sp_p.Ured, plan.cyclic)
    red_p = pcr.pcr_factor_plain(sp_p.Lred, sp_p.Ured, plan.cyclic)
    for got, want in zip(red_k, red_p):
        _record(results, "K4.pcr_factor", got, want, tol, what)
    wood = ()
    if plan.woodbury:
        # the acyclic factor of the ring's reduced system ignores its
        # corner blocks: held against the plain factor with them masked
        Lm, Um = sp_p.Lred.clone(), sp_p.Ured.clone()
        Lm[..., 0] = 0.0
        Um[..., -1] = 0.0
        for got, want in zip(red_k, pcr.pcr_factor_plain(Lm, Um, False)):
            _record(results, "K4.pcr_factor", got, want, tol, f"masked {what}")
        wood = pcr.woodbury_plain(red_p, sp_p.Lred, sp_p.Ured)
        for got, want in zip(pcr.woodbury(red_p, sp_p.Lred, sp_p.Ured), wood):
            _record(results, "K4.pcr_solve", got, want, tol, f"woodbury {what}")
    cols = torch.tensor(rng.standard_normal((2 * plan.s, 2 * plan.s, plan.C)),
                        dtype=dtype, device=device)
    _record(results, "K4.pcr_solve", pcr.pcr_solve(red_p, cols),
            pcr.pcr_solve_plain(red_p, cols), tol, f"R={2 * plan.s} {what}")

    y_k, yred_k = thomas.thomas_sweep(sp_p, rhs, plan)
    y_p, yred_p = thomas.thomas_sweep_plain(sp_p, rhs, plan)
    _record(results, "K3.thomas_sweep", y_k, y_p, tol, what)
    _record(results, "K3.thomas_sweep", yred_k, yred_p, tol, what)

    sh_k = pcr.pcr_solve_shift(red_p, yred_p, plan.wrap, *wood)
    sh_p = pcr.pcr_solve_shift_plain(red_p, yred_p, plan.wrap, *wood)
    for got, want in zip(sh_k, sh_p):
        _record(results, "K4.pcr_solve_shift", got, want, tol, what)

    x_k = thomas.spike_correct(sp_p, y_p, *sh_p, plan, add_to=add)
    x_p = thomas.spike_correct_plain(sp_p, y_p, *sh_p, plan, add_to=add)
    _record(results, "K3.spike_correct", x_k, x_p, tol, what)

    x = chunked.factor(alpha, beta, bands, periodic, plan).solve(rhs)
    A = torch.zeros_like(bands).double()
    A += beta * bands.double()
    A[W // 2, torch.arange(nvar), torch.arange(nvar)] += alpha
    resid = banded_matvec(A, x.double(), periodic) - rhs.double()
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
    if adaptive is not None:
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


#: (W, nvar, N, periodic): block sizes 1, 2 and 4, acyclic, and rings
#: closed block-cyclic (power-of-two plans) and by the Woodbury correction
#: (plans of 125, 4, 120 and 30 chunks)
SOLVER_CASES = [(3, 1, 4096, True), (3, 1, 4000, False), (5, 1, 4096, True),
                (5, 1, 2000, False), (3, 2, 2048, True), (3, 2, 1200, False),
                (3, 1, 1000, True), (5, 1, 200, True), (3, 2, 1200, True),
                (5, 2, 2048, True), (5, 2, 600, True), (5, 2, 1000, False)]


def run_all(device, dtypes=(torch.float64, torch.float32)):
    """Every check above at small and odd shapes, both dtypes; returns
    {dtype name: {kernel entry: max abs error}}."""
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
        check_all_megasteps(device, dtype, results)
        out[str(dtype).replace("torch.", "")] = results
    return out
