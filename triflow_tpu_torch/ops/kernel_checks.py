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
entry, a few units in the last place.
"""

from __future__ import annotations

import numpy as np
import torch

from . import chunked, combine, pcr, stencil, thomas

TOL = {torch.float64: {"FJ": 1e-12, "solve": 1e-10, "combine": 1e-15},
       torch.float32: {"FJ": 1e-5, "solve": 1e-4, "combine": 1e-6}}

#: (equations, dependent variables, parameters) the K1 checks compile
STENCIL_MODELS = {
    "burgers": ("-U * dxU + nu * dxxU", "U", ["nu"]),
    "readme": ("k * dxxU - c * dxU", "U", ["k", "c"]),
    "ks": ("-dxxU - dxxxxU - U * dxU", "U", []),
}


class CheckFailed(AssertionError):
    pass


def _err(got, want):
    """(max abs error, max abs error relative to max|want|)."""
    got, want = got.double(), want.double()
    abs_err = float((got - want).abs().max()) if want.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    return abs_err, abs_err / max(scale, 1e-300)


def _record(results, name, got, want, tol, what):
    abs_err, rel = _err(got, want)
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
    """K2, K4 (factor, solve with shifts) and K3 (sweep, correction)
    against their plain versions on the same inputs, then the kernels'
    whole solve by its residual.  ``bands`` are J's bands on the card."""
    results = {} if results is None else results
    W, nvar, _, N = bands.shape
    dtype, device = bands.dtype, bands.device
    tol = TOL[dtype]["solve"]
    if plan is None:
        plan = chunked.make_plan(N, nvar, W // 2, periodic)
    what = f"N={N} s={plan.s} C={plan.C} cyclic={plan.cyclic}"
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

    y_k, yred_k = thomas.thomas_sweep(sp_p, rhs, plan)
    y_p, yred_p = thomas.thomas_sweep_plain(sp_p, rhs, plan)
    _record(results, "K3.thomas_sweep", y_k, y_p, tol, what)
    _record(results, "K3.thomas_sweep", yred_k, yred_p, tol, what)

    sh_k = pcr.pcr_solve_shift(red_p, yred_p, plan.cyclic)
    sh_p = pcr.pcr_solve_shift_plain(red_p, yred_p, plan.cyclic)
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


#: (W, nvar, N, periodic): block sizes 1 and 2, cyclic and acyclic,
#: chunk counts that are and are not powers of two
SOLVER_CASES = [(3, 1, 4096, True), (3, 1, 4000, False), (5, 1, 4096, True),
                (5, 1, 2000, False), (3, 2, 2048, True), (3, 2, 1200, False)]


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
        out[str(dtype).replace("torch.", "")] = results
    return out
