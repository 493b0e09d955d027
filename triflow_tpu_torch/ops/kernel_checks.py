"""Each kernel against its plain version on CUDA tensors, on the same
inputs: the checks behind ``tests/test_torch_kernels.py`` and phase 1 of
``chip_smoke.py``.

Inputs are made with numpy from a seed.  Tolerances: float64 F and J within
1e-12 of max|F| (max|J|), float64 solver pieces within 1e-10 of the largest
entry; float32 F and J within 1e-5 of the largest entry, float32 solver
pieces within 1e-4, and the float32 solve's residual ``|A x - b| / |b|``
within 1e-4.  float32 is looser because FMA contraction and summation order
differ between the kernel and torch.
"""

from __future__ import annotations

import numpy as np
import torch

from . import chunked, pcr, thomas

TOL = {torch.float64: {"FJ": 1e-12, "solve": 1e-10},
       torch.float32: {"FJ": 1e-5, "solve": 1e-4}}

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
    """K1's F (with a scale) and J entries against ``F_impl`` /
    ``J_bands_impl`` on random inputs of the model's dtype."""
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
    J_k = b.J_bands(u, helpers, pstack, x, periodic=periodic)
    J_p = b.J_bands_impl(u, helpers, pstack, x, periodic=periodic)
    _record(results, "K1.J", J_k, J_p, tol, f"N={N} periodic={periodic}")
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
        out[str(dtype).replace("torch.", "")] = results
    return out
