"""The port's ``parallel.Ensemble`` against the JAX package's, from one
ensemble handed to both (``utils.convert.ensemble_from_numpy``), in
float64 on the CPU, where the JAX ``Ensemble`` takes its vmapped route.

* fixed RODASPR steps of B = 3 distinct KS members (N = 256, periodic and
  not; N = 1000, a ring closed through the Woodbury correction) to 1e-10
  relative, and ROS2 (the default scheme) on Burgers;
* Theta with a Dirichlet hook and a per-member diffusivity, ten output
  steps, to 1e-9;
* ``refine=1`` (the residual refinement through the banded matvec K7
  with a member axis and each member's g00*dt): the reference's own case
  (``tests/test_ensemble.py``: B = 4 KS members at N = 1024, fixed
  steps), and the shared and per-member adaptive controllers, to the
  limits below; the port takes its host route (K6 has no refinement);
* the adaptive RODASPR controller with a shared dt (``step`` and
  ``steps(3)``: equal times and attempts, u to 1e-9) and per member
  (``per_member_dt``: equal ``member_iters``, u to 1e-9), and the
  interpolating ``recompute_target=False`` mode of both;
* the port's own invariants: ``steps(n)`` through the adaptive scan is bit
  for bit ``n`` calls of ``step``; every member equals the port's
  single-grid run of that member; the fused stage right-hand side
  (K1.F_terms's plain version) equals the combination and the biased F;
  the batched plain solver pieces equal the per-member ones; the status
  codes raise and leave the ensemble as it was; the refusals.

Each parity case runs on both routes of the port: the tests named
``..._matches_jax`` take an ensemble of small grids through K6's route
(its plain versions on the CPU: ``steps(n)`` one scan), and their
``..._multi_launch`` twins withhold K6's plan (the ``multi_launch``
fixture), so the same steps run the host controllers over K1-K5 with a
member axis, the route of large grids.  The adaptive cases are chosen with
the accepted dts set by errs near tol (or by the 10x growth cap), and each
asserts that no attempt's err lies within 1e-6 relative of tol.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import triflow_tpu as tj
import triflow_tpu_torch as tt
from triflow_tpu.core import schemes as schemes_j
from triflow_tpu.parallel import Ensemble as EnsembleJ
from triflow_tpu.parallel import stack_parameters as stack_parameters_j
from triflow_tpu_torch.ops import chunked, combine, megastep, pcr, stencil, thomas
from triflow_tpu_torch.parallel import Ensemble, stack_parameters
from triflow_tpu_torch.utils.convert import ensemble_from_numpy

torch.set_num_threads(1)

KS = ("-dxxU - dxxxxU - U * dxU", "U", [])
BURGERS = ("k * dxxU - U * dxU", "U", "k")
README = ("k * dxxU - c * dxU", "U", ["k", "c"])
B = 3


def ks_members(N, B=B, seed=9):
    """B distinct KS members on x = 0.5 i (the reference's merged-ensemble
    tests' states)."""
    rng = np.random.RandomState(seed)
    i = np.arange(N)
    return i * 0.5, np.stack([np.cos(2 * np.pi * i / N * (3 + m))
                              + 0.05 * rng.randn(N) for m in range(B)])


@pytest.fixture
def multi_launch(monkeypatch):
    """Withhold K6's plan from every grid: the ensembles take the host
    route over K1-K5, and the test fails if anything still reaches K6."""
    monkeypatch.setattr(megastep, "plan_for", lambda *args: None)
    reached = []
    for name in ("step", "row_adaptive_step", "adaptive_scan"):
        def refuse(*args, _name=name, **kw):
            reached.append(_name)
            raise AssertionError(f"megastep.{_name} reached with its plan withheld")

        monkeypatch.setattr(megastep, name, refuse)
    yield
    assert not reached


def _record_errors(ens, monkeypatch):
    """Keep every attempt's member errors: of the ensemble's batched fixed
    step (the host route) and of K6's plain step (the K6 route)."""
    errs = []
    step = ens._scheme.fixed_step_batched
    plain = megastep.step_plain

    def recording(*args):
        out = step(*args)
        errs.append(out[-1].numpy().copy())
        return out

    def recording_plain(*args):
        out = plain(*args)
        errs.append(out[-1].numpy().copy())
        return out

    ens._scheme.fixed_step_batched = recording
    monkeypatch.setattr(megastep, "step_plain", recording_plain)
    return errs


def _assert_not_marginal(errs, tol):
    assert errs, "no attempt was made"
    ratios = np.concatenate([np.ravel(e) for e in errs]) / tol
    margin = np.min(np.abs(ratios - 1.0))
    assert margin > 1e-6, f"an attempt's err is within {margin:.1e} of tol"
    assert np.any((ratios > 0.1) & (ratios <= 1.0)), "no err near tol"


def _port(eqs, u0, x, pars, **kw):
    model = tt.Model(*eqs, device="cpu")
    return Ensemble(model, **ensemble_from_numpy(model, u0, x, pars), **kw)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


# ------------------------------------------------------- the JAX side

def _scheme_kw(kw):
    """Keyword arguments for both packages' schemes ("scheme" by name)."""
    kw = dict(kw)
    name = kw.pop("scheme")
    return name, kw


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """The JAX Ensemble's trajectory of a case: after each call of
    ``calls`` ((n, dt): ``steps(n, dt)``, or n None: ``step(dt)``), its t,
    u, internal dt and member_iters."""
    eqs, u0, x, pars, kw, calls = CASES[case]
    name, kw = _scheme_kw(kw)
    model = tj.Model(*eqs)
    hook = kw.pop("hook_jax", schemes_j.null_hook)
    kw.pop("hook_torch", None)
    ens = EnsembleJ(model, u0, pars, x, scheme=getattr(tj.schemes, name),
                    hook=hook, **kw)
    out = []
    for n, dt in calls:
        if n is None:
            ens.step(dt)
        else:
            ens.steps(n, dt)
        out.append((ens.t, np.asarray(ens.u), np.asarray(ens._internal_dt),
                    None if ens.member_iters is None
                    else np.asarray(ens.member_iters).copy()))
    return out


@functools.lru_cache(maxsize=None)
def _jax_shared_attempts(case):
    """The JAX shared-dt controller's attempts in each call of a case: its
    ``_build_adaptive`` loop (the vmapped fixed step, err max-reduced over
    the members) run with the attempt count kept."""
    eqs, u0, x, pars, kw, calls = CASES[case]
    name, kw = _scheme_kw(kw)
    model = tj.Model(*eqs)
    ens = EnsembleJ(model, u0, pars, x, scheme=getattr(tj.schemes, name), **kw)
    scheme = ens._scheme
    fixed = scheme.device_fixed_step(ens._hook, ens.periodic, batched=True)
    vfixed = jax.vmap(fixed, in_axes=(None, 0, 0, 0, None, None))

    def batch_fixed(t, u, h, p, x_, dt):
        u2, h2, p2, _x, errs = vfixed(t, u, h, p, x_, dt)
        return u2, h2, p2, x_, jnp.max(errs)

    loop = jax.jit(schemes_j._adaptive_embedded_loop(
        batch_fixed, tol=scheme._tol, safety=scheme._safety_factor,
        max_iter=scheme._max_iter, dt_min=scheme._dt_min,
        compensated=scheme._compensated,
        interpolate=not scheme._recompute_target))
    t, u, h, p, idt = 0.0, ens.u, ens.helpers, ens.pstack, None
    out = []
    for n, dt in calls:
        total = 0
        for _ in range(1 if n is None else n):
            if idt is None:
                idt = schemes_j._seed_internal_dt(scheme, dt)
            t, u, h, p, _x, idt, niter, _st = loop(
                jnp.asarray(t), u, h, p, ens.x, jnp.asarray(dt), jnp.asarray(idt))
            total += int(niter)
        out.append(total)
    return out


def _dirichlet_jax(t, fields, pars):
    fields["U"] = fields["U"].at[0].set(1.0).at[-1].set(0.0)
    return fields, pars


def _dirichlet_torch(t, fields, pars):
    fields["U"][0] = 1.0
    fields["U"][-1] = 0.0
    return fields, pars


_X256, _U256 = ks_members(256)
_X1024, _U1024 = ks_members(1024, B=4, seed=3)
_X1000, _U1000 = ks_members(1000, seed=7)
_XB = np.linspace(0, 10, 64, endpoint=False)
_UB = np.stack([np.cos(2 * np.pi * _XB / 10 + p)
                for p in np.random.RandomState(0).rand(4)])
_XR = np.linspace(0, 1, 128)
_UR = np.stack([np.cos(2 * np.pi * _XR * 5 + p)
                for p in np.random.RandomState(2).rand(B)])
_FIXED = dict(scheme="RODASPR", time_stepping=False, tol=None)
_FIXED_CALLS = ((None, 0.02), (3, 0.02))

#: case -> (equations, u0, x, parameter sets, scheme keywords, calls)
CASES = {
    "ks-periodic": (KS, _U256, _X256, dict(periodic=True), _FIXED, _FIXED_CALLS),
    "ks-edges": (KS, _U256, _X256, dict(periodic=False), _FIXED, _FIXED_CALLS),
    "ks-1000-woodbury": (KS, _U1000, _X1000, dict(periodic=True), _FIXED,
                         _FIXED_CALLS),
    "burgers-ros2-default": (BURGERS, _UB, _XB,
                             tuple(dict(k=k, periodic=True)
                                   for k in (0.5, 0.7, 1.0, 1.5)),
                             dict(scheme="ROS2"), ((3, 0.1), (None, 0.1))),
    "readme-theta-hook": (README, _UR, _XR,
                          tuple(dict(k=k, c=3e-3, periodic=False)
                                for k in (1e-3, 2e-3, 4e-3)),
                          dict(scheme="Theta", theta=1.0,
                               hook_jax=_dirichlet_jax, hook_torch=_dirichlet_torch),
                          ((5, 1.0), (None, 1.0), (4, 1.0))),
    "ks-shared-adaptive": (KS, _U256, _X256, dict(periodic=True),
                           dict(scheme="RODASPR", tol=1e-4),
                           ((None, 0.5), (3, 0.5))),
    "ks-per-member": (KS, _U256, _X256, dict(periodic=True),
                      dict(scheme="RODASPR", tol=1e-4, per_member_dt=True),
                      ((None, 1.0), (2, 1.0))),
    "ks-shared-interpolating": (KS, _U256, _X256, dict(periodic=True),
                                dict(scheme="RODASPR", tol=1e-4,
                                     recompute_target=False),
                                ((None, 0.7), (2, 0.7))),
    "ks-per-member-interpolating": (KS, _U256, _X256, dict(periodic=True),
                                    dict(scheme="RODASPR", tol=1e-4,
                                         per_member_dt=True,
                                         recompute_target=False),
                                    ((None, 0.7),)),
}
_REFINE_CASES = {
    "ks-1024-refine": (KS, _U1024, _X1024, dict(periodic=True),
                       dict(_FIXED, refine=1), ((None, 0.02), (2, 0.02))),
    "ks-shared-adaptive-refine": (KS, _U256, _X256, dict(periodic=True),
                                  dict(scheme="RODASPR", tol=1e-4, refine=1),
                                  ((None, 0.5), (2, 0.5))),
    "ks-per-member-refine": (KS, _U256, _X256, dict(periodic=True),
                             dict(scheme="RODASPR", tol=1e-4, refine=1,
                                  per_member_dt=True),
                             ((None, 1.0),)),
}
CASES.update(_REFINE_CASES)
#: the cases of the K6 route's parity tests and their multi-launch twins
ROUTED = ["ks-periodic", "ks-edges", "ks-1000-woodbury", "burgers-ros2-default",
          "readme-theta-hook", "ks-shared-adaptive", "ks-per-member"]


def _port_run(case, monkeypatch=None):
    """The port's ensemble of a case and its trajectory (as ``_jax_run``)
    and recorded errs (adaptive cases)."""
    eqs, u0, x, pars, kw, calls = CASES[case]
    name, kw = _scheme_kw(kw)
    kw.pop("hook_jax", None)
    hook = kw.pop("hook_torch", tt.schemes.null_hook)
    pars = dict(pars) if isinstance(pars, dict) else list(pars)
    ens = _port(eqs, u0, x, pars, scheme=getattr(tt.schemes, name), hook=hook,
                **kw)
    errs = (_record_errors(ens, monkeypatch)
            if monkeypatch is not None and ens._adaptive else None)
    out, attempts = [], []
    for n, dt in calls:
        if n is None:
            ens.step(dt)
        else:
            ens.steps(n, dt)
        out.append((ens.t, ens.u.clone().numpy(), np.asarray(ens._internal_dt),
                    None if ens.member_iters is None else ens.member_iters.copy()))
        attempts.append(ens.attempts)
    return ens, out, attempts, errs


def _assert_matches_jax(case, monkeypatch, route):
    ens, got, attempts, errs = _port_run(case, monkeypatch)
    assert ens.route == route
    want = _jax_run(case)
    kw = CASES[case][4]
    tol_u = 1e-10 if not ens._adaptive else 1e-9
    for (t_t, u_t, dt_t, it_t), (t_j, u_j, dt_j, it_j) in zip(got, want):
        assert t_t == pytest.approx(t_j, rel=1e-14)
        assert u_t.shape == u_j.shape
        assert _rel(u_t, u_j) <= tol_u
        if ens._adaptive:
            assert np.allclose(dt_t, dt_j, rtol=1e-8, atol=0)
        if it_j is not None:
            assert np.array_equal(it_t, it_j)
    if ens._adaptive and not ens._per_member_dt:
        assert attempts == _jax_shared_attempts(case)
    if errs is not None:
        _assert_not_marginal(errs, kw["tol"])
    return ens, got


@pytest.mark.parametrize("case", ROUTED)
def test_ensemble_matches_jax(case, monkeypatch):
    ens, got = _assert_matches_jax(case, monkeypatch,
                                   "host" if "hook" in case else "K6")
    if "hook" in case:
        assert np.all(got[-1][1][:, 0, 0] == 1.0)
        assert np.all(got[-1][1][:, 0, -1] == 0.0)


@pytest.mark.parametrize("case", ROUTED)
def test_ensemble_matches_jax_multi_launch(multi_launch, case, monkeypatch):
    _assert_matches_jax(case, monkeypatch, "host")


@pytest.mark.parametrize("case", ["ks-shared-interpolating",
                                  "ks-per-member-interpolating"])
def test_interpolating_mode_matches_jax(multi_launch, case, monkeypatch):
    """``recompute_target=False``: every member (or the shared clock)
    overshoots the output time and u is interpolated between the
    bracketing steps, on K1-K5 with a member axis."""
    _assert_matches_jax(case, monkeypatch, "host")


@pytest.mark.parametrize("case", sorted(_REFINE_CASES))
def test_refined_ensemble_matches_jax(case, monkeypatch):
    """``Ensemble(..., refine=1)``: the host route over K1-K5 and K7 with a
    member axis, on a grid K6 would take otherwise."""
    ens, _ = _assert_matches_jax(case, monkeypatch, "host")
    assert ens._scheme._refine == 1
    assert megastep.plan_for(ens.N, 1, 2, True, ens.B) is not None


def test_woodbury_plans_on_both_routes():
    """KS N = 1000's ring closes through the Woodbury correction on K6's
    plan and on the B-member chunk plan."""
    k6 = megastep.plan_for(1000, 1, 2, True, B)
    plan = chunked.make_plan(1000, 1, 2, True, B)
    assert k6.B == plan.B == B
    assert k6.woodbury and plan.woodbury


# ----------------------------------------------------------- the port alone

@pytest.mark.parametrize("per_member", [False, True], ids=["shared", "per-member"])
def test_adaptive_scan_equals_single_steps(per_member):
    """``steps(3)`` (one adaptive scan on K6's route: its plain version on
    the CPU) is bit for bit three ``step`` calls (three adaptive launches),
    with the same clock, internal dts and attempts."""
    kw = dict(scheme=tt.schemes.RODASPR, tol=1e-4, per_member_dt=per_member)
    a = _port(KS, _U256, _X256, dict(periodic=True), **kw)
    b = _port(KS, _U256, _X256, dict(periodic=True), **kw)
    assert a.route == b.route == "K6"
    a.steps(3, 0.5)
    iters, attempts = 0, 0
    for _ in range(3):
        b.step(0.5)
        if per_member:
            iters = iters + b.member_iters
        else:
            attempts += b.attempts
    assert a.t == b.t
    assert torch.equal(a.u, b.u)
    assert np.array_equal(np.asarray(a._internal_dt), np.asarray(b._internal_dt))
    if per_member:
        assert np.array_equal(a.member_iters, iters)
    else:
        assert a.attempts == attempts


@pytest.mark.parametrize("route", ["K6", "host"])
@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed", "per-member"])
def test_members_equal_single_grid_runs(route, adaptive):
    """Each member of an ensemble equals the port's single-grid run of that
    member: fixed RODASPR steps, and per-member adaptive output steps
    against the single-grid controller, to 1e-12."""
    kw = (dict(tol=1e-4, per_member_dt=True) if adaptive
          else dict(time_stepping=False, tol=None))
    ens = _port(KS, _U256, _X256, dict(periodic=True), scheme=tt.schemes.RODASPR,
                **kw)
    if route == "host":
        ens._scheme._mega_plans[(256, True, B)] = None
    assert ens.route == route
    dt = 1.0 if adaptive else 0.02
    ens.steps(2, dt)
    model = ens.model
    for b in range(B):
        fields = model.fields_template(x=torch.tensor(_X256),
                                       U=torch.tensor(_U256[b]))
        single = tt.schemes.RODASPR(model, **{k: v for k, v in kw.items()
                                              if k != "per_member_dt"})
        if route == "host":
            single._mega_plans[(256, True)] = None
        t, iters = 0.0, 0
        for _ in range(2):
            t, fields = single(t, fields, dt, dict(periodic=True))
            iters += single._internal_iter or 0
        assert _rel(ens.u[b, 0].numpy(), fields["U"].numpy()) <= 1e-12
        if adaptive:
            assert ens.member_iters[b] == iters


@pytest.mark.parametrize("knob,message", [(dict(dt_min=0.5), "less than"),
                                          (dict(max_iter=1), "max iterations")])
@pytest.mark.parametrize("per_member", [False, True], ids=["shared", "per-member"])
@pytest.mark.parametrize("route", ["K6", "host"])
def test_status_codes_raise(route, per_member, knob, message):
    """The dt floor and the attempt cap raise the reference's
    RuntimeErrors on both routes, and leave the ensemble as it was (after
    ``test_ensemble.py``'s guard test)."""
    ens = _port(BURGERS, _UB[:2], _XB, dict(k=1.0, periodic=True),
                scheme=tt.schemes.RODASPR, tol=1e-12, per_member_dt=per_member,
                **knob)
    if route == "host":
        ens._scheme._mega_plans[(64, True, 2)] = None
    assert ens.route == route
    u0 = ens.u.clone()
    with pytest.raises(RuntimeError, match=message):
        ens.steps(2, 1.0)
    assert ens.t == 0.0 and torch.equal(ens.u, u0)


def test_fused_stage_rhs_equals_combination_and_biased_F():
    """K1.F_terms's plain version (F at the combined stage input, scaled,
    then the bias terms added one by one) equals the single-grid path's
    combination (K5) and biased F (K1) to 1e-13, and the JAX model's F at
    the same combination to 1e-12, with a shared and a per-member scale."""
    model = tt.Model(*KS, device="cpu")
    model_j = tj.Model(*KS)
    rng = np.random.default_rng(3)
    N = 256
    u = rng.standard_normal((B, 1, N))
    stages = [1e-2 * rng.standard_normal((B, 1, N)) for _ in range(5)]
    coefs = [(1.0, 0.0), (0.75, 0.3), (0.0, -1.2), (1.0, 1.0), (2.5, 0.0),
             (-0.4, 0.7)]
    arrays = [torch.tensor(a) for a in [u] + stages]
    terms = [(a, c, arr) for (a, c), arr in zip(coefs, arrays)]
    h = torch.zeros((B, 0, N), dtype=torch.float64)
    p = torch.zeros((B, 0, N), dtype=torch.float64)
    x = torch.tensor(_X256)
    for scale in (0.0125, torch.tensor([0.01, 0.02, 0.03], dtype=torch.float64)):
        got = stencil.eval_F_terms_plain(model.backend, terms, h, p, x, True, scale)
        u_i, csum = combine.combine_plain([[a for a, _ in coefs], [c for _, c in coefs]],
                                          arrays)
        want = stencil.eval_F_plain(model.backend, u_i, h, p, x, True, scale, csum)
        assert _rel(got, want) <= 1e-13
        sc = np.asarray(scale).reshape(-1, 1, 1) if np.ndim(scale) else scale
        u_np = sum(a * np.asarray(arr) for (a, _), arr in zip(coefs, arrays))
        F_j = np.stack([np.asarray(model_j.backend.F(
            jnp.asarray(u_np[b]), jnp.zeros((0, N)), jnp.zeros((0, N)),
            jnp.asarray(_X256), periodic=True)) for b in range(B)])
        want_j = sc * F_j + sum(c * np.asarray(arr) for (_, c), arr in zip(coefs, arrays))
        assert _rel(got, want_j) <= 1e-12


@pytest.mark.parametrize("W,nvar,N,periodic", [(5, 1, 1000, True), (5, 1, 1024, True),
                                                (3, 2, 1200, True), (5, 1, 2000, False)])
def test_batched_plain_solver_equals_per_member(W, nvar, N, periodic):
    """The plain K2-K4 with a member axis equal the single-grid plain
    pieces of each member (factor with per-member shifts, PCR factor,
    Woodbury set-up, R-column solve, sweep, solve with shifts,
    correction)."""
    from triflow_tpu_torch.ops import kernel_checks

    bands = torch.stack([kernel_checks.random_bands(W, nvar, N, torch.float64, "cpu",
                                                    seed=b, beta=-0.2)
                         for b in range(B)])
    betas = torch.tensor([-0.3, -0.2, -0.25], dtype=torch.float64)
    plan = chunked.make_plan(N, nvar, W // 2, periodic, B)
    rng = np.random.default_rng(0)
    rhs = torch.tensor(rng.standard_normal((B, nvar, N)))
    add = torch.tensor(rng.standard_normal((B, nvar, N)))
    cols = torch.tensor(rng.standard_normal((B, 2 * plan.s, 2 * plan.s, plan.C)))
    fb = thomas.spike_factor(bands, 1.0, betas, plan)
    red = pcr.pcr_factor(fb.Lred, fb.Ured, plan.cyclic)
    wood = pcr.woodbury(red, fb.Lred, fb.Ured) if plan.woodbury else ()
    y, yred = thomas.thomas_sweep(fb, rhs, plan)
    xm1, xp1 = pcr.pcr_solve_shift(red, yred, plan.wrap, *wood)
    x = thomas.spike_correct(fb, y, xm1, xp1, plan, add_to=add)
    z = pcr.pcr_solve(red, cols)
    for b in range(B):
        f1 = thomas.spike_factor(bands[b], 1.0, float(betas[b]), plan)
        r1 = pcr.pcr_factor(f1.Lred, f1.Ured, plan.cyclic)
        w1 = pcr.woodbury(r1, f1.Lred, f1.Ured) if plan.woodbury else ()
        y1, yr1 = thomas.thomas_sweep(f1, rhs[b], plan)
        a1, p1 = pcr.pcr_solve_shift(r1, yr1, plan.wrap, *w1)
        pairs = list(zip(fb, f1)) + list(zip(red, r1)) + list(zip(wood, w1)) + [
            (y[b], y1), (yred[b], yr1), (xm1[b], a1), (xp1[b], p1),
            (x[b], thomas.spike_correct(f1, y1, a1, p1, plan, add_to=add[b])),
            (z[b], pcr.pcr_solve(r1, cols[b]))]
        for got, want in pairs:
            got = got[b] if got.ndim == want.ndim + 1 else got
            assert got.shape == want.shape
            assert torch.allclose(got, want, rtol=1e-14, atol=1e-14 * float(
                want.abs().max()))


def test_plans_carry_the_member_count():
    """The chunk plan of B members keeps C per member (a divisor of each
    member's supernodes) and is chosen by the batch cost; one grid keeps
    its single-grid plan."""
    one = chunked.make_plan(10 ** 5, 1, 2, True)
    many = chunked.make_plan(10 ** 5, 1, 2, True, 1024)
    assert one.B == 1 and many.B == 1024
    assert (10 ** 5 // 2) % many.C == 0
    M = 10 ** 5 // 2
    cands = [C for C in chunked.chunk_counts(10 ** 5, 2, True) if C <= pcr.MAX_C]
    assert many.C == min(cands, key=lambda C: (chunked.batch_plan_cost_us(M, C, 1024), C))
    assert megastep.plan_for(200, 1, 2, True, 64).B == 64
    assert megastep.plan_for(200, 1, 2, True) == megastep.make_plan(200, 1, 2, True)


def test_stack_parameters_matches_jax():
    model = tt.Model(*README, device="cpu")
    sets = [dict(k=1e-3, c=np.linspace(0, 1, 16)), dict(k=2e-3, c=3e-3)]
    got = stack_parameters(model, sets, 16)
    want = np.asarray(stack_parameters_j(tj.Model(*README), sets, 16))
    assert got.shape == (2, 2, 16)
    assert np.array_equal(got.numpy(), want)


def test_ensemble_from_numpy_lands_on_the_model():
    model = tt.Model(*README, double=False, device="cpu")
    kw = ensemble_from_numpy(model, _UR, _XR,
                             [dict(k=1e-3, c=np.full(128, 3e-3), periodic=0)] * B,
                             helpers0=np.zeros((B, 0, 128)))
    assert kw["u0"].dtype == kw["x"].dtype == torch.float32
    assert kw["u0"].shape == (B, 128) and kw["helpers0"].shape == (B, 0, 128)
    assert kw["parameter_sets"][0]["periodic"] is False
    assert isinstance(kw["parameter_sets"][0]["k"], float)
    assert kw["parameter_sets"][0]["c"].dtype == torch.float32
    ens = Ensemble(model, **kw)
    assert ens.u.shape == (B, 1, 128) and ens.pstack.shape == (B, 2, 128)


def test_run_lands_on_tmax_with_steps_per_call():
    """``run`` with ``steps_per_call`` takes the scanned driver and ends on
    tmax exactly as single steps do."""
    a = _port(BURGERS, _UB, _XB, dict(k=1.0, periodic=True))
    b = _port(BURGERS, _UB, _XB, dict(k=1.0, periodic=True))
    events = []
    a.stream.sink(lambda ens: events.append(ens.t))
    a.run(tmax=0.35, dt=0.1, steps_per_call=2)
    b.run(tmax=0.35, dt=0.1)
    assert a.t == pytest.approx(0.35) and b.t == pytest.approx(0.35)
    assert _rel(a.u.numpy(), b.u.numpy()) <= 1e-12
    assert events[-1] == a.t and len(events) == 3


def test_refusals():
    """What the port does not have yet raises, naming its queue item."""
    with pytest.raises(NotImplementedError, match="A9"):
        _port(KS, _U256, _X256, dict(periodic=True), mesh=object())
    with pytest.raises(NotImplementedError, match="A9"):
        _port(KS, _U256, _X256, dict(periodic=True), space_axis="space")
    # an ensemble of a df64 model is ported (tests/test_torch_df64_ensemble.py):
    # float64 state and parameters, the mixed solve on the host route
    df64 = tt.Model(*KS, double="df64", device="cpu")
    ens = Ensemble(df64, **ensemble_from_numpy(df64, _U256, _X256,
                                               dict(periodic=True)),
                   scheme=tt.schemes.RODASPR, time_stepping=False,
                   df64_mixed_solve=1)
    assert ens.u.dtype == ens.pstack.dtype == torch.float64
    assert ens.route == "host"
    # containers and checkpoints are ported (tests/test_torch_persistence.py)
    ens = _port(KS, _U256, _X256, dict(periodic=True))
    assert len(ens.attach_container(None).data.t) == 1
    with pytest.raises(ValueError, match="periodic"):
        _port(KS, _U256, _X256, [dict(periodic=True), dict(periodic=False),
                                 dict(periodic=True)])
