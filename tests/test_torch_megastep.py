"""Kernel K6's route (``triflow_tpu_torch.ops.megastep``): small grids step
in one launch.  On the CPU every wrapper takes K6's plain version, which
composes the plain chunked factor, sweep, PCR and combination on K6's
plan; these tests hold that route against the JAX package's own step,
float64 on the CPU, from one state handed to both.

* ``plan_for`` admits the README grid and small periodic grids, whose
  ring closes block-cyclic on a power-of-two plan and through the
  Woodbury correction on any other, and refuses what the multi-launch
  path serves;
* one Theta step and one fixed RODASPR step (README model, N = 200,
  Dirichlet hook; KS at N = 256, s = 2; a two-variable model at N = 512,
  s = 4; Woodbury plans of KS at N = 200 and the two-variable model at
  N = 600) within 1e-10 relative of JAX;
* the adaptive output steps of the null-hook route (one K6 launch each on
  the card) take the attempts JAX's RODASPR takes, and the states agree to
  1e-9 relative; no attempt's err lies within 1e-6 relative of ``tol``
  (the decision ``err <= tol`` could flip there), which the test asserts;
* ``device_fixed_scan`` over 3 steps equals 3 single steps exactly and
  agrees with JAX's 3 steps;
* ``max_iter`` and ``dt_min`` raise ``RuntimeError`` through the route;
* the schemes call ``ops.megastep`` where the plan admits the grid and the
  multi-launch chunked path where it does not.
"""

import numpy as np
import pytest
import torch

import triflow_tpu as tj
import triflow_tpu_torch as tt
from triflow_tpu_torch.ops import chunked, megastep
from triflow_tpu_torch.utils.convert import state_from_numpy

from .test_torch_theta import (KS, README, dirichlet_jax, dirichlet_torch,
                               ks_state, readme_state)

torch.set_num_threads(1)

TWO_VAR = (["-dxq", "-dx(q**2/h) - h * dxxxh + q / h"], ["h", "q"], [])


def two_var_state(N, periodic):
    """The state of the reference's megastep tests (tests/test_megastep.py)."""
    rng = np.random.RandomState(3)
    i = np.arange(N)
    h, q = (1.2 + 0.1 * np.cos(2 * np.pi * i / N * 5 + k) + 0.01 * rng.randn(N)
            for k in range(2))
    return {"x": i * 0.5, "h": h, "q": q}, dict(periodic=periodic)


def _both(eqs, state):
    fields_np, pars = state
    model_j = tj.Model(*eqs)
    model_t = tt.Model(*eqs, device="cpu")
    fields_j = model_j.fields_template(**fields_np)
    fields_t, pars_t = state_from_numpy(fields_np, pars, model_t)
    return model_j, fields_j, model_t, fields_t, pars, pars_t


def _hooks(hooked):
    return ((dirichlet_jax, dirichlet_torch) if hooked
            else (tj.schemes.null_hook, tt.schemes.null_hook))


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_plan_for_gate():
    readme = megastep.plan_for(200, 1, 1, False)
    assert readme is not None and not readme.cyclic and readme.Mc >= 2
    ks = megastep.plan_for(256, 1, 2, True)
    assert ks is not None and ks.cyclic and ks.s == 2
    assert ks.C >= chunked.MIN_CYCLIC_C and ks.C & (ks.C - 1) == 0
    assert megastep.plan_for(1 << 13, 1, 2, True) is not None
    assert megastep.plan_for(512, 2, 2, True).s == 4
    # KS at N = 200: no power-of-two chunk count >= 8 divides its 100
    # supernodes, so its ring closes through the Woodbury correction
    ks200 = megastep.plan_for(200, 1, 2, True)
    assert ks200 is not None and ks200.woodbury and ks200.C * ks200.Mc == 100
    burgers = megastep.plan_for(10 ** 4, 1, 1, True)
    assert burgers.woodbury and burgers.C & (burgers.C - 1)
    # above the gate, and blocks wider than the kernels' s <= 4
    assert megastep.plan_for(2 * megastep.MAX_N[1], 1, 1, True) is None
    assert megastep.make_plan(2 * megastep.MAX_N[1], 1, 1, True) is not None
    assert megastep.plan_for(512, 3, 2, True) is None
    assert megastep.plan_for(512, 1, 5, False) is None
    # a block size no sweep measured (s = 3) has no K6 plan: the
    # multi-launch path serves it
    assert megastep.make_plan(512, 3, 1, False) is None
    assert megastep.plan_for(512, 3, 1, False) is None
    # the plan is the chunk count of least modelled cost on the cluster
    # cluster_plan places it on, from the fit alone
    costs = {C: megastep.layout_cost_us(256, 1, 2, True, C) for C in (8, 16, 32, 64)}
    assert ks.C == min(costs, key=costs.get)


#: (name, equations, state, dt, hooked)
STEP_CASES = [
    ("readme", README, readme_state(), 5.0, True),
    ("ks-256", KS, ks_state(256), 0.05, False),
    ("two-var-512", TWO_VAR, two_var_state(512, True), 0.02, False),
    ("two-var-512-edge", TWO_VAR, two_var_state(512, False), 0.02, False),
    ("ks-200-woodbury", KS, ks_state(200), 0.05, False),
    ("two-var-600-woodbury", TWO_VAR, two_var_state(600, True), 0.02, False),
]


@pytest.mark.parametrize("scheme", ["Theta", "RODASPR"])
@pytest.mark.parametrize("name,eqs,state,dt,hooked", STEP_CASES,
                         ids=[c[0] for c in STEP_CASES])
def test_one_step_matches_jax(scheme, name, eqs, state, dt, hooked):
    import jax

    model_j, fields_j, model_t, fields_t, pars, pars_t = _both(eqs, state)
    hook_j, hook_t = _hooks(hooked)
    periodic = bool(pars["periodic"])
    kw = {"theta": 1.0} if scheme == "Theta" else {"time_stepping": False,
                                                   "tol": 1e-3}
    ref = getattr(tj.schemes, scheme)(model_j, **kw)
    port = getattr(tt.schemes, scheme)(model_t, **kw)
    N = state[0]["x"].size
    plan = port._mega_plan(N, periodic)
    assert plan is not None and plan.woodbury == name.endswith("woodbury")
    u, h, p, x = ref._split(fields_j, pars)
    u_j, *_, err_j = jax.jit(ref.device_fixed_step(hook_j, periodic))(
        0.0, u, h, p, x, dt)
    problem = port._problem(hook_t, periodic)
    u_t, *_, err_t = port.fixed_step(problem, 0.0, *port._split(fields_t, pars_t),
                                     dt)
    assert _rel(u_t.numpy(), np.asarray(u_j)) <= 1e-10
    if scheme == "RODASPR":
        assert float(err_t) == pytest.approx(float(err_j), rel=1e-9)


def test_theta_half_step_matches_jax():
    """Crank-Nicolson (theta = 0.5) on the README model through K6."""
    model_j, fields_j, model_t, fields_t, pars, pars_t = _both(
        README, readme_state())
    _, out_j = tj.schemes.Theta(model_j, theta=0.5)(0.0, fields_j, 5.0, pars,
                                                    hook=dirichlet_jax)
    _, out_t = tt.schemes.Theta(model_t, theta=0.5)(0.0, fields_t, 5.0, pars_t,
                                                    hook=dirichlet_torch)
    assert _rel(out_t["U"].numpy(), np.asarray(out_j["U"])) <= 1e-10


def _record_plain_errors(monkeypatch):
    errs = []
    plain = megastep.step_plain

    def recording(*args):
        out = plain(*args)
        errs.append(float(out[-1]))
        return out

    monkeypatch.setattr(megastep, "step_plain", recording)
    return errs


def _adaptive_route(N, monkeypatch):
    model_j, fields_j, model_t, fields_t, pars, pars_t = _both(KS, ks_state(N))
    calls = []
    adaptive = megastep.row_adaptive_step

    def counting(*args, **kw):
        calls.append(1)
        return adaptive(*args, **kw)

    monkeypatch.setattr(megastep, "row_adaptive_step", counting)
    errs = _record_plain_errors(monkeypatch)
    sim_j = tj.Simulation(model_j, fields_j, pars, dt=1.0, tmax=4.0, tol=1e-3)
    sim_t = tt.Simulation(model_t, fields_t, pars_t, dt=1.0, tmax=4.0, tol=1e-3)
    traj_j = [(t, np.asarray(f["U"]), sim_j._scheme._internal_iter)
              for t, f in sim_j]
    traj_t = [(t, f["U"].clone().numpy(), sim_t._scheme._internal_iter)
              for t, f in sim_t]
    assert len(calls) == len(traj_t) == len(traj_j) == 4
    assert sum(it for *_, it in traj_t) > 4  # some retries
    assert len(errs) == sum(it for *_, it in traj_t)
    for (t_j, u_j, it_j), (t_t, u_t, it_t) in zip(traj_j, traj_t):
        assert t_t == pytest.approx(t_j, rel=1e-14)
        assert it_t == it_j
        assert _rel(u_t, u_j) <= 1e-9
    margin = min(abs(e / 1e-3 - 1.0) for e in errs)
    assert margin > 1e-6, f"an attempt's err is within {margin:.1e} of tol"


def test_adaptive_route_matches_jax(monkeypatch):
    """KS at N = 256, periodic, tol 1e-3, no hook: every output step is one
    call of K6's adaptive entry (its plain version here)."""
    _adaptive_route(256, monkeypatch)


def test_adaptive_route_matches_jax_on_a_woodbury_plan(monkeypatch):
    """The same at N = 200, whose ring closes through the Woodbury
    correction (C = 25)."""
    assert megastep.plan_for(200, 1, 2, True).woodbury
    _adaptive_route(200, monkeypatch)


@pytest.mark.parametrize("scheme", ["Theta", "RODASPR"])
def test_fixed_scan_equals_single_steps(scheme):
    model_j, fields_j, model_t, fields_t, pars, pars_t = _both(KS, ks_state(256))
    kw = {"theta": 1.0} if scheme == "Theta" else {"time_stepping": False,
                                                   "tol": None}
    port = getattr(tt.schemes, scheme)(model_t, **kw)
    scan = port.device_fixed_scan(256, periodic=True)
    assert scan is not None
    u, h, p, x = port._split(fields_t, pars_t)
    got = scan(0.0, u, h, p, x, 0.02, 3)
    problem = port._problem(tt.schemes.null_hook, True)
    want = u
    for i in range(3):
        want = port.fixed_step(problem, 0.02 * i, want, h, p, x, 0.02)[0]
    assert torch.equal(got, want)
    ref = getattr(tj.schemes, scheme)(model_j, **kw)
    t_j, f_j = 0.0, fields_j
    for _ in range(3):
        t_j, f_j = ref(t_j, f_j, 0.02, pars)
    assert _rel(got.numpy()[0], np.asarray(f_j["U"])) <= 1e-10
    # no plan, no scan: the multi-launch path serves the grid
    assert port.device_fixed_scan(2 * megastep.MAX_N[2]) is None
    if scheme == "Theta":
        assert tt.schemes.Theta(model_t, theta=0).device_fixed_scan(256) is None


@pytest.mark.parametrize("knob,message", [
    ({"max_iter": 1}, "above max iterations authorized"),
    ({"dt_min": 0.5, "tol": 1e-12}, "time step less than authorized"),
], ids=["max_iter", "dt_min"])
def test_status_codes_raise_through_the_route(knob, message, monkeypatch):
    _, _, model_t, fields_t, _, pars_t = _both(KS, ks_state(256))
    calls = []
    adaptive = megastep.row_adaptive_step

    def counting(*args, **kw):
        calls.append(1)
        return adaptive(*args, **kw)

    monkeypatch.setattr(megastep, "row_adaptive_step", counting)
    with pytest.raises(RuntimeError, match=message):
        tt.schemes.RODASPR(model_t, **{"tol": 1e-3, **knob})(0.0, fields_t, 1.0,
                                                             pars_t)
    assert calls == [1]


def test_route_follows_the_plan(monkeypatch):
    """K6 where ``plan_for`` admits the grid, the chunked multi-launch path
    (``chunked.factor``) where it does not; the hook or the interpolating
    mode keeps the host loop, whose attempts still take K6's step."""
    used = []
    for mod, name in ((megastep, "step"), (megastep, "row_adaptive_step"),
                      (chunked, "factor")):
        orig = getattr(mod, name)

        def spy(*args, _orig=orig, _name=name, **kw):
            used.append(_name)
            return _orig(*args, **kw)

        monkeypatch.setattr(mod, name, spy)

    def run(N, scheme, **kw):
        used.clear()
        fields_np, pars = ks_state(N)
        model = tt.Model(*KS, device="cpu")
        fields, pars_t = state_from_numpy(fields_np, pars, model)
        getattr(tt.schemes, scheme)(model, **kw)(0.0, fields, 0.01, pars_t)
        return sorted(set(used))

    big = 2 * megastep.MAX_N[2]
    assert run(256, "Theta") == ["step"]
    assert run(256, "RODASPR", time_stepping=False, tol=None) == ["step"]
    assert run(256, "RODASPR", tol=1e-1) == ["row_adaptive_step"]
    assert run(256, "RODASPR", tol=1e-1, recompute_target=False) == ["step"]
    monkeypatch.setattr(megastep, "MAX_N", {**megastep.MAX_N, 2: 128})
    assert run(256, "Theta") == ["factor"]
    assert run(256, "RODASPR", tol=1e-1) == ["factor"]
    assert megastep.plan_for(big, 1, 2, True) is None
