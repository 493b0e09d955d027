"""The port's Rosenbrock-Wanner schemes against the JAX package's, float64
on the CPU, from one state handed to both with ``state_from_numpy``.

* the Hairer-Wanner transformed tables of ROS2, ROS3PRw, ROS3PRL and
  RODASPR equal the reference's exactly;
* one fixed step of each scheme, on the README model (Dirichlet hook), on
  Burgers and on Kuramoto-Sivashinsky (N = 256, and N = 1000, whose
  periodic plans close the ring through the Woodbury correction), within
  1e-11 max|u|, and the same embedded error;
* adaptive trajectories (``Simulation``'s defaults: RODASPR with its own
  controller) within 1e-9 max|u| of the reference, with the same number
  of attempts in every output step and the same adapted dt to 1e-8
  relative.  The adapted dt goes as ``err**-1/2``, and ``err`` is a
  difference of stage solutions, of the size of ``tol`` or below: the two
  packages' states agree to ~1e-13 absolute (their banded solvers
  differ), so at tol = 1e-3 the errs that set dt agree to ~1e-9
  relative, not to rounding.  A dt set by an err k times below tol
  carries k times more of that rounding, and how much depends on the
  chunk plan (KS at N = 512 with output steps of 1.0 sets one dt from an
  err of 0.036 tol, which agreed to 3e-9 to 1.7e-8 over chunk counts 8 to
  128), so the cases are chosen with every dt set by an err near tol: KS
  takes output steps of 0.5, whose dts agree to 3.1e-10 or better at
  every one of those chunk counts.  KS at N = 1000 (Woodbury plans) sets
  one dt 2.6e-8 apart at tol 1e-3 and 7.7e-10 apart at tol 3e-3, the
  tolerance its case takes;
* the interpolating mode (``recompute_target=False``) and the status
  codes (``max_iter``, ``dt_min``), which raise the same ``RuntimeError``;
* each of the above on both routes of the port: through kernel K6 (its
  plain version on the CPU), which these small grids take, and, in the
  ``..._multi_launch`` twins, through the multi-launch path of larger grids
  (the stage loop of K5 combinations, biased F and chunked solves);
* ``refine=`` (the reference's iterative refinement of every stage solve
  against J's true bands, through the banded matvec K7): one fixed
  RODASPR step on KS with a block-cyclic (N = 256) and a Woodbury
  (N = 1000) plan and on a two-variable edge model with a Dirichlet hook,
  to 1e-12; adaptive trajectories with equal attempts and dt to 1e-8; and
  the reference's float32 envelope (``tests/test_precision.py``): the f32
  advection-diffusion run with ``refine=1`` within 5e-5 of the f64 run
  after 500 steps.  Such schemes never take K6 (``test_torch_matvec.py``);
* kernel K5's plain version against the reference's ``combine_folded``
  (in interpret mode, on folded arrays) with the rows RODASPR emits, and
  K1's F with a bias against the reference's F times the scale plus the
  bias.

The controller takes a decision on ``err <= tol``, so an attempt whose
error lies within rounding of ``tol`` could go either way in the two
packages.  The adaptive cases below are chosen with no attempt within
1e-6 relative of ``tol``, and each test asserts that margin.
"""

import numpy as np
import pytest
import torch

import triflow_tpu as tj
import triflow_tpu_torch as tt
from triflow_tpu.ops import folded
from triflow_tpu_torch.ops import combine as combine_mod
from triflow_tpu_torch.ops import chunked, megastep, stencil
from triflow_tpu_torch.utils.convert import state_from_numpy

from .test_torch_theta import (BURGERS, KS, README, burgers_state,
                               dirichlet_jax, dirichlet_torch, ks_state,
                               multi_launch, readme_state)

torch.set_num_threads(1)

SCHEMES = ["ROS2", "ROS3PRw", "ROS3PRL", "RODASPR"]

#: (name, equations, state, dt, hooked)
MODELS = [
    ("readme", README, readme_state(), 5.0, True),
    ("burgers", BURGERS, burgers_state(256), 0.05, False),
    ("ks", KS, ks_state(256), 0.05, False),
    ("burgers-1000-woodbury", BURGERS, burgers_state(1000), 0.05, False),
    ("ks-1000-woodbury", KS, ks_state(1000), 0.05, False),
]


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


def _record_errors(scheme, monkeypatch):
    """Wrap the port scheme's fixed step, and the step of K6's plain
    adaptive route, so every attempt's err is kept."""
    errs = []
    step = scheme.fixed_step
    plain = megastep.step_plain

    def recording(*args):
        out = step(*args)
        errs.append(float(out[-1]))
        return out

    def recording_plain(*args):
        out = plain(*args)
        errs.append(float(out[-1]))
        return out

    scheme.fixed_step = recording
    monkeypatch.setattr(megastep, "step_plain", recording_plain)
    return errs


def _assert_not_marginal(errs, tol):
    assert errs, "no attempt was made"
    margin = min(abs(e / tol - 1.0) for e in errs)
    assert margin > 1e-6, f"an attempt's err is within {margin:.1e} of tol"


@pytest.mark.parametrize("name", SCHEMES)
def test_transformed_tables_equal_the_reference(name):
    model_j = tj.Model(*README)
    model_t = tt.Model(*README, device="cpu")
    ref = getattr(tj.schemes, name)(model_j)
    port = getattr(tt.schemes, name)(model_t)
    for attr in ("_a_t", "_c_t", "_m_t", "_m_pred_t"):
        want, got = getattr(ref, attr), getattr(port, attr)
        if want is None:
            assert got is None
        else:
            assert got.dtype == np.float64
            assert np.array_equal(got, want), attr


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("name,eqs,state,dt,hooked", MODELS,
                         ids=[m[0] for m in MODELS])
def test_one_fixed_step_matches_jax(scheme, name, eqs, state, dt, hooked):
    import jax

    model_j, fields_j, model_t, fields_t, pars, pars_t = _both(eqs, state)
    hook_j, hook_t = _hooks(hooked)
    kw = {} if scheme == "ROS2" else {"time_stepping": False}
    ref = getattr(tj.schemes, scheme)(model_j, **kw)
    port = getattr(tt.schemes, scheme)(model_t, **kw)
    periodic = bool(pars["periodic"])
    fixed_j = jax.jit(ref.device_fixed_step(hook_j, periodic))
    u, h, p, x = ref._split(fields_j, pars)
    u_j, *_, err_j = fixed_j(0.0, u, h, p, x, dt)
    problem = port._problem(hook_t, periodic)
    u_t, *_, err_t = port.fixed_step(problem, 0.0, *port._split(fields_t, pars_t),
                                     dt)
    u_j = np.asarray(u_j)
    assert np.abs(u_t.numpy() - u_j).max() <= 1e-11 * np.abs(u_j).max()
    if np.isinf(err_j):
        assert np.isinf(float(err_t))
    else:
        assert float(err_t) == pytest.approx(float(err_j), rel=1e-9)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("name,eqs,state,dt,hooked", MODELS,
                         ids=[m[0] for m in MODELS])
def test_one_fixed_step_matches_jax_multi_launch(multi_launch, scheme, name, eqs,
                                                 state, dt, hooked):
    test_one_fixed_step_matches_jax(scheme, name, eqs, state, dt, hooked)


#: (name, equations, state, output dt, tmax, hooked, Simulation kwargs)
ADAPTIVE = [
    ("readme-defaults", README, readme_state(), 5.0, 50.0, True, {}),
    ("ks-512", KS, ks_state(512), 0.5, 3.0, False, {"tol": 1e-3}),
    ("burgers-2048", BURGERS, burgers_state(2048), 1.0, 5.0, False,
     {"tol": 1e-3}),
    ("ks-1000-woodbury", KS, ks_state(1000), 0.5, 3.0, False, {"tol": 3e-3}),
    ("burgers-1000-woodbury", BURGERS, burgers_state(1000), 1.0, 5.0, False,
     {"tol": 1e-3}),
]


def _trajectories(eqs, state, dt, tmax, hooked, kwargs, monkeypatch):
    model_j, fields_j, model_t, fields_t, pars, pars_t = _both(eqs, state)
    hook_j, hook_t = _hooks(hooked)
    sim_j = tj.Simulation(model_j, fields_j, pars, dt=dt, tmax=tmax,
                          hook=hook_j, **kwargs)
    sim_t = tt.Simulation(model_t, fields_t, pars_t, dt=dt, tmax=tmax,
                          hook=hook_t, **kwargs)
    errs = (_record_errors(sim_t._scheme, monkeypatch)
            if hasattr(sim_t._scheme, "fixed_step") else None)
    traj_j = [(t, np.asarray(f["U"]), sim_j._scheme._internal_iter,
               sim_j._scheme._internal_dt) for t, f in sim_j]
    traj_t = [(t, f["U"].clone().numpy(), sim_t._scheme._internal_iter,
               sim_t._scheme._internal_dt) for t, f in sim_t]
    return sim_t, traj_j, traj_t, errs


def _assert_same_trajectory(traj_j, traj_t, n_steps):
    assert len(traj_j) == len(traj_t) == n_steps
    for (t_j, u_j, it_j, dt_j), (t_t, u_t, it_t, dt_t) in zip(traj_j, traj_t):
        assert t_t == pytest.approx(t_j, rel=1e-14)
        assert it_t == it_j
        assert dt_t == pytest.approx(dt_j, rel=1e-8)
        assert np.abs(u_t - u_j).max() <= 1e-9 * np.abs(u_j).max()


@pytest.mark.parametrize("name,eqs,state,dt,tmax,hooked,kwargs", ADAPTIVE,
                         ids=[c[0] for c in ADAPTIVE])
def test_adaptive_trajectory_matches_jax(name, eqs, state, dt, tmax, hooked,
                                         kwargs, monkeypatch):
    sim, traj_j, traj_t, errs = _trajectories(eqs, state, dt, tmax, hooked,
                                              kwargs, monkeypatch)
    assert isinstance(sim._scheme, tt.schemes.RODASPR)
    assert sim._scheme._time_control and sim.status == "finished"
    _assert_same_trajectory(traj_j, traj_t, round(tmax / dt))
    _assert_not_marginal(errs, kwargs.get("tol", 1e-1))
    assert sum(it for *_, it, _dt in traj_t) > len(traj_t)  # some retries
    if hooked:
        assert traj_t[-1][1][0] == 1.0 and traj_t[-1][1][-1] == 0.0


@pytest.mark.parametrize("name,eqs,state,dt,tmax,hooked,kwargs", ADAPTIVE,
                         ids=[c[0] for c in ADAPTIVE])
def test_adaptive_trajectory_matches_jax_multi_launch(multi_launch, name, eqs,
                                                      state, dt, tmax, hooked,
                                                      kwargs, monkeypatch):
    test_adaptive_trajectory_matches_jax(name, eqs, state, dt, tmax, hooked,
                                         kwargs, monkeypatch)


def test_interpolating_mode_matches_jax(monkeypatch):
    """``recompute_target=False``: internal steps overshoot the output time
    and the output state is interpolated between the bracketing steps."""
    sim, traj_j, traj_t, errs = _trajectories(
        KS, ks_state(512), 1.0, 4.0, False,
        {"tol": 1e-3, "recompute_target": False}, monkeypatch)
    assert not sim._scheme._recompute_target
    _assert_same_trajectory(traj_j, traj_t, 4)
    _assert_not_marginal(errs, 1e-3)


def test_interpolating_mode_matches_jax_multi_launch(multi_launch, monkeypatch):
    test_interpolating_mode_matches_jax(monkeypatch)


@pytest.mark.parametrize("knob,message", [
    ({"max_iter": 1}, "above max iterations authorized"),
    ({"dt_min": 0.5, "tol": 1e-12}, "time step less than authorized"),
], ids=["max_iter", "dt_min"])
def test_status_codes_raise_like_jax(knob, message):
    model_j, fields_j, model_t, fields_t, pars, pars_t = _both(
        KS, ks_state(256))
    kw = {"tol": 1e-3, **knob}
    for pkg, model, fields, p in ((tj, model_j, fields_j, pars),
                                  (tt, model_t, fields_t, pars_t)):
        with pytest.raises(RuntimeError, match=message) as info:
            pkg.schemes.RODASPR(model, **kw)(0.0, fields, 1.0, p)
        assert str(info.value).startswith("Rosenbrock internal")


@pytest.mark.parametrize("knob,message", [
    ({"max_iter": 1}, "above max iterations authorized"),
    ({"dt_min": 0.5, "tol": 1e-12}, "time step less than authorized"),
], ids=["max_iter", "dt_min"])
def test_status_codes_raise_like_jax_multi_launch(multi_launch, knob, message):
    test_status_codes_raise_like_jax(knob, message)


def _stage_combinations(eqs, state, dt, monkeypatch):
    """(rows, arrays) of every K5 call of one RODASPR step of the port's
    multi-launch path (which K6 replaces on grids this small)."""
    monkeypatch.setattr(megastep, "plan_for", lambda *args: None)
    _, _, model_t, fields_t, _, pars_t = _both(eqs, state)
    calls = []
    plain = combine_mod.combine

    def recording(rows, arrays):
        calls.append(([list(r) for r in rows], [a.clone() for a in arrays]))
        return plain(rows, arrays)

    scheme = tt.schemes.RODASPR(model_t, tol=1e-3, time_stepping=False)
    orig = tt.schemes.combine
    tt.schemes.combine = recording
    try:
        scheme(0.0, fields_t, dt, pars_t)
    finally:
        tt.schemes.combine = orig
    return model_t, calls


@pytest.mark.parametrize("case", ["burgers-2048", "ks-4096"])
def test_combine_plain_matches_combine_folded(case, monkeypatch):
    """K5's plain version against ``triflow_tpu.ops.folded.combine_folded``
    run in interpret mode, on the rows and arrays of one real RODASPR step
    (the folded plan needs N / g >= 1024 supernodes)."""
    import jax.numpy as jnp

    monkeypatch.setenv("TRIFLOW_PALLAS_INTERPRET", "1")
    eqs, state = ((BURGERS, burgers_state(2048)) if case == "burgers-2048"
                  else (KS, ks_state(4096)))
    model_t, calls = _stage_combinations(eqs, state, 1e-3, monkeypatch)
    # stages 1..5 combine their inputs, then the final (u_new, diff) pair
    assert len(calls) == 6 and len(calls[-1][1]) == 7 and len(calls[-1][0]) == 2
    sysm = model_t.system
    plan = folded.make_plan(state[0]["x"].size, sysm.nvar, sysm.halo,
                            sysm.window)
    assert plan is not None
    for rows, arrays in calls:
        want = folded.combine_folded(
            rows, [folded.fold(jnp.asarray(a.numpy()), plan) for a in arrays],
            plan)
        got = combine_mod.combine_plain(rows, arrays)
        for row, g, w in zip(rows, got, want):
            # XLA may contract c * a + acc into an FMA: hold the two to
            # rounding of the terms, which can cancel to far below them
            terms = sum(abs(c) * float(a.abs().max())
                        for c, a in zip(row, arrays))
            w = np.asarray(folded.unfold(w, plan))
            assert np.abs(g.numpy() - w).max() <= 1e-14 * terms


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("name,eqs", [("readme", README), ("burgers", BURGERS),
                                      ("ks", KS)])
def test_biased_F_matches_jax(name, eqs, periodic):
    """K1's F entry with a scale and a bias (plain version) against the
    reference's ``scale * F + bias``."""
    rng = np.random.default_rng(3)
    N = 64
    model_j = tj.Model(*eqs)
    model_t = tt.Model(*eqs, device="cpu")
    npar = len(eqs[2])
    u = rng.standard_normal((1, N))
    pstack = 0.5 + rng.random((npar, 1)) * np.ones((1, N))
    x = np.linspace(0.0, 3.0, N)
    helpers = np.zeros((0, N))
    bias = rng.standard_normal((1, N))
    scale = 0.0625
    F_j = model_j.backend.F(u, helpers, pstack, x, periodic=periodic)
    want = scale * np.asarray(F_j) + bias
    got = stencil.eval_F_plain(
        model_t.backend, *(torch.tensor(a) for a in (u, helpers, pstack, x)),
        periodic, scale, torch.tensor(bias)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


TWO_VAR = (["k * dxxU - c * dxV", "k * dxxV - c * dxU + U * V"], ["U", "V"],
           ["k", "c"])


def two_var_state(N=300):
    x = np.linspace(0, 1, N)
    return ({"x": x, "U": np.cos(2 * np.pi * x * 3), "V": np.sin(2 * np.pi * x * 2)},
            dict(periodic=False, k=1e-3, c=3e-3))


def dirichlet2_jax(t, fields, pars):
    fields["U"] = fields["U"].at[0].set(1.0).at[-1].set(0.0)
    fields["V"] = fields["V"].at[0].set(0.0)
    return fields, pars


def dirichlet2_torch(t, fields, pars):
    fields["U"][0] = 1.0
    fields["U"][-1] = 0.0
    fields["V"][0] = 0.0
    return fields, pars


#: (name, equations, state, dt, hooks, refine, plan (cyclic, woodbury))
REFINED = [
    ("ks-256-cyclic", KS, ks_state(256), 0.05, None, 1, (True, False)),
    ("ks-256-cyclic-refine2", KS, ks_state(256), 0.05, None, 2, (True, False)),
    ("ks-1000-woodbury", KS, ks_state(1000), 0.05, None, 1, (False, True)),
    ("two-var-300-edge-hook", TWO_VAR, two_var_state(), 0.5,
     (dirichlet2_jax, dirichlet2_torch), 1, (False, False)),
]


@pytest.mark.parametrize("name,eqs,state,dt,hooks,refine,plan", REFINED,
                         ids=[c[0] for c in REFINED])
def test_refined_fixed_step_matches_jax(name, eqs, state, dt, hooks, refine,
                                        plan):
    import jax

    fields_np, pars = state
    model_j = tj.Model(*eqs)
    model_t = tt.Model(*eqs, device="cpu")
    fields_j = model_j.fields_template(**fields_np)
    fields_t, pars_t = state_from_numpy(fields_np, pars, model_t)
    hook_j, hook_t = hooks or (tj.schemes.null_hook, tt.schemes.null_hook)
    kw = dict(time_stepping=False, tol=1e-3, refine=refine)
    ref = tj.schemes.RODASPR(model_j, **kw)
    port = tt.schemes.RODASPR(model_t, **kw)
    periodic = bool(pars["periodic"])
    sysm = model_t.system
    N = fields_np["x"].size
    p = chunked.make_plan(N, sysm.nvar, sysm.halo, periodic)
    assert (p.cyclic, p.woodbury) == plan
    fixed_j = jax.jit(ref.device_fixed_step(hook_j, periodic))
    u_j, *_, err_j = fixed_j(0.0, *ref._split(fields_j, pars), dt)
    problem = port._problem(hook_t, periodic)
    u_t, *_, err_t = port.fixed_step(problem, 0.0,
                                     *port._split(fields_t, pars_t), dt)
    u_j = np.asarray(u_j)
    assert u_t.shape == u_j.shape
    assert np.abs(u_t.numpy() - u_j).max() <= 1e-12 * np.abs(u_j).max()
    assert float(err_t) == pytest.approx(float(err_j), rel=1e-9)


@pytest.mark.parametrize("name", ["ks-512", "ks-1000-woodbury"])
def test_refined_adaptive_trajectory_matches_jax(name, monkeypatch):
    """Adaptive RODASPR with ``refine=1`` through ``Simulation``: the host
    controller over refined fixed steps; the output steps of the
    unrefined cases keep every dt set by an err near tol."""
    _, eqs, state, dt, tmax, hooked, kwargs = next(c for c in ADAPTIVE
                                                  if c[0] == name)
    sim, traj_j, traj_t, errs = _trajectories(
        eqs, state, dt, tmax, hooked, {**kwargs, "refine": 1}, monkeypatch)
    assert sim._scheme._refine == 1 and sim.status == "finished"
    _assert_same_trajectory(traj_j, traj_t, round(tmax / dt))
    _assert_not_marginal(errs, kwargs["tol"])
    assert sum(it for *_, it, _dt in traj_t) > len(traj_t)


def _advdiff_trajectory(double, steps, N=1024, **scheme_kwargs):
    """``tests/test_precision.py``'s trajectory on the port: fixed RODASPR
    steps of 0.01 of advection-diffusion, periodic, N = 1024."""
    model = tt.Model("k * dxxU - c * dxU", "U", ["k", "c"], double=double,
                     device="cpu")
    scheme = tt.schemes.RODASPR(model, time_stepping=False, tol=None,
                                **scheme_kwargs)
    xs = np.linspace(0, 10, N, endpoint=False)
    fields, pars = state_from_numpy(
        {"x": xs, "U": np.cos(xs * 2 * np.pi / 10) + 2.0},
        dict(k=0.05, c=0.3, periodic=True), model)
    problem = scheme._problem(tt.schemes.null_hook, True)
    u, h, p, x = scheme._split(fields, pars)
    T = scheme._np_dtype
    t, dt = T(0.0), T(0.01)
    for _ in range(steps):
        u, h, p, x, _ = scheme.fixed_step(problem, float(t), u, h, p, x, dt)
        t = t + dt
    return u.double().numpy()


def test_f32_refined_stays_in_envelope():
    """The reference's ``test_f32_options_stay_in_envelope`` for
    ``refine=1``: 500 f32 steps within 5e-5 of the f64 run."""
    err = np.abs(_advdiff_trajectory(False, 500, refine=1)
                 - _advdiff_trajectory(True, 500)).max()
    assert err < 5e-5, err
