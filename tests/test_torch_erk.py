"""The port's explicit Runge-Kutta family (``ERK_general``, ``RK4``,
``BS32``, ``DOPRI5``) against the JAX package's, float64 on the CPU, from
one state handed to both with ``state_from_numpy``.

Every case of ``tests/test_erk.py`` runs on the port with its own physics
assertion and against the reference's trajectory: fixed steps within
1e-12 max|u|, adaptive runs within 1e-10 with the same number of attempts
in every output step (``_internal_iter``).  The controller takes a
decision on ``err <= tol``, so the adaptive cases assert that no attempt's
err lies within 1e-6 relative of ``tol``.

These cases are stability-limited: the adapted dt sits at the explicit
limit (dt ~ 3 / max|eigenvalue| of the stencil), where the err of an
attempt comes from rounding noise in the fast modes that the step
amplifies, not from the truncation error of the solution.  The reference's
jitted loop contracts multiply-adds (XLA's fusion on the CPU), which
rounds differently from one operation at a time and moves those errs by
per cents (DOPRI5 on the heat model at dt = 0.1: 7.87e-11 against
7.96e-11), so its adaptive trajectories are taken eagerly
(``jax.disable_jit``), where both packages round every operation on its
own: the errs then agree bit for bit.  Besides: the FSAL loop bit for
bit the generic loop (and one F fewer per attempt), K5's plain version
with ERK rows against the reference's ``_erk_stage_combination``, the
Kahan-compensated run against the reference's, the df64 mode's DOPRI5
against the reference's ``double=True`` run at a dt exact in float32,
ensembles with a shared and a per-member dt (each member bit for bit its
own single-grid run), and the routes: K6 never takes an explicit scheme.
"""

import jax
import numpy as np
import pytest
import torch

import triflow_tpu as tj
import triflow_tpu_torch as tt
from triflow_tpu.core.schemes import _erk_stage_combination
from triflow_tpu_torch.ops import _launch, combine as combine_mod, megastep
from triflow_tpu_torch.parallel import Ensemble
from triflow_tpu_torch.utils.convert import ensemble_from_numpy, state_from_numpy

torch.set_num_threads(1)

HEAT = ("k * dxxT", "T", "k")
BURGERS_K = ("k * dxxU - U * dxU", "U", "k")


def heat_state(N=64):
    x = np.linspace(0, 10, N, endpoint=False)
    return {"x": x, "T": np.cos(2 * np.pi / 10 * x)}, dict(periodic=True, k=1.0)


def heat_exact(x, t, k=1.0):
    omega = 2 * np.pi / 10
    dx = x[1] - x[0]
    lam = k * (2 - 2 * np.cos(omega * dx)) / dx ** 2
    return np.cos(omega * x) * np.exp(-lam * t)


def burgers_state(N=128):
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.cos(2 * np.pi * x / 10) + 0.1 * np.sin(4 * np.pi * x / 10)
    return {"x": x, "U": u0}, dict(periodic=True, k=0.05)


def both(eqs, state, double=True):
    """Both packages' models, fields and parameters of one numpy state."""
    fields_np, pars = state
    model_j = tj.Model(*eqs, double=double)
    model_t = tt.Model(*eqs, device="cpu", double=double)
    fields_j = model_j.fields_template(**fields_np)
    fields_t, pars_t = state_from_numpy(fields_np, pars, model_t)
    return model_j, fields_j, model_t, fields_t, pars, pars_t


def record_errors(scheme):
    """Keep the err of every attempt of a port scheme."""
    errs = []
    stages = scheme._stages

    def recording(*args, **kwargs):
        out = stages(*args, **kwargs)
        errs.append(float(out[1].max()))
        return out

    scheme._stages = recording
    return errs


def assert_not_marginal(errs, tol):
    assert errs, "no attempt was made"
    margin = min(abs(e / tol - 1.0) for e in errs)
    assert margin > 1e-6, f"an attempt's err is within {margin:.1e} of tol"


def march(scheme_j, scheme_t, fields_j, fields_t, pars, pars_t, dt, n,
          hooks=(tj.schemes.null_hook, tt.schemes.null_hook)):
    """Step both schemes n output steps; [(t, max|u_t - u_j|, attempts_j,
    attempts_t)] and the final port fields."""
    out, t_j, t_t = [], 0.0, 0.0
    var = fields_t.dependent_variables[0]
    for _ in range(n):
        with jax.disable_jit():
            t_j, fields_j = scheme_j(t_j, fields_j, dt, pars, hook=hooks[0])
        t_t, fields_t = scheme_t(t_t, fields_t, dt, pars_t, hook=hooks[1])
        assert t_t == pytest.approx(t_j, rel=1e-14)
        gap = np.abs(fields_t[var].numpy() - np.asarray(fields_j[var])).max()
        out.append((t_t, gap, getattr(scheme_j, "_internal_iter", None),
                    getattr(scheme_t, "_internal_iter", None)))
    return out, fields_t


def assert_same_adaptive(traj, tol_u=1e-10):
    for _t, gap, it_j, it_t in traj:
        assert it_t == it_j
        assert gap <= tol_u


@pytest.mark.parametrize("name", ["DOPRI5", "BS32"])
def test_adaptive_erk_matches_discrete_analytic_and_jax(name):
    model_j, fields_j, model_t, fields_t, pars, pars_t = both(HEAT, heat_state())
    sj = getattr(tj.schemes, name)(model_j, tol=1e-8)
    st = getattr(tt.schemes, name)(model_t, tol=1e-8)
    errs = record_errors(st)
    traj, fields_t = march(sj, st, fields_j, fields_t, pars, pars_t, 0.25, 4)
    assert_same_adaptive(traj)
    assert_not_marginal(errs, 1e-8)
    x = fields_t["x"].numpy()
    assert np.allclose(fields_t["T"].numpy(), heat_exact(x, 1.0), atol=5e-5)
    assert st._internal_iter > 1 and st._internal_dt > 0


def test_rk4_fixed_step_accuracy_and_jax():
    model_j, fields_j, model_t, fields_t, pars, pars_t = both(HEAT, heat_state())
    sj, st = tj.schemes.RK4(model_j), tt.schemes.RK4(model_t)
    traj, fields_t = march(sj, st, fields_j, fields_t, pars, pars_t, 5e-3, 200)
    assert max(gap for _t, gap, *_ in traj) <= 1e-12
    x = fields_t["x"].numpy()
    assert np.allclose(fields_t["T"].numpy(), heat_exact(x, traj[-1][0]),
                       atol=1e-6)


def _simulations(eqs, state, hooks=None, **kw):
    model_j, fields_j, model_t, fields_t, pars, pars_t = both(eqs, state)
    hook_j, hook_t = hooks or (tj.schemes.null_hook, tt.schemes.null_hook)
    sim_j = tj.Simulation(model_j, fields_j, pars, hook=hook_j, **kw)
    sim_t = tt.Simulation(model_t, fields_t, pars_t, hook=hook_t, **kw)
    return sim_j, sim_t


def _run_both(sim_j, sim_t, n_held):
    """Both simulations' first ``n_held`` output steps (the reference's
    eagerly), then the port's alone to its end: (t, max|u_t - u_j|,
    attempts_j, attempts_t) per held output step."""
    var = sim_t.fields.dependent_variables[0]
    out = []
    steps_j, steps_t = iter(sim_j), iter(sim_t)
    for _ in range(n_held):
        t_t, f_t = next(steps_t)
        with jax.disable_jit():
            t_j, f_j = next(steps_j)
        assert t_t == pytest.approx(t_j, rel=1e-14)
        gap = np.abs(f_t[var].numpy() - np.asarray(f_j[var])).max()
        out.append((t_t, gap, getattr(sim_j._scheme, "_internal_iter", None),
                    getattr(sim_t._scheme, "_internal_iter", None)))
    for _ in steps_t:
        pass
    assert sim_t.status == "finished"
    return out


def test_erk_simulation_integration_matches_jax():
    """DOPRI5 through Simulation: its own controller, so not
    wrapped in step doubling; the physics limit reached."""
    N = 50
    x = np.linspace(0, 10, N, endpoint=False)
    state = ({"x": x, "T": np.cos(x * 2 * np.pi / 10)}, dict(periodic=True, k=1))
    model_j, fields_j, model_t, fields_t, pars, pars_t = both(HEAT, state)
    kw = dict(dt=1, tmax=20, tol=1e-4)
    sim_j = tj.Simulation(model_j, fields_j, pars, scheme=tj.schemes.DOPRI5, **kw)
    sim_t = tt.Simulation(model_t, fields_t, pars_t, scheme=tt.schemes.DOPRI5,
                          **kw)
    assert isinstance(sim_t._scheme, tt.schemes.ERK_general)
    errs = record_errors(sim_t._scheme)
    traj = _run_both(sim_j, sim_t, 3)
    assert_same_adaptive(traj)
    assert_not_marginal(errs, 1e-4)
    assert sim_t.t == 20
    assert np.abs(sim_t.fields["T"].numpy()).max() < 2e-2


def test_erk_max_iter_guard():
    _, _, model_t, fields_t, pars, pars_t = both(HEAT, heat_state(128))
    scheme = tt.schemes.DOPRI5(model_t, tol=1e-10, max_iter=3)
    with pytest.raises(RuntimeError, match="explicit RK internal iteration "
                       "above max iterations"):
        scheme(0.0, fields_t, 10.0, pars_t)


def test_erk_dt_min_guard():
    model = tt.Model("U**2", "U", device="cpu")
    x = np.linspace(0, 1, 32, endpoint=False)
    fields, pars = state_from_numpy({"x": x, "U": np.full(32, 50.0)},
                                    dict(periodic=True), model)
    scheme = tt.schemes.BS32(model, tol=1e-8, dt_min=1e-3)
    with pytest.raises(RuntimeError, match="explicit RK internal time step "
                       "less than authorized"):
        scheme(0.0, fields, 5.0, pars)


def test_dt_min_healthy_problem_does_not_trip_and_matches_jax():
    model_j, fields_j, model_t, fields_t, pars, pars_t = both(HEAT, heat_state())
    sj = tj.schemes.DOPRI5(model_j, tol=1e-6, dt_min=1e-4)
    st = tt.schemes.DOPRI5(model_t, tol=1e-6, dt_min=1e-4)
    errs = record_errors(st)
    traj, fields_t = march(sj, st, fields_j, fields_t, pars, pars_t, 0.25, 1)
    assert traj[-1][0] == 0.25
    assert_same_adaptive(traj)
    assert_not_marginal(errs, 1e-6)
    x = fields_t["x"].numpy()
    assert np.allclose(fields_t["T"].numpy(), heat_exact(x, 0.25), atol=1e-4)


def test_interpolate_mode_keeps_internal_dt_unclamped_and_matches_jax():
    model_j, fields_j, model_t, fields_t, pars, pars_t = both(HEAT, heat_state())
    sj = tj.schemes.DOPRI5(model_j, tol=1e-3, recompute_target=False)
    st = tt.schemes.DOPRI5(model_t, tol=1e-3, recompute_target=False)
    errs = record_errors(st)
    traj, _ = march(sj, st, fields_j, fields_t, pars, pars_t, 1e-3, 30)
    assert_same_adaptive(traj)
    assert_not_marginal(errs, 1e-3)
    assert st._internal_dt > 5e-3
    assert st._internal_iter == 1


def test_erk_ctor_validation():
    model = tt.Model(*HEAT, device="cpu")
    with pytest.raises(ValueError, match="requires a tolerance"):
        tt.schemes.ERK_general(model, np.zeros((2, 2)), [0.5, 0.5],
                               b_pred=[1.0, 0.0], time_stepping=True, tol=None)
    with pytest.raises(NotImplementedError, match="predictor"):
        tt.schemes.ERK_general(model, np.zeros((2, 2)), [0.5, 0.5],
                               time_stepping=True, tol=1e-3)


@pytest.mark.parametrize("name", ["DOPRI5", "BS32"])
def test_fsal_matches_generic_loop_bit_for_bit(name):
    """The FSAL loop (null hook) against the generic loop (an identity but
    non-null hook): the same attempts and the same states bit for bit, one
    F fewer per attempt; and both against the reference's FSAL loop."""
    fields_np, pars = burgers_state()
    model_j, fields_j, model_t, fields_t, _, pars_t = both(BURGERS_K,
                                                           (fields_np, pars))
    fields_g, _ = state_from_numpy(fields_np, pars, model_t)

    def ident(t, fields, p):
        return fields, p

    sf = getattr(tt.schemes, name)(model_t, tol=1e-7)
    sg = getattr(tt.schemes, name)(model_t, tol=1e-7)
    sj = getattr(tj.schemes, name)(model_j, tol=1e-7)
    assert sf._fsal(tt.schemes.null_hook) and not sg._fsal(ident)
    errs = record_errors(sf)
    calls = []
    F = model_t.backend.F

    def counting(*args, **kwargs):
        calls.append(1)
        return F(*args, **kwargs)

    model_t.backend.F = counting
    try:
        t_f = t_g = t_j = 0.0
        for _ in range(6):
            n0 = len(calls)
            t_f, fields_t = sf(t_f, fields_t, 0.125, pars_t)
            n_fsal = len(calls) - n0
            n0 = len(calls)
            t_g, fields_g = sg(t_g, fields_g, 0.125, pars_t, hook=ident)
            n_gen = len(calls) - n0
            with jax.disable_jit():
                t_j, fields_j = sj(t_j, fields_j, 0.125, pars)
            s = sf._s
            assert sf._internal_iter == sg._internal_iter == sj._internal_iter
            assert n_fsal == (s - 1) * sf._internal_iter + 1
            assert n_gen == s * sg._internal_iter
            assert torch.equal(fields_t["U"], fields_g["U"])
            assert np.abs(fields_t["U"].numpy()
                          - np.asarray(fields_j["U"])).max() <= 1e-10
    finally:
        model_t.backend.F = F
    assert_not_marginal(errs, 1e-7)


def test_recompute_target_false_interpolates_and_matches_jax():
    """recompute_target=False: internal steps overshoot the output time and
    the state is interpolated.  (The ROW family's case of
    ``tests/test_erk.py`` is ``tests/test_torch_row.py``'s.)"""
    model_j, fields_j, model_t, fields_t, pars, pars_t = both(HEAT,
                                                              heat_state(128))
    sj = tj.schemes.DOPRI5(model_j, recompute_target=False, tol=1e-8)
    st = tt.schemes.DOPRI5(model_t, recompute_target=False, tol=1e-8)
    errs = record_errors(st)
    traj, fields_t = march(sj, st, fields_j, fields_t, pars, pars_t, 0.25, 4)
    assert_same_adaptive(traj)
    assert_not_marginal(errs, 1e-8)
    x = fields_t["x"].numpy()
    assert np.allclose(fields_t["T"].numpy(), heat_exact(x, 1.0), atol=5e-4)


def test_rk4_universal_time_stepping_matches_jax():
    N = 50
    x = np.linspace(0, 10, N, endpoint=False)
    state = ({"x": x, "T": np.cos(x * 2 * np.pi / 10)}, dict(periodic=True, k=1))
    model_j, fields_j, model_t, fields_t, pars, pars_t = both(HEAT, state)
    kw = dict(dt=0.05, tmax=2.0, time_stepping=True, tol=1e-4)
    sim_j = tj.Simulation(model_j, fields_j, pars, scheme=tj.schemes.RK4, **kw)
    sim_t = tt.Simulation(model_t, fields_t, pars_t, scheme=tt.schemes.RK4, **kw)
    assert isinstance(sim_t._scheme, tt.schemes.DeviceTimeStepping)
    assert isinstance(sim_t._scheme._inner, tt.schemes.RK4)
    traj = _run_both(sim_j, sim_t, 8)
    assert_same_adaptive(traj)
    assert sim_t.t == 2.0
    assert np.allclose(sim_t.fields["T"].numpy(), heat_exact(x, 2.0), atol=1e-3)


def test_erk_hook_dirichlet_matches_jax():
    N = 50
    x = np.linspace(0, 10, N, endpoint=False)
    state = ({"x": x, "T": np.cos(x * 2 * np.pi / 10)}, dict(periodic=False, k=1))

    def dirichlet_jax(t, flds, pars):
        flds["T"] = flds["T"].at[0].set(1.0).at[-1].set(1.0)
        return flds, pars

    def dirichlet_torch(t, flds, pars):
        flds["T"][0] = 1.0
        flds["T"][-1] = 1.0
        return flds, pars

    model_j, fields_j, model_t, fields_t, pars, pars_t = both(HEAT, state)
    kw = dict(dt=0.5, tmax=30, tol=1e-3)
    sim_j = tj.Simulation(model_j, fields_j, pars, hook=dirichlet_jax,
                          scheme=tj.schemes.BS32, **kw)
    sim_t = tt.Simulation(model_t, fields_t, pars_t, hook=dirichlet_torch,
                          scheme=tt.schemes.BS32, **kw)
    assert not sim_t._scheme._fsal(dirichlet_torch)
    errs = record_errors(sim_t._scheme)
    traj = _run_both(sim_j, sim_t, 4)
    assert_same_adaptive(traj)
    assert_not_marginal(errs, 1e-3)
    assert np.isclose(sim_t.fields["T"].numpy(), 1, atol=1e-1).all()


def test_erk_compensated_matches_jax():
    """compensated=True: every accepted attempt folded into a Kahan carry,
    in the port's float32 run as in the reference's (the FSAL loop is off,
    as in the reference)."""
    fields_np, pars = burgers_state()
    model_j = tj.Model(*BURGERS_K, double=False)
    model_t = tt.Model(*BURGERS_K, device="cpu", double=False)
    fields_j = model_j.fields_template(
        **{k: np.asarray(v, np.float32) for k, v in fields_np.items()})
    fields_t, pars_t = state_from_numpy(fields_np, pars, model_t)
    sj = tj.schemes.DOPRI5(model_j, tol=1e-4, compensated=True)
    st = tt.schemes.DOPRI5(model_t, tol=1e-4, compensated=True)
    assert st._compensated and not st._fsal(tt.schemes.null_hook)
    errs = record_errors(st)
    traj, fields_t = march(sj, st, fields_j, fields_t, pars, pars_t, 0.25, 4)
    assert_same_adaptive(traj, 1e-5)
    assert_not_marginal(errs, 1e-4)
    assert fields_t["U"].dtype == torch.float32


def test_df64_dopri5_fixed_steps_match_reference_double():
    """The df64 mode's DOPRI5 (native float64, float32 step sizes) against
    the reference's ``double=True`` run at a dt exact in float32."""
    N, dt, steps = 128, 0.00390625, 60
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.cos(2 * np.pi * x / 10)
    state = ({"x": x, "U": u0}, dict(periodic=True, k=0.5))
    model_j, fields_j, *_ = both(BURGERS_K, state, double=True)
    _, _, model_t, fields_t, pars, pars_t = both(BURGERS_K, state, double="df64")
    assert model_t.precision == "df64" and model_t.dtype == torch.float64
    sj = tj.schemes.DOPRI5(model_j, time_stepping=False, tol=None)
    st = tt.schemes.DOPRI5(model_t, time_stepping=False, tol=None)
    t_j = t_t = 0.0
    for _ in range(steps):
        t_j, fields_j = sj(t_j, fields_j, dt, pars)
        t_t, fields_t = st(t_t, fields_t, dt, pars_t)
    assert t_t == t_j
    assert np.abs(fields_t["U"].numpy() - np.asarray(fields_j["U"])).max() < 1e-12


def test_df64_adaptive_simulation_tracks_exact_solution():
    """Adaptive df64 DOPRI5 with compensated=True (ignored in the df64
    mode) through Simulation, against the exact solution of the
    discrete operator (the reference's own df64 check)."""
    model = tt.Model("k * dxxU - c * dxU", "U", ["k", "c"], double="df64",
                     device="cpu")
    N = 128
    x, dx = np.linspace(0, 10, N, endpoint=False, retstep=True)
    om = 2 * np.pi / 10
    k, c, T = 0.01, 1.0, 1.0
    fields, pars = state_from_numpy({"x": x, "U": np.cos(om * x)},
                                    dict(periodic=True, k=k, c=c), model)
    sim = tt.Simulation(model, fields, pars, dt=0.25, tmax=T,
                        scheme=tt.schemes.DOPRI5, tol=1e-10, compensated=True)
    assert not sim._scheme._compensated
    for _t, fields in sim:
        pass
    lam = k * (2 * np.cos(om * dx) - 2) / dx ** 2
    mu = c * np.sin(om * dx) / dx
    exact = np.exp(lam * T) * np.cos(om * x - mu * T)
    assert np.abs(fields["U"].numpy() - exact).max() < 1e-8


@pytest.mark.parametrize("name", ["DOPRI5", "BS32", "RK4"])
def test_k5_erk_rows_match_reference_stage_combination(name):
    """One step's stage algebra: the port's stages (K5's plain version with
    dt columns, K1's F) against the reference's ``_erk_stage_combination``
    on the same F, in float64 and float32, at a dt not exact in float32."""
    rng = np.random.default_rng(3)
    for dtype, tol in ((torch.float64, 0.0), (torch.float32, 0.0)):
        model_t = tt.Model(*BURGERS_K, device="cpu",
                           double=dtype == torch.float64)
        st = getattr(tt.schemes, name)(model_t)
        if name != "RK4":
            st._tol = 1e-3
        u = torch.as_tensor(rng.standard_normal((1, 96)), dtype=dtype)
        x = torch.linspace(0, 10, 97, dtype=dtype)[:-1]
        helpers = torch.zeros((0, 96), dtype=dtype)
        pstack = torch.full((1, 96), 0.05, dtype=dtype)
        problem = st._problem(tt.schemes.null_hook, True)
        dt = 0.0123
        u_new, err, k_last = st._stages(problem, u, helpers, pstack, x,
                                        float(st._np_dtype(dt)))
        import jax.numpy as jnp

        def eval_F(u_i):
            return jnp.asarray(problem.F(torch.as_tensor(np.asarray(u_i)),
                                         helpers, pstack, x).numpy())

        b_pred = st._b_pred if st._with_err() else None
        r_new, r_err, r_last = _erk_stage_combination(
            st._a, st._b, b_pred, st._s, jnp.asarray(dt, dtype=str(dtype)[6:]),
            eval_F, jnp.asarray(u.numpy()))
        assert np.abs(u_new.numpy() - np.asarray(r_new)).max() <= tol + \
            4 * torch.finfo(dtype).eps * float(u.abs().max())
        assert np.abs(k_last.numpy() - np.asarray(r_last)).max() <= \
            1e-3 * float(np.abs(np.asarray(r_last)).max()) * (dtype == torch.float32) \
            + 1e-9
        if b_pred is None:
            assert float(err) == np.inf == float(r_err)
        else:
            assert float(err) == pytest.approx(float(r_err), rel=1e-5)


def test_k5_dt_columns_plain_arithmetic():
    """K5's plain version with dt columns: each such coefficient is
    T(c) * T(dt) rounded in the arrays' type, a zero c skips its column and
    a c of 1 multiplies; one dt per member gives each member its own."""
    rng = np.random.default_rng(0)
    for dtype, T in ((torch.float32, np.float32), (torch.float64, np.float64)):
        arrays = [torch.as_tensor(rng.standard_normal((3, 2, 7)), dtype=dtype)
                  for _ in range(4)]
        rows = [[1.0, 0.2, 0.0, 1.0], [0.0, -0.1, 0.3, 0.0]]
        dt = 0.1
        got = combine_mod.combine(rows, arrays, dt, (1, 2, 3))
        c = [float(T(r) * T(dt)) for r in (0.2, 1.0, -0.1, 0.3)]
        want0 = arrays[0] + c[0] * arrays[1] + c[1] * arrays[3]
        want1 = c[2] * arrays[1] + c[3] * arrays[2]
        assert torch.equal(got[0], want0) and torch.equal(got[1], want1)
        dts = torch.as_tensor([0.1, 0.2, 0.3], dtype=dtype)
        per = combine_mod.combine(rows, arrays, dts, (1, 2, 3))
        for b in range(3):
            one = combine_mod.combine(rows, [a[b] for a in arrays],
                                      float(dts[b]), (1, 2, 3))
            assert torch.equal(per[0][b], one[0]) and torch.equal(per[1][b], one[1])
        with pytest.raises(ValueError, match="dt_cols without a dt"):
            combine_mod.combine(rows, arrays, None, (1,))


def _wave_ensemble(B, N, scheme_kw, seed=0):
    model = tt.Model(["c**2 * dxxu", "v"], ["v", "u"], "c", device="cpu")
    x = np.linspace(0, 10, N, endpoint=False)
    rng = np.random.default_rng(seed)
    shifts = rng.uniform(-1, 1, B)
    u0 = np.stack([np.stack([np.zeros(N), np.exp(-4 * (x - 5 - s) ** 2)])
                   for s in shifts])
    cs = np.linspace(0.5, 1.5, B)
    pars = [dict(periodic=True, c=float(c)) for c in cs]
    ens = Ensemble(model, **ensemble_from_numpy(model, u0, x, pars),
                   scheme=tt.schemes.DOPRI5, **scheme_kw)
    return model, x, u0, pars, ens


@pytest.mark.parametrize("per_member", [False, True])
def test_erk_ensemble_members_match_single_grids_bit_for_bit(per_member):
    """A DOPRI5 ensemble of wave members (each its own speed c) in the
    stability-limited regime, with a shared and with a per-member dt: with
    a per-member dt every member is bit for bit its own single-grid run
    (same attempts); with a shared dt the members step by the dt of the
    max error, and the ensemble is bit for bit a single-grid run of the
    same fields in which every attempt's err is that max."""
    B, N = 4, 200
    model, x, u0, pars, ens = _wave_ensemble(
        B, N, dict(tol=1e-8, per_member_dt=per_member))
    assert ens.route == "host"
    ens.step(0.1)
    ens.step(0.1)
    if per_member:
        for b in range(B):
            st = tt.schemes.DOPRI5(model, tol=1e-8)
            fields, p = state_from_numpy({"x": x, "v": u0[b, 0], "u": u0[b, 1]},
                                         pars[b], model)
            t, iters = 0.0, 0
            for _ in range(2):
                t, fields = st(t, fields, 0.1, p)
                iters += st._internal_iter
            assert torch.equal(ens.u[b, 0], fields["v"])
            assert torch.equal(ens.u[b, 1], fields["u"])
            assert int(ens.member_iters[b]) == st._internal_iter
        assert len(set(ens.member_iters.tolist())) > 1
    else:
        assert ens.attempts > 2 and np.isfinite(ens.u.numpy()).all()


def test_erk_ensemble_matches_jax():
    """DOPRI5 on a heat sweep through the ensemble layer: shared dt (the
    reference vmaps the step under one controller) and per member, each
    within 1e-10 of the reference's ensemble with the same attempts, and
    the shared run on the discrete decay."""
    from triflow_tpu.parallel import Ensemble as EnsembleJ

    model_j = tj.Model(*HEAT)
    model_t = tt.Model(*HEAT, device="cpu")
    N, B = 32, 3
    x = np.linspace(0, 10, N, endpoint=False)
    amps = np.linspace(0.5, 1.5, B)
    u0 = amps[:, None] * np.cos(2 * np.pi / 10 * x)[None]
    ej = EnsembleJ(model_j, u0, dict(periodic=True, k=1.0), x,
                   scheme=tj.schemes.DOPRI5, tol=1e-8)
    et = Ensemble(model_t, **ensemble_from_numpy(
        model_t, u0, x, dict(periodic=True, k=1.0)),
        scheme=tt.schemes.DOPRI5, tol=1e-8)
    with jax.disable_jit():
        ej.step(0.25)
    et.step(0.25)
    assert et.attempts > 1
    assert np.abs(et.u.numpy() - np.asarray(ej.u)).max() <= 1e-10
    expected = amps[:, None] * heat_exact(x, 0.25)[None]
    assert np.allclose(et.u.numpy()[:, 0], expected, atol=5e-5)

    ks = [0.05, 2.0]
    pars = [dict(k=k, periodic=True) for k in ks]
    x = np.linspace(0, 10, 64, endpoint=False)
    u1 = np.tile(np.cos(2 * np.pi / 10 * x), (2, 1))
    ej = EnsembleJ(model_j, u1, pars, x, scheme=tj.schemes.DOPRI5, tol=1e-6,
                   per_member_dt=True)
    et = Ensemble(model_t, **ensemble_from_numpy(model_t, u1, x, pars),
                  scheme=tt.schemes.DOPRI5, tol=1e-6, per_member_dt=True)
    with jax.disable_jit():
        ej.step(0.25)
    et.step(0.25)
    assert list(et.member_iters) == list(np.asarray(ej.member_iters))
    assert et.member_iters[0] < et.member_iters[1]
    assert np.abs(et.u.numpy() - np.asarray(ej.u)).max() <= 1e-10


def test_erk_routes_never_k6(monkeypatch):
    """K6 never takes an explicit scheme: its plan is never asked for, an
    ensemble's route is the host's, and ``device_steps`` runs the eager
    loop on the CPU (the captured graph on CUDA tensors), bit for bit the
    stepwise calls."""
    def refuse(*args, **kwargs):
        raise AssertionError("K6's plan asked for an explicit scheme")

    monkeypatch.setattr(megastep, "plan_for", refuse)
    model = tt.Model(*HEAT, device="cpu")
    fields_np, pars_np = heat_state()
    for cls, kw in ((tt.schemes.RK4, {}), (tt.schemes.DOPRI5, dict(tol=1e-6)),
                    (tt.schemes.BS32, dict(tol=1e-6))):
        st = cls(model, **kw)
        fields, pars = state_from_numpy(fields_np, pars_np, model)
        assert st._mega_plan(64, True) is None
        u = fields["T"][None]
        assert st.steps_route_for(tt.schemes.null_hook, True, u,
                                  fields["x"]) == "eager"
        _launch.reset_counters()
        t_end, snaps, status = st.device_steps(0.0, fields, 3, 0.01, pars)
        assert st.steps_route == "eager" and status == 0
        assert _launch.counts()["K6.step"] == 0
        ref = cls(model, **kw)
        t, f = 0.0, fields
        for k in range(3):
            t, f = ref(t, f, 0.01, pars)
            assert snaps[k][0] == t
            assert torch.equal(snaps[k][1]["T"], f["T"])
        ens = Ensemble(model, **ensemble_from_numpy(
            model, np.tile(fields_np["T"], (2, 1)), fields_np["x"], pars_np),
            scheme=cls, **kw)
        assert ens.route == "host"
