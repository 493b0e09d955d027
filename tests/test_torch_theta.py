"""The port's theta step and Simulation against the JAX package's, from one
state handed to both with ``state_from_numpy``.

* one step of Theta (theta = 1, 0.5 and 0) to 1e-11, also on Burgers and
  KS at N = 1000, periodic grids whose plans close the ring through the
  Woodbury correction on both routes;
* ten output steps of the README model (advection-diffusion, N = 200,
  Dirichlet hook) and of Burgers (periodic, N = 2048) to 1e-9 relative to
  max|u|;
* ``Theta(solver=...)``: both packages get the same dense solve of the
  banded matrix they hand it; one step (theta = 1, 0.5 and 0, edge with
  the Dirichlet hook and periodic) to 1e-12, and the README trajectory
  through ``Simulation(..., solver=...)`` to 1e-9.  This path never takes
  K6 (J's bands, dt*F, the right-hand side through K7 and K5, then the
  user's solver).

Each runs on both routes of the port: these grids are small enough for
kernel K6's plan (``ops.megastep.plan_for``), so the tests named
``..._matches_jax`` step through K6 (its plain version on the CPU), and
their ``..._multi_launch`` twins withhold that plan (the ``multi_launch``
fixture), so the same steps take the multi-launch path that larger grids
take (K1-K5's plain versions: the chunked factor, the solve that adds the
state, the stage combinations).

The JAX package steps ``u2 = A^-1 (dt*(F - theta*J*u) + u)``; the port
steps ``u2 = u + A^-1 (dt*F)``.  The two agree to rounding times the
condition number of ``A = I - theta*dt*J``."""

import numpy as np
import pytest
import torch

import triflow_tpu as tj
import triflow_tpu_torch as tt
from triflow_tpu_torch.ops import megastep
from triflow_tpu_torch.utils.convert import ensemble_from_numpy, state_from_numpy

torch.set_num_threads(1)

README = ("k * dxxU - c * dxU", "U", ["k", "c"])
BURGERS = ("-U * dxU + nu * dxxU", "U", ["nu"])
KS = ("-dxxU - dxxxxU - U * dxU", "U", [])


@pytest.fixture
def multi_launch(monkeypatch):
    """Withhold K6's plan from every grid: the schemes take the multi-launch
    path, and the test fails if anything still reaches K6."""
    monkeypatch.setattr(megastep, "plan_for", lambda *args: None)
    reached = []
    for name in ("step", "row_adaptive_step"):
        def refuse(*args, _name=name, **kw):
            reached.append(_name)
            raise AssertionError(f"megastep.{_name} reached with its plan withheld")

        monkeypatch.setattr(megastep, name, refuse)
    yield
    assert not reached


def dirichlet_jax(t, fields, pars):
    fields["U"] = fields["U"].at[0].set(1.0).at[-1].set(0.0)
    return fields, pars


def dirichlet_torch(t, fields, pars):
    fields["U"][0] = 1.0
    fields["U"][-1] = 0.0
    return fields, pars


def readme_state(N=200):
    x = np.linspace(0, 1, N)
    return {"x": x, "U": np.cos(2 * np.pi * x * 5)}, dict(periodic=False,
                                                          k=1e-3, c=3e-3)


def burgers_state(N):
    x = np.arange(N) * 0.5
    return ({"x": x, "U": np.cos(2 * np.pi * np.arange(N) / N * 4)},
            dict(periodic=True, nu=0.5))


def ks_state(N, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 32 * np.pi, N, endpoint=False)
    return {"x": x, "U": np.cos(x / 16) + 0.1 * rng.standard_normal(N)}, \
        dict(periodic=True)


def _both(eqs, state, double=True):
    fields_np, pars = state
    model_j = tj.Model(*eqs)
    model_t = tt.Model(*eqs, double=double, device="cpu")
    fields_j = model_j.fields_template(**fields_np)
    fields_t, pars_t = state_from_numpy(fields_np, pars, model_t)
    return model_j, fields_j, model_t, fields_t, pars, pars_t


ONE_STEP = [
    ("readme-theta1", README, readme_state(), 5.0, 1.0, True),
    ("readme-cn", README, readme_state(), 5.0, 0.5, True),
    ("burgers-theta1", BURGERS, burgers_state(256), 0.05, 1.0, False),
    ("ks-theta1", KS, ks_state(256), 0.01, 1.0, False),
    ("burgers-euler", BURGERS, burgers_state(256), 0.05, 0.0, False),
    ("readme-euler", README, readme_state(), 0.01, 0.0, True),
    ("burgers-1000-woodbury", BURGERS, burgers_state(1000), 0.05, 1.0, False),
    ("ks-1000-woodbury", KS, ks_state(1000), 0.01, 1.0, False),
]


@pytest.mark.parametrize("name,eqs,state,dt,theta,hooked",
                         ONE_STEP, ids=[c[0] for c in ONE_STEP])
def test_one_theta_step_matches_jax(name, eqs, state, dt, theta, hooked):
    model_j, fields_j, model_t, fields_t, pars, pars_t = _both(eqs, state)
    hook_j = dirichlet_jax if hooked else tj.schemes.null_hook
    hook_t = dirichlet_torch if hooked else tt.schemes.null_hook
    t_j, out_j = tj.schemes.Theta(model_j, theta=theta)(0.0, fields_j, dt, pars,
                                                         hook=hook_j)
    t_t, out_t = tt.schemes.Theta(model_t, theta=theta)(0.0, fields_t, dt,
                                                         pars_t, hook=hook_t)
    assert t_t == t_j
    u_j = np.asarray(out_j["U"])
    assert np.abs(out_t["U"].numpy() - u_j).max() <= 1e-11 * np.abs(u_j).max()


@pytest.mark.parametrize("name,eqs,state,dt,theta,hooked",
                         ONE_STEP, ids=[c[0] for c in ONE_STEP])
def test_one_theta_step_matches_jax_multi_launch(multi_launch, name, eqs, state,
                                                 dt, theta, hooked):
    test_one_theta_step_matches_jax(name, eqs, state, dt, theta, hooked)


def _run_both(eqs, state, dt, tmax, hooks):
    model_j, fields_j, model_t, fields_t, pars, pars_t = _both(eqs, state)
    sim_j = tj.Simulation(model_j, fields_j, pars, dt=dt, tmax=tmax,
                          scheme=tj.schemes.Theta, theta=1.0,
                          time_stepping=False, hook=hooks[0])
    sim_t = tt.Simulation(model_t, fields_t, pars_t, dt=dt, tmax=tmax,
                          scheme=tt.schemes.Theta, theta=1.0,
                          time_stepping=False, hook=hooks[1])
    traj_j = [(t, np.asarray(f["U"])) for t, f in sim_j]
    traj_t = [(t, f["U"].clone().numpy()) for t, f in sim_t]
    return sim_t, traj_j, traj_t


@pytest.mark.parametrize("case", ["readme", "burgers"])
def test_simulation_trajectory_matches_jax(case):
    if case == "readme":
        sim, traj_j, traj_t = _run_both(README, readme_state(), 5.0, 50.0,
                                        (dirichlet_jax, dirichlet_torch))
    else:
        sim, traj_j, traj_t = _run_both(BURGERS, burgers_state(2048), 0.05,
                                        0.5, (tj.schemes.null_hook,
                                              tt.schemes.null_hook))
    assert len(traj_t) == len(traj_j) == 10
    assert sim.status == "finished" and sim.i == 10
    for (t_j, u_j), (t_t, u_t) in zip(traj_j, traj_t):
        assert t_t == pytest.approx(t_j, rel=1e-14)
        assert np.abs(u_t - u_j).max() <= 1e-9 * np.abs(u_j).max()
    if case == "readme":
        assert traj_t[-1][1][0] == 1.0 and traj_t[-1][1][-1] == 0.0


@pytest.mark.parametrize("case", ["readme", "burgers"])
def test_simulation_trajectory_matches_jax_multi_launch(multi_launch, case):
    test_simulation_trajectory_matches_jax(case)


def test_dt_clamps_at_tmax():
    fields_np, pars = readme_state(40)
    model = tt.Model(*README, device="cpu")
    fields, pars_t = state_from_numpy(fields_np, pars, model)
    sim = tt.Simulation(model, fields, pars_t, dt=0.3, tmax=1.0,
                        time_stepping=False)
    times = [t for t, _ in sim]
    assert len(times) == 4 and times[-1] == pytest.approx(1.0)
    assert sim.dt == pytest.approx(0.1)


def test_post_process_stream_and_timer():
    fields_np, pars = readme_state(40)
    model = tt.Model(*README, device="cpu")
    fields, pars_t = state_from_numpy(fields_np, pars, model)
    sim = tt.Simulation(model, fields, pars_t, dt=1.0, tmax=3.0,
                        time_stepping=False, hook=dirichlet_torch)
    seen, emitted = [], []
    sim.add_post_process("max", lambda s: seen.append(float(s.fields["U"].max())))
    sim.stream.sink(lambda s: emitted.append(s.i))
    t, fields = sim.run(progress=False)
    assert t == pytest.approx(3.0) and len(seen) == 4
    assert emitted == [0, 1, 2, 3]
    assert sim.timer.total > 0 and "finished" in repr(sim)


def test_unported_features_raise():
    fields_np, pars = readme_state(40)
    model = tt.Model(*README, device="cpu")
    fields, pars_t = state_from_numpy(fields_np, pars, model)
    # the Kahan carry is ported (tests/test_torch_compensated.py)
    assert tt.schemes.RODASPR(model, compensated=True)._compensated
    sim = tt.Simulation(model, fields, pars_t, dt=1.0, compensated=True)
    assert sim._scheme._compensated
    # df64_mixed_solve= is taken on every model and ignored off the df64
    # mode, as in the reference
    tt.schemes.RODASPR(model, df64_mixed_solve=2)
    tt.Simulation(model, fields, pars_t, dt=1.0, df64_mixed_solve=2)
    sim = tt.Simulation(model, fields, pars_t, dt=1.0, tmax=2.0,
                        time_stepping=False)
    # containers are ported (tests/test_torch_persistence.py): an in-memory
    # one takes every emission, the chunked run's snapshots included
    sim.attach_container(None)
    # several output steps per call are ported (device_steps)
    sim.run(progress=False, device_chunk=4)
    assert sim.status == "finished" and sim.i == 2
    assert len(sim.container.data.t) == 3
    with pytest.raises(NotImplementedError):
        tt.Simulation(model, fields, pars_t, dt=1.0, time_stepping=False,
                      mesh=object())
    # an ensemble hands a custom solver one member at a time
    # (tests/test_torch_df64_ensemble.py holds it against one grid)
    x = fields_np["x"]
    ens = tt.parallel.Ensemble(
        model, **ensemble_from_numpy(model, np.stack([fields_np["U"]] * 2),
                                     x, pars),
        scheme=tt.schemes.Theta, solver=dense_solver_torch)
    assert ens.route == "host"


def test_yielded_states_stay_as_yielded():
    """An in-place hook never reaches a state the iterator yielded before."""
    def bump(t, fields, pars):
        fields["U"][0] += 1.0
        return fields, pars

    fields_np, pars = readme_state(40)
    model = tt.Model(*README, device="cpu")
    fields, pars_t = state_from_numpy(fields_np, pars, model)
    sim = tt.Simulation(model, fields, pars_t, dt=1.0, tmax=3.0,
                        time_stepping=False, hook=bump)
    kept = [(f, f["U"].clone()) for _, f in sim]
    assert len(kept) == 3
    assert all(torch.equal(f["U"], u) for f, u in kept)


def test_hook_does_not_touch_the_callers_arrays():
    fields_np, pars = readme_state(40)
    before = fields_np["U"].copy()
    model = tt.Model(*README, device="cpu")
    fields, pars_t = state_from_numpy(fields_np, pars, model)
    sim = tt.Simulation(model, fields, pars_t, dt=1.0, tmax=1.0,
                        time_stepping=False, hook=dirichlet_torch)
    sim.run(progress=False)
    assert np.array_equal(fields_np["U"], before)


def banded_index(W, nvar, N, periodic):
    """(rows, cols, flat band index) of every entry of a banded matrix
    ((W, nvar, nvar, N), node layout) in its dense form."""
    k, m, n, i = np.meshgrid(np.arange(W), np.arange(nvar), np.arange(nvar),
                             np.arange(N), indexing="ij")
    j = i + k - W // 2
    keep = np.ones(j.shape, bool) if periodic else (j >= 0) & (j < N)
    flat = np.arange(W * nvar * nvar * N).reshape(j.shape)
    return m[keep] * N + i[keep], n[keep] * N + j[keep] % N, flat[keep]


def dense_solver_jax(A, B, periodic):
    """The dense solve of the banded system, traced by jax.jit."""
    import jax.numpy as jnp

    W, nvar, _, N = A.shape
    rows, cols, flat = banded_index(W, nvar, N, periodic)
    M = jnp.zeros((nvar * N, nvar * N), A.dtype).at[rows, cols].add(
        A.reshape(-1)[flat])
    return jnp.linalg.solve(M, B.reshape(-1)).reshape(B.shape)


def dense_solver_torch(A, B, periodic):
    """The same dense solve on torch tensors."""
    W, nvar, _, N = A.shape
    rows, cols, flat = (torch.as_tensor(a) for a in banded_index(W, nvar, N,
                                                                  periodic))
    M = torch.zeros((nvar * N, nvar * N), dtype=A.dtype, device=A.device)
    M.index_put_((rows, cols), A.reshape(-1)[flat], accumulate=True)
    return torch.linalg.solve(M, B.reshape(-1)).reshape(B.shape)


SOLVER_STEPS = [c for c in ONE_STEP if c[0] in (
    "readme-theta1", "readme-cn", "burgers-theta1", "ks-theta1",
    "readme-euler", "ks-1000-woodbury")]


@pytest.mark.parametrize("name,eqs,state,dt,theta,hooked", SOLVER_STEPS,
                         ids=[c[0] for c in SOLVER_STEPS])
def test_one_theta_solver_step_matches_jax(name, eqs, state, dt, theta,
                                           hooked):
    model_j, fields_j, model_t, fields_t, pars, pars_t = _both(eqs, state)
    hook_j = dirichlet_jax if hooked else tj.schemes.null_hook
    hook_t = dirichlet_torch if hooked else tt.schemes.null_hook
    calls = []

    def solver(A, B, periodic):
        calls.append(periodic)
        return dense_solver_torch(A, B, periodic)

    scheme_j = tj.schemes.Theta(model_j, theta=theta, solver=dense_solver_jax)
    scheme_t = tt.schemes.Theta(model_t, theta=theta, solver=solver)
    t_j, out_j = scheme_j(0.0, fields_j, dt, pars, hook=hook_j)
    t_t, out_t = scheme_t(0.0, fields_t, dt, pars_t, hook=hook_t)
    assert t_t == t_j
    assert calls == ([] if theta == 0 else [bool(pars["periodic"])])
    u_j = np.asarray(out_j["U"])
    assert np.abs(out_t["U"].numpy() - u_j).max() <= 1e-12 * np.abs(u_j).max()


def test_simulation_with_solver_matches_jax():
    """``Simulation(..., scheme=Theta, solver=...)`` forwards the solver."""
    model_j, fields_j, model_t, fields_t, pars, pars_t = _both(
        README, readme_state())
    sims = [pkg.Simulation(model, fields, p, dt=5.0, tmax=50.0,
                           scheme=pkg.schemes.Theta, theta=1.0,
                           time_stepping=False, solver=solver, hook=hook)
            for pkg, model, fields, p, solver, hook in (
                (tj, model_j, fields_j, pars, dense_solver_jax, dirichlet_jax),
                (tt, model_t, fields_t, pars_t, dense_solver_torch,
                 dirichlet_torch))]
    assert sims[1]._scheme._solver is dense_solver_torch
    traj_j = [(t, np.asarray(f["U"])) for t, f in sims[0]]
    traj_t = [(t, f["U"].clone().numpy()) for t, f in sims[1]]
    assert len(traj_t) == len(traj_j) == 10
    for (t_j, u_j), (t_t, u_t) in zip(traj_j, traj_t):
        assert t_t == pytest.approx(t_j, rel=1e-14)
        assert np.abs(u_t - u_j).max() <= 1e-9 * np.abs(u_j).max()
    assert traj_t[-1][1][0] == 1.0 and traj_t[-1][1][-1] == 0.0
