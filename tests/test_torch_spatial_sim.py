"""``Simulation(mesh=)`` and the sharded df64 mode of the port against the
JAX package's on its 8-device virtual CPU mesh, and the sharded driver
against the port's own runs, float64 on the CPU.

* DOPRI5 (adaptive, tol 1e-8) on the advection-diffusion model through
  ``Simulation(mesh=)``: within 1e-8 of the reference's sharded run (its
  own bar against its single grid) and bit for bit the port's single grid
  (an explicit step has no solve, and on this grid every shard's dx is the
  whole grid's, so the sharded F is the single grid's F);
* the README workload (edge mode, a Dirichlet hook, Theta at fixed dt)
  through ``Simulation(mesh=)``: within 1e-10 of max|u| of the reference's
  sharded run, the hook's values exact;
* one fixed df64 step (ROS2 and Theta, 2 mixed residual passes) sharded
  over 8 shards: within 1e-12 of the reference's sharded df64 step (its own
  bar against its single grid);
* against the port's own runs: the adaptive raw stepper
  (``row_stepper(time_stepping=True)``) against the single grid (attempts
  equal, u within 1e-9); step doubling (``time_stepping=True`` around a
  sharded Theta) against the single grid; ``run(device_chunk=n)`` against
  the stepwise sharded run and a checkpoint resume against the
  uninterrupted sharded run, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as MeshJ

import triflow_tpu as tj
import triflow_tpu_torch as tt
from triflow_tpu.parallel.spatial import SpatialModel as SpatialJ
from triflow_tpu_torch.parallel import Mesh, SpatialModel
from triflow_tpu_torch.utils import checkpoint
from triflow_tpu_torch.utils.convert import state_from_df, state_from_numpy

torch.set_num_threads(1)

KS = ("-dxxU - dxxxxU - U * dxU", "U", [])
README = ("k * dxxU - c * dxU", "U", ["k", "c"])


def mesh_j(n=8):
    return MeshJ(np.array(jax.devices()[:n]), ("space",))


def mesh_t(n=8):
    return Mesh.on("cpu", n, ("space",))


def run(pkg, model, fields_np, pars, mesh=None, **kw):
    """A Simulation of either package run to its end: (t, u, simulation)."""
    if pkg is tt:
        fields, pars = state_from_numpy(fields_np, pars, model)
    else:
        fields = model.fields_template(**fields_np)
    sim = pkg.Simulation(model, fields, dict(pars), mesh=mesh, **kw)
    for t, f in sim:
        pass
    return t, np.asarray(f["U"]), sim


def test_dopri5_through_simulation_mesh():
    model_j, model_t = tj.Model(*README), tt.Model(*README, device="cpu")
    N = 256
    x = np.linspace(0, 10, N, endpoint=False)
    fields = {"x": x, "U": np.cos(2 * np.pi * x / 10)}
    pars = dict(periodic=True, k=1e-2, c=0.5)
    kw = dict(dt=0.25, tmax=1.0, scheme=None, tol=1e-8)
    kw_j = dict(kw, scheme=tj.schemes.DOPRI5)
    kw_t = dict(kw, scheme=tt.schemes.DOPRI5)
    t_j, u_j, _ = run(tj, model_j, fields, pars, mesh_j(), **kw_j)
    t_t, u_t, sim = run(tt, model_t, fields, pars, mesh_t(), **kw_t)
    t_1, u_1, _ = run(tt, model_t, fields, pars, **kw_t)
    assert type(sim._scheme).__name__ == "SpatialDOPRI5"
    assert t_t == pytest.approx(t_j) and t_t == t_1
    assert np.allclose(u_t, u_j, rtol=1e-8, atol=1e-8)
    assert np.array_equal(u_t, u_1)


def _dirichlet_j(t, fields, pars):
    fields["U"] = fields["U"].at[0].set(1.0).at[-1].set(0.0)
    return fields, pars


def _dirichlet_t(t, fields, pars):
    fields["U"][0] = 1.0
    fields["U"][-1] = 0.0
    return fields, pars


def test_dirichlet_theta_through_simulation_mesh():
    model_j, model_t = tj.Model(*README), tt.Model(*README, device="cpu")
    x = np.linspace(0, 1, 200)
    fields = {"x": x, "U": np.cos(2 * np.pi * x * 5)}
    pars = dict(periodic=False, k=1e-3, c=3e-3)
    kw = dict(dt=5.0, tmax=50.0, theta=1.0, time_stepping=False)
    _, u_j, _ = run(tj, model_j, fields, pars, mesh_j(), hook=_dirichlet_j,
                    scheme=tj.schemes.Theta, **kw)
    _, u_t, _ = run(tt, model_t, fields, pars, mesh_t(), hook=_dirichlet_t,
                    scheme=tt.schemes.Theta, **kw)
    assert u_t[0] == 1.0 and u_t[-1] == 0.0
    assert np.abs(u_t - u_j).max() <= 1e-10 * np.abs(u_j).max()


@pytest.mark.parametrize("scheme", ["ROS2", "Theta"])
def test_df64_sharded_step_matches_jax(scheme):
    """The reference's df64 state (``_df64_state`` of its tests), one fixed
    step at a float32 dt: within 1e-12."""
    from triflow_tpu.ops.df64 import DF

    model_j = tj.Model(*KS, double="df64")
    model_t = tt.Model(*KS, double="df64", device="cpu")
    N = 256
    x = np.arange(N) * 0.5
    rng = np.random.RandomState(0)
    u = (np.cos(0.1 * x) + 0.05 * rng.randn(N))[None]
    sm_j = SpatialJ(model_j, mesh_j(), periodic=True)
    zero = DF.from_float64(np.zeros((0, N)))
    args_j = (sm_j.shard(DF.from_float64(u)), sm_j.shard(zero),
              sm_j.shard(zero), sm_j.shard(DF.from_float64(x)))
    dt = 0.02 if scheme == "ROS2" else 0.01
    sm_t = SpatialModel(model_t, mesh_t(), periodic=True)
    if scheme == "ROS2":
        step_j = sm_j.row_stepper(tj.schemes.ROS2)
        step_t = sm_t.row_stepper(tt.schemes.ROS2)
    else:
        step_j = sm_j.theta_stepper(theta=1.0)
        step_t = sm_t.theta_stepper(theta=1.0)
    u_j = step_j(jnp.float32(0.0), *args_j, jnp.float32(dt))[1]
    u_j = state_from_df(u_j.hi, u_j.lo)
    z = torch.zeros((0, N), dtype=torch.float64)
    u_t = step_t(0.0, torch.tensor(u), z, z, torch.tensor(x), dt)[1]
    assert np.abs(u_t.numpy() - u_j).max() < 1e-12


# ------------------------------------------------- against the port's own

def _ks_state(N, seed=0):
    x = np.arange(N) * 0.5
    rng = np.random.RandomState(seed)
    return {"x": x, "U": np.cos(0.1 * x) + 0.05 * rng.randn(N)}


def test_adaptive_raw_stepper_matches_single_grid():
    """Two adaptive output steps of 0.25 at tol 1e-5 (the reference's case):
    the attempts of the single grid's, u within 1e-9 (two solvers of one
    system; every accepted dt set by an err away from tol)."""
    model = tt.Model(*KS, device="cpu")
    N = 256
    fields_np = _ks_state(N)
    sm = SpatialModel(model, mesh_t(), periodic=True)
    step = sm.row_stepper(tt.schemes.RODASPR, time_stepping=True, tol=1e-5)
    u = sm.shard(fields_np["U"][None])
    z = torch.zeros((0, N), dtype=torch.float64)
    x = sm.shard(fields_np["x"])
    scheme = tt.schemes.RODASPR(model, time_stepping=True, tol=1e-5)
    fields, pars = state_from_numpy(fields_np, dict(periodic=True), model)
    t, t1, idt = 0.0, 0.0, 1e-6
    for _ in range(2):
        t, u, idt, status = step(t, u, z, z, x, 0.25, idt)
        assert status == 0
        t1, fields = scheme(t1, fields, 0.25, pars)
        assert idt == pytest.approx(scheme._internal_dt, rel=1e-6)
    assert float(t) == pytest.approx(0.5) and float(t) == t1
    assert np.abs(u.numpy() - fields["U"].numpy()).max() <= 1e-9


def test_step_doubling_around_a_sharded_theta():
    """``Simulation(mesh=)`` wraps a sharded Theta in step doubling
    (``time_stepping=True``): the wrapper steps the sharded scheme's problem
    and split (its guards), and lands within 1e-9 of the single grid's."""
    model = tt.Model(*KS, device="cpu")
    fields_np = _ks_state(128)
    kw = dict(dt=0.5, tmax=1.0, scheme=tt.schemes.Theta, theta=1.0, tol=1e-3)
    _, u_t, sim = run(tt, model, fields_np, dict(periodic=True), mesh_t(), **kw)
    _, u_1, _ = run(tt, model, fields_np, dict(periodic=True), **kw)
    assert isinstance(sim._scheme, tt.schemes.DeviceTimeStepping)
    assert sim._scheme._inner._spatial is not None
    assert np.abs(u_t - u_1).max() <= 1e-9
    bad = dict(fields_np, x=np.arange(130) * 0.5, U=np.zeros(130))
    with pytest.raises(ValueError, match="must divide"):
        run(tt, model, bad, dict(periodic=True), mesh_t(), **kw)


def test_chunked_run_and_checkpoint_resume_bit_for_bit():
    """A sharded adaptive run (tol 1e-4, 4 output steps): ``device_chunk=3``
    emits every state of the stepwise run bit for bit (the eager route on
    CPU tensors), and a run checkpointed after 2 steps (``checkpoint_state``)
    and resumed with ``mesh=`` ends bit for bit on the uninterrupted one."""
    model = tt.Model(*KS, device="cpu")
    fields_np = _ks_state(128)
    pars = dict(periodic=True)
    kw = dict(dt=0.5, tmax=2.0, tol=1e-4)

    def sim(**more):
        fields, p = state_from_numpy(fields_np, pars, model)
        return tt.Simulation(model, fields, p, mesh=mesh_t(), **kw, **more)

    def emissions(s, **run_kw):
        seen = []
        s.stream.sink(lambda sm: seen.append((sm.t, sm.fields["U"].clone())))
        s.run(progress=False, **run_kw)
        return seen

    stepwise = emissions(sim())
    chunked = sim()
    got = emissions(chunked, device_chunk=3)
    assert chunked._scheme.steps_route == "eager"
    assert len(got) == len(stepwise) == 5
    for (t1, u1), (t2, u2) in zip(stepwise, got):
        assert t1 == t2 and torch.equal(u1, u2)
    first = sim()
    for _ in range(2):
        next(first)
    attrs, fields = checkpoint.checkpoint_state(first)
    resumed = checkpoint.simulation_from_state(attrs, fields, model,
                                               mesh=mesh_t(), tol=1e-4)
    assert type(resumed._scheme).__name__ == "SpatialRODASPR"
    t, f = resumed.run(progress=False)
    assert t == stepwise[-1][0] and torch.equal(f["U"], stepwise[-1][1])
