"""The port's dp x sp ensembles (``Ensemble(mesh=, space_axis=)``: B
members, each grid cut into shards over the "space" axis) against the JAX
package's on its (2, 4) virtual CPU mesh, float64 on the CPU, from one
numpy sweep (``utils.convert.ensemble_from_numpy``).

The reference's cases of ``tests/test_dp_sp.py`` at its tolerances (the
sharded F is last-ulp different from the single grid's, so adaptive runs
agree to within the controller's tolerance; fixed steps to the
accumulated rounding): RODASPR at tol 1e-6 (2e-6), ROS2 (1e-11), DOPRI5
at tol 1e-7 (2e-7), Theta (1e-11), ``steps(4, dt)``, edge mode, the
Dirichlet hook (1e-11) and the guards; then against the port's own
ensembles: ``per_member_dt`` (member attempts equal, u within 1e-8 of the
unsharded ensemble), the df64 mode (within 1e-12), a member-axis-only
mesh, whose members take the unsharded routes bit for bit, and a
checkpoint resumed on the mesh, bit for bit.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as MeshJ

import triflow_tpu as tj
import triflow_tpu_torch as tt
from triflow_tpu.parallel import Ensemble as EnsembleJ
from triflow_tpu_torch.parallel import Ensemble, Mesh
from triflow_tpu_torch.utils.convert import ensemble_from_numpy

torch.set_num_threads(1)

BURGERS = ("k * dxxU - U * dxU", "U", "k")
README = ("k * dxxU - c * dxU", "U", ["k", "c"])


def mesh_j(ne=2, ns=4):
    return MeshJ(np.array(jax.devices()[: ne * ns]).reshape(ne, ns),
                 ("ensemble", "space"))


def mesh_t(ne=2, ns=4):
    return Mesh.on("cpu", (ne, ns), ("ensemble", "space"))


def sweep(N=256, B=4, seed=0):
    """The reference's sweep: B Burgers members, phases from ``seed``."""
    x = np.linspace(0, 10, N, endpoint=False)
    rng = np.random.RandomState(seed)
    u0 = np.stack([np.cos(2 * np.pi * x / 10 + phi) for phi in rng.rand(B)])
    pars = [dict(k=float(k), periodic=True) for k in np.linspace(0.5, 2.0, B)]
    return x, u0, pars


def port(eqs, u0, x, pars, double=True, **kw):
    model = tt.Model(*eqs, device="cpu", double=double)
    return Ensemble(model, **ensemble_from_numpy(model, u0, x, pars), **kw)


@pytest.fixture(scope="module")
def burgers_j():
    return tj.Model(*BURGERS)


@pytest.mark.parametrize("scheme,kw,atol", [
    ("RODASPR", dict(tol=1e-6), 2e-6),
    ("ROS2", dict(), 1e-11),
    ("DOPRI5", dict(tol=1e-7), 2e-7),
    ("Theta", dict(theta=1.0), 1e-11),
])
def test_dp_sp_matches_jax(burgers_j, scheme, kw, atol):
    x, u0, pars = sweep()
    ref = EnsembleJ(burgers_j, u0, pars, x, scheme=getattr(tj.schemes, scheme),
                    mesh=mesh_j(), space_axis="space", **kw)
    t_j, u_j = ref.run(tmax=0.5, dt=0.125)
    ens = port(BURGERS, u0, x, pars, scheme=getattr(tt.schemes, scheme),
               mesh=mesh_t(), space_axis="space", **kw)
    assert ens.spatial is not None and ens.route == "host"
    t, u = ens.run(tmax=0.5, dt=0.125)
    assert t == pytest.approx(t_j)
    assert np.allclose(u.numpy(), np.asarray(u_j), rtol=1e-9, atol=atol)


def test_dp_sp_steps_and_edge_mode(burgers_j):
    """``steps(4, dt)`` (RODASPR at tol 1e-6) against the reference's, and
    edge mode (the global folds on every member's first and last shard)
    against the reference's run, both at 2e-6."""
    x, u0, pars = sweep()
    kw = dict(scheme=tj.schemes.RODASPR, tol=1e-6)
    ref = EnsembleJ(burgers_j, u0, pars, x, mesh=mesh_j(), space_axis="space",
                    **kw)
    ref.steps(4, 0.125)
    ens = port(BURGERS, u0, x, pars, scheme=tt.schemes.RODASPR, tol=1e-6,
               mesh=mesh_t(), space_axis="space")
    t, u = ens.steps(4, 0.125)
    assert t == pytest.approx(0.5)
    assert np.allclose(u.numpy(), np.asarray(ref.u), rtol=1e-9, atol=2e-6)

    N = 256
    x = np.linspace(0, 10, N)
    u0 = np.stack([np.cos(2 * np.pi * x / 10), np.sin(2 * np.pi * x / 10)])
    pars = [dict(k=0.7, periodic=False), dict(k=1.3, periodic=False)]
    ref = EnsembleJ(burgers_j, u0, pars, x, mesh=mesh_j(), space_axis="space",
                    **kw)
    _, u_j = ref.run(tmax=0.25, dt=0.125)
    ens = port(BURGERS, u0, x, pars, scheme=tt.schemes.RODASPR, tol=1e-6,
               mesh=mesh_t(), space_axis="space")
    _, u = ens.run(tmax=0.25, dt=0.125)
    assert np.allclose(u.numpy(), np.asarray(u_j), rtol=1e-9, atol=2e-6)


def test_dp_sp_dirichlet_hook():
    """The README workload with a Dirichlet hook per member on the global
    state, Theta at fixed dt: 1e-11 (the reference's bar against its single
    chip), the hook's values exact."""
    model_j = tj.Model(*README)
    N, B = 256, 4
    x = np.linspace(0, 1, N)
    rng = np.random.RandomState(1)
    u0 = np.stack([np.cos(2 * np.pi * x * 5 + p) for p in rng.rand(B)])
    pars = [dict(k=1e-3 * (i + 1), c=3e-3, periodic=False) for i in range(B)]

    def dirichlet_j(t, fields, pars):
        fields["U"] = fields["U"].at[0].set(1.0).at[-1].set(0.0)
        return fields, pars

    def dirichlet_t(t, fields, pars):
        fields["U"][0] = 1.0
        fields["U"][-1] = 0.0
        return fields, pars

    ref = EnsembleJ(model_j, u0, pars, x, mesh=mesh_j(), space_axis="space",
                    scheme=tj.schemes.Theta, theta=1.0, hook=dirichlet_j)
    _, u_j = ref.run(tmax=25.0, dt=1.0)
    ens = port(README, u0, x, pars, mesh=mesh_t(), space_axis="space",
               scheme=tt.schemes.Theta, theta=1.0, hook=dirichlet_t)
    _, u = ens.run(tmax=25.0, dt=1.0)
    U = u.numpy()
    assert np.all(U[:, 0, 0] == 1.0) and np.all(U[:, 0, -1] == 0.0)
    assert np.allclose(U, np.asarray(u_j), rtol=1e-9, atol=1e-11)


def test_dp_sp_guards():
    """The reference's guards and messages."""
    x, u0, pars = sweep(B=4)
    with pytest.raises(ValueError, match="space_axis requires a mesh"):
        port(BURGERS, u0, x, pars, space_axis="space")
    with pytest.raises(ValueError, match="space_axis requires a mesh"):
        port(BURGERS, u0, x, pars, mesh=Mesh.on("cpu", 4, ("ensemble",)),
             space_axis="space")
    x3, u3, p3 = sweep(B=3)
    with pytest.raises(ValueError, match="must divide"):
        port(BURGERS, u3, x3, p3, mesh=mesh_t(), space_axis="space")
    x, u0, pars = sweep(N=258, B=4)
    with pytest.raises(ValueError, match="must divide the mesh axis"):
        port(BURGERS, u0, x, pars, mesh=mesh_t(), space_axis="space")
    x, u0, pars = sweep()
    with pytest.raises(TypeError, match="no sharded implementation"):
        port(BURGERS, u0, x, pars, scheme=tt.schemes.DeviceTimeStepping,
             mesh=mesh_t(), space_axis="space")
    with pytest.raises(NotImplementedError, match="A9b"):
        Mesh([["cpu", "cpu"], ["cpu", "cuda:1"]], ("ensemble", "space"))


# ------------------------------------------------- against the port's own

def test_dp_sp_per_member_dt_matches_unsharded():
    """``per_member_dt`` (RODASPR at tol 1e-5, stiffness over three
    decades): every member's attempts those of the unsharded ensemble,
    u within 1e-8 (two solvers of one system)."""
    N, B = 256, 4
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.stack([np.cos(2 * np.pi * x / 10)] * B)
    pars = [dict(k=float(k), periodic=True) for k in (3e-3, 3e-2, 0.3, 3.0)]
    kw = dict(scheme=tt.schemes.RODASPR, tol=1e-5, per_member_dt=True)
    ref = port(BURGERS, u0, x, pars, **kw)
    ens = port(BURGERS, u0, x, pars, mesh=mesh_t(), space_axis="space", **kw)
    for _ in range(2):
        ref.step(0.5)
        ens.step(0.5)
        assert np.array_equal(ens.member_iters, ref.member_iters)
    assert ens.member_iters.max() > ens.member_iters.min()
    assert np.abs(ens.u.numpy() - ref.u.numpy()).max() <= 1e-8


def test_dp_sp_df64_and_member_axis_mesh():
    """The df64 mode on the (2, 4) mesh (ROS2, 2 mixed residual passes a
    stage solve) within 1e-12 of the unsharded df64 ensemble (the full
    float64 solve); a mesh of the member axis alone takes the unsharded
    routes, bit for bit."""
    x, u0, pars = sweep()
    ref = port(BURGERS, u0, x, pars, double="df64", scheme=tt.schemes.ROS2)
    ens = port(BURGERS, u0, x, pars, double="df64", scheme=tt.schemes.ROS2,
               mesh=mesh_t(), space_axis="space")
    assert ens._scheme._passes() == 2
    ref.run(tmax=0.25, dt=0.125)
    t, u = ens.run(tmax=0.25, dt=0.125)
    assert t == ref.t == 0.25
    assert np.abs(u.numpy() - ref.u.numpy()).max() < 1e-12
    kw = dict(scheme=tt.schemes.RODASPR, tol=1e-6)
    a = port(BURGERS, u0, x, pars, **kw)
    b = port(BURGERS, u0, x, pars, mesh=Mesh.on("cpu", 4, ("ensemble",)), **kw)
    c = port(BURGERS, u0, x, pars, mesh=mesh_t(2, 1), space_axis="space", **kw)
    assert b.spatial is None and c.spatial is None and b.route == a.route
    for e in (a, b, c):
        e.run(tmax=0.25, dt=0.125)
    assert torch.equal(a.u, b.u) and torch.equal(a.u, c.u)


def test_dp_sp_checkpoint_resume(tmp_path):
    """``load_ensemble_checkpoint(..., mesh=, space_axis=)`` forwards the
    mesh: the resumed sweep is sharded again and ends bit for bit on the
    uninterrupted one (ROS2, 2 output steps, checkpointed after 1)."""
    x, u0, pars = sweep()
    kw = dict(scheme=tt.schemes.ROS2, mesh=mesh_t(), space_axis="space")
    full = port(BURGERS, u0, x, pars, **kw)
    full.run(tmax=0.25, dt=0.125)
    first = port(BURGERS, u0, x, pars, **kw)
    first.step(0.125)
    path = first.save_checkpoint(tmp_path / "dpsp.h5")
    resumed = Ensemble.from_checkpoint(path, first.model, **kw)
    assert resumed.spatial is not None and resumed.t == 0.125
    resumed.step(0.125)
    assert resumed.t == full.t and torch.equal(resumed.u, full.u)
