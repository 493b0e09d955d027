"""The port's spatial sharding (``parallel.spatial``) against the JAX
package's, float64 on the CPU: the port's mesh is 8 (or 6) shards of one
CPU tensor, the reference's its 8-device virtual mesh
(``tests/conftest.py``), both fed one numpy state.

* the sharded F and J (each shard's halo from its ring neighbours, its own
  dx = x[1] - x[0], the global edges folded in edge mode) against the
  reference's shard-mapped ones, periodic and edge, on a grid whose
  spacing is not exact in float64 (the shards' dx differ from the whole
  grid's in the last ulps), to 1e-12 of max|F| and max|J|; and the plain
  building blocks (``halo_extend``, ``banded_matvec_ext``);
* one fixed step of Theta (KS periodic and edge, the two-variable wave
  model in edge mode), RODASPR (periodic and edge, the 6-shard periodic
  ring with an odd shard size: the Woodbury closure of the interface
  system and padded shards) and RODASPR ``refine=1``: to 1e-10 of the
  reference's sharded step and 1e-8 relative / 1e-9 absolute of the
  port's single grid (held against the reference in its own tests);
* the interface system's closures and the shard counts the port admits (any
  N / ndev >= 2 max(h, 1)) against the single grid; the reference's guards;
  a mesh of distinct devices or of another device than the model's.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as MeshJ

import triflow_tpu as tj
import triflow_tpu_torch as tt
from triflow_tpu.parallel.spatial import SpatialModel as SpatialJ
from triflow_tpu.parallel.spatial import shard_map
from triflow_tpu_torch.parallel import Mesh, SpatialModel
from triflow_tpu_torch.parallel import spatial

torch.set_num_threads(1)

KS = ("-dxxU - dxxxxU - U * dxU", "U", [])
WAVE = (["c**2 * dxxu", "v"], ["v", "u"], ["c"])


def mesh_j(n=8):
    return MeshJ(np.array(jax.devices()[:n]), ("space",))


def mesh_t(n=8):
    return Mesh.on("cpu", n, ("space",))


@pytest.fixture(scope="module")
def ks():
    return tj.Model(*KS), tt.Model(*KS, device="cpu")


@pytest.fixture(scope="module")
def wave():
    return tj.Model(*WAVE), tt.Model(*WAVE, device="cpu")


def states(nvar, N, seed=0, x=None):
    """(x, u (nvar, N)): the reference's test state (x = 0.5 i, a cosine
    and noise from ``seed``)."""
    x = np.arange(N) * 0.5 if x is None else x
    rng = np.random.RandomState(seed)
    u = np.stack([np.cos(0.1 * x + i) + 0.05 * rng.randn(N) for i in range(nvar)])
    return x, u


def inputs(model_t, u, x, pars):
    """The port's (u, helpers, pstack, x) tensors of a numpy state."""
    be = model_t.backend
    xt = torch.tensor(x)
    return (torch.tensor(u), torch.zeros((0, x.size), dtype=torch.float64),
            be.pack_pars(pars, xt), xt)


def inputs_j(sm, model_j, u, x, pars):
    """The reference's sharded (u, helpers, pstack, x)."""
    import jax.numpy as jnp

    be = model_j.backend
    xd = jnp.asarray(x, be.dtype)
    pstack = be.pack_pars(pars, xd)
    return (sm.shard(u), sm.shard(jnp.zeros((0, x.size), be.dtype)),
            sm.shard(pstack), sm.shard(x))


def scaled_gap(got, want):
    """max|got - want| over max(max|want|, 1)."""
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


def ref_J(sm):
    """The reference's sharded J bands of global sharded arrays (its
    ``_local_J`` under its own shard_map)."""
    from jax.sharding import PartitionSpec as P

    spec_state, spec_x, _ = sm._specs()
    return jax.jit(shard_map(
        lambda u, h, p, x: sm._local_J(u, h, p, x)[0], sm.mesh,
        in_specs=(spec_state, spec_state, spec_state, spec_x),
        out_specs=P(None, None, None, sm.axis)))


# ---------------------------------------------------------------- F and J

@pytest.mark.parametrize("periodic", [True, False])
def test_sharded_F_and_J_match_jax(ks, periodic):
    """Tolerance 1e-12 of max|F| and of max|J| (the float64 rounding of
    two evaluations of one stencil)."""
    model_j, model_t = ks
    N = 256
    x = np.linspace(0, 2 * np.pi, N, endpoint=False)
    x, u = states(1, N, seed=1, x=x)
    sm_j = SpatialJ(model_j, mesh_j(), periodic=periodic)
    args_j = inputs_j(sm_j, model_j, u, x, {})
    F_j = sm_j.F()(0.0, *args_j, 0.0)[1]
    J_j = ref_J(sm_j)(*args_j)
    sm_t = SpatialModel(model_t, mesh_t(), periodic=periodic)
    args_t = inputs(model_t, u, x, {})
    F_t = sm_t.F()(0.0, *args_t, 0.0)[1]
    J_t = sm_t._local_J(*args_t)
    assert scaled_gap(F_t, F_j) <= 1e-12
    assert scaled_gap(J_t, J_j) <= 1e-12
    # the shards' dx are not the whole grid's: the single grid is another
    # rounding of the same stencil
    F_1 = model_t.backend.F(*args_t, periodic=periodic)
    assert 0 < scaled_gap(F_t, F_1) <= 1e-9


@pytest.mark.parametrize("periodic", [True, False])
def test_halo_extend_is_the_ring(periodic):
    """The plain halo ring: each shard's ghosts are its neighbours' edge
    nodes (or the clamped global edge), and the haloed band product is the
    global banded matvec (bit for bit: the same products in band order)."""
    from triflow_tpu_torch.core.compiler import to_shards
    from triflow_tpu_torch.ops import matvec

    rng = np.random.default_rng(0)
    ndev, Nl, h, nvar = 4, 6, 2, 2
    N = ndev * Nl
    u = torch.tensor(rng.standard_normal((nvar, N)))
    ext = spatial.halo_extend(to_shards(u, ndev), h, periodic)
    idx = np.arange(-h, N + h).reshape(1, -1)
    idx = np.mod(idx, N) if periodic else np.clip(idx, 0, N - 1)
    for d in range(ndev):
        want = u[:, idx[0, d * Nl:d * Nl + Nl + 2 * h]]
        assert torch.equal(ext[d], want)
    bands = torch.tensor(rng.standard_normal((2 * h + 1, nvar, nvar, N)))
    if not periodic:
        tt.core.compiler.fold_edges(bands, h)
    got = spatial.banded_matvec_ext(
        bands.unflatten(-1, (ndev, Nl)).movedim(-2, 0), ext)
    want = matvec.banded_matvec_plain(bands, u, periodic)
    assert torch.allclose(spatial.from_shards(got), want, rtol=0, atol=1e-13)


# ------------------------------------------------------------ fixed steps

STEP_CASES = {
    # label: (model, N, ndev, periodic, scheme, scheme kwargs, dt, pars)
    "theta ks periodic": ("ks", 512, 8, True, "Theta", dict(theta=1.0), 0.01, {}),
    "theta ks edge": ("ks", 512, 8, False, "Theta", dict(theta=1.0), 0.01, {}),
    "theta wave edge": ("wave", 512, 8, False, "Theta", dict(theta=1.0), 0.01,
                        dict(c=0.8)),
    "rodaspr ks periodic": ("ks", 512, 8, True, "RODASPR", {}, 0.02, {}),
    "rodaspr ks edge": ("ks", 512, 8, False, "RODASPR", {}, 0.02, {}),
    "rodaspr ks periodic refine=1": ("ks", 512, 8, True, "RODASPR",
                                     dict(refine=1), 0.02, {}),
    # N = 510 over 6 shards: 85 nodes a shard (odd at h = 2, so padded to
    # 86 in the interface level) and a ring of 6 shards (Woodbury)
    "rodaspr ks periodic 6 shards": ("ks", 510, 6, True, "RODASPR", {}, 0.02, {}),
}


def _step_j(model_j, case, u, x):
    _, N, ndev, periodic, scheme, kw, dt, pars = case
    sm = SpatialJ(model_j, mesh_j(ndev), periodic=periodic)
    if scheme == "Theta":
        step = sm.theta_stepper(theta=kw["theta"])
    else:
        step = sm.row_stepper(getattr(tj.schemes, scheme), **kw)
    return np.asarray(step(0.0, *inputs_j(sm, model_j, u, x, pars), dt)[1])


def _step_t(model_t, case, u, x, sharded=True):
    _, N, ndev, periodic, scheme, kw, dt, pars = case
    args = inputs(model_t, u, x, pars)
    if not sharded:
        cls = getattr(tt.schemes, scheme)
        kw = dict(kw) if scheme == "Theta" else dict(kw, time_stepping=False,
                                                      tol=None)
        fixed = cls(model_t, **kw).device_fixed_step(periodic=periodic)
        return fixed(0.0, *args, dt)[0].numpy()
    sm = SpatialModel(model_t, mesh_t(ndev), periodic=periodic)
    if scheme == "Theta":
        step = sm.theta_stepper(theta=kw["theta"])
    else:
        step = sm.row_stepper(getattr(tt.schemes, scheme), **kw)
    return step(0.0, *args, dt)[1].numpy()


@pytest.mark.parametrize("label", sorted(STEP_CASES))
def test_sharded_fixed_step_matches_jax(ks, wave, label):
    """1e-10 of max|u| against the reference's sharded step; 1e-8 relative
    and 1e-9 absolute against the port's single grid (the reference's own
    bar for its sharded step against its single grid)."""
    case = STEP_CASES[label]
    model_j, model_t = ks if case[0] == "ks" else wave
    x, u = states(model_t.system.nvar, case[1])
    got = _step_t(model_t, case, u, x)
    assert scaled_gap(got, _step_j(model_j, case, u, x)) <= 1e-10
    single = _step_t(model_t, case, u, x, sharded=False)
    assert np.allclose(got, single, rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("ndev,N,periodic", [
    (2, 64, True), (4, 64, True), (5, 70, True), (8, 64, True), (16, 64, True),
    (3, 66, False), (8, 128, False), (1, 64, True), (1, 64, False),
    # the smallest shards the reference admits: Nl = 2 max(h, 1)
    (8, 32, True), (8, 32, False)])
def test_shard_counts_match_single_grid(ks, ndev, N, periodic):
    """The interface system's closures (block-cyclic at 8 and 16 shards,
    Woodbury at 2-5, acyclic in edge mode, the whole grid at one shard) and
    the smallest shards: one fixed RODASPR step within 1e-12 of the port's
    single grid (both float64 solves of one system)."""
    _, model_t = ks
    x, u = states(1, N, seed=ndev)
    case = ("ks", N, ndev, periodic, "RODASPR", {}, 0.02, {})
    plan = spatial.shard_plan(N, 1, 2, ndev, periodic)
    assert plan.iface.cyclic == (periodic and ndev in (8, 16))
    assert plan.iface.woodbury == (periodic and ndev in (2, 3, 4, 5))
    got = _step_t(model_t, case, u, x)
    single = _step_t(model_t, case, u, x, sharded=False)
    assert scaled_gap(got, single) <= 1e-12


def test_sharded_members_and_per_member_shift(ks):
    """The distributed factorization of B members at once (a per-member
    shift) is each member's own, bit for bit."""
    _, model_t = ks
    N, ndev = 96, 4
    sm = SpatialModel(model_t, mesh_t(ndev), periodic=True)
    rng = np.random.default_rng(2)
    us = torch.tensor(rng.standard_normal((3, 1, N)))
    x = torch.arange(N, dtype=torch.float64) * 0.5
    h0, p0 = (torch.zeros((3, 0, N), dtype=torch.float64),) * 2
    bands = sm._local_J(us, h0, p0, x)
    beta = torch.tensor([-0.01, -0.02, -0.03], dtype=torch.float64)
    rhs = torch.tensor(rng.standard_normal((3, 1, N)))
    got = sm.factor(beta, bands, B=3).solve(rhs)
    for b in range(3):
        one = sm.factor(float(beta[b]), bands[b]).solve(rhs[b])
        assert torch.equal(got[b], one)
    # and the solution solves the global system
    from triflow_tpu_torch.ops import matvec

    r = got + matvec.banded_matvec_plain(bands, got, True, beta) - rhs
    assert r.abs().max() <= 1e-12


def test_guards_and_refusals(ks):
    """The reference's guards (its messages), and what the port's mesh
    refuses: distinct devices (ROADMAP A9b) and another device."""
    _, model_t = ks
    sm = SpatialModel(model_t, mesh_t(), periodic=True)
    with pytest.raises(ValueError, match="must divide the mesh axis"):
        sm.shard(np.zeros(130))
    with pytest.raises(ValueError, match="too small for halo"):
        sm.shard(np.zeros(24))
    with pytest.raises(NotImplementedError, match="A9b"):
        Mesh(np.array([torch.device("cuda", 0), torch.device("cuda", 1)],
                      dtype=object), ("space",))
    with pytest.raises(NotImplementedError, match="A9b"):
        Mesh([["cpu", "cpu"], ["cpu", "meta"]], ("ensemble", "space"))
    with pytest.raises(ValueError, match="lies on"):
        SpatialModel(model_t, Mesh.on("cuda", 8, ("space",)))
    with pytest.raises(ValueError, match="no axis"):
        SpatialModel(model_t, mesh_t(), axis="x")
    with pytest.raises(TypeError, match="no sharded implementation"):
        sm.scheme_class(tt.schemes.DeviceTimeStepping)
    mesh = Mesh(np.full((2, 4), torch.device("cpu"), dtype=object),
                ("ensemble", "space"))
    assert mesh.shape == {"ensemble": 2, "space": 4} and mesh.size == 8
    assert mesh.axis_names == ("ensemble", "space")


# ------------------------------------------------- K1's shard entries (host)

from .test_torch_stencil_J_plans import (FakeCuda, FakeLib, N as FAKE_N,  # noqa: E402,F401
                                         fake_launch, j_inputs, readme_backend)


def test_shard_entries_bind_launch_and_count(readme_backend, fake_launch,
                                             monkeypatch):
    """K1's ``*_shards`` entries on (fake) CUDA tensors: bound by name, the
    shard size passed after the boundary flag, counted apart from the whole
    grid's entries; a grid that does not cut into shards of 2 nodes or more
    is refused before any launch."""
    from triflow_tpu_torch.ops import _launch, stencil

    lib = FakeLib()
    monkeypatch.setattr(readme_backend, "stencil", lib)
    args = j_inputs(B=3)
    before = _launch.counts()
    stencil.eval_J(readme_backend, *args.values(), False, shards=4)
    stencil.eval_F(readme_backend, *args.values(), True, 0.5, None, 4)
    terms = [(1.0, 0.0, args["u"]), (0.5, 0.25, FakeCuda((3, 1, FAKE_N)))]
    stencil.eval_F_terms(readme_backend, terms, args["helpers"], args["pstack"],
                         args["x"], True, 0.5, 4)
    assert lib.bound == ["tf_stencil_J_shards_f64", "tf_stencil_F_shards_f64",
                         "tf_stencil_F_terms_shards_f64"]
    Nl = FAKE_N // 4
    # J: (u, helpers, pstack, x, bands, N, B, periodic, Nl, stream)
    assert lib.calls[0][1][5:9] == (FAKE_N, 3, 0, Nl)
    # F: (..., scale_b, N, B, periodic, Nl, scale, stream)
    assert lib.calls[1][1][7:12] == (FAKE_N, 3, 1, Nl, 0.5)
    # F_terms: (..., scale_b, A, N, B, periodic, Nl, scale, stream)
    assert lib.calls[2][1][7:13] == (2, FAKE_N, 3, 1, Nl, 0.5)
    after = _launch.counts()
    for name in ("K1.J_shards", "K1.F_shards", "K1.F_terms_shards"):
        assert after[name] == before[name] + 1
    for name in ("K1.J", "K1.F", "K1.F_terms"):
        assert after[name] == before[name]
    for shards in (5, FAKE_N):
        with pytest.raises(ValueError, match="shards"):
            stencil.eval_J(readme_backend, *args.values(), True, shards=shards)
        with pytest.raises(ValueError, match="shards"):
            stencil.eval_F(readme_backend, *args.values(), True, 1.0, None,
                           shards)
    assert len(lib.calls) == 3


def test_shard_check_harness_on_cpu():
    """``kernel_checks.check_all_shards`` (the card's checks of the shard
    entries and of the distributed factorization's kernels) runs its
    harness on CPU tensors, where every wrapper takes its plain version:
    each comparison exact, every solve's residual within the solver
    tolerance."""
    from triflow_tpu_torch.ops import kernel_checks

    for dtype in (torch.float64, torch.float32):
        res = kernel_checks.check_all_shards("cpu", dtype)
        assert {"K1.F_shards", "K1.F_terms_shards", "K1.J_shards", "K2.spike_factor",
                "K3.thomas_sweep", "K3.spike_correct", "K4.pcr_solve_shift",
                "K4.pcr_solve", "K4.pcr_factor_members"} <= set(res)
        assert all(v == 0.0 for k, v in res.items() if k != "residual")
        assert res["residual"] <= kernel_checks.TOL[dtype]["solve"]
