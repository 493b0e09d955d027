"""Ensembles of a df64 model and of Theta with a custom solver on the
port, against the JAX package, float64 on the CPU.

The port steps a df64 ensemble in native float64 with float32 step sizes
and controllers deciding in float32 on float64 clocks (the reference's
compensated (hi, lo) member clocks); ``df64_mixed_solve=n`` solves every
stage with a float32 factor of the members' bands and n residual passes
(``ops.mixed.MixedFactorization`` with a member axis: K2-K4 in float32,
K8).  The reference's own df64 ensemble tests (``tests/test_ensemble.py``)
set the cases:

* ROS2 at N = 64, B = 3 members (k = 0.3, 0.5, 0.8), 4 steps of 0.125:
  every member within 1e-12 of the reference's single-grid df64 ROS2 (its
  ``test_ensemble_df64_merged_members_as_chunks``), the output clock bit
  for bit the port's single-grid clock, and more than 1e-9 from the
  float32 ensemble (the reference's guard against a silent float32 run);
  with the full solver through K6 (its plain version), in the
  ``..._multi_launch`` twin through K1-K5, and with the mixed solve;
* ``per_member_dt`` with ``recompute_target=False`` (N = 32, k = 0.4 and
  1.3, tol 1e-7, one output step of 0.7): every member within 1e-11 of the
  reference's single-grid run with the same flags, with its attempts;
* ROS3PRw with ``df64_mixed_solve=1`` at tol 1e-9: the shared and the
  per-member controllers agree to 1e-7, and their output clocks are bit
  for bit the port's single-grid df64 clock (one output step of 0.125,
  where the reference's case takes two: about 280 attempts each on the
  CPU's plain solver);
* the member-axis ``MixedFactorization`` (per-member coef) bit for bit B
  one-grid factorizations on the same chunk plan, and within the mixed
  solve's limit of the float64 solve;
* ``Ensemble(Theta(solver=))``: the solver sees one member's bands, and
  every member is bit for bit the port's single-grid ``Theta(solver=)``
  and within 1e-12 of the reference's vmapped ensemble.
"""

import functools

import numpy as np
import pytest
import torch

import triflow_tpu as tj
import triflow_tpu_torch as tt
from triflow_tpu.parallel import Ensemble as EnsembleJ
from triflow_tpu_torch.ops import chunked, mixed
from triflow_tpu_torch.ops.matvec import banded_matvec_plain
from triflow_tpu_torch.parallel import Ensemble
from triflow_tpu_torch.utils.convert import ensemble_from_numpy, state_from_numpy

from .test_torch_ensemble import multi_launch
from .test_torch_theta import dense_solver_jax, dense_solver_torch

torch.set_num_threads(1)

BURGERS = ("k * dxxU - U * dxU", "U", "k")
HEAT = ("k * dxxU", "U", "k")
KS_COEFS = (0.3, 0.5, 0.8)


def burgers_members(N=64, B=3):
    """The reference's df64 ensemble state: B cosines of 1..B waves."""
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.stack([np.cos(2 * np.pi * x / 10 * (i + 1)) for i in range(B)])
    return x, u0[:, None, :]


def _port_ensemble(eqs, u0, x, coefs, double="df64", **kw):
    model = tt.Model(*eqs, double=double, device="cpu")
    pars = [dict(k=k, periodic=True) for k in coefs]
    return model, Ensemble(model, **ensemble_from_numpy(model, u0, x, pars), **kw)


@functools.lru_cache(maxsize=None)
def _jax_scheme(eqs, scheme, passes, **kw):
    """One reference df64 scheme per case, shared by its members (one
    compile)."""
    model = tj.Model(*eqs, double="df64")
    return model, getattr(tj.schemes, scheme)(model, df64_mixed_solve=passes,
                                               **kw)


@functools.lru_cache(maxsize=None)
def _jax_single(eqs, scheme, N, member, coef, dt, n, passes=None, **kw):
    """The reference's single-grid df64 run of one member: n output steps
    of dt through the scheme's ``__call__`` (its DF state, float64 out),
    from a fresh dt seed."""
    x, u0 = (burgers_members(N) if eqs == BURGERS
             else (np.linspace(0, 10, N, endpoint=False), None))
    if u0 is None:
        u0 = np.cos(x * 2 * np.pi / 10)[None, None, :]
    model, sch = _jax_scheme(eqs, scheme, passes, **kw)
    sch._internal_dt = None
    t, fields = 0.0, model.fields_template(x=x, U=u0[member, 0])
    for _ in range(n):
        t, fields = sch(t, fields, dt, dict(k=coef, periodic=True))
    return np.asarray(fields["U"]), t, getattr(sch, "_internal_iter", None)


def _port_single_clock(eqs, scheme, N, coef, dt, n, **kw):
    """The port's single-grid df64 output clock after n calls."""
    model = tt.Model(*eqs, double="df64", device="cpu")
    x = np.linspace(0, 10, N, endpoint=False)
    fields, pars = state_from_numpy({"x": x, "U": np.cos(x)},
                                    dict(k=coef, periodic=True), model)
    sch = getattr(tt.schemes, scheme)(model, **kw)
    t = 0.0
    for _ in range(n):
        t, fields = sch(t, fields, dt, pars)
    return t


ROS2_CASES = [("full", None, "K6"), ("mixed1", 1, "host")]


def _ros2_case(solver, passes, route):
    x, u0 = burgers_members()
    model, ens = _port_ensemble(BURGERS, u0, x, KS_COEFS, scheme=tt.schemes.ROS2,
                                df64_mixed_solve=passes)
    assert ens.u.dtype == ens.pstack.dtype == torch.float64
    assert ens.route == route
    t, u = ens.run(tmax=0.5, dt=0.125)
    assert t == _port_single_clock(BURGERS, "ROS2", 64, 0.3, 0.125, 4)
    for i, k in enumerate(KS_COEFS):
        want, t_ref, _ = _jax_single(BURGERS, "ROS2", 64, i, k, 0.125, 4,
                                     passes)
        d = np.abs(u[i, 0].numpy() - want).max()
        assert d < 1e-12, (solver, i, d)
        assert t == t_ref
    _, e32 = _port_ensemble(BURGERS, u0, x, KS_COEFS, double=False,
                            scheme=tt.schemes.ROS2)
    e32.run(tmax=0.5, dt=0.125)
    assert np.abs(e32.u.double().numpy() - u.numpy()).max() > 1e-9


@pytest.mark.parametrize("solver,passes,route", ROS2_CASES,
                         ids=[c[0] for c in ROS2_CASES])
def test_df64_ensemble_matches_single_runs(solver, passes, route):
    _ros2_case(solver, passes, route)


def test_df64_ensemble_matches_single_runs_multi_launch(multi_launch):
    _ros2_case("full", None, "host")


def test_df64_per_member_recompute_target_false():
    """The reference's ``test_ensemble_df64_recompute_target_false``: each
    member's interpolated state at the output time within 1e-11 of the
    single-grid run, with its attempts."""
    N, ks, tol = 32, (0.4, 1.3), 1e-7
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.tile(np.cos(x * 2 * np.pi / 10), (len(ks), 1))
    _, ens = _port_ensemble(HEAT, u0, x, ks, scheme=tt.schemes.ROS3PRw,
                            tol=tol, per_member_dt=True,
                            recompute_target=False, df64_mixed_solve=1)
    assert ens.route == "host"
    t, u = ens.step(0.7)
    assert t == float(np.float32(0.7))
    for b, k in enumerate(ks):
        want, t_ref, niter = _jax_single(HEAT, "ROS3PRw", N, 0, k, 0.7, 1, 1,
                                         time_stepping=True, tol=tol,
                                         recompute_target=False)
        d = np.abs(u[b, 0].numpy() - want).max()
        assert d < 1e-11, (b, d)
        assert ens.member_iters[b] == niter
        assert t == t_ref


def test_df64_shared_and_per_member_agree():
    """The reference's ``test_ensemble_df64_adaptive_per_member``: both
    controllers integrate to tol 1e-9, so their states agree to 1e-7; the
    output clocks are the single grid's bit for bit."""
    x, u0 = burgers_members()
    kw = dict(scheme=tt.schemes.ROS3PRw, tol=1e-9, df64_mixed_solve=1)
    _, shared = _port_ensemble(BURGERS, u0, x, KS_COEFS, **kw)
    _, per = _port_ensemble(BURGERS, u0, x, KS_COEFS, per_member_dt=True, **kw)
    t1, u1 = shared.step(0.125)
    t2, u2 = per.step(0.125)
    clock = _port_single_clock(BURGERS, "ROS3PRw", 64, 0.3, 0.125, 1, tol=1e-9,
                               df64_mixed_solve=1)
    assert t1 == t2 == clock == 0.125
    assert per.member_iters.min() >= 1 and shared.attempts >= 1
    assert np.abs(u1.numpy() - u2.numpy()).max() < 1e-7


@pytest.mark.parametrize("periodic", [True, False])
def test_member_axis_mixed_factorization(periodic):
    """B members with their own coef solve as B one-grid factorizations
    on the same chunk plan, bit for bit, and within the mixed solve's limit
    of the float64 solve of each member."""
    B, W, nvar, N, passes = 3, 5, 1, 96, 1
    gen = torch.Generator().manual_seed(4)
    bands = torch.randn((B, W, nvar, nvar, N), generator=gen,
                        dtype=torch.float64)
    bands[:, W // 2] -= 4.0
    rhs = torch.randn((B, nvar, N), generator=gen, dtype=torch.float64)
    coef = torch.tensor([0.05, 0.1, 0.2], dtype=torch.float64)
    plan = chunked.plan_with(N, nvar, W // 2, periodic, 8)
    fact = mixed.MixedFactorization(bands, coef, periodic, plan._replace(B=B),
                                    passes)
    got = fact.solve(rhs)
    for b in range(B):
        one = mixed.MixedFactorization(bands[b], float(coef[b]), periodic, plan,
                                       passes)
        assert torch.equal(got[b], one.solve(rhs[b])), b
        # the residual of the float64 system I - coef J
        res = (got[b] - float(coef[b]) * banded_matvec_plain(bands[b], got[b],
                                                             periodic)) - rhs[b]
        assert res.abs().max() < 1e-11 * rhs[b].abs().max(), b


def test_ensemble_theta_solver_per_member():
    """``Theta(solver=)`` in an ensemble: the solver gets one member's
    bands, and every member is bit for bit the single grid's step, within
    1e-12 of the reference's vmapped ensemble."""
    N, ks, steps, dt = 48, (0.5, 1.0, 1.5), 3, 0.1
    x, u0 = burgers_members(N, len(ks))
    shapes = []

    def solver(A, rhs, periodic):
        shapes.append(tuple(A.shape))
        return dense_solver_torch(A, rhs, periodic)

    model, ens = _port_ensemble(BURGERS, u0, x, ks, double=True,
                                scheme=tt.schemes.Theta, theta=1.0,
                                solver=solver)
    assert ens.route == "host"
    for _ in range(steps):
        ens.step(dt)
    assert set(shapes) == {(3, 1, 1, N)}
    single = tt.schemes.Theta(model, theta=1.0, solver=dense_solver_torch)
    for b, k in enumerate(ks):
        fields, pars = state_from_numpy({"x": x, "U": u0[b, 0]},
                                        dict(k=k, periodic=True), model)
        t = 0.0
        for _ in range(steps):
            t, fields = single(t, fields, dt, pars)
        assert torch.equal(ens.u[b, 0], fields["U"]), b
    model_j = tj.Model(*BURGERS, double=True)
    ens_j = EnsembleJ(model_j, u0, [dict(k=k, periodic=True) for k in ks], x,
                      scheme=tj.schemes.Theta, theta=1.0,
                      solver=dense_solver_jax)
    for _ in range(steps):
        ens_j.step(dt)
    assert np.abs(ens.u.numpy() - np.asarray(ens_j.u)).max() < 1e-12
