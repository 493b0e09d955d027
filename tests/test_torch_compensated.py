"""``compensated=True`` (the Kahan-summed state) on the port, against the
JAX package on the CPU.

The reference folds every accepted state into a Kahan carry
(``ops/compensated.py``: Neumaier's four operations): in its adaptive
loops, the carry starting at zero in each output step; across the n steps
of ``device_steps`` (an outer carry) and of the ensembles' fixed
``steps``.  The port runs the same operations in the same order:
``ops.compensated`` on the host, ``kahan_nodes`` in K6.

* ``kahan_update`` bit for bit the reference's, on float32 and float64;
* one adaptive output step of compensated RODASPR (``double=True``) from
  ``device_stepper`` at the reference's own inputs
  (``tests/test_megastep.py:_adaptive_pair``: KS, N = 200, periodic,
  seed 0, tol 1e-4, dt 0.5, internal dt 0.1) on K6's route (its plain
  adaptive entry with the carry) and, in the ``..._multi_launch`` twin,
  on the host controller: the same attempts, u within 1e-12 and the
  adapted dt within 1e-8 relative of the reference's (the limit
  ``tests/test_torch_row.py`` states: the two packages' solvers round
  apart); and two such output steps through ``device_steps``, which a
  compensated scheme runs on the eager route (each output step's own
  carry, and the outer carry across them);
* K6's plain entries from a seeded carry (the step entry over n steps,
  the adaptive scan over several output steps, one grid and a member
  axis) against the host path with the carry on the same inputs;
* fixed-step ``device_steps`` runs of float32 compensated RODASPR against
  the float64 run.  A step's result is a state rounded to float32; where
  it lies within a factor of two of the state before it the update
  ``u_new - u`` is exact (Sterbenz) and the fold returns the step's
  result, so on a positive heat state (N = 64, 2000 steps) the
  compensated run is the plain one bit for bit, in both packages.  Where
  a node crosses zero the fold moves u by rounding: on KS (N = 64, 200
  steps) the compensated run differs from the plain one in both packages
  and lies closer to the float64 run (the test states both distances),
  the K6 route and the eager route agree bit for bit, and the port lies
  within the float32 envelope of the reference's compensated run;
* a compensated ensemble: the K6 route (its plain scan with the carry)
  and the host route agree, bit for bit where the host route steps by
  K6's plain step (a hook sends it there), and each member equals the
  single grid's compensated run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import triflow_tpu as tj
import triflow_tpu_torch as tt
from triflow_tpu.ops.compensated import kahan_update as kahan_j
from triflow_tpu_torch.core import rosenbrock
from triflow_tpu_torch.ops import kernel_checks, megastep
from triflow_tpu_torch.ops.compensated import kahan_update
from triflow_tpu_torch.parallel import Ensemble
from triflow_tpu_torch.utils.convert import ensemble_from_numpy, state_from_numpy

from .test_torch_ensemble import multi_launch

torch.set_num_threads(1)

KS = ("-dxxU - dxxxxU - U * dxU", "U")
HEAT = ("k * dxxU", "U", "k")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_kahan_update_matches_jax(dtype):
    rng = np.random.default_rng(3)
    u = rng.standard_normal(4096).astype(dtype)
    u_new = (u + 1e-3 * rng.standard_normal(4096)).astype(dtype)
    c = (1e-9 * rng.standard_normal(4096)).astype(dtype)
    got = kahan_update(torch.as_tensor(u), torch.as_tensor(c),
                       torch.as_tensor(u_new))
    want = kahan_j(jnp.asarray(u), jnp.asarray(c), jnp.asarray(u_new))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def ks_state(N=200):
    """The reference's ``_adaptive_pair`` state: KS on x = 0.5 i."""
    rng = np.random.RandomState(0)
    u0 = (np.cos(2 * np.pi * np.arange(N) / N * 5) + 0.1 * rng.randn(N))[None]
    return u0, np.arange(N) * 0.5


def _jax_compensated_step(N=200):
    u0, x = ks_state(N)
    model = tj.Model(*KS, double=True)
    d = jnp.float64
    sch = tj.schemes.RODASPR(model, tol=1e-4, compensated=True)
    out = sch.device_stepper(periodic=True)(
        d(0.0), jnp.asarray(u0, d), jnp.zeros((0, N), d), jnp.zeros((0, N), d),
        jnp.asarray(x, d), d(0.5), d(0.1))
    return np.asarray(out[1]), float(out[5]), int(out[6]), int(out[7])


def _port_compensated_step(compensated=True, N=200):
    u0, x = ks_state(N)
    model = tt.Model(*KS, double=True, device="cpu")
    sch = tt.schemes.RODASPR(model, tol=1e-4, compensated=compensated)
    zeros = torch.zeros((0, N), dtype=torch.float64)
    out = sch.device_stepper(periodic=True)(
        0.0, torch.tensor(u0), zeros, zeros, torch.tensor(x), 0.5, 0.1)
    return out[1].numpy(), float(out[5]), int(out[6]), int(out[7])


def _compensated_step_case():
    u_j, dt_j, n_j, st_j = _jax_compensated_step()
    u_t, dt_t, n_t, st_t = _port_compensated_step()
    assert st_t == st_j == 0
    assert n_t == n_j > 1
    assert np.abs(u_t - u_j).max() < 1e-12
    assert abs(dt_t - dt_j) / dt_j < 1e-8


def test_compensated_adaptive_step_matches_jax():
    _compensated_step_case()


def test_compensated_adaptive_step_matches_jax_multi_launch(multi_launch):
    _compensated_step_case()


def _ks_inputs(B, N=128):
    model = tt.Model(*KS, double=True, device="cpu")
    rng = np.random.RandomState(2)
    i = np.arange(N)
    u = np.stack([np.cos(2 * np.pi * i / N * (3 + m)) + 0.05 * rng.randn(N)
                  for m in range(B)])[:, None, :]
    u = torch.tensor(u[0] if B == 1 else u)
    lead = () if B == 1 else (B,)
    zeros = torch.zeros(lead + (0, N), dtype=torch.float64)
    return model, u, zeros, zeros, torch.tensor(i * 0.5)


@pytest.mark.parametrize("B", [1, 3])
def test_k6_compensated_entries_match_host(B):
    """K6's plain step entry over n steps and its plain adaptive scan over
    several output steps, from a seeded carry (a carry folded from zero
    stays zero on these states), against the host path with the carry:
    every fixed step folded in, and the host controller's output steps
    chained, the first from the seeded carry and each later one from
    zero, as the kernel runs them."""
    model, u, h, p, x = _ks_inputs(B)
    sch = tt.schemes.RODASPR(model, tol=1e-4, compensated=True)
    plan = megastep.plan_for(x.shape[-1], 1, 2, True, B)
    assert plan is not None
    table = sch._table(True)
    seed = kernel_checks.seeded_carry(u)
    # the step entry: n fixed steps through one carry
    carry = seed.clone()
    got = megastep.row_step(model.backend, plan, sch._table(False), True, u, h,
                            p, x, 0.05, nsteps=4, carry=carry)[0]
    want, c = u, seed.clone()
    gdt = megastep.gdt_of(np.float64, table.g00, 0.05, u.device)
    for _ in range(4):
        u2 = megastep.step_plain(model.backend, plan, sch._table(False), True,
                                 want, h, p, x, -gdt, gdt)[0]
        want, c = kahan_update(want, c, u2)
    assert torch.equal(got, want) and torch.equal(carry, c)
    assert bool((carry != 0).any())
    # the adaptive scan: three output steps of 0.05
    carry = seed.clone()
    got = megastep.adaptive_scan(
        rosenbrock.member_controller if B > 1 else rosenbrock.adaptive_controller,
        model.backend, plan, table, True, u, h, p, x, 0.0, 0.05, 0.1, 1e-4, 0.9,
        None, None, 3, per_member=B > 1, attempts=True, carry=carry)
    problem = sch._problem(tt.schemes.null_hook, True)
    state, t, dt_i, total = (u, h, p), 0.0, 0.1, 0
    T = np.float64
    for k in range(3):
        c = seed.clone() if k == 0 else torch.zeros_like(u)
        if B > 1:
            def attempt(tb, s, dt_eff):
                out = sch.fixed_step_batched(problem, tb, *s, x, dt_eff)
                return out[:3], out[4].numpy()
            t, state, dt_i, niter, status = rosenbrock.member_controller(
                attempt, T, t, 0.05, dt_i, 1e-4, 0.9, None, None, False, state,
                carry=c)
        else:
            def attempt(t_, s, dt_eff):
                out = sch.fixed_step(problem, float(t_), *s, x, dt_eff)
                return out[:3], T(out[4].item())
            t, state, dt_i, niter, status = rosenbrock.adaptive_controller(
                attempt, T, t, 0.05, dt_i, 1e-4, 0.9, None, None, False, state,
                carry=c)
        assert status == 0
        total = total + niter
    # the host step is K6's plain step on this grid: the same arithmetic
    assert np.array_equal(np.asarray(got[4]), np.asarray(total))
    assert torch.equal(got[0], state[0]) and torch.equal(carry, c)


def test_compensated_float32_fixed_steps():
    """2000 fixed float32 steps through ``device_steps`` with and without
    the carry against the float64 run: bit for bit the same trajectory
    (module doc), so both distances are equal."""
    N, n, dt = 64, 2000, 2e-4
    x = np.linspace(0, 2 * np.pi, N, endpoint=False)
    u0 = 1.0 + 0.5 * np.cos(x)
    finals = {}
    for double, comp in ((True, False), (False, False), (False, True)):
        model = tt.Model(*HEAT, double=double, device="cpu")
        fields, pars = state_from_numpy({"x": x, "U": u0},
                                        dict(k=1.0, periodic=True), model)
        sch = tt.schemes.RODASPR(model, time_stepping=False, tol=None,
                                 compensated=comp)
        t, snaps, status = sch.device_steps(0.0, fields, n, dt, pars)
        assert status == 0 and len(snaps) == n and sch.steps_route == "K6"
        finals[double, comp] = snaps[-1][1]["U"].double().numpy()
    ref = finals[True, False]
    plain = np.abs(finals[False, False] - ref).max()
    comp = np.abs(finals[False, True] - ref).max()
    assert np.array_equal(finals[False, True], finals[False, False]), (plain, comp)
    assert comp == plain and 1e-7 < plain < 1e-4, (plain, comp)
    # the reference's float32 runs of the case, with and without the carry
    jax_runs = []
    for comp_j in (False, True):
        model = tj.Model(*HEAT, double=False)
        sch = tj.schemes.RODASPR(model, time_stepping=False, tol=None,
                                 compensated=comp_j)
        _, snaps, _ = sch.device_steps(0.0, model.fields_template(x=x, U=u0), n,
                                       dt, dict(k=1.0, periodic=True))
        jax_runs.append(np.asarray(snaps[-1][1]["U"]))
    assert np.array_equal(*jax_runs)


def _null(t, fields, pars):
    return fields, pars


def test_compensated_float32_fixed_steps_crossing_zero():
    """200 fixed float32 steps of KS (a state that crosses zero) through
    ``device_steps`` with and without the carry, in both packages, against
    the port's float64 run (within 1e-13 of the reference's).  The carry
    moves both packages' runs (the module doc); the port's compensated run
    is the same on the K6 route and, with a hook, on the eager route, and
    lies within the float32 envelope of the reference's compensated run.
    The distances to the float64 run (port: plain 3.86e-5, compensated
    7.20e-6; reference: 2.59e-5 and 2.21e-5, of max|u| 2.10) are stated
    here, each compensated run the closer."""
    N, n, dt = 64, 200, 0.05
    x = 0.5 * np.arange(N)
    u0 = (np.cos(2 * np.pi * 2 * np.arange(N) / N)
          + 0.1 * np.random.RandomState(0).randn(N))
    assert u0.min() < 0 < u0.max()
    finals = {}
    for double, comp in ((True, False), (False, False), (False, True)):
        model = tt.Model(*KS, double=double, device="cpu")
        fields, pars = state_from_numpy({"x": x, "U": u0},
                                        dict(periodic=True), model)
        sch = tt.schemes.RODASPR(model, time_stepping=False, tol=None,
                                 compensated=comp)
        _, snaps, status = sch.device_steps(0.0, fields, n, dt, pars)
        assert status == 0 and sch.steps_route == "K6"
        finals[double, comp] = snaps[-1][1]["U"].double().numpy()
        if comp:
            _, eager, _ = sch.device_steps(0.0, fields, n, dt, pars, hook=_null)
            assert sch.steps_route == "eager"
            assert torch.equal(eager[-1][1]["U"], snaps[-1][1]["U"])
    ref = finals[True, False]
    plain = np.abs(finals[False, False] - ref).max()
    comp = np.abs(finals[False, True] - ref).max()
    assert not np.array_equal(finals[False, True], finals[False, False])
    assert comp < plain < 1e-4, (plain, comp)
    jax_runs = {}
    for comp_j in (False, True):
        model = tj.Model(*KS, double=False)
        sch = tj.schemes.RODASPR(model, time_stepping=False, tol=None,
                                 compensated=comp_j)
        _, snaps, _ = sch.device_steps(0.0, model.fields_template(x=x, U=u0), n,
                                       dt, dict(periodic=True))
        jax_runs[comp_j] = np.asarray(snaps[-1][1]["U"], np.float64)
    assert not np.array_equal(jax_runs[True], jax_runs[False])
    assert np.abs(jax_runs[True] - ref).max() < np.abs(jax_runs[False] - ref).max()
    # the two packages' float32 solvers round apart: 1.91e-5 here, the
    # plain runs 6.03e-5 apart
    assert np.abs(finals[False, True] - jax_runs[True]).max() < 1e-4


def test_compensated_adaptive_device_steps_match_jax():
    """Two adaptive output steps of compensated RODASPR through
    ``device_steps`` at the reference's ``_adaptive_pair`` inputs: on a
    grid K6 admits the port takes the eager route (K6's plain adaptive
    entry per output step, from a zero carry, and the outer carry across
    the output steps), as the reference's ``device_steps`` folds them;
    the same attempts, u within 1e-12 and the clock equal."""
    u0, x = ks_state()
    model = tt.Model(*KS, double=True, device="cpu")
    fields, pars = state_from_numpy({"x": x, "U": u0[0]}, dict(periodic=True),
                                    model)
    sch = tt.schemes.RODASPR(model, tol=1e-4, compensated=True)
    t, snaps, status = sch.device_steps(0.0, fields, 2, 0.5, pars)
    assert status == 0 and sch.steps_route == "eager" and len(snaps) == 2
    model_j = tj.Model(*KS, double=True)
    sch_j = tj.schemes.RODASPR(model_j, tol=1e-4, compensated=True)
    t_j, snaps_j, status_j = sch_j.device_steps(
        0.0, model_j.fields_template(x=x, U=u0[0]), 2, 0.5, dict(periodic=True))
    assert status_j == 0 and t == pytest.approx(float(t_j), abs=0)
    for (ti, fi), (tj_, fj) in zip(snaps, snaps_j):
        assert ti == float(tj_)
        assert np.abs(fi["U"].numpy() - np.asarray(fj["U"])).max() < 1e-12


@pytest.mark.parametrize("scheme_kw", [
    dict(time_stepping=False, tol=None), dict(tol=1e-4)],
    ids=["fixed", "adaptive"])
def test_compensated_ensemble_routes(monkeypatch, scheme_kw):
    """A compensated ensemble (fixed ``steps(3)``, or the shared adaptive
    controller) on the K6 route and on the host route agree: bit for bit
    where the host route steps by K6's plain step (a hook sends it
    there), to the solvers' rounding on K1-K5; with fixed steps each
    member equals the single grid's compensated ``device_steps`` to the
    solvers' rounding."""
    model, u, h, p, x = _ks_inputs(3)
    kw = dict(scheme=tt.schemes.RODASPR, compensated=True, **scheme_kw)

    def ensemble():
        return Ensemble(model, **ensemble_from_numpy(model, u.numpy(),
                                                     x.numpy(), {"periodic": True}),
                        **kw)

    k6 = ensemble()
    assert k6.route == "K6"
    k6.steps(3, 0.05)
    # a hook sends the ensemble to the host route, whose step is K6's plain
    # step on this grid: the same arithmetic, bit for bit
    hooked = Ensemble(model, **ensemble_from_numpy(model, u.numpy(), x.numpy(),
                                                   {"periodic": True}),
                      hook=_null, **kw)
    assert hooked.route == "host"
    hooked.steps(3, 0.05)
    assert hooked.t == k6.t and torch.equal(hooked.u, k6.u)
    with monkeypatch.context() as m:
        m.setattr(megastep, "plan_for", lambda *args: None)
        host = ensemble()
        assert host.route == "host"
        host.steps(3, 0.05)
    assert k6.t == host.t
    assert (k6.u - host.u).abs().max() < 1e-12
    if k6.attempts is not None:
        assert k6.attempts == host.attempts
    if "tol" in scheme_kw and scheme_kw["tol"]:
        return
    sch = tt.schemes.RODASPR(model, compensated=True, **scheme_kw)
    for b in range(3):
        fields, pars = state_from_numpy({"x": x.numpy(), "U": u[b, 0].numpy()},
                                        {"periodic": True}, model)
        t, snaps, _ = sch.device_steps(0.0, fields, 3, 0.05, pars)
        assert (snaps[-1][1]["U"] - k6.u[b, 0]).abs().max() < 1e-12, b
