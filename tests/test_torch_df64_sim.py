"""The df64 precision mode through ``Simulation`` and the adaptive
controller, against the JAX package, float64 on the CPU.

* ``Simulation`` end to end (``tests/test_precision.py:230``): float64
  host fields, the same output times as the reference's df64 run, and the
  trajectory within 1e-8 of the exact discrete-operator solution (the
  reference's own limit) and 1e-10 of the reference's df64 run (measured
  1.1e-11); the requested dt is rounded to float32 up front on both (dt =
  0.01 becomes 0.009999999776482582).  Its tol = 1e-12 sets every dt from
  an err within two orders of magnitude of the solvers' rounding (the
  states agree to about 1e-13), so the float32 dts differ between the two
  packages and so may the attempts, by one in an output step of about
  155 (measured: 155 against 156 in one of four); the adaptive case
  below, whose errs lie near a larger tol, holds the attempts equal.
* The Dirichlet hook (``tests/test_precision.py:366``): the reference's
  df64 hook sees the float32 ``hi`` and enforces float32-granular values,
  while the port's hook sees and sets float64 fields, so the port is held
  to the reference's ``double=True`` run: the same ten hooked fixed steps
  (ROS3PRL, dt = 6, exact in float32) within 1e-11, with boundary values
  exactly those the hook sets.  (The reference test's adaptive run at
  tol = 1e-6 takes about 9400 attempts per output step on both packages;
  the port's host controller spends about 7 ms an attempt on the CPU, so
  it is not rerun here.)
* One adaptive RODASPR run with ``df64_mixed_solve=1`` (KS, N = 256,
  tol = 1e-3, four output steps of 0.5): the same attempts in every
  output step as the reference's df64 run, each output step's adapted dt
  within one float32 ulp of the reference's, and the state within 1e-9.
  Both controllers decide in float32 on err rounded to float32, so the
  dts agree to the last bit unless an err sits on a float32 rounding
  boundary; the output step of 0.5 keeps every dt set by an err near tol
  (an err far below tol carries more of the solvers' rounding, ROADMAP
  Queue C), and no attempt's err lies within 1e-6 relative of tol, where
  the decision ``err <= tol`` could flip, which the test asserts.
"""

import numpy as np
import torch

import triflow_tpu as tj
import triflow_tpu_torch as tt
from triflow_tpu_torch.utils.convert import state_from_numpy

from .test_torch_theta import KS, README, ks_state

torch.set_num_threads(1)


def test_simulation_end_to_end():
    N, k, c, T = 256, 0.05, 0.3, 2.0
    x, dx = np.linspace(0, 10, N, endpoint=False, retstep=True)
    om = 2 * np.pi / 10
    U0 = np.cos(om * x)
    pars = dict(periodic=True, k=k, c=c)
    model_j = tj.Model(*README, double="df64")
    sim_j = tj.Simulation(model_j, model_j.fields_template(x=x, U=U0), pars,
                          dt=0.5, tmax=T, tol=1e-12)
    model_t = tt.Model(*README, double="df64", device="cpu")
    assert model_t.precision == "df64"
    fields, pars_t = state_from_numpy({"x": x, "U": U0}, pars, model_t)
    sim_t = tt.Simulation(model_t, fields, pars_t, dt=0.5, tmax=T, tol=1e-12)
    out_j, out_t = [], []
    for t, f in sim_j:
        out_j.append((t, sim_j._scheme._internal_iter, np.asarray(f["U"])))
    for t, f in sim_t:
        out_t.append((t, sim_t._scheme._internal_iter, f["U"].numpy()))
    assert [o[0] for o in out_t] == [o[0] for o in out_j]
    # tol = 1e-12 sets every dt from an err within two orders of the
    # solvers' rounding: the attempts may differ by one (module doc)
    assert all(abs(a[1] - b[1]) <= 1 for a, b in zip(out_t, out_j))
    U = out_t[-1][2]
    assert U.dtype == np.float64
    lam = k * (2 * np.cos(om * dx) - 2) / dx ** 2
    mu = c * np.sin(om * dx) / dx
    exact = np.exp(lam * T) * np.cos(om * x - mu * T)
    assert np.abs(U - exact).max() < 1e-8
    assert np.abs(U - out_j[-1][2]).max() < 1e-10
    # the requested dt is rounded to float32 up front, on both
    for sim in (tj.Simulation(model_j, model_j.fields_template(x=x, U=U0), pars,
                              dt=0.01),
                tt.Simulation(model_t, fields, pars_t, dt=0.01)):
        assert sim.dt == float(np.float32(0.01)) != 0.01


def _dirichlet_jax(t, fields, pars):
    fields["U"] = fields["U"].at[0].set(1.0).at[-1].set(0.0)
    return fields, pars


def _dirichlet_torch(t, fields, pars):
    fields["U"][0] = 1.0
    fields["U"][-1] = 0.0
    return fields, pars


def _hook_case():
    x = np.linspace(0, 1, 64)
    return x, np.cos(2 * np.pi * x * 3), dict(periodic=False, k=4e-2)


def test_dirichlet_hook_against_the_references_float64():
    x, U0, pars = _hook_case()
    eqs = ("k * dxxU", "U", "k")
    model_j = tj.Model(*eqs, double=True)
    sim_j = tj.Simulation(model_j, model_j.fields_template(x=x, U=U0), pars,
                          hook=_dirichlet_jax, scheme=tj.schemes.ROS3PRL,
                          dt=6.0, tmax=60.0, time_stepping=False)
    model_t = tt.Model(*eqs, double="df64", device="cpu")
    fields, pars_t = state_from_numpy({"x": x, "U": U0}, pars, model_t)
    sim_t = tt.Simulation(model_t, fields, pars_t, hook=_dirichlet_torch,
                          scheme=tt.schemes.ROS3PRL, dt=6.0, tmax=60.0,
                          time_stepping=False)
    ts_j = [(t, np.asarray(f["U"])) for t, f in sim_j]
    ts_t = [(t, f["U"].numpy()) for t, f in sim_t]
    assert [t for t, _ in ts_t] == [t for t, _ in ts_j]
    assert len(ts_t) == 10
    for (_, uj), (_, ut) in zip(ts_j, ts_t):
        assert np.abs(ut - uj).max() <= 1e-11
    U = ts_t[-1][1]
    assert U.dtype == np.float64
    assert U[0] == 1.0 and U[-1] == 0.0


def test_adaptive_mixed_matches_reference():
    fields_np, pars = ks_state(256)
    tol, out_dt, n_out = 1e-3, 0.5, 4
    model_j = tj.Model(*KS, double="df64")
    scheme_j = tj.schemes.RODASPR(model_j, tol=tol, df64_mixed_solve=1)
    fields_j = model_j.fields_template(**fields_np)
    model_t = tt.Model(*KS, double="df64", device="cpu")
    scheme_t = tt.schemes.RODASPR(model_t, tol=tol, df64_mixed_solve=1)
    fields_t, pars_t = state_from_numpy(fields_np, pars, model_t)
    errs = []
    step = scheme_t.fixed_step

    def recording(*args):
        out = step(*args)
        errs.append(float(out[-1]))
        return out

    scheme_t.fixed_step = recording
    t_j = t_t = 0.0
    for _ in range(n_out):
        t_j, fields_j = scheme_j(t_j, fields_j, out_dt, pars)
        t_t, fields_t = scheme_t(t_t, fields_t, out_dt, pars_t)
        assert t_t == t_j
        assert scheme_t._internal_iter == scheme_j._internal_iter
        dt_j = np.float32(scheme_j._internal_dt)
        assert abs(np.float32(scheme_t._internal_dt) - dt_j) <= np.spacing(dt_j)
        assert np.abs(fields_t["U"].numpy()
                      - np.asarray(fields_j["U"])).max() <= 1e-9
    assert errs
    margin = min(abs(e / tol - 1.0) for e in errs)
    assert margin > 1e-6, f"an attempt's err is within {margin:.1e} of tol"
