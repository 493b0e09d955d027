"""The port's step-doubling controller (``DeviceTimeStepping``) against the
JAX package's, float64 on the CPU.

``Simulation(scheme=Theta)`` with the default ``time_stepping=True`` wraps
Theta in ``schemes.time_stepping``: every attempt compares one coarse step
with ten fine ones.  On the README model (Dirichlet hook) and on Burgers
(N = 2048), with the error norms ord = 2 and inf, the trajectories agree
to 1e-9 max|u| with the same number of attempts in every output step and
the same adapted dt to 1e-8 relative (the dt goes as ``err**-1/2``, and
``err`` is a difference of two solutions, so it agrees to the states'
absolute agreement over its own size, not to rounding).  ROS2, which has
no error estimate of its own, is wrapped the same way.  The cases are
chosen with no attempt whose decision is within 1e-6 relative of the
acceptance line, and the test asserts that margin.  The
``..._multi_launch`` twins run the same cases with kernel K6's plan
withheld, so the wrapped scheme's steps take the multi-launch path.
"""

import numpy as np
import pytest
import torch

import triflow_tpu as tj
import triflow_tpu_torch as tt

from .test_torch_row import _assert_same_trajectory, _both, _hooks
from .test_torch_theta import (BURGERS, README, burgers_state, multi_launch,
                               readme_state)

torch.set_num_threads(1)

#: (name, equations, state, output dt, tmax, hooked, scheme name, kwargs):
#: tolerances at which the controller rejects and retries (19, 7 and 4
#: attempts in the README's output steps; 6 and 5, 4 and 3 in Burgers';
#: 9 and 9 for ROS2), and one where every attempt is accepted
CASES = [
    ("readme-ord2", README, readme_state(), 5.0, 15.0, True, "Theta",
     {"tol": 3e-3}),
    ("readme-inf", README, readme_state(), 5.0, 50.0, True, "Theta",
     {"ord": np.inf}),
    ("burgers-ord2", BURGERS, burgers_state(2048), 0.5, 1.0, False, "Theta",
     {"tol": 1e-6}),
    ("burgers-inf", BURGERS, burgers_state(2048), 0.5, 1.0, False, "Theta",
     {"tol": 1e-7, "ord": np.inf}),
    ("readme-ros2", README, readme_state(), 5.0, 10.0, True, "ROS2",
     {"tol": 3e-3}),
]


def _record_errors(wrapped):
    """Wrap the controller's attempt so every attempt's err is kept."""
    errs = []
    attempt = wrapped._attempt

    def recording(*args):
        out = attempt(*args)
        errs.append(float(out[-1]))
        return out

    wrapped._attempt = recording
    return errs


@pytest.mark.parametrize("name,eqs,state,dt,tmax,hooked,scheme,kwargs",
                         CASES, ids=[c[0] for c in CASES])
def test_step_doubling_trajectory_matches_jax(name, eqs, state, dt, tmax,
                                              hooked, scheme, kwargs):
    model_j, fields_j, model_t, fields_t, pars, pars_t = _both(eqs, state)
    hook_j, hook_t = _hooks(hooked)
    sim_j = tj.Simulation(model_j, fields_j, pars, dt=dt, tmax=tmax,
                          hook=hook_j, scheme=getattr(tj.schemes, scheme),
                          **kwargs)
    sim_t = tt.Simulation(model_t, fields_t, pars_t, dt=dt, tmax=tmax,
                          hook=hook_t, scheme=getattr(tt.schemes, scheme),
                          **kwargs)
    wrapped = sim_t._scheme
    assert isinstance(wrapped, tt.schemes.DeviceTimeStepping)
    assert isinstance(wrapped._inner, getattr(tt.schemes, scheme))
    assert wrapped._ord == kwargs.get("ord", 2)
    assert wrapped._tol == kwargs.get("tol", 1e-1)
    errs = _record_errors(wrapped)
    traj_j = [(t, np.asarray(f["U"]), sim_j._scheme._internal_iter,
               sim_j._scheme._internal_dt) for t, f in sim_j]
    traj_t = [(t, f["U"].clone().numpy(), wrapped._internal_iter,
               wrapped._internal_dt) for t, f in sim_t]
    _assert_same_trajectory(traj_j, traj_t, round(tmax / dt))
    assert sim_t.status == "finished"
    # an attempt is accepted when sqrt(tol / err) >= 1 / reject_factor,
    # i.e. err <= 4 tol: no attempt sits within rounding of that line
    assert min(abs(e / (4 * wrapped._tol) - 1) for e in errs) > 1e-6
    if hooked:
        assert traj_t[-1][1][0] == 1.0 and traj_t[-1][1][-1] == 0.0


@pytest.mark.parametrize("name,eqs,state,dt,tmax,hooked,scheme,kwargs",
                         CASES, ids=[c[0] for c in CASES])
def test_step_doubling_trajectory_matches_jax_multi_launch(
        multi_launch, name, eqs, state, dt, tmax, hooked, scheme, kwargs):
    test_step_doubling_trajectory_matches_jax(name, eqs, state, dt, tmax,
                                              hooked, scheme, kwargs)


def test_dt_floor_raises_like_jax():
    """An error that no dt satisfies collapses dt to the roundoff floor,
    which raises in both packages."""
    model_j, fields_j, model_t, fields_t, pars, pars_t = _both(
        README, readme_state())
    for pkg, model, fields, p in ((tj, model_j, fields_j, pars),
                                  (tt, model_t, fields_t, pars_t)):
        wrapped = pkg.schemes.time_stepping(pkg.schemes.Theta(model),
                                            tol=1e-300)
        with pytest.raises(RuntimeError, match="step-doubling internal time "
                                               "step less than authorized"):
            wrapped(0.0, fields, 5.0, p)


def test_dt_floor_raises_like_jax_multi_launch(multi_launch):
    test_dt_floor_raises_like_jax()
