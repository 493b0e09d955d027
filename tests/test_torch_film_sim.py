"""The adaptive trajectory of the s = 6 falling film (``Simulation``'s
defaults) on the port against the JAX package's, float64 on the CPU
(``test_torch_film.py`` has the model, the state and why its output steps
set every dt from an err near tol)."""

import numpy as np
import pytest

import triflow_tpu as tj
import triflow_tpu_torch as tt

from .test_torch_film import _both, _stack, film_state, models  # noqa: F401


def test_adaptive_trajectory_matches_jax(models):  # noqa: F811
    model_j, model_t = models
    fields_j, fields_t, pars, pars_t = _both(models, film_state(400))
    sim_j = tj.Simulation(model_j, fields_j, pars, dt=0.5, tmax=3.0, tol=1e-4)
    sim_t = tt.Simulation(model_t, fields_t, pars_t, dt=0.5, tmax=3.0, tol=1e-4)
    assert isinstance(sim_t._scheme, tt.schemes.RODASPR)
    errs = []
    fixed = sim_t._scheme.fixed_step

    def recording(*args):
        out = fixed(*args)
        errs.append(float(out[-1]))
        return out

    sim_t._scheme.fixed_step = recording
    traj_j = [(t, _stack(f, np.asarray), sim_j._scheme._internal_iter,
               sim_j._scheme._internal_dt) for t, f in sim_j]
    traj_t = [(t, _stack(f, lambda a: a.clone().numpy()), sim_t._scheme._internal_iter,
               sim_t._scheme._internal_dt) for t, f in sim_t]
    assert sim_t.status == "finished" and len(traj_j) == len(traj_t) == 6
    for (t_j, u_j, it_j, dt_j), (t_t, u_t, it_t, dt_t) in zip(traj_j, traj_t):
        assert t_t == pytest.approx(t_j, rel=1e-14)
        assert it_t == it_j
        assert dt_t == pytest.approx(dt_j, rel=1e-8)
        assert np.abs(u_t - u_j).max() <= 1e-9 * np.abs(u_j).max()
    assert len(errs) == sum(it for _, _, it, _ in traj_t) > len(traj_t)
    assert min(abs(e / 1e-4 - 1.0) for e in errs) > 1e-6
