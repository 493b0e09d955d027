"""A three-field falling film with block size s = 6 (nvar 3, halo 2) on the
port against the JAX package, float64 on the CPU: the model whose solves
take kernels K2-K4 at their wide instantiations on the card.

The model is ``examples/11_falling_film.py``'s Shkadov film (h, q;
second-order upwind) with a capillary term ``h dxxx h / (3 delta)`` and an
insoluble surfactant G, carried at the surface speed 3q/2h, that pulls on
the film through a Marangoni stress ``-Ma h dx G``.  The state is the
example's film on its domain [0, 100): h = 1 + 0.1 cos(2 pi 3 x / 100),
q = h^3 / 3, G = 1 + 0.05 sin(2 pi 2 x / 100).

* one fixed RODASPR step (here) and one Theta step
  (``test_torch_film_theta.py``) of dt 0.5, periodic and on an edge grid,
  within 1e-11 max|u| of the reference's;
* an adaptive trajectory (``test_torch_film_sim.py``; ``Simulation``'s
  defaults: RODASPR with its own controller, tol 1e-4, 6 output steps of
  0.5 at N = 400) within 1e-9
  max|u|, with the same attempts in every output step and the same adapted
  dt to 1e-8 relative.  The adapted dt goes as ``err**-1/2`` and the two
  packages' states agree to ~1e-13 absolute, so a dt set by an err k times
  below tol carries k times more of that gap (ROADMAP Queue C, "Adapted dt
  agrees to 1e-8 relative").  Output steps of 0.5 set every dt from an err
  between 0.16 and 10 tol: the attempts whose err is smaller either grow
  dt by the controller's cap of 10 (err below about 0.008 tol), which
  rounding cannot move, or are the clamped last attempt of an output step,
  which sets no dt.  The test asserts that every attempt's err lies more
  than 1e-6 relative away from tol, so none is marginal.

Such a model never takes K6 (its block size exceeds ``megastep.MAX_S``):
the port steps it on the multi-launch route (K1-K5).  The reference compiles
each of these steps for 30-60 s on one CPU, so the cases are spread over
three files, which the test workers run side by side."""

import jax
import numpy as np
import pytest
import torch

import triflow_tpu as tj
import triflow_tpu_torch as tt
from triflow_tpu_torch.ops import chunked, megastep
from triflow_tpu_torch.utils.convert import state_from_numpy

torch.set_num_threads(1)

FILM = (["-dxq",
         "9/7 * q**2 / h**2 * dxh - upwind(17/7 * q / h, q, 2)"
         " + (h - q / h**2) / delta + h * dxxxh / (3 * delta) - Ma * h * dxG",
         "-upwind(3/2 * q / h, G, 2) + dxxG / Pe"],
        ["h", "q", "G"], ["delta", "Ma", "Pe"])
FIELDS = ("h", "q", "G")


def film_state(N, periodic=True):
    x = np.linspace(0, 100, N, endpoint=False)
    h = 1 + 0.1 * np.cos(2 * np.pi * 3 * x / 100)
    return ({"x": x, "h": h, "q": h ** 3 / 3,
             "G": 1 + 0.05 * np.sin(2 * np.pi * 2 * x / 100)},
            dict(periodic=periodic, delta=0.1, Ma=0.5, Pe=100.0))


@pytest.fixture(scope="module")
def models():
    """The film compiled once by each package (the reference's symbolic
    compile costs seconds)."""
    return tj.Model(*FILM), tt.Model(*FILM, device="cpu")


def _both(models, state):
    model_j, model_t = models
    fields_np, pars = state
    fields_t, pars_t = state_from_numpy(fields_np, pars, model_t)
    return model_j.fields_template(**fields_np), fields_t, pars, pars_t


def _stack(fields, to_numpy):
    return np.stack([to_numpy(fields[k]) for k in FIELDS])


def test_block_size_and_route(models):
    _, model_t = models
    assert (model_t.system.nvar, model_t.system.halo) == (3, 2)
    for N in (400, 10 ** 6, 1 << 20):
        plan = chunked.make_plan(N, 3, 2, True)
        assert plan.s == 6 and plan.C * plan.Mc * plan.g == N
        assert megastep.plan_for(N, 3, 2, True) is None
    assert tt.schemes.RODASPR(model_t)._mega_plan(400, True) is None


def check_one_fixed_step(models, scheme, periodic):
    """One fixed step of 0.5 of ``scheme`` (RODASPR or Theta) on N = 240
    within 1e-11 max|u| of the reference's ``device_fixed_step``."""
    model_j, model_t = models
    fields_j, fields_t, pars, pars_t = _both(models, film_state(240, periodic))
    if scheme == "Theta":
        ref = tj.schemes.Theta(model_j, theta=1.0)
        port = tt.schemes.Theta(model_t, theta=1.0)
    else:
        ref = tj.schemes.RODASPR(model_j, time_stepping=False)
        port = tt.schemes.RODASPR(model_t, time_stepping=False)
    fixed_j = jax.jit(ref.device_fixed_step(tj.schemes.null_hook, periodic))
    u_j = np.asarray(fixed_j(0.0, *ref._split(fields_j, pars), 0.5)[0])
    _, out_t = port(0.0, fields_t, 0.5, pars_t)
    u_t = _stack(out_t, lambda a: a.numpy())
    assert u_j.shape == u_t.shape == (3, 240)
    assert np.abs(u_j - np.stack([np.asarray(fields_j[k]) for k in FIELDS])).max() > 1e-3
    assert np.abs(u_t - u_j).max() <= 1e-11 * np.abs(u_j).max()


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "edge"])
def test_one_rodaspr_step_matches_jax(models, periodic):
    check_one_fixed_step(models, "RODASPR", periodic)
