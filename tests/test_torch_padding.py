"""Grids with no chunk plan of their own, padded as the reference pads
them (``triflow_tpu_torch/ops/chunked.py``), held to the JAX package in
float64 on the CPU.

* The padded solve against scipy's sparse LU and the reference's
  ``solve_banded`` to 1e-12 relative: a prime N (edge), N odd with halo 2
  (edge and periodic), N = 2 x prime, and periodic grids whose supernode
  count M is prime, each on its least-cost plan and on other padded chunk
  counts.  A periodic grid padded this way closes its ring at the system
  level (``Plan.ring``: the reference's ``_extract_wrap`` and
  ``_attach_woodbury``).  Members (B = 3, one shift each) solve as three
  grids do.
* Short RODASPR ``Simulation`` runs against the reference's: KS at N =
  1001 (periodic, halo 2: N is no multiple of g = 2, so the ring closes at
  the system level) and the README model at N = 199 (edge, prime: K6 keeps
  its serial plan, cheaper than the multi-launch path; the ``_multi_launch``
  twins withhold it, and K1-K5 take the grid on a padded plan), fixed
  steps to 1e-10 of max|u|, and the README model's adaptive defaults with
  the same attempts (the margin of every err from tol asserted, as in
  ``test_torch_row.py``).
* The plans: the least-cost plan over padded chunk counts, which an edge
  grid with a prime M now takes instead of one chunk; the reference's
  grids keep theirs (``test_torch_banded.py``).
"""

import functools

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

import triflow_tpu as tj
import triflow_tpu_torch as tt
from triflow_tpu.ops import banded as banded_jax
from triflow_tpu_torch.core.routines import bands_to_csc
from triflow_tpu_torch.ops import chunked, megastep
from triflow_tpu_torch.utils.convert import state_from_numpy

from .test_torch_banded import ALPHA, BETA, random_bands
from .test_torch_row import (_assert_not_marginal, _assert_same_trajectory,
                             _trajectories)
from .test_torch_theta import (KS, README, dirichlet_jax, dirichlet_torch,
                               ks_state, multi_launch, readme_state)

torch.set_num_threads(1)

RTOL = 1e-12


@functools.lru_cache(maxsize=None)
def reference(W, nvar, N, periodic):
    """(bands, rhs, scipy's x, the reference's x) of one random system."""
    bands = random_bands(W, nvar, N, seed=W * 1000 + nvar * 100 + N)
    rhs = np.random.default_rng(N).standard_normal((nvar, N))
    A = ALPHA * sps.identity(N * nvar) + BETA * bands_to_csc(bands, periodic)
    x_scipy = spla.spsolve(A.tocsc(), rhs.T.reshape(-1)).reshape(N, nvar).T
    x_jax = np.asarray(banded_jax.solve_banded(
        banded_jax.axpy_bands(ALPHA, BETA, bands), rhs, periodic=periodic))
    return bands, rhs, x_scipy, x_jax


#: (W, nvar, N, periodic, other chunk counts): a prime N (edge), N odd
#: with halo 2 (edge and periodic, also with two variables), N = 2 x prime
#: (edge; periodic with halo 2, whose M is prime), periodic prime M at
#: halo 1 and 3 (g = 3 and N no multiple of it)
CASES = [
    (3, 1, 101, False, (3, 7)),
    (5, 1, 1001, False, (5, 33)),
    (5, 1, 1001, True, (2, 9, 40)),
    (5, 2, 99, True, (1, 4)),
    (3, 1, 2 * 1009, False, (2, 17)),
    (5, 1, 2 * 101, True, (3, 8)),
    (3, 1, 101, True, (1, 5, 16)),
    (7, 1, 400, True, (6,)),
]
#: the cases whose own plan is exact under the plan cost refitted to K4's
#: Woodbury set-up across the card (N = 2 x 1009, edge: 1009 chunks of two
#: supernodes); their padded plans are among the other chunk counts
EXACT_PICKS = {(3, 1, 2 * 1009, False)}


def _ids(case):
    W, nvar, N, periodic, _ = case
    return f"W{W}-nvar{nvar}-N{N}-{'periodic' if periodic else 'edge'}"


@pytest.mark.parametrize("W,nvar,N,periodic,others", CASES,
                         ids=[_ids(c) for c in CASES])
def test_padded_solve_vs_scipy_and_jax(W, nvar, N, periodic, others):
    bands, rhs, x_scipy, x_jax = reference(W, nvar, N, periodic)
    scale = np.abs(x_scipy).max()
    plan = chunked.make_plan(N, nvar, W // 2, periodic)
    assert (plan.padded or plan.ring) != ((W, nvar, N, periodic) in EXACT_PICKS)
    assert any(chunked.plan_with(N, nvar, W // 2, periodic, C).padded
               for C in (plan.C, *others))
    assert plan.ring == (periodic and plan.padded or periodic and plan.C < 2)
    for C in (plan.C, *others):
        p = chunked.plan_with(N, nvar, W // 2, periodic, C)
        assert p.Np >= N and p.Mc >= 2 and p.Np % p.g == 0
        fact = chunked.factor(ALPHA, BETA, torch.tensor(bands), periodic, p)
        x = fact.solve(torch.tensor(rhs)).numpy()
        assert x.shape == (nvar, N)
        assert np.abs(x - x_scipy).max() <= RTOL * scale, C
        assert np.abs(x - x_jax).max() <= RTOL * scale, C
        u = np.random.default_rng(1).standard_normal((nvar, N))
        got = chunked.solve(fact, torch.tensor(rhs), add_to=torch.tensor(u))
        assert np.abs(got.numpy() - u - x).max() <= 1e-15 * max(scale, 1.0)


@pytest.mark.parametrize("W,nvar,N,periodic", [(5, 1, 1001, True),
                                                (3, 1, 101, False),
                                                (5, 2, 99, True)])
def test_padded_solve_with_members(W, nvar, N, periodic):
    """B = 3 grids with one shift each factor and solve in one call as
    three grids do, on one grid's padded plan for B members."""
    B = 3
    bands = np.stack([random_bands(W, nvar, N, seed=b) for b in range(B)])
    rhs = np.random.default_rng(2).standard_normal((B, nvar, N))
    betas = np.linspace(BETA, 0.5 * BETA, B)
    C = chunked.make_plan(N, nvar, W // 2, periodic).C
    plan = chunked.plan_with(N, nvar, W // 2, periodic, C, B)
    assert plan.B == B and plan.padded
    x = chunked.factor(ALPHA, torch.tensor(betas), torch.tensor(bands),
                       periodic, plan).solve(torch.tensor(rhs)).numpy()
    for b in range(B):
        A = ALPHA * sps.identity(N * nvar) + betas[b] * bands_to_csc(
            bands[b], periodic)
        want = spla.spsolve(A.tocsc(), rhs[b].T.reshape(-1)).reshape(
            N, nvar).T
        assert np.abs(x[b] - want).max() <= RTOL * np.abs(want).max()


def test_plans_of_the_grids_that_had_none():
    """Every grid that had no plan before padding plans: the edge grid of a
    prime M takes the least-cost padded plan, not one chunk; periodic grids
    with N no multiple of g or a prime M close their ring at the system
    level."""
    edge = chunked.make_plan(1000003, 1, 1, False)
    assert edge.C > 1 and edge.padded and not edge.ring
    M = 1000003
    cost = min(chunked.plan_cost_us(M, C) for C in chunked.padded_counts(M, 1))
    assert chunked.plan_cost_us(M, edge.C) == cost
    assert chunked.plan_cost_us(M, 1) > 100 * cost
    edge2 = chunked.make_plan(2 * 1000003, 1, 2, False)
    assert edge2.C > 1 and edge2.Np >= 2 * 1000003
    for N, halo in ((999983, 2), (1001, 2), (101, 1)):
        plan = chunked.make_plan(N, 1, halo, True)
        assert plan.ring and not plan.wrap and plan.C >= 2 and plan.Mc >= 2
        assert plan.Np == plan.C * plan.Mc * plan.g >= N
    # the single-launch step pads nothing: it keeps its serial plan where
    # that costs less than the multi-launch path (N = 199), and declines a
    # prime grid where it does not (N = 4099)
    serial = megastep.make_plan(199, 1, 1, False)
    assert (serial.C, serial.Mc) == (1, 199)
    assert megastep.plan_for(4099, 1, 1, False) is None
    assert chunked.make_plan(4099, 1, 1, False).padded
    assert megastep.make_plan(200, 1, 1, False) is not None


def _fixed_sim(eqs, state, dt, tmax, hook_j, hook_t):
    fields_np, pars = state
    model_j, model_t = tj.Model(*eqs), tt.Model(*eqs, device="cpu")
    fields_t, pars_t = state_from_numpy(fields_np, pars, model_t)
    kw = dict(scheme=None, time_stepping=False, tol=None, dt=dt, tmax=tmax)
    sim_j = tj.Simulation(model_j, model_j.fields_template(**fields_np), pars,
                          hook=hook_j, **{**kw, "scheme": tj.schemes.RODASPR})
    sim_t = tt.Simulation(model_t, fields_t, pars_t, hook=hook_t,
                          **{**kw, "scheme": tt.schemes.RODASPR})
    traj_j = [np.asarray(f["U"]) for _, f in sim_j]
    traj_t = [f["U"].clone().numpy() for _, f in sim_t]
    return sim_t, traj_j, traj_t


@pytest.mark.parametrize("name", ["ks-1001", "readme-199"])
def test_fixed_rodaspr_simulation_matches_jax(name):
    """KS at N = 1001 on its ring plan; the README model at N = 199 on the
    route K6's gate picks (its serial plan) and, in the twin below, on the
    padded multi-launch path."""
    if name == "ks-1001":
        sim, traj_j, traj_t = _fixed_sim(KS, ks_state(1001), 0.05, 0.5,
                                         tj.schemes.null_hook,
                                         tt.schemes.null_hook)
        plan = sim._scheme._plan(1001, True)
        assert plan.ring and plan.padded
    else:
        sim, traj_j, traj_t = _fixed_sim(README, readme_state(199), 5.0, 50.0,
                                         dirichlet_jax, dirichlet_torch)
        mega = sim._scheme._mega_plan(199, False)
        assert mega is None or mega.C == 1
        assert mega is not None or sim._scheme._plan(199, False).padded
    assert len(traj_j) == len(traj_t) == 10
    for u_j, u_t in zip(traj_j, traj_t):
        assert np.abs(u_t - u_j).max() <= 1e-10 * np.abs(u_j).max()


def test_fixed_rodaspr_simulation_matches_jax_multi_launch(multi_launch):
    test_fixed_rodaspr_simulation_matches_jax("readme-199")


def test_adaptive_readme_199_matches_jax(monkeypatch):
    sim, traj_j, traj_t, errs = _trajectories(
        README, readme_state(199), 5.0, 50.0, True, {}, monkeypatch)
    _assert_same_trajectory(traj_j, traj_t, 10)
    _assert_not_marginal(errs, 1e-1)
    assert traj_t[-1][1][0] == 1.0 and traj_t[-1][1][-1] == 0.0


def test_adaptive_readme_199_matches_jax_multi_launch(multi_launch,
                                                      monkeypatch):
    test_adaptive_readme_199_matches_jax(monkeypatch)
