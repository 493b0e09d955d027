"""The port's plain chunked SPIKE factor and solve (what kernels K2-K4 are
held to on the card) against scipy's sparse LU and the JAX package's
``factor_linearized``, to 1e-10 relative in f64.

Cases cover block sizes s = 1 and s = 2 (halo 2, or two variables),
cyclic and acyclic reduced systems, several (C, Mc) plans and the fused
state add (``add_to``).  Periodic grids on chunk counts that are no power
of two >= 8 close their ring with the Woodbury correction: those solves
are held to a dense ``torch.linalg.solve`` and the JAX package's
``solve_banded(..., periodic=True)`` to 1e-12, at s = 1, 2 and 4 and
C = 2, 4 and counts that are no power of two, and the JAX package's alone
at the cells' thousands of chunks."""

import functools

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

from triflow_tpu.ops import banded as banded_jax
from triflow_tpu.ops.banded import factor_linearized
from triflow_tpu_torch.core.routines import bands_to_csc
from triflow_tpu_torch.ops import banded, chunked, pcr, thomas

torch.set_num_threads(1)

RTOL = 1e-10
ALPHA, BETA = 1.0, -0.3


def random_bands(W, nvar, N, seed):
    """Random J bands whose alpha*I + beta*J is diagonally dominant."""
    rng = np.random.default_rng(seed)
    bands = rng.standard_normal((W, nvar, nvar, N))
    h = W // 2
    for m in range(nvar):
        bands[h, m, m] -= 3.0 * W * nvar / abs(BETA)
    return bands


def _plan(N, nvar, halo, periodic, C):
    return chunked.plan_with(N, nvar, halo, periodic, C)


@functools.lru_cache(maxsize=None)
def reference(W, nvar, N, periodic):
    """(bands, rhs, scipy's x) of one random system: every chunk plan of
    the same system is held to the same answer."""
    bands = random_bands(W, nvar, N, seed=W * 100 + nvar * 10 + N)
    rhs = np.random.default_rng(7).standard_normal((nvar, N))
    A = ALPHA * sps.identity(N * nvar) + BETA * bands_to_csc(bands, periodic)
    x_scipy = spla.spsolve(A.tocsc(), rhs.T.reshape(-1)).reshape(N, nvar).T
    return bands, rhs, x_scipy


@functools.lru_cache(maxsize=None)
def reference_jax(W, nvar, N, periodic):
    """The JAX package's solution of the same system (its eager solver
    compiles per shape, so only some systems are held against it)."""
    bands, rhs, _ = reference(W, nvar, N, periodic)
    return np.asarray(factor_linearized(ALPHA, BETA, bands, None, periodic)
                      .solve(rhs))


#: (W, nvar, N, periodic, C, against the JAX package too):
#: s = nvar * max(W // 2, 1) is 1, 2 or 4
CASES = [
    (3, 1, 128, True, 8, True), (3, 1, 128, True, 32, True),
    (3, 1, 120, False, 1, True), (3, 1, 120, False, 5, True),
    (3, 1, 120, False, 12, True),
    (5, 1, 128, True, 8, True), (5, 1, 128, True, 16, True),
    (5, 1, 96, False, 3, False), (5, 1, 96, False, 12, False),
    (3, 2, 64, True, 8, False), (3, 2, 64, True, 16, False),
    (3, 2, 60, False, 6, True), (5, 2, 48, False, 4, False),
]


@pytest.mark.parametrize("W,nvar,N,periodic,C,against_jax", CASES)
def test_chunked_solve_vs_scipy_and_jax(W, nvar, N, periodic, C, against_jax):
    bands, rhs, x_scipy = reference(W, nvar, N, periodic)
    plan = _plan(N, nvar, W // 2, periodic, C)
    fact = chunked.factor(ALPHA, BETA, torch.tensor(bands), periodic, plan)
    x = fact.solve(torch.tensor(rhs)).numpy()
    scale = np.abs(x_scipy).max()
    assert np.abs(x - x_scipy).max() <= RTOL * scale
    if against_jax:
        x_jax = reference_jax(W, nvar, N, periodic)
        assert np.abs(x - x_jax).max() <= RTOL * scale


@pytest.mark.parametrize("periodic", [True, False])
def test_add_to_fuses_the_state_add(periodic):
    W, nvar, N = 5, 1, 128
    bands = torch.tensor(random_bands(W, nvar, N, seed=3))
    rng = np.random.default_rng(4)
    rhs, u = (torch.tensor(rng.standard_normal((nvar, N))) for _ in range(2))
    fact = chunked.factor(ALPHA, BETA, bands, periodic)
    expect = u + fact.solve(rhs)
    got = chunked.solve(fact, rhs, add_to=u)
    assert torch.allclose(got, expect, rtol=0, atol=1e-14)


@pytest.mark.parametrize("W,nvar", [(3, 1), (5, 2)])
def test_identity_and_axpy_bands_match_jax(W, nvar):
    N = 16
    bands = random_bands(W, nvar, N, seed=5)
    eye = banded.identity_bands(W, nvar, N)
    assert np.array_equal(eye.numpy(),
                          np.asarray(banded_jax.identity_bands(W, nvar, N)))
    got = banded.axpy_bands(0.7, -0.2, torch.tensor(bands)).numpy()
    want = np.asarray(banded_jax.axpy_bands(0.7, -0.2, bands))
    assert np.abs(got - want).max() <= 1e-15 * np.abs(want).max()


def test_plan_choice():
    big = chunked.make_plan(1 << 20, 1, 1, True)
    assert (big.C, big.Mc, big.cyclic) == (4096, 256, True)
    readme = chunked.make_plan(200, 1, 1, False)
    assert (readme.C, readme.Mc, readme.cyclic) == (100, 2, False)
    ks = chunked.make_plan(2048, 1, 2, True)
    assert (ks.g, ks.s, ks.C, ks.Mc) == (2, 2, 512, 2)
    # the plan is the cheapest admissible one under the cost model
    M = big.M
    assert all(chunked.plan_cost_us(M, big.C) <= chunked.plan_cost_us(M, C)
               for C in (1024, 2048, 8192, 16384))
    # no halo: no coupling, nothing cyclic even on a periodic grid
    assert not chunked.make_plan(64, 1, 0, True).cyclic


def test_periodic_grid_without_power_of_two_chunks_raises():
    """A periodic grid takes any chunk count >= 2: one with no power of two
    >= 8 among its divisors closes its ring through the Woodbury
    correction.  A prime supernode count, which raised before padding was
    ported, and an N that is no multiple of the supernode size now take a
    padded plan whose ring closes at the system level (``Plan.ring``), and
    solve as the dense system does."""
    plan = chunked.make_plan(100, 1, 1, True)
    assert plan.wrap and plan.woodbury and not plan.cyclic
    assert plan.C * plan.Mc == 100 and plan.C >= 2 and plan.Mc >= 2
    for N, halo, periodic in ((101, 1, True), (101, 2, False)):
        plan = chunked.make_plan(N, 1, halo, periodic)
        assert plan.padded and plan.Np == plan.C * plan.Mc * plan.g > N
        assert plan.ring == periodic and not plan.wrap and plan.C >= 2
        bands, rhs, _ = reference(2 * halo + 1, 1, N, periodic)
        x = chunked.factor(ALPHA, BETA, torch.tensor(bands), periodic,
                           plan).solve(torch.tensor(rhs))
        A = (ALPHA * np.eye(N)
             + BETA * bands_to_csc(bands, periodic).toarray())
        x_dense = torch.linalg.solve(torch.tensor(A), torch.tensor(rhs[0]))
        scale = float(x_dense.abs().max())
        assert float((x[0] - x_dense).abs().max()) <= 1e-12 * scale


def test_reference_grids_take_the_least_cost_divisor():
    """The reference benchmark's periodic grids (N = 10^6 and 10^4) plan
    over every divisor; a power-of-two grid keeps its block-cyclic plan."""
    for N, halo, C in ((10 ** 6, 1, 5000), (10 ** 6, 2, 4000),
                       (10 ** 4, 2, 500)):
        plan = chunked.make_plan(N, 1, halo, True)
        M = plan.M
        every = [c for c in chunked._divisors(M) if M // c >= 2 and c >= 2]
        best = min(every, key=lambda c: (chunked.plan_cost_us(M, c), c))
        assert (plan.C, plan.Mc) == (best, M // best) == (C, M // C)
        assert plan.wrap and plan.woodbury and C & (C - 1)
    big = chunked.make_plan(1 << 20, 1, 1, True)
    assert (big.C, big.cyclic, big.wrap, big.woodbury) == (4096, True, True,
                                                            False)


#: (W, nvar, N, C) of the Woodbury solves: s = 1, 2, 4; C = 2, 4 and
#: counts that are no power of two
WOODBURY_CASES = [(3, 1, 120, 2), (3, 1, 120, 4), (3, 1, 120, 15),
                  (5, 1, 120, 2), (5, 1, 120, 4), (5, 1, 120, 6),
                  (3, 2, 60, 2), (3, 2, 60, 4), (3, 2, 60, 5),
                  (5, 2, 48, 2), (5, 2, 48, 4), (5, 2, 48, 12)]


@pytest.mark.parametrize("W,nvar,N,C", WOODBURY_CASES)
def test_woodbury_solve_vs_dense_and_jax(W, nvar, N, C):
    bands, rhs, _ = reference(W, nvar, N, True)
    plan = _plan(N, nvar, W // 2, True, C)
    assert plan.woodbury and plan.s == nvar * max(W // 2, 1)
    x = chunked.factor(ALPHA, BETA, torch.tensor(bands), True, plan).solve(
        torch.tensor(rhs))
    A = (ALPHA * np.eye(N * nvar)
         + BETA * bands_to_csc(bands, True).toarray())
    x_dense = torch.linalg.solve(torch.tensor(A), torch.tensor(
        rhs.T.reshape(-1))).reshape(N, nvar).T
    scale = float(x_dense.abs().max())
    assert float((x - x_dense).abs().max()) <= 1e-12 * scale
    x_jax = np.asarray(banded_jax.solve_banded(
        banded_jax.axpy_bands(ALPHA, BETA, bands), rhs, periodic=True))
    assert np.abs(x.numpy() - x_jax).max() <= 1e-12 * scale


#: (W, nvar, N, C) of Woodbury solves at the chunk counts the cells' plans
#: take since the plan cost was refitted to K4's Woodbury set-up across the
#: card (KS 10^6: 4000, Burgers 10^6: 5000), two supernodes a chunk, at s =
#: 1, 2 and 4
CELL_WOODBURY_CASES = [(3, 1, 10000, 5000), (3, 1, 8000, 4000), (5, 1, 16000, 4000),
                       (5, 2, 16000, 4000)]


@pytest.mark.parametrize("W,nvar,N,C", CELL_WOODBURY_CASES)
def test_woodbury_solve_at_the_cells_chunk_counts_vs_jax(W, nvar, N, C):
    """The ring closed by the Woodbury correction on thousands of chunks,
    against the JAX package's ``solve_banded(periodic=True)`` to 1e-12 of
    the largest entry."""
    bands = random_bands(W, nvar, N, seed=W * 100 + nvar * 10 + C)
    rhs = np.random.default_rng(8).standard_normal((nvar, N))
    plan = _plan(N, nvar, W // 2, True, C)
    assert plan.woodbury and plan.C == C and plan.Mc == 2
    assert plan.s == nvar * max(W // 2, 1)
    x = chunked.factor(ALPHA, BETA, torch.tensor(bands), True, plan).solve(
        torch.tensor(rhs)).numpy()
    x_jax = np.asarray(banded_jax.solve_banded(
        banded_jax.axpy_bands(ALPHA, BETA, bands), rhs, periodic=True))
    assert np.abs(x - x_jax).max() <= 1e-12 * np.abs(x_jax).max()


def test_acyclic_pcr_factor_ignores_the_corner_blocks():
    """The reduced system of a Woodbury plan keeps the ring's corner blocks
    in Lred[..., 0] and Ured[..., C-1]; the acyclic PCR factor gives the
    same operators, bit for bit, as with them masked."""
    bands, _, _ = reference(5, 2, 48, True)
    plan = _plan(48, 2, 2, True, 6)
    spikes = thomas.spike_factor(torch.tensor(bands), ALPHA, BETA, plan)
    assert spikes.Lred[..., 0].abs().max() > 0
    assert spikes.Ured[..., -1].abs().max() > 0
    Lm, Um = spikes.Lred.clone(), spikes.Ured.clone()
    Lm[..., 0] = 0.0
    Um[..., -1] = 0.0
    got = pcr.pcr_factor_plain(spikes.Lred, spikes.Ured, False)
    want = pcr.pcr_factor_plain(Lm, Um, False)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
