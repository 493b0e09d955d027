"""The port's chunked SPIKE factor and solve at the wide block sizes s =
nvar * max(halo, 1) = 5, 6, 7 and 8 (what kernels K2-K4 are held to on the
card in their wide libraries) against scipy's sparse LU and the JAX
package's ``solve_banded``, to 1e-10 relative in float64; the plain
block-Schur inverse against the reference's; and the limits: K2-K4 take
s <= 8 (interface blocks up to 16), K6 keeps s <= 4.

Systems are random diagonally dominant bands at the (W, nvar) pairs (3, 5),
(5, 3), (3, 7), (5, 4) and (3, 8), N <= 256.  Every periodic system is
solved on a block-cyclic plan (a power-of-two chunk count >= 8) and on a
Woodbury plan (a chunk count that is no power of two), every acyclic one
on two chunk counts.  The reference compiles its solver per shape (10-20 s
each on one CPU), so it solves one periodic system of each block size:
the other systems are held to scipy."""

import functools

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

from triflow_tpu.ops import banded as banded_jax
from triflow_tpu_torch.core.routines import bands_to_csc
from triflow_tpu_torch.ops import banded, chunked, megastep, pcr, thomas

torch.set_num_threads(1)

RTOL = 1e-10
ALPHA, BETA = 1.0, -0.3


def random_bands(W, nvar, N, seed):
    """Random J bands whose alpha*I + beta*J is diagonally dominant."""
    rng = np.random.default_rng(seed)
    bands = rng.standard_normal((W, nvar, nvar, N))
    for m in range(nvar):
        bands[W // 2, m, m] -= 3.0 * W * nvar / abs(BETA)
    return bands


@functools.lru_cache(maxsize=None)
def system(W, nvar, N, periodic):
    """(bands, rhs, scipy's x) of one random system."""
    bands = random_bands(W, nvar, N, seed=W * 100 + nvar * 10 + N)
    rhs = np.random.default_rng(7).standard_normal((nvar, N))
    A = ALPHA * sps.identity(N * nvar) + BETA * bands_to_csc(bands, periodic)
    x_scipy = spla.spsolve(A.tocsc(), rhs.T.reshape(-1)).reshape(N, nvar).T
    return bands, rhs, x_scipy


@functools.lru_cache(maxsize=None)
def reference_jax(W, nvar, N, periodic):
    bands, rhs, _ = system(W, nvar, N, periodic)
    return np.asarray(banded_jax.solve_banded(
        banded_jax.axpy_bands(ALPHA, BETA, bands), rhs, periodic=periodic))


#: (W, nvar, N, periodic, chunk counts, against the JAX package too)
SYSTEMS = [
    (3, 5, 240, True, (8, 12), True), (3, 5, 240, False, (5, 16), False),
    (5, 3, 240, True, (8, 12), True), (5, 3, 240, False, (5, 6), False),
    (3, 7, 128, True, (8, 16), True), (3, 7, 120, True, (10,), False),
    (3, 7, 120, False, (4, 15), False),
    (5, 4, 256, True, (16, 32), False), (5, 4, 240, True, (12,), False),
    (5, 4, 240, False, (3, 8), False),
    (3, 8, 120, True, (8, 6), True), (3, 8, 120, False, (8, 10), False),
]
CASES = [(W, nvar, N, periodic, C, jx) for W, nvar, N, periodic, Cs, jx in SYSTEMS
         for C in Cs]


def _id(case):
    W, nvar, N, periodic, C, _ = case
    plan = chunked.plan_with(N, nvar, W // 2, periodic, C)
    kind = ("cyclic" if plan.cyclic else "woodbury" if plan.woodbury
            else "acyclic")
    return f"s{plan.s}-W{W}-nvar{nvar}-N{N}-C{C}-{kind}"


@pytest.mark.parametrize("W,nvar,N,periodic,C,against_jax", CASES,
                         ids=[_id(c) for c in CASES])
def test_wide_chunked_solve_vs_scipy_and_jax(W, nvar, N, periodic, C,
                                             against_jax):
    bands, rhs, x_scipy = system(W, nvar, N, periodic)
    plan = chunked.plan_with(N, nvar, W // 2, periodic, C)
    assert 5 <= plan.s <= 8 and plan.s == nvar * max(W // 2, 1)
    fact = chunked.factor(ALPHA, BETA, torch.tensor(bands), periodic, plan)
    x = fact.solve(torch.tensor(rhs)).numpy()
    scale = np.abs(x_scipy).max()
    assert np.abs(x - x_scipy).max() <= RTOL * scale
    if against_jax:
        assert np.abs(x - reference_jax(W, nvar, N, periodic)).max() <= RTOL * scale


@pytest.mark.parametrize("s", [5, 6, 7, 8])
def test_block_schur_inverse_matches_jax_and_linalg(s):
    """The plain versions' inverse of the wide blocks (the reference's
    block-Schur split, which the kernels replace by Gauss-Jordan with
    pivoting) against the reference's ``_small_inv`` and a dense inverse."""
    rng = np.random.default_rng(s)
    D = rng.standard_normal((s, s, 64)) + 3.0 * s * np.eye(s)[..., None]
    got = banded.small_inv(torch.tensor(D)).numpy()
    want = np.asarray(banded_jax._small_inv(D))
    dense = np.linalg.inv(np.moveaxis(D, -1, 0))
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
    assert np.abs(np.moveaxis(got, -1, 0) - dense).max() <= 1e-13 * np.abs(dense).max()


def test_kernel_limits():
    """K2-K4 are instantiated for s <= 8 (interface blocks 2s <= 16), as
    the reference's sweeps serve them; wider blocks raise."""
    assert thomas.MAX_S == 8 and thomas.NARROW_S == 4
    for s2 in (2, 4, 8, 10, 12, 14, 16):
        pcr._check_sizes(s2, 64, "K4")
    for s2 in (18, 7):
        with pytest.raises(NotImplementedError, match="no kernel instantiation"):
            pcr._check_sizes(s2, 64, "K4")
    with pytest.raises(NotImplementedError, match="s = 9 > 8"):
        thomas.pick(9, "K2", None, None)
    narrow, wide = object(), object()
    assert [thomas.pick(s, "K2", narrow, wide) is wide for s in range(1, 9)] == [
        False] * 4 + [True] * 4
    # the wide instantiations are libraries of their own, built from the same
    # sources with TF_WIDE defined
    assert thomas.FACTOR_WIDE_LIB.name == "spike_factor_wide"
    assert thomas.FACTOR_WIDE_LIB.source().startswith("#define TF_WIDE 1\n")
    assert thomas.SOLVE_WIDE_LIB.source().endswith(thomas.SOLVE_LIB.source())
    assert pcr.WIDE_LIB.name == "pcr_wide"


@pytest.mark.parametrize("nvar,halo", [(5, 1), (3, 2), (7, 1), (4, 2), (8, 1)])
def test_k6_keeps_its_own_block_size_limit(nvar, halo):
    """K6 (csrc/megastep.cu) has no instantiation above s = 4: no K6 plan
    at s = 5..8 at any size, and its wrappers refuse such a plan."""
    assert megastep.MAX_S == 4
    for N in (120, 240, 1 << 10):
        assert megastep.plan_for(N, nvar, halo, True) is None
        assert megastep.make_plan(N, nvar, halo, True) is None
        assert megastep.mixed_plan_for(N, nvar, halo, True) is None
    plan = chunked.plan_with(240, nvar, halo, True, 8)
    sysm = type("System", (), {"nvar": nvar, "halo": halo})
    with pytest.raises(ValueError, match=f"s = {plan.s} > 4"):
        megastep.check_plan(plan, sysm, "K6 step")
