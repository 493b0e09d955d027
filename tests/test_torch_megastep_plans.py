"""K6's cluster plans: where a member's step runs (``ops/megastep.py:
cluster_plan``: K CTAs, their chunks and nodes, each buffer's home in
shared memory or L2, the bytes a CTA takes) and the gates that decide
which grids K6 takes (``plan_for``, ``mixed_plan_for``).

CPU only: the planners are host code.  The kernels on these plans are held
against their plain versions, and every cluster size against the others
bit for bit, on the card (``tests/test_torch_kernels.py``:
``test_cluster_body_matches_plain_version``; ``chip_smoke.py`` phase 1).
"""

import numpy as np
import pytest
import torch

from triflow_tpu_torch.ops import chunked, kernel_checks, megastep

torch.set_num_threads(1)

#: (nvar, halo, periodic) of the block sizes K6 takes: s = 1 (the README
#: model, Burgers), 2 (KS) and 4 (the two-variable model), rings and edge
#: grids
SYSTEMS = [(1, 1, False), (1, 1, True), (1, 2, True), (1, 2, False), (2, 2, True),
           (2, 2, False)]
#: stage counts of the tables K6 runs: Theta (1) and RODASPR (6)
STAGES = (1, megastep.MAX_STAGES)


def grids(nvar, halo, periodic, count=60, seed=0):
    """Grid sizes up to the gate of the block size: powers of two, the
    reference's sizes, primes, the gate itself and a random sample."""
    top = megastep.MAX_N[nvar * max(halo, 1)]
    rng = np.random.default_rng(seed + 7 * nvar + halo + 3 * periodic)
    ns = {1 << e for e in range(4, 17)} | {200, 199, 600, 1000, 4099, 10 ** 4, top, top - 1}
    ns |= set(int(n) for n in rng.integers(8, top + 1, count))
    return sorted(n for n in ns if 8 <= n <= top)


def runs(cp, C):
    """The chunk runs [c0, c0 + nc) of the K CTAs of a cluster plan."""
    return [(k * cp.Cc, max(0, min(cp.Cc, C - k * cp.Cc))) for k in range(cp.K)]


def check_layout(plan, cp, n_stages, dtype, mixed):
    """A cluster plan's invariants: K a size the kernels take, at most
    232,448 bytes of shared memory a CTA (the kernels' static part
    counted), every CTA a run of chunks, the runs covering 0..C-1 once
    and in order, and every CTA's nodes at least the halo, so that F's
    and J's halo reads and the shifts' interface reads reach only the
    neighbouring ranks (rank K-1 and 0 on a ring); the buffers other CTAs
    read in shared memory, the shares laid out without overlap."""
    assert cp.K in megastep.CLUSTER_SIZES and cp.K <= 16
    assert cp.bytes <= megastep.SMEM_PER_CTA == 232448
    assert cp.threads == megastep.THREADS
    assert cp.threads >= 2 * (2 * plan.s) ** 2
    rs = runs(cp, plan.C)
    covered = [c for c0, nc in rs for c in range(c0, c0 + nc)]
    assert covered == list(range(plan.C))
    assert all(nc >= 1 for _, nc in rs)
    assert cp.Nr == cp.Cc * plan.Mc * plan.g
    for _, nc in rs:
        assert nc * plan.Mc * plan.g >= plan.halo
    must = megastep.MIXED_NEIGHBOUR_READ if mixed else megastep.NEIGHBOUR_READ
    assert all(cp.home(name) == "shared" for name in must)
    sizes = megastep.shares(plan, n_stages, cp.K, mixed)
    item = torch.finfo(dtype).bits // 8
    spans = {0: [], 1: []}
    for name, h, off in zip(megastep.BUFFERS, cp.homes, cp.offsets):
        size = sizes[name] * (4 if mixed and name in megastep.MIXED32 else
                              (8 if mixed else item))
        assert off % 16 == 0
        spans[h].append((off, off + size))
    for h, limit in ((0, cp.smem), (1, cp.gslab)):
        spans[h].sort()
        for (a0, a1), (b0, _) in zip(spans[h], spans[h][1:]):
            assert a1 <= b0
        assert all(b <= limit for _, b in spans[h])


@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("nvar,halo,periodic", SYSTEMS)
def test_admitted_grids_have_a_cluster(nvar, halo, periodic, dtype, B):
    """Every grid ``plan_for`` admits (for B members) has a cluster plan
    for Theta and RODASPR in both dtypes, with the layout's invariants."""
    admitted = 0
    for N in grids(nvar, halo, periodic):
        plan = megastep.plan_for(N, nvar, halo, periodic, B)
        if plan is None:
            continue
        admitted += 1
        for n_stages in STAGES:
            cp = megastep.cluster_plan(plan, n_stages, dtype, B)
            check_layout(plan, cp, n_stages, dtype, False)
    assert admitted > 0


@pytest.mark.parametrize("nvar,halo,periodic", SYSTEMS)
def test_mixed_admitted_grids_have_a_cluster(nvar, halo, periodic):
    """Every grid ``mixed_plan_for`` admits has a cluster plan of the
    mixed entry (float64 bands and stage vectors, float32 solver), the
    stage solutions in shared memory too (the residual's halo)."""
    admitted = 0
    for N in grids(nvar, halo, periodic, count=30):
        plan = megastep.mixed_plan_for(N, nvar, halo, periodic)
        if plan is None:
            continue
        admitted += 1
        for n_stages in STAGES:
            cp = megastep.cluster_plan(plan, n_stages, torch.float64, 1, mixed=True)
            check_layout(plan, cp, n_stages, torch.float64, True)
    assert admitted > 0


@pytest.mark.parametrize("nvar,halo,periodic", SYSTEMS)
def test_gates_admit_no_grid_without_a_cluster(nvar, halo, periodic):
    """A grid with a chunk plan but no cluster that holds it (the widest
    table in float64) is one the gates refuse; the gate's own size is
    admitted where its chunk plan fits."""
    s = nvar * max(halo, 1)
    for N in grids(nvar, halo, periodic) + [2 * megastep.MAX_N[s]]:
        plan = megastep.make_plan(N, nvar, halo, periodic)
        if plan is None:
            continue
        for B in (1, 64):
            got = megastep.plan_for(N, nvar, halo, periodic, B)
            if got is not None:
                assert megastep.fits(got)
                assert N <= megastep.MAX_N[s]
        got = megastep.mixed_plan_for(N, nvar, halo, periodic)
        if got is not None:
            assert megastep.fits(got, mixed=True) and N <= megastep.MIXED_MAX_N[s]


def test_a_member_that_fits_no_cluster_raises():
    """A chunk plan whose neighbour-read buffers fit no cluster of 16 CTAs
    raises, and a forced size that gives some CTA no chunk is refused."""
    big = chunked.plan_with(1 << 22, 2, 2, True, 1 << 17)
    with pytest.raises(ValueError, match="no cluster"):
        megastep.cluster_plan(big, 6, torch.float64)
    assert not megastep.fits(big)
    plan = chunked.plan_with(200, 1, 1, False, 50)
    with pytest.raises(ValueError):
        megastep.cluster_plan(plan, 6, torch.float64, K=16)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("table", ["theta", "rodaspr"])
def test_the_sweep_runs_one_cta_a_member(dtype, table):
    """The sweep's shapes (B = 64 KS members at N = 200) take one CTA a
    member, the whole working set in its shared memory."""
    plan = megastep.plan_for(200, 1, 2, True, 64)
    cp = megastep.cluster_plan(plan, 1 if table == "theta" else 6, dtype, 64)
    assert cp.K == 1 and cp.gslab == 0
    assert all(h == 0 for h in cp.homes)


@pytest.mark.parametrize("K", megastep.CLUSTER_SIZES)
def test_forced_cluster_sizes_of_the_checks(K):
    """``kernel_checks.CLUSTER_CASES`` give every CTA of every cluster
    size a run of chunks (C not divisible by K at K = 16): where the size
    holds the member, its layout keeps the invariants; the s = 1 edge grid
    runs on every size."""
    held = 0
    for name, N, periodic, C, _, _ in kernel_checks.CLUSTER_CASES:
        nvar, halo = {"readme": (1, 1), "ks": (1, 2), "two_var": (2, 2)}[name]
        plan = chunked.plan_with(N, nvar, halo, periodic, C)
        assert megastep._cluster_shape(C, K) is not None
        for dtype in (torch.float64, torch.float32):
            try:
                cp = megastep.cluster_plan(plan, 6, dtype, K=K)
            except ValueError:
                assert name != "readme"
                continue
            held += 1
            assert cp.K == K
            check_layout(plan, cp, 6, dtype, False)
    assert held >= 2


def test_cost_model_prefers_fewer_barriers_on_small_grids():
    """One CTA costs no cluster barrier: a grid whose working set fits one
    CTA with work for few passes of its threads takes K = 1."""
    plan = megastep.plan_for(200, 1, 1, False)
    for dtype in (torch.float64, torch.float32):
        assert megastep.cluster_plan(plan, 6, dtype).K == 1


#: the picks recorded in PERF.md (§4 and §6) of the refitted
#: constants: (N, nvar, halo, periodic, members) -> (C, K), float64, RODASPR;
#: the cells and the layout sweeps' grids whose picks the fit reproduced
PICKS = {(200, 1, 1, False, 1): (25, 1), (1 << 13, 1, 2, True, 1): (256, 16),
         (10 ** 4, 1, 1, True, 1): (500, 16), (10 ** 4, 1, 2, True, 1): (250, 16),
         (600, 2, 2, True, 1): (15, 4), (200, 1, 2, True, 64): (25, 1),
         (1 << 15, 1, 2, True, 1): (1024, 16), (1 << 12, 2, 2, True, 1): (128, 16),
         (1000, 1, 1, False, 1): (50, 1), (512, 1, 2, True, 1): (32, 1)}


@pytest.mark.parametrize("grid", list(PICKS), ids=[f"N={k[0]}-s={k[1] * k[2]}-B={k[4]}"
                                                    for k in PICKS])
def test_refitted_constants_reproduce_the_recorded_picks(grid):
    """``plan_for``'s chunk count and ``cluster_plan``'s cluster size at the
    refitted constants are the picks PERF.md records (float64, RODASPR);
    a grid of one CTA with its working set in shared memory runs the
    one-CTA instantiation."""
    N, nvar, halo, periodic, B = grid
    plan = megastep.plan_for(N, nvar, halo, periodic, B)
    cp = megastep.cluster_plan(plan, megastep.MAX_STAGES, torch.float64, B)
    assert (plan.C, cp.K) == PICKS[grid]
    assert cp.one == (cp.K == 1 and plan.s <= megastep.ONE_MAX_S and not any(cp.homes))


def test_the_gates_follow_the_crossover():
    """The gates PERF.md records from the crossover sweeps: K6 up to 2^16
    at s = 1 and 2 (the sweep's top) and 2^13 at s = 4; the mixed entry up
    to 2^15, 2^15 and 2^14; KS at the reference's N = 10^4 takes K6."""
    assert megastep.MAX_N == {1: 1 << 16, 2: 1 << 16, 4: 1 << 13}
    assert megastep.MIXED_MAX_N == {1: 1 << 15, 2: 1 << 15, 4: 1 << 14}
    for s_blk, (nvar, halo) in {1: (1, 1), 2: (1, 2), 4: (2, 2)}.items():
        top = megastep.MAX_N[s_blk]
        assert megastep.plan_for(top, nvar, halo, True) is not None
        assert megastep.plan_for(2 * top, nvar, halo, True) is None
    assert megastep.plan_for(10 ** 4, 1, 2, True).woodbury
