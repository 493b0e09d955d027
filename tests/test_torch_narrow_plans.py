"""The launch plans of K3's tiled correction and K4's narrow factor across
the card, and the chunk plans the refitted narrow cost picks.

CPU only: the planners are host code (``ops/thomas.py:correct_plan``,
``ops/pcr.py:factor_plan_grid`` and ``factor_route``).  The kernels
themselves, and the correction's coverage of every row at odd shapes, are
held against their plain versions on the card
(``tests/test_torch_kernels.py``: ``test_tiled_correction_matches_plain_version``,
``test_grid_factor_matches_plain_version``).
"""

import pytest
import torch

from triflow_tpu_torch.ops import _launch, chunked, kernel_checks, pcr, thomas

torch.set_num_threads(1)

#: (Mc, C, B) of the correction plan checks: one, two and three chunks, Mc
#: no multiple of the rows a block takes, a part-full last chunk group, the
#: cells' plans (KS 10^6 and 2^20, config 5, the ring), few rows and many
#: chunks, one long chunk, and B = 1 and 1024 members
PLAN_SHAPES = [(13, 1, 1), (300, 1, 1), (9, 2, 1), (37, 3, 1), (13, 37, 1), (9, 40, 3),
               (13, 3, 1024), (5, 100, 1024), (1, 1, 1), (500, 1000, 1), (512, 1024, 1),
               (500, 100, 1024), (326, 1534, 1), (2, 16384, 1), (50000, 1, 1)]


def test_correct_rows():
    """R at CORRECT_MAX_CB chunks: 32 at s = 1; at s = 2 16 in float32 and
    8 in float64; 8 from s = 3."""
    assert [thomas.correct_rows(s_, 4) for s_ in range(1, 9)] == [32, 16, 8, 8, 8, 8, 8, 8]
    assert [thomas.correct_rows(s_, 8) for s_ in range(1, 9)] == [32, 8, 8, 8, 8, 8, 8, 8]


@pytest.mark.parametrize("s", range(1, 9))
@pytest.mark.parametrize("Mc,C,B", PLAN_SHAPES)
def test_correct_plan_shape(s, Mc, C, B):
    """CB a power of two up to 32 (B C rounded up where fewer); R =
    ``correct_rows(s, item)`` times 32 / CB rows, or the chunk's rows
    rounded up to a power of two, so that a block's tile holds at least
    its 256 threads' (row, chunk) pairs where the chunks have the rows;
    the plan cached per shape."""
    for item in (4, 8):
        cp = thomas.correct_plan(s, item, Mc, C, B)
        assert cp.CB & (cp.CB - 1) == 0 and cp.CB <= thomas.CORRECT_MAX_CB
        assert cp.CB == min(32, 1 << (B * C - 1).bit_length())
        assert B * C <= cp.CB or cp.CB == thomas.CORRECT_MAX_CB
        assert cp.R == min(thomas.correct_rows(s, item) * 32 // cp.CB,
                           1 << (Mc - 1).bit_length())
        assert cp.R >= 1 and (cp.R >= Mc or cp.R * cp.CB >= 8 * 32)
        assert thomas.correct_plan(s, item, Mc, C, B) is cp


#: (s2, C, B) of the grid factor's plans: one chunk, the cells' chunk
#: counts, the most chunks K4 takes, and members
GRID_PLANS = [(s2, C, B) for s2 in (2, 4, 6, 8) for C, B in (
    (1, 1), (2, 1), (3, 1), (1000, 1), (1024, 1), (1534, 1), (2048, 1), (16384, 1),
    (130, 4), (100, 131), (100, 1024))]


@pytest.mark.parametrize("s2,C,B", GRID_PLANS)
def test_grid_factor_plan_fits_the_card_and_covers_every_pair(s2, C, B):
    """The cooperative grid never holds more CTAs than the card takes at
    once (``per_sm`` of them on each SM), and its passes cover the B C
    pairs: a thread per pair at s2 = 2, else ``factor_groups`` lane groups
    to a CTA, with no pass left empty."""
    per_cta = pcr.grid_pairs_per_cta(s2)
    assert per_cta == (pcr.FACTOR_WIDE_THREADS if s2 == 2
                       else pcr.factor_groups(s2, pcr.FACTOR_WIDE_THREADS))
    for sms in (132, 114):
        for per_sm in (1, 2, 5, 8, 16):
            fp = pcr.factor_plan_grid(C, s2, B, sms, per_sm)
            assert 1 <= fp.ctas <= sms * per_sm
            assert fp.ctas * per_cta * fp.passes >= B * C
            assert fp.ctas * per_cta * (fp.passes - 1) < B * C
            assert fp.ctas <= -(-B * C // per_cta)


def test_factor_route_by_shape():
    """K4's factor is picked by shape alone: the wide library's grid at s2
    > 8, one block per member up to ``pcr.FACTOR_MEMBERS_MAX_C`` = 128
    chunks (config 5's 100, the smaller plans), the narrow grid above (the
    cells' 1000..2500); every narrow route counts its launches apart."""
    for s2 in (10, 12, 14, 16):
        for C in (1, 100, 1000):
            assert pcr.factor_route(s2, C) == "wide"
    assert pcr.FACTOR_MEMBERS_MAX_C == 128
    for s2 in (2, 4, 6, 8):
        for C in (1, 2, 64, 100, 128):
            assert pcr.factor_route(s2, C) == "members"
        for C in (129, 256, 1000, 1534, 2048, 16384):
            assert pcr.factor_route(s2, C) == "grid"
    assert {"K4.pcr_factor", "K4.pcr_factor_members",
            "K4.pcr_factor_wide"} <= set(_launch.COUNTERS)
    assert kernel_checks.factor_entry(2, 100) == "K4.pcr_factor_members"
    assert kernel_checks.factor_entry(2, 2000) == "K4.pcr_factor"
    assert kernel_checks.factor_entry(6, 100) == "K4.pcr_factor_wide"


def test_correction_and_factor_checks_harness_on_cpu():
    """The new checks on CPU tensors (a few cases): plain against plain,
    nothing launched."""
    before = _launch.counts()
    results = kernel_checks.check_all_corrections(
        "cpu", torch.float64, blocks={2: (5, 1), 6: (5, 3)},
        shapes=kernel_checks.CORRECT_SHAPES[:3] + kernel_checks.CORRECT_SHAPES[5:6])
    kernel_checks.check_all_grid_factors(
        "cpu", torch.float64, results,
        cases=[(1, 3, 1, True), (2, 64, 1, True), (2, 130, 4, False)])
    assert results == {"K3.spike_correct": 0.0, "K3.spike_correct_wide": 0.0,
                       "K4.pcr_factor": 0.0, "K4.pcr_factor_members": 0.0}
    assert _launch.counts() == before


#: (N, nvar, halo, members, chunk count) of the cells under the narrow and
#: wide costs refitted to the Woodbury set-up across the card: KS (s = 2)
#: and Burgers (s = 1) at 10^6 (Woodbury) and 2^20 (block-cyclic), the
#: padded ring N = 999983, KS 10^4; config 5 (B = 1024, its own batch
#: cost); the film's grids (s = 6, the wide cost)
CELL_PICKS = [(10 ** 6, 1, 2, 1, 4000), (1 << 20, 1, 2, 1, 4096), (10 ** 6, 1, 1, 1, 5000),
              (1 << 20, 1, 1, 1, 4096), (999983, 1, 2, 1, 4065), (10 ** 4, 1, 2, 1, 500),
              (10 ** 5, 1, 2, 1024, 100), (10 ** 6, 3, 2, 1, 2000), (1 << 20, 3, 2, 1, 2048)]


@pytest.mark.parametrize("N,nvar,halo,B,want", CELL_PICKS)
def test_refitted_costs_give_the_cells_picks(N, nvar, halo, B, want):
    """``make_plan`` under the constants refitted to the Woodbury set-up
    across the card (``chunked.ROW_US`` / ``LEVEL_US`` / ``SLAB_US``, a
    non-negative fit of both dtypes' KS 10^6 and 10^4 chunk sweeps;
    ``WIDE_ROW_US`` / ``WIDE_LEVEL_US`` / ``WIDE_WOOD_US``, of the film's)
    picks each cell's chunk count, the least modelled cost over the exact
    counts; config 5's batch cost keeps its pick."""
    plan = chunked.make_plan(N, nvar, halo, True, B)
    assert plan.C == want
    s, M = plan.s, -(-N // plan.g)
    if B == 1 and not plan.padded:
        exact = [C for C in chunked.chunk_counts(N, halo, True)
                 if C <= pcr.max_chunks(2 * s)]
        cost = {C: chunked.plan_cost_us(M, C, s) + (
            chunked.woodbury_cost_us(C, s)
            if chunked.plan_with(N, nvar, halo, True, C).woodbury else 0.0) for C in exact}
        assert min(cost, key=lambda C: (cost[C], C)) == want
