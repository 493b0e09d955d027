"""The launch plans of K2's and K4's wide kernels (block sizes s = 5..8) and
the chunk plan's wide cost model: pure functions of the shapes, checked on
the CPU."""

import pytest

from triflow_tpu_torch.ops import chunked, pcr, thomas

#: (nvar, halo) of every wide block size the staged walk instantiates
WIDE_BLOCKS = [(5, 0), (5, 1), (1, 5), (6, 0), (6, 1), (3, 2), (2, 3), (1, 6),
               (7, 0), (7, 1), (1, 7), (8, 0), (8, 1), (4, 2), (2, 4), (1, 8)]
#: (Mc, C, B): the film's plans at N = 10^6 and 2^20, short and long
#: chunks, many chunks, members
SHAPES = [(1000, 500, 1), (1024, 512, 1), (1, 40, 1), (2, 3, 1), (122, 4096, 1),
          (2, 8192, 1), (3000, 3, 1), (100, 128, 64), (4, 500, 4)]
#: H100's shared memory per SM and the most one block may take
SM_SMEM = 228 * 1024
BLOCK_SMEM = 227 * 1024


@pytest.mark.parametrize("nvar,halo", WIDE_BLOCKS)
def test_wide_factor_plan_fits_and_covers_every_chunk(nvar, halo):
    """K2's wide plan: one-warp blocks of 32 // s lane groups, a chunk
    each, so ceil(B C / CB) blocks cover every chunk; R g nodes per stage
    at most a warp's lanes, R = 8 unless the chunks are shorter or the
    stages would pass FACTOR_WIDE_SMEM; the shared memory the C source
    computes, with the static arrays within a block's 227 KB; the forward
    results kept only where they fit."""
    g = max(halo, 1)
    s = nvar * g
    for item in (4, 8):
        for Mc, C, B in SHAPES:
            fp = thomas.factor_plan(nvar, halo, item, Mc, C, B)
            assert fp.CB == 32 // s
            blocks = -(-B * C // fp.CB)
            assert (blocks - 1) * fp.CB < B * C <= blocks * fp.CB
            assert 1 <= fp.R <= 8 and fp.R * g <= 32 and fp.R < 2 * Mc
            assert fp.smem == thomas.factor_smem(nvar, halo, item, Mc, fp.CB, fp.R,
                                                 fp.persist)
            assert fp.smem <= thomas.FACTOR_WIDE_SMEM
            # with the static arrays: two offsets per chunk, and a block of
            # s x s entries (16-byte rounded) for each group's products
            static = 16 * fp.CB + (fp.CB + 1) * -(-s * s * item // 16) * 16
            assert fp.smem + static <= BLOCK_SMEM
            if fp.R < min(8, 32 // g) and fp.R < Mc:
                assert thomas.factor_smem(nvar, halo, item, Mc, fp.CB, 2 * fp.R,
                                          False) > thomas.FACTOR_WIDE_SMEM
            if fp.persist:
                assert item * 3 * Mc * s * s * fp.CB <= thomas.FACTOR_KEEP


def test_wide_factor_plan_at_the_film():
    """The film (nvar 3, halo 2, s = 6) at N = 10^6, C = 500: 100 blocks of
    five lane groups with stages of 8 rows (135 KB in float64, one block
    an SM); at C = 4096 the same stages (three blocks an SM in float64);
    chunks of 2 rows take stages of 2 and keep the forward results."""
    assert thomas.factor_plan(3, 2, 8, 1000, 500) == thomas.FactorPlan(
        5, 8, False, thomas.factor_smem(3, 2, 8, 1000, 5, 8, False))
    assert thomas.factor_plan(3, 2, 8, 1000, 500).smem == 138240
    assert thomas.factor_plan(3, 2, 8, 122, 4096)[:3] == (5, 8, False)
    assert thomas.factor_plan(3, 2, 4, 122, 4096)[:3] == (5, 8, False)
    assert thomas.factor_plan(3, 2, 8, 2, 8192)[:3] == (5, 2, True)
    # short chunks keep the forward results in shared memory
    assert thomas.factor_plan(3, 2, 8, 4, 500).persist


@pytest.mark.parametrize("s2", [10, 12, 14, 16])
def test_wide_pcr_factor_plan_covers_every_pair(s2):
    """K4's wide factor: a cooperative grid of at most ``per_sm`` CTAs (what
    the card holds) and FACTOR_WIDE_PER_SM on each SM, one lane group of s2
    lanes per (member, chunk) pair in each pass, the fewest passes, no
    idle CTA."""
    for sms, per_sm in ((132, 4), (132, 2), (16, 1)):
        for C in (1, 2, 3, 500, 512, 1000, 2048, 4096, 8192, 16384):
            for B in (1, 4, 1024):
                fp = pcr.factor_plan_wide(C, s2, B, sms, per_sm)
                gpc = pcr.factor_groups(s2, pcr.FACTOR_WIDE_THREADS)
                assert 1 <= fp.ctas <= sms * min(per_sm, pcr.FACTOR_WIDE_PER_SM)
                assert fp.ctas * gpc * fp.passes >= B * C
                assert fp.ctas * gpc * (fp.passes - 1) < B * C
                assert (fp.ctas - 1) * gpc < B * C
    # the film's C = 500 and 512 in one pass of 63 and 64 CTAs of eight
    # groups (two of 12 lanes in each of four warps); 4096 chunks in two
    # passes and 8192 in four of 264 CTAs, two an SM
    assert pcr.factor_groups(12, 128) == 8
    assert pcr.factor_plan_wide(500, 12) == pcr.FactorPlanWide(63, 1)
    assert pcr.factor_plan_wide(512, 12) == pcr.FactorPlanWide(64, 1)
    assert pcr.factor_plan_wide(4096, 12, 1, 132, 4) == pcr.FactorPlanWide(264, 2)
    assert pcr.factor_plan_wide(8192, 12) == pcr.FactorPlanWide(264, 4)


def test_wide_cost_model_terms():
    """The wide cost: rows walked, levels times K4's passes, and on a
    Woodbury plan levels times its set-up's slabs of 512 chunks; the
    Woodbury term is zero at s <= 4 (``plan_cost_us``'s slabs count it
    there) and every term scales as (s / 6)^2."""
    M = 500000
    assert chunked.wide_features(M, 500, 6) == (1000, 9, 9)
    assert chunked.wide_features(M, 8000, 6) == (63, 13 * 4, 13 * 16)
    assert chunked.woodbury_cost_us(500, 4) == 0.0
    for C in (500, 1000, 4000):
        assert chunked.plan_cost_us(M, C, 8) == pytest.approx(
            (8 / 6) ** 2 * chunked.plan_cost_us(M, C, 6))
        assert chunked.woodbury_cost_us(C, 8) == pytest.approx(
            (8 / 6) ** 2 * chunked.woodbury_cost_us(C, 6))


@pytest.mark.parametrize("N,want", [(10 ** 6, 2000), (1 << 20, 2048)])
def test_film_plans_take_the_least_modelled_cost(N, want):
    """The film's grids (nvar 3, halo 2, periodic): ``make_plan`` takes the
    count of least modelled cost over the exact counts (a Woodbury plan
    with its set-up) and the padded ones (with their ring's solves and
    copies): C = 2000 at N = 10^6 (Woodbury), 2048 at 2^20 (block-cyclic),
    the picks PERF.md reports against the chip's sweeps."""
    plan = chunked.make_plan(N, 3, 2, True)
    assert plan.C == want and not plan.padded
    M, s = N // 2, 6
    ring = 1 + 2 * 3 * 2 / 6
    pad = chunked.pad_cost_us(N, 3, 5)
    costs = {}
    for C in chunked.chunk_counts(N, 2, True):
        if C <= pcr.max_chunks(12):
            p = chunked.plan_with(N, 3, 2, True, C)
            costs[C] = chunked.plan_cost_us(M, C, s) + (
                chunked.woodbury_cost_us(C, s) if p.woodbury else 0.0)
    for C in chunked.padded_counts(N, 2, pcr.max_chunks(12)):
        if chunked.plan_with(N, 3, 2, True, C).padded:
            costs.setdefault(C, chunked.plan_cost_us(M, C, s) * ring + pad)
    assert min(costs, key=costs.get) == want
    assert plan.woodbury == (N == 10 ** 6) and plan.cyclic == (N == 1 << 20)


def test_longest_builds_split_by_dtype():
    """K4's libraries and K2's wide one are built as one library per element
    type, two nvcc runs a caller starts together (``Library.builds``); each
    part's source keeps only its type's entries.  The other libraries stay
    whole."""
    from triflow_tpu_torch.ops import _build

    for lib in (pcr.LIB, pcr.WIDE_LIB, thomas.FACTOR_WIDE_LIB):
        assert lib.by_dtype and len(lib.builds()) == len(_build.SUFFIXES) == 2
        tail = lib.source().rstrip().splitlines()[-6:]
        assert tail[0] == "#ifndef TF_ONLY_F64" and "f32, float)" in tail[1]
        assert tail[3] == "#ifndef TF_ONLY_F32" and "f64, double)" in tail[4]
        assert tail[2] == tail[5] == "#endif"
    for lib in (thomas.FACTOR_LIB, thomas.SOLVE_LIB, thomas.SOLVE_WIDE_LIB):
        assert not lib.by_dtype and lib.builds() == [lib.load]
