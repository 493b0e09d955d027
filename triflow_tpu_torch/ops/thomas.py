"""Kernels K2 (chunked SPIKE factor) and K3 (per right-hand side sweep and
spike correction): wrappers and plain versions.

K2 replaces the TPU's ``ops/folded.py:factor_sweeps_folded`` and
``ops/pallas_thomas.py:_bwd_factor_call_cols`` (and, at block sizes 5..8,
``chunked_factor_sweeps`` / ``fused_factor_sweeps``); K3 replaces
``ops/pallas_thomas.py:chunked_solve_flat`` and the spike correction of
``ops/folded.py:_solve_folded_flat``.  Sources: ``csrc/spike_factor.cu``
and ``csrc/spike_solve.cu``, each built twice: for block sizes s <=
``NARROW_S`` and, with ``TF_WIDE`` defined, for
s = 5..``MAX_S`` (K2 walks a chunk with a group of s lanes), whose launches
count apart (``..._wide``).  The plain versions are the chunked factor and
sweeps of ``ops/banded.py``.

Every wrapper takes the plain version for CPU tensors and launches its
kernel for CUDA tensors; ``plan`` is an ``ops.chunked.Plan``.

Member axis: bands ``(B, W, nvar, nvar, N)`` (an ensemble's B grids) give
a factor whose arrays lead with B, each member's slab laid out as one
grid's (rows ``(B, Mc, s, s, C)``, reduced couplings ``(B, 2s, 2s, C)``),
and right-hand sides ``(B, nvar, N)``.  K2 and K3's sweep run one block of
walkers per group of (member, chunk) pairs, fed by ``cp.async`` copies
into a shared-memory ring on a plan of the host's (``factor_plan``,
``sweep_plan``); K2's walker is a thread, or in its wide library a group
of s lanes; K3's correction one block per group of (member, chunk) pairs
and of rows (``correct_plan``); members never couple, and each member's
ring closes on itself.  The factor shift ``beta`` is a number or a
per-member (B,) tensor on the bands' device (the kernel reads it there,
so shared and per-member step sizes take one code).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import banded
from ._build import csrc_library
from ._launch import (Counter, check_cuda, check_shapes, sm_count, stream_of,
                      suffix)

FACTOR_LAUNCHES = Counter("K2.spike_factor")
SWEEP_LAUNCHES = Counter("K3.thomas_sweep")
CORRECT_LAUNCHES = Counter("K3.spike_correct")
FACTOR_WIDE_LAUNCHES = Counter("K2.spike_factor_wide")
SWEEP_WIDE_LAUNCHES = Counter("K3.thomas_sweep_wide")
CORRECT_WIDE_LAUNCHES = Counter("K3.spike_correct_wide")

#: the block sizes s = nvar * max(halo, 1) the kernels are instantiated
#: for, as the reference's sweeps serve them: s <= NARROW_S in the
#: libraries of spike_factor.cu and spike_solve.cu, NARROW_S < s <= MAX_S
#: in their wide libraries
MAX_S = 8
NARROW_S = 4

FACTOR_LIB = csrc_library("spike_factor.cu")
SOLVE_LIB = csrc_library("spike_solve.cu")
FACTOR_WIDE_LIB = csrc_library("spike_factor.cu", "TF_WIDE",
                               by_dtype=True)
SOLVE_WIDE_LIB = csrc_library("spike_solve.cu", "TF_WIDE")


def pick(s, what, narrow, wide):
    """``narrow`` or ``wide`` (each a library and its launch counter) by
    the block size s; raises where no library instantiates s."""
    if s > MAX_S:
        raise NotImplementedError(
            f"{what}: block size s = {s} > {MAX_S} has no kernel "
            "instantiation")
    return narrow if s <= NARROW_S else wide


def members(t, unbatched_ndim):
    """(B, lead): the member count of ``t`` and the shape prefix its
    arrays carry, () for one grid (``unbatched_ndim`` dimensions)."""
    if t.ndim == unbatched_ndim:
        return 1, ()
    if t.ndim == unbatched_ndim + 1:
        return t.shape[0], (t.shape[0],)
    raise ValueError(f"tensor of shape {tuple(t.shape)}: expected "
                     f"{unbatched_ndim} dimensions, or one more for members")


def beta_args(beta, B, dtype, device, what):
    """(pointer, number) of a factor shift or F scale: a per-member (B,)
    tensor goes by its device address (the number is then unused), a
    number by value."""
    if isinstance(beta, torch.Tensor):
        check_cuda((beta,), dtype, what)
        check_shapes(what, beta=(beta, (B,)))
        return beta.data_ptr(), 0.0
    return 0, float(beta)


def _rows_shape(plan, lead=()):
    return (*lead, plan.Mc, plan.s, plan.s, plan.C)


def _chunk_major(t, lead):
    """A factor array of the kernel layout ((B,) Mc, ...) with Mc first,
    as the plain sweeps walk it."""
    return t.movedim(1, 0) if lead else t


def spike_factor_plain(bands, alpha, beta, plan):
    L, D, U = banded.assemble_blocks(banded.axpy_bands(alpha, beta, bands))
    fact = banded.chunked_factor(L, D, U, plan.C, plan.wrap)
    if bands.ndim == 4:
        return fact
    rows = [t.movedim(0, 1).contiguous() for t in fact[:5]]
    return banded.SpikeFactor(*rows, fact.Lred, fact.Ured)


def spike_factor(bands, alpha, beta, plan) -> banded.SpikeFactor:
    """Chunked factorization of ``alpha*I + beta*J`` from the bands
    ``((B,) W, nvar, nvar, N)`` of J."""
    if bands.device.type == "cpu":
        return spike_factor_plain(bands, alpha, beta, plan)
    B, lead = members(bands, 4)
    what = "K2 spike_factor"
    check_cuda((bands,), bands.dtype, what)
    check_shapes(what, bands=(bands, (*lead, plan.W, plan.nvar, plan.nvar,
                                      plan.Np)))
    lib, launches = pick(plan.s, what, (FACTOR_LIB, FACTOR_LAUNCHES),
                         (FACTOR_WIDE_LIB, FACTOR_WIDE_LAUNCHES))
    beta_ptr, beta_val = beta_args(beta, B, bands.dtype, bands.device, what)
    s, C = plan.s, plan.C
    rows = torch.empty((5, *_rows_shape(plan, lead)), dtype=bands.dtype,
                       device=bands.device)
    red = torch.empty((2, *lead, 2 * s, 2 * s, C), dtype=bands.dtype,
                      device=bands.device)
    fp = factor_plan(plan.nvar, plan.halo, bands.element_size(), plan.Mc, C,
                     B, sm_count(bands))
    fn = lib.fn(f"tf_spike_factor_{suffix(bands.dtype)}", 9, 11, 2)
    rc = fn(bands.data_ptr(), *(r.data_ptr() for r in rows),
            red[0].data_ptr(), red[1].data_ptr(), beta_ptr, plan.Np, plan.nvar,
            plan.g, plan.halo, plan.Mc, C, int(plan.wrap), B, fp.CB, fp.R,
            int(fp.persist), float(alpha), beta_val, stream_of(bands))
    lib.check(rc, what)
    launches.add()
    return banded.SpikeFactor(*rows, red[0], red[1])


#: stages of the shared-memory ring of K2's staged walk (kFactorStages in
#: csrc/spike_factor.cu), whose blocks are one warp of FACTOR_THREADS
FACTOR_STAGES = 4
FACTOR_THREADS = 32
#: most chunks one block of K2 walks (every lane of its warp)
FACTOR_MAX_CB = 32
#: shared memory a block of K2 may take at most, and at most what its
#: forward results kept for the backward pass may
FACTOR_SMEM = 100 * 1024
FACTOR_KEEP = 48 * 1024
#: an SM's schedulers: K2 plans one walking warp (one block) for each
SM_SCHEDULERS = 4


class FactorPlan(NamedTuple):
    CB: int        # chunks per block (walker lanes)
    R: int         # supernode rows per stage
    persist: bool  # forward results kept in shared memory
    smem: int      # bytes of shared memory per block


def factor_smem(nvar, halo, item, Mc, CB, R, persist):
    """Bytes of shared memory of a K2 plan (``factor_smem`` in
    csrc/spike_factor.cu): FACTOR_STAGES stages of the band tile (W nvar^2
    planes of R g nodes; without ``persist`` at least the backward pass's
    three row tiles of R s^2), with ``persist`` the forward results (3 Mc
    s^2), and at s <= NARROW_S each chunk's outer coupling Tr and previous
    U (s^2 each; the lane groups of the wide walk keep them in registers),
    for each of CB chunks."""
    g = max(halo, 1)
    s, planes = nvar * g, (2 * halo + 1) * nvar * nvar
    band, rows = planes * R * g, 3 * R * s * s
    stage = band if persist else max(band, rows)
    return item * CB * (FACTOR_STAGES * stage + (3 * Mc * s * s if persist else 0)
                        + (2 * s * s if s <= NARROW_S else 0))


@functools.lru_cache(maxsize=None)
def factor_plan(nvar, halo, item, Mc, C, B=1, sms=132):
    """K2's plan of block size s = nvar max(halo, 1).  At s <= NARROW_S a walk
    is bound by the issue and latency of its own instructions, which one
    warp issues for all of its walkers, so the plan gives each scheduler of
    the card one walking warp (one block), SM_SCHEDULERS per SM, with as
    many walkers as that takes: CB chunks per block (of the B * C chunks of
    all members, taken in turn), the least power of two up to
    FACTOR_MAX_CB that needs no more blocks than schedulers.  The blocks
    then share an SM's shared memory by four: CB halved, then the R = 8 rows
    per stage, until a block's stages fit its share (and FACTOR_SMEM); the
    forward results kept in shared memory where they take at most
    FACTOR_KEEP and the whole still fits.  (Chip runs at KS 2^20, 10^6 and
    config 5, PERF.md.)

    At s > NARROW_S a block is still one warp, of 32 // s lane groups
    walking a chunk each: CB = 32 // s, and R = 8 rows per stage (fewer
    where the chunks are shorter, or the stages would pass
    FACTOR_WIDE_SMEM), the forward results kept where they take at most
    FACTOR_KEEP and the whole still fits.  The walk of one block nearly
    fills its SM's issue, so the plan does not shrink the stages to put
    more blocks on an SM: at the film's C = 2048 and 4096 that cost 7 and
    48 % in float64 (chip runs, PERF.md)."""
    s = nvar * max(halo, 1)
    chunks = B * C
    if s > NARROW_S:
        return _wide_factor_plan(nvar, halo, item, Mc)
    CB = min(FACTOR_MAX_CB,
             1 << (-(-chunks // (SM_SCHEDULERS * sms)) - 1).bit_length())
    budget = min(FACTOR_SMEM, SM_SMEM // SM_SCHEDULERS - 1024)

    def smem(CB, R, persist):
        return factor_smem(nvar, halo, item, Mc, CB, R, persist)

    R = 8
    while smem(CB, R, False) > budget and CB > 1:
        CB //= 2
    while smem(CB, R, False) > budget and R > 1:
        R //= 2
    persist = (item * 3 * Mc * s * s * CB <= FACTOR_KEEP
               and smem(CB, R, True) <= budget)
    return FactorPlan(CB, R, persist, smem(CB, R, persist))


#: the wide walk (s > NARROW_S): the shared memory a block's stages may
#: take at most
FACTOR_WIDE_SMEM = 200 * 1024


def _wide_factor_plan(nvar, halo, item, Mc):
    g = max(halo, 1)
    CB = 32 // (nvar * g)

    def smem(R, persist):
        return factor_smem(nvar, halo, item, Mc, CB, R, persist)

    R = min(8, FACTOR_THREADS // g, 1 << (Mc - 1).bit_length())
    while smem(R, False) > FACTOR_WIDE_SMEM and R > 1:
        R //= 2
    persist = (item * 3 * Mc * (nvar * g) ** 2 * CB <= FACTOR_KEEP
               and smem(R, True) <= FACTOR_WIDE_SMEM)
    return FactorPlan(CB, R, persist, smem(R, persist))


#: stages of the shared-memory ring of K3's staged sweep (kStages in
#: csrc/spike_solve.cu)
SWEEP_STAGES = 4
#: most chunks one block walks (half a warp of walkers), and the fewest it
#: is cut down to for more blocks
SWEEP_MAX_CB = 16
SWEEP_MIN_CB = 4
#: shared memory a block's plan may take at most, and at most what the
#: forward results kept for the backward pass may; an SM's shared memory
#: (228 KB, of which each resident block also takes 1 KB and the kernel's
#: own 512 bytes) shared by the blocks a grid puts on it, up to 16 (2048
#: threads)
SWEEP_SMEM = 100 * 1024
SWEEP_KEEP = 48 * 1024
SM_SMEM = 228 * 1024
SM_BLOCKS = 16


class SweepPlan(NamedTuple):
    CB: int        # chunks per block (walker lanes)
    R: int         # rows per stage
    persist: bool  # forward results kept in shared memory
    smem: int      # bytes of shared memory per block


def sweep_smem(s, item, Mc, CB, R, persist):
    """Bytes of shared memory of a sweep plan (``sweep_smem`` in
    csrc/spike_solve.cu): SWEEP_STAGES stages of two s x s row tiles and a
    vector tile, the out tile, and with ``persist`` the forward results."""
    return item * CB * (SWEEP_STAGES * R * (2 * s * s + s) + R * s
                        + (Mc * s if persist else 0))


@functools.lru_cache(maxsize=None)
def sweep_plan(s, item, Mc, C, B=1, sms=132):
    """K3's sweep plan.  CB chunks per block (of the B * C chunks of all
    members, taken in turn): from SWEEP_MAX_CB (at most B * C rounded up to
    a power of two), halved down to SWEEP_MIN_CB while the grid has fewer
    than two blocks per SM.  The blocks each SM then holds (at most
    SM_BLOCKS) share its shared memory: R rows per stage from 8, halved,
    then CB, until a block's stages fit its share (and SWEEP_SMEM); the
    forward results kept in shared memory where they take at most
    SWEEP_KEEP and the whole still fits.  (Chip runs at KS 2^20, the film
    and config 5: occupancy decides, PERF.md.)"""
    chunks = B * C
    CB = min(SWEEP_MAX_CB, 1 << (chunks - 1).bit_length())
    while CB > SWEEP_MIN_CB and -(-chunks // CB) < 2 * sms:
        CB //= 2
    per_sm = min(SM_BLOCKS, -(-(-(-chunks // CB)) // sms))
    budget = min(SWEEP_SMEM, SM_SMEM // per_sm - 1536)
    R = 8
    while sweep_smem(s, item, Mc, CB, R, False) > budget and R > 1:
        R //= 2
    while sweep_smem(s, item, Mc, CB, R, False) > budget and CB > 1:
        CB //= 2
    persist = (item * Mc * s * CB <= SWEEP_KEEP
               and sweep_smem(s, item, Mc, CB, R, True) <= budget)
    return SweepPlan(CB, R, persist, sweep_smem(s, item, Mc, CB, R, persist))


def thomas_sweep_plain(fact: banded.SpikeFactor, rhs, plan):
    _, lead = members(rhs, 2)
    y = banded.chunked_sweep(*(_chunk_major(t, lead) for t in fact[:3]),
                             banded.nodes_to_rows(rhs, plan.g, plan.C))
    return banded.rows_to_nodes(y, plan.nvar), torch.cat([y[0], y[-1]], dim=-2)


def thomas_sweep(fact: banded.SpikeFactor, rhs, plan):
    """Chunk-local Thomas solve of ``rhs ((B,) nvar, N)``: returns y of
    rhs's shape and the interface right-hand side yred ((B,) 2s, C)."""
    if rhs.device.type == "cpu":
        return thomas_sweep_plain(fact, rhs, plan)
    B, lead = members(rhs, 2)
    what = "K3 thomas_sweep"
    check_cuda((rhs, fact.fac, fact.Dhinv, fact.DU), rhs.dtype, what)
    rows = _rows_shape(plan, lead)
    check_shapes(what, rhs=(rhs, (*lead, plan.nvar, plan.Np)),
                 fac=(fact.fac, rows), Dhinv=(fact.Dhinv, rows),
                 DU=(fact.DU, rows))
    lib, launches = pick(plan.s, what, (SOLVE_LIB, SWEEP_LAUNCHES),
                         (SOLVE_WIDE_LIB, SWEEP_WIDE_LAUNCHES))
    y = torch.empty_like(rhs)
    yred = torch.empty((*lead, 2 * plan.s, plan.C), dtype=rhs.dtype,
                       device=rhs.device)
    sp = sweep_plan(plan.s, rhs.element_size(), plan.Mc, plan.C, B,
                    sm_count(rhs))
    fn = lib.fn(f"tf_thomas_sweep_{suffix(rhs.dtype)}", 6, 9)
    rc = fn(fact.fac.data_ptr(), fact.Dhinv.data_ptr(), fact.DU.data_ptr(),
            rhs.data_ptr(), y.data_ptr(), yred.data_ptr(), plan.Np, plan.nvar,
            plan.g, plan.Mc, plan.C, B, sp.CB, sp.R, int(sp.persist),
            stream_of(rhs))
    lib.check(rc, what)
    launches.add()
    return y, yred


#: the most chunks a block of K3's tiled correction takes (kMaxCorrectCB
#: in csrc/spike_solve.cu)
CORRECT_MAX_CB = 32


class CorrectPlan(NamedTuple):
    CB: int  # chunks per block, a power of two
    R: int   # supernode rows per block


def correct_rows(s, item):
    """Rows per block of K3's correction at CORRECT_MAX_CB chunks: 32 at s =
    1, at s = 2 16 in float32 and 8 in float64, else 8.  (Chip runs at KS
    2^20, 10^6 and the ring, Burgers, config 5 and the film,
    ``tools/sweep_plans.py k3c``, device µs: s = 1 32 rows 7.2 against 10.3
    for 8 in float64; s = 2 16 rows 6.5 against 7.3 for 8 in float32 and 8
    rows 17.9 against 19.3 for 16 in float64 at KS 2^20; at s = 6 8 and 16
    rows within 2 %; PERF.md.)"""
    if s == 1:
        return 32
    return 64 // item if s == 2 else 8


@functools.lru_cache(maxsize=None)
def correct_plan(s, item, Mc, C, B=1):
    """K3's correction plan: blocks of CB consecutive chunks (of the B * C
    chunks of all members, taken in turn, as ``sweep_plan`` takes them) by
    R supernode rows.  CB is CORRECT_MAX_CB, or the B * C chunks rounded up
    to a power of two where they are fewer: a warp's loads of one entry of
    W or V are then CB consecutive values (32 float64 values are two
    128-byte lines).  R is ``correct_rows(s, item)``, times CORRECT_MAX_CB // CB
    where the block takes fewer chunks, and at most the chunk's Mc rows
    rounded up to a power of two; each chunk's R g nodes per field are one
    contiguous run of the node layout."""
    chunks = B * C
    CB = min(CORRECT_MAX_CB, 1 << (chunks - 1).bit_length())
    return CorrectPlan(CB, min(correct_rows(s, item) * (CORRECT_MAX_CB // CB),
                               1 << (Mc - 1).bit_length()))


def spike_correct_plain(fact: banded.SpikeFactor, y, xm1, xp1, plan,
                        add_to=None):
    _, lead = members(y, 2)
    rows = banded.nodes_to_rows(y, plan.g, plan.C)
    if lead:
        # member-major rows against the member-major spikes
        rows = rows.movedim(0, 1)
        xm1, xp1 = xm1.unsqueeze(1), xp1.unsqueeze(1)
    rows = rows - banded.mv(fact.W, xm1) - banded.mv(fact.V, xp1)
    x = banded.rows_to_nodes(_chunk_major(rows, lead), plan.nvar)
    return x if add_to is None else add_to + x


def spike_correct(fact: banded.SpikeFactor, y, xm1, xp1, plan, add_to=None):
    """``add_to + (y - W xm1 - V xp1)`` in the node layout ((B,) nvar, N);
    xm1 and xp1 ((B,) s, C) are the neighbours' interface unknowns."""
    if y.device.type == "cpu":
        return spike_correct_plain(fact, y, xm1, xp1, plan, add_to)
    B, lead = members(y, 2)
    what = "K3 spike_correct"
    rows = _rows_shape(plan, lead)
    shapes = dict(y=(y, (*lead, plan.nvar, plan.Np)),
                  xm1=(xm1, (*lead, plan.s, plan.C)),
                  xp1=(xp1, (*lead, plan.s, plan.C)), W=(fact.W, rows),
                  V=(fact.V, rows))
    if add_to is not None:
        shapes["add_to"] = (add_to, (*lead, plan.nvar, plan.Np))
    check_cuda([t for t, _ in shapes.values()], y.dtype, what)
    check_shapes(what, **shapes)
    lib, launches = pick(plan.s, what, (SOLVE_LIB, CORRECT_LAUNCHES),
                         (SOLVE_WIDE_LIB, CORRECT_WIDE_LAUNCHES))
    out = torch.empty_like(y)
    cp = correct_plan(plan.s, y.element_size(), plan.Mc, plan.C, B)
    fn = lib.fn(f"tf_spike_correct_{suffix(y.dtype)}", 7, 9)
    rc = fn(y.data_ptr(), fact.W.data_ptr(), fact.V.data_ptr(), xm1.data_ptr(),
            xp1.data_ptr(), 0 if add_to is None else add_to.data_ptr(),
            out.data_ptr(), plan.Np, plan.nvar, plan.g, plan.Mc, plan.C,
            int(add_to is not None), B, cp.CB, cp.R, stream_of(y))
    lib.check(rc, what)
    launches.add()
    return out
