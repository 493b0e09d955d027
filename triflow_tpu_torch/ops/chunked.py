"""Chunked SPIKE factor and solve of ``alpha*I + beta*J``: the plan and the
orchestration of kernels K2-K4.

Counterpart of ``triflow_tpu.ops.folded``'s ``factor_folded`` and
``_solve_folded_flat``, without the TPU's sublane packing of the chunk
axis: state and right-hand sides stay in the node layout ``(nvar, N)`` and
the kernels store their per-row arrays chunk-minor.

An ensemble's B grids (``Plan.B``) factor and solve in the same launches
with a leading member axis; C stays the chunk count of each member, chosen
by a cost fitted to B members (``batch_plan_cost_us``).

A periodic grid closes its ring inside the reduced interface system:
block-cyclic PCR where the chunk count C is a power of two >= 8 (the
reference's ``cyclic_ok``), otherwise acyclic PCR and a rank-2s Woodbury
correction (the reference's ``WrappedPcr``), so any C >= 2 serves.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import pcr, thomas

#: smallest power-of-two chunk count whose ring closes block-cyclic
MIN_CYCLIC_C = 8

#: cost model of a plan, in microseconds, fitted to the chunk-count sweep
#: of Burgers at N = 2^20 on one H100 (PERF.md): K2 and K3's sweep walk
#: the Mc rows of a chunk one after the other, and every level of K4's PCR
#: costs a fixed latency plus one slab per pcr.BLOCK_THREADS chunks
ROW_US = 1.5
LEVEL_US = 9.0
SLAB_US = 3.5


#: cost model of a plan at the wide block sizes s = 5..8 (K2-K4's wide
#: libraries), in microseconds of one fixed RODASPR step, fitted to
#: chip_smoke.py's chunk-count sweep of the s = 6 falling film at N = 10^6
#: (float64; PERF.md): K2's and K3's sweeps walk the Mc rows of a chunk, and
#: every level of K4's factor walks the chunks in passes of
#: ``wide_pass_chunks(s)`` lane groups, its cost bound by their shuffles.
#: Both grow as the per-lane work of the lane groups, s^2: the other wide
#: block sizes scale the s = 6 fit (not measured)
WIDE_ROW_US = 76.2
WIDE_PASS_US = 89.9
WIDE_FIT_S = 6


def wide_pass_chunks(s: int) -> int:
    """Chunks in one pass of K4's wide factor: 32 // (2s) groups of 2s lanes
    in each warp of its one block."""
    return pcr.BLOCK_THREADS // 32 * (32 // (2 * s))


def plan_cost_us(M: int, C: int, s: int = 1) -> float:
    """Modelled time of the sequential parts of one factor and solve with
    C chunks of M // C rows of block size s."""
    levels = pcr.n_levels(C)
    if s <= thomas.NARROW_S:
        slabs = -(-C // pcr.BLOCK_THREADS)
        return ROW_US * (M // C) + levels * (LEVEL_US + SLAB_US * slabs)
    passes = -(-C // wide_pass_chunks(s))
    return (s / WIDE_FIT_S) ** 2 * (WIDE_ROW_US * (M // C)
                                    + WIDE_PASS_US * levels * passes)


#: cost model of an ensemble's plan (B members of C chunks each), in
#: microseconds of one fixed RODASPR step, fitted to chip_smoke.py's
#: chunk-count sweep at config 5 (B = 1024 x KS N = 10^5, float64 and
#: float32 pooled, relative weights; PERF.md): every thread of K2 and K3
#: walks its chunk's Mc rows; K4 walks log2 C levels of ceil(C / 512)
#: slabs for ceil(B / SMS) waves of member blocks; and each doubling of C
#: costs a share of the ensemble's traffic, BATCH_SPLIT_US at config 5's
#: BATCH_REF_ROWS supernodes, in proportion to B * M elsewhere (the step is
#: bound by device memory, and more, shorter chunks read it less well).
#: The same sweep at B = 64 x KS N = 2^13 and B = 4 x KS N = 10^5 checks
#: it: there it picks the fastest float64 plan (C = 256, 500); a fit
#: pooled over the three shapes describes them worse and picks slower
#: plans everywhere (PERF.md)
BATCH_ROW_US = 3.391
BATCH_LEVEL_US = 21.918
BATCH_SPLIT_US = 4177.857
BATCH_REF_ROWS = 1024 * 50000
SMS = 132


def batch_features(M: int, C: int, B: int):
    """(rows walked, levels walked, doublings) of ``batch_plan_cost_us``."""
    slabs = -(-C // pcr.BLOCK_THREADS)
    return (M // C, pcr.n_levels(C) * slabs * -(-B // SMS),
            np.log2(C) * B * M / BATCH_REF_ROWS)


def batch_plan_cost_us(M: int, C: int, B: int) -> float:
    """Modelled time of one step of B members with C chunks of M // C rows
    each (without the part no chunk count changes)."""
    rows, levels, doublings = batch_features(M, C, B)
    return (BATCH_ROW_US * rows + BATCH_LEVEL_US * levels
            + BATCH_SPLIT_US * doublings)


class Plan(NamedTuple):
    N: int        # nodes
    nvar: int
    halo: int
    g: int        # nodes per supernode, max(halo, 1)
    W: int        # band window, 2 * halo + 1
    C: int        # chunks
    Mc: int       # supernode rows per chunk
    cyclic: bool  # block-cyclic PCR of the reduced system
    wrap: bool    # periodic ring: K2 keeps the wrap couplings and the
                  # shifts close the ring; with not cyclic, Woodbury
    B: int = 1    # members (an ensemble's grids), each of C chunks

    @property
    def s(self):
        return self.nvar * self.g

    @property
    def woodbury(self):
        return self.wrap and not self.cyclic

    @property
    def M(self):
        return self.N // self.g


def _divisors(M):
    out = set()
    d = 1
    while d * d <= M:
        if M % d == 0:
            out.update((d, M // d))
        d += 1
    return sorted(out)


def plan_with(N: int, nvar: int, halo: int, periodic: bool, C: int,
              B: int = 1) -> Plan:
    """The plan of C chunks (per member, of B): a periodic grid (with a
    halo) wraps, and its ring closes block-cyclic where C is a power of two
    >= 8, through the Woodbury correction otherwise."""
    g = max(halo, 1)
    wrap = bool(periodic) and halo > 0
    cyclic = wrap and C >= MIN_CYCLIC_C and C & (C - 1) == 0
    return Plan(N, nvar, halo, g, 2 * halo + 1, C, N // g // C, cyclic, wrap,
                B)


def chunk_counts(N: int, halo: int, periodic: bool):
    """The admissible chunk counts of a grid: divisors C of its M
    supernodes with at least 2 rows per chunk, and C >= 2 on a ring (the
    Woodbury closure couples chunk 0 to chunk C-1).  Raises where N is no
    multiple of the supernode size."""
    g = max(halo, 1)
    if N % g:
        raise ValueError(f"N = {N} is not a multiple of the supernode size "
                         f"g = {g} (identity padding is queued: ROADMAP A2c)")
    M = N // g
    wrap = bool(periodic) and halo > 0
    return [C for C in _divisors(M) if M // C >= 2 and (C >= 2 or not wrap)]


def make_plan(N: int, nvar: int, halo: int, periodic: bool,
              B: int = 1) -> Plan:
    """Chunk plan: the admissible chunk count C (``chunk_counts``, at most
    ``pcr.MAX_C``) of least ``plan_cost_us``, or for B > 1 members of
    least ``batch_plan_cost_us`` (fitted at s = 2).  K4's scratch grows as
    s^2 C: 7 (2s)^2 C entries, 235 MB at s = 8 and C = ``pcr.MAX_C`` in
    float64, which the card holds."""
    M = N // max(halo, 1)
    cands = [C for C in chunk_counts(N, halo, periodic) if C <= pcr.MAX_C]
    if not cands:
        raise ValueError(
            f"no chunk plan for a {'periodic ' if periodic else ''}grid of "
            f"{M} supernodes: no divisor leaves 2 rows per chunk"
            + (" in 2 chunks or more" if periodic else "")
            + " (identity padding is queued: ROADMAP A2c)")
    if B > 1:
        C = min(cands, key=lambda C: (batch_plan_cost_us(M, C, B), C))
    else:
        s = nvar * max(halo, 1)
        C = min(cands, key=lambda C: (plan_cost_us(M, C, s), C))
    return plan_with(N, nvar, halo, periodic, C, B)


class ChunkedFactorization:
    """Factorization of ``alpha*I + beta*J`` for the chunked solve."""

    def __init__(self, spikes, red, plan: Plan, Z=None, cap_inv=None):
        self.spikes = spikes
        self.red = red
        self.plan = plan
        self.Z = Z              # Woodbury plans: the closure's columns
        self.cap_inv = cap_inv  # and its capacitance inverse

    def solve(self, rhs, add_to=None):
        """``add_to + A^-1 rhs`` (or ``A^-1 rhs``), rhs of shape
        ((B,) nvar, N)."""
        plan = self.plan
        y, yred = thomas.thomas_sweep(self.spikes, rhs, plan)
        xm1, xp1 = pcr.pcr_solve_shift(self.red, yred, plan.wrap, self.Z,
                                       self.cap_inv)
        return thomas.spike_correct(self.spikes, y, xm1, xp1, plan,
                                    add_to=add_to)


def factor(alpha, beta, bands, periodic: bool, plan: Plan = None):
    """Factor ``alpha*I + beta*J`` from J's bands ((B,) W, nvar, nvar, N);
    ``beta`` is a number or a per-member (B,) tensor; ``plan`` defaults to
    ``make_plan`` of their shape."""
    if plan is None:
        W, nvar, _, N = bands.shape[-4:]
        B = bands.shape[0] if bands.ndim == 5 else 1
        plan = make_plan(N, nvar, W // 2, periodic, B)
    spikes = thomas.spike_factor(bands, alpha, beta, plan)
    red = pcr.pcr_factor(spikes.Lred, spikes.Ured, plan.cyclic)
    wood = (pcr.woodbury(red, spikes.Lred, spikes.Ured) if plan.woodbury
            else ())
    return ChunkedFactorization(spikes, red, plan, *wood)


def solve(fact: ChunkedFactorization, rhs, add_to=None):
    return fact.solve(rhs, add_to=add_to)
