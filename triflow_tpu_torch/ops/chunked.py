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

Grids with no good chunk plan of their own are padded, as the reference
pads them (``ops/banded.py``: ``_assemble_blocks`` pads N to a multiple of
the supernode size g, ``_chunked_factor`` / ``_chunked_solve`` pad M to
C * Mc): ``make_plan`` also takes chunk counts C that do not divide the M =
ceil(N / g) supernodes, with Mc = ceil(M / C) rows each, and the system
grows to ``Plan.Np`` = C * Mc * g nodes of identity rows.  The padding is a
copy: ``factor`` forms ``alpha*I + beta*J`` in banded form on Np nodes
(identity on the padded ones) and factors it with K2-K4 as they are; each
solve pads the right-hand side with zeros and crops the solution back to
N.  A periodic grid whose N is no multiple of g, or whose M has no
admissible chunk count of its own (a prime M), takes the reference's
system-level closure instead of the interface-level one
(``Plan.ring``: ``banded.extract_wrap``, the acyclic padded factor, and
``banded.ring_setup`` / ``ring_correct``, its ``_attach_woodbury``): the
wrap couplings leave the bands, 2 nvar h columns are solved once per
factor, and each solve is corrected with their 2 nvar h x 2 nvar h
capacitance.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import banded, pcr, thomas

#: smallest power-of-two chunk count whose ring closes block-cyclic
MIN_CYCLIC_C = 8

#: cost model of a plan at block sizes s <= 4, in microseconds of one fixed
#: RODASPR step, fitted (non-negative least squares, relative weights, one
#: offset per grid and dtype) to the minima over six of chip_smoke.py's
#: chunk-count sweeps of KS at N = 10^6 and two at N = 10^4, float64 and
#: float32, on one H100 (PERF.md): K2 and K3's sweeps walk the Mc rows of a
#: chunk (ROW_US), and K4's pieces (the factor across the card, the cluster
#: solves with shifts and, on a Woodbury plan, the set-up's column
#: clusters) take each level in work that grows with the chunks a CTA
#: holds, counted in slabs of pcr.BLOCK_THREADS chunks (SLAB_US); the fit
#: puts no cost on a level beyond its slabs (LEVEL_US).  It picks C = 4000
#: at KS 10^6, the fastest of those minima in both dtypes
ROW_US = 1.743
LEVEL_US = 0.0
SLAB_US = 2.456


#: cost model of a plan at the wide block sizes s = 5..8 (K2-K4's wide
#: libraries), in microseconds of one fixed RODASPR step, fitted to the
#: minima over four of chip_smoke.py's chunk-count sweeps of the s = 6
#: falling film at N = 10^6 and 2^20 (non-negative least squares of both
#: dtypes, relative weights, one offset per grid and dtype; PERF.md): K2's
#: and K3's sweeps walk the Mc rows of a chunk (WIDE_ROW_US); K4's factor
#: spreads each level's two phases over the card, ``pcr.factor_plan_wide``'s
#: passes of lane groups per phase (WIDE_LEVEL_US per level and pass); and
#: on a Woodbury plan the set-up's column clusters take each level in work
#: that grows with the chunks a CTA holds, in slabs of pcr.BLOCK_THREADS
#: chunks (WIDE_WOOD_US, ``woodbury_cost_us``).  All grow as the per-lane
#: work of the lane groups, s^2: the other wide block sizes scale the s = 6
#: fit (not measured)
WIDE_ROW_US = 4.773
WIDE_LEVEL_US = 71.997
WIDE_WOOD_US = 11.589
WIDE_FIT_S = 6


def wide_features(M: int, C: int, s: int):
    """(rows walked, levels times passes of K4's wide factor, levels times
    slabs of pcr.BLOCK_THREADS chunks, the Woodbury set-up's) of a plan of C
    chunks of ceil(M / C) rows at a wide block size s, unscaled."""
    levels = pcr.n_levels(C)
    return (-(-M // C), levels * pcr.factor_plan_wide(C, 2 * s).passes,
            levels * -(-C // pcr.BLOCK_THREADS))


def plan_cost_us(M: int, C: int, s: int = 1) -> float:
    """Modelled time of the parts of one fixed RODASPR step that the chunk
    count changes, with C chunks of ceil(M / C) rows of block size s
    (without a wide Woodbury plan's set-up: ``woodbury_cost_us``)."""
    levels = pcr.n_levels(C)
    rows = -(-M // C)
    if s <= thomas.NARROW_S:
        slabs = -(-C // pcr.BLOCK_THREADS)
        return ROW_US * rows + levels * (LEVEL_US + SLAB_US * slabs)
    rows, passes, _ = wide_features(M, C, s)
    return (s / WIDE_FIT_S) ** 2 * (WIDE_ROW_US * rows + WIDE_LEVEL_US * passes)


def woodbury_cost_us(C: int, s: int) -> float:
    """Modelled time of K4's Woodbury set-up in one RODASPR step at a wide
    block size s (at s <= 4 ``plan_cost_us``'s slabs count it)."""
    if s <= thomas.NARROW_S:
        return 0.0
    return (s / WIDE_FIT_S) ** 2 * WIDE_WOOD_US * wide_features(1, C, s)[2]


#: modelled cost of padding, in microseconds of one fixed RODASPR step (the
#: unit of ``plan_cost_us``): the launches of the copies (the padded bands
#: per factor, the padded right-hand side and the cropped solution per
#: stage solve) and their bytes at the card's memory rate (3.35e6 bytes
#: per microsecond, float64); not fitted.  A padded periodic grid also
#: solves 2 nvar h columns per factor for its ring (``Plan.ring``), which
#: ``make_plan`` counts as that many more of a step's six stage solves
PAD_LAUNCH_US = 30.0
BYTES_PER_US = 3.35e6


def pad_cost_us(N: int, nvar: int, W: int, B: int = 1) -> float:
    """``PAD_LAUNCH_US`` plus the bytes of a padded plan's copies in one
    RODASPR step: the bands (W nvar^2 per node) once, the right-hand side
    and the solution (nvar each) for six stages, each read and written once
    in float64."""
    return PAD_LAUNCH_US + 16 * B * N * (W * nvar * nvar + 12 * nvar) \
        / BYTES_PER_US


#: cost model of an ensemble's plan (B members of C chunks each), in
#: microseconds of one fixed RODASPR step: every walker of K2 and K3 walks
#: its chunk's Mc rows; K4 walks log2 C levels of ceil(C / 512) slabs for
#: ceil(B / SMS) waves of member blocks; and each doubling of C costs a
#: share of the ensemble's traffic, BATCH_SPLIT_US at config 5's
#: BATCH_REF_ROWS supernodes, in proportion to B * M elsewhere (the step is
#: bound by device memory, and more, shorter chunks read it less well).
#: Chosen against chip_smoke.py's float64 chunk-count sweeps at config 5 (B
#: = 1024 x KS N = 10^5), B = 64 x KS N = 2^13 and B = 4 x KS N = 10^5 on
#: one H100 (PERF.md): the constants on a grid whose worst float64 pick is
#: nearest the fastest measured plan (config 5's step is within 6 % over C
#: = 10..500, and no least-squares fit of this form picks within 3 % there)
BATCH_ROW_US = 0.75
BATCH_LEVEL_US = 15.0
BATCH_SPLIT_US = 250.0
BATCH_REF_ROWS = 1024 * 50000
SMS = 132


def batch_features(M: int, C: int, B: int):
    """(rows walked, levels walked, doublings) of ``batch_plan_cost_us``."""
    slabs = -(-C // pcr.BLOCK_THREADS)
    return (-(-M // C), pcr.n_levels(C) * slabs * -(-B // SMS),
            np.log2(C) * B * M / BATCH_REF_ROWS)


def batch_plan_cost_us(M: int, C: int, B: int) -> float:
    """Modelled time of one step of B members with C chunks of ceil(M / C)
    rows each (without the part no chunk count changes)."""
    rows, levels, doublings = batch_features(M, C, B)
    return (BATCH_ROW_US * rows + BATCH_LEVEL_US * levels
            + BATCH_SPLIT_US * doublings)


class Plan(NamedTuple):
    N: int        # nodes of the grid
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
    ring: bool = False  # periodic ring closed at the system level (a
                        # padded grid): the wrap leaves the bands, the
                        # chunks are factored acyclic

    @property
    def s(self):
        return self.nvar * self.g

    @property
    def woodbury(self):
        return self.wrap and not self.cyclic

    @property
    def M(self):
        """Supernodes the kernels walk, C * Mc (the grid's N // g where
        the plan is not padded)."""
        return self.C * self.Mc

    @property
    def Np(self):
        """Nodes the kernels walk: N, or N padded with identity rows."""
        return self.C * self.Mc * self.g

    @property
    def padded(self):
        return self.Np != self.N


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
    """The plan of C chunks (per member, of B) of ceil(ceil(N / g) / C)
    rows: a periodic grid (with a halo) wraps, and its ring closes
    block-cyclic where C is a power of two >= 8, through the Woodbury
    correction otherwise; where the plan pads the grid (or C = 1), at the
    system level (``Plan.ring``)."""
    g = max(halo, 1)
    Mc = -(-(-(-N // g)) // C)
    ring = bool(periodic) and halo > 0 and (C * Mc * g != N or C < 2)
    wrap = bool(periodic) and halo > 0 and not ring
    cyclic = wrap and C >= MIN_CYCLIC_C and C & (C - 1) == 0
    return Plan(N, nvar, halo, g, 2 * halo + 1, C, Mc, cyclic, wrap, B, ring)


def chunk_counts(N: int, halo: int, periodic: bool):
    """The chunk counts of a grid that pad nothing: divisors C of its M
    supernodes with at least 2 rows per chunk, and C >= 2 on a ring (the
    Woodbury closure couples chunk 0 to chunk C-1); none where N is no
    multiple of the supernode size."""
    g = max(halo, 1)
    if N % g:
        return []
    M = N // g
    wrap = bool(periodic) and halo > 0
    return [C for C in _divisors(M) if M // C >= 2 and (C >= 2 or not wrap)]


def padded_counts(N: int, halo: int, max_c: int = pcr.MAX_C):
    """Every chunk count C <= ``max_c`` that leaves at least 2 rows in each
    of C chunks of ceil(M / C) rows, M = ceil(N / g), whether or not it
    pads the grid; for each row count Mc only the least C."""
    M = -(-N // max(halo, 1))
    out, seen = [], set()
    for C in range(1, min(max_c, M // 2) + 1):
        Mc = -(-M // C)
        if Mc not in seen:
            seen.add(Mc)
            out.append(C)
    return out


def make_plan(N: int, nvar: int, halo: int, periodic: bool,
              B: int = 1) -> Plan:
    """Chunk plan: the chunk count C of least modelled cost,
    ``plan_cost_us`` (with a wide Woodbury plan's ``woodbury_cost_us``) or
    for B > 1 members ``batch_plan_cost_us`` (fitted at s = 2), over the
    counts that pad nothing (``chunk_counts``) and those
    that pad (``padded_counts``), which pay ``pad_cost_us`` more, and on a
    ring 2 nvar h more solves per factor (beside a RODASPR step's six).  C
    is at most ``pcr.max_chunks(2s)``: the most chunks whose float64
    interface vectors K4's solve with shifts holds in one cluster's shared
    memory (``pcr.MAX_C`` up to s = 5; 4096 at s = 8), so no plan is one
    that K4 refuses in either dtype.  K4's factor scratch grows as s^2 C: 7
    (2s)^2 C entries, 59 MB at s = 8 and C = 4096 in float64."""
    g = max(halo, 1)
    s = nvar * g
    M = -(-N // g)
    max_c = pcr.max_chunks(2 * s)
    if B > 1:
        def cost(C):
            return batch_plan_cost_us(M, C, B)
    else:
        def cost(C):
            return plan_cost_us(M, C, s)
    exact = [C for C in chunk_counts(N, halo, periodic) if C <= max_c]
    # a ring's 2 nvar h column solves per factor beside a RODASPR step's six
    ring = 1 + (2 * nvar * halo / 6 if periodic and halo > 0 else 0)
    pad = pad_cost_us(N, nvar, 2 * halo + 1, B)

    def wood(C):
        # a ring on an exact count that is no power of two >= 8: Woodbury
        cyclic = C >= MIN_CYCLIC_C and C & (C - 1) == 0
        return woodbury_cost_us(C, s) if periodic and halo > 0 and not cyclic else 0.0

    keyed = [((cost(C) + (wood(C) if B == 1 else 0.0), C), C) for C in exact]
    keyed += [((cost(C) * ring + pad, C), C) for C in padded_counts(N, halo, max_c)
              if g * C * -(-M // C) != N or C not in exact]
    if not keyed:
        raise ValueError(f"no chunk plan for a grid of N = {N} nodes: "
                         f"fewer than 2 supernodes of g = {g}")
    return plan_with(N, nvar, halo, periodic, min(keyed)[1], B)


class ChunkedFactorization:
    """Factorization of ``alpha*I + beta*J`` for the chunked solve; on a
    padded plan, of the padded system, and on a ring plan with its
    system-level closure ``ring = (Z, cap_inv)``."""

    def __init__(self, spikes, red, plan: Plan, Z=None, cap_inv=None,
                 ring=None):
        self.spikes = spikes
        self.red = red
        self.plan = plan
        self.Z = Z              # Woodbury plans: the closure's columns
        self.cap_inv = cap_inv  # and its capacitance inverse
        self.ring = ring

    def _tri_solve(self, rhs, add_to=None):
        """``add_to + A_tri^-1 rhs`` of the chunked system (the padded one,
        the ring's wrap left out), on the grid's N nodes."""
        plan = self.plan
        if plan.padded:
            rhs = torch.nn.functional.pad(rhs, (0, plan.Np - plan.N))
        y, yred = thomas.thomas_sweep(self.spikes, rhs, plan)
        xm1, xp1 = pcr.pcr_solve_shift(self.red, yred, plan.wrap, self.Z,
                                       self.cap_inv)
        if not plan.padded:
            return thomas.spike_correct(self.spikes, y, xm1, xp1, plan,
                                        add_to=add_to)
        x = thomas.spike_correct(self.spikes, y, xm1, xp1, plan)
        x = x[..., :plan.N]
        return x.contiguous() if add_to is None else add_to + x

    def solve(self, rhs, add_to=None):
        """``add_to + A^-1 rhs`` (or ``A^-1 rhs``), rhs of shape
        ((B,) nvar, N)."""
        if self.ring is None:
            return self._tri_solve(rhs, add_to)
        x = banded.ring_correct(*self.ring, self._tri_solve(rhs),
                                self.plan.halo)
        return x if add_to is None else add_to + x


def factor(alpha, beta, bands, periodic: bool, plan: Plan = None):
    """Factor ``alpha*I + beta*J`` from J's bands ((B,) W, nvar, nvar, N);
    ``beta`` is a number or a per-member (B,) tensor; ``plan`` defaults to
    ``make_plan`` of their shape.  A padded or ring plan factors the copy
    of ``alpha*I + beta*J`` on ``plan.Np`` nodes (``padded_system``) with
    K2's shift (0, 1)."""
    if plan is None:
        W, nvar, _, N = bands.shape[-4:]
        B = bands.shape[0] if bands.ndim == 5 else 1
        plan = make_plan(N, nvar, W // 2, periodic, B)
    corners = None
    if plan.padded or plan.ring:
        bands, corners = padded_system(alpha, beta, bands, plan)
        alpha, beta = 0.0, 1.0
    spikes = thomas.spike_factor(bands, alpha, beta, plan)
    red = pcr.pcr_factor(spikes.Lred, spikes.Ured, plan.cyclic)
    wood = (pcr.woodbury(red, spikes.Lred, spikes.Ured) if plan.woodbury
            else ())
    fact = ChunkedFactorization(spikes, red, plan, *wood)
    if corners is not None:
        cols = banded.ring_columns(*corners, plan.nvar, plan.N)
        Z = torch.stack([fact._tri_solve(cols[..., c, :, :])
                         for c in range(cols.shape[-3])], dim=-3)
        fact.ring = banded.ring_setup(Z, plan.halo)
    return fact


def padded_system(alpha, beta, bands, plan: Plan):
    """(``alpha*I + beta*J`` in banded form on ``plan.Np`` nodes, the
    ring's wrap corners or None): identity rows on the padded nodes, and
    on a ring plan the wrap couplings moved out of the bands into the
    corner blocks (``banded.extract_wrap``)."""
    A = banded.axpy_bands(alpha, beta, bands)
    corners = banded.extract_wrap(A) if plan.ring else None
    if plan.padded:
        A = torch.nn.functional.pad(A, (0, plan.Np - plan.N))
        # a fill of each diagonal slice: no host value is copied, so a
        # captured graph (core/graphs.py) may hold it
        for m in range(plan.nvar):
            A[..., plan.halo, m, m, plan.N:].fill_(1.0)
    return A.contiguous(), corners


def solve(fact: ChunkedFactorization, rhs, add_to=None):
    return fact.solve(rhs, add_to=add_to)
