"""Kernel K4: PCR of the chunk-interface system (the factor; the solve of
R right-hand sides, which also sets up the Woodbury closure; the per
right-hand side solve with neighbour shifts); wrappers and plain versions.

Replaces the TPU's ``ops/pallas_pcr.py:pcr_factor_fused_sub``,
``pcr_solve_fused_sub`` and ``interface_shift_solve``; source
``csrc/pcr.cu``.  The plain versions are ``ops/banded.py``'s
``pcr_factor`` / ``pcr_solve`` / ``woodbury_setup`` /
``woodbury_correct``.  The reduced system has identity diagonal blocks and
the couplings ``Lred`` / ``Ured`` (2s, 2s, C) that K2 writes.

A periodic ring on a chunk count that is no power of two >= 8 is factored
acyclic (which ignores the corner blocks ``Lred[..., 0]`` and
``Ured[..., C-1]``); ``woodbury`` then solves for the closure's 2s columns
Z and inverts its capacitance, once per factor, and every
``pcr_solve_shift`` with Z corrects the acyclic solution before the shifts
close the ring.

The R-column solve (``pcr_solve``, and the closure's columns in
``woodbury``) runs a thread-block cluster per (member, column): the
kernel of the solve with shifts, writing whole columns, ``solve_plan`` of
B R right-hand sides; the closure's capacitance then takes one block per
member.  Where members fill the card on plans of few chunks
(``cols_route``: config 5) one block per member walks all the columns
instead (counted as ``K4.pcr_solve_members``).  The chunk count is capped
at ``MAX_C``.  The factor spreads each level over a cooperative
grid of CTAs across the card (``factor_plan_grid``: at s2 <= 8 a thread
per (member, chunk) pair at s2 = 2, else a group of s2 lanes, the kernel
fixing which by s2; one phase a level but at s2 = 6), except at up to
``FACTOR_MEMBERS_MAX_C`` chunks, where one block per member walks the
levels faster than the grid's barriers allow (``factor_route``; counted as
``K4.pcr_factor_members``).  The per-stage
solve with shifts runs on a thread-block cluster of up to ``MAX_CLUSTER``
CTAs per member, each holding its slice of the chunks' vectors in shared
memory
(``solve_plan``); it refuses a (C, s2, dtype) whose vectors do not fit
``MAX_CLUSTER`` CTAs, and ``max_chunks`` gives the largest C it takes.
Interface blocks s2 = 2s of s <= ``thomas.NARROW_S``
launch ``csrc/pcr.cu``'s library; s2 = 10..16 (s = 5..8) its wide library
(``TF_WIDE``), whose launches count apart (``..._wide``).  Its factor runs
each (member, chunk) pair's level on a group of s2 lanes, two phases a
level (``factor_plan_wide``).  Every grid factor keeps its level state in
7 s2^2 B C entries of global scratch (59 MB at s2 = 16 and its largest C,
4096, in float64).

Member axis: an ensemble's reduced systems
``Lred, Ured (B, 2s, 2s, C)`` factor into level operators
``(B, nlev, 2s, 2s, C)`` and ``Dinv (B, 2s, 2s, C)``, one block (or one
cluster) each, the grid factors over all B C pairs at once;
right-hand sides lead with B the same way.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import banded, thomas
from .thomas import members
from ._build import csrc_library
from ._launch import (Counter, check_cuda, check_shapes, sm_count, stream_of,
                      suffix)

FACTOR_LAUNCHES = Counter("K4.pcr_factor")
FACTOR_MEMBERS_LAUNCHES = Counter("K4.pcr_factor_members")
SOLVE_LAUNCHES = Counter("K4.pcr_solve_shift")
COLS_LAUNCHES = Counter("K4.pcr_solve")
COLS_MEMBERS_LAUNCHES = Counter("K4.pcr_solve_members")
FACTOR_WIDE_LAUNCHES = Counter("K4.pcr_factor_wide")
SOLVE_WIDE_LAUNCHES = Counter("K4.pcr_solve_shift_wide")
COLS_WIDE_LAUNCHES = Counter("K4.pcr_solve_wide")

#: most chunks the one-block kernels take
MAX_C = 16384
#: threads of the one block (kThreads in csrc/pcr.cu)
BLOCK_THREADS = 512

#: the cluster solve with shifts (csrc/pcr.cu): most CTAs per cluster
#: (kMaxCluster), threads per CTA (kSolveThreads), the shared memory a CTA's
#: plan may take, and the least it must hold: the state beside a ring of
#: SOLVE_MIN_STAGES slabs of SOLVE_MIN_CT chunks (a C that needs more than
#: MAX_CLUSTER such CTAs is refused); the chunks per CTA a single grid's
#: cluster aims at (chip runs at KS 2^20 and 10^6: 16 CTAs of 64 chunks
#: beat 8 of 128 and fewer, PERF.md)
MAX_CLUSTER = 16
SOLVE_THREADS = 512
SOLVE_SMEM = 220 * 1024
SOLVE_MIN_STAGES = 3
SOLVE_MIN_CT = 8
SOLVE_CHUNKS = 64

# the longest nvcc runs of the kernels, each split by dtype to build in
# parallel
LIB = csrc_library("pcr.cu", by_dtype=True)
WIDE_LIB = csrc_library("pcr.cu", "TF_WIDE", by_dtype=True)


class PcrFactor(NamedTuple):
    """Per-level operators ((B,) nlev, s2, s2, C) and final inverse
    ((B,) s2, s2, C)."""

    alphas: torch.Tensor
    betas: torch.Tensor
    Dinv: torch.Tensor


def n_levels(C: int) -> int:
    return (C - 1).bit_length()


class SolvePlan(NamedTuple):
    K: int        # CTAs per cluster (per member)
    Cc: int       # chunks per CTA (the last CTA may hold fewer)
    Ct: int       # chunks per tile of the operator ring
    D: int        # slabs in the operator ring
    threads: int  # threads per CTA, s2 Ct rounded up to a warp
    smem: int     # bytes of dynamic shared memory per CTA


def solve_smem(s2, item, Cc, Ct, D):
    """Bytes of shared memory of a cluster solve plan (``solve_smem`` in
    csrc/pcr.cu): the two level buffers of Cc chunks' s2-vectors and D
    slabs of two s2 x s2 operators for Ct chunks."""
    return item * (2 * s2 * Cc + D * 2 * s2 * s2 * Ct)


def _slice(C, K):
    """Chunks per CTA of K CTAs: ceil(C / K) rounded up to a power of two
    (the kernel finds a chunk's CTA by a shift)."""
    return 1 << (-(-C // K) - 1).bit_length()


def _fits(C, s2, item, K):
    Cc = _slice(C, K)
    return solve_smem(s2, item, Cc, min(Cc, SOLVE_MIN_CT), SOLVE_MIN_STAGES) <= SOLVE_SMEM


@functools.lru_cache(maxsize=None)
def max_chunks(s2, item=8):
    """The largest chunk count whose solve with shifts fits MAX_CLUSTER
    CTAs at interface block size s2 and element size ``item`` (at most
    MAX_C)."""
    lo, hi = 1, MAX_C
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if _fits(mid, s2, item, MAX_CLUSTER) else (lo, mid - 1)
    return lo


@functools.lru_cache(maxsize=None)
def solve_plan(C, s2, B=1, item=8, sms=132, max_cluster=MAX_CLUSTER):
    """The cluster plan of the solve with shifts: K CTAs per member, each
    of Cc chunks, ceil(C / K) rounded up to a power of two.  K is at least the fewest CTAs whose shared
    memory holds the state beside a ring of SOLVE_MIN_CT chunks (a C that
    needs more than ``max_cluster`` raises ValueError), and otherwise one
    CTA per member where the B members fill the SMs, else up to
    ``max_cluster`` CTAs of about SOLVE_CHUNKS chunks each.  Tiles of Ct
    chunks, s2 Ct <= SOLVE_THREADS, halved until SOLVE_MIN_STAGES slabs fit
    beside the state; then a ring of as many slabs as fit, up to every
    slab of the solve (its levels and Dinv for each tile: the operators
    are in flight from the start), in the CTA's shared memory, or where
    the clusters need more than one wave of the card and the state allows,
    in half an SM's."""
    kmin = next((K for K in range(1, max_cluster + 1)
                 if _fits(C, s2, item, K)), None)
    if kmin is None:
        raise ValueError(
            f"K4 pcr_solve_shift: C = {C} chunks of interface block {s2} "
            f"({item}-byte entries) do not fit {max_cluster} CTAs' shared "
            f"memory (at most {max_chunks(s2, item)} at {MAX_CLUSTER})")
    K = max(kmin, min(max_cluster, -(-C // SOLVE_CHUNKS), max(1, sms // B)))
    Cc = _slice(C, K)
    K = -(-C // Cc)
    budget = SOLVE_SMEM
    if B * K > sms and solve_smem(s2, item, Cc, min(Cc, SOLVE_MIN_CT),
                                  SOLVE_MIN_STAGES) <= thomas.SM_SMEM // 2 - 2048:
        budget = thomas.SM_SMEM // 2 - 2048
    Ct = min(Cc, SOLVE_THREADS // s2)
    while Ct > 1 and solve_smem(s2, item, Cc, Ct, SOLVE_MIN_STAGES) > budget:
        Ct //= 2
    slabs = (n_levels(C) + 1) * -(-Cc // Ct)
    D = max(1, min(slabs, (budget // item - 2 * s2 * Cc) // (2 * s2 * s2 * Ct)))
    return SolvePlan(K, Cc, Ct, D, -(-s2 * Ct // 32) * 32, solve_smem(s2, item, Cc, Ct, D))


#: what a cluster solve solves and writes (``ClusterMode`` in csrc/pcr.cu):
#: the neighbour shifts of yred, with the Woodbury correction first, or
#: whole solution columns (of given right-hand sides or of the closure)
SHIFTS, SHIFTS_WOOD, COLUMNS = 0, 1, 2


@functools.lru_cache(maxsize=None)
def _scheduled_plan(lib, sfx, C, s2, n, item, sms, mode):
    """``solve_plan`` of n clusters (one per right-hand side) that the card
    schedules: the planned cluster size, or the largest smaller one that
    ``cudaOccupancyMaxActiveClusters`` admits for the kernel of ``mode``
    (asked once per shape)."""
    query = getattr(lib.load(sfx), f"tf_pcr_shift_clusters_{sfx}")
    query.argtypes = [ctypes.c_int] * 7
    query.restype = ctypes.c_int
    cap = MAX_CLUSTER
    while True:
        sp = solve_plan(C, s2, n, item, sms, cap)
        got = query(s2, mode, sp.K, sp.Cc, sp.Ct, sp.D, sp.threads)
        if got < 0:
            lib.check(-got, "K4 cluster solve")
        if got > 0:
            return sp
        if sp.K == 1:
            raise RuntimeError(f"K4 cluster solve: no cluster of {sp} fits the card")
        cap = sp.K - 1


def _check_sizes(s2, C, what):
    if C > MAX_C:
        raise ValueError(f"{what}: C = {C} > {MAX_C} chunks")
    if s2 % 2 or s2 > 2 * thomas.MAX_S:
        raise NotImplementedError(
            f"{what}: interface block size {s2} has no kernel instantiation")


def _pick(s2, narrow, wide):
    """(library, counter) of an interface block size s2."""
    return (LIB, narrow) if s2 <= 2 * thomas.NARROW_S else (WIDE_LIB, wide)


def pcr_factor_plain(Lred, Ured, cyclic: bool) -> PcrFactor:
    *lead, s2, _, C = Lred.shape
    eye = torch.eye(s2, dtype=Lred.dtype, device=Lred.device)
    alphas, betas, Dinv = banded.pcr_factor(
        Lred, eye[..., None].expand(*lead, s2, s2, C), Ured, cyclic)
    empty = Lred.new_zeros((*lead, 0, s2, s2, C))
    return PcrFactor(torch.stack(alphas, dim=-4) if alphas else empty,
                     torch.stack(betas, dim=-4) if betas else empty, Dinv)


#: the grid factor (csrc/pcr.cu, the wide s2 = 10..16 and the narrow s2 =
#: 2..8): threads of a CTA of its cooperative grid (kGridFactorThreads),
#: and the most of the wide factor's CTAs an SM is given (chip runs at the
#: film's C = 500..8192: one or two CTAs an SM beat four by 5-10 % where
#: the pairs fill the card, PERF.md)
FACTOR_WIDE_THREADS = 128
FACTOR_WIDE_PER_SM = 2
#: the most chunks at which the narrow factor keeps one block per member
#: (``factor_route``): its level walk grows with C (a thread per chunk, the
#: whole blocks spilling at s2 = 4), the grid's stays about one grid-wide
#: barrier a level.  Chip runs (``tools/sweep_plans.py k4n``, device µs,
#: float64 / float32, PERF.md): one block against the grid at s2 = 4 and
#: one grid, C = 128 35.7 / 17.9 against 38.6 / 30.9, C = 256 79.0 / 32.1
#: against 43.3 / 33.3; at C = 100 one block won at every B from 4 to 1024
#: (32.9 against 39.7 at B = 4, 409.0 against 610.9 at 1024, float64), at
#: C = 1000 the grid at B = 16 (133.1 against 393.4); at s2 = 2 one block
#: won up to C = 512 (23.9 against 25.8)
FACTOR_MEMBERS_MAX_C = 128
#: the fewest members at which the narrow R-column solve keeps one block
#: per member (``cols_route``, on plans of at most FACTOR_MEMBERS_MAX_C
#: chunks): as many as the card's SMs.  Chip runs of the Woodbury set-up
#: (``tools/ab_sweep.py``, device µs, float64 / float32, PERF.md): at C =
#: 100, one block per member against the clusters at B = 1024 232.1 / 145.4
#: against 293.1 / 272.9, at B = 132 48.0 / 32.5 against 42.9 / 39.4, at B
#: = 16 45.4 / 30.4 against 16.0 / 15.4; one grid of 2000 chunks 452.0
#: against 27.9
MEMBERS_COLS_MIN_B = 132


class FactorPlanWide(NamedTuple):
    ctas: int    # CTAs of the cooperative grid
    passes: int  # passes of the lane groups over the pairs in each phase


class FactorPlanGrid(NamedTuple):
    ctas: int    # CTAs of the cooperative grid
    passes: int  # passes of its warps (threads) over the pairs in each phase


def factor_groups(s2, threads):
    """Lane groups of s2 lanes in a CTA of ``threads``: 32 // s2 per warp."""
    return threads // 32 * (32 // s2)


@functools.lru_cache(maxsize=None)
def factor_plan_wide(C, s2, B=1, sms=132, per_sm=FACTOR_WIDE_PER_SM):
    """The plan of K4's wide factor: one group of s2 lanes per (member,
    chunk) pair in each phase, the B * C pairs in as few passes as the card
    allows: one CTA of FACTOR_WIDE_THREADS per ``factor_groups`` pairs, at
    most ``per_sm`` (and FACTOR_WIDE_PER_SM) CTAs on each of ``sms`` SMs;
    every CTA of the grid must be resident at once, ``per_sm`` being what
    the card holds.  Its shared memory is the groups' product blocks only
    (``wide.cuh: group_block``; at most 24 KB a CTA): the level state lives
    in L2."""
    pairs = B * C
    gpc = factor_groups(s2, FACTOR_WIDE_THREADS)
    ctas = max(1, min(-(-pairs // gpc), sms * min(per_sm, FACTOR_WIDE_PER_SM)))
    return FactorPlanWide(ctas, -(-pairs // (ctas * gpc)))


@functools.lru_cache(maxsize=None)
def factor_plan_grid(C, s2, B, sms, per_sm):
    """The plan of K4's narrow factor across the card (s2 <= 8): one CTA per
    ``grid_pairs_per_cta`` of the B * C pairs, at most ``per_sm`` (what the
    card holds at once) CTAs on each of ``sms`` SMs, in as few passes as
    that allows.  Each level is one phase (a pair inverts its neighbours'
    blocks itself), but at s2 = 6, two (csrc/pcr.cu)."""
    pairs = B * C
    per_cta = grid_pairs_per_cta(s2)
    ctas = max(1, min(-(-pairs // per_cta), sms * per_sm))
    return FactorPlanGrid(ctas, -(-pairs // (ctas * per_cta)))


def grid_pairs_per_cta(s2):
    """Pairs a CTA of the narrow grid factor takes in one pass: a thread
    each at s2 = 2, else a group of s2 lanes each (``factor_groups``), as
    csrc/pcr.cu's grid_factor_kernel picks its body by s2 (chip runs in
    float64, PERF.md: at Burgers' C = 2000 and 2048, s2 = 2, a thread 32.0
    against lane groups' 35.3 µs; at KS's C = 1024 and 1534, s2 = 4, lane
    groups 54.1 and 59.1 against a thread's 60.0 and 71.7 µs)."""
    return FACTOR_WIDE_THREADS if s2 == 2 else factor_groups(s2, FACTOR_WIDE_THREADS)


def factor_route(s2, C):
    """Which kernel factors reduced systems of interface block size s2 on C
    chunks (of one grid or of each member): "wide" (s2 > 2
    ``thomas.NARROW_S``: the lane-group grid of the wide library),
    "members" (one block per member, at C <= FACTOR_MEMBERS_MAX_C) or
    "grid" (the narrow factor across the card, ``factor_plan_grid``).
    Chosen by shape, never on failure."""
    if s2 > 2 * thomas.NARROW_S:
        return "wide"
    return "members" if C <= FACTOR_MEMBERS_MAX_C else "grid"


@functools.lru_cache(maxsize=None)
def _grid_blocks(lib, sfx, s2):
    """CTAs of a cooperative grid factor one SM holds (asked once)."""
    entry = "wide" if lib is WIDE_LIB else "grid"
    query = getattr(lib.load(sfx), f"tf_pcr_factor_{entry}_blocks_{sfx}")
    query.argtypes = [ctypes.c_int]
    query.restype = ctypes.c_int
    n = query(s2)
    if n < 0:
        lib.check(-n, "K4 pcr_factor")
    if n == 0:
        raise RuntimeError(f"K4 pcr_factor: no CTA of the grid factor (s2 = {s2}) "
                           "fits an SM")
    return n


def _factor(Lred, Ured, cyclic, route):
    """One launch of K4's factor by ``route`` (``factor_route``), on inputs
    the wrapper checked."""
    B, lead = members(Lred, 3)
    s2, _, C = Lred.shape[-3:]
    sfx = suffix(Lred.dtype)
    nlev = n_levels(C)
    ops = torch.empty((2, *lead, nlev, s2, s2, C), dtype=Lred.dtype,
                      device=Lred.device)
    Dinv = torch.empty((*lead, s2, s2, C), dtype=Lred.dtype, device=Lred.device)
    scratch = torch.empty((7, B * C, s2, s2), dtype=Lred.dtype, device=Lred.device)
    args = (Lred.data_ptr(), Ured.data_ptr(), ops[0].data_ptr(), ops[1].data_ptr(),
            Dinv.data_ptr(), scratch.data_ptr())
    if route == "members":
        fn = LIB.fn(f"tf_pcr_factor_{sfx}", 6, 4)
        rc = fn(*args, C, s2, int(bool(cyclic)), B, stream_of(Lred))
        LIB.check(rc, "K4 pcr_factor")
        FACTOR_MEMBERS_LAUNCHES.add()
        return PcrFactor(ops[0], ops[1], Dinv)
    if route == "wide":
        lib, launches, plan = WIDE_LIB, FACTOR_WIDE_LAUNCHES, factor_plan_wide
    else:
        lib, launches, plan = LIB, FACTOR_LAUNCHES, factor_plan_grid
    fp = plan(C, s2, B, sm_count(Lred), _grid_blocks(lib, sfx, s2))
    fn = lib.fn(f"tf_pcr_factor_{route}_{sfx}", 6, 5)
    rc = fn(*args, C, s2, int(bool(cyclic)), B, fp.ctas, stream_of(Lred))
    lib.check(rc, "K4 pcr_factor")
    launches.add()
    return PcrFactor(ops[0], ops[1], Dinv)


def pcr_factor(Lred, Ured, cyclic: bool) -> PcrFactor:
    """Factor the reduced system with identity diagonal blocks."""
    if Lred.device.type == "cpu":
        return pcr_factor_plain(Lred, Ured, cyclic)
    _, lead = members(Lred, 3)
    s2, _, C = Lred.shape[-3:]
    what = "K4 pcr_factor"
    check_cuda((Lred, Ured), Lred.dtype, what)
    check_shapes(what, Lred=(Lred, (*lead, s2, s2, C)),
                 Ured=(Ured, (*lead, s2, s2, C)))
    _check_sizes(s2, C, what)
    if cyclic and C & (C - 1):
        raise ValueError(f"{what}: cyclic PCR requires a power-of-two C")
    return _factor(Lred, Ured, cyclic, factor_route(s2, C))


def _columns(red: PcrFactor, lead):
    """The factor's operators with a column axis in front of each member's
    rows, for right-hand sides ((B,) R, s2, C)."""
    if not lead:
        return red
    return PcrFactor(red.alphas.unsqueeze(1), red.betas.unsqueeze(1),
                     red.Dinv.unsqueeze(1))


def pcr_solve_plain(red: PcrFactor, b):
    lead = red.Dinv.shape[:-3]
    if lead and b.ndim == 4:
        red = _columns(red, lead)
        return banded.pcr_solve(red.alphas.unbind(-4), red.betas.unbind(-4),
                                red.Dinv, b)
    return banded.pcr_solve(red.alphas, red.betas, red.Dinv, b)


def _check_factor(red: PcrFactor, s2, C, dtype, what, lead, *more):
    check_cuda((red.alphas, red.betas, red.Dinv) + more, dtype, what)
    ops = (*lead, n_levels(C), s2, s2, C)
    check_shapes(what, alphas=(red.alphas, ops), betas=(red.betas, ops),
                 Dinv=(red.Dinv, (*lead, s2, s2, C)))
    _check_sizes(s2, C, what)


def cols_route(s2, C, B):
    """Which kernel solves R columns of B members' reduced systems of
    interface block size s2 on C chunks: "members" (one block per member,
    pcr.cuh's body, narrow only, where MEMBERS_COLS_MIN_B members fill the
    card and their plans have at most FACTOR_MEMBERS_MAX_C chunks) or
    "clusters" (a thread-block cluster per member and column).  Chosen by
    shape, never on failure."""
    if s2 <= 2 * thomas.NARROW_S and B >= MEMBERS_COLS_MIN_B \
            and C <= FACTOR_MEMBERS_MAX_C:
        return "members"
    return "clusters"


def _launch_cols(red: PcrFactor, b, Lred, Ured, out, cap_inv, R, B, route):
    """One launch of the R-column solve by ``route`` (``cols_route``): of b,
    or (b None) of the Woodbury columns read off Lred / Ured, which also
    writes cap_inv (a second, one-block-per-member kernel after the
    clusters)."""
    s2, _, C = red.Dinv.shape[-3:]
    dtype = red.Dinv.dtype
    sfx = suffix(dtype)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    ptrs = (red.alphas.data_ptr(), red.betas.data_ptr(), red.Dinv.data_ptr(),
            ptr(b), ptr(Lred), ptr(Ured), out.data_ptr(), ptr(cap_inv))
    if route == "members":
        scratch = torch.empty((B, 2, R, s2, C), dtype=dtype, device=out.device)
        lib, _ = _pick(s2, None, None)
        fn = lib.fn(f"tf_pcr_solve_members_{sfx}", 9, 4)
        rc = fn(*ptrs, scratch.data_ptr(), C, s2, R, B, stream_of(out))
        lib.check(rc, "K4 pcr_solve")
        COLS_MEMBERS_LAUNCHES.add()
        return
    lib, launches = _pick(s2, COLS_LAUNCHES, COLS_WIDE_LAUNCHES)
    sp = _scheduled_plan(lib, sfx, C, s2, B * R, out.element_size(), sm_count(out),
                         COLUMNS)
    fn = lib.fn(f"tf_pcr_solve_{sfx}", 8, 9)
    rc = fn(*ptrs, C, s2, R, B, sp.K, sp.Cc, sp.Ct, sp.D, sp.threads, stream_of(out))
    lib.check(rc, "K4 pcr_solve")
    launches.add()


def pcr_solve(red: PcrFactor, b):
    """Solve the reduced system for R right-hand sides ``b ((B,) R, s2,
    C)`` in one launch by ``cols_route``; returns b's shape."""
    if b.device.type == "cpu":
        return pcr_solve_plain(red, b)
    B, lead = members(b, 3)
    R, s2, C = b.shape[-3:]
    _check_factor(red, s2, C, b.dtype, "K4 pcr_solve", lead, b)
    out = torch.empty_like(b)
    _launch_cols(red, b, None, None, out, None, R, B, cols_route(s2, C, B))
    return out


def woodbury_plain(red: PcrFactor, Lred, Ured):
    return banded.woodbury_setup(red.alphas, red.betas, red.Dinv, Lred, Ured)


def woodbury(red: PcrFactor, Lred, Ured):
    """The Woodbury closure of a ring factored acyclic: ``Z ((B,) 2s, 2s,
    C)``, the acyclic solve of its 2s columns, and ``cap_inv ((B,) 2s,
    2s)``, in one K4 call by ``cols_route`` (``banded.woodbury_setup`` has
    the algebra)."""
    if Lred.device.type == "cpu":
        return woodbury_plain(red, Lred, Ured)
    B, lead = members(Lred, 3)
    s2, _, C = Lred.shape[-3:]
    what = "K4 pcr_solve"
    _check_factor(red, s2, C, Lred.dtype, what, lead, Lred, Ured)
    check_shapes(what, Lred=(Lred, (*lead, s2, s2, C)),
                 Ured=(Ured, (*lead, s2, s2, C)))
    if C < 2:
        raise ValueError(f"{what}: the Woodbury closure needs C >= 2")
    Z = torch.empty((*lead, s2, s2, C), dtype=Lred.dtype, device=Lred.device)
    cap_inv = torch.empty((*lead, s2, s2), dtype=Lred.dtype,
                          device=Lred.device)
    _launch_cols(red, None, Lred, Ured, Z, cap_inv, s2, B, cols_route(s2, C, B))
    return Z, cap_inv


def pcr_solve_shift_plain(red: PcrFactor, yred, wrap: bool, Z=None,
                          cap_inv=None):
    s = yred.shape[-2] // 2
    z = pcr_solve_plain(red, yred)
    if Z is not None:
        z = banded.woodbury_correct(Z, cap_inv, z)
    xm1 = torch.roll(z[..., s:, :], 1, dims=-1)
    xp1 = torch.roll(z[..., :s, :], -1, dims=-1)
    if not wrap:
        xm1[..., 0] = 0.0
        xp1[..., -1] = 0.0
    return xm1, xp1


def pcr_solve_shift(red: PcrFactor, yred, wrap: bool, Z=None, cap_inv=None):
    """Solve the reduced system for ``yred ((B,) 2s, C)`` and return the
    neighbour interface unknowns of every chunk: ``xm1[..., :, c]`` =
    bottom of chunk c-1 and ``xp1[..., :, c]`` = top of chunk c+1, each
    ((B,) s, C); around the ring with ``wrap``, zero past the ends
    without.  With the Woodbury closure ``(Z, cap_inv)`` of ``woodbury``
    the acyclic solution is corrected to the ring's first."""
    if yred.device.type == "cpu":
        return pcr_solve_shift_plain(red, yred, wrap, Z, cap_inv)
    B, lead = members(yred, 2)
    s2, C = yred.shape[-2:]
    s = s2 // 2
    what = "K4 pcr_solve_shift"
    wood = () if Z is None else (Z, cap_inv)
    _check_factor(red, s2, C, yred.dtype, what, lead, yred, *wood)
    if Z is not None:
        if not wrap:
            raise ValueError(f"{what}: the Woodbury closure needs wrap")
        check_shapes(what, Z=(Z, (*lead, s2, s2, C)),
                     cap_inv=(cap_inv, (*lead, s2, s2)))
    lib, launches = _pick(s2, SOLVE_LAUNCHES, SOLVE_WIDE_LAUNCHES)
    sfx = suffix(yred.dtype)
    sp = _scheduled_plan(lib, sfx, C, s2, B, yred.element_size(),
                         sm_count(yred), SHIFTS if Z is None else SHIFTS_WOOD)
    out = torch.empty((2, *lead, s, C), dtype=yred.dtype, device=yred.device)
    fn = lib.fn(f"tf_pcr_solve_shift_{sfx}", 8, 9)
    rc = fn(red.alphas.data_ptr(), red.betas.data_ptr(), red.Dinv.data_ptr(),
            yred.data_ptr(), 0 if Z is None else Z.data_ptr(),
            0 if Z is None else cap_inv.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), C, s2, int(bool(wrap)), B, sp.K, sp.Cc, sp.Ct, sp.D,
            sp.threads, stream_of(yred))
    lib.check(rc, what)
    launches.add()
    return out[0], out[1]
