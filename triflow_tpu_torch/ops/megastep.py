"""Kernel K6: the whole implicit step of a small grid in one launch;
the plan and its gate, the wrappers, and their plain versions.

Replaces the TPU's ``ops/megastep.py:_launch`` (one or ``nsteps`` whole ROW
or theta steps: ``row_step_folded``, ``theta_step_folded``,
``row_scan_folded``, ``theta_scan_folded``), ``row_adaptive_step_folded``
(one adaptive output step with its accept/reject loop in the kernel) and
``row_adaptive_scan_folded`` (``nsteps`` adaptive output steps, shared or
per-member clocks: ``adaptive_scan``).  For one grid the step entry and the
adaptive scan also write each (output) step's state into a snapshot
buffer, and the scan each output step's time, dt, attempts and status
(counter ``K6.adaptive_snapshots``): the reference's ``device_steps``
collects its scan's snapshots this way.  Source ``csrc/megastep.cu``, generated
per model like K1 (``backend.megastep``); it runs K1-K5's arithmetic
(shared through the headers in ``csrc/``) phase after phase on one
thread-block cluster of K CTAs per member (K = 1 a plain block), each CTA
holding its run of the chunks and their share of the working set in its
shared memory (``cluster_plan``), so a step costs one launch instead of 7
(theta) or 38 (RODASPR).

A third entry, **K6's mixed entry** (``step_mixed``, counter
``K6.step_mixed``, one grid), is a library of its own, built from the same
source for a float64 model at the mixed entry's first launch
(``backend.megastep_mixed``: a ``double=True`` model never builds it):
``nsteps`` steps of the df64
precision mode's mixed-precision stage solve (``df64_mixed_solve=n``) in
one launch, replacing the TPU's ``row_step_df_folded`` and
``theta_step_df_folded`` (``ops/megastep.py``, the theta step as a
one-stage table with ``rhs = dt F``).  J, F, the stage sums and the final
combination are float64; the factor, the PCR factor and the solves are
float32 on J's bands rounded to float32; each of the ``passes`` residual
passes per stage is K8's body against the float64 bands.  Its own gate,
``mixed_plan_for`` (``MIXED_MAX_N``), decides where it serves.

The step and adaptive entries take an optional **Kahan carry** (``carry``: a
tensor of u's shape, written in place), the reference's
``compensated=True``: every accepted state is then the Kahan update
(``ops.compensated.kahan_update``) of the state before it by the step's
result.  The step entry carries it in and out across its steps, as the
reference's fixed scans do.  The adaptive entries start their first output
step from the carry as given (every caller passes zeros, as the reference's
steppers start from zero; a check seeds it) and every later output step
from zero, and leave the last output step's carry in the tensor.  A
launch with a carry counts as
``K6.compensated`` instead of its entry's counter.  The carry lives in
global memory beside the member's accepted states, not in the cluster's
shared memory, so ``cluster_plan`` and ``fits`` place every grid as they
place it without one.  The plain versions take the same carry.

Every entry takes a leading member axis (an ensemble's B grids, u
``(B, nvar, N)``): one cluster per member, as many clusters as the card
holds at once, each looping over its share of the members.  With a shared
dt the adaptive kernels take every attempt's err as the max over all
members (every CTA resident, a grid-wide barrier per attempt); with
``per_member=True`` each member runs its own controller.

``cluster_plan`` (host code, tested on the CPU) places a member: of the
cluster sizes ``CLUSTER_SIZES`` that give each CTA a run of chunks and
hold the buffers other CTAs read in shared memory (the rest in shared
memory where they fit, else in the CTA's slab of global memory), the one
of least ``cluster_cost_us``.  ``plan_for`` and ``mixed_plan_for`` admit
no grid that no cluster holds.

``plan_for`` alone decides whether a grid takes K6 or the multi-launch
path (K1-K5), on the CPU as on the card.  The plain versions compose the
plain chunked factor, sweep, PCR and combination on K6's plan; a CPU tensor
takes them, a CUDA tensor launches K6 or raises.  The plain adaptive step
is handed the scheme's controller (``core.rosenbrock.adaptive_controller``,
which ``ROW_general._adaptive`` runs on the host); the kernel runs the same
arithmetic.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import chunked, combine, mixed, pcr, stencil, thomas
from ._launch import Counter, check_cuda, check_shapes, stream_of, suffix
from .compensated import kahan_update
from .thomas import members

#: launches of the fixed-step entry (1 or nsteps steps) and of the adaptive
#: entry's two uses: one output step of one grid with a shared dt
#: (adaptive_kernel on a cluster, scan_kernel on one CTA with every buffer
#: in shared memory) and the adaptive scan (scan_kernel: nsteps output
#: steps, and every adaptive output step of B > 1 members or per member)
STEP_LAUNCHES = Counter("K6.step")
ADAPTIVE_LAUNCHES = Counter("K6.adaptive")
SCAN_LAUNCHES = Counter("K6.adaptive_scan")
#: the adaptive scan of one grid with per-output-step snapshots
SNAP_LAUNCHES = Counter("K6.adaptive_snapshots")
#: launches of the mixed entry (1 or nsteps mixed-precision steps)
MIXED_LAUNCHES = Counter("K6.step_mixed")
#: launches of the step and adaptive entries with a Kahan carry (each
#: counted here instead of under its entry's name)
COMPENSATED_LAUNCHES = Counter("K6.compensated")

#: stages of the widest table (RODASPR); kMaxStages in csrc/megastep.cu
MAX_STAGES = 6
#: widest block size s = nvar * max(halo, 1) K6 is instantiated for, the
#: reference's gate (its ``megastep.applicable``); K2-K4 go to
#: ``thomas.MAX_S``, but csrc/megastep.cu, which shares their s <= 4
#: bodies, has no wider instantiation
MAX_S = 4
#: threads per CTA (at most kMaxThreads in csrc/megastep.cu, its launch
#: bound: the s = 4 body takes the registers 256 threads leave it)
THREADS = 256
#: largest grid K6 takes, by block size s = nvar * max(halo, 1): the
#: largest N up to which K6's fixed RODASPR step beat the multi-launch
#: path in every pairing of chip_smoke.py's crossover sweep (N = 2^10 ..
#: 2^16, both dtypes; PERF.md), capped by the sweep's top: at s = 1 and 2
#: K6 won every pairing, Theta's too, at s = 4 RODASPR's up to 2^13 while
#: Theta's float64 step lost to the host-bound multi-launch path at 2^10,
#: 2^11 and from 2^13 (PERF.md §7); ``plan_for`` also refuses a grid no
#: cluster holds (``fits``); a block size no sweep measured takes the
#: multi-launch path
MAX_N = {1: 1 << 16, 2: 1 << 16, 4: 1 << 13}

#: largest grid K6's mixed entry takes, by block size s: the largest N at
#: which the mixed entry beat the multi-launch mixed path (K1, K2-K4 in
#: float32, K8) in every pairing of chip_smoke.py's crossover sweep of
#: fixed df64 RODASPR and Theta steps with one residual pass, over N =
#: 2^10 .. 2^15 and the reference's 10^4 (PERF.md): every pairing won up
#: to the sweep's top, 2^15, at s = 1 and 2; at s = 4 up to 2^14, where no
#: cluster holds 2^15
MIXED_MAX_N = {1: 1 << 15, 2: 1 << 15, 4: 1 << 14}

#: the cost model of a step on a cluster (``cluster_cost_us``), by block
#: size s, in microseconds of a step: per row of a chunk walk (a sweep's
#: forward and backward row; ROW_US with the factor rows in shared memory,
#: L2_ROW_US in L2), per PCR level of one solve (LEVEL_US, L2_LEVEL_US with
#: the level operators in L2), per pass of a CTA's threads over its nodes
#: in one stage (NODE_US: the sums, F and the correction, with each stage's
#: fixed phases; L2_NODE_US with a node vector in L2); every phase that
#: reads another CTA's share waits for a cluster barrier (SYNC_US).  Fitted
#: (non-negative least squares, relative residuals) to chip_smoke.py's
#: layout sweeps in float64 (``cluster_sweep``; PERF.md)
ROW_US = {1: 0.0672, 2: 0.1688, 4: 0.4994}
L2_ROW_US = {1: 0.2509, 2: 0.1789, 4: 0.5683}
LEVEL_US = {1: 0.3708, 2: 0.7007, 4: 8.1228}
L2_LEVEL_US = {1: 0.6942, 2: 0.7461, 4: 9.5615}
NODE_US = {1: 1.839, 2: 3.7699, 4: 14.1843}
L2_NODE_US = {1: 2.9411, 2: 4.6001, 4: 11.7167}
SYNC_US = 0.9619


def cluster_cost_us(M, C, s, g, K, n_stages=MAX_STAGES, rows_in_l2=False,
                    levels_in_l2=False, nodes_in_l2=False, threads=THREADS):
    """Modelled microseconds of one step on C chunks of ceil(M / C) rows of
    block size s (g nodes a row), on a cluster of K CTAs: the factor and
    every stage walk their chunks' rows (threads in passes over a CTA's
    chunks) and the PCR levels, and pass over the CTA's nodes; the levels
    and three node phases a stage, plus one, read other CTAs (a cluster
    barrier each where K > 1).  ``rows_in_l2`` / ``levels_in_l2`` /
    ``nodes_in_l2``: a factor row, level operator or node vector lives in
    L2."""
    Cc = -(-C // K)
    Mc = -(-M // C)
    nlev = pcr.n_levels(C)
    passes = -(-Cc // threads)
    node_passes = -(-(Cc * Mc * g) // threads)
    walks = n_stages + 1
    row = L2_ROW_US[s] if rows_in_l2 else ROW_US[s]
    level = L2_LEVEL_US[s] if levels_in_l2 else LEVEL_US[s]
    node = L2_NODE_US[s] if nodes_in_l2 else NODE_US[s]
    cost = walks * (row * Mc * passes + level * nlev + node * node_passes)
    if K > 1:
        cost += SYNC_US * walks * (nlev + 3)
    return cost


#: K6 declines a grid whose plan costs more than PAD_MARGIN times the
#: least-cost padded plan and more than MULTI_LAUNCH_US (``make_plan``):
#: the multi-launch path is host-bound on small grids, a RODASPR step of
#: the README model at N = 199 taking 2.14 ms synchronised on an H100
#: (float64, chip_smoke.py phase 3; PERF.md), so K6 keeps a serial plan
#: cheaper than that
PAD_MARGIN = 2.0
MULTI_LAUNCH_US = 2000.0


def plan_cost_us(M: int, C: int, s: int, g: int = 1) -> float:
    """Modelled time of one RODASPR step of K6 with C chunks of ceil(M / C)
    rows of block size s (g nodes a row) on the cluster size that serves
    it fastest, every buffer in shared memory (``cluster_cost_us`` over
    ``CLUSTER_SIZES``): a bound below ``layout_cost_us``, which places the
    buffers."""
    return min(cluster_cost_us(M, C, s, g, K) for K in CLUSTER_SIZES
               if K <= C and (K - 1) * -(-C // K) < C)


def layout_cost_us(N, nvar, halo, periodic, C):
    """Modelled time of one RODASPR step of K6 in float64 on C chunks, on
    the cluster ``cluster_plan`` places it on; None where no cluster holds
    it."""
    plan = chunked.plan_with(N, nvar, halo, periodic, C)
    try:
        return cluster_plan(plan, MAX_STAGES, torch.float64).cost_us
    except ValueError:
        return None


def make_plan(N: int, nvar: int, halo: int, periodic: bool):
    """K6's chunk plan of a grid: the admissible chunk count
    (``chunked.chunk_counts``: any divisor with at least 2 rows per chunk,
    C >= 2 on a ring) of least ``layout_cost_us`` (of least
    ``plan_cost_us`` where no cluster holds any), whatever N is; None when
    the grid has none, when its block size has no fitted cost, or when a
    chunk count that pads the grid (``chunked.padded_counts``) costs less
    than the plan's cost over ``PAD_MARGIN`` and the plan costs more than
    ``MULTI_LAUNCH_US``: K6 pads nothing, and such a grid (a prime
    supernode count: one serial chunk) takes K1-K5, which pad it."""
    g = max(halo, 1)
    s = nvar * g
    if N % g or s not in ROW_US:
        return None
    M = N // g
    cands = chunked.chunk_counts(N, halo, periodic)
    if not cands:
        return None
    placed = {C: layout_cost_us(N, nvar, halo, periodic, C) for C in cands}
    costs = ({C: c for C, c in placed.items() if c is not None}
             or {C: plan_cost_us(M, C, s, g) for C in cands})
    C = min(costs, key=lambda C: (costs[C], C))
    padded = min(plan_cost_us(M, c, s, g) for c in chunked.padded_counts(N, halo))
    cost = costs[C]
    if padded * PAD_MARGIN < cost and cost > MULTI_LAUNCH_US:
        return None
    return chunked.plan_with(N, nvar, halo, periodic, C)


def plan_for(N: int, nvar: int, halo: int, periodic: bool, B: int = 1):
    """The plan of a grid K6 takes (for each of B members), or None: the
    multi-launch path serves it (or raises, for a grid without a chunk
    plan)."""
    if N > MAX_N.get(nvar * max(halo, 1), 0):
        return None
    plan = make_plan(N, nvar, halo, periodic)
    if plan is None:
        return None
    plan = plan._replace(B=B)
    return plan if fits(plan) else None


def mixed_plan_for(N: int, nvar: int, halo: int, periodic: bool):
    """The plan of a grid K6's mixed entry takes (one grid), or None: the
    multi-launch mixed path serves it.  The TPU's lane-utilization plan
    and VMEM budget (``df64_small_plan_for``, ``applicable_df``) are not
    carried over: the chunk plan is ``make_plan``'s."""
    if N > MIXED_MAX_N.get(nvar * max(halo, 1), 0):
        return None
    plan = make_plan(N, nvar, halo, periodic)
    return plan if plan is not None and fits(plan, mixed=True) else None


class Table(NamedTuple):
    """The linear combinations of one step.  ``stages[k] = (a_row,
    c_row)``: stage k's input ``Σ a_row[j] * cols[j]`` and bias
    ``Σ c_row[j] * cols[j]`` (c_row None: no bias) over ``cols = (u, u_0,
    ..., u_{k-1})``; ``final``: the row of u_new, then the error row
    u_new - u_pred if any, over ``(u, u_0, ...)``; ``g00`` makes the
    adaptive entry's factor shift ``-g00 * dt``."""

    stages: tuple
    final: tuple
    g00: float


def row_table(a_t, c_t, m_t, m_pred_t, g00, with_err: bool) -> Table:
    """The table of a ROW step (the Hairer-Wanner transformed
    coefficients), with the error row when ``with_err``."""
    stages = []
    for i in range(len(m_t)):
        a_row = (1.0,) + tuple(float(a_t[i, j]) for j in range(i))
        c_row = (0.0,) + tuple(float(g00 * c_t[i, j]) for j in range(i))
        stages.append((a_row, c_row if any(c_row) else None))
    final = ((1.0,) + tuple(float(m) for m in m_t),)
    if with_err:
        final += ((0.0,) + tuple(float(m - p) for m, p in zip(m_t, m_pred_t)),)
    return Table(tuple(stages), final, float(g00))


def theta_table(theta) -> Table:
    """The theta step as a one-stage table: u2 = u + (I - theta dt J)^-1
    (dt F(u))."""
    return Table((((1.0,), None),), ((1.0, 1.0),), float(theta))


def _is_u(a_row):
    return a_row[0] == 1.0 and not any(a_row[1:])


# ---------------------------------------------------------------- plain


def _err_of(outs, u):
    """err of each member (a 0-d tensor for one grid): max|u_new - u_pred|,
    inf without an error row and where not finite."""
    lead = u.shape[:-2]
    if len(outs) == 1:
        return torch.full(lead, np.inf, dtype=u.dtype, device=u.device)
    err = outs[1].abs().amax(dim=(-2, -1))
    return torch.where(torch.isfinite(err), err, torch.full_like(err, np.inf))


def _plain_solver(bands, beta, plan, periodic, passes):
    """``solve(rhs)`` of ``I + beta*J`` on K6's plan from J's bands: the
    chunked factor and solve in the bands' dtype, or with ``passes`` (not
    None) the mixed solve: the factor of the bands rounded to float32, a
    float32 solve of the rounded rhs, then per pass the residual (K8's
    plain version) solved and added, widened."""
    fbands = bands if passes is None else bands.float()
    # a member's shift rounds to float32 as the factor takes it
    fbeta = (beta.float() if passes is not None and isinstance(beta, torch.Tensor)
             else beta)
    fact = thomas.spike_factor_plain(fbands, 1.0, fbeta, plan)
    red = pcr.pcr_factor_plain(fact.Lred, fact.Ured, plan.cyclic)
    wood = (pcr.woodbury_plain(red, fact.Lred, fact.Ured) if plan.woodbury
            else ())

    def solve(rhs):
        y, yred = thomas.thomas_sweep_plain(fact, rhs, plan)
        xm1, xp1 = pcr.pcr_solve_shift_plain(red, yred, plan.wrap, *wood)
        return thomas.spike_correct_plain(fact, y, xm1, xp1, plan)

    if passes is None:
        return solve

    def solve_mixed(rhs):
        k = solve(rhs.float()).double()
        for _ in range(passes):
            k = k + solve(mixed.mixed_residual_plain(bands, k, rhs, -beta,
                                                     periodic))
        return k

    return solve_mixed


def step_plain(backend, plan, table: Table, periodic, u, helpers, pstack, x,
               beta, scale, passes=None):
    """One step: J, the chunked factor of ``I + beta*J`` on K6's plan, and
    for each stage ``scale*F(u_i) + bias`` solved; returns (u_new, err),
    err inf without an error row and where not finite.  With a member axis
    ``beta`` and ``scale`` may be per-member (B,) tensors and err is (B,).
    With ``passes`` (float64 u) the stage solves are the mixed solve of
    ``_plain_solver``: the mixed entry's plain version."""
    bands = backend.J_bands_impl(u, helpers, pstack, x, periodic=periodic)
    solve = _plain_solver(bands, beta, plan, periodic, passes)
    us = []
    for a_row, c_row in table.stages:
        cols = [u] + us
        u_i = u if _is_u(a_row) else combine.combine_plain([a_row], cols)[0]
        bias = None if c_row is None else combine.combine_plain([c_row], cols)[0]
        rhs = stencil.eval_F_plain(backend, u_i, helpers, pstack, x, periodic,
                                   scale, bias)
        us.append(solve(rhs))
    outs = combine.combine_plain(list(table.final), [u] + us)
    return outs[0], _err_of(outs, u)


def scan_plain(backend, plan, table, periodic, u, helpers, pstack, x, beta,
               scale, nsteps, passes=None, snap=None, carry=None):
    """``nsteps`` plain steps; with ``snap`` (nsteps, nvar, N) step k's
    state is also written into ``snap[k]``; with ``carry`` (u's shape,
    updated in place) each step's state is the Kahan update of the last."""
    for k in range(nsteps):
        u2 = step_plain(backend, plan, table, periodic, u, helpers, pstack, x,
                        beta, scale, passes)[0]
        if carry is not None:
            u2, c2 = kahan_update(u, carry, u2)
            carry.copy_(c2)
        u = u2
        if snap is not None:
            snap[k] = u
    return u


def gdt_of(T, g00, dt, device):
    """g00 * dt rounded as the model's dtype multiplies them: a number for
    a shared dt, a (B,) tensor for per-member dts."""
    if np.ndim(dt):
        return torch.as_tensor(T(g00) * np.asarray(dt, dtype=T),
                               device=device)
    return float(T(g00) * T(dt))


def adaptive_plain(controller, backend, plan, table, periodic, u, helpers,
                   pstack, x, t, dt, internal_dt, tol, safety, max_iter,
                   dt_min, per_member=False, carry=None, step_fn=None):
    """One adaptive output step (clamp and recompute) of plain steps,
    decided by ``controller``: the scheme's
    ``core.rosenbrock.adaptive_controller`` (a shared dt: with a member
    axis err is the max over the members), or with ``per_member``
    ``core.rosenbrock.member_controller`` (each member's own clock and
    dt).  K6's adaptive entries run the same arithmetic.  Returns (u,
    dt_i, niter, status), dt_i and niter per member with ``per_member``;
    ``carry`` goes to the controller (Kahan updates where it accepts).
    ``step_fn`` runs each attempt (``step``'s arguments to ``scale``;
    ``step_plain`` by default): with K6's ``step`` entry on CUDA tensors
    it replays the adaptive entries' decisions on the card."""
    T = _np_type(u)
    step_fn = step_plain if step_fn is None else step_fn

    def attempt(_t, state, dt_eff):
        gdt = gdt_of(T, table.g00, dt_eff, u.device)
        u2, err = step_fn(backend, plan, table, periodic, state[0], helpers,
                          pstack, x, -gdt, gdt)
        if per_member:
            return (u2,), err.cpu().numpy().astype(T)
        return (u2,), T(err.max().item())

    _, (u2,), dt_i, niter, status = controller(
        attempt, T, t, dt, internal_dt, tol, safety, max_iter, dt_min, False,
        (u,), carry=carry)
    return u2, dt_i, niter, status


def adaptive_scan_plain(controller, backend, plan, table, periodic, u,
                        helpers, pstack, x, t, dt, internal_dt, tol, safety,
                        max_iter, dt_min, nsteps, per_member=False,
                        snap=None, carry=None, step_fn=None):
    """``nsteps`` output steps of ``adaptive_plain``, each from the last
    one's output time, stopping after the first with a nonzero status:
    (u, steps_done, dt_i, status, attempts), dt_i and the attempts summed
    over the steps per member with ``per_member``.  With ``snap`` (one
    grid: a pair of an (nsteps, nvar, N) tensor and an (nsteps, 4) float64
    array) output step k writes its state into ``snap[0][k]`` and its (t_i,
    dt_i, attempts, status) into ``snap[1][k]``, as the kernel does.  A
    ``carry``: the first output step starts from it, every later one from
    zero, as in the kernel; ``step_fn`` as ``adaptive_plain``'s."""
    T = _np_type(u)
    t_, dt_i, done, status, total = T(t), internal_dt, 0, 0, 0
    while done < nsteps and status == 0:
        if carry is not None and done:
            carry.zero_()
        u, dt_i, niter, st = adaptive_plain(
            controller, backend, plan, table, periodic, u, helpers, pstack, x,
            t_, dt, dt_i, tol, safety, max_iter, dt_min, per_member, carry,
            step_fn)
        t_ = t_ + T(dt)
        if snap is not None:
            snap[0][done] = u
            snap[1][done] = (t_, dt_i, niter, st)
        done += 1
        total = total + niter
        status = max(status, st)
    return u, done, dt_i, status, total


# --------------------------------------------------------------- kernel

#: the buffers of a member's working set, in the order of
#: csrc/megastep.cu's enum Buf: each CTA holds its share of every one
BUFFERS = ("u", "bands", "fac", "Dhinv", "DU", "Wsp", "Vsp", "Lred", "Ured",
           "alphas", "betas", "Dinv", "pscr", "Z", "us", "ui", "bias", "rhs",
           "y", "yred", "xm1", "xp1", "bands32", "r32", "d32")
#: buffers other CTAs of the cluster read (F's and J's halos, the closure's
#: end chunks, the PCR levels' neighbours and the shifts' neighbour
#: chunks): their shares always live in shared memory; in the mixed entry
#: the stage solutions too (the residual's halo)
NEIGHBOUR_READ = frozenset({"u", "ui", "Lred", "Ured", "pscr", "Z"})
MIXED_NEIGHBOUR_READ = NEIGHBOUR_READ | {"us"}
#: the order in which the other buffers take the shared memory left:
#: the vectors every stage touches first, then the per-level operators,
#: the factor rows each sweep walks, and last the bands (read once a step)
SHARED_FIRST = ("yred", "xm1", "xp1", "Dinv", "rhs", "y", "r32", "d32",
                "alphas", "betas", "fac", "Dhinv", "DU", "Wsp", "Vsp", "bias",
                "us", "bands32", "bands")
#: the factor rows the chunk walks read, and the PCR levels' operators:
#: where any of them lives in L2 the model charges L2_ROW_US / L2_LEVEL_US
ROW_BUFFERS = frozenset({"fac", "Dhinv", "DU", "Wsp", "Vsp"})
LEVEL_BUFFERS = frozenset({"alphas", "betas", "Dinv"})
#: the node vectors the stages read and write (L2_NODE_US where in L2)
NODE_BUFFERS = frozenset({"bands", "us", "bias", "rhs", "y", "bands32", "r32", "d32"})
#: the float32 buffers of the mixed entry (the rest are float64)
MIXED32 = frozenset({"bands32", "fac", "Dhinv", "DU", "Wsp", "Vsp", "Lred",
                     "Ured", "alphas", "betas", "Dinv", "pscr", "Z", "r32",
                     "y", "yred", "xm1", "xp1", "d32"})

#: shared memory one CTA may take (an H100's opt-in limit per block, static
#: and dynamic together), and a bound on what K6's kernels take statically
#: beside the plan's dynamic shares (the step table, the err reduction, the
#: capacitance and its Gauss-Jordan: under 5 KB at s = 4 in float64;
#: chip_smoke.py phase 0 prints each library's figure)
SMEM_PER_CTA = 232448
STATIC_SMEM = 8192
#: CTAs per member's cluster (16 is a non-portable size the kernels opt in
#: to); K = 1 is a plain block
CLUSTER_SIZES = (1, 2, 4, 8, 16)
#: SMs of the card the plans are made for (an H100), for the members a
#: cluster steps one after the other
SMS = 132
#: widest block size with a one-CTA instantiation (kOneBody in
#: csrc/megastep.cu: at s = 4 the body spills either way, and a second
#: instantiation doubled the library's build)
ONE_MAX_S = 2
#: doubles per member of a launch's info: err, dt_i, attempts, status,
#: output steps done
INFO = 5
#: per output step of the adaptive scan's snapshots: t_i, dt_i, attempts,
#: status (csrc/megastep.cu kSnapInfo)
SNAP_INFO = 4
#: element offsets align to 16 bytes
_ALIGN = 16
#: kernel kinds of the capacity query: the step entry, the adaptive entries
#: with a shared dt, and per member
STEP_KIND, SHARED_KIND, MEMBER_KIND = 0, 1, 2


class ClusterPlan(NamedTuple):
    """Where a member's step runs: K CTAs of ``threads`` threads, Cc chunks
    and Nr = Cc Mc g nodes per CTA, each buffer of ``BUFFERS`` in shared
    memory (home 0, at byte ``offsets[i]`` of the dynamic shared memory) or
    in the CTA's own slab of global memory (home 1, at that byte of it),
    ``smem`` dynamic shared bytes and ``gslab`` global bytes per CTA, the
    modelled µs of a step (``cluster_cost_us``), and ``one``: one CTA with
    every buffer in shared memory at s <= ONE_MAX_S, which the kernels run
    in their one-CTA instantiation (no cluster address mapping, every
    access in the shared-memory window)."""

    K: int
    threads: int
    Cc: int
    Nr: int
    homes: tuple
    offsets: tuple
    smem: int
    gslab: int
    cost_us: float
    one: bool  # the kernels' one-CTA instantiation (ONE_MAX_S)

    @property
    def bytes(self):
        """Shared memory per CTA, the kernels' static part included."""
        return self.smem + STATIC_SMEM

    def home(self, name):
        return "shared" if self.homes[BUFFERS.index(name)] == 0 else "L2"


def _cluster_shape(C, K):
    """Chunks per CTA (the last may hold fewer) of C chunks over K CTAs, or
    None where a CTA would hold none."""
    Cc = -(-C // K)
    if K > C or (K - 1) * Cc >= C:
        return None
    return Cc


def shares(plan, n_stages, K, mixed=False):
    """Elements of each buffer's share in one CTA of K (a dict by name of
    ``BUFFERS``)."""
    Cc = _cluster_shape(plan.C, K)
    s, nvar, Mc = plan.s, plan.nvar, plan.Mc
    s2, nlev = 2 * s, pcr.n_levels(plan.C)
    Nr = Cc * Mc * plan.g
    n, blk = nvar * Nr, s2 * s2 * Cc
    rows = Mc * s * s * Cc
    out = dict(u=n, bands=plan.W * nvar * nvar * Nr, fac=rows, Dhinv=rows,
               DU=rows, Wsp=rows, Vsp=rows, Lred=blk, Ured=blk,
               alphas=nlev * blk, betas=nlev * blk, Dinv=blk,
               pscr=(7 if K == 1 else 6) * blk,
               Z=blk if plan.woodbury else 0, us=n_stages * n, ui=n, bias=n,
               rhs=n, y=n, yred=s2 * Cc, xm1=s * Cc, xp1=s * Cc, bands32=0,
               r32=0, d32=0)
    if mixed:
        out.update(bands32=out["bands"], r32=n, d32=n)
    return out


def _place(sizes, item_of, must):
    """(homes, offsets, smem, gslab) of the shares: the ``must`` buffers in
    shared memory, then ``SHARED_FIRST`` while they fit, the rest in the
    CTA's global slab; None where the ``must`` buffers do not fit."""
    budget = SMEM_PER_CTA - STATIC_SMEM
    nbytes = {k: -(-sizes[k] * item_of(k) // _ALIGN) * _ALIGN for k in BUFFERS}
    home = dict.fromkeys(BUFFERS, 1)
    smem = sum(nbytes[k] for k in BUFFERS if k in must)
    if smem > budget:
        return None
    for k in must:
        home[k] = 0
    for k in SHARED_FIRST:
        if k not in must and smem + nbytes[k] <= budget:
            home[k] = 0
            smem += nbytes[k]
    at = [0, 0]
    offsets = []
    for k in BUFFERS:
        offsets.append(at[home[k]])
        at[home[k]] += nbytes[k]
    return tuple(home[k] for k in BUFFERS), tuple(offsets), at[0], at[1]


def cluster_plan(plan, n_stages, dtype, B=1, mixed=False, K=None):
    """The cluster a member's step runs on (``ClusterPlan``): of the sizes
    ``CLUSTER_SIZES`` that give every CTA a chunk and fit the buffers other
    CTAs read into shared memory (the rest where they fit, else the CTA's
    global slab), the one of least ``cluster_cost_us`` for B members (the
    members a cluster steps one after the other counted on a card of
    ``SMS`` SMs); ``K`` forces a size.  Pure Python (the CPU tests check
    it), cached by its arguments.  Raises ValueError where no cluster fits
    the member."""
    return _cluster_plan(plan, n_stages, dtype, B, mixed, K)


@functools.lru_cache(maxsize=4096)
def _cluster_plan(plan, n_stages, dtype, B, mixed, K):
    item = torch.finfo(dtype).bits // 8
    must = MIXED_NEIGHBOUR_READ if mixed else NEIGHBOUR_READ
    item_of = ((lambda k: 4 if k in MIXED32 else 8) if mixed
               else (lambda k: item))
    best = None
    for k in (CLUSTER_SIZES if K is None else (K,)):
        Cc = _cluster_shape(plan.C, k)
        if Cc is None or k > SMS:
            continue
        placed = _place(shares(plan, n_stages, k, mixed), item_of, must)
        if placed is None:
            continue
        homes, offsets, smem, gslab = placed
        rounds = -(-B // max(1, SMS // k))
        in_l2 = {name for name, h in zip(BUFFERS, homes) if h}
        one = k == 1 and not in_l2 and plan.s <= ONE_MAX_S
        cost = rounds * cluster_cost_us(
            plan.M, plan.C, plan.s, plan.g, k, n_stages, bool(in_l2 & ROW_BUFFERS),
            bool(in_l2 & LEVEL_BUFFERS), bool(in_l2 & NODE_BUFFERS))
        cand = ClusterPlan(k, THREADS, Cc, Cc * plan.Mc * plan.g, homes,
                           offsets, smem, gslab, cost, one)
        if best is None or cand.cost_us < best.cost_us:
            best = cand
    if best is None:
        raise ValueError(
            f"K6: no cluster of {CLUSTER_SIZES if K is None else (K,)} CTAs "
            f"holds a member of N = {plan.N}, C = {plan.C}, s = {plan.s} "
            f"({n_stages} stages, {dtype}{', mixed' if mixed else ''}) in "
            f"{SMEM_PER_CTA} bytes of shared memory per CTA")
    return best


def fits(plan, mixed=False):
    """Whether a cluster holds a member of ``plan`` at the widest table
    (``MAX_STAGES``) in float64: the gates admit no grid that fails."""
    try:
        cluster_plan(plan, MAX_STAGES, torch.float64, plan.B, mixed)
    except ValueError:
        return False
    return True


def step_phases(plan, n_stages, cluster):
    """(cluster barriers, block barriers, rows walked one after the other)
    of one step of csrc/megastep.cu on ``cluster``: the phases whose
    latency bounds the step (a cluster barrier where K > 1 for a phase
    that reads another CTA's share, else a block barrier), and the rows a
    thread walks in the chunk sweeps (2 Mc a walk, forward and back, in
    passes of the CTA's threads over its chunks)."""
    nlev = pcr.n_levels(plan.C)
    s2 = 2 * plan.s
    stored = cluster.one
    # the state copied in; the factor's copy, levels (and, on one CTA, the
    # stored inverses); on a Woodbury plan the columns' copy and levels,
    # the columns visible, the capacitance's Gauss-Jordan (4 a column)
    remote = 1 + 1 + nlev * (2 if stored else 1)
    local = 3 + 1
    if plan.woodbury:
        remote += 1 + nlev + 1
        local += 4 * s2 + 2
    # per stage: the stage input, the solve's copy, levels and solution;
    # the sums (bias only), F, the sweep, the correction and the Woodbury
    # coefficients
    remote += n_stages * (1 + 1 + nlev + 1)
    local += n_stages * (3 + 1 + (2 if plan.woodbury else 0))
    # err over the CTA (a tree over its threads) and the cluster
    local += (cluster.threads - 1).bit_length() + 2
    remote += 1 if cluster.K > 1 else 0
    rows = 2 * plan.Mc * -(-cluster.Cc // cluster.threads) * (n_stages + 1)
    if cluster.K == 1:
        return 0, remote + local, rows
    return remote, local, rows


class _Prepared(NamedTuple):
    """What one launch configuration passes the kernel besides the tensor
    addresses and the scalars: built once, reused by every launch."""

    cluster: ClusterPlan
    ints: object    # ctypes int array
    reals: object   # ctypes double array; the first 9 are set per launch


_PREPARED = {}
_CAPACITY = {}


def capacity(backend, dtype, kind, cluster):
    """Clusters of a K6 kernel the card holds at once at the cluster plan
    (blocks per SM times SMs for one-CTA clusters,
    ``cudaOccupancyMaxActiveClusters`` otherwise), by kernel kind."""
    one = int(cluster.one)
    key = (id(backend.megastep), dtype, kind, cluster.K, cluster.threads,
           cluster.smem, one)
    if key not in _CAPACITY:
        fn = backend.megastep.fn(f"tf_mega_capacity_{suffix(dtype)}", 0, 5)
        got = fn(kind, cluster.K, cluster.threads, cluster.smem, one, None)
        if got <= 0:
            backend.megastep.check(-got or 1, "K6 capacity")
        _CAPACITY[key] = got
    return _CAPACITY[key]


def _prepare(plan, table, periodic, nsteps, max_iter, dt_min, B, ncl,
             cluster):
    key = (plan, table, periodic, nsteps, max_iter, dt_min is not None, B,
           ncl, cluster)
    if key in _PREPARED:
        return _PREPARED[key]
    n_stages = len(table.stages)
    coefs = np.zeros((MAX_STAGES + 1, 2, MAX_STAGES + 1))
    for k, (a_row, c_row) in enumerate(table.stages):
        coefs[k, 0, :len(a_row)] = a_row
        if c_row is not None:
            coefs[k, 1, :len(c_row)] = c_row
    for r, row in enumerate(table.final):
        coefs[n_stages, r, :len(row)] = row
    rows = [1 + (c is not None) for _, c in table.stages] + [len(table.final)]
    rows += [1] * (MAX_STAGES + 1 - len(rows))
    cp = cluster
    ints = [plan.N, plan.Mc, plan.C, int(plan.cyclic), int(plan.wrap),
            int(bool(periodic)), n_stages, nsteps,
            -1 if max_iter is None else int(max_iter),
            int(dt_min is not None), B, ncl, cp.K, cp.threads, cp.Cc, cp.Nr,
            cp.smem, cp.gslab] + rows + list(cp.homes) + list(cp.offsets)
    if cp.gslab >= 2 ** 31 or plan.N * plan.nvar * B >= 2 ** 31:
        raise ValueError(f"K6: {cp.gslab} bytes of global memory per CTA, "
                         "more than the kernel's 32-bit slab size")
    prepared = _Prepared(cp, (ctypes.c_int * len(ints))(*ints),
                         (ctypes.c_double * (9 + coefs.size))(*[0.0] * 9,
                                                              *coefs.ravel()))
    _PREPARED[key] = prepared
    return prepared


def check_plan(plan, sysm, what):
    """Raise ValueError unless K6 takes ``plan`` for the model system
    ``sysm``: the model's variables and halo, and a block size of at most
    ``MAX_S``."""
    if (plan.nvar, plan.halo) != (sysm.nvar, sysm.halo):
        raise ValueError(f"{what}: plan {plan} does not fit the model")
    if plan.s > MAX_S:
        raise ValueError(f"{what}: block size s = {plan.s} > {MAX_S}, which "
                         "K6 has no instantiation for")


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _launch(entry, counter, backend, plan, table, periodic, u, helpers,
            pstack, x, reals, nsteps=1, max_iter=None, dt_min=None,
            kind=STEP_KIND, beta_b=None, scale_b=None, idt_b=None,
            cluster=None, snap=None, snap_info=None, carry=None):
    """Check the inputs, allocate the outputs, the states and the CTAs'
    global slabs, launch one K6 entry on the cluster plan (``cluster``, or
    ``cluster_plan``'s); returns (u_out, info (B, INFO) float64 on the
    device).  ``snap`` (one grid: (nsteps, nvar, N) of u's dtype) takes
    every step's or output step's state, ``snap_info`` ((nsteps,
    SNAP_INFO) float64, the adaptive scan's) each output step's (t_i, dt_i,
    attempts, status); the step entry then leaves u_out unwritten.
    ``carry`` (u's shape and dtype) is the Kahan carry, read and written in
    place; the launch then counts as ``K6.compensated``."""
    what = f"K6 {entry}"
    sysm = backend.system
    check_plan(plan, sysm, what)
    check_cuda((u, helpers, pstack, x), backend.dtype, what)
    N = plan.N
    B, lead = members(u, 2)
    check_shapes(what, u=(u, (*lead, sysm.nvar, N)),
                 helpers=(helpers, (*lead, len(sysm.help_funcs), N)),
                 pstack=(pstack, (*lead, len(sysm.pars), N)), x=(x, (N,)))
    per_member = [t for t in (beta_b, scale_b, idt_b) if t is not None]
    check_cuda(per_member, backend.dtype, what)
    check_shapes(what, **{f"per-member[{k}]": (t, (B,))
                          for k, t in enumerate(per_member)})
    if snap is not None:
        if u.ndim != 2:
            raise ValueError(f"{what}: snapshots are of one grid")
        check_cuda((snap,), backend.dtype, what, (nsteps, sysm.nvar, N))
    if snap_info is not None:
        check_cuda((snap_info,), torch.float64, what, (nsteps, SNAP_INFO))
    if carry is not None:
        check_cuda((carry,), backend.dtype, what, tuple(u.shape))
        counter = COMPENSATED_LAUNCHES
    if not 1 <= len(table.stages) <= MAX_STAGES:
        raise NotImplementedError(f"{what}: {len(table.stages)} stages; the "
                                  f"kernel takes 1 to {MAX_STAGES}")
    if cluster is None:
        cluster = cluster_plan(plan, len(table.stages), u.dtype, B)
    ncl = min(B, capacity(backend, u.dtype, kind, cluster))
    prep = _prepare(plan, table, periodic, nsteps, max_iter, dt_min, B, ncl,
                    cluster)
    n = sysm.nvar * N
    states = torch.empty(2 * B * n, dtype=u.dtype, device=u.device)
    gwork = torch.empty(max(1, ncl * cluster.K * cluster.gslab),
                        dtype=torch.uint8, device=u.device)
    info = torch.empty((B, INFO), dtype=torch.float64, device=u.device)
    out = torch.empty_like(u)
    sync = errs = None
    if kind == SHARED_KIND and ncl > 1:
        sync = torch.zeros(2, dtype=torch.int32, device=u.device)
        errs = torch.empty(2 * ncl * cluster.K, dtype=u.dtype,
                           device=u.device)
    item = u.element_size()
    ptrs = (ctypes.c_uint64 * 17)(
        u.data_ptr(), helpers.data_ptr(), pstack.data_ptr(), x.data_ptr(),
        info.data_ptr(), out.data_ptr(), gwork.data_ptr(), states.data_ptr(),
        states.data_ptr() + B * n * item, _ptr(beta_b), _ptr(scale_b),
        _ptr(idt_b), _ptr(sync), _ptr(errs), _ptr(snap), _ptr(snap_info),
        _ptr(carry))
    prep.reals[:9] = reals
    lib = backend.megastep
    args = (ctypes.addressof(ptrs), ctypes.addressof(prep.ints),
            ctypes.addressof(prep.reals))
    if entry == "step":
        fn = lib.fn(f"tf_mega_step_{suffix(u.dtype)}", 3, 0)
        rc = fn(*args, stream_of(u))
    else:
        fn = lib.fn(f"tf_mega_adaptive_{suffix(u.dtype)}", 3, 2)
        rc = fn(*args, int(kind == MEMBER_KIND), int(entry == "adaptive_scan"),
                stream_of(u))
    lib.check(rc, what)
    counter.add()
    return out, info


def _reals(beta=0.0, scale=0.0, g00=0.0, t=0.0, dt=0.0, internal_dt=0.0,
           tol=0.0, safety=0.0, dt_min=None):
    return [beta, scale, g00, t, dt, internal_dt, tol, safety,
            0.0 if dt_min is None else float(dt_min)]


def _np_type(u):
    return np.float64 if u.dtype == torch.float64 else np.float32


def _member_arg(v):
    """(tensor or None, number) of a factor shift or F scale."""
    if isinstance(v, torch.Tensor):
        return v, 0.0
    return None, float(v)


def step(backend, plan, table, periodic, u, helpers, pstack, x, beta, scale,
         nsteps=1, cluster=None, snap=None, carry=None):
    """``nsteps`` steps of the table with factor shift ``beta`` and F scale
    ``scale`` (values of the model's dtype, or per-member (B,) tensors for
    u ``(B, nvar, N)``): returns (u_new, err), err of the last step (a 0-d
    tensor, or (B,) with a member axis; inf without an error row or where
    not finite).  With ``snap`` (one grid, (nsteps, nvar, N)) step k's
    state is written into ``snap[k]`` and u_new is ``snap[-1]``.  CPU
    tensors take the plain version; CUDA tensors launch K6's step entry
    once, on ``cluster`` (a ``ClusterPlan``) or ``cluster_plan``'s.
    ``carry`` (u's shape, updated in place): each step's state is the Kahan
    update of the last (module doc)."""
    if u.device.type == "cpu":
        if nsteps == 1 and snap is None and carry is None:
            return step_plain(backend, plan, table, periodic, u, helpers,
                              pstack, x, beta, scale)
        u2 = scan_plain(backend, plan, table, periodic, u, helpers, pstack, x,
                        beta, scale, nsteps, snap=snap, carry=carry)
        return u2, torch.full(u.shape[:-2], np.inf, dtype=u.dtype)
    if nsteps < 1:
        raise ValueError(f"K6 step: nsteps = {nsteps} < 1")
    beta_b, beta_v = _member_arg(beta)
    scale_b, scale_v = _member_arg(scale)
    out, info = _launch("step", STEP_LAUNCHES, backend, plan, table, periodic,
                        u, helpers, pstack, x,
                        _reals(beta=beta_v, scale=scale_v),
                        nsteps=int(nsteps), beta_b=beta_b, scale_b=scale_b,
                        cluster=cluster, snap=snap, carry=carry)
    if snap is not None:
        out = snap[-1]
    return out, (info[:, 0] if u.ndim == 3 else info[0, 0])


def row_step(backend, plan, table, periodic, u, helpers, pstack, x, dt,
             nsteps=1, snap=None, carry=None):
    """``nsteps`` ROW steps of ``dt`` -> (u_new, err): the factor shift is
    ``-g00*dt`` and the F scale ``g00*dt``, rounded as the model's dtype
    multiplies them; ``dt`` may be a per-member array; ``carry`` as
    ``step``'s."""
    gdt = gdt_of(_np_type(u), table.g00, dt, u.device)
    return step(backend, plan, table, periodic, u, helpers, pstack, x, -gdt,
                gdt, nsteps, snap=snap, carry=carry)


def theta_step(backend, plan, theta, periodic, u, helpers, pstack, x, dt,
               nsteps=1, snap=None):
    """``nsteps`` linearized theta steps of ``dt`` -> u_new."""
    dt = float(_np_type(u)(dt))
    return step(backend, plan, theta_table(theta), periodic, u, helpers,
                pstack, x, -theta * dt, dt, nsteps, snap=snap)[0]


def row_scan(backend, plan, table, periodic, u, helpers, pstack, x, dt,
             nsteps, snap=None, carry=None):
    """``nsteps`` fixed ROW steps in one launch -> u (no controller reads
    err, so the table should carry no error row); with ``snap`` (one grid,
    (nsteps, nvar, N)) every step's state in its slot; ``carry`` as
    ``step``'s."""
    return row_step(backend, plan, table, periodic, u, helpers, pstack, x, dt,
                    nsteps, snap, carry)[0]


def theta_scan(backend, plan, theta, periodic, u, helpers, pstack, x, dt,
               nsteps, snap=None):
    """``nsteps`` fixed theta steps in one launch -> u; ``snap`` as
    ``row_scan``'s."""
    return theta_step(backend, plan, theta, periodic, u, helpers, pstack, x,
                      dt, nsteps, snap)


def step_mixed(backend, plan, table, periodic, u, helpers, pstack, x, beta,
               scale, passes, nsteps=1, cluster=None):
    """``nsteps`` mixed-precision steps of the table (module doc) with
    factor shift ``beta`` and F scale ``scale`` (numbers) and ``passes``
    residual passes per stage solve, of one float64 grid: returns (u_new,
    err), err of the last step (a 0-d tensor; inf without an error row or
    where not finite).  CPU tensors take the plain version
    (``step_plain`` with ``passes``); CUDA tensors launch K6's mixed entry
    once, on ``cluster`` or ``cluster_plan``'s (``mixed=True``)."""
    if u.device.type == "cpu":
        if nsteps == 1:
            return step_plain(backend, plan, table, periodic, u, helpers,
                              pstack, x, beta, scale, passes)
        u2 = scan_plain(backend, plan, table, periodic, u, helpers, pstack, x,
                        beta, scale, nsteps, passes)
        return u2, torch.full((), np.inf, dtype=u.dtype)
    what = "K6 step_mixed"
    sysm = backend.system
    check_plan(plan, sysm, what)
    check_cuda((u, helpers, pstack, x), torch.float64, what)
    N = plan.N
    check_shapes(what, u=(u, (sysm.nvar, N)),
                 helpers=(helpers, (len(sysm.help_funcs), N)),
                 pstack=(pstack, (len(sysm.pars), N)), x=(x, (N,)))
    if not 1 <= len(table.stages) <= MAX_STAGES:
        raise NotImplementedError(f"{what}: {len(table.stages)} stages; the "
                                  f"kernel takes 1 to {MAX_STAGES}")
    if nsteps < 1 or passes < 0:
        raise ValueError(f"{what}: nsteps = {nsteps}, passes = {passes}")
    if cluster is None:
        cluster = cluster_plan(plan, len(table.stages), torch.float64, 1,
                               mixed=True)
    prep = _prepare(plan, table, periodic, int(nsteps), None, None, 1, 1,
                    cluster)
    n = sysm.nvar * N
    states = torch.empty(2 * n, dtype=torch.float64, device=u.device)
    gwork = torch.empty(max(1, cluster.K * cluster.gslab), dtype=torch.uint8,
                        device=u.device)
    info = torch.empty((1, INFO), dtype=torch.float64, device=u.device)
    out = torch.empty_like(u)
    ptrs = (ctypes.c_uint64 * 9)(
        u.data_ptr(), helpers.data_ptr(), pstack.data_ptr(), x.data_ptr(),
        info.data_ptr(), out.data_ptr(), gwork.data_ptr(), states.data_ptr(),
        states.data_ptr() + n * 8)
    prep.reals[:9] = _reals(beta=float(beta), scale=float(scale))
    lib = backend.megastep_mixed
    fn = lib.fn("tf_mega_step_mixed_f64", 3, 1)
    rc = fn(ctypes.addressof(ptrs), ctypes.addressof(prep.ints),
            ctypes.addressof(prep.reals), int(passes), stream_of(u))
    lib.check(rc, what)
    MIXED_LAUNCHES.add()
    return out, info[0, 0]


def row_step_mixed(backend, plan, table, periodic, u, helpers, pstack, x, dt,
                   passes, nsteps=1):
    """``nsteps`` mixed-precision ROW steps of ``dt`` -> (u_new, err): the
    factor shift ``-g00*dt`` and the F scale ``g00*dt`` in float64."""
    gdt = float(table.g00) * float(dt)
    return step_mixed(backend, plan, table, periodic, u, helpers, pstack, x,
                      -gdt, gdt, passes, nsteps)


def theta_step_mixed(backend, plan, theta, periodic, u, helpers, pstack, x,
                     dt, passes, nsteps=1):
    """``nsteps`` mixed-precision linearized theta steps of ``dt`` ->
    u_new: ``u + (I - theta dt J)^-1 (dt F(u))``."""
    dt = float(dt)
    return step_mixed(backend, plan, theta_table(theta), periodic, u, helpers,
                      pstack, x, -theta * dt, dt, passes, nsteps)[0]


def _adaptive_launch(backend, plan, table, periodic, u, helpers, pstack, x,
                     t, dt, internal_dt, tol, safety, max_iter, dt_min, nsteps,
                     per_member, cluster=None, snap=None, carry=None):
    """One launch of the adaptive entry; (u, info rows on the host, and
    with ``snap`` (one grid's (states, info) on the device) the snapshots'
    info rows on the host).  One output step of one grid with a shared dt
    and no snapshots is counted as K6.adaptive (the library runs
    adaptive_kernel on a cluster, scan_kernel on one CTA), the scan with
    snapshots as K6.adaptive_snapshots, anything else as K6.adaptive_scan
    (scan_kernel); with a ``carry``, as K6.compensated."""
    B, _ = members(u, 2)
    scan = per_member or B > 1 or nsteps > 1 or snap is not None
    entry = "adaptive_scan" if scan else "adaptive"
    counter = SCAN_LAUNCHES if scan else ADAPTIVE_LAUNCHES
    if snap is not None:
        counter = SNAP_LAUNCHES
    if len(table.final) != 2:
        raise ValueError(f"K6 {entry}: the table has no error row")
    idt_b = None
    if per_member:
        idt_b = torch.as_tensor(np.broadcast_to(
            np.asarray(internal_dt, _np_type(u)), (B,)).copy(), device=u.device)
        internal_dt = 0.0
    states, snap_info = (None, None) if snap is None else snap
    out, info = _launch(
        entry, counter, backend, plan, table, periodic, u, helpers, pstack, x,
        _reals(g00=table.g00, t=float(t), dt=float(dt),
               internal_dt=float(internal_dt), tol=float(tol),
               safety=float(safety), dt_min=dt_min),
        nsteps=nsteps, max_iter=max_iter, dt_min=dt_min,
        kind=MEMBER_KIND if per_member else SHARED_KIND, idt_b=idt_b,
        cluster=cluster, snap=states, snap_info=snap_info, carry=carry)
    if snap is None:
        return out, info.cpu().numpy()
    # one read-back of both
    both = torch.cat([info.reshape(-1), snap_info.reshape(-1)]).cpu().numpy()
    return out, both[:info.numel()].reshape(info.shape), \
        both[info.numel():].reshape(snap_info.shape)


def row_adaptive_step(controller, backend, plan, table, periodic, u, helpers,
                      pstack, x, t, dt, internal_dt, tol, safety, max_iter,
                      dt_min, per_member=False, cluster=None, carry=None):
    """One adaptive output step from ``t`` to ``t + dt`` (clamp and
    recompute): returns (u, dt_i, niter, status) with dt_i a scalar of the
    model's dtype, or with ``per_member`` (u of B members, each its own
    controller) dt_i and niter per member.  CPU tensors take the plain
    version, decided by ``controller`` (``core.rosenbrock``'s
    ``adaptive_controller``, or ``member_controller`` per member); CUDA
    tensors launch K6's adaptive entry, which runs that controller's
    arithmetic, once and read its results back once: one grid with a
    shared dt K6.adaptive, B > 1 members or per member K6.adaptive_scan
    (``_adaptive_launch``); ``cluster`` (a
    ``ClusterPlan``) overrides ``cluster_plan``'s.  ``carry`` (u's shape,
    updated in place): every accepted state is the Kahan update of the
    last (module doc)."""
    if len(table.final) != 2:
        raise ValueError("K6 adaptive: the table has no error row")
    if u.device.type == "cpu":
        return adaptive_plain(controller, backend, plan, table, periodic, u,
                              helpers, pstack, x, t, dt, internal_dt, tol,
                              safety, max_iter, dt_min, per_member, carry)
    out, info = _adaptive_launch(backend, plan, table, periodic, u, helpers,
                                 pstack, x, t, dt, internal_dt, tol, safety,
                                 max_iter, dt_min, 1, per_member, cluster,
                                 carry=carry)
    T = _np_type(u)
    if per_member:
        return (out, info[:, 1].astype(T), info[:, 2].astype(np.int64),
                int(info[:, 3].max()))
    return out, T(info[0, 1]), int(info[0, 2]), int(info[0, 3])


def adaptive_scan(controller, backend, plan, table, periodic, u, helpers,
                  pstack, x, t, dt, internal_dt, tol, safety, max_iter,
                  dt_min, nsteps, per_member=False, attempts=False,
                  cluster=None, snapshots=False, carry=None):
    """``nsteps`` adaptive output steps of ``dt`` from ``t`` in one launch
    (the reference's ``row_adaptive_scan_folded``): every output step
    re-clamps its starting dt to ``dt``, and the loop stops after the first
    step with a nonzero status.  A shared dt returns (u, steps_done, dt_i,
    status); ``per_member`` (each member its own clock, dt and attempts)
    returns (u, steps_done, dt_b, status, niter_b), the attempts summed
    over the steps.  With ``attempts`` a shared dt also returns the
    attempts summed over the steps.  CPU tensors take the plain version
    (``adaptive_scan_plain``, decided by ``controller``); CUDA tensors
    launch K6's scan_kernel (K6.adaptive_scan) once and read its results
    back once; one output step of one grid with a shared dt is the
    adaptive entry (K6.adaptive) instead.
    Per member a member stops at its own first nonzero status;
    steps_done is the fewest any member did and status the largest.

    ``snapshots`` (one grid, a shared dt) appends ``(states, rows)``:
    states (nsteps, nvar, N) on u's device, output step k's accepted state
    in ``states[k]``, and rows an (nsteps, 4) float64 numpy array of each
    output step's (t_i, dt_i, attempts, status); the steps after the first
    with a nonzero status are not written.  On the card that is scan_kernel
    with a snapshot buffer (K6.adaptive_snapshots), whose final state is
    the one it returns without snapshots.  ``carry`` (u's shape, updated
    in place): the first output step starts from it, every later one from
    zero (module doc)."""
    if nsteps < 1:
        raise ValueError(f"K6 adaptive_scan: nsteps = {nsteps} < 1")
    if snapshots and (per_member or u.ndim != 2):
        raise ValueError("K6 adaptive_scan: snapshots are of one grid with "
                         "a shared dt")
    snap = None
    if snapshots:
        shape = (int(nsteps),) + tuple(u.shape)
        snap = (torch.zeros(shape, dtype=u.dtype, device=u.device),
                torch.zeros((int(nsteps), SNAP_INFO), dtype=torch.float64,
                            device=u.device))
    if u.device.type == "cpu":
        rows = None if snap is None else snap[1].numpy()
        out = adaptive_scan_plain(controller, backend, plan, table, periodic,
                                  u, helpers, pstack, x, t, dt, internal_dt,
                                  tol, safety, max_iter, dt_min, nsteps,
                                  per_member,
                                  None if snap is None else (snap[0], rows),
                                  carry)
        out = out if per_member or attempts else out[:4]
        return out if snap is None else out + ((snap[0], rows),)
    launched = _adaptive_launch(backend, plan, table, periodic, u, helpers,
                                pstack, x, t, dt, internal_dt, tol, safety,
                                max_iter, dt_min, int(nsteps), per_member,
                                cluster, snap, carry)
    u2, info = launched[:2]
    T = _np_type(u)
    if per_member:
        return (u2, int(info[:, 4].min()), info[:, 1].astype(T),
                int(info[:, 3].max()), info[:, 2].astype(np.int64))
    out = (u2, int(info[0, 4]), T(info[0, 1]), int(info[0, 3]))
    out = out + (int(info[0, 2]),) if attempts else out
    return out if snap is None else out + ((snap[0], launched[2]),)
