"""Kernel K6: the whole implicit step of a small grid in one launch;
the plan and its gate, the wrappers, and their plain versions.

Replaces the TPU's ``ops/megastep.py:_launch`` (one or ``nsteps`` whole ROW
or theta steps: ``row_step_folded``, ``theta_step_folded``,
``row_scan_folded``, ``theta_scan_folded``), ``row_adaptive_step_folded``
(one adaptive output step with its accept/reject loop in the kernel) and
``row_adaptive_scan_folded`` (``nsteps`` adaptive output steps, shared or
per-member clocks: ``adaptive_scan``).  Source ``csrc/megastep.cu``, generated
per model like K1 (``backend.megastep``); it runs K1-K5's arithmetic
(shared through the headers in ``csrc/``) phase after phase in one thread
block, so a step costs one launch instead of 7 (theta) or 38 (RODASPR).

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

Every entry takes a leading member axis (an ensemble's B grids, u
``(B, nvar, N)``): one thread block per member, as many blocks as the card
holds at once, each looping over its share of the members.  With a shared
dt the adaptive kernels take every attempt's err as the max over all
members (a cooperative launch with a grid-wide barrier per attempt); with
``per_member=True`` each member runs its own controller.

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
from typing import NamedTuple

import numpy as np
import torch

from . import chunked, combine, mixed, pcr, stencil, thomas
from ._launch import Counter, check_cuda, check_shapes, stream_of, suffix
from .thomas import members

#: launches of the fixed-step entry (1 or nsteps steps) and of the adaptive
#: entry's two kernels: adaptive_kernel (one output step of one grid with a
#: shared dt) and scan_kernel (the adaptive scan: nsteps output steps, and
#: every adaptive output step of B > 1 members or per member)
STEP_LAUNCHES = Counter("K6.step")
ADAPTIVE_LAUNCHES = Counter("K6.adaptive")
SCAN_LAUNCHES = Counter("K6.adaptive_scan")
#: launches of the mixed entry (1 or nsteps mixed-precision steps)
MIXED_LAUNCHES = Counter("K6.step_mixed")

#: stages of the widest table (RODASPR); kMaxStages in csrc/megastep.cu
MAX_STAGES = 6
#: widest block size s = nvar * max(halo, 1) K6 is instantiated for, the
#: reference's gate (its ``megastep.applicable``); K2-K4 go to
#: ``thomas.MAX_S``, but csrc/megastep.cu, which shares their s <= 4
#: bodies, has no wider instantiation
MAX_S = 4
#: threads of the one block (kThreads in csrc/megastep.cu)
BLOCK_THREADS = 256
#: largest grid K6 takes, by block size s = nvar * max(halo, 1): the
#: largest N at which K6 beat the multi-launch path in every pairing of
#: chip_smoke.py's crossover sweep, for fixed RODASPR and Theta steps alike
#: (PERF.md); a block size no sweep measured takes the multi-launch path
MAX_N = {1: 1 << 14, 2: 1 << 13, 4: 1 << 12}

#: largest grid K6's mixed entry takes, by block size s: the largest N at
#: which the mixed entry beat the multi-launch mixed path (K1, K2-K4 in
#: float32, K8) in every pairing of chip_smoke.py's crossover sweep of
#: fixed df64 RODASPR and Theta steps with one residual pass, over N =
#: 2^10 .. 2^15 and the reference's 10^4, in each of two runs (PERF.md):
#: RODASPR sets it at s = 2 (2^14 lost in one run to the host-bound
#: multi-launch path) and s = 4 (2^13 lost)
MIXED_MAX_N = {1: 1 << 14, 2: 10 ** 4, 4: 1 << 12}

#: cost model of K6's plan by block size s, in microseconds of one RODASPR
#: step, fitted to chip_smoke.py's device-time chunk-count sweeps (float64,
#: PERF.md): every pass of the block's threads over the chunks walks Mc rows
#: one after the other, and every PCR level is a dependent phase
ROW_US = {1: 2.20, 2: 3.41, 4: 6.57}
LEVEL_US = {1: 3.33, 2: 10.42, 4: 70.47}


#: K6 declines a grid whose plan costs more than PAD_MARGIN times the
#: least-cost padded plan and more than MULTI_LAUNCH_US (``make_plan``):
#: the multi-launch path is host-bound on small grids, a RODASPR step of
#: the README model at N = 199 taking 2.14 ms synchronised on an H100
#: (float64, chip_smoke.py phase 3; PERF.md), so K6 keeps a serial plan
#: cheaper than that
PAD_MARGIN = 2.0
MULTI_LAUNCH_US = 2000.0


def plan_cost_us(M: int, C: int, s: int) -> float:
    """Modelled time of the sequential parts of one K6 step with C chunks of
    ceil(M / C) rows of block size s."""
    passes = -(-C // BLOCK_THREADS)
    return passes * (ROW_US[s] * -(-M // C) + LEVEL_US[s] * pcr.n_levels(C))


def make_plan(N: int, nvar: int, halo: int, periodic: bool):
    """K6's chunk plan of a grid: the admissible chunk count
    (``chunked.chunk_counts``: any divisor with at least 2 rows per chunk,
    C >= 2 on a ring) of least ``plan_cost_us``, whatever N is; None when
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
    C = min(cands, key=lambda C: (plan_cost_us(M, C, s), C))
    padded = min(plan_cost_us(M, c, s) for c in chunked.padded_counts(N, halo))
    cost = plan_cost_us(M, C, s)
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
    return None if plan is None else plan._replace(B=B)


def mixed_plan_for(N: int, nvar: int, halo: int, periodic: bool):
    """The plan of a grid K6's mixed entry takes (one grid), or None: the
    multi-launch mixed path serves it.  The TPU's lane-utilization plan
    and VMEM budget (``df64_small_plan_for``, ``applicable_df``) are not
    carried over: the chunk plan is ``make_plan``'s."""
    if N > MIXED_MAX_N.get(nvar * max(halo, 1), 0):
        return None
    return make_plan(N, nvar, halo, periodic)


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
    fact = thomas.spike_factor_plain(fbands, 1.0, beta, plan)
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
               scale, nsteps, passes=None):
    for _ in range(nsteps):
        u = step_plain(backend, plan, table, periodic, u, helpers, pstack, x,
                       beta, scale, passes)[0]
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
                   dt_min, per_member=False):
    """One adaptive output step (clamp and recompute) of plain steps,
    decided by ``controller``: the scheme's
    ``core.rosenbrock.adaptive_controller`` (a shared dt: with a member
    axis err is the max over the members), or with ``per_member``
    ``core.rosenbrock.member_controller`` (each member's own clock and
    dt).  K6's adaptive entries run the same arithmetic.  Returns (u,
    dt_i, niter, status), dt_i and niter per member with ``per_member``."""
    T = _np_type(u)

    def attempt(_t, state, dt_eff):
        gdt = gdt_of(T, table.g00, dt_eff, u.device)
        u2, err = step_plain(backend, plan, table, periodic, state[0], helpers,
                             pstack, x, -gdt, gdt)
        if per_member:
            return (u2,), err.cpu().numpy().astype(T)
        return (u2,), T(err.max().item())

    _, (u2,), dt_i, niter, status = controller(
        attempt, T, t, dt, internal_dt, tol, safety, max_iter, dt_min, False,
        (u,))
    return u2, dt_i, niter, status


def adaptive_scan_plain(controller, backend, plan, table, periodic, u,
                        helpers, pstack, x, t, dt, internal_dt, tol, safety,
                        max_iter, dt_min, nsteps, per_member=False):
    """``nsteps`` output steps of ``adaptive_plain``, each from the last
    one's output time, stopping after the first with a nonzero status:
    (u, steps_done, dt_i, status, attempts), dt_i and the attempts summed
    over the steps per member with ``per_member``."""
    T = _np_type(u)
    t_, dt_i, done, status, total = T(t), internal_dt, 0, 0, 0
    while done < nsteps and status == 0:
        u, dt_i, niter, st = adaptive_plain(
            controller, backend, plan, table, periodic, u, helpers, pstack, x,
            t_, dt, dt_i, tol, safety, max_iter, dt_min, per_member)
        t_ = t_ + T(dt)
        done += 1
        total = total + niter
        status = max(status, st)
    return u, done, dt_i, status, total


# --------------------------------------------------------------- kernel

#: the per-block scratch buffers of one launch, in the order of
#: csrc/megastep.cu's Work after its 11 leading addresses (block 0's; block
#: k's lie k slabs further); then the per-member states buf0 and buf1
_BUFFERS = ("bands", "fac", "Dhinv", "DU", "Wsp", "Vsp", "Lred", "Ured",
            "alphas", "betas", "Dinv", "pscr", "Z", "us", "ui", "bias", "rhs",
            "y", "yred", "xm1", "xp1")
#: doubles per member of a launch's info: err, dt_i, attempts, status,
#: output steps done
INFO = 5
#: kernel kinds of the capacity query: the step entry, the adaptive entries
#: with a shared dt, and per member
STEP_KIND, SHARED_KIND, MEMBER_KIND = 0, 1, 2


def _sizes(plan, n_stages):
    N, nvar, s, C, Mc = plan.N, plan.nvar, plan.s, plan.C, plan.Mc
    n, s2 = nvar * N, 2 * plan.s
    rows, red = Mc * s * s * C, s2 * s2 * C
    return dict(bands=plan.W * nvar * nvar * N, fac=rows, Dhinv=rows,
                DU=rows, Wsp=rows, Vsp=rows, Lred=red, Ured=red,
                alphas=pcr.n_levels(C) * red, betas=pcr.n_levels(C) * red,
                Dinv=red, pscr=7 * red, Z=red, us=n_stages * n, ui=n, bias=n,
                rhs=n, y=n, yred=s2 * C, xm1=s * C, xp1=s * C)


class _Prepared(NamedTuple):
    """What one launch configuration passes the kernel besides the tensor
    addresses and the scalars: built once, reused by every launch."""

    offsets: tuple  # element offset of each _BUFFERS entry in a block's slab
    slab: int       # scratch elements of one block
    ints: object    # ctypes int array
    reals: object   # ctypes double array; the first 9 are set per launch


_PREPARED = {}
_CAPACITY = {}


def capacity(backend, dtype, kind):
    """Blocks of a K6 kernel the card holds at once (its SMs times the
    blocks per SM at the kernel's registers), by kernel kind."""
    key = (id(backend.megastep), dtype, kind)
    if key not in _CAPACITY:
        fn = backend.megastep.fn(f"tf_mega_capacity_{suffix(dtype)}", 0, 1)
        got = fn(kind, None)
        if got <= 0:
            backend.megastep.check(-got or 1, "K6 capacity")
        _CAPACITY[key] = got
    return _CAPACITY[key]


def _prepare(plan, table, periodic, nsteps, max_iter, dt_min, B, nblk):
    key = (plan, table, periodic, nsteps, max_iter, dt_min is not None, B,
           nblk)
    if key in _PREPARED:
        return _PREPARED[key]
    n_stages = len(table.stages)
    sizes = _sizes(plan, n_stages)
    offsets, at = [], 0
    for name in _BUFFERS:
        offsets.append(at)
        at += sizes[name]
    coefs = np.zeros((MAX_STAGES + 1, 2, MAX_STAGES + 1))
    for k, (a_row, c_row) in enumerate(table.stages):
        coefs[k, 0, :len(a_row)] = a_row
        if c_row is not None:
            coefs[k, 1, :len(c_row)] = c_row
    for r, row in enumerate(table.final):
        coefs[n_stages, r, :len(row)] = row
    rows = [1 + (c is not None) for _, c in table.stages] + [len(table.final)]
    rows += [1] * (MAX_STAGES + 1 - len(rows))
    ints = [plan.N, plan.Mc, plan.C, int(plan.cyclic), int(plan.wrap),
            int(bool(periodic)), n_stages, nsteps,
            -1 if max_iter is None else int(max_iter),
            int(dt_min is not None), B, nblk, at] + rows
    if at >= 2 ** 31:
        raise ValueError(f"K6: {at} scratch elements per block, more than the "
                         "kernel's 32-bit slab size")
    prepared = _Prepared(tuple(offsets), at, (ctypes.c_int * len(ints))(*ints),
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
            kind=STEP_KIND, beta_b=None, scale_b=None, idt_b=None):
    """Check the inputs, allocate the outputs and the scratch, launch one
    K6 entry; returns (u_out, info (B, INFO) float64 on the device)."""
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
    if not 1 <= len(table.stages) <= MAX_STAGES:
        raise NotImplementedError(f"{what}: {len(table.stages)} stages; the "
                                  f"kernel takes 1 to {MAX_STAGES}")
    nblk = min(B, capacity(backend, u.dtype, kind))
    prep = _prepare(plan, table, periodic, nsteps, max_iter, dt_min, B, nblk)
    n = sysm.nvar * N
    work = torch.empty(nblk * prep.slab + 2 * B * n, dtype=u.dtype,
                       device=u.device)
    info = torch.empty((B, INFO), dtype=torch.float64, device=u.device)
    out = torch.empty_like(u)
    sync = errs = None
    if kind == SHARED_KIND and nblk > 1:
        sync = torch.zeros(2, dtype=torch.int32, device=u.device)
        errs = torch.empty(2 * nblk, dtype=u.dtype, device=u.device)
    item, base = u.element_size(), work.data_ptr()
    states = base + nblk * prep.slab * item
    ptrs = (ctypes.c_uint64 * (11 + len(_BUFFERS) + 2))(
        u.data_ptr(), helpers.data_ptr(), pstack.data_ptr(), x.data_ptr(),
        info.data_ptr(), out.data_ptr(), _ptr(beta_b), _ptr(scale_b),
        _ptr(idt_b), _ptr(sync), _ptr(errs),
        *(base + at * item for at in prep.offsets), states,
        states + B * n * item)
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
         nsteps=1):
    """``nsteps`` steps of the table with factor shift ``beta`` and F scale
    ``scale`` (values of the model's dtype, or per-member (B,) tensors for
    u ``(B, nvar, N)``): returns (u_new, err), err of the last step (a 0-d
    tensor, or (B,) with a member axis; inf without an error row or where
    not finite).  CPU tensors take the plain version; CUDA tensors launch
    K6's step entry once."""
    if u.device.type == "cpu":
        if nsteps == 1:
            return step_plain(backend, plan, table, periodic, u, helpers,
                              pstack, x, beta, scale)
        u2 = scan_plain(backend, plan, table, periodic, u, helpers, pstack, x,
                        beta, scale, nsteps)
        return u2, torch.full(u.shape[:-2], np.inf, dtype=u.dtype)
    if nsteps < 1:
        raise ValueError(f"K6 step: nsteps = {nsteps} < 1")
    beta_b, beta_v = _member_arg(beta)
    scale_b, scale_v = _member_arg(scale)
    out, info = _launch("step", STEP_LAUNCHES, backend, plan, table, periodic,
                        u, helpers, pstack, x,
                        _reals(beta=beta_v, scale=scale_v),
                        nsteps=int(nsteps), beta_b=beta_b, scale_b=scale_b)
    return out, (info[:, 0] if u.ndim == 3 else info[0, 0])


def row_step(backend, plan, table, periodic, u, helpers, pstack, x, dt,
             nsteps=1):
    """``nsteps`` ROW steps of ``dt`` -> (u_new, err): the factor shift is
    ``-g00*dt`` and the F scale ``g00*dt``, rounded as the model's dtype
    multiplies them; ``dt`` may be a per-member array."""
    gdt = gdt_of(_np_type(u), table.g00, dt, u.device)
    return step(backend, plan, table, periodic, u, helpers, pstack, x, -gdt,
                gdt, nsteps)


def theta_step(backend, plan, theta, periodic, u, helpers, pstack, x, dt,
               nsteps=1):
    """``nsteps`` linearized theta steps of ``dt`` -> u_new."""
    dt = float(_np_type(u)(dt))
    return step(backend, plan, theta_table(theta), periodic, u, helpers,
                pstack, x, -theta * dt, dt, nsteps)[0]


def row_scan(backend, plan, table, periodic, u, helpers, pstack, x, dt,
             nsteps):
    """``nsteps`` fixed ROW steps in one launch -> u (no controller reads
    err, so the table should carry no error row)."""
    return row_step(backend, plan, table, periodic, u, helpers, pstack, x, dt,
                    nsteps)[0]


def theta_scan(backend, plan, theta, periodic, u, helpers, pstack, x, dt,
               nsteps):
    """``nsteps`` fixed theta steps in one launch -> u."""
    return theta_step(backend, plan, theta, periodic, u, helpers, pstack, x,
                      dt, nsteps)


#: the mixed entry's scratch: the float64 slab's buffers, then the float32
#: slab's, in the order of csrc/megastep.cu's MixedWork after its six
#: leading addresses
_MIXED64 = ("bands", "us", "ui", "bias", "rhs", "buf0", "buf1")
_MIXED32 = ("bands32", "fac", "Dhinv", "DU", "Wsp", "Vsp", "Lred", "Ured",
            "alphas", "betas", "Dinv", "pscr", "Z", "r32", "y", "yred", "xm1",
            "xp1", "d32")


def _mixed_offsets(plan, n_stages):
    """(float64 offsets, float64 elements, float32 offsets, float32
    elements) of the mixed entry's two slabs."""
    sizes = _sizes(plan, n_stages)
    n = plan.nvar * plan.N
    sizes.update(bands32=sizes["bands"], r32=n, d32=n, buf0=n, buf1=n)
    out = []
    for names in (_MIXED64, _MIXED32):
        offsets, at = [], 0
        for name in names:
            offsets.append(at)
            at += sizes[name]
        out += [offsets, at]
    return out


def step_mixed(backend, plan, table, periodic, u, helpers, pstack, x, beta,
               scale, passes, nsteps=1):
    """``nsteps`` mixed-precision steps of the table (module doc) with
    factor shift ``beta`` and F scale ``scale`` (numbers) and ``passes``
    residual passes per stage solve, of one float64 grid: returns (u_new,
    err), err of the last step (a 0-d tensor; inf without an error row or
    where not finite).  CPU tensors take the plain version
    (``step_plain`` with ``passes``); CUDA tensors launch K6's mixed entry
    once."""
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
    prep = _prepare(plan, table, periodic, int(nsteps), None, None, 1, 1)
    off64, n64, off32, n32 = _mixed_offsets(plan, len(table.stages))
    work64 = torch.empty(n64, dtype=torch.float64, device=u.device)
    work32 = torch.empty(n32, dtype=torch.float32, device=u.device)
    info = torch.empty((1, INFO), dtype=torch.float64, device=u.device)
    out = torch.empty_like(u)
    b64, b32 = work64.data_ptr(), work32.data_ptr()
    ptrs = (ctypes.c_uint64 * (6 + len(_MIXED64) + len(_MIXED32)))(
        u.data_ptr(), helpers.data_ptr(), pstack.data_ptr(), x.data_ptr(),
        info.data_ptr(), out.data_ptr(), *(b64 + 8 * at for at in off64),
        *(b32 + 4 * at for at in off32))
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
                     per_member):
    """One launch of the adaptive entry; (u, info rows on the host).  One
    output step of one grid with a shared dt launches adaptive_kernel
    (counted as K6.adaptive), anything else scan_kernel (counted as
    K6.adaptive_scan)."""
    B, _ = members(u, 2)
    scan = per_member or B > 1 or nsteps > 1
    entry = "adaptive_scan" if scan else "adaptive"
    if len(table.final) != 2:
        raise ValueError(f"K6 {entry}: the table has no error row")
    idt_b = None
    if per_member:
        idt_b = torch.as_tensor(np.broadcast_to(
            np.asarray(internal_dt, _np_type(u)), (B,)).copy(), device=u.device)
        internal_dt = 0.0
    out, info = _launch(
        entry, SCAN_LAUNCHES if scan else ADAPTIVE_LAUNCHES, backend, plan, table, periodic, u, helpers, pstack, x,
        _reals(g00=table.g00, t=float(t), dt=float(dt),
               internal_dt=float(internal_dt), tol=float(tol),
               safety=float(safety), dt_min=dt_min),
        nsteps=nsteps, max_iter=max_iter, dt_min=dt_min,
        kind=MEMBER_KIND if per_member else SHARED_KIND, idt_b=idt_b)
    return out, info.cpu().numpy()


def row_adaptive_step(controller, backend, plan, table, periodic, u, helpers,
                      pstack, x, t, dt, internal_dt, tol, safety, max_iter,
                      dt_min, per_member=False):
    """One adaptive output step from ``t`` to ``t + dt`` (clamp and
    recompute): returns (u, dt_i, niter, status) with dt_i a scalar of the
    model's dtype, or with ``per_member`` (u of B members, each its own
    controller) dt_i and niter per member.  CPU tensors take the plain
    version, decided by ``controller`` (``core.rosenbrock``'s
    ``adaptive_controller``, or ``member_controller`` per member); CUDA
    tensors launch K6's adaptive entry, which runs that controller's
    arithmetic, once and read its results back once: one grid with a
    shared dt its adaptive_kernel (K6.adaptive), B > 1 members or per
    member its scan_kernel (K6.adaptive_scan)."""
    if len(table.final) != 2:
        raise ValueError("K6 adaptive: the table has no error row")
    if u.device.type == "cpu":
        return adaptive_plain(controller, backend, plan, table, periodic, u,
                              helpers, pstack, x, t, dt, internal_dt, tol,
                              safety, max_iter, dt_min, per_member)
    out, info = _adaptive_launch(backend, plan, table, periodic, u, helpers,
                                 pstack, x, t, dt, internal_dt, tol, safety,
                                 max_iter, dt_min, 1, per_member)
    T = _np_type(u)
    if per_member:
        return (out, info[:, 1].astype(T), info[:, 2].astype(np.int64),
                int(info[:, 3].max()))
    return out, T(info[0, 1]), int(info[0, 2]), int(info[0, 3])


def adaptive_scan(controller, backend, plan, table, periodic, u, helpers,
                  pstack, x, t, dt, internal_dt, tol, safety, max_iter,
                  dt_min, nsteps, per_member=False, attempts=False):
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
    back once; one output step of one grid with a shared dt launches
    adaptive_kernel (K6.adaptive) instead.
    Per member a member stops at its own first nonzero status;
    steps_done is the fewest any member did and status the largest."""
    if nsteps < 1:
        raise ValueError(f"K6 adaptive_scan: nsteps = {nsteps} < 1")
    if u.device.type == "cpu":
        out = adaptive_scan_plain(controller, backend, plan, table, periodic,
                                  u, helpers, pstack, x, t, dt, internal_dt,
                                  tol, safety, max_iter, dt_min, nsteps,
                                  per_member)
        return out if per_member or attempts else out[:4]
    u2, info = _adaptive_launch(backend, plan, table, periodic, u, helpers,
                                pstack, x, t, dt, internal_dt, tol, safety,
                                max_iter, dt_min, int(nsteps), per_member)
    T = _np_type(u)
    if per_member:
        return (u2, int(info[:, 4].min()), info[:, 1].astype(T),
                int(info[:, 3].max()), info[:, 2].astype(np.int64))
    out = (u2, int(info[0, 4]), T(info[0, 1]), int(info[0, 3]))
    return out + (int(info[0, 2]),) if attempts else out
