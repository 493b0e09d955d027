"""Kernel K9: the opt-in two-pass theta step of one periodic grid; its gate
and chunk plan, the wrappers of its two entries and their plain versions,
and the step they make with K4.

Replaces the TPU's ``ops/megatheta.py:theta_step_tiled`` (its two
``pallas_call``\\ s, ``kernel_a`` and ``kernel_b``).  One linearized theta
step ``u2 = u + (I - theta*dt*J)^-1 (dt*F)`` is

1. the interface pass (``interface``, counter ``K9.interface``): per
   chunk, the rows of ``A = I - theta*dt*J`` and ``dt*F`` evaluated from u,
   their block-Thomas sweeps, and only the chunk's rows of the reduced
   interface system, in the layouts K2 and K3 hand to K4;
2. K4's factor of the reduced system (``pcr.pcr_factor``; on a Woodbury
   plan also ``pcr.woodbury``, counted as ``K4.pcr_solve``) and its solve
   with neighbour shifts (``pcr.pcr_solve_shift``);
3. the correction pass (``correct``, counter ``K9.correct``): per chunk,
   the same rows again and u2 from the neighbours' interface unknowns.

No array of the state's size is written but u2: no bands, factor rows,
right-hand side or sweep intermediate.  Source ``csrc/megatheta.cu``,
generated per model and dtype as K1 and K6 (``backend.megatheta``); it
describes the algebra.  The plain versions run the same sweeps in torch,
vectorised over the chunks, on F and J of the whole grid.

The route is opt-in, as in the reference: ``Theta.device_fixed_step_folded``
takes it where ``TRIFLOW_MEGATHETA`` is set when the entry is built,
``TRIFLOW_NO_MEGATHETA`` is not, and ``applicable`` holds.  The reference's
plan (chunk counts that fill TPU lane tiles within a VMEM budget, and its
``TRIFLOW_MEGATHETA_MB`` / ``_LB`` / ``_MC`` knobs) is a Mosaic artifact and
is not carried over: ``plan_for`` picks among the chunk counts K4 takes.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import banded, chunked, megastep, pcr, stencil, thomas
from ._launch import (Counter, check_cuda, check_shapes, shape_cache, stream_of,
                      suffix)

INTERFACE_LAUNCHES = Counter("K9.interface")
CORRECT_LAUNCHES = Counter("K9.correct")

#: the block sizes s = nvar * max(halo, 1) the step takes (the reference's)
MAX_S = 2
#: lanes of a chunk (``kP`` in csrc/megatheta.cu): one warp per chunk, each
#: lane eliminating a sub-chunk of ceil(Mc / LANES) or floor(Mc / LANES)
#: rows
LANES = 32
#: most rows of a chunk, by block size s: a chunk's block keeps its span of
#: the state and parameters (and x, where the model reads it) and each
#: lane's interior rows (2 s^2 + s values a row) in shared memory
#: (``smem_bytes``); the largest powers of two at which the float64 block of
#: a one-variable model without parameters fits a block's 227 KB (132368
#: bytes at s = 1, 196128 at s = 2; Burgers, with its parameter, 167176).
#: ``applicable`` refuses a plan whose model's block does not fit.
MAX_MC = {1: 4096, 2: 2048}

#: cost model of a plan by block size s, in microseconds of device time of
#: one step (the parts the chunk count changes), a sum of terms each fitted
#: to its own piece's device time.  K9's two entries: each lane's chain of
#: ``chain_rows`` (ceil(Mc / LANES) rows and the levels of the lanes'
#: reduction) times the waves of chunks the card runs (``chunked.SMS``
#: multiprocessors, each holding the one-warp blocks its registers,
#: RESIDENT, and its shared memory, ``smem_bytes`` of a model with one
#: parameter row, allow),
#: CHAIN_US per row of a wave's chain; and CHUNK_US per chunk (its staging,
#: reduction and writes).  K4 by its routes today: the factor's levels
#: (``pcr.factor_route``: a cooperative grid's barrier a level), LEVEL_US
#: each, and its work, LEVEL_KC_US per level and thousand chunks; the solve
#: with shifts on its cluster plan (``pcr.solve_plan``: each CTA's tiles
#: over the levels), SHIFT_US per tile and level; on a Woodbury plan the
#: set-up's column clusters (``pcr.cols_route``) on the same plan, WOOD_US
#: per tile and level.  Fitted by non-negative least squares (float64 and
#: float32 pooled, an offset per grid and dtype) to the device µs of each
#: piece in chip_smoke.py's chunk-count sweeps of Burgers at N = 10^6 (s =
#: 1) and KS at N = 2^20 (s = 2) on one H100 (PERF.md).  RESIDENT: blocks
#: an SM holds by their registers (the float64 builds' ptxas reports: 62
#: registers at s = 1, 154 in the s = 2 interface entry).  WOOD_US at s = 2
#: is not measured (KS 2^20 closes its ring block-cyclic): the set-up's
#: column clusters run the solve's body, so it takes the solve's SHIFT_US.
RESIDENT = {1: 32, 2: 12}
CHAIN_US = {1: 0.161, 2: 0.384}
CHUNK_US = {1: 0.0009, 2: 0.0026}
LEVEL_US = {1: 2.876, 2: 2.110}
LEVEL_KC_US = {1: 0.023, 2: 0.287}
SHIFT_US = {1: 0.868, 2: 0.997}
WOOD_US = {1: 0.791, 2: 0.997}


def smem_bytes(nvar: int, nhelp: int, npar: int, halo: int, Mc: int,
               itemsize: int, with_x: bool = False) -> int:
    """Shared memory of one chunk's block (csrc/megatheta.cu's ``Layout``):
    the span's variable and helper rows (Mc g nodes and h on each side),
    the parameter rows and, ``with_x``, x (Mc g nodes), each padded by one
    element per 128 bytes (per 64 in float32 where the lanes' stride is 31
    elements mod 32), and ceil(Mc / LANES) - 1 kept rows of 2 s^2 + s
    values for each lane."""
    g = max(halo, 1)
    s = nvar * g
    shift = 4 if itemsize == 8 or (Mc // LANES) * g % 32 == 31 else 5

    def pad(t):
        return t + (t >> shift)

    nodes = Mc * g
    lsp = pad(nodes + 2 * halo - 1) + 1
    lnd = pad(nodes - 1) + 1
    rows = -(-Mc // LANES) - 1
    return itemsize * ((nvar + nhelp) * lsp + (npar + int(with_x)) * lnd
                       + rows * (2 * s * s + s) * LANES)


def chain_rows(Mc: int) -> int:
    """The chain of a chunk of Mc rows: a lane's ceil(Mc / LANES) rows and
    the levels of the lanes' reduction."""
    return -(-Mc // LANES) + (min(Mc, LANES) - 1).bit_length()


def plan_features(M: int, C: int, s: int, woodbury: bool):
    """The features of ``plan_cost_us`` for C chunks of M // C rows at block
    size s: (K9's chain rows times waves, its chunks; K4's factor levels,
    its levels times thousands of chunks, its solve's tiles times levels,
    the Woodbury set-up's)."""
    Mc = M // C
    levels = pcr.n_levels(C)
    by_smem = thomas.SM_SMEM // (smem_bytes(1, 0, 1, s, Mc, 8) + 1024)
    waves = -(-C // (chunked.SMS * max(1, min(RESIDENT[s], by_smem))))
    sp = pcr.solve_plan(C, 2 * s)
    tiles = (levels + 1) * -(-sp.Cc // sp.Ct)
    return (chain_rows(Mc) * waves, C, levels, levels * C / 1000, tiles,
            tiles if woodbury else 0)


def plan_cost_us(M: int, C: int, s: int, woodbury: bool) -> float:
    """Modelled device time of the parts of one step that the chunk count
    changes, with C chunks of M // C rows of block size s (``woodbury``: the
    ring closes through K4's Woodbury set-up)."""
    consts = (CHAIN_US, CHUNK_US, LEVEL_US, LEVEL_KC_US, SHIFT_US, WOOD_US)
    return sum(k[s] * f for k, f in zip(consts, plan_features(M, C, s, woodbury)))


def chunk_counts(N: int, nvar: int, halo: int):
    """The chunk counts of a periodic grid the step takes: those of
    ``chunked.chunk_counts`` that K4 takes (at most ``pcr.max_chunks``)
    with at most ``MAX_MC`` rows; none for a block size above ``MAX_S`` or
    N no multiple of the supernode size."""
    g = max(halo, 1)
    s = nvar * g
    if s > MAX_S or N % g:
        return []
    M = N // g
    return [C for C in chunked.chunk_counts(N, halo, True)
            if C <= pcr.max_chunks(2 * s) and M // C <= MAX_MC[s]]


def plan_for(N: int, nvar: int, halo: int, C: int = None):
    """The step's plan of a periodic grid (``chunked.Plan``, block-cyclic
    for a power-of-two C >= 8, Woodbury otherwise): the chunk count of
    least ``plan_cost_us``, or ``C`` where it is admissible; None where the
    step does not take the grid."""
    cands = chunk_counts(N, nvar, halo)
    if C is not None:
        cands = [C] if C in cands else []
    if not cands:
        return None
    plans = [chunked.plan_with(N, nvar, halo, True, C) for C in cands]
    return min(plans, key=lambda p: (plan_cost_us(p.M, p.C, p.s, p.woodbury),
                                     p.C))


def opted_in() -> bool:
    """``TRIFLOW_MEGATHETA`` set and ``TRIFLOW_NO_MEGATHETA`` not (any
    non-empty value counts, as in the reference)."""
    return bool(os.environ.get("TRIFLOW_MEGATHETA")) and not os.environ.get(
        "TRIFLOW_NO_MEGATHETA")


def applicable(model, plan, periodic: bool) -> bool:
    """The reference's gate: a plan (block size s <= 2, N a multiple of the
    supernode size), a periodic grid, no helper functions, one grid (no
    member axis) and not the df64 mode; and a chunk's block that fits the
    shared memory a block may take (``block_bytes``)."""
    return (plan is not None and bool(periodic) and plan.B == 1
            and not model.system.help_funcs and model.precision != "df64"
            and block_bytes(model, plan) <= megastep.SMEM_PER_CTA)


def block_bytes(model, plan) -> int:
    """``smem_bytes`` of the model's block on ``plan``."""
    sysm, b = model.system, model.backend
    return smem_bytes(sysm.nvar, len(sysm.help_funcs), len(sysm.pars),
                      sysm.halo, plan.Mc, torch.finfo(model.dtype).bits // 8,
                      stencil.uses_x(sysm, b.args_symbols))


# ---------------------------------------------------------------- plain


def _rows(backend, plan, u, helpers, pstack, x, beta, dt):
    """The chunk rows (L, D, U (Mc, s, s, C), r (Mc, s, C)) of ``A = I +
    beta*J`` and ``dt*F``, and the chunks' outer couplings Tl = L_0 and
    Tr = U_{Mc-1} (s, s, C), split off L and U."""
    bands = backend.J_bands_impl(u, helpers, pstack, x, periodic=True)
    blocks = banded.assemble_blocks(banded.axpy_bands(1.0, beta, bands))
    L, D, U = (banded.to_chunks(X, plan.C).clone(
        memory_format=torch.contiguous_format) for X in blocks)
    r = banded.nodes_to_rows(dt * backend.F_impl(u, helpers, pstack, x,
                                                 periodic=True),
                             plan.g, plan.C)
    Tl, Tr = L[0].clone(), U[-1].clone()
    if not plan.wrap:
        Tl[..., 0] = 0.0
        Tr[..., -1] = 0.0
    L[0] = 0.0
    U[-1] = 0.0
    return L, D, U, r, Tl, Tr


def interface_plain(backend, plan, u, helpers, pstack, x, beta, dt):
    L, D, U, r, Tl, Tr = _rows(backend, plan, u, helpers, pstack, x, beta, dt)
    Mc = plan.Mc
    dh, up, bt = (torch.zeros_like(Tl), torch.zeros_like(Tl),
                  torch.zeros_like(r[0]))
    for j in range(Mc):
        f = banded.mm(L[j], dh)
        dh = banded.small_inv(D[j] - banded.mm(f, up))
        bt = r[j] - banded.mv(f, bt)
        wt = Tl if j == 0 else -banded.mm(f, wt)
        up = U[j]
    yl, Wl, Vl = banded.mv(dh, bt), banded.mm(dh, wt), banded.mm(dh, Tr)
    eh, lo, ct = (torch.zeros_like(Tl), torch.zeros_like(Tl),
                  torch.zeros_like(r[0]))
    for j in reversed(range(Mc)):
        f = banded.mm(U[j], eh)
        eh = banded.small_inv(D[j] - banded.mm(f, lo))
        ct = r[j] - banded.mv(f, ct)
        vt = Tr if j == Mc - 1 else -banded.mm(f, vt)
        lo = L[j]
    y0, W0, V0 = banded.mv(eh, ct), banded.mm(eh, Tl), banded.mm(eh, vt)
    s = plan.s
    Lred = Tl.new_zeros((2 * s, 2 * s, plan.C))
    Ured = torch.zeros_like(Lred)
    Lred[:s, s:], Lred[s:, s:] = W0, Wl
    Ured[:s, :s], Ured[s:, :s] = V0, Vl
    if not plan.wrap:
        Lred[..., 0] = 0.0
        Ured[..., -1] = 0.0
    return Lred, Ured, torch.cat([y0, yl])


def correct_plain(backend, plan, u, helpers, pstack, x, beta, dt, xm1, xp1):
    L, D, U, r, Tl, Tr = _rows(backend, plan, u, helpers, pstack, x, beta, dt)
    r[0] -= banded.mv(Tl, xm1)
    r[-1] -= banded.mv(Tr, xp1)
    dh, up, bt = (torch.zeros_like(Tl), torch.zeros_like(Tl),
                  torch.zeros_like(r[0]))
    DU, hb = torch.empty_like(L), torch.empty_like(r)
    for j in range(plan.Mc):
        f = banded.mm(L[j], dh)
        dh = banded.small_inv(D[j] - banded.mm(f, up))
        bt = r[j] - banded.mv(f, bt)
        DU[j], hb[j] = banded.mm(dh, U[j]), banded.mv(dh, bt)
        up = U[j]
    xs = torch.empty_like(r)
    xn = torch.zeros_like(r[0])
    for j in reversed(range(plan.Mc)):
        xn = xs[j] = hb[j] - banded.mv(DU[j], xn)
    return u + banded.rows_to_nodes(xs, plan.nvar)


# --------------------------------------------------------------- kernel


def _entry(backend, plan, u, helpers, pstack, x, what, name):
    """The bound C entry ``name`` of K9 at these inputs' shapes on ``plan``,
    which it checks (and raises on)."""
    sysm = backend.system
    check_shapes(what, u=(u, (sysm.nvar, plan.N)),
                 helpers=(helpers, (len(sysm.help_funcs), plan.N)),
                 pstack=(pstack, (len(sysm.pars), plan.N)), x=(x, (plan.N,)))
    if ((plan.nvar, plan.halo) != (sysm.nvar, sysm.halo) or plan.s > MAX_S
            or plan.Mc > MAX_MC[plan.s] or plan.B != 1):
        raise ValueError(f"{what}: plan {plan} does not fit the kernel")
    return backend.megatheta.fn(f"tf_megatheta_{name}_{suffix(u.dtype)}", 7, 4, 2)


def _bound(backend, plan, u, helpers, pstack, x, what, name):
    """``_entry`` once per (backend, plan, shapes): the launch path is short,
    as K1's, since a step calls each entry once; every call checks the
    tensors' device, dtype and contiguity (``_launch.shape_cache``)."""
    check_cuda((u, helpers, pstack, x), backend.dtype, what)
    return shape_cache((what, backend, plan, u.shape, helpers.shape, pstack.shape,
                        x.shape), _entry, backend, plan, u, helpers, pstack, x, what,
                       name)


def interface(backend, plan, u, helpers, pstack, x, beta, dt):
    """The interface pass of ``I + beta*J`` and ``dt*F`` at u (nvar, N):
    (Lred, Ured (2s, 2s, C), yred (2s, C)), the reduced system and its
    right-hand side as ``thomas.spike_factor`` and ``thomas.thomas_sweep``
    give them.  CPU tensors take the plain version; CUDA tensors launch
    K9's interface entry."""
    if u.device.type == "cpu":
        return interface_plain(backend, plan, u, helpers, pstack, x, beta, dt)
    what = "K9 interface"
    fn = _bound(backend, plan, u, helpers, pstack, x, what, "interface")
    s2, C = 2 * plan.s, plan.C
    red = torch.empty((2, s2, s2, C), dtype=u.dtype, device=u.device)
    yred = torch.empty((s2, C), dtype=u.dtype, device=u.device)
    rc = fn(u.data_ptr(), helpers.data_ptr(), pstack.data_ptr(), x.data_ptr(),
            red[0].data_ptr(), red[1].data_ptr(), yred.data_ptr(), plan.N,
            plan.Mc, C, int(plan.wrap), float(beta), float(dt), stream_of(u))
    if rc:
        backend.megatheta.check(rc, what)
    INTERFACE_LAUNCHES.add()
    return red[0], red[1], yred


def correct(backend, plan, u, helpers, pstack, x, beta, dt, xm1, xp1):
    """The correction pass: ``u + (I + beta*J)^-1 (dt*F)`` from the
    neighbour interface unknowns xm1, xp1 (s, C) of
    ``pcr.pcr_solve_shift``.  CPU tensors take the plain version; CUDA
    tensors launch K9's correct entry."""
    if u.device.type == "cpu":
        return correct_plain(backend, plan, u, helpers, pstack, x, beta, dt,
                             xm1, xp1)
    what = "K9 correct"
    check_cuda((xm1, xp1), u.dtype, what, (plan.s, plan.C))
    fn = _bound(backend, plan, u, helpers, pstack, x, what, "correct")
    out = torch.empty_like(u)
    rc = fn(u.data_ptr(), helpers.data_ptr(), pstack.data_ptr(), x.data_ptr(),
            xm1.data_ptr(), xp1.data_ptr(), out.data_ptr(), plan.N, plan.Mc,
            plan.C, int(plan.wrap), float(beta), float(dt), stream_of(u))
    if rc:
        backend.megatheta.check(rc, what)
    CORRECT_LAUNCHES.add()
    return out


def scalars(dtype, theta, dt):
    """(beta, dt): ``-theta*dt`` and dt rounded as the model's dtype
    multiplies them, the reference's step scalars."""
    T = np.float64 if dtype == torch.float64 else np.float32
    return float(-(T(theta) * T(dt))), float(T(dt))


def step_plain(backend, plan, theta, u, helpers, pstack, x, dt):
    """``theta_step`` of the plain versions, on any device."""
    beta, dt = scalars(u.dtype, theta, dt)
    Lred, Ured, yred = interface_plain(backend, plan, u, helpers, pstack, x,
                                       beta, dt)
    red = pcr.pcr_factor_plain(Lred, Ured, plan.cyclic)
    wood = pcr.woodbury_plain(red, Lred, Ured) if plan.woodbury else ()
    xm1, xp1 = pcr.pcr_solve_shift_plain(red, yred, plan.wrap, *wood)
    return correct_plain(backend, plan, u, helpers, pstack, x, beta, dt, xm1,
                         xp1)


def theta_step(backend, plan, theta, u, helpers, pstack, x, dt):
    """One theta step of a periodic grid (u (nvar, N)) on ``plan``:
    K9.interface, K4's factor (and the Woodbury set-up), K4's solve with
    shifts, K9.correct; plain versions throughout on the CPU."""
    beta, dt = scalars(u.dtype, theta, dt)
    Lred, Ured, yred = interface(backend, plan, u, helpers, pstack, x, beta, dt)
    red = pcr.pcr_factor(Lred, Ured, plan.cyclic)
    wood = pcr.woodbury(red, Lred, Ured) if plan.woodbury else ()
    xm1, xp1 = pcr.pcr_solve_shift(red, yred, plan.wrap, *wood)
    return correct(backend, plan, u, helpers, pstack, x, beta, dt, xm1, xp1)
