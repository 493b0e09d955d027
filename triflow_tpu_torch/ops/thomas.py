"""Kernels K2 (chunked SPIKE factor) and K3 (per right-hand side sweep and
spike correction): wrappers and plain versions.

K2 replaces the TPU's ``ops/folded.py:factor_sweeps_folded`` and
``ops/pallas_thomas.py:_bwd_factor_call_cols``; K3 replaces
``ops/pallas_thomas.py:chunked_solve_flat`` and the spike correction of
``ops/folded.py:_solve_folded_flat``.  Sources: ``csrc/spike_factor.cu``
and ``csrc/spike_solve.cu``.  The plain versions are the chunked factor
and sweeps of ``ops/banded.py``.

Every wrapper takes the plain version for CPU tensors and launches its
kernel for CUDA tensors; ``plan`` is an ``ops.chunked.Plan``.
"""

from __future__ import annotations

import torch

from . import banded
from ._build import csrc_library
from ._launch import Counter, check_cuda, check_shapes, stream_of, suffix

FACTOR_LAUNCHES = Counter("K2.spike_factor")
SWEEP_LAUNCHES = Counter("K3.thomas_sweep")
CORRECT_LAUNCHES = Counter("K3.spike_correct")

#: the block sizes s = nvar * max(halo, 1) the kernels are instantiated for
MAX_S = 4

FACTOR_LIB = csrc_library("spike_factor.cu")
SOLVE_LIB = csrc_library("spike_solve.cu")


def _check_s(plan, what):
    if plan.s > MAX_S:
        raise NotImplementedError(
            f"{what}: block size s = {plan.s} > {MAX_S} has no kernel "
            "instantiation yet")


def _rows_shape(plan):
    return (plan.Mc, plan.s, plan.s, plan.C)


def spike_factor_plain(bands, alpha, beta, plan):
    L, D, U = banded.assemble_blocks(banded.axpy_bands(alpha, beta, bands))
    return banded.chunked_factor(L, D, U, plan.C, plan.wrap)


def spike_factor(bands, alpha, beta, plan) -> banded.SpikeFactor:
    """Chunked factorization of ``alpha*I + beta*J`` from the bands
    ``(W, nvar, nvar, N)`` of J."""
    if bands.device.type == "cpu":
        return spike_factor_plain(bands, alpha, beta, plan)
    check_cuda((bands,), bands.dtype, "K2 spike_factor")
    check_shapes("K2 spike_factor",
                 bands=(bands, (plan.W, plan.nvar, plan.nvar, plan.N)))
    _check_s(plan, "K2 spike_factor")
    s, C = plan.s, plan.C
    rows = torch.empty((5, plan.Mc, s, s, C), dtype=bands.dtype,
                       device=bands.device)
    red = torch.empty((2, 2 * s, 2 * s, C), dtype=bands.dtype,
                      device=bands.device)
    fn = FACTOR_LIB.fn(f"tf_spike_factor_{suffix(bands.dtype)}", 8, 7, 2)
    rc = fn(bands.data_ptr(), *(r.data_ptr() for r in rows),
            red[0].data_ptr(), red[1].data_ptr(), plan.N, plan.nvar, plan.g,
            plan.halo, plan.Mc, C, int(plan.wrap), float(alpha), float(beta),
            stream_of(bands))
    FACTOR_LIB.check(rc, "K2 spike_factor")
    FACTOR_LAUNCHES.add()
    return banded.SpikeFactor(*rows, red[0], red[1])


def thomas_sweep_plain(fact: banded.SpikeFactor, rhs, plan):
    y = banded.chunked_sweep(fact.fac, fact.Dhinv, fact.DU,
                             banded.nodes_to_rows(rhs, plan.g, plan.C))
    return banded.rows_to_nodes(y, plan.nvar), torch.cat([y[0], y[-1]], dim=0)


def thomas_sweep(fact: banded.SpikeFactor, rhs, plan):
    """Chunk-local Thomas solve of ``rhs (nvar, N)``: returns y (nvar, N)
    and the interface right-hand side yred (2s, C)."""
    if rhs.device.type == "cpu":
        return thomas_sweep_plain(fact, rhs, plan)
    check_cuda((rhs, fact.fac, fact.Dhinv, fact.DU), rhs.dtype, "K3 thomas_sweep")
    rows = _rows_shape(plan)
    check_shapes("K3 thomas_sweep", rhs=(rhs, (plan.nvar, plan.N)),
                 fac=(fact.fac, rows), Dhinv=(fact.Dhinv, rows),
                 DU=(fact.DU, rows))
    _check_s(plan, "K3 thomas_sweep")
    y = torch.empty_like(rhs)
    yred = torch.empty((2 * plan.s, plan.C), dtype=rhs.dtype, device=rhs.device)
    fn = SOLVE_LIB.fn(f"tf_thomas_sweep_{suffix(rhs.dtype)}", 6, 5)
    rc = fn(fact.fac.data_ptr(), fact.Dhinv.data_ptr(), fact.DU.data_ptr(),
            rhs.data_ptr(), y.data_ptr(), yred.data_ptr(), plan.N, plan.nvar,
            plan.g, plan.Mc, plan.C, stream_of(rhs))
    SOLVE_LIB.check(rc, "K3 thomas_sweep")
    SWEEP_LAUNCHES.add()
    return y, yred


def spike_correct_plain(fact: banded.SpikeFactor, y, xm1, xp1, plan,
                        add_to=None):
    rows = banded.nodes_to_rows(y, plan.g, plan.C)
    x = banded.rows_to_nodes(
        rows - banded.mv(fact.W, xm1) - banded.mv(fact.V, xp1), plan.nvar)
    return x if add_to is None else add_to + x


def spike_correct(fact: banded.SpikeFactor, y, xm1, xp1, plan, add_to=None):
    """``add_to + (y - W xm1 - V xp1)`` in the node layout (nvar, N); xm1
    and xp1 (s, C) are the neighbours' interface unknowns."""
    if y.device.type == "cpu":
        return spike_correct_plain(fact, y, xm1, xp1, plan, add_to)
    rows = _rows_shape(plan)
    shapes = dict(y=(y, (plan.nvar, plan.N)), xm1=(xm1, (plan.s, plan.C)),
                  xp1=(xp1, (plan.s, plan.C)), W=(fact.W, rows),
                  V=(fact.V, rows))
    if add_to is not None:
        shapes["add_to"] = (add_to, (plan.nvar, plan.N))
    check_cuda([t for t, _ in shapes.values()], y.dtype, "K3 spike_correct")
    check_shapes("K3 spike_correct", **shapes)
    _check_s(plan, "K3 spike_correct")
    out = torch.empty_like(y)
    fn = SOLVE_LIB.fn(f"tf_spike_correct_{suffix(y.dtype)}", 7, 6)
    rc = fn(y.data_ptr(), fact.W.data_ptr(), fact.V.data_ptr(), xm1.data_ptr(),
            xp1.data_ptr(), 0 if add_to is None else add_to.data_ptr(),
            out.data_ptr(), plan.N, plan.nvar, plan.g, plan.Mc, plan.C,
            int(add_to is not None), stream_of(y))
    SOLVE_LIB.check(rc, "K3 spike_correct")
    CORRECT_LAUNCHES.add()
    return out
