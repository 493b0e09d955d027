"""Kernel K4: PCR of the chunk-interface system (factor, and the per
right-hand side solve with neighbour shifts); wrappers and plain versions.

Replaces the TPU's ``ops/pallas_pcr.py:pcr_factor_fused_sub`` and
``interface_shift_solve``; source ``csrc/pcr.cu``.  The plain versions are
``ops/banded.py``'s ``pcr_factor`` / ``pcr_solve``.  The reduced system
has identity diagonal blocks and the couplings ``Lred`` / ``Ured``
(2s, 2s, C) that K2 writes.

Both kernel entries run in one thread block, so the chunk count is capped
at ``MAX_C``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import banded, thomas
from ._build import csrc_library
from ._launch import Counter, check_cuda, check_shapes, stream_of, suffix

FACTOR_LAUNCHES = Counter("K4.pcr_factor")
SOLVE_LAUNCHES = Counter("K4.pcr_solve_shift")

#: most chunks the one-block kernels take
MAX_C = 16384
#: threads of the one block (kThreads in csrc/pcr.cu)
BLOCK_THREADS = 512

LIB = csrc_library("pcr.cu")


class PcrFactor(NamedTuple):
    """Per-level operators (nlev, s2, s2, C) and final inverse (s2, s2, C)."""

    alphas: torch.Tensor
    betas: torch.Tensor
    Dinv: torch.Tensor


def n_levels(C: int) -> int:
    return (C - 1).bit_length()


def _check_sizes(s2, C, what):
    if C > MAX_C:
        raise ValueError(f"{what}: C = {C} > {MAX_C} chunks")
    if s2 % 2 or s2 > 2 * thomas.MAX_S:
        raise NotImplementedError(
            f"{what}: interface block size {s2} has no kernel instantiation")


def pcr_factor_plain(Lred, Ured, cyclic: bool) -> PcrFactor:
    s2, _, C = Lred.shape
    eye = torch.eye(s2, dtype=Lred.dtype, device=Lred.device)
    alphas, betas, Dinv = banded.pcr_factor(
        Lred, eye[..., None].expand(s2, s2, C), Ured, cyclic)
    empty = Lred.new_zeros((0, s2, s2, C))
    return PcrFactor(torch.stack(alphas) if alphas else empty,
                     torch.stack(betas) if betas else empty, Dinv)


def pcr_factor(Lred, Ured, cyclic: bool) -> PcrFactor:
    """Factor the reduced system with identity diagonal blocks."""
    if Lred.device.type == "cpu":
        return pcr_factor_plain(Lred, Ured, cyclic)
    s2, _, C = Lred.shape
    check_cuda((Lred, Ured), Lred.dtype, "K4 pcr_factor")
    check_shapes("K4 pcr_factor", Lred=(Lred, (s2, s2, C)),
                 Ured=(Ured, (s2, s2, C)))
    _check_sizes(s2, C, "K4 pcr_factor")
    if cyclic and C & (C - 1):
        raise ValueError("K4 pcr_factor: cyclic PCR requires a power-of-two C")
    nlev = n_levels(C)
    ops = torch.empty((2, nlev, s2, s2, C), dtype=Lred.dtype, device=Lred.device)
    Dinv = torch.empty((s2, s2, C), dtype=Lred.dtype, device=Lred.device)
    scratch = torch.empty((7, s2, s2, C), dtype=Lred.dtype, device=Lred.device)
    fn = LIB.fn(f"tf_pcr_factor_{suffix(Lred.dtype)}", 6, 3)
    rc = fn(Lred.data_ptr(), Ured.data_ptr(), ops[0].data_ptr(),
            ops[1].data_ptr(), Dinv.data_ptr(), scratch.data_ptr(), C, s2,
            int(bool(cyclic)), stream_of(Lred))
    LIB.check(rc, "K4 pcr_factor")
    FACTOR_LAUNCHES.add()
    return PcrFactor(ops[0], ops[1], Dinv)


def pcr_solve_shift_plain(red: PcrFactor, yred, cyclic: bool):
    s = yred.shape[0] // 2
    z = banded.pcr_solve(red.alphas, red.betas, red.Dinv, yred)
    xm1 = torch.roll(z[s:], 1, dims=-1)
    xp1 = torch.roll(z[:s], -1, dims=-1)
    if not cyclic:
        xm1[:, 0] = 0.0
        xp1[:, -1] = 0.0
    return xm1, xp1


def pcr_solve_shift(red: PcrFactor, yred, cyclic: bool):
    """Solve the reduced system for ``yred (2s, C)`` and return the
    neighbour interface unknowns of every chunk: ``xm1[:, c]`` = bottom of
    chunk c-1 and ``xp1[:, c]`` = top of chunk c+1, each (s, C); zero past
    the ends when acyclic."""
    if yred.device.type == "cpu":
        return pcr_solve_shift_plain(red, yred, cyclic)
    s2, C = yred.shape
    s = s2 // 2
    check_cuda((yred, red.alphas, red.betas, red.Dinv), yred.dtype,
               "K4 pcr_solve_shift")
    ops = (n_levels(C), s2, s2, C)
    check_shapes("K4 pcr_solve_shift", alphas=(red.alphas, ops),
                 betas=(red.betas, ops), Dinv=(red.Dinv, (s2, s2, C)))
    _check_sizes(s2, C, "K4 pcr_solve_shift")
    out = torch.empty((2, s, C), dtype=yred.dtype, device=yred.device)
    scratch = torch.empty((2, s2, C), dtype=yred.dtype, device=yred.device)
    fn = LIB.fn(f"tf_pcr_solve_shift_{suffix(yred.dtype)}", 7, 3)
    rc = fn(red.alphas.data_ptr(), red.betas.data_ptr(), red.Dinv.data_ptr(),
            yred.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            scratch.data_ptr(), C, s2, int(bool(cyclic)), stream_of(yred))
    LIB.check(rc, "K4 pcr_solve_shift")
    SOLVE_LAUNCHES.add()
    return out[0], out[1]
