"""Kernel K7: the block-banded matrix-vector product ``scale * A v``;
wrapper and plain version.

Replaces the TPU's ``ops/pallas_stencil.py:banded_matvec_pallas`` (reached
through the reference's ``ops/banded.py:banded_matvec``) and computes
``ops/folded.py:matvec_folded``, the same product in the TPU's folded
layout; source ``csrc/matvec.cu``.  Two paths call it: the ROW schemes'
residual refinement (``refine=``: ``rhs - k + g00 dt J k``) and the
right-hand side of ``Theta(solver=...)`` (``dt F - theta dt J u + u``).

A banded matrix ``A (W, nvar, nvar, N)`` couples node i to node i + k - h
(``h = W // 2``) through ``A[k, :, :, i]``; in edge mode a column outside
the grid contributes zero (the compiler folds the ghost nodes into the
bands), on a ring the index wraps.  A leading member axis (bands ``(B, W,
nvar, nvar, N)``, v ``(B, nvar, N)``) takes B products in one launch, and
``scale`` is a number or a per-member (B,) tensor on v's device.
"""

from __future__ import annotations

import torch

from ._build import csrc_library
from ._launch import Counter, check_cuda, check_shapes, stream_of, suffix
from .banded import per_member
from .thomas import beta_args, members

LAUNCHES = Counter("K7.matvec")

#: most members of one launch (the kernel's grid.y)
MAX_MEMBERS = 65535

LIB = csrc_library("matvec.cu")


def banded_matvec_plain(bands, v, periodic, scale=1.0):
    """``scale * A v`` for bands ((B,) W, nvar, nvar, N) and v ((B,) nvar,
    N): one shifted product per band, summed in band order."""
    W, _, _, N = bands.shape[-4:]
    h = W // 2
    out = torch.zeros_like(v)
    for k in range(W):
        off = k - h
        if periodic:
            vs = torch.roll(v, -off, dims=-1)
        else:
            vs = torch.zeros_like(v)
            lo, hi = max(0, -off), min(N, N - off)
            if lo < hi:
                vs[..., lo:hi] = v[..., lo + off:hi + off]
        out += torch.einsum("...mni,...ni->...mi", bands[..., k, :, :, :], vs)
    if isinstance(scale, torch.Tensor):
        return per_member(scale, out.ndim) * out
    return out if scale == 1.0 else scale * out


def banded_matvec(bands, v, periodic, scale=1.0):
    """``scale * A v`` (module doc).  CPU tensors take the plain version;
    CUDA tensors launch K7."""
    if v.device.type == "cpu":
        return banded_matvec_plain(bands, v, periodic, scale)
    B, lead = members(v, 2)
    W, nvar, _, N = bands.shape[-4:]
    if B > MAX_MEMBERS:
        raise NotImplementedError(f"K7 matvec: {B} members; the kernel takes "
                                  f"at most {MAX_MEMBERS}")
    check_cuda((bands, v), v.dtype, "K7 matvec")
    check_shapes("K7 matvec", bands=(bands, (*lead, W, nvar, nvar, N)),
                 v=(v, (*lead, nvar, N)))
    if N >= 2 ** 31:
        raise NotImplementedError("K7 matvec: grids of 2^31 nodes or more")
    scale_ptr, scale_val = beta_args(scale, B, v.dtype, v.device,
                                     "K7 matvec scale")
    out = torch.empty_like(v)
    fn = LIB.fn(f"tf_matvec_{suffix(v.dtype)}", 4, 5, 1)
    rc = fn(bands.data_ptr(), v.data_ptr(), out.data_ptr(), scale_ptr, W, nvar,
            N, B, int(bool(periodic)), scale_val, stream_of(v))
    LIB.check(rc, "K7 matvec")
    LAUNCHES.add()
    return out
