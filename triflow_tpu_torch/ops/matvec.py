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

The kernel (``csrc/matvec.cu``) stages v's span of a tile in shared memory
and streams the bands with vector loads, at the (W, nvar) compiled in (W =
3, 5, 7 and nvar = 1, 2, 3, the repo's models' shapes); its entry runs the
body of before the tiles (a thread per node and member) for other shapes
and for members of 2^31 band values or more.  That body is also an
uncounted entry of its own (``banded_matvec_nodes``) that the kernel
checks hold the tiled one to.
"""

from __future__ import annotations

import torch

from ._build import csrc_library
from ._launch import Counter, check_cuda, check_shapes, shape_cache, stream_of, suffix
from .banded import per_member
from .thomas import beta_args, members

LAUNCHES = Counter("K7.matvec")

#: most members of one launch (the kernel's grid.y)
MAX_MEMBERS = 65535

LIB = csrc_library("matvec.cu", by_dtype=True)


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


def _shape(bands, v):
    """(W, nvar, N, B) at these inputs' shapes, which it checks (and raises
    on)."""
    B, lead = members(v, 2)
    if bands.ndim != v.ndim + 2:
        raise ValueError(f"K7 matvec: bands of shape {tuple(bands.shape)} beside v "
                         f"of shape {tuple(v.shape)}")
    W, nvar, _, N = bands.shape[-4:]
    check_shapes("K7 matvec", bands=(bands, (*lead, W, nvar, nvar, N)),
                 v=(v, (*lead, nvar, N)))
    if B > MAX_MEMBERS:
        raise NotImplementedError(f"K7 matvec: {B} members; the kernel takes "
                                  f"at most {MAX_MEMBERS}")
    if N >= 2 ** 31:
        raise NotImplementedError("K7 matvec: grids of 2^31 nodes or more")
    return W, nvar, N, B


def _entry(bands, v):
    """(bound C entry, W, nvar, N, B) at these inputs' shapes, which it
    checks (and raises on)."""
    shape = _shape(bands, v)
    return (LIB.fn(f"tf_matvec_{suffix(v.dtype)}", 4, 5, 1), *shape)


def banded_matvec(bands, v, periodic, scale=1.0):
    """``scale * A v`` (module doc).  CPU tensors take the plain version;
    CUDA tensors launch K7.

    The launch path is short, as K1's: every call checks the tensors'
    device, dtype and contiguity and a per-member ``scale``; the shapes and
    the member count are checked, and the entry bound, once per shape
    (``_launch.shape_cache``)."""
    if v.device.type == "cpu":
        return banded_matvec_plain(bands, v, periodic, scale)
    check_cuda((bands, v), v.dtype, "K7 matvec")
    fn, W, nvar, N, B = shape_cache(("K7", bands.shape, v.shape, v.dtype), _entry, bands, v)
    scale_ptr, scale_val = beta_args(scale, B, v.dtype, v.device,
                                     "K7 matvec scale")
    out = torch.empty_like(v)
    rc = fn(bands.data_ptr(), v.data_ptr(), out.data_ptr(), scale_ptr, W, nvar,
            N, B, 1 if periodic else 0, scale_val, stream_of(v))
    if rc:
        LIB.check(rc, "K7 matvec")
    LAUNCHES.add()
    return out


def banded_matvec_nodes(bands, v, periodic, scale=1.0):
    """``banded_matvec`` of CUDA tensors through the body of before the
    tiles (``tf_matvec_nodes_*``: one thread per node and member walking
    ``matvec.cuh:band_row``): on no path and uncounted; the kernel checks
    hold the tiled body to it bit for bit, and ``chip_smoke.py`` times the
    two side by side."""
    what = "K7 matvec (per-node body)"
    check_cuda((bands, v), v.dtype, what)
    W, nvar, N, B = _shape(bands, v)
    scale_ptr, scale_val = beta_args(scale, B, v.dtype, v.device, f"{what} scale")
    out = torch.empty_like(v)
    fn = LIB.fn(f"tf_matvec_nodes_{suffix(v.dtype)}", 4, 5, 1)
    rc = fn(bands.data_ptr(), v.data_ptr(), out.data_ptr(), scale_ptr, W, nvar,
            N, B, 1 if periodic else 0, scale_val, stream_of(v))
    LIB.check(rc, what)
    return out
