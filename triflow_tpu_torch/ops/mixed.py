"""Kernel K8, the residual of the mixed-precision stage solve; its wrapper
and plain version, and the solve it serves.

K8 computes ``r32 = float((rhs - k) + coef * A k)`` from double bands ``A
((B,) W, nvar, nvar, N)``, double ``k`` and ``rhs`` ((B,) nvar, N) and a
number ``coef`` or a per-member (B,) double tensor, into a float32 tensor.
It replaces the TPU's ``ops/folded.py:matvec_df_folded`` and, in the node
layout, ``ops/banded_df.py:banded_matvec_df`` (the df64 product ``J k``
on (hi, lo) float pairs) together with the residual the reference forms
around them; source ``csrc/mixed_residual.cu``, whose band walk K7 shares
(``csrc/matvec.cuh``).

``MixedFactorization`` is the reference's ``df64_mixed_solve=n``
(``core/schemes.py:_df64_mixed_solver``, Higham-style): the system ``I -
coef J`` rounded to float32 is factored once (K2, K4 on J's bands rounded
to float32: the rounded operator, not J of the rounded state, is the
preconditioner), a right-hand side is solved in float32 (K3, K4, K3) on
its rounding, and each of ``n`` passes solves the K8 residual against the
double operator in float32 and adds the widened correction.  On Hopper
the state, J and the residual are native float64; only the factor and the
solves are float32.
"""

from __future__ import annotations

import torch

from . import chunked
from ._build import csrc_library
from ._launch import Counter, check_cuda, check_shapes, stream_of
from .banded import per_member
from .matvec import MAX_MEMBERS, banded_matvec_plain
from .thomas import beta_args, members

LAUNCHES = Counter("K8.residual")

LIB = csrc_library("mixed_residual.cu")


def mixed_residual_plain(bands, k, rhs, coef, periodic):
    """``float((rhs - k) + coef * A k)``: the product in float64 (K7's plain
    version), the combination, then the rounding."""
    Ak = banded_matvec_plain(bands, k, periodic)
    if isinstance(coef, torch.Tensor):
        coef = per_member(coef, Ak.ndim)
    return ((rhs - k) + coef * Ak).float()


def mixed_residual(bands, k, rhs, coef, periodic):
    """``float((rhs - k) + coef * A k)`` (module doc).  CPU tensors take
    the plain version; CUDA tensors launch K8."""
    if k.device.type == "cpu":
        return mixed_residual_plain(bands, k, rhs, coef, periodic)
    what = "K8 mixed residual"
    B, lead = members(k, 2)
    W, nvar, _, N = bands.shape[-4:]
    if B > MAX_MEMBERS:
        raise NotImplementedError(f"{what}: {B} members; the kernel takes at "
                                  f"most {MAX_MEMBERS}")
    check_cuda((bands, k, rhs), torch.float64, what)
    check_shapes(what, bands=(bands, (*lead, W, nvar, nvar, N)),
                 k=(k, (*lead, nvar, N)), rhs=(rhs, (*lead, nvar, N)))
    if N >= 2 ** 31:
        raise NotImplementedError(f"{what}: grids of 2^31 nodes or more")
    coef_ptr, coef_val = beta_args(coef, B, torch.float64, k.device,
                                   f"{what} coef")
    out = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    fn = LIB.fn("tf_mixed_residual_f64", 5, 5, 1)
    rc = fn(bands.data_ptr(), k.data_ptr(), rhs.data_ptr(), out.data_ptr(),
            coef_ptr, W, nvar, N, B, int(bool(periodic)), coef_val,
            stream_of(k))
    LIB.check(rc, what)
    LAUNCHES.add()
    return out


class MixedFactorization:
    """``(I - coef J)^-1`` by a float32 factor and ``passes`` residual
    passes against the float64 bands (module doc), of one grid (bands (W,
    nvar, nvar, N), ``coef`` a number) or of B members (bands (B, W, nvar,
    nvar, N), ``coef`` a number or a (B,) float64 tensor: an ensemble's
    per-member dt); ``solve`` has the signature of
    ``chunked.ChunkedFactorization.solve``.  The members' float32 factor
    takes each member's shift rounded to float32 (K2 and K4 with a member
    axis, as ``chunked.factor`` takes an ensemble's), and K8 each member's
    float64 coef.  ``factor`` (default ``chunked.factor``) makes the float32
    factor from its plan: a sharded grid's is ``parallel.spatial``'s
    ``spike_factor``, and K8's residual then runs on the global bands, the
    distributed operator."""

    def __init__(self, bands, coef, periodic, plan, passes, factor=None):
        self.bands = bands
        self.coef = coef
        self.periodic = periodic
        self.passes = int(passes)
        shift = -coef.float() if isinstance(coef, torch.Tensor) else -coef
        self.fact32 = (factor or chunked.factor)(1.0, shift, bands.float(),
                                                 periodic, plan)

    def solve(self, rhs, add_to=None):
        """``add_to + k`` (or ``k``) for the float64 solution k of the
        system with right-hand side ``rhs``: one float32 solve of the
        rounded rhs, then per pass the K8 residual and one float32 solve
        whose widened result is added to k."""
        k = self.fact32.solve(rhs.float()).double()
        for _ in range(self.passes):
            r32 = mixed_residual(self.bands, k, rhs, self.coef, self.periodic)
            k = k + self.fact32.solve(r32)
        return k if add_to is None else add_to + k
