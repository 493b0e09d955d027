"""Kernel K5: linear combinations ``out[k] = Σ_j rows[k][j] · arrays[j]``
of same-shape arrays in one pass; wrapper and plain version.

Replaces the TPU's ``ops/folded.py:combine_folded``; source
``csrc/combine.cu``.  The Rosenbrock step calls it for every stage input
(with the stage's bias sum as a second row) and for the final
``(u_new, u_new - u_pred)`` pair.  The plain version is the reference's
own fallback loop: a column whose coefficient is 0 is skipped, one whose
coefficient is 1 is added unmultiplied, and the terms are summed in column
order.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import csrc_library
from ._launch import Counter, check_cuda, check_shapes, stream_of, suffix

LAUNCHES = Counter("K5.combine")

#: most input arrays and coefficient rows of one launch (kMaxA, kMaxR in
#: csrc/combine.cu): u and the six RODASPR stages, two output rows
MAX_ARRAYS = 8
MAX_ROWS = 2

LIB = csrc_library("combine.cu")


def _coerce_rows(rows, n_arrays):
    rows = [[float(c) for c in row] for row in rows]
    if any(len(row) != n_arrays for row in rows):
        raise ValueError(f"K5 combine: every row needs {n_arrays} "
                         "coefficients, one per array")
    return rows


def combine_plain(rows, arrays):
    rows = _coerce_rows(rows, len(arrays))
    outs = []
    for row in rows:
        acc = None
        for c, arr in zip(row, arrays):
            if c:
                t = arr if c == 1.0 else c * arr
                acc = t if acc is None else acc + t
        outs.append(acc if acc is not None else torch.zeros_like(arrays[0]))
    return outs


def combine(rows, arrays):
    """``[Σ_j rows[k][j] * arrays[j] for each row k]``: ``rows`` are lists
    of Python floats, one per array; ``arrays`` share one shape.  CPU
    tensors take the plain version; CUDA tensors launch K5."""
    a0 = arrays[0]
    if a0.device.type == "cpu":
        return combine_plain(rows, arrays)
    rows = _coerce_rows(rows, len(arrays))
    A, R = len(arrays), len(rows)
    if not (1 <= A <= MAX_ARRAYS and 1 <= R <= MAX_ROWS):
        raise NotImplementedError(
            f"K5 combine: {A} arrays and {R} rows; the kernel takes at most "
            f"{MAX_ARRAYS} and {MAX_ROWS}")
    check_cuda(arrays, a0.dtype, "K5 combine")
    check_shapes("K5 combine",
                 **{f"arrays[{j}]": (a, a0.shape) for j, a in enumerate(arrays)})
    if a0.numel() >= 2 ** 31:
        raise ValueError("K5 combine: arrays of 2^31 elements or more")
    outs = [torch.empty_like(a0) for _ in rows]
    in_ptrs = (ctypes.c_uint64 * A)(*(a.data_ptr() for a in arrays))
    out_ptrs = (ctypes.c_uint64 * R)(*(o.data_ptr() for o in outs))
    coefs = (ctypes.c_double * (A * R))(*(c for row in rows for c in row))
    fn = LIB.fn(f"tf_combine_{suffix(a0.dtype)}", 3, 3)
    rc = fn(ctypes.addressof(in_ptrs), ctypes.addressof(out_ptrs),
            ctypes.addressof(coefs), A, R, a0.numel(), stream_of(a0))
    LIB.check(rc, "K5 combine")
    LAUNCHES.add()
    return outs
