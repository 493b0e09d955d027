"""Kernel K5: linear combinations ``out[k] = Σ_j rows[k][j] · arrays[j]``
of same-shape arrays in one pass; wrapper and plain version.

Replaces the TPU's ``ops/folded.py:combine_folded``; source
``csrc/combine.cu``.  The Rosenbrock step calls it for every stage input
(with the stage's bias sum as a second row) and for the final
``(u_new, u_new - u_pred)`` pair; an explicit RK step for every stage
input ``u + Σ (a_ij dt) k_j`` and for the final ``(u_new, err row)``
pair.  The plain version is the reference's
own fallback loop: a column whose coefficient is 0 is skipped, one whose
coefficient is 1 is added unmultiplied, and the terms are summed in column
order.

The launch path is short, since a step launches K5 once per stage with the
same few rows every step: the kernel's argument block (the coefficients
rounded to the arrays' type and each one's role) is built once per (rows,
dtype) and cached (``_coef_block``), and a launch passes only that block,
the array pointers, n and the SM count read once per process.

The explicit RK family (``core.schemes.ERK_general``) weighs its stages by
``a_ij * dt``: ``dt`` is one launch argument and ``dt_cols`` marks the
columns it scales (the fourth role, ``kScaleDt``), so the cached block
stays keyed on the tableau while dt changes at every adaptive attempt.
Such a column's coefficient is ``T(c) * T(dt)``, the product rounded in
the arrays' type T, as the reference rounds ``float(c) * dt`` on a T
scalar; the C entry forms it once per launch (the same product for every
element) and the body multiplies it into the column as any other.  A
zero ``c`` still skips its column, and a ``c`` of 1 multiplies.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import csrc_library
from ._launch import Counter, check_cuda, sm_count, stream_of

LAUNCHES = Counter("K5.combine")
#: launches of the per-member dt body (``combine_members_kernel``)
MEMBER_LAUNCHES = Counter("K5.combine_members")

#: most input arrays and coefficient rows of one launch (kMaxA, kMaxR in
#: csrc/combine.cu): u and the six RODASPR stages, two output rows
MAX_ARRAYS = 8
MAX_ROWS = 2
LIB = csrc_library("combine.cu")
_ENTRIES = {torch.float32: "tf_combine_f32", torch.float64: "tf_combine_f64"}

#: (rows as a tuple of tuples, arrays, dtype) -> the cached argument block;
#: emptied when it reaches _MAX_BLOCKS (a step's rows are a few constants)
_BLOCKS = {}
_MAX_BLOCKS = 256
_ROLE = {0.0: 0, 1.0: 1}  # kSkip, kUnit; anything else kScale (2)
#: the role of a nonzero coefficient in a column that dt scales
_SCALE_DT = 3


def _coerce_rows(rows, n_arrays):
    rows = [[float(c) for c in row] for row in rows]
    if any(len(row) != n_arrays for row in rows):
        raise ValueError(f"K5 combine: every row needs {n_arrays} "
                         "coefficients, one per array")
    return rows


def _np_type(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def _coef_block(rows, n_arrays, dtype, dt_cols=()):
    """(ctypes buffer, rows count) of ``Coefs<T>`` in csrc/combine.cu: the
    rows' coefficients rounded to ``dtype`` in a (MAX_ROWS, MAX_ARRAYS)
    array, then each one's role as a byte (``kScaleDt`` for a nonzero one
    in a column of ``dt_cols``), padded to the type's size; built once
    per (rows, dtype, dt_cols)."""
    key = (tuple(map(tuple, rows)), n_arrays, dtype, dt_cols)
    hit = _BLOCKS.get(key)
    if hit is not None:
        return hit
    rows = _coerce_rows(rows, n_arrays)
    R = len(rows)
    if not (1 <= n_arrays <= MAX_ARRAYS and 1 <= R <= MAX_ROWS):
        raise NotImplementedError(
            f"K5 combine: {n_arrays} arrays and {R} rows; the kernel takes at "
            f"most {MAX_ARRAYS} and {MAX_ROWS}")
    coef = np.zeros((MAX_ROWS, MAX_ARRAYS), dtype=_np_type(dtype))
    role = np.zeros((MAX_ROWS, MAX_ARRAYS), dtype=np.uint8)
    for k, row in enumerate(rows):
        for j, c in enumerate(row):
            coef[k, j] = c
            role[k, j] = ((_SCALE_DT if c else 0) if j in dt_cols
                          else _ROLE.get(c, 2))
    raw = coef.tobytes() + role.tobytes()
    item = coef.itemsize
    raw += bytes(-len(raw) % item)
    block = ctypes.create_string_buffer(raw, len(raw))
    if len(_BLOCKS) >= _MAX_BLOCKS:
        _BLOCKS.clear()
    _BLOCKS[key] = hit = (block, R)
    return hit


def _dt_coef(c, dt, T, ndim):
    """``T(c) * T(dt)``: a number, or with one dt per member (a (B,)
    tensor) a (B, 1, ...) tensor of ``ndim`` dimensions."""
    if isinstance(dt, torch.Tensor):
        return (c * dt).reshape((-1,) + (1,) * (ndim - 1))
    return float(T(c) * T(dt))


def combine_plain(rows, arrays, dt=None, dt_cols=()):
    rows = _coerce_rows(rows, len(arrays))
    T = _np_type(arrays[0].dtype)
    outs = []
    for row in rows:
        acc = None
        for j, (c, arr) in enumerate(zip(row, arrays)):
            if c:
                if j in dt_cols:
                    t = _dt_coef(c, dt, T, arr.ndim) * arr
                else:
                    t = arr if c == 1.0 else c * arr
                acc = t if acc is None else acc + t
        outs.append(acc if acc is not None else torch.zeros_like(arrays[0]))
    return outs


def combine(rows, arrays, dt=None, dt_cols=()):
    """``[Σ_j rows[k][j] * arrays[j] for each row k]``: ``rows`` are lists
    of Python floats, one per array; ``arrays`` share one shape.  The
    coefficients of the columns in ``dt_cols`` (a tuple of indices) are
    ``T(c) * T(dt)`` instead (module doc); ``dt`` is a number, or one per
    member of arrays with a leading member axis (a (B,) tensor of their
    dtype on their device).  CPU tensors take the plain version; CUDA
    tensors launch K5."""
    a0 = arrays[0]
    dt_cols = tuple(dt_cols)
    if dt_cols and dt is None:
        raise ValueError("K5 combine: dt_cols without a dt")
    if a0.device.type == "cpu":
        return combine_plain(rows, arrays, dt, dt_cols)
    A = len(arrays)
    check_cuda(arrays, a0.dtype, "K5 combine", a0.shape)
    block, R = _coef_block(rows, A, a0.dtype, dt_cols)
    n = a0.numel()
    if n >= 2 ** 31:
        raise ValueError("K5 combine: arrays of 2^31 elements or more")
    dt_b, B = None, 1
    if isinstance(dt, torch.Tensor):
        B = a0.shape[0]
        check_cuda((dt,), a0.dtype, "K5 combine dt", (B,))
        if B > 65535:
            raise ValueError(f"K5 combine: {B} members with their own dt; the "
                             "kernel takes at most 65535")
        dt_b, dt = dt.data_ptr(), 0.0
    outs = [torch.empty_like(a0) for _ in range(R)]
    ptrs = [a.data_ptr() for a in arrays] + [None] * (MAX_ARRAYS - A)
    fn = LIB.fn(_ENTRIES[a0.dtype], 12, 5, 1)
    rc = fn(block, *ptrs, outs[0].data_ptr(),
            outs[1].data_ptr() if R > 1 else None, dt_b, A, R, n,
            sm_count(a0), B, 0.0 if dt is None else float(dt), stream_of(a0))
    LIB.check(rc, "K5 combine")
    (LAUNCHES if dt_b is None else MEMBER_LAUNCHES).add()
    return outs
