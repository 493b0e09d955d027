"""Lower the discretized symbolic system to tensor functions.

Counterpart of ``triflow_tpu.core.compiler``.  ``TorchBackend`` holds two
versions of the stencil RHS ``F`` and the banded Jacobian ``J``:

* the plain versions ``F_impl`` / ``J_bands_impl``: every SymPy expression
  lambdified onto torch, evaluated on whole ``(N,)`` rows;
* ``F`` / ``J_bands``: the entry points the schemes call.  They go through
  the wrappers of kernel K1 (``ops/stencil.py``), which launch the
  per-model generated CUDA kernel on a CUDA tensor and take the plain
  version on a CPU tensor.

Layouts follow the reference: ``F`` is ``(nvar, N)``, the bands are
``(W, nvar, nvar, N)`` with ``bands[k, m, n, i] = dF_m(i) / du_n(i + k - h)``,
and in edge mode the ghost-node dependencies are folded onto the boundary
columns (``fold_edges``).  Each also takes a leading member axis (an
ensemble's B grids: ``(B, nvar, N)`` and ``(B, W, nvar, nvar, N)``, x
shared).

A grid cut into ``shards`` (``parallel/spatial.py``: the reference's
mesh of devices, here views of one tensor) evaluates F and J shard by
shard, as the reference's ``shard_map`` body does: each shard's rows
extended by ``halo_extend`` (its ring neighbours' edge nodes, or the clamped
edge at the global ends in edge mode), the stencil evaluated on the
shard's interior with the shard's own dx = x[1] - x[0]
(``F_ext_impl``, ``J_bands_ext_impl``), and in edge mode the global edges
folded (``fold_edges`` on the global view: the first shard's left edge
and the last shard's right edge).  The kernel K1 computes the same from
the whole grid's tensor (``ops/stencil.py``).
"""

from __future__ import annotations

from functools import reduce

import numpy as np
import sympy as sp
import torch
from sympy import Symbol
from sympy.printing.pytorch import TorchPrinter

from ..ops import stencil
from .symbolic import DiscreteSystem, offset_symbol


def _as_tensor_like(value, like):
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def _first_tensor(args):
    return next((a for a in args if isinstance(a, torch.Tensor)), None)


def _minmax_modules():
    """Max/Min/Heaviside lowering (Heaviside is the mathematical one,
    ``H(0) = 0.5`` unless the expression names another value)."""

    def _reduce(op, args):
        if len(args) == 1 and isinstance(args[0], (tuple, list)):
            args = args[0]
        like = _first_tensor(args)
        if like is None:
            return float(reduce(max if op is torch.maximum else min, args))
        return reduce(op, [_as_tensor_like(a, like) for a in args])

    def _max(*args):
        return _reduce(torch.maximum, args)

    def _min(*args):
        return _reduce(torch.minimum, args)

    def _heaviside(a, *h0):
        a = torch.as_tensor(a)
        return torch.heaviside(a, _as_tensor_like(h0[0] if h0 else 0.5, a))

    return {"Max": _max, "Min": _min, "Heaviside": _heaviside}


class _LambdaPrinter(TorchPrinter):
    """Torch printer that leaves Max/Min/Heaviside to the lowering above
    (the stock printer emits torch.max(0, x), which torch rejects)."""

    def _call(self, name, expr):
        return f"{name}({', '.join(self._print(a) for a in expr.args)})"

    def _print_Max(self, expr):
        return self._call("Max", expr)

    def _print_Min(self, expr):
        return self._call("Min", expr)

    def _print_Heaviside(self, expr):
        return self._call("Heaviside", expr)


def shift(arr, off: int, periodic: bool):
    """Tensor of ``arr[..., i + off]`` with the boundary closure: wrap-around
    when periodic, else clamped to the edge value."""
    if off == 0:
        return arr
    if periodic:
        return torch.roll(arr, -off, dims=-1)
    n = arr.shape[-1]
    idx = torch.clamp(torch.arange(n, device=arr.device) + off, 0, n - 1)
    return arr[..., idx]


def to_shards(a, ndev: int):
    """The shard view of a node-layout tensor: (..., rows, N) -> (..., ndev,
    rows, N // ndev), shard d holding nodes [d Nl, (d + 1) Nl)."""
    return a.unflatten(-1, (ndev, a.shape[-1] // ndev)).movedim(-2, -3)


def from_shards(a):
    """Inverse of ``to_shards``: (..., ndev, rows, Nl) -> (..., rows, ndev
    Nl), contiguous."""
    return a.movedim(-3, -2).flatten(-2).contiguous()


def halo_extend(shards, h: int, periodic: bool):
    """Each shard of ``shards`` (..., ndev, rows, Nl) extended by h ghost
    nodes per side from its ring neighbours: the last h nodes of shard d-1
    on the left, the first h of shard d+1 on the right (two rolls of the
    shards' edge slices over the shard axis: the reference's two ppermute
    rings); without ``periodic`` the global ends are edge-padded (the first
    shard's left ghosts repeat its first node, the last shard's right ghosts
    its last).  Returns (..., ndev, rows, Nl + 2h)."""
    if h == 0:
        return shards
    left = torch.roll(shards[..., -h:], 1, dims=-3)
    right = torch.roll(shards[..., :h], -1, dims=-3)
    if not periodic:
        left[..., 0, :, :] = shards[..., 0, :, :1]
        right[..., -1, :, :] = shards[..., -1, :, -1:]
    return torch.cat([left, shards, right], dim=-1)


def fold_edges(bands, halo: int):
    """Fold out-of-domain band entries onto the clamped boundary columns
    (in place on ``bands``, shape (W, nvar, nvar, N)).

    At node i < halo the entry of offset k - halo with i + k - halo < 0
    multiplies u(0): add it to band ``halo - i`` and zero it.  The right
    edge is symmetric."""
    h = halo
    W = bands.shape[-4]
    for i in range(h):
        for k in range(h - i):
            bands[..., h - i, :, :, i] += bands[..., k, :, :, i]
            bands[..., k, :, :, i] = 0.0
        for k in range(h - i):
            koff = W - 1 - k
            bands[..., h + i, :, :, -1 - i] += bands[..., koff, :, :, -1 - i]
            bands[..., koff, :, :, -1 - i] = 0.0
    return bands


class TorchBackend:
    """The compiled functions of one model on one device and dtype.

    Entry points take ``u (nvar, N)``, ``helpers (nhelp, N)``,
    ``pstack (npar, N)``, ``x (N,)`` and the boundary mode ``periodic``."""

    def __init__(self, system: DiscreteSystem, dtype, device):
        self.system = system
        self.dtype = dtype
        self.device = torch.device(device)
        lo, hi = system.bounds
        self.halo = system.halo
        self.window = system.window
        all_vars = tuple(system.dep_vars) + tuple(system.help_funcs)
        self._offset_args = [
            (var, off) for off in range(lo, hi + 1) for var in all_vars
        ]
        #: argument order shared by the lambdified expressions and the
        #: generated kernel: x, offset values, parameters, dx
        self.args_symbols = (
            [Symbol("x")]
            + [offset_symbol(v, o) for v, o in self._offset_args]
            + [Symbol(p) for p in system.pars]
            + [Symbol("dx")]
        )
        modules = [_minmax_modules(), "torch"]

        def lambdify(expr):
            return sp.lambdify(self.args_symbols, expr, modules=modules,
                               printer=_LambdaPrinter)

        self._F_fns = [lambdify(e) for e in system.F_exprs]
        self._J_fns = {key: lambdify(e)
                       for key, e in system.J_band_exprs.items()}
        #: the model's K1, K6 and K9 libraries (generated CUDA sources for
        #: its dtype, built at first use), and the library of K6's mixed
        #: entry, which only the df64 mode's mixed solve launches (float64)
        self.stencil = stencil.library(system, self.args_symbols,
                                       dtype=dtype)
        self.megastep = stencil.library(system, self.args_symbols,
                                        "megastep.cu", dtype)
        self.megatheta = stencil.library(system, self.args_symbols,
                                         "megatheta.cu", dtype)
        self.megastep_mixed = stencil.library(system, self.args_symbols,
                                              "megastep.cu", dtype, True)

    # ------------------------------------------------------- kernel route
    def F(self, u, helpers, pstack, x, *, periodic: bool, scale=1.0,
          bias=None, shards=1):
        """``scale * F (+ bias)``, shape ((B,) nvar, N): kernel K1 on CUDA
        tensors; ``shards > 1``: of the grid cut into that many shards
        (module doc)."""
        return stencil.eval_F(self, u, helpers, pstack, x, periodic, scale,
                              bias, shards)

    def F_terms(self, terms, helpers, pstack, x, *, periodic: bool, scale,
                shards=1):
        """``scale * F(Σ a_j u_j) + Σ c_j u_j`` for ``terms = [(a_j, c_j,
        u_j), ...]``: kernel K1's F_terms entry on CUDA tensors."""
        return stencil.eval_F_terms(self, terms, helpers, pstack, x, periodic,
                                    scale, shards)

    def J_bands(self, u, helpers, pstack, x, *, periodic: bool, shards=1):
        """Banded J, shape (W, nvar, nvar, N): kernel K1 on CUDA tensors."""
        return stencil.eval_J(self, u, helpers, pstack, x, periodic, shards)

    # ------------------------------------------------------ plain versions
    def _ext_args(self, u_ext, helpers_ext, pstack, x, dx):
        """The argument rows of the expressions on pre-haloed rows: u_ext
        (..., nvar, Nl + 2h) and helpers_ext, with pstack (..., npar, Nl), x
        (..., Nl) and dx broadcastable against them."""
        h, Nl = self.halo, x.shape[-1]
        named = {}
        for i, name in enumerate(self.system.dep_vars):
            named[name] = u_ext[..., i, :]
        for i, name in enumerate(self.system.help_funcs):
            named[name] = helpers_ext[..., i, :]
        args = [x]
        for var, off in self._offset_args:
            args.append(named[var][..., h + off:h + off + Nl])
        for i, _p in enumerate(self.system.pars):
            args.append(pstack[..., i, :])
        args.append(dx)
        return args, Nl

    def F_ext_impl(self, u_ext, helpers_ext, pstack, x, dx):
        """Plain RHS on pre-haloed rows (the reference's ``F_ext_impl``):
        the interior's F, shape (..., nvar, Nl)."""
        args, Nl = self._ext_args(u_ext, helpers_ext, pstack, x, dx)
        shape = (*u_ext.shape[:-2], Nl)
        return torch.stack([self._row(fn(*args), x, shape)
                            for fn in self._F_fns], dim=-2)

    def J_bands_ext_impl(self, u_ext, helpers_ext, pstack, x, dx):
        """Plain banded J on pre-haloed rows, unfolded: shape (..., W, nvar,
        nvar, Nl)."""
        args, Nl = self._ext_args(u_ext, helpers_ext, pstack, x, dx)
        nvar = self.system.nvar
        lead = u_ext.shape[:-2]
        bands = torch.zeros((*lead, self.window, nvar, nvar, Nl),
                            dtype=x.dtype, device=x.device)
        for (m, n, k), fn in self._J_fns.items():
            bands[..., k, m, n, :] = self._row(fn(*args), x, (*lead, Nl))
        return bands

    def _shard_args(self, u, helpers, pstack, x, periodic, shards):
        """The haloed shards of u and helpers and the shards of pstack, x
        and dx (each shard's x[1] - x[0])."""
        h = self.halo
        xs = to_shards(x[None], shards)[..., 0, :]
        return (halo_extend(to_shards(u, shards), h, periodic),
                halo_extend(to_shards(helpers, shards), h, periodic),
                to_shards(pstack, shards), xs, (xs[:, 1] - xs[:, 0])[:, None])

    def F_shards_impl(self, u, helpers, pstack, x, *, periodic: bool,
                      shards: int):
        """Plain RHS of a grid cut into ``shards`` (module doc), shape
        ((B,) nvar, N)."""
        return from_shards(self.F_ext_impl(
            *self._shard_args(u, helpers, pstack, x, periodic, shards)))

    def J_bands_shards_impl(self, u, helpers, pstack, x, *, periodic: bool,
                            shards: int):
        """Plain banded J of a grid cut into ``shards`` (module doc), shape
        ((B,) W, nvar, nvar, N), the global edges folded when not
        periodic."""
        bands = self.J_bands_ext_impl(
            *self._shard_args(u, helpers, pstack, x, periodic, shards))
        bands = bands.movedim(-5, -2).flatten(-2).contiguous()
        if not periodic:
            fold_edges(bands, self.halo)
        return bands

    def _eval_args(self, u, helpers, pstack, x, periodic: bool):
        named = {}
        for i, name in enumerate(self.system.dep_vars):
            named[name] = u[..., i, :]
        for i, name in enumerate(self.system.help_funcs):
            named[name] = helpers[..., i, :]
        N = x.shape[-1]
        dx = (x[-1] - x[0]) / (N - 1)
        args = [x]
        for var, off in self._offset_args:
            args.append(shift(named[var], off, periodic))
        for i, _p in enumerate(self.system.pars):
            args.append(pstack[..., i, :])
        args.append(dx)
        return args, N

    def _row(self, value, x, shape):
        return torch.broadcast_to(_as_tensor_like(value, x).to(x.dtype),
                                  shape)

    def F_impl(self, u, helpers, pstack, x, *, periodic: bool):
        """Plain RHS of the dynamical system, shape ((B,) nvar, N)."""
        args, N = self._eval_args(u, helpers, pstack, x, periodic)
        shape = (*u.shape[:-2], N)
        return torch.stack([self._row(fn(*args), x, shape)
                            for fn in self._F_fns], dim=-2)

    def J_bands_impl(self, u, helpers, pstack, x, *, periodic: bool):
        """Plain banded Jacobian, shape ((B,) W, nvar, nvar, N),
        edge-folded when not periodic."""
        args, N = self._eval_args(u, helpers, pstack, x, periodic)
        nvar = self.system.nvar
        lead = u.shape[:-2]
        bands = torch.zeros((*lead, self.window, nvar, nvar, N),
                            dtype=x.dtype, device=x.device)
        for (m, n, k), fn in self._J_fns.items():
            bands[..., k, m, n, :] = self._row(fn(*args), x, (*lead, N))
        if not periodic:
            fold_edges(bands, self.halo)
        return bands

    # --------------------------------------------------- host-side helpers
    def as_tensor(self, value):
        if isinstance(value, torch.Tensor):
            return value.to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(np.asarray(value), dtype=self.dtype,
                               device=self.device)

    def _par_row(self, value, N):
        if isinstance(value, torch.Tensor) or np.ndim(value):
            return torch.broadcast_to(self.as_tensor(value), (N,))
        # a Python scalar fills on the device: no host-to-device copy,
        # which would stall the host until the device queue drained
        return torch.full((N,), float(value), dtype=self.dtype,
                          device=self.device)

    def pack_pars(self, pars: dict, x):
        """Scalar or per-node parameters broadcast to an (npar, N) stack."""
        N = x.shape[-1]
        rows = [self._par_row(pars[key], N) for key in self.system.pars]
        if not rows:
            return torch.zeros((0, N), dtype=self.dtype, device=self.device)
        return torch.stack(rows).contiguous()

    def split_fields(self, fields):
        """(u, helpers, x) tensors from a Fields container."""
        N = fields.size
        sysm = self.system

        def stack(names):
            if not names:
                return torch.zeros((0, N), dtype=self.dtype,
                                   device=self.device)
            return torch.stack([self.as_tensor(fields[k]) for k in names])

        return (stack(sysm.dep_vars), stack(sysm.help_funcs),
                self.as_tensor(fields["x"]))
