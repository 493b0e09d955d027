"""Kernel K1: the per-model stencil kernel for ``F`` and the banded ``J``.

The CUDA source is generated from the model's SymPy expressions (the
counterpart of the run-time code generation of the original triflow, which
compiled Theano graphs): each ``F_exprs`` entry and each ``J_band_exprs``
entry is printed as a C++ expression templated on the element type ``T``
and spliced into ``csrc/stencil.cu``.  The printer keeps every literal a
``T`` value, so the float instantiation never computes in double.

Replaces the TPU's ``ops/folded.py:eval_F_folded`` in its plain, its
``scale``/``bias`` mode (``scale * F(u) + bias``, the ROW stage right-hand
side) and its fused ``u_terms`` mode (``eval_F_terms``, entry
``K1.F_terms``: F at ``Σ a_j u_j`` plus ``Σ c_j u_j`` in one pass, which
the reference runs on its ensemble plans), and computes the same functions
as ``eval_J_folded`` and ``ops/pallas_stencil.py:eval_F`` /
``eval_J_bands``.  The plain versions are ``scale * TorchBackend.F_impl +
bias``, the same with the terms combined in the kernel's order, and
``TorchBackend.J_bands_impl``.

Every entry takes a leading member axis (an ensemble's B grids: u,
helpers, parameters, bias and the stage vectors ``(B, rows, N)``, x shared)
and a per-member F scale, a (B,) tensor on the card, beside the number.

``shards > 1`` (``parallel/spatial.py``: a grid cut into shards of N /
shards nodes, the reference's mesh devices) launches the ``*_shards``
entries (counted as ``K1.F_shards``, ``K1.F_terms_shards``,
``K1.J_shards``): each shard's halo read from its ring neighbours' edges in
the tile load, each shard's dx its own x[1] - x[0], as the reference's
``shard_map`` body computes F and J on its haloed shards.  Their plain
versions are that algorithm itself: ``TorchBackend.F_shards_impl`` /
``J_bands_shards_impl`` (``compiler.halo_extend``, the stencil on each
shard's interior, the global edges folded).
"""

from __future__ import annotations

import ctypes
import re

import sympy as sp
import torch
from sympy.printing.c import C99CodePrinter

from . import _build
from ._launch import Counter, check_cuda, check_shapes, shape_cache, stream_of, suffix
from .banded import per_member
from .thomas import beta_args, members

#: launches of the F, F_terms and J entries made by the wrappers below
F_LAUNCHES = Counter("K1.F")
F_TERMS_LAUNCHES = Counter("K1.F_terms")
J_LAUNCHES = Counter("K1.J")
F_SHARDS_LAUNCHES = Counter("K1.F_shards")
F_TERMS_SHARDS_LAUNCHES = Counter("K1.F_terms_shards")
J_SHARDS_LAUNCHES = Counter("K1.J_shards")

#: most stage vectors of one F_terms launch (kMaxTerms in csrc/stencil.cu):
#: u and RODASPR's five earlier stages, with room for one more
MAX_TERMS = 8
#: most members of one F or F_terms launch (the member runs along the
#: grid's y)
MAX_MEMBERS = 65535


class KernelPrinter(C99CodePrinter):
    """C++ printer for expressions evaluated in element type ``T``.

    Symbols print as entries ``a[i]`` of the argument vector; numbers as
    ``T(...)`` values; integer powers as products; ``Max``/``Min`` as
    ``fmax``/``fmin``; ``Heaviside(a, h0)`` as
    ``a > 0 ? 1 : (a < 0 ? 0 : h0)``."""

    def __init__(self, arg_index):
        super().__init__()
        self._arg_index = arg_index

    def _print_Symbol(self, expr):
        try:
            return f"a[{self._arg_index[expr]}]"
        except KeyError:
            raise ValueError(f"symbol {expr} is not a kernel argument") from None

    def _print_Integer(self, expr):
        return f"T({int(expr)})"

    def _print_Float(self, expr):
        return f"T({float(expr)!r})"

    def _print_Rational(self, expr):
        return f"(T({int(expr.p)}) / T({int(expr.q)}))"

    def _print_Half(self, expr):
        return self._print_Rational(expr)

    def _print_NumberSymbol(self, expr):
        return f"T({float(expr)!r})"

    _print_Pi = _print_NumberSymbol
    _print_Exp1 = _print_NumberSymbol

    def _print_Pow(self, expr):
        base = self._print(expr.base)
        exp = expr.exp
        if exp.is_Integer:
            n = int(exp)
            if n == 0:
                return "T(1)"
            prod = "*".join([f"({base})"] * abs(n))
            return f"({prod})" if n > 0 else f"(T(1) / ({prod}))"
        if exp == sp.S.Half:
            return f"sqrt({base})"
        if exp == -sp.S.Half:
            return f"(T(1) / sqrt({base}))"
        return f"pow({base}, {self._print(exp)})"

    def _minmax(self, fn, args):
        out = self._print(args[0])
        for arg in args[1:]:
            out = f"{fn}({out}, {self._print(arg)})"
        return out

    def _print_Max(self, expr):
        return self._minmax("fmax", expr.args)

    def _print_Min(self, expr):
        return self._minmax("fmin", expr.args)

    def _print_Heaviside(self, expr):
        a = self._print(expr.args[0])
        h0 = self._print(expr.args[1] if len(expr.args) > 1 else sp.S.Half)
        return f"(({a}) > T(0) ? T(1) : (({a}) < T(0) ? T(0) : {h0}))"

    def _print_sign(self, expr):
        a = self._print(expr.args[0])
        return f"(({a}) > T(0) ? T(1) : (({a}) < T(0) ? T(-1) : T(0)))"

    def _print_Abs(self, expr):
        return f"fabs({self._print(expr.args[0])})"


def generate_source(system, args_symbols, template="stencil.cu",
                    dtype=torch.float64, mixed=False, inverse_dx=False) -> str:
    """A per-model CUDA source: ``csrc/<template>`` (K1's ``stencil.cu``,
    K6's ``megastep.cu`` or K9's ``megatheta.cu``) with the constants and
    the expression bodies of ``system`` spliced in, and the entries of the
    model's ``dtype`` only (the one it computes in: half the build of
    both); ``mixed``: K6's mixed entry alone (float64).  ``inverse_dx``
    (K9's): the bodies take 1 / dx in dx's place, so that a stencil's
    divisions by powers of dx print as products, and ``TF_USES_X`` says
    whether they read x."""
    index = {s: i for i, s in enumerate(args_symbols)}
    F_exprs, J_exprs = list(system.F_exprs), dict(system.J_band_exprs)
    extra = []
    if inverse_dx:
        dx, idx = args_symbols[-1], sp.Symbol("inverse dx")
        index[idx] = index.pop(dx)
        F_exprs = [e.subs(dx, 1 / idx) for e in F_exprs]
        J_exprs = {k: e.subs(dx, 1 / idx) for k, e in J_exprs.items()}
        extra.append(f"#define TF_USES_X {int(uses_x(system, args_symbols))}")
    printer = KernelPrinter(index)
    nvar = system.nvar
    lines = [
        f"#define TF_F32 {int(dtype == torch.float32)}",
        f"#define TF_MIXED {int(mixed)}",
        f"#define TF_NVAR {nvar}",
        f"#define TF_NHELP {len(system.help_funcs)}",
        f"#define TF_NPAR {len(system.pars)}",
        f"#define TF_H {system.halo}",
        f"#define TF_NARGS {len(args_symbols)}",
        *extra,
        "template <typename T>",
        "__device__ __forceinline__ void tf_F(const T* a, T* f) {",
    ]
    for m, expr in enumerate(F_exprs):
        lines.append(f"  f[{m}] = {printer.doprint(expr)};")
    lines += ["}", "template <typename T>",
              "__device__ __forceinline__ void tf_J(const T* a, T* b) {"]
    for (m, n, k), expr in J_exprs.items():
        lines.append(f"  b[{(k * nvar + m) * nvar + n}] = {printer.doprint(expr)};")
    lines.append("}")
    text = (_build.CSRC / template).read_text()
    return text.replace("// @GENERATED@", "\n".join(lines))


def uses_x(system, args_symbols) -> bool:
    """Whether the model's F or J reads x (``TF_USES_X`` of K9's source)."""
    return any(args_symbols[0] in e.free_symbols
               for e in list(system.F_exprs) + list(system.J_band_exprs.values()))


#: a floating-point literal that does not sit directly inside ``T(...)``
#: (such a literal would be a double in the float instantiation)
BARE_LITERAL = re.compile(
    r"(?<![\w.])(?<!T\()(?<!T\(-)\d+(?:\.\d*(?:[eE][-+]?\d+)?|[eE][-+]?\d+)")


def library(system, args_symbols, template="stencil.cu",
            dtype=torch.float64, mixed=False) -> _build.Library:
    """The model's K1 library (or, with ``template="megastep.cu"``, its K6
    library; with ``mixed`` too, its library of K6's mixed entry; with
    ``template="megatheta.cu"``, its K9 library, whose bodies take 1 / dx)
    for ``dtype``, generated and built at its first launch."""
    name = template.split(".")[0] + ("_mixed" if mixed else "")
    return _build.Library(name, lambda: generate_source(
        system, args_symbols, template, dtype, mixed,
        inverse_dx=template == "megatheta.cu"))


def _kernel_inputs(backend, u, helpers, pstack, x):
    """(N, B, lead) of checked kernel inputs."""
    check_cuda((u, helpers, pstack, x), backend.dtype, "K1 stencil")
    sysm = backend.system
    N = x.shape[-1]
    B, lead = members(u, 2)
    check_shapes("K1 stencil", u=(u, (*lead, sysm.nvar, N)),
                 helpers=(helpers, (*lead, len(sysm.help_funcs), N)),
                 pstack=(pstack, (*lead, len(sysm.pars), N)), x=(x, (N,)))
    return N, B, lead


def _scaled(scale, out):
    if isinstance(scale, torch.Tensor):
        return per_member(scale, out.ndim) * out
    return out if scale == 1.0 else scale * out


def _F_rows(backend, u, helpers, pstack, x, periodic, shards):
    """The plain F of the whole grid, or of its shards."""
    if shards > 1:
        return backend.F_shards_impl(u, helpers, pstack, x, periodic=periodic,
                                     shards=shards)
    return backend.F_impl(u, helpers, pstack, x, periodic=periodic)


def eval_F_plain(backend, u, helpers, pstack, x, periodic, scale=1.0,
                 bias=None, shards=1):
    out = _scaled(scale, _F_rows(backend, u, helpers, pstack, x, periodic,
                                 shards))
    return out if bias is None else out + bias


def check_shards(what, N, shards):
    """Raise unless the grid's N nodes cut into ``shards`` shards of at
    least 2 nodes each (the kernels' own test); returns the shard size."""
    if shards < 1 or N % shards or N // shards < 2:
        raise ValueError(f"{what}: N = {N} does not cut into {shards} shards "
                         "of at least 2 nodes")
    return N // shards if shards > 1 else 0


def _F_entry(backend, u, helpers, pstack, x, bias, shards=1):
    """(bound C entry, N, B, shard size or 0) of the F entry (the shards'
    entry where ``shards > 1``) at these inputs' shapes, which it checks
    (and raises on)."""
    N, B, lead = _kernel_inputs(backend, u, helpers, pstack, x)
    if bias is not None:
        check_shapes("K1 stencil F", bias=(bias, (*lead, backend.system.nvar, N)))
    if B > MAX_MEMBERS:
        raise ValueError(f"K1 stencil F: {B} members; the kernel takes at most "
                         f"{MAX_MEMBERS}")
    Nl = check_shards("K1 stencil F", N, shards)
    if Nl:
        return (backend.stencil.fn(f"tf_stencil_F_shards_{suffix(u.dtype)}", 7, 4, 1),
                N, B, Nl)
    return backend.stencil.fn(f"tf_stencil_F_{suffix(u.dtype)}", 7, 3, 1), N, B, 0


def eval_F(backend, u, helpers, pstack, x, periodic, scale=1.0, bias=None,
           shards=1):
    """``scale * F(u) (+ bias)``, shape ((B,) nvar, N); ``bias`` is None
    or of u's shape, ``scale`` a number or a per-member (B,) tensor;
    ``shards > 1``: the grid cut into that many shards (module doc).  CPU
    tensors take the plain version; CUDA tensors launch K1's F entry.

    The launch path is short, since a step calls it once per stage: every
    call checks the tensors' device, dtype and contiguity, and the shapes
    are checked (and the entry bound) once per shape
    (``_launch.shape_cache``)."""
    if u.device.type == "cpu":
        return eval_F_plain(backend, u, helpers, pstack, x, periodic, scale,
                            bias, shards)
    check_cuda((u, helpers, pstack, x) if bias is None else
               (u, helpers, pstack, x, bias), backend.dtype, "K1 stencil F")
    fn, N, B, Nl = shape_cache(("F", backend, u.shape, helpers.shape, pstack.shape,
                                x.shape, None if bias is None else bias.shape, shards),
                               _F_entry, backend, u, helpers, pstack, x, bias, shards)
    scale_ptr, scale_val = beta_args(scale, B, u.dtype, u.device,
                                     "K1 stencil F scale")
    out = torch.empty_like(u)
    args = (u.data_ptr(), helpers.data_ptr(), pstack.data_ptr(), x.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), scale_ptr,
            N, B, 1 if periodic else 0)
    if Nl:
        rc = fn(*args, Nl, scale_val, stream_of(u))
    else:
        rc = fn(*args, scale_val, stream_of(u))
    if rc:
        backend.stencil.check(rc, "K1 stencil F")
    (F_SHARDS_LAUNCHES if Nl else F_LAUNCHES).add()
    return out


def eval_F_nodes(backend, u, helpers, pstack, x, periodic, scale=1.0,
                 bias=None):
    """``eval_F`` of CUDA tensors through the F entry of before the tiles
    (``tf_stencil_F_nodes_*``: one thread per node running K6's per-node
    body, which gathers from device memory): on no path and uncounted; the
    kernel checks hold the tiled entry to it bit for bit, and
    ``chip_smoke.py`` times the two side by side."""
    what = "K1 stencil F (per-node body)"
    check_cuda((u, helpers, pstack, x) if bias is None else
               (u, helpers, pstack, x, bias), backend.dtype, what)
    _, N, B, _ = _F_entry(backend, u, helpers, pstack, x, bias)
    scale_ptr, scale_val = beta_args(scale, B, u.dtype, u.device, f"{what} scale")
    out = torch.empty_like(u)
    fn = backend.stencil.fn(f"tf_stencil_F_nodes_{suffix(u.dtype)}", 7, 3, 1)
    rc = fn(u.data_ptr(), helpers.data_ptr(), pstack.data_ptr(), x.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), scale_ptr,
            N, B, 1 if periodic else 0, scale_val, stream_of(u))
    backend.stencil.check(rc, what)
    return out


def _lin(coefs, arrays):
    """``Σ c_j * arrays[j]`` in term order, a zero coefficient skipped and a
    unit one added unmultiplied (None when every coefficient is zero)."""
    acc = None
    for c, arr in zip(coefs, arrays):
        if c:
            t = arr if c == 1.0 else c * arr
            acc = t if acc is None else acc + t
    return acc


def eval_F_terms_plain(backend, terms, helpers, pstack, x, periodic, scale,
                       shards=1):
    arrays = [t[2] for t in terms]
    u = _lin([float(t[0]) for t in terms], arrays)
    if u is None:
        u = torch.zeros_like(arrays[0])
    out = _F_rows(backend, u, helpers, pstack, x, periodic, shards)
    out = (per_member(scale, out.ndim) if isinstance(scale, torch.Tensor)
           else scale) * out
    for c, arr in zip((float(t[1]) for t in terms), arrays):
        if c:
            out = out + (arr if c == 1.0 else c * arr)
    return out


def eval_F_terms(backend, terms, helpers, pstack, x, periodic, scale,
                 shards=1):
    """The fused ROW stage right-hand side ``scale * F(Σ a_j u_j) +
    Σ c_j u_j`` for ``terms = [(a_j, c_j, u_j), ...]`` (Python numbers;
    stage vectors of one shape ((B,) nvar, N)), in one pass over the stage
    vectors: the reference's ``eval_F_folded(..., u_terms=terms)``.  The
    bias terms are added one by one after the scaled F, in term order;
    ``shards > 1``: the grid cut into shards (module doc).  CPU tensors take
    the plain version; CUDA tensors launch K1's F_terms entry."""
    arrays = [t[2] for t in terms]
    u0 = arrays[0]
    if u0.device.type == "cpu":
        return eval_F_terms_plain(backend, terms, helpers, pstack, x,
                                  periodic, scale, shards)
    what = "K1 stencil F_terms"
    A = len(terms)
    if not 1 <= A <= MAX_TERMS:
        raise NotImplementedError(f"{what}: {A} terms; the kernel takes 1 to "
                                  f"{MAX_TERMS}")
    N, B, lead = _kernel_inputs(backend, u0, helpers, pstack, x)
    check_cuda(arrays, backend.dtype, what)
    check_shapes(what, **{f"terms[{k}]": (a, u0.shape)
                          for k, a in enumerate(arrays)})
    Nl = check_shards(what, N, shards)
    scale_ptr, scale_val = beta_args(scale, B, u0.dtype, u0.device,
                                     f"{what} scale")
    out = torch.empty_like(u0)
    in_ptrs = (ctypes.c_uint64 * A)(*(a.data_ptr() for a in arrays))
    coefs = (ctypes.c_double * (2 * A))(*(float(t[0]) for t in terms),
                                        *(float(t[1]) for t in terms))
    lib = backend.stencil
    args = (ctypes.addressof(in_ptrs), ctypes.addressof(coefs),
            helpers.data_ptr(), pstack.data_ptr(), x.data_ptr(), out.data_ptr(),
            scale_ptr, A, N, B, int(bool(periodic)))
    if Nl:
        fn = lib.fn(f"tf_stencil_F_terms_shards_{suffix(u0.dtype)}", 7, 5, 1)
        rc = fn(*args, Nl, scale_val, stream_of(u0))
    else:
        fn = lib.fn(f"tf_stencil_F_terms_{suffix(u0.dtype)}", 7, 4, 1)
        rc = fn(*args, scale_val, stream_of(u0))
    lib.check(rc, what)
    (F_TERMS_SHARDS_LAUNCHES if Nl else F_TERMS_LAUNCHES).add()
    return out


def _J_entry(backend, u, helpers, pstack, x, name="tf_stencil_J", shards=1):
    """(bound C entry ``name`` (the shards' entry where ``shards > 1``), N,
    B, bands' shape, shard size or 0) of the J entry at these inputs'
    shapes, which it checks (and raises on)."""
    N, B, lead = _kernel_inputs(backend, u, helpers, pstack, x)
    nvar = backend.system.nvar
    Nl = check_shards("K1 stencil J", N, shards)
    fn = (backend.stencil.fn(f"{name}_shards_{suffix(u.dtype)}", 5, 4) if Nl
          else backend.stencil.fn(f"{name}_{suffix(u.dtype)}", 5, 3))
    return fn, N, B, (*lead, backend.window, nvar, nvar, N), Nl


def eval_J_plain(backend, u, helpers, pstack, x, periodic, shards=1):
    if shards > 1:
        return backend.J_bands_shards_impl(u, helpers, pstack, x,
                                           periodic=periodic, shards=shards)
    return backend.J_bands_impl(u, helpers, pstack, x, periodic=periodic)


def eval_J(backend, u, helpers, pstack, x, periodic, shards=1):
    """Banded J, shape ((B,) W, nvar, nvar, N), edge-folded when not
    periodic; ``shards > 1``: the grid cut into that many shards (module
    doc).  CPU tensors take the plain version; CUDA tensors launch K1's J
    entry.

    The launch path is short, as F's: every call checks the tensors'
    device, dtype and contiguity, and the shapes are checked (and the
    entry bound) once per shape (``_launch.shape_cache``)."""
    if u.device.type == "cpu":
        return eval_J_plain(backend, u, helpers, pstack, x, periodic, shards)
    check_cuda((u, helpers, pstack, x), backend.dtype, "K1 stencil J")
    fn, N, B, shape, Nl = shape_cache(
        ("J", backend, u.shape, helpers.shape, pstack.shape, x.shape, shards),
        _J_entry, backend, u, helpers, pstack, x, "tf_stencil_J", shards)
    bands = torch.empty(shape, dtype=u.dtype, device=u.device)
    args = (u.data_ptr(), helpers.data_ptr(), pstack.data_ptr(), x.data_ptr(),
            bands.data_ptr(), N, B, 1 if periodic else 0)
    rc = fn(*args, Nl, stream_of(u)) if Nl else fn(*args, stream_of(u))
    if rc:
        backend.stencil.check(rc, "K1 stencil J")
    (J_SHARDS_LAUNCHES if Nl else J_LAUNCHES).add()
    return bands


def eval_J_nodes(backend, u, helpers, pstack, x, periodic):
    """``eval_J`` of CUDA tensors through the J entry of before the tiles
    (``tf_stencil_J_nodes_*``: one thread per node running K6's per-node
    body, which gathers from device memory): on no path and uncounted; the
    kernel checks hold the tiled entry to it bit for bit, and
    ``chip_smoke.py`` times the two side by side."""
    what = "K1 stencil J (per-node body)"
    check_cuda((u, helpers, pstack, x), backend.dtype, what)
    fn, N, B, shape, _ = _J_entry(backend, u, helpers, pstack, x, "tf_stencil_J_nodes")
    bands = torch.empty(shape, dtype=u.dtype, device=u.device)
    rc = fn(u.data_ptr(), helpers.data_ptr(), pstack.data_ptr(), x.data_ptr(),
            bands.data_ptr(), N, B, 1 if periodic else 0, stream_of(u))
    backend.stencil.check(rc, what)
    return bands
