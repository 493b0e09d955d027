"""Model: a 1D PDE system discretized in space and compiled to tensor
functions on one device.

Counterpart of ``triflow_tpu.core.model``:

>>> from triflow_tpu_torch import Model
>>> model = Model("k * dxxU", "U", "k", device="cpu")

The constructor takes the reference's parameters in the reference's order
(``Model(eqs, vars, pars, helps, bdcs, compiler=...)``), then the port's
own ``device``.  ``double=True`` computes in ``torch.float64``,
``double=False`` in ``torch.float32``.  ``double="df64"`` is the
reference's double-float precision mode, which the TPU carries as (hi, lo)
float32 pairs because it has no float64; Hopper has, so the port keeps the
mode's API (``precision == "df64"``, float64 host fields, float32 step
sizes, ``df64_mixed_solve=``) and computes it in native ``torch.float64``.
The model's tensors and kernels
live on ``device``, which is the card (``"cuda"``) unless the caller asks
for ``"cpu"``; asking for the card on a machine without one raises.

A model pickles as the reference's does (``save``, ``load``,
``__reduce__``): by its equation strings, rebuilt and compiled again with
the same ``double``, compiler name and device.  A custom callable compiler
cannot be pickled by name, so it is saved as ``"torch"``, the port's own
backend (the reference saves ``"jax"``, its own).
"""

from __future__ import annotations

from pickle import dump, load

import numpy as np
import sympy as sp
import torch

from . import fields as fields_mod
from .compiler import TorchBackend
from .routines import F_Routine, J_Routine
from .symbolic import build_discrete_system


def _coerce(arg):
    if arg is None:
        return tuple()
    if isinstance(arg, str):
        return (arg,)
    return tuple(arg)


#: the reference's compiler names.  Each is the port's ``TorchBackend``:
#: "numpy" on the CPU (the kernels' plain versions, what the reference's
#: NumpyBackend is to its JAX backend), the others on the model's device
COMPILERS = ("jax", "numpy", "theano", "torch")


def _reduce_model(eq_diffs, dep_vars, pars, help_functions, bdc_conditions,
                  compiler, double, device):
    return Model(eq_diffs, dep_vars, pars, help_functions, bdc_conditions,
                 compiler=compiler, double=double, device=device)


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested, but torch sees no "
                           "CUDA device")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"device {device}: the port runs on cpu or cuda")
    return device


class Model:
    """The finite-difference approximation of ``dtU = F(U)`` and its
    compiled routines.

    Parameters
    ----------
    differential_equations : str or iterable of str
    dependent_variables : str or iterable of str
    parameters : str or iterable of str, optional
        scalar or per-node (N,) parameters.
    help_functions : str or iterable of str, optional
        fields differenced in space but not evolved in time.
    bdc_conditions : str or iterable of str, optional
        parsed and discretized as the reference does, and not used by the
        backend (the reference's backends do not use them either):
        boundary conditions are hooks or the periodic flag.
    compiler : "torch" (the default), "jax", "theano", "numpy" or callable
        every name is the port's ``TorchBackend`` (``COMPILERS``), "numpy"
        on the CPU whatever ``device`` says; a callable ``compiler(model)``
        returns the backend.  Another name raises ``ValueError``.
    double : bool or "df64"
        float64 (True), float32 (False), or the df64 precision mode
        (native float64 state and kernels; the schemes round every step
        size to float32 and take ``df64_mixed_solve=``).
    hold_compilation : bool
        build the SymPy system only; ``compile(compiler)`` builds the
        backend later.
    device : str or torch.device
        "cuda" (the default, or "cuda:<index>") or "cpu", where every
        kernel takes its plain PyTorch version.
    simplify, fdiff_jac, high_order : as in the reference.

    Attributes
    ----------
    F : F_Routine, the interleaved flat RHS (host API).
    J : J_Routine, the scipy CSC Jacobian (host API).
    backend : TorchBackend with ``F`` -> (nvar, N) and ``J_bands`` ->
        (window, nvar, nvar, N).
    """

    def __init__(self, differential_equations, dependent_variables,
                 parameters=None, help_functions=None, bdc_conditions=None,
                 compiler="torch", simplify=False, fdiff_jac=False,
                 double=True, hold_compilation=False, high_order=False,
                 device="cuda"):
        if double not in (True, False, "df64"):
            raise NotImplementedError(
                f"double={double!r}: the port has float64 (True), float32 "
                "(False) and the df64 mode (\"df64\")")
        self._diff_eqs = _coerce(differential_equations)
        self._dep_vars = _coerce(dependent_variables)
        self._pars = _coerce(parameters)
        self._help_funcs = _coerce(help_functions)
        self._bdcs = _coerce(bdc_conditions)
        self._double = double
        self.device = torch.device(device)
        self.system = build_discrete_system(
            self._diff_eqs, self._dep_vars, self._pars, self._help_funcs,
            simplify=simplify, fdiff_jac=fdiff_jac, high_order=high_order)
        if self._bdcs:
            build_discrete_system(self._bdcs, self._dep_vars, self._pars,
                                  self._help_funcs, high_order=high_order)
        self.F_array = np.array(self.system.F_exprs, dtype=object)
        lo, hi = self.system.bounds
        nvar = len(self._dep_vars)
        self.J_array = np.array(
            [self.system.J_band_exprs.get((m, n, off - lo), sp.S.Zero)
             for off in range(lo, hi + 1) for n in range(nvar)
             for m in range(nvar)], dtype=object)
        if not hold_compilation:
            self.compile(compiler)

    def compile(self, compiler="torch"):
        """Build the backend and the host routines ``F`` and ``J``."""
        if callable(compiler):
            backend = compiler(self)
        elif compiler in COMPILERS:
            dtype = torch.float64 if self._double else torch.float32
            device = "cpu" if compiler == "numpy" else self.device
            backend = TorchBackend(self.system, dtype, resolve_device(device))
        else:
            raise ValueError(f"unknown compiler '{compiler}' (available: "
                             f"{sorted(COMPILERS)})")
        self.backend = backend
        self.device = backend.device
        self._compiler_name = compiler
        var_names = self._dep_vars + self._help_funcs
        self.F = F_Routine(self.F_array, var_names, self._pars, backend)
        self.J = J_Routine(self.J_array[self.J_array != 0], var_names,
                           self._pars, backend)

    @property
    def fields_template(self):
        return fields_mod.factory1D(self._dep_vars, self._help_funcs)

    @property
    def precision(self):
        """'df64' (the double-float mode, native float64 on the card),
        'f64' or 'f32'."""
        if self._double == "df64":
            return "df64"
        return "f64" if self._double else "f32"

    @property
    def halo(self):
        return self.system.halo

    @property
    def window(self):
        return self.system.window

    @property
    def dtype(self):
        return self.backend.dtype

    def save(self, filename):
        """Save the model as a binary pickle file."""
        with open(filename, "wb") as f:
            dump(self, f)

    @staticmethod
    def load(filename):
        """Load a saved model: rebuilt from its equation strings and
        compiled for its device (module doc)."""
        with open(filename, "rb") as f:
            return load(f)

    def __reduce__(self):
        compiler = getattr(self, "_compiler_name", "torch")
        if not isinstance(compiler, str):
            compiler = "torch"
        return (_reduce_model,
                (self._diff_eqs, self._dep_vars, self._pars, self._help_funcs,
                 self._bdcs, compiler, self._double, str(self.device)))

    def __repr__(self):
        return "\n".join([
            *self._diff_eqs, "",
            "Variables", "---------",
            f"unknowns:       {', '.join(self._dep_vars)}",
            f"helpers:        {', '.join(self._help_funcs) or None}",
            f"parameters:     {', '.join(self._pars) or None}",
            f"device:         {self.device} ({self.precision})",
        ])
