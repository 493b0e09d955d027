"""Fields container: named tensors holding the PDE unknowns.

Counterpart of ``triflow_tpu.core.fields`` on torch tensors, with its
surface: ``factory`` / ``factory1D`` templates (structural ``__eq__`` and
``__hash__``), item access, ``size``, ``uarray``, ``uflat`` (the node-major
interleaved flat copy), ``fill`` / ``filled`` / ``assign``, ``copy(deep=)``,
``copy.copy`` / ``copy.deepcopy``, pickling, and ``to_df`` / ``to_csv``.
``to_clipboard`` is left out: it needs a system clipboard, which a
headless machine with a card does not have.

JAX arrays are immutable, so the reference's hooks write ``fields["U"] =
fields["U"].at[0].set(1.0)``; here the tensors are mutable and the idiom is
the in-place ``fields["U"][0] = 1.0``.  Rebinding a name
(``fields["U"] = tensor``) works as well.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class FieldsTemplate:
    """Factory bound to a model's variable layout: the coordinate names and
    ``(name, dims)`` of every dependent variable and helper function;
    calling it with named arrays yields a :class:`Fields` instance.  Two
    templates of the same layout are equal and hash alike."""

    def __init__(self, coords, dependent_variables_info,
                 helper_functions_info):
        self.coords = tuple(coords)
        self.dependent_variables_info = tuple(
            (name, tuple(dims)) for name, dims in dependent_variables_info)
        self.helper_functions_info = tuple(
            (name, tuple(dims)) for name, dims in helper_functions_info)

    @property
    def dependent_variables(self):
        return [name for name, _ in self.dependent_variables_info]

    @property
    def helper_functions(self):
        return [name for name, _ in self.helper_functions_info]

    def __call__(self, **inputs) -> "Fields":
        return Fields(self, **inputs)

    def _layout(self):
        return (self.coords, self.dependent_variables_info,
                self.helper_functions_info)

    def __eq__(self, other):
        return (isinstance(other, FieldsTemplate)
                and self._layout() == other._layout())

    def __hash__(self):
        return hash(self._layout())


def factory(coords, dependent_variables, helper_functions) -> FieldsTemplate:
    """A template over the coordinates ``coords``, the variables and
    helpers given as ``(name, dims)`` pairs (n-D coordinates)."""
    return FieldsTemplate(coords, dependent_variables, helper_functions)


def factory1D(dependent_variables, helper_functions) -> FieldsTemplate:
    """A template over x, each variable and helper a function of x."""
    return FieldsTemplate(("x",),
                          [(name, ("x",)) for name in dependent_variables],
                          [(name, ("x",)) for name in helper_functions])


def _clone(value):
    if isinstance(value, torch.Tensor):
        return value.clone()
    return np.array(value) if isinstance(value, np.ndarray) else value


class Fields:
    """Mapping of coordinate and variable names to tensors, in the
    template's fixed order."""

    def __init__(self, template: FieldsTemplate, **inputs):
        self.template = template
        self._data: Dict[str, torch.Tensor] = {}
        for name in self.keys():
            if name not in inputs:
                kind = "coordinate" if name in template.coords else "variable"
                raise KeyError(f"missing {kind} '{name}'")
            self._data[name] = inputs[name]

    @classmethod
    def _of(cls, template, values):
        obj = cls.__new__(cls)
        obj.template = template
        obj._data = dict(zip(obj.keys(), values))
        return obj

    # -- mapping interface ---------------------------------------------------
    def keys(self):
        return [*self.template.coords, *self._var_names()]

    def _var_names(self):
        t = self.template
        return [name for name, _ in (t.dependent_variables_info
                                     + t.helper_functions_info)]

    @property
    def dependent_variables(self):
        return self.template.dependent_variables

    @property
    def helper_functions(self):
        return self.template.helper_functions

    def __getitem__(self, key):
        return self._data[key]

    def __setitem__(self, key, value):
        if key not in self._data:
            raise KeyError(
                f"unknown field '{key}' (template fields: {self.keys()})"
            )
        self._data[key] = value

    def __contains__(self, key):
        return key in self._data

    def __iter__(self):
        return iter(self.keys())

    def __repr__(self):
        lines = ["Fields:"]
        for key in self.keys():
            lines.append(f"  {key}: shape={tuple(np.shape(self._data[key]))}")
        return "\n".join(lines)

    # -- pickling: the tensors as numpy arrays, restored on their device -----
    def __reduce__(self):
        values = [self._data[k] for k in self.keys()]
        devices = [str(v.device) if isinstance(v, torch.Tensor) else None
                   for v in values]
        arrays = [v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v) for v in values]
        return _rebuild_fields, (self.template, arrays, devices)

    # -- numerics interface --------------------------------------------------
    @property
    def size(self) -> int:
        """Number of nodes along the primary coordinate."""
        return int(np.shape(self._data[self.template.coords[0]])[0])

    def _node_components(self, dims):
        """Per-node component count of a variable over ``dims``: the
        product of its non-primary coordinates' sizes (1 for a 1-D
        variable)."""
        comps = 1
        for dim in dims:
            if dim != self.template.coords[0]:
                comps *= int(np.shape(self._data[dim])[0])
        return comps

    def _tensor(self, name):
        value = self._data[name]
        return value if isinstance(value, torch.Tensor) \
            else torch.as_tensor(np.asarray(value))

    @property
    def uarray(self):
        """The dependent variables stacked as (nvar, N)."""
        return torch.stack([self._tensor(n) for n in self.dependent_variables])

    @property
    def uflat(self):
        """Interleaved flat copy of the dependent variables, ``[U0, V0, U1,
        V1, ...]``: node-major, as the reference's Fortran flatten."""
        N = self.size
        cols = [self._tensor(name).reshape(N, -1)
                for name, _ in self.template.dependent_variables_info]
        return torch.cat(cols, dim=1).reshape(-1)

    def fill(self, uflat):
        """Scatter a flat interleaved solver vector (``uflat``'s layout)
        back into the dependent variables, in place: each keeps its shape,
        and a tensor its device and dtype."""
        flat = uflat if isinstance(uflat, torch.Tensor) \
            else torch.as_tensor(np.asarray(uflat))
        rarray = flat.reshape(self.size, -1)
        ptr = 0
        for name, dims in self.template.dependent_variables_info:
            comps = self._node_components(dims)
            old = self._data[name]
            chunk = rarray[:, ptr:ptr + comps].reshape(np.shape(old))
            if isinstance(old, torch.Tensor):
                chunk = chunk.to(device=old.device, dtype=old.dtype)
            self._data[name] = chunk.clone()
            ptr += comps

    def filled(self, uflat) -> "Fields":
        """A new Fields with ``uflat`` scattered into the variables (the
        functional twin of :meth:`fill`)."""
        new = self.copy(deep=False)
        new.fill(uflat)
        return new

    def assign(self, **updates) -> "Fields":
        """A new Fields with the named arrays replaced."""
        new = self.copy(deep=False)
        for key, value in updates.items():
            new[key] = value
        return new

    def copy(self, deep: bool = True) -> "Fields":
        """A Fields of clones of every tensor, or with ``deep=False`` of
        the same tensors."""
        values = [self._data[k] for k in self.keys()]
        return Fields._of(self.template,
                          [_clone(v) for v in values] if deep else values)

    def __copy__(self):
        return self.copy(deep=False)

    def __deepcopy__(self, memo):
        return self.copy(deep=True)

    # -- export ----------------------------------------------------------------
    def to_df(self):
        """A pandas DataFrame of the variables indexed by x (1-D only)."""
        import pandas as pd

        if len(self.template.coords) > 1:
            raise ValueError("CSV files only available for 1D arrays")
        x_name = self.template.coords[0]
        data = {key: _numpy(self._data[key]) for key in self._var_names()}
        return pd.DataFrame(data, index=_numpy(self._data[x_name]))

    def to_csv(self, path):
        self.to_df().to_csv(path)


def _numpy(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _rebuild_fields(template, arrays, devices):
    return Fields._of(template, [
        np.asarray(a) if d is None else torch.from_numpy(np.array(a)).to(d)
        for a, d in zip(arrays, devices)])
