"""Fields container: named tensors holding the PDE unknowns.

Counterpart of ``triflow_tpu.core.fields`` on torch tensors.  JAX arrays
are immutable, so the reference's hooks write ``fields["U"] =
fields["U"].at[0].set(1.0)``; here the tensors are mutable and the idiom is
the in-place ``fields["U"][0] = 1.0``.  Rebinding a name
(``fields["U"] = tensor``) works as well.
"""

from __future__ import annotations

from typing import Dict

import torch


class FieldsTemplate:
    """Factory bound to a model's variable layout; calling it with named
    arrays yields a :class:`Fields` instance."""

    def __init__(self, coords, dependent_variables, helper_functions):
        self.coords = tuple(coords)
        self.dependent_variables = list(dependent_variables)
        self.helper_functions = list(helper_functions)

    def __call__(self, **inputs) -> "Fields":
        return Fields(self, **inputs)


def factory1D(dependent_variables, helper_functions) -> FieldsTemplate:
    return FieldsTemplate(("x",), dependent_variables, helper_functions)


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

    def keys(self):
        t = self.template
        return [*t.coords, *t.dependent_variables, *t.helper_functions]

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
            lines.append(f"  {key}: shape={tuple(self._data[key].shape)}")
        return "\n".join(lines)

    @property
    def size(self) -> int:
        """Number of nodes along the primary coordinate."""
        return int(self._data[self.template.coords[0]].shape[0])

    def copy(self) -> "Fields":
        """A Fields of clones of every tensor."""
        return Fields(self.template,
                      **{k: v.clone() for k, v in self._data.items()})
