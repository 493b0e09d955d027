"""Hand one state to the port: numpy arrays in, the model's tensors out."""

from __future__ import annotations

import numpy as np


def state_from_numpy(fields, pars, model):
    """The port's ``(Fields, parameters)`` from a state given as numpy
    arrays: ``fields`` maps each coordinate and variable name to an array
    (for example ``np.asarray`` of each column of a ``triflow_tpu`` Fields)
    and ``pars`` is the parameter dict.  Arrays land on the model's device
    (the card, unless the model was built with ``device="cpu"``) and
    dtype; scalar parameters and the ``periodic`` flag stay Python values.

    On the CPU, as the parity tests run it::

        model = Model("k * dxxU", "U", "k", device="cpu")
        fields, pars = state_from_numpy({"x": x, "U": u}, {"k": 1.0}, model)
    """
    tensor = model.backend.as_tensor
    template = model.fields_template
    names = (*template.coords, *template.dependent_variables,
             *template.helper_functions)
    out_fields = template(
        **{k: tensor(np.asarray(fields[k])).clone() for k in names})
    out_pars = {}
    for key, value in dict(pars).items():
        arr = np.asarray(value)
        if key == "periodic":
            out_pars[key] = bool(value)
        elif arr.ndim == 0:
            out_pars[key] = float(arr)
        else:
            out_pars[key] = tensor(arr).clone()
    return out_fields, out_pars
