"""Hand a state to the port: numpy arrays in, the model's tensors out, and
back: a tensor's numpy array for the host (containers, checkpoints,
displays, scipy)."""

from __future__ import annotations

import numpy as np
import torch


def host_array(value):
    """A numpy array of ``value``: a tensor through ``.detach().cpu()
    .numpy()`` (from any device), anything else through ``np.asarray``."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


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


def state_from_df(hi, lo):
    """The float64 value ``hi + lo`` of a double-float pair (the JAX
    package's df64 state: ``DF.hi`` and ``DF.lo``, float32 arrays), as a
    numpy float64 array: both components widen exactly and their sum is
    exact in float64 (``|lo| <= ulp(hi) / 2``), so a ``double="df64"``
    model of the port starts from the reference's state unchanged."""
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def ensemble_from_numpy(model, u0, x, parameter_sets, helpers0=None):
    """The inputs of the port's ``parallel.Ensemble`` from numpy arrays, as
    keyword arguments: ``u0`` (B, nvar, N) (or (B, N) for one variable),
    ``x`` (N,), ``parameter_sets`` (one dict for every member, or a list of
    B dicts of numbers and (N,) arrays) and ``helpers0`` (B, nhelp, N) or
    None.  Arrays land on the model's device (the card, unless the model
    was built with ``device="cpu"``) and dtype; numbers and the
    ``periodic`` flag stay Python values.

    On the CPU, as the parity tests run it::

        model = Model("k * dxxU", "U", "k", device="cpu")
        ens = Ensemble(model, **ensemble_from_numpy(
            model, u0, x, [{"k": k, "periodic": True} for k in ks]))
    """
    tensor = model.backend.as_tensor

    def pars(p):
        out = {}
        for key, value in dict(p).items():
            arr = np.asarray(value)
            if key == "periodic":
                out[key] = bool(value)
            elif arr.ndim == 0:
                out[key] = float(arr)
            else:
                out[key] = tensor(arr).clone()
        return out

    sets = (pars(parameter_sets) if isinstance(parameter_sets, dict)
            else [pars(p) for p in parameter_sets])
    return dict(u0=tensor(np.asarray(u0)).clone(),
                x=tensor(np.asarray(x)).clone(), parameter_sets=sets,
                helpers0=None if helpers0 is None
                else tensor(np.asarray(helpers0)).clone())
