"""Checkpoint and resume of a running simulation or ensemble: one HDF5
file holding the restartable state, written atomically (a temporary file
renamed into place).

Counterpart of ``triflow_tpu.utils.checkpoint``, with its layout, so a
file written by either package is read by the other.  A Simulation's
file has the attributes ``t``, ``i``, ``dt``, ``tmax`` (NaN for None),
``id``, ``internal_dt`` (where the scheme carries one) and ``parameters``
(JSON), and a group ``fields`` with one dataset per field.  An Ensemble's
has ``kind = "ensemble"``, ``t``, ``id``, ``parameters`` (JSON, one dict
per member), the datasets ``u``, ``helpers`` and ``x``, and where an
adaptive scheme carries one the dataset ``internal_dt`` (one value, or
one per member) with the attribute ``internal_dt_scalar``.

``checkpoint_state`` and ``simulation_from_state`` are the state a
Simulation's file holds and its rebuild, apart from the file itself.
Arrays are written as the numpy arrays of the tensors: a df64 model's
state is native float64 in the port, so its value is stored exactly (the
reference stores its double-float pairs as hi + lo, the same float64
value).  Nothing else is stored: a ``compensated`` run resumes from a zero
Kahan carry, as the reference's does.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from .convert import host_array


def _json_parameters(parameters):
    return {k: (host_array(v).tolist() if hasattr(v, "shape") else v)
            for k, v in parameters.items()}


def _parameters_from_json(parameters):
    return {k: (np.asarray(v) if isinstance(v, list) else v)
            for k, v in parameters.items()}


def _write_atomically(path, write):
    import h5py

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with h5py.File(tmp, "w") as f:
        write(f)
    os.replace(tmp, path)
    return path


def checkpoint_state(simulation):
    """The restartable state of a Simulation, as the checkpoint file holds
    it: ``(attrs, fields)``, two dicts of numbers and numpy arrays."""
    attrs = {
        "t": float(simulation.t),
        "i": int(simulation.i),
        "dt": float(simulation.user_dt),
        "tmax": (float(simulation.tmax) if simulation.tmax is not None
                 else np.nan),
        "id": simulation.id,
        "parameters": json.dumps(_json_parameters(simulation.parameters)),
    }
    internal_dt = getattr(simulation._scheme, "_internal_dt", None)
    if internal_dt is not None:
        attrs["internal_dt"] = float(internal_dt)
    fields = {key: host_array(simulation.fields[key])
              for key in simulation.fields.keys()}
    return attrs, fields


def simulation_from_state(attrs, fields, model, **simulation_kwargs):
    """A Simulation rebuilt from ``checkpoint_state``'s ``(attrs,
    fields)``: extra kwargs (hook, scheme, tol, ...) are forwarded to the
    constructor; tmax and id default to the saved values, and the scheme
    resumes from the saved internal dt."""
    from ..core.simulation import Simulation

    tmax = float(attrs["tmax"])
    simulation_kwargs.setdefault("tmax", None if np.isnan(tmax) else tmax)
    simulation_kwargs.setdefault("id", str(attrs["id"]))
    simul = Simulation(model, dict(fields),
                       _parameters_from_json(json.loads(attrs["parameters"])),
                       dt=float(attrs["dt"]), t=float(attrs["t"]),
                       **simulation_kwargs)
    simul.i = int(attrs["i"])
    internal_dt = attrs.get("internal_dt")
    if internal_dt is not None and hasattr(simul._scheme, "_internal_dt"):
        simul._scheme._internal_dt = float(internal_dt)
    return simul


def save_checkpoint(path, simulation):
    """Write a restartable snapshot of a Simulation."""
    attrs, fields = checkpoint_state(simulation)

    def write(f):
        for key, value in attrs.items():
            f.attrs[key] = value
        g = f.create_group("fields")
        for key, value in fields.items():
            g.create_dataset(key, data=value)

    return _write_atomically(path, write)


def load_checkpoint(path, model, **simulation_kwargs):
    """Rebuild a Simulation from a checkpoint file (``simulation_from_state``
    on the file's attributes and fields)."""
    import h5py

    with h5py.File(path, "r") as f:
        attrs = dict(f.attrs)
        fields = {k: f["fields"][k][...] for k in f["fields"]}
    return simulation_from_state(attrs, fields, model, **simulation_kwargs)


def save_ensemble_checkpoint(path, ensemble):
    """Write a restartable snapshot of an Ensemble: t, the member states,
    helpers and grid, the shared or per-member internal dt and the member
    parameter sets."""

    def write(f):
        f.attrs["kind"] = "ensemble"
        f.attrs["t"] = float(ensemble.t)
        f.attrs["id"] = ensemble.id
        f.attrs["parameters"] = json.dumps(
            [_json_parameters(p) for p in ensemble._parameter_sets])
        idt = ensemble._internal_dt
        if idt is not None:
            f.create_dataset("internal_dt",
                             data=np.atleast_1d(np.asarray(idt, np.float64)))
            f.attrs["internal_dt_scalar"] = not np.ndim(idt)
        f.create_dataset("u", data=host_array(ensemble.u))
        f.create_dataset("helpers", data=host_array(ensemble.helpers))
        f.create_dataset("x", data=host_array(ensemble.x))

    return _write_atomically(path, write)


def load_ensemble_checkpoint(path, model, **ensemble_kwargs):
    """Rebuild an Ensemble from a checkpoint file.

    Extra kwargs (scheme, tol, per_member_dt, ...) are forwarded to the
    Ensemble constructor; t, the member states and the adaptive internal
    dt resume from the checkpointed values."""
    import h5py

    from ..parallel.ensemble import Ensemble

    with h5py.File(path, "r") as f:
        t = float(f.attrs["t"])
        ens_id = str(f.attrs["id"])
        parameter_sets = json.loads(f.attrs["parameters"])
        u = f["u"][...]
        helpers = f["helpers"][...]
        x = f["x"][...]
        idt = f["internal_dt"][...] if "internal_dt" in f else None
        idt_scalar = bool(f.attrs.get("internal_dt_scalar", True))

    tensor = model.backend.as_tensor
    parameter_sets = [
        {k: (tensor(np.asarray(v)) if isinstance(v, list) else v)
         for k, v in p.items()}
        for p in parameter_sets]
    ens = Ensemble(model, tensor(u), parameter_sets, tensor(x),
                   helpers0=tensor(helpers), **ensemble_kwargs)
    ens.t = t
    ens.id = ens_id
    if idt is not None:
        ens._internal_dt = float(idt[0]) if idt_scalar else idt
    return ens
