"""Streaming persistence container: a stream sink that buffers ``nbuffer``
snapshots and flushes them to HDF5 chunks (``data_<uuid>.h5``), with a
YAML metadata sidecar, retrieve and merge operations, and an in-memory
mode when ``path=None``.

Counterpart of ``triflow_tpu.plugins.container``, with its on-disk layout:
each chunk holds the dataset ``t``, the groups ``coords`` and
``data_vars`` (time-major arrays per variable) and the JSON ``metadata``
attribute; ``metadata.yml`` sits beside the chunks, and the end-of-run
merge writes ``data.h5``.  A container written by either package is read
by the other.  Tensors become numpy arrays (``.detach().cpu().numpy()``)
as a frame is taken, so a frame holds host memory only.

``TimeSeries`` is a small self-contained time-major dataset;
``TimeSeries.from_ensemble_state`` takes an ``Ensemble``'s frame with a
``member`` axis, so a persisted sweep retrieves as ``data[var] -> (T, B,
N)``.
"""

from __future__ import annotations

import json
import logging
import shutil
import warnings
from collections import deque, namedtuple
from pathlib import Path
from uuid import uuid1

import numpy as np

from ..utils.convert import host_array
from ..utils.streams import collect

logger = logging.getLogger(__name__)
logger.addHandler(logging.NullHandler())

FieldsData = namedtuple("FieldsData", ["data", "metadata"])


class AttrDict(dict):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.__dict__ = self


def coerce_attr(key, value):
    """Clamp a metadata value to a plain scalar (bool/int/float/str) so it
    serializes into the YAML/HDF5 sidecars; numpy scalars and anything with
    a sensible numeric/string conversion are narrowed, everything else is a
    TypeError."""
    if isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, np.generic):
        return value.item()
    for narrow in (int, float, str):
        try:
            coerced = narrow(value)
        except (TypeError, ValueError):
            continue
        logger.debug("metadata %r: %s narrowed to %s", key, type(value),
                     narrow)
        return coerced
    raise TypeError(
        f"metadata {key!r} has unserializable type {type(value)} "
        "(no int/float/str conversion)"
    )


class TimeSeries:
    """Minimal time-major dataset: per-variable arrays of shape (T, ...) plus
    coordinates (t of shape (T,), x of shape (N,), ...)."""

    def __init__(self, t, coords, data_vars, attrs=None):
        self.t = np.atleast_1d(np.asarray(t))
        self.coords = {k: np.asarray(v) for k, v in coords.items()}
        self.data_vars = {k: np.asarray(v) for k, v in data_vars.items()}
        self.attrs = dict(attrs or {})

    # -- selection -----------------------------------------------------------
    def isel(self, t=None, **ignored):
        if t is None:
            return self
        if isinstance(t, int):
            t = [t] if t != -1 else [len(self.t) - 1]
            squeeze = True
        else:
            squeeze = False
        tidx = np.arange(len(self.t))[t] if isinstance(t, slice) else np.asarray(t)
        tidx = np.atleast_1d(tidx)
        sub = TimeSeries(
            self.t[tidx],
            self.coords,
            {k: v[tidx] for k, v in self.data_vars.items()},
            self.attrs,
        )
        if squeeze:
            sub = TimeSeries(
                sub.t,
                sub.coords,
                {k: v[0] for k, v in sub.data_vars.items()},
                sub.attrs,
            )
        return sub

    def __getitem__(self, key):
        if key == "t":
            return self.t
        if key in self.coords:
            return self.coords[key]
        return self.data_vars[key]

    def keys(self):
        return ["t", *self.coords.keys(), *self.data_vars.keys()]

    def __repr__(self):
        lines = [f"TimeSeries: {len(self.t)} snapshots"]
        for k, v in self.coords.items():
            lines.append(f"  coord {k}: {v.shape}")
        for k, v in self.data_vars.items():
            lines.append(f"  var   {k}: {v.shape}")
        return "\n".join(lines)

    def equals(self, other):
        if sorted(self.keys()) != sorted(other.keys()):
            return False
        if not np.array_equal(self.t, other.t):
            return False
        return all(
            np.array_equal(self[k], other[k]) for k in self.keys()
        )

    def load(self):
        return self

    # -- (de)serialization -----------------------------------------------------
    def to_hdf5(self, path):
        import h5py

        with h5py.File(path, "w") as f:
            f.create_dataset("t", data=self.t)
            g = f.create_group("coords")
            for k, v in self.coords.items():
                g.create_dataset(k, data=v)
            g = f.create_group("data_vars")
            for k, v in self.data_vars.items():
                g.create_dataset(k, data=v)
            f.attrs["metadata"] = json.dumps(
                {k: coerce_attr(k, v) for k, v in self.attrs.items()}
            )

    @staticmethod
    def from_hdf5(path):
        import h5py

        with h5py.File(path, "r") as f:
            t = f["t"][...]
            coords = {k: f["coords"][k][...] for k in f["coords"]}
            data_vars = {k: f["data_vars"][k][...] for k in f["data_vars"]}
            attrs = json.loads(f.attrs.get("metadata", "{}"))
        return TimeSeries(t, coords, data_vars, attrs)

    @staticmethod
    def concat(series):
        series = [s for s in series if s is not None]
        if not series:
            return None
        order = np.argsort([s.t[0] for s in series])
        series = [series[i] for i in order]
        t = np.concatenate([s.t for s in series])
        data_vars = {
            k: np.concatenate([s.data_vars[k] for s in series])
            for k in series[0].data_vars
        }
        return TimeSeries(t, series[0].coords, data_vars, series[0].attrs)

    @staticmethod
    def from_state(t, fields, metadata=None):
        """Snapshot a Fields container at time t (one-frame TimeSeries)."""
        coords = {c: host_array(fields[c]) for c in fields.template.coords}
        data_vars = {}
        for name, _dims in (
            fields.template.dependent_variables_info
            + fields.template.helper_functions_info
        ):
            data_vars[name] = host_array(fields[name])[None]
        return TimeSeries([t], coords, data_vars, metadata)

    @staticmethod
    def from_ensemble_state(t, ensemble, metadata=None):
        """Snapshot an Ensemble at time t (one-frame TimeSeries): every
        dependent variable is stored as (1, B, N) under a ``member``
        coordinate, so a persisted parameter sweep retrieves as
        ``data[var] -> (T, B, N)``: the whole sweep in one container."""
        system = ensemble.model.backend.system
        coords = {
            "member": np.arange(ensemble.B),
            "x": host_array(ensemble.x),
        }
        u = host_array(ensemble.u)              # (B, nvar, N)
        data_vars = {
            name: u[:, idx][None]
            for idx, name in enumerate(system.dep_vars)
        }
        helpers = host_array(ensemble.helpers)  # (B, nhelp, N)
        for idx, name in enumerate(system.help_funcs):
            data_vars[str(name)] = helpers[:, idx][None]
        return TimeSeries([t], coords, data_vars, metadata)

    def to_xarray(self):
        """xarray.Dataset view of the series (requires xarray)."""
        try:
            import xarray as xr
        except ImportError as err:  # pragma: no cover - env without xarray
            raise ImportError(
                "TimeSeries.to_xarray requires the optional xarray "
                "dependency"
            ) from err
        spatial = [c for c in self.coords if c != "t"]
        data = {
            k: (("t", *spatial) if v.ndim > len(spatial) else tuple(spatial),
                v)
            for k, v in self.data_vars.items()
        }
        coords = {"t": self.t, **self.coords}
        return xr.Dataset(data, coords=coords, attrs=self.attrs)


class LazyTimeSeries:
    """Deferred-read view over on-disk HDF5 chunks: the tiny t/coords axes
    load eagerly (they index the selection), but variable data stays on
    disk until selected: ``isel`` reads only the requested time rows from
    the owning chunk files (h5py partial reads), and ``load()``/indexing
    materializes the full series."""

    def __init__(self, paths):
        import h5py

        entries = []
        for p in paths:
            with h5py.File(p, "r") as f:
                entries.append((float(f["t"][0]), Path(p)))
        entries.sort()
        self._paths = [p for _t0, p in entries]
        ts, self._spans = [], []
        offset = 0
        for p in self._paths:
            with h5py.File(p, "r") as f:
                t = f["t"][...]
            ts.append(t)
            self._spans.append((offset, offset + len(t)))
            offset += len(t)
        self.t = np.concatenate(ts) if ts else np.zeros(0)
        with h5py.File(self._paths[0], "r") as f:
            self.coords = {k: f["coords"][k][...] for k in f["coords"]}
            self.attrs = json.loads(f.attrs.get("metadata", "{}"))
            self._var_names = list(f["data_vars"])

    def keys(self):
        return ["t", *self.coords.keys(), *self._var_names]

    def _read_rows(self, rows):
        """Gather global time rows from the chunk files (partial reads)."""
        import h5py

        rows = np.asarray(rows)
        out = {k: [None] * len(rows) for k in self._var_names}
        for p, (lo, hi) in zip(self._paths, self._spans):
            sel = np.where((rows >= lo) & (rows < hi))[0]
            if not len(sel):
                continue
            local = rows[sel] - lo
            # h5py fancy selection requires strictly increasing unique
            # indices: read each distinct row once, then scatter it to
            # every output position that requested it (repeats allowed)
            uniq, inverse = np.unique(local, return_inverse=True)
            with h5py.File(p, "r") as f:
                for k in self._var_names:
                    block = f["data_vars"][k][uniq]
                    for j, i_out in enumerate(sel):
                        out[k][i_out] = block[inverse[j]]
        return {k: np.stack(v) for k, v in out.items()}

    def isel(self, t=None, **ignored):
        if t is None:
            return self
        squeeze = isinstance(t, int)
        if squeeze:
            t = [t if t != -1 else len(self.t) - 1]
        rows = np.arange(len(self.t))[t] if isinstance(t, slice) \
            else np.atleast_1d(np.asarray(t))
        rows = np.where(rows < 0, rows + len(self.t), rows)
        data_vars = self._read_rows(rows)
        if squeeze:
            data_vars = {k: v[0] for k, v in data_vars.items()}
        return TimeSeries(self.t[rows], self.coords, data_vars, self.attrs)

    def load(self):
        return self.isel(t=slice(None))

    def __getitem__(self, key):
        if key == "t":
            return self.t
        if key in self.coords:
            return self.coords[key]
        return self.load()[key]

    def __repr__(self):
        return (f"LazyTimeSeries: {len(self.t)} snapshots on disk over "
                f"{len(self._paths)} chunk file(s)")


class Container:
    """Stream-fed persistence sink (module doc)."""

    def __init__(self, path=None, mode="a", *, save="all", metadata={},
                 force=False, nbuffer=50):
        self._nbuffer = nbuffer
        self._mode = mode
        self._metadata = dict(metadata)
        self.save = save
        self._cached_data = deque([], self._n_save)
        self._collector = None
        self.path = path = Path(path).absolute() if path else None

        if not path:
            return

        if self._mode == "w" and path.exists():
            if not force:
                raise FileExistsError(
                    f"container directory {path} already exists "
                    "(pass force=True to replace it)"
                )
            shutil.rmtree(path)
        if self._mode == "r" and not path.exists():
            raise FileNotFoundError(f"no container at {path}")
        path.mkdir(parents=True, exist_ok=True)
        self._write_metadata()

    def _write_metadata(self, filename="metadata.yml"):
        import yaml

        with open(self.path / filename, "w") as yaml_file:
            yaml.dump(
                {k: coerce_attr(k, v) for k, v in self._metadata.items()},
                yaml_file,
                default_flow_style=False,
            )

    @property
    def save(self):
        return "last" if self._n_save else "all"

    @save.setter
    def save(self, value):
        modes = {"all": None, "last": 1, -1: 1}
        try:
            self._n_save = modes[value]
        except (KeyError, TypeError):
            raise ValueError(
                f"save mode must be 'all', 'last' or -1, got {value!r}"
            ) from None

    # ------------------------------------------------------------- streaming
    def connect(self, stream, snapshot=None):
        """Wire the container into a simulation stream.

        ``snapshot`` maps an emitted object to a one-frame TimeSeries; the
        default snapshots a Simulation's ``(t, fields)``.  Ensembles pass
        ``TimeSeries.from_ensemble_state`` so every frame carries the
        member axis."""
        if snapshot is None:
            def snapshot(simul):
                return TimeSeries.from_state(simul.t, simul.fields,
                                             self._metadata)

        def expand(emitted):
            frame = snapshot(emitted)
            self._cached_data.append(frame)
            return frame

        accumulation_stream = stream.map(expand)
        self._collector = collect(accumulation_stream)
        if self.save == "all":
            self._collector.map(TimeSeries.concat).sink(self._write)
        else:
            self._collector.map(
                lambda frames: frames[-1] if frames else None
            ).sink(self._write)

        accumulation_stream.partition(self._nbuffer).sink(self._collector.flush)
        return self._collector

    def flush(self):
        if self._collector:
            self._collector.flush()

    def _write(self, concatenated):
        if concatenated is not None and self.path:
            target_file = self.path / ("data_%i.h5" % uuid1())
            concatenated.to_hdf5(target_file)
            self._cached_data = deque([], self._n_save)
            if self.save == "last":
                for f in self.path.glob("data_*.h5"):
                    if f != target_file:
                        f.unlink()

    def __repr__(self):
        return "path:   {path}\n{data}".format(path=self.path, data=self.data)

    def __del__(self):
        try:
            self.flush()
        except Exception:  # interpreter shutdown
            pass

    # ------------------------------------------------------------------ data
    @property
    def data(self):
        try:
            if self.path:
                merged = self.path / "data.h5"
                chunks = sorted(self.path.glob("data_*.h5"))
                series = []
                if merged.exists():
                    series.append(TimeSeries.from_hdf5(merged))
                series += [TimeSeries.from_hdf5(f) for f in chunks]
                return TimeSeries.concat(series)
            return TimeSeries.concat(list(self._cached_data))
        except OSError:
            return None

    @property
    def metadata(self):
        try:
            if self.path:
                import yaml

                with open(self.path / "metadata.yml", "r") as yaml_file:
                    return yaml.safe_load(yaml_file)
            return self._metadata
        except OSError:
            return None

    @metadata.setter
    def metadata(self, parameters):
        if self._mode == "r":
            return
        for key, value in parameters.items():
            self._metadata[key] = value
        if self.path:
            self._write_metadata("info.yml")

    # --------------------------------------------------------------- retrieve
    @staticmethod
    def retrieve(path, isel="all", lazy=False):
        """Load a saved container.

        isel: 'all', 'last', an int/slice/list over the t axis, or a dict
        with a 't' key.

        lazy: defer variable reads to access time (LazyTimeSeries) — with a
        non-'all' isel only the selected time rows are ever read from
        disk."""
        path = Path(path)
        merged = path / "data.h5"
        if merged.exists():
            files = [merged]
        else:
            files = sorted(path.glob("data_*.h5"))
            if not files:
                raise FileNotFoundError("no data files in %s" % path)
        if lazy:
            data = LazyTimeSeries(files)
        elif len(files) == 1:
            data = TimeSeries.from_hdf5(files[0])
        else:
            data = TimeSeries.concat([TimeSeries.from_hdf5(f) for f in files])

        try:
            import yaml

            with open(path / "metadata.yml", "r") as yaml_file:
                metadata = yaml.safe_load(yaml_file)
        except FileNotFoundError:
            # retro-compatibility: legacy json sidecar
            legacy = sorted(path.glob("Treant.*.json"))
            if not legacy:
                raise
            with open(legacy[0]) as f:
                metadata = json.load(f)["categories"]

        if isel == "last":
            data = data.isel(t=-1)
        elif isel == "all":
            pass
        elif isinstance(isel, dict):
            data = data.isel(**isel)
        else:
            data = data.isel(t=isel)

        return FieldsData(data=data, metadata=AttrDict(**(metadata or {})))

    @staticmethod
    def get_last(path):
        warnings.warn(
            "get_last method is deprecated, use retrieve(path, 'last')",
            DeprecationWarning,
        )
        return Container.retrieve(path, isel=[-1], lazy=False)

    @staticmethod
    def get_all(path):
        warnings.warn(
            "get_all method is deprecated, use retrieve(path)",
            DeprecationWarning,
        )
        return Container.retrieve(path, isel="all", lazy=False)

    # ------------------------------------------------------------------ merge
    def merge(self, override=True):
        if self.path:
            return Container.merge_datafiles(self.path, override=override)

    @staticmethod
    def merge_datafiles(path, override=False):
        """Merge data_*.h5 chunks into one data.h5 with verify-then-delete."""
        path = Path(path)
        merged = path / "data.h5"
        if merged.exists() and not override:
            raise FileExistsError(merged)
        if merged.exists():
            merged.unlink()

        chunks = sorted(path.glob("data_*.h5"))
        split_data = TimeSeries.concat([TimeSeries.from_hdf5(f) for f in chunks])
        if split_data is None:
            return None
        split_data.to_hdf5(merged)
        merged_data = TimeSeries.from_hdf5(merged)

        if not split_data.equals(merged_data):
            merged.unlink()
            raise IOError("Unable to merge data")

        for f in chunks:
            f.unlink()
        return merged
