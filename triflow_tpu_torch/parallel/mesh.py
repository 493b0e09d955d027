"""A mesh of devices with named axes, as the reference reads one from
``jax.sharding.Mesh``.

``Mesh(devices, axis_names)``: ``devices`` is an array (numpy, or nested
lists) of ``torch.device`` values (or their names), whose shape gives the
axis sizes; ``shape`` maps each axis name to its size, as
``mesh.shape[axis]`` is read by ``parallel/spatial.py`` and
``parallel/ensemble.py``.

Every entry of a mesh is one device in this port: the shards of a grid
(and an ensemble's member groups) are views of one tensor on one card, as
the reference's tests lay 8 virtual CPU devices out in one process.  A mesh
of distinct devices, one process per card under ``torch.distributed``, is
ROADMAP item A9b, and raises.
"""

from __future__ import annotations

import numpy as np
import torch


def _device(d):
    """A torch.device with the index a bare "cuda" means (0)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", 0)
    return d


class Mesh:
    """Named axes over an array of devices (module doc)."""

    def __init__(self, devices, axis_names):
        grid = np.empty(np.shape(devices), dtype=object)
        flat = np.asarray(devices, dtype=object).reshape(-1)
        grid.reshape(-1)[:] = [torch.device(d) for d in flat]
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a mesh of {grid.ndim} axes needs {grid.ndim} "
                             f"axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names repeat: {axis_names}")
        if grid.size == 0:
            raise ValueError("a mesh needs at least one device")
        distinct = {_device(d) for d in grid.reshape(-1)}
        if len(distinct) > 1:
            raise NotImplementedError(
                f"a mesh of distinct devices ({sorted(map(str, distinct))}): "
                "the port's mesh is one device's shards; meshes across cards "
                "(torch.distributed, one process per card) are ROADMAP A9b")
        self.devices = grid
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, grid.shape))
        #: the one device every entry names
        self.device = grid.reshape(-1)[0]

    @classmethod
    def on(cls, device, shape, axis_names):
        """A mesh of ``shape`` whose every entry is ``device``."""
        shape = (shape,) if np.ndim(shape) == 0 else tuple(shape)
        grid = np.empty(shape, dtype=object)
        grid.reshape(-1)[:] = [torch.device(device)] * grid.size
        return cls(grid, axis_names)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def check_device(self, device, what="the model"):
        """Raise ValueError unless the mesh's device is ``device``."""
        if _device(self.device) != _device(device):
            raise ValueError(f"the mesh lies on {self.device}, {what} on "
                             f"{torch.device(device)}")

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"
