"""Parallel drivers of the port: ensembles of one model, and grids cut into
shards over a mesh (one card's shards; ROADMAP A9b for meshes across
cards)."""

from .ensemble import Ensemble, stack_parameters  # noqa: F401
from .mesh import Mesh  # noqa: F401
from .spatial import SpatialModel  # noqa: F401

__all__ = ["Ensemble", "stack_parameters", "Mesh", "SpatialModel"]
