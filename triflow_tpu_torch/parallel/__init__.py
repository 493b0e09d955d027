"""Parallel drivers of the port: ensembles of one model on one card."""

from .ensemble import Ensemble, stack_parameters  # noqa: F401

__all__ = ["Ensemble", "stack_parameters"]
