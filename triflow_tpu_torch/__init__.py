"""triflow_tpu_torch: the PyTorch and CUDA port of triflow-tpu.

Automatic finite-difference discretization of 1D PDE systems with implicit
and explicit temporal schemes, on torch tensors.  The hot path runs
hand-written CUDA kernels for NVIDIA Hopper (``csrc/``), built with nvcc at
first use; CPU tensors take the kernels' plain PyTorch versions.  The JAX
package ``triflow_tpu`` is the reference this package is tested against.
"""

import logging

from . import parallel  # noqa: F401
from .core import schemes  # noqa: F401
from .core.fields import Fields, factory, factory1D  # noqa: F401
from .core.model import Model  # noqa: F401
from .core.simulation import Simulation  # noqa: F401
from .plugins.container import Container  # noqa: F401
from .plugins.displays import Display  # noqa: F401

logging.getLogger(__name__).addHandler(logging.NullHandler())

retrieve_container = Container.retrieve
display_fields = Display.display_fields
display_probe = Display.display_probe

__all__ = ["Model", "Simulation", "schemes", "Container", "Display",
           "Fields", "factory", "factory1D", "retrieve_container",
           "display_fields", "display_probe", "parallel"]
