"""The port stands apart from JAX: importing it loads no jax, and its copy
of the symbolic front-end discretizes exactly as the JAX package's."""

import subprocess
import sys
from pathlib import Path

import pytest

from triflow_tpu.core import symbolic as sym_jax
from triflow_tpu_torch.core import symbolic as sym_torch

from .test_torch_model import MODELS

ROOT = Path(__file__).resolve().parents[1]


def test_import_loads_no_jax():
    code = ("import sys, triflow_tpu_torch, triflow_tpu_torch.utils.convert; "
            "import triflow_tpu_torch.core.simulation; "
            "import triflow_tpu_torch.parallel.ensemble; "
            "import triflow_tpu_torch.parallel.spatial, "
            "triflow_tpu_torch.parallel.mesh; "
            "import triflow_tpu_torch.ops.matvec, triflow_tpu_torch.ops.mixed; "
            "import triflow_tpu_torch.plugins.container, "
            "triflow_tpu_torch.plugins.displays; "
            "import triflow_tpu_torch.utils.checkpoint, "
            "triflow_tpu_torch.utils.profiling; "
            "print('jax' in sys.modules, "
            "any(m.startswith('triflow_tpu.') or m == 'triflow_tpu' "
            "for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "False False"


@pytest.mark.parametrize("name", sorted(MODELS))
def test_symbolic_copy_matches_reference(name):
    eqs, dep, pars = MODELS[name]
    eqs = [eqs] if isinstance(eqs, str) else eqs
    dep = [dep] if isinstance(dep, str) else dep
    ref = sym_jax.build_discrete_system(eqs, dep, pars, [])
    port = sym_torch.build_discrete_system(eqs, dep, pars, [])
    assert port.F_exprs == ref.F_exprs
    assert port.J_band_exprs == ref.J_band_exprs
    assert port.bounds == ref.bounds
