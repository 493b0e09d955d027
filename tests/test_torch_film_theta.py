"""One fixed Theta step of the s = 6 falling film on the port against the
JAX package's, float64 on the CPU (``test_torch_film.py`` has the model,
the state and the reasoning)."""

import pytest

from .test_torch_film import check_one_fixed_step, models  # noqa: F401


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "edge"])
def test_one_theta_step_matches_jax(models, periodic):  # noqa: F811
    check_one_fixed_step(models, "Theta", periodic)
