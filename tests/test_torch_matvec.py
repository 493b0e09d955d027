"""Kernel K7's plain version (the block-banded matvec) against the JAX
package and scipy, and the routing of the paths that run it, in float64 on
the CPU.

* ``banded_matvec_plain`` against the JAX package's ``ops/banded.py``
  ``banded_matvec`` (its XLA path on the CPU) and against a scipy CSC
  product of the same matrix (the oracle of ``tests/test_banded.py``), for
  one to three variables, band widths 3, 5 and 7, edge and periodic, to
  1e-13 of max|A v|;
* the member axis and a per-member scale against a loop over the members;
* the folded-layout TPU kernel ``ops/folded.py:matvec_folded`` (run in
  Pallas interpret mode) on the folded bands and vector, unfolded: the
  same function, which K7 computes in the node layout;
* routing: on a grid K6 admits, a ROW scheme with ``refine=`` and a Theta
  with ``solver=`` never reach K6 (nor does an ensemble with ``refine=``),
  and a fixed RODASPR step with ``refine=r`` calls K7 6 r times.

K7 itself runs only on the card: ``tests/test_torch_kernels.py`` (marked
``cuda``) and ``chip_smoke.py`` hold it against this plain version there.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import triflow_tpu_torch as tt
from triflow_tpu.ops import banded as banded_j
from triflow_tpu_torch.core import schemes as schemes_t
from triflow_tpu_torch.ops import matvec, megastep
from triflow_tpu_torch.parallel import Ensemble
from triflow_tpu_torch.utils.convert import ensemble_from_numpy, state_from_numpy

from .test_torch_theta import (KS, README, banded_index, dense_solver_torch,
                               ks_state, readme_state)

torch.set_num_threads(1)

#: (nvar, W, periodic) of the parity cases
SHAPES = [(nvar, W, periodic) for nvar in (1, 2, 3) for W in (3, 5, 7)
          for periodic in (True, False)]
N = 37
RTOL = 1e-13


def _ids(cases):
    return [f"nvar{n}-W{W}-{'periodic' if p else 'edge'}" for n, W, p in cases]


def _inputs(nvar, W, N, lead=(), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((*lead, W, nvar, nvar, N)),
            rng.standard_normal((*lead, nvar, N)))


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("nvar,W,periodic", SHAPES, ids=_ids(SHAPES))
def test_plain_matches_jax_banded_matvec(nvar, W, periodic):
    bands, v = _inputs(nvar, W, N)
    got = matvec.banded_matvec_plain(torch.tensor(bands), torch.tensor(v),
                                     periodic)
    want = banded_j.banded_matvec(bands, v, periodic)
    assert _rel(got.numpy(), want) <= RTOL


def csc_of(bands, periodic):
    """The banded matrix as scipy CSC, rows and columns in the node layout
    (variable-major: m * N + i)."""
    W, nvar, _, N = bands.shape
    rows, cols, flat = banded_index(W, nvar, N, periodic)
    return sps.csc_matrix((bands.reshape(-1)[flat], (rows, cols)),
                          (nvar * N, nvar * N))


@pytest.mark.parametrize("nvar,W,periodic", SHAPES, ids=_ids(SHAPES))
def test_plain_matches_scipy_csc(nvar, W, periodic):
    bands, v = _inputs(nvar, W, N, seed=1)
    got = matvec.banded_matvec_plain(torch.tensor(bands), torch.tensor(v),
                                     periodic, 0.25)
    want = 0.25 * (csc_of(bands, periodic) @ v.reshape(-1)).reshape(nvar, N)
    assert _rel(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "edge"])
def test_member_axis_and_scale_match_a_loop(periodic):
    B = 3
    bands, v = (torch.tensor(a) for a in _inputs(2, 5, N, (B,), seed=2))
    scales = torch.tensor([0.5, -1.25, 3.0])
    for scale in (0.75, scales):
        got = matvec.banded_matvec_plain(bands, v, periodic, scale)
        for b in range(B):
            sb = float(scale[b]) if isinstance(scale, torch.Tensor) else scale
            want = matvec.banded_matvec_plain(bands[b], v[b], periodic, sb)
            assert torch.equal(got[b], want)


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "edge"])
def test_plain_matches_matvec_folded(periodic, monkeypatch):
    """Row 4 of the TPU kernels: ``matvec_folded`` on the folded J and v of
    KS at N = 2048 (the folded plan needs 1024 supernodes), in interpret
    mode, unfolded, against K7's plain version on the node layout."""
    import jax.numpy as jnp
    from triflow_tpu.ops import folded

    monkeypatch.setenv("TRIFLOW_PALLAS_INTERPRET", "1")
    n = 2048
    model = tt.Model(*KS, device="cpu")
    fields_np, _ = ks_state(n)
    rng = np.random.default_rng(3)
    u = torch.tensor(fields_np["U"])[None]
    x = torch.tensor(fields_np["x"])
    bands = model.backend.J_bands(u, torch.zeros((0, n)), torch.zeros((0, n)),
                                  x, periodic=periodic)
    v = torch.tensor(rng.standard_normal((1, n)))
    sysm = model.system
    plan = folded.make_plan(n, sysm.nvar, sysm.halo, sysm.window)
    assert plan is not None
    out = folded.matvec_folded(folded.fold(jnp.asarray(bands.numpy()), plan),
                               folded.fold(jnp.asarray(v.numpy()), plan),
                               periodic, plan)
    want = np.asarray(folded.unfold(out, plan))
    got = matvec.banded_matvec_plain(bands, v, periodic).numpy()
    assert _rel(got, want) <= RTOL


# ----------------------------------------------------------------- routing

@pytest.fixture
def no_k6(monkeypatch):
    """Every K6 entry raises, and every K7 call is counted."""
    for name in ("step", "row_adaptive_step", "adaptive_scan", "theta_step",
                 "row_step", "theta_scan", "row_scan"):
        def refuse(*args, _name=name, **kw):
            raise AssertionError(f"megastep.{_name} reached")

        monkeypatch.setattr(megastep, name, refuse)
    calls = []
    plain = schemes_t.banded_matvec

    def counting(*args):
        calls.append(args[1].shape)
        return plain(*args)

    monkeypatch.setattr(schemes_t, "banded_matvec", counting)
    return calls


ROUTES = [
    ("rodaspr-refine1-fixed", lambda m: tt.schemes.RODASPR(
        m, time_stepping=False, tol=None, refine=1), 6),
    ("rodaspr-refine2-fixed", lambda m: tt.schemes.RODASPR(
        m, time_stepping=False, tol=None, refine=2), 12),
    ("rodaspr-refine1-adaptive", lambda m: tt.schemes.RODASPR(
        m, tol=1e-3, refine=1), None),
    ("theta-solver", lambda m: tt.schemes.Theta(m, solver=dense_solver_torch), 1),
    ("theta-solver-step-doubling", lambda m: tt.schemes.time_stepping(
        tt.schemes.Theta(m, solver=dense_solver_torch), tol=1e-2), None),
]


@pytest.mark.parametrize("name,make,k7_calls", ROUTES, ids=[r[0] for r in ROUTES])
def test_refine_and_solver_never_take_k6(no_k6, name, make, k7_calls):
    """The README grid, N = 200 in edge mode: K6's plan admits it, and
    neither the scheme nor ``device_fixed_scan`` takes it."""
    fields_np, pars = readme_state()
    model = tt.Model(*README, device="cpu")
    assert megastep.plan_for(200, 1, 1, False) is not None
    fields, pars_t = state_from_numpy(fields_np, pars, model)
    scheme = make(model)
    inner = getattr(scheme, "_inner", scheme)
    assert inner._mega_plan(200, False) is None
    assert inner.device_fixed_scan(200, periodic=False) is None
    t, out = scheme(0.0, fields, 1.0, pars_t)
    assert t == pytest.approx(1.0) and bool(torch.isfinite(out["U"]).all())
    if k7_calls is None:
        assert len(no_k6) > 0
    else:
        assert len(no_k6) == k7_calls


def test_refined_ensemble_takes_the_host_route(no_k6):
    """An ensemble on a grid K6 admits takes the host route with refine=,
    K7 with a member axis on every stage."""
    model = tt.Model(*KS, device="cpu")
    fields_np, _ = ks_state(256)
    u0 = np.stack([fields_np["U"], np.roll(fields_np["U"], 3)])
    ens = Ensemble(model, **ensemble_from_numpy(model, u0, fields_np["x"],
                                                dict(periodic=True)),
                   scheme=tt.schemes.RODASPR, time_stepping=False, tol=None,
                   refine=1)
    assert megastep.plan_for(256, 1, 2, True, 2) is not None
    assert ens.route == "host"
    ens.steps(2, 0.05)
    assert no_k6 == [(2, 1, 256)] * 12
