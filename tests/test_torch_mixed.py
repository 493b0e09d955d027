"""Kernel K8 (the residual of the df64 mode's mixed-precision stage solve)
and K6's mixed entry (the whole mixed-precision step in one launch): their
plain versions against the JAX package's df64 pieces, float64 on the CPU,
from inputs made with numpy from a seed and handed to the reference as
double-float (hi, lo) pairs and to the port as their exact float64 values
(``utils.convert.state_from_df``).

* K8's plain version ``mixed_residual_plain`` against the reference's
  residual ``(rhs - k) + coef * banded_matvec_df(J, k)`` on DF operands,
  rounded as ``r.hi + r.lo`` to float32 (what the reference's float32
  preconditioner solves), for one to three variables, band widths 3, 5
  and 7, N = 7, 64 and 1000, edge and periodic, one grid and B = 4
  members, coef a number and one per member; and against the folded TPU
  kernel ``ops/folded.py:matvec_df_folded`` (Pallas interpret mode) at
  one small folded plan.  The limit, per entry: one float32 ulp of |r|
  plus 1e-13 of ``|coef| sum |a| |k| + |rhs| + |k|``.  The DF product
  carries about 2^-48 of its terms and the port's float64 one 2^-53, so
  where the residual cancels far below its terms the two float32
  roundings may sit on either side of a rounding boundary: the terms, not
  |r|, bound what they can disagree by (the lesson of K7's check).
* K6's mixed entry's plain version (``megastep.step_mixed`` on the CPU)
  against the reference's single-launch df64 step ``row_step_df_folded``
  / ``theta_step_df_folded`` (B15, Pallas interpret mode: its value-level
  body ``_row_step_values_df`` uses the TPU's ``roll`` and runs only
  inside a kernel) and against the reference's node-layout mixed
  pipeline (``device_fixed_step`` of a df64 scheme with
  ``df64_mixed_solve=n``, run eagerly), on KS at N = 64 (dt = 0.0625,
  exact in float32; the port's plan closes the ring block-cyclic) and
  N = 200 (Woodbury), ROS3PRw and RODASPR with 1 and 2 residual passes,
  and Theta (theta = 1) on ``k * dxxU - U * dxU``; each also against the
  reference's float64 step.  Limit 1e-12 absolute (the states are of
  size 1; the reference's own class is 1e-13), except the reference's
  node-layout Theta: it solves for the new state itself (``A u2 = dt F -
  theta dt J u + u``, not the increment ``A d = dt F`` of its
  single-launch step and of the port), so its one pass leaves the
  preconditioner's residue on |u2| ~ 1 and it lies 1.8e-12 from its own
  float64 step at N = 200; the port, 1.2e-13 from that float64 step, is
  held to the reference's df64 Theta limit there (1e-11,
  ``tests/test_precision.py:446``).
* The mixed entry's ``nsteps = 3`` equals three single steps.

K8 and the mixed entry run only on the card: ``tests/test_torch_kernels.py``
(marked ``cuda``) and ``chip_smoke.py`` hold them against these plain
versions there.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import triflow_tpu as tj
import triflow_tpu_torch as tt
from triflow_tpu.ops import folded
from triflow_tpu.ops import megastep as megastep_j
from triflow_tpu.ops.banded_df import banded_matvec_df
from triflow_tpu.ops.df64 import DF, from_scalar
from triflow_tpu_torch.ops import matvec, megastep, mixed
from triflow_tpu_torch.utils.convert import state_from_df, state_from_numpy

from .test_torch_theta import KS

torch.set_num_threads(1)

SHAPES = [(nvar, W, periodic) for nvar in (1, 2, 3) for W in (3, 5, 7)
          for periodic in (True, False)]
B = 4
TOL_TERMS = 1e-13


def _ids(cases):
    return [f"nvar{n}-W{W}-{'periodic' if p else 'edge'}" for n, W, p in cases]


def _df(rng, shape):
    return DF.from_float64(rng.standard_normal(shape))


def _f64(a):
    """The float64 value of a DF pair, as a torch tensor."""
    return torch.tensor(state_from_df(a.hi, a.lo))


def _coef(value, lead):
    """(DF coef broadcasting against (lead, nvar, N), its exact float64
    value for the port: a number or a (B,) tensor)."""
    if not lead:
        hi, lo = from_scalar(value)
        return DF.wrap(jnp.float32(hi), jnp.float32(lo)), float(hi) + float(lo)
    c = DF.from_float64(np.asarray(value).reshape(-1, 1, 1))
    return c, torch.tensor(state_from_df(c.hi, c.lo).reshape(-1))


def _reference_r32(bands, k, rhs, coef, periodic):
    """The reference's residual, rounded as its preconditioner takes it."""
    r = (rhs - k) + coef * banded_matvec_df(bands, k, periodic)
    return torch.tensor(np.asarray(r.hi + r.lo, np.float32))


def _assert_residual(got, want, bands, k, rhs, coef, periodic):
    """Each entry within one float32 ulp of |r| plus TOL_TERMS of its
    terms (module doc)."""
    c = coef.abs() if isinstance(coef, torch.Tensor) else abs(coef)
    terms = (matvec.banded_matvec_plain(bands.abs(), k.abs(), periodic, c)
             + rhs.abs() + k.abs())
    ulp = torch.tensor(np.spacing(np.abs(want.numpy())))
    gap = (got.double() - want.double()).abs()
    limit = ulp.double() + TOL_TERMS * terms
    assert got.dtype == torch.float32
    assert bool((gap <= limit).all()), float((gap / limit).max())


@pytest.mark.parametrize("nvar,W,periodic", SHAPES, ids=_ids(SHAPES))
def test_residual_plain_matches_banded_matvec_df(nvar, W, periodic):
    rng = np.random.default_rng(nvar * 100 + W)
    for N in (7, 64, 1000):
        for lead in ((), (B,)):
            bands = _df(rng, (*lead, W, nvar, nvar, N))
            k, rhs = _df(rng, (*lead, nvar, N)), _df(rng, (*lead, nvar, N))
            values = [0.3125 + 0.1 * rng.standard_normal()]
            if lead:
                values.append(rng.standard_normal(B))
            for value in values:
                coef_df, coef = _coef(value, lead)
                want = _reference_r32(bands, k, rhs, coef_df, periodic)
                b64, k64, rhs64 = _f64(bands), _f64(k), _f64(rhs)
                got = mixed.mixed_residual(b64, k64, rhs64, coef, periodic)
                _assert_residual(got, want, b64, k64, rhs64, coef, periodic)


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "edge"])
def test_residual_plain_matches_matvec_df_folded(periodic, monkeypatch):
    """Row 5 of the TPU kernels: ``matvec_df_folded`` on the folded DF
    bands of KS's J and a DF vector at N = 256 (the reference test's
    folded plan), in interpret mode, unfolded, and the reference's
    residual around it, against K8's plain version on the node layout."""
    monkeypatch.setenv("TRIFLOW_PALLAS_INTERPRET", "1")
    N = 256
    model = tj.Model(*KS, double="df64")
    plan = folded.plan_for_backend(model.backend, N)
    assert plan is not None
    rng = np.random.RandomState(0)
    x = np.arange(N, dtype=np.float64) * 0.5
    u = DF.from_float64((np.cos(0.1 * x) + 0.05 * rng.randn(N))[None])
    zeros = DF.from_float64(np.zeros((0, N)))
    bands = model.backend.J_bands_df64(u, zeros, zeros, DF.from_float64(x),
                                       periodic=periodic)
    k = DF.from_float64(rng.randn(1, N))
    rhs = DF.from_float64(rng.randn(1, N))
    coef_df, coef = _coef(0.0625 * 0.25, ())

    def fold(a):
        return DF.wrap(folded.fold(a.hi, plan), folded.fold(a.lo, plan))

    jk_f = folded.matvec_df_folded(fold(bands), fold(k), periodic, plan)
    jk = DF.wrap(folded.unfold(jk_f.hi, plan), folded.unfold(jk_f.lo, plan))
    r = (rhs - k) + coef_df * jk
    want = torch.tensor(np.asarray(r.hi + r.lo, np.float32))
    b64, k64, rhs64 = _f64(bands), _f64(k), _f64(rhs)
    got = mixed.mixed_residual(b64, k64, rhs64, coef, periodic)
    _assert_residual(got, want, b64, k64, rhs64, coef, periodic)


# ------------------------------------------------------ the mixed entry

def ks64_state(N):
    """The reference's df64 tests' KS state (tests/test_precision.py)."""
    x = np.arange(N, dtype=np.float64) * 0.5
    rng = np.random.RandomState(0)
    u0 = np.cos(2 * np.pi * np.arange(N) / N * 3) + 0.1 * rng.randn(N)
    return {"x": x, "U": u0}, dict(periodic=True)


THETA_EQS = ("k * dxxU - U * dxU", "U", "k")
#: the models of the mixed-entry cases, by name (the reference steps are
#: cached by it)
EQS = {"ks": KS, "theta": THETA_EQS}


def theta_state(N):
    """The reference's df64 Theta state (tests/test_precision.py:446)."""
    x = np.linspace(0, 10, N, endpoint=False)
    return {"x": x, "U": np.cos(2 * np.pi * x / 10)}, dict(periodic=True,
                                                           k=0.5)


def _jax_state(fields_np, pars, model_j):
    """(u, helpers, pstack, x) of the reference as DF pairs."""
    N = len(fields_np["x"])
    names = model_j._pars
    pstack = np.stack([np.full(N, float(pars[p])) for p in names]) if names \
        else np.zeros((0, N))
    return (DF.from_float64(fields_np["U"][None]),
            DF.from_float64(np.zeros((0, N))), DF.from_float64(pstack),
            DF.from_float64(fields_np["x"]))


def _jax_scheme(name, model, **kw):
    if name == "theta":
        return tj.schemes.Theta(model, theta=1.0, **kw)
    return getattr(tj.schemes, name)(model, time_stepping=False, tol=None,
                                     **kw)


def _port_scheme(name, model, **kw):
    if name == "theta":
        return tt.schemes.Theta(model, theta=1.0, **kw)
    return getattr(tt.schemes, name)(model, time_stepping=False, tol=None,
                                     **kw)


@functools.lru_cache(maxsize=None)
def _reference_step(name, model_name, state_fn, N, dt, double, passes):
    """One step of the reference: its node-layout mixed pipeline (df64
    with ``df64_mixed_solve=passes``, eager) or its float64 step."""
    fields_np, pars = state_fn(N)
    model = tj.Model(*EQS[model_name], double=double)
    kw = dict(df64_mixed_solve=passes) if double == "df64" else {}
    fixed = _jax_scheme(name, model, **kw).device_fixed_step(periodic=True)
    if double == "df64":
        u, h, p, x = _jax_state(fields_np, pars, model)
        return fixed(jnp.float32(0.0), u, h, p, x, jnp.float32(dt))[0] \
            .to_float64()[0]
    x = jnp.asarray(fields_np["x"])
    p = model.backend.pack_pars(pars, x)
    u = jnp.asarray(fields_np["U"][None])
    return np.asarray(fixed(0.0, u, jnp.zeros((0, N)), p, x,
                            jnp.float64(dt))[0][0])


def _port_step(name, model_name, state, dt, passes):
    fields_np, pars = state
    model = tt.Model(*EQS[model_name], double="df64", device="cpu")
    fields, pars_t = state_from_numpy(fields_np, pars, model)
    scheme = _port_scheme(name, model, df64_mixed_solve=passes)
    N = len(fields_np["x"])
    assert scheme._mixed_plan(N, True) is not None
    return scheme(0.0, fields, dt, pars_t)[1]["U"].numpy()


#: (scheme, model, state of N, N, dt, residual passes, limit against the
#: reference's df64 step; module doc): the port's plan at N = 64 closes the
#: ring block-cyclic, at N = 200 through the Woodbury correction
PIPELINE_CASES = [
    ("RODASPR", "ks", ks64_state, 64, 0.0625, 1, 1e-12),
    ("RODASPR", "ks", ks64_state, 200, 0.0625, 2, 1e-12),
    ("ROS3PRw", "ks", ks64_state, 64, 0.0625, 2, 1e-12),
    ("theta", "theta", theta_state, 200, 0.25, 1, 1e-11),
]


@pytest.mark.parametrize("name,model_name,state_fn,N,dt,passes,limit",
                         PIPELINE_CASES, ids=[f"{c[0]}-N{c[3]}-mixed{c[5]}"
                                              for c in PIPELINE_CASES])
def test_mixed_entry_matches_reference_pipeline(name, model_name, state_fn, N,
                                                dt, passes, limit):
    got = _port_step(name, model_name, state_fn(N), dt, passes)
    df = _reference_step(name, model_name, state_fn, N, dt, "df64", passes)
    f64 = _reference_step(name, model_name, state_fn, N, dt, True, passes)
    assert np.abs(got - df).max() <= limit
    assert np.abs(got - f64).max() <= 1e-12


def _fold_df(a, plan):
    return DF.wrap(folded.fold(a.hi, plan), folded.fold(a.lo, plan))


@pytest.mark.parametrize("name", ["ROS3PRw", "theta"])
def test_mixed_entry_matches_b15(name, monkeypatch):
    """The reference's single-launch df64 step (B15) at N = 64, one
    residual pass, in interpret mode, against the port's mixed entry."""
    monkeypatch.setenv("TRIFLOW_PALLAS_INTERPRET", "1")
    N = 64
    model_name, state_fn, dt = (("ks", ks64_state, 0.0625) if name != "theta"
                                else ("theta", theta_state, 0.25))
    fields_np, pars = state_fn(N)
    model = tj.Model(*EQS[model_name], double="df64")
    be = model.backend
    u, h, p, x = _jax_state(fields_np, pars, model)
    dx = (x[..., -1] - x[..., 0]) / DF(jnp.float32(N - 1))
    if name == "theta":
        plan = megastep_j.df64_small_plan_for(be, N, 1)
        out, _ = megastep_j.theta_step_df_folded(
            be, plan, 1.0, True, _fold_df(u, plan), _fold_df(h, plan),
            _fold_df(p, plan), _fold_df(x, plan), dx, jnp.float32(dt), 1)
    else:
        scheme = _jax_scheme(name, model, df64_mixed_solve=1)
        tables = scheme._tables[:3] + (None,) + scheme._tables[4:]
        plan = megastep_j.df64_small_plan_for(be, N, scheme._s)
        out, _ = megastep_j.row_step_df_folded(
            be, plan, tables, scheme._s, True, _fold_df(u, plan),
            _fold_df(h, plan), _fold_df(p, plan), _fold_df(x, plan), dx,
            jnp.float32(dt), 1)
    want = state_from_df(folded.unfold(out.hi, plan),
                         folded.unfold(out.lo, plan))[0]
    got = _port_step(name, model_name, (fields_np, pars), dt, 1)
    assert np.abs(got - want).max() <= 1e-12
    f64 = _reference_step(name, model_name, state_fn, N, dt, True, 1)
    assert np.abs(got - f64).max() <= 1e-12


def test_mixed_entry_nsteps_equals_single_steps():
    """``step_mixed(nsteps=3)`` is three single steps (on the card the
    kernel's one launch is held to three launches bit for bit)."""
    fields_np, pars = ks64_state(200)
    model = tt.Model(*KS, double="df64", device="cpu")
    fields, pars_t = state_from_numpy(fields_np, pars, model)
    scheme = tt.schemes.RODASPR(model, time_stepping=False, tol=None,
                                df64_mixed_solve=1)
    u, helpers, x = model.backend.split_fields(fields)
    pstack = model.backend.pack_pars(pars_t, x)
    plan = scheme._mixed_plan(200, True)
    table = scheme._table(False)
    three = megastep.row_step_mixed(model.backend, plan, table, True, u,
                                    helpers, pstack, x, 0.0625, 1, nsteps=3)[0]
    one = u
    for _ in range(3):
        one = megastep.row_step_mixed(model.backend, plan, table, True, one,
                                      helpers, pstack, x, 0.0625, 1)[0]
    assert torch.equal(three, one)
