"""The df64 precision mode (``Model(double="df64")``) on the port, against
the JAX package, float64 on the CPU.  The port computes the mode in native
float64 (the reference carries it as (hi, lo) float32 pairs because the
TPU has no float64); its step sizes are float32 values, as the
reference's, and ``df64_mixed_solve=n`` is the reference's mixed solve (a
float32 factor, n residual passes against the float64 operator: K8, or
K6's mixed entry on small grids).

* the 40-step KS RODASPR trajectory of ``tests/test_precision.py:178``
  (N = 96, dt = 0.0625, exact in float32) with the full solver and with
  ``df64_mixed_solve=1``, within 1e-11 of the reference's df64 run with
  the same solver and of its float64 run (the reference's own measured
  class is 1e-13);
* Theta's df64 step (``tests/test_precision.py:446``), full and mixed,
  within the reference's 1e-11 of its df64 and float64 steps;
* each of the above on both routes of the port: K6 (its float64 step, or
  its mixed entry), which these grids take, and, in the
  ``..._multi_launch`` twins, the multi-launch path (K1-K5, or K1, the
  float32 factor and solves and K8), with every K6 plan withheld;
* routing, counted by the entry each path calls: a mixed step on a grid
  the mixed gate admits is one call of K6's mixed entry and
  ``device_fixed_scan(n)`` one for n steps; above the gate a RODASPR step
  calls K8 stages x passes times and K6 not at all;
  ``df64_mixed_solve=0`` takes the float64 route and no K8; ``refine=1``
  on a df64 model calls K7 once per stage and never K6;
* ``df64_mixed_solve=`` on a float64 model runs and changes nothing (the
  reference ignores it off the df64 mode);
* what stays refused (other modes) raises; ``compensated=`` is taken and
  ignored on a df64 model, as in the reference, and a df64 ensemble
  builds (``tests/test_torch_df64_ensemble.py``);
* the state of a reference df64 run hands over exactly
  (``state_from_df``), and a hook sees and sets float64 values.

``Simulation``, the Dirichlet hook and the adaptive controller in the df64
mode: ``tests/test_torch_df64_sim.py``.  K8 and K6's mixed entry against
the reference's B14 and B15: ``tests/test_torch_mixed.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import triflow_tpu as tj
import triflow_tpu_torch as tt
from triflow_tpu.ops.df64 import DF
from triflow_tpu_torch.core import schemes as schemes_t
from triflow_tpu_torch.ops import megastep, mixed
from triflow_tpu_torch.parallel import Ensemble
from triflow_tpu_torch.utils.convert import (ensemble_from_numpy,
                                             state_from_df, state_from_numpy)

from .test_torch_mixed import EQS, ks64_state, theta_state

torch.set_num_threads(1)

STEPS, N_KS, DT_KS = 40, 96, 0.0625
N_THETA, DT_THETA = 128, 0.25


@pytest.fixture
def multi_launch(monkeypatch):
    """Withhold every K6 plan (the float64 step's and the mixed entry's):
    the schemes take the multi-launch path, and the test fails if anything
    still reaches K6."""
    monkeypatch.setattr(megastep, "plan_for", lambda *args: None)
    monkeypatch.setattr(megastep, "mixed_plan_for", lambda *args: None)
    reached = []
    for name in ("step", "step_mixed", "row_adaptive_step"):
        def refuse(*args, _name=name, **kw):
            reached.append(_name)
            raise AssertionError(f"megastep.{_name} reached with its plan "
                                 "withheld")

        monkeypatch.setattr(megastep, name, refuse)
    yield
    assert not reached


def _jax_inputs(model_name, state_fn, N, double):
    fields_np, pars = state_fn(N)
    model = tj.Model(*EQS[model_name], double=double)
    names = model._pars
    pstack = (np.stack([np.full(N, float(pars[p])) for p in names]) if names
              else np.zeros((0, N)))
    arrays = (fields_np["U"][None], np.zeros((0, N)), pstack, fields_np["x"])
    if double == "df64":
        return model, tuple(DF.from_float64(a) for a in arrays)
    return model, tuple(jnp.asarray(a) for a in arrays)


@functools.lru_cache(maxsize=None)
def _jax_run(name, model_name, state_fn, N, dt, steps, double, passes):
    """The reference's fixed-step run (jitted, as tests/test_precision.py
    runs it): u after ``steps`` steps, float64."""
    model, (u, h, p, x) = _jax_inputs(model_name, state_fn, N, double)
    kw = dict(df64_mixed_solve=passes) if double == "df64" else {}
    if name == "theta":
        scheme = tj.schemes.Theta(model, theta=1.0, **kw)
    else:
        scheme = getattr(tj.schemes, name)(model, time_stepping=False,
                                           tol=None, **kw)
    fixed = scheme.device_fixed_step(periodic=True)
    T = jnp.float32 if double == "df64" else jnp.float64
    step = jax.jit(lambda t, u: fixed(t, u, h, p, x, T(dt))[0])
    for i in range(steps):
        u = step(T(i * dt), u)
    return u.to_float64()[0] if double == "df64" else np.asarray(u[0])


def _port_model(model_name, state_fn, N, double="df64"):
    fields_np, pars = state_fn(N)
    model = tt.Model(*EQS[model_name], double=double, device="cpu")
    fields, pars_t = state_from_numpy(fields_np, pars, model)
    return model, fields, pars_t


def _port_run(name, model_name, state_fn, N, dt, steps, passes):
    model, fields, pars = _port_model(model_name, state_fn, N)
    if name == "theta":
        scheme = tt.schemes.Theta(model, theta=1.0, df64_mixed_solve=passes)
    else:
        scheme = getattr(tt.schemes, name)(model, time_stepping=False,
                                           tol=None, df64_mixed_solve=passes)
    t = 0.0
    for _ in range(steps):
        t, fields = scheme(t, fields, dt, pars)
    assert t == steps * dt
    return fields["U"].numpy()


#: (solver, df64_mixed_solve)
SOLVERS = [("full", None), ("mixed1", 1)]


def _ks_trajectory(passes):
    got = _port_run("RODASPR", "ks", ks64_state, N_KS, DT_KS, STEPS, passes)
    df = _jax_run("RODASPR", "ks", ks64_state, N_KS, DT_KS, STEPS, "df64",
                  passes)
    f64 = _jax_run("RODASPR", "ks", ks64_state, N_KS, DT_KS, STEPS, True,
                   None)
    assert np.abs(got - df).max() <= 1e-11
    assert np.abs(got - f64).max() <= 1e-11


@pytest.mark.parametrize("solver,passes", SOLVERS, ids=[s[0] for s in SOLVERS])
def test_ks_trajectory_matches_reference(solver, passes):
    _ks_trajectory(passes)


@pytest.mark.parametrize("solver,passes", SOLVERS, ids=[s[0] for s in SOLVERS])
def test_ks_trajectory_matches_reference_multi_launch(multi_launch, solver,
                                                      passes):
    _ks_trajectory(passes)


def _theta_step(passes):
    got = _port_run("theta", "theta", theta_state, N_THETA, DT_THETA, 1,
                    passes)
    df = _jax_run("theta", "theta", theta_state, N_THETA, DT_THETA, 1, "df64",
                  passes)
    f64 = _jax_run("theta", "theta", theta_state, N_THETA, DT_THETA, 1, True,
                   None)
    assert np.abs(got - df).max() <= 1e-11
    assert np.abs(got - f64).max() <= 1e-11


@pytest.mark.parametrize("solver,passes", SOLVERS, ids=[s[0] for s in SOLVERS])
def test_theta_step_matches_reference(solver, passes):
    _theta_step(passes)


@pytest.mark.parametrize("solver,passes", SOLVERS, ids=[s[0] for s in SOLVERS])
def test_theta_step_matches_reference_multi_launch(multi_launch, solver,
                                                   passes):
    _theta_step(passes)


# ----------------------------------------------------------------- routing

@pytest.fixture
def calls(monkeypatch):
    """Every call of K6's entries, K8 and K7, by name."""
    seen = {"K6.step": 0, "K6.step_mixed": 0, "K6.adaptive": 0, "K8": 0,
            "K7": 0, "nsteps": []}

    def counting(module, attr, key):
        plain = getattr(module, attr)

        def wrapped(*args, **kw):
            seen[key] += 1
            if key == "K6.step_mixed":
                # step_mixed(backend, plan, table, periodic, u, helpers,
                # pstack, x, beta, scale, passes, nsteps=1)
                seen["nsteps"].append(kw.get("nsteps", (*args, 1)[11]))
            return plain(*args, **kw)

        monkeypatch.setattr(module, attr, wrapped)

    counting(megastep, "step", "K6.step")
    counting(megastep, "step_mixed", "K6.step_mixed")
    counting(megastep, "row_adaptive_step", "K6.adaptive")
    counting(mixed, "mixed_residual", "K8")
    counting(schemes_t, "banded_matvec", "K7")
    return seen


def _ks_model(N, double="df64"):
    return _port_model("ks", ks64_state, N, double)


def test_mixed_step_below_the_gate_is_one_mixed_entry_call(calls):
    model, fields, pars = _ks_model(256)
    scheme = tt.schemes.RODASPR(model, time_stepping=False, tol=None,
                                df64_mixed_solve=2)
    assert scheme._mixed_plan(256, True) is not None
    assert scheme._mega_plan(256, True) is None
    for i in range(3):
        _, fields = scheme(i * 0.0625, fields, 0.0625, pars)
    assert (calls["K6.step_mixed"], calls["K8"], calls["K6.step"]) == (3, 0, 0)
    u, helpers, x = model.backend.split_fields(fields)
    scan = scheme.device_fixed_scan(256, periodic=True)
    scan(0.0, u, helpers, model.backend.pack_pars(pars, x), x, 0.0625, 7)
    assert calls["K6.step_mixed"] == 4 and calls["nsteps"][-1] == 7
    # Theta takes the mixed entry the same way
    theta = tt.schemes.Theta(model, theta=1.0, df64_mixed_solve=1)
    theta(0.0, fields, 0.0625, pars)
    assert calls["K6.step_mixed"] == 5 and calls["K8"] == 0


def test_mixed_step_above_the_gate_calls_k8(calls):
    N = 2 * megastep.MIXED_MAX_N[2]
    model, fields, pars = _ks_model(N)
    for passes in (1, 2):
        scheme = tt.schemes.RODASPR(model, time_stepping=False, tol=None,
                                    df64_mixed_solve=passes)
        assert scheme._mixed_plan(N, True) is None
        assert scheme.device_fixed_scan(N, periodic=True) is None
        calls["K8"] = 0
        scheme(0.0, fields, 0.0625, pars)
        assert calls["K8"] == 6 * passes
    assert calls["K6.step"] == calls["K6.step_mixed"] == 0


def test_full_solver_takes_the_float64_route(calls):
    model, fields, pars = _ks_model(256)
    scheme = tt.schemes.RODASPR(model, time_stepping=False, tol=None,
                                df64_mixed_solve=0)
    assert scheme._mixed_plan(256, True) is None
    scheme(0.0, fields, 0.0625, pars)
    assert (calls["K6.step"], calls["K6.step_mixed"], calls["K8"]) == (1, 0, 0)
    withheld = tt.schemes.RODASPR(model, time_stepping=False, tol=None)
    withheld._mega_plans[(256, True)] = None
    withheld(0.0, fields, 0.0625, pars)
    assert (calls["K6.step"], calls["K8"]) == (1, 0)


@pytest.mark.parametrize("passes", [None, 1], ids=["full", "mixed1"])
def test_refine_on_df64_takes_k7_and_never_k6(calls, passes):
    """``refine=1`` wraps the stage solve (full, or mixed: one K8 in the
    solve of the right-hand side and one in the solve of the residual)
    with a K7 residual per stage, on a grid K6 admits."""
    model, fields, pars = _ks_model(256)
    scheme = tt.schemes.RODASPR(model, time_stepping=False, tol=None,
                                refine=1, df64_mixed_solve=passes)
    assert scheme._mega_plan(256, True) is None
    assert scheme._mixed_plan(256, True) is None
    assert scheme.device_fixed_scan(256, periodic=True) is None
    _, out = scheme(0.0, fields, 0.0625, pars)
    assert calls["K7"] == 6 and calls["K8"] == (12 if passes else 0)
    assert calls["K6.step"] == calls["K6.step_mixed"] == 0
    plain = tt.schemes.RODASPR(model, time_stepping=False, tol=None)
    _, want = plain(0.0, fields, 0.0625, pars)
    assert float((out["U"] - want["U"]).abs().max()) <= 1e-12


def test_adaptive_mixed_attempts_take_the_mixed_entry(calls):
    """The df64 controller decides on the host (float32 decisions on a
    float64 clock): one mixed-entry call per attempt, never K6's
    adaptive entry."""
    model, fields, pars = _ks_model(256)
    scheme = tt.schemes.RODASPR(model, tol=1e-3, df64_mixed_solve=1)
    scheme(0.0, fields, 0.5, pars)
    assert calls["K6.step_mixed"] == scheme._internal_iter > 0
    assert calls["K6.adaptive"] == calls["K8"] == 0


def test_mixed_entry_has_a_library_of_its_own():
    """K6's mixed entry is built from K6's source into a library of its
    own, which only the mixed solve loads: a float64 model's K6 library
    carries the float64 entries alone."""
    b = tt.Model(*EQS["ks"], double="df64", device="cpu").backend
    k6, mixed_lib = b.megastep.source(), b.megastep_mixed.source()
    assert "#define TF_MIXED 0" in k6 and "#define TF_MIXED 1" in mixed_lib
    assert k6.replace("#define TF_MIXED 0", "#define TF_MIXED 1") == mixed_lib
    assert (b.megastep.name, b.megastep_mixed.name) == ("megastep",
                                                        "megastep_mixed")
    assert b.megastep_mixed.lib is None and b.megastep.lib is None


# ------------------------------------------------------- repair, refusals

def test_df64_mixed_solve_is_ignored_off_df64():
    """The reference takes ``df64_mixed_solve=`` on every model and ignores
    it unless the model is df64: the port's steps equal those without."""
    model, fields, pars = _ks_model(256, double=True)
    for make in (lambda **kw: tt.schemes.RODASPR(model, time_stepping=False,
                                                 tol=None, **kw),
                 lambda **kw: tt.schemes.Theta(model, theta=1.0, **kw)):
        with_knob, without = make(df64_mixed_solve=1), make()
        assert with_knob._mixed == 0
        a, b = fields, fields
        for i in range(3):
            _, a = with_knob(i * 0.05, a, 0.05, pars)
            _, b = without(i * 0.05, b, 0.05, pars)
        assert torch.equal(a["U"], b["U"])


def test_refusals_name_their_queue_item():
    model, fields, pars = _ks_model(256)
    # the df64 state carries its own precision: the Kahan carry is off
    assert tt.schemes.RODASPR(model, compensated=True)._compensated is False
    u0 = np.stack([ks64_state(256)[0]["U"]] * 2)
    ens = Ensemble(model, **ensemble_from_numpy(model, u0, ks64_state(256)[0]["x"],
                                                dict(periodic=True)))
    assert ens.u.dtype == torch.float64
    for double in ("df32", "float64"):
        with pytest.raises(NotImplementedError):
            tt.Model(*EQS["ks"], double=double, device="cpu")


def test_state_from_df_is_exact():
    rng = np.random.default_rng(5)
    values = rng.standard_normal((3, 200)) * 10.0 ** rng.integers(-8, 8, (3, 200))
    df = DF.from_float64(values)
    got = state_from_df(df.hi, df.lo)
    assert got.dtype == np.float64
    assert np.array_equal(got, df.to_float64())
    assert np.abs(got - values).max() <= 2.0 ** -47 * np.abs(values).max()


def test_step_doubling_steps_float32_dts_on_a_float64_clock():
    """A scheme without its own controller in the df64 mode is wrapped in
    step doubling, whose attempts take float32 dts while its clock adds
    them in float64: the output times are the float32 dt's multiples."""
    model, fields, pars = _port_model("theta", theta_state, 64)
    sim = tt.Simulation(model, fields, pars, dt=0.1, tmax=0.3,
                        scheme=tt.schemes.Theta, df64_mixed_solve=1, tol=1e-4)
    dt = float(np.float32(0.1))
    times = [t for t, _ in sim]
    assert times[:2] == [dt, 2 * dt] and np.isclose(times[-1], 0.3)
    assert sim._scheme._inner._mixed == 1


def test_hook_sees_and_sets_float64():
    model, fields, pars = _port_model("theta", theta_state, 64)
    seen = []

    def hook(t, f, p):
        seen.append(f["U"].dtype)
        f["U"][0] = 1.0 / 3.0
        return f, p

    scheme = tt.schemes.Theta(model, theta=1.0, df64_mixed_solve=1)
    t, out = scheme(0.0, fields, 0.1, pars, hook=hook)
    assert set(seen) == {torch.float64}
    assert float(out["U"][0]) == 1.0 / 3.0
    # the step took dt rounded to float32, and the clock adds it in float64
    assert t == float(np.float32(0.1))
