"""The port's raw device entries against the JAX package's entries of the
same name, float64 on the CPU, from one state handed to both with
``state_from_numpy``:

* ``device_fixed_step`` (one grid, and with ``batched=True`` three members
  against ``jax.vmap`` of the reference's batched step) and
  ``device_stepper`` on the heat equation (block size s = 1), KS (s = 2)
  and a two-variable advection-diffusion model (s = 2), periodic and on an
  edge grid with a Dirichlet hook, within 1e-12 max|u|;
* ``device_steps``: t_final, status, the number of snapshots and each
  snapshot's time and state, within 1e-12 for fixed steps; adaptive runs
  (KS, output steps of 0.5 at tol 1e-3, whose dts are set by errs near
  tol: ``test_torch_row.py``) within 1e-9 max|u| and the adapted dt to
  1e-8 relative; the failure prefix under a tight ``max_iter``;
* the routes of ``device_steps`` on the CPU: K6's fixed and adaptive scans
  (their plain versions) and the eager loop, each bit for bit against the
  same number of ``__call__`` calls;
* the reference's scan names (``device_fixed_scan_folded``,
  ``device_fixed_scan_df_folded``): their argument order, where they are
  None, and their output bit for bit against n calls of the folded step.
"""

import inspect

import numpy as np
import pytest
import torch

import triflow_tpu as tj
import triflow_tpu_torch as tt
from triflow_tpu_torch.utils.convert import state_from_numpy

from .test_torch_theta import (KS, dirichlet_jax, dirichlet_torch, ks_state,
                               multi_launch)

torch.set_num_threads(1)

HEAT = ("k * dxxU", "U", ["k"])
TWO = (["k * dxxU - c * dxV", "k * dxxV - c * dxU"], ["U", "V"], ["k", "c"])


def heat_state(N=64, periodic=True):
    x = np.linspace(0, 10, N, endpoint=not periodic)
    return {"x": x, "U": np.cos(2 * np.pi * x / 10) + 0.5}, \
        dict(periodic=periodic, k=1.0)


def two_state(N=64, periodic=True):
    x = np.linspace(0, 10, N, endpoint=not periodic)
    return ({"x": x, "U": np.cos(2 * np.pi * x / 10),
             "V": np.sin(4 * np.pi * x / 10)},
            dict(periodic=periodic, k=0.5, c=1.0))


def dirichlet2_jax(t, fields, pars):
    fields, pars = dirichlet_jax(t, fields, pars)
    fields["V"] = fields["V"].at[0].set(0.0).at[-1].set(0.0)
    return fields, pars


def dirichlet2_torch(t, fields, pars):
    fields, pars = dirichlet_torch(t, fields, pars)
    fields["V"][0] = 0.0
    fields["V"][-1] = 0.0
    return fields, pars


#: (id, equations, state, dt, reference hook, port hook)
CASES = [
    ("heat-periodic", HEAT, heat_state(), 0.05, None, None),
    ("heat-dirichlet", HEAT, heat_state(periodic=False), 0.05, dirichlet_jax,
     dirichlet_torch),
    ("ks-periodic", KS, ks_state(128), 0.05, None, None),
    ("ks-dirichlet", KS, (ks_state(128)[0], dict(periodic=False)), 0.05,
     dirichlet_jax, dirichlet_torch),
    ("two-periodic", TWO, two_state(), 0.05, None, None),
    ("two-dirichlet", TWO, two_state(periodic=False), 0.05, dirichlet2_jax,
     dirichlet2_torch),
]
IDS = [c[0] for c in CASES]


def _both(eqs, state, double=True):
    fields_np, pars = state
    model_j = tj.Model(*eqs)
    model_t = tt.Model(*eqs, double=double, device="cpu")
    fields_j = model_j.fields_template(**fields_np)
    fields_t, pars_t = state_from_numpy(fields_np, pars, model_t)
    return model_j, fields_j, model_t, fields_t, pars, pars_t


def _hooks(hook_j, hook_t):
    return hook_j or tj.schemes.null_hook, hook_t or tt.schemes.null_hook


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _fields_close(got, want, tol):
    for name in got.dependent_variables:
        _close(got[name], want[name], tol)


def _fixed(cls, model):
    return (cls(model, time_stepping=False) if cls.__name__ != "Theta"
            else cls(model, theta=1.0))


@pytest.mark.parametrize("scheme", ["RODASPR", "Theta"])
@pytest.mark.parametrize("name,eqs,state,dt,hook_j,hook_t", CASES, ids=IDS)
def test_device_fixed_step_matches_jax(scheme, name, eqs, state, dt, hook_j,
                                       hook_t):
    import jax

    model_j, fields_j, model_t, fields_t, pars, pars_t = _both(eqs, state)
    hook_j, hook_t = _hooks(hook_j, hook_t)
    ref = _fixed(getattr(tj.schemes, scheme), model_j)
    port = _fixed(getattr(tt.schemes, scheme), model_t)
    periodic = bool(pars["periodic"])
    out_j = jax.jit(ref.device_fixed_step(hook_j, periodic))(
        0.0, *ref._split(fields_j, pars), dt)
    out_t = port.device_fixed_step(hook_t, periodic)(
        0.0, *port._split(fields_t, pars_t), dt)
    assert len(out_t) == 5
    for got, want in zip(out_t[:4], out_j[:4]):
        if np.size(want):
            _close(got, want, 1e-12)
    if out_t[4] is None or np.isinf(float(out_t[4])):
        assert out_j[4] is None or np.isinf(float(out_j[4]))
    else:
        assert float(out_t[4]) == pytest.approx(float(out_j[4]), rel=1e-9)


@pytest.mark.parametrize("name,eqs,state,dt,hook_j,hook_t",
                         [CASES[0], CASES[5]], ids=[IDS[0], IDS[5]])
def test_device_fixed_step_batched_matches_jax_vmap(name, eqs, state, dt,
                                                    hook_j, hook_t):
    """Three members (the state shifted by 0, 0.1, 0.2) through the batched
    step, against ``jax.vmap`` of the reference's batched step."""
    import jax

    model_j, fields_j, model_t, fields_t, pars, pars_t = _both(eqs, state)
    hook_j, hook_t = _hooks(hook_j, hook_t)
    ref = tj.schemes.RODASPR(model_j, time_stepping=False)
    port = tt.schemes.RODASPR(model_t, time_stepping=False)
    periodic = bool(pars["periodic"])
    u, h, p, x = ref._split(fields_j, pars)
    shifts = np.array([0.0, 0.1, 0.2])[:, None, None]
    ub, hb, pb = (np.asarray(u)[None] + shifts, np.stack([np.asarray(h)] * 3),
                  np.stack([np.asarray(p)] * 3))
    fixed_j = jax.vmap(ref.device_fixed_step(hook_j, periodic, batched=True),
                       in_axes=(None, 0, 0, 0, None, None))
    out_j = fixed_j(0.0, ub, hb, pb, x, dt)
    out_t = port.device_fixed_step(hook_t, periodic, batched=True)(
        0.0, *(torch.from_numpy(a.copy()) for a in (ub, hb, pb)),
        torch.from_numpy(np.array(x)), dt)
    _close(out_t[0], out_j[0], 1e-12)
    assert np.allclose(out_t[4].numpy(), np.asarray(out_j[4]), rtol=1e-9)


@pytest.mark.parametrize("name,eqs,state,dt,hook_j,hook_t", CASES, ids=IDS)
def test_device_stepper_matches_jax(name, eqs, state, dt, hook_j, hook_t):
    """One output step of the stepper: the output-time hook applied, the
    internal dt returned as it came, no attempt counted, status 0."""
    model_j, fields_j, model_t, fields_t, pars, pars_t = _both(eqs, state)
    hook_j, hook_t = _hooks(hook_j, hook_t)
    ref = tj.schemes.RODASPR(model_j, time_stepping=False)
    port = tt.schemes.RODASPR(model_t, time_stepping=False)
    periodic = bool(pars["periodic"])
    out_j = ref.device_stepper(hook_j, periodic)(
        0.25, *ref._split(fields_j, pars), dt, 0.01)
    out_t = port.device_stepper(hook_t, periodic)(
        0.25, *port._split(fields_t, pars_t), dt, 0.01)
    assert float(out_t[0]) == float(out_j[0]) == 0.25 + dt
    _close(out_t[1], out_j[1], 1e-12)
    assert float(out_t[5]) == pytest.approx(float(out_j[5]))
    assert (int(out_t[6]), int(out_t[7])) == (int(out_j[6]), int(out_j[7])) == (0, 0)


@pytest.mark.parametrize("name,eqs,state,dt,hook_j,hook_t",
                         [CASES[0], CASES[3], CASES[5]],
                         ids=[IDS[0], IDS[3], IDS[5]])
def test_device_steps_fixed_matches_jax(name, eqs, state, dt, hook_j, hook_t):
    model_j, fields_j, model_t, fields_t, pars, pars_t = _both(eqs, state)
    hook_j, hook_t = _hooks(hook_j, hook_t)
    ref = tj.schemes.RODASPR(model_j, time_stepping=False)
    port = tt.schemes.RODASPR(model_t, time_stepping=False)
    t_j, snaps_j, st_j = ref.device_steps(0.0, fields_j, 4, dt, pars, hook=hook_j)
    t_t, snaps_t, st_t = port.device_steps(0.0, fields_t, 4, dt, pars_t,
                                           hook=hook_t)
    assert port.steps_route == ("eager" if hook_t is not tt.schemes.null_hook
                                else "K6")
    assert (st_t, len(snaps_t)) == (st_j, len(snaps_j)) == (0, 4)
    assert t_t == pytest.approx(t_j, rel=1e-15)
    for (ti, fi), (tj_, fj) in zip(snaps_t, snaps_j):
        assert ti == pytest.approx(tj_, rel=1e-15)
        _fields_close(fi, fj, 1e-12)


@pytest.mark.parametrize("name,eqs,state,dt,hook_j,hook_t",
                         [CASES[0], CASES[5]], ids=[IDS[0], IDS[5]])
def test_device_steps_fixed_matches_jax_multi_launch(multi_launch, name, eqs,
                                                     state, dt, hook_j, hook_t):
    """With K6's plan withheld, fixed steps on CPU tensors take the eager
    loop."""
    model_j, fields_j, model_t, fields_t, pars, pars_t = _both(eqs, state)
    hook_j, hook_t = _hooks(hook_j, hook_t)
    ref = tj.schemes.RODASPR(model_j, time_stepping=False)
    port = tt.schemes.RODASPR(model_t, time_stepping=False)
    _, snaps_j, _ = ref.device_steps(0.0, fields_j, 3, dt, pars, hook=hook_j)
    _, snaps_t, st_t = port.device_steps(0.0, fields_t, 3, dt, pars_t,
                                         hook=hook_t)
    assert port.steps_route == "eager" and st_t == 0
    for (_, fi), (_, fj) in zip(snaps_t, snaps_j):
        _fields_close(fi, fj, 1e-12)


def test_device_steps_adaptive_matches_jax():
    """KS N = 512, output steps of 0.5 at tol 1e-3 (every dt set by an err
    near tol): K6's adaptive scan with snapshots (its plain version)."""
    model_j, fields_j, model_t, fields_t, pars, pars_t = _both(KS, ks_state(512))
    ref = tj.schemes.RODASPR(model_j, tol=1e-3)
    port = tt.schemes.RODASPR(model_t, tol=1e-3)
    t_j, snaps_j, st_j = ref.device_steps(0.0, fields_j, 3, 0.5, pars)
    t_t, snaps_t, st_t = port.device_steps(0.0, fields_t, 3, 0.5, pars_t)
    assert port.steps_route == "K6_adaptive"
    assert (st_t, len(snaps_t)) == (st_j, len(snaps_j)) == (0, 3)
    assert t_t == t_j == 1.5
    for (ti, fi), (tj_, fj) in zip(snaps_t, snaps_j):
        assert ti == tj_
        _fields_close(fi, fj, 1e-9)
    assert port._internal_dt == pytest.approx(float(ref._internal_dt), rel=1e-8)


def test_device_steps_failure_prefix_matches_jax():
    """A tight max_iter: both stop at the same output step with status 1
    and return only the snapshots before it (the first output step ramps
    from the seed dt: it is the one that fails)."""
    model_j, fields_j, model_t, fields_t, pars, pars_t = _both(KS, ks_state(512))
    ref = tj.schemes.RODASPR(model_j, tol=1e-3, max_iter=3)
    port = tt.schemes.RODASPR(model_t, tol=1e-3, max_iter=3)
    t_j, snaps_j, st_j = ref.device_steps(0.0, fields_j, 3, 0.5, pars)
    t_t, snaps_t, st_t = port.device_steps(0.0, fields_t, 3, 0.5, pars_t)
    assert (st_t, len(snaps_t)) == (st_j, len(snaps_j)) == (1, 0)
    assert t_t == pytest.approx(float(t_j))


def _run_calls(scheme, fields, pars, n, dt, hook=tt.schemes.null_hook):
    t, out = 0.0, []
    for _ in range(n):
        t, fields = scheme(t, fields, dt, pars, hook=hook)
        out.append((t, fields))
    return out


def _same_snapshots(got, want):
    assert len(got) == len(want)
    for (tg, fg), (tw, fw) in zip(got, want):
        assert tg == tw
        for name in fw.keys():
            assert torch.equal(fg[name], fw[name]), name


#: (id, equations, state, dt, scheme factory, hook, the route)
ROUTES = [
    ("k6-rodaspr", KS, ks_state(128), 0.05,
     lambda m: tt.schemes.RODASPR(m, time_stepping=False, tol=None), None, "K6"),
    ("k6-theta", HEAT, heat_state(), 0.05, lambda m: tt.schemes.Theta(m), None,
     "K6"),
    ("k6-adaptive", KS, ks_state(512), 0.5,
     lambda m: tt.schemes.RODASPR(m, tol=1e-3), None, "K6_adaptive"),
    ("eager-hook", KS, (ks_state(128)[0], dict(periodic=False)), 0.05,
     lambda m: tt.schemes.RODASPR(m, time_stepping=False), dirichlet_torch,
     "eager"),
    ("eager-adaptive-hook", TWO, two_state(periodic=False), 0.2,
     lambda m: tt.schemes.RODASPR(m, tol=1e-3), dirichlet2_torch, "eager"),
    ("eager-step-doubling", HEAT, heat_state(), 0.1,
     lambda m: tt.schemes.time_stepping(tt.schemes.Theta(m), tol=1e-3), None,
     "eager"),
]


@pytest.mark.parametrize("name,eqs,state,dt,make,hook,route", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_device_steps_routes_match_calls(name, eqs, state, dt, make, hook,
                                         route):
    """Each route of ``device_steps`` on the CPU, bit for bit against the
    same number of ``__call__`` calls (the internal dt and attempts kept
    alike)."""
    hook = hook or tt.schemes.null_hook
    model = tt.Model(*eqs, device="cpu")
    fields, pars = state_from_numpy(*state, model)
    a, b = make(model), make(model)
    want = _run_calls(a, fields, pars, 3, dt, hook)
    t, got, status = b.device_steps(0.0, fields, 3, dt, pars, hook=hook)
    assert b.steps_route == route and status == 0
    _same_snapshots(got, want)
    assert t == want[-1][0]
    assert getattr(b, "_internal_dt", None) == getattr(a, "_internal_dt", None)
    assert getattr(b, "_internal_iter", None) == getattr(a, "_internal_iter", None)
    # the input fields are left as they were
    assert torch.equal(fields["U"], state_from_numpy(*state, model)[0]["U"])


def test_scan_names_signatures():
    """The reference's argument order, and where the entries are None."""
    model = tt.Model(*KS, device="cpu")
    df64 = tt.Model(*KS, double="df64", device="cpu")
    ros = tt.schemes.RODASPR(model, time_stepping=False, tol=None)
    plan, scan = ros.device_fixed_scan_folded(128, periodic=True)
    assert list(inspect.signature(scan).parameters) == [
        "t", "u", "helpers", "pstack", "x", "dx", "dt", "nsteps"]
    assert ros.device_fixed_scan_df_folded(128) is None
    assert tt.schemes.RODASPR(df64).device_fixed_scan_folded(128) is None
    assert tt.schemes.RODASPR(df64).device_fixed_scan_df_folded(128) is None
    mixed = tt.schemes.RODASPR(df64, time_stepping=False, df64_mixed_solve=1)
    _, scan_df = mixed.device_fixed_scan_df_folded(128)
    assert list(inspect.signature(scan_df).parameters) == [
        "u", "helpers", "pstack", "x", "dx", "dt", "nsteps"]
    assert tt.schemes.Theta(model, theta=0).device_fixed_scan_folded(128) is None
    assert tt.schemes.Theta(df64).device_fixed_scan_folded(128) is None
    assert not hasattr(tt.schemes.Theta(model), "device_fixed_scan_df_folded")
    # the reference's entries take the same positions
    ref = tj.schemes.RODASPR(tj.Model(*KS), time_stepping=False, tol=None)
    assert hasattr(ref, "device_fixed_scan_folded")
    assert hasattr(ref, "device_fixed_scan_df_folded")


@pytest.mark.parametrize("N", [128, 4 * 8192])
@pytest.mark.parametrize("scheme", ["RODASPR", "Theta"])
def test_scan_names_match_folded_steps(scheme, N):
    """n steps of the scan against n calls of ``device_fixed_step_folded``'s
    step, bit for bit: on K6's plan (N = 128) and off it (a grid above
    K6's gate: the loop the CPU takes, the graph on the card)."""
    model = tt.Model(*KS, device="cpu")
    cls = getattr(tt.schemes, scheme)
    sch = (cls(model, time_stepping=False, tol=None) if scheme == "RODASPR"
           else cls(model, theta=1.0))
    fields, pars = state_from_numpy(*ks_state(N), model)
    args = sch._split(fields, pars)
    _, scan = sch.device_fixed_scan_folded(N, periodic=True)
    _, step = sch.device_fixed_step_folded(N, periodic=True)
    u = args[0]
    for _ in range(3):
        u = step(0.0, u, *args[1:], None, 0.01)[0]
    assert torch.equal(scan(0.0, *args, None, 0.01, 3), u)


def test_df_scan_matches_fixed_steps():
    """The df64 mode's mixed solve: ``device_fixed_scan_df_folded`` (K6's
    mixed entry's plain version) bit for bit against n fixed steps."""
    model = tt.Model(*KS, double="df64", device="cpu")
    sch = tt.schemes.RODASPR(model, time_stepping=False, tol=None,
                             df64_mixed_solve=1)
    fields, pars = state_from_numpy(*ks_state(128), model)
    args = sch._split(fields, pars)
    _, scan = sch.device_fixed_scan_df_folded(128, periodic=True)
    fixed = sch.device_fixed_step(periodic=True)
    u = args[0]
    for _ in range(2):
        u = fixed(0.0, u, *args[1:], np.float32(0.01))[0]
    assert torch.equal(scan(*args, None, 0.01, 2), u)
