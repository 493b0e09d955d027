"""The port's host-side schemes on the CPU: the ``scipy_ode`` proxy (scipy's
integrators over the model's host routines ``model.F`` / ``model.J``), the
host step-doubling wrapper ``_host_time_stepping`` and the ``time_stepping``
dispatch, and duck-typed hand-written models through ``Simulation``.

The cases of ``tests/test_workloads.py`` that use the proxy run on the
port at smaller sizes: the adaptive RODASPR trajectory against scipy's
vode at tight tolerances (Kuramoto-Sivashinsky, and the coupled U/V pair
with its swap symmetry, vode's BDF with the Jacobian), and a hand-written
model.  The proxy's trajectory is also held against the reference's proxy
on the same integrator and tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import triflow_tpu as tj
import triflow_tpu_torch as tt
from triflow_tpu_torch.utils.convert import state_from_numpy

torch.set_num_threads(1)

KS = ("-dxxU - dxxxxU - U * dxU", "U", [])
PAIR = (["k * dxxU - c * U * dxV", "k * dxxV - c * V * dxU"], ["U", "V"],
        ["k", "c"])
README = ("k * dxxU - c * dxU", "U", ["k", "c"])
TIGHT = dict(atol=1e-13, rtol=1e-13, nsteps=50000)


def ks_state(N=64):
    x = np.arange(N) * 0.5
    return {"x": x, "U": np.cos(0.2 * x) + 0.05 * np.cos(0.4 * x)}, \
        dict(periodic=True)


def pair_state(N=64, swap=False):
    L = 10.0
    x = np.linspace(0, L, N, endpoint=False)
    U0 = 1 + 0.3 * np.cos(2 * np.pi * x / L)
    V0 = 1 + 0.3 * np.sin(2 * np.pi * x / L)
    if swap:
        U0, V0 = V0, U0
    return {"x": x, "U": U0, "V": V0}, dict(periodic=True, k=0.05, c=1.0)


def run(model, state, scheme, dt, n, hook=tt.schemes.null_hook):
    fields, pars = state_from_numpy(*state, model)
    t = 0.0
    for _ in range(n):
        t, fields = scheme(t, fields, dt, pars, hook)
    return t, fields


def test_ks_rosenbrock_trajectory_matches_scipy_vode():
    model = tt.Model(*KS, device="cpu")
    fields, pars = state_from_numpy(*ks_state(), model)
    sim = tt.Simulation(model, fields, pars, dt=0.25, tmax=0.25, tol=1e-12)
    for _t, fields in sim:
        pass
    t, oracle = run(model, ks_state(), tt.schemes.scipy_ode(model, **TIGHT),
                    0.25, 1)
    assert t == 0.25
    assert np.abs(fields["U"].numpy() - oracle["U"].numpy()).max() < 1e-8


@pytest.mark.parametrize("jac", [False, True])
def test_pair_trajectory_matches_scipy_and_swap_symmetry(jac):
    """The coupled pair against vode (Adams without the Jacobian, BDF with
    ``model.J``), and its U <-> V symmetry."""
    model = tt.Model(*PAIR, device="cpu")
    kw = dict(TIGHT, method="bdf") if jac else TIGHT
    scheme = tt.schemes.scipy_ode(model, jac=jac, **kw)
    _, oracle = run(model, pair_state(), scheme, 0.25, 1)
    fields, pars = state_from_numpy(*pair_state(), model)
    sim = tt.Simulation(model, fields, pars, dt=0.25, tmax=0.25, tol=1e-12)
    for _t, fields in sim:
        pass
    for var in "UV":
        assert np.abs(fields[var].numpy() - oracle[var].numpy()).max() < 1e-8
    _, swapped = run(model, pair_state(swap=True),
                     tt.schemes.scipy_ode(model, jac=jac, **kw), 0.25, 1)
    assert np.abs(swapped["U"].numpy() - oracle["V"].numpy()).max() < 1e-9
    assert np.abs(swapped["V"].numpy() - oracle["U"].numpy()).max() < 1e-9


@pytest.mark.parametrize("integrator,kw", [("vode", {}),
                                           ("vode", {"method": "bdf"}),
                                           ("dopri5", {})])
def test_proxy_matches_reference_proxy(integrator, kw):
    """The port's proxy and the reference's on one integrator and
    tolerances, on the README model with its Dirichlet hook (re-applied
    at every right-hand side), Jacobian where BDF takes one."""
    x = np.linspace(0, 1, 64)
    state = ({"x": x, "U": np.cos(2 * np.pi * x * 5)},
             dict(periodic=False, k=1e-3, c=3e-3))
    jac = kw.get("method") == "bdf"
    opts = dict(atol=1e-12, rtol=1e-12, nsteps=50000, **kw)

    def hook_jax(t, fields, pars):
        fields["U"] = fields["U"].at[0].set(1.0).at[-1].set(0.0)
        return fields, pars

    def hook_torch(t, fields, pars):
        fields["U"][0] = 1.0
        fields["U"][-1] = 0.0
        return fields, pars

    model_j = tj.Model(*README)
    model_t = tt.Model(*README, device="cpu")
    sj = tj.schemes.scipy_ode(model_j, jac=jac, integrator=integrator, **opts)
    st = tt.schemes.scipy_ode(model_t, jac=jac, integrator=integrator, **opts)
    fields_j = model_j.fields_template(
        **{k: jnp.asarray(v) for k, v in state[0].items()})
    t_j = 0.0
    for _ in range(2):
        t_j, fields_j = sj(t_j, fields_j, 2.0, state[1], hook_jax)
    t_t, fields_t = run(model_t, state, st, 2.0, 2, hook_torch)
    assert t_t == t_j == 4.0
    assert fields_t["U"][0] == 1.0 and fields_t["U"][-1] == 0.0
    assert np.abs(fields_t["U"].numpy() - np.asarray(fields_j["U"])).max() < 1e-9


def test_proxy_reports_integrator_failure():
    model = tt.Model(*KS, device="cpu")
    scheme = tt.schemes.scipy_ode(model, nsteps=2)
    fields, pars = state_from_numpy(*ks_state(), model)
    with pytest.raises(RuntimeError, match="integrator reported failure"):
        scheme(0.0, fields, 5.0, pars)


class Decay:
    """A hand-written model: ``F`` and ``fields_template`` only."""

    fields_template = tt.factory(("x",), [("u", ("x",))], [])

    @staticmethod
    def F(fields, pars):
        return -pars["lam"] * np.asarray(fields["u"])


@pytest.mark.parametrize("time_stepping", [False, True])
def test_duck_typed_manual_model(time_stepping):
    """A duck-typed model through Simulation with the proxy: its fields
    stay as given (no backend converts them), and with time stepping the
    proxy is wrapped in the host step-doubling loop."""
    model = Decay()
    x = np.linspace(0, 1, 16)
    fields = model.fields_template(x=x, u=np.ones(16))
    sim = tt.Simulation(model, fields, {"lam": 2.0}, dt=0.25, tmax=1.0,
                        scheme=tt.schemes.scipy_ode,
                        time_stepping=time_stepping, tol=1e-6)
    assert isinstance(sim.fields["u"], np.ndarray)
    assert callable(sim._scheme)
    assert isinstance(sim._scheme, tt.schemes.scipy_ode) != time_stepping
    for _t, fields in sim:
        pass
    assert sim.t == 1.0
    assert np.allclose(np.asarray(fields["u"]), np.exp(-2.0), atol=1e-5)


def test_time_stepping_dispatch_and_per_trajectory_dt():
    """``time_stepping`` wraps a scheme of the port in DeviceTimeStepping
    and any other callable in the host loop, which keeps one adapted dt per
    trajectory (keyed on the fields handed back)."""
    model = tt.Model(*KS, device="cpu")
    assert isinstance(tt.schemes.time_stepping(tt.schemes.Theta(model)),
                      tt.schemes.DeviceTimeStepping)
    calls = []

    def inner(t, fields, dt, pars, hook=tt.schemes.null_hook):
        # forward Euler on U' = -lam U: an error that the step doubling sees
        calls.append(dt)
        fields = fields.copy()
        fields["U"] = fields["U"] * (1 - dt * pars["lam"])
        return t + dt, fields

    wrapped = tt.schemes.time_stepping(inner, tol=1e-9, m=4)
    assert not isinstance(wrapped, tt.schemes.DeviceTimeStepping)
    tmpl = tt.factory1D(["U"], [])
    fast = tmpl(x=np.arange(4.0), U=np.ones(4))
    slow = tmpl(x=np.arange(4.0), U=np.ones(4))
    t1, fast = wrapped(0.0, fast, 1.0, {"lam": 5.0})
    calls.clear()
    t2, slow = wrapped(0.0, slow, 1.0, {"lam": 0.1})
    first_slow = calls[0]
    calls.clear()
    t1, fast = wrapped(t1, fast, 1.0, {"lam": 5.0})
    assert t1 == t2 + 1.0 == 2.0
    # the fast trajectory resumes from its own adapted dt, not the slow one's
    assert calls[0] < first_slow
    assert np.allclose(np.asarray(fast["U"]), np.exp(-10.0), rtol=1e-2)
    assert np.allclose(np.asarray(slow["U"]), np.exp(-0.1), rtol=1e-3)
