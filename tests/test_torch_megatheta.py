"""The opt-in two-pass theta step (kernel K9, ``ops/megatheta.py``) against
the JAX package's ``theta_step_tiled``.

The port's ``Theta(...).device_fixed_step_folded`` with
``TRIFLOW_MEGATHETA=1`` takes K9's route (its plain versions on the CPU:
the interface pass, K4's plain PCR, the correction pass); the reference's
entry with the same variable and ``TRIFLOW_PALLAS_INTERPRET=1`` runs its
Pallas kernels in interpret mode, jitted, on its folded layout.  From one
state handed to both:

* Burgers and KS (block sizes 1 and 2) at N = 8192, theta = 1, dt = 0.05:
  one step and five chained steps, float64 within 1e-11 of max|u| and
  float32 within 2e-5 (the reference's own limit between its tiled and
  grid paths, ``tests/test_megastep.py``);
* the gate, case by case against the reference's: Burgers and KS admitted;
  the two-variable model (s = 4), a model with a helper function, an edge
  grid, the df64 mode, ``solver=`` and theta = 0 refused;
  ``TRIFLOW_NO_MEGATHETA`` overrides ``TRIFLOW_MEGATHETA``, and without it
  the entry is the default route;
* the plain interface pass against the plain K2 factor and K3 sweep on the
  same plan (Woodbury and block-cyclic) to 1e-12;
* ``ROW_general.device_fixed_step_folded`` (RODASPR) and Theta's entry
  without the variable against the reference's node-layout
  ``device_fixed_step`` to 1e-11: the reference's own folded entries
  return None on the CPU outside interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import triflow_tpu as tj
import triflow_tpu_torch as tt
from triflow_tpu.ops import folded as jfolded
from triflow_tpu_torch.ops import _launch, megastep, megatheta, pcr, thomas
from triflow_tpu_torch.utils.convert import state_from_numpy

torch.set_num_threads(1)

BURGERS = ("-U * dxU + nu * dxxU", "U", ["nu"])
KS = ("-dxxU - dxxxxU - U * dxU", "U", [])
TWO_VAR = (["-dxq", "-dx(q**2/h) - h * dxxxh + q / h"], ["h", "q"], [])
HELPER = (["k * dxxU + s"], "U", ["k"], ["s"])
N = 8192
DT = 0.05
STEPS = 5
TOL = {True: 1e-11, False: 2e-5}


def state(eqs, N=N, seed=0):
    """The reference's tiled-kernel test state (x = 0.5 i, cos(8 pi i / N)
    plus noise of 0.05, nu = 0.5) as numpy fields and parameters."""
    i = np.arange(N)
    rng = np.random.RandomState(seed)
    fields = {"x": 0.5 * i,
              "U": np.cos(2 * np.pi * i / N * 4) + 0.05 * rng.randn(N)}
    pars = dict(periodic=True, nu=0.5) if eqs[2] else dict(periodic=True)
    return fields, pars


@pytest.fixture
def opt_in(monkeypatch):
    monkeypatch.setenv("TRIFLOW_MEGATHETA", "1")
    monkeypatch.setenv("TRIFLOW_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("TRIFLOW_NO_MEGATHETA", raising=False)


def jax_steps(eqs, double, fields, pars, steps):
    """The reference's tiled step, jitted: the state after each of
    ``steps`` steps (numpy, node layout)."""
    model = tj.Model(*eqs, double=double)
    be = model.backend
    api = tj.schemes.Theta(model, theta=1.0).device_fixed_step_folded(
        N, periodic=True)
    plan, fixed = api
    assert fixed.__name__ == "fixed_t"  # the tiled route was taken
    dtype = be.dtype
    x = jnp.asarray(fields["x"], dtype)
    fold = lambda a: jfolded.fold(a, plan)  # noqa: E731
    uf = fold(jnp.asarray(fields["U"][None], dtype))
    hf = fold(jnp.zeros((0, N), dtype))
    pf = fold(be.pack_pars(pars, x))
    xf = fold(x)
    step = jax.jit(lambda u: fixed(0.0, u, hf, pf, xf, jnp.asarray(0.5, dtype),
                                   jnp.asarray(DT, dtype))[0])
    out = []
    for _ in range(steps):
        uf = step(uf)
        out.append(np.asarray(jfolded.unfold(uf, plan), np.float64))
    return out


def port_steps(eqs, double, fields, pars, steps):
    model = tt.Model(*eqs, double=double, device="cpu")
    scheme = tt.schemes.Theta(model, theta=1.0)
    plan, fixed = scheme.device_fixed_step_folded(N, periodic=True)
    assert plan == megatheta.plan_for(N, 1, model.halo)
    f, p = state_from_numpy(fields, pars, model)
    u, helpers, pstack, x = scheme._split(f, p)
    out = []
    for _ in range(steps):
        u, err = fixed(0.0, u, helpers, pstack, x, 0.5, DT)
        assert float(err) == 0.0
        out.append(u.double().numpy())
    return out


@pytest.mark.parametrize("double", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("eqs", [BURGERS, KS], ids=["burgers", "ks"])
def test_tiled_step_matches_jax(opt_in, eqs, double):
    """One step and five chained steps through both packages' opt-in
    entry, each on its own plan (the port's: block-cyclic at s = 1 and
    2)."""
    fields, pars = state(eqs)
    want = jax_steps(eqs, double, fields, pars, STEPS)
    got = port_steps(eqs, double, fields, pars, STEPS)
    for k in (0, STEPS - 1):
        rel = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
        assert rel < TOL[double], (k + 1, rel)
        assert np.isfinite(got[k]).all()


def _reference_takes(eqs, double, periodic, N=N, **kw):
    model = tj.Model(*eqs, double=double)
    api = tj.schemes.Theta(model, **kw).device_fixed_step_folded(
        N, periodic=periodic)
    return api is not None and api[1].__name__ == "fixed_t"


def _port_takes(eqs, double, periodic, N=N, **kw):
    """Whether one call of the port's entry runs K9's step."""
    model = tt.Model(*eqs, double=double, device="cpu")
    api = tt.schemes.Theta(model, **kw).device_fixed_step_folded(
        N, periodic=periodic)
    if api is None:
        return False
    calls = []
    sysm = model.system
    u = torch.ones((sysm.nvar, N), dtype=model.dtype)
    helpers = torch.zeros((len(sysm.help_funcs), N), dtype=model.dtype)
    pstack = torch.full((len(sysm.pars), N), 0.5, dtype=model.dtype)
    x = torch.arange(N, dtype=model.dtype) * 0.5
    step = megatheta.theta_step
    megatheta.theta_step = lambda *args: calls.append(args) or args[3]
    try:
        api[1](0.0, u, helpers, pstack, x, 0.5, DT)
    finally:
        megatheta.theta_step = step
    return bool(calls)


def _solver(A, B, periodic):
    return B


GATE_CASES = [
    ("burgers", BURGERS, True, True, {}, True),
    ("ks", KS, True, True, {}, True),
    ("burgers-f32", BURGERS, False, True, {}, True),
    ("two-var s=4", TWO_VAR, True, True, {}, False),
    ("helper function", HELPER, True, True, {}, False),
    ("edge grid", BURGERS, True, False, {}, False),
    ("df64", BURGERS, "df64", True, {}, False),
    ("solver=", BURGERS, True, True, {"solver": _solver}, False),
    ("theta=0", BURGERS, True, True, {"theta": 0}, False),
]


@pytest.mark.parametrize("name,eqs,double,periodic,kw,takes", GATE_CASES,
                         ids=[c[0] for c in GATE_CASES])
def test_gate_matches_reference(opt_in, name, eqs, double, periodic, kw,
                                takes):
    assert _reference_takes(eqs, double, periodic, **kw) is takes
    assert _port_takes(eqs, double, periodic, **kw) is takes


def test_no_megatheta_overrides_and_default_route(opt_in, monkeypatch):
    """``TRIFLOW_NO_MEGATHETA`` wins over ``TRIFLOW_MEGATHETA``; without
    either the entry is the default route (K6's plan at N = 8192), and a
    refused scheme returns None as the reference's does."""
    monkeypatch.setenv("TRIFLOW_NO_MEGATHETA", "1")
    assert not _reference_takes(BURGERS, True, True)
    model = tt.Model(*BURGERS, device="cpu")
    scheme = tt.schemes.Theta(model, theta=1.0)
    plan, _ = scheme.device_fixed_step_folded(N)
    assert plan == scheme._mega_plan(N, True)
    assert not _port_takes(BURGERS, True, True)
    monkeypatch.delenv("TRIFLOW_NO_MEGATHETA")
    monkeypatch.delenv("TRIFLOW_MEGATHETA")
    assert not _port_takes(BURGERS, True, True)
    for kw in ({"theta": 0}, {"solver": _solver}):
        assert tt.schemes.Theta(model, **kw).device_fixed_step_folded(N) is None
    df64 = tt.Model(*KS, double="df64", device="cpu")
    assert tt.schemes.Theta(df64).device_fixed_step_folded(N) is None
    assert tt.schemes.RODASPR(df64).device_fixed_step_folded(N) is None


def test_plan_and_gate():
    """The plan: a divisor chunk count K4 takes with at most MAX_MC rows,
    Woodbury at the reference's N = 10^6 and block-cyclic at KS 2^20;
    none for s > 2 or N no multiple of the supernode size."""
    burgers = megatheta.plan_for(10 ** 6, 1, 1)
    assert burgers.woodbury and burgers.C <= pcr.MAX_C
    assert burgers.Mc <= megatheta.MAX_MC[1] and burgers.C * burgers.Mc == 10 ** 6
    ks = megatheta.plan_for(1 << 20, 1, 2)
    assert ks.cyclic and ks.s == 2
    assert megatheta.plan_for(1 << 20, 1, 2, C=ks.C) == ks
    assert megatheta.plan_for(1 << 20, 1, 2, C=3) is None
    assert megatheta.plan_for(8192, 2, 2) is None
    assert megatheta.plan_for(8193, 1, 2) is None
    model = tt.Model(*BURGERS, device="cpu")
    assert megatheta.applicable(model, burgers, True)
    assert not megatheta.applicable(model, burgers, False)
    assert not megatheta.applicable(model, burgers._replace(B=4), True)


#: the chunk counts the plan weighs at the reference's grids: every divisor
#: of the supernode count with at most MAX_MC rows (4096 at s = 1, 2048 at
#: s = 2) and at most pcr.MAX_C chunks
ADMITTED = {
    (10 ** 6, 1): [250, 320, 400, 500, 625, 800, 1000, 1250, 1600, 2000,
                   2500, 3125, 4000, 5000, 6250, 8000, 10000, 12500, 15625],
    (1 << 20, 2): [256, 512, 1024, 2048, 4096, 8192, 16384],
}


@pytest.mark.parametrize("N,halo", list(ADMITTED), ids=["burgers-10^6", "ks-2^20"])
def test_plan_weighs_admitted_chunk_counts(N, halo):
    """The chunk counts at Burgers 10^6 and KS 2^20, and the plan's pick
    the least modelled cost among them."""
    counts = megatheta.chunk_counts(N, 1, halo)
    assert counts == ADMITTED[(N, halo)]
    plan = megatheta.plan_for(N, 1, halo)
    costs = {C: megatheta.plan_cost_us(N // halo, C, halo, not (C & (C - 1) == 0))
             for C in counts}
    assert plan.C == min(costs, key=lambda C: (costs[C], C))


@pytest.mark.parametrize("N,halo,Mc", [(8192, 1, 4096), (8192, 2, 2048)],
                         ids=["s=1", "s=2"])
def test_plan_limits(N, halo, Mc):
    """MAX_MC by block size: a chunk of MAX_MC rows is admitted, one of
    twice as many is not; the lanes split a chunk of Mc rows into a chain
    of ceil(Mc / LANES) rows and log2 min(Mc, LANES) levels."""
    assert megatheta.LANES == 32
    assert megatheta.MAX_MC[halo] == Mc
    assert megatheta.plan_for(N, 1, halo, C=2).Mc == Mc
    assert megatheta.plan_for(2 * N, 1, halo, C=2) is None
    for rows, chain in ((2, 2), (32, 6), (50, 7), (500, 21), (Mc, Mc // 32 + 5)):
        assert megatheta.chain_rows(rows) == chain


def test_block_bytes_gate():
    """The gate refuses a plan whose chunk's block does not fit the shared
    memory a block may take: Burgers at MAX_MC (its one parameter staged)
    fits in float64; with x read and two more parameters it does not, and
    at a chunk of 500 rows it does."""
    item = 8
    assert megatheta.smem_bytes(1, 0, 1, 1, 4096, item) == 167176
    assert megatheta.smem_bytes(1, 0, 0, 2, 2048, item) == 196128
    assert megatheta.smem_bytes(1, 0, 0, 2, 2048, 4) < 196128 // 2 + 4096
    # float32 rows pad every 16 elements where the lanes' stride is 31
    assert megatheta.smem_bytes(1, 0, 1, 1, 1000, 4) == 4 * (1064 + 1062 + 31 * 3 * 32)
    assert megatheta.smem_bytes(1, 0, 1, 1, 800, 4) == 4 * (827 + 824 + 24 * 3 * 32)
    # x beside the parameter: one more row of 4096 nodes, padded
    assert (megatheta.smem_bytes(1, 0, 1, 1, 4096, item, True)
            == 167176 + item * (4095 + 4095 // 16 + 1))
    big = megatheta.plan_for(8192, 1, 1, C=2)
    small = megatheta.plan_for(8000, 1, 1, C=16)
    model = tt.Model(*BURGERS, device="cpu")
    assert megatheta.block_bytes(model, big) <= megastep.SMEM_PER_CTA
    assert megatheta.applicable(model, big, True)
    two = tt.Model("-U * dxU + nu * dxxU + k * U + c * x", "U",
                   ["nu", "k", "c"], device="cpu")
    assert megatheta.block_bytes(two, big) > megastep.SMEM_PER_CTA
    assert not megatheta.applicable(two, big, True)
    assert megatheta.applicable(two, small, True)


@pytest.mark.parametrize("eqs,N,C", [(BURGERS, 1000, 125), (BURGERS, 4096, 256),
                                     (KS, 1200, 15), (KS, 4096, 64)],
                         ids=["burgers-woodbury", "burgers-cyclic", "ks-woodbury",
                              "ks-cyclic"])
def test_interface_pass_matches_k2_k3(eqs, N, C):
    """The plain interface pass against the plain K2 factor of I - dt J and
    K3 sweep of dt F at the same plan, one of each closure per block
    size."""
    model = tt.Model(*eqs, device="cpu")
    b = model.backend
    f, p = state_from_numpy(*state(eqs, N), model)
    u, helpers, x = b.split_fields(f)
    pstack = b.pack_pars(p, x)
    plan = megatheta.plan_for(N, 1, model.halo, C)
    assert plan.woodbury == (N in (1000, 1200))
    beta, dt = megatheta.scalars(u.dtype, 1.0, DT)
    got = megatheta.interface_plain(b, plan, u, helpers, pstack, x, beta, dt)
    fact = thomas.spike_factor_plain(b.J_bands_impl(u, helpers, pstack, x,
                                                    periodic=True),
                                     1.0, beta, plan)
    _, yred = thomas.thomas_sweep_plain(
        fact, dt * b.F_impl(u, helpers, pstack, x, periodic=True), plan)
    for g, w in zip(got, (fact.Lred, fact.Ured, yred)):
        assert (g - w).abs().max() <= 1e-12 * w.abs().max()


def _node_layout_reference(scheme_j, fields, pars, dt):
    model_j = scheme_j._model
    be = model_j.backend
    x = jnp.asarray(fields["x"])
    fixed = scheme_j.device_fixed_step(periodic=True)
    out = fixed(0.0, jnp.asarray(fields["U"][None]), jnp.zeros((0, N)),
                be.pack_pars(pars, x), x, dt)
    return np.asarray(out[0])


@pytest.mark.parametrize("which", ["rodaspr", "theta"])
def test_default_entries_match_node_layout_reference(which, monkeypatch):
    """The entries without the variable: the port's fixed step (K6's route
    at N = 8192) against the reference's node-layout step, float64."""
    monkeypatch.delenv("TRIFLOW_MEGATHETA", raising=False)
    eqs = KS
    fields, pars = state(eqs)
    model_j = tj.Model(*eqs, double=True)
    model_t = tt.Model(*eqs, device="cpu")
    if which == "rodaspr":
        make_j = lambda m: tj.schemes.RODASPR(m, time_stepping=False, tol=None)  # noqa: E731
        make_t = lambda m: tt.schemes.RODASPR(m, time_stepping=False, tol=None)  # noqa: E731
    else:
        make_j = lambda m: tj.schemes.Theta(m, theta=1.0)  # noqa: E731
        make_t = lambda m: tt.schemes.Theta(m, theta=1.0)  # noqa: E731
    want = _node_layout_reference(make_j(model_j), fields, pars, DT)
    scheme = make_t(model_t)
    _, fixed = scheme.device_fixed_step_folded(N, periodic=True)
    f, p = state_from_numpy(fields, pars, model_t)
    u, err = fixed(0.0, *scheme._split(f, p), 0.5, DT)
    got = u.numpy()
    assert np.abs(got - want).max() <= 1e-11 * np.abs(want).max()
    if which == "rodaspr":
        assert float(err) == np.inf  # no tolerance: the single-output table


def test_wrappers_refuse_devices_without_a_kernel():
    """No silent fallback: K9's entries raise on a tensor that is neither on
    the CPU nor on a CUDA device."""
    meta = {"device": "meta", "dtype": torch.float64}
    model = tt.Model(*BURGERS, device="cpu")
    plan = megatheta.plan_for(64, 1, 1)
    args = [torch.empty(shape, **meta) for shape in ((1, 64), (0, 64), (1, 64),
                                                      (64,))]
    with pytest.raises(ValueError, match="CUDA"):
        megatheta.interface(model.backend, plan, *args, -0.05, 0.05)
    shifts = [torch.empty((1, plan.C), **meta)] * 2
    with pytest.raises(ValueError, match="CUDA"):
        megatheta.correct(model.backend, plan, *args, -0.05, 0.05, *shifts)


def _k9_inputs(N=64, **bad):
    from .test_torch_stencil_J_plans import FakeCuda

    args = {"u": FakeCuda((1, N)), "helpers": FakeCuda((0, N)),
            "pstack": FakeCuda((1, N)), "x": FakeCuda((N,)),
            "xm1": FakeCuda((1, 2)), "xp1": FakeCuda((1, 2))}
    args.update({k: v if not isinstance(v, tuple) else FakeCuda(*v)
                 for k, v in bad.items()})
    return args


#: (id, bad inputs (shape, device, dtype, contiguous), error, message) of
#: K9's refusals at the plan of N = 64 nodes in two chunks
K9_FAULTS = [
    ("cpu-beside-cuda", {"helpers": ((0, 64), -1)}, ValueError, "CUDA tensors"),
    ("other-dtype", {"pstack": ((1, 64), 0, torch.float32)}, TypeError, "expected"),
    ("not-contiguous", {"x": ((64,), 0, torch.float64, False)}, ValueError,
     "contiguous"),
    ("x-shape", {"x": ((65,),)}, ValueError, "x has shape"),
    ("pstack-rows", {"pstack": ((2, 64),)}, ValueError, "pstack has shape"),
    ("other-grid", {"u": ((1, 128),)}, ValueError, "u has shape"),
    ("shifts-shape", {"xm1": ((1, 3),)}, ValueError, "expected"),
]


@pytest.mark.parametrize("bad,err,match", [c[1:] for c in K9_FAULTS],
                         ids=[c[0] for c in K9_FAULTS])
def test_wrappers_refuse_each_fault(monkeypatch, bad, err, match):
    """K9's entries, whose shapes are checked once per (plan, shapes):
    every call raises on a tensor off the card or beside CPU ones, of
    another dtype, not contiguous or of another shape (the correct entry
    also on its neighbours' unknowns), and a refused shape is never taken
    as checked."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    backend = tt.Model(*BURGERS, device="cpu").backend
    plan = megatheta.plan_for(64, 1, 1, C=2)
    args = _k9_inputs(**bad)
    before = dict(_launch._SHAPES)
    for _ in range(2):
        with pytest.raises(err, match=match):
            ins = [args[k] for k in ("u", "helpers", "pstack", "x")]
            if "xm1" in bad:
                megatheta.correct(backend, plan, *ins, -0.05, 0.05, args["xm1"],
                                  args["xp1"])
            else:
                megatheta.interface(backend, plan, *ins, -0.05, 0.05)
    assert _launch._SHAPES == before
