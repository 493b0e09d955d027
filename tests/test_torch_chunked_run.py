"""``Simulation.run(device_chunk=n)`` on the CPU: the chunked run against
the port's stepwise run, bit for bit (the same ``i``, the same times, the
same states, one stream emission and one post-process call per output
step, status ``"finished"``), and against the JAX package's chunked run
within 1e-10 (the port's forms of ``tests/test_simulation.py``'s chunked
cases); the hook tail, ``_chunk_cap``, the df64 mode, step doubling and the
failure prefix; and K6's adaptive scan with snapshots (its plain version)
bit for bit against n one-step adaptive launches' plain versions."""

import numpy as np
import pytest
import torch

import triflow_tpu as tj
import triflow_tpu_torch as tt
from triflow_tpu_torch.core.rosenbrock import adaptive_controller
from triflow_tpu_torch.ops import kernel_checks, megastep
from triflow_tpu_torch.utils.convert import state_from_numpy

from .test_torch_theta import KS, README

torch.set_num_threads(1)

HEAT = ("k * dxxT", "T", "k")


def heat_fields(N=50):
    x = np.linspace(0, 10, N, endpoint=False)
    return {"x": x, "T": np.cos(x * 2 * np.pi / 10)}


def dirichlet_jax(t, fields, parameters):
    fields["T"] = fields["T"].at[0].set(1.0).at[-1].set(1.0)
    return fields, parameters


def dirichlet_torch(t, fields, parameters):
    fields["T"][0] = 1.0
    fields["T"][-1] = 1.0
    return fields, parameters


def run(pkg, model, fields_np, pars, device_chunk, var="T", setup=None, **kw):
    """(t, final state, i, status, emissions [(i, t, state)], post-process
    calls) of a Simulation of either package."""
    if pkg is tt:
        fields, pars = state_from_numpy(fields_np, pars, model)
    else:
        fields = model.fields_template(**fields_np)
    sim = pkg.Simulation(model, fields, dict(pars), **kw)
    if setup is not None:
        setup(sim)
    seen, calls = [], []
    sim.stream.sink(lambda s: seen.append(
        (s.i, s.t, np.array(s.fields[var]) if pkg is tj
         else s.fields[var].clone())))
    sim.add_post_process("count", lambda s: calls.append(s.i))
    t, f = sim.run(progress=False, device_chunk=device_chunk)
    return t, f[var], sim.i, sim.status, seen, calls


def same_runs(a, b):
    ta, ua, ia, sa, seen_a, calls_a = a
    tb, ub, ib, sb, seen_b, calls_b = b
    assert (ta, ia, sa, calls_a) == (tb, ib, sb, calls_b)
    assert torch.equal(ua, ub)
    assert len(seen_a) == len(seen_b)
    for (i1, t1, u1), (i2, t2, u2) in zip(seen_a, seen_b):
        assert (i1, t1) == (i2, t2) and torch.equal(u1, u2)


def near_reference(port, ref, tol=1e-10):
    """The same i, status and times, and every emitted state within tol of
    the reference's (the reference hands back its df64 run's final fields
    rounded to float32, so the emissions are compared, not those)."""
    tp, _, ip, sp, seen_p, _ = port
    tr, _, ir, sr, seen_r, _ = ref
    assert np.isclose(tp, tr) and (ip, sp) == (ir, sr)
    assert len(seen_p) == len(seen_r)
    for (i1, t1, u1), (i2, t2, u2) in zip(seen_p, seen_r):
        assert i1 == i2 and np.isclose(t1, t2)
        assert np.abs(u1.numpy() - u2).max() <= tol


#: (id, Simulation kwargs): the adaptive default (K6's adaptive scan with
#: snapshots), fixed RODASPR and Theta (K6's step with snapshots)
HEAT_RUNS = [("defaults", dict(tol=1e-2)),
             ("rodaspr-fixed", dict(time_stepping=False, tol=None)),
             ("theta", dict(scheme="Theta", time_stepping=False))]


def _kw(pkg, kw):
    kw = dict(kw)
    if "scheme" in kw:
        kw["scheme"] = getattr(pkg.schemes, kw["scheme"])
    return kw


@pytest.mark.parametrize("name,kw", HEAT_RUNS, ids=[h[0] for h in HEAT_RUNS])
def test_run_device_chunk_matches_stepwise(name, kw):
    """The heat equation, output steps of 0.5 to 5.2 (ten full steps and a
    clamped tail): device_chunk=4 bit for bit against the stepwise run,
    and within 1e-10 of the reference's device_chunk=4 run."""
    model = tt.Model(*HEAT, device="cpu")
    pars = dict(k=1.0, periodic=True)
    args = (model, heat_fields(), pars)
    stepwise = run(tt, *args, 1, dt=0.5, tmax=5.2, **_kw(tt, kw))
    chunked = run(tt, *args, 4, dt=0.5, tmax=5.2, **_kw(tt, kw))
    same_runs(stepwise, chunked)
    assert chunked[2] == 11 and chunked[3] == "finished"
    ref = run(tj, tj.Model(*HEAT), heat_fields(), pars, 4, dt=0.5, tmax=5.2,
              **_kw(tj, kw))
    near_reference(chunked, ref)


def test_run_device_chunk_hook_tail():
    """A Dirichlet hook (the eager route) and tmax not a multiple of dt:
    the tail through the stepwise loop, the hook applied, bit for bit."""
    model = tt.Model(*HEAT, device="cpu")
    pars = dict(k=1.0, periodic=False)
    kw = dict(dt=1.0, tmax=6.5, tol=1e-2)
    stepwise = run(tt, model, heat_fields(), pars, 1, hook=dirichlet_torch, **kw)
    chunked = run(tt, model, heat_fields(), pars, 4, hook=dirichlet_torch, **kw)
    same_runs(stepwise, chunked)
    assert chunked[1][0] == 1.0 and chunked[2] == 7
    ref = run(tj, tj.Model(*HEAT), heat_fields(), pars, 4, hook=dirichlet_jax,
              **kw)
    near_reference(chunked, ref)


def test_stream_emissions():
    """One emission at the start and one per output step, in order."""
    model = tt.Model(*HEAT, device="cpu")
    fields, pars = state_from_numpy(heat_fields(), dict(k=1.0, periodic=True),
                                    model)
    sim = tt.Simulation(model, fields, pars, dt=0.5, tmax=3.0,
                        time_stepping=False, tol=None)
    seen = []
    sim.stream.sink(lambda s: seen.append((s.i, s.t, s.status)))
    sim.run(progress=False, device_chunk=4)
    assert [s[0] for s in seen] == list(range(7))
    assert [s[1] for s in seen[1:]] == pytest.approx(np.arange(1, 7) * 0.5)
    assert seen[0][2] == "created" and sim.status == "finished"


def test_chunk_cap():
    """A snapshot cap of three states on the instance: chunks of at most
    three output steps, the same run."""
    model = tt.Model(*HEAT, device="cpu")
    args = (model, heat_fields(), dict(k=1.0, periodic=True))
    kw = dict(dt=0.5, tmax=5.0, time_stepping=False, tol=None)
    calls = []

    def capped(sim):
        sim._CHUNK_SNAPSHOT_BYTES = 3 * 2 * 50 * 8
        steps = sim._scheme.device_steps

        def counting(t, fields, n, *a, **k):
            calls.append(n)
            return steps(t, fields, n, *a, **k)

        sim._scheme.device_steps = counting
        assert sim._chunk_cap() == 3

    stepwise = run(tt, *args, 1, **kw)
    chunked = run(tt, *args, 8, setup=capped, **kw)
    same_runs(stepwise, chunked)
    assert calls == [3, 3, 3, 1]


def test_df64_mode_chunked():
    """The df64 mode (float64 state, float32 step sizes, float32 decisions
    on a float64 clock: the host controller, the eager route) bit for bit
    against its stepwise run, and within 1e-10 of the reference's chunked
    run: the advection-diffusion case of ``test_torch_df64_sim.py``, whose
    tol = 1e-12 holds the two packages' states to about 1e-11."""
    N = 128
    x = np.linspace(0, 10, N, endpoint=False)
    fields = {"x": x, "U": np.cos(2 * np.pi / 10 * x)}
    pars = dict(periodic=True, k=0.05, c=0.3)
    model = tt.Model(*README, double="df64", device="cpu")
    kw = dict(dt=0.5, tmax=1.5, tol=1e-12)
    stepwise = run(tt, model, fields, pars, 1, var="U", **kw)
    chunked = run(tt, model, fields, pars, 3, var="U", **kw)
    same_runs(stepwise, chunked)
    ref = run(tj, tj.Model(*README, double="df64"), fields, pars, 3, var="U",
              **kw)
    near_reference(chunked, ref)


def test_step_doubling_chunked():
    """Theta wrapped in step doubling (``DeviceTimeStepping``, the eager
    route) bit for bit against its stepwise run."""
    model = tt.Model(*HEAT, device="cpu")
    args = (model, heat_fields(), dict(k=1.0, periodic=True))
    kw = dict(dt=0.5, tmax=2.0, scheme=tt.schemes.Theta, tol=1e-3)
    stepwise = run(tt, *args, 1, **kw)
    chunked = run(tt, *args, 3, **kw)
    same_runs(stepwise, chunked)
    sim = tt.Simulation(model, state_from_numpy(*args[1:], model)[0], args[2],
                        **kw)
    assert isinstance(sim._scheme, tt.schemes.DeviceTimeStepping)


def bench_ks_state(N):
    """The reference benchmark's KS state: x = 0.5 i, cos(20 pi i / N) +
    0.1 randn (seed 0)."""
    i = np.arange(N)
    rng = np.random.RandomState(0)
    return ({"x": 0.5 * i, "U": np.cos(2 * np.pi * 10 * i / N)
             + 0.1 * rng.randn(N)}, dict(periodic=True))


def _failing_run(device_chunk):
    """KS N = 8192, output steps of 1.0 at tol 1e-3, from the state after
    the first output step with the internal dt it left (past the ramp from
    the seed dt: 2, 1, 1, 1, 1, 1, 3 attempts in the next steps), and
    max_iter = 2: the seventh output step fails."""
    model = tt.Model(*KS, device="cpu")
    fields, pars = state_from_numpy(*bench_ks_state(8192), model)
    first = tt.Simulation(model, fields, pars, dt=1.0, tmax=1.0, tol=1e-3)
    first.run(progress=False)
    sim = tt.Simulation(model, first.fields, pars, dt=1.0, t=1.0, tmax=8.0,
                        tol=1e-3, max_iter=2)
    sim._scheme._internal_dt = first._scheme._internal_dt
    seen = []
    sim.stream.sink(lambda s: seen.append((s.i, s.t, s.fields["U"].clone())))
    with pytest.raises(RuntimeError, match="max iterations"):
        sim.run(progress=False, device_chunk=device_chunk)
    assert sim.status == "failed"
    return seen, sim._scheme.steps_route


def test_failure_prefix():
    """The chunked run emits the valid prefix (here across chunks of two)
    before it raises, as the stepwise run does."""
    stepwise, _ = _failing_run(1)
    chunked, route = _failing_run(2)
    assert route == "K6_adaptive"
    assert len(stepwise) == len(chunked) == 7
    for (i1, t1, u1), (i2, t2, u2) in zip(stepwise, chunked):
        assert (i1, t1) == (i2, t2) and torch.equal(u1, u2)


def test_adaptive_scan_plain_snapshots():
    """``adaptive_scan_plain`` with snapshots, bit for bit against n
    ``adaptive_plain`` output steps on K6's plan: each state, time, dt,
    attempts and status."""
    model = tt.Model(*KS, device="cpu")
    N = 256
    fields, pars = state_from_numpy(*bench_ks_state(N), model)
    u, h, x = model.backend.split_fields(fields)
    p = model.backend.pack_pars(pars, x)
    plan = megastep.plan_for(N, 1, 2, True)
    table = kernel_checks.rodaspr_table()
    n = 3
    snap = (torch.zeros((n, 1, N), dtype=torch.float64),
            np.zeros((n, megastep.SNAP_INFO)))
    args = (adaptive_controller, model.backend, plan, table, True)
    out = megastep.adaptive_scan_plain(*args, u, h, p, x, 0.0, 0.5, 1e-6, 1e-3,
                                       0.9, None, None, n, snap=snap)
    assert out[1:4:2] == (n, 0)
    t, dt_i, ui = np.float64(0.0), 1e-6, u
    for k in range(n):
        ui, dt_i, niter, status = megastep.adaptive_plain(
            *args, ui, h, p, x, t, 0.5, dt_i, 1e-3, 0.9, None, None)
        t = t + np.float64(0.5)
        assert torch.equal(snap[0][k], ui)
        assert tuple(snap[1][k]) == (t, dt_i, niter, status)
    assert torch.equal(out[0], ui)
    # the wrapper's snapshot output on CPU tensors is the same
    got = megastep.adaptive_scan(*args, u, h, p, x, 0.0, 0.5, 1e-6, 1e-3, 0.9,
                                 None, None, n, snapshots=True)
    assert torch.equal(got[-1][0], snap[0])
    assert np.array_equal(got[-1][1], snap[1])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest tests/test_torch_chunked_run.py -m cuda)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1 << 17, (1 << 17) + 1], ids=["cyclic", "padded-ring"])
@pytest.mark.parametrize("scheme", ["RODASPR", "Theta"])
def test_graph_route_matches_stepwise(cuda_device, scheme, N):
    """Fixed steps above K6's gate on the card: ``device_steps`` replays
    its captured graph (twice, the second from the first's last state),
    bit for bit against as many ``__call__`` calls, with the launch counts
    of those calls."""
    from triflow_tpu_torch.ops import _launch

    model = tt.Model(*KS, device=cuda_device)
    fields, pars = state_from_numpy(*bench_ks_state(N), model)
    make = (lambda: tt.schemes.RODASPR(model, time_stepping=False, tol=None)
            if scheme == "RODASPR" else tt.schemes.Theta(model))
    a, b = make(), make()
    _launch.reset_counters()
    want = _run_calls(a, fields, pars, 6, 0.01)
    calls = _launch.counts()
    _launch.reset_counters()
    t, got, status = b.device_steps(0.0, fields, 3, 0.01, pars)
    t, more, status = b.device_steps(t, got[-1][1], 3, 0.01, pars)
    assert b.steps_route == "graph" and status == 0
    assert _launch.counts() == calls
    for (tg, fg), (tw, fw) in zip(got + more, want):
        assert tg == tw and torch.equal(fg["U"], fw["U"])


def _run_calls(scheme, fields, pars, n, dt):
    t, out = 0.0, []
    for _ in range(n):
        t, fields = scheme(t, fields, dt, pars)
        out.append((t, fields))
    return out
