"""The port's host side: persistence containers, checkpoints, displays and
profiling, on the CPU.

The cases of ``tests/test_containers.py``, ``tests/test_checkpoint.py``
and ``tests/test_displays.py`` run on the port.  Besides, the two packages
share the on-disk layouts: a container or a checkpoint written by either
is read by the other with equal arrays (a Simulation's and an Ensemble's
checkpoint, in float64 and in the df64 mode, whose float64 state the
reference stores as hi + lo), a resumed run is bit for bit the
uninterrupted one, an ensemble's container carries the member axis, and
``run(device_chunk=n)`` feeds the container one frame per snapshot, as the
stepwise loop does.
"""

import numpy as np
import pytest
import torch

import triflow_tpu as tj
import triflow_tpu_torch as tt
from triflow_tpu_torch import Container, retrieve_container
from triflow_tpu_torch.parallel import Ensemble
from triflow_tpu_torch.plugins.container import (LazyTimeSeries, TimeSeries,
                                                 coerce_attr)
from triflow_tpu_torch.utils.convert import ensemble_from_numpy, state_from_numpy
from triflow_tpu_torch.utils.profiling import step_breakdown, trace

torch.set_num_threads(1)

HEAT = ("k * dxxT", "T", "k")
BURGERS_K = ("k * dxxU - U * dxU", "U", "k")


@pytest.fixture(scope="module")
def heat_model():
    return tt.Model(*HEAT, device="cpu")


@pytest.fixture(scope="module")
def burgers():
    return tt.Model(*BURGERS_K, device="cpu")


def heat_simul(model, tmax=10, **kw):
    x = np.linspace(0, 10, 50, endpoint=False)
    fields, pars = state_from_numpy({"x": x, "T": np.cos(x * 2 * np.pi / 10)},
                                    dict(periodic=True, k=1), model)
    return tt.Simulation(model, fields, pars, dt=1, tmax=tmax, tol=1e-1, **kw)


def run_simul(model, path=None, save="all", nbuffer=7, tmax=10):
    simul = heat_simul(model, tmax=tmax, id="test_simul")
    simul.attach_container(path, save=save, nbuffer=nbuffer, force=True)
    simul.run(progress=False)
    return simul


def burgers_initial(model, N=128):
    x = np.linspace(0, 10, N, endpoint=False)
    return state_from_numpy({"x": x, "U": np.cos(2 * np.pi * x / 10)},
                            dict(periodic=True, k=0.3), model)


# ---------------------------------------------------------------- containers
def test_coerce_attr():
    assert coerce_attr("a", 1) == 1
    assert coerce_attr("a", 1.5) == 1.5
    assert coerce_attr("a", "x") == "x"
    assert coerce_attr("a", np.float64(2.0)) == 2.0
    assert isinstance(coerce_attr("a", object()), str)


def test_in_memory_container(heat_model):
    simul = run_simul(heat_model, path=None)
    data = simul.container.data
    assert len(data.t) == 11  # initial emit + 10 steps
    assert data["T"].shape == (11, 50)
    assert isinstance(data["T"], np.ndarray)
    assert np.isclose(data.t[-1], 10)
    assert np.array_equal(data["T"][-1], simul.fields["T"].numpy())


def test_on_disk_matches_memory(heat_model, tmp_path):
    mem = run_simul(heat_model, path=None)
    disk = run_simul(heat_model, path=str(tmp_path / "out"))
    data = retrieve_container(str(tmp_path / "out" / disk.id)).data
    mem_data = mem.container.data
    assert np.array_equal(data["T"], mem_data["T"])
    assert np.array_equal(data.t, mem_data.t)


def test_save_last(heat_model, tmp_path):
    simul = run_simul(heat_model, path=str(tmp_path / "last"), save="last",
                      nbuffer=3)
    retrieved = retrieve_container(str(tmp_path / "last" / simul.id))
    assert len(np.atleast_1d(retrieved.data.t)) == 1
    assert np.isclose(retrieved.data.t[-1], 10)


def test_metadata_roundtrip(heat_model, tmp_path):
    simul = run_simul(heat_model, path=str(tmp_path / "meta"))
    retrieved = retrieve_container(str(tmp_path / "meta" / simul.id))
    assert retrieved.metadata["k"] == 1
    assert retrieved.metadata["periodic"] in (True, 1)
    assert retrieved.metadata.k == 1


@pytest.mark.parametrize("isel", ["all", "last", -1, slice(0, 5), [0, 2, 4]])
def test_retrieve_isel_modes(heat_model, tmp_path, isel):
    simul = run_simul(heat_model, path=str(tmp_path / "isel"))
    retrieved = retrieve_container(str(tmp_path / "isel" / simul.id), isel=isel)
    if isel == "all":
        assert len(retrieved.data.t) == 11
    elif isel in ("last", -1):
        assert np.isclose(np.atleast_1d(retrieved.data.t)[-1], 10)
    elif isinstance(isel, slice):
        assert len(retrieved.data.t) == 5
    else:
        assert len(retrieved.data.t) == 3


def test_merge_chunks(heat_model, tmp_path):
    simul = run_simul(heat_model, path=str(tmp_path / "merge"), nbuffer=3)
    cdir = tmp_path / "merge" / simul.id
    assert (cdir / "data.h5").exists()
    assert list(cdir.glob("data_*.h5")) == []
    data = retrieve_container(str(cdir)).data
    assert len(data.t) == 11
    assert np.all(np.diff(data.t) > 0)


def test_mode_w_existing_raises(tmp_path):
    target = tmp_path / "exists"
    target.mkdir()
    (target / "sentinel").write_text("x")
    with pytest.raises(FileExistsError):
        Container(str(target), mode="w", force=False)


def test_mode_r_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        Container(str(tmp_path / "nope"), mode="r")


def test_save_argument_validation():
    with pytest.raises(ValueError):
        Container(save="everything")


def test_timeseries_concat_and_equals():
    x = np.arange(4.0)
    a = TimeSeries([0.0], {"x": x}, {"U": np.ones((1, 4))})
    b = TimeSeries([1.0, 2.0], {"x": x}, {"U": np.zeros((2, 4))})
    cat = TimeSeries.concat([b, a])
    assert np.allclose(cat.t, [0, 1, 2])
    assert cat.equals(TimeSeries.concat([a, b]))
    assert not cat.equals(a)


def test_retrieve_lazy_duplicate_isel(heat_model, tmp_path):
    simul = run_simul(heat_model, path=str(tmp_path / "lazydup"))
    path = str(tmp_path / "lazydup" / simul.id)
    eager = retrieve_container(path).data
    lazy = retrieve_container(path, lazy=True).data
    n = len(np.atleast_1d(eager.t))
    sel = lazy.isel(t=[0, 0, n - 1, -1])
    assert np.array_equal(sel.t, eager.t[[0, 0, n - 1, n - 1]])
    assert np.array_equal(sel["T"][0], sel["T"][1])
    assert np.array_equal(sel["T"][2], sel["T"][3])
    assert np.array_equal(sel["T"][0], eager["T"][0])


def test_retrieve_lazy(heat_model, tmp_path):
    simul = run_simul(heat_model, path=str(tmp_path / "lazy"))
    path = str(tmp_path / "lazy" / simul.id)
    eager = retrieve_container(path)
    lazy_all = retrieve_container(path, lazy=True)
    assert isinstance(lazy_all.data, LazyTimeSeries)
    assert np.array_equal(lazy_all.data.t, eager.data.t)
    assert lazy_all.data.load().equals(eager.data)
    lazy_last = retrieve_container(path, isel="last", lazy=True)
    assert np.allclose(lazy_last.data["T"], eager.data.isel(t=-1)["T"])
    lazy_slice = retrieve_container(path, isel=slice(1, 3), lazy=True)
    assert np.allclose(lazy_slice.data["T"], eager.data.isel(t=slice(1, 3))["T"])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_container_read_by_the_other_package(tmp_path, writer):
    """One layout: a container written by either package (chunks, then the
    end-of-run merge) is read by the other's ``retrieve`` with equal
    arrays, times and metadata."""
    x = np.linspace(0, 10, 50, endpoint=False)
    T0 = np.cos(x * 2 * np.pi / 10)
    if writer == "port":
        model = tt.Model(*HEAT, device="cpu")
        fields, pars = state_from_numpy({"x": x, "T": T0}, dict(periodic=True, k=1),
                                        model)
        simul = tt.Simulation(model, fields, pars, dt=1, tmax=5, tol=1e-1)
        reader = tj.Container.retrieve
    else:
        model = tj.Model(*HEAT)
        simul = tj.Simulation(model, model.fields_template(x=x, T=T0),
                              dict(periodic=True, k=1), dt=1, tmax=5, tol=1e-1)
        reader = tt.Container.retrieve
    simul.attach_container(str(tmp_path), nbuffer=2)
    simul.run(progress=False)
    path = str(tmp_path / simul.id)
    mine = (tt.Container.retrieve if writer == "port" else tj.Container.retrieve)(path)
    theirs = reader(path)
    assert np.array_equal(theirs.data.t, mine.data.t)
    assert np.array_equal(theirs.data["T"], mine.data["T"])
    assert np.array_equal(theirs.data["x"], x)
    assert np.array_equal(theirs.data["T"][-1], np.asarray(simul.fields["T"]))
    assert theirs.metadata.k == mine.metadata.k == 1


def test_chunked_run_feeds_one_frame_per_snapshot(heat_model):
    """``run(device_chunk=n)`` emits every snapshot to the container, so
    its frames equal the stepwise run's."""
    frames = []
    for chunk in (1, 4):
        simul = heat_simul(heat_model, tmax=10)
        simul.attach_container(None)
        simul.run(progress=False, device_chunk=chunk)
        frames.append(simul.container.data)
    assert len(frames[1].t) == 11
    assert frames[0].equals(frames[1])


def test_ensemble_container_roundtrip(tmp_path):
    """The whole sweep in one container: data[var] retrieves as (T, B, N)
    and matches the stepped trajectory frame for frame; the in-memory
    mode sees the same frames, and the reference's retrieve reads it."""
    model = tt.Model(*HEAT, device="cpu")
    N, B = 32, 3
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.stack([np.cos(2 * np.pi * x / 10 * (m + 1)) for m in range(B)])
    pars = [dict(k=0.1 * (m + 1), periodic=True) for m in range(B)]

    def make():
        return Ensemble(model, **ensemble_from_numpy(model, u0, x, pars),
                        scheme=tt.schemes.ROS2)

    ens = make()
    cont = ens.attach_container(str(tmp_path / "sweep"), nbuffer=2, force=True)
    traj = [ens.u.numpy().copy()]
    for _ in range(4):
        ens.step(0.1)
        traj.append(ens.u.numpy().copy())
    cont.flush()
    path = str(tmp_path / "sweep" / ens.id)
    data = retrieve_container(path).data
    assert data["T"].shape == (5, B, N)
    assert np.array_equal(data["member"], np.arange(B))
    assert np.array_equal(data["x"], x)
    for i, snap in enumerate(traj):
        assert np.array_equal(data["T"][i], snap[:, 0])
    assert np.isclose(data.t[-1], ens.t)
    assert np.array_equal(tj.Container.retrieve(path).data["T"], data["T"])
    ens2 = make()
    ens2.attach_container(None)
    for _ in range(4):
        ens2.step(0.1)
    assert np.array_equal(ens2.container.data["T"], data["T"])


# --------------------------------------------------------------- checkpoints
def test_checkpoint_resume_matches_uninterrupted(burgers, tmp_path):
    fields, pars = burgers_initial(burgers)
    ref = tt.Simulation(burgers, fields, dict(pars), dt=0.5, tmax=2.0, tol=1e-8)
    ref.run(progress=False)
    fields, pars = burgers_initial(burgers)
    first = tt.Simulation(burgers, fields, dict(pars), dt=0.5, tmax=2.0,
                          tol=1e-8)
    for t, _ in first:
        if t >= 1.0:
            break
    ckpt = tmp_path / "run.ckpt.h5"
    first.save_checkpoint(ckpt)
    resumed = tt.Simulation.from_checkpoint(ckpt, burgers, tol=1e-8)
    assert resumed.t == 1.0 and resumed.i == first.i
    assert resumed._scheme._internal_dt == first._scheme._internal_dt
    resumed.run(progress=False)
    assert resumed.t == ref.t
    assert torch.equal(resumed.fields["U"], ref.fields["U"])


def test_checkpoint_preserves_parameters(burgers, tmp_path):
    fields, _ = burgers_initial(burgers)
    simul = tt.Simulation(burgers, fields, dict(periodic=True, k=0.123),
                          dt=0.5, tmax=5, tol=1e-4)
    next(simul)
    ckpt = tmp_path / "p.h5"
    simul.save_checkpoint(ckpt)
    resumed = tt.Simulation.from_checkpoint(ckpt, burgers, tol=1e-4)
    assert resumed.parameters["k"] == pytest.approx(0.123)
    assert bool(resumed.parameters["periodic"]) is True
    assert resumed.tmax == 5


def test_failure_flushes_container(burgers, tmp_path):
    """On RuntimeError the buffered frames land on disk."""
    fields, pars = burgers_initial(burgers)
    simul = tt.Simulation(burgers, fields, pars, dt=0.5, tmax=10, tol=1e-6,
                          max_iter=3)
    simul.attach_container(str(tmp_path), nbuffer=1000)
    with pytest.raises(RuntimeError):
        simul.run(progress=False)
    assert simul.status == "failed"
    assert list((tmp_path / simul.id).glob("data_*.h5"))


def test_step_breakdown(burgers):
    fields, pars = burgers_initial(burgers)
    simul = tt.Simulation(burgers, fields, pars, dt=0.5, tol=1e-4)
    out = step_breakdown(simul, n=2)
    assert out["total_s"] > 0 and out["per_step_s"] > 0
    assert out["total_s"] >= out["device_s"] - 1e-9


def test_trace_writes_a_chrome_trace(burgers, tmp_path):
    fields, pars = burgers_initial(burgers, N=32)
    simul = tt.Simulation(burgers, fields, pars, dt=0.5, tmax=0.5, tol=1e-4)
    with trace(tmp_path / "tb"):
        simul.run(progress=False)
    assert (tmp_path / "tb" / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_read_by_the_other_package(tmp_path, writer):
    """A Simulation's checkpoint written by either package resumes in the
    other with equal state, clock, step count, internal dt and
    parameters."""
    N = 64
    x = np.linspace(0, 10, N, endpoint=False)
    U0 = np.cos(2 * np.pi * x / 10)
    pars = dict(periodic=True, k=0.3)
    model_j = tj.Model(*BURGERS_K)
    model_t = tt.Model(*BURGERS_K, device="cpu")
    if writer == "port":
        fields, pars_t = state_from_numpy({"x": x, "U": U0}, pars, model_t)
        simul = tt.Simulation(model_t, fields, pars_t, dt=0.5, tmax=2.0, tol=1e-6)
        load = tj.Simulation.from_checkpoint
        other = model_j
    else:
        simul = tj.Simulation(model_j, model_j.fields_template(x=x, U=U0), pars,
                              dt=0.5, tmax=2.0, tol=1e-6)
        load = tt.Simulation.from_checkpoint
        other = model_t
    next(simul)
    next(simul)
    path = simul.save_checkpoint(tmp_path / "c.h5")
    resumed = load(path, other, tol=1e-6)
    assert resumed.t == simul.t and resumed.i == simul.i == 2
    assert resumed.tmax == 2.0 and resumed.id == simul.id
    assert resumed._scheme._internal_dt == float(simul._scheme._internal_dt)
    assert float(resumed.parameters["k"]) == 0.3
    assert np.array_equal(np.asarray(resumed.fields["U"]),
                          np.asarray(simul.fields["U"]))


@pytest.mark.parametrize("double", [True, "df64"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_ensemble_checkpoint_read_by_the_other_package(tmp_path, writer, double):
    """An Ensemble's checkpoint written by either package is read by the
    other: the same clock, id and internal dt (per member, float64 with an
    adaptive RODASPR), and the same float64 state.  In the df64 mode (a
    Theta sweep) the reference stores its double-float state as hi + lo,
    which the port reads exactly; the port stores its native float64
    state, which the reference reads as its own double-float split of
    that value."""
    from triflow_tpu.ops.df64 import DF, host64
    from triflow_tpu.parallel import Ensemble as EnsembleJ

    N, B = 32, 2
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.stack([np.cos(2 * np.pi * x / 10 + i) for i in range(B)])
    pars = [dict(k=0.5, periodic=True), dict(k=1.0, periodic=True)]
    if double == "df64":
        kw_j = dict(scheme=tj.schemes.Theta, theta=1.0)
        kw_t = dict(scheme=tt.schemes.Theta, theta=1.0)
    else:
        kw_j = dict(scheme=tj.schemes.RODASPR, tol=1e-4, per_member_dt=True)
        kw_t = dict(scheme=tt.schemes.RODASPR, tol=1e-4, per_member_dt=True)
    model_j = tj.Model(*BURGERS_K, double=double)
    model_t = tt.Model(*BURGERS_K, device="cpu", double=double)
    if writer == "port":
        ens = Ensemble(model_t, **ensemble_from_numpy(model_t, u0, x, pars),
                       **kw_t)
        ens.step(0.125)
        u_w = ens.u.numpy()
        res = EnsembleJ.from_checkpoint(ens.save_checkpoint(tmp_path / "e.h5"),
                                        model_j, **kw_j)
        u_r = host64(res.u)
        if double == "df64":
            u_w = host64(DF.from_float64(u_w))
    else:
        ens = EnsembleJ(model_j, u0, pars, x, **kw_j)
        ens.step(0.125)
        u_w = host64(ens.u)
        res = Ensemble.from_checkpoint(ens.save_checkpoint(tmp_path / "e.h5"),
                                       model_t, **kw_t)
        u_r = res.u.numpy()
    assert res.t == ens.t and res.id == ens.id
    assert np.array_equal(u_r, u_w)
    if double is True:
        assert np.array_equal(np.asarray(res._internal_dt),
                              np.asarray(ens._internal_dt))


def test_ensemble_checkpoint_resume(tmp_path):
    """A resumed sweep lands on the uninterrupted one bit for bit, shared
    and per-member internal dt."""
    model = tt.Model(*HEAT, device="cpu")
    N, B = 32, 3
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.stack([np.cos(2 * np.pi * x / 10 * (m + 1)) for m in range(B)])
    pars = [dict(k=0.5 * (m + 1), periodic=True) for m in range(B)]
    for per_member in (False, True):
        kw = dict(scheme=tt.schemes.RODASPR, tol=1e-6, per_member_dt=per_member)
        ens = Ensemble(model, **ensemble_from_numpy(model, u0, x, pars), **kw)
        ens.step(0.2)
        ens.step(0.2)
        path = ens.save_checkpoint(tmp_path / f"sweep{per_member}.ckpt")
        ens.step(0.2)
        ens.step(0.2)
        res = Ensemble.from_checkpoint(path, model, **kw)
        assert res.t == pytest.approx(0.4) and res.id == ens.id
        assert np.ndim(res._internal_dt) == (1 if per_member else 0)
        res.step(0.2)
        res.step(0.2)
        assert res.t == ens.t
        assert torch.equal(res.u, ens.u)


def test_ensemble_df64_checkpoint_roundtrip(tmp_path):
    """A df64 ensemble's float64 state and internal dt survive the
    checkpoint bit for bit, and the resumed sweep is bit for bit the
    uninterrupted one."""
    N, B = 48, 2
    x = np.linspace(0, 10, N, endpoint=False)
    u0 = np.stack([np.cos(2 * np.pi * x / 10 + i) for i in range(B)])
    model = tt.Model("k * dxxU", "U", "k", double="df64", device="cpu")
    pars = dict(k=0.5, periodic=True)
    kw = dict(scheme=tt.schemes.Theta, theta=1.0)
    ens = Ensemble(model, **ensemble_from_numpy(model, u0, x, pars), **kw)
    ens.run(tmax=0.25, dt=0.125)
    path = ens.save_checkpoint(tmp_path / "ens_df64.h5")
    ens2 = Ensemble.from_checkpoint(path, model, **kw)
    assert ens2.t == ens.t
    assert ens2.u.dtype == torch.float64 and torch.equal(ens2.u, ens.u)
    ens.run(tmax=0.5, dt=0.125)
    ens2.run(tmax=0.5, dt=0.125)
    assert torch.equal(ens2.u, ens.u)


# ------------------------------------------------------------------ displays
def test_display_fields(heat_model):
    simul = heat_simul(heat_model, tmax=5)
    tt.display_fields(simul)
    simul.run(progress=False)


def test_display_probe(heat_model):
    simul = heat_simul(heat_model, tmax=5)
    tt.display_probe(simul, function=lambda s: s.timer.total)
    simul.run(progress=False)


@pytest.mark.parametrize("fmt", ["png", "svg", "pdf"])
def test_display_on_disk_frame_count(heat_model, tmp_path, fmt):
    simul = heat_simul(heat_model, tmax=5)
    tt.display_fields(simul, on_disk=str(tmp_path), fmt=fmt)
    simul.run(progress=False)
    assert len(list(tmp_path.glob(f"*.{fmt}"))) == simul.i + 1


def test_display_probe_on_disk(heat_model, tmp_path):
    simul = heat_simul(heat_model, tmax=3)
    tt.display_probe(simul, function=lambda s: s.fields["T"].abs().max(),
                     on_disk=str(tmp_path))
    simul.run(progress=False)
    assert len(list(tmp_path.glob("*.png"))) == simul.i + 1


def test_display_throttle_every(heat_model, tmp_path):
    simul = heat_simul(heat_model, tmax=8)
    tt.display_fields(simul, on_disk=str(tmp_path / "thr"), every=2)
    simul.run(progress=False)
    frames = list((tmp_path / "thr").glob("*.png"))
    assert 2 < len(frames) < 9


def test_display_async_drains_final_frame(heat_model):
    simul = heat_simul(heat_model, tmax=5)
    seen = []

    def probe(data, fig):
        seen.append(float(data.t))
        ax = fig.add_subplot(111)
        ax.plot(data.fields["T"].numpy())

    d = tt.Display(simul, probe, asynchronous=True)
    d.connect(simul.stream)
    simul.run(progress=False)
    d.close()
    assert not d._thread.is_alive()
    assert seen and seen[-1] == 5.0


def test_live_handle_updates_in_place(heat_model, monkeypatch):
    updates = []

    class FakeHandle:
        def update(self, fig):
            updates.append(fig)

    monkeypatch.setattr(tt.Display, "_make_live_handle",
                        lambda self, live: FakeHandle())
    sim = heat_simul(heat_model, tmax=3)
    tt.Display.display_fields(sim)
    for _t, _fields in sim:
        pass
    assert len(updates) == sim.i + 2


def test_live_disabled_outside_kernel(heat_model):
    sim = heat_simul(heat_model, tmax=2)
    d = tt.display_fields(sim, live=False)
    assert d._handle is None
