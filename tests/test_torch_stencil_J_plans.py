"""The short launch paths of K1's J entry and of K7 (the banded matvec):
the wrappers' refusals, the shape cache they share with K1's F entry
(``_launch.shape_cache``), and the plain versions CPU tensors take.

CPU only: the wrappers' checks are host code (``ops/stencil.py:eval_J``,
``ops/matvec.py:banded_matvec``); K7's choice of body is its C entry's.
The kernels themselves are held against their plain versions and, bit for
bit, against the bodies of before their tiles on the card
(``tests/test_torch_kernels.py``: ``test_tiled_J_matches_plain_version``,
``test_matvec_matches_plain_version_and_nodes_body``).
"""

import numpy as np
import pytest
import torch

from triflow_tpu_torch import Model
from triflow_tpu_torch.ops import _launch, kernel_checks, matvec, stencil

from .test_torch_setup_plans import FakeCuda as SetupFake

torch.set_num_threads(1)

N = 64


class FakeCuda(SetupFake):
    """``test_torch_setup_plans.FakeCuda`` with the element size and the
    address the wrappers read."""

    def element_size(self):
        return torch.finfo(self.dtype).bits // 8

    def data_ptr(self):
        return 256


def j_inputs(B=None, **bad):
    """FakeCuda inputs of K1's J entry for the README model (one variable,
    two parameters), with ``bad`` ones in their place."""
    lead = () if B is None else (B,)
    args = {"u": FakeCuda((*lead, 1, N)), "helpers": FakeCuda((*lead, 0, N)),
            "pstack": FakeCuda((*lead, 2, N)), "x": FakeCuda((N,))}
    args.update(bad)
    return args


#: (id, inputs, error, message) of K1's J entry's refusals
J_FAULTS = [
    ("cpu-beside-cuda", j_inputs(helpers=FakeCuda((0, N), dev=-1)), ValueError,
     "CUDA tensors"),
    ("other-device", j_inputs(u=FakeCuda((1, N), dev=1)), ValueError, "current device"),
    ("other-dtype", j_inputs(pstack=FakeCuda((2, N), dtype=torch.float32)), TypeError,
     "expected"),
    ("not-contiguous", j_inputs(x=FakeCuda((N,), contiguous=False)), ValueError,
     "contiguous"),
    ("x-shape", j_inputs(x=FakeCuda((N + 1,))), ValueError, "u has shape"),
    ("pstack-rows", j_inputs(pstack=FakeCuda((1, N))), ValueError, "pstack has shape"),
    ("member-count", j_inputs(B=4, helpers=FakeCuda((3, 0, N))), ValueError,
     "helpers has shape"),
    ("dimensions", j_inputs(u=FakeCuda((2, 2, 1, N))), ValueError, "dimensions"),
]


@pytest.fixture
def readme_backend(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return Model("k * dxxU - c * dxU", "U", ["k", "c"], device="cpu").backend


@pytest.mark.parametrize("args,err,match", [c[1:] for c in J_FAULTS],
                         ids=[c[0] for c in J_FAULTS])
def test_J_wrapper_refuses_each_fault(readme_backend, args, err, match):
    """K1's J entry raises on every call, for a tensor off the current
    device or on the CPU beside CUDA ones, of another dtype, not
    contiguous, of another shape or member count; a refused shape is never
    cached as checked."""
    before = dict(_launch._SHAPES)
    for _ in range(2):
        with pytest.raises(err, match=match):
            stencil.eval_J(readme_backend, args["u"], args["helpers"], args["pstack"],
                           args["x"], True)
    assert _launch._SHAPES == before


def mv_inputs(B=None, W=5, nvar=1, **bad):
    lead = () if B is None else (B,)
    args = {"bands": FakeCuda((*lead, W, nvar, nvar, N)), "v": FakeCuda((*lead, nvar, N)),
            "scale": 0.5}
    args.update(bad)
    return args


#: (id, inputs, error, message) of K7's refusals
K7_FAULTS = [
    ("cpu-beside-cuda", mv_inputs(bands=FakeCuda((5, 1, 1, N), dev=-1)), ValueError,
     "CUDA tensors"),
    ("other-device", mv_inputs(bands=FakeCuda((5, 1, 1, N), dev=1)), ValueError,
     "current device"),
    ("other-dtype", mv_inputs(bands=FakeCuda((5, 1, 1, N), dtype=torch.float32)),
     TypeError, "expected"),
    ("not-contiguous", mv_inputs(v=FakeCuda((1, N), contiguous=False)), ValueError,
     "contiguous"),
    ("v-shape", mv_inputs(v=FakeCuda((1, N + 1))), ValueError, "v has shape"),
    ("bands-shape", mv_inputs(bands=FakeCuda((5, 1, 2, N))), ValueError,
     "bands has shape"),
    ("member-count", mv_inputs(B=4, bands=FakeCuda((3, 5, 1, 1, N))), ValueError,
     "bands has shape"),
    ("bands-dimensions", mv_inputs(bands=FakeCuda((1, N))), ValueError, "beside v"),
    ("too-many-members", mv_inputs(B=matvec.MAX_MEMBERS + 1), NotImplementedError,
     "members"),
]


@pytest.mark.parametrize("args,err,match", [c[1:] for c in K7_FAULTS],
                         ids=[c[0] for c in K7_FAULTS])
def test_matvec_wrapper_refuses_each_fault(monkeypatch, args, err, match):
    """K7 raises on every call, for a tensor off the current device or on
    the CPU beside CUDA ones, of another dtype, not contiguous, of another
    shape or member count, or more members than its grid takes; a refused
    shape is never cached as checked.  (A faulty per-member scale:
    ``test_matvec_short_path_checks_shapes_once``.)"""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    before = dict(_launch._SHAPES)
    for _ in range(2):
        with pytest.raises(err, match=match):
            matvec.banded_matvec(args["bands"], args["v"], True, args["scale"])
    assert _launch._SHAPES == before


class FakeLib:
    """A kernel library that binds entries without building: each entry
    records its arguments and reports success."""

    def __init__(self):
        self.calls, self.bound = [], []

    def fn(self, name, *counts):
        self.bound.append(name)
        return lambda *args: self.calls.append((name, args)) or 0

    def check(self, rc, what):
        assert rc == 0


@pytest.fixture
def fake_launch(monkeypatch):
    """The wrappers' launches on FakeCuda tensors: a FakeLib for K7's
    library, outputs allocated as FakeCuda tensors, stream 0."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    lib = FakeLib()
    monkeypatch.setattr(matvec, "LIB", lib)
    monkeypatch.setattr(matvec, "stream_of", lambda t: 0)
    monkeypatch.setattr(stencil, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch, "empty_like", lambda t: FakeCuda(t.shape, dtype=t.dtype))
    monkeypatch.setattr(torch, "empty", lambda shape, dtype, device: FakeCuda(shape,
                                                                              dtype=dtype))
    _launch._SHAPES.clear()
    return lib


def cached(entry):
    """The shape cache's keys of one entry ("F", "J" or "K7")."""
    return [k for k in _launch._SHAPES if k[0] == entry]


def test_matvec_short_path_checks_shapes_once(fake_launch):
    """K7's entry is bound and its shapes checked at the first call of a
    shape only; later calls of that shape launch at once (and count), and
    still refuse a tensor of another device, dtype or contiguity and a
    faulty per-member scale on every call."""
    lib = fake_launch
    bands, v = FakeCuda((4, 5, 1, 1, N)), FakeCuda((4, 1, N))
    scale = 0.25
    before = _launch.counts()["K7.matvec"]
    for _ in range(3):
        matvec.banded_matvec(bands, v, True, scale)
    assert lib.bound == ["tf_matvec_f64"]
    assert len(cached("K7")) == 1 and len(lib.calls) == 3
    assert _launch.counts()["K7.matvec"] == before + 3
    # (bands, v, out, scale, W, nvar, N, B, periodic, number, stream)
    assert lib.calls[0][1][4:10] == (5, 1, N, 4, 1, 0.25)
    # a per-member scale on the CPU (of the right shape, and of another)
    faults = [((FakeCuda((4, 5, 1, 1, N), dev=1), v, scale), ValueError),
              ((bands, FakeCuda((4, 1, N), dtype=torch.float32), scale), TypeError),
              ((bands, FakeCuda((4, 1, N), contiguous=False), scale), ValueError),
              ((bands, v, torch.ones(4, dtype=torch.float64)), ValueError),
              ((bands, v, torch.ones(5, dtype=torch.float64)), ValueError)]
    for args, err in faults:
        for _ in range(2):
            with pytest.raises(err):
                matvec.banded_matvec(*args[:2], True, args[2])
    assert len(lib.calls) == 3 and len(cached("K7")) == 1
    # the body of before is bound apart and launches uncounted
    matvec.banded_matvec_nodes(bands, v, False, 0.5)
    assert lib.bound[-1] == "tf_matvec_nodes_f64"
    assert _launch.counts()["K7.matvec"] == before + 3


def test_J_short_path_checks_shapes_once(readme_backend, fake_launch, monkeypatch):
    """K1's J entry is bound and its shapes checked at the first call of a
    shape only, later calls launch at once (and count), and a tensor of
    another device, dtype or contiguity is refused on every call."""
    lib = FakeLib()
    monkeypatch.setattr(readme_backend, "stencil", lib)
    args = j_inputs(B=3)
    before = _launch.counts()["K1.J"]
    for _ in range(3):
        bands = stencil.eval_J(readme_backend, *args.values(), False)
    assert tuple(bands.shape) == (3, 3, 1, 1, N)
    assert lib.bound == ["tf_stencil_J_f64"] and len(lib.calls) == 3
    assert _launch.counts()["K1.J"] == before + 3
    # (u, helpers, pstack, x, bands, N, B, periodic, stream)
    assert lib.calls[0][1][5:8] == (N, 3, 0)
    for bad, err in ((dict(u=FakeCuda((3, 1, N), dev=1)), ValueError),
                     (dict(x=FakeCuda((N,), dtype=torch.float32)), TypeError),
                     (dict(pstack=FakeCuda((3, 2, N), contiguous=False)), ValueError)):
        for _ in range(2):
            with pytest.raises(err):
                stencil.eval_J(readme_backend, *{**args, **bad}.values(), True)
    assert len(lib.calls) == 3 and len(cached("J")) == 1
    stencil.eval_J_nodes(readme_backend, *args.values(), True)
    assert lib.bound[-1] == "tf_stencil_J_nodes_f64"
    assert _launch.counts()["K1.J"] == before + 3


def test_shape_cache_makes_each_key_once():
    """An entry is made once per key and read back after; keys of the
    three entries apart."""
    _launch._SHAPES.clear()
    made = []

    def make(*args):
        made.append(args)
        return args

    for _ in range(3):
        assert _launch.shape_cache(("K7", 1), make, "a") == ("a",)
    assert _launch.shape_cache(("J", 1), make, "b") == ("b",)
    assert made == [("a",), ("b",)]
    assert set(_launch._SHAPES) == {("K7", 1), ("J", 1)}


def test_shape_cache_keeps_nothing_of_a_refused_shape():
    """A key whose checks raise is not cached, and is checked again (and
    refused again) at the next call."""
    _launch._SHAPES.clear()
    calls = []

    def refuse():
        calls.append(1)
        raise ValueError("refused")

    for _ in range(2):
        with pytest.raises(ValueError, match="refused"):
            _launch.shape_cache(("K7", 2), refuse)
    assert calls == [1, 1] and not _launch._SHAPES


def test_shape_cache_empties_only_to_insert():
    """A full cache still serves its keys, and is emptied only when a new
    key is inserted, which it then holds alone."""
    _launch._SHAPES.clear()
    for k in range(_launch.MAX_SHAPES):
        _launch.shape_cache(("F", k), lambda k=k: k)
    assert _launch.shape_cache(("F", 0), pytest.fail) == 0
    assert len(_launch._SHAPES) == _launch.MAX_SHAPES
    assert _launch.shape_cache(("F", -1), lambda: -1) == -1
    assert _launch._SHAPES == {("F", -1): -1}


def test_J_nodes_leaves_the_shape_cache_alone(readme_backend, fake_launch, monkeypatch):
    """The per-node J (on no path) checks its shapes every call and neither
    reads nor empties the main path's cache, even a full one."""
    monkeypatch.setattr(readme_backend, "stencil", FakeLib())
    for k in range(_launch.MAX_SHAPES):
        _launch._SHAPES[("F", k)] = k
    full = dict(_launch._SHAPES)
    for _ in range(2):
        stencil.eval_J_nodes(readme_backend, *j_inputs(B=3).values(), True)
    assert _launch._SHAPES == full
    with pytest.raises(ValueError, match="helpers has shape"):
        stencil.eval_J_nodes(readme_backend, *j_inputs(B=4, helpers=FakeCuda(
            (3, 0, N))).values(), True)


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "edge"])
@pytest.mark.parametrize("B", [1, 3])
def test_cpu_tensors_take_the_plain_versions(periodic, B):
    """CPU tensors take the plain versions, bit for bit, and launch
    nothing."""
    rng = np.random.default_rng(B)
    model = Model("-U * dxU + nu * dxxU", "U", ["nu"], device="cpu")
    b = model.backend
    lead = (B,) if B > 1 else ()
    u = torch.tensor(rng.standard_normal((*lead, 1, N)))
    helpers = torch.zeros((*lead, 0, N), dtype=torch.float64)
    pstack = torch.tensor(0.5 + rng.random((*lead, 1, N)))
    x = torch.linspace(0.0, 1.0, N, dtype=torch.float64)
    before = _launch.counts()
    got = stencil.eval_J(b, u, helpers, pstack, x, periodic)
    assert torch.equal(got, b.J_bands_impl(u, helpers, pstack, x, periodic=periodic))
    scale = torch.tensor(rng.random(B)) if B > 1 else 0.3
    got = matvec.banded_matvec(got, u, periodic, scale)
    want = matvec.banded_matvec_plain(b.J_bands_impl(u, helpers, pstack, x,
                                                     periodic=periodic), u, periodic, scale)
    assert torch.equal(got, want)
    assert _launch.counts() == before


def test_J_and_matvec_checks_harness_on_cpu():
    """The tiled J and K7 checks on CPU tensors (a few shapes, beyond a
    grid's y of members too): plain against plain, nothing launched."""
    before = _launch.counts()
    results = kernel_checks.check_all_tiled_J("cpu", torch.float64,
                                              shapes=[(2, 1), (257, 4), (3, 66000)])
    kernel_checks.check_all_matvecs("cpu", torch.float32, results)
    assert results == {"K1.J": 0.0, "K7.matvec": 0.0}
    assert _launch.counts() == before
    view = kernel_checks.offset_view(torch.arange(6.0).reshape(2, 3))
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    assert torch.equal(view, torch.arange(6.0).reshape(2, 3))
