"""The port's Fields and Model host surface against the JAX package's, on
the CPU (the cases of ``tests/test_fields.py`` but its pytree one, and
``tests/test_model.py``'s ``test_save_load``): template and factory
equality and hash, uflat's node-major interleaving, the fill round trip,
pickle and copy, CSV export, n-D uflat/fill and the n-D export refusal;
a saved and loaded model keeps its device and gives the saved one's F and
J."""

import copy
import pickle

import numpy as np
import pytest
import torch

import triflow_tpu as tj
import triflow_tpu_torch as tt
from triflow_tpu_torch.utils.convert import state_from_numpy

TWO = (["dxxU", "dxxV"], ["U", "V"])


def both_fields2():
    """The same two-variable state with a helper in both packages."""
    x = np.linspace(0, 10, 50, endpoint=False)
    data = {"x": x, "U": np.cos(x), "V": np.sin(x), "s": np.zeros_like(x)}
    model_j = tj.Model(*TWO, help_functions="s")
    model_t = tt.Model(*TWO, help_functions="s", device="cpu")
    fields_t, _ = state_from_numpy(data, {}, model_t)
    return model_j.fields_template(**data), fields_t


def test_template_matches_factory():
    fj, ft = both_fields2()
    template = tt.factory1D(["U", "V"], ["s"])
    direct = template(**{k: ft[k] for k in ft.keys()})
    assert direct.keys() == ft.keys() == fj.keys()
    assert torch.equal(direct.uflat, ft.uflat)
    assert template == ft.template and hash(template) == hash(ft.template)
    assert template == tt.factory(("x",), [("U", ("x",)), ("V", ("x",))],
                                  [("s", ("x",))])
    assert template != tt.factory1D(["U"], ["s"])
    assert len({template, ft.template}) == 1
    ref = tj.factory1D(["U", "V"], ["s"])
    assert template.dependent_variables_info == ref.dependent_variables_info
    assert template.helper_functions_info == ref.helper_functions_info


def test_uflat_interleaving():
    """Node-major [U0, V0, U1, V1, ...], the reference's uflat."""
    fj, ft = both_fields2()
    flat = ft.uflat
    assert flat.shape == (100,)
    assert torch.equal(flat[0::2], ft["U"]) and torch.equal(flat[1::2], ft["V"])
    assert np.array_equal(flat.numpy(), np.asarray(fj.uflat))
    assert torch.equal(ft.uarray, torch.stack([ft["U"], ft["V"]]))


def test_fill_roundtrip():
    fj, ft = both_fields2()
    flat = ft.uflat.numpy()
    other = ft.copy()
    other["U"] = torch.zeros_like(ft["U"])
    other.fill(flat)
    assert torch.equal(other["U"], ft["U"]) and torch.equal(other["V"], ft["V"])
    assert other["U"].dtype == ft["U"].dtype
    ref = fj.copy()
    ref.fill(flat)
    assert np.array_equal(other["V"].numpy(), np.asarray(ref["V"]))
    filled = ft.filled(2 * ft.uflat)
    assert torch.equal(filled["U"], 2 * ft["U"]) and torch.equal(ft["U"], other["U"])
    assigned = ft.assign(U=ft["V"])
    assert assigned["U"] is ft["V"] and ft["U"] is not ft["V"]


def test_missing_input_raises():
    template = tt.factory1D(["U"], [])
    with pytest.raises(KeyError):
        template(x=torch.arange(5.0))


def test_pickle_and_copy():
    _, ft = both_fields2()
    clone = pickle.loads(pickle.dumps(ft))
    assert clone.keys() == ft.keys() and clone.template == ft.template
    assert torch.equal(clone.uflat, ft.uflat)
    assert all(clone[k].device == ft[k].device for k in ft.keys())
    shallow, deep = ft.copy(deep=False), ft.copy(deep=True)
    assert shallow["U"] is ft["U"] and deep["U"] is not ft["U"]
    assert torch.equal(deep["U"], ft["U"])
    deep["U"][0] = 7.0
    assert ft["U"][0] != 7.0
    assert copy.copy(ft)["V"] is ft["V"]
    assert copy.deepcopy(ft)["V"] is not ft["V"]


def test_csv_export(tmp_path):
    fj, ft = both_fields2()
    path = tmp_path / "out.csv"
    ft.to_csv(str(path))
    assert path.exists()
    df, ref = ft.to_df(), fj.to_df()
    assert list(df.columns) == list(ref.columns) == ["U", "V", "s"]
    assert np.array_equal(df.values, ref.values)
    assert np.array_equal(df.index.values, ref.index.values)


def test_2d_export_rejected():
    template = tt.factory(("x", "y"), [("U", ("x", "y"))], [])
    f = template(x=torch.arange(4.0), y=torch.arange(3.0),
                 U=torch.zeros((4, 3)))
    with pytest.raises(ValueError):
        f.to_df()


def test_2d_uflat_fill():
    """Variables over two coordinates: uflat and fill round trip, as the
    reference's."""
    info = [("h", ("x", "y")), ("q", ("x", "y"))]
    rng = np.random.RandomState(1)
    h, q = rng.randn(4, 3), rng.randn(4, 3)
    data = dict(x=np.arange(4.0), y=np.arange(3.0), h=h, q=q)
    f = tt.factory(("x", "y"), info, [])(
        **{k: torch.from_numpy(v) for k, v in data.items()})
    ref = tj.factory(("x", "y"), info, [])(**data)
    flat = f.uflat
    assert flat.shape == (24,)
    assert np.array_equal(flat.numpy(), np.asarray(ref.uflat))
    g = f.copy()
    g["h"] = torch.zeros((4, 3), dtype=torch.float64)
    g["q"] = torch.zeros((4, 3), dtype=torch.float64)
    g.fill(flat)
    assert np.array_equal(g["h"].numpy(), h) and np.array_equal(g["q"].numpy(), q)


def test_save_load(tmp_path):
    """A saved model, loaded: the same equations, device and precision,
    and F and J equal to the saved one's (and the reference's)."""
    heat = ("k * dxxT", "T", "k")
    model = tt.Model(*heat, device="cpu")
    model.save(str(tmp_path / "heat_model"))
    loaded = tt.Model.load(str(tmp_path / "heat_model"))
    assert loaded.device == model.device and loaded.precision == model.precision
    assert (loaded.F_array == model.F_array).all()
    assert (loaded.J_array == model.J_array).all()
    x = np.linspace(0, 10, 50, endpoint=False)
    data = {"x": x, "T": np.cos(x * 2 * np.pi / 10)}
    fields, _ = state_from_numpy(data, {}, model)
    pars = dict(periodic=True, k=1)
    F = np.asarray(model.F(fields, pars))
    assert np.array_equal(np.asarray(loaded.F(fields, pars)), F)
    assert (loaded.J(fields, pars) != model.J(fields, pars)).nnz == 0
    ref = tj.Model(*heat)
    assert np.allclose(F, np.asarray(ref.F(ref.fields_template(**data), pars)),
                       rtol=1e-12, atol=1e-12)
    # float32, the numpy compiler name, and a custom compiler saved as the
    # port's own backend
    f32 = pickle.loads(pickle.dumps(tt.Model(*heat, double=False,
                                             compiler="numpy", device="cpu")))
    assert f32.dtype == torch.float32 and f32._compiler_name == "numpy"
    custom = tt.Model(*heat, device="cpu",
                      compiler=lambda m: tt.Model(*heat, device="cpu").backend)
    again = pickle.loads(pickle.dumps(custom))
    assert again._compiler_name == "torch" and again.device.type == "cpu"
