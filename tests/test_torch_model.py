"""The port's F and banded J against the JAX package's backends.

The same seeded state goes through ``triflow_tpu_torch``'s plain versions
(what kernel K1 is held to on the card) and through ``triflow_tpu``'s
``JaxBackend`` and ``NumpyBackend``; they agree to 1e-12 relative in f64.
Also checks K1's code generation: deterministic, and every floating-point
literal a ``T(...)`` value, so the float kernel never computes in double.
"""

import numpy as np
import pytest
import torch

import triflow_tpu as tj
import triflow_tpu_torch as tt
from triflow_tpu.core.compiler import NumpyBackend
from triflow_tpu_torch.ops import stencil
from triflow_tpu_torch.ops.stencil import BARE_LITERAL

torch.set_num_threads(1)

#: (equations, dependent variables, parameters): heat, advection-diffusion,
#: Burgers, Kuramoto-Sivashinsky (halo 2, s = 2), a 2-variable system and
#: a model with Max/Min (upwind) and Heaviside
MODELS = {
    "heat": ("k * dxxU", "U", ["k"]),
    "advdiff": ("k * dxxU - c * dxU", "U", ["k", "c"]),
    "burgers": ("-U * dxU + nu * dxxU", "U", ["nu"]),
    "ks": ("-dxxU - dxxxxU - U * dxU", "U", []),
    "twovar": (["k * dxxU - c * dxV", "k * dxxV - c * dxU + U * V"],
               ["U", "V"], ["k", "c"]),
    "maxheav": ("-upwind(U, U, 2) + k * dxxU + c * Heaviside(x - 1.5)", "U",
                ["k", "c"]),
}

RTOL = 1e-12
N = 48


def _state(model_t, pars, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 3.0, N)
    u = rng.standard_normal((model_t.system.nvar, N))
    p = {k: 0.5 + rng.random() for k in pars}
    return x, u, p


def _rel(a, b):
    b = np.asarray(b)
    return np.abs(np.asarray(a) - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_F_J_match_jax_and_numpy(name, periodic):
    eqs, dep, pars = MODELS[name]
    model_t = tt.Model(eqs, dep, pars, device="cpu")
    model_j = tj.Model(eqs, dep, pars)
    ref_np = NumpyBackend(model_j.system, dtype=np.float64)
    x, u, p = _state(model_t, pars)
    pstack = np.stack([np.full(N, p[k]) for k in pars]) if pars \
        else np.zeros((0, N))
    helpers = np.zeros((0, N))
    b = model_t.backend
    args_t = [torch.tensor(a) for a in (u, helpers, pstack, x)]
    F_t = b.F(*args_t, periodic=periodic).numpy()
    J_t = b.J_bands(*args_t, periodic=periodic).numpy()
    for backend in (model_j.backend, ref_np):
        F_r = backend.F(u, helpers, pstack, x, periodic=periodic)
        J_r = backend.J_bands(u, helpers, pstack, x, periodic=periodic)
        assert _rel(F_t, F_r) <= RTOL
        assert _rel(J_t, J_r) <= RTOL


@pytest.mark.parametrize("name", sorted(MODELS))
def test_routines_match_jax(name):
    """The host routines: interleaved flat F and the CSC Jacobian."""
    eqs, dep, pars = MODELS[name]
    model_t = tt.Model(eqs, dep, pars, device="cpu")
    model_j = tj.Model(eqs, dep, pars)
    x, u, p = _state(model_t, pars, seed=1)
    p["periodic"] = True
    vals = dict(zip(model_t.system.dep_vars, u))
    f_t = model_t.fields_template(x=torch.tensor(x),
                                  **{k: torch.tensor(v) for k, v in vals.items()})
    f_j = model_j.fields_template(x=x, **vals)
    assert _rel(model_t.F(f_t, p), model_j.F(f_j, p)) <= RTOL
    assert _rel(model_t.J(f_t, p).toarray(), model_j.J(f_j, p).toarray()) <= RTOL


def _generated_block(source):
    start = source.index("#define TF_NVAR")
    return source[start:source.index("// ---- end of generated block")]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_stencil_codegen_deterministic_and_typed(name):
    eqs, dep, pars = MODELS[name]
    first = tt.Model(eqs, dep, pars, device="cpu").backend.stencil.source()
    second = tt.Model(eqs, dep, pars, double=False, device="cpu").backend.stencil.source()
    # the two dtypes differ only in which dtype's entries the library carries
    assert "#define TF_F32 0" in first
    assert first.replace("#define TF_F32 0", "#define TF_F32 1") == second
    block = _generated_block(first)
    assert "tf_F" in block and "tf_J" in block
    assert BARE_LITERAL.findall(block) == []
    assert "double" not in block


@pytest.mark.parametrize("name", sorted(MODELS))
def test_megatheta_codegen_takes_inverse_dx(name):
    """K9's library prints the model's bodies with 1 / dx in dx's slot (the
    last argument): deterministic, typed, and with no division by it; it
    says whether the bodies read x (the first argument)."""
    eqs, dep, pars = MODELS[name]
    b = tt.Model(eqs, dep, pars, device="cpu").backend
    first = b.megatheta.source()
    second = tt.Model(eqs, dep, pars, double=False, device="cpu").backend.megatheta.source()
    assert first.replace("#define TF_F32 0", "#define TF_F32 1") == second
    block = _generated_block(first)
    last = f"a[{len(b.args_symbols) - 1}]"
    assert BARE_LITERAL.findall(block) == [] and "double" not in block
    assert f"/{last}" not in block.replace(" ", "") and f"/(({last})" not in block
    reads_x = "a[0]" in block
    assert f"#define TF_USES_X {int(reads_x)}" in block
    assert stencil.uses_x(b.system, b.args_symbols) is reads_x
    assert "TF_USES_X" not in b.stencil.source()


def test_bare_literal_pattern():
    assert BARE_LITERAL.findall("T(-0.5) + T(1.5e-3) * T(2)") == []
    assert BARE_LITERAL.findall("x * 0.5 + (1.5) + 3e5") == ["0.5", "1.5", "3e5"]


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.Model("k * dxxU", "U", "k", device="cuda")


def test_default_device_is_the_card(monkeypatch):
    """Without ``device=`` a model targets the card, so it raises where
    torch sees none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.Model("k * dxxU", "U", "k")


def test_model_dtype_and_unported_precision():
    assert tt.Model("k * dxxU", "U", "k", device="cpu").dtype == torch.float64
    assert tt.Model("k * dxxU", "U", "k", double=False,
                    device="cpu").dtype == torch.float32
    # the df64 mode computes in native float64; other modes stay refused
    df64 = tt.Model("k * dxxU", "U", "k", double="df64", device="cpu")
    assert df64.dtype == torch.float64 and df64.precision == "df64"
    for double in ("df32", "f16"):
        with pytest.raises(NotImplementedError):
            tt.Model("k * dxxU", "U", "k", double=double, device="cpu")


def test_signature_is_the_references():
    """The reference's parameters, in its order, then the port's device."""
    import inspect

    ref = list(inspect.signature(tj.Model).parameters)
    port = list(inspect.signature(tt.Model).parameters)
    assert port == ref + ["device"]


def test_reference_positional_form_builds():
    """``Model(eqs, vars, pars, helps, bdcs, compiler=...)`` as the
    reference is called; the boundary conditions are kept and unused."""
    eqs, dep, pars = MODELS["advdiff"]
    for compiler in ("jax", "theano", "torch"):
        model = tt.Model(eqs, dep, pars, None, "dxU", compiler=compiler,
                         device="cpu")
        assert model._bdcs == ("dxU",) and model.device.type == "cpu"
    ref = tj.Model(eqs, dep, pars, None, "dxU")
    assert np.array_equal(model.F_array, ref.F_array)


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_numpy_compiler_matches_numpy_backend(name, periodic):
    """``compiler="numpy"``: the plain versions on the CPU, whatever the
    device, against the reference's NumpyBackend."""
    eqs, dep, pars = MODELS[name]
    model_t = tt.Model(eqs, dep, pars, compiler="numpy")
    assert model_t.device.type == "cpu"
    ref = tj.Model(eqs, dep, pars, compiler="numpy").backend
    assert isinstance(ref, NumpyBackend)
    x, u, p = _state(model_t, pars, seed=2)
    pstack = np.stack([np.full(N, p[k]) for k in pars]) if pars \
        else np.zeros((0, N))
    helpers = np.zeros((0, N))
    args_t = [torch.tensor(a) for a in (u, helpers, pstack, x)]
    b = model_t.backend
    assert _rel(b.F(*args_t, periodic=periodic).numpy(),
                ref.F(u, helpers, pstack, x, periodic=periodic)) <= RTOL
    assert _rel(b.J_bands(*args_t, periodic=periodic).numpy(),
                ref.J_bands(u, helpers, pstack, x, periodic=periodic)) <= RTOL


def test_hold_compilation_then_compile():
    model = tt.Model("k * dxxU", "U", "k", hold_compilation=True)
    assert not hasattr(model, "backend") and model.precision == "f64"
    assert model.system.window == 3
    model.compile("numpy")
    x = torch.linspace(0.0, 1.0, 16, dtype=torch.float64)
    fields = model.fields_template(x=x, U=x ** 2)
    assert np.allclose(model.F(fields, {"k": 1.0, "periodic": False})[1:-1], 2.0)
    seen = []

    def compiler(m):
        seen.append(m)
        return tt.core.compiler.TorchBackend(m.system, torch.float32, "cpu")

    held = tt.Model("k * dxxU", "U", "k", hold_compilation=True)
    held.compile(compiler)
    assert seen == [held] and held.dtype == torch.float32


def test_unknown_compiler_raises():
    for pkg in (tj, tt):
        with pytest.raises(ValueError, match="unknown compiler"):
            pkg.Model("k * dxxU", "U", "k", compiler="fortran")
