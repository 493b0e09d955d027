"""The hand-written CUDA kernels against their plain PyTorch versions.

The kernel checks need an NVIDIA GPU and nvcc: they carry the ``cuda``
marker and skip where torch sees no CUDA device.  On the card, run

    python -m pytest tests/test_torch_kernels.py -q

They are the checks of phase 1 of ``chip_smoke.py``
(``triflow_tpu_torch.ops.kernel_checks``).  The other tests here run
anywhere: the same harness on CPU tensors (where every wrapper takes its
plain version), and the wrappers' refusal of any device they have no
kernel for.
"""

import pytest
import torch

from triflow_tpu_torch import Model, schemes
from triflow_tpu_torch.ops import (_launch, chunked, kernel_checks, megastep,
                                   megatheta, mixed, pcr, thomas)

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest tests/test_torch_kernels.py)")
    return "cuda"


#: the kernel entries only an ensemble runs: ``kernel_checks.run_batched``
#: holds them against their plain versions (below)
MEMBER_AXIS_ONLY = {"K1.F_terms", "K6.adaptive_scan"}
#: the kernel entries only ``refine=`` and ``Theta(solver=)`` run
REFINE_ONLY = {"K7.matvec"}
#: the kernel entries of the df64 mode's mixed solve: float64 only
DF64_ONLY = {"K8.residual", "K6.step_mixed"}
#: K2-K4's wide instantiations (block sizes 5..8): ``kernel_checks.run_wide``
#: holds them against their plain versions (below)
WIDE_ONLY = {"K2.spike_factor_wide", "K3.thomas_sweep_wide", "K3.spike_correct_wide",
             "K4.pcr_factor_wide", "K4.pcr_solve_wide", "K4.pcr_solve_shift_wide"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_kernels_match_plain_versions(cuda_device, dtype):
    results = kernel_checks.run_all(cuda_device, dtypes=(dtype,))
    name = str(dtype).replace("torch.", "")
    skip = (MEMBER_AXIS_ONLY | WIDE_ONLY
            | (DF64_ONLY if dtype == torch.float32 else set()))
    assert set(_launch.COUNTERS) - skip <= set(results[name])
    assert REFINE_ONLY <= set(results[name])


#: the kernel entries one Theta step launches once each (all but K5) on a
#: grid above K6's gate
THETA_KERNELS = ("K1.F", "K1.J", "K2.spike_factor", "K3.thomas_sweep",
                 "K3.spike_correct", "K4.pcr_factor", "K4.pcr_solve_shift")


def _burgers_on(device, N=None):
    """Burgers on a periodic grid, by default the smallest power of two
    above K6's gate (the multi-launch path)."""
    if N is None:
        N = 1 << megastep.MAX_N[1].bit_length()
    model = Model("-U * dxU + nu * dxxU", "U", "nu", device=device)
    x = torch.arange(N, dtype=torch.float64, device=device) * 0.5
    fields = model.fields_template(x=x, U=torch.cos(2 * torch.pi * x / x[-1]))
    return model, fields, {"periodic": True, "nu": 0.5}


@pytest.mark.cuda
def test_theta_step_launches_every_kernel(cuda_device):
    model, fields, pars = _burgers_on(cuda_device)
    _launch.reset_counters()
    schemes.Theta(model)(0.0, fields, 0.05, pars)
    counts = _launch.counts()
    assert {k: counts[k] for k in THETA_KERNELS} == dict.fromkeys(THETA_KERNELS, 1)
    assert counts["K5.combine"] == counts["K6.step"] == 0


@pytest.mark.cuda
def test_rodaspr_step_launches_every_kernel(cuda_device):
    """One fixed RODASPR step: one J and one factor, six biased F and six
    solves, and five stage combinations plus the final one; a block-cyclic
    plan has no Woodbury set-up, one grid no fused stage right-hand side
    (an ensemble's), a step without ``refine=`` no matvec, a float64
    model no mixed-solve residual (the df64 mode's K8), a step of
    ``Simulation``'s schemes never the opt-in two-pass theta step (K9), a
    block size of 1 none of K2-K4's wide instantiations, and a plan of more
    than ``pcr.FACTOR_MEMBERS_MAX_C`` chunks not K4's one block per
    member (its factor's or its R-column solve's)."""
    model, fields, pars = _burgers_on(cuda_device)
    _launch.reset_counters()
    schemes.RODASPR(model, time_stepping=False, tol=None)(0.0, fields, 0.05,
                                                           pars)
    counts = _launch.counts()
    assert all(c > 0 for k, c in counts.items()
               if not k.startswith(("K6", "K9")) and k not in WIDE_ONLY
               and k not in ("K4.pcr_factor_members", "K4.pcr_solve_members")
               and k not in ("K4.pcr_solve", "K1.F_terms", "K7.matvec", "K8.residual"))
    assert not any(counts[k] for k in WIDE_ONLY)
    assert counts["K9.interface"] == counts["K9.correct"] == 0
    assert counts["K4.pcr_solve"] == counts["K1.F_terms"] == counts["K7.matvec"] == 0
    assert counts["K8.residual"] == 0
    assert counts["K1.J"] == counts["K2.spike_factor"] == 1
    assert counts["K1.F"] == counts["K3.thomas_sweep"] == 6
    assert counts["K5.combine"] == 6
    assert counts["K6.step"] == counts["K6.adaptive"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("refine", [1, 2])
def test_refined_rodaspr_step_launches_k7_six_times_per_pass(cuda_device, refine):
    """A fixed RODASPR step with ``refine=r`` on a grid K6 admits: no K6,
    K7 6 r times, and K3, K4's per-stage solve and K5 6 r more times
    each than the unrefined multi-launch step."""
    model, fields, pars = _burgers_on(cuda_device, N=4096)
    _launch.reset_counters()
    schemes.RODASPR(model, time_stepping=False, tol=None, refine=refine)(
        0.0, fields, 0.05, pars)
    counts = _launch.counts()
    r6 = 6 * refine
    assert counts["K6.step"] == counts["K6.adaptive"] == 0
    assert counts["K7.matvec"] == r6
    assert counts["K3.thomas_sweep"] == counts["K3.spike_correct"] == 6 + r6
    assert counts["K4.pcr_solve_shift"] == 6 + r6
    assert counts["K5.combine"] == 6 + r6
    assert counts["K1.J"] == counts["K2.spike_factor"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_matvec_matches_plain_version(cuda_device, dtype):
    """K7 at every small shape (one to three variables, W = 3, 5, 7, edge
    and periodic, one grid and four members with a number and a
    per-member scale), and on J's bands of a Burgers grid."""
    results = kernel_checks.check_all_matvecs(cuda_device, dtype)
    model, fields, pars = _burgers_on(cuda_device)
    b = model.backend
    u, helpers, x = b.split_fields(fields)
    bands = b.J_bands(u, helpers, b.pack_pars(pars, x), x, periodic=True)
    kernel_checks.check_matvec(bands.to(dtype), u.to(dtype), True, -0.05,
                               results)
    assert set(results) == REFINE_ONLY


def test_matvec_check_harness_on_cpu():
    """K7's checks on CPU tensors: plain against plain, nothing launched."""
    before = _launch.counts()
    results = kernel_checks.check_all_matvecs("cpu", torch.float64)
    assert results == {"K7.matvec": 0.0}
    assert _launch.counts() == before


#: a periodic grid above K6's gate whose ring closes through the Woodbury
#: correction (its chunked plan: C = 1500, no power of two)
N_WOODBURY = 75000


def test_woodbury_grid_plan():
    plan = chunked.make_plan(N_WOODBURY, 1, 1, True)
    assert plan.woodbury and N_WOODBURY > megastep.MAX_N[1]


@pytest.mark.cuda
def test_woodbury_theta_step_launches_the_setup_once(cuda_device):
    """A Theta step on a Woodbury plan: every K1-K4 entry once, the
    closure's set-up (K4.pcr_solve) once, for the one factor."""
    model, fields, pars = _burgers_on(cuda_device, N=N_WOODBURY)
    _launch.reset_counters()
    schemes.Theta(model)(0.0, fields, 0.05, pars)
    counts = _launch.counts()
    want = THETA_KERNELS + ("K4.pcr_solve",)
    assert {k: counts[k] for k in want} == dict.fromkeys(want, 1)


#: the Woodbury cases of the kernel checks: the solver's and K6's
WOODBURY_SOLVER_CASES = [c for c in kernel_checks.SOLVER_CASES
                         if chunked.make_plan(c[2], c[1], c[0] // 2, c[3]).woodbury]
WOODBURY_MEGA_CASES = [c for c in kernel_checks.MEGA_CASES
                       if megastep.make_plan(c[1], 2 if c[0] == "two_var" else 1,
                                             2 if c[0] != "readme" else 1, c[2]).woodbury]


def _woodbury_checks(device, dtype):
    results = {}
    for i, (W, nvar, N, periodic) in enumerate(WOODBURY_SOLVER_CASES):
        bands = kernel_checks.random_bands(W, nvar, N, dtype, device, seed=i)
        kernel_checks.check_solver(bands, 1.0, -0.3, periodic, seed=i, results=results)
    for name, N, periodic, dt, adaptive in WOODBURY_MEGA_CASES:
        model = Model(*kernel_checks.MEGA_MODELS[name],
                      double=dtype == torch.float64, device=device)
        kernel_checks.check_megastep(model, N, periodic, dt, device, results, adaptive)
    return results


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_woodbury_kernels_match_plain_versions(cuda_device, dtype):
    """K4.pcr_solve (the set-up), K4.pcr_solve_shift's Woodbury correction,
    K2 with wrap and K6 on Woodbury plans against their plain versions."""
    results = _woodbury_checks(cuda_device, dtype)
    assert {"K2.spike_factor", "K4.pcr_solve", "K4.pcr_solve_shift",
            "K6.step"} <= set(results)


def test_woodbury_check_harness_on_cpu():
    """The Woodbury checks on CPU tensors: plain against plain, every case
    a Woodbury plan (s = 1, 2, 4 for the solver; s = 1, 2, 4 for K6)."""
    assert len(WOODBURY_SOLVER_CASES) == 4 and len(WOODBURY_MEGA_CASES) == 3
    before = _launch.counts()
    results = _woodbury_checks("cpu", torch.float64)
    assert results["residual"] < 1e-12
    assert _launch.counts() == before


@pytest.mark.cuda
def test_small_grid_steps_launch_k6_once(cuda_device):
    """Below K6's gate a fixed step is one K6 launch and an adaptive output
    step (no hook) one launch of K6's adaptive entry, and nothing else."""
    model, fields, pars = _burgers_on(cuda_device, N=4096)
    for scheme, kw, entry in ((schemes.Theta, {}, "K6.step"),
                              (schemes.RODASPR, {"time_stepping": False, "tol": None},
                               "K6.step"),
                              (schemes.RODASPR, {"tol": 1e-3}, "K6.adaptive")):
        _launch.reset_counters()
        scheme(model, **kw)(0.0, fields, 0.05, pars)
        counts = _launch.counts()
        assert counts == {**dict.fromkeys(counts, 0), entry: 1}


def test_check_harness_on_cpu():
    """The harness itself, on CPU tensors: plain against plain, and the
    plain solve's residual at every check shape."""
    before = _launch.counts()
    results = kernel_checks.run_all("cpu")
    assert all(r["residual"] < 1e-6 for r in results.values())
    assert _launch.counts() == before  # the plain route launches nothing


def test_adapted_dt_limit_catches_a_wrong_err():
    """The float32 limit on K6's adapted dt against a wrong err: on CPU
    tensors the kernel's side is the plain version (no gap), and an err
    twice too large moves dt_i past the limit or changes the attempts."""
    limit = kernel_checks.TOL[torch.float32]["dt"]
    readings = kernel_checks.adaptive_dt_readings("cpu", torch.float32, seeds=(0,))
    assert len(readings) == 2
    for rows in readings.values():
        for _, gap, same, bad_gap, bad_same in rows:
            assert gap == 0.0 and same
            assert bad_gap > limit or not bad_same


@pytest.mark.cuda
def test_df64_kernels_match_plain_versions(cuda_device):
    """K8 at every small shape (one grid and four members, a number and a
    per-member coef) and K6's mixed entry (s = 1, 2, 4; edge,
    block-cyclic and Woodbury; 1 and 2 residual passes; 3 steps in one
    launch bit for bit) against their plain versions."""
    results = kernel_checks.check_all_mixed(cuda_device)
    assert set(results) == DF64_ONLY


def test_df64_check_harness_on_cpu():
    """The df64 checks on CPU tensors: plain against plain, nothing
    launched."""
    before = _launch.counts()
    results = kernel_checks.check_all_mixed("cpu")
    assert results == dict.fromkeys(DF64_ONLY, 0.0)
    assert _launch.counts() == before


@pytest.mark.cuda
def test_mixed_solve_with_members_matches_plain_version(cuda_device):
    """The df64 ensembles' mixed solve with a member axis (B = 4, a coef
    per member: K2 and K4 in float32, K3 and K4's solves, K8) against its
    plain version and against each member's one-grid solve."""
    results = kernel_checks.check_all_mixed_members(cuda_device)
    assert set(results) == {"mixed solve members", "mixed solve members alone"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_carry_matches_plain_version(cuda_device, dtype):
    """K6 with the Kahan carry (``kernel_checks.COMPENSATED_CASES``: s = 1,
    2, 4, one grid and B = 4), from a seeded carry: bit for bit the step
    entry's bare launches and the adaptive controller replayed on them,
    folded by kahan_update, and against its plain version."""
    results = kernel_checks.check_all_compensated(cuda_device, dtype)
    assert "K6.compensated" in results


def test_carry_check_harness_on_cpu():
    """The carry checks and the member-axis mixed solve on CPU tensors:
    plain against plain (the carried step equal to the bare steps folded
    by kahan_update, the adaptive entries equal to the controller
    replayed on plain steps, every seeded carry nonzero where the check
    asks it), the members against their one-grid solves, nothing
    launched."""
    before = _launch.counts()
    results = kernel_checks.check_all_compensated("cpu", torch.float64)
    assert results == {"K6.compensated": 0.0, "K6.compensated dt_i": 0.0}
    mixed = kernel_checks.check_all_mixed_members("cpu")
    assert mixed["mixed solve members"] == 0.0
    assert mixed["mixed solve members alone"] < 1e-12
    assert _launch.counts() == before


@pytest.mark.cuda
def test_df64_mixed_steps_launch_k8_or_the_mixed_entry(cuda_device):
    """A df64 RODASPR step with ``df64_mixed_solve=n``: above the mixed
    entry's gate K8 6 n times, K2 and K4's factor once (float32) and no
    K6; below it one launch of K6's mixed entry and nothing else."""
    for N, passes in ((2 * megastep.MIXED_MAX_N[1], 1),
                      (2 * megastep.MIXED_MAX_N[1], 2), (4096, 1)):
        model = Model("-U * dxU + nu * dxxU", "U", "nu", double="df64",
                      device=cuda_device)
        _, fields, pars = _burgers_on(cuda_device, N=N)
        scheme = schemes.RODASPR(model, time_stepping=False, tol=None,
                                 df64_mixed_solve=passes)
        _launch.reset_counters()
        scheme(0.0, fields, 0.0625, pars)
        counts = _launch.counts()
        if scheme._mixed_plan(N, True) is None:
            assert counts["K8.residual"] == 6 * passes
            assert counts["K2.spike_factor"] == counts["K4.pcr_factor"] == 1
            assert counts["K3.thomas_sweep"] == 6 * (1 + passes)
            assert all(counts[k] == 0 for k in counts if k.startswith("K6"))
        else:
            assert counts == {**dict.fromkeys(counts, 0), "K6.step_mixed": 1}


def test_wrappers_refuse_devices_without_a_kernel():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA device raises instead of taking the plain version."""
    meta = {"device": "meta", "dtype": torch.float64}
    plan = chunked.make_plan(64, 1, 1, True)
    with pytest.raises(ValueError, match="CUDA"):
        thomas.spike_factor(torch.empty((3, 1, 1, 64), **meta), 1.0, -0.1,
                            plan)
    with pytest.raises(ValueError, match="CUDA"):
        pcr.pcr_factor(torch.empty((2, 2, 8), **meta),
                       torch.empty((2, 2, 8), **meta), True)
    model = Model("k * dxxU", "U", "k", device="cpu")
    args = [torch.empty(shape, **meta) for shape in ((1, 64), (0, 64), (1, 64), (64,))]
    with pytest.raises(ValueError, match="CUDA"):
        model.backend.F(*args, periodic=True)
    # the df64 mode's kernels
    bands, v = torch.empty((3, 1, 1, 64), **meta), torch.empty((1, 64), **meta)
    with pytest.raises(ValueError, match="CUDA"):
        mixed.mixed_residual(bands, v, v, 0.1, True)
    table = megastep.theta_table(1.0)
    with pytest.raises(ValueError, match="CUDA"):
        megastep.step_mixed(model.backend, megastep.make_plan(64, 1, 1, True),
                            table, True, *args, -0.1, 0.1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_megatheta_kernels_match_plain_versions(cuda_device, dtype):
    """K9's interface and correct entries and its whole step against their
    plain versions (s = 1 and 2; Woodbury and block-cyclic rings; Mc up to
    MAX_MC), and the plain step against the plain K1-K4 step."""
    results = kernel_checks.check_all_megathetas(cuda_device, dtype)
    assert {"K9.interface", "K9.correct", "K9 step"} <= set(results)


@pytest.mark.cuda
@pytest.mark.parametrize("N,wood", [(30030, True), (1 << 15, False)],
                         ids=["woodbury", "block-cyclic"])
def test_megatheta_entry_launches_k9_twice_per_step(cuda_device, monkeypatch, N, wood):
    """Theta's ``device_fixed_step_folded`` with ``TRIFLOW_MEGATHETA=1``: one
    step is K9.interface, K4's factor (the Woodbury set-up on a Woodbury
    plan) and solve with shifts, K9.correct, and nothing else; without the
    variable it is ``fixed_step``'s route, and it agrees with the K9 step."""
    model, fields, pars = _burgers_on(cuda_device, N=N)
    scheme = schemes.Theta(model)
    args = scheme._split(fields, pars)
    monkeypatch.setenv("TRIFLOW_MEGATHETA", "1")
    plan, fixed = scheme.device_fixed_step_folded(N)
    assert plan.woodbury is wood and plan == megatheta.plan_for(N, 1, 1)
    _launch.reset_counters()
    u9 = fixed(0.0, *args, 0.5, 0.05)[0]
    counts = _launch.counts()
    want = dict.fromkeys(counts, 0)
    want.update({"K9.interface": 1, "K9.correct": 1,
                 kernel_checks.factor_entry(plan.s, plan.C): 1,
                 "K4.pcr_solve_shift": 1, "K4.pcr_solve": int(wood)})
    assert counts == want
    monkeypatch.delenv("TRIFLOW_MEGATHETA")
    _, default = scheme.device_fixed_step_folded(N)
    _launch.reset_counters()
    u = default(0.0, *args, 0.5, 0.05)[0]
    assert _launch.counts()["K9.interface"] == 0
    assert (u9 - u).abs().max() <= 1e-10 * u.abs().max()


def test_megatheta_check_harness_on_cpu():
    """K9's checks on CPU tensors: plain against plain, nothing launched."""
    before = _launch.counts()
    results = kernel_checks.check_all_megathetas("cpu", torch.float64)
    assert results["K9.interface"] == results["K9.correct"] == 0.0
    assert results["K9 plain step against K1-K4's"] < 1e-12
    assert _launch.counts() == before


#: the kernel entries the member-axis checks hold against plain versions
#: (B > 1 members run every adaptive output step through K6's scan kernel)
MEMBER_AXIS_ENTRIES = {"K1.F", "K1.F_terms", "K1.J", "K2.spike_factor",
                       "K3.thomas_sweep", "K3.spike_correct", "K4.pcr_factor",
                       "K4.pcr_solve", "K4.pcr_solve_shift", "K6.step",
                       "K6.adaptive_scan"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_member_axis_kernels_match_plain_versions(cuda_device, dtype):
    """K1 (F, F_terms, J), K2-K4 and K6 (step, adaptive with a shared dt
    and per member, adaptive_scan) on B = 4 members against their plain
    versions: block-cyclic and Woodbury rings, per-member shifts and
    scales."""
    results = kernel_checks.run_batched(cuda_device, dtypes=(dtype,))
    name = str(dtype).replace("torch.", "")
    assert MEMBER_AXIS_ENTRIES <= set(results[name])


def test_member_axis_check_harness_on_cpu():
    """The member-axis checks on CPU tensors: plain against plain, every
    member's solve by its residual, and nothing launched."""
    before = _launch.counts()
    results = kernel_checks.run_batched("cpu", dtypes=(torch.float64,))
    assert MEMBER_AXIS_ENTRIES <= set(results["float64"])
    assert results["float64"]["residual"] < 1e-12
    assert _launch.counts() == before


def test_member_axis_wrappers_refuse_devices_without_a_kernel():
    """The member-axis entries raise on a device they have no kernel for,
    as the single-grid ones do."""
    meta = {"device": "meta", "dtype": torch.float64}
    model = Model("k * dxxU", "U", "k", device="cpu")
    u, h, p = (torch.empty(shape, **meta) for shape in ((2, 1, 64), (2, 0, 64),
                                                       (2, 1, 64)))
    x = torch.empty(64, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        model.backend.F_terms([(1.0, 0.5, u)], h, p, x, periodic=True, scale=0.1)
    plan = chunked.make_plan(64, 1, 1, True, 2)
    with pytest.raises(ValueError, match="CUDA"):
        thomas.spike_factor(torch.empty((2, 3, 1, 1, 64), **meta), 1.0, -0.1,
                            plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_wide_kernels_match_plain_versions(cuda_device, dtype):
    """K2-K4 at block sizes S = 5..8 (their wide libraries) against their
    plain versions: block-cyclic, Woodbury and acyclic plans, and B = 4
    members at S = 6 and 8."""
    results = kernel_checks.run_wide(cuda_device, dtypes=(dtype,))
    name = str(dtype).replace("torch.", "")
    assert WIDE_ONLY <= set(results[name])
    assert WIDE_ONLY <= set(_launch.COUNTERS)


@pytest.mark.cuda
def test_wide_block_step_launches_the_wide_kernels(cuda_device):
    """A model of block size 6 (three fields with a third derivative) steps
    on the card through K2-K4's wide entries and never their s <= 4 ones or
    K6."""
    model = Model(["-dxq", "-dxxxh + q", "dxxG - G"], ["h", "q", "G"],
                  device=cuda_device)
    x = torch.arange(4096, dtype=torch.float64, device=cuda_device) * 0.01
    fields = model.fields_template(x=x, h=1 + 0.1 * torch.cos(x), q=0 * x,
                                   G=torch.sin(x))
    _launch.reset_counters()
    schemes.Theta(model, theta=1.0)(0.0, fields, 0.01, dict(periodic=True))
    counts = _launch.counts()
    assert {k: counts[k] for k in WIDE_ONLY - {"K4.pcr_solve_wide"}} == dict.fromkeys(
        WIDE_ONLY - {"K4.pcr_solve_wide"}, 1)
    narrow = {k.removesuffix("_wide") for k in WIDE_ONLY}
    assert not any(counts[k] for k in narrow | {"K6.step", "K6.adaptive"})


def test_wide_check_harness_on_cpu():
    """The wide checks on CPU tensors: plain against plain, each solve by
    its residual, and nothing launched."""
    before = _launch.counts()
    results = kernel_checks.run_wide("cpu", dtypes=(torch.float64,))
    assert WIDE_ONLY <= set(results["float64"])
    assert results["float64"]["residual"] < 1e-12
    assert _launch.counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_sweep_and_combine_match_plain_versions(cuda_device, dtype):
    """K3's staged sweep at every block size 1..8, one grid and members,
    Mc = 2, odd Mc and Mc no multiple of the stage rows, C no multiple of
    the chunks per block, the forward results kept and streamed; K5 bit
    for bit at KS 2^20's shape, on unaligned arrays and a vector tail."""
    results = kernel_checks.check_all_sweeps(cuda_device, dtype)
    kernel_checks.check_combines_exact(cuda_device, dtype, results)
    assert set(results) == {"K3.thomas_sweep", "K3.thomas_sweep_wide",
                            "K5.combine"}


#: a prime grid above K6's gate: a padded plan, whose ring closes at the
#: system level on a periodic grid
N_PRIME = 65537


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [True, False], ids=["ring", "edge"])
def test_padded_rodaspr_step_launches(cuda_device, periodic):
    """A fixed RODASPR step on a padded plan: one J, factor and PCR factor,
    six F and K5; six stage solves, and on a ring two more (the 2 nvar h
    columns of its closure, solved once per factor); no interface-level
    Woodbury set-up."""
    model, fields, pars = _burgers_on(cuda_device, N=N_PRIME)
    pars = dict(pars, periodic=periodic)
    plan = chunked.make_plan(N_PRIME, 1, 1, periodic)
    assert plan.padded and plan.ring == periodic
    assert megastep.plan_for(N_PRIME, 1, 1, periodic) is None
    _launch.reset_counters()
    schemes.RODASPR(model, time_stepping=False, tol=None)(0.0, fields, 0.05,
                                                           pars)
    counts = _launch.counts()
    solves = 6 + (2 if periodic else 0)
    assert counts["K1.J"] == counts["K2.spike_factor"] == 1
    assert counts["K4.pcr_factor"] == 1 and counts["K4.pcr_solve"] == 0
    assert counts["K1.F"] == counts["K5.combine"] == 6
    assert counts["K3.thomas_sweep"] == counts["K3.spike_correct"] == solves
    assert counts["K4.pcr_solve_shift"] == solves


def test_sweep_plan():
    """K3's planner: chunks per block a power of two up to 16, halved while
    the grid has fewer than two blocks per SM; the stages within the share
    of an SM's shared memory of the blocks it holds; the forward results
    kept only where they fit."""
    s_item = [(1, 8), (2, 8), (2, 4), (4, 8), (6, 8), (6, 4), (8, 8)]
    for (s, item) in s_item:
        for Mc, C, B in ((2, 3, 1), (128, 4096, 1), (200, 2500, 1),
                         (500, 1000, 1), (2000, 25, 1024), (3001, 3, 1)):
            sp = thomas.sweep_plan(s, item, Mc, C, B)
            assert sp.CB & (sp.CB - 1) == 0 and 1 <= sp.CB <= 16
            assert sp.smem == thomas.sweep_smem(s, item, Mc, sp.CB, sp.R,
                                                sp.persist)
            assert sp.smem <= thomas.SWEEP_SMEM and sp.R >= 1
            if sp.persist:
                assert item * Mc * s * sp.CB <= thomas.SWEEP_KEEP
    # KS 2^20: 4096 chunks in blocks of 8, the forward results kept
    assert thomas.sweep_plan(2, 8, 128, 4096) == thomas.SweepPlan(
        8, 8, True, thomas.sweep_smem(2, 8, 128, 8, 8, True))
    # config 5's 25600 chunks in 1600 blocks of 16, 13 on each SM: short
    # stages, and the 2000 rows stream through y
    assert thomas.sweep_plan(2, 8, 2000, 25, 1024) == thomas.SweepPlan(
        16, 2, False, thomas.sweep_smem(2, 8, 2000, 16, 2, False))
    # the film's 1000 chunks in blocks of 4: more SMs take part, two blocks
    # on each, with stages of 8 rows; float32 keeps the forward results
    film = thomas.sweep_plan(6, 8, 500, 1000)
    assert (film.CB, film.R, film.persist) == (4, 8, False)
    assert thomas.sweep_plan(6, 4, 500, 1000).persist


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_cluster_body_matches_plain_version(cuda_device, dtype):
    """K6 on every cluster size K = 1..16 that holds each of
    ``kernel_checks.CLUSTER_CASES`` (edge grids, block-cyclic and Woodbury
    rings, C not divisible by K, s = 1, 2, 4, B = 4 members, the mixed
    entry): each entry against its plain version, every entry's outputs
    bit for bit equal across sizes, the adaptive ones with equal attempts."""
    results = kernel_checks.check_clusters(cuda_device, dtype)
    assert {"K6.step", "K6.adaptive", "K6.adaptive_scan"} <= set(results)


def test_cluster_check_harness_on_cpu():
    """The cluster checks on CPU tensors: plain against plain on every
    case, the forced cluster plans built (every size holds the s = 1 edge
    grid), nothing launched."""
    before = _launch.counts()
    skipped = []
    results = kernel_checks.check_clusters("cpu", torch.float64, skipped=skipped)
    assert results["K6.step"] == 0.0 and results["K6.adaptive"] == 0.0
    assert not any("N=1000" in s_ for s_ in skipped)
    assert _launch.counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_staged_factor_matches_plain_version(cuda_device, dtype):
    """K2's staged walk at block sizes 1..4 against its plain version:
    block-cyclic, Woodbury, acyclic and padded plans, one grid and B = 4
    members with their own shifts, Mc = 1, 2, odd and long enough that the
    forward results stream through the rows (``kernel_checks.FACTOR_CASES``),
    within 1e-10 (f64) and 1e-4 (f32) of the largest entry."""
    results = kernel_checks.check_all_factors(cuda_device, dtype)
    assert set(results) == {"K2.spike_factor"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_cluster_solve_shift_matches_plain_version(cuda_device, dtype):
    """K4's solve with shifts over a thread-block cluster against its plain
    version at every interface block size 2..16, with and without the
    Woodbury correction, on clusters of one CTA and of several, one grid
    and members (``kernel_checks.SHIFT_CASES``)."""
    results = kernel_checks.check_all_shifts(cuda_device, dtype)
    assert set(results) == {"K4.pcr_solve_shift", "K4.pcr_solve_shift_wide"}
    sizes = {pcr.solve_plan(C, 2 * s, B).K for s, C, B, _ in kernel_checks.SHIFT_CASES}
    assert 1 in sizes and max(sizes) == pcr.MAX_CLUSTER


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_tiled_correction_matches_plain_version(cuda_device, dtype):
    """K3's tiled correction against its plain version at block sizes 1..8
    (narrow and wide libraries), one chunk to a part-full last group of
    chunks, Mc no multiple of the block's rows, chunk groups across
    members and B = 1024 members (``kernel_checks.CORRECT_SHAPES``), each
    without and with ``add_to``, within 1e-10 (f64) and 1e-4 (f32) of the
    largest entry."""
    results = kernel_checks.check_all_corrections(cuda_device, dtype)
    assert set(results) == {"K3.spike_correct", "K3.spike_correct_wide"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_grid_factor_matches_plain_version(cuda_device, dtype):
    """K4's narrow factor across the card against its plain version at
    interface blocks 2..8, block-cyclic, Woodbury (factored acyclic) and
    acyclic, one chunk to the ring's 1534, one grid and members
    (``kernel_checks.GRID_FACTOR_CASES``), each by the route and body its
    shape picks: one block per member up to ``pcr.FACTOR_MEMBERS_MAX_C``
    chunks, the grid above."""
    results = kernel_checks.check_all_grid_factors(cuda_device, dtype)
    assert set(results) == {kernel_checks.factor_entry(s, C)
                            for s, C, _, _ in kernel_checks.GRID_FACTOR_CASES}
    assert set(results) == {"K4.pcr_factor", "K4.pcr_factor_members"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_tiled_F_matches_plain_version(cuda_device, dtype):
    """K1's tiled F and F_terms against their plain versions at N not a
    multiple of the tile, N within a few tiles of the halo (down to fewer
    nodes than the halo spans), periodic and edge, B = 1, 4 and 1024
    (``kernel_checks.TILED_F_SHAPES``), halos 1 and 2; F bit for bit K6's
    per-node body launched alone, and F_terms of one unit term bit for bit
    F."""
    results = kernel_checks.check_all_tiled_F(cuda_device, dtype)
    assert set(results) == {"K1.F", "K1.F_terms"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_tiled_J_matches_plain_version(cuda_device, dtype):
    """K1's tiled J against its plain version at ``TILED_F_SHAPES`` (fewer
    nodes than the halo spans, N no multiple of the tile, B = 1, 4 and
    1024) and at more members than a grid's y takes, periodic and edge,
    halos 1 and 2; bit for bit K6's per-node body launched alone."""
    results = kernel_checks.check_all_tiled_J(cuda_device, dtype)
    assert set(results) == {"K1.J"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_matvec_matches_plain_version_and_nodes_body(cuda_device, dtype):
    """K7's tiled body (compile-time W = 3, 5, 7 and nvar = 1, 2, 3, vector
    and scalar loads) and, at shapes not compiled in, its per-node body
    against the plain version at ``MATVEC_SHAPES``, one grid and B = 4 with a number and a
    per-member scale, periodic and edge, and on inputs off a 16-byte
    boundary; bit for bit the per-node body of before."""
    results = kernel_checks.check_all_matvecs(cuda_device, dtype)
    assert set(results) == {"K7.matvec"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_woodbury_setup_matches_plain_version(cuda_device, dtype):
    """K4's Woodbury set-up and R-column solve across the card against their
    plain versions at block sizes 1..8 (narrow and wide), C = 2 to the
    cells' 2500, one grid and members up to config 5's B = 1024
    (``kernel_checks.SETUP_CASES``), each by the route its shape picks and
    bit for bit the one-block body (K6's)."""
    results = kernel_checks.check_all_setups(cuda_device, dtype)
    assert set(results) == {kernel_checks.setup_entry(s, C, B)
                            for s, C, B in kernel_checks.SETUP_CASES}
    assert set(results) == {"K4.pcr_solve", "K4.pcr_solve_wide", "K4.pcr_solve_members"}


def test_new_checks_harness_on_cpu():
    """The K2 and cluster-solve checks on CPU tensors (a few cases): plain
    against plain, nothing launched."""
    before = _launch.counts()
    results = kernel_checks.check_all_factors(
        "cpu", torch.float64, cases=kernel_checks.FACTOR_CASES[3:5])
    kernel_checks.check_all_shifts("cpu", torch.float64, results,
                                   cases=[(2, 300, 1, True), (8, 64, 1, True)])
    assert results == {"K2.spike_factor": 0.0, "K4.pcr_solve_shift": 0.0,
                       "K4.pcr_solve_shift_wide": 0.0}
    assert _launch.counts() == before


#: H100's shared memory per SM (228 KB) and the most a block may take
SM_SMEM = 228 * 1024
BLOCK_SMEM = 227 * 1024


def test_factor_plan():
    """K2's planner: one-warp blocks of CB chunks, a power of two up to 32:
    the fewest that need no more blocks than the card's schedulers (4 per
    SM), then fewer while four blocks would not share an SM's 228 KB; the
    forward results kept only where they fit."""
    sms = 132
    for nvar, halo in ((1, 1), (1, 2), (2, 1), (3, 1), (2, 2), (4, 1), (1, 4)):
        s = nvar * max(halo, 1)
        for item in (4, 8):
            for Mc, C, B in ((1, 40, 1), (2, 3, 1), (128, 4096, 1), (512, 1024, 1),
                             (500, 2000, 1), (500, 100, 1024), (3000, 3, 1),
                             (100, 128, 64)):
                fp = thomas.factor_plan(nvar, halo, item, Mc, C, B, sms)
                assert fp.CB & (fp.CB - 1) == 0 and 1 <= fp.CB <= thomas.FACTOR_MAX_CB
                assert fp.smem == thomas.factor_smem(nvar, halo, item, Mc, fp.CB, fp.R,
                                                     fp.persist)
                assert fp.smem <= thomas.FACTOR_SMEM and 4 * (fp.smem + 1024) <= SM_SMEM
                assert 1 <= fp.R <= 8 and fp.R * max(halo, 1) <= 32
                if fp.persist:
                    assert item * 3 * Mc * s * s * fp.CB <= thomas.FACTOR_KEEP
                # one block per scheduler where the chunks fill them, and
                # no more than that unless shared memory caps the block
                blocks = -(-B * C // fp.CB)
                assert fp.CB == 1 or -(-B * C // (fp.CB // 2)) > 4 * sms
                assert blocks <= 4 * sms or fp.CB == thomas.FACTOR_MAX_CB or (
                    4 * (thomas.factor_smem(nvar, halo, item, Mc, 2 * fp.CB, fp.R, False)
                         + 1024) > SM_SMEM)
    # KS 2^20 at C = 1024: 512 blocks of two walkers, the 512 rows streamed
    # (kept in shared memory in float32)
    assert thomas.factor_plan(1, 2, 8, 512, 1024) == thomas.FactorPlan(
        2, 8, False, thomas.factor_smem(1, 2, 8, 512, 2, 8, False))
    assert thomas.factor_plan(1, 2, 4, 512, 1024).persist
    # 4096 chunks in blocks of 8; config 5's 102400 in blocks of 16
    # (float64) and 32 (float32), four on each SM
    assert thomas.factor_plan(1, 2, 8, 128, 4096).CB == 8
    assert thomas.factor_plan(1, 2, 8, 500, 100, 1024)[:2] == (16, 8)
    assert thomas.factor_plan(1, 2, 4, 500, 100, 1024)[:2] == (32, 8)
    # Burgers 10^6 (s = 1, C = 2000): the forward results kept
    assert thomas.factor_plan(1, 1, 8, 500, 2000).persist


def test_solve_plan():
    """K4's cluster plan: one CTA per member where many members fill the
    card (config 5), up to 16 on one grid, every CTA with chunks, the
    shared memory within a block's 227 KB, and a refusal where the state
    does not fit 16 CTAs."""
    for s2 in (2, 4, 6, 8, 10, 12, 14, 16):
        for item in (4, 8):
            cap = pcr.max_chunks(s2, item)
            for C in (1, 2, 3, 64, 100, 128, 250, 1000, 1024, 2000, 4096, 16384):
                for B in (1, 4, 64, 1024):
                    if C > cap:
                        with pytest.raises(ValueError, match="do not fit"):
                            pcr.solve_plan(C, s2, B, item)
                        continue
                    sp = pcr.solve_plan(C, s2, B, item)
                    assert 1 <= sp.K <= pcr.MAX_CLUSTER
                    assert sp.K * sp.Cc >= C > (sp.K - 1) * sp.Cc
                    assert sp.Cc & (sp.Cc - 1) == 0
                    assert 1 <= sp.Ct <= sp.Cc
                    assert s2 * sp.Ct <= sp.threads <= pcr.SOLVE_THREADS
                    assert sp.threads % 32 == 0
                    assert sp.smem == pcr.solve_smem(s2, item, sp.Cc, sp.Ct, sp.D)
                    assert sp.smem + 2 * s2 * item <= BLOCK_SMEM
                    # a ring of at least the slabs needed, at most all of them
                    slabs = (pcr.n_levels(C) + 1) * -(-sp.Cc // sp.Ct)
                    assert 1 <= sp.D <= slabs
                    if B * sp.K > 132 and 2 * (pcr.solve_smem(
                            s2, item, sp.Cc, min(sp.Cc, 8), 3) + 2048) <= SM_SMEM:
                        assert 2 * (sp.smem + 2048) <= SM_SMEM  # two CTAs an SM
    # config 5: B = 1024 members of C = 100 chunks, clusters of one
    assert pcr.solve_plan(100, 4, 1024).K == 1
    # KS 2^20 (C = 1024) and 10^6 (C = 1000): 16 CTAs of 64 chunks (a
    # power of two: the last of the 1000 holds 40), every level's
    # operators in flight from the start
    assert pcr.solve_plan(1024, 4)[:4] == (16, 64, 64, 11)
    assert pcr.solve_plan(1000, 4)[:2] == (16, 64)
    # the largest chunk counts: all of MAX_C at s2 <= 10, fewer at 12..16
    # in float64
    assert pcr.max_chunks(4) == pcr.max_chunks(10) == pcr.MAX_C
    assert pcr.max_chunks(16) < pcr.max_chunks(12) < pcr.MAX_C
    assert pcr.max_chunks(16, 4) == pcr.MAX_C
    with pytest.raises(ValueError, match="do not fit"):
        pcr.solve_plan(pcr.max_chunks(16) + 1, 16)


def test_make_plan_never_picks_a_refused_chunk_count(monkeypatch):
    """With a cost that prefers ever more chunks, ``make_plan`` stops at the
    most chunks K4's cluster solve takes in float64 (and so in float32)."""
    monkeypatch.setattr(chunked, "plan_cost_us", lambda M, C, s=1: -C)
    for nvar, halo in ((8, 1), (4, 2), (6, 1), (1, 2)):
        s = nvar * max(halo, 1)
        for N in (1 << 17, 10 ** 5 + 1):
            plan = chunked.make_plan(N, nvar, halo, True)
            assert plan.C <= pcr.max_chunks(2 * s)
            for item in (4, 8):
                pcr.solve_plan(plan.C, 2 * s, 1, item)
        # the cap binds: the grid has admissible counts above it
        assert max(chunked.chunk_counts(1 << 17, halo, True)) > pcr.max_chunks(2 * s) \
            or s < 6


def test_combine_argument_cache():
    """K5's argument block: built once per (rows, arrays, dtype), the
    coefficients rounded to the type and each one's role (0 skip, 1 unit,
    2 scale), in ``Coefs<T>``'s layout (csrc/combine.cu)."""
    import numpy as np

    from triflow_tpu_torch.ops import combine

    rows = [[1.0, 0.0, 0.1], [-0.0, 2.5, 1.0]]
    for dtype, np_type, size in ((torch.float64, np.float64, 144),
                                 (torch.float32, np.float32, 80)):
        block, R = combine._coef_block(rows, 3, dtype)
        assert R == 2 and len(block.raw) == size
        assert combine._coef_block([tuple(r) for r in rows], 3, dtype)[0] is block
        raw = block.raw
        coef = np.frombuffer(raw, dtype=np_type, count=2 * combine.MAX_ARRAYS)
        coef = coef.reshape(2, combine.MAX_ARRAYS)
        assert coef[0, 2] == np_type(0.1) and coef[1, 1] == 2.5
        assert not coef[:, 3:].any()
        role = np.frombuffer(raw, dtype=np.uint8, count=16,
                             offset=coef.nbytes).reshape(2, -1)
        assert role[0, :3].tolist() == [1, 0, 2]
        assert role[1, :3].tolist() == [0, 2, 1]
    assert combine._coef_block(rows, 3, torch.float64)[0] is not \
        combine._coef_block(rows, 3, torch.float32)[0]
    with pytest.raises(ValueError, match="every row needs 4"):
        combine._coef_block(rows, 4, torch.float64)
    with pytest.raises(NotImplementedError, match="at most"):
        combine._coef_block([[1.0] * 9], 9, torch.float64)


def test_check_cuda_reads_the_device_once_and_refuses_each_fault(monkeypatch):
    """The wrappers' shared check on stand-ins for CUDA tensors: a tensor
    off the current device, on the CPU, of another dtype, not contiguous or
    of another shape raises; the current device is read once per call."""

    class Fake:
        def __init__(self, dev, dtype=torch.float64, contiguous=True,
                     shape=(1, 4)):
            self.dev, self.dtype, self.contiguous = dev, dtype, contiguous
            self.shape = torch.Size(shape)
            self.device = (torch.device("cuda", dev) if dev >= 0
                           else torch.device("cpu"))

        def get_device(self):
            return self.dev

        def is_contiguous(self):
            return self.contiguous

    reads = []
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: reads.append(0) or 0)
    shape = torch.Size((1, 4))
    _launch.check_cuda([Fake(0)] * 7, torch.float64, "K", shape)
    assert len(reads) == 1
    for bad, err, match in (
            ([Fake(0), Fake(-1)], ValueError, "CUDA tensors"),
            ([Fake(1)], ValueError, "current device"),
            ([Fake(0), Fake(1)], ValueError, "current device"),
            ([Fake(0), Fake(0, torch.float32)], TypeError, "expected"),
            ([Fake(0), Fake(0, contiguous=False)], ValueError, "contiguous"),
            ([Fake(0), Fake(0, shape=(1, 5))], ValueError, "shape")):
        with pytest.raises(err, match=match):
            _launch.check_cuda(bad, torch.float64, "K", shape)
    with pytest.raises(TypeError, match="float32 or float64"):
        _launch.check_cuda([Fake(0)], torch.float16, "K")
