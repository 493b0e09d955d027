#!/usr/bin/env python3
"""Time the solver kernels, K1's F and J, K6's entries and K7 against a
parent commit's, in one process on one NVIDIA GPU.

    python3 tools/ab_sweep.py [PARENT_DIR] [PAIRS] [GRID ...] [+KERNELS ...]

PARENT_DIR holds the parent's ``triflow_tpu_torch`` package (default
``build/ab_parent``); where it is missing and the checkout is a git
repository, it is unpacked there from commit ``ffd78f9`` (``git
archive``), the commit before K9's lane-split bodies.  GRID words keep only
the grids whose name holds one of them (``film``: the falling film's);
``+word`` arguments keep only those kernel groups (``KERNEL_GROUPS``:
``k2``, ``k4f``, ``setup``, ``shift``, ``k3``, ``corr``, ``k5``,
``stencil``, ``j``, ``k7``, ``k6``, ``batched``, ``k9``; all without).
``+k6`` alone times K6's entries on ``K6_CASES`` (``k6_turns``: the
outputs at the parent's chunk plan bit for bit or their gap, device µs
and host-call ms of the parent, this at the parent's plan and this at
its own).  Both packages load in this process, the parent's under another name, each building its
kernels from its own ``csrc/`` into its own ``build/``, all libraries at
once first.

On the same inputs (random diagonally dominant bands; the plain reduced
factor of K2's and, on a Woodbury plan, its closure; one random
right-hand side) it times, on each grid of ``GRIDS`` and under its chunk
plan: K2 (``thomas.spike_factor``, the whole wrapper), K4's factor
(``pcr.pcr_factor``), its Woodbury set-up (``pcr.woodbury``, on inputs
cold in L2, by its route and at a narrow size the other route's device
µs beside it; and the R-column solve's outputs), its solve with shifts
(``pcr.pcr_solve_shift``), K3's sweep (``thomas.thomas_sweep``) and K3's
correction (``thomas.spike_correct`` of the sweep's y with ``add_to``,
timed on copies of its inputs taken in turn, ``COLD_BYTES`` of them, so
that each call reads its inputs from memory and not from L2); the grids
are KS N = 2^20 (s = 2, one grid, block-cyclic: ``make_plan``'s plan and
C = 1024 and 4096), KS N = 10^6 (Woodbury), the padded ring of KS N =
999983 (1534 and 2041 chunks), Burgers N = 10^6 (s = 1), the falling
film (s = 6, three fields: K2's and K4's wide factors) at N = 10^6 under
``make_plan``'s plan and at C = 500, 1000, 2000 and 4000 (Woodbury), at N
= 2^20 at C = 512, 2048 and 4096, and at 8192 chunks of 2^15 nodes
(block-cyclic), config 5 (B = 1024 members of KS N = 10^5), KS 2^13 at C
= 64 (K4's one-block factor of one grid) and B = 16 and 132 members at C
= 100 (its one-block-per-member factor and set-up); K5 (``combine.combine``: A = 7 arrays, R = 2
rows, KS 2^20's shape) beside one ``torch.mm`` of the same coefficients
over stacked operands; and K1's F (a scale and a bias, a RODASPR stage's
call) on ``STENCIL_GRIDS`` with its outputs and J's against the parent's,
the host call back to back, the device µs on inputs cold in L2 and a
cProfile of 1000 calls at KS 2^20, and F_terms at config 5's shape; K1's
J (``j``) on ``J_GRIDS`` and K7 (``k7``, a number scale and, on members,
a per-member one) on ``K7_GRIDS`` the same way: outputs against the
parent's, periodic and edge, the host call back to back and the device
µs on inputs cold in L2 (the profiler's, and a CUDA graph's of the same
calls: ``chip_smoke.graph_us``, parent, this, this, parent) beside the
bytes bound.  ``k9``: K9's interface and correct entries and its whole
step (``megatheta.theta_step``, with K4) on ``kernel_checks.megatheta_state``
at ``K9_GRIDS`` (Burgers N = 10^6, KS N = 2^20), at the parent's plan and
at this one's (``megatheta.plan_for`` of each side): the outputs against
the parent's at the same plan within the solver pieces' limits (the
entries on the increment where they make one), the host call back to
back, and the device µs of each entry on inputs cold in L2 and of the
step (``chip_smoke.graph_us``).
Float64 and float32; CUDA-event ms per call over back-to-back calls, in
the order parent, this, this, parent, PAIRS times (default 2).  It
checks that both give the same outputs (bit for bit, or within the
solver pieces' limits, 1e-10 of the largest entry in float64 and 1e-4 in
float32, printed beside), and reads each kernel's device µs per launch
from ``torch.profiler`` (20 launches alone).  Prints the card's name and
power limit, one line per measurement, then one JSON line with every
mean.
"""

import importlib.util
import itertools
import json
import subprocess
import sys
import tarfile
import io
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from triflow_tpu_torch import Model  # noqa: E402
from triflow_tpu_torch.ops import (chunked, combine, kernel_checks,  # noqa: E402
                                   matvec, pcr, thomas)

PARENT_COMMIT = "ffd78f9"
#: bytes the inputs of K3's correction rotate over when timed: twice the
#: H100's 50 MB L2, so that each call reads its inputs from memory
COLD_BYTES = 100 * 2 ** 20


def load_parent(path: Path):
    """The parent's ``triflow_tpu_torch`` package, imported as
    ``parent_port`` (its modules import each other relatively)."""
    pkg = path / "triflow_tpu_torch"
    if not pkg.exists():
        if not (ROOT / ".git").exists():
            raise SystemExit(f"{pkg} is missing and {ROOT} is no git checkout")
        blob = subprocess.run(["git", "-C", str(ROOT), "archive", PARENT_COMMIT,
                               "triflow_tpu_torch"], capture_output=True,
                              check=True).stdout
        path.mkdir(parents=True, exist_ok=True)
        with tarfile.open(fileobj=io.BytesIO(blob)) as tar:
            tar.extractall(path)
    spec = importlib.util.spec_from_file_location(
        "parent_port", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_port"] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"parent_port{name}")
                 for name in (".ops.thomas", ".ops.pcr", ".ops.combine", ".ops.matvec", ""))


def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(fn, name, launches=20, tries=5):
    """Device µs per call of fn, summed over the kernels whose name holds
    ``name`` (a string, or a tuple of strings whose kernels each launch
    once a call), over ``launches`` calls of fn alone; a window in which the
    profiler kept another number of them is measured again, and after
    ``tries`` windows the result is None."""
    from torch.profiler import ProfilerActivity, profile

    names = (name,) if isinstance(name, str) else name
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        times = {n: [ev.time_range.end - ev.time_range.start for ev in prof.events()
                     if ev.device_type == torch.autograd.DeviceType.CUDA and n in ev.name]
                 for n in names}
        if all(len(ts) == launches for ts in times.values()):
            return sum(sum(ts) for ts in times.values()) / launches
    return None


#: (name, W, nvar, N, B, chunk count or None for make_plan's, calls timed)
GRIDS = [("ks 2^20", 5, 1, 1 << 20, 1, None, 20),
         ("ks 2^20 C=1024", 5, 1, 1 << 20, 1, 1024, 20),
         ("ks 2^20 C=4096", 5, 1, 1 << 20, 1, 4096, 20),
         ("ks 10^6", 5, 1, 10 ** 6, 1, None, 20),
         ("ks ring 999983 C=1534", 5, 1, 1000168, 1, 1534, 20),
         ("ks ring 999983 C=2041", 5, 1, 1000090, 1, 2041, 20),
         ("burgers 10^6", 3, 1, 10 ** 6, 1, None, 20),
         ("film 10^6", 5, 3, 10 ** 6, 1, None, 5),
         ("film 10^6 C=500", 5, 3, 10 ** 6, 1, 500, 5),
         ("film 10^6 C=1000", 5, 3, 10 ** 6, 1, 1000, 5),
         ("film 10^6 C=2000", 5, 3, 10 ** 6, 1, 2000, 5),
         ("film 10^6 C=4000", 5, 3, 10 ** 6, 1, 4000, 5),
         ("film 2^20 C=512", 5, 3, 1 << 20, 1, 512, 5),
         ("film 2^20 C=2048", 5, 3, 1 << 20, 1, 2048, 5),
         ("film 2^20 C=4096", 5, 3, 1 << 20, 1, 4096, 5),
         ("film 2^15 C=8192", 5, 3, 1 << 15, 1, 8192, 5),
         ("config 5", 5, 1, 10 ** 5, 1024, None, 3),
         ("ks 2^13 C=64", 5, 1, 1 << 13, 1, 64, 20),
         ("ks 10^5 B=16 C=100", 5, 1, 10 ** 5, 16, 100, 5),
         ("ks 10^5 B=132 C=100", 5, 1, 10 ** 5, 132, 100, 5)]


def prebuild(sides, kernels):
    """Build both checkouts' libraries that the run needs at once, one nvcc
    each: the solver libraries and K5 where a group of them is timed, the
    K1 libraries of STENCIL_GRIDS' and J_GRIDS' models where ``stencil`` or
    ``j`` is, K7's where ``k7`` is, K4's and the K9 libraries of K9_GRIDS'
    models where ``k9`` is."""
    from concurrent.futures import ThreadPoolExecutor

    jobs = []
    for th, pc, co, mv, model in sides:
        if kernels & (SOLVER_GROUPS | {"k5"}):
            for lib in (th.FACTOR_LIB, th.SOLVE_LIB, pc.LIB, co.LIB, th.FACTOR_WIDE_LIB,
                        th.SOLVE_WIDE_LIB, pc.WIDE_LIB):
                jobs += lib.builds()
        if "k7" in kernels:
            jobs += getattr(mv.LIB, "builds", lambda lib=mv.LIB: [lib.load])()
        if "k9" in kernels:
            jobs += pc.LIB.builds()
            for _, eqs, _ in K9_GRIDS:
                for double in (True, False):
                    jobs.append(model(*eqs, double=double, device="cuda").backend.megatheta.load)
        grids = (STENCIL_GRIDS if "stencil" in kernels else []) + (
            J_GRIDS if "j" in kernels else [])
        for eqs in {id(g[1]): g[1] for g in grids}.values():
            for double in (True, False):
                jobs.append(model(*eqs, double=double, device="cuda").backend.stencil.load)
    with ThreadPoolExecutor(len(jobs)) as pool:
        for fut in [pool.submit(job) for job in jobs]:
            fut.result()


def cold_copies(nbytes, first, clone):
    """``first`` and copies ``clone(*first)`` of a call's inputs, as many as
    span COLD_BYTES with ``nbytes`` each (``first`` alone where it does):
    timed in turn, each call reads inputs that COLD_BYTES of other traffic
    has passed through L2 since their last read."""
    n = 1 if nbytes >= COLD_BYTES else 1 + -(-COLD_BYTES // nbytes)
    return [first] + [clone(*first) for _ in range(n - 1)]


#: the kernel groups (``+word`` arguments): K2, K4's factor, its Woodbury
#: set-up and R-column solve, its solve with shifts, K3's sweep and
#: correction, K5, K1's F and F_terms, K1's J, K7, K6's entries, K6's
#: member-axis checks at B = 64 (``batched``), K9's entries and step
KERNEL_GROUPS = ("k2", "k4f", "setup", "shift", "k3", "corr", "k5", "stencil", "j", "k7",
                 "k6", "batched", "k9")
#: the groups timed on the solver grids (``GRIDS``)
SOLVER_GROUPS = {"k2", "k4f", "setup", "shift", "k3", "corr"}
KS = ("-dxxU - dxxxxU - U * dxU", "U", [])
BURGERS = ("-U * dxU + nu * dxxU", "U", ["nu"])
FILM = (["-dxq",
         "9/7 * q**2 / h**2 * dxh - upwind(17/7 * q / h, q, 2)"
         " + (h - q / h**2) / delta + h * dxxxh / (3 * delta) - Ma * h * dxG",
         "-upwind(3/2 * q / h, G, 2) + dxxG / Pe"],
        ["h", "q", "G"], ["delta", "Ma", "Pe"])
#: (label, equations, N, members) of K1's timings: one grid on the F
#: entry, members on F_terms
STENCIL_GRIDS = [("ks 2^20", KS, 1 << 20, 1), ("ks 10^6", KS, 10 ** 6, 1),
                 ("burgers 10^6", BURGERS, 10 ** 6, 1), ("film 10^6", FILM, 10 ** 6, 1),
                 ("ks 999983", KS, 999983, 1), ("ks 1000", KS, 1000, 1),
                 ("config 5", KS, 10 ** 5, 1024)]
#: (label, equations, N, members) of K1's J timings
J_GRIDS = [("ks 2^20", KS, 1 << 20, 1), ("ks 10^6", KS, 10 ** 6, 1),
           ("config 5", KS, 10 ** 5, 1024), ("film 10^6", FILM, 10 ** 6, 1)]
#: (label, W, nvar, N, members) of K7's timings: KS 10^6's refine=1
#: residual, the advection-diffusion trajectory's (N = 1024) and the refined
#: ensemble's (B = 4 KS members at N = 10^5)
K7_GRIDS = [("ks 10^6", 5, 1, 10 ** 6, 1), ("advdiff 1024", 3, 1, 1024, 1),
            ("refine B=4 10^5", 5, 1, 10 ** 5, 4)]
#: (label, equations, N) of K9's timings: bench.py's config 2 grid and KS
#: at 2^20, the opt-in step's cells
K9_GRIDS = [("burgers 10^6", BURGERS, 10 ** 6), ("ks 2^20", KS, 1 << 20)]
#: the card's memory rate (NVIDIA H100 SXM data sheet, at the 700 W limit)
BYTES_PER_S = 3.35e12


#: K6's cases (``k6``): (label, model, N, periodic, chunk count or None
#: for the parent's make_plan, members, entry); the entries: "step" one
#: fixed RODASPR step (its table without the error row, as the smoke
#: times it; "step_err" with it, the adaptive entries' table),
#: "adaptive" the first output step of KS 2^13 (dt 1.0, tol 1e-3),
#: "shared" / "member" the adaptive scan of two output steps with a
#: shared dt / per member, "steps100" 100 fixed steps in one launch (the
#: sweep's ``steps(100)``), "mixed" one df64 mixed step with one residual
#: pass (float64 only)
K6_MODELS = {"readme": ("k * dxxU - c * dxU", "U", ["k", "c"]), "ks": KS,
             "burgers": BURGERS,
             "two_var": (["-dxq", "-dx(q**2/h) - h * dxxxh + q / h"], ["h", "q"], [])}
K6_CASES = [("readme N=200", "readme", 200, False, None, 1, "step"),
            ("ks N=2^13", "ks", 1 << 13, True, None, 1, "step"),
            ("ks N=2^13 err row", "ks", 1 << 13, True, None, 1, "step_err"),
            ("ks N=2^13 C=4 woodbury", "ks", 1 << 13, True, 4, 1, "step"),
            ("burgers N=10^4", "burgers", 10 ** 4, True, None, 1, "step"),
            ("two_var N=600", "two_var", 600, True, None, 1, "step"),
            ("ks N=2^13 adaptive", "ks", 1 << 13, True, None, 1, "adaptive"),
            ("ks B=4 N=200 shared", "ks", 200, True, None, 4, "shared"),
            ("ks B=64 N=200 shared", "ks", 200, True, None, 64, "shared"),
            ("ks B=64 N=200 per member", "ks", 200, True, None, 64, "member"),
            ("ks B=64 N=200 steps(100)", "ks", 200, True, None, 64, "steps100"),
            ("ks B=4 N=2^13 steps(1)", "ks", 1 << 13, True, None, 4, "step"),
            ("ks N=2^13 mixed", "ks", 1 << 13, True, None, 1, "mixed"),
            ("ks N=10^4 mixed", "ks", 10 ** 4, True, None, 1, "mixed")]
K6_KERNEL = {"step": "step_kernel", "step_err": "step_kernel", "adaptive": "adaptive_kernel",
             "shared": "scan_kernel", "member": "scan_kernel", "steps100": "step_kernel",
             "mixed": "step_mixed_kernel"}


def k6_state(model, N, periodic, B):
    """The inputs of a K6 case: kernel_checks' states (the README and KS
    ones; Burgers the K9 checks' grid), B members stacked."""
    sysm = model.backend.system
    if len(sysm.pars) == 1:
        one = lambda b: kernel_checks.megatheta_state(model, N, "cuda", seed=b)
        if B == 1:
            return one(0)
        parts = [one(b) for b in range(B)]
        return (*(torch.stack([p[k] for p in parts]) for k in range(3)), parts[0][3])
    if B == 1:
        return kernel_checks.mega_state(model, N, periodic, "cuda")
    return kernel_checks.mega_members(model, N, periodic, "cuda", B)


def k6_sides(old_port, case, dtype):
    """(parent's call, this one's at the parent's chunk plan, this one's at
    its own plan or None where it is the same, the parent's chunk plan and
    this one's own) of one case."""
    from triflow_tpu_torch.ops import megastep

    label, name, N, periodic, C, B, entry = case
    old_ms = importlib.import_module("parent_port.ops.megastep")
    old_kc = importlib.import_module("parent_port.ops.kernel_checks")
    old_rb = importlib.import_module("parent_port.core.rosenbrock")
    eqs = K6_MODELS[name]
    mixed = entry == "mixed"
    double = "df64" if mixed else dtype == torch.float64
    new_m = Model(*eqs, double=double, device="cuda")
    old_m = old_port.Model(*eqs, double=double, device="cuda")
    sysm = new_m.system
    old_plan = (old_ms.make_plan(N, sysm.nvar, sysm.halo, periodic) if C is None
                else importlib.import_module("parent_port.ops.chunked").plan_with(
                    N, sysm.nvar, sysm.halo, periodic, C))
    old_plan = old_plan._replace(B=B)
    same = chunked.plan_with(N, sysm.nvar, sysm.halo, periodic, old_plan.C, B)
    own = megastep.make_plan(N, sysm.nvar, sysm.halo, periodic)._replace(B=B)
    args = k6_state(new_m, N, periodic, B)
    T = np.float64 if new_m.backend.dtype == torch.float64 else np.float32
    if entry in ("step", "step_err", "steps100", "mixed"):
        err_row = entry == "step_err"
        tab, old_tab = kernel_checks.rodaspr_table(err_row), old_kc.rodaspr_table(err_row)
        dt = 0.0625 if mixed else 0.05
        gdt = float(T(tab.g00) * T(dt)) if not mixed else tab.g00 * float(np.float32(dt))
        n = 100 if entry == "steps100" else 1

        def call(ms, b, plan, table):
            if mixed:
                return lambda: ms.step_mixed(b, plan, table, periodic, *args, -gdt, gdt, 1)
            return lambda: ms.step(b, plan, table, periodic, *args, -gdt, gdt, n)
    else:
        tab, old_tab = kernel_checks.rodaspr_table(), old_kc.rodaspr_table()
        per = entry == "member"
        out_dt = 1.0

        def call(ms, b, plan, table):
            rb = old_rb if ms is old_ms else None
            ctl = (rb or importlib.import_module("triflow_tpu_torch.core.rosenbrock"))
            ctl = ctl.member_controller if per else ctl.adaptive_controller
            a = (ctl, b, plan, table, periodic, *args, 0.0, out_dt, 1e-6, 1e-3, 0.9, None,
                 None)
            if entry == "adaptive":
                return lambda: ms.row_adaptive_step(*a)
            return lambda: ms.adaptive_scan(*a, 2, per_member=per, attempts=True)
    new_b, old_b = new_m.backend, old_m.backend
    return (call(old_ms, old_b, old_plan, old_tab), call(megastep, new_b, same, tab),
            None if own.C == same.C else call(megastep, new_b, own, tab), same, own)


def k6_gap(new, old):
    """``gap`` of every output of an entry together and, where they
    differ, each output's own (u, err or dt_i, attempts, status, ...): a
    number as "this / parent"."""
    new, old = flat(new), flat(old)
    got = gap(new, old)
    if got == "equal":
        return got
    parts = []
    for a, b in zip(new, old):
        a, b = a.cpu(), b.cpu()
        if torch.equal(a, b):
            parts.append("equal")
        elif a.numel() == 1:
            parts.append(f"{float(a)!r} / {float(b)!r}")
        else:
            parts.append(gap((a,), (b,)))
    return f"{got} ({'; '.join(parts)})"


def flat(out):
    """The tensors and numbers of an entry's output, as tensors."""
    items = out if isinstance(out, tuple) else (out,)
    return tuple(a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a, float))
                 for a in items)


def gap(new, old):
    """"equal" where every tensor of ``new`` is bit for bit ``old``'s, else
    the largest difference relative to the largest entry."""
    if all(torch.equal(a, b) for a, b in zip(new, old)):
        return "equal"
    return "relative gap %.2e" % max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))
                                     for a, b in zip(new, old))


def batched_checks(old_port, B=64):
    """Each side's own ``kernel_checks.check_megastep_batched`` at B
    members on ``BATCH_MEGA_CASES``, both dtypes: its largest errors, or
    the check that failed; beside it, per table of the check (RODASPR with
    a shared and a per-member dt, Theta), whether either side's 3-step
    launch holds a non-finite value, and how far the plain float32 step
    lies from the plain float64 step of the same inputs (the rounding of
    the problem itself)."""
    from triflow_tpu_torch.ops import megastep

    old_kc = importlib.import_module("parent_port.ops.kernel_checks")
    old_ms = importlib.import_module("parent_port.ops.megastep")
    for dtype in (torch.float64, torch.float32):
        dt_name = str(dtype).replace("torch.", "")
        T = np.float64 if dtype == torch.float64 else np.float32
        for name, N, periodic, dt, adaptive in kernel_checks.BATCH_MEGA_CASES:
            eqs = kernel_checks.MEGA_MODELS[name]
            what = f"K6 batched {name} N={N} B={B} {dt_name}"
            for side, make, kc in (("parent", old_port.Model, old_kc),
                                   ("this", Model, kernel_checks)):
                model = make(*eqs, double=dtype == torch.float64, device="cuda")
                try:
                    got = kc.check_megastep_batched(model, N, periodic, dt, "cuda",
                                                    adaptive=adaptive, B=B)
                    print(f"{what} {side}: passed, "
                          + json.dumps({k: float(v) for k, v in got.items()}), flush=True)
                except kc.CheckFailed as exc:
                    print(f"{what} {side}: FAILED {exc}", flush=True)
            model = Model(*eqs, double=dtype == torch.float64, device="cuda")
            m64 = Model(*eqs, double=True, device="cuda")
            sysm = model.backend.system
            plan = megastep.plan_for(N, sysm.nvar, sysm.halo, periodic, B)
            if plan is None:
                plan = megastep.make_plan(N, sysm.nvar, sysm.halo, periodic)._replace(B=B)
            args = kernel_checks.mega_members(model, N, periodic, "cuda", B)
            ros = kernel_checks.rodaspr_table()
            dts = np.asarray(dt * (1.0 + 0.25 * np.arange(B)), dtype=T)
            gdt_b = megastep.gdt_of(T, ros.g00, dts, "cuda")
            g = float(T(ros.g00) * T(dt))
            old_b = old_port.Model(*eqs, double=dtype == torch.float64, device="cuda").backend
            old_plan = importlib.import_module("parent_port.ops.chunked").plan_with(
                N, sysm.nvar, sysm.halo, periodic, plan.C, B)
            parts = []
            for tname, tables, beta, scale in (
                    ("rodaspr", (old_kc.rodaspr_table(), ros), -g, g),
                    ("rodaspr per-member", (old_kc.rodaspr_table(), ros), -gdt_b, gdt_b),
                    ("theta=1", (old_ms.theta_table(1.0), megastep.theta_table(1.0)),
                     -float(T(dt)), float(T(dt)))):
                fin = []
                for ms, b, pl, table in ((old_ms, old_b, old_plan, tables[0]),
                                         (megastep, model.backend, plan, tables[1])):
                    u3 = ms.step(b, pl, table, periodic, *args, beta, scale, nsteps=3)[0]
                    fin.append(bool(torch.isfinite(u3).all()))
                table = tables[1]
                want = megastep.step_plain(model.backend, plan, table, periodic, *args, beta,
                                           scale)[0]
                b64 = (beta.double() if isinstance(beta, torch.Tensor) else beta,
                       scale.double() if isinstance(scale, torch.Tensor) else scale)
                want64 = megastep.step_plain(m64.backend, plan, table, periodic,
                                             *(a.double() for a in args), *b64)[0]
                rel = float((want.double() - want64).abs().max() / want64.abs().max())
                parts.append(f"{tname}: 3-step launch finite parent {fin[0]} this {fin[1]}, "
                             f"plain against plain float64 {rel:.3e}")
            print(f"{what} (C={plan.C}): " + "; ".join(parts), flush=True)
            torch.cuda.empty_cache()


def main():
    args = sys.argv[1:]
    parent_dir = Path(args[0]) if args else ROOT / "build" / "ab_parent"
    pairs = int(args[1]) if len(args) > 1 else 2
    kernels = {w[1:] for w in args[2:] if w.startswith("+")} or set(KERNEL_GROUPS)
    words = [w for w in args[2:] if not w.startswith("+")]
    grids = [g for g in GRIDS if not words or any(w in g[0] for w in words)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card {smi}", flush=True)
    old_thomas, old_pcr, old_combine, old_matvec, old_port = load_parent(parent_dir)
    if kernels & (SOLVER_GROUPS | {"k5", "stencil", "j", "k7", "k9"}):
        prebuild([(thomas, pcr, combine, matvec, Model),
                  (old_thomas, old_pcr, old_combine, old_matvec, old_port.Model)], kernels)
    if not kernels & SOLVER_GROUPS:
        grids = []
    means = {}

    def turns(what, old, new, iters):
        got = {"parent": [], "this": []}
        for _ in range(pairs):
            for side, fn in (("parent", old), ("this", new), ("this", new),
                             ("parent", old)):
                got[side].append(cuda_ms(fn, iters))
        for side, ms in got.items():
            means[f"{what} {side}"] = sum(ms) / len(ms)
        print(f"  {what}: parent " + " / ".join(f"{m:.4f}" for m in got["parent"])
              + " ms, this " + " / ".join(f"{m:.4f}" for m in got["this"])
              + f" ms; this / parent {means[f'{what} this'] / means[f'{what} parent']:.3f}",
              flush=True)

    def on_device(what, old, new, name, old_name=None):
        for side, fn, nm in (("parent", old, old_name or name), ("this", new, name)):
            us = device_us(fn, nm)
            means[f"{what} {side} device us"] = us
            print(f"  {what} {side}: "
                  + (f"{us:.3f} device us per launch" if us is not None
                     else "device us not measured (the profiler dropped launches)"),
                  flush=True)

    def setup_turns(name, dt, where, plan, B, red, fact, iters):
        """K4's Woodbury set-up (``pcr.woodbury``) against the parent's
        one-block set-up, on inputs cold in L2, and at a narrow block size
        by each of its routes; the R-column solve of random right-hand
        sides beside it."""
        s2, C = 2 * plan.s, plan.C
        lead = (B,) if B > 1 else ()
        new_out = pcr.woodbury(red, fact.Lred, fact.Ured)
        old_out = old_pcr.woodbury(red, fact.Lred, fact.Ured)
        route = pcr.cols_route(s2, C, B)
        print(f"K4 woodbury set-up {where}, route {route}, "
              f"{pcr.solve_plan(C, s2, B * s2, red.Dinv.element_size())}; "
              f"{gap(new_out, old_out)}", flush=True)
        del new_out, old_out
        # the factor's operators, Dinv and the corner blocks, cold in L2
        nbytes = sum(a.numel() * a.element_size() for a in (*red, fact.Lred, fact.Ured))
        sets = cold_copies(nbytes, (red, fact.Lred, fact.Ured), lambda r, L, U: (
            pcr.PcrFactor(*(a.clone() for a in r)), L.clone(), U.clone()))

        def cold(call):
            turn = itertools.cycle(sets)
            return lambda: call(*next(turn))

        def by(route):
            def call(r, L, U):
                Z = torch.empty((*lead, s2, s2, C), dtype=L.dtype, device=L.device)
                cap = torch.empty((*lead, s2, s2), dtype=L.dtype, device=L.device)
                pcr._launch_cols(r, None, L, U, Z, cap, s2, B, route)
                return Z, cap
            return call

        what = f"K4 woodbury set-up {name} {dt}"
        turns(what, cold(old_pcr.woodbury), cold(pcr.woodbury), iters * len(sets))
        names = {"clusters": ("pcr_solve_cols_cluster_kernel", "woodbury_cap_kernel"),
                 "members": "pcr_solve_kernel"}
        on_device(what, cold(old_pcr.woodbury), cold(pcr.woodbury), names[route],
                  "pcr_solve_kernel")
        if s2 <= 2 * thomas.NARROW_S:
            other = "members" if route == "clusters" else "clusters"
            got = by(other)(red, fact.Lred, fact.Ured)
            ref = pcr.woodbury(red, fact.Lred, fact.Ured)
            print(f"  {what} route {other}: {gap(got, ref)} against route {route}",
                  flush=True)
            us = device_us(cold(by(other)), names[other])
            means[f"{what} {other} device us"] = us
            print(f"  {what} route {other}: "
                  + (f"{us:.3f} device us per call" if us is not None else
                     "device us not measured"), flush=True)
        del sets
        # the R-column solve of s2 random columns (kernel_checks' shape)
        gen = torch.Generator(device="cuda").manual_seed(4)
        cols = torch.randn(lead + (s2, s2, C), dtype=red.Dinv.dtype, device="cuda",
                           generator=gen)
        print(f"K4 pcr_solve {where}: "
              f"{gap((pcr.pcr_solve(red, cols),), (old_pcr.pcr_solve(red, cols),))}",
              flush=True)

    def stencil_turns(dt, dtype):
        """K1's F entry (scale and bias, a RODASPR stage's call) against the
        parent's on STENCIL_GRIDS, F_terms at config 5's shape, and J's
        output against the parent's: outputs bit for bit, the host call's
        ms (CUDA events over back-to-back calls), device µs on inputs cold
        in L2, and where the host's time goes (cProfile of 1000 calls of
        the F entry at KS 2^20)."""
        import cProfile
        import pstats

        double = dtype == torch.float64
        gen = torch.Generator(device="cuda").manual_seed(5)
        for label, eqs, N, B in STENCIL_GRIDS:
            new_b = Model(*eqs, double=double, device="cuda").backend
            old_b = old_port.Model(*eqs, double=double, device="cuda").backend
            sysm = new_b.system
            lead = (B,) if B > 1 else ()

            def rand(*shape):
                return torch.randn(shape, dtype=dtype, device="cuda", generator=gen)

            x = torch.linspace(0.0, 0.5 * N, N, dtype=dtype, device="cuda")
            u, bias = rand(*lead, sysm.nvar, N), rand(*lead, sysm.nvar, N)
            helpers = rand(*lead, len(sysm.help_funcs), N)
            pstack = 0.5 + torch.rand((*lead, len(sysm.pars), N), dtype=dtype,
                                      device="cuda", generator=gen)
            what = f"{label} {dt}"
            if B == 1:
                for periodic in (True, False):
                    got = new_b.F(u, helpers, pstack, x, periodic=periodic, scale=0.05,
                                  bias=bias)
                    want = old_b.F(u, helpers, pstack, x, periodic=periodic, scale=0.05,
                                   bias=bias)
                    print(f"K1.F {what} periodic={periodic}: {gap((got,), (want,))}; J "
                          + gap((new_b.J_bands(u, helpers, pstack, x, periodic=periodic),),
                                (old_b.J_bands(u, helpers, pstack, x, periodic=periodic),)),
                          flush=True)
                nbytes = (3 * sysm.nvar + helpers.shape[-2] + pstack.shape[-2] + 1) * N \
                    * u.element_size()
                sets = cold_copies(nbytes, (u, helpers, pstack, x, bias),
                                   lambda *a: tuple(v.clone() for v in a))

                def cold(b):
                    turn = itertools.cycle(sets)

                    def go():
                        u_, h_, p_, x_, c_ = next(turn)
                        return b.F(u_, h_, p_, x_, periodic=True, scale=0.05, bias=c_)
                    return go

                turns(f"K1.F {what}", lambda: old_b.F(u, helpers, pstack, x, periodic=True,
                                                      scale=0.05, bias=bias),
                      lambda: new_b.F(u, helpers, pstack, x, periodic=True, scale=0.05,
                                      bias=bias), 1000)
                on_device(f"K1.F {what} cold", cold(old_b), cold(new_b), "stencil_F_kernel")
                if label == "ks 2^20":
                    for side, b in (("parent", old_b), ("this", new_b)):
                        prof = cProfile.Profile()
                        prof.enable()
                        for _ in range(1000):
                            b.F(u, helpers, pstack, x, periodic=True, scale=0.05, bias=bias)
                        prof.disable()
                        torch.cuda.synchronize()
                        print(f"  cProfile K1.F {what} {side}, 1000 calls:", flush=True)
                        pstats.Stats(prof, stream=sys.stdout).sort_stats(
                            "tottime").print_stats(12)
                del sets
            else:
                terms = [(c, d, rand(B, sysm.nvar, N)) for c, d in (
                    (1.0, 0.0), (0.37, 1.0), (-0.21, 0.5), (0.0, -0.7), (1.3, 0.0), (0.8, 0.2))]
                got = new_b.F_terms(terms, helpers, pstack, x, periodic=True, scale=0.05)
                want = old_b.F_terms(terms, helpers, pstack, x, periodic=True, scale=0.05)
                print(f"K1.F_terms {what} (A = 6): {gap((got,), (want,))}", flush=True)
                turns(f"K1.F_terms {what}",
                      lambda: old_b.F_terms(terms, helpers, pstack, x, periodic=True,
                                            scale=0.05),
                      lambda: new_b.F_terms(terms, helpers, pstack, x, periodic=True,
                                            scale=0.05), 5)
                on_device(f"K1.F_terms {what}",
                          lambda: old_b.F_terms(terms, helpers, pstack, x, periodic=True,
                                                scale=0.05),
                          lambda: new_b.F_terms(terms, helpers, pstack, x, periodic=True,
                                                scale=0.05), "stencil_F_terms")
            torch.cuda.empty_cache()

    def on_graph(what, old, new, launches):
        """Device µs per call of each side without the host's time
        (``chip_smoke.graph_us``: the calls captured in a CUDA graph),
        parent, this, this, parent."""
        from chip_smoke import graph_us

        got = {"parent": [], "this": []}
        for side, fn in (("parent", old), ("this", new), ("this", new), ("parent", old)):
            got[side].append(graph_us(fn, launches))
        for side, us in got.items():
            means[f"{what} {side} graph us"] = sum(us) / len(us)
        print(f"  {what}: graph device us parent " + " / ".join(f"{u:.3f}" for u in got["parent"])
              + ", this " + " / ".join(f"{u:.3f}" for u in got["this"]), flush=True)

    def log_bound(what, nbytes):
        print(f"  {what}: bound {nbytes / BYTES_PER_S * 1e6:.3f} device us "
              f"({nbytes} bytes)", flush=True)

    def j_turns(dt, dtype):
        """K1's J entry against the parent's on J_GRIDS: outputs bit for bit
        (periodic and edge), the host call's ms back to back, the device µs
        on inputs cold in L2 (periodic) beside the bytes bound (inputs read
        once, the bands written once)."""
        double = dtype == torch.float64
        gen = torch.Generator(device="cuda").manual_seed(7)
        for label, eqs, N, B in J_GRIDS:
            new_b = Model(*eqs, double=double, device="cuda").backend
            old_b = old_port.Model(*eqs, double=double, device="cuda").backend
            sysm = new_b.system
            lead = (B,) if B > 1 else ()

            def rand(*shape):
                return torch.randn(shape, dtype=dtype, device="cuda", generator=gen)

            # positive states and parameters: the film divides by h
            args = (1.0 + 0.1 * rand(*lead, sysm.nvar, N),
                    rand(*lead, len(sysm.help_funcs), N),
                    0.5 + rand(*lead, len(sysm.pars), N).abs(),
                    torch.linspace(0.0, 0.5 * N, N, dtype=dtype, device="cuda"))
            what = f"K1.J {label} {dt}"
            for periodic in (True, False):
                print(f"{what} periodic={periodic}: "
                      + gap((new_b.J_bands(*args, periodic=periodic),),
                            (old_b.J_bands(*args, periodic=periodic),)), flush=True)
                torch.cuda.empty_cache()
            nbytes = (sum(a.numel() for a in args)
                      + B * new_b.window * sysm.nvar ** 2 * N) * args[0].element_size()
            sets = cold_copies(nbytes, args, lambda *a: tuple(v.clone() for v in a))

            def cold(b):
                turn = itertools.cycle(sets)
                return lambda: b.J_bands(*next(turn), periodic=True)

            turns(what, lambda: old_b.J_bands(*args, periodic=True),
                  lambda: new_b.J_bands(*args, periodic=True), 3 if B > 1 else 200)
            on_device(f"{what} cold", cold(old_b), cold(new_b), "stencil_J")
            on_graph(f"{what} cold", cold(old_b), cold(new_b), 3 if B > 1 else max(50, len(sets)))
            log_bound(what, nbytes)
            del sets, args
            torch.cuda.empty_cache()

    def k7_turns(dt, dtype):
        """K7 against the parent's on K7_GRIDS: outputs bit for bit (periodic
        and edge; a number scale and on members a per-member one), the host
        call's ms back to back, the device µs on inputs cold in L2 beside
        the bytes bound (bands and v read once, the product written once)."""
        gen = torch.Generator(device="cuda").manual_seed(8)
        for label, W, nvar, N, B in K7_GRIDS:
            lead = (B,) if B > 1 else ()
            bands = torch.randn((*lead, W, nvar, nvar, N), dtype=dtype, device="cuda",
                                generator=gen)
            v = torch.randn((*lead, nvar, N), dtype=dtype, device="cuda", generator=gen)
            scales = [0.0125] + ([0.01 + torch.rand(B, dtype=dtype, device="cuda",
                                                    generator=gen)] if B > 1 else [])
            what = f"K7 {label} {dt}"
            for periodic in (True, False):
                for sc in scales:
                    kind = "per-member" if isinstance(sc, torch.Tensor) else "number"
                    print(f"{what} periodic={periodic} scale {kind}: "
                          + gap((matvec.banded_matvec(bands, v, periodic, sc),),
                                (old_matvec.banded_matvec(bands, v, periodic, sc),)),
                          flush=True)
            nbytes = (bands.numel() + 2 * v.numel()) * v.element_size()
            sets = cold_copies(nbytes, (bands, v), lambda a, b: (a.clone(), b.clone()))

            def cold(mod):
                turn = itertools.cycle(sets)
                return lambda: mod.banded_matvec(*next(turn), True, 0.0125)

            turns(what, lambda: old_matvec.banded_matvec(bands, v, True, 0.0125),
                  lambda: matvec.banded_matvec(bands, v, True, 0.0125), 1000)
            on_device(f"{what} cold", cold(old_matvec), cold(matvec), "matvec")
            on_graph(f"{what} cold", cold(old_matvec), cold(matvec), max(50, len(sets)))
            log_bound(what, nbytes)
            del sets, bands, v
            torch.cuda.empty_cache()

    def k9_turns(dt, dtype):
        """K9's entries and step against the parent's on K9_GRIDS (see the
        module's docstring)."""
        from triflow_tpu_torch.ops import megatheta

        old_k9 = importlib.import_module("parent_port.ops.megatheta")
        tol = kernel_checks.TOL[dtype]["solve"]
        for label, eqs, N in K9_GRIDS:
            new_m = Model(*eqs, double=dtype == torch.float64, device="cuda")
            old_m = old_port.Model(*eqs, double=dtype == torch.float64, device="cuda")
            new_b, old_b = new_m.backend, old_m.backend
            sysm = new_m.system
            args = kernel_checks.megatheta_state(new_m, N, "cuda")
            u = args[0]
            beta, dts = megatheta.scalars(dtype, 1.0, 0.05)
            own_new = megatheta.plan_for(N, sysm.nvar, sysm.halo)
            own_old = old_k9.plan_for(N, sysm.nvar, sysm.halo)
            nbytes = sum(a.numel() for a in args) * u.element_size()
            sets = cold_copies(nbytes, args, lambda *a: tuple(v.clone() for v in a))
            for plan in {own_old.C: own_old, own_new.C: own_new}.values():
                what = f"K9 {label} {dt} C={plan.C} Mc={plan.Mc}"
                whose = " and ".join(w for w, p in (("the parent's", own_old),
                                                    ("this", own_new)) if p.C == plan.C)
                red_new = megatheta.interface(new_b, plan, *args, beta, dts)
                red_old = old_k9.interface(old_b, plan, *args, beta, dts)
                errs = [float((a - b).abs().max() / b.abs().max())
                        for a, b in zip(red_new, red_old)]
                Lred, Ured, yred = red_old
                fac = pcr.pcr_factor(Lred, Ured, plan.cyclic)
                wood = pcr.woodbury(fac, Lred, Ured) if plan.woodbury else ()
                xm1, xp1 = pcr.pcr_solve_shift(fac, yred, plan.wrap, *wood)
                outs = [(megatheta.correct(new_b, plan, *args, beta, dts, xm1, xp1),
                         old_k9.correct(old_b, plan, *args, beta, dts, xm1, xp1)),
                        (megatheta.theta_step(new_b, plan, 1.0, *args, 0.05),
                         old_k9.theta_step(old_b, plan, 1.0, *args, 0.05))]
                errs += [kernel_checks.increment_error(a, b, u, tol, what)[1]
                         for a, b in outs]
                print(f"{what} ({whose} plan): Lred, Ured, yred relative gaps "
                      + ", ".join(f"{e:.3e}" for e in errs[:3])
                      + f"; correct and step on the increment {errs[3]:.3e}, {errs[4]:.3e}"
                      f" (limit {tol:.0e})", flush=True)
                if not all(e <= tol for e in errs):
                    raise SystemExit(f"{what}: outside the solver pieces' limits")
                del outs, red_new, red_old
                entries = {
                    "interface": lambda k9, b, a: k9.interface(b, plan, *a, beta, dts),
                    "correct": lambda k9, b, a: k9.correct(b, plan, *a, beta, dts, xm1, xp1)}
                for entry, call in entries.items():
                    turns(f"{what} {entry}", lambda: call(old_k9, old_b, args),
                          lambda: call(megatheta, new_b, args), 50)

                    def cold(k9, b, call=call):
                        turn = itertools.cycle(sets)
                        return lambda: call(k9, b, next(turn))

                    on_graph(f"{what} {entry} cold", cold(old_k9, old_b),
                             cold(megatheta, new_b), max(50, len(sets)))
                    log_bound(f"{what} {entry}", nbytes + (u.numel() if entry == "correct"
                                                           else 0) * u.element_size())
            # the whole step, each side under its own plan
            what = f"K9 step {label} {dt} (C={own_old.C} / C={own_new.C})"
            old_step = lambda: old_k9.theta_step(old_b, own_old, 1.0, *args, 0.05)  # noqa: E731
            new_step = lambda: megatheta.theta_step(new_b, own_new, 1.0, *args, 0.05)  # noqa: E731
            turns(what, old_step, new_step, 20)
            try:
                on_graph(what, old_step, new_step, 20)
            except RuntimeError as err:
                torch.cuda.synchronize()
                print(f"  {what}: graph device us not measured ({err})", flush=True)
            del sets, args
            torch.cuda.empty_cache()

    def k6_turns():
        """K6's entries against the parent's (``K6_CASES``): the outputs at
        the parent's chunk plan bit for bit (or their gap), then device µs
        (the profiler, 20 launches alone) and host-call ms of the parent,
        this at the parent's plan and this at its own plan."""
        from concurrent.futures import ThreadPoolExecutor

        from triflow_tpu_torch.ops import megastep

        # every K6 library of both sides at once, one nvcc each
        jobs = []
        for make in (Model, old_port.Model):
            for name in sorted({c[1] for c in K6_CASES}):
                for double in (True, False):
                    jobs.append(make(*K6_MODELS[name], double=double,
                                     device="cuda").backend.megastep.load)
            jobs.append(make(*K6_MODELS["ks"], double="df64",
                             device="cuda").backend.megastep_mixed.load)
        with ThreadPoolExecutor(len(jobs)) as pool:
            for fut in [pool.submit(job) for job in jobs]:
                fut.result()
        for dtype in (torch.float64, torch.float32):
            dt = str(dtype).replace("torch.", "")
            for case in K6_CASES:
                label, entry = case[0], case[-1]
                if entry == "mixed" and dtype != torch.float64:
                    continue
                old, new, own, same, own_plan = k6_sides(old_port, case, dtype)
                mixed = entry == "mixed"
                cps = [megastep.cluster_plan(p, 6, torch.float64 if mixed else dtype,
                                             p.B, mixed) for p in (same, own_plan)]
                print(f"K6 {label} {dt}: the parent's chunk plan C={same.C} (K={cps[0].K}, "
                      f"{cps[0].bytes} shared bytes a CTA), its own C={own_plan.C} "
                      f"(K={cps[1].K}, {cps[1].bytes}); {k6_gap(new(), old())}",
                      flush=True)
                what = f"K6 {label} {dt}"
                kern = K6_KERNEL[entry]
                iters = 3 if "C=4" in label else 10
                turns(what, old, new, iters)
                on_device(what, old, new, kern)
                if own is not None:
                    turns(f"{what} own plan", old, own, iters)
                    on_device(f"{what} own plan", old, own, kern)
                torch.cuda.empty_cache()

    if "k6" in kernels:
        k6_turns()
    if "batched" in kernels:
        batched_checks(old_port)
    for dtype in (torch.float64, torch.float32):
        dt = str(dtype).replace("torch.", "")
        suffix = "f64" if dtype == torch.float64 else "f32"
        item = torch.finfo(dtype).bits // 8
        for name, W, nvar, N, B, C, iters in grids:
            plan = (chunked.make_plan(N, nvar, W // 2, True, B) if C is None
                    else chunked.plan_with(N, nvar, W // 2, True, C, B))
            bands = kernel_checks.random_bands(W, nvar, N, dtype, "cuda")
            if B > 1:
                bands = bands.expand(B, *bands.shape).contiguous()
            where = (f"{name} {dt}: s={plan.s} C={plan.C} Mc={plan.Mc} B={B} "
                     f"woodbury={plan.woodbury}")
            fact = thomas.spike_factor(bands, 1.0, -0.3, plan)
            if "k2" in kernels:
                f_old = old_thomas.spike_factor(bands, 1.0, -0.3, plan)
                fp = thomas.factor_plan(plan.nvar, plan.halo, item, plan.Mc, plan.C, B)
                print(f"K2 factor {where}, {fp}; {gap(fact, f_old)}", flush=True)
                del f_old
                turns(f"K2 factor {name} {dt}",
                      lambda: old_thomas.spike_factor(bands, 1.0, -0.3, plan),
                      lambda: thomas.spike_factor(bands, 1.0, -0.3, plan), iters)
                on_device(f"K2 factor {name} {dt}",
                          lambda: old_thomas.spike_factor(bands, 1.0, -0.3, plan),
                          lambda: thomas.spike_factor(bands, 1.0, -0.3, plan),
                          "spike_factor")
            del bands
            # K4's factor of the reduced system
            red = pcr.pcr_factor(fact.Lred, fact.Ured, plan.cyclic)
            if "k4f" in kernels:
                r_old = old_pcr.pcr_factor(fact.Lred, fact.Ured, plan.cyclic)
                sms = torch.cuda.get_device_properties(0).multi_processor_count
                route = pcr.factor_route(2 * plan.s, plan.C)
                if route == "wide":
                    kp = pcr.factor_plan_wide(plan.C, 2 * plan.s, B, sms, pcr._grid_blocks(
                        pcr.WIDE_LIB, suffix, 2 * plan.s))
                elif route == "grid":
                    kp = pcr.factor_plan_grid(plan.C, 2 * plan.s, B, sms, pcr._grid_blocks(
                        pcr.LIB, suffix, 2 * plan.s))
                else:
                    kp = "one block per member"
                print(f"K4 factor {where}, {kp}; {gap(red, r_old)}", flush=True)
                del r_old
                turns(f"K4 factor {name} {dt}",
                      lambda: old_pcr.pcr_factor(fact.Lred, fact.Ured, plan.cyclic),
                      lambda: pcr.pcr_factor(fact.Lred, fact.Ured, plan.cyclic), iters)
                on_device(f"K4 factor {name} {dt}",
                          lambda: old_pcr.pcr_factor(fact.Lred, fact.Ured, plan.cyclic),
                          lambda: pcr.pcr_factor(fact.Lred, fact.Ured, plan.cyclic),
                          "pcr_factor")
            if "setup" in kernels and plan.woodbury:
                setup_turns(name, dt, where, plan, B, red, fact, iters)
            wood = pcr.woodbury(red, fact.Lred, fact.Ured) if plan.woodbury else ()
            gen = torch.Generator(device="cuda").manual_seed(0)
            lead = (B,) if B > 1 else ()
            if "shift" in kernels:
                # K4's solve with shifts
                yred = torch.randn(lead + (2 * plan.s, plan.C), dtype=dtype, device="cuda",
                                   generator=gen)
                s_new = pcr.pcr_solve_shift(red, yred, plan.wrap, *wood)
                s_old = old_pcr.pcr_solve_shift(red, yred, plan.wrap, *wood)
                sp = pcr.solve_plan(plan.C, 2 * plan.s, B, item)
                print(f"K4 solve_shift {where}, {sp}; {gap(s_new, s_old)}", flush=True)
                turns(f"K4 solve_shift {name} {dt}",
                      lambda: old_pcr.pcr_solve_shift(red, yred, plan.wrap, *wood),
                      lambda: pcr.pcr_solve_shift(red, yred, plan.wrap, *wood), 5 * iters)
                on_device(f"K4 solve_shift {name} {dt}",
                          lambda: old_pcr.pcr_solve_shift(red, yred, plan.wrap, *wood),
                          lambda: pcr.pcr_solve_shift(red, yred, plan.wrap, *wood),
                          "pcr_solve_shift_cluster_kernel")
                del yred, s_new, s_old
            del red, wood
            rhs = torch.randn(lead + (nvar, N), dtype=dtype, device="cuda", generator=gen)
            if "k3" in kernels:
                # K3's sweep (the same kernel in both: the noise of the pairs)
                y_new = thomas.thomas_sweep(fact, rhs, plan)
                y_old = old_thomas.thomas_sweep(fact, rhs, plan)
                print(f"K3 sweep {where}; {gap(y_new, y_old)}", flush=True)
                del y_new, y_old
                turns(f"K3 sweep {name} {dt}",
                      lambda: old_thomas.thomas_sweep(fact, rhs, plan),
                      lambda: thomas.thomas_sweep(fact, rhs, plan), iters)
            if "corr" in kernels:
                # K3's correction, on the sweep's y and random neighbour unknowns
                y, _ = thomas.thomas_sweep(fact, rhs, plan)
                xm1, xp1 = (torch.randn(lead + (plan.s, plan.C), dtype=dtype, device="cuda",
                                        generator=gen) for _ in range(2))
                x_new = thomas.spike_correct(fact, y, xm1, xp1, plan, add_to=rhs)
                x_old = old_thomas.spike_correct(fact, y, xm1, xp1, plan, add_to=rhs)
                cp = thomas.correct_plan(plan.s, item, plan.Mc, plan.C, B)
                print(f"K3 correct {where}, {cp}; {gap((x_new,), (x_old,))}", flush=True)
                del x_new, x_old
                # timed on inputs cold in L2: copies that span COLD_BYTES, in turn
                nbytes = B * (3 * plan.nvar * plan.Np + 2 * plan.Mc * plan.s ** 2 * plan.C
                              + 2 * plan.s * plan.C) * item
                sets = cold_copies(nbytes, (fact, y, xm1, xp1, rhs), lambda f, *v: (
                    f._replace(W=f.W.clone(), V=f.V.clone()), *(a.clone() for a in v)))

                def cold(mod):
                    turn = itertools.cycle(sets)

                    def go():
                        f_, y_, m_, p_, a_ = next(turn)
                        return mod.spike_correct(f_, y_, m_, p_, plan, add_to=a_)
                    return go

                turns(f"K3 correct {name} {dt}", cold(old_thomas), cold(thomas),
                      5 * iters * len(sets))
                on_device(f"K3 correct {name} {dt}", cold(old_thomas), cold(thomas),
                          "spike_correct")
                del y, xm1, xp1, sets
            del fact, rhs
            torch.cuda.empty_cache()
        if "stencil" in kernels:
            stencil_turns(dt, dtype)
        if "j" in kernels:
            j_turns(dt, dtype)
        if "k7" in kernels:
            k7_turns(dt, dtype)
        if "k9" in kernels:
            k9_turns(dt, dtype)
        if "k5" not in kernels:
            continue
        n = 1 << 20
        gen = torch.Generator(device="cuda").manual_seed(1)
        rows = torch.randn(2, 7, generator=gen, device="cuda").tolist()
        rows[0][0], rows[1][0], rows[1][3] = 1.0, 1.0, 0.0
        arrays = [torch.randn(1, n, dtype=dtype, device="cuda", generator=gen)
                  for _ in range(7)]
        coefs = torch.tensor(rows, dtype=dtype, device="cuda")
        stacked = torch.stack(arrays).view(7, -1)
        if not all(torch.equal(a, b) for a, b in zip(
                old_combine.combine(rows, arrays), combine.combine(rows, arrays))):
            raise SystemExit(f"K5 {dt}: the two combinations differ")
        print(f"K5 combine ks 2^20 {dt} (A = 7, R = 2):", flush=True)
        turns(f"K5 combine {dt}", lambda: old_combine.combine(rows, arrays),
              lambda: combine.combine(rows, arrays), 50)
        turns(f"torch.mm {dt}", lambda: torch.mm(coefs, stacked),
              lambda: torch.mm(coefs, stacked), 50)
        on_device(f"K5 combine {dt}", lambda: old_combine.combine(rows, arrays),
                  lambda: combine.combine(rows, arrays), "combine")
    print(json.dumps({"card": smi, "means_ms": means}))


if __name__ == "__main__":
    main()
