"""Temporal schemes: callables ``scheme(t, fields, dt, pars, hook) -> (t,
fields)`` that step the discretized system on the model's device.

Counterpart of ``triflow_tpu.core.schemes``: ``null_hook``, the
device-state plumbing (``_DeviceProblem``, ``_SchemeBase``), ``Theta``, the
Rosenbrock-Wanner family (``ROW_general``, ``ROS2``, ``ROS3PRw``,
``ROS3PRL``, ``RODASPR``) with its embedded-error controller, the explicit
Runge-Kutta family (``ERK_general``, ``RK4``, ``BS32``, ``DOPRI5``: K1's F
and K5 with a dt factor, the same host controller with the pair's
exponent, never K6), the step-doubling wrappers (``DeviceTimeStepping``
for the port's schemes, ``_host_time_stepping`` for any other callable,
chosen by ``time_stepping``) and the ``scipy_ode`` proxy (scipy's
integrators over the model's host routines; duck-typed hand-written
models step through it).

Hooks keep the reference contract ``hook(t, fields, pars) -> (fields,
pars)``.  The fields hold torch tensors, so a Dirichlet condition is the
in-place ``fields["U"][0] = 1.0`` (returning the same fields); rebinding a
name to a new tensor works too.  The hook runs before every attempted step
at its start time and once after the output step at ``t + dt``, as in the
reference.

An ensemble (``parallel.Ensemble``) steps B grids at once through
``fixed_step_batched`` (``Theta``'s is its ``fixed_step``, which takes the
member axis): the same order of operations with a leading member axis, a
per-member dt where the controller gives one, and the ROW stage
right-hand side through K1's fused ``F_terms`` entry (the reference's
``u_terms`` mode of its member-merged plans); a single grid keeps the
combination (K5) and the biased F (K1).

A grid that ``ops.megastep.plan_for`` admits (a small one) steps through
kernel K6, one launch per implicit step; larger grids take the multi-launch
path (K1-K5).  A ROW scheme with a residual refinement (``refine=r``) and
a Theta with a custom solver (``solver=``) never take K6, which has no
pass for either: they run K1-K5 and the banded matvec K7 on every grid
(``_SchemeBase._mega_plan``).  With no hook and ``recompute_target=True``
the adaptive controller of a Rosenbrock scheme runs inside K6 too, one
launch and one read-back per output step.  Otherwise the adaptive loops
run on the host: an attempt is enqueued on the device and its error
estimate is the one scalar read back, which decides it.  Every controller
quantity (t, dt, err, the new dt) is a numpy scalar (or a kernel value) of
the model's dtype, so a float32 run takes the decisions the float32
reference takes in ``u.dtype``.

The reference's raw device entries are here too: ``device_fixed_step``,
``device_stepper`` and ``device_steps`` (n output steps and their
snapshots, by the routes of ``_SchemeBase``: one K6 launch, a captured
CUDA graph of the fixed steps (``core/graphs.py``), K6's adaptive scan, or
the stepper's loop), and ``device_fixed_scan_folded`` /
``device_fixed_scan_df_folded`` (n fixed steps in one submission).
``device_fixed_step_folded`` is the reference's entry for a caller that
steps on its own (its benchmark's loop): a fixed step with no hook, in the
node layout.  For Theta, ``TRIFLOW_MEGATHETA`` opts into the two-pass
step of kernel K9 (``ops/megatheta.py``) on a periodic grid it admits, as
in the reference; ``Simulation`` and ``fixed_step`` never take K9.

A ``double="df64"`` model (the reference's double-float mode) computes in
native float64: its state, F, J, stage vectors and residuals are float64
tensors, and its full solver (``df64_mixed_solve=None`` or 0) is the
float64 route above.  As in the reference, every step size it takes is a
float32 value and its controllers decide in float32 (err rounded to
float32), while the clock is carried in float64 (the reference's
compensated float32 pair).  ``df64_mixed_solve=n`` (ROW and Theta; ignored
on other models, as the reference ignores it) is the reference's mixed
solve: J's bands rounded to float32 are factored (K2, K4 in float32), each
stage is solved in float32 and corrected by n residual passes against the
float64 bands (kernel K8, ``ops/mixed.py``).  On a grid its own gate
admits (``megastep.mixed_plan_for``) a whole mixed step is one launch of
K6's mixed entry; the adaptive loop then runs on the host with one launch
per attempt.  Hooks see float64 fields and set float64 values.

``compensated=True`` (ROW; ignored in the df64 mode, as in the reference)
carries the state through a Kahan carry (``ops.compensated``), as the
reference does: the adaptive controller, on the host or in K6, folds every
accepted attempt of an output step into a carry that starts at zero in the
step, and ``device_steps`` folds each of its n steps into an outer carry
that starts at zero in the call (on the K6 route inside K6's step entry).
"""

from __future__ import annotations

import weakref
from collections import OrderedDict

import numpy as np
import torch

from ..ops import chunked, megastep, megatheta, mixed
from ..ops.banded import axpy_bands
from ..ops.combine import combine
from ..ops.compensated import kahan_update
from ..ops.matvec import banded_matvec
from ..utils.convert import host_array
from . import graphs, rosenbrock


def null_hook(t, fields, pars):
    return fields, pars


def _seed_internal_dt(scheme, dt):
    """First-call internal dt for an adaptive scheme: small (1e-6) so the
    controller ramps up safely from an unknown state, but never below the
    user's dt_min (the 10x-per-accept growth cap cannot escape a seed under
    the floor).  The step-doubling wrapper seeds with the output dt."""
    if not getattr(scheme, "_time_control", False):
        return dt
    if getattr(scheme, "_seed_with_dt", False):
        return dt
    dt_min = getattr(scheme, "_dt_min", None)
    seed = 1e-6
    if dt_min is not None:
        seed = max(seed, dt_min)
    return min(seed, dt)


class _DeviceProblem:
    """A model bound to one hook and one boundary mode.

    State tuple: (u (nvar, N), helpers (nhelp, N), pstack (npar, N),
    x (N,))."""

    def __init__(self, model, hook, periodic: bool):
        self.backend = model.backend
        self.system = model.backend.system
        self.template = model.fields_template
        self.hook = hook
        self.periodic = periodic

    def apply_hook(self, t, u, helpers, pstack, x):
        if self.hook is null_hook:
            return u, helpers, pstack, x
        sysm = self.system
        data = {"x": x}
        for i, name in enumerate(sysm.dep_vars):
            data[name] = u[i]
        for i, name in enumerate(sysm.help_funcs):
            data[name] = helpers[i]
        pars = {name: pstack[i] for i, name in enumerate(sysm.pars)}
        pars["periodic"] = self.periodic
        fields, pars = self.hook(t, self.template(**data), pars)
        tensor = self.backend.as_tensor
        u2 = torch.stack([tensor(fields[n]) for n in sysm.dep_vars])
        helpers2 = (torch.stack([tensor(fields[n]) for n in sysm.help_funcs])
                    if sysm.help_funcs else helpers)
        x2 = tensor(fields["x"])
        N = x2.shape[-1]
        pstack2 = (torch.stack([torch.broadcast_to(tensor(pars[n]), (N,))
                                for n in sysm.pars])
                   if sysm.pars else pstack)
        return u2, helpers2, pstack2.contiguous(), x2.contiguous()

    def apply_hook_members(self, t, u, helpers, pstack, x):
        """The hook on each member of an ensemble's state (leading axis B)
        at its time: ``t`` is one time or one per member.  A loop over
        member views: the hook sees one grid's fields, as in ``Simulation``,
        and may update them in place; x is shared and stays."""
        if self.hook is null_hook:
            return u, helpers, pstack, x
        B = u.shape[0]
        tb = np.broadcast_to(np.asarray(t, dtype=np.float64), (B,))
        outs = [self.apply_hook(float(tb[b]), u[b], helpers[b], pstack[b], x)
                for b in range(B)]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]),
                torch.stack([o[2] for o in outs]), x)

    def F(self, u, helpers, pstack, x, scale=1.0, bias=None):
        return self.backend.F(u, helpers, pstack, x, periodic=self.periodic,
                              scale=scale, bias=bias)

    def F_terms(self, terms, helpers, pstack, x, scale):
        return self.backend.F_terms(terms, helpers, pstack, x,
                                    periodic=self.periodic, scale=scale)

    def J_bands(self, u, helpers, pstack, x):
        return self.backend.J_bands(u, helpers, pstack, x,
                                    periodic=self.periodic)


class _SchemeBase:
    """Splits Fields into device tensors, steps them, rebuilds Fields.

    Subclasses define ``fixed_step(problem, t, u, helpers, pstack, x, dt)
    -> (u', helpers', pstack', x', err)``: the hook at ``t``, then one step
    of ``dt`` (the counterpart of the reference's ``_fixed_step_fn``).
    ``err`` is the embedded error estimate as a 0-d tensor, or None for a
    scheme without one.  They define ``_output_step`` too, the body of
    ``device_stepper``: one output step with its hook at the output time.

    The raw device entries are the reference's: ``device_fixed_step``,
    ``device_stepper`` and ``device_steps`` (``n`` output steps and their
    snapshots).  ``device_steps`` takes one of four routes, chosen by
    declared conditions only and recorded in ``steps_route``:

    * ``"K6"``: fixed steps, the null hook, a grid K6's plan admits: K6's
      step entry, ``n`` steps in one launch, each step's state written
      into its slot of a snapshot buffer (K6's plain version on the CPU);
    * ``"graph"``: fixed steps, the null hook and no custom solver, on any
      other grid, CUDA tensors: the ``n`` steps captured once as a CUDA
      graph and replayed (``core/graphs.py``);
    * ``"K6_adaptive"``: a ROW scheme's own controller with the null hook,
      ``recompute_target=True``, a grid K6 admits, not the df64 mode and
      not ``compensated`` (whose outer carry needs each output step's
      start on the host):
      K6's adaptive scan, ``n`` output steps in one launch, with a
      snapshot per output step (its plain version on the CPU);
    * ``"eager"``: anything else (hooks, step doubling, the host
      controller, a custom solver, fixed steps on CPU tensors off K6's
      plan): ``device_stepper``'s step ``n`` times.

    Each route gives the states, times and statuses the same number of
    ``__call__`` calls gives, bit for bit where it launches the same
    kernels on the same inputs; with ``compensated`` every route folds
    its n steps into a Kahan carry that starts at zero in the call, as the
    reference's scan does (on the K6 route inside the kernel)."""

    _time_control = False
    #: residual refinement passes per stage solve (ROW ``refine=``)
    _refine = 0
    #: a custom linear solver (Theta ``solver=``)
    _solver = None
    #: residual passes of the df64 mode's mixed solve (0: the full solve)
    _mixed = 0
    #: a Kahan carry on the state (ROW ``compensated=True``)
    _compensated = False
    #: the ``parallel.spatial.SpatialModel`` of a sharded scheme
    #: (``SpatialModel.scheme_class``), whose mixin rebinds the problem, the
    #: plans and the factor to the shards and withholds K6 and K9
    _spatial = None
    #: the message a failed output step raises, by status
    _failures = {}

    def __init__(self, model):
        self._model = model
        self._problems = {}
        self._plans = {}
        self._mega_plans = {}
        self._graphs = OrderedDict()
        #: the route of the last ``device_steps`` call (class doc), and the
        #: attempts of each output step it ran
        self.steps_route = None
        self.steps_attempts = []
        self._np_dtype = np.float64 if model.dtype == torch.float64 \
            else np.float32
        self._df64 = model.precision == "df64"
        #: the type of the step sizes and of the controllers' decisions:
        #: float32 in the df64 mode (the reference's device steps take a
        #: float32 dt), else the model's
        self._dt_type = np.float32 if self._df64 else self._np_dtype
        #: the adaptive clock's own type in the df64 mode, else None
        self._clock = np.float64 if self._df64 else None

    def _step_dt(self, dt):
        """The step size a step takes: in the df64 mode ``dt`` rounded to
        float32, else ``dt`` as it is."""
        return float(np.float32(dt)) if self._df64 else dt

    def _advance(self, t, dt):
        """The output time ``t + dt`` of a step: in the model's dtype, or in
        the df64 mode in float64 with dt rounded to float32."""
        T = self._dt_type
        Tc = self._clock or T
        return Tc(t) + Tc(T(dt))

    def _problem(self, hook, periodic):
        key = (hook, periodic)
        if key not in self._problems:
            self._problems[key] = _DeviceProblem(self._model, hook, periodic)
        return self._problems[key]

    def _plan(self, N, periodic, B=1):
        key = (N, periodic, B)
        if key not in self._plans:
            self._plans[key] = chunked.make_plan(
                N, self._model.system.nvar, self._model.halo, periodic, B)
        return self._plans[key]

    def _mega_plan(self, N, periodic, B=1):
        """K6's plan of the grid (for each of B members), or None where the
        multi-launch path serves it: always for a scheme that refines its
        solves or has a custom solver, as the reference leaves its
        single-launch and folded paths for them, and for the df64 mode's
        mixed solve (``_mixed_plan``)."""
        if self._refine or self._solver is not None or self._mixed:
            return None
        # one grid keeps the key (N, periodic) that callers withhold by
        key = (N, periodic) if B == 1 else (N, periodic, B)
        if key not in self._mega_plans:
            self._mega_plans[key] = megastep.plan_for(
                N, self._model.system.nvar, self._model.halo, periodic, B)
        return self._mega_plans[key]

    def _mixed_plan(self, N, periodic):
        """The plan of K6's mixed entry for one grid of a scheme with the
        df64 mode's mixed solve, or None where the multi-launch mixed path
        serves it (always with ``refine=`` or a custom solver)."""
        if not self._mixed or self._refine or self._solver is not None:
            return None
        key = (N, periodic, "mixed")
        if key not in self._mega_plans:
            self._mega_plans[key] = megastep.mixed_plan_for(
                N, self._model.system.nvar, self._model.halo, periodic)
        return self._mega_plans[key]

    def _factor(self, problem, u, helpers, pstack, x, beta):
        """J's bands (K1) and the chunked factor of ``I + beta*J`` (K2,
        K4), or with the df64 mode's mixed solve its float32 factor
        (``mixed.MixedFactorization``: K2, K4 in float32, K8 per residual
        pass); u of B members (B, nvar, N) factors B systems, ``beta`` a
        number or one per member.  Returns (factor, bands), the bands None
        unless the scheme refines its solves against them."""
        B = u.shape[0] if u.ndim == 3 else 1
        plan = self._plan(x.shape[-1], problem.periodic, B)
        bands = problem.J_bands(u, helpers, pstack, x)
        if self._mixed:
            fact = mixed.MixedFactorization(bands, -beta, problem.periodic,
                                            plan, self._mixed)
        else:
            fact = chunked.factor(1.0, beta, bands, problem.periodic, plan)
        return fact, (bands if self._refine else None)

    def _split(self, fields, pars):
        backend = self._model.backend
        u, helpers, x = backend.split_fields(fields)
        return u, helpers, backend.pack_pars(pars, x), x.contiguous()

    def _rebuild(self, u, helpers, x):
        sysm = self._model.backend.system
        data = {"x": x}
        for i, name in enumerate(sysm.dep_vars):
            data[name] = u[i]
        for i, name in enumerate(sysm.help_funcs):
            data[name] = helpers[i]
        return self._model.fields_template(**data)

    # ---- the raw device entries (the reference's) ------------------------
    def _bound_step(self, hook, periodic, batched=False):
        """``fixed_step`` (or ``fixed_step_batched``) bound to the problem
        of ``hook`` and ``periodic``: err None for a scheme without an
        estimate."""
        step = getattr(self, "fixed_step_batched" if batched
                       else "fixed_step", None)
        if step is None:
            raise NotImplementedError(
                f"{type(self).__name__} does not expose a single fixed step")
        problem = self._problem(hook, periodic)

        def fixed(t, u, helpers, pstack, x, dt):
            return step(problem, t, u, helpers, pstack, x, dt)

        return fixed

    def device_fixed_step(self, hook=null_hook, periodic=True, batched=False):
        """``fixed(t, u, helpers, pstack, x, dt) -> (u', helpers', pstack',
        x', err)``: the hook at ``t`` and one fixed step of ``dt``
        (``fixed_step``), or with ``batched`` the step of B members with a
        leading member axis (``fixed_step_batched``, where the reference
        vmaps its step); err is zero for a scheme without an estimate, as
        the reference's, and a scheme with neither step raises, as the
        reference's."""
        step = self._bound_step(hook, periodic, batched)

        def fixed(t, u, helpers, pstack, x, dt):
            u2, h2, p2, x2, err = step(t, u, helpers, pstack, x, dt)
            if err is None:
                err = torch.zeros(u.shape[:-2], dtype=u.dtype, device=u.device)
            return u2, h2, p2, x2, err

        return fixed

    def device_stepper(self, hook=null_hook, periodic=True):
        """``step(t, u, helpers, pstack, x, dt, internal_dt) -> (t', u',
        helpers', pstack', x', internal_dt', niter, status)``: one output
        step from ``t`` to ``t + dt`` on the route and with the output-time
        hook ``__call__`` takes.  A fixed-step scheme returns niter 0,
        status 0 and internal_dt as it came; status 1 (max_iter) or 2 (the
        dt floor) is returned, not raised, and the hook then does not run
        on the failed state."""
        problem = self._problem(hook, periodic)

        def step(t, u, helpers, pstack, x, dt, internal_dt):
            return self._output_step(problem, t, u, helpers, pstack, x, dt,
                                     internal_dt)

        return step

    def _start_dt(self, dt):
        """The internal dt an output step starts from: the last one kept,
        or the first call's seed."""
        internal_dt = getattr(self, "_internal_dt", None)
        return _seed_internal_dt(self, dt) if internal_dt is None \
            else internal_dt

    def _keep_dt(self, dt_i, niter):
        """Keep an output step's internal dt and attempts, on a scheme
        that carries them."""
        if hasattr(self, "_internal_dt"):
            self._internal_dt = float(dt_i)
            self._internal_iter = int(niter)

    def __call__(self, t, fields, dt, pars, hook=null_hook):
        """Advance from t to t + dt (one output step, any number of
        internal attempts): ``device_stepper``'s step; a failed step raises
        ``RuntimeError``."""
        u, helpers, pstack, x = self._split(fields, pars)
        step = self.device_stepper(hook, bool(pars.get("periodic", False)))
        t2, u2, h2, p2, x2, dt_i, niter, status = step(
            t, u, helpers, pstack, x, dt, self._start_dt(dt))
        if status:
            raise RuntimeError(self._failures[status])
        self._keep_dt(dt_i, niter)
        return float(t2), self._rebuild(u2, h2, x2)

    def _fixed_dt(self, dt):
        """The dt ``_output_step`` hands ``fixed_step`` for an output dt."""
        return dt

    def _k6_fixed(self, N, periodic):
        """K6's plan where ``fixed_step`` takes K6's step entry (then the
        scheme's ``_k6_scan`` runs n of them into a snapshot buffer), else
        None."""
        return self._mega_plan(N, periodic)

    def _k6_adaptive(self, hook, N, periodic):
        """K6's plan where an output step is one launch of K6's adaptive
        entry (then ``_steps_k6_adaptive`` runs n of them in one), else
        None."""
        return None

    def steps_route_for(self, hook, periodic, u, x):
        """The route ``device_steps`` takes (class doc) for this state."""
        N = x.shape[-1]
        if hook is null_hook and not self._time_control:
            if u.ndim == 2 and self._k6_fixed(N, periodic) is not None:
                return "K6"
            if u.device.type == "cuda" and self._solver is None:
                return "graph"
        elif self._k6_adaptive(hook, N, periodic) is not None:
            return "K6_adaptive"
        return "eager"

    def device_steps(self, t, fields, n, dt, pars, hook=null_hook):
        """Advance ``n`` output steps of ``dt`` from ``t`` and return
        ``(t_final, snapshots, status)``: snapshots a list of ``(t_i,
        Fields)``, one per output step before the first that failed, and
        status 0, 1 (max_iter) or 2 (the dt floor), not raised.  t_final is
        the output time of the n-th step, as the reference's scan reaches
        it.  The internal dt and attempts are kept as ``__call__`` keeps
        them, from the last step run.  The route (class doc) is recorded
        in ``steps_route``.  Snapshot states of the fixed and K6 routes are
        views of one ``(n, nvar, N)`` tensor; memory grows as n times the
        state (``Simulation`` caps it per call)."""
        periodic = bool(pars.get("periodic", False))
        u, helpers, pstack, x = self._split(fields, pars)
        n = int(n)
        route = self.steps_route_for(hook, periodic, u, x)
        self.steps_route, self.steps_attempts = route, []
        if n < 1:
            return float(t), [], 0
        internal_dt = self._start_dt(dt)
        if route == "eager":
            return self._steps_eager(t, u, helpers, pstack, x, n, dt,
                                     internal_dt, hook, periodic)
        if route == "K6_adaptive":
            return self._steps_k6_adaptive(t, u, helpers, pstack, x, n, dt,
                                           internal_dt, periodic)
        N = x.shape[-1]
        if route == "K6":
            snap = torch.empty((n,) + tuple(u.shape), dtype=u.dtype,
                               device=u.device)
            self._k6_scan(self._k6_fixed(N, periodic), periodic, u, helpers,
                          pstack, x, dt, n, snap)
        else:
            snap = graphs.fixed_steps(
                self._graphs, self._bound_step(null_hook, periodic),
                periodic, u, helpers, pstack, x, self._fixed_dt(dt), n, True,
                self._compensated)
        snapshots = []
        for k in range(n):
            t = float(self._advance(t, dt))
            snapshots.append((t, self._rebuild(snap[k], helpers, x)))
        self._keep_dt(self._dt_type(internal_dt), 0)
        self.steps_attempts = [0] * n
        return t, snapshots, 0

    def _fixed_scan_entry(self, N, periodic):
        """(plan, scan_f) of ``device_fixed_scan_folded``: one K6 launch
        (of its mixed entry with the df64 mode's mixed solve) where a K6
        plan admits the grid, else the captured graph on CUDA tensors and
        a loop over ``fixed_step`` on CPU tensors."""
        plan = self._mega_plan(N, periodic) or self._mixed_plan(N, periodic)
        single = self.device_fixed_scan(N, periodic)
        fixed = self._bound_step(null_hook, periodic)

        def scan_f(t, u, helpers, pstack, x, dx, dt, nsteps):
            if single is not None:
                return single(t, u, helpers, pstack, x, dt, nsteps)
            if u.device.type == "cuda":
                return graphs.fixed_steps(self._graphs, fixed, periodic, u,
                                          helpers, pstack, x,
                                          self._fixed_dt(dt), nsteps, False)
            for _ in range(int(nsteps)):
                u, helpers, pstack, x, _ = fixed(t, u, helpers, pstack, x,
                                                 self._fixed_dt(dt))
            return u

        return plan or self._plan(N, periodic), scan_f

    def _steps_eager(self, t, u, helpers, pstack, x, n, dt, internal_dt,
                     hook, periodic):
        """``device_steps``' eager route: ``device_stepper``'s step n times,
        each from the output time the last one returned (as ``__call__``
        returns it).  A hook may update the state in place, so with one the
        step after a snapshot starts from a copy of it.  With
        ``compensated`` each output step's state is the Kahan update of the
        last by the step's result, one carry across the n steps."""
        step = self.device_stepper(hook, periodic)
        snapshots, status = [], 0
        carry = torch.zeros_like(u) if self._compensated else None
        for k in range(n):
            u_prev = u if hook is null_hook or carry is None else u.clone()
            t2, u, helpers, pstack, x, dt_i, niter, status = step(
                t, u, helpers, pstack, x, dt, internal_dt)
            self._keep_dt(dt_i, niter)
            self.steps_attempts.append(int(niter))
            internal_dt = dt_i
            if status:
                # the clock runs on to the n-th output time, as the
                # reference's scan does
                for _ in range(n - k):
                    t = float(self._advance(t, dt))
                return t, snapshots, status
            if carry is not None:
                u, carry = kahan_update(u_prev, carry, u)
            t = float(t2)
            snapshots.append((t, self._rebuild(u, helpers, x)))
            if hook is not null_hook:
                u, helpers = u.clone(), helpers.clone()
        return t, snapshots, 0


class Theta(_SchemeBase):
    """One-step theta scheme: theta=0 forward Euler, 1 backward Euler,
    0.5 Crank-Nicolson, linearized with J frozen at the current state.

    The implicit step uses the identity ``B = dt*(F - theta*J*u) + u =
    A*u + dt*F`` with ``A = I - theta*dt*J``, so ``u2 = u + A^-1 (dt*F)``:
    J's bands (K1), the chunked factor of A (K2, K4), dt*F (K1) and one
    solve (K3, K4, K3) whose last kernel adds the state; on a grid K6
    admits, all of it in one K6 launch.

    With ``solver``, a callable ``solver(A_bands, B, periodic) -> u2`` on
    torch tensors of the model's device, the step is the reference's: J's
    bands and dt*F (K1), ``B = dt*F - theta*dt*J*u + u`` (K7, K5), and
    ``A = I - theta*dt*J`` in banded form handed to the solver (theta = 0
    stays forward Euler, with no solver call).  In an ensemble
    (``parallel.Ensemble``, u of B members) the solver is called once per
    member, ``solver(A_bands[b], B[b], periodic)`` with that member's (W,
    nvar, nvar, N) bands and (nvar, N) right-hand side, as the reference's
    vmapped scheme hands it one member's; the B solutions are stacked.

    ``df64_mixed_solve=n`` on a df64 model solves ``A`` by the mixed solve
    (the module doc): one launch of K6's mixed entry where its gate admits
    the grid, else J (K1), dt*F (K1), the float32 factor and solves and n
    K8 residuals; the user's ``solver=`` takes precedence over it."""

    def __init__(self, model, theta=1, solver=None, df64_mixed_solve=None):
        super().__init__(model)
        self._theta = theta
        self._solver = solver
        self._mixed = int(df64_mixed_solve or 0) if self._df64 else 0

    def fixed_step(self, problem, t, u, helpers, pstack, x, dt):
        """The hook at ``t``, then one theta step of ``dt``: one K6 launch
        where K6's plan admits the grid, else K1-K4.  An ensemble's state
        (u (B, nvar, N)) runs the hook on every member (``t`` one time or
        one per member) and steps its B members together, with a member
        axis through the same kernels."""
        batched = u.ndim == 3
        hook = problem.apply_hook_members if batched else problem.apply_hook
        u, helpers, pstack, x = hook(t, u, helpers, pstack, x)
        dt = float(self._np_dtype(self._step_dt(dt)))
        theta = self._theta
        N = x.shape[-1]
        plan = self._mega_plan(N, problem.periodic,
                               u.shape[0] if batched else 1)
        if plan is not None and theta != 0:
            u2 = megastep.theta_step(self._model.backend, plan, theta,
                                     problem.periodic, u, helpers, pstack, x,
                                     dt)
            return u2, helpers, pstack, x, None
        plan = None if batched else self._mixed_plan(N, problem.periodic)
        if plan is not None and theta != 0:
            u2 = megastep.theta_step_mixed(self._model.backend, plan, theta,
                                           problem.periodic, u, helpers,
                                           pstack, x, dt, self._mixed)
            return u2, helpers, pstack, x, None
        rhs = problem.F(u, helpers, pstack, x, scale=dt)
        if theta == 0:
            return u + rhs, helpers, pstack, x, None
        if self._solver is not None:
            bands = problem.J_bands(u, helpers, pstack, x)
            Ju = banded_matvec(bands, u, problem.periodic, -theta * dt)
            B = combine([[1.0, 1.0, 1.0]], [rhs, Ju, u])[0]
            A = axpy_bands(1.0, -theta * dt, bands)
            if batched:
                u2 = torch.stack([self._solver(A[b], B[b], problem.periodic)
                                  for b in range(B.shape[0])])
            else:
                u2 = self._solver(A, B, problem.periodic)
            return u2, helpers, pstack, x, None
        fact, _ = self._factor(problem, u, helpers, pstack, x, -theta * dt)
        return fact.solve(rhs, add_to=u), helpers, pstack, x, None

    #: an ensemble's step (``parallel.Ensemble``): ``fixed_step`` takes the
    #: member axis
    fixed_step_batched = fixed_step

    def _k6_fixed(self, N, periodic):
        return None if self._theta == 0 else self._mega_plan(N, periodic)

    def _k6_scan(self, plan, periodic, u, helpers, pstack, x, dt, n, snap):
        dt = float(self._np_dtype(self._step_dt(dt)))
        megastep.theta_scan(self._model.backend, plan, self._theta, periodic,
                            u, helpers, pstack, x, dt, n, snap)

    def _output_step(self, problem, t, u, helpers, pstack, x, dt,
                     internal_dt):
        u2, helpers, pstack, x, _ = self.fixed_step(problem, t, u, helpers,
                                                    pstack, x, dt)
        t2 = self._advance(t, dt)
        u2, helpers, pstack, x = problem.apply_hook(float(t2), u2, helpers,
                                                    pstack, x)
        return t2, u2, helpers, pstack, x, internal_dt, 0, 0

    def device_fixed_scan_folded(self, N, periodic=True):
        """``(plan, scan_f)`` with ``scan_f(t, u, helpers, pstack, x, dx,
        dt, nsteps) -> u'``: ``nsteps`` theta steps of ``dt`` (no hook) in
        one submission, in the node layout (``dx`` taken and not read, as
        ``device_fixed_step_folded``'s); None with theta = 0, a custom
        solver or the df64 mode, as the reference's.  Where K6's plan
        admits the grid it is one K6 launch; on any other grid, CUDA
        tensors replay the captured graph of the ``nsteps`` steps
        (``core/graphs.py``) and CPU tensors loop over ``fixed_step``.
        The reference returns None off its single-launch kernel's grids and
        its caller scans the folded step; the port's body covers those
        grids too: the same ``nsteps`` steps in one submission."""
        if self._theta == 0 or self._solver is not None or self._df64:
            return None
        return self._fixed_scan_entry(N, periodic)

    def device_fixed_scan(self, N, periodic=True):
        """``scan(t, u, helpers, pstack, x, dt, nsteps) -> u``: ``nsteps``
        theta steps of ``dt`` (no hook) in ONE K6 launch (of its mixed
        entry with the df64 mode's mixed solve), in the node layout; None
        where K6's plan does not apply or theta = 0.  The port's name for
        the single-launch route of ``device_fixed_scan_folded`` (the port
        has no folded layout)."""
        if self._theta == 0:
            return None
        plan, mplan = self._mega_plan(N, periodic), self._mixed_plan(N, periodic)
        backend, theta, passes = self._model.backend, self._theta, self._mixed

        def scan(t, u, helpers, pstack, x, dt, nsteps):
            dt = self._step_dt(dt)
            if plan is not None:
                return megastep.theta_scan(backend, plan, theta, periodic, u,
                                           helpers, pstack, x, dt, nsteps)
            return megastep.theta_step_mixed(backend, mplan, theta, periodic,
                                             u, helpers, pstack, x, dt,
                                             passes, nsteps)

        return None if plan is None and mplan is None else scan

    def device_fixed_step_folded(self, N, periodic=True):
        """``(plan, fixed_f)`` with ``fixed_f(t, u, helpers, pstack, x, dx,
        dt) -> (u', err)``: one theta step of ``dt`` (no hook; err a zero
        0-d tensor), or None with theta = 0, a custom solver or the df64
        mode, as the reference's entry.  The state stays in the node
        layout (the port has no folded one) and the kernels derive the
        grid step from x, so ``dx`` is taken and not read.

        ``TRIFLOW_MEGATHETA`` (set, and ``TRIFLOW_NO_MEGATHETA`` not, when
        the entry is built) opts into the two-pass step of kernel K9
        (``ops/megatheta.py``) where ``megatheta.applicable`` holds: its
        plan, then K9.interface, K4 and K9.correct per step.  Otherwise
        ``fixed_f`` is the step ``fixed_step`` takes (K6 where its plan
        admits the grid, else K1-K4) and ``plan`` its chunk plan."""
        if self._theta == 0 or self._solver is not None or self._df64:
            return None
        model, theta = self._model, self._theta
        zero = torch.zeros((), dtype=model.dtype, device=model.device)
        if self._spatial is None and megatheta.opted_in():
            plan = megatheta.plan_for(N, model.system.nvar, model.halo)
            if megatheta.applicable(model, plan, periodic):
                def fixed_t(t, u, helpers, pstack, x, dx, dt):
                    return megatheta.theta_step(
                        model.backend, plan, theta, u, helpers, pstack, x,
                        self._step_dt(dt)), zero

                return plan, fixed_t
        problem = self._problem(null_hook, periodic)
        plan = self._mega_plan(N, periodic) or self._plan(N, periodic)

        def fixed_f(t, u, helpers, pstack, x, dx, dt):
            return self.fixed_step(problem, t, u, helpers, pstack, x, dt)[0], zero

        return plan, fixed_f



class _EmbeddedScheme(_SchemeBase):
    """What the schemes with their own embedded-error controller share (the
    ROW and explicit RK families): an output step is the adaptive loop
    (``_adaptive``) or one fixed step, then the hook at the output time;
    fixed steps take dt in the step-size type; a compensated scheme starts
    each carry at zero."""

    def _fixed_dt(self, dt):
        return self._dt_type(dt)

    def _carry(self, u):
        """A zero Kahan carry for u where the scheme is compensated, else
        None."""
        return torch.zeros_like(u) if self._compensated else None

    def _output_step(self, problem, t, u, helpers, pstack, x, dt,
                     internal_dt):
        """One output step: the adaptive controller (``_adaptive``), or
        one fixed step; then the hook at the output time."""
        T = self._dt_type
        if self._time_control:
            t2, u2, h2, p2, x2, dt_i, niter, status = self._adaptive(
                problem, t, u, helpers, pstack, x, dt, internal_dt)
        else:
            u2, h2, p2, x2, _ = self.fixed_step(problem, t, u, helpers,
                                                pstack, x, T(dt))
            t2, dt_i, niter, status = (self._advance(t, dt), T(internal_dt),
                                       0, 0)
        if status == 0:
            u2, h2, p2, x2 = problem.apply_hook(float(t2), u2, h2, p2, x2)
        return t2, u2, h2, p2, x2, dt_i, niter, status


def _combos(rows, arrays, dt=None):
    """``combine`` (K5) with the columns that are zero in every row
    dropped, as the reference's stage algebra does; with ``dt`` (the
    explicit RK family's ``[u, k_0, k_1, ...]``, u's column first and
    kept), every column but the first is weighed by dt (K5's dt columns:
    coefficient ``T(c) * T(dt)``)."""
    cols = [j for j in range(len(arrays))
            if any(rows[k][j] for k in range(len(rows)))]
    rows = [[float(rows[k][j]) for j in cols] for k in range(len(rows))]
    arrays = [arrays[j] for j in cols]
    if dt is None:
        return combine(rows, arrays)
    return combine(rows, arrays, dt, range(1, len(cols)))


def _finite_err(err):
    """inf where the error estimate is not finite, so the controller
    rejects a step that blew up."""
    return torch.where(torch.isfinite(err), err, torch.full_like(err, np.inf))


class ROW_general(_EmbeddedScheme):
    """Generic s-stage Rosenbrock-Wanner solver with one banded
    factorization per step reused across all stages, an embedded-order
    error estimate and an adaptive-dt controller.

    The stages use the Hairer-Wanner transformed tables (Solving ODEs II,
    ch. IV.7): with ``ut_i = sum_{j<=i} gamma_ij k_j`` each stage is
    ``(I - g00*dt*J) ut_i = g00*dt*F(u + sum a_ij ut_j) + g00 * sum_{j<i}
    c_ij ut_j``, so a step is one J (K1), one factor (K2, K4), and per
    stage one combination (K5), one biased F (K1) and one solve (K3, K4,
    K3), then one final combination (K5); on a grid K6 admits, all of it in
    one K6 launch.

    ``refine=r`` adds the reference's iterative refinement to every stage
    solve: r times the residual ``rhs - k + g00*dt*J*k`` against J's true
    bands (K7, K5) and one more solve that adds its correction into k, so
    a step launches K7 r times per stage.  Such a scheme never takes K6.

    ``df64_mixed_solve=n`` on a df64 model makes every stage solve the
    mixed solve (the module doc): n K8 launches per stage on the
    multi-launch path, or one launch of K6's mixed entry per step where
    its gate admits the grid; ``refine=`` wraps the mixed solve as it
    wraps the full one.  On another model the argument is ignored, as in
    the reference.

    ``compensated=True`` carries the state through a Kahan carry (the
    module doc) in float32 and float64; a df64 model ignores it, as the
    reference's does.  A single fixed step (``__call__``, ``fixed_step``)
    takes no carry, as in the reference."""

    def __init__(self, model, alpha, gamma, b, b_pred=None,
                 time_stepping=False, tol=None, max_iter=None, dt_min=None,
                 safety_factor=0.9, recompute_target=True,
                 compensated=False, refine=0, df64_mixed_solve=None):
        super().__init__(model)
        self._compensated = bool(compensated) and not self._df64
        self._mixed = int(df64_mixed_solve or 0) if self._df64 else 0
        self._refine = int(refine)
        self._alpha = np.asarray(alpha, dtype=np.float64)
        self._gamma = np.asarray(gamma, dtype=np.float64)
        self._b = np.asarray(b, dtype=np.float64)
        self._b_pred = None if b_pred is None else np.asarray(b_pred, np.float64)
        self._s = len(b)
        self._a_t, self._c_t, self._m_t, self._m_pred_t = \
            rosenbrock.transformed(alpha, gamma, b, b_pred)
        self._time_control = time_stepping
        self._tol = tol
        self._safety_factor = safety_factor
        self._max_iter = max_iter
        self._dt_min = dt_min
        self._recompute_target = recompute_target
        self._internal_dt = None
        self._internal_iter = None
        self._tables = {}
        if time_stepping and b_pred is None:
            raise NotImplementedError(
                "time stepping requires the predictor (b_pred) coefficients")
        if time_stepping and tol is None:
            raise ValueError("time_stepping=True requires a tolerance (tol)")

    def _table(self, with_err):
        """K6's combination table of this scheme."""
        if with_err not in self._tables:
            self._tables[with_err] = megastep.row_table(
                self._a_t, self._c_t, self._m_t, self._m_pred_t,
                self._gamma[0, 0], with_err)
        return self._tables[with_err]

    def _solve(self, fact, bands, rhs, gdt, periodic):
        """``(I - gdt*J)^-1 rhs`` through the factor (K3, K4, K3), then the
        ``refine`` passes: the residual ``rhs - k + gdt*J*k`` (K7, K5) and
        one solve whose last kernel adds its correction into k; ``gdt`` a
        number or one per member."""
        k = fact.solve(rhs)
        for _ in range(self._refine):
            Jk = banded_matvec(bands, k, periodic, gdt)
            r = combine([[1.0, -1.0, 1.0]], [rhs, k, Jk])[0]
            k = fact.solve(r, add_to=k)
        return k

    def _with_err(self):
        """Whether a controller reads the embedded error of a step."""
        return self._m_pred_t is not None and (self._tol is not None
                                               or self._time_control)

    def fixed_step(self, problem, t, u, helpers, pstack, x, dt):
        """The hook at ``t``, then one ROW step of ``dt`` in the order of
        the reference's ``_row_folded_core``.  ``err = max|u_new - u_pred|``
        (inf where not finite); with neither a tolerance nor time stepping
        no controller reads it, so the final combination emits ``u_new``
        alone and ``err`` is inf."""
        u, helpers, pstack, x = problem.apply_hook(t, u, helpers, pstack, x)
        dt = self._step_dt(dt)
        N = x.shape[-1]
        plan = self._mega_plan(N, problem.periodic)
        if plan is not None:
            u_new, err = megastep.row_step(
                self._model.backend, plan, self._table(self._with_err()),
                problem.periodic, u, helpers, pstack, x, dt)
            return u_new, helpers, pstack, x, err
        plan = self._mixed_plan(N, problem.periodic)
        if plan is not None:
            u_new, err = megastep.row_step_mixed(
                self._model.backend, plan, self._table(self._with_err()),
                problem.periodic, u, helpers, pstack, x, dt, self._mixed)
            return u_new, helpers, pstack, x, err
        T = self._np_dtype
        g00 = self._gamma[0, 0]
        # g00 * dt rounded as the model's dtype multiplies them
        gdt = float(T(g00) * T(dt))
        fact, bands = self._factor(problem, u, helpers, pstack, x, -gdt)
        a_t, c_t = self._a_t, self._c_t
        us = []
        for i in range(self._s):
            terms = [(1.0, 0.0, u)]
            for j in range(i):
                a, b = float(a_t[i, j]), float(g00 * c_t[i, j])
                if a or b:
                    terms.append((a, b, us[j]))
            a_row = [term[0] for term in terms]
            c_row = [term[1] for term in terms]
            arrays = [term[2] for term in terms]
            if not any(c_row):
                u_i = u if len(terms) == 1 else _combos([a_row], arrays)[0]
                csum = None
            else:
                u_i, csum = _combos([a_row, c_row], arrays)
            rhs = problem.F(u_i, helpers, pstack, x, scale=gdt, bias=csum)
            us.append(self._solve(fact, bands, rhs, gdt, problem.periodic))
        m_t = [float(m) for m in self._m_t]
        if not self._with_err():
            u_new = _combos([[1.0] + m_t], [u] + us)[0]
            err = torch.full((), np.inf, dtype=u.dtype, device=u.device)
        else:
            d_t = [float(m - p) for m, p in zip(self._m_t, self._m_pred_t)]
            u_new, diff = _combos([[1.0] + m_t, [0.0] + d_t], [u] + us)
            err = _finite_err(diff.abs().max())
        return u_new, helpers, pstack, x, err

    def fixed_step_batched(self, problem, t, u, helpers, pstack, x, dt):
        """``fixed_step`` of an ensemble: the hook on every member at ``t``
        (one time, or one per member), then one ROW step of the B members
        (u (B, nvar, N)) of ``dt``, one step size or one per member (a
        numpy array of the model's dtype).  Where K6's plan admits the grid
        the step is one K6 launch; otherwise one J (K1), one factor (K2,
        K4) and per stage the fused right-hand side ``g00 dt F(u + Σ a u_j)
        + Σ g00 c u_j`` (K1.F_terms) and one solve (K3, K4, K3), then the
        final combination (K5), in the order of the reference's
        ``_row_folded_core`` on its member-merged plans.  err is each
        member's (B,), inf where not finite or with no error row."""
        u, helpers, pstack, x = problem.apply_hook_members(t, u, helpers,
                                                           pstack, x)
        plan = self._mega_plan(x.shape[-1], problem.periodic, u.shape[0])
        if plan is not None:
            u_new, err = megastep.row_step(
                self._model.backend, plan, self._table(self._with_err()),
                problem.periodic, u, helpers, pstack, x, dt)
            return u_new, helpers, pstack, x, err
        g00 = self._gamma[0, 0]
        gdt = megastep.gdt_of(self._np_dtype, g00, dt, u.device)
        fact, bands = self._factor(problem, u, helpers, pstack, x, -gdt)
        a_t, c_t = self._a_t, self._c_t
        us = []
        for i in range(self._s):
            terms = [(1.0, 0.0, u)]
            for j in range(i):
                a, b = float(a_t[i, j]), float(g00 * c_t[i, j])
                if a or b:
                    terms.append((a, b, us[j]))
            rhs = problem.F_terms(terms, helpers, pstack, x, scale=gdt)
            us.append(self._solve(fact, bands, rhs, gdt, problem.periodic))
        m_t = [float(m) for m in self._m_t]
        if not self._with_err():
            u_new = _combos([[1.0] + m_t], [u] + us)[0]
            err = torch.full(u.shape[:1], np.inf, dtype=u.dtype,
                             device=u.device)
        else:
            d_t = [float(m - p) for m, p in zip(self._m_t, self._m_pred_t)]
            u_new, diff = _combos([[1.0] + m_t, [0.0] + d_t], [u] + us)
            err = _finite_err(diff.abs().amax(dim=(-2, -1)))
        return u_new, helpers, pstack, x, err

    def _k6_scan(self, plan, periodic, u, helpers, pstack, x, dt, n, snap):
        megastep.row_scan(self._model.backend, plan,
                          self._table(self._with_err()), periodic, u, helpers,
                          pstack, x, self._step_dt(self._dt_type(dt)), n, snap,
                          self._carry(u))

    def _k6_adaptive(self, hook, N, periodic):
        if (not self._time_control or hook is not null_hook
                or not self._recompute_target or self._df64
                or self._compensated):
            return None
        return self._mega_plan(N, periodic)

    def _steps_k6_adaptive(self, t, u, helpers, pstack, x, n, dt,
                           internal_dt, periodic):
        """``device_steps``' route through K6's adaptive scan: one launch
        for the n output steps, each one's state, time, dt, attempts and
        status in its snapshot slot."""
        plan = self._k6_adaptive(null_hook, x.shape[-1], periodic)
        out = megastep.adaptive_scan(
            rosenbrock.adaptive_controller, self._model.backend, plan,
            self._table(True), periodic, u, helpers, pstack, x, t, dt,
            internal_dt, self._tol, self._safety_factor, self._max_iter,
            self._dt_min, n, attempts=True, snapshots=True)
        _, done, dt_i, status, _, (states, rows) = out
        snapshots = []
        for k in range(done):
            if rows[k, 3]:
                break
            snapshots.append((float(rows[k, 0]),
                              self._rebuild(states[k], helpers, x)))
        self._keep_dt(dt_i, rows[done - 1, 2])
        self.steps_attempts = [int(a) for a in rows[:done, 2]]
        t_final = float(rows[done - 1, 0])
        for _ in range(n - done):
            t_final = float(self._advance(t_final, dt))
        return t_final, snapshots, status

    def device_fixed_scan_folded(self, N, periodic=True):
        """``(plan, scan_f)`` with ``scan_f(t, u, helpers, pstack, x, dx,
        dt, nsteps) -> u'``: ``nsteps`` fixed ROW steps of ``dt`` (no hook)
        in one submission, in the node layout (``dx`` taken and not read,
        as ``device_fixed_step_folded``'s); None in the df64 mode, as the
        reference's.  Where K6's plan admits the grid it is one K6 launch;
        on any other grid, CUDA tensors replay the captured graph of the
        ``nsteps`` steps (``core/graphs.py``) and CPU tensors loop over
        ``fixed_step``.  The reference returns None off its single-launch
        kernel's grids and its caller scans the folded step (its
        benchmark); the port's body covers those grids too: the same
        ``nsteps`` steps in one submission."""
        if self._df64:
            return None
        return self._fixed_scan_entry(N, periodic)

    def device_fixed_scan_df_folded(self, N, periodic=True):
        """``(plan, scan_f)`` with ``scan_f(u, helpers, pstack, x, dx, dt,
        nsteps) -> u'`` (the reference's argument order: no t): ``nsteps``
        fixed steps of the df64 mode's mixed solve in one submission, by
        the routes of ``device_fixed_scan_folded`` (one launch of K6's
        mixed entry where its gate admits the grid); None off the df64
        mode, without the mixed solve or with ``refine=``, as the
        reference's."""
        if not self._df64 or not self._mixed or self._refine:
            return None
        plan, scan = self._fixed_scan_entry(N, periodic)

        def scan_f(u, helpers, pstack, x, dx, dt, nsteps):
            return scan(0.0, u, helpers, pstack, x, dx, dt, nsteps)

        return plan, scan_f

    def device_fixed_scan(self, N, periodic=True):
        """``scan(t, u, helpers, pstack, x, dt, nsteps) -> u``: ``nsteps``
        fixed steps of ``dt`` (no hook, no error estimate) in ONE K6 launch
        (of its mixed entry with the df64 mode's mixed solve), in the node
        layout; None where K6's plan does not apply.  The port's name for
        the single-launch route of ``device_fixed_scan_folded`` and
        ``device_fixed_scan_df_folded`` (the port has no folded
        layout)."""
        plan, mplan = self._mega_plan(N, periodic), self._mixed_plan(N, periodic)
        backend, table, passes = self._model.backend, self._table(False), self._mixed

        def scan(t, u, helpers, pstack, x, dt, nsteps):
            dt = self._step_dt(dt)
            if plan is not None:
                return megastep.row_scan(backend, plan, table, periodic, u,
                                         helpers, pstack, x, dt, nsteps)
            return megastep.row_step_mixed(backend, mplan, table, periodic, u,
                                           helpers, pstack, x, dt, passes,
                                           nsteps)[0]

        return None if plan is None and mplan is None else scan

    def device_fixed_step_folded(self, N, periodic=True):
        """``(plan, fixed_f)`` with ``fixed_f(t, u, helpers, pstack, x, dx,
        dt) -> (u', err)``: one ROW step of ``dt`` with no hook, the step
        ``fixed_step`` takes, ``plan`` its chunk plan (K6's or K1-K5's);
        None in the df64 mode, as the reference's entry.  With neither a
        tolerance nor time stepping the final combination emits u' alone
        and err is inf (the reference's single-output table).  The state
        stays in the node layout and ``dx`` is taken and not read, as
        ``Theta.device_fixed_step_folded``'s."""
        if self._df64:
            return None
        problem = self._problem(null_hook, periodic)
        plan = self._mega_plan(N, periodic) or self._plan(N, periodic)

        def fixed_f(t, u, helpers, pstack, x, dx, dt):
            u2, _, _, _, err = self.fixed_step(problem, t, u, helpers, pstack,
                                               x, dt)
            return u2, err

        return plan, fixed_f

    def _adaptive(self, problem, t, u, helpers, pstack, x, dt, internal_dt):
        """Advance from ``t`` to ``t + dt`` through accepted attempts (the
        controller of ``rosenbrock.adaptive_controller``).  With no hook and
        ``recompute_target=True`` on a grid K6 admits, the whole output
        step is one K6 launch; otherwise (and always in the df64 mode, whose
        controller decides in float32 on a float64 clock) every attempt is
        a ``fixed_step`` decided on the host.  With ``compensated`` every
        accepted attempt is folded into a Kahan carry that starts at zero.
        Returns (next_t, u, helpers, pstack, x, dt_i, niter, status), status
        1 for max_iter and 2 for the dt floor."""
        T = self._dt_type
        plan = self._mega_plan(x.shape[-1], problem.periodic)
        carry = self._carry(u)
        if (plan is not None and problem.hook is null_hook
                and self._recompute_target and not self._df64):
            u2, dt_i, niter, status = megastep.row_adaptive_step(
                rosenbrock.adaptive_controller, self._model.backend, plan,
                self._table(True), problem.periodic, u, helpers, pstack, x, t,
                dt, internal_dt, self._tol, self._safety_factor,
                self._max_iter, self._dt_min, carry=carry)
            return T(t) + T(dt), u2, helpers, pstack, x, dt_i, niter, status

        def attempt(t_, state, dt_eff):
            u2, h2, p2, _x2, err = self.fixed_step(
                problem, float(t_), *state, x, dt_eff)
            return (u2, h2, p2), T(err.item())

        next_t, (u, helpers, pstack), dt_i, niter, status = \
            rosenbrock.adaptive_controller(
                attempt, T, t, dt, internal_dt, self._tol, self._safety_factor,
                self._max_iter, self._dt_min, not self._recompute_target,
                (u, helpers, pstack), self._clock, carry)
        return next_t, u, helpers, pstack, x, dt_i, niter, status

    _failures = {
        1: "Rosenbrock internal iteration above max iterations authorized",
        2: "Rosenbrock internal time step less than authorized"}


class ROS2(ROW_general):
    """2nd-order 2-stage Rosenbrock scheme, no time stepping."""

    def __init__(self, model, df64_mixed_solve=None):
        gamma = np.array([[2.928932188134e-1, 0],
                          [-5.857864376269e-1, 2.928932188134e-1]])
        alpha = np.array([[0, 0],
                          [1, 0]])
        b = np.array([1 / 2, 1 / 2])
        super().__init__(model, alpha, gamma, b, time_stepping=False,
                         df64_mixed_solve=df64_mixed_solve)


class ROS3PRw(ROW_general):
    """3rd-order W-method ROS3PRw with embedded error control (Rang 2013)."""

    def __init__(self, model, tol=1e-1, time_stepping=True,
                 max_iter=None, dt_min=None, recompute_target=True,
                 compensated=False, refine=0, df64_mixed_solve=None):
        alpha = np.zeros((3, 3))
        gamma = np.zeros((3, 3))
        gamma_i = 7.8867513459481287e-01
        b = [5.0544867840851759e-01,
             -1.1571687603637559e-01,
             6.1026819762785800e-01]
        b_pred = [2.8973180237214197e-01,
                  1.0000000000000001e-01,
                  6.1026819762785800e-01]
        alpha[1, 0] = 2.3660254037844388e+00
        alpha[2, 0] = 5.0000000000000000e-01
        alpha[2, 1] = 7.6794919243112270e-01
        gamma[0, 0] = gamma[1, 1] = gamma[2, 2] = gamma_i
        gamma[1, 0] = -2.3660254037844388e+00
        gamma[2, 0] = -8.6791218280355165e-01
        gamma[2, 1] = -8.7306695894642317e-01
        super().__init__(model, alpha, gamma, b, b_pred=b_pred,
                         time_stepping=time_stepping, tol=tol,
                         max_iter=max_iter, dt_min=dt_min,
                         recompute_target=recompute_target,
                         compensated=compensated, refine=refine,
                         df64_mixed_solve=df64_mixed_solve)


class ROS3PRL(ROW_general):
    """4-stage stiffly-accurate ROS3PRL with embedded error control (Rang
    2013)."""

    def __init__(self, model, tol=1e-1, time_stepping=True,
                 max_iter=None, dt_min=None, recompute_target=True,
                 compensated=False, refine=0, df64_mixed_solve=None):
        alpha = np.zeros((4, 4))
        gamma = np.zeros((4, 4))
        gamma_i = 4.3586652150845900e-01
        b = [2.1103008548132443e-03,
             8.8607515441580453e-01,
             -3.2405197677907682e-01,
             4.3586652150845900e-01]
        b_pred = [5.0000000000000000e-01,
                  3.8752422953298199e-01,
                  -2.0949226315045236e-01,
                  3.2196803361747034e-01]
        alpha[1, 0] = .5
        alpha[2, 0] = .5
        alpha[2, 1] = .5
        alpha[3, 0] = .5
        alpha[3, 1] = .5
        alpha[3, 2] = 0
        for i in range(len(b)):
            gamma[i, i] = gamma_i
        gamma[1, 0] = -5.0000000000000000e-01
        gamma[2, 0] = -7.9156480420464204e-01
        gamma[2, 1] = 3.5244216792751432e-01
        gamma[3, 0] = -4.9788969914518677e-01
        gamma[3, 1] = 3.8607515441580453e-01
        gamma[3, 2] = -3.2405197677907682e-01
        super().__init__(model, alpha, gamma, b, b_pred=b_pred,
                         time_stepping=time_stepping, tol=tol,
                         max_iter=max_iter, dt_min=dt_min,
                         recompute_target=recompute_target,
                         compensated=compensated, refine=refine,
                         df64_mixed_solve=df64_mixed_solve)


class RODASPR(ROW_general):
    """6-stage RODASPR, order 4(3), the default scheme (Rang 2013)."""

    def __init__(self, model, tol=1e-1, time_stepping=True,
                 max_iter=None, dt_min=None, recompute_target=True,
                 compensated=False, refine=0, df64_mixed_solve=None):
        alpha, gamma, b, b_pred = rosenbrock.rodaspr_coefficients()
        super().__init__(model, alpha, gamma, b, b_pred=b_pred,
                         time_stepping=time_stepping, tol=tol,
                         max_iter=max_iter, dt_min=dt_min,
                         recompute_target=recompute_target,
                         compensated=compensated, refine=refine,
                         df64_mixed_solve=df64_mixed_solve)


class ERK_general(_EmbeddedScheme):
    """Generic s-stage explicit Runge-Kutta scheme with an optional embedded
    error estimate and the host adaptive controller of the ROW family
    (``rosenbrock.adaptive_controller``), with the pair's exponent.

    Butcher arrays: ``a`` strictly lower triangular (s x s), ``b`` the
    update weights, ``b_pred`` the embedded lower-order weights (required
    for ``time_stepping=True``).  ``order`` is the lower order of the pair:
    the controller is ``dt <- safety*dt*(tol/err)**(1/(order + 1))``.

    A step is the reference's ``_erk_stage_combination``: per stage one
    stage input ``u + Σ_j (a_ij dt) k_j`` (one K5 launch with dt as its
    launch argument; u itself where the row is empty) and one
    ``k_i = F(u_i)`` (one K1.F launch, no scale, no bias), then one
    two-row K5 launch for ``u_new = u + Σ (b_i dt) k_i`` and the error row
    ``Σ ((b - b_pred)_i dt) k_i``; ``err = max|error row|``, inf where not
    finite.  With neither a tolerance nor time stepping no controller
    reads err: the final launch has one row and err is inf.  No kernel
    takes a whole step (the reference has no single-launch ERK kernel), so
    K6 never takes an explicit scheme (``_mega_plan`` is None), and
    ``device_steps`` runs fixed steps through the captured CUDA graph of
    K1/K5 (the null hook, CUDA tensors) or the eager loop.

    First-same-as-last pairs (DOPRI5, BS32: the last stage's input is the
    accepted state) carry the last stage's F across the attempts of an
    output step, as the reference's FSAL stepper does: one F of the output
    step's start, then s - 1 per attempt.  The carried F rides in the
    controller's state (kept on a reject, replaced on an accept), so the
    loop is the generic one's attempt for attempt and bit for bit.  It
    applies where the reference applies it: the null hook,
    ``recompute_target=True``, not compensated and not the df64 mode.

    ``compensated=True`` folds every accepted attempt into a Kahan carry
    (the controller's ``carry``); the df64 mode ignores it.  In the df64
    mode (float64 state) every step size is a float32 value on a float64
    clock, as for the ROW family."""

    def __init__(self, model, a, b, b_pred=None, order=2,
                 time_stepping=False, tol=None, max_iter=None, dt_min=None,
                 safety_factor=0.9, recompute_target=True,
                 compensated=False):
        super().__init__(model)
        self._compensated = bool(compensated) and not self._df64
        self._a = np.asarray(a, dtype=np.float64)
        self._b = np.asarray(b, dtype=np.float64)
        self._b_pred = (None if b_pred is None
                        else np.asarray(b_pred, dtype=np.float64))
        self._s = s = len(b)
        self._order = int(order)
        self._recompute_target = recompute_target
        self._time_control = time_stepping
        self._tol = tol
        self._safety_factor = safety_factor
        self._max_iter = max_iter
        self._dt_min = dt_min
        self._err_exponent = 1.0 / (self._order + 1)
        self._internal_dt = None
        self._internal_iter = None
        if time_stepping and b_pred is None:
            raise NotImplementedError(
                "time stepping requires the predictor (b_pred) coefficients")
        if time_stepping and tol is None:
            raise ValueError("time_stepping=True requires a tolerance (tol)")
        self._fsal_pair = (self._b_pred is not None and self._b[s - 1] == 0.0
                           and np.allclose(self._a[s - 1, :s - 1],
                                           self._b[:s - 1]))

    def _mega_plan(self, N, periodic, B=1):
        """None: no kernel takes a whole explicit step."""
        return None

    def _with_err(self):
        """Whether a controller reads the embedded error of a step (the
        reference drops ``b_pred`` otherwise)."""
        return self._b_pred is not None and (self._tol is not None
                                             or self._time_control)

    def _stages(self, problem, u, helpers, pstack, x, dt, k1=None):
        """``(u_new, err, k_last)`` of one step of ``dt`` from u (the hook
        already applied), ``k1`` the carried F of u or None; err a 0-d
        tensor (or one per member), inf where not finite or with no error
        row; ``dt`` a number or, for an ensemble's members, a (B,) tensor."""
        a, s = self._a, self._s
        ks = [] if k1 is None else [k1]
        for i in range(len(ks), s):
            row = [1.0] + [a[i, j] for j in range(i)]
            u_i = _combos([row], [u] + ks, dt)[0] if any(row[1:]) else u
            ks.append(problem.F(u_i, helpers, pstack, x))
        rows = [[1.0] + list(self._b)]
        if self._with_err():
            rows.append([0.0] + list(self._b - self._b_pred))
        outs = _combos(rows, [u] + ks, dt)
        lead = u.shape[:-2]
        if len(outs) == 1:
            err = torch.full(lead, np.inf, dtype=u.dtype, device=u.device)
        else:
            err = _finite_err(outs[1].abs().amax(dim=(-2, -1)))
        return outs[0], err, ks[s - 1]

    def fixed_step(self, problem, t, u, helpers, pstack, x, dt):
        """The hook at ``t``, then one step of ``dt`` (class doc); an
        ensemble's state (u (B, nvar, N)) runs the hook on every member
        (``t`` one time or one per member) and steps the B members with a
        member axis through the same kernels, ``dt`` one step size or one
        per member (a numpy array: K5 then takes each member's)."""
        batched = u.ndim == 3
        hook = problem.apply_hook_members if batched else problem.apply_hook
        u, helpers, pstack, x = hook(t, u, helpers, pstack, x)
        if np.ndim(dt):
            dt = torch.as_tensor(np.asarray(dt, dtype=self._dt_type),
                                 dtype=u.dtype, device=u.device)
        else:
            dt = float(self._step_dt(dt))
        u_new, err, _ = self._stages(problem, u, helpers, pstack, x, dt)
        return u_new, helpers, pstack, x, err

    #: an ensemble's step (``parallel.Ensemble``): ``fixed_step`` takes the
    #: member axis
    fixed_step_batched = fixed_step

    def _fsal(self, hook):
        """Whether the adaptive loop carries the last stage's F (class
        doc)."""
        return (self._fsal_pair and hook is null_hook
                and self._recompute_target and not self._compensated
                and not self._df64)

    def _adaptive(self, problem, t, u, helpers, pstack, x, dt, internal_dt):
        """Advance from ``t`` to ``t + dt`` through accepted attempts, each
        decided on the host by its err (one scalar read), under
        ``rosenbrock.adaptive_controller`` with the pair's exponent; with
        the FSAL loop (``_fsal``) the carried F rides in the state.
        Returns (next_t, u, helpers, pstack, x, dt_i, niter, status)."""
        T = self._dt_type
        if self._fsal(problem.hook):
            def attempt(t_, state, dt_eff):
                u2, err, k_last = self._stages(
                    problem, state[0], helpers, pstack, x,
                    float(self._step_dt(dt_eff)), state[1])
                return (u2, k_last), T(err.item())

            state = (u, problem.F(u, helpers, pstack, x))
        else:
            def attempt(t_, state, dt_eff):
                u2, h2, p2, _x2, err = self.fixed_step(
                    problem, float(t_), *state, x, dt_eff)
                return (u2, h2, p2), T(err.item())

            state = (u, helpers, pstack)
        next_t, state, dt_i, niter, status = rosenbrock.adaptive_controller(
            attempt, T, t, dt, internal_dt, self._tol, self._safety_factor,
            self._max_iter, self._dt_min, not self._recompute_target, state,
            self._clock, self._carry(u), self._err_exponent)
        if len(state) == 3:
            u, helpers, pstack = state
        else:
            u = state[0]
        return next_t, u, helpers, pstack, x, dt_i, niter, status

    _failures = {
        1: "explicit RK internal iteration above max iterations authorized",
        2: "explicit RK internal time step less than authorized"}


def rk4_tableau():
    """``(a, b, None)`` of the classic 4th-order Runge-Kutta scheme."""
    a = np.array([[0, 0, 0, 0],
                  [1 / 2, 0, 0, 0],
                  [0, 1 / 2, 0, 0],
                  [0, 0, 1, 0]])
    return a, np.array([1 / 6, 1 / 3, 1 / 3, 1 / 6]), None


def bs32_tableau():
    """``(a, b, b_pred)`` of the Bogacki-Shampine 3(2) pair."""
    a = np.array([[0, 0, 0, 0],
                  [1 / 2, 0, 0, 0],
                  [0, 3 / 4, 0, 0],
                  [2 / 9, 1 / 3, 4 / 9, 0]])
    b = np.array([2 / 9, 1 / 3, 4 / 9, 0])
    b_pred = np.array([7 / 24, 1 / 4, 1 / 3, 1 / 8])
    return a, b, b_pred


def dopri5_tableau():
    """``(a, b, b_pred)`` of the Dormand-Prince 5(4) pair."""
    a = np.zeros((7, 7))
    a[1, 0] = 1 / 5
    a[2, :2] = [3 / 40, 9 / 40]
    a[3, :3] = [44 / 45, -56 / 15, 32 / 9]
    a[4, :4] = [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]
    a[5, :5] = [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176,
                -5103 / 18656]
    a[6, :6] = [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]
    b = np.array([35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84,
                  0])
    b_pred = np.array([5179 / 57600, 0, 7571 / 16695, 393 / 640,
                       -92097 / 339200, 187 / 2100, 1 / 40])
    return a, b, b_pred


class RK4(ERK_general):
    """Classic 4th-order Runge-Kutta, fixed dt (no embedded estimate; wrap
    in :func:`time_stepping` for step-doubling adaptivity)."""

    def __init__(self, model, compensated=False):
        a, b, _ = rk4_tableau()
        super().__init__(model, a, b, time_stepping=False,
                         compensated=compensated)


class BS32(ERK_general):
    """Bogacki-Shampine 3(2) embedded pair (4 stages, FSAL; scipy's
    RK23)."""

    def __init__(self, model, time_stepping=True, tol=1e-2, max_iter=None,
                 dt_min=None, safety_factor=0.9, recompute_target=True,
                 compensated=False):
        a, b, b_pred = bs32_tableau()
        super().__init__(model, a, b, b_pred=b_pred, order=2,
                         time_stepping=time_stepping, tol=tol,
                         max_iter=max_iter, dt_min=dt_min,
                         safety_factor=safety_factor,
                         recompute_target=recompute_target,
                         compensated=compensated)


class DOPRI5(ERK_general):
    """Dormand-Prince 5(4) embedded pair (7 stages, FSAL)."""

    def __init__(self, model, time_stepping=True, tol=1e-2, max_iter=None,
                 dt_min=None, safety_factor=0.9, recompute_target=True,
                 compensated=False):
        a, b, b_pred = dopri5_tableau()
        super().__init__(model, a, b, b_pred=b_pred, order=4,
                         time_stepping=time_stepping, tol=tol,
                         max_iter=max_iter, dt_min=dt_min,
                         safety_factor=safety_factor,
                         recompute_target=recompute_target,
                         compensated=compensated)


class DeviceTimeStepping(_SchemeBase):
    """Richardson (step-doubling) error control for a scheme without its
    own estimator: every attempt compares one coarse step of ``dt`` with
    ``m`` fine steps of ``dt/m`` of the wrapped scheme.

    err = max over variables of ``||coarse - fine||_ord / (m^2 - 1)``; the
    attempt is rejected when the controller asks for a shrink beyond
    ``reject_factor``, and a dt below the roundoff floor raises
    ``RuntimeError``."""

    _time_control = True
    _seed_with_dt = True  # the first coarse attempt is the output dt

    def __init__(self, scheme, tol=1e-1, ord=2, m=10, reject_factor=2):
        super().__init__(scheme._model)
        self._inner = scheme
        self._tol = tol
        self._ord = ord
        self._m = m
        self._reject_factor = reject_factor
        self._internal_dt = None
        self._internal_iter = None

    def _norm(self, diff):
        """np.linalg.norm(coarse - fine, ord) per variable, max over the
        variables; diff is (nvar, N)."""
        if self._ord == np.inf:
            per_var = diff.abs().amax(dim=-1)
        elif self._ord == 2:
            per_var = torch.sqrt(torch.sum(diff * diff, dim=-1))
        else:
            per_var = torch.sum(diff.abs() ** self._ord, dim=-1) ** (
                1.0 / self._ord)
        return per_var.max()

    def _attempt(self, problem, t, u, helpers, pstack, x, dt_eff):
        """(fine state, err) of the coarse-versus-m-fine pair."""
        T = self._dt_type
        step = self._inner.fixed_step
        uc = step(problem, float(t), u, helpers, pstack, x, dt_eff)[0]
        dt_f = dt_eff / T(self._m)
        tf, uf, hf, pf, xf = t, u, helpers, pstack, x
        for _ in range(self._m):
            uf, hf, pf, xf, _ = step(problem, float(tf), uf, hf, pf, xf, dt_f)
            tf = tf + dt_f
        err = T(self._norm(uc - uf).item()) / T(self._m * self._m - 1)
        if not np.isfinite(err):
            err = T(np.inf)
        return uf, hf, pf, err

    _failures = {2: "step-doubling internal time step less than authorized"}

    def device_fixed_step(self, hook=null_hook, periodic=True, batched=False):
        """The wrapped scheme's fixed step (step doubling has none of its
        own)."""
        return self._inner.device_fixed_step(hook, periodic, batched)

    def _problem(self, hook, periodic):
        """The wrapped scheme's problem: a sharded scheme's evaluates F and
        J on its shards (``parallel.spatial``)."""
        return self._inner._problem(hook, periodic)

    def _split(self, fields, pars):
        """The wrapped scheme's split, with its guards (a sharded scheme's
        on the grid's size)."""
        return self._inner._split(fields, pars)

    def _output_step(self, problem, t, u, helpers, pstack, x, dt,
                     internal_dt):
        """One output step of step-doubling attempts, then the hook at the
        output time; status 2 where dt fell below its floor."""
        # the df64 mode: float32 step sizes and decisions on a float64
        # clock, as in ``rosenbrock.adaptive_controller``
        T = self._dt_type
        Tc = self._clock or T
        info = np.finfo(T)
        tol = T(self._tol)
        next_t = Tc(t) + Tc(T(dt))
        eps = Tc(1e-12) * np.maximum(abs(next_t), Tc(1.0))
        dt_floor = T(1e3) * info.tiny + T(2.0) * info.eps * T(abs(next_t))
        t_ = Tc(t)
        dt_i = np.minimum(T(internal_dt), T(dt))
        niter, status = 0, 0
        while t_ < next_t - eps and status == 0:
            remaining = next_t - t_
            clamped = dt_i >= remaining
            dt_eff = T(np.minimum(dt_i, remaining))
            uf, hf, pf, err = self._attempt(problem, t_, u, helpers, pstack,
                                            x, dt_eff)
            dt_next = dt_eff * np.sqrt(tol / np.maximum(err, info.tiny))
            dt_next = np.minimum(np.maximum(dt_next, T(0.1) * dt_eff),
                                 T(10.0) * dt_eff)
            accept = dt_next >= dt_eff / T(self._reject_factor)
            if accept:
                t_ = t_ + dt_eff
                u, helpers, pstack = uf, hf, pf
            if not (accept and clamped):
                dt_i = dt_next
            niter += 1
            if dt_i < dt_floor:
                status = 2
        if status == 0:
            u, helpers, pstack, x = problem.apply_hook(float(next_t), u,
                                                       helpers, pstack, x)
        return next_t, u, helpers, pstack, x, dt_i, niter, status


def _host_time_stepping(scheme, tol=1e-1, ord=2, m=10, reject_factor=2):
    """Step doubling driven through the ``scheme(t, fields, dt, pars,
    hook)`` surface, for schemes that exist only as host callables
    (``scipy_ode``, a duck-typed hand-written model's): the controller of
    ``DeviceTimeStepping`` on whole calls, the error norm on the host.

    The adapted step size is carried per trajectory, keyed on the identity
    of the fields object handed back to the caller (a weak reference), so
    two simulations sharing one wrapped scheme keep their own dt."""
    carried = {}  # id(fields) -> (weakref, adapted dt)

    def _recall(fields, default):
        entry = carried.pop(id(fields), None)
        if entry is not None:
            ref, h = entry
            if ref() is fields:
                return h
        return default

    def _remember(fields, h):
        try:
            carried[id(fields)] = (weakref.ref(fields), h)
        except TypeError:  # a container that takes no weak reference
            return
        while len(carried) > 64:  # bound abandoned trajectories' entries
            carried.pop(next(iter(carried)))

    def controlled(t, fields, dt, pars, hook=null_hook):
        target = t + dt
        h = _recall(fields, dt)
        while target - t > 1e-10 * max(1.0, abs(target)):
            # clamp the attempt, not the carried step size: the clamped
            # final sliver fed back into h would collapse the adapted dt at
            # every output step
            h_eff = min(h, target - t)
            clamped = h_eff < h
            _tc, coarse = scheme(t, fields, h_eff, pars, hook)
            t_f, fine = t, fields
            for _ in range(m):
                t_f, fine = scheme(t_f, fine, h_eff / m, pars, hook)
            err = max(
                np.linalg.norm(host_array(coarse[v]) - host_array(fine[v]),
                               ord) / (m * m - 1)
                for v in fields.dependent_variables)
            h_next = (np.sqrt(h_eff * h_eff * tol / err) if err > 0
                      else 2 * h_eff)
            h_next = float(np.clip(h_next, 0.1 * h_eff, 10.0 * h_eff))
            if h_next < h_eff / reject_factor:
                h = h_next  # rejected: retry the same interval smaller
                continue
            t, fields = t_f, fine
            if not clamped:
                h = h_next
        _remember(fields, h)
        return target, fields

    return controlled


def time_stepping(scheme, tol=1e-1, ord=2, m=10, reject_factor=2):
    """Step-doubling adaptive wrapper around a scheme without its own error
    control: ``DeviceTimeStepping`` for a scheme of the port (every one
    exposes a fixed step), the host loop (``_host_time_stepping``) for any
    other callable scheme."""
    if isinstance(scheme, _SchemeBase):
        return DeviceTimeStepping(scheme, tol=tol, ord=ord, m=m,
                                  reject_factor=reject_factor)
    return _host_time_stepping(scheme, tol=tol, ord=ord, m=m,
                               reject_factor=reject_factor)


class scipy_ode:
    """Proxy around ``scipy.integrate.ode`` (vode, BDF, dopri5, ...) on the
    host, through the model's host routines: ``model.F(fields, pars)`` and,
    with ``jac=True``, ``model.J(fields, pars, sparse=False)``, which run
    where the model lives (K1 on the card for a model of the port) and
    return host numpy.  Any object with ``.F(fields, pars)`` and
    ``fields_template`` (a duck-typed hand-written model) steps the same
    way.

    The integrator sees the interleaved flat state (``Fields.uflat``);
    each right-hand side or Jacobian call scatters it back into a Fields
    workspace (``Fields.fill``), re-applies the hook (so boundary values
    hold at every internal evaluation) and calls the model.  The explicit
    RK family (DOPRI5, BS32) and the ROW family step on the device
    instead; this proxy stays for scipy's own trajectories and for models
    whose F is host code."""

    def __init__(self, model, jac=False, integrator="vode",
                 **integrator_kwargs):
        from scipy.integrate import ode

        self._model = model
        self._solver = ode(self._rhs, jac=self._jacobian if jac else None)
        self._solver.set_integrator(integrator, **integrator_kwargs)

    def _sync(self, t, flat, workspace, pars, hook):
        workspace.fill(flat)
        return hook(t, workspace, pars)

    def _rhs(self, t, flat, workspace, pars, hook):
        fields, pars = self._sync(t, flat, workspace, pars, hook)
        return host_array(self._model.F(fields, pars))

    def _jacobian(self, t, flat, workspace, pars, hook):
        fields, pars = self._sync(t, flat, workspace, pars, hook)
        return host_array(self._model.J(fields, pars, sparse=False))

    def __call__(self, t, fields, dt, pars, hook=null_hook):
        solver = self._solver
        workspace, pars = hook(t, fields.copy(), pars)
        callback_args = (workspace, pars, hook)
        solver.set_initial_value(host_array(workspace.uflat), t)
        solver.set_f_params(*callback_args)
        solver.set_jac_params(*callback_args)
        flat = solver.integrate(t + dt)
        if not solver.successful():
            raise RuntimeError("scipy_ode integrator reported failure")
        workspace.fill(flat)
        workspace, _ = hook(t + dt, workspace, pars)
        return t + dt, workspace
