"""Ensembles: B simulations of one model, stepped together on one card.

Counterpart of ``triflow_tpu.parallel.ensemble``.  Parameter sweeps, the
reference's flagship use (its user guide's pickled-model sweeps), run as
one computation with a leading member axis: the state, helpers and
parameters are ``(B, rows, N)`` tensors and x is shared.  The reference
folds its members into one chunk system with member masks
(``folded.make_ensemble_plan``) and splits large batches into VMEM-sized
groups; both are TPU layout and are not ported.  Here every kernel takes
the member axis in its launch grid (K1 over B x N nodes, K2/K3 over B x C
chunks, K4 and K6 one block per member), and the chunk plan gains the
member count (``ops.chunked.Plan.B``).

Routes (``route``):

* ``"K6"``: a grid K6 admits (``ops.megastep.plan_for``), no hook, for
  an adaptive scheme ``recompute_target=True`` and not the df64 mode, and
  no ``refine=``, custom ``solver=`` or df64 mixed solve (the scheme's
  ``_mega_plan`` gate).  ``steps(n, dt)`` is ONE
  launch: K6's step entry for a fixed scheme, its ``adaptive_scan`` entry
  for an adaptive ROW scheme (a shared dt, or each member's own with
  ``per_member_dt``); ``step(dt)`` is one launch of the step or adaptive
  entry.
* ``"host"``: otherwise.  Every output step runs on the host: the scheme's
  ``fixed_step_batched`` (K1-K5 with a member axis, with ``refine=`` also
  K7 with each member's g00*dt as its scale, with the df64 mixed solve K2-K4
  in float32 and K8, or one K6 launch where K6's plan admits the grid),
  under the shared-dt controller
  (``core.rosenbrock.adaptive_controller`` on the max member error, one
  scalar read per attempt) or the per-member one
  (``core.rosenbrock.member_controller``, one (B,) read per attempt).

**df64 models** (``Model(double="df64")``) step as one grid of the mode
steps: a native float64 state (``stack_parameters`` stacks float64, the
model's dtype), every step size the float32 value of the scheme's
``_step_dt`` (the output dt is rounded once, as the reference's ensemble
rounds it), the output clock advanced in float64 by the scheme's
``_advance`` (so it equals the single grid's bit for bit), and the
controllers deciding in float32 on float64 clocks (``clock=``: the
reference's compensated (hi, lo) member clocks), on the host route.  The
full solver (``df64_mixed_solve`` None or 0) takes the routes of a float64
ensemble: K6 for fixed steps where its plan admits the grid, else K1-K5;
``df64_mixed_solve=n`` takes the host route, each stage solve the
member-axis mixed solve (``ops.mixed.MixedFactorization``: K2-K4 in
float32 with each member's shift, n K8 passes).  The reference folds a
df64 ensemble into one chunk system and runs ``df64_mixed_solve or 2``
residual passes there (its ``_build_merged_df``), so with 0 it runs 2
mixed passes where the port runs the full float64 solve, the single
grid's route; both land within the 1e-12 of the single-grid run that the
reference's tests ask of it.  K6's mixed entry has no member axis, and the
reference gives df64 ensembles no single-launch kernel either.

``compensated=True`` (ROW schemes), on both routes as in the reference's
vmapped paths: the adaptive controllers fold each member's accepted
attempts into a Kahan carry that starts at zero in each output step (per
member where it accepts; no carry runs across output steps, as the
reference's ensemble scan takes none for an adaptive scheme), and fixed
``steps(n)`` folds its n steps into one carry (a single ``step`` takes
none).  On the K6 route the kernel does both (``ops.megastep``'s module
doc), so the two routes agree bit for bit where they step by the same
kernel.

``Theta(solver=f)``: the reference vmaps the scheme, so its solver sees one
member's bands; here the solver is called once per member with that
member's ``(W, nvar, nvar, N)`` bands and right-hand side (``Theta``'s
doc), on the host route.

A shared dt controls every member by the max error over the members, so
every member meets the tolerance; ``per_member_dt`` gives each member its
own internal clock and step size (masked freezing), recorded in
``member_iters``.  Hooks run per member at attempt time and at output time,
as a loop over member views (``_DeviceProblem.apply_hook_members``): B
Python calls and one stack per application, so a hooked ensemble is
host-bound at small N.

The explicit RK family (``schemes.ERK_general``: RK4, BS32, DOPRI5) steps
on the host route (no kernel takes a whole explicit step, so never K6):
its ``fixed_step_batched`` runs K1.F and K5 with a member axis, K5 taking
each member's dt under ``per_member_dt``; both controllers use the pair's
exponent 1/(order + 1), as the reference passes its ``_err_exponent``.

Persistence: ``attach_container`` persists the whole sweep in one
container whose frames carry a ``member`` axis
(``TimeSeries.from_ensemble_state``), fed once per ``step`` and once per
``steps`` call, flushed at the end of ``run``; ``save_checkpoint`` /
``from_checkpoint`` (``utils.checkpoint``) write and rebuild the sweep.

**A mesh** (``mesh=``, a ``parallel.Mesh`` on the model's device): the
members lie on its ``mesh_axis`` (default "ensemble"), whose size must
divide B (the reference's check); they share the one device, so the routes
above are unchanged.  With ``space_axis`` naming an axis of size > 1 every
member's grid is also cut into shards over it (the reference's dp x sp):
the scheme is rebound by ``parallel.spatial.SpatialModel.scheme_class``,
and the B members x ndev shards step on the host route as B * ndev local
systems (K2-K4 with B * ndev members, the wrap off), B interface systems
over the shards (K4) and K1's ``*_shards`` entries, under the shared dt on
the max error or ``per_member_dt``: the fixed and adaptive ROW family, the
explicit RK family, Theta and the df64 mode (its stage solves the mixed
solve, 2 residual passes unless ``df64_mixed_solve`` says otherwise).  A
mesh across cards is ROADMAP A9b.
"""

from __future__ import annotations

from uuid import uuid1

import numpy as np
import torch

from ..core import rosenbrock
from ..core import schemes as schemes_mod
from ..core.schemes import null_hook
from ..ops import megastep
from ..ops.compensated import kahan_update
from ..utils.streams import Stream


def stack_parameters(model, parameter_sets, N):
    """Stack a list of parameter dicts (numbers, or (N,) arrays or
    tensors) into a batched pstack of shape (B, npar, N) on the model's
    device, in its dtype (float64 for a df64 model); numbers fill on the
    device."""
    backend = model.backend
    rows = []
    for pars in parameter_sets:
        if backend.system.pars:
            rows.append(torch.stack([backend._par_row(pars[k], N)
                                     for k in backend.system.pars]))
        else:
            rows.append(torch.zeros((0, N), dtype=backend.dtype,
                                    device=backend.device))
    return torch.stack(rows).contiguous()




class Ensemble:
    """Batched simulations over a leading member axis.

    Parameters
    ----------
    model : Model
    u0 : (B, nvar, N) initial dependent variables (or (B, N) when
        nvar == 1), numpy or torch
    parameter_sets : list of B parameter dicts (all sharing 'periodic'),
        or a single dict broadcast to every member
    x : (N,) shared grid
    scheme : scheme class (default ``schemes.ROS2``, fixed dt; adaptive ROW
        classes use a shared dt controlled by the max member error)
    hook : ``hook(t, fields, pars)`` applied per member, at attempt and
        output time
    mesh : ``parallel.Mesh`` or None (module doc)
    mesh_axis : str, the mesh axis of the members
    space_axis : str or None, a mesh axis over which every member's grid
        is sharded (dp x sp, module doc)
    helpers0 : (B, nhelp, N) initial helper functions
    per_member_dt : bool, adaptive schemes only: every member carries its
        own internal clock and step size (masked freezing) instead of the
        shared dt; ``member_iters`` records each member's attempts
    **scheme_kwargs : forwarded to the scheme constructor

    ``utils.convert.ensemble_from_numpy`` hands numpy inputs over:

    >>> ens = Ensemble(model, **ensemble_from_numpy(model, u0, x, pars))
    >>> t, u = ens.run(tmax=1.0, dt=0.1)
    """

    def __init__(self, model, u0, parameter_sets, x, scheme=None,
                 hook=null_hook, mesh=None, mesh_axis="ensemble",
                 space_axis=None, helpers0=None, per_member_dt=False,
                 **scheme_kwargs):
        if space_axis is not None and (mesh is None
                                       or space_axis not in mesh.shape):
            raise ValueError("space_axis requires a mesh carrying that axis")
        if mesh is not None:
            mesh.check_device(model.device)
        self.model = model
        backend = model.backend
        nvar = backend.system.nvar
        u0 = backend.as_tensor(u0).clone()
        if u0.ndim == 2 and nvar == 1:
            u0 = u0[:, None, :]
        if u0.ndim != 3:
            raise ValueError("u0 must have shape (B, nvar, N)")
        self.B, _, self.N = u0.shape
        self.x = backend.as_tensor(x).contiguous()
        if isinstance(parameter_sets, dict):
            parameter_sets = [parameter_sets] * self.B
        if len(parameter_sets) != self.B:
            raise ValueError("need one parameter dict per member")
        self._parameter_sets = [dict(p) for p in parameter_sets]
        periodic = {bool(p.get("periodic", False)) for p in parameter_sets}
        if len(periodic) != 1:
            raise ValueError("all members must share the periodic flag")
        self.periodic = periodic.pop()
        self.pstack = stack_parameters(model, parameter_sets, self.N)
        nhelp = len(backend.system.help_funcs)
        if helpers0 is None:
            self.helpers = torch.zeros((self.B, nhelp, self.N),
                                       dtype=backend.dtype,
                                       device=backend.device)
        else:
            self.helpers = backend.as_tensor(helpers0).clone()
        self.u = u0.contiguous()
        self.t = 0.0

        scheme = schemes_mod.ROS2 if scheme is None else scheme
        self.spatial = None
        if mesh is not None:
            if mesh_axis in mesh.shape and self.B % mesh.shape[mesh_axis]:
                raise ValueError(f"B={self.B} must divide the '{mesh_axis}' "
                                 f"axis ({mesh.shape[mesh_axis]})")
            if space_axis is not None and mesh.shape[space_axis] > 1:
                from .spatial import SpatialModel

                #: the members' grids sharded (dp x sp), or None
                self.spatial = SpatialModel(model, mesh, axis=space_axis,
                                            periodic=self.periodic)
                self.spatial.check_grid(self.N)
                scheme = self.spatial.scheme_class(scheme)
        self._scheme = scheme(model, **scheme_kwargs)
        if not hasattr(self._scheme, "fixed_step_batched"):
            raise NotImplementedError(
                f"{type(self._scheme).__name__} has no batched step in the "
                "port (ensembles take Theta, the ROW and the explicit RK "
                "families)")
        self._adaptive = bool(getattr(self._scheme, "_time_control", False))
        self._hook = hook
        self._per_member_dt = bool(per_member_dt) and self._adaptive
        self._problem = self._scheme._problem(hook, self.periodic)
        self._internal_dt = None
        #: per member, the attempts of the last step/steps call
        #: (``per_member_dt`` only)
        self.member_iters = None
        #: the shared controller's attempts over the last step/steps call
        #: (adaptive schemes with a shared dt)
        self.attempts = None
        self.id = str(uuid1())[:6]
        self._stream = None
        self._container = None

    # ------------------------------------------------------------- routes
    @property
    def route(self):
        """"K6" (one launch per ``steps`` call) or "host" (module doc)."""
        plan = self._scheme._mega_plan(self.N, self.periodic, self.B)
        if plan is None or self._hook is not null_hook:
            return "host"
        if self._adaptive and (not self._scheme._recompute_target
                               or self._scheme._df64):
            return "host"
        return "K6"

    def _k6_steps(self, n, dt, internal_dt, scan):
        """n output steps through K6: (t, dt_i, status, niter).  A
        compensated scheme's launch takes a Kahan carry (the kernel zeroes
        an adaptive entry's in every output step), but for a single fixed
        ``step``."""
        sch = self._scheme
        T = sch._np_dtype
        backend = self.model.backend
        plan = sch._mega_plan(self.N, self.periodic, self.B)
        state = (self.u, self.helpers, self.pstack, self.x)
        carry = (torch.zeros_like(self.u) if sch._compensated
                 and (scan or self._adaptive) else None)
        if not self._adaptive:
            if isinstance(sch, schemes_mod.Theta):
                self.u = megastep.theta_step(backend, plan, sch._theta,
                                             self.periodic, *state, dt,
                                             nsteps=n)
            else:
                self.u = megastep.row_step(backend, plan, sch._table(False),
                                           self.periodic, *state, T(dt),
                                           nsteps=n, carry=carry)[0]
            return self._advanced(n, dt), internal_dt, 0, None
        per_member = self._per_member_dt
        controller = (rosenbrock.member_controller if per_member
                      else rosenbrock.adaptive_controller)
        args = (controller, backend, plan, sch._table(True), self.periodic,
                *state, self.t, dt, internal_dt, sch._tol, sch._safety_factor,
                sch._max_iter, sch._dt_min)
        if scan:
            out = megastep.adaptive_scan(*args, n, per_member=per_member,
                                         attempts=True, carry=carry)
            self.u, done, dt_i, status, niter = out
        else:
            self.u, dt_i, niter, status = megastep.row_adaptive_step(
                *args, per_member=per_member, carry=carry)
            done = 1
        return self._advanced(done, dt), dt_i, status, niter

    def _advanced(self, n, dt):
        """The clock after n output steps of dt, added as the scheme's
        steppers add it (``_SchemeBase._advance``: in the model's dtype, or
        in float64 in the df64 mode)."""
        t = self.t
        for _ in range(n):
            t = self._scheme._advance(t, dt)
        return float(t)

    def _host_step(self, dt, internal_dt, carry=None):
        """One output step on the host: (t, dt_i, status, niter).  The
        controllers decide in the scheme's step-size type on its clock
        (the df64 mode's float32 on float64); a compensated adaptive
        scheme's controller takes a zero Kahan carry, and ``carry`` (fixed
        steps: the carry of a ``steps`` call) folds the step into it."""
        sch, problem = self._scheme, self._problem
        T, clock = sch._dt_type, sch._clock
        exponent = getattr(sch, "_err_exponent", 0.5)
        state = (self.u, self.helpers, self.pstack)
        step_carry = (torch.zeros_like(self.u)
                      if sch._compensated and self._adaptive else None)
        u_prev = self.u
        if carry is not None and self._hook is not null_hook:
            # the hook may update the state in place
            u_prev = self.u.clone()
        if not self._adaptive:
            u2, h2, p2, _, _ = sch.fixed_step_batched(
                problem, self.t, *state, self.x, sch._fixed_dt(dt))
            next_t, dt_i, status, niter = (sch._advance(self.t, dt),
                                           internal_dt, 0, None)
        elif self._per_member_dt:
            def attempt(tb, state_, dt_eff):
                u2, h2, p2, _, errs = sch.fixed_step_batched(
                    problem, tb, *state_, self.x, dt_eff)
                return (u2, h2, p2), errs.cpu().numpy()

            next_t, (u2, h2, p2), dt_i, niter, status = \
                rosenbrock.member_controller(
                    attempt, T, self.t, dt, internal_dt, sch._tol,
                    sch._safety_factor, sch._max_iter, sch._dt_min,
                    not sch._recompute_target, state, clock, step_carry,
                    exponent)
        else:
            def attempt(t_, state_, dt_eff):
                u2, h2, p2, _, errs = sch.fixed_step_batched(
                    problem, float(t_), *state_, self.x, dt_eff)
                return (u2, h2, p2), T(errs.max().item())

            next_t, (u2, h2, p2), dt_i, niter, status = \
                rosenbrock.adaptive_controller(
                    attempt, T, self.t, dt, internal_dt, sch._tol,
                    sch._safety_factor, sch._max_iter, sch._dt_min,
                    not sch._recompute_target, state, clock, step_carry,
                    exponent)
        # the output-time hook, as the reference's steppers end every
        # output step
        u2, self.helpers, self.pstack, _ = problem.apply_hook_members(
            float(next_t), u2, h2, p2, self.x)
        if carry is not None:
            u2, c2 = kahan_update(u_prev, carry, u2)
            carry.copy_(c2)
        self.u = u2
        return float(next_t), dt_i, status, niter

    def _advance(self, n, dt, scan):
        # the df64 mode steps by the float32 value of dt, and its clock
        # adds that value
        dt = self._scheme._step_dt(dt)
        internal_dt = self._internal_dt
        if internal_dt is None:
            internal_dt = schemes_mod._seed_internal_dt(self._scheme, dt)
        before = (self.t, self.u, self.helpers, self.pstack)
        if self.route == "K6":
            t, dt_i, status, niter = self._k6_steps(n, dt, internal_dt, scan)
        else:
            total, status = None, 0
            t, dt_i = self.t, internal_dt
            carry = (torch.zeros_like(self.u) if self._scheme._compensated
                     and scan and not self._adaptive else None)
            for _ in range(n):
                t, dt_i, status, niter = self._host_step(dt, dt_i, carry)
                self.t = t
                total = niter if total is None else total + niter
                if status:
                    break
            niter = total
        if self._per_member_dt:
            self.member_iters = np.asarray(niter)
        elif self._adaptive:
            self.attempts = int(niter)
        if status:
            # a failed call leaves the ensemble as it was
            self.t, self.u, self.helpers, self.pstack = before
            raise RuntimeError(self._scheme._failures[status])
        self.t = t
        self._internal_dt = (np.asarray(dt_i) if np.ndim(dt_i)
                             else float(dt_i))
        self._emit()
        return self.t, self.u

    # --------------------------------------------------------- the surface
    def step(self, dt):
        """Advance every member by dt (output clocks stay shared; with
        ``per_member_dt`` the internal stepping is member-local)."""
        return self._advance(1, dt, scan=False)

    def steps(self, n, dt):
        """Advance every member by n output steps of dt: one K6 launch on
        the K6 route, else n host output steps."""
        return self._advance(int(n), dt, scan=True)

    def run(self, tmax, dt, steps_per_call=None):
        """Run to tmax.  With ``steps_per_call`` the loop takes that many
        steps per ``steps`` call.  The final step is clamped so the run
        lands exactly on tmax even when it is not a multiple of dt."""
        eps = 1e-12 * max(1.0, abs(tmax))
        if steps_per_call and steps_per_call > 1:
            while True:
                n_full = int(np.floor((tmax - self.t) / dt + 1e-9))
                if n_full < 1:
                    break
                self.steps(min(int(steps_per_call), n_full), dt)
        while self.t < tmax - eps:
            self.step(min(dt, tmax - self.t))
        if self._container is not None:
            self._container.flush()
        return self.t, self.u

    def _emit(self):
        if self._stream is not None:
            self._stream.emit(self)

    @property
    def stream(self):
        """Push-based event stream emitting this Ensemble after every
        ``step(dt)`` and once per ``steps(n, dt)`` call."""
        if self._stream is None:
            self._stream = Stream()
        return self._stream

    @property
    def container(self):
        return self._container

    def attach_container(self, path=None, save="all", mode="w",
                         nbuffer=50, force=False):
        """Persist the whole sweep into one container, in ``path/<id>``
        (in memory with no path): every frame carries a ``member`` axis,
        so ``retrieve(path).data[var]`` has shape (T, B, N); the members'
        parameter values are in the metadata.  The current state is the
        first frame."""
        from ..plugins.container import Container, TimeSeries

        metadata = {"B": self.B, "N": self.N, "periodic": self.periodic,
                    "ensemble": True}
        keys = sorted({k for p in self._parameter_sets for k in p}
                      - {"periodic"})
        for k in keys:
            metadata[k] = [p.get(k) for p in self._parameter_sets]
        self._container = Container(
            "%s/%s" % (path, self.id) if path else None, save=save,
            mode=mode, metadata=metadata, force=force, nbuffer=nbuffer)
        self._container.connect(
            self.stream,
            snapshot=lambda ens: TimeSeries.from_ensemble_state(
                ens.t, ens, metadata))
        self._emit()
        return self._container

    def save_checkpoint(self, path):
        """One-call restartable snapshot of the whole sweep (t, member
        states, helpers, shared or per-member internal dt, member
        parameter sets): ``utils.checkpoint``."""
        from ..utils.checkpoint import save_ensemble_checkpoint

        return save_ensemble_checkpoint(path, self)

    @staticmethod
    def from_checkpoint(path, model, **kwargs):
        """Rebuild an Ensemble from a checkpoint file and the (re)built
        model; extra kwargs (scheme, tol, per_member_dt, ...) are
        forwarded."""
        from ..utils.checkpoint import load_ensemble_checkpoint

        return load_ensemble_checkpoint(path, model, **kwargs)
