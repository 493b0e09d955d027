"""Temporal schemes: callables ``scheme(t, fields, dt, pars, hook) -> (t,
fields)`` that step the discretized system on the model's device.

Counterpart of the parts of ``triflow_tpu.core.schemes`` on the theta
step's path: ``null_hook``, the device-state plumbing (``_DeviceProblem``,
``_SchemeBase``) and ``Theta``.  The Rosenbrock-Wanner family, the
explicit Runge-Kutta family and the step-doubling wrapper are queued.

Hooks keep the reference contract ``hook(t, fields, pars) -> (fields,
pars)``.  The fields hold torch tensors, so a Dirichlet condition is the
in-place ``fields["U"][0] = 1.0`` (returning the same fields); rebinding a
name to a new tensor works too.  The hook runs before the step at ``t`` and
after it at ``t + dt``, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import chunked


def null_hook(t, fields, pars):
    return fields, pars


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

    def F(self, u, helpers, pstack, x, scale=1.0):
        return self.backend.F(u, helpers, pstack, x, periodic=self.periodic,
                              scale=scale)

    def J_bands(self, u, helpers, pstack, x):
        return self.backend.J_bands(u, helpers, pstack, x,
                                    periodic=self.periodic)


class _SchemeBase:
    """Splits Fields into device tensors, steps them, rebuilds Fields."""

    def __init__(self, model):
        self._model = model
        self._problems = {}
        self._np_dtype = np.float64 if model.dtype == torch.float64 \
            else np.float32

    def _problem(self, hook, periodic):
        key = (hook, periodic)
        if key not in self._problems:
            self._problems[key] = _DeviceProblem(self._model, hook, periodic)
        return self._problems[key]

    def _advance(self, t, dt):
        """``t + dt`` rounded as the model's dtype adds them."""
        return float(self._np_dtype(t) + self._np_dtype(dt))

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


class Theta(_SchemeBase):
    """One-step theta scheme: theta=0 forward Euler, 1 backward Euler,
    0.5 Crank-Nicolson, linearized with J frozen at the current state.

    The implicit step uses the identity ``B = dt*(F - theta*J*u) + u =
    A*u + dt*F`` with ``A = I - theta*dt*J``, so ``u2 = u + A^-1 (dt*F)``:
    J's bands (K1), the chunked factor of A (K2, K4), dt*F (K1) and one
    solve (K3, K4, K3) whose last kernel adds the state."""

    def __init__(self, model, theta=1, solver=None):
        if solver is not None:
            raise NotImplementedError(
                "Theta(solver=...): custom linear solvers are not ported yet")
        super().__init__(model)
        self._theta = theta
        self._plans = {}

    def _plan(self, N, periodic):
        key = (N, periodic)
        if key not in self._plans:
            self._plans[key] = chunked.make_plan(
                N, self._model.system.nvar, self._model.halo, periodic)
        return self._plans[key]

    def fixed_step(self, problem, u, helpers, pstack, x, dt):
        """One step of dt from a hooked state: returns the new u."""
        dt = float(self._np_dtype(dt))
        theta = self._theta
        rhs = problem.F(u, helpers, pstack, x, scale=dt)
        if theta == 0:
            return u + rhs
        plan = self._plan(x.shape[-1], problem.periodic)
        bands = problem.J_bands(u, helpers, pstack, x)
        fact = chunked.factor(1.0, -theta * dt, bands, problem.periodic, plan)
        return fact.solve(rhs, add_to=u)

    def __call__(self, t, fields, dt, pars, hook=null_hook):
        problem = self._problem(hook, bool(pars.get("periodic", False)))
        u, helpers, pstack, x = self._split(fields, pars)
        u, helpers, pstack, x = problem.apply_hook(t, u, helpers, pstack, x)
        u2 = self.fixed_step(problem, u, helpers, pstack, x, dt)
        t2 = self._advance(t, dt)
        u2, helpers, pstack, x = problem.apply_hook(t2, u2, helpers, pstack, x)
        return t2, self._rebuild(u2, helpers, x)
