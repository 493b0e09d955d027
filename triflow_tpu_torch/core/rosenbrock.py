"""The Rosenbrock-Wanner pieces below the schemes: the Hairer-Wanner
transform of a table, RODASPR's coefficients, and the embedded-error
step-size controller.

``core.schemes`` builds its ROW schemes on them, and its explicit RK
family on the controller (with the pair's exponent); kernel K6's plain
adaptive step (``ops.megastep.adaptive_plain``) is handed the controller,
and the kernel checks build RODASPR's table from the coefficients.  An
ensemble (``parallel.Ensemble``) runs the shared controller on the max
error over its members and ``member_controller`` for per-member clocks.
This module imports neither the schemes nor the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.compensated import kahan_update


def transformed(alpha, gamma, b, b_pred=None):
    """The Hairer-Wanner transformed tables (Solving ODEs II, ch. IV.7) of
    ``(alpha, gamma, b, b_pred)``: ``(a_t, c_t, m_t, m_pred_t)``, with
    ``a_t`` and ``c_t`` strictly lower and ``m_pred_t`` None without
    ``b_pred``."""
    alpha, gamma = np.asarray(alpha, np.float64), np.asarray(gamma, np.float64)
    s = len(b)
    G = np.tril(gamma, -1) + gamma[0, 0] * np.eye(s)
    Ginv = np.linalg.inv(G)
    m_pred_t = None if b_pred is None else np.asarray(b_pred, np.float64) @ Ginv
    return (alpha @ Ginv, -np.tril(Ginv, -1), np.asarray(b, np.float64) @ Ginv,
            m_pred_t)


def rodaspr_coefficients():
    """``(alpha, gamma, b, b_pred)`` of RODASPR, order 4(3) (Rang 2013)."""
    alpha = np.zeros((6, 6))
    gamma = np.zeros((6, 6))
    b = [-7.9683251690137014e-1,
         6.2136401428192344e-2,
         1.1198553514719862e0,
         4.7198362114404874e-1,
         -1.0714285714285714e-1,
         2.5e-1]
    b_pred = [-7.3844531665375115e0,
              -3.0593419030174646e-1,
              7.8622074209377981e0,
              5.7817993590145966e-1,
              2.5e-1,
              0]
    alpha[1, 0] = 7.5e-1
    alpha[2, 0] = 7.5162877593868457e-2
    alpha[2, 1] = 2.4837122406131545e-2
    alpha[3, 0] = 1.6532708886396510e0
    alpha[3, 1] = 2.1545706385445562e-1
    alpha[3, 2] = -1.3157488872766792e0
    alpha[4, 0] = 1.9385003738039885e1
    alpha[4, 1] = 1.2007117225835324e0
    alpha[4, 2] = -1.9337924059522791e1
    alpha[4, 3] = -2.4779140110062559e-1
    alpha[5, 0] = -7.3844531665375115e0
    alpha[5, 1] = -3.0593419030174646e-1
    alpha[5, 2] = 7.8622074209377981e0
    alpha[5, 3] = 5.7817993590145966e-1
    alpha[5, 4] = 2.5e-1
    gamma_i = .25
    for i in range(len(b)):
        gamma[i, i] = gamma_i
    gamma[1, 0] = -7.5e-1
    gamma[2, 0] = -8.8644e-2
    gamma[2, 1] = -2.868897e-2
    gamma[3, 0] = -4.84700e0
    gamma[3, 1] = -3.1583e-1
    gamma[3, 2] = 4.9536568e0
    gamma[4, 0] = -2.67694569e1
    gamma[4, 1] = -1.5066459e0
    gamma[4, 2] = 2.720013e1
    gamma[4, 3] = 8.25971337e-1
    gamma[5, 0] = 6.58762e0
    gamma[5, 1] = 3.6807059e-1
    gamma[5, 2] = -6.74235e0
    gamma[5, 3] = -1.061963e-1
    gamma[5, 4] = -3.57142857e-1
    return alpha, gamma, b, b_pred


def _dt_next(T, safety, dt_eff, tol, err, tiny, exponent):
    """``safety*dt_eff*(tol/err)**exponent`` clipped to [0.1, 10] dt_eff in
    ``T``: ``np.sqrt`` at the exponent 1/2 (the ROW controller, the
    reference's own branch), a power in ``T`` otherwise (the explicit RK
    pairs' 1/(order + 1))."""
    ratio = tol / np.maximum(err, tiny)
    if exponent == 0.5:
        dt_next = safety * dt_eff * np.sqrt(ratio)
    else:
        dt_next = safety * dt_eff * np.power(ratio, T(exponent))
    return np.minimum(np.maximum(dt_next, T(0.1) * dt_eff), T(10.0) * dt_eff)


def adaptive_controller(attempt, T, t, dt, internal_dt, tol, safety,
                        max_iter, dt_min, interpolate, state, clock=None,
                        carry=None, exponent=0.5):
    """One output step from ``t`` to ``t + dt`` through accepted attempts:
    the counterpart of the reference's ``_adaptive_embedded_loop`` with the
    controller ``dt <- clip(safety*dt*(tol/err)**exponent, 0.1*dt, 10*dt)``
    (``exponent`` 1/2 for the ROW family, taken by ``np.sqrt``, and
    1/(order + 1) for an explicit RK pair), every quantity a numpy scalar
    of ``T`` (the model's dtype).

    ``attempt(t_, state, dt_eff) -> (state2, err)`` runs one step of
    ``dt_eff`` (err a ``T`` scalar); ``state[0]`` is u.  ``interpolate``
    (``recompute_target=False``) overshoots the output time and
    interpolates u between the bracketing steps.  Returns (next_t, state,
    dt_i, niter, status), status 1 for max_iter and 2 for the dt floor.
    K6's adaptive entry runs the same arithmetic in the same order.

    ``clock`` (the df64 mode: float64, with ``T`` float32) carries the
    times in a type of their own, as the reference's compensated (hi, lo)
    float32 clock does: every attempt's dt is still a ``T`` value, the
    remaining time rounded to ``T`` where the attempt is clamped to the
    output time, so the clamped attempt may leave a remainder below ``T``'s
    resolution that one more attempt takes, as in the reference.

    ``carry`` (``compensated=True``: a tensor of u's shape, updated in
    place) makes every accepted u the Kahan update of the last one by the
    attempt's (``ops.compensated.kahan_update``), as the reference's loop
    does; a rejected attempt leaves u and the carry as they were."""
    info = np.finfo(T)
    Tc = T if clock is None else clock
    tol, safety = T(tol), T(safety)
    next_t = Tc(t) + Tc(dt)
    eps = Tc(1e-12) * np.maximum(abs(next_t), Tc(1.0))
    if dt_min is not None:
        dt_floor = T(dt_min)
    else:
        dt_floor = T(1e3) * info.tiny + T(2.0) * info.eps * T(abs(next_t))
    t_ = Tc(t)
    dt_i = T(internal_dt) if interpolate \
        else np.minimum(T(internal_dt), T(dt))
    tp, sp_ = t_, state
    niter, status = 0, 0
    while next_t - t_ > eps and status == 0:
        if interpolate:
            clamped, dt_eff = False, dt_i
        else:
            remaining = next_t - t_
            clamped = dt_i >= remaining
            dt_eff = T(np.minimum(dt_i, remaining))
        state2, err = attempt(t_, state, dt_eff)
        accept = err <= tol
        dt_next = _dt_next(T, safety, dt_eff, tol, err, info.tiny, exponent)
        if accept:
            tp, sp_ = t_, state
            t_ = t_ + dt_eff
            if carry is not None:
                u2, c2 = kahan_update(state[0], carry, state2[0])
                carry.copy_(c2)
                state2 = (u2,) + tuple(state2[1:])
            state = state2
        if not (accept and clamped):
            dt_i = dt_next
        niter += 1
        if max_iter is not None and niter > max_iter:
            status = 1
        if dt_i < dt_floor:
            status = 2
    if interpolate:
        # the weight in T from the clock's values rounded to T, as the
        # reference weighs it from its (hi, lo) clock's hi + lo; the lerp
        # in the state's type
        span = np.maximum(T(t_) - T(tp), info.tiny)
        w = np.clip((T(next_t) - T(tp)) / span, T(0.0), T(1.0))
        state = (sp_[0] + float(w) * (state[0] - sp_[0]),) + tuple(state[1:])
    return next_t, state, dt_i, niter, status


def _where_members(mask, a, b):
    """Per-member select of two member-leading tensors by a (B,) mask."""
    return torch.where(mask.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)


def member_controller(attempt, T, t, dt, internal_dt, tol, safety, max_iter,
                      dt_min, interpolate, state, clock=None, carry=None,
                      exponent=0.5):
    """One output step from ``t`` to ``t + dt`` in which every member of an
    ensemble runs its own clock and step size: the counterpart of the
    reference's ``_per_member_adaptive_loop`` (masked freezing: a member
    that reached ``t + dt`` no longer moves while the others retry), with
    the same controller as ``adaptive_controller`` (and its ``exponent``)
    per member, every quantity a numpy array of ``T`` over the B members.

    ``attempt(tb, state, dt_eff) -> (state2, errs)`` steps every member
    from its clock ``tb`` by its ``dt_eff`` (arrays of B) and returns the
    members' errors (B,); ``state`` is a tuple of member-leading tensors,
    u first, updated where a member accepts.  ``internal_dt`` is a number
    or one per member.  ``interpolate`` (``recompute_target=False``)
    overshoots and interpolates each member's u between its own bracketing
    steps.  Returns (next_t, state, dt_b, niter_b, status): status 1 when
    an active member exceeds ``max_iter`` attempts, 2 when a member still
    short of ``t + dt`` has its dt below the floor; the loop stops for all
    members at the first.

    ``clock`` (the df64 mode: float64, with ``T`` float32) carries every
    member's clock in a type of its own, as ``adaptive_controller``'s, the
    reference's compensated (hi, lo) member clocks: each dt_eff a ``T``
    value, a clamped one the member's remaining time rounded to ``T``, and
    the weight of ``recompute_target=False``'s interpolation taken in ``T``
    from the clocks rounded to ``T``, as the reference takes it from hi +
    lo, the interpolation itself in the state's type.  ``carry`` (a member-leading tensor of u's shape, updated in
    place) makes each accepting member's u the Kahan update of its last
    one, the reference's ``compensated`` members."""
    info = np.finfo(T)
    Tc = T if clock is None else clock
    tol, safety = T(tol), T(safety)
    next_t = Tc(t) + Tc(dt)
    eps = Tc(1e-12) * np.maximum(abs(next_t), Tc(1.0))
    if dt_min is not None:
        dt_floor = T(dt_min)
    else:
        dt_floor = T(1e3) * info.tiny + T(2.0) * info.eps * T(abs(next_t))
    device = state[0].device
    B = state[0].shape[0]
    tb = np.full(B, Tc(t), dtype=Tc)
    idt = np.broadcast_to(np.asarray(internal_dt, dtype=T), (B,)).copy()
    dtb = idt if interpolate else np.minimum(idt, T(dt))
    tpb, sp_ = tb.copy(), state
    nb = np.zeros(B, dtype=np.int64)
    status = 0
    while np.any(next_t - tb > eps) and status == 0:
        remaining = next_t - tb
        active = remaining > eps
        if interpolate:
            clamped = np.zeros(B, dtype=bool)
            dt_eff = dtb
        else:
            clamped = dtb >= remaining
            dt_eff = np.minimum(dtb, remaining).astype(T)
        state2, errs = attempt(tb, state, dt_eff)
        errs = np.asarray(errs, dtype=T)
        accept = (errs <= tol) & active
        dt_next = _dt_next(T, safety, dt_eff, tol, errs, info.tiny, exponent)
        dtb = np.where(active & ~(accept & clamped), dt_next, dtb)
        mask = torch.as_tensor(accept, device=device)
        if interpolate:
            tpb = np.where(accept, tb, tpb)
            sp_ = tuple(_where_members(mask, a, b) for a, b in zip(state, sp_))
        tb = np.where(accept, tb + dt_eff, tb)
        if carry is not None:
            u2, c2 = kahan_update(state[0], carry, state2[0])
            carry.copy_(_where_members(mask, c2, carry))
            state2 = (u2,) + tuple(state2[1:])
        state = tuple(_where_members(mask, a, b) for a, b in zip(state2, state))
        nb += active
        if max_iter is not None and np.any(active & (nb > max_iter)):
            status = 1
        if np.any((next_t - tb > eps) & (dtb < dt_floor)):
            status = 2
    if interpolate:
        span = np.maximum(tb.astype(T) - tpb.astype(T), info.tiny)
        w = np.clip((T(next_t) - tpb.astype(T)) / span, T(0.0), T(1.0))
        w = torch.as_tensor(w, device=device).reshape(
            (-1,) + (1,) * (state[0].ndim - 1))
        state = (sp_[0] + w * (state[0] - sp_[0]),) + tuple(state[1:])
    return next_t, state, dtb, nb, status
