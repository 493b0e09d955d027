"""Compensated (Kahan/Neumaier) accumulation of the state over a run of
steps: the counterpart of ``triflow_tpu.ops.compensated``.

A method-of-lines trajectory adds one state update per accepted step; in
float32 the rounding of ``u + du`` grows like sqrt(steps) * eps * |u|.  A
carry ``c`` of the same shape as u (the rounding residual of every past
addition) removes that growth for four elementwise operations per step.

Used by the host controllers (``core.rosenbrock``), ``device_steps``'
graph and eager routes and the ensembles' fixed ``steps`` when a scheme is
built with ``compensated=True``; kernel K6 runs the same four operations
in the same order (``csrc/megastep.cu: kahan_nodes``).  Each line is one
torch operation on whole tensors, which rounds once and reassociates
nothing: keep it so (no ``torch.compile``, no fused ``addcmul``), or the
identity that recovers the residual is lost.
"""

from __future__ import annotations


def kahan_update(u, c, u_new):
    """Fold the step's update ``u_new - u`` into the compensated pair (u,
    c): ``(u2, c2)`` with ``u2 = fl(u + ((u_new - u) + c))`` and ``c2`` the
    rounding residual of that addition (Neumaier's variant, safe for |du| >
    |u|), in the reference's order of operations."""
    du = u_new - u
    y = du + c
    u2 = u + y
    c2 = y - (u2 - u)
    return u2, c2
