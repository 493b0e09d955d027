"""Captured fixed-step graphs: ``n`` fixed steps of a scheme on one grid,
captured once as a CUDA graph (``torch.cuda.CUDAGraph``) and replayed.

The reference advances ``n`` output steps in one device submission (a
jitted ``lax.scan``).  A fixed step of the port is a run of kernel launches
(K1-K5 for ROW, K1-K4 for Theta, K7 and K8 where the scheme refines or runs
the df64 mode's mixed solve) that reads nothing back to the host, so ``n``
of them can be captured once and replayed as one submission: the host
enqueues one graph instead of 7 (Theta) to 38 (RODASPR) launches per step.

A graph is valid for the values it was captured with: the kernels take dt
(and the products made of it) as host scalars, so a graph is keyed by
(N, periodic, dtype, device, dt, n, snapshots, compensated, the shapes of
helpers and parameters).  A compensated graph (a ``compensated=True``
scheme's) folds each step's state into a Kahan carry
(``ops.compensated.kahan_update``) that the graph zeroes before its first
step, so every replay starts it at zero.  The scheme keeps a few graphs
(``MAX_GRAPHS``, least recently used dropped).  Inputs are copied into the graph's static buffers before
each replay; the snapshots (each step's u in a slot of an ``(n, nvar, N)``
tensor written inside the graph) or the final state are cloned after it.

Only the null hook is captured: a hook may read ``t`` as a Python float,
which a graph would freeze.  Under the null hook a step leaves the helpers,
parameters and x as they were, so only u is snapshotted.

Launch counts stay true: capturing records launches without running them,
so the counts the wrappers added while capturing are taken back, and every
replay adds them again (``ops._launch.COUNTERS``).

Python's cyclic garbage collector is run before a capture and held off
during it: a collection inside the capture could free an unreachable
object holding an earlier graph, and destroying a graph is an operation
that invalidates a capture in progress.
"""

from __future__ import annotations

import gc

import torch

from ..ops import _launch
from ..ops.compensated import kahan_update

#: graphs kept per scheme
MAX_GRAPHS = 4


class FixedGraph:
    """``n`` fixed steps of ``fixed(t, u, helpers, pstack, x, dt)`` (the
    scheme's ``device_fixed_step`` under the null hook), captured on
    static copies of the first call's inputs; with ``compensated`` each
    step's state is the Kahan update of the last, the carry zeroed at the
    start of every replay."""

    def __init__(self, fixed, u, helpers, pstack, x, dt, n, snapshots,
                 compensated=False):
        if n < 1:
            raise ValueError(f"a fixed-step graph of n = {n} < 1 steps")
        self.n = n
        self.static = [torch.empty_like(a) for a in (u, helpers, pstack, x)]
        self.snap = (torch.empty((n,) + tuple(u.shape), dtype=u.dtype,
                                 device=u.device) if snapshots else None)
        self.graph = torch.cuda.CUDAGraph()
        before = _launch.counts()
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph):
                su, sh, sp, sx = self.static
                carry = torch.zeros_like(su) if compensated else None
                for k in range(n):
                    su2, sh, sp, sx, _ = fixed(0.0, su, sh, sp, sx, dt)
                    if carry is not None:
                        su2, carry = kahan_update(su, carry, su2)
                    su = su2
                    if self.snap is not None:
                        self.snap[k].copy_(su)
                self.out = su
        finally:
            if collecting:
                gc.enable()
        after = _launch.counts()
        self.launches = {k: after[k] - before.get(k, 0) for k in after
                         if after[k] != before.get(k, 0)}
        # the capture ran nothing: its launches count at each replay
        for name, k in self.launches.items():
            _launch.COUNTERS[name].count -= k

    def __call__(self, u, helpers, pstack, x):
        """Replay on these inputs: the final state, or with snapshots the
        (n, nvar, N) states, each a clone the next replay leaves alone."""
        for dst, src in zip(self.static, (u, helpers, pstack, x)):
            dst.copy_(src)
        self.graph.replay()
        for name, k in self.launches.items():
            _launch.COUNTERS[name].count += k
        return (self.out if self.snap is None else self.snap).clone()


def fixed_steps(cache, fixed, periodic, u, helpers, pstack, x, dt, n,
                snapshots, compensated=False):
    """``n`` fixed steps of ``dt`` from (u, helpers, pstack, x), CUDA
    tensors of one grid, by ``fixed`` (the scheme's null-hook fixed step on
    the ``periodic`` boundary) through the graph of ``cache`` (a scheme's
    ``OrderedDict``, least recently used first) for this key, captured at
    its first use; ``compensated``: through a Kahan carry (module doc)."""
    key = (bool(periodic), tuple(u.shape), tuple(helpers.shape),
           tuple(pstack.shape), u.dtype, u.device, float(dt), int(n),
           bool(snapshots), bool(compensated))
    graph = cache.get(key)
    if graph is None:
        graph = FixedGraph(fixed, u, helpers, pstack, x, dt, int(n),
                           snapshots, compensated)
        if len(cache) >= MAX_GRAPHS:
            cache.popitem(last=False)
        cache[key] = graph
    else:
        cache.move_to_end(key)
    return graph(u, helpers, pstack, x)
