"""Spatial domain decomposition: a grid cut into shards over a mesh axis.

Counterpart of ``triflow_tpu.parallel.spatial``.  The grid is split into
``ndev`` contiguous shards of ``Nl = N / ndev`` nodes along a mesh axis
(default "space"), and a step runs the reference's algorithm:

* **a halo ring per stencil evaluation**: F and J of each shard read h
  ghost nodes from its ring neighbours (``halo_extend``: two rolls of the
  shards' edge slices over the shard axis, the global ends edge-padded in
  edge mode), each shard with its own dx = x[1] - x[0].  On the card K1's
  ``*_shards`` entries do it in their tile loads (``ops/stencil.py``);
* **per-shard local factors with the couplings peeled out**: the shards'
  bands with the entries that reach a neighbour moved out
  (``banded.extract_wrap`` per shard: T to the left neighbour's last h
  nodes, B to the right neighbour's first h), factored as B * ndev
  independent acyclic systems by the chunked SPIKE factor (K2, K4), and the
  2P = 2 nvar h spike columns ``A_loc^-1 [E_top T | E_bot B]`` solved through
  it (K3, K4, K3);
* **the reduced interface system over the shards**: one supernode of 2P
  unknowns per shard (its first and last h nodes), the identity on the
  diagonal and the spikes' corner quadrants as couplings: K4's own layout
  with the shards as its chunks.  A periodic ring closes block-cyclic
  where ndev is a power of two >= 8 (``chunked.MIN_CYCLIC_C``), otherwise
  by K4's acyclic factor and its Woodbury closure; the reference closes any
  power of two cyclically;
* **the correction** ``x = y - W x_{d-1}^bot - V x_{d+1}^top`` of every
  shard by K3's spike correction, the shards as its chunks;
* **errors reduced across shards**: the max over the whole state.

The state stays one global ``(nvar, N)`` tensor (``(B, nvar, N)`` for an
ensemble's members), the shards its view ``(nvar, ndev, Nl)``: a hook writes
the global array, as in the reference, and the edge folds of the first and
last shard in edge mode are ``compiler.fold_edges`` on the global view of
the shard bands.  Every device of the mesh is one card here (``Mesh``):
the shards are views, the ring's "communication" a copy of edge slices,
and the interface system is solved once (the reference solves it
redundantly on every device).  A mesh across cards is ROADMAP A9b.

``ndev == 1`` factors the whole grid as one (the reference's special case:
the peeled couplings are the ring's own wrap); a model without a halo
(h = 0) has no couplings between shards.

``SpatialModel.scheme_class`` rebinds Theta, the ROW family and the explicit
RK family to the sharded F, J and factorization (``_SpatialSchemeMixin``):
the port's own step bodies, adaptive controllers, hooks and
``device_steps`` routes run over them, never K6 or K9.  ``refine=n`` takes
its residual against the distributed operator (K7 on the global bands,
whose cross-shard entries are the ghost couplings), and a df64 model's
stage solves take the mixed solve (``ops/mixed.py``): the float32 sharded
factor of the rounded system and ``df64_mixed_solve`` (0 or None: 2) K8
residual passes against the float64 global bands.
"""

from __future__ import annotations

import inspect
from typing import NamedTuple

import torch

from ..core import schemes as schemes_mod
from ..core.compiler import from_shards, halo_extend, to_shards
from ..ops import banded, chunked, mixed, pcr, thomas
from ..ops.banded import per_member
from .mesh import Mesh

__all__ = ["SpatialModel", "SpikeFactorization", "spike_factor", "ShardPlan",
           "shard_plan", "halo_extend", "banded_matvec_ext", "to_shards",
           "from_shards", "Mesh"]


# ---------------------------------------------------------------------------
# per-shard building blocks
# ---------------------------------------------------------------------------

def banded_matvec_ext(bands, v_ext):
    """Each shard's band product against its haloed vector: ``bands``
    (..., W, nvar, nvar, Nl) and ``v_ext`` (..., nvar, Nl + 2h); the
    couplings to neighbour shards are applied through the ghost nodes."""
    W, nvar, _, Nl = bands.shape[-4:]
    out = None
    for k in range(W):
        term = torch.einsum("...mni,...ni->...mi", bands[..., k, :, :, :],
                            v_ext[..., k:k + Nl])
        out = term if out is None else out + term
    return out


def _node_major(a):
    """(..., nvar, h) -> (..., h nvar): entry node * nvar + var."""
    a = a.transpose(-1, -2)
    return a.reshape(*a.shape[:-2], -1)


def _flatten_interface(zslice):
    """(..., C, nvar, h) spike slice (C columns) -> (..., P_rows, C): each
    column's h nodes node-major (row r = node * nvar + var)."""
    return _node_major(zslice).transpose(-1, -2)


def _bands_to_shards(bands, ndev):
    """Global bands (..., W, nvar, nvar, N) -> every shard's bands as
    members (B ndev, W, nvar, nvar, Nl), a contiguous copy."""
    W, nvar, _, N = bands.shape[-4:]
    sh = bands.unflatten(-1, (ndev, N // ndev)).movedim(-2, -5)
    return sh.reshape(-1, W, nvar, nvar, N // ndev).contiguous()


# ---------------------------------------------------------------------------
# the distributed factorization
# ---------------------------------------------------------------------------

class ShardPlan(NamedTuple):
    """The plans of a sharded factorization: ``local`` every shard's own
    chunk plan (B ndev members, acyclic; for ndev == 1 the whole grid's,
    ring included), and ``iface`` the interface level, K3's correction and
    K4's reduced system with the ndev shards as its chunks of Mc = ceil(Nl /
    g) supernode rows (a shard whose Nl is no multiple of g is padded to Mc g
    nodes there)."""

    ndev: int
    Nl: int
    B: int
    periodic: bool
    local: chunked.Plan
    iface: chunked.Plan

    @property
    def Nlp(self):
        """Nodes of a shard in the interface level's layout."""
        return self.iface.Mc * self.iface.g


def shard_plan(N: int, nvar: int, halo: int, ndev: int, periodic: bool,
               B: int = 1) -> ShardPlan:
    """The ``ShardPlan`` of B grids of N nodes cut into ndev shards."""
    Nl = N // ndev
    g = max(halo, 1)
    if ndev == 1:
        local = chunked.make_plan(N, nvar, halo, periodic, B)
    else:
        local = chunked.make_plan(Nl, nvar, halo, False, B * ndev)
    Mc = -(-Nl // g)
    wrap = bool(periodic) and halo > 0 and ndev > 1
    cyclic = wrap and ndev >= chunked.MIN_CYCLIC_C and ndev & (ndev - 1) == 0
    iface = chunked.Plan(ndev * Mc * g, nvar, halo, g, 2 * halo + 1, ndev, Mc,
                         cyclic, wrap, B)
    return ShardPlan(ndev, Nl, B, bool(periodic), local, iface)


class SpikeFactorization:
    """The distributed factorization of ``alpha*I + beta*J``: the shards'
    local factor, their spike columns (as K3's correction spikes W, V with
    the shards as chunks) and the reduced interface system's K4 factor
    (with its Woodbury closure on a ring that is not block-cyclic).
    ``solve`` has the signature of ``chunked.ChunkedFactorization.solve``."""

    def __init__(self, local, plan: ShardPlan, spikes=None, red=None,
                 wood=(None, None)):
        self.local = local
        self.plan = plan
        self.spikes = spikes
        self.red = red
        self.Zw, self.capw = wood

    def solve(self, rhs, add_to=None):
        """``add_to + A^-1 rhs`` (or ``A^-1 rhs``) of the global system, rhs
        of shape ((B,) nvar, N): the local solves of every shard (K3, K4,
        K3), the interface system (K4) and the correction (K3)."""
        plan = self.plan
        if plan.ndev == 1:
            return self.local.solve(rhs, add_to=add_to)
        lead, nvar, Nl = rhs.shape[:-2], rhs.shape[-2], plan.Nl
        shards = to_shards(rhs, plan.ndev).reshape(-1, nvar, Nl)
        y = self.local._tri_solve(shards.contiguous())
        if self.spikes is None:  # no halo: the shards never couple
            x = from_shards(y.reshape(*lead, plan.ndev, nvar, Nl))
            return x if add_to is None else add_to + x
        h = plan.local.halo
        ends = torch.cat([_node_major(y[..., :h]), _node_major(y[..., Nl - h:])],
                         dim=-1)
        yred = ends.reshape(*lead, plan.ndev, -1).transpose(-1, -2)
        xm1, xp1 = pcr.pcr_solve_shift(self.red, yred.contiguous(),
                                       plan.iface.wrap, self.Zw, self.capw)
        if plan.Nlp != Nl:  # every shard padded with zeros to Nlp nodes
            y = torch.nn.functional.pad(y, (0, plan.Nlp - Nl))
        y = from_shards(y.reshape(*lead, plan.ndev, nvar, plan.Nlp))
        if plan.Nlp == Nl:
            return thomas.spike_correct(self.spikes, y, xm1, xp1, plan.iface,
                                        add_to=add_to)
        x = thomas.spike_correct(self.spikes, y, xm1, xp1, plan.iface)
        x = from_shards(to_shards(x, plan.ndev)[..., :Nl])
        return x if add_to is None else add_to + x


def spike_factor(alpha, beta, bands, periodic: bool, plan: ShardPlan):
    """Factor ``alpha*I + beta*J`` of the global bands ((B,) W, nvar, nvar,
    N) of a grid cut into ``plan.ndev`` shards (module doc), ``beta`` a
    number or a per-member (B,) tensor; the signature of
    ``chunked.factor``."""
    if plan.ndev == 1:
        return SpikeFactorization(chunked.factor(alpha, beta, bands, periodic,
                                                 plan.local), plan)
    ndev = plan.ndev
    W, nvar, _, _ = bands.shape[-4:]
    h = W // 2
    P = nvar * h
    if isinstance(beta, torch.Tensor) and beta.ndim:
        beta = beta.repeat_interleave(ndev)
    J = _bands_to_shards(bands, ndev)
    T, Bc = banded.extract_wrap(J)
    local = chunked.factor(alpha, beta, J, False, plan.local)
    if h == 0:
        return SpikeFactorization(local, plan)
    Bt, Nl = J.shape[0], plan.Nl
    b3 = per_member(beta, 3)
    cols = banded.ring_columns(b3 * T, b3 * Bc, nvar, Nl)
    Z = torch.stack([local._tri_solve(cols[:, c].contiguous())
                     for c in range(2 * P)], dim=1)  # (Bt, 2P, nvar, Nl)
    # the interface system: rows my interface unknowns (first h nodes, then
    # last h, node-major), columns the neighbours' coupled unknowns
    quads = [_flatten_interface(Z[:, sl, :, nodes])
             for sl in (slice(0, P), slice(P, 2 * P))
             for nodes in (slice(0, h), slice(Nl - h, Nl))]
    Wt, Wb, Vt, Vb = quads
    Lred = Z.new_zeros((Bt, 2 * P, 2 * P))
    Ured = Z.new_zeros((Bt, 2 * P, 2 * P))
    Lred[:, :P, P:], Lred[:, P:, P:] = Wt, Wb
    Ured[:, :P, :P], Ured[:, P:, :P] = Vt, Vb
    lead = () if bands.ndim == 4 else (bands.shape[0],)
    Lred = Lred.reshape(*lead, ndev, 2 * P, 2 * P).movedim(-3, -1).contiguous()
    Ured = Ured.reshape(*lead, ndev, 2 * P, 2 * P).movedim(-3, -1).contiguous()
    if not periodic:
        # the global edge folds zero the boundary shards' outward couplings
        # already; the acyclic ends hold by construction
        Lred[..., 0] = 0.0
        Ured[..., ndev - 1] = 0.0
    red = pcr.pcr_factor(Lred, Ured, plan.iface.cyclic)
    wood = (pcr.woodbury(red, Lred, Ured) if plan.iface.woodbury
            else (None, None))
    # the spikes as K3's correction spikes: rows of g nodes of every shard
    Mc, g = plan.iface.Mc, plan.iface.g
    if plan.Nlp != Nl:
        Z = torch.nn.functional.pad(Z, (0, plan.Nlp - Nl))
    rows = Z.unflatten(-1, (Mc, g)).permute(0, 3, 4, 2, 1).reshape(Bt, Mc, P, 2 * P)
    rows = rows.reshape(*lead, ndev, Mc, P, 2 * P).movedim(-4, -1)
    spikes = banded.SpikeFactor(None, None, None, rows[..., :P, :].contiguous(),
                                rows[..., P:, :].contiguous(), Lred, Ured)
    return SpikeFactorization(local, plan, spikes, red, wood)


# ---------------------------------------------------------------------------
# the sharded model
# ---------------------------------------------------------------------------

class _ShardedProblem(schemes_mod._DeviceProblem):
    """A model bound to one hook and boundary mode whose F and J are those
    of its grid cut into ``shards`` (K1's ``*_shards`` entries)."""

    def __init__(self, model, hook, periodic, shards):
        super().__init__(model, hook, periodic)
        self.shards = shards

    def F(self, u, helpers, pstack, x, scale=1.0, bias=None):
        return self.backend.F(u, helpers, pstack, x, periodic=self.periodic,
                              scale=scale, bias=bias, shards=self.shards)

    def F_terms(self, terms, helpers, pstack, x, scale):
        return self.backend.F_terms(terms, helpers, pstack, x,
                                    periodic=self.periodic, scale=scale,
                                    shards=self.shards)

    def J_bands(self, u, helpers, pstack, x):
        return self.backend.J_bands(u, helpers, pstack, x,
                                    periodic=self.periodic,
                                    shards=self.shards)


class SpatialModel:
    """A model whose grid is sharded over a mesh axis.

    Parameters
    ----------
    model : triflow_tpu_torch.Model
    mesh : ``Mesh`` carrying the axis, on the model's device
    axis : str, the mesh axis that carries the grid (default "space")
    periodic : bool, the global boundary closure of the raw steppers (the
        scheme path reads it from the parameters dict)

    Usage
    -----
    Raw tensor steppers (fixed dt)::

    >>> sm = SpatialModel(model, Mesh.on("cpu", 8, ("space",)), periodic=True)
    >>> step = sm.row_stepper(schemes.RODASPR)
    >>> u = sm.shard(u0); x = sm.shard(x_global)
    >>> t, u = step(0.0, u, helpers, pstack, x, 0.05)

    The full scheme surface (hooks, adaptive dt), usually through
    ``Simulation(..., mesh=mesh)``, which does this wiring itself.
    """

    def __init__(self, model, mesh: Mesh, axis: str = "space",
                 periodic: bool = True):
        if axis not in mesh.shape:
            raise ValueError(f"the mesh has no axis {axis!r} (axes "
                             f"{mesh.axis_names})")
        mesh.check_device(model.device)
        self.model = model
        self.mesh = mesh
        self.axis = axis
        self.periodic = periodic
        self.ndev = mesh.shape[axis]
        self.backend = model.backend
        self.h = model.halo

    # -- data placement -----------------------------------------------------
    def check_grid(self, N: int):
        """The reference's two guards on a grid of N nodes over the axis."""
        if N % self.ndev:
            raise ValueError(
                f"grid size {N} must divide the mesh axis ({self.ndev})")
        Nl = N // self.ndev
        if Nl < 2 * max(self.h, 1):
            raise ValueError(
                f"local shard size {Nl} too small for halo {self.h} "
                f"(need >= {2 * max(self.h, 1)} nodes per device)")
        return Nl

    def shard(self, arr):
        """``arr`` (..., N) as a contiguous tensor of the model's device and
        dtype, after the guards; its shards are its views ``to_shards``."""
        arr = self.backend.as_tensor(arr)
        self.check_grid(arr.shape[-1])
        return arr.contiguous()

    # -- per-shard physics ---------------------------------------------------
    def _local_F(self, u, helpers, pstack, x, periodic=None):
        periodic = self.periodic if periodic is None else periodic
        return self.backend.F(u, helpers, pstack, x, periodic=periodic,
                              shards=self.ndev)

    def _local_J(self, u, helpers, pstack, x, periodic=None):
        """The global bands of the sharded J (each shard's own dx; in edge
        mode the global ends folded)."""
        periodic = self.periodic if periodic is None else periodic
        return self.backend.J_bands(u, helpers, pstack, x, periodic=periodic,
                                    shards=self.ndev)

    def plan(self, N: int, periodic=None, B: int = 1) -> ShardPlan:
        periodic = self.periodic if periodic is None else periodic
        sysm = self.backend.system
        return shard_plan(N, sysm.nvar, self.h, self.ndev, periodic, B)

    def factor(self, beta, bands, periodic=None, B: int = 1):
        """``spike_factor`` of ``I + beta J`` from the global bands."""
        periodic = self.periodic if periodic is None else periodic
        return spike_factor(1.0, beta, bands, periodic,
                            self.plan(bands.shape[-1], periodic, B))

    # -- scheme integration ---------------------------------------------------
    def scheme_class(self, scheme_cls=None):
        """A scheme class (ROW family, explicit RK family, or Theta) rebound
        to this sharded model: the same constructor signature and the whole
        ``_SchemeBase`` surface (hooks, adaptive controllers,
        ``device_steps``), with the sharded F, J and factorization.  Feed
        it to ``Simulation(..., scheme=...)``, or use ``Simulation(...,
        mesh=mesh)``, which does this wiring itself."""
        scheme_cls = scheme_cls or schemes_mod.RODASPR
        if issubclass(scheme_cls, (schemes_mod.ROW_general, schemes_mod.Theta)):
            mixin = _SpatialSchemeMixin
        elif issubclass(scheme_cls, schemes_mod.ERK_general):
            mixin = _SpatialERKMixin
        else:
            raise TypeError(
                f"{scheme_cls.__name__} has no sharded implementation "
                "(supported: ROW family, explicit RK family, Theta)")
        return type("Spatial" + scheme_cls.__name__, (mixin, scheme_cls),
                    {"_spatial": self})

    def _make_scheme(self, scheme_cls, **scheme_kwargs):
        cls = self.scheme_class(scheme_cls)
        params = inspect.signature(scheme_cls.__init__).parameters
        kwargs = {k: v for k, v in scheme_kwargs.items() if k in params}
        return cls(self.model, **kwargs)

    # -- raw tensor steppers --------------------------------------------------
    def theta_stepper(self, theta=1.0):
        """Sharded linearized theta step over raw tensors:
        ``step(t, u, helpers, pstack, x, dt) -> (t2, u2)``."""
        scheme = self._make_scheme(schemes_mod.Theta, theta=theta)
        stepper = scheme.device_stepper(periodic=self.periodic)

        def step(t, u, helpers, pstack, x, dt):
            t2, u2, *_ = stepper(t, u, helpers, pstack, x, dt, dt)
            return t2, u2

        return step

    def row_stepper(self, scheme_cls=None, **scheme_kwargs):
        """Sharded Rosenbrock-Wanner step over raw tensors: one distributed
        factorization reused for all stages, a halo ring per stage.

        Fixed dt by default: ``step(t, u, helpers, pstack, x, dt) -> (t2,
        u2)``.  With ``time_stepping=True`` (and ``tol``) the adaptive
        controller runs over the sharded step (one error read per attempt,
        the max over the shards), and the stepper becomes ``step(t, u,
        helpers, pstack, x, dt, internal_dt) -> (t2, u2, internal_dt',
        status)``."""
        scheme_kwargs.setdefault("time_stepping", False)
        scheme_kwargs.setdefault("tol", None)
        scheme = self._make_scheme(scheme_cls or schemes_mod.RODASPR,
                                   **scheme_kwargs)
        stepper = scheme.device_stepper(periodic=self.periodic)
        if getattr(scheme, "_time_control", False):
            def adaptive_step(t, u, helpers, pstack, x, dt, internal_dt):
                t2, u2, _h, _p, _x, dt_i, _niter, status = stepper(
                    t, u, helpers, pstack, x, dt, internal_dt)
                return t2, u2, dt_i, status

            return adaptive_step

        def step(t, u, helpers, pstack, x, dt):
            t2, u2, *_ = stepper(t, u, helpers, pstack, x, dt, dt)
            return t2, u2

        return step

    def F(self):
        """``F_fn(t, u, helpers, pstack, x, dt) -> (t, F)``: the sharded F of
        the global tensors (diagnostics and tests)."""
        def F_fn(t, u, helpers, pstack, x, dt):
            return t, self._local_F(u, helpers, pstack, x)

        return F_fn


# ---------------------------------------------------------------------------
# scheme mixins: the _SchemeBase machinery over the sharded pieces
# ---------------------------------------------------------------------------

class _SpatialSchemeMixin:
    """Rebinds a scheme's F, J and factorization to its ``SpatialModel``:
    the problem (``_ShardedProblem``), the plans (``ShardPlan``) and the
    factor (``spike_factor``, or the df64 mode's mixed solve over it with 2
    residual passes unless ``df64_mixed_solve`` says otherwise, as the
    reference's mixins map 0); no K6 plan, no K6 mixed plan, no K9.  Hooks
    stay at the global level (the base class's), so reference-style
    Dirichlet hooks work unchanged on sharded state."""

    _spatial: SpatialModel = None  # bound by SpatialModel.scheme_class

    def _mega_plan(self, N, periodic, B=1):
        return None

    def _mixed_plan(self, N, periodic):
        return None

    def _plan(self, N, periodic, B=1):
        key = (N, periodic, B)
        if key not in self._plans:
            self._plans[key] = self._spatial.plan(N, periodic, B)
        return self._plans[key]

    def _problem(self, hook, periodic):
        key = (hook, periodic)
        if key not in self._problems:
            self._problems[key] = _ShardedProblem(self._model, hook, periodic,
                                                  self._spatial.ndev)
        return self._problems[key]

    def _passes(self):
        """Residual passes of the df64 mode's mixed solve (0 or None: 2)."""
        return (self._mixed or 2) if self._df64 else 0

    def _factor(self, problem, u, helpers, pstack, x, beta):
        B = u.shape[0] if u.ndim == 3 else 1
        plan = self._plan(x.shape[-1], problem.periodic, B)
        bands = problem.J_bands(u, helpers, pstack, x)
        passes = self._passes()
        if passes:
            fact = mixed.MixedFactorization(bands, -beta, problem.periodic,
                                            plan, passes, factor=spike_factor)
        else:
            fact = spike_factor(1.0, beta, bands, problem.periodic, plan)
        return fact, (bands if self._refine else None)

    def _split(self, fields, pars):
        u, helpers, pstack, x = super()._split(fields, pars)
        self._spatial.check_grid(x.shape[-1])
        return u, helpers, pstack, x


class _SpatialERKMixin(_SpatialSchemeMixin):
    def _fsal(self, hook):
        """False: the generic loop, as the reference's sharded mixin forces
        it (its FSAL loop called F outside the sharded core)."""
        return False
