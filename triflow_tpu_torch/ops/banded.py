"""Plain PyTorch block-banded linear algebra: the reference version of the
solver kernels K2-K4.

Counterpart of the parts of ``triflow_tpu.ops.banded`` that the theta step
needs.  A banded matrix ``A (W, nvar, nvar, N)`` (``A[k, m, n, i]`` couples
node i to node i + k - h) is grouped into supernodes of ``g = max(h, 1)``
nodes, which makes it block-tridiagonal with dense ``s = nvar * g`` blocks
(``assemble_blocks``).  The block-tridiagonal system is cut into C chunks
of Mc rows; each chunk is eliminated by a block-Thomas sweep and the chunks
are coupled through a reduced system over their interface rows (Wang's
algorithm, also called SPIKE), which is solved by parallel cyclic
reduction (PCR).  A periodic grid closes its ring in that reduced system:
block-cyclic PCR where the chunk count is a power of two >= 8, otherwise
acyclic PCR and a rank-2s Woodbury correction (``woodbury_setup``,
``woodbury_correct``).

Block stacks keep the reference's ``(..., s, s, M)`` convention (block
index last); the chunked arrays are ``(Mc, s, s, C)``, the layout the CUDA
kernels store.  Loops over rows are Python loops, vectorised over chunks.

A padded grid (``ops/chunked.py``) has no ring inside its chunks: its
periodic wrap couplings leave the bands (``extract_wrap``) and close the
ring at the system level, by a rank-2P Woodbury correction with P = nvar *
h (``ring_columns``, ``ring_setup``, ``ring_correct``: the reference's
``_extract_wrap`` and ``_attach_woodbury``).

Every function also takes a leading member axis (an ensemble's B grids,
each its own system): bands ``(B, W, nvar, nvar, N)``, blocks
``(B, s, s, M)``, chunk rows ``(Mc, B, s, s, C)`` and reduced systems
``(B, s2, s2, C)``.  Members never couple: each closes its own ring.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def identity_bands(window: int, nvar: int, N: int, dtype=torch.float64,
                   device="cpu"):
    """Banded representation of the identity matrix."""
    bands = torch.zeros((window, nvar, nvar, N), dtype=dtype, device=device)
    idx = torch.arange(nvar, device=device)
    bands[window // 2, idx, idx] = 1.0
    return bands


def per_member(v, ndim):
    """A per-member (B,) tensor shaped to broadcast against member-leading
    arrays of ``ndim`` dimensions; a Python number passes through."""
    if isinstance(v, torch.Tensor) and v.ndim:
        return v.reshape((-1,) + (1,) * (ndim - 1))
    return v


def axpy_bands(alpha, beta, J_bands):
    """``alpha * I + beta * J`` in banded form; ``beta`` may be a
    per-member (B,) tensor for bands ``(B, W, nvar, nvar, N)``."""
    W, nvar = J_bands.shape[-4], J_bands.shape[-3]
    A = per_member(beta, J_bands.ndim) * J_bands
    idx = torch.arange(nvar, device=J_bands.device)
    A[..., W // 2, idx, idx, :] += alpha
    return A


def mm(a, b):
    """Block product over (..., m, k, M) @ (..., k, n, M)."""
    return torch.einsum("...ikM,...kjM->...ijM", a, b)


def mv(a, b):
    """Block matvec (..., m, k, M) @ (..., k, M) -> (..., m, M)."""
    return torch.einsum("...ikM,...kM->...iM", a, b)


def small_inv(D):
    """Inverse of small (..., s, s, M) blocks: the closed forms and the
    block-Schur recursion of the reference's ``_small_inv``."""
    s = D.shape[-3]
    if s == 1:
        return 1.0 / D
    if s == 2:
        a, b = D[..., 0, 0, :], D[..., 0, 1, :]
        c, d = D[..., 1, 0, :], D[..., 1, 1, :]
        inv_det = 1.0 / (a * d - b * c)
        return torch.stack([torch.stack([d * inv_det, -b * inv_det], -2),
                            torch.stack([-c * inv_det, a * inv_det], -2)], -3)
    if s <= 8:
        p = s // 2
        A, B = D[..., :p, :p, :], D[..., :p, p:, :]
        C, Dd = D[..., p:, :p, :], D[..., p:, p:, :]
        Ainv = small_inv(A)
        AinvB = mm(Ainv, B)
        CAinv = mm(C, Ainv)
        Sinv = small_inv(Dd - mm(C, AinvB))
        top = torch.cat([Ainv + mm(AinvB, mm(Sinv, CAinv)), -mm(AinvB, Sinv)], -2)
        bot = torch.cat([-mm(Sinv, CAinv), Sinv], -2)
        return torch.cat([top, bot], -3)
    # contiguous like the closed forms: the plain PCR factor of interface
    # blocks above 8 is handed on to K4's wrappers
    return torch.linalg.inv(D.movedim(-1, -3)).movedim(-3, -1).contiguous()


def supernode_size(W: int, nvar: int):
    """(g, s): nodes per supernode and block size of a W-band system."""
    g = max(W // 2, 1)
    return g, nvar * g


def assemble_blocks(A_bands):
    """Block-tridiagonal (L, D, U), each (..., s, s, M), of the banded
    matrix ``A_bands (..., W, nvar, nvar, N)``: entry
    ``[a*nvar + m, b*nvar + n]`` of supernode I's block at block offset
    ``db`` is ``A[h + (b - a) + db*g, m, n, I*g + a]``.  Couplings that
    leave the grid (the periodic wrap of supernodes 0 and M-1) stay in
    L[..., 0] and U[..., M-1]; the chunked factor keeps or drops them."""
    *lead, W, nvar, _, N = A_bands.shape
    h = W // 2
    g, s = supernode_size(W, nvar)
    if N % g:
        raise ValueError(f"N = {N} is not a multiple of the supernode size "
                         f"g = {g}")
    M = N // g
    # (..., W, nvar, nvar, M, g) -> (g, ..., W, nvar, nvar, M)
    A_t = A_bands.reshape(*lead, W, nvar, nvar, M, g).movedim(-1, 0)
    zero = torch.zeros((*lead, M), dtype=A_bands.dtype, device=A_bands.device)

    def block(db):
        rows = []
        for a in range(g):
            for m in range(nvar):
                row = []
                for b in range(g):
                    for n in range(nvar):
                        delta = (b - a) + db * g
                        row.append(A_t[a][..., h + delta, m, n, :]
                                   if abs(delta) <= h else zero)
                rows.append(torch.stack(row, dim=-2))
        return torch.stack(rows, dim=-3)

    return block(-1), block(0), block(1)


def to_chunks(A, C: int):
    """(..., M) -> (Mc, ..., C): chunk c owns rows [c*Mc, (c+1)*Mc)."""
    M = A.shape[-1]
    return A.reshape(A.shape[:-1] + (C, M // C)).movedim(-1, 0)


def nodes_to_rows(u, g: int, C: int):
    """Node layout (..., nvar, N) -> chunk rows (Mc, ..., s, C), entry
    a*nvar + m of row j of chunk c = variable m at node (c*Mc + j)*g + a."""
    *lead, nvar, N = u.shape
    Mc = N // (g * C)
    rows = u.reshape(*lead, nvar, C, Mc, g).movedim(-2, 0).movedim(-1, -3)
    return rows.reshape(Mc, *lead, g * nvar, C)


def rows_to_nodes(rows, nvar: int):
    """Inverse of ``nodes_to_rows``."""
    Mc, *lead, s, C = rows.shape
    g = s // nvar
    u = rows.reshape(Mc, *lead, g, nvar, C).movedim(-3, -1).movedim(0, -2)
    return u.reshape(*lead, nvar, C * Mc * g)


class SpikeFactor(NamedTuple):
    """Chunked factorization: per-row Thomas operators and spikes
    (Mc, s, s, C), and the reduced interface system's couplings
    (2s, 2s, C)."""

    fac: torch.Tensor
    Dhinv: torch.Tensor
    DU: torch.Tensor
    W: torch.Tensor
    V: torch.Tensor
    Lred: torch.Tensor
    Ured: torch.Tensor


def chunked_factor(L, D, U, C: int, wrap: bool) -> SpikeFactor:
    """Wang/SPIKE factorization of a block-tridiagonal system in C chunks
    (blocks (..., s, s, M); each leading index is a system of its own).

    Chunk c's outer couplings Tl = L_0 (to chunk c-1) and Tr = U_{Mc-1}
    (to chunk c+1) leave the chunk's sweep and enter the reduced system.
    With ``wrap`` the couplings of chunk 0 and chunk C-1 are the periodic
    wrap and stay, so ``Lred[..., 0]`` and ``Ured[..., C-1]`` hold the
    ring's corner blocks; otherwise they are dropped."""
    Lc, Dc, Uc = (to_chunks(X, C).clone(memory_format=torch.contiguous_format)
                  for X in (L, D, U))
    Mc = Lc.shape[0]
    Tl, Tr = Lc[0].clone(), Uc[-1].clone()
    if not wrap:
        Tl[..., 0] = 0.0
        Tr[..., -1] = 0.0
    Lc[0] = 0.0
    Uc[-1] = 0.0
    fac = torch.empty_like(Lc)
    Dhinv = torch.empty_like(Lc)
    wt = torch.empty_like(Lc)
    dh = torch.zeros_like(Tl)
    for j in range(Mc):
        fac[j] = mm(Lc[j], dh)
        dh = small_inv(Dc[j] - mm(fac[j], Uc[j - 1] if j else torch.zeros_like(Tl)))
        Dhinv[j] = dh
        wt[j] = Tl if j == 0 else -mm(fac[j], wt[j - 1])
    DU = mm(Dhinv, Uc).contiguous()
    W = torch.empty_like(Lc)
    V = torch.empty_like(Lc)
    Wn = torch.zeros_like(Tl)
    Vn = torch.zeros_like(Tl)
    for j in reversed(range(Mc)):
        Wn = mm(Dhinv[j], wt[j]) - mm(DU[j], Wn)
        Vn = (mm(Dhinv[j], Tr) if j == Mc - 1 else 0.0) - mm(DU[j], Vn)
        W[j], V[j] = Wn, Vn
    *lead, s, _, _ = L.shape
    Lred = torch.zeros((*lead, 2 * s, 2 * s, C), dtype=L.dtype,
                       device=L.device)
    Ured = torch.zeros_like(Lred)
    Lred[..., :s, s:, :], Lred[..., s:, s:, :] = W[0], W[-1]
    Ured[..., :s, :s, :], Ured[..., s:, :s, :] = V[0], V[-1]
    if not wrap:
        Lred[..., 0] = 0.0
        Ured[..., -1] = 0.0
    return SpikeFactor(fac, Dhinv, DU, W, V, Lred, Ured)


def chunked_sweep(fac, Dhinv, DU, b):
    """Chunk-local forward and backward Thomas sweeps of the right-hand
    side rows b (Mc, s, C) -> y (Mc, s, C)."""
    Mc = b.shape[0]
    bt = torch.empty_like(b)
    prev = torch.zeros_like(b[0])
    for j in range(Mc):
        prev = bt[j] = b[j] - mv(fac[j], prev)
    y = torch.empty_like(b)
    nxt = torch.zeros_like(b[0])
    for j in reversed(range(Mc)):
        nxt = y[j] = mv(Dhinv[j], bt[j]) - mv(DU[j], nxt)
    return y


def _roll(a, d):
    """``out[..., c] = a[..., c - d]`` around the ring of chunks."""
    return torch.roll(a, d, dims=-1)


def pcr_factor(L, D, U, cyclic: bool):
    """PCR factorization of a block-tridiagonal system of (s2, s2, C)
    blocks: per-level (alpha, beta) and the final block inverse.

    Level d combines row c with rows c -+ d, so after ceil(log2 C) levels
    the system is block-diagonal.  Acyclic rows whose neighbour falls
    outside keep no coupling; cyclic (C a power of two) rows wrap, and the
    couplings left at distance C are the diagonal itself."""
    C = L.shape[-1]
    if cyclic and C & (C - 1):
        raise ValueError("cyclic PCR requires a power-of-two C")
    idx = torch.arange(C, device=L.device)
    alphas, betas = [], []
    d = 1
    while d < C:
        Dinv = small_inv(D)
        alpha = -mm(L, _roll(Dinv, d))
        beta = -mm(U, _roll(Dinv, -d))
        if not cyclic:
            alpha = torch.where(idx >= d, alpha, 0.0)
            beta = torch.where(idx < C - d, beta, 0.0)
        D = D + mm(alpha, _roll(U, d)) + mm(beta, _roll(L, -d))
        L, U = mm(alpha, _roll(L, d)), mm(beta, _roll(U, -d))
        alphas.append(alpha)
        betas.append(beta)
        d *= 2
    if cyclic:
        D = D + L + U
    return alphas, betas, small_inv(D)


def _levels(ops):
    """The per-level operators of a factor: a list, or a stacked tensor
    (..., nlev, s2, s2, C)."""
    return ops.unbind(-4) if isinstance(ops, torch.Tensor) else ops


def pcr_solve(alphas, betas, Dinv, b):
    """Solve with a ``pcr_factor`` result; b is (..., s2, C)."""
    d = 1
    for alpha, beta in zip(_levels(alphas), _levels(betas)):
        b = b + mv(alpha, _roll(b, d)) + mv(beta, _roll(b, -d))
        d *= 2
    return mv(Dinv, b)


def _vt(y):
    """``v_i^T y`` of the Woodbury closure for y (..., s2, C): i < s reads
    ``y[s+i]`` at chunk C-1, i >= s reads ``y[i-s]`` at chunk 0."""
    s = y.shape[-2] // 2
    return torch.cat([y[..., s:, -1], y[..., :s, 0]], dim=-1)


def woodbury_setup(alphas, betas, Dinv, Lred, Ured):
    """The rank-2s Woodbury closure of a periodic ring whose reduced system
    was factored acyclic (``pcr_factor`` with ``cyclic=False``, which
    ignores the corner blocks ``Lred[..., 0]`` and ``Ured[..., C-1]``):
    the reduced matrix is ``A0 + U V^T`` with the columns
    ``u_j = e_0 (x) Lred[:, s+j, 0]`` (j < s) and
    ``u_j = e_{C-1} (x) Ured[:, j-s, C-1]`` (j >= s), and ``v_i`` reading
    ``y[s+i]`` at chunk C-1 (i < s) and ``y[i-s]`` at chunk 0 (i >= s).
    Returns ``Z = A0^-1 U`` (..., 2s_j, 2s_v, C) and
    ``cap_inv = (I + V^T Z)^-1`` (..., 2s, 2s): the reference's
    ``folded._reduced_factor`` (one member)."""
    *lead, s2, _, C = Lred.shape
    s = s2 // 2
    U = Lred.new_zeros((*lead, s2, s2, C))
    U[..., :s, :, 0] = Lred[..., :, s:, 0].transpose(-1, -2)
    U[..., s:, :, C - 1] = Ured[..., :, :s, C - 1].transpose(-1, -2)
    # the 2s columns ride a column axis in front of the member's rows
    Z = pcr_solve([a.unsqueeze(-4) for a in _levels(alphas)],
                  [b.unsqueeze(-4) for b in _levels(betas)],
                  Dinv.unsqueeze(-4), U).contiguous()
    cap = (torch.eye(s2, dtype=Z.dtype, device=Z.device)
           + _vt(Z).transpose(-1, -2))
    return Z, small_inv(cap[..., None])[..., 0].contiguous()


def woodbury_correct(Z, cap_inv, y):
    """``y - Z (cap_inv V^T y)``: the acyclic reduced solution y
    (..., s2, C) corrected to the ring's (the reference's
    ``WrappedPcr.solve``)."""
    coef = torch.einsum("...ij,...j->...i", cap_inv, _vt(y))
    return y - torch.einsum("...j,...jrc->...rc", coef, Z)


def extract_wrap(A):
    """Move the periodic wrap couplings of ``A (..., W, nvar, nvar, N)``
    out of the bands, in place, and return them as the corner blocks
    (T, Bc), each (..., P, P) with P = nvar * h: T couples the first h
    nodes (rows, entry i * nvar + m) to the last h (columns, entry j * nvar
    + n of node N - h + j), Bc the last h to the first h (the reference's
    ``_extract_wrap``)."""
    *lead, W, nvar, _, N = A.shape
    h = W // 2
    P = nvar * h
    T = A.new_zeros((*lead, P, P))
    Bc = A.new_zeros((*lead, P, P))
    for i in range(h):
        for k in range(h - i):  # node i + k - h < 0 wraps to N + i + k - h
            T[..., i * nvar:(i + 1) * nvar, (i + k) * nvar:(i + k + 1) * nvar] = \
                A[..., k, :, :, i]
            A[..., k, :, :, i] = 0.0
    for di in range(h):
        i = N - 1 - di
        for k in range(W - 1, W - 1 - (h - di), -1):  # node i + k - h >= N
            j, r = i + k - h - N, h - 1 - di
            Bc[..., r * nvar:(r + 1) * nvar, j * nvar:(j + 1) * nvar] = \
                A[..., k, :, :, i]
            A[..., k, :, :, i] = 0.0
    return T, Bc


def _corner_cols(X, nvar):
    """(..., P, P) corner block -> its P columns as (..., P, nvar, h)
    node-layout slabs: column c, variable m, node i holds X[i*nvar + m, c]."""
    *lead, P, _ = X.shape
    h = P // nvar
    return X.transpose(-1, -2).reshape(*lead, P, h, nvar).transpose(-1, -2)


def ring_columns(T, Bc, nvar, N):
    """The 2P columns ``Uw = [E_top T | E_end Bc]`` of the ring's
    correction in the node layout, (..., 2P, nvar, N)."""
    *lead, P, _ = T.shape
    h = P // nvar
    cols = T.new_zeros((*lead, 2 * P, nvar, N))
    cols[..., :P, :, :h] = _corner_cols(T, nvar)
    cols[..., P:, :, N - h:] = _corner_cols(Bc, nvar)
    return cols


def _vt_nodes(y, h):
    """``Vw^T y = [y at the last h nodes ; y at the first h]`` of node-layout
    y (..., nvar, N), each entry node-major (j * nvar + m)."""
    end = y[..., y.shape[-1] - h:].transpose(-1, -2)
    top = y[..., :h].transpose(-1, -2)
    return torch.cat([end.reshape(*end.shape[:-2], -1),
                      top.reshape(*top.shape[:-2], -1)], dim=-1)


def ring_setup(Z, h):
    """``(Z, cap_inv)`` of the ring's correction from ``Z = A_tri^-1 Uw``
    (..., 2P, nvar, N): ``cap_inv = (I + Vw^T Z)^-1`` (..., 2P, 2P)."""
    VtZ = _vt_nodes(Z, h)  # (..., 2P columns, 2P rows)
    P2 = VtZ.shape[-1]
    cap = torch.eye(P2, dtype=Z.dtype, device=Z.device) + VtZ.transpose(-1, -2)
    return Z, small_inv(cap[..., None])[..., 0].contiguous()


def ring_correct(Z, cap_inv, y, h):
    """``y - Z (cap_inv Vw^T y)``: the solution y (..., nvar, N) of the
    system without its wrap corrected to the ring's (the reference's
    ``BandedFactorization.solve``)."""
    coef = torch.einsum("...ij,...j->...i", cap_inv, _vt_nodes(y, h))
    return y - torch.einsum("...cni,...c->...ni", Z, coef)
