"""Host-facing routines: ``model.F(fields, pars)`` returns the interleaved
flat RHS as a numpy array and ``model.J(fields, pars)`` the Jacobian as a
scipy CSC matrix, as in ``triflow_tpu.core.routines``."""

from __future__ import annotations

import numpy as np
import sympy as sp


def bands_to_csc(bands, periodic: bool):
    """The (N*nvar, N*nvar) scipy CSC matrix of banded ``(W, nvar, nvar,
    N)`` entries, interleaved node-major (row = i * nvar + m).  Host-only:
    for tests and the J routine."""
    import scipy.sparse as sps

    bands = np.asarray(bands)
    W, nvar, _, N = bands.shape
    h = W // 2
    rows, cols, vals = [], [], []
    for k in range(W):
        for m in range(nvar):
            for n in range(nvar):
                band = bands[k, m, n]
                i = np.arange(N)
                j = i + (k - h)
                if periodic:
                    j = j % N
                else:
                    mask = (j >= 0) & (j < N)
                    i, j, band = i[mask], j[mask], band[mask]
                rows.append(i * nvar + m)
                cols.append(j * nvar + n)
                vals.append(band)
    return sps.csc_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(N * nvar, N * nvar))


class ModelRoutine:
    def __init__(self, matrix, args, pars, backend):
        self.pars = list(pars) + ["periodic"]
        self.matrix = matrix
        self.args = args
        self._backend = backend

    def _prepare(self, fields, pars):
        backend = self._backend
        u, helpers, x = backend.split_fields(fields)
        pstack = backend.pack_pars(pars, x)
        return u, helpers, pstack, x, bool(pars["periodic"])

    def __repr__(self):
        return sp.Matrix(np.atleast_1d(self.matrix).tolist()).__repr__()


class F_Routine(ModelRoutine):
    """RHS as an interleaved flat vector ``[F_U(0), F_V(0), F_U(1), ...]``."""

    def __call__(self, fields, pars):
        u, helpers, pstack, x, periodic = self._prepare(fields, pars)
        F = self._backend.F(u, helpers, pstack, x, periodic=periodic)
        return F.T.reshape(-1).cpu().numpy()


class J_Routine(ModelRoutine):
    """Jacobian as scipy CSC (``sparse=True``) or a dense matrix."""

    def __call__(self, fields, pars, sparse=True):
        u, helpers, pstack, x, periodic = self._prepare(fields, pars)
        bands = self._backend.J_bands(u, helpers, pstack, x, periodic=periodic)
        J = bands_to_csc(bands.cpu().numpy(), periodic)
        return J if sparse else J.todense()
