// The per-chunk body of K2 (spike_factor.cu), shared with K6 (megastep.cu).
//
// One call walks chunk c of the block-tridiagonal system of
// alpha*I + beta*J through the forward and backward sweeps and writes the
// chunk's per-row operators and its rows of the reduced interface system;
// spike_factor.cu describes the algebra and the layout.  K6 calls it on its
// CTA's share of a member's chunks: `bands` of Nb nodes (its own), the
// chunk rows and the interface rows at stride C of that share, chunk c of
// it; edge_l / edge_u: the chunk is the grid's first / last and the grid
// does not wrap (its outer coupling is zero).  The pointers carry no
// __restrict__: K6 reads `bands` after writing it in the same launch, and a
// read-only (non-coherent) load there could return stale data.
#pragma once

#include "common.cuh"

namespace tf {

template <typename T, int S>
__device__ __forceinline__ Blk<T, S> band_block(const T* bands, long I, int dblock, T alpha,
                                               T beta, int N, int nvar, int g, int h) {
  Blk<T, S> out;
#pragma unroll
  for (int r = 0; r < S; ++r) {
    const int a = r / nvar, m = r % nvar;
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int b = q / nvar, n = q % nvar;
      const int delta = (b - a) + dblock * g;
      T val = T(0);
      if (delta >= -h && delta <= h)
        val = beta * bands[((long)((h + delta) * nvar + m) * nvar + n) * N + I * g + a];
      if (dblock == 0 && r == q) val += alpha;
      out.v[r][q] = val;
    }
  }
  return out;
}

template <typename T, int S>
__device__ __forceinline__ Blk<T, S> sub(const Blk<T, S>& a, const Blk<T, S>& b) {
  Blk<T, S> c;
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j) c.v[i][j] = a.v[i][j] - b.v[i][j];
  return c;
}

template <typename T, int S>
__device__ __forceinline__ void spike_factor_chunk(const T* bands, T* fac, T* Dhinv, T* DU,
                                                   T* Wsp, T* Vsp, T* Lred, T* Ured, int Nb,
                                                   int nvar, int g, int h, int Mc, int C,
                                                   bool edge_l, bool edge_u, T alpha, T beta,
                                                   int c) {
  Blk<T, S> dh, up, wt, Tl, Tr;
  zero(dh);
  zero(up);
  zero(wt);
  zero(Tl);
  zero(Tr);
  for (int j = 0; j < Mc; ++j) {
    const long I = (long)c * Mc + j;
    Blk<T, S> L = band_block<T, S>(bands, I, -1, alpha, beta, Nb, nvar, g, h);
    Blk<T, S> D = band_block<T, S>(bands, I, 0, alpha, beta, Nb, nvar, g, h);
    Blk<T, S> U = band_block<T, S>(bands, I, 1, alpha, beta, Nb, nvar, g, h);
    if (j == 0) {
      Tl = L;
      if (edge_l) zero(Tl);
      zero(L);
    }
    if (j == Mc - 1) {
      Tr = U;
      if (edge_u) zero(Tr);
      zero(U);
    }
    const Blk<T, S> f = mm(L, dh);
    dh = inv(sub(D, mm(f, up)));
    if (j == 0) {
      wt = Tl;
    } else {
      Blk<T, S> z;
      zero(z);
      wt = sub(z, mm(f, wt));
    }
    store_blk(fac, j, c, C, f);
    store_blk(Dhinv, j, c, C, dh);
    store_blk(Wsp, j, c, C, wt);  // wt_j, overwritten by W_j below
    store_blk(DU, j, c, C, U);    // U_j, overwritten by Dh_j U_j below
    up = U;
  }

  Blk<T, S> Wn, Vn, W0, V0, Wl, Vl;
  zero(Wn);
  zero(Vn);
  for (int j = Mc - 1; j >= 0; --j) {
    const Blk<T, S> dhj = load_blk<T, S>(Dhinv, j, c, C);
    const Blk<T, S> du = mm(dhj, load_blk<T, S>(DU, j, c, C));
    const Blk<T, S> W = sub(mm(dhj, load_blk<T, S>(Wsp, j, c, C)), mm(du, Wn));
    Blk<T, S> V;
    if (j == Mc - 1) {
      V = mm(dhj, Tr);
      Wl = W;
      Vl = V;
    } else {
      Blk<T, S> z;
      zero(z);
      V = sub(z, mm(du, Vn));
    }
    store_blk(DU, j, c, C, du);
    store_blk(Wsp, j, c, C, W);
    store_blk(Vsp, j, c, C, V);
    Wn = W;
    Vn = V;
  }
  W0 = Wn;
  V0 = Vn;

  const bool keep_l = !edge_l;
  const bool keep_u = !edge_u;
#pragma unroll
  for (int r = 0; r < 2 * S; ++r)
#pragma unroll
    for (int q = 0; q < 2 * S; ++q) {
      T lv = T(0), uv = T(0);
      if (q >= S) lv = (r < S) ? W0.v[r][q - S] : Wl.v[r - S][q - S];
      if (q < S) uv = (r < S) ? V0.v[r][q] : Vl.v[r - S][q];
      Lred[((long)r * 2 * S + q) * C + c] = keep_l ? lv : T(0);
      Ured[((long)r * 2 * S + q) * C + c] = keep_u ? uv : T(0);
    }
}

}  // namespace tf
