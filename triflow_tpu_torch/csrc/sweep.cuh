// K6's (megastep.cu) bodies of K3's two entries (spike_solve.cu, which
// describes the algebra and runs staged and tiled kernels of its own): the
// chunk-local Thomas sweep of one chunk and the spike correction of one
// node.  No __restrict__ on the pointers: K6 reads buffers it wrote earlier
// in the same launch.
#pragma once

#include "common.cuh"

namespace tf {

template <typename T, int S>
__device__ __forceinline__ void thomas_sweep_chunk(const T* fac, const T* Dhinv, const T* DU,
                                                   const T* rhs, T* y, T* yred, int N,
                                                   int nvar, int g, int Mc, int C, int c) {
  T bt[S], t[S];
#pragma unroll
  for (int r = 0; r < S; ++r) bt[r] = T(0);
  for (int j = 0; j < Mc; ++j) {
    const long base = ((long)c * Mc + j) * g;
    mv(load_blk<T, S>(fac, j, c, C), bt, t);
#pragma unroll
    for (int r = 0; r < S; ++r) {
      const long at = (long)(r % nvar) * N + base + r / nvar;
      bt[r] = rhs[at] - t[r];
      y[at] = bt[r];
    }
  }
  T yn[S], p[S];
#pragma unroll
  for (int r = 0; r < S; ++r) yn[r] = T(0);
  for (int j = Mc - 1; j >= 0; --j) {
    const long base = ((long)c * Mc + j) * g;
#pragma unroll
    for (int r = 0; r < S; ++r) bt[r] = y[(long)(r % nvar) * N + base + r / nvar];
    mv(load_blk<T, S>(Dhinv, j, c, C), bt, p);
    mv(load_blk<T, S>(DU, j, c, C), yn, t);
#pragma unroll
    for (int r = 0; r < S; ++r) {
      yn[r] = p[r] - t[r];
      y[(long)(r % nvar) * N + base + r / nvar] = yn[r];
      if (j == Mc - 1) yred[(long)(S + r) * C + c] = yn[r];
    }
  }
#pragma unroll
  for (int r = 0; r < S; ++r) yred[(long)r * C + c] = yn[r];
}

template <typename T, int S>
__device__ __forceinline__ void spike_correct_node(const T* y, const T* Wsp, const T* Vsp,
                                                   const T* xm1, const T* xp1,
                                                   const T* add_to, T* out, int N, int nvar,
                                                   int g, int Mc, int C, long i) {
  const long I = i / g;
  const int a = (int)(i % g);
  const int c = (int)(I / Mc);
  const long j = I % Mc;
  for (int m = 0; m < nvar; ++m) {
    const int r = a * nvar + m;
    T corr = T(0);
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const long at = ((j * S + r) * S + q) * C + c;
      corr += Wsp[at] * xm1[(long)q * C + c] + Vsp[at] * xp1[(long)q * C + c];
    }
    const long k = (long)m * N + i;
    const T x = y[k] - corr;
    out[k] = add_to ? add_to[k] + x : x;
  }
}

}  // namespace tf
