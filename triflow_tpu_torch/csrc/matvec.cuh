// The band walk of one output row of a block-banded product, shared by
// K7's per-node body (matvec.cu: matvec_nodes_kernel, on no path) and K8
// (mixed_residual.cu); K7's tiled body and K6's mixed entry (megastep.cu:
// band_row_at) sum in the same order:
//   sum_k sum_q A[k, m, q, i] * v[q, i + k - h],   h = W / 2,
// for one grid's bands A (W, nvar, nvar, N) and vector v (nvar, N) in the
// node layout.  In edge mode a column outside [0, N) contributes zero (the
// compiler has already folded the ghost nodes into the bands); on a ring
// the column index wraps.  The terms are summed in (k, q) order.
//
// Every load goes through `load`: ReadOnlyLoad (__ldg, the read-only data
// path), as A and v do not change during the launch (the walk inlined
// with plain loads ran K7's float32 per-node instance 7 % slower on an
// H100, PERF.md).
#pragma once

namespace tf {

struct ReadOnlyLoad {
  template <typename T>
  __device__ __forceinline__ T operator()(const T* p) const { return __ldg(p); }
};

template <typename T, typename Load>
__device__ __forceinline__ T band_row(const T* A, const T* v, int W, int nvar, long N,
                                      int periodic, long i, int m, Load load = Load()) {
  const long n = (long)nvar * N;
  const int h = W / 2;
  T acc = T(0);
  for (int k = 0; k < W; ++k) {
    long j = i + k - h;
    if (j < 0 || j >= N) {
      if (!periodic) continue;
      j = ((j % N) + N) % N;
    }
    const T* Akm = A + (long)(k * nvar + m) * n;
    for (int q = 0; q < nvar; ++q) acc += load(Akm + q * N + i) * load(v + q * N + j);
  }
  return acc;
}

}  // namespace tf
