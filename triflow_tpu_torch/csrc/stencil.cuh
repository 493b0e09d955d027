// The per-node bodies of K1 (stencil.cu), shared with K6 (megastep.cu).
// Include after the generated block that defines TF_NVAR, TF_NHELP,
// TF_NPAR, TF_H, TF_NARGS, tf_F and tf_J; stencil.cu describes the layouts,
// the boundary closure and the edge fold.  No __restrict__ on the
// pointers: K6 evaluates F at stage states it wrote in the same launch, and
// reads them through a callable (stencil_F_vals, stencil_J_vals) where they
// are spread over a cluster's shared memory.
#pragma once

namespace tf {

constexpr int kW = 2 * TF_H + 1;
constexpr int kNJ = kW * TF_NVAR * TF_NVAR;

// uval(v, j, off): variable v at node j, the neighbour at stencil offset
// off (a stored row read at j, or K1.F_terms's tile read at off;
// stencil.cu)
template <typename T, typename UVal>
__device__ __forceinline__ void gather(T* a, long i, long N, int periodic, UVal uval,
                                       const T* hlp, const T* par, const T* x) {
  int idx = 0;
  a[idx++] = x[i];
#pragma unroll
  for (int off = -TF_H; off <= TF_H; ++off) {
    long j = i + off;
    if (periodic) {
      j %= N;
      if (j < 0) j += N;
    } else {
      j = j < 0 ? 0 : (j > N - 1 ? N - 1 : j);
    }
#pragma unroll
    for (int v = 0; v < TF_NVAR; ++v) a[idx++] = uval(v, j, off);
#pragma unroll
    for (int v = 0; v < TF_NHELP; ++v) a[idx++] = hlp[v * N + j];
  }
#pragma unroll
  for (int q = 0; q < TF_NPAR; ++q) a[idx++] = par[q * N + i];
  a[idx] = (x[N - 1] - x[0]) / T(N - 1);
}

// f[m] = F_m(i), the state read through uval(v, j, off) (K6 reads it from
// the cluster's shared memory)
template <typename T, typename UVal>
__device__ __forceinline__ void stencil_F_vals(UVal uval, const T* hlp, const T* par,
                                               const T* x, long N, int periodic, long i,
                                               T (&f)[TF_NVAR]) {
  T a[TF_NARGS];
  gather(a, i, N, periodic, uval, hlp, par, x);
  tf_F(a, f);
}

// out[m, i] = scale * F_m(i) (+ bias[m, i] when bias is not null)
template <typename T>
__device__ __forceinline__ void stencil_F_node(const T* u, const T* hlp, const T* par,
                                               const T* x, const T* bias, T* out, long N,
                                               int periodic, T scale, long i) {
  T f[TF_NVAR];
  stencil_F_vals<T>([&](int v, long j, int) { return u[v * N + j]; }, hlp, par, x, N, periodic,
                    i, f);
#pragma unroll
  for (int m = 0; m < TF_NVAR; ++m) {
    const T v = scale * f[m];
    out[m * N + i] = bias ? v + bias[m * N + i] : v;
  }
}

// The edge fold of node i's J entries b[(k, m, n)] (not periodic): the
// ghost-node dependencies fold onto the boundary columns, in the order of
// compiler.fold_edges; shared by the per-node J (stencil_J_vals) and K1's
// tiled J entry (stencil.cu), so that the two round alike
template <typename T>
__device__ __forceinline__ void fold_edges(T (&b)[kNJ], long i, long N) {
  constexpr int NN = TF_NVAR * TF_NVAR;
#pragma unroll
  for (int ii = 0; ii < TF_H; ++ii) {
    if (i == ii) {
#pragma unroll
      for (int k = 0; k < TF_H - ii; ++k)
#pragma unroll
        for (int e = 0; e < NN; ++e) {
          b[(TF_H - ii) * NN + e] += b[k * NN + e];
          b[k * NN + e] = T(0);
        }
    }
    if (i == N - 1 - ii) {
#pragma unroll
      for (int k = 0; k < TF_H - ii; ++k) {
        const int koff = kW - 1 - k;
#pragma unroll
        for (int e = 0; e < NN; ++e) {
          b[(TF_H + ii) * NN + e] += b[koff * NN + e];
          b[koff * NN + e] = T(0);
        }
      }
    }
  }
}

// b[(k, m, n)] = dF_m(i) / du_n(i + k - h), edge-folded when not periodic,
// the state read through uval(v, j, off)
template <typename T, typename UVal>
__device__ __forceinline__ void stencil_J_vals(UVal uval, const T* hlp, const T* par,
                                               const T* x, long N, int periodic, long i,
                                               T (&b)[kNJ]) {
  T a[TF_NARGS];
#pragma unroll
  for (int e = 0; e < kNJ; ++e) b[e] = T(0);
  gather(a, i, N, periodic, uval, hlp, par, x);
  tf_J(a, b);
  if (!periodic) fold_edges(b, i, N);
}

// bands[k, m, n, i] = dF_m(i) / du_n(i + k - h), edge-folded when not periodic
template <typename T>
__device__ __forceinline__ void stencil_J_node(const T* u, const T* hlp, const T* par,
                                               const T* x, T* bands, long N, int periodic,
                                               long i) {
  T b[kNJ];
  stencil_J_vals<T>([&](int v, long j, int) { return u[v * N + j]; }, hlp, par, x, N, periodic,
                    i, b);
#pragma unroll
  for (int e = 0; e < kNJ; ++e) bands[e * N + i] = b[e];
}

}  // namespace tf
