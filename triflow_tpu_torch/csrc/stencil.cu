// K1: the stencil RHS F and the banded Jacobian J of one model, generated
// per model from its SymPy expressions (ops/stencil.py prints them into
// the block marked GENERATED below) and compiled at first use.  The
// per-node bodies live in stencil.cuh, shared with K6 (megastep.cu).
//
// Replaces, on the TPU: ops/folded.py eval_F_folded (the theta step's
// dt * F and, in its scale/bias mode, the ROW stage right-hand side
// g00 dt F(u_i) + csum) and, for J, ops/folded.py eval_J_folded and ops/pallas_stencil.py
// eval_F / eval_J_bands, which compute the same functions in other layouts.
//
// One thread per node i, in the reference's node layout: u (nvar, N),
// helpers (nhelp, N), parameters (npar, N), x (N,).  The thread gathers the
// argument vector of the expressions (x, every variable at every stencil
// offset, the parameters, dx) with the boundary closure applied to the
// index (periodic: modular; edge: clamped, as compiler.shift does), then
//   F entry: out[m, i] = scale * F_m (+ bias[m, i] when a bias is given;
//            a null bias pointer means none, as add_to in K3)
//   J entry: bands[k, m, n, i] = dF_m(i) / du_n(i + k - h), shape
//            (W, nvar, nvar, N), with the edge fold of compiler.fold_edges
//            applied on the boundary nodes when not periodic.
// dx = (x[N-1] - x[0]) / (N - 1) is computed in the kernel, so the caller
// never reads the grid back to the host.
//
// Bound: a stencil of a few flops per loaded value, so both entries are
// bound by device-memory bandwidth: each reads the (nvar + nhelp) rows W
// times (neighbours hit in L1/L2) and writes nvar (F) or W * nvar^2 (J)
// rows once, all coalesced.  The bias costs one more coalesced read of
// nvar rows, which saves the separate pass of the stage algebra that would
// re-read F and the bias and write the sum.
#include <cuda_runtime.h>

extern "C" const char* tf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ---- GENERATED: model constants and expression bodies ----
// @GENERATED@
// ---- end of generated block ----

#include "stencil.cuh"

namespace {

template <typename T>
__global__ void stencil_F_kernel(const T* __restrict__ u, const T* __restrict__ hlp,
                                 const T* __restrict__ par, const T* __restrict__ x,
                                 const T* __restrict__ bias, T* __restrict__ out, long N,
                                 int periodic, T scale) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  tf::stencil_F_node<T>(u, hlp, par, x, bias, out, N, periodic, scale, i);
}

template <typename T>
__global__ void stencil_J_kernel(const T* __restrict__ u, const T* __restrict__ hlp,
                                 const T* __restrict__ par, const T* __restrict__ x,
                                 T* __restrict__ bands, long N, int periodic) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  tf::stencil_J_node<T>(u, hlp, par, x, bands, N, periodic, i);
}

template <typename T>
int launch_F(const T* u, const T* hlp, const T* par, const T* x, const T* bias, T* out,
             long N, int periodic, double scale, cudaStream_t stream) {
  const int threads = 256;
  const long blocks = (N + threads - 1) / threads;
  stencil_F_kernel<T><<<blocks, threads, 0, stream>>>(u, hlp, par, x, bias, out, N,
                                                      periodic, T(scale));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_J(const T* u, const T* hlp, const T* par, const T* x, T* bands, long N,
             int periodic, cudaStream_t stream) {
  const int threads = 256;
  const long blocks = (N + threads - 1) / threads;
  stencil_J_kernel<T><<<blocks, threads, 0, stream>>>(u, hlp, par, x, bands, N, periodic);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define TF_ENTRIES(SUFFIX, T)                                                               \
  extern "C" int tf_stencil_F_##SUFFIX(const void* u, const void* hlp, const void* par,    \
                                       const void* x, const void* bias, void* out, int N,  \
                                       int periodic, double scale, void* stream) {         \
    return launch_F<T>(static_cast<const T*>(u), static_cast<const T*>(hlp),               \
                       static_cast<const T*>(par), static_cast<const T*>(x),               \
                       static_cast<const T*>(bias), static_cast<T*>(out), N, periodic,     \
                       scale, static_cast<cudaStream_t>(stream));                          \
  }                                                                                        \
  extern "C" int tf_stencil_J_##SUFFIX(const void* u, const void* hlp, const void* par,    \
                                       const void* x, void* bands, int N, int periodic,    \
                                       void* stream) {                                     \
    return launch_J<T>(static_cast<const T*>(u), static_cast<const T*>(hlp),               \
                       static_cast<const T*>(par), static_cast<const T*>(x),               \
                       static_cast<T*>(bands), N, periodic,                                \
                       static_cast<cudaStream_t>(stream));                                 \
  }

TF_ENTRIES(f32, float)
TF_ENTRIES(f64, double)
