// K7: the block-banded matrix-vector product of B members,
//   out[b, m, i] = scale_b * sum_k sum_n A[b, k, m, n, i] * v[b, n, i + k - h],
// h = W / 2, in the node layout: bands (B, W, nvar, nvar, N), v and out
// (B, nvar, N); one grid is B = 1.  In edge mode a column outside [0, N)
// contributes zero (the compiler has already folded the ghost nodes into
// the bands); on a ring the column index wraps.  scale is one number, or
// one value per member read from device memory (an ensemble's g00 * dt).
//
// Replaces, on the TPU: ops/pallas_stencil.py banded_matvec_pallas (the
// node layout, reached through ops/banded.py banded_matvec) and, as the
// same function in the TPU's folded layout, ops/folded.py matvec_folded.
// The ROW schemes' residual refinement (r = rhs - k + g00 dt J k) and the
// right-hand side of Theta with a custom solver (dt F - theta dt J u + u)
// call it.
//
// Bound: device-memory bandwidth.  Each launch reads the bands once
// (W nvar^2 values per node), v and writes out: B N (W nvar^2 + 2 nvar)
// values, 56 MB in f64 at KS N = 10^6 (W = 5, nvar = 1), 16.7 us at the
// card's 3.35 TB/s; 2 W nvar^2 operations per node are far below the
// arithmetic peaks.
//
// Design (simple first): one thread per (node, member), blockIdx.y the
// member; each thread loops over the output variable m and walks the band
// row (matvec.cuh, shared with K8 and K6's mixed entry).  The bands are
// node-minor, so the 32 threads of a warp read 32 neighbouring values of
// each band: every band byte is read once, coalesced.  The v window of a
// warp (32 + W - 1 nodes per variable) is read through L1, where
// neighbouring threads find each other's values.
#include "common.cuh"
#include "matvec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMembers = 65535;  // gridDim.y

template <typename T>
__global__ void matvec_kernel(const T* __restrict__ bands, const T* __restrict__ v,
                              T* __restrict__ out, const T* __restrict__ scale_b, T scale,
                              int W, int nvar, long N, int periodic) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const long b = blockIdx.y;
  const long n = (long)nvar * N;
  const T* A = bands + b * W * nvar * n;
  const T* vb = v + b * n;
  const T sc = scale_b ? scale_b[b] : scale;
  for (int m = 0; m < nvar; ++m)
    out[b * n + m * N + i] = sc * tf::band_row(A, vb, W, nvar, N, periodic, i, m,
                                               tf::ReadOnlyLoad());
}

template <typename T>
int matvec(const T* bands, const T* v, T* out, const T* scale_b, int W, int nvar, int N,
           int B, int periodic, double scale, void* stream) {
  if (W < 1 || nvar < 1 || N < 0 || B < 1 || B > kMaxMembers)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const dim3 grid((unsigned)(((long)N + kThreads - 1) / kThreads), (unsigned)B);
  matvec_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bands, v, out, scale_b, T(scale), W, nvar, N, periodic);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scale_b: a device address of B values, or 0 for the number scale.
#define TF_ENTRIES(SUFFIX, T)                                                             \
  extern "C" int tf_matvec_##SUFFIX(const void* bands, const void* v, void* out,         \
                                    const void* scale_b, int W, int nvar, int N, int B,  \
                                    int periodic, double scale, void* stream) {          \
    return matvec<T>(static_cast<const T*>(bands), static_cast<const T*>(v),              \
                     static_cast<T*>(out), static_cast<const T*>(scale_b), W, nvar, N, B, \
                     periodic, scale, stream);                                            \
  }

TF_ENTRIES(f32, float)
TF_ENTRIES(f64, double)
