// K8: the residual of the mixed-precision stage solve, rounded to float,
//   r32[b, m, i] = float((rhs[b, m, i] - k[b, m, i]) + coef_b * (A k)[b, m, i]),
//   (A k)[b, m, i] = sum_k sum_n A[b, k, m, n, i] * k[b, n, i + k - h],
// for double bands A (B, W, nvar, nvar, N), double k and rhs (B, nvar, N)
// and a float output (B, nvar, N); one grid is B = 1.  coef is one number
// or one value per member read from device memory (an ensemble's
// g00 * dt).  In edge mode a column outside [0, N) contributes zero, on a
// ring the column index wraps (matvec.cuh).
//
// Replaces, on the TPU: ops/folded.py matvec_df_folded (the df64 product
// J k as error-free-transform chains on (hi, lo) float pairs in the folded
// layout) and ops/banded_df.py banded_matvec_df (the same in the node
// layout), with the residual (rhs - k) + coef * J k that the reference's
// df64_mixed_solve computes around them (core/schemes.py
// _df64_mixed_solver) and the rounding of r.hi + r.lo to float that feeds
// the float preconditioner.  Hopper has native fp64, so the df64 pairs
// become doubles: the product in double carries at least the pairs'
// ~2^-48 precision, and the one rounding is the float output the
// preconditioner solves with.  That pair of types (double in, float out)
// is why the residual is a kernel of its own and not an instance of K7.
//
// Bound: device-memory bandwidth.  Each launch reads the bands once
// (W nvar^2 doubles per node), k and rhs once, and writes r32:
// B N (8 W nvar^2 + 16 nvar + 4 nvar) bytes, 60 MB at KS N = 10^6
// (W = 5, nvar = 1), 17.9 us at the card's 3.35 TB/s; 2 W nvar^2 + 3
// operations per row are far below the double peak.
//
// Design (simple first, K7's): one thread per (node, member), blockIdx.y
// the member; each thread walks its output rows through matvec.cuh's band
// walk and writes the rounded residual.  The bands are node-minor, so the
// 32 threads of a warp read 32 neighbouring values of each band, once and
// coalesced; the k window of a warp is read through L1.
#include "common.cuh"
#include "matvec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMembers = 65535;  // gridDim.y

__global__ void mixed_residual_kernel(const double* __restrict__ bands,
                                      const double* __restrict__ k,
                                      const double* __restrict__ rhs, float* __restrict__ r,
                                      const double* __restrict__ coef_b, double coef, int W,
                                      int nvar, long N, int periodic) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const long b = blockIdx.y;
  const long n = (long)nvar * N;
  const double* A = bands + b * W * nvar * n;
  const double* kb = k + b * n;
  const double c = coef_b ? coef_b[b] : coef;
  for (int m = 0; m < nvar; ++m) {
    const long e = b * n + m * N + i;
    const double Ak = tf::band_row(A, kb, W, nvar, N, periodic, i, m, tf::ReadOnlyLoad());
    r[e] = static_cast<float>((rhs[e] - k[e]) + c * Ak);
  }
}

int mixed_residual(const double* bands, const double* k, const double* rhs, float* r,
                   const double* coef_b, int W, int nvar, int N, int B, int periodic,
                   double coef, void* stream) {
  if (W < 1 || nvar < 1 || N < 0 || B < 1 || B > kMaxMembers)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const dim3 grid((unsigned)(((long)N + kThreads - 1) / kThreads), (unsigned)B);
  mixed_residual_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bands, k, rhs, r, coef_b, coef, W, nvar, N, periodic);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coef_b: a device address of B doubles, or 0 for the number coef.
extern "C" int tf_mixed_residual_f64(const void* bands, const void* k, const void* rhs,
                                     void* r, const void* coef_b, int W, int nvar, int N,
                                     int B, int periodic, double coef, void* stream) {
  return mixed_residual(static_cast<const double*>(bands), static_cast<const double*>(k),
                        static_cast<const double*>(rhs), static_cast<float*>(r),
                        static_cast<const double*>(coef_b), W, nvar, N, B, periodic, coef,
                        stream);
}
