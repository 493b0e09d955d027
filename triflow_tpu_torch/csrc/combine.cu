// K5: R linear combinations of A same-shape arrays in one pass,
//   out[k][i] = sum_j rows[k][j] * in[j][i],   k < R, j < A,
// the stage algebra of one Rosenbrock step (stage inputs u_i with their
// bias sums, and the final (u_new, u_new - u_pred) pair).
//
// Replaces, on the TPU: ops/folded.py combine_folded, which fetched each
// input block into VMEM once and wrote every output once.
//
// One grid-stride loop over the n = nvar * N elements; each thread reads
// the A inputs of its element once and writes the R outputs once.  The
// input and output pointers and the R x A coefficients travel by value in
// one small struct (kernel parameter space), the coefficients as T, so the
// float instantiation never computes in double.  Each coefficient's role is
// decided on the host from its double value, as the reference decides it:
// 0 skips the column, 1 adds the input unmultiplied, anything else
// multiplies.  Products and sums are rounded one at a time (__fmul_rn,
// __fadd_rn and their double twins are never contracted into an FMA), in
// the reference's column order, so the kernel computes exactly what the
// plain PyTorch loop computes.
//
// Bound: device-memory bandwidth.  (A + R) * n * sizeof(T) bytes at the
// card's 3.35 TB/s; the arithmetic is at most 2 * A * R operations per
// element.  At N = 2^20, nvar = 1, A = 7, R = 2 that is 37.7 MB in f32
// (11.3 us) and 75.5 MB in f64 (22.5 us).
#include "common.cuh"

namespace {

constexpr int kMaxA = 8;
constexpr int kMaxR = 2;

using tf::kScale;
using tf::kSkip;
using tf::kUnit;

template <typename T>
struct Args {
  const T* in[kMaxA];
  T* out[kMaxR];
  T coef[kMaxR][kMaxA];
  unsigned char role[kMaxR][kMaxA];
};

template <typename T, int A, int R>
__global__ void combine_kernel(const Args<T> args, long n) {
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    T v[A];
#pragma unroll
    for (int j = 0; j < A; ++j) v[j] = args.in[j][i];
#pragma unroll
    for (int k = 0; k < R; ++k)
      args.out[k][i] = tf::lin_comb(A, args.coef[k], args.role[k], [&](int j) { return v[j]; });
  }
}

template <typename T, int A, int R>
void launch(const Args<T>& args, long n, int blocks, cudaStream_t stream) {
  combine_kernel<T, A, R><<<blocks, 256, 0, stream>>>(args, n);
}

template <typename T>
int combine(const void* in_ptrs, const void* out_ptrs, const void* coefs, int A, int R, int n,
            void* stream) {
  if (A < 1 || A > kMaxA || R < 1 || R > kMaxR || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Args<T> args = {};
  const unsigned long long* ins = static_cast<const unsigned long long*>(in_ptrs);
  const unsigned long long* outs = static_cast<const unsigned long long*>(out_ptrs);
  const double* c = static_cast<const double*>(coefs);
  for (int j = 0; j < A; ++j) args.in[j] = reinterpret_cast<const T*>(ins[j]);
  for (int k = 0; k < R; ++k) {
    args.out[k] = reinterpret_cast<T*>(outs[k]);
    for (int j = 0; j < A; ++j) {
      const double cj = c[k * A + j];
      args.coef[k][j] = T(cj);
      args.role[k][j] = cj == 0.0 ? kSkip : (cj == 1.0 ? kUnit : kScale);
    }
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long want = ((long)n + 255) / 256;
  const int blocks = (int)(want < 16L * sms ? want : 16L * sms);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R * 16 + A) {
#define TF_CASE(RR, AA) \
  case RR * 16 + AA:    \
    launch<T, AA, RR>(args, n, blocks, s); \
    break;
#define TF_ROW(RR) \
  TF_CASE(RR, 1) TF_CASE(RR, 2) TF_CASE(RR, 3) TF_CASE(RR, 4) \
  TF_CASE(RR, 5) TF_CASE(RR, 6) TF_CASE(RR, 7) TF_CASE(RR, 8)
    TF_ROW(1)
    TF_ROW(2)
#undef TF_ROW
#undef TF_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in_ptrs: A device addresses, out_ptrs: R device addresses, coefs: R x A
// doubles (row-major); all three arrays live in host memory and are read
// before the launch returns.
#define TF_ENTRIES(SUFFIX, T)                                                          \
  extern "C" int tf_combine_##SUFFIX(const void* in_ptrs, const void* out_ptrs,       \
                                     const void* coefs, int A, int R, int n,          \
                                     void* stream) {                                  \
    return combine<T>(in_ptrs, out_ptrs, coefs, A, R, n, stream);                     \
  }

TF_ENTRIES(f32, float)
TF_ENTRIES(f64, double)
