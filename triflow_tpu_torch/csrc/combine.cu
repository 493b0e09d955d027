// K5: R linear combinations of A same-shape arrays in one pass,
//   out[k][i] = sum_j rows[k][j] * in[j][i],   k < R, j < A,
// the stage algebra of one Rosenbrock step (stage inputs u_i with their
// bias sums, and the final (u_new, u_new - u_pred) pair) and of one
// explicit RK step (stage inputs u + sum_j (a_ij dt) k_j, and the final
// (u_new, error row) pair).
//
// Replaces, on the TPU: ops/folded.py combine_folded, which fetched each
// input block into VMEM once and wrote every output once.
//
// Bound: device-memory bandwidth.  (A + R) * n * sizeof(T) bytes at the
// card's 3.35 TB/s; the arithmetic is at most 2 * A * R operations per
// element.  At N = 2^20, nvar = 1, A = 7, R = 2 that is 37.7 MB in f32
// (11.3 us) and 75.5 MB in f64 (22.5 us).
//
// Design for this card.  The device body runs at its bound already at
// large n; what a Rosenbrock step pays for is the launch path, so it is
// kept short:
//   - the coefficients, rounded to T, and each one's role travel in an
//     argument block (``Coefs``) that the wrapper builds once per
//     (rows, dtype) and caches on the host; a launch passes that block's
//     address, the A + R array pointers, n and the grid size, which the
//     wrapper sizes from an SM count it reads once per process;
//   - the entry queries nothing of the device;
//   - in float32 each thread moves 16 bytes per array per step (float4)
//     where every pointer is 16-byte aligned, with a scalar tail, in a grid
//     of 4 blocks per SM; otherwise one element per step in a grid-stride
//     loop of up to 16 blocks per SM.  Measured on the H100 at KS 2^20's
//     shape (A = 7, R = 2; PERF.md): float4 at 4 blocks per SM 11.9 us of
//     device time (bound 11.3), one float 12.4 to 13.2; in float64 one
//     double 26.4 to 27.1 us (bound 22.5), double2 30.4 at best, so
//     float64 moves one element per step.
// Each role is decided on the host from the coefficient's double value, as
// the reference decides it: 0 skips the column, 1 adds the input
// unmultiplied, anything else multiplies.  A fourth role, kScaleDt, marks a
// column that the launch's dt scales (the explicit RK family's stage
// weights a_ij * dt): the entry replaces its coefficient by T(c) * T(dt),
// one product rounded in T (the same for every element, so formed once per
// launch into the launch's copy of the block), and the body multiplies it
// in as a kScale column.  The cached block stays keyed on the tableau.  An
// ensemble whose members step by their own dt passes one dt per member
// (dt_b, on the device): combine_members_kernel forms member b's products
// T(c) * dt_b[b] on the device, the same rounding, one element per step.  Products and sums are rounded
// one at a time (__fmul_rn, __fadd_rn and their double twins are never
// contracted into an FMA), in the reference's column order, so the kernel
// computes exactly what the plain PyTorch loop computes.
#include "common.cuh"

namespace {

constexpr int kMaxA = 8;
constexpr int kMaxR = 2;

using tf::kScale;
using tf::kSkip;
using tf::kUnit;
// a column scaled by the launch's dt (the wrapper's _SCALE_DT)
constexpr unsigned char kScaleDt = 3;

// The cached argument block: R x A coefficients rounded to T and their
// roles (the wrapper's ``_coef_block`` writes exactly this layout).
template <typename T>
struct Coefs {
  T coef[kMaxR][kMaxA];
  unsigned char role[kMaxR][kMaxA];
};

template <typename T>
struct Args {
  const T* in[kMaxA];
  T* out[kMaxR];
  Coefs<T> c;
  const T* dt_b;  // each member's dt, or null: the launch's one dt (formed in c)
  int B;          // members of dt_b
};

constexpr int kVecBlocksPerSm = 4;
constexpr int kBlocksPerSm = 16;

template <typename T, int A, int R>
__device__ __forceinline__ void combine_one(const Args<T>& args, long i) {
  T v[A];
#pragma unroll
  for (int j = 0; j < A; ++j) v[j] = __ldg(args.in[j] + i);
#pragma unroll
  for (int k = 0; k < R; ++k)
    args.out[k][i] = tf::lin_comb(A, args.c.coef[k], args.c.role[k], [&](int j) { return v[j]; });
}

// One float4 of every array per step; the n % 4 tail by the first threads
// of the grid.
template <int A, int R>
__global__ void combine_vec_kernel(const Args<float> args, long n) {
  using T = float;
  using V = float4;
  constexpr int kW = 4;
  const long nv = n / kW;
  const long first = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long stride = (long)gridDim.x * blockDim.x;
  for (long q = first; q < nv; q += stride) {
    T v[A][kW];
#pragma unroll
    for (int j = 0; j < A; ++j) {
      const V x = __ldg(reinterpret_cast<const V*>(args.in[j]) + q);
      const T* xs = reinterpret_cast<const T*>(&x);
#pragma unroll
      for (int e = 0; e < kW; ++e) v[j][e] = xs[e];
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      V y;
      T* ys = reinterpret_cast<T*>(&y);
#pragma unroll
      for (int e = 0; e < kW; ++e)
        ys[e] = tf::lin_comb(A, args.c.coef[k], args.c.role[k], [&](int j) { return v[j][e]; });
      reinterpret_cast<V*>(args.out[k])[q] = y;
    }
  }
  const long tail = nv * kW + first;
  if (tail < n) combine_one<T, A, R>(args, tail);
}

template <typename T, int A, int R>
__global__ void combine_kernel(const Args<T> args, long n) {
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    combine_one<T, A, R>(args, i);
}

// An ensemble stepping each member by its own dt (the per-member
// controller): member b's kScaleDt coefficients are T(c) * dt_b[b], formed
// once per thread from the member's dt; a block row per member
// (blockIdx.y), one element per step of a grid-stride loop over the
// member's member_n elements.
template <typename T, int A, int R>
__global__ void combine_members_kernel(const Args<T> args, const T* __restrict__ dt_b,
                                       long member_n) {
  const long base = (long)blockIdx.y * member_n;
  const T dt = __ldg(dt_b + blockIdx.y);
  T coef[R][A];
  unsigned char role[R][A];
#pragma unroll
  for (int k = 0; k < R; ++k)
#pragma unroll
    for (int j = 0; j < A; ++j) {
      const unsigned char r = args.c.role[k][j];
      role[k][j] = r == kScaleDt ? kScale : r;
      coef[k][j] = r == kScaleDt ? tf::mul_rn(args.c.coef[k][j], dt) : args.c.coef[k][j];
    }
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < member_n; i += stride) {
    T v[A];
#pragma unroll
    for (int j = 0; j < A; ++j) v[j] = __ldg(args.in[j] + base + i);
#pragma unroll
    for (int k = 0; k < R; ++k)
      args.out[k][base + i] = tf::lin_comb(A, coef[k], role[k], [&](int j) { return v[j]; });
  }
}

// float4 where every pointer allows it (float32), else one element per
// step; the grid from the SM count.
template <typename T, int A, int R>
void launch(const Args<T>& args, long n, bool aligned, int sms, cudaStream_t stream) {
  if (args.dt_b) {
    const long member_n = n / args.B;
    const long cap = ((long)sms * kBlocksPerSm + args.B - 1) / args.B;
    const long want = (member_n + 255) / 256;
    const int blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
    combine_members_kernel<T, A, R><<<dim3(blocks, args.B), 256, 0, stream>>>(args, args.dt_b,
                                                                              member_n);
    return;
  }
  const long per_thread = aligned ? 4 : 1;
  const long cap = (long)sms * (aligned ? kVecBlocksPerSm : kBlocksPerSm);
  const long want = (n / per_thread + 255) / 256;
  const int blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  if constexpr (sizeof(T) == 4) {
    if (aligned) {
      combine_vec_kernel<A, R><<<blocks, 256, 0, stream>>>(args, n);
      return;
    }
  }
  combine_kernel<T, A, R><<<blocks, 256, 0, stream>>>(args, n);
}

template <typename T>
int combine(const void* coefs, const void* const* ins, void* const* outs, const void* dt_b,
            int A, int R, int n, int sms, int B, double dt, void* stream) {
  if (A < 1 || A > kMaxA || R < 1 || R > kMaxR || n < 0 || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dt_b && (B < 1 || B > 65535 || n % B)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Args<T> args;
  args.c = *static_cast<const Coefs<T>*>(coefs);
  args.dt_b = static_cast<const T*>(dt_b);
  args.B = B;
  if (!dt_b) {
    const T dt_t = static_cast<T>(dt);
    for (int k = 0; k < R; ++k)
      for (int j = 0; j < A; ++j)
        if (args.c.role[k][j] == kScaleDt) {
          args.c.coef[k][j] = args.c.coef[k][j] * dt_t;
          args.c.role[k][j] = kScale;
        }
  }
  unsigned long long bits = 0;
  for (int j = 0; j < A; ++j) {
    args.in[j] = static_cast<const T*>(ins[j]);
    bits |= reinterpret_cast<unsigned long long>(ins[j]);
  }
  for (int k = 0; k < R; ++k) {
    args.out[k] = static_cast<T*>(outs[k]);
    bits |= reinterpret_cast<unsigned long long>(outs[k]);
  }
  const bool aligned = sizeof(T) == 4 && (bits & 15) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R * 16 + A) {
#define TF_CASE(RR, AA) \
  case RR * 16 + AA:    \
    launch<T, AA, RR>(args, n, aligned, sms, s); \
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

// coefs: the host address of a cached ``Coefs<T>`` block, read before the
// launch returns; i0..i7: the A input arrays (the rest null), o0, o1: the
// R outputs; sms: the card's SM count, which sizes the grid; dt: the factor
// of the kScaleDt columns (read only where the block has one), or, where
// dt_b is not null, dt_b: the device address of B members' factors, the
// arrays being B members of n / B elements each.
#define TF_ENTRIES(SUFFIX, T)                                                               \
  extern "C" int tf_combine_##SUFFIX(const void* coefs, const void* i0, const void* i1,    \
                                     const void* i2, const void* i3, const void* i4,       \
                                     const void* i5, const void* i6, const void* i7,       \
                                     void* o0, void* o1, const void* dt_b, int A, int R,   \
                                     int n, int sms, int B, double dt, void* stream) {     \
    const void* const ins[kMaxA] = {i0, i1, i2, i3, i4, i5, i6, i7};                       \
    void* const outs[kMaxR] = {o0, o1};                                                    \
    return combine<T>(coefs, ins, outs, dt_b, A, R, n, sms, B, dt, stream);                \
  }

TF_ENTRIES(f32, float)
TF_ENTRIES(f64, double)
