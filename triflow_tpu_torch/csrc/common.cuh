// Shared pieces of the hand-written kernels: the error-string entry every
// library exports, rounding that nvcc never contracts, the linear
// combination of K5 and K6, and S x S block algebra held in registers.
//
// The solver kernels work on dense S x S blocks (S = nvar * max(halo, 1),
// the supernode size).  Blocks are small (1..4 in the instantiated set),
// so they live in per-thread register arrays and every product and inverse
// is fully unrolled at compile time.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* tf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace tf {

// Products, sums, differences and quotients rounded one at a time: nvcc
// never contracts these into an FMA, so a kernel computes exactly what the
// same operations compute on the host (numpy, torch) in the same order.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// Role of one coefficient of a linear combination, decided on the host from
// its double value as the reference decides it: 0 skips the column, 1 adds
// the value unmultiplied, anything else multiplies.
enum Role : unsigned char { kSkip = 0, kUnit = 1, kScale = 2 };

// sum_j coef[j] * value(j) over the A columns, in column order, each term
// and each sum rounded on its own (0 when every column is skipped).
template <typename T, typename Value>
__device__ __forceinline__ T lin_comb(int A, const T* coef, const unsigned char* role,
                                      Value value) {
  T acc = T(0);
  bool any = false;
#pragma unroll
  for (int j = 0; j < A; ++j) {
    if (role[j] == kSkip) continue;
    const T t = role[j] == kUnit ? value(j) : mul_rn(coef[j], value(j));
    acc = any ? add_rn(acc, t) : t;
    any = true;
  }
  return acc;
}

template <typename T, int S>
struct Blk {
  T v[S][S];
};

template <typename T, int S>
__device__ __forceinline__ void zero(Blk<T, S>& a) {
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j) a.v[i][j] = T(0);
}

template <typename T, int S>
__device__ __forceinline__ void eye(Blk<T, S>& a) {
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j) a.v[i][j] = (i == j) ? T(1) : T(0);
}

// c = a * b
template <typename T, int S>
__device__ __forceinline__ Blk<T, S> mm(const Blk<T, S>& a, const Blk<T, S>& b) {
  Blk<T, S> c;
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j) {
      T acc = a.v[i][0] * b.v[0][j];
#pragma unroll
      for (int q = 1; q < S; ++q) acc += a.v[i][q] * b.v[q][j];
      c.v[i][j] = acc;
    }
  return c;
}

// y = a * x
template <typename T, int S>
__device__ __forceinline__ void mv(const Blk<T, S>& a, const T (&x)[S], T (&y)[S]) {
#pragma unroll
  for (int i = 0; i < S; ++i) {
    T acc = a.v[i][0] * x[0];
#pragma unroll
    for (int q = 1; q < S; ++q) acc += a.v[i][q] * x[q];
    y[i] = acc;
  }
}

// Inverse of a small block.  S = 1 and S = 2 use the closed forms of the
// reference's _small_inv; larger blocks use Gauss-Jordan elimination with
// partial pivoting (the blocks come from diagonally dominant systems, but
// pivoting costs nothing at these sizes).
template <typename T, int S>
__device__ __forceinline__ Blk<T, S> inv(const Blk<T, S>& a) {
  Blk<T, S> r;
  if constexpr (S == 1) {
    r.v[0][0] = T(1) / a.v[0][0];
  } else if constexpr (S == 2) {
    const T inv_det = T(1) / (a.v[0][0] * a.v[1][1] - a.v[0][1] * a.v[1][0]);
    r.v[0][0] = a.v[1][1] * inv_det;
    r.v[0][1] = -a.v[0][1] * inv_det;
    r.v[1][0] = -a.v[1][0] * inv_det;
    r.v[1][1] = a.v[0][0] * inv_det;
  } else {
    Blk<T, S> m = a;
    eye(r);
#pragma unroll
    for (int col = 0; col < S; ++col) {
      int piv = col;
      T best = fabs(m.v[col][col]);
#pragma unroll
      for (int row = col + 1; row < S; ++row) {
        if (fabs(m.v[row][col]) > best) {
          best = fabs(m.v[row][col]);
          piv = row;
        }
      }
#pragma unroll
      for (int row = col + 1; row < S; ++row) {
        if (row == piv) {
#pragma unroll
          for (int j = 0; j < S; ++j) {
            T t = m.v[col][j]; m.v[col][j] = m.v[row][j]; m.v[row][j] = t;
            t = r.v[col][j]; r.v[col][j] = r.v[row][j]; r.v[row][j] = t;
          }
        }
      }
      const T p = T(1) / m.v[col][col];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        m.v[col][j] *= p;
        r.v[col][j] *= p;
      }
#pragma unroll
      for (int row = 0; row < S; ++row) {
        if (row == col) continue;
        const T f = m.v[row][col];
#pragma unroll
        for (int j = 0; j < S; ++j) {
          m.v[row][j] -= f * m.v[col][j];
          r.v[row][j] -= f * r.v[col][j];
        }
      }
    }
  }
  return r;
}

// Blocks stored chunk-minor: element (row j, a, b) of chunk c sits at
// ((j * S + a) * S + b) * C + c, so neighbouring threads (chunks) read
// neighbouring addresses.
template <typename T, int S>
__device__ __forceinline__ Blk<T, S> load_blk(const T* p, long j, int c, int C) {
  Blk<T, S> a;
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int k = 0; k < S; ++k) a.v[i][k] = p[((j * S + i) * S + k) * C + c];
  return a;
}

template <typename T, int S>
__device__ __forceinline__ void store_blk(T* p, long j, int c, int C, const Blk<T, S>& a) {
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int k = 0; k < S; ++k) p[((j * S + i) * S + k) * C + c] = a.v[i][k];
}

}  // namespace tf
