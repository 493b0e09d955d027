// Block algebra of the wide block sizes (S = 5..8, and the interface blocks
// S2 = 10..16 of K4), for K2's and K4's factors.
//
// A block of that size does not fit one thread's registers (a double 8 x 8
// block is 128 registers, a 16 x 16 one 512), so a *group* of S lanes of
// one warp holds it row by row: lane `base + r` holds row r in a Row<T, S>.
// A warp carries G = 32 / S groups side by side (one chunk each), and the
// lanes past G * S idle.  Products and the inverse exchange rows with warp
// shuffles, so no shared memory is used and every block stays in
// registers, S values per lane.  Every lane of a warp must take part in
// every call below (they shuffle with the full mask): a lane of no chunk
// computes on a clamped chunk and stores nothing.
#pragma once

#include "common.cuh"

namespace tf {

template <typename T, int S>
struct Row {
  T v[S];
};

// The lanes of one group: `base` its first lane, `r` this lane's row.
struct Group {
  int base;
  int r;
};

// Group layout of a warp: G = 32 / S groups of S lanes; the lanes past
// G * S get group G (no chunk).
template <int S>
__device__ __forceinline__ int group_of_lane(int lane) {
  return lane / S < 32 / S ? lane / S : 32 / S;
}

// entry (q, j) of a block the group holds row-wise
template <typename T, int S>
__device__ __forceinline__ T entry(const Row<T, S>& a, const Group& g, int q, int j) {
  return __shfl_sync(0xffffffffu, a.v[j], g.base + q);
}

template <typename T, int S>
__device__ __forceinline__ Row<T, S> zero_row() {
  Row<T, S> a;
#pragma unroll
  for (int j = 0; j < S; ++j) a.v[j] = T(0);
  return a;
}

template <typename T, int S>
__device__ __forceinline__ Row<T, S> sub(const Row<T, S>& a, const Row<T, S>& b) {
  Row<T, S> c;
#pragma unroll
  for (int j = 0; j < S; ++j) c.v[j] = a.v[j] - b.v[j];
  return c;
}

template <typename T, int S>
__device__ __forceinline__ Row<T, S> add(const Row<T, S>& a, const Row<T, S>& b) {
  Row<T, S> c;
#pragma unroll
  for (int j = 0; j < S; ++j) c.v[j] = a.v[j] + b.v[j];
  return c;
}

template <typename T, int S>
__device__ __forceinline__ Row<T, S> neg(const Row<T, S>& a) {
  Row<T, S> c;
#pragma unroll
  for (int j = 0; j < S; ++j) c.v[j] = -a.v[j];
  return c;
}

// this lane's row of a * b, both held row-wise by the group; the sum over
// q runs in the order of common.cuh's mm
template <typename T, int S>
__device__ __forceinline__ Row<T, S> mm(const Row<T, S>& a, const Row<T, S>& b,
                                        const Group& g) {
  Row<T, S> c;
#pragma unroll
  for (int j = 0; j < S; ++j) c.v[j] = a.v[0] * entry(b, g, 0, j);
#pragma unroll
  for (int q = 1; q < S; ++q)
#pragma unroll
    for (int j = 0; j < S; ++j) c.v[j] += a.v[q] * entry(b, g, q, j);
  return c;
}

// this lane's row of the inverse: Gauss-Jordan elimination with partial
// pivoting (the first row of largest magnitude in the column), rows
// exchanged and broadcast by shuffles
template <typename T, int S>
__device__ __forceinline__ Row<T, S> inv(Row<T, S> m, const Group& g) {
  Row<T, S> x;
#pragma unroll
  for (int j = 0; j < S; ++j) x.v[j] = g.r == j ? T(1) : T(0);
#pragma unroll
  for (int col = 0; col < S; ++col) {
    int piv = col;
    T best = fabs(entry(m, g, col, col));
#pragma unroll
    for (int row = col + 1; row < S; ++row) {
      const T v = fabs(entry(m, g, row, col));
      if (v > best) {
        best = v;
        piv = row;
      }
    }
    const int src = g.r == col ? piv : (g.r == piv ? col : g.r);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      m.v[j] = __shfl_sync(0xffffffffu, m.v[j], g.base + src);
      x.v[j] = __shfl_sync(0xffffffffu, x.v[j], g.base + src);
    }
    const T p = T(1) / entry(m, g, col, col);
    const T f = m.v[col];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const T pm = entry(m, g, col, j) * p;
      const T px = entry(x, g, col, j) * p;
      if (g.r == col) {
        m.v[j] = pm;
        x.v[j] = px;
      } else {
        m.v[j] -= f * pm;
        x.v[j] -= f * px;
      }
    }
  }
  return x;
}

// row r of a block stored chunk-minor (common.cuh's load_blk layout)
template <typename T, int S>
__device__ __forceinline__ Row<T, S> load_row(const T* p, long j, int r, int c, int C) {
  Row<T, S> a;
#pragma unroll
  for (int k = 0; k < S; ++k) a.v[k] = p[((j * S + r) * S + k) * C + c];
  return a;
}

template <typename T, int S>
__device__ __forceinline__ void store_row(T* p, long j, int r, int c, int C,
                                          const Row<T, S>& a) {
#pragma unroll
  for (int k = 0; k < S; ++k) p[((j * S + r) * S + k) * C + c] = a.v[k];
}

}  // namespace tf
