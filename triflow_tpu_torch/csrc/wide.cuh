// Block algebra of the wide block sizes (S = 5..8, and the interface blocks
// S2 = 10..16 of K4), for K2's and K4's factors; K4's narrow factor (S2 =
// 4..8) takes the same lane groups, 32 / S2 to a warp.
//
// A block of that size does not fit one thread's registers (a double 8 x 8
// block is 128 registers, a 16 x 16 one 512), so a *group* of S lanes of
// one warp holds it row by row: lane `base + r` holds row r in a Row<T, S>.
// A warp carries G = 32 / S groups side by side (one chunk each), and the
// lanes past G * S idle.  A product takes its right operand through the
// group's block in shared memory (mm_shared: each lane writes its row and
// reads the whole block, one load serving the group's lanes); the inverse
// exchanges rows by warp shuffles.  Every lane of a warp must take part in
// every call below (they shuffle and __syncwarp with the full mask): a lane
// of no chunk computes on a valid chunk and stores nothing.
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

// Entries of one group's S x S block in shared memory (mm_shared), rounded
// up to 16 bytes; a warp needs 32 / S + 1 of them (its groups and the
// lanes past them)
template <typename T, int S>
__host__ __device__ constexpr int group_block() {
  return (int)((S * S * sizeof(T) + 15) / 16 * 16 / sizeof(T));
}

// S entries from / to shared memory at p, in 16- or 8-byte pieces where
// the row's bytes allow (p is as aligned as S entries are)
template <typename T, int S>
__device__ __forceinline__ void ld_shared(const T* p, T (&v)[S]) {
  if constexpr (S * sizeof(T) % 16 == 0 && sizeof(T) == 8) {
#pragma unroll
    for (int i = 0; i < S / 2; ++i) {
      const double2 x = reinterpret_cast<const double2*>(p)[i];
      v[2 * i] = x.x;
      v[2 * i + 1] = x.y;
    }
  } else if constexpr (S * sizeof(T) % 16 == 0) {
#pragma unroll
    for (int i = 0; i < S / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = x.x;
      v[4 * i + 1] = x.y;
      v[4 * i + 2] = x.z;
      v[4 * i + 3] = x.w;
    }
  } else if constexpr (S * sizeof(T) % 8 == 0 && sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < S / 2; ++i) {
      const float2 x = reinterpret_cast<const float2*>(p)[i];
      v[2 * i] = x.x;
      v[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < S; ++i) v[i] = p[i];
  }
}

template <typename T, int S>
__device__ __forceinline__ void st_shared(T* p, const T (&v)[S]) {
  if constexpr (S * sizeof(T) % 16 == 0 && sizeof(T) == 8) {
#pragma unroll
    for (int i = 0; i < S / 2; ++i)
      reinterpret_cast<double2*>(p)[i] = make_double2(v[2 * i], v[2 * i + 1]);
  } else if constexpr (S * sizeof(T) % 16 == 0) {
#pragma unroll
    for (int i = 0; i < S / 4; ++i)
      reinterpret_cast<float4*>(p)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                                                    v[4 * i + 3]);
  } else if constexpr (S * sizeof(T) % 8 == 0 && sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < S / 2; ++i)
      reinterpret_cast<float2*>(p)[i] = make_float2(v[2 * i], v[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < S; ++i) p[i] = v[i];
  }
}

// this lane's row of a * b, both held row-wise by the group; b goes
// through the group's block `buf` in shared memory (group_block entries):
// each lane writes its row of b, then reads all of b, one load serving the
// group's S lanes at once, where shuffles move every entry to every lane
// apart (products by shuffles, with the inverse's two shuffle rounds a
// column, took 9-25 % longer in K2 and K4 at the film's C = 500 and 512;
// PERF.md).  The sum over q runs in the order of common.cuh's mm.  The
// whole warp calls it together.
template <typename T, int S>
__device__ __forceinline__ Row<T, S> mm_shared(const Row<T, S>& a, const Row<T, S>& b,
                                               const Group& g, T* buf) {
  __syncwarp();
  st_shared<T, S>(buf + g.r * S, b.v);
  __syncwarp();
  Row<T, S> c;
  T bq[S];
  ld_shared<T, S>(buf, bq);
#pragma unroll
  for (int j = 0; j < S; ++j) c.v[j] = a.v[0] * bq[j];
#pragma unroll
  for (int q = 1; q < S; ++q) {
    ld_shared<T, S>(buf + q * S, bq);
#pragma unroll
    for (int j = 0; j < S; ++j) c.v[j] += a.v[q] * bq[j];
  }
  return c;
}

// this lane's row of the inverse: Gauss-Jordan elimination with partial
// pivoting (the first row of largest magnitude in the column).  Each column
// takes one round of shuffles: every lane fetches the row it holds after
// the pivot exchange (its own, or the pivot's and col's swapped) and the
// pivot row itself together, then scales and eliminates: the values of an
// exchange followed by a broadcast of the exchanged pivot row.
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
    Row<T, S> pm, px;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      pm.v[j] = __shfl_sync(0xffffffffu, m.v[j], g.base + piv);
      px.v[j] = __shfl_sync(0xffffffffu, x.v[j], g.base + piv);
      m.v[j] = __shfl_sync(0xffffffffu, m.v[j], g.base + src);
      x.v[j] = __shfl_sync(0xffffffffu, x.v[j], g.base + src);
    }
    const T p = T(1) / pm.v[col];
    const T f = m.v[col];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const T sm = pm.v[j] * p;
      const T sx = px.v[j] * p;
      if (g.r == col) {
        m.v[j] = sm;
        x.v[j] = sx;
      } else {
        m.v[j] -= f * sm;
        x.v[j] -= f * sx;
      }
    }
  }
  return x;
}

// row r of a block into its chunk-minor place (common.cuh's load_blk layout)
template <typename T, int S>
__device__ __forceinline__ void store_row(T* p, long j, int r, int c, int C,
                                          const Row<T, S>& a) {
#pragma unroll
  for (int k = 0; k < S; ++k) p[((j * S + r) * S + k) * C + c] = a.v[k];
}

}  // namespace tf
