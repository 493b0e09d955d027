// The bodies of K4 (pcr.cu) and K6 (megastep.cu) for the PCR of the
// chunk-interface system: the PCR factor, the solve of R right-hand sides
// (and with it the Woodbury set-up of a ring factored acyclic) and the
// reduced solve with neighbour shifts, over a member's chunks spread on a
// thread-block cluster (tf::Spread, K6) or all on one thread block whose
// threads stride over them (tf::Local: K6's one-CTA members and K4's
// one-block kernels, where they win: the factor on few chunks, the
// R-column solve where members fill the card).  K4's own capacitance
// kernel takes woodbury_cap_block.  pcr.cu describes the algebra.  Every
// caller's threads must all enter (the bodies hold barriers).  No
// __restrict__ on the pointers: K6 reads buffers it wrote earlier in the
// same launch.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace tf {

template <typename T, int S>
__device__ __forceinline__ Blk<T, S> add(const Blk<T, S>& a, const Blk<T, S>& b) {
  Blk<T, S> c;
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j) c.v[i][j] = a.v[i][j] + b.v[i][j];
  return c;
}

template <typename T, int S>
__device__ __forceinline__ Blk<T, S> neg(const Blk<T, S>& a) {
  Blk<T, S> c;
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j) c.v[i][j] = -a.v[i][j];
  return c;
}

template <typename T, int S2>
__device__ __forceinline__ void load_vec(const T* p, int c, int C, T (&v)[S2]) {
#pragma unroll
  for (int r = 0; r < S2; ++r) v[r] = p[(long)r * C + c];
}

// The capacitance of the Woodbury closure: cap_inv (S2 x S2) is the
// inverse of cap = I + V^T Z, v_i reading y[S+i] at chunk C-1 (i < S) and
// y[i-S] at chunk 0 (i >= S), Z (S2 columns j, S2, C) read through
// z(j, row, c).  cap is inverted by Gauss-Jordan without pivoting (it is I
// plus a small correction for solver-grade dt), in shared memory, one
// thread per entry of the augmented matrix: blockDim must be >= 2 S2^2.  Z
// must be visible to the whole block; cap_inv may point to shared or
// global memory.  The caller syncs before reading it.
template <typename T, int S2, typename ZAt>
__device__ __forceinline__ void woodbury_cap_at(ZAt z, T* cap_inv, int C) {
  constexpr int S = S2 / 2;
  __shared__ T a[S2][2 * S2];
  const int tid = threadIdx.x;
  if (tid < S2 * S2) {
    const int i = tid / S2, j = tid % S2;
    const T vtz = i < S ? z(j, S + i, C - 1) : z(j, i - S, 0);
    a[i][j] = (i == j ? T(1) : T(0)) + vtz;
    a[i][S2 + j] = i == j ? T(1) : T(0);
  }
  const int row = tid / (2 * S2), k = tid % (2 * S2);
  const bool mine = tid < 2 * S2 * S2;
  for (int col = 0; col < S2; ++col) {
    __syncthreads();
    const T piv = T(1) / a[col][col];
    __syncthreads();
    if (tid < 2 * S2) a[col][tid] *= piv;
    __syncthreads();
    const T f = mine ? a[row][col] : T(0);
    __syncthreads();
    if (mine && row != col) a[row][k] -= f * a[col][k];
  }
  __syncthreads();
  if (tid < S2 * S2) cap_inv[tid] = a[tid / S2][S2 + tid % S2];
}

// woodbury_cap_at of Z in one array (S2 columns j, S2, C)
template <typename T, int S2>
__device__ __forceinline__ void woodbury_cap_block(const T* Z, T* cap_inv, int C) {
  woodbury_cap_at<T, S2>([&](int j, int row, int c) { return Z[((long)j * S2 + row) * C + c]; },
                         cap_inv, C);
}

// ---- the bodies over a member's chunks ----
//
// A member's C chunks spread over the K CTAs of a thread-block cluster:
// CTA `rank` owns chunks [c0, c0 + nc), c0 = rank Cc, and holds every
// chunk-minor buffer's entries of them in its share (shared memory, or
// its own slab of global memory), entry (row, chunk c0 + l) at
// share[row Cc + l].  A level reads the neighbours c -+ d from whichever
// CTA owns them through distributed shared memory (`at`), and `sync`
// separates the phases that read another CTA's entries from the phases
// that wrote them (a cluster barrier, arrive with release and wait with
// acquire semantics; a block barrier for a cluster of one CTA).  A member
// on one CTA takes Local instead, the same interface with every chunk its
// own (Cc = nc = C, c0 = 0), so that the compiler keeps every address in
// K6's shared-memory window; K4's one-block kernels take it on global
// memory.  Every thread of every CTA must call the bodies.  Each chunk's
// products and sums are the same whatever the policy: only where the
// entries live moves.
struct Spread {
  // the PCR factor inverts a neighbour's diagonal block where it reads it:
  // one phase and one barrier a level
  static constexpr bool kStoredInverse = false;
  int K, rank, Cc, C, c0, nc;

  // chunk c's entry 0 in its owner's share of the buffer whose share in
  // this CTA is `share` (a shared-memory buffer, when c is another's)
  template <typename T>
  __device__ __forceinline__ T* at(T* share, int c) const {
    if (c >= c0 && c < c0 + nc) return share + (c - c0);
    const int r = c / Cc;
    return cooperative_groups::this_cluster().map_shared_rank(share, r) + (c - r * Cc);
  }

  __device__ __forceinline__ void sync() const {
    if (K > 1) {
      asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    } else {
      __syncthreads();
    }
  }
};

// A member's chunks all on one thread block (Spread's interface)
struct Local {
  // the PCR factor inverts each block once and stores it (Dt): a block
  // barrier is cheap, an S2 x S2 inverse not
  static constexpr bool kStoredInverse = true;
  int K, rank, Cc, C, c0, nc;

  template <typename T>
  __device__ __forceinline__ T* at(T* share, int c) const {
    return share + c;
  }

  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

// c - d and c + d around a ring of C chunks (0 <= c < C, 0 < d < C): a
// compare and an add, not a remainder
__device__ __forceinline__ int ring_sub(int c, int d, int C) { return c < d ? c - d + C : c - d; }
__device__ __forceinline__ int ring_add(int c, int d, int C) { return c + d >= C ? c + d - C : c + d; }

// The PCR factor (pcr.cu): Lred, Ured, alphas, betas and Dinv are this
// CTA's shares; scratch (7 x (S2, S2, Cc); shared memory on a cluster)
// holds both level buffers of L, D and U and the inverted diagonal blocks
// Dt.  Across CTAs each thread inverts its neighbours' diagonal blocks
// itself (Dt computed where it is read), so a level is one phase and one
// barrier; on one block (Sp::kStoredInverse) each block is inverted once
// into Dt, a block barrier before the level reads it.  The caller syncs
// (a block barrier) before reading Dinv.
template <typename T, int S2, typename Sp>
__device__ __forceinline__ void pcr_factor_cluster(const T* Lred, const T* Ured, T* alphas,
                                                   T* betas, T* Dinv, T* scratch, const Sp& sp,
                                                   int cyclic) {
  const int C = sp.C, Cc = sp.Cc;
  const long sz = (long)S2 * S2 * Cc;
  T* Lb[2] = {scratch, scratch + 3 * sz};
  T* Db[2] = {scratch + sz, scratch + 4 * sz};
  T* Ub[2] = {scratch + 2 * sz, scratch + 5 * sz};
  T* Dt = scratch + 6 * sz;
  for (int l = threadIdx.x; l < sp.nc; l += blockDim.x) {
    Blk<T, S2> I;
    eye(I);
    store_blk(Lb[0], 0, l, Cc, load_blk<T, S2>(Lred, 0, l, Cc));
    store_blk(Ub[0], 0, l, Cc, load_blk<T, S2>(Ured, 0, l, Cc));
    store_blk(Db[0], 0, l, Cc, I);
  }
  sp.sync();
  int cur = 0, lev = 0;
  for (int d = 1; d < C; d *= 2, ++lev) {
    const int nxt = cur ^ 1;
    if constexpr (Sp::kStoredInverse) {
      for (int l = threadIdx.x; l < sp.nc; l += blockDim.x)
        store_blk(Dt, 0, l, Cc, inv(load_blk<T, S2>(Db[cur], 0, l, Cc)));
      sp.sync();
    }
    for (int l = threadIdx.x; l < sp.nc; l += blockDim.x) {
      const int c = sp.c0 + l, cm = ring_sub(c, d, C), cp = ring_add(c, d, C);
      // the inverted neighbour block where alpha (beta) takes it: one of the
      // two alive at a time (both at once spilled more of the f64 S2 = 4
      // factor at 128 registers)
      auto dinv = [&](int cc) -> Blk<T, S2> {
        if constexpr (Sp::kStoredInverse)
          return load_blk<T, S2>(sp.at(Dt, cc), 0, 0, Cc);
        else
          return inv(load_blk<T, S2>(sp.at(Db[cur], cc), 0, 0, Cc));
      };
      Blk<T, S2> alpha = neg(mm(load_blk<T, S2>(Lb[cur], 0, l, Cc), dinv(cm)));
      Blk<T, S2> beta = neg(mm(load_blk<T, S2>(Ub[cur], 0, l, Cc), dinv(cp)));
      if (!cyclic && c < d) zero(alpha);
      if (!cyclic && c >= C - d) zero(beta);
      const Blk<T, S2> Lm = load_blk<T, S2>(sp.at(Lb[cur], cm), 0, 0, Cc);
      const Blk<T, S2> Um = load_blk<T, S2>(sp.at(Ub[cur], cm), 0, 0, Cc);
      const Blk<T, S2> Lp = load_blk<T, S2>(sp.at(Lb[cur], cp), 0, 0, Cc);
      const Blk<T, S2> Up = load_blk<T, S2>(sp.at(Ub[cur], cp), 0, 0, Cc);
      const Blk<T, S2> D = add(add(load_blk<T, S2>(Db[cur], 0, l, Cc), mm(alpha, Um)),
                               mm(beta, Lp));
      store_blk(Db[nxt], 0, l, Cc, D);
      store_blk(Lb[nxt], 0, l, Cc, mm(alpha, Lm));
      store_blk(Ub[nxt], 0, l, Cc, mm(beta, Up));
      store_blk(alphas, lev, l, Cc, alpha);
      store_blk(betas, lev, l, Cc, beta);
    }
    sp.sync();
    cur = nxt;
  }
  for (int l = threadIdx.x; l < sp.nc; l += blockDim.x) {
    Blk<T, S2> D = load_blk<T, S2>(Db[cur], 0, l, Cc);
    if (cyclic) D = add(D, add(load_blk<T, S2>(Lb[cur], 0, l, Cc), load_blk<T, S2>(Ub[cur], 0, l, Cc)));
    store_blk(Dinv, 0, l, Cc, inv(D));
  }
}

// Solve of R right-hand sides, rhs(r, row, c) the entry `row` of column r
// at the global chunk c, into out (R, S2, Cc), this CTA's share.  Every
// level is one phase for all R columns: each thread takes its chunks of
// every column before the level's barrier (nested loops: a flat stride
// over the R * C pairs costs an integer division per pair).  scratch 2 x
// (R, S2, Cc), shared memory on a cluster.  The caller syncs before
// reading out.
template <typename T, int S2, typename Rhs, typename Sp>
__device__ __forceinline__ void pcr_solve_cols_cluster(const T* alphas, const T* betas,
                                                       const T* Dinv, Rhs rhs, T* out,
                                                       T* scratch, const Sp& sp, int R) {
  const int C = sp.C, Cc = sp.Cc;
  const long col = (long)S2 * Cc;
  T* bb[2] = {scratch, scratch + R * col};
  for (int r = 0; r < R; ++r)
    for (int l = threadIdx.x; l < sp.nc; l += blockDim.x)
#pragma unroll
      for (int row = 0; row < S2; ++row) bb[0][r * col + (long)row * Cc + l] = rhs(r, row, sp.c0 + l);
  sp.sync();
  int cur = 0, lev = 0;
  for (int d = 1; d < C; d *= 2, ++lev) {
    for (int r = 0; r < R; ++r) {
      const T* src = bb[cur] + r * col;
      T* dst = bb[cur ^ 1] + r * col;
      for (int l = threadIdx.x; l < sp.nc; l += blockDim.x) {
        const int c = sp.c0 + l, cm = ring_sub(c, d, C), cp = ring_add(c, d, C);
        T b[S2], bm[S2], bp[S2], ta[S2], tb[S2];
        load_vec<T, S2>(src, l, Cc, b);
        load_vec<T, S2>(sp.at(src, cm), 0, Cc, bm);
        load_vec<T, S2>(sp.at(src, cp), 0, Cc, bp);
        mv(load_blk<T, S2>(alphas, lev, l, Cc), bm, ta);
        mv(load_blk<T, S2>(betas, lev, l, Cc), bp, tb);
#pragma unroll
        for (int row = 0; row < S2; ++row) dst[(long)row * Cc + l] = b[row] + ta[row] + tb[row];
      }
    }
    sp.sync();
    cur ^= 1;
  }
  for (int r = 0; r < R; ++r)
    for (int l = threadIdx.x; l < sp.nc; l += blockDim.x) {
      T b[S2], z[S2];
      load_vec<T, S2>(bb[cur] + r * col, l, Cc, b);
      mv(load_blk<T, S2>(Dinv, 0, l, Cc), b, z);
#pragma unroll
      for (int row = 0; row < S2; ++row) out[r * col + (long)row * Cc + l] = z[row];
    }
}

// The Woodbury closure of a ring factored acyclic: Z (S2 columns j, S2,
// Cc, this CTA's share) solves the columns u_j = e_0 (x) Lred[:, S+j, 0]
// (j < S) and u_j = e_{C-1} (x) Ured[:, j-S, C-1] (j >= S), and cap_inv is
// the inverse of its capacitance (woodbury_cap_at), which every CTA
// inverts itself into its own cap_inv (blockDim >= 2 S2^2).  On a cluster
// Z, Lred and Ured are in shared memory (the others read Z, and the
// columns start at chunk 0 and C-1).  The caller syncs before reading
// cap_inv.
template <typename T, int S2, typename Sp>
__device__ __forceinline__ void woodbury_cluster(const T* alphas, const T* betas, const T* Dinv,
                                                 const T* Lred, const T* Ured, T* Z, T* cap_inv,
                                                 T* scratch, const Sp& sp) {
  constexpr int S = S2 / 2;
  const int C = sp.C, Cc = sp.Cc;
  pcr_solve_cols_cluster<T, S2>(
      alphas, betas, Dinv,
      [&](int j, int row, int c) -> T {
        if (j < S) return c == 0 ? sp.at(Lred, 0)[((long)row * S2 + S + j) * Cc] : T(0);
        return c == C - 1 ? sp.at(Ured, C - 1)[((long)row * S2 + j - S) * Cc] : T(0);
      },
      Z, scratch, sp, S2);
  sp.sync();
  woodbury_cap_at<T, S2>(
      [&](int j, int row, int c) { return sp.at(Z, c)[((long)j * S2 + row) * Cc]; }, cap_inv, C);
}

// The reduced solve of yred with the neighbour shifts on the cluster:
// xm1[:, c] the bottom half of chunk c-1's solution, xp1[:, c] the top half
// of chunk c+1's, around the ring with `wrap` and zero past the ends
// without.  With kWood (a Woodbury plan: Z and cap_inv from
// woodbury_cluster) the acyclic solution z is corrected first, z - sum_j
// coef_j Z_j with coef = cap_inv V^T z: the 2 S2 scalars vt and coef sit in
// shared memory, and every thread corrects the neighbour entries it
// shifts.  The levels are pcr_solve_cols_cluster's with one column.  yred
// (S2, Cc), xm1 and xp1 (S, Cc)
// this CTA's shares; Z (a Woodbury plan) shared memory; cap_inv this
// CTA's; scratch 3 x (S2, Cc), shared memory: the level buffers and the
// solution z, which the neighbours read for the shifts.  The caller syncs
// (a block barrier) before reading xm1 and xp1.
template <typename T, int S2, bool kWood, typename Sp>
__device__ __forceinline__ void pcr_solve_shift_cluster(const T* alphas, const T* betas,
                                                        const T* Dinv, const T* yred, const T* Z,
                                                        const T* cap_inv, T* xm1, T* xp1,
                                                        T* scratch, const Sp& sp, int wrap) {
  constexpr int S = S2 / 2;
  const int C = sp.C, Cc = sp.Cc;
  T* bb[3] = {scratch, scratch + (long)S2 * Cc, scratch + 2L * S2 * Cc};
  for (int l = threadIdx.x; l < sp.nc; l += blockDim.x)
#pragma unroll
    for (int r = 0; r < S2; ++r) bb[0][(long)r * Cc + l] = yred[(long)r * Cc + l];
  sp.sync();
  int cur = 0, lev = 0;
  for (int d = 1; d < C; d *= 2, ++lev) {
    for (int l = threadIdx.x; l < sp.nc; l += blockDim.x) {
      const int c = sp.c0 + l, cm = ring_sub(c, d, C), cp = ring_add(c, d, C);
      T b[S2], bm[S2], bp[S2], ta[S2], tb[S2];
      load_vec<T, S2>(bb[cur], l, Cc, b);
      load_vec<T, S2>(sp.at(bb[cur], cm), 0, Cc, bm);
      load_vec<T, S2>(sp.at(bb[cur], cp), 0, Cc, bp);
      mv(load_blk<T, S2>(alphas, lev, l, Cc), bm, ta);
      mv(load_blk<T, S2>(betas, lev, l, Cc), bp, tb);
#pragma unroll
      for (int r = 0; r < S2; ++r) bb[cur ^ 1][(long)r * Cc + l] = b[r] + ta[r] + tb[r];
    }
    sp.sync();
    cur ^= 1;
  }
  for (int l = threadIdx.x; l < sp.nc; l += blockDim.x) {
    T b[S2], z[S2];
    load_vec<T, S2>(bb[cur], l, Cc, b);
    mv(load_blk<T, S2>(Dinv, 0, l, Cc), b, z);
#pragma unroll
    for (int r = 0; r < S2; ++r) bb[2][(long)r * Cc + l] = z[r];
  }
  sp.sync();
  const T* z = bb[2];
  if constexpr (kWood) {
    __shared__ T s_vt[S2], s_coef[S2];
    const int tid = threadIdx.x;
    if (tid < S2) s_vt[tid] = tid < S ? sp.at(z, C - 1)[(long)(S + tid) * Cc] : sp.at(z, 0)[(long)(tid - S) * Cc];
    __syncthreads();
    if (tid < S2) {
      T acc = cap_inv[tid * S2] * s_vt[0];
#pragma unroll
      for (int i = 1; i < S2; ++i) acc += cap_inv[tid * S2 + i] * s_vt[i];
      s_coef[tid] = acc;
    }
    __syncthreads();
    auto y = [&](int row, int cc) {
      const T* Zc = sp.at(Z, cc);
      T corr = s_coef[0] * Zc[(long)row * Cc];
#pragma unroll
      for (int j = 1; j < S2; ++j) corr += s_coef[j] * Zc[((long)j * S2 + row) * Cc];
      return sp.at(z, cc)[(long)row * Cc] - corr;
    };
    // the ring is closed (a Woodbury plan wraps)
    for (int l = tid; l < sp.nc; l += blockDim.x) {
      const int c = sp.c0 + l, cm = ring_sub(c, 1, C), cp = ring_add(c, 1, C);
#pragma unroll
      for (int r = 0; r < S; ++r) {
        xm1[(long)r * Cc + l] = y(S + r, cm);
        xp1[(long)r * Cc + l] = y(r, cp);
      }
    }
  } else {
    for (int l = threadIdx.x; l < sp.nc; l += blockDim.x) {
      const int c = sp.c0 + l, cm = ring_sub(c, 1, C), cp = ring_add(c, 1, C);
      const bool has_m = wrap || c != 0;
      const bool has_p = wrap || c != C - 1;
      const T* zm = sp.at(z, cm);
      const T* zp = sp.at(z, cp);
#pragma unroll
      for (int r = 0; r < S; ++r) {
        xm1[(long)r * Cc + l] = has_m ? zm[(long)(S + r) * Cc] : T(0);
        xp1[(long)r * Cc + l] = has_p ? zp[(long)r * Cc] : T(0);
      }
    }
  }
}

}  // namespace tf
