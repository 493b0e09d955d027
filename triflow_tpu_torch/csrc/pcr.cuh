// The one-block bodies of K4 (pcr.cu), shared with K6 (megastep.cu): the
// PCR factor, the solve of R right-hand sides (and with it the Woodbury
// set-up of a ring factored acyclic), and the reduced solve with neighbour
// shifts, each run by ONE thread block whose threads stride over the C
// chunks; pcr.cu describes the algebra and runs them where they win (the
// factor on few chunks, the R-column solve where members fill the card),
// and K4's own capacitance kernel takes woodbury_cap_block.
// Every caller's threads must all enter (the bodies hold __syncthreads()).
// No __restrict__ on the pointers: K6 reads buffers it wrote earlier in the
// same launch.
#pragma once

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

// scratch: 7 x (S2, S2, C)
template <typename T, int S2>
__device__ __forceinline__ void pcr_factor_block(const T* Lred, const T* Ured, T* alphas,
                                                 T* betas, T* Dinv, T* scratch, int C,
                                                 int cyclic) {
  const long sz = (long)S2 * S2 * C;
  T* Lb[2] = {scratch, scratch + 3 * sz};
  T* Db[2] = {scratch + sz, scratch + 4 * sz};
  T* Ub[2] = {scratch + 2 * sz, scratch + 5 * sz};
  T* Dt = scratch + 6 * sz;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    Blk<T, S2> I;
    eye(I);
    store_blk(Lb[0], 0, c, C, load_blk<T, S2>(Lred, 0, c, C));
    store_blk(Ub[0], 0, c, C, load_blk<T, S2>(Ured, 0, c, C));
    store_blk(Db[0], 0, c, C, I);
  }
  __syncthreads();
  int cur = 0, lev = 0;
  for (int d = 1; d < C; d *= 2, ++lev) {
    for (int c = threadIdx.x; c < C; c += blockDim.x)
      store_blk(Dt, 0, c, C, inv(load_blk<T, S2>(Db[cur], 0, c, C)));
    __syncthreads();
    const int nxt = cur ^ 1;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const int cm = (c - d + C) % C, cp = (c + d) % C;
      Blk<T, S2> alpha = neg(mm(load_blk<T, S2>(Lb[cur], 0, c, C), load_blk<T, S2>(Dt, 0, cm, C)));
      Blk<T, S2> beta = neg(mm(load_blk<T, S2>(Ub[cur], 0, c, C), load_blk<T, S2>(Dt, 0, cp, C)));
      if (!cyclic && c < d) zero(alpha);
      if (!cyclic && c >= C - d) zero(beta);
      const Blk<T, S2> Lm = load_blk<T, S2>(Lb[cur], 0, cm, C);
      const Blk<T, S2> Um = load_blk<T, S2>(Ub[cur], 0, cm, C);
      const Blk<T, S2> Lp = load_blk<T, S2>(Lb[cur], 0, cp, C);
      const Blk<T, S2> Up = load_blk<T, S2>(Ub[cur], 0, cp, C);
      const Blk<T, S2> D = add(add(load_blk<T, S2>(Db[cur], 0, c, C), mm(alpha, Um)),
                               mm(beta, Lp));
      store_blk(Db[nxt], 0, c, C, D);
      store_blk(Lb[nxt], 0, c, C, mm(alpha, Lm));
      store_blk(Ub[nxt], 0, c, C, mm(beta, Up));
      store_blk(alphas, lev, c, C, alpha);
      store_blk(betas, lev, c, C, beta);
    }
    __syncthreads();
    cur = nxt;
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    Blk<T, S2> D = load_blk<T, S2>(Db[cur], 0, c, C);
    if (cyclic) D = add(D, add(load_blk<T, S2>(Lb[cur], 0, c, C), load_blk<T, S2>(Ub[cur], 0, c, C)));
    store_blk(Dinv, 0, c, C, inv(D));
  }
}

template <typename T, int S2>
__device__ __forceinline__ void load_vec(const T* p, int c, int C, T (&v)[S2]) {
#pragma unroll
  for (int r = 0; r < S2; ++r) v[r] = p[(long)r * C + c];
}

// Solve of R right-hand sides, rhs(r, row, c) the entry `row` of column r
// at chunk c, into out (R, S2, C).  Every level is one phase for all R
// columns: each thread takes its chunks of every column before the
// level's sync (nested loops: a flat stride over the R * C pairs costs an
// integer division per pair).  The last phase writes out; the caller
// syncs before reading it.
// scratch: 2 x (R, S2, C)
template <typename T, int S2, typename Rhs>
__device__ __forceinline__ void pcr_solve_cols_block(const T* alphas, const T* betas,
                                                     const T* Dinv, Rhs rhs, T* out, T* scratch,
                                                     int C, int R) {
  const long col = (long)S2 * C;
  T* bb[2] = {scratch, scratch + R * col};
  for (int r = 0; r < R; ++r)
    for (int c = threadIdx.x; c < C; c += blockDim.x)
#pragma unroll
      for (int row = 0; row < S2; ++row) bb[0][r * col + (long)row * C + c] = rhs(r, row, c);
  __syncthreads();
  int cur = 0, lev = 0;
  for (int d = 1; d < C; d *= 2, ++lev) {
    for (int r = 0; r < R; ++r) {
      const T* src = bb[cur] + r * col;
      T* dst = bb[cur ^ 1] + r * col;
      for (int c = threadIdx.x; c < C; c += blockDim.x) {
        const int cm = (c - d + C) % C, cp = (c + d) % C;
        T b[S2], bm[S2], bp[S2], ta[S2], tb[S2];
        load_vec<T, S2>(src, c, C, b);
        load_vec<T, S2>(src, cm, C, bm);
        load_vec<T, S2>(src, cp, C, bp);
        mv(load_blk<T, S2>(alphas, lev, c, C), bm, ta);
        mv(load_blk<T, S2>(betas, lev, c, C), bp, tb);
#pragma unroll
        for (int row = 0; row < S2; ++row) dst[(long)row * C + c] = b[row] + ta[row] + tb[row];
      }
    }
    __syncthreads();
    cur ^= 1;
  }
  for (int r = 0; r < R; ++r)
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      T b[S2], z[S2];
      load_vec<T, S2>(bb[cur] + r * col, c, C, b);
      mv(load_blk<T, S2>(Dinv, 0, c, C), b, z);
#pragma unroll
      for (int row = 0; row < S2; ++row) out[r * col + (long)row * C + c] = z[row];
    }
}

// The capacitance of the Woodbury closure: cap_inv (S2 x S2) is the
// inverse of cap = I + V^T Z, v_i reading y[S+i] at chunk C-1 (i < S) and
// y[i-S] at chunk 0 (i >= S), Z (S2 columns j, S2, C).  cap is inverted by
// Gauss-Jordan without pivoting (it is I plus a small correction for
// solver-grade dt), in shared memory, one thread per entry of the augmented
// matrix: blockDim must be >= 2 S2^2.  Z must be visible to the whole
// block; cap_inv may point to shared or global memory.  The caller syncs
// before reading it.
template <typename T, int S2>
__device__ __forceinline__ void woodbury_cap_block(const T* Z, T* cap_inv, int C) {
  constexpr int S = S2 / 2;
  __shared__ T a[S2][2 * S2];
  const int tid = threadIdx.x;
  if (tid < S2 * S2) {
    const int i = tid / S2, j = tid % S2;
    const T vtz = i < S ? Z[((long)j * S2 + S + i) * C + C - 1] : Z[((long)j * S2 + i - S) * C];
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

// The Woodbury closure of a ring factored acyclic in one block: Z (S2
// columns j, S2, C) solves the columns u_j = e_0 (x) Lred[:, S+j, 0] (j < S)
// and u_j = e_{C-1} (x) Ured[:, j-S, C-1] (j >= S), and cap_inv is the
// inverse of its capacitance (woodbury_cap_block): blockDim must be >= 2
// S2^2.  K6's body; K4 solves the columns over thread-block clusters
// (pcr.cu).  The caller syncs before reading cap_inv.
// scratch: 2 x (S2, S2, C)
template <typename T, int S2>
__device__ __forceinline__ void woodbury_block(const T* alphas, const T* betas, const T* Dinv,
                                               const T* Lred, const T* Ured, T* Z, T* cap_inv,
                                               T* scratch, int C) {
  constexpr int S = S2 / 2;
  pcr_solve_cols_block<T, S2>(
      alphas, betas, Dinv,
      [&](int j, int row, int c) -> T {
        if (j < S) return c == 0 ? Lred[((long)row * S2 + S + j) * C] : T(0);
        return c == C - 1 ? Ured[((long)row * S2 + j - S) * C + C - 1] : T(0);
      },
      Z, scratch, C, S2);
  __syncthreads();
  woodbury_cap_block<T, S2>(Z, cap_inv, C);
}

// The reduced solve of yred (S2, C) with the neighbour shifts: xm1[:, c]
// the bottom half of chunk c-1's solution, xp1[:, c] the top half of
// chunk c+1's, around the ring with `wrap` and zero past the ends without.
// With kWood (a Woodbury plan: Z and cap_inv from woodbury_block) the
// acyclic solution z is corrected first, z - sum_j coef_j Z_j with
// coef = cap_inv V^T z: the 2 S2 scalars vt and coef sit in shared memory,
// and every thread corrects the neighbour entries it shifts.  The
// correction is a template branch, not a runtime one, and the levels are
// not pcr_solve_cols_block's: on H100 either made the per-stage solve of
// block-cyclic plans slower (tools/ab_pcr_solve_shift.py, PERF.md).
// scratch: 2 x (S2, C)
template <typename T, int S2, bool kWood>
__device__ __forceinline__ void pcr_solve_shift_block(const T* alphas, const T* betas,
                                                      const T* Dinv, const T* yred, const T* Z,
                                                      const T* cap_inv, T* xm1, T* xp1,
                                                      T* scratch, int C, int wrap) {
  constexpr int S = S2 / 2;
  T* bb[2] = {scratch, scratch + (long)S2 * C};
  for (int c = threadIdx.x; c < C; c += blockDim.x)
#pragma unroll
    for (int r = 0; r < S2; ++r) bb[0][(long)r * C + c] = yred[(long)r * C + c];
  __syncthreads();
  int cur = 0, lev = 0;
  for (int d = 1; d < C; d *= 2, ++lev) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const int cm = (c - d + C) % C, cp = (c + d) % C;
      T b[S2], bm[S2], bp[S2], ta[S2], tb[S2];
      load_vec<T, S2>(bb[cur], c, C, b);
      load_vec<T, S2>(bb[cur], cm, C, bm);
      load_vec<T, S2>(bb[cur], cp, C, bp);
      mv(load_blk<T, S2>(alphas, lev, c, C), bm, ta);
      mv(load_blk<T, S2>(betas, lev, c, C), bp, tb);
#pragma unroll
      for (int r = 0; r < S2; ++r) bb[cur ^ 1][(long)r * C + c] = b[r] + ta[r] + tb[r];
    }
    __syncthreads();
    cur ^= 1;
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    T b[S2], z[S2];
    load_vec<T, S2>(bb[cur], c, C, b);
    mv(load_blk<T, S2>(Dinv, 0, c, C), b, z);
#pragma unroll
    for (int r = 0; r < S2; ++r) bb[cur ^ 1][(long)r * C + c] = z[r];
  }
  __syncthreads();
  const T* z = bb[cur ^ 1];
  if constexpr (kWood) {
    __shared__ T s_vt[S2], s_coef[S2];
    const int tid = threadIdx.x;
    if (tid < S2) s_vt[tid] = tid < S ? z[(long)(S + tid) * C + C - 1] : z[(long)(tid - S) * C];
    __syncthreads();
    if (tid < S2) {
      T acc = cap_inv[tid * S2] * s_vt[0];
#pragma unroll
      for (int i = 1; i < S2; ++i) acc += cap_inv[tid * S2 + i] * s_vt[i];
      s_coef[tid] = acc;
    }
    __syncthreads();
    auto y = [&](int row, int c) {
      T corr = s_coef[0] * Z[(long)row * C + c];
#pragma unroll
      for (int j = 1; j < S2; ++j) corr += s_coef[j] * Z[((long)j * S2 + row) * C + c];
      return z[(long)row * C + c] - corr;
    };
    // the ring is closed (a Woodbury plan wraps)
    for (int c = tid; c < C; c += blockDim.x) {
      const int cm = (c - 1 + C) % C, cp = (c + 1) % C;
#pragma unroll
      for (int r = 0; r < S; ++r) {
        xm1[(long)r * C + c] = y(S + r, cm);
        xp1[(long)r * C + c] = y(r, cp);
      }
    }
  } else {
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const int cm = (c - 1 + C) % C, cp = (c + 1) % C;
      const bool has_m = wrap || c != 0;
      const bool has_p = wrap || c != C - 1;
#pragma unroll
      for (int r = 0; r < S; ++r) {
        xm1[(long)r * C + c] = has_m ? z[(long)(S + r) * C + cm] : T(0);
        xp1[(long)r * C + c] = has_p ? z[(long)r * C + cp] : T(0);
      }
    }
  }
}

}  // namespace tf
