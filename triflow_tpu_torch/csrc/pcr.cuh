// The bodies of K4 (pcr.cu), shared with K6 (megastep.cu): the PCR factor
// and the reduced solve with neighbour shifts, each run by ONE thread block
// whose threads stride over the C chunks; pcr.cu describes the algebra.
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

// scratch: 2 x (S2, C)
template <typename T, int S2>
__device__ __forceinline__ void pcr_solve_shift_block(const T* alphas, const T* betas,
                                                      const T* Dinv, const T* yred, T* xm1,
                                                      T* xp1, T* scratch, int C, int cyclic) {
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
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int cm = (c - 1 + C) % C, cp = (c + 1) % C;
    const bool has_m = cyclic || c != 0;
    const bool has_p = cyclic || c != C - 1;
#pragma unroll
    for (int r = 0; r < S; ++r) {
      xm1[(long)r * C + c] = has_m ? z[(long)(S + r) * C + cm] : T(0);
      xp1[(long)r * C + c] = has_p ? z[(long)r * C + cp] : T(0);
    }
  }
}

}  // namespace tf
