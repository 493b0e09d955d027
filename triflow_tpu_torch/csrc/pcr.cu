// K4: parallel cyclic reduction (PCR) of the chunk-interface system, two
// entries.
//
// Replaces, on the TPU: ops/pallas_pcr.py pcr_factor_fused_sub (factor)
// and interface_shift_solve (per right-hand side: reduced solve plus the
// neighbour shifts).  The Woodbury wrap correction of interface_shift_solve
// is not here: a periodic grid takes the block-cyclic form instead, which
// needs a power-of-two chunk count.
//
// The reduced system has C block rows of size S2 = 2S (unknowns
// (x_c^top, x_c^bot)), identity diagonal blocks and the couplings Lred
// (to chunk c-1) and Ured (to chunk c+1) written by K2, all stored
// chunk-minor (S2, S2, C).  PCR keeps all C rows at every level: level d
// combines row c with rows c -+ d,
//   alpha = -L_c Dinv_{c-d},  beta = -U_c Dinv_{c+d},
//   D' = D_c + alpha U_{c-d} + beta L_{c+d},  L' = alpha L_{c-d},
//   U' = beta U_{c+d},
// so after ceil(log2 C) levels the system is block-diagonal.  Acyclic rows
// whose neighbour falls outside keep no coupling; cyclic (C a power of two)
// rows wrap, and the couplings left at distance C are the diagonal itself.
//
// Both entries run in ONE thread block: the level loop is sequential, and
// __syncthreads() between the phases of a level makes each phase's global
// scratch writes visible to the whole block.  The reduced system is small
// (C <= 16384 rows of S2 x S2), so the kernel is bound by the latency of
// its 2 log2 C dependent phases, not by bandwidth or arithmetic; one block
// avoids any grid-wide synchronisation.
#include "common.cuh"

namespace {

using tf::Blk;

constexpr int kThreads = 512;

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
__global__ void __launch_bounds__(kThreads)
    pcr_factor_kernel(const T* __restrict__ Lred, const T* __restrict__ Ured, T* alphas,
                      T* betas, T* Dinv, T* scratch, int C, int cyclic) {
  const long sz = (long)S2 * S2 * C;
  T* Lb[2] = {scratch, scratch + 3 * sz};
  T* Db[2] = {scratch + sz, scratch + 4 * sz};
  T* Ub[2] = {scratch + 2 * sz, scratch + 5 * sz};
  T* Dt = scratch + 6 * sz;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    Blk<T, S2> I;
    tf::eye(I);
    tf::store_blk(Lb[0], 0, c, C, tf::load_blk<T, S2>(Lred, 0, c, C));
    tf::store_blk(Ub[0], 0, c, C, tf::load_blk<T, S2>(Ured, 0, c, C));
    tf::store_blk(Db[0], 0, c, C, I);
  }
  __syncthreads();
  int cur = 0, lev = 0;
  for (int d = 1; d < C; d *= 2, ++lev) {
    for (int c = threadIdx.x; c < C; c += blockDim.x)
      tf::store_blk(Dt, 0, c, C, tf::inv(tf::load_blk<T, S2>(Db[cur], 0, c, C)));
    __syncthreads();
    const int nxt = cur ^ 1;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const int cm = (c - d + C) % C, cp = (c + d) % C;
      Blk<T, S2> alpha = neg(tf::mm(tf::load_blk<T, S2>(Lb[cur], 0, c, C),
                                    tf::load_blk<T, S2>(Dt, 0, cm, C)));
      Blk<T, S2> beta = neg(tf::mm(tf::load_blk<T, S2>(Ub[cur], 0, c, C),
                                   tf::load_blk<T, S2>(Dt, 0, cp, C)));
      if (!cyclic && c < d) tf::zero(alpha);
      if (!cyclic && c >= C - d) tf::zero(beta);
      const Blk<T, S2> Lm = tf::load_blk<T, S2>(Lb[cur], 0, cm, C);
      const Blk<T, S2> Um = tf::load_blk<T, S2>(Ub[cur], 0, cm, C);
      const Blk<T, S2> Lp = tf::load_blk<T, S2>(Lb[cur], 0, cp, C);
      const Blk<T, S2> Up = tf::load_blk<T, S2>(Ub[cur], 0, cp, C);
      const Blk<T, S2> D = add(add(tf::load_blk<T, S2>(Db[cur], 0, c, C), tf::mm(alpha, Um)),
                               tf::mm(beta, Lp));
      tf::store_blk(Db[nxt], 0, c, C, D);
      tf::store_blk(Lb[nxt], 0, c, C, tf::mm(alpha, Lm));
      tf::store_blk(Ub[nxt], 0, c, C, tf::mm(beta, Up));
      tf::store_blk(alphas, lev, c, C, alpha);
      tf::store_blk(betas, lev, c, C, beta);
    }
    __syncthreads();
    cur = nxt;
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    Blk<T, S2> D = tf::load_blk<T, S2>(Db[cur], 0, c, C);
    if (cyclic)
      D = add(D, add(tf::load_blk<T, S2>(Lb[cur], 0, c, C), tf::load_blk<T, S2>(Ub[cur], 0, c, C)));
    tf::store_blk(Dinv, 0, c, C, tf::inv(D));
  }
}

template <typename T, int S2>
__device__ __forceinline__ void load_vec(const T* p, int c, int C, T (&v)[S2]) {
#pragma unroll
  for (int r = 0; r < S2; ++r) v[r] = p[(long)r * C + c];
}

template <typename T, int S2>
__global__ void __launch_bounds__(kThreads)
    pcr_solve_shift_kernel(const T* __restrict__ alphas, const T* __restrict__ betas,
                           const T* __restrict__ Dinv, const T* __restrict__ yred, T* xm1,
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
      tf::mv(tf::load_blk<T, S2>(alphas, lev, c, C), bm, ta);
      tf::mv(tf::load_blk<T, S2>(betas, lev, c, C), bp, tb);
#pragma unroll
      for (int r = 0; r < S2; ++r) bb[cur ^ 1][(long)r * C + c] = b[r] + ta[r] + tb[r];
    }
    __syncthreads();
    cur ^= 1;
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    T b[S2], z[S2];
    load_vec<T, S2>(bb[cur], c, C, b);
    tf::mv(tf::load_blk<T, S2>(Dinv, 0, c, C), b, z);
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

template <typename T>
int factor(const T* Lred, const T* Ured, T* alphas, T* betas, T* Dinv, T* scratch, int C,
           int S2, int cyclic, cudaStream_t stream) {
  switch (S2) {
#define TF_CASE(S2)                                                                     \
  case S2:                                                                              \
    pcr_factor_kernel<T, S2><<<1, kThreads, 0, stream>>>(Lred, Ured, alphas, betas,     \
                                                         Dinv, scratch, C, cyclic);     \
    break;
    TF_CASE(2)
    TF_CASE(4)
    TF_CASE(6)
    TF_CASE(8)
#undef TF_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int solve_shift(const T* alphas, const T* betas, const T* Dinv, const T* yred, T* xm1, T* xp1,
                T* scratch, int C, int S2, int cyclic, cudaStream_t stream) {
  switch (S2) {
#define TF_CASE(S2)                                                                    \
  case S2:                                                                             \
    pcr_solve_shift_kernel<T, S2><<<1, kThreads, 0, stream>>>(                         \
        alphas, betas, Dinv, yred, xm1, xp1, scratch, C, cyclic);                      \
    break;
    TF_CASE(2)
    TF_CASE(4)
    TF_CASE(6)
    TF_CASE(8)
#undef TF_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define TF_ENTRIES(SUFFIX, T)                                                              \
  extern "C" int tf_pcr_factor_##SUFFIX(const void* Lred, const void* Ured, void* alphas, \
                                        void* betas, void* Dinv, void* scratch, int C,    \
                                        int S2, int cyclic, void* stream) {               \
    return factor<T>(static_cast<const T*>(Lred), static_cast<const T*>(Ured),            \
                     static_cast<T*>(alphas), static_cast<T*>(betas),                     \
                     static_cast<T*>(Dinv), static_cast<T*>(scratch), C, S2, cyclic,      \
                     static_cast<cudaStream_t>(stream));                                  \
  }                                                                                       \
  extern "C" int tf_pcr_solve_shift_##SUFFIX(const void* alphas, const void* betas,       \
                                             const void* Dinv, const void* yred,          \
                                             void* xm1, void* xp1, void* scratch, int C,  \
                                             int S2, int cyclic, void* stream) {          \
    return solve_shift<T>(static_cast<const T*>(alphas), static_cast<const T*>(betas),    \
                          static_cast<const T*>(Dinv), static_cast<const T*>(yred),       \
                          static_cast<T*>(xm1), static_cast<T*>(xp1),                     \
                          static_cast<T*>(scratch), C, S2, cyclic,                        \
                          static_cast<cudaStream_t>(stream));                             \
  }

TF_ENTRIES(f32, float)
TF_ENTRIES(f64, double)
