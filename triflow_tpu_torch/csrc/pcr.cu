// K4: parallel cyclic reduction (PCR) of the chunk-interface system, three
// entries.
//
// Replaces, on the TPU: ops/pallas_pcr.py pcr_factor_fused_sub (factor),
// pcr_solve_fused_sub (the solve of R right-hand sides; here it also sets
// up the Woodbury closure, folded._reduced_factor's wrap branch) and
// interface_shift_solve (per right-hand side: reduced solve, the Woodbury
// correction where the plan has one, and the neighbour shifts).
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
// A periodic ring on any other chunk count is factored acyclic (its corner
// blocks Lred[..., 0] and Ured[..., C-1] are never read: the acyclic
// alpha / beta of those rows are zero) and closed by a rank-S2 Woodbury
// correction A^-1 b = y - Z (I + V^T Z)^-1 V^T y, y = A0^-1 b, where the
// columns U carry the corner blocks and V^T reads the two ring-end
// unknowns (pcr.cuh: woodbury_block).  The solve entry sets it up in one
// launch per factor: the S2 columns of Z share every level's phase and
// sync (the TPU kernel ran its right-hand sides' levels one after the
// other), and the S2 x S2 capacitance is inverted in shared memory.
//
// Every entry runs one thread block per member (gridDim.x = B, the
// members of an ensemble; 1 for one grid): the level loop is sequential,
// and __syncthreads() between the phases of a level makes each phase's
// global scratch writes visible to the whole block.  Member b's arrays sit
// at b times one member's size (Lred, Ured, Dinv, Z (B, S2, S2, C), the
// level operators (B, nlev, S2, S2, C), right-hand sides (B, R, S2, C) and
// yred (B, S2, C), cap_inv (B, S2, S2), xm1 and xp1 (B, S, C), and every
// scratch), so members run on separate SMs and never couple.  The reduced system is small
// (C <= 16384 rows of S2 x S2), so the kernel is bound by the latency of
// its 2 log2 C dependent phases, not by bandwidth or arithmetic; one block
// avoids any grid-wide synchronisation.
//
// The bodies live in pcr.cuh, shared with K6 (megastep.cu).
//
// Wide interface blocks (S2 = 10..16, of K2's S = 5..8) are built into a
// library of their own, from this file with TF_WIDE defined.  The solves
// keep pcr.cuh's bodies (vectors of S2 entries per thread); the factor,
// whose S2 x S2 products and inverses do not fit one thread's registers,
// runs each chunk's level on a group of S2 lanes, lane r holding row r of
// every block (wide.cuh: pcr_factor_block_wide below).
#include "pcr.cuh"
#include "wide.cuh"

namespace {

constexpr int kThreads = 512;

#ifdef TF_WIDE
#define TF_CASES TF_CASE(10) TF_CASE(12) TF_CASE(14) TF_CASE(16)
#else
#define TF_CASES TF_CASE(2) TF_CASE(4) TF_CASE(6) TF_CASE(8)
#endif

// pcr.cuh's pcr_factor_block for wide blocks: every phase walks the chunks
// in passes of (warps x 32 / S2) groups, one group of S2 lanes per chunk,
// the same products and sums in the same order.  A lane of no chunk in
// the last pass computes on chunk C - 1 and stores nothing.
// scratch: 7 x (S2, S2, C)
template <typename T, int S2>
__device__ __forceinline__ void pcr_factor_block_wide(const T* Lred, const T* Ured, T* alphas,
                                                      T* betas, T* Dinv, T* scratch, int C,
                                                      int cyclic) {
  using Row = tf::Row<T, S2>;
  constexpr int G = 32 / S2;
  const long sz = (long)S2 * S2 * C;
  T* Lb[2] = {scratch, scratch + 3 * sz};
  T* Db[2] = {scratch + sz, scratch + 4 * sz};
  T* Ub[2] = {scratch + 2 * sz, scratch + 5 * sz};
  T* Dt = scratch + 6 * sz;
  for (long e = threadIdx.x; e < sz; e += blockDim.x) {
    Lb[0][e] = Lred[e];
    Ub[0][e] = Ured[e];
    Db[0][e] = (e / C) % S2 == e / ((long)S2 * C) ? T(1) : T(0);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, grp = tf::group_of_lane<S2>(lane);
  const tf::Group g{grp * S2, lane - grp * S2};
  const int r = g.r, per_pass = (blockDim.x >> 5) * G;
  const int first = (threadIdx.x >> 5) * G + grp;
  int cur = 0, lev = 0;
  for (int d = 1; d < C; d *= 2, ++lev) {
    for (int c0 = 0; c0 < C; c0 += per_pass) {
      const bool store = grp < G && c0 + first < C;
      const int c = store ? c0 + first : C - 1;
      const Row di = tf::inv(tf::load_row<T, S2>(Db[cur], 0, r, c, C), g);
      if (store) tf::store_row(Dt, 0, r, c, C, di);
    }
    __syncthreads();
    const int nxt = cur ^ 1;
    for (int c0 = 0; c0 < C; c0 += per_pass) {
      const bool store = grp < G && c0 + first < C;
      const int c = store ? c0 + first : C - 1;
      const int cm = (c - d + C) % C, cp = (c + d) % C;
      // alpha's terms first, then beta's: fewer rows live at once
      Row alpha = tf::neg(tf::mm(tf::load_row<T, S2>(Lb[cur], 0, r, c, C),
                                 tf::load_row<T, S2>(Dt, 0, r, cm, C), g));
      if (!cyclic && c < d) alpha = tf::zero_row<T, S2>();
      const Row Lnew = tf::mm(alpha, tf::load_row<T, S2>(Lb[cur], 0, r, cm, C), g);
      const Row Dpart = tf::add(tf::load_row<T, S2>(Db[cur], 0, r, c, C),
                                tf::mm(alpha, tf::load_row<T, S2>(Ub[cur], 0, r, cm, C), g));
      if (store) {
        tf::store_row(alphas, lev, r, c, C, alpha);
        tf::store_row(Lb[nxt], 0, r, c, C, Lnew);
      }
      Row beta = tf::neg(tf::mm(tf::load_row<T, S2>(Ub[cur], 0, r, c, C),
                                tf::load_row<T, S2>(Dt, 0, r, cp, C), g));
      if (!cyclic && c >= C - d) beta = tf::zero_row<T, S2>();
      const Row Unew = tf::mm(beta, tf::load_row<T, S2>(Ub[cur], 0, r, cp, C), g);
      const Row D = tf::add(Dpart, tf::mm(beta, tf::load_row<T, S2>(Lb[cur], 0, r, cp, C), g));
      if (store) {
        tf::store_row(betas, lev, r, c, C, beta);
        tf::store_row(Ub[nxt], 0, r, c, C, Unew);
        tf::store_row(Db[nxt], 0, r, c, C, D);
      }
    }
    __syncthreads();
    cur = nxt;
  }
  for (int c0 = 0; c0 < C; c0 += per_pass) {
    const bool store = grp < G && c0 + first < C;
    const int c = store ? c0 + first : C - 1;
    Row D = tf::load_row<T, S2>(Db[cur], 0, r, c, C);
    if (cyclic)
      D = tf::add(D, tf::add(tf::load_row<T, S2>(Lb[cur], 0, r, c, C),
                             tf::load_row<T, S2>(Ub[cur], 0, r, c, C)));
    const Row di = tf::inv(D, g);
    if (store) tf::store_row(Dinv, 0, r, c, C, di);
  }
}

__device__ __forceinline__ int levels(int C) {
  int n = 0;
  for (int d = 1; d < C; d *= 2) ++n;
  return n;
}

template <typename T, int S2, bool kMembers>
__global__ void __launch_bounds__(kThreads)
    pcr_factor_kernel(const T* __restrict__ Lred, const T* __restrict__ Ured, T* alphas,
                      T* betas, T* Dinv, T* scratch, int C, int cyclic) {
  const long b = kMembers ? blockIdx.x : 0, blk = (long)S2 * S2 * C,
             ops = kMembers ? levels(C) * blk : 0;
  if constexpr (S2 > 8)
    pcr_factor_block_wide<T, S2>(Lred + b * blk, Ured + b * blk, alphas + b * ops,
                                 betas + b * ops, Dinv + b * blk, scratch + b * 7 * blk, C,
                                 cyclic);
  else
    tf::pcr_factor_block<T, S2>(Lred + b * blk, Ured + b * blk, alphas + b * ops,
                                betas + b * ops, Dinv + b * blk, scratch + b * 7 * blk, C,
                                cyclic);
}

template <typename T, int S2, bool kMembers>
__global__ void __launch_bounds__(kThreads)
    pcr_solve_kernel(const T* __restrict__ alphas, const T* __restrict__ betas,
                     const T* __restrict__ Dinv, const T* __restrict__ b,
                     const T* __restrict__ Lred, const T* __restrict__ Ured, T* out, T* cap_inv,
                     T* scratch, int C, int R) {
  // woodbury_block inverts the capacitance with one thread per entry of
  // [cap | I]: every instantiated S2 needs 2 S2^2 <= kThreads (512 at 16)
  static_assert(2 * S2 * S2 <= kThreads, "the Woodbury set-up needs 2 S2^2 threads");
  if constexpr (kMembers) {
    const long m = blockIdx.x, blk = (long)S2 * S2 * C, ops = levels(C) * blk;
    const long col = (long)S2 * C, cols = R * col;
    if (b) {
      tf::pcr_solve_cols_block<T, S2>(
          alphas + m * ops, betas + m * ops, Dinv + m * blk,
          [&](int r, int row, int c) { return b[m * cols + r * col + (long)row * C + c]; },
          out + m * cols, scratch + m * 2 * cols, C, R);
    } else {
      tf::woodbury_block<T, S2>(alphas + m * ops, betas + m * ops, Dinv + m * blk,
                                Lred + m * blk, Ured + m * blk, out + m * blk,
                                cap_inv + m * S2 * S2, scratch + m * 2 * cols, C);
    }
  } else {
    // one grid: the body without member offsets, as it was before them (the
    // same source with offsets that fold to zero compiled 35 % slower on
    // H100 for the Woodbury set-up, with as many instructions; PERF.md)
    if (b) {
      const long col = (long)S2 * C;
      tf::pcr_solve_cols_block<T, S2>(
          alphas, betas, Dinv, [&](int r, int row, int c) { return b[r * col + (long)row * C + c]; },
          out, scratch, C, R);
    } else {
      tf::woodbury_block<T, S2>(alphas, betas, Dinv, Lred, Ured, out, cap_inv, scratch, C);
    }
  }
}

template <typename T, int S2, bool kWood, bool kMembers>
__global__ void __launch_bounds__(kThreads)
    pcr_solve_shift_kernel(const T* __restrict__ alphas, const T* __restrict__ betas,
                           const T* __restrict__ Dinv, const T* __restrict__ yred,
                           const T* __restrict__ Z, const T* __restrict__ cap_inv, T* xm1,
                           T* xp1, T* scratch, int C, int wrap) {
  const long m = kMembers ? blockIdx.x : 0, blk = (long)S2 * S2 * C,
             ops = kMembers ? levels(C) * blk : 0;
  const long col = (long)S2 * C, half = col / 2;
  tf::pcr_solve_shift_block<T, S2, kWood>(
      alphas + m * ops, betas + m * ops, Dinv + m * blk, yred + m * col,
      kWood ? Z + m * blk : Z, kWood ? cap_inv + m * S2 * S2 : cap_inv, xm1 + m * half,
      xp1 + m * half, scratch + m * 2 * col, C, wrap);
}

template <typename T>
int factor(const T* Lred, const T* Ured, T* alphas, T* betas, T* Dinv, T* scratch, int C,
           int S2, int cyclic, int B, cudaStream_t stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (S2) {
#define TF_CASE(S2)                                                                       \
  case S2:                                                                                \
    if (B > 1)                                                                            \
      pcr_factor_kernel<T, S2, true><<<B, kThreads, 0, stream>>>(Lred, Ured, alphas,      \
                                                                 betas, Dinv, scratch, C, \
                                                                 cyclic);                 \
    else                                                                                  \
      pcr_factor_kernel<T, S2, false><<<1, kThreads, 0, stream>>>(Lred, Ured, alphas,     \
                                                                  betas, Dinv, scratch,   \
                                                                  C, cyclic);             \
    break;
    TF_CASES
#undef TF_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// b (B, R, S2, C) -> out; or, b null, the Woodbury set-up (R = S2): out = Z,
// and cap_inv
template <typename T>
int solve(const T* alphas, const T* betas, const T* Dinv, const T* b, const T* Lred,
          const T* Ured, T* out, T* cap_inv, T* scratch, int C, int S2, int R, int B,
          cudaStream_t stream) {
  if (R < 1 || B < 1 || (!b && (R != S2 || !Lred || !Ured || !cap_inv || C < 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (S2) {
#define TF_CASE(S2)                                                                     \
  case S2:                                                                              \
    if (B > 1)                                                                          \
      pcr_solve_kernel<T, S2, true><<<B, kThreads, 0, stream>>>(                        \
          alphas, betas, Dinv, b, Lred, Ured, out, cap_inv, scratch, C, R);             \
    else                                                                                \
      pcr_solve_kernel<T, S2, false><<<1, kThreads, 0, stream>>>(                       \
          alphas, betas, Dinv, b, Lred, Ured, out, cap_inv, scratch, C, R);             \
    break;
    TF_CASES
#undef TF_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Z and cap_inv null: no Woodbury correction
template <typename T>
int solve_shift(const T* alphas, const T* betas, const T* Dinv, const T* yred, const T* Z,
                const T* cap_inv, T* xm1, T* xp1, T* scratch, int C, int S2, int wrap, int B,
                cudaStream_t stream) {
  if (B < 1 || (Z && (!cap_inv || !wrap))) return static_cast<int>(cudaErrorInvalidValue);
  switch (S2) {
#define TF_LAUNCH(S2, WOOD, MEM)                                                        \
  pcr_solve_shift_kernel<T, S2, WOOD, MEM><<<B, kThreads, 0, stream>>>(                 \
      alphas, betas, Dinv, yred, Z, cap_inv, xm1, xp1, scratch, C, wrap)
#define TF_CASE(S2)                                                                     \
  case S2:                                                                              \
    if (Z && B > 1)                                                                     \
      TF_LAUNCH(S2, true, true);                                                        \
    else if (Z)                                                                         \
      TF_LAUNCH(S2, true, false);                                                       \
    else if (B > 1)                                                                     \
      TF_LAUNCH(S2, false, true);                                                       \
    else                                                                                \
      TF_LAUNCH(S2, false, false);                                                      \
    break;
    TF_CASES
#undef TF_CASE
#undef TF_LAUNCH
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define TF_ENTRIES(SUFFIX, T)                                                              \
  extern "C" int tf_pcr_factor_##SUFFIX(const void* Lred, const void* Ured, void* alphas, \
                                        void* betas, void* Dinv, void* scratch, int C,    \
                                        int S2, int cyclic, int B, void* stream) {        \
    return factor<T>(static_cast<const T*>(Lred), static_cast<const T*>(Ured),            \
                     static_cast<T*>(alphas), static_cast<T*>(betas),                     \
                     static_cast<T*>(Dinv), static_cast<T*>(scratch), C, S2, cyclic, B,   \
                     static_cast<cudaStream_t>(stream));                                  \
  }                                                                                       \
  extern "C" int tf_pcr_solve_##SUFFIX(const void* alphas, const void* betas,             \
                                       const void* Dinv, const void* b, const void* Lred, \
                                       const void* Ured, void* out, void* cap_inv,        \
                                       void* scratch, int C, int S2, int R, int B,        \
                                       void* stream) {                                    \
    return solve<T>(static_cast<const T*>(alphas), static_cast<const T*>(betas),          \
                    static_cast<const T*>(Dinv), static_cast<const T*>(b),                \
                    static_cast<const T*>(Lred), static_cast<const T*>(Ured),             \
                    static_cast<T*>(out), static_cast<T*>(cap_inv),                       \
                    static_cast<T*>(scratch), C, S2, R, B,                                \
                    static_cast<cudaStream_t>(stream));                                   \
  }                                                                                       \
  extern "C" int tf_pcr_solve_shift_##SUFFIX(const void* alphas, const void* betas,       \
                                             const void* Dinv, const void* yred,          \
                                             const void* Z, const void* cap_inv,          \
                                             void* xm1, void* xp1, void* scratch, int C,  \
                                             int S2, int wrap, int B, void* stream) {     \
    return solve_shift<T>(static_cast<const T*>(alphas), static_cast<const T*>(betas),    \
                          static_cast<const T*>(Dinv), static_cast<const T*>(yred),       \
                          static_cast<const T*>(Z), static_cast<const T*>(cap_inv),       \
                          static_cast<T*>(xm1), static_cast<T*>(xp1),                     \
                          static_cast<T*>(scratch), C, S2, wrap, B,                       \
                          static_cast<cudaStream_t>(stream));                             \
  }

TF_ENTRIES(f32, float)
TF_ENTRIES(f64, double)
