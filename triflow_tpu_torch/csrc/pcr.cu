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
#include "pcr.cuh"

namespace {

constexpr int kThreads = 512;

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
    TF_CASE(2)
    TF_CASE(4)
    TF_CASE(6)
    TF_CASE(8)
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
