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
//
// The bodies live in pcr.cuh, shared with K6 (megastep.cu).
#include "pcr.cuh"

namespace {

constexpr int kThreads = 512;

template <typename T, int S2>
__global__ void __launch_bounds__(kThreads)
    pcr_factor_kernel(const T* __restrict__ Lred, const T* __restrict__ Ured, T* alphas,
                      T* betas, T* Dinv, T* scratch, int C, int cyclic) {
  tf::pcr_factor_block<T, S2>(Lred, Ured, alphas, betas, Dinv, scratch, C, cyclic);
}

template <typename T, int S2>
__global__ void __launch_bounds__(kThreads)
    pcr_solve_shift_kernel(const T* __restrict__ alphas, const T* __restrict__ betas,
                           const T* __restrict__ Dinv, const T* __restrict__ yred, T* xm1,
                           T* xp1, T* scratch, int C, int cyclic) {
  tf::pcr_solve_shift_block<T, S2>(alphas, betas, Dinv, yred, xm1, xp1, scratch, C, cyclic);
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
