// K3: the per-right-hand-side part of the chunked SPIKE solve, two entries.
//
// Replaces, on the TPU: ops/pallas_thomas.py chunked_solve_flat (the
// chunk-local forward and backward Thomas sweeps) and the spike correction
// of ops/folded.py _solve_folded_flat, which the reference left to an XLA
// expression with the state add (`add_to`) fused in.
//
// thomas_sweep: one thread per chunk.  With the factors of K2 it solves the
// chunk-local system with the outer couplings removed,
//   bt_j = b_j - fac_j bt_{j-1},   y_j = Dh_j bt_j - DU_j y_{j+1},
// writes y in the node layout (nvar, N) of the right-hand side, and the
// interface right-hand side yred (2S, C) = (y_0, y_{Mc-1}) of every chunk.
//
// spike_correct: one thread per node.  With the interface unknowns of the
// neighbours from K4 (xm1 = x_{c-1}^bot, xp1 = x_{c+1}^top, each (S, C)),
//   x = y - W xm1 - V xp1   (+ add_to, the theta step's u + A^-1 dt F).
//
// Member axis: both entries take B grids (an ensemble) in one launch, one
// thread per (member, chunk) or (member, node); member b's arrays sit at b
// times one grid's size (rhs, y, add_to and out (B, nvar, N), factor rows
// (B, Mc, S, S, C), yred (B, 2S, C), xm1 and xp1 (B, S, C)).  One grid
// (B = 1) launches the instantiations without member offsets (kMembers).
//
// Bound: the sweep is latency-bound along the Mc sequential rows of a
// chunk, like K2; its node-layout reads and writes are strided by Mc * g
// between neighbour threads.  The correction is elementwise and
// bandwidth-bound: it reads y, the two spikes and add_to once and writes x
// once.
//
// The bodies live in sweep.cuh, shared with K6 (megastep.cu).
//
// Wide blocks (S = 5..8) are built into a library of their own, from this
// file with TF_WIDE defined: the same bodies, one thread per chunk or node.
// They hold vectors of S entries and stream each block's entries into a
// product, so unlike K2 and K4's factor they need no group of lanes.
#include "sweep.cuh"

#ifdef TF_WIDE
#define TF_CASES TF_CASE(5) TF_CASE(6) TF_CASE(7) TF_CASE(8)
#else
#define TF_CASES TF_CASE(1) TF_CASE(2) TF_CASE(3) TF_CASE(4)
#endif

namespace {

template <typename T, int S, bool kMembers>
__global__ void thomas_sweep_kernel(const T* __restrict__ fac, const T* __restrict__ Dhinv,
                                    const T* __restrict__ DU, const T* __restrict__ rhs, T* y,
                                    T* yred, int N, int nvar, int g, int Mc, int C, int B) {
  if constexpr (kMembers) {
    const long q = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= (long)B * C) return;
    const int b = (int)(q / C), c = (int)(q % C);
    const long rows = (long)Mc * S * S * C, n = (long)nvar * N;
    tf::thomas_sweep_chunk<T, S>(fac + b * rows, Dhinv + b * rows, DU + b * rows, rhs + b * n,
                                 y + b * n, yred + b * 2L * S * C, N, nvar, g, Mc, C, c);
  } else {
    // one grid: the member-free text, whose code runs faster than the
    // member version with b folded to 0 (PERF.md)
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= C) return;
    tf::thomas_sweep_chunk<T, S>(fac, Dhinv, DU, rhs, y, yred, N, nvar, g, Mc, C, c);
  }
}

template <typename T, int S, bool kMembers>
__global__ void spike_correct_kernel(const T* __restrict__ y, const T* __restrict__ Wsp,
                                     const T* __restrict__ Vsp, const T* __restrict__ xm1,
                                     const T* __restrict__ xp1, const T* __restrict__ add_to,
                                     T* out, int N, int nvar, int g, int Mc, int C,
                                     int has_add, int B) {
  const long q = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (long)B * N) return;
  const long b = kMembers ? q / N : 0, i = kMembers ? q % N : q;
  const long rows = (long)Mc * S * S * C, n = (long)nvar * N, sc = (long)S * C;
  tf::spike_correct_node<T, S>(y + b * n, Wsp + b * rows, Vsp + b * rows, xm1 + b * sc,
                               xp1 + b * sc, has_add ? add_to + b * n : nullptr, out + b * n,
                               N, nvar, g, Mc, C, i);
}

template <typename T>
int sweep(const T* fac, const T* Dhinv, const T* DU, const T* rhs, T* y, T* yred, int N,
          int nvar, int g, int Mc, int C, int B, cudaStream_t stream) {
  const int threads = 128;
  const long blocks = ((long)B * C + threads - 1) / threads;
  switch (nvar * g) {
#define TF_LAUNCH(S, MEM)                                                               \
  thomas_sweep_kernel<T, S, MEM><<<blocks, threads, 0, stream>>>(fac, Dhinv, DU, rhs, y, \
                                                                 yred, N, nvar, g, Mc, C, B)
#define TF_CASE(S)                                                                      \
  case S:                                                                               \
    if (B > 1)                                                                          \
      TF_LAUNCH(S, true);                                                               \
    else                                                                                \
      TF_LAUNCH(S, false);                                                              \
    break;
    TF_CASES
#undef TF_CASE
#undef TF_LAUNCH
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int correct(const T* y, const T* W, const T* V, const T* xm1, const T* xp1, const T* add_to,
            T* out, int N, int nvar, int g, int Mc, int C, int has_add, int B,
            cudaStream_t stream) {
  const int threads = 256;
  const long blocks = ((long)B * N + threads - 1) / threads;
  switch (nvar * g) {
#define TF_LAUNCH(S, MEM)                                                            \
  spike_correct_kernel<T, S, MEM><<<blocks, threads, 0, stream>>>(                   \
      y, W, V, xm1, xp1, add_to, out, N, nvar, g, Mc, C, has_add, B)
#define TF_CASE(S)                                                                   \
  case S:                                                                            \
    if (B > 1)                                                                       \
      TF_LAUNCH(S, true);                                                            \
    else                                                                             \
      TF_LAUNCH(S, false);                                                           \
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

#define TF_ENTRIES(SUFFIX, T)                                                             \
  extern "C" int tf_thomas_sweep_##SUFFIX(const void* fac, const void* Dhinv,            \
                                          const void* DU, const void* rhs, void* y,      \
                                          void* yred, int N, int nvar, int g, int Mc,    \
                                          int C, int B, void* stream) {                  \
    return sweep<T>(static_cast<const T*>(fac), static_cast<const T*>(Dhinv),            \
                    static_cast<const T*>(DU), static_cast<const T*>(rhs),               \
                    static_cast<T*>(y), static_cast<T*>(yred), N, nvar, g, Mc, C, B,     \
                    static_cast<cudaStream_t>(stream));                                  \
  }                                                                                      \
  extern "C" int tf_spike_correct_##SUFFIX(const void* y, const void* W, const void* V,  \
                                           const void* xm1, const void* xp1,             \
                                           const void* add_to, void* out, int N,         \
                                           int nvar, int g, int Mc, int C, int has_add,  \
                                           int B, void* stream) {                        \
    return correct<T>(static_cast<const T*>(y), static_cast<const T*>(W),                \
                      static_cast<const T*>(V), static_cast<const T*>(xm1),              \
                      static_cast<const T*>(xp1), static_cast<const T*>(add_to),         \
                      static_cast<T*>(out), N, nvar, g, Mc, C, has_add, B,               \
                      static_cast<cudaStream_t>(stream));                                \
  }

TF_ENTRIES(f32, float)
TF_ENTRIES(f64, double)
