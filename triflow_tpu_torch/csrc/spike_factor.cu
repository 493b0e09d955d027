// K2: chunked block-Thomas / SPIKE factorization of A = alpha*I + beta*J,
// read straight from the banded J.
//
// Replaces, on the TPU: ops/folded.py factor_sweeps_folded (the forward
// sweep, fwd_kernel) and ops/pallas_thomas.py _bwd_factor_call_cols (the
// backward spike sweep).  The TPU ran them as two launches only because its
// grid is sequential; here one thread walks one chunk through both sweeps.
//
// Layout.  The N nodes form M = N / g supernodes of g = max(halo, 1) nodes
// (block size S = nvar * g, entry a * nvar + m = variable m at local node
// a).  Chunk c owns supernodes [c * Mc, (c + 1) * Mc).  Every per-row output
// is stored chunk-minor, (Mc, S, S, C), so the threads of a warp (neighbour
// chunks) touch neighbouring addresses.
//
// Per chunk, rows j = 0 .. Mc-1 of the block-tridiagonal system (L_j, D_j,
// U_j) are assembled from the bands (the reference's
// _row_from_folded_bands), the chunk's outer couplings Tl = L_0 and
// Tr = U_{Mc-1} are split off, and
//   forward:  fac_j = L_j Dh_{j-1},  Dh_j = (D_j - fac_j U_{j-1})^-1,
//             wt_j  = Tl (j = 0) or -fac_j wt_{j-1}
//   backward: DU_j = Dh_j U_j,  W_j = Dh_j wt_j - DU_j W_{j+1},
//             V_j  = Dh_j [Tr if j = Mc-1] - DU_j V_{j+1}
// It then writes the chunk's rows of the 2S x 2S reduced interface system
// (the reference's _reduced_LU): unknowns (x_c^top, x_c^bot) couple to
// x_{c-1}^bot through W and to x_{c+1}^top through V.  With `wrap` the
// wrap couplings of chunks 0 and C-1 stay (the periodic ring closes inside
// the reduced system, block-cyclic or through K4's Woodbury correction):
// Lred[..., 0] and Ured[..., C-1] hold the ring's corner blocks; otherwise
// they are zeroed.
//
// Member axis: an ensemble's B grids factor in one launch, one thread per
// (member, chunk), B * C threads.  Every array of member b is one grid's
// layout at an offset of b times its size (bands (B, W, nvar, nvar, N),
// rows (B, Mc, S, S, C), reduced couplings (B, 2S, 2S, C)); members never
// couple, so each member's chunk 0 and chunk C-1 close its own ring.  The
// factor shift beta is a number, or (beta_b not null) member b's entry of a
// device array: shared and per-member step sizes take one code.  One grid
// (B = 1) launches the instantiation without member offsets (kMembers).
//
// Bound: each step of the sweep reads its band rows and writes five S x S
// blocks, and the Mc steps of a chunk are sequential, so the kernel is
// bound by memory latency along the sweep rather than by bandwidth or
// arithmetic.  The design answers with many independent chunks (one thread
// each, C up to 16384) and coalesced chunk-minor stores.  The band reads
// are node-major (stride Mc * g between neighbour threads); that is the
// first thing to fix when this kernel is made fast.
//
// The bodies live in factor.cuh, shared with K6 (megastep.cu).
#include "factor.cuh"

namespace {

template <typename T, int S, bool kMembers>
__global__ void spike_factor_kernel(const T* __restrict__ bands, T* fac, T* Dhinv, T* DU,
                                    T* Wsp, T* Vsp, T* Lred, T* Ured,
                                    const T* __restrict__ beta_b, int N, int nvar, int g,
                                    int h, int Mc, int C, int wrap, int B, T alpha, T beta) {
  const long q = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (long)B * C) return;
  const int b = kMembers ? (int)(q / C) : 0, c = kMembers ? (int)(q % C) : (int)q;
  const long band = (long)(2 * h + 1) * nvar * nvar * N;
  const long rows = (long)Mc * S * S * C;
  const long red = 4L * S * S * C;
  tf::spike_factor_chunk<T, S>(bands + b * band, fac + b * rows, Dhinv + b * rows,
                               DU + b * rows, Wsp + b * rows, Vsp + b * rows,
                               Lred + b * red, Ured + b * red, N, nvar, g, h, Mc, C, wrap,
                               alpha, beta_b ? beta_b[b] : beta, c);
}

template <typename T>
int launch(const T* bands, T* fac, T* Dhinv, T* DU, T* W, T* V, T* Lred, T* Ured,
           const T* beta_b, int N, int nvar, int g, int h, int Mc, int C, int wrap, int B,
           double alpha, double beta, cudaStream_t stream) {
  const int threads = 128;
  const long blocks = ((long)B * C + threads - 1) / threads;
  const T a = T(alpha), bt = T(beta);
  switch (nvar * g) {
#define TF_LAUNCH(S, MEM)                                                               \
  spike_factor_kernel<T, S, MEM><<<blocks, threads, 0, stream>>>(                       \
      bands, fac, Dhinv, DU, W, V, Lred, Ured, beta_b, N, nvar, g, h, Mc, C, wrap, B, a, bt)
#define TF_CASE(S)                                                                      \
  case S:                                                                               \
    if (B > 1)                                                                          \
      TF_LAUNCH(S, true);                                                               \
    else                                                                                \
      TF_LAUNCH(S, false);                                                              \
    break;
    TF_CASE(1)
    TF_CASE(2)
    TF_CASE(3)
    TF_CASE(4)
#undef TF_CASE
#undef TF_LAUNCH
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define TF_ENTRY(NAME, T)                                                                \
  extern "C" int NAME(const void* bands, void* fac, void* Dhinv, void* DU, void* W,     \
                      void* V, void* Lred, void* Ured, const void* beta_b, int N,       \
                      int nvar, int g, int h, int Mc, int C, int wrap, int B,           \
                      double alpha, double beta, void* stream) {                        \
    return launch<T>(static_cast<const T*>(bands), static_cast<T*>(fac),                \
                     static_cast<T*>(Dhinv), static_cast<T*>(DU), static_cast<T*>(W),   \
                     static_cast<T*>(V), static_cast<T*>(Lred), static_cast<T*>(Ured),  \
                     static_cast<const T*>(beta_b), N, nvar, g, h, Mc, C, wrap, B,      \
                     alpha, beta, static_cast<cudaStream_t>(stream));                   \
  }

TF_ENTRY(tf_spike_factor_f32, float)
TF_ENTRY(tf_spike_factor_f64, double)
