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
//
// Wide blocks (S = 5..8: three or four variables with halo 2, five to eight
// with halo 1) are built into a library of their own, from this file with
// TF_WIDE defined.  It replaces ops/pallas_thomas.py chunked_factor_sweeps
// and fused_factor_sweeps, the reference's factor of such blocks (from
// assembled blocks, or from raw bands with alpha*I + beta*J folded in as
// here).  The blocks no longer fit one thread's registers, so a group of S
// lanes walks each chunk, lane r holding row r of every block (wide.cuh),
// with the same sweeps in the same order; a warp walks 32 / S chunks side
// by side.  Every product and inverse exchanges rows by warp shuffles, so
// the sweep is bound by their latency along its Mc sequential rows.
#include "factor.cuh"
#include "wide.cuh"

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

// row r of the S x S block of alpha*I + beta*J at supernode I and block
// offset dblock (factor.cuh's band_block, one row)
template <typename T, int S>
__device__ __forceinline__ tf::Row<T, S> band_row(const T* bands, long I, int dblock, int r,
                                                  T alpha, T beta, int N, int nvar, int g,
                                                  int h) {
  tf::Row<T, S> out;
  const int a = r / nvar, m = r % nvar;
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int b = q / nvar, n = q % nvar;
    const int delta = (b - a) + dblock * g;
    T val = T(0);
    if (delta >= -h && delta <= h)
      val = beta * bands[((long)((h + delta) * nvar + m) * nvar + n) * N + I * g + a];
    if (dblock == 0 && r == q) val += alpha;
    out.v[q] = val;
  }
  return out;
}

// factor.cuh's spike_factor_chunk for a group of S lanes (wide.cuh): lane
// g.r walks row g.r of chunk c's blocks; `store` is false for a lane of no
// chunk, which computes on a valid chunk and writes nothing
template <typename T, int S>
__device__ __forceinline__ void spike_factor_chunk_wide(
    const T* bands, T* fac, T* Dhinv, T* DU, T* Wsp, T* Vsp, T* Lred, T* Ured, int N, int nvar,
    int g, int h, int Mc, int C, int wrap, T alpha, T beta, int c, const tf::Group& grp,
    bool store) {
  using Row = tf::Row<T, S>;
  const int r = grp.r;
  Row dh = tf::zero_row<T, S>(), up = dh, wt = dh, Tl = dh, Tr = dh;
  for (int j = 0; j < Mc; ++j) {
    const long I = (long)c * Mc + j;
    Row L = band_row<T, S>(bands, I, -1, r, alpha, beta, N, nvar, g, h);
    Row U = band_row<T, S>(bands, I, 1, r, alpha, beta, N, nvar, g, h);
    if (j == 0) {
      Tl = (!wrap && c == 0) ? tf::zero_row<T, S>() : L;
      L = tf::zero_row<T, S>();
    }
    if (j == Mc - 1) {
      Tr = (!wrap && c == C - 1) ? tf::zero_row<T, S>() : U;
      U = tf::zero_row<T, S>();
    }
    const Row f = tf::mm(L, dh, grp);
    const Row D = band_row<T, S>(bands, I, 0, r, alpha, beta, N, nvar, g, h);
    dh = tf::inv(tf::sub(D, tf::mm(f, up, grp)), grp);
    wt = j == 0 ? Tl : tf::neg(tf::mm(f, wt, grp));
    if (store) {
      tf::store_row(fac, j, r, c, C, f);
      tf::store_row(Dhinv, j, r, c, C, dh);
      tf::store_row(Wsp, j, r, c, C, wt);  // wt_j, overwritten by W_j below
      tf::store_row(DU, j, r, c, C, U);    // U_j, overwritten by Dh_j U_j below
    }
    up = U;
  }
  // each lane reads back only the rows it wrote itself
  Row Wn = tf::zero_row<T, S>(), Vn = Wn, Wl = Wn, Vl = Wn;
  for (int j = Mc - 1; j >= 0; --j) {
    const Row dhj = tf::load_row<T, S>(Dhinv, j, r, c, C);
    const Row du = tf::mm(dhj, tf::load_row<T, S>(DU, j, r, c, C), grp);
    const Row W = tf::sub(tf::mm(dhj, tf::load_row<T, S>(Wsp, j, r, c, C), grp),
                          tf::mm(du, Wn, grp));
    Row V;
    if (j == Mc - 1) {
      V = tf::mm(dhj, Tr, grp);
      Wl = W;
      Vl = V;
    } else {
      V = tf::neg(tf::mm(du, Vn, grp));
    }
    if (store) {
      tf::store_row(DU, j, r, c, C, du);
      tf::store_row(Wsp, j, r, c, C, W);
      tf::store_row(Vsp, j, r, c, C, V);
    }
    Wn = W;
    Vn = V;
  }
  if (!store) return;
  // rows r and S + r of the reduced couplings (factor.cuh's layout)
  const bool keep_l = wrap || c != 0;
  const bool keep_u = wrap || c != C - 1;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const Row& Wr = half ? Wl : Wn;
    const Row& Vr = half ? Vl : Vn;
    const long row = (long)half * S + r;
#pragma unroll
    for (int q = 0; q < 2 * S; ++q) {
      const T lv = q >= S ? Wr.v[q - S] : T(0);
      const T uv = q < S ? Vr.v[q] : T(0);
      Lred[(row * 2 * S + q) * C + c] = keep_l ? lv : T(0);
      Ured[(row * 2 * S + q) * C + c] = keep_u ? uv : T(0);
    }
  }
}

// one group of S lanes per (member, chunk), 32 / S groups per warp
template <typename T, int S, bool kMembers>
__global__ void spike_factor_wide_kernel(const T* __restrict__ bands, T* fac, T* Dhinv, T* DU,
                                         T* Wsp, T* Vsp, T* Lred, T* Ured,
                                         const T* __restrict__ beta_b, int N, int nvar, int g,
                                         int h, int Mc, int C, int wrap, int B, T alpha,
                                         T beta) {
  constexpr int G = 32 / S;
  const int lane = threadIdx.x & 31, grp = tf::group_of_lane<S>(lane);
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long q = warp * G + grp;
  if (warp * G >= (long)B * C) return;  // the whole warp has no chunk
  const bool store = grp < G && q < (long)B * C;
  const long qc = store ? q : (long)B * C - 1;
  const int b = kMembers ? (int)(qc / C) : 0, c = kMembers ? (int)(qc % C) : (int)qc;
  const long band = (long)(2 * h + 1) * nvar * nvar * N;
  const long rows = (long)Mc * S * S * C;
  const long red = 4L * S * S * C;
  spike_factor_chunk_wide<T, S>(bands + b * band, fac + b * rows, Dhinv + b * rows,
                                DU + b * rows, Wsp + b * rows, Vsp + b * rows,
                                Lred + b * red, Ured + b * red, N, nvar, g, h, Mc, C, wrap,
                                alpha, beta_b ? beta_b[b] : beta, c,
                                tf::Group{grp * S, lane - grp * S}, store);
}

template <typename T>
int launch(const T* bands, T* fac, T* Dhinv, T* DU, T* W, T* V, T* Lred, T* Ured,
           const T* beta_b, int N, int nvar, int g, int h, int Mc, int C, int wrap, int B,
           double alpha, double beta, cudaStream_t stream) {
  const int threads = 128;
  const T a = T(alpha), bt = T(beta);
  switch (nvar * g) {
#ifdef TF_WIDE
#define TF_LAUNCH(S, MEM)                                                               \
  spike_factor_wide_kernel<T, S, MEM><<<((long)B * C + 32 / S * 4 - 1) / (32 / S * 4),  \
                                        threads, 0, stream>>>(                          \
      bands, fac, Dhinv, DU, W, V, Lred, Ured, beta_b, N, nvar, g, h, Mc, C, wrap, B, a, bt)
#else
#define TF_LAUNCH(S, MEM)                                                               \
  spike_factor_kernel<T, S, MEM><<<((long)B * C + threads - 1) / threads, threads, 0,   \
                                   stream>>>(                                           \
      bands, fac, Dhinv, DU, W, V, Lred, Ured, beta_b, N, nvar, g, h, Mc, C, wrap, B, a, bt)
#endif
#define TF_CASE(S)                                                                      \
  case S:                                                                               \
    if (B > 1)                                                                          \
      TF_LAUNCH(S, true);                                                               \
    else                                                                                \
      TF_LAUNCH(S, false);                                                              \
    break;
#ifdef TF_WIDE
    TF_CASE(5)
    TF_CASE(6)
    TF_CASE(7)
    TF_CASE(8)
#else
    TF_CASE(1)
    TF_CASE(2)
    TF_CASE(3)
    TF_CASE(4)
#endif
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
