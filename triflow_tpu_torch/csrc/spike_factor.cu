// K2: chunked block-Thomas / SPIKE factorization of A = alpha*I + beta*J,
// read straight from the banded J.
//
// Replaces, on the TPU: ops/folded.py factor_sweeps_folded (the forward
// sweep, fwd_kernel) and ops/pallas_thomas.py _bwd_factor_call_cols (the
// backward spike sweep).  The TPU ran them as two launches only because its
// grid is sequential; here one walker thread takes one chunk through both
// sweeps.
//
// Layout.  The N nodes form M = N / g supernodes of g = max(halo, 1) nodes
// (block size S = nvar * g, entry a * nvar + m = variable m at local node
// a).  Chunk c owns supernodes [c * Mc, (c + 1) * Mc).  Every per-row output
// is stored chunk-minor, (Mc, S, S, C), so the walkers of a block (neighbour
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
// Member axis: an ensemble's B grids factor in one launch, one walker per
// (member, chunk), B * C walkers.  Every array of member b is one grid's
// layout at an offset of b times its size (bands (B, W, nvar, nvar, N),
// rows (B, Mc, S, S, C), reduced couplings (B, 2S, 2S, C)); members never
// couple, so each member's chunk 0 and chunk C-1 close its own ring.  The
// factor shift beta is a number, or (beta_b not null) member b's entry of a
// device array: shared and per-member step sizes take one code.
//
// Bound: each step of the sweep reads its band rows and writes five S x S
// blocks, and the Mc steps of a chunk are sequential, so a walk that loads
// its rows as it goes waits on memory latency at every row.  None of the
// loads depends on the recurrence, though: the bands of rows j+1.. are
// known before row j is factored.  So the kernel (spike_factor_staged_kernel)
// is a pipeline, as K3's sweep is: a block of one warp serves CB chunks of
// the B * C (member, chunk) pairs; every lane copies tiles of R supernode
// rows of the bands into a ring of kFactorStages shared-memory stages with
// cp.async, kFactorStages - 1 tiles ahead of the walk.  A chunk's rows are
// one contiguous node segment (Mc * g nodes) of each of the W * nvar^2
// band planes, so the copies coalesce along nodes and land transposed,
// chunk-minor, in the tile.  The warp's first CB lanes walk one chunk each
// from shared memory (alpha * I + beta * J folded into their reads, at
// offsets the compile-time geometry (nvar, halo) fixes) and store their
// per-row blocks straight to the chunk-minor rows (Mc, S, S, C): the CB
// chunks of a block are neighbours, so each store is one contiguous
// segment.  The backward sweep reads Dh_j, U_j and wt_j back either from
// shared memory, where the plan keeps the forward results there
// (``persist``: 3 Mc S^2 values per chunk), or streamed through the same
// ring in reverse tile order from the rows the forward pass wrote.  Once
// its loads are staged, a walk is bound by the issue and latency of its
// own instructions, not by bytes: one instruction serves every walker of
// a warp, and one-warp blocks spread over an SM's four schedulers.  The
// host plans CB, R and persist (ops/thomas.py:factor_plan): the fewest
// chunks per block that leave no more walking warps than the card's
// schedulers; the stages within each block's share of the SM's shared
// memory.  What is left is the recurrence's own latency along the Mc rows.
//
// K6 (megastep.cu) keeps the one-thread walk of a chunk, factor.cuh's
// spike_factor_chunk; the staged kernel runs the same products and sums in
// the same order.
//
// Wide blocks (S = 5..8: three or four variables with halo 2, five to eight
// with halo 1) are built into a library of their own, from this file with
// TF_WIDE defined.  It replaces ops/pallas_thomas.py chunked_factor_sweeps
// and fused_factor_sweeps, the reference's factor of such blocks (from
// assembled blocks, or from raw bands with alpha*I + beta*J folded in as
// here).  The blocks no longer fit one thread's registers, so a group of S
// lanes walks each chunk, lane r holding row r of every block (wide.cuh),
// with the same sweeps in the same order; a warp walks 32 / S chunks side
// by side.  The walk is staged as the narrow one is
// (spike_factor_wide_kernel: one-warp blocks, the band tiles and the
// backward rows in a cp.async ring, compile-time offsets per (nvar, halo)),
// so no global load waits on the recurrence.  What bounds it is then the
// warp's own instruction stream along its Mc sequential rows: every
// product and inverse exchanges rows by warp shuffles (some 440 a lane per
// row at S = 6), and the chain of a row's inverse is its latency.
#include "cp_async.cuh"
#include "factor.cuh"
#include "wide.cuh"

namespace {

constexpr int kFactorThreads = 32;
constexpr int kFactorStages = 4;
constexpr int kFactorMaxCB = 32;

// The entries of a block of alpha*I + beta*J at block offset kD (-1, 0, 1)
// from a band tile: entry (r, q), variable m at local node a against
// variable n at node bq of the neighbour supernode, is plane ((h + delta)
// nvar + m) nvar + n at node a of the row, delta = bq - a + kD g, and zero
// outside the band; the diagonal adds alpha (factor.cuh's band_block, the
// same products and sums).  The geometry is compile-time, so every offset
// is a constant multiple of the tile's two strides and no load waits on a
// branch.  p points at the row's first node, lane l; planes are `plane`
// apart, nodes CB.
template <typename T, int NV, int H, int kD>
__device__ __forceinline__ tf::Blk<T, NV * (H > 1 ? H : 1)> tile_block(const T* p, int plane,
                                                                      int CB, T alpha,
                                                                      T beta) {
  constexpr int G = H > 1 ? H : 1, S = NV * G;
  tf::Blk<T, S> out;
#pragma unroll
  for (int r = 0; r < S; ++r)
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int a = r / NV, m = r % NV, bq = q / NV, n = q % NV;
      const int delta = (bq - a) + kD * G;
      T val = T(0);
      if (delta >= -H && delta <= H)
        val = beta * p[(((H + delta) * NV + m) * NV + n) * plane + a * CB];
      if (kD == 0 && r == q) val += alpha;
      out.v[r][q] = val;
    }
  return out;
}

// An S x S block of a chunk-minor tile p[e * CB] (e = r * S + q).
template <typename T, int S>
__device__ __forceinline__ tf::Blk<T, S> tile_blk(const T* p, int CB) {
  tf::Blk<T, S> a;
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int k = 0; k < S; ++k) a.v[i][k] = p[(i * S + k) * CB];
  return a;
}

// An S x S block into one chunk's row of the chunk-minor rows (Mc, S, S,
// C): p points at entry (0, 0) of the row, entries C apart.
template <typename T, int S>
__device__ __forceinline__ void store_rows(T* p, long C, const tf::Blk<T, S>& a) {
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int k = 0; k < S; ++k) p[(i * S + k) * C] = a.v[i][k];
}

template <typename T, int S>
__device__ __forceinline__ void store_tile_blk(T* p, int CB, const tf::Blk<T, S>& a) {
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int k = 0; k < S; ++k) p[(i * S + k) * CB] = a.v[i][k];
}

// Rows `half * S ..` of chunk c's reduced couplings (factor.cuh's layout):
// W couples to x_{c-1}^bot, V to x_{c+1}^top.
template <typename T, int S>
__device__ __forceinline__ void store_red(T* Lred, T* Ured, int half, const tf::Blk<T, S>& W,
                                          const tf::Blk<T, S>& V, int c, int C, bool keep_l,
                                          bool keep_u) {
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int q = 0; q < 2 * S; ++q) {
      const long at = ((long)(half * S + i) * 2 * S + q) * C + c;
      Lred[at] = keep_l && q >= S ? W.v[i][q - S] : T(0);
      Ured[at] = keep_u && q < S ? V.v[i][q] : T(0);
    }
}

// One block per CB chunks of the B * C (member, chunk) pairs (flat index
// member * C + chunk), for NV variables with halo H (S = NV max(H, 1)).
// Shared memory: kFactorStages stages (the band tile, W NV^2 planes x R g
// nodes x CB; without persist at least the three row tiles of the
// backward pass, 3 x R S^2 x CB), with persist the forward results (3 x Mc
// S^2 x CB), and each chunk's Tr and, at S >= 3, U_{j-1} (S^2 x CB each:
// registers are scarce there).  A block is one warp: its lanes copy, its
// first CB lanes walk.
template <typename T, int NV, int H>
__global__ void __launch_bounds__(kFactorThreads)
    spike_factor_staged_kernel(const T* __restrict__ bands, T* fac, T* Dhinv, T* DU, T* Wsp,
                               T* Vsp, T* Lred, T* Ured, const T* __restrict__ beta_b, int N,
                               int Mc, int C, int wrap, int B, T alpha, T beta, int CB, int R,
                               int persist) {
  constexpr int G = H > 1 ? H : 1, S = NV * G, SS = S * S, P = (2 * H + 1) * NV * NV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ long seg0[kFactorMaxCB], row0[kFactorMaxCB];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const long q0 = (long)blockIdx.x * CB;
  const int nch = (int)min((long)CB, (long)B * C - q0);
  const int tid = threadIdx.x, Rg = R * G;
  const long band = (long)P * N, rows = (long)Mc * SS * C, red = 4L * SS * C;
  const bool walker = tid < nch;
  int c = 0;
  long mrow = 0, mred = 0;
  T bt = beta;
  if (walker) {
    const long b = (q0 + tid) / C;
    c = (int)((q0 + tid) % C);
    seg0[tid] = b * band + (long)c * Mc * G;
    mrow = b * rows + c;
    row0[tid] = mrow;
    mred = b * red;
    if (beta_b) bt = beta_b[b];
  }
  __syncthreads();

  const int lcb = 31 - __clz(CB);
  const int plane = Rg * CB, band_tile = P * plane, row_tile = R * SS * CB;
  const int stage = persist ? band_tile : max(band_tile, 3 * row_tile);
  T* kept = smem + kFactorStages * stage;             // with persist: Dh, U, wt of every row
  T* trs = kept + (persist ? 3L * Mc * SS * CB : 0);  // each chunk's Tr
  T* ups = trs + SS * CB;                             // at S >= 3, U_{j-1}
  constexpr bool kCarry = S >= 3;
  const long kept_sz = (long)Mc * SS * CB, SSC = (long)SS * C;
  const int tiles = (Mc + R - 1) / R;
  // band copies: node vk of the tile's segment, (plane, lane) pairs from vp
  // by vstep; row copies: lane bl, entries from be by kFactorThreads / CB
  const int vk = tid % Rg, vp = tid / Rg, vstep = kFactorThreads / Rg;
  const int bl = tid & (CB - 1), be = tid >> lcb;

  auto issue_fwd = [&](int t) {
    if (t < tiles) {
      T* st = smem + (t % kFactorStages) * stage;
      const int j0 = t * R, nr = min(R, Mc - j0);
      if (vp < vstep && vk < nr * G) {
        for (int p = vp; p < (P << lcb); p += vstep) {
          const int l = p & (CB - 1), pl = p >> lcb;
          if (l < nch)
            tf::cp_async(st + pl * plane + vk * CB + l,
                         bands + seg0[l] + (long)pl * N + (long)j0 * G + vk);
        }
      }
    }
    tf::cp_async_commit();
  };
  for (int t = 0; t < kFactorStages; ++t) issue_fwd(t);

  tf::Blk<T, S> dh, up, wt;
  tf::zero(dh);
  tf::zero(up);
  tf::zero(wt);
  if (kCarry && walker) store_tile_blk<T, S>(ups + tid, CB, up);
  const bool keep_l = wrap || c != 0, keep_u = wrap || c != C - 1;
  for (int t = 0; t < tiles; ++t) {
    tf::cp_async_wait<kFactorStages - 1>();
    __syncthreads();
    const T* st = smem + (t % kFactorStages) * stage;
    const int j0 = t * R, nr = min(R, Mc - j0);
    if (walker) {
#pragma unroll(S <= 2 ? 2 : 1)
      for (int jj = 0; jj < nr; ++jj) {
        const int j = j0 + jj;
        const T* rowp = st + jj * G * CB + tid;
        // L first, U last: at S = 4 in float64 the three blocks do not
        // fit the registers beside the walk's own
        tf::Blk<T, S> L = tile_block<T, NV, H, -1>(rowp, plane, CB, alpha, bt);
        if (j == 0) {
          // wt_0 = Tl = L_0, the coupling to the previous chunk, which
          // leaves the chunk's own system
          wt = L;
          if (!keep_l) tf::zero(wt);
          tf::zero(L);
        }
        const tf::Blk<T, S> f = tf::mm(L, dh);
        if constexpr (kCarry) up = tile_blk<T, S>(ups + tid, CB);
        dh = tf::inv(tf::sub(tile_block<T, NV, H, 0>(rowp, plane, CB, alpha, bt), tf::mm(f, up)));
        if (j > 0) {
          tf::Blk<T, S> z;
          tf::zero(z);
          wt = tf::sub(z, tf::mm(f, wt));
        }
        const long at = mrow + j * SSC;
        store_rows<T, S>(fac + at, C, f);
        store_rows<T, S>(Dhinv + at, C, dh);
        tf::Blk<T, S> U = tile_block<T, NV, H, 1>(rowp, plane, CB, alpha, bt);
        if (j == Mc - 1) {
          // Tr = U_{Mc-1}: the coupling to the next chunk
          tf::Blk<T, S> Tr = U;
          if (!keep_u) tf::zero(Tr);
          store_tile_blk<T, S>(trs + tid, CB, Tr);
          tf::zero(U);
        }
        if (persist) {
          T* kj = kept + (long)j * SS * CB + tid;
          store_tile_blk<T, S>(kj, CB, dh);
          store_tile_blk<T, S>(kj + kept_sz, CB, U);
          store_tile_blk<T, S>(kj + 2 * kept_sz, CB, wt);
        } else {
          store_rows<T, S>(Wsp + at, C, wt);  // wt_j, overwritten by W_j below
          store_rows<T, S>(DU + at, C, U);    // U_j, overwritten by Dh_j U_j below
        }
        if constexpr (kCarry)
          store_tile_blk<T, S>(ups + tid, CB, U);
        else
          up = U;
      }
    }
    __syncthreads();
    issue_fwd(t + kFactorStages);
  }
  tf::cp_async_wait<0>();
  __threadfence_block();
  __syncthreads();

  // backward: tile tiles-1-k in stage k % kFactorStages (Dh, U, wt row
  // tiles), unless the forward results are kept
  auto issue_bwd = [&](int k) {
    const int t = tiles - 1 - k;
    if (!persist && t >= 0 && bl < nch) {
      T* st = smem + (k % kFactorStages) * stage;
      const int j0 = t * R, nr = min(R, Mc - j0);
      const T* src[3] = {Dhinv, DU, Wsp};
#pragma unroll
      for (int w = 0; w < 3; ++w) {
        const T* from = src[w] + row0[bl] + j0 * SSC;
        for (int e = be; e < nr * SS; e += kFactorThreads >> lcb)
          tf::cp_async(st + w * row_tile + e * CB + bl, from + (long)e * C);
      }
    }
    tf::cp_async_commit();
  };
  for (int k = 0; k < kFactorStages; ++k) issue_bwd(k);
  tf::Blk<T, S> Wn, Vn;
  tf::zero(Wn);
  tf::zero(Vn);
  for (int k = 0; k < tiles; ++k) {
    tf::cp_async_wait<kFactorStages - 1>();
    __syncthreads();
    const T* st = smem + (k % kFactorStages) * stage;
    const int j0 = (tiles - 1 - k) * R, nr = min(R, Mc - j0);
    if (walker) {
      for (int jj = nr - 1; jj >= 0; --jj) {
        const int j = j0 + jj;
        const T* at = persist ? kept + (long)j * SS * CB + tid : st + jj * SS * CB + tid;
        const long w = persist ? kept_sz : row_tile;
        const tf::Blk<T, S> dhj = tile_blk<T, S>(at, CB);
        const tf::Blk<T, S> du = tf::mm(dhj, tile_blk<T, S>(at + w, CB));
        const tf::Blk<T, S> W =
            tf::sub(tf::mm(dhj, tile_blk<T, S>(at + 2 * w, CB)), tf::mm(du, Wn));
        tf::Blk<T, S> V;
        if (j == Mc - 1) {
          V = tf::mm(dhj, tile_blk<T, S>(trs + tid, CB));
          store_red<T, S>(Lred + mred, Ured + mred, 1, W, V, c, C, keep_l, keep_u);
        } else {
          tf::Blk<T, S> z;
          tf::zero(z);
          V = tf::sub(z, tf::mm(du, Vn));
        }
        const long to = mrow + j * SSC;
        store_rows<T, S>(DU + to, C, du);
        store_rows<T, S>(Wsp + to, C, W);
        store_rows<T, S>(Vsp + to, C, V);
        Wn = W;
        Vn = V;
      }
    }
    __syncthreads();
    issue_bwd(k + kFactorStages);
  }
  tf::cp_async_wait<0>();
  if (walker) store_red<T, S>(Lred + mred, Ured + mred, 0, Wn, Vn, c, C, keep_l, keep_u);
}

// Shared memory of a factor plan, in bytes (ops/thomas.py:factor_smem
// computes the same); the lane-group walk (S > 4) keeps Tr and U_{j-1} in
// registers.
long factor_smem(int S, int P, int g, int item, int Mc, int CB, int R, int persist) {
  const long band = (long)P * R * g, rows = 3L * R * S * S;
  const long stage = persist ? band : (band > rows ? band : rows);
  return (long)item * CB *
         (kFactorStages * stage + (persist ? 3L * Mc * S * S : 0) + (S > 4 ? 0 : 2L * S * S));
}

#ifdef TF_WIDE
// Row r of the S x S block of alpha*I + beta*J at block offset kD (-1, 0, 1)
// from a node-major band tile (st[(node * P + plane) * CB + l]), for a lane
// of a group (wide.cuh) that holds row r = a * NV + m, variable m at local
// node a.  Entry (r, q), q = bq * NV + n, is plane ((H + delta) NV + m) NV
// + n at node a, delta = bq - a + kD g, and zero outside the band: p points
// at plane (H - a) NV^2 + m NV of node a, so each entry sits at a
// compile-time offset from p and only the band test reads a.  The diagonal
// adds alpha (the reference's band block, the same products and sums).
template <typename T, int NV, int H, int kD>
__device__ __forceinline__ tf::Row<T, NV * (H > 1 ? H : 1)> tile_row(const T* p, int a, int r,
                                                                    T alpha, T beta) {
  constexpr int G = H > 1 ? H : 1, S = NV * G, CB = 32 / S;
  tf::Row<T, S> out;
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int bq = q / NV, n = q % NV;
    const int delta = bq - a + kD * G;
    T val = T(0);
    if (delta >= -H && delta <= H) val = beta * p[((bq + kD * G) * NV * NV + n) * CB];
    if (kD == 0 && r == q) val += alpha;
    out.v[q] = val;
  }
  return out;
}

// Row r of an S x S block of a chunk-minor row tile p[(r S + k) CB]
template <typename T, int S>
__device__ __forceinline__ tf::Row<T, S> tile_rrow(const T* p) {
  constexpr int CB = 32 / S;
  tf::Row<T, S> a;
#pragma unroll
  for (int k = 0; k < S; ++k) a.v[k] = p[k * CB];
  return a;
}

template <typename T, int S>
__device__ __forceinline__ void store_tile_rrow(T* p, const tf::Row<T, S>& a) {
  constexpr int CB = 32 / S;
#pragma unroll
  for (int k = 0; k < S; ++k) p[k * CB] = a.v[k];
}

// Row r of an S x S block into a chunk's row of the chunk-minor rows (Mc,
// S, S, C): p points at entry (r, 0) of the row, entries C apart
template <typename T, int S>
__device__ __forceinline__ void store_rrow(T* p, long C, const tf::Row<T, S>& a) {
#pragma unroll
  for (int k = 0; k < S; ++k) p[k * C] = a.v[k];
}

// The staged walk at S = 5..8: spike_factor_staged_kernel's pipeline with
// a group of S lanes per chunk.  A block is one warp and serves CB = 32 / S
// neighbouring chunks of the B * C (member, chunk) pairs, one per group
// (the lanes past CB S, and the groups of a tail block past its chunks,
// walk chunk 0 of the block and store nothing: every lane takes part in
// the shuffles).  Its lanes copy tiles of R supernode rows of the W NV^2
// band planes with cp.async into a ring of kFactorStages stages, node-major
// (st[(node * P + plane) * CB + l]), so that a lane's entries sit at
// compile-time offsets (tile_row); the forward results Dh, U, wt are kept
// in shared memory (persist: 3 Mc S^2 CB values) or stored to the rows and
// streamed back through the ring in reverse tile order.  Lane r's Tr and
// U_{j-1} stay in its registers.  The products and inverses are wide.cuh's
// and the sweeps run in factor.cuh's order (spike_factor_chunk).
template <typename T, int NV, int H>
__global__ void __launch_bounds__(kFactorThreads)
    spike_factor_wide_kernel(const T* __restrict__ bands, T* __restrict__ fac,
                             T* __restrict__ Dhinv, T* __restrict__ DU, T* __restrict__ Wsp,
                             T* __restrict__ Vsp, T* __restrict__ Lred, T* __restrict__ Ured,
                             const T* __restrict__ beta_b, int N, int Mc, int C, int wrap, int B,
                             T alpha, T beta, int R, int persist) {
  using Row = tf::Row<T, NV * (H > 1 ? H : 1)>;
  constexpr int G = H > 1 ? H : 1, S = NV * G, SS = S * S, P = (2 * H + 1) * NV * NV;
  constexpr int CB = 32 / S, GB = tf::group_block<T, S>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ long seg0[CB], row0[CB];
  // each group's block for its products (and one for the lanes past them)
  __shared__ __align__(16) T mmbuf[(CB + 1) * GB];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const long q0 = (long)blockIdx.x * CB;
  const int nch = (int)min((long)CB, (long)B * C - q0);
  const int lane = threadIdx.x, grp = tf::group_of_lane<S>(lane);
  const tf::Group g{grp * S, lane - grp * S};
  T* const mb = mmbuf + grp * GB;
  auto mm = [&](const Row& x, const Row& y) { return tf::mm_shared<T, S>(x, y, g, mb); };
  const int r = g.r, a = r / NV, m = r % NV;
  const bool store = grp < nch;
  const int l = store ? grp : 0;  // the chunk whose tiles this lane walks
  const long band = (long)P * N, rows = (long)Mc * SS * C, red = 4L * SS * C;
  if (lane < nch) {
    const long b = (q0 + lane) / C, c = (q0 + lane) % C;
    seg0[lane] = b * band + c * Mc * G;
    row0[lane] = b * rows + c;
  }
  const long mem = (q0 + l) / C;
  const int c = (int)((q0 + l) % C);
  const T bt = beta_b ? beta_b[mem] : beta;
  __syncthreads();
  const long mrow = row0[l] + (long)r * S * C, mred = mem * red;

  const int Rg = R * G;
  const int band_tile = Rg * P * CB, row_tile = R * SS * CB;
  const int stage = persist ? band_tile : max(band_tile, 3 * row_tile);
  T* kept = smem + kFactorStages * stage;  // with persist: Dh, U, wt of every row
  const long kept_sz = (long)Mc * SS * CB, SSC = (long)SS * C;
  const int tiles = (Mc + R - 1) / R;
  // band copies: node vk of the tile, of every chunk the planes from vp by
  // vstep; row copies: chunk bl, entries from be by 32 / CB
  const int vk = lane % Rg, vp = lane / Rg, vstep = kFactorThreads / Rg;
  const int bl = lane % CB, be = lane / CB, estep = kFactorThreads / CB;

  // each copying lane's node of every chunk's segment
  const T* lane_seg[CB];
#pragma unroll
  for (int ll = 0; ll < CB; ++ll) lane_seg[ll] = bands + seg0[ll < nch ? ll : 0] + vk;
  auto issue_fwd = [&](int t) {
    if (t < tiles) {
      T* st = smem + (t % kFactorStages) * stage + vk * P * CB;
      const int j0 = t * R, nr = min(R, Mc - j0);
      if (vp < vstep && vk < nr * G) {
#pragma unroll
        for (int ll = 0; ll < CB; ++ll) {
          if (ll < nch) {
            const T* src = lane_seg[ll] + (long)j0 * G;
#pragma unroll 5
            for (int pl = vp; pl < P; pl += vstep)
              tf::cp_async(st + pl * CB + ll, src + (long)pl * N);
          }
        }
      }
    }
    tf::cp_async_commit();
  };
  for (int t = 0; t < kFactorStages; ++t) issue_fwd(t);

  const bool keep_l = wrap || c != 0, keep_u = wrap || c != C - 1;
  Row dh = tf::zero_row<T, S>(), up = dh, wt = dh, Tr = dh;
  // lane r's place in a band tile row (tile_row) and in a row tile
  const int lane_band = (a * P + (H - a) * NV * NV + m * NV) * CB + l;
  const int lane_rows = r * S * CB + l;
  for (int t = 0; t < tiles; ++t) {
    tf::cp_async_wait<kFactorStages - 1>();
    __syncthreads();
    const T* st = smem + (t % kFactorStages) * stage;
    const int j0 = t * R, nr = min(R, Mc - j0);
    for (int jj = 0; jj < nr; ++jj) {
      const int j = j0 + jj;
      const T* rowp = st + jj * G * P * CB + lane_band;
      Row L = tile_row<T, NV, H, -1>(rowp, a, r, alpha, bt);
      Row U = tile_row<T, NV, H, 1>(rowp, a, r, alpha, bt);
      Row Tl = L;
      if (j == 0) {
        // Tl = L_0, the coupling to the previous chunk, which leaves the
        // chunk's own system
        if (!keep_l) Tl = tf::zero_row<T, S>();
        L = tf::zero_row<T, S>();
      }
      if (j == Mc - 1) {
        // Tr = U_{Mc-1}: the coupling to the next chunk
        Tr = keep_u ? U : tf::zero_row<T, S>();
        U = tf::zero_row<T, S>();
      }
      const Row f = mm(L, dh);
      const Row D = tile_row<T, NV, H, 0>(rowp, a, r, alpha, bt);
      dh = tf::inv(tf::sub(D, mm(f, up)), g);
      wt = j == 0 ? Tl : tf::neg(mm(f, wt));
      if (store) {
        const long at = mrow + j * SSC;
        store_rrow<T, S>(fac + at, C, f);
        store_rrow<T, S>(Dhinv + at, C, dh);
        if (persist) {
          T* kj = kept + (long)j * SS * CB + lane_rows;
          store_tile_rrow<T, S>(kj, dh);
          store_tile_rrow<T, S>(kj + kept_sz, U);
          store_tile_rrow<T, S>(kj + 2 * kept_sz, wt);
        } else {
          store_rrow<T, S>(Wsp + at, C, wt);  // wt_j, overwritten by W_j below
          store_rrow<T, S>(DU + at, C, U);    // U_j, overwritten by Dh_j U_j below
        }
      }
      up = U;
    }
    __syncthreads();
    issue_fwd(t + kFactorStages);
  }
  tf::cp_async_wait<0>();
  __threadfence_block();
  __syncthreads();

  // backward: tile tiles-1-k in stage k % kFactorStages (Dh, U, wt row
  // tiles), unless the forward results are kept
  auto issue_bwd = [&](int k) {
    const int t = tiles - 1 - k;
    if (!persist && t >= 0 && be < estep && bl < nch) {
      T* st = smem + (k % kFactorStages) * stage;
      const int j0 = t * R, nr = min(R, Mc - j0);
      const T* src[3] = {Dhinv, DU, Wsp};
#pragma unroll
      for (int w = 0; w < 3; ++w) {
        const T* from = src[w] + row0[bl] + j0 * SSC;
        for (int e = be; e < nr * SS; e += estep)
          tf::cp_async(st + w * row_tile + e * CB + bl, from + (long)e * C);
      }
    }
    tf::cp_async_commit();
  };
  for (int k = 0; k < kFactorStages; ++k) issue_bwd(k);
  Row Wn = tf::zero_row<T, S>(), Vn = Wn, Wl = Wn, Vl = Wn;
  for (int k = 0; k < tiles; ++k) {
    tf::cp_async_wait<kFactorStages - 1>();
    __syncthreads();
    const T* st = smem + (k % kFactorStages) * stage;
    const int j0 = (tiles - 1 - k) * R, nr = min(R, Mc - j0);
    for (int jj = nr - 1; jj >= 0; --jj) {
      const int j = j0 + jj;
      const T* at = persist ? kept + (long)j * SS * CB + lane_rows
                            : st + jj * SS * CB + lane_rows;
      const long w = persist ? kept_sz : row_tile;
      const Row dhj = tile_rrow<T, S>(at);
      const Row du = mm(dhj, tile_rrow<T, S>(at + w));
      const Row W = tf::sub(mm(dhj, tile_rrow<T, S>(at + 2 * w)), mm(du, Wn));
      Row V;
      if (j == Mc - 1) {
        V = mm(dhj, Tr);
        Wl = W;
        Vl = V;
      } else {
        V = tf::neg(mm(du, Vn));
      }
      if (store) {
        const long to = mrow + j * SSC;
        store_rrow<T, S>(DU + to, C, du);
        store_rrow<T, S>(Wsp + to, C, W);
        store_rrow<T, S>(Vsp + to, C, V);
      }
      Wn = W;
      Vn = V;
    }
    __syncthreads();
    issue_bwd(k + kFactorStages);
  }
  tf::cp_async_wait<0>();
  if (!store) return;
  // rows r and S + r of the reduced couplings (factor.cuh's layout)
  T* Lm = Lred + mred;
  T* Um = Ured + mred;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const Row& Wr = half ? Wl : Wn;
    const Row& Vr = half ? Vl : Vn;
    const long row = (long)half * S + r;
#pragma unroll
    for (int q = 0; q < 2 * S; ++q) {
      const T lv = q >= S ? Wr.v[q - S] : T(0);
      const T uv = q < S ? Vr.v[q] : T(0);
      Lm[(row * 2 * S + q) * C + c] = keep_l ? lv : T(0);
      Um[(row * 2 * S + q) * C + c] = keep_u ? uv : T(0);
    }
  }
}

// R supernode rows per stage (R g nodes at most kFactorThreads), persist:
// the forward results kept in shared memory, CB = 32 / S chunks per block
// (ops/thomas.py:factor_plan); one instantiation per (nvar, halo) of a
// block size s = 5..8
template <typename T, int NV, int H>
int launch_wide(const T* bands, T* fac, T* Dhinv, T* DU, T* W, T* V, T* Lred, T* Ured,
                const T* beta_b, int N, int Mc, int C, int wrap, int B, T alpha, T beta, int R,
                int persist, cudaStream_t stream) {
  constexpr int G = H > 1 ? H : 1, S = NV * G, CB = 32 / S;
  const long bytes = factor_smem(S, (2 * H + 1) * NV * NV, G, sizeof(T), Mc, CB, R, persist);
  // above 48 KB with the kernel's static shared memory: opt in, once per
  // device and size (a driver call)
  static long set[16] = {};
  if (bytes > 40 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && dev >= 16) err = cudaErrorInvalidDevice;
    if (err == cudaSuccess && bytes > set[dev]) {
      err = cudaFuncSetAttribute(spike_factor_wide_kernel<T, NV, H>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err == cudaSuccess) set[dev] = bytes;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long blocks = ((long)B * C + CB - 1) / CB;
  spike_factor_wide_kernel<T, NV, H><<<blocks, kFactorThreads, bytes, stream>>>(
      bands, fac, Dhinv, DU, W, V, Lred, Ured, beta_b, N, Mc, C, wrap, B, alpha, beta, R,
      persist);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* bands, T* fac, T* Dhinv, T* DU, T* W, T* V, T* Lred, T* Ured,
           const T* beta_b, int N, int nvar, int g, int h, int Mc, int C, int wrap, int B,
           double alpha, double beta, int CB, int R, int persist, cudaStream_t stream) {
  const int S = nvar * g;
  if (S < 5 || S > 8 || CB != 32 / S || R < 1 || R * g > kFactorThreads || Mc < 1 || C < 1 ||
      B < 1 || g != (h > 1 ? h : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (nvar * 16 + h) {
#define TF_CASE(NV, H)                                                                    \
  case NV * 16 + H:                                                                       \
    return launch_wide<T, NV, H>(bands, fac, Dhinv, DU, W, V, Lred, Ured, beta_b, N, Mc,  \
                                 C, wrap, B, T(alpha), T(beta), R, persist, stream);
    TF_CASE(5, 0)
    TF_CASE(5, 1)
    TF_CASE(1, 5)
    TF_CASE(6, 0)
    TF_CASE(6, 1)
    TF_CASE(3, 2)
    TF_CASE(2, 3)
    TF_CASE(1, 6)
    TF_CASE(7, 0)
    TF_CASE(7, 1)
    TF_CASE(1, 7)
    TF_CASE(8, 0)
    TF_CASE(8, 1)
    TF_CASE(4, 2)
    TF_CASE(2, 4)
    TF_CASE(1, 8)
#undef TF_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
#else
template <typename T, int NV, int H>
int launch_staged(const T* bands, T* fac, T* Dhinv, T* DU, T* W, T* V, T* Lred, T* Ured,
                  const T* beta_b, int N, int Mc, int C, int wrap, int B, T alpha, T beta,
                  int CB, int R, int persist, cudaStream_t stream) {
  constexpr int G = H > 1 ? H : 1;
  const long bytes =
      factor_smem(NV * G, (2 * H + 1) * NV * NV, G, sizeof(T), Mc, CB, R, persist);
  // above 48 KB with the kernel's static shared memory: opt in, once per
  // device and size (a driver call)
  static long set[16] = {};
  if (bytes > 40 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && dev >= 16) err = cudaErrorInvalidDevice;
    if (err == cudaSuccess && bytes > set[dev]) {
      err = cudaFuncSetAttribute(spike_factor_staged_kernel<T, NV, H>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err == cudaSuccess) set[dev] = bytes;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long blocks = ((long)B * C + CB - 1) / CB;
  spike_factor_staged_kernel<T, NV, H><<<blocks, kFactorThreads, bytes, stream>>>(
      bands, fac, Dhinv, DU, W, V, Lred, Ured, beta_b, N, Mc, C, wrap, B, alpha, beta, CB, R,
      persist);
  return static_cast<int>(cudaGetLastError());
}

// CB chunks per block (a power of two, at most kFactorMaxCB), R supernode
// rows per stage (R g nodes at most kFactorThreads), persist: the forward
// results kept in shared memory (ops/thomas.py:factor_plan); one
// instantiation per (nvar, halo) of a block size s <= 4
template <typename T>
int launch(const T* bands, T* fac, T* Dhinv, T* DU, T* W, T* V, T* Lred, T* Ured,
           const T* beta_b, int N, int nvar, int g, int h, int Mc, int C, int wrap, int B,
           double alpha, double beta, int CB, int R, int persist, cudaStream_t stream) {
  if (CB < 1 || CB > kFactorMaxCB || (CB & (CB - 1)) || R < 1 || R * g > kFactorThreads ||
      Mc < 1 || C < 1 || B < 1 || g != (h > 1 ? h : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (nvar * 8 + h) {
#define TF_CASE(NV, H)                                                                  \
  case NV * 8 + H:                                                                      \
    return launch_staged<T, NV, H>(bands, fac, Dhinv, DU, W, V, Lred, Ured, beta_b, N,  \
                                   Mc, C, wrap, B, T(alpha), T(beta), CB, R, persist,   \
                                   stream);
    TF_CASE(1, 0)
    TF_CASE(1, 1)
    TF_CASE(1, 2)
    TF_CASE(1, 3)
    TF_CASE(1, 4)
    TF_CASE(2, 0)
    TF_CASE(2, 1)
    TF_CASE(2, 2)
    TF_CASE(3, 0)
    TF_CASE(3, 1)
    TF_CASE(4, 0)
    TF_CASE(4, 1)
#undef TF_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif

}  // namespace

#define TF_ENTRY(NAME, T)                                                                \
  extern "C" int NAME(const void* bands, void* fac, void* Dhinv, void* DU, void* W,     \
                      void* V, void* Lred, void* Ured, const void* beta_b, int N,       \
                      int nvar, int g, int h, int Mc, int C, int wrap, int B, int CB,   \
                      int R, int persist, double alpha, double beta, void* stream) {    \
    return launch<T>(static_cast<const T*>(bands), static_cast<T*>(fac),                \
                     static_cast<T*>(Dhinv), static_cast<T*>(DU), static_cast<T*>(W),   \
                     static_cast<T*>(V), static_cast<T*>(Lred), static_cast<T*>(Ured),  \
                     static_cast<const T*>(beta_b), N, nvar, g, h, Mc, C, wrap, B,      \
                     alpha, beta, CB, R, persist, static_cast<cudaStream_t>(stream));   \
  }

// a library built by dtype (ops/_build.py: Library) keeps one type's entries
#ifndef TF_ONLY_F64
TF_ENTRY(tf_spike_factor_f32, float)
#endif
#ifndef TF_ONLY_F32
TF_ENTRY(tf_spike_factor_f64, double)
#endif
