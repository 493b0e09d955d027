// K3: the per-right-hand-side part of the chunked SPIKE solve, two entries.
//
// Replaces, on the TPU: ops/pallas_thomas.py chunked_solve_flat (the
// chunk-local forward and backward Thomas sweeps) and the spike correction
// of ops/folded.py _solve_folded_flat, which the reference left to an XLA
// expression with the state add (`add_to`) fused in.
//
// thomas_sweep: a block per group of CB chunks of one member.  With the
// factors of K2 it solves the chunk-local system with the outer couplings
// removed,
//   bt_j = b_j - fac_j bt_{j-1},   y_j = Dh_j bt_j - DU_j y_{j+1},
// writes y in the node layout (nvar, N) of the right-hand side, and the
// interface right-hand side yred (2S, C) = (y_0, y_{Mc-1}) of every chunk.
//
// spike_correct: with the interface unknowns of the neighbours from K4
// (xm1 = x_{c-1}^bot, xp1 = x_{c+1}^top, each (S, C)),
//   x = y - W xm1 - V xp1   (+ add_to, the theta step's u + A^-1 dt F).
//
// Member axis: both entries take B grids (an ensemble) in one launch, one
// block per group of chunks (and for the correction, of rows) of the B C
// chunks of all members, taken in turn; member
// b's arrays sit at b times one grid's size (rhs, y, add_to and out (B,
// nvar, N), factor rows (B, Mc, S, S, C), yred (B, 2S, C), xm1 and xp1 (B,
// S, C)).  One grid (B = 1) launches the correction's instantiations
// without member offsets (kMembers).
//
// Bound: the sweep's recurrence is sequential along the Mc rows of a
// chunk, but none of its loads depends on it: the factor rows and the
// right-hand side of rows j+1.. are known before row j is solved.  So the
// sweep is built for Hopper as a pipeline (thomas_sweep_kernel): every
// thread of the block copies tiles of R rows into a ring of kStages
// shared-memory stages with cp.async, kStages - 1 tiles ahead of the walk;
// each stage holds, for the block's chunks, the rows' fac (forward) or
// Dhinv and DU (backward) blocks, contiguous across chunks for each entry,
// and the chunks' right-hand side segments, each contiguous in the node
// layout (Mc * g nodes per field and chunk) and so copied coalesced and
// transposed into a chunk-minor tile.  One lane per chunk (the walkers,
// the block's first CB threads) runs the recurrence from shared memory.
// The forward results stay in shared memory for the backward pass where
// the chunks' rows fit (``persist``: Mc * S * CB values); otherwise they
// stream through y, written by the forward pass and copied back into the
// ring by the backward one.  y leaves through a shared tile, in coalesced
// node-layout rows.  The host plans CB, R and persist
// (``ops/thomas.py:sweep_plan``): fewer chunks per block where the grid has
// few, so that more SMs take part, and the stages within the shared memory
// a block may use.  The bytes bound it: the factor rows and the right-hand
// side read once, y written once.
//
// The correction is bandwidth-bound: it reads y, the two spikes W and V
// (S^2 values per supernode each: 4 of the 6 values a node moves at S = 2,
// 36 of 42 per grid point at the film's S = 6), xm1, xp1 and add_to once
// and writes x once.  One thread per node read its spikes at ((j S + r) S
// + q) C + c, so a warp's loads of W and V strode by S C or S^2 C entries
// and each value took a 32-byte sector of its own.  So the correction is
// tiled (spike_correct_kernel): a block takes CB consecutive chunks by R
// rows, reads W, V, xm1 and xp1 along the chunks, their contiguous axis,
// then y and add_to and writes x along each chunk's node segment, the node
// layout's contiguous axis, through a shared-memory tile of the sums.
// The host plans CB and R (``ops/thomas.py:correct_plan``).
//
// K6 (megastep.cu) keeps the one-thread bodies of sweep.cuh: the sweep of
// a chunk (thomas_sweep_chunk) and the correction of a node
// (spike_correct_node), whose sums the tiled correction keeps in order.
//
// Wide blocks (S = 5..8) are built into a library of their own, from this
// file with TF_WIDE defined: the same bodies, one lane per chunk or per
// (row, chunk) pair.  They hold vectors of S entries and stream each
// block's entries into a product, so unlike K2 and K4's factor they need no
// group of lanes.
#include "common.cuh"
#include "cp_async.cuh"

#ifdef TF_WIDE
#define TF_CASES TF_CASE(5) TF_CASE(6) TF_CASE(7) TF_CASE(8)
// the correction's (S, g) pairs: S = nvar g, g = max(halo, 1)
#define TF_CORRECT_CASES                                                              \
  TF_CC(5, 1) TF_CC(5, 5) TF_CC(6, 1) TF_CC(6, 2) TF_CC(6, 3) TF_CC(6, 6) TF_CC(7, 1) \
  TF_CC(7, 7) TF_CC(8, 1) TF_CC(8, 2) TF_CC(8, 4) TF_CC(8, 8)
#else
#define TF_CASES TF_CASE(1) TF_CASE(2) TF_CASE(3) TF_CASE(4)
#define TF_CORRECT_CASES \
  TF_CC(1, 1) TF_CC(2, 1) TF_CC(2, 2) TF_CC(3, 1) TF_CC(3, 3) TF_CC(4, 1) TF_CC(4, 2) TF_CC(4, 4)
#endif

namespace {

constexpr int kSweepThreads = 128;
constexpr int kStages = 4;
constexpr int kMaxCB = 32;
// the correction: threads of a block, most chunks a block takes
constexpr int kCorrectThreads = 256;
constexpr int kMaxCorrectCB = 32;

using tf::cp_async;
using tf::cp_async_commit;
using tf::cp_async_wait;

// A block's chunks and what each of its threads copies.  The block walks
// CB consecutive chunks of the B * C chunks of all members (flat index q:
// member q / C, chunk q % C), nch of them real; base[l] and seg0[l] (shared
// memory) are lane l's offsets into the factor rows and the node layout.
// A thread copies the block tiles' entries of one lane, bl, every
// kSweepThreads / CB entries from be, and the vector tiles' node vk of a
// chunk segment of R * g nodes, for every (variable, lane) pair vp, vp +
// vstep, ...  (CB is a power of two, 2^lcb, at most 32.)
struct Tiles {
  int nch, CB, lcb, R, Mc, C, N, nvar, g;
  int bl, be, vk, vp, vstep;
  const long* base;
  const long* seg0;
};

// Rows [j0, j0 + nr) of the S x S blocks ``src`` (layout (B, Mc, S, S,
// C)) into the chunk-minor tile dst[(jj * S * S + e) * CB + l].
template <typename T, int S>
__device__ __forceinline__ void load_blocks(T* dst, const T* src, const Tiles& G, int j0,
                                            int nr) {
  if (G.bl >= G.nch) return;
  const T* from = src + G.base[G.bl] + (long)j0 * S * S * G.C;
  for (int e = G.be; e < nr * S * S; e += kSweepThreads >> G.lcb)
    cp_async(dst + e * G.CB + G.bl, from + (long)e * G.C);
}

// Rows [j0, j0 + nr) of the chunks' node-layout vectors ``src`` ((B,
// nvar, N)) into the tile dst[(jj * S + r) * CB + l]: consecutive threads
// take consecutive nodes of one chunk's segment.
template <typename T, int S>
__device__ __forceinline__ void load_vec(T* dst, const T* src, const Tiles& G, int j0, int nr) {
  if (G.vp >= G.vstep || G.vk >= nr * G.g) return;
  const int jj = G.vk / G.g, a = G.vk % G.g;
  for (int p = G.vp; p < (G.nvar << G.lcb); p += G.vstep) {
    const int l = p & (G.CB - 1), m = p >> G.lcb;
    if (l < G.nch)
      cp_async(dst + (jj * S + a * G.nvar + m) * G.CB + l,
               src + G.seg0[l] + (long)m * G.N + (long)j0 * G.g + G.vk);
  }
}

// The tile src[(jj * S + r) * CB + l] back to the node layout, coalesced.
template <typename T, int S>
__device__ __forceinline__ void store_vec(T* dst, const T* src, const Tiles& G, int j0,
                                          int nr) {
  if (G.vp >= G.vstep || G.vk >= nr * G.g) return;
  const int jj = G.vk / G.g, a = G.vk % G.g;
  for (int p = G.vp; p < (G.nvar << G.lcb); p += G.vstep) {
    const int l = p & (G.CB - 1), m = p >> G.lcb;
    if (l < G.nch)
      dst[G.seg0[l] + (long)m * G.N + (long)j0 * G.g + G.vk] =
          src[(jj * S + a * G.nvar + m) * G.CB + l];
  }
}

// y = a x for the chunk-minor block a[(i * S + q) * CB] in shared memory.
template <typename T, int S>
__device__ __forceinline__ void mv_tile(const T* a, int CB, const T (&x)[S], T (&y)[S]) {
#pragma unroll
  for (int i = 0; i < S; ++i) {
    T acc = a[(i * S) * CB] * x[0];
#pragma unroll
    for (int q = 1; q < S; ++q) acc += a[(i * S + q) * CB] * x[q];
    y[i] = acc;
  }
}

// Shared memory: kStages stages of (mat0, mat1: R S S CB each; vec: R S
// CB), the out tile (R S CB), and with persist the forward results (Mc S
// CB).  Every thread copies; the block's first CB threads walk.
template <typename T, int S>
__global__ void __launch_bounds__(kSweepThreads)
    thomas_sweep_kernel(const T* __restrict__ fac, const T* __restrict__ Dhinv,
                        const T* __restrict__ DU, const T* __restrict__ rhs, T* y, T* yred,
                        int N, int nvar, int g, int Mc, int C, int B, int CB, int R,
                        int persist) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ long base[kMaxCB], seg0[kMaxCB];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const long q0 = (long)blockIdx.x * CB;
  const int nch = (int)min((long)CB, (long)B * C - q0);
  const int l = threadIdx.x;
  long red = 0;  // lane l's column of yred
  if (l < nch) {
    const long b = (q0 + l) / C;
    const int c = (int)((q0 + l) % C);
    base[l] = b * Mc * S * S * C + c;
    seg0[l] = b * nvar * N + (long)c * Mc * g;
    red = b * 2L * S * C + c;
  }
  const int lcb = 31 - __clz(CB), seg = R * g;
  const Tiles G{nch, CB, lcb, R, Mc, C, N, nvar, g,
                l & (CB - 1), l >> lcb, l % seg, l / seg, kSweepThreads / seg, base, seg0};
  __syncthreads();

  const int mat = R * S * S * CB, vec = R * S * CB, stage = 2 * mat + vec;
  T* out = smem + kStages * stage;
  T* kept = out + vec;  // the forward results, with persist
  const int tiles = (Mc + R - 1) / R;
  const bool walker = l < CB;

  // forward: tile t in stage t % kStages, fac in mat0, rhs in vec
  auto issue_fwd = [&](int t) {
    if (t < tiles) {
      T* st = smem + (t % kStages) * stage;
      const int j0 = t * R, nr = min(R, Mc - j0);
      load_blocks<T, S>(st, fac, G, j0, nr);
      load_vec<T, S>(st + 2 * mat, rhs, G, j0, nr);
    }
    cp_async_commit();
  };
  for (int t = 0; t < kStages; ++t) issue_fwd(t);
  T bt[S];
#pragma unroll
  for (int r = 0; r < S; ++r) bt[r] = T(0);
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* st = smem + (t % kStages) * stage;
    const int j0 = t * R, nr = min(R, Mc - j0);
    if (walker) {
      for (int jj = 0; jj < nr; ++jj) {
        T m[S];
        mv_tile<T, S>(st + jj * S * S * CB + l, CB, bt, m);
        const T* bv = st + 2 * mat + jj * S * CB + l;
        T* o = persist ? kept + (long)(j0 + jj) * S * CB + l : out + jj * S * CB + l;
#pragma unroll
        for (int r = 0; r < S; ++r) {
          bt[r] = bv[r * CB] - m[r];
          o[r * CB] = bt[r];
        }
      }
    }
    __syncthreads();
    if (!persist) store_vec<T, S>(y, out, G, j0, nr);
    issue_fwd(t + kStages);
  }
  cp_async_wait<0>();
  __threadfence_block();
  __syncthreads();

  // backward: tile tiles-1-k in stage k % kStages, Dhinv in mat0, DU in
  // mat1, and (without persist) the forward results from y in vec
  auto issue_bwd = [&](int k) {
    const int t = tiles - 1 - k;
    if (t >= 0) {
      T* st = smem + (k % kStages) * stage;
      const int j0 = t * R, nr = min(R, Mc - j0);
      load_blocks<T, S>(st, Dhinv, G, j0, nr);
      load_blocks<T, S>(st + mat, DU, G, j0, nr);
      if (!persist) load_vec<T, S>(st + 2 * mat, y, G, j0, nr);
    }
    cp_async_commit();
  };
  for (int k = 0; k < kStages; ++k) issue_bwd(k);
  T yn[S];
#pragma unroll
  for (int r = 0; r < S; ++r) yn[r] = T(0);
  for (int k = 0; k < tiles; ++k) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* st = smem + (k % kStages) * stage;
    const int j0 = (tiles - 1 - k) * R, nr = min(R, Mc - j0);
    if (walker) {
      for (int jj = nr - 1; jj >= 0; --jj) {
        const T* bsrc = persist ? kept + (long)(j0 + jj) * S * CB + l
                                : st + 2 * mat + jj * S * CB + l;
        T bj[S], p[S], m[S];
#pragma unroll
        for (int r = 0; r < S; ++r) bj[r] = bsrc[r * CB];
        mv_tile<T, S>(st + jj * S * S * CB + l, CB, bj, p);
        mv_tile<T, S>(st + mat + jj * S * S * CB + l, CB, yn, m);
#pragma unroll
        for (int r = 0; r < S; ++r) {
          yn[r] = p[r] - m[r];
          out[(jj * S + r) * CB + l] = yn[r];
        }
        if (j0 + jj == Mc - 1 && l < nch) {
#pragma unroll
          for (int r = 0; r < S; ++r) yred[red + (long)(S + r) * C] = yn[r];
        }
      }
    }
    __syncthreads();
    store_vec<T, S>(y, out, G, j0, nr);
    issue_bwd(k + kStages);
  }
  cp_async_wait<0>();
  if (l < nch) {
#pragma unroll
    for (int r = 0; r < S; ++r) yred[red + (long)r * C] = yn[r];
  }
}

// The correction of a tile: CB consecutive chunks (flat index q of the B C
// chunks of all members, as the sweep takes them; CB = 2^lcb) by R
// supernode rows from row tile * R, blockIdx.x = group * tiles + tile.
// Phase 1: the threads take the tile's (row, chunk) pairs in turn, the
// chunk fastest, and sum the S rows of W xm1 + V xp1 at each pair's row; a warp's loads of
// one entry of W or V are the CB consecutive chunks' values, contiguous in
// the chunk-minor layout (B, Mc, S, S, C), and so are those of xm1 and
// xp1 (B, S, C).  The sums go to a shared tile cs[l (R S + 1) + jj S + r]
// (one pad entry per chunk: the phase-2 reads of consecutive nodes do not
// share a bank).  Phase 2: consecutive threads take consecutive nodes of
// one chunk's segment of R g nodes of one field (contiguous in the node
// layout (B, nvar, N)), padded to P = 2^lp >= R g lanes, and write out =
// add_to + (y - corr).  The segment offsets of the block's chunks come
// once per block (lane l's in wb, xb, nb); every other index is a shift,
// a mask or a division by the compile-time g.  The sums and the update
// are tf::spike_correct_node's, in its order.
template <typename T, int S, int G, bool kMembers>
__global__ void __launch_bounds__(kCorrectThreads, 4)
    spike_correct_kernel(const T* __restrict__ y, const T* __restrict__ Wsp,
                         const T* __restrict__ Vsp, const T* __restrict__ xm1,
                         const T* __restrict__ xp1, const T* __restrict__ add_to,
                         T* __restrict__ out, int N, int Mc, int C, int B, int lcb, int R,
                         int tiles) {
  constexpr int NV = S / G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ long wb[kMaxCorrectCB], xb[kMaxCorrectCB], nb[kMaxCorrectCB];
  T* cs = reinterpret_cast<T*>(smem_raw);
  const int CB = 1 << lcb, tid = threadIdx.x;
  const int grp = blockIdx.x / tiles, tile = blockIdx.x - grp * tiles;
  const long q0 = (long)grp << lcb;
  const int nch = (int)min((long)CB, (long)B * C - q0);
  const int j0 = tile * R, nr = min(R, Mc - j0);
  if (tid < nch) {
    const long q = q0 + tid;
    const long b = kMembers ? q / C : 0, c = q - b * C;
    wb[tid] = (b * Mc + j0) * S * S * C + c;
    xb[tid] = b * S * C + c;
    nb[tid] = b * NV * N + (c * Mc + j0) * G;
  }
  __syncthreads();
  const int ld = R * S + 1;
  for (int p = tid; p < (nr << lcb); p += kCorrectThreads) {
    const int l = p & (CB - 1), jj = p >> lcb;
    if (l >= nch) continue;
    const long at0 = wb[l] + (long)jj * S * S * C;
    const T* w = Wsp + at0;
    const T* v = Vsp + at0;
    T xm[S], xp[S];
#pragma unroll
    for (int q = 0; q < S; ++q) {
      xm[q] = xm1[xb[l] + (long)q * C];
      xp[q] = xp1[xb[l] + (long)q * C];
    }
#pragma unroll
    for (int r = 0; r < S; ++r) {
      T corr = T(0);
#pragma unroll
      for (int q = 0; q < S; ++q) {
        const long at = (long)(r * S + q) * C;
        corr += w[at] * xm[q] + v[at] * xp[q];
      }
      cs[l * ld + jj * S + r] = corr;
    }
  }
  __syncthreads();
  const int rg = nr * G, lp = 32 - __clz(R * G - 1);
  for (int e = tid; e < ((NV << lcb) << lp); e += kCorrectThreads) {
    const int k = e & ((1 << lp) - 1), pm = e >> lp;
    const int l = pm & (CB - 1), m = pm >> lcb;
    if (k >= rg || l >= nch) continue;
    const int jj = k / G, a = k - jj * G;
    const T corr = cs[l * ld + jj * S + a * NV + m];
    const long at = nb[l] + (long)m * N + k;
    const T x = y[at] - corr;
    out[at] = add_to ? add_to[at] + x : x;
  }
}

// Shared memory of a sweep plan, in bytes (ops/thomas.py:sweep_plan
// computes the same).
long sweep_smem(int S, int item, int Mc, int CB, int R, int persist) {
  return (long)item * CB *
         ((long)kStages * R * (2 * S * S + S) + (long)R * S + (persist ? (long)Mc * S : 0));
}

template <typename T, int S>
int launch_sweep(const T* fac, const T* Dhinv, const T* DU, const T* rhs, T* y, T* yred, int N,
                 int nvar, int g, int Mc, int C, int B, int CB, int R, int persist,
                 cudaStream_t stream) {
  const long bytes = sweep_smem(S, sizeof(T), Mc, CB, R, persist);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        thomas_sweep_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long blocks = ((long)B * C + CB - 1) / CB;
  thomas_sweep_kernel<T, S><<<blocks, kSweepThreads, bytes, stream>>>(
      fac, Dhinv, DU, rhs, y, yred, N, nvar, g, Mc, C, B, CB, R, persist);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int sweep(const T* fac, const T* Dhinv, const T* DU, const T* rhs, T* y, T* yred, int N,
          int nvar, int g, int Mc, int C, int B, int CB, int R, int persist,
          cudaStream_t stream) {
  if (CB < 1 || CB > kMaxCB || (CB & (CB - 1)) || R < 1 || R * g > kSweepThreads || Mc < 1 ||
      C < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (nvar * g) {
#define TF_CASE(S)                                                                      \
  case S:                                                                               \
    return launch_sweep<T, S>(fac, Dhinv, DU, rhs, y, yred, N, nvar, g, Mc, C, B, CB, R, \
                              persist, stream);
    TF_CASES
#undef TF_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Shared memory of a correction plan (CB chunks by R rows,
// ops/thomas.py:correct_plan), in bytes: the sums of CB chunks' R rows, one
// pad entry each.
long correct_smem(int S, int item, int CB, int R) { return (long)item * CB * (R * S + 1); }

// One launch of the correction on the plan (CB = 2^lcb chunks, R rows per
// block) at block size S = NV G
template <typename T, int S, int G>
int launch_correct(const T* y, const T* W, const T* V, const T* xm1, const T* xp1,
                   const T* add_to, T* out, int N, int Mc, int C, int B, int lcb, int R,
                   cudaStream_t stream) {
  const long bytes = correct_smem(S, sizeof(T), 1 << lcb, R);
  const int tiles = (Mc + R - 1) / R;
  const long blocks = (((long)B * C + (1 << lcb) - 1) >> lcb) * tiles;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  auto fn = B > 1 ? spike_correct_kernel<T, S, G, true> : spike_correct_kernel<T, S, G, false>;
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fn<<<(unsigned)blocks, kCorrectThreads, bytes, stream>>>(y, W, V, xm1, xp1, add_to, out, N,
                                                           Mc, C, B, lcb, R, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int correct(const T* y, const T* W, const T* V, const T* xm1, const T* xp1, const T* add_to,
            T* out, int N, int nvar, int g, int Mc, int C, int has_add, int B, int CB, int R,
            cudaStream_t stream) {
  if (CB < 1 || CB > kMaxCorrectCB || (CB & (CB - 1)) || R < 1 || Mc < 1 || C < 1 || B < 1 ||
      nvar < 1 || g < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lcb = 31 - __builtin_clz(CB);
  if (!has_add) add_to = nullptr;
  switch (nvar * g * 16 + g) {
#define TF_CC(S, G)                                                                   \
  case S * 16 + G:                                                                    \
    return launch_correct<T, S, G>(y, W, V, xm1, xp1, add_to, out, N, Mc, C, B, lcb, \
                                   R, stream);
    TF_CORRECT_CASES
#undef TF_CC
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#define TF_ENTRIES(SUFFIX, T)                                                             \
  extern "C" int tf_thomas_sweep_##SUFFIX(const void* fac, const void* Dhinv,            \
                                          const void* DU, const void* rhs, void* y,      \
                                          void* yred, int N, int nvar, int g, int Mc,    \
                                          int C, int B, int CB, int R, int persist,      \
                                          void* stream) {                                \
    return sweep<T>(static_cast<const T*>(fac), static_cast<const T*>(Dhinv),            \
                    static_cast<const T*>(DU), static_cast<const T*>(rhs),               \
                    static_cast<T*>(y), static_cast<T*>(yred), N, nvar, g, Mc, C, B, CB, \
                    R, persist, static_cast<cudaStream_t>(stream));                      \
  }                                                                                      \
  extern "C" int tf_spike_correct_##SUFFIX(const void* y, const void* W, const void* V,  \
                                           const void* xm1, const void* xp1,             \
                                           const void* add_to, void* out, int N,         \
                                           int nvar, int g, int Mc, int C, int has_add,  \
                                           int B, int CB, int R, void* stream) {         \
    return correct<T>(static_cast<const T*>(y), static_cast<const T*>(W),                \
                      static_cast<const T*>(V), static_cast<const T*>(xm1),              \
                      static_cast<const T*>(xp1), static_cast<const T*>(add_to),         \
                      static_cast<T*>(out), N, nvar, g, Mc, C, has_add, B, CB, R,        \
                      static_cast<cudaStream_t>(stream));                                \
  }

TF_ENTRIES(f32, float)
TF_ENTRIES(f64, double)
