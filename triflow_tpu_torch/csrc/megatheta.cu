// K9: the opt-in two-pass theta step of one periodic grid, generated per
// model (ops/stencil.py prints the model's F and J into the block marked
// GENERATED below, as for K1 and K6) and compiled at first use.
//
// Replaces, on the TPU: ops/megatheta.py theta_step_tiled, its two
// pallas_calls kernel_a (the interface pass) and kernel_b (the correction
// pass).  One linearized theta step u2 = u + A^-1 (dt F(u)) with
// A = I - theta dt J(u), on the chunked SPIKE algebra of K2-K4
// (spike_factor.cu has the layout): supernodes of g = max(halo, 1) nodes,
// blocks of S = nvar g, C chunks of Mc rows, chunk c owning supernodes
// [c Mc, (c + 1) Mc), T_c the chunk's block-tridiagonal matrix with its
// outer couplings Tl = L_0 (to chunk c - 1) and Tr = U_{Mc-1} (to chunk
// c + 1) split off.  Both passes evaluate every row of A and of dt F from
// u, x and the parameters where the sweep needs it (the generated tf_F and
// tf_J at the supernode's g nodes, the periodic ring applied to the index
// as K1 does), so neither writes bands, factor rows, a right-hand side or
// a sweep intermediate to device memory: the step's only state-sized
// output is u2.
//
//   interface entry: the chunk's rows of the reduced interface system, in
//     K2's and K3's layouts, which K4 takes as they are: Lred, Ured
//     (2S, 2S, C) from the first and last blocks of the spikes
//     W = T_c^-1 (Tl e_0) and V = T_c^-1 (Tr e_{Mc-1}), and yred (2S, C)
//     from the first and last rows of y = T_c^-1 (dt F).  Two sweeps and
//     no per-row storage: the top-down block-Thomas elimination ends on the
//     last rows (y, W and V at row Mc - 1 are Dh_{Mc-1} times their swept
//     right-hand sides), and the same elimination run bottom-up ends on the
//     first rows.  The reference (_tile_solve) keeps every row's operators
//     for one backward sweep instead; both compute T_c^-1 of the same
//     columns.
//   correct entry: u2 = u + T_c^-1 (dt F - Tl x_{c-1} e_0 - Tr x_{c+1}
//     e_{Mc-1}), x_{c-1} the bottom interface unknowns of chunk c - 1 (xm1)
//     and x_{c+1} the top ones of chunk c + 1 (xp1), both from
//     K4.pcr_solve_shift: the reference's u + y - W xm1 - V xp1 as one
//     block-Thomas solve whose end rows carry the couplings.  Its forward
//     sweep keeps Dh_j U_j and Dh_j b_j of every row in shared memory for
//     the back substitution (Mc (S^2 + S) values: the plan's Mc is at most
//     kMaxMc).
//
// Bound: the step reads u, x and the parameters in each pass and writes
// u2 once (about 7 state passes for Burgers), with a few tens of
// operations per node and sweep, so the work is bound by bytes; but the
// rows of a chunk are eliminated one after the other, each a chain of
// dependent operations (a J and F evaluation, an S x S inverse, block
// products), with at most pcr.MAX_C = 16384 chunks.  So each pass is bound
// by the latency of its sweeps.  The design takes the evaluation off the
// chain: one warp per chunk (one block each), whose 32 lanes evaluate 32
// consecutive rows at once (neighbour lanes read neighbour nodes) into a
// shared-memory tile, and lane 0 then runs the elimination over the tile's
// rows, which needs only the block algebra.  Other warps on the SM hide
// lane 0's latency; the chunk plan (ops/megatheta.py) trades the chain's
// length Mc against K4's cost in C.
#include "common.cuh"

// ---- GENERATED: model constants and expression bodies ----
// @GENERATED@
// ---- end of generated block ----

#include "factor.cuh"
#include "stencil.cuh"

namespace {

constexpr int kG = TF_H > 0 ? TF_H : 1;
constexpr int kS = TF_NVAR * kG;
// most rows of a chunk the correct entry keeps: ops/megatheta.py's MAX_MC,
// spliced into the generated block
constexpr int kMaxMc = TF_MAX_MC;
// one warp per chunk, one chunk per block
constexpr int kWarp = 32;

template <typename T>
using Blk = tf::Blk<T, kS>;

template <typename T>
struct Row {
  Blk<T> L, D, U;  // couplings of supernode I to I - 1, I and I + 1
  T r[kS];         // dt F at the supernode's nodes
};

// Row I of A = I + beta J and its right-hand side.  J's bands at the
// supernode's g nodes go into a local array laid out as K1's bands of a
// grid of g nodes, so K2's band_block assembles the blocks from it.
template <typename T>
__device__ __forceinline__ void eval_row(const T* u, const T* hlp, const T* par, const T* x,
                                         long N, long I, T beta, T dt, Row<T>& row) {
  T bands[tf::kNJ * kG];
#pragma unroll
  for (int a = 0; a < kG; ++a) {
    const long i = I * kG + a;
    T args[TF_NARGS];
    T f[TF_NVAR];
    T b[tf::kNJ];
    tf::gather(args, i, N, 1, [&](int v, long j, int) { return u[v * N + j]; }, hlp, par, x);
    tf_F(args, f);
#pragma unroll
    for (int m = 0; m < TF_NVAR; ++m) row.r[a * TF_NVAR + m] = dt * f[m];
#pragma unroll
    for (int e = 0; e < tf::kNJ; ++e) b[e] = T(0);
    tf_J(args, b);
#pragma unroll
    for (int e = 0; e < tf::kNJ; ++e) bands[e * kG + a] = b[e];
  }
  row.L = tf::band_block<T, kS>(bands, 0, -1, T(1), beta, kG, TF_NVAR, kG, TF_H);
  row.D = tf::band_block<T, kS>(bands, 0, 0, T(1), beta, kG, TF_NVAR, kG, TF_H);
  row.U = tf::band_block<T, kS>(bands, 0, 1, T(1), beta, kG, TF_NVAR, kG, TF_H);
}

template <typename T>
__device__ __forceinline__ Blk<T> neg(const Blk<T>& a) {
  Blk<T> z;
  tf::zero(z);
  return tf::sub(z, a);
}

// r -= a * v
template <typename T>
__device__ __forceinline__ void sub_mv(T (&r)[kS], const Blk<T>& a, const T (&v)[kS]) {
  T t[kS];
  tf::mv(a, v, t);
#pragma unroll
  for (int q = 0; q < kS; ++q) r[q] = r[q] - t[q];
}

// The warp's lanes evaluate up to 32 rows at once into the tile (lane l:
// row j0 + dir * l, neighbour lanes on neighbour nodes), then lane 0 runs
// the sequential elimination over them.
template <typename T>
__device__ __forceinline__ int fill_tile(const T* u, const T* hlp, const T* par, const T* x,
                                         long N, long I0, int j0, int dir, int rows, T beta,
                                         T dt, Row<T>* tile) {
  const int n = rows < kWarp ? rows : kWarp;
  if ((int)threadIdx.x < n)
    eval_row(u, hlp, par, x, N, I0 + j0 + dir * (int)threadIdx.x, beta, dt, tile[threadIdx.x]);
  __syncwarp();
  return n;
}

template <typename T>
__global__ void __launch_bounds__(kWarp)
    megatheta_interface_kernel(const T* __restrict__ u, const T* __restrict__ hlp,
                               const T* __restrict__ par, const T* __restrict__ x,
                               T* __restrict__ Lred, T* __restrict__ Ured,
                               T* __restrict__ yred, long N, int Mc, int C, int wrap, T beta,
                               T dt) {
  __shared__ Row<T> tile[kWarp];
  const int c = blockIdx.x;
  const bool lead = threadIdx.x == 0;
  const long I0 = (long)c * Mc;

  // top-down: fac_j = L_j Dh_{j-1}, Dh_j = (D_j - fac_j U_{j-1})^-1, the
  // right-hand sides b_j -= fac_j b_{j-1} (dt F; Tl's column from row 0)
  Blk<T> dh, up, wt, Tl, Tr;
  T bt[kS];
  tf::zero(dh);
  tf::zero(up);
  tf::zero(wt);
  tf::zero(Tl);
  tf::zero(Tr);
#pragma unroll
  for (int q = 0; q < kS; ++q) bt[q] = T(0);
  for (int j0 = 0; j0 < Mc; j0 += kWarp) {
    const int n = fill_tile(u, hlp, par, x, N, I0, j0, 1, Mc - j0, beta, dt, tile);
    if (lead) {
      for (int k = 0; k < n; ++k) {
        const int j = j0 + k;
        Row<T> row = tile[k];
        if (j == 0) {
          Tl = row.L;
          if (!wrap && c == 0) tf::zero(Tl);
          tf::zero(row.L);
        }
        if (j == Mc - 1) {
          Tr = row.U;
          if (!wrap && c == C - 1) tf::zero(Tr);
          tf::zero(row.U);
        }
        const Blk<T> f = tf::mm(row.L, dh);
        dh = tf::inv(tf::sub(row.D, tf::mm(f, up)));
        sub_mv(row.r, f, bt);
#pragma unroll
        for (int q = 0; q < kS; ++q) bt[q] = row.r[q];
        wt = j == 0 ? Tl : neg(tf::mm(f, wt));
        up = row.U;
      }
    }
    __syncwarp();
  }

  // bottom-up: the same elimination from row Mc - 1 (Tr's column) to row 0
  Blk<T> eh, lo, vt;
  T ct[kS];
  tf::zero(eh);
  tf::zero(lo);
  tf::zero(vt);
#pragma unroll
  for (int q = 0; q < kS; ++q) ct[q] = T(0);
  for (int j1 = Mc - 1; j1 >= 0; j1 -= kWarp) {
    const int n = fill_tile(u, hlp, par, x, N, I0, j1, -1, j1 + 1, beta, dt, tile);
    if (lead) {
      for (int k = 0; k < n; ++k) {
        const int j = j1 - k;
        Row<T> row = tile[k];
        if (j == 0) tf::zero(row.L);
        if (j == Mc - 1) tf::zero(row.U);
        const Blk<T> f = tf::mm(row.U, eh);
        eh = tf::inv(tf::sub(row.D, tf::mm(f, lo)));
        sub_mv(row.r, f, ct);
#pragma unroll
        for (int q = 0; q < kS; ++q) ct[q] = row.r[q];
        vt = j == Mc - 1 ? Tr : neg(tf::mm(f, vt));
        lo = row.L;
      }
    }
    __syncwarp();
  }
  if (!lead) return;
  T yl[kS], y0[kS];
  tf::mv(dh, bt, yl);
  tf::mv(eh, ct, y0);
  const Blk<T> Wl = tf::mm(dh, wt), Vl = tf::mm(dh, Tr);
  const Blk<T> W0 = tf::mm(eh, Tl), V0 = tf::mm(eh, vt);

  // K2's rows of the reduced system and K3's interface right-hand side
  const bool keep_l = wrap || c != 0;
  const bool keep_u = wrap || c != C - 1;
#pragma unroll
  for (int r = 0; r < 2 * kS; ++r) {
#pragma unroll
    for (int q = 0; q < 2 * kS; ++q) {
      T lv = T(0), uv = T(0);
      if (q >= kS) lv = (r < kS) ? W0.v[r][q - kS] : Wl.v[r - kS][q - kS];
      if (q < kS) uv = (r < kS) ? V0.v[r][q] : Vl.v[r - kS][q];
      Lred[((long)r * 2 * kS + q) * C + c] = keep_l ? lv : T(0);
      Ured[((long)r * 2 * kS + q) * C + c] = keep_u ? uv : T(0);
    }
    yred[(long)r * C + c] = r < kS ? y0[r] : yl[r - kS];
  }
}

// per row of the correct entry's store: Dh_j U_j, then Dh_j b_j (x_j after
// the back substitution)
constexpr int kStore = kS * kS + kS;

template <typename T>
__global__ void __launch_bounds__(kWarp)
    megatheta_correct_kernel(const T* __restrict__ u, const T* __restrict__ hlp,
                             const T* __restrict__ par, const T* __restrict__ x,
                             const T* __restrict__ xm1, const T* __restrict__ xp1,
                             T* __restrict__ out, long N, int Mc, int C, int wrap, T beta,
                             T dt) {
  __shared__ Row<T> tile[kWarp];
  extern __shared__ __align__(16) unsigned char smem[];
  T* store = reinterpret_cast<T*>(smem);  // Mc rows of kStore
  const int c = blockIdx.x;
  const bool lead = threadIdx.x == 0;
  const long I0 = (long)c * Mc;
  Blk<T> dh, up;
  T bt[kS], xv[kS];
  tf::zero(dh);
  tf::zero(up);
#pragma unroll
  for (int q = 0; q < kS; ++q) bt[q] = T(0);
  for (int j0 = 0; j0 < Mc; j0 += kWarp) {
    const int n = fill_tile(u, hlp, par, x, N, I0, j0, 1, Mc - j0, beta, dt, tile);
    if (lead) {
      for (int k = 0; k < n; ++k) {
        const int j = j0 + k;
        Row<T> row = tile[k];
        if (j == 0) {
          Blk<T> Tl = row.L;
          if (!wrap && c == 0) tf::zero(Tl);
          tf::zero(row.L);
#pragma unroll
          for (int q = 0; q < kS; ++q) xv[q] = xm1[(long)q * C + c];
          sub_mv(row.r, Tl, xv);
        }
        if (j == Mc - 1) {
          Blk<T> Tr = row.U;
          if (!wrap && c == C - 1) tf::zero(Tr);
          tf::zero(row.U);
#pragma unroll
          for (int q = 0; q < kS; ++q) xv[q] = xp1[(long)q * C + c];
          sub_mv(row.r, Tr, xv);
        }
        const Blk<T> f = tf::mm(row.L, dh);
        dh = tf::inv(tf::sub(row.D, tf::mm(f, up)));
        sub_mv(row.r, f, bt);
        T* st = store + (long)j * kStore;
        const Blk<T> DU = tf::mm(dh, row.U);
#pragma unroll
        for (int p = 0; p < kS; ++p) {
#pragma unroll
          for (int q = 0; q < kS; ++q) st[p * kS + q] = DU.v[p][q];
          bt[p] = row.r[p];
        }
        T hb[kS];
        tf::mv(dh, bt, hb);
#pragma unroll
        for (int q = 0; q < kS; ++q) st[kS * kS + q] = hb[q];
        up = row.U;
      }
    }
    __syncwarp();
  }
  // back substitution x_j = Dh_j b_j - Dh_j U_j x_{j+1} (lane 0), then
  // u2 = u + x over the chunk's nodes (every lane)
  if (lead) {
#pragma unroll
    for (int q = 0; q < kS; ++q) xv[q] = T(0);
    for (int j = Mc - 1; j >= 0; --j) {
      T* st = store + (long)j * kStore;
      Blk<T> DU;
      T xj[kS];
#pragma unroll
      for (int p = 0; p < kS; ++p) {
#pragma unroll
        for (int q = 0; q < kS; ++q) DU.v[p][q] = st[p * kS + q];
        xj[p] = st[kS * kS + p];
      }
      sub_mv(xj, DU, xv);
#pragma unroll
      for (int q = 0; q < kS; ++q) st[kS * kS + q] = xv[q] = xj[q];
    }
  }
  __syncwarp();
  for (int j = threadIdx.x; j < Mc; j += kWarp) {
    const T* xj = store + (long)j * kStore + kS * kS;
    const long base = (I0 + j) * kG;
#pragma unroll
    for (int q = 0; q < kS; ++q) {
      const long k = (long)(q % TF_NVAR) * N + base + q / TF_NVAR;
      out[k] = u[k] + xj[q];
    }
  }
}

template <typename T>
int launch_interface(const T* u, const T* hlp, const T* par, const T* x, T* Lred, T* Ured,
                     T* yred, long N, int Mc, int C, int wrap, double beta, double dt,
                     cudaStream_t stream) {
  if (Mc < 2 || (long)Mc * C * kG != N) return static_cast<int>(cudaErrorInvalidValue);
  megatheta_interface_kernel<T><<<C, kWarp, 0, stream>>>(u, hlp, par, x, Lred, Ured, yred, N,
                                                         Mc, C, wrap, T(beta), T(dt));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_correct(const T* u, const T* hlp, const T* par, const T* x, const T* xm1,
                   const T* xp1, T* out, long N, int Mc, int C, int wrap, double beta,
                   double dt, cudaStream_t stream) {
  if (Mc < 2 || Mc > kMaxMc || (long)Mc * C * kG != N)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = Mc * kStore * (int)sizeof(T);
  // above the 48 KB a block takes by default, the store needs the opt-in
  if (bytes + (int)sizeof(Row<T>) * kWarp > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        megatheta_correct_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  megatheta_correct_kernel<T><<<C, kWarp, bytes, stream>>>(u, hlp, par, x, xm1, xp1, out, N,
                                                           Mc, C, wrap, T(beta), T(dt));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define TF_ENTRIES(SUFFIX, T)                                                                \
  extern "C" int tf_megatheta_interface_##SUFFIX(                                           \
      const void* u, const void* hlp, const void* par, const void* x, void* Lred,           \
      void* Ured, void* yred, int N, int Mc, int C, int wrap, double beta, double dt,       \
      void* stream) {                                                                       \
    return launch_interface<T>(static_cast<const T*>(u), static_cast<const T*>(hlp),        \
                               static_cast<const T*>(par), static_cast<const T*>(x),        \
                               static_cast<T*>(Lred), static_cast<T*>(Ured),                \
                               static_cast<T*>(yred), N, Mc, C, wrap, beta, dt,             \
                               static_cast<cudaStream_t>(stream));                          \
  }                                                                                         \
  extern "C" int tf_megatheta_correct_##SUFFIX(                                             \
      const void* u, const void* hlp, const void* par, const void* x, const void* xm1,      \
      const void* xp1, void* out, int N, int Mc, int C, int wrap, double beta, double dt,   \
      void* stream) {                                                                       \
    return launch_correct<T>(static_cast<const T*>(u), static_cast<const T*>(hlp),          \
                             static_cast<const T*>(par), static_cast<const T*>(x),          \
                             static_cast<const T*>(xm1), static_cast<const T*>(xp1),        \
                             static_cast<T*>(out), N, Mc, C, wrap, beta, dt,                \
                             static_cast<cudaStream_t>(stream));                            \
  }

// a model computes in one dtype: its library carries that dtype's entries
#if TF_F32
TF_ENTRIES(f32, float)
#else
TF_ENTRIES(f64, double)
#endif
