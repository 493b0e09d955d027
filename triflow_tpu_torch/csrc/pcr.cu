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
// unknowns (pcr.cuh: woodbury_cluster).  The solve entry sets it up once
// per factor: the S2 columns of Z are solved like any R right-hand sides
// (below), then one block per member forms the S2 x S2 capacitance from
// the columns' ring-end chunks and inverts it in shared memory
// (woodbury_cap_kernel: woodbury_cap_block's Gauss-Jordan).
//
// The R-column solve (the set-up's columns, or given right-hand sides)
// runs one thread-block cluster per (member, column): the cluster solve
// below, which writes the whole solution column where the per-stage solve
// writes neighbour shifts, so the R columns of every member take their
// levels at once across the card.  One block of 512 threads walking the
// levels of all S2 columns of one grid, each level round-tripping the
// vectors through global scratch, took 358 us at KS 10^6's C = 2000 on
// one SM (PERF.md).  Where many members fill the card on plans of few
// chunks (config 5: B = 1024, C = 100), that one block per member
// (pcr_solve_kernel, pcr.cuh's body, as K6 runs it) is faster and stays
// (ops/pcr.py:cols_route).  The narrow factor's one-block kernel
// (pcr_factor_kernel) is kept for plans of few chunks
// (ops/pcr.py:factor_route: up to 128 a member), whose levels it walks
// faster than a grid-wide barrier a level allows; otherwise the narrow
// factor spreads each level over a cooperative grid across the card
// (pcr_factor_grid_kernel / pcr_factor_thread_kernel below).  A one-block
// kernel's level loop is sequential, and __syncthreads() between the
// phases of a level makes each phase's global scratch writes visible to
// the whole block.
// Member b's arrays sit at b times one member's size (Lred, Ured, Dinv, Z
// (B, S2, S2, C), the level operators (B, nlev, S2, S2, C), right-hand
// sides (B, R, S2, C) and yred (B, S2, C), cap_inv (B, S2, S2), xm1 and
// xp1 (B, S, C), and every scratch), so members never couple.  The reduced
// system is small (C <= 16384 rows of S2 x S2), so each entry is bound by
// the latency of its 2 log2 C dependent phases, not by bandwidth or
// arithmetic.
//
// The per-stage solve with shifts (pcr_solve_shift_cluster_kernel) runs six
// times per RODASPR step, so one SM reading every level operator and
// round-tripping the vector state through global scratch at every level
// was its cost.  It runs on a thread-block cluster of up to 16 CTAs per
// member instead, and so does each column of the R-column solve
// (pcr_solve_cols_cluster_kernel, the same body): each CTA keeps its slice
// of the chunks' S2-vectors (both
// level buffers) in shared memory, reads the neighbours c -+ d of a level
// from the CTAs that own them through distributed shared memory, and
// cluster.sync() separates the levels.  The level operators do not depend
// on the right-hand side, so each CTA streams its slice of them through a
// cp.async ring a few levels ahead; after the levels it applies Dinv, on a
// Woodbury plan the correction (each CTA forms coef = cap_inv V^T z from
// the ring-end chunks' entries), and writes the neighbour shifts (or, a
// column, its solution).  The host plans the CTAs per cluster, chunks per
// CTA and tile (ops/pcr.py:solve_plan, of the B or B R clusters): one CTA
// per cluster where many clusters fill the card, otherwise as many as
// keep about 64 chunks each, and at least as many as fit the state into
// 16 CTAs' shared memory.
//
// The bodies of the one-block entries live in pcr.cuh, beside K6's
// (megastep.cu) cluster bodies of the same arithmetic.
//
// Wide interface blocks (S2 = 10..16, of K2's S = 5..8) are built into a
// library of their own, from this file with TF_WIDE defined.  The R-column
// solve and the solve with shifts are the same cluster kernels (one row of
// a chunk per thread, its products streamed).  The factor, whose S2 x S2 products and
// inverses do not fit one thread's registers, runs each chunk's level on a
// group of S2 lanes, lane r holding row r of every block (wide.cuh), and
// spreads each phase of a level over the whole card
// (pcr_factor_grid_kernel below): its 2 log2 C + 1 dependent phases are
// what bound it, each one pass of lane groups (a 12 x 12 Gauss-Jordan by
// shuffles, or six shuffle products) and a grid-wide barrier.  The narrow
// factor takes the same grid with one phase a level (log2 C + 1).
#include <cooperative_groups.h>

#include "cp_async.cuh"
#include "pcr.cuh"
#include "wide.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
// the cluster solve: most threads of a CTA, most CTAs in a cluster (above 8
// a non-portable size, which H100 takes), and the most copy groups a thread
// lets run ahead of the slab it waits for
constexpr int kSolveThreads = 512;
constexpr int kMaxCluster = 16;
constexpr int kMaxAhead = 7;
constexpr int kMaxDevices = 16;

// wait until at most min(n, kMaxAhead) of this thread's copy groups are in
// flight (a larger n waits for more than it must)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n < kMaxAhead ? n : kMaxAhead) {
    case 0: tf::cp_async_wait<0>(); break;
    case 1: tf::cp_async_wait<1>(); break;
    case 2: tf::cp_async_wait<2>(); break;
    case 3: tf::cp_async_wait<3>(); break;
    case 4: tf::cp_async_wait<4>(); break;
    case 5: tf::cp_async_wait<5>(); break;
    case 6: tf::cp_async_wait<6>(); break;
    default: tf::cp_async_wait<kMaxAhead>(); break;
  }
}

#ifdef TF_WIDE
#define TF_CASES TF_CASE(10) TF_CASE(12) TF_CASE(14) TF_CASE(16)
#else
#define TF_CASES TF_CASE(2) TF_CASE(4) TF_CASE(6) TF_CASE(8)
#endif

// The factor across many SMs (the wide S2 = 10..16, and the narrow S2 =
// 2..8, where one block per member would run every level of one grid on
// one SM of 132).  A level's chunks are independent once the previous
// level is done: the only order is inverse (Dt_c = D_c^-1 of every chunk)
// -> update (alpha, beta, L', D', U') -> next level.  So each phase is
// spread over the pairs (member, chunk) of the whole grid, and a grid-wide
// barrier separates the phases.  The level state (L, D, U in two buffers
// and, unfused, Dt) lives in global scratch and is small enough to stay in
// L2 for one grid (7 S2^2 B C values: 4 MB at S2 = 12, C = 500, float64);
// it is read with ld.global.cg, past the reading SM's L1, which may hold a
// line another SM rewrote since.  The inputs Lred / Ured and the outputs
// (alphas, betas, Dinv) keep the chunk-minor layout (S2, S2, C) of the
// other entries.  The products, sums and inverses are pcr.cuh's
// pcr_factor_cluster's, in the same order.
//
// Two bodies, fixed by S2 at compile time (grid_factor_kernel):
// - lane groups (pcr_factor_grid_kernel, S2 = 4..16): one group of S2
//   lanes per pair (wide.cuh), lane r holding row r of each block, each
//   pair's block contiguous in the scratch (chunk-major: lane r reads its
//   row as S2 / 2 or S2 / 4 vector loads); each product takes its right
//   operand through the group's block in shared memory (tf::mm_shared),
//   the inverse is one shuffle round a column.  A warp's groups take
//   consecutive pairs.
// - a thread per pair (pcr_factor_thread_kernel, S2 = 2, where lane
//   groups of two would leave most of a warp's shuffles idle): the whole
//   blocks in registers (common.cuh), the scratch chunk-minor over the B C
//   pairs so that a warp's loads of one entry are consecutive.
// With kFused (the narrow S2 but 6) each pair inverts its two neighbours'
// D itself instead of reading Dt, so a level is one phase and one barrier
// (two inverses a pair instead of one: cheap at S2 <= 8).  The wide
// factor keeps two phases a level, and so does S2 = 6, where the fused
// body spilled (4 bytes of spill stores in float64, 24 in float32;
// ptxas -v) and the unfused one does not.
//
// The grid is cooperative: its CTAs (at most what the card holds at once,
// ops/pcr.py:factor_plan_grid / factor_plan_wide) cover every pair of
// every member, the warps (threads) of the grid consecutive runs of pairs,
// in passes until every pair is done, and grid.sync() separates the
// phases.  (One thread-block cluster of up to 16 CTAs per member, the
// cluster barrier between the phases and 512-thread CTAs multiplying by
// shuffles, ran 2.9 times slower at the film's C = 500 and 5 times at C >=
// 2048: 16 SMs against the card's 132; PERF.md.)

// Loads through L2 (ld.global.cg) as volatile asm: none is merged with
// another or moved across the barriers between the phases.
__device__ __forceinline__ void ld_cg(const double* p, double& x, double& y) {
  asm volatile("ld.global.cg.v2.f64 {%0, %1}, [%2];\n" : "=d"(x), "=d"(y) : "l"(p));
}
__device__ __forceinline__ void ld_cg(const float* p, float& x, float& y) {
  asm volatile("ld.global.cg.v2.f32 {%0, %1}, [%2];\n" : "=f"(x), "=f"(y) : "l"(p));
}
__device__ __forceinline__ void ld_cg(const float* p, float& x, float& y, float& z, float& w) {
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x), "=f"(y), "=f"(z), "=f"(w)
               : "l"(p));
}
__device__ __forceinline__ double ld_cg(const double* p) {
  double x;
  asm volatile("ld.global.cg.f64 %0, [%1];\n" : "=d"(x) : "l"(p));
  return x;
}
__device__ __forceinline__ float ld_cg(const float* p) {
  float x;
  asm volatile("ld.global.cg.f32 %0, [%1];\n" : "=f"(x) : "l"(p));
  return x;
}

// row r of the block of pair q, chunk-major (q, S2, S2), through L2: S2 / 4
// 16-byte loads where a row's bytes allow (float, S2 = 4, 8, 12, 16), else
// S2 / 2 pairs (every row starts 8-byte aligned, 16-byte in double)
template <typename T, int S2>
__device__ __forceinline__ tf::Row<T, S2> ld_row(const T* p, long q, int r) {
  const T* a = p + (q * S2 + r) * S2;
  tf::Row<T, S2> out;
  if constexpr (sizeof(T) == 4 && S2 % 4 == 0) {
#pragma unroll
    for (int i = 0; i < S2 / 4; ++i)
      ld_cg(a + 4 * i, out.v[4 * i], out.v[4 * i + 1], out.v[4 * i + 2], out.v[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < S2 / 2; ++i) ld_cg(a + 2 * i, out.v[2 * i], out.v[2 * i + 1]);
  }
  return out;
}

template <typename T, int S2>
__device__ __forceinline__ void st_row(T* p, long q, int r, const tf::Row<T, S2>& x) {
  T* a = p + (q * S2 + r) * S2;
  if constexpr (sizeof(T) == 4 && S2 % 4 == 0) {
#pragma unroll
    for (int i = 0; i < S2 / 4; ++i)
      reinterpret_cast<float4*>(a)[i] =
          make_float4(x.v[4 * i], x.v[4 * i + 1], x.v[4 * i + 2], x.v[4 * i + 3]);
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < S2 / 2; ++i)
      reinterpret_cast<float2*>(a)[i] = make_float2(x.v[2 * i], x.v[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < S2 / 2; ++i)
      reinterpret_cast<double2*>(a)[i] = make_double2(x.v[2 * i], x.v[2 * i + 1]);
  }
}

constexpr int kGridFactorThreads = 128;

// The lane-group body.  scratch: 7 x (B C, S2, S2)
template <typename T, int S2, bool kFused>
__global__ void __launch_bounds__(kGridFactorThreads)
    pcr_factor_grid_kernel(const T* __restrict__ Lred, const T* __restrict__ Ured,
                           T* __restrict__ alphas, T* __restrict__ betas, T* __restrict__ Dinv,
                           T* __restrict__ scratch, int C, int B, int cyclic, int nlev) {
  using Row = tf::Row<T, S2>;
  constexpr int G = 32 / S2, SS = S2 * S2;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the grid's pairs [0, p1), its warps and this warp's place among them
  const long p1 = (long)B * C;
  const int nwarps = gridDim.x * warps, wg = blockIdx.x * warps + warp;
  cg::grid_group grid = cg::this_grid();
  const long nbc = (long)B * C, sz = nbc * SS, blk = (long)SS * C, ops = (long)nlev * blk;
  T* Lb[2] = {scratch, scratch + 3 * sz};
  T* Db[2] = {scratch + sz, scratch + 4 * sz};
  T* Ub[2] = {scratch + 2 * sz, scratch + 5 * sz};
  T* Dt = scratch + 6 * sz;
  // the inputs into the chunk-major state, read along the chunks; D = I
  {
    const long t0 = (long)wg * 32 + lane, tstride = (long)nwarps * 32;
    for (long e = t0; e < p1 * SS; e += tstride) {
      const long b = e / blk, w = (e - b * blk) / C, c = e - b * blk - w * C;
      const long at = ((b * C + c) * SS) + w;
      Lb[0][at] = Lred[e];
      Ub[0][at] = Ured[e];
      Db[0][at] = w / S2 == w % S2 ? T(1) : T(0);
    }
  }
  grid.sync();
  const int grp = tf::group_of_lane<S2>(lane);
  const tf::Group g{grp * S2, lane - grp * S2};
  const int r = g.r;
  // each group's block for its products (and one for the lanes past them)
  constexpr int GB = tf::group_block<T, S2>();
  __shared__ __align__(16) T mmbuf[kGridFactorThreads / 32 * (G + 1) * GB];
  T* const mb = mmbuf + (warp * (G + 1) + grp) * GB;
  auto mm = [&](const Row& a, const Row& b) { return tf::mm_shared<T, S2>(a, b, g, mb); };
  // one pass of the warp's groups over its pairs: fn(q, b, c, store)
  auto passes = [&](auto&& fn) {
    for (long base = (long)wg * G; base < p1; base += (long)nwarps * G) {
      const bool store = grp < G && base + grp < p1;
      const long q = store ? base + grp : p1 - 1;
      const long b = q / C;
      fn(q, b, (int)(q - b * C), store);
    }
  };
  int cur = 0, lev = 0;
  for (int d = 1; d < C; d *= 2, ++lev) {
    if constexpr (!kFused) {
      passes([&](long q, long, int, bool store) {
        const Row di = tf::inv(ld_row<T, S2>(Db[cur], q, r), g);
        if (store) st_row<T, S2>(Dt, q, r, di);
      });
      grid.sync();
    }
    const int nxt = cur ^ 1;
    passes([&](long q, long b, int c, bool store) {
      const long qb = q - c;
      const long qm = qb + (c < d ? c - d + C : c - d), qp = qb + (c + d >= C ? c + d - C : c + d);
      // the neighbours' inverses: Dt's, or (fused) inverted here
      auto dinv = [&](long qn) {
        if constexpr (kFused) return tf::inv(ld_row<T, S2>(Db[cur], qn, r), g);
        return ld_row<T, S2>(Dt, qn, r);
      };
      // alpha's terms first, then beta's: fewer rows live at once
      Row alpha = tf::neg(mm(ld_row<T, S2>(Lb[cur], q, r), dinv(qm)));
      if (!cyclic && c < d) alpha = tf::zero_row<T, S2>();
      const Row Lnew = mm(alpha, ld_row<T, S2>(Lb[cur], qm, r));
      const Row Dpart = tf::add(ld_row<T, S2>(Db[cur], q, r),
                                mm(alpha, ld_row<T, S2>(Ub[cur], qm, r)));
      if (store) {
        tf::store_row(alphas + b * ops, lev, r, c, C, alpha);
        st_row<T, S2>(Lb[nxt], q, r, Lnew);
      }
      Row beta = tf::neg(mm(ld_row<T, S2>(Ub[cur], q, r), dinv(qp)));
      if (!cyclic && c >= C - d) beta = tf::zero_row<T, S2>();
      const Row Unew = mm(beta, ld_row<T, S2>(Ub[cur], qp, r));
      const Row D = tf::add(Dpart, mm(beta, ld_row<T, S2>(Lb[cur], qp, r)));
      if (store) {
        tf::store_row(betas + b * ops, lev, r, c, C, beta);
        st_row<T, S2>(Ub[nxt], q, r, Unew);
        st_row<T, S2>(Db[nxt], q, r, D);
      }
    });
    grid.sync();
    cur = nxt;
  }
  passes([&](long q, long b, int c, bool store) {
    Row D = ld_row<T, S2>(Db[cur], q, r);
    if (cyclic)
      D = tf::add(D, tf::add(ld_row<T, S2>(Lb[cur], q, r), ld_row<T, S2>(Ub[cur], q, r)));
    const Row di = tf::inv(D, g);
    if (store) tf::store_row(Dinv + b * blk, 0, r, c, C, di);
  });
}

#ifndef TF_WIDE
// block of pair q of a chunk-minor array over the P = B C pairs, entry
// (i, k) at (i S2 + k) P + q, through L2
template <typename T, int S2>
__device__ __forceinline__ tf::Blk<T, S2> ld_blk_cg(const T* p, long q, long P) {
  tf::Blk<T, S2> a;
#pragma unroll
  for (int i = 0; i < S2; ++i)
#pragma unroll
    for (int k = 0; k < S2; ++k) a.v[i][k] = ld_cg(p + (i * S2 + k) * P + q);
  return a;
}

// The thread-per-pair body (S2 = 2, fused levels).  scratch: 6 x (S2, S2, B C)
template <typename T, int S2>
__global__ void __launch_bounds__(kGridFactorThreads)
    pcr_factor_thread_kernel(const T* __restrict__ Lred, const T* __restrict__ Ured,
                             T* __restrict__ alphas, T* __restrict__ betas,
                             T* __restrict__ Dinv, T* __restrict__ scratch, int C, int B,
                             int cyclic, int nlev) {
  constexpr int SS = S2 * S2;
  cg::grid_group grid = cg::this_grid();
  const long P = (long)B * C, sz = P * SS, blk = (long)SS * C, ops = (long)nlev * blk;
  const long t0 = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long tstride = (long)gridDim.x * blockDim.x;
  T* Lb[2] = {scratch, scratch + 3 * sz};
  T* Db[2] = {scratch + sz, scratch + 4 * sz};
  T* Ub[2] = {scratch + 2 * sz, scratch + 5 * sz};
  for (long q = t0; q < P; q += tstride) {
    const long b = q / C, c = q - b * C;
#pragma unroll
    for (int e = 0; e < SS; ++e) {
      Lb[0][e * P + q] = Lred[b * blk + e * C + c];
      Ub[0][e * P + q] = Ured[b * blk + e * C + c];
      Db[0][e * P + q] = e / S2 == e % S2 ? T(1) : T(0);
    }
  }
  grid.sync();
  int cur = 0, lev = 0;
  for (int d = 1; d < C; d *= 2, ++lev) {
    const int nxt = cur ^ 1;
    for (long q = t0; q < P; q += tstride) {
      const long b = q / C;
      const int c = (int)(q - b * C);
      const long qb = q - c;
      const long qm = qb + (c < d ? c - d + C : c - d), qp = qb + (c + d >= C ? c + d - C : c + d);
      tf::Blk<T, S2> alpha =
          tf::neg(tf::mm(ld_blk_cg<T, S2>(Lb[cur], q, P), tf::inv(ld_blk_cg<T, S2>(Db[cur], qm, P))));
      tf::Blk<T, S2> beta =
          tf::neg(tf::mm(ld_blk_cg<T, S2>(Ub[cur], q, P), tf::inv(ld_blk_cg<T, S2>(Db[cur], qp, P))));
      if (!cyclic && c < d) tf::zero(alpha);
      if (!cyclic && c >= C - d) tf::zero(beta);
      const tf::Blk<T, S2> D =
          tf::add(tf::add(ld_blk_cg<T, S2>(Db[cur], q, P), tf::mm(alpha, ld_blk_cg<T, S2>(Ub[cur], qm, P))),
                  tf::mm(beta, ld_blk_cg<T, S2>(Lb[cur], qp, P)));
      tf::store_blk(Db[nxt], 0, (int)q, (int)P, D);
      tf::store_blk(Lb[nxt], 0, (int)q, (int)P, tf::mm(alpha, ld_blk_cg<T, S2>(Lb[cur], qm, P)));
      tf::store_blk(Ub[nxt], 0, (int)q, (int)P, tf::mm(beta, ld_blk_cg<T, S2>(Ub[cur], qp, P)));
      tf::store_blk(alphas + b * ops, lev, c, C, alpha);
      tf::store_blk(betas + b * ops, lev, c, C, beta);
    }
    grid.sync();
    cur = nxt;
  }
  for (long q = t0; q < P; q += tstride) {
    const long b = q / C;
    const int c = (int)(q - b * C);
    tf::Blk<T, S2> D = ld_blk_cg<T, S2>(Db[cur], q, P);
    if (cyclic) D = tf::add(D, tf::add(ld_blk_cg<T, S2>(Lb[cur], q, P), ld_blk_cg<T, S2>(Ub[cur], q, P)));
    tf::store_blk(Dinv + b * blk, 0, c, C, tf::inv(D));
  }
}
#endif

// A member's C chunks all on this thread block (pcr.cuh's bodies)
__device__ __forceinline__ tf::Local one_block(int C) { return tf::Local{1, 0, C, C, 0, C}; }

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
  tf::pcr_factor_cluster<T, S2>(Lred + b * blk, Ured + b * blk, alphas + b * ops,
                                betas + b * ops, Dinv + b * blk, scratch + b * 7 * blk,
                                one_block(C), cyclic);
}

template <typename T, int S2, bool kMembers>
__global__ void __launch_bounds__(kThreads)
    pcr_solve_kernel(const T* __restrict__ alphas, const T* __restrict__ betas,
                     const T* __restrict__ Dinv, const T* __restrict__ b,
                     const T* __restrict__ Lred, const T* __restrict__ Ured, T* out, T* cap_inv,
                     T* scratch, int C, int R) {
  // woodbury_cluster inverts the capacitance with one thread per entry of
  // [cap | I]: every instantiated S2 needs 2 S2^2 <= kThreads (512 at 16)
  static_assert(2 * S2 * S2 <= kThreads, "the Woodbury set-up needs 2 S2^2 threads");
  const tf::Local sp = one_block(C);
  if constexpr (kMembers) {
    const long m = blockIdx.x, blk = (long)S2 * S2 * C, ops = levels(C) * blk;
    const long col = (long)S2 * C, cols = R * col;
    if (b) {
      tf::pcr_solve_cols_cluster<T, S2>(
          alphas + m * ops, betas + m * ops, Dinv + m * blk,
          [&](int r, int row, int c) { return b[m * cols + r * col + (long)row * C + c]; },
          out + m * cols, scratch + m * 2 * cols, sp, R);
    } else {
      tf::woodbury_cluster<T, S2>(alphas + m * ops, betas + m * ops, Dinv + m * blk,
                                  Lred + m * blk, Ured + m * blk, out + m * blk,
                                  cap_inv + m * S2 * S2, scratch + m * 2 * cols, sp);
    }
  } else {
    // one grid: the body without member offsets, as it was before them (the
    // same source with offsets that fold to zero compiled 35 % slower on
    // H100 for the Woodbury set-up, with as many instructions; PERF.md)
    if (b) {
      const long col = (long)S2 * C;
      tf::pcr_solve_cols_cluster<T, S2>(
          alphas, betas, Dinv, [&](int r, int row, int c) { return b[r * col + (long)row * C + c]; },
          out, scratch, sp, R);
    } else {
      tf::woodbury_cluster<T, S2>(alphas, betas, Dinv, Lred, Ured, out, cap_inv, scratch, sp);
    }
  }
}

// The cluster barrier in two halves: arrive (release) when a CTA's share
// of a phase is written, wait (acquire) before reading other CTAs' shares,
// so that the work between them (the next level's operators, addresses)
// hides the barrier's latency.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// What a cluster solve (cluster_solve) solves and writes: the
// per-stage right-hand side yred with its neighbour shifts (kShifts; with
// the Woodbury correction first, kShiftsWood), or whole solution columns
// (kColumns) of given right-hand sides b, or (b null) of the Woodbury
// closure's columns read off Lred / Ured
enum ClusterMode { kShifts = 0, kShiftsWood = 1, kColumns = 2 };

// The PCR solve over a thread-block cluster of K CTAs per right-hand side
// (clusters run along x: cluster blockIdx.x / K, CTA rank blockIdx.x % K).
// With shifts the cluster's right-hand side is member m's yred; solving
// columns, cluster m takes column j = m % R of member m / R, whose level
// operators it reads (so the R columns of a member, and the members, run
// at once over the card).  CTA k owns chunks [k Cc, k Cc + Cc) and holds
// their S2-vectors, both level buffers, in its shared memory (state (2,
// S2, Cc)); a level reads the neighbours c -+ d from whichever CTA owns
// them, through distributed shared memory (level 0 from the right-hand
// side itself), and one cluster barrier separates the levels (Cc a power
// of two: a chunk's owner and place are a shift and a mask).  Thread (r,
// cl) of a tile of Ct chunks (r = tid / Ct < S2) computes row r of chunk
// cl, the same products and sums in the same order as pcr.cuh's
// pcr_solve_shift_cluster and pcr_solve_cols_cluster.  The level operators
// (and Dinv after them) stream through a ring of D slabs, each one
// level's row r of both operators for the thread's chunks of a tile,
// which the thread copies itself with cp.async D - 1 slabs ahead (all of
// them, where they fit): they do not depend on the right-hand side, and no
// thread waits on another's copies.
template <typename T, int S2, int kMode>
__device__ __forceinline__ void cluster_solve(const T* __restrict__ alphas,
                                              const T* __restrict__ betas,
                                              const T* __restrict__ Dinv,
                                              const T* __restrict__ yred,
                                              const T* __restrict__ Z,
                                              const T* __restrict__ cap_inv,
                                              const T* __restrict__ Lred,
                                              const T* __restrict__ Ured, T* xm1, T* xp1,
                                              T* out, int C, int wrap, int nlev, int Cc,
                                              int Ct, int D, int R) {
  constexpr int S = S2 / 2, SS2 = S2 * S2;
  constexpr bool kWood = kMode == kShiftsWood, kCols = kMode == kColumns;
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), k = (int)cluster.block_rank();
  // the cluster's right-hand side m, its member mb and (columns) column j
  const long m = blockIdx.x / K, mb = kCols ? m / R : m;
  const int j = kCols ? (int)(m - mb * R) : 0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* state = reinterpret_cast<T*>(smem_raw);  // (2, S2, Cc)
  T* ring = state + 2 * S2 * Cc;              // (D, 2 SS2, Ct)
  const long blk = (long)SS2 * C, col = (long)S2 * C;
  alphas += mb * nlev * blk;
  betas += mb * nlev * blk;
  Dinv += mb * blk;
  if (!kCols || yred) {
    yred += m * col;
  } else {
    Lred += mb * blk;
    Ured += mb * blk;
  }
  if constexpr (kWood) {
    Z += m * blk;
    cap_inv += m * SS2;
  }
  if constexpr (kCols) {
    out += m * col;
  } else {
    xm1 += m * S * C;
    xp1 += m * S * C;
  }
  // entry q of the right-hand side at chunk cc: yred (or b), or (columns,
  // b null) column j of the closure, e_0 (x) Lred[:, S+j, 0] (j < S) or
  // e_{C-1} (x) Ured[:, j-S, C-1]
  auto rhs = [&](int q, int cc) -> T {
    if constexpr (kCols) {
      if (!yred) {
        if (j < S) return cc == 0 ? Lred[((long)q * S2 + S + j) * C] : T(0);
        return cc == C - 1 ? Ured[((long)q * S2 + j - S) * C + C - 1] : T(0);
      }
    }
    return yred[(long)q * C + cc];
  };
  const int c0 = k * Cc, nc = min(Cc, C - c0), tiles = (nc + Ct - 1) / Ct;
  const int tid = threadIdx.x, cl = tid % Ct, r = tid / Ct, lg = __ffs(Cc) - 1;
  const bool lane = r < S2;
  const int slabs = (nlev + 1) * tiles;
  // slab i = lev tiles + t: row r of level lev's operators (Dinv at nlev)
  // for chunk cl of tile t, entries (r, q) at st[(r S2 + q) Ct + cl] (alpha,
  // Dinv) and st[(SS2 + r S2 + q) Ct + cl] (beta); issued in order, the
  // next one (ilev, it) counted along
  int inext = 0, ilev = 0, it = 0;
  auto issue = [&]() {
    if (inext < slabs && lane && cl < min(Ct, nc - it * Ct)) {
      T* st = ring + (inext % D) * 2 * SS2 * Ct + r * S2 * Ct + cl;
      const long at = (long)r * S2 * C + c0 + it * Ct + cl;
      if (ilev < nlev) {
        const T* al = alphas + ilev * blk + at;
        const T* be = betas + ilev * blk + at;
#pragma unroll
        for (int q = 0; q < S2; ++q) {
          tf::cp_async(st + q * Ct, al + (long)q * C);
          tf::cp_async(st + (SS2 + q) * Ct, be + (long)q * C);
        }
      } else {
#pragma unroll
        for (int q = 0; q < S2; ++q) tf::cp_async(st + q * Ct, Dinv + at + (long)q * C);
      }
    }
    tf::cp_async_commit();
    ++inext;
    if (++it == tiles) {
      it = 0;
      ++ilev;
    }
  };
  for (int i = 0; i < D; ++i) issue();
  // the owner of chunk cc's entries in a buffer of the cluster (Cc is a
  // power of two)
  auto at = [&](const T* buf, int cc) -> const T* {
    const int owner = cc >> lg;
    return (owner == k ? buf : cluster.map_shared_rank(buf, owner)) + (cc & (Cc - 1));
  };
  if constexpr (kCols) {
    // columns: the right-hand side into the first level buffer, so that
    // level 0 reads it as every later level reads its input (the products
    // of its loads, read under the branches of rhs, were rounded apart
    // from their sums where the one-block body fuses them)
    if (nlev > 0) {
      if (lane)
        for (int lc = cl; lc < nc; lc += Ct) state[r * Cc + lc] = rhs(r, c0 + lc);
      cluster_arrive();
    }
  }
  int cur = 0;
  for (int lev = 0; lev <= nlev; ++lev) {
    T* src = state + cur * S2 * Cc;
    T* dst = state + (cur ^ 1) * S2 * Cc;
    for (int t = 0; t < tiles; ++t) {
      const int i = lev * tiles + t, lc = t * Ct + cl, c = c0 + lc;
      cp_async_wait_upto(D - 1);
      const T* a = ring + (i % D) * 2 * SS2 * Ct + r * S2 * Ct + cl;
      const bool mine = lane && lc < nc;
      if (nlev == 0) {
        // C = 1: no level, Dinv applies to the right-hand side itself
        if (mine) src[r * Cc + lc] = rhs(r, c);
        __syncthreads();
      }
      if (!kCols && lev == 0 && nlev > 0) {
        // level 0 reads the right-hand side itself, neighbours too
        if (mine) {
          const int cm = c == 0 ? C - 1 : c - 1, cp = c == C - 1 ? 0 : c + 1;
          T ta = a[0] * rhs(0, cm);
#pragma unroll
          for (int q = 1; q < S2; ++q) ta += a[q * Ct] * rhs(q, cm);
          T tb = a[SS2 * Ct] * rhs(0, cp);
#pragma unroll
          for (int q = 1; q < S2; ++q) tb += a[(SS2 + q) * Ct] * rhs(q, cp);
          dst[r * Cc + lc] = rhs(r, c) + ta + tb;
        }
      } else if (lev < nlev) {
        const int d = 1 << lev, cm = c - d, cp = c + d;
        const T* bm = mine ? at(src, cm < 0 ? cm + C : cm) : src;
        const T* bp = mine ? at(src, cp >= C ? cp - C : cp) : src;
        if (t == 0) cluster_wait();  // level lev - 1 is in every CTA
        if (mine) {
          T ta = a[0] * bm[0];
#pragma unroll
          for (int q = 1; q < S2; ++q) ta += a[q * Ct] * bm[q * Cc];
          T tb = a[SS2 * Ct] * bp[0];
#pragma unroll
          for (int q = 1; q < S2; ++q) tb += a[(SS2 + q) * Ct] * bp[q * Cc];
          dst[r * Cc + lc] = src[r * Cc + lc] + ta + tb;
        }
      } else {
        if (t == 0 && nlev > 0) cluster_wait();
        if (mine) {
          T z = a[0] * src[lc];
#pragma unroll
          for (int q = 1; q < S2; ++q) z += a[q * Ct] * src[q * Cc + lc];
          // a column is written where it is solved; shifts read neighbours
          if constexpr (kCols)
            out[(long)r * C + c] = z;
          else
            dst[r * Cc + lc] = z;
        }
      }
      issue();
    }
    // this CTA's share of the level is written
    cluster_arrive();
    cur ^= 1;
  }
  tf::cp_async_wait<0>();
  cluster_wait();  // the solution z is in every CTA
  if constexpr (!kCols) {
    const T* z = state + cur * S2 * Cc;
    __shared__ T s_vt[S2], s_coef[S2];
    if constexpr (kWood) {
      // coef = cap_inv V^T z, V^T reading the ring's two end chunks
      if (tid < S2) s_vt[tid] = tid < S ? at(z, C - 1)[(S + tid) * Cc] : at(z, 0)[(tid - S) * Cc];
      __syncthreads();
      if (tid < S2) {
        T acc = cap_inv[tid * S2] * s_vt[0];
#pragma unroll
        for (int i = 1; i < S2; ++i) acc += cap_inv[tid * S2 + i] * s_vt[i];
        s_coef[tid] = acc;
      }
      __syncthreads();
    }
    // entry `row` of chunk cc's solution: z, less the Woodbury correction
    // sum_j coef_j Z_j on a Woodbury plan
    auto y = [&](int row, int cc) -> T {
      const T zv = at(z, cc)[row * Cc];
      if constexpr (kWood) {
        T corr = s_coef[0] * Z[(long)row * C + cc];
#pragma unroll
        for (int jj = 1; jj < S2; ++jj) corr += s_coef[jj] * Z[((long)jj * S2 + row) * C + cc];
        return zv - corr;
      }
      return zv;
    };
    // xm1[:, c] = bottom of chunk c-1, xp1[:, c] = top of chunk c+1: around
    // the ring with wrap (always on a Woodbury plan), zero past the ends
    // without
    if (r < S) {
      for (int lc = cl; lc < nc; lc += Ct) {
        const int c = c0 + lc, cm = c == 0 ? C - 1 : c - 1, cp = c == C - 1 ? 0 : c + 1;
        const bool has_m = kWood || wrap || c != 0, has_p = kWood || wrap || c != C - 1;
        xm1[(long)r * C + c] = has_m ? y(S + r, cm) : T(0);
        xp1[(long)r * C + c] = has_p ? y(r, cp) : T(0);
      }
    }
    // no CTA leaves while another may still read its shared memory
    cluster_arrive();
    cluster_wait();
  }
}

// The kernels of the cluster solve: with shifts (the per-stage solve) and
// of whole columns (the R-column solve and the Woodbury set-up), apart so
// that a trace tells them apart
#define TF_CLUSTER_PARAMS                                                              \
  const T *__restrict__ alphas, const T *__restrict__ betas, const T *__restrict__ Dinv, \
      const T *__restrict__ yred, const T *__restrict__ Z, const T *__restrict__ cap_inv, \
      const T *__restrict__ Lred, const T *__restrict__ Ured, T *xm1, T *xp1, T *out,     \
      int C, int wrap, int nlev, int Cc, int Ct, int D, int R
#define TF_CLUSTER_ARGS \
  alphas, betas, Dinv, yred, Z, cap_inv, Lred, Ured, xm1, xp1, out, C, wrap, nlev, Cc, Ct, D, R

template <typename T, int S2, bool kWood>
__global__ void __launch_bounds__(kSolveThreads)
    pcr_solve_shift_cluster_kernel(TF_CLUSTER_PARAMS) {
  cluster_solve<T, S2, kWood ? kShiftsWood : kShifts>(TF_CLUSTER_ARGS);
}

template <typename T, int S2>
__global__ void __launch_bounds__(kSolveThreads) pcr_solve_cols_cluster_kernel(TF_CLUSTER_PARAMS) {
  cluster_solve<T, S2, kColumns>(TF_CLUSTER_ARGS);
}
#undef TF_CLUSTER_PARAMS
#undef TF_CLUSTER_ARGS

// The kernel of the cluster solve of mode kMode
template <typename T, int S2, int kMode>
auto cluster_kernel() {
  if constexpr (kMode == kColumns)
    return pcr_solve_cols_cluster_kernel<T, S2>;
  else
    return pcr_solve_shift_cluster_kernel<T, S2, kMode == kShiftsWood>;
}

// The capacitance of the Woodbury closure of each member (pcr.cuh:
// woodbury_cap_block, the Gauss-Jordan of woodbury_cluster), one block
// of 2 S2^2 threads (rounded up to a warp) per member, after the cluster
// solve of its columns Z
template <typename T, int S2>
__global__ void __launch_bounds__(kThreads)
    woodbury_cap_kernel(const T* __restrict__ Z, T* __restrict__ cap_inv, int C) {
  const long m = blockIdx.x;
  tf::woodbury_cap_block<T, S2>(Z + m * S2 * S2 * C, cap_inv + m * S2 * S2, C);
}

// The grid factor's kernel at S2: the thread-per-pair body at S2 = 2, the
// lane groups otherwise (fused at the narrow S2 but 6)
template <typename T, int S2>
auto grid_factor_kernel() {
#ifdef TF_WIDE
  return pcr_factor_grid_kernel<T, S2, false>;
#else
  if constexpr (S2 == 2)
    return pcr_factor_thread_kernel<T, S2>;
  else
    return pcr_factor_grid_kernel<T, S2, S2 != 6>;
#endif
}

// One launch of the grid factor over a cooperative grid of `ctas` CTAs (at
// most what the card holds at once, factor_grid_blocks)
template <typename T, int S2>
int launch_factor_grid(const T* Lred, const T* Ured, T* alphas, T* betas, T* Dinv, T* scratch,
                       int C, int cyclic, int B, int ctas, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3(kGridFactorThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int nlev = 0;
  for (int d = 1; d < C; d *= 2) ++nlev;
  cudaError_t err = cudaLaunchKernelEx(&cfg, grid_factor_kernel<T, S2>(), Lred, Ured,
                                       alphas, betas, Dinv, scratch, C, B, cyclic, nlev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int factor_grid(const T* Lred, const T* Ured, T* alphas, T* betas, T* Dinv, T* scratch, int C,
                int S2, int cyclic, int B, int ctas, cudaStream_t stream) {
  if (B < 1 || C < 1 || ctas < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (S2) {
#define TF_CASE(S2)                                                                        \
  case S2:                                                                                 \
    return launch_factor_grid<T, S2>(Lred, Ured, alphas, betas, Dinv, scratch, C, cyclic,  \
                                     B, ctas, stream);
    TF_CASES
#undef TF_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// CTAs of the cooperative grid factor one SM holds at once (0: none), or
// minus a CUDA error
template <typename T>
int factor_grid_blocks(int S2) {
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (S2) {
#define TF_CASE(S2)                                                                             \
  case S2:                                                                                      \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                                        \
        &n, grid_factor_kernel<T, S2>(), kGridFactorThreads, 0);                                \
    break;
    TF_CASES
#undef TF_CASE
    default:
      break;
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

#ifndef TF_WIDE
// The one-block-per-member factor (pcr_factor_kernel), kept for plans of
// few chunks (ops/pcr.py:factor_route)
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
#endif

// The one-block-per-member R-column solve (pcr_solve_kernel): b (B, R, S2,
// C) -> out; or, b null, the Woodbury set-up (R = S2): out = Z, and cap_inv
template <typename T>
int solve_members(const T* alphas, const T* betas, const T* Dinv, const T* b, const T* Lred,
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

// Shared memory of a cluster solve plan, in bytes (ops/pcr.py:solve_smem
// computes the same): the state's two level buffers and the operator ring
// of D slabs.
long solve_smem(int S2, int item, int Cc, int Ct, int D) {
  return (long)item * (2L * S2 * Cc + (long)D * 2 * S2 * S2 * Ct);
}

// Set what a launch of the cluster solve kernel<T, S2, kMode> with dynamic
// shared memory `bytes` and clusters of K CTAs needs.  Each setting is a
// driver call, so it is made once per kernel and device, and the shared
// memory opted in only ever grows (a smaller setting would refuse a larger
// plan launched before): `set` is the kernel's record, per device, of the
// largest size opted in (set[0]) and of the non-portable cluster size
// allowed (set[1]), for launches and occupancy queries alike.
template <typename T, int S2, int kMode>
cudaError_t prepare(long bytes, int K) {
  static long set[2][kMaxDevices] = {};
  auto fn = cluster_kernel<T, S2, kMode>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= kMaxDevices) return err ? err : cudaErrorInvalidDevice;
  // above 48 KB with the kernel's static shared memory: opt in
  if (bytes > 40 * 1024 && bytes > set[0][dev]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess) set[0][dev] = bytes;
  }
  if (err == cudaSuccess && K > 8 && !set[1][dev]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) set[1][dev] = 1;
  }
  return err;
}

cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int n, int K, int threads,
                                  long bytes, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n * K);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The pointers and sizes of one cluster solve (cluster_solve's)
template <typename T>
struct ClusterArgs {
  const T *alphas, *betas, *Dinv, *yred, *Z, *cap_inv, *Lred, *Ured;
  T *xm1, *xp1, *out;
  int C, wrap, R;
};

// One launch of n clusters of K CTAs of Cc chunks each, a power of two
// (the last may hold fewer, none holds none), tiles of Ct chunks, a ring
// of D slabs, `threads` >= S2 Ct threads (ops/pcr.py:solve_plan)
template <typename T, int S2, int kMode>
int launch_cluster(const ClusterArgs<T>& a, int n, int K, int Cc, int Ct, int D, int threads,
                   cudaStream_t stream) {
  auto fn = cluster_kernel<T, S2, kMode>();
  const long bytes = solve_smem(S2, sizeof(T), Cc, Ct, D);
  cudaError_t err = prepare<T, S2, kMode>(bytes, K);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(attr, n, K, threads, bytes, stream);
  int nlev = 0;
  for (int d = 1; d < a.C; d *= 2) ++nlev;
  err = cudaLaunchKernelEx(&cfg, fn, a.alphas, a.betas, a.Dinv, a.yred, a.Z, a.cap_inv, a.Lred,
                           a.Ured, a.xm1, a.xp1, a.out, a.C, a.wrap, nlev, Cc, Ct, D, a.R);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool bad_plan(int n, int C, int S2, int K, int Cc, int Ct, int D, int threads) {
  return n < 1 || C < 1 || K < 1 || K > kMaxCluster || Cc < 1 || (long)K * Cc < C ||
         (long)(K - 1) * Cc >= C || (Cc & (Cc - 1)) || Ct < 1 || Ct > Cc || D < 1 ||
         threads < S2 * Ct || threads > kSolveThreads || threads % 32;
}

// The solve with shifts of B members' yred; Z and cap_inv null: no
// Woodbury correction
template <typename T>
int solve_shift(const ClusterArgs<T>& a, int S2, int B, int K, int Cc, int Ct, int D,
                int threads, cudaStream_t stream) {
  if (bad_plan(B, a.C, S2, K, Cc, Ct, D, threads) || (a.Z && (!a.cap_inv || !a.wrap)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (S2) {
#define TF_CASE(S2)                                                                     \
  case S2:                                                                              \
    return a.Z ? launch_cluster<T, S2, kShiftsWood>(a, B, K, Cc, Ct, D, threads, stream) \
               : launch_cluster<T, S2, kShifts>(a, B, K, Cc, Ct, D, threads, stream);
    TF_CASES
#undef TF_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The R-column solve of B members, one cluster per (member, column): b (B,
// R, S2, C) -> out; or, b null, the Woodbury set-up (R = S2): out = Z, then
// cap_inv (woodbury_cap_kernel, one block per member)
template <typename T>
int solve_cols(const ClusterArgs<T>& a, int S2, int B, int K, int Cc, int Ct, int D,
               int threads, cudaStream_t stream) {
  if (bad_plan(B * a.R, a.C, S2, K, Cc, Ct, D, threads) || a.R < 1 ||
      (!a.yred && (a.R != S2 || !a.Lred || !a.Ured || !a.cap_inv || a.C < 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cap_threads = (2 * S2 * S2 + 31) / 32 * 32;
  int err = static_cast<int>(cudaErrorInvalidValue);
  switch (S2) {
#define TF_CASE(S2)                                                                     \
  case S2:                                                                              \
    err = launch_cluster<T, S2, kColumns>(a, B * a.R, K, Cc, Ct, D, threads, stream);    \
    if (err || a.yred) return err;                                                      \
    woodbury_cap_kernel<T, S2><<<B, cap_threads, 0, stream>>>(a.out, const_cast<T*>(a.cap_inv), \
                                                                a.C);                   \
    break;
    TF_CASES
#undef TF_CASE
    default:
      return err;
  }
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of the plan's shape the card holds at once
// (cudaOccupancyMaxActiveClusters; 0: it cannot run), or minus a CUDA
// error.
template <typename T, int S2, int kMode>
int clusters_of(int K, int Cc, int Ct, int D, int threads) {
  auto fn = cluster_kernel<T, S2, kMode>();
  const long bytes = solve_smem(S2, sizeof(T), Cc, Ct, D);
  cudaError_t err = prepare<T, S2, kMode>(bytes, K);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(attr, 1, K, threads, bytes, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <typename T>
int max_clusters(int S2, int mode, int K, int Cc, int Ct, int D, int threads) {
  if (K < 1 || K > kMaxCluster || mode < kShifts || mode > kColumns)
    return -static_cast<int>(cudaErrorInvalidValue);
  switch (S2) {
#define TF_CASE(S2)                                                                      \
  case S2:                                                                               \
    return mode == kShifts       ? clusters_of<T, S2, kShifts>(K, Cc, Ct, D, threads)     \
           : mode == kShiftsWood ? clusters_of<T, S2, kShiftsWood>(K, Cc, Ct, D, threads) \
                                 : clusters_of<T, S2, kColumns>(K, Cc, Ct, D, threads);
    TF_CASES
#undef TF_CASE
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// the grid factor: tf_pcr_factor_wide_* in the wide library,
// tf_pcr_factor_grid_* (and the one-block tf_pcr_factor_*) in the narrow one
#define TF_GRID_ENTRIES(NAME, SUFFIX, T)                                                     \
  extern "C" int tf_pcr_factor_##NAME##_##SUFFIX(const void* Lred, const void* Ured,         \
                                                 void* alphas, void* betas, void* Dinv,      \
                                                 void* scratch, int C, int S2, int cyclic,   \
                                                 int B, int ctas, void* stream) {            \
    return factor_grid<T>(static_cast<const T*>(Lred), static_cast<const T*>(Ured),          \
                          static_cast<T*>(alphas), static_cast<T*>(betas),                   \
                          static_cast<T*>(Dinv), static_cast<T*>(scratch), C, S2, cyclic,    \
                          B, ctas, static_cast<cudaStream_t>(stream));                       \
  }                                                                                          \
  extern "C" int tf_pcr_factor_##NAME##_blocks_##SUFFIX(int S2) {                            \
    return factor_grid_blocks<T>(S2);                                                        \
  }
#ifdef TF_WIDE
#define TF_FACTOR_ENTRIES(SUFFIX, T) TF_GRID_ENTRIES(wide, SUFFIX, T)
#else
#define TF_FACTOR_ENTRIES(SUFFIX, T)                                                      \
  TF_GRID_ENTRIES(grid, SUFFIX, T)                                                        \
  extern "C" int tf_pcr_factor_##SUFFIX(const void* Lred, const void* Ured, void* alphas, \
                                        void* betas, void* Dinv, void* scratch, int C,    \
                                        int S2, int cyclic, int B, void* stream) {        \
    return factor<T>(static_cast<const T*>(Lred), static_cast<const T*>(Ured),            \
                     static_cast<T*>(alphas), static_cast<T*>(betas),                     \
                     static_cast<T*>(Dinv), static_cast<T*>(scratch), C, S2, cyclic, B,   \
                     static_cast<cudaStream_t>(stream));                                  \
  }
#endif

#define TF_ENTRIES(SUFFIX, T)                                                              \
  TF_FACTOR_ENTRIES(SUFFIX, T)                                                            \
  extern "C" int tf_pcr_solve_members_##SUFFIX(                                           \
      const void* alphas, const void* betas, const void* Dinv, const void* b,             \
      const void* Lred, const void* Ured, void* out, void* cap_inv, void* scratch, int C, \
      int S2, int R, int B, void* stream) {                                               \
    return solve_members<T>(static_cast<const T*>(alphas), static_cast<const T*>(betas),  \
                            static_cast<const T*>(Dinv), static_cast<const T*>(b),        \
                            static_cast<const T*>(Lred), static_cast<const T*>(Ured),     \
                            static_cast<T*>(out), static_cast<T*>(cap_inv),               \
                            static_cast<T*>(scratch), C, S2, R, B,                        \
                            static_cast<cudaStream_t>(stream));                           \
  }                                                                                       \
  extern "C" int tf_pcr_solve_##SUFFIX(const void* alphas, const void* betas,             \
                                       const void* Dinv, const void* b, const void* Lred, \
                                       const void* Ured, void* out, void* cap_inv, int C, \
                                       int S2, int R, int B, int K, int Cc, int Ct, int D, \
                                       int threads, void* stream) {                       \
    const ClusterArgs<T> a = {static_cast<const T*>(alphas), static_cast<const T*>(betas), \
                              static_cast<const T*>(Dinv),   static_cast<const T*>(b),     \
                              nullptr,                       static_cast<const T*>(cap_inv), \
                              static_cast<const T*>(Lred),   static_cast<const T*>(Ured),  \
                              nullptr,                       nullptr,                      \
                              static_cast<T*>(out),          C,                            \
                              1,                             R};                           \
    return solve_cols<T>(a, S2, B, K, Cc, Ct, D, threads, static_cast<cudaStream_t>(stream)); \
  }                                                                                       \
  extern "C" int tf_pcr_solve_shift_##SUFFIX(const void* alphas, const void* betas,       \
                                             const void* Dinv, const void* yred,          \
                                             const void* Z, const void* cap_inv,          \
                                             void* xm1, void* xp1, int C, int S2,         \
                                             int wrap, int B, int K, int Cc, int Ct,      \
                                             int D, int threads, void* stream) {          \
    const ClusterArgs<T> a = {static_cast<const T*>(alphas), static_cast<const T*>(betas), \
                              static_cast<const T*>(Dinv),   static_cast<const T*>(yred),  \
                              static_cast<const T*>(Z),      static_cast<const T*>(cap_inv), \
                              nullptr,                       nullptr,                      \
                              static_cast<T*>(xm1),          static_cast<T*>(xp1),         \
                              nullptr,                       C,                            \
                              wrap,                          1};                           \
    return solve_shift<T>(a, S2, B, K, Cc, Ct, D, threads, static_cast<cudaStream_t>(stream)); \
  }                                                                                       \
  extern "C" int tf_pcr_shift_clusters_##SUFFIX(int S2, int mode, int K, int Cc, int Ct,  \
                                                int D, int threads) {                     \
    return max_clusters<T>(S2, mode, K, Cc, Ct, D, threads);                             \
  }

// a library built by dtype (ops/_build.py: Library) keeps one type's entries
#ifndef TF_ONLY_F64
TF_ENTRIES(f32, float)
#endif
#ifndef TF_ONLY_F32
TF_ENTRIES(f64, double)
#endif
