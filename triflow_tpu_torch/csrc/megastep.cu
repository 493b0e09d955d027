// K6: the whole implicit step of a small grid in ONE launch, generated per
// model like K1 (ops/megastep.py prints the model's F and J into the block
// marked GENERATED below) and compiled at first use.
//
// Replaces, on the TPU: ops/megastep.py _launch (one or nsteps whole ROW or
// theta steps, the entries row_step_folded, theta_step_folded,
// row_scan_folded and theta_scan_folded) and row_adaptive_step_folded (one
// adaptive output step, its accept/reject loop inside the kernel).  The
// TPU's folded (8, C8) layout, its VMEM budget and its f32-only gate are
// not carried over; this kernel serves float and double.
//
// Replaces also row_adaptive_scan_folded (nsteps adaptive output steps in
// one launch, shared or per-member clocks), which only the reference's
// ensembles call.
//
// A member (one grid of an ensemble of B; B = 1 for one grid) is stepped by
// ONE thread-block cluster of K CTAs (K = 1, 2, 4, 8 or 16; K = 1 is a
// plain block), and the grid has ncl = min(B, the clusters the card holds
// at once) clusters, cluster k taking members k, k + ncl, ...  Two
// entries:
//   step:          nsteps >= 1 steps of fixed dt from u0 (beta = -gamma00*dt
//                  or -theta*dt factor shift, scale = the F scale, numbers
//                  or per-member device arrays), writing the last state and
//                  each member's last err, or for one grid with a snapshot
//                  buffer every step's state into its slot instead;
//   adaptive:      nsteps >= 1 output steps of the clamp-and-recompute
//                  controller of ROW_general._adaptive, run by thread 0 of
//                  every CTA in the model's type with every product, sum and
//                  quotient rounded as the host rounds it, every output step
//                  re-clamping its starting dt to the output dt and the loop
//                  ending at the first nonzero status; it writes the
//                  accepted state, dt_i, the attempts, the status (1:
//                  max_iter exceeded, 2: dt below its floor) and the output
//                  steps done; with a snapshot buffer (one grid, the
//                  scan) also each output step's state, t_i, dt_i,
//                  attempts and status in its slot.  Its caller counts the
//                  entry it asked for:
//                  adaptive_kernel runs one output step of one grid with a
//                  shared dt on a cluster, scan_kernel everything else
//                  (one grid's output step on one CTA too).
// Both entries take an optional Kahan carry c ((B, nvar, N), the caller's;
// null: no carry): every accepted state is then the Kahan update of the
// state before it by the step's result (kahan_nodes, ops/compensated.py's
// four operations in their order), and c keeps the rounding residual.  The
// step entry carries c in and out across its nsteps steps.  The adaptive
// entries start the first output step from c as given (zero from every
// caller of the port, as the reference's steppers start theirs; a check
// seeds it) and every later one from zero (zero_nodes), and leave the last
// output step's carry in c.  Like the accepted state, c lives in global
// memory beside the member's states, so the cluster plan does not change.
// An ensemble's adaptive steps run scan_kernel in two modes.
// Shared dt (one clock for the ensemble, the reference's shared-dt
// controller): an attempt's err is the max over all members, so every
// attempt ends in a grid-wide barrier (every CTA resident: a cooperative
// launch of one-CTA clusters, or as many clusters as
// cudaOccupancyMaxActiveClusters admits; an atomic counter, a generation
// word, and the CTA maxima in a double buffer); each CTA's thread 0 then
// runs the same controller on the same err, so the CTAs agree with no
// further traffic.  Per member (per_member_dt): each member's clock, dt,
// attempts and status are its own (the reference's masked per-member
// controller, where a member that reached the output time is frozen), so
// members never wait for each other.  A cluster's working set is reused by
// its members one after the other; the accepted and trial states are kept
// per member in global memory and switched by pointer.  One grid (B = 1)
// runs kernels without member offsets (kMembers false) and, on a cluster,
// its one-output-step adaptive entry its own kernel (adaptive_kernel): the
// member versions cost one grid registers and time (PERF.md).
// A df64 model's mixed library (TF_MIXED, built only where its mixed
// solve runs) has one entry instead, K6's mixed entry (step_mixed, one
// grid, one cluster): nsteps >= 1 steps of the df64 precision mode's
// mixed-precision stage solve, the reference's row_step_df_folded /
// theta_step_df_folded (ops/megastep.py) on native float64.  Per step: J in
// double (K1's node body), its bands rounded to float, the chunked factor,
// the PCR factor and on a Woodbury plan the closure's set-up in float (the
// float instantiations of factor.cuh and pcr.cuh); per stage the stage
// sums and F in double, the first solve in float on the rounded right-hand
// side, then `passes` times K8's residual body (matvec.cuh's band walk
// against the double bands, rounded to float) and a float solve whose
// widened result is added to the stage's double solution; the final
// combination and err in double.  The factor takes the rounded bands of
// J(u), not J of the rounded state: both are float-accurate
// preconditioners, and the residual passes correct against the double
// operator either way.  It shares one_step's stage sums, final combination
// and err (stage_sums, finish) and the step loop (run_steps).
// One step, in the order of the multi-launch path (K1-K5):
//   1. J at every node (K1's body), the chunked factor of I + beta*J (K2's
//      body, one thread per chunk) and the PCR factor of the interface
//      system (K4's body); on a Woodbury plan (a ring whose chunk count is
//      no power of two >= 8) the closure's set-up (K4's solve body: Z and
//      the capacitance inverse, which every CTA inverts itself into its
//      shared memory);
//   2. per stage: the stage input sum a*u_j and bias sum c*u_j (K5's
//      arithmetic), rhs = scale*F + bias (K1), the chunk sweep (K3), the
//      reduced solve with the Woodbury correction where the plan has one
//      and the shifts (K4) and the spike correction (K3);
//   3. the final combination and err = max|sum (m - mhat)*u_j|, NaN and inf
//      becoming inf, reduced over the cluster through distributed shared
//      memory.
// Ownership: CTA `rank` of the cluster owns the contiguous chunks [rank Cc,
// rank Cc + Cc) (the last may own fewer) and their Nr = Cc Mc g nodes, and
// holds its share of every buffer of the member's working set: the state
// u (copied in at each step), J's bands, the factor rows (fac, Dhinv, DU,
// Wsp, Vsp), the interface rows and operators (Lred, Ured, alphas, betas,
// Dinv, Z), the PCR scratch, and the stage vectors (us, ui, bias, rhs, y,
// yred, xm1, xp1); in the mixed entry the double bands beside the float
// ones.  Each buffer's home is the CTA's dynamic shared memory or, where a
// share does not fit, the CTA's own slab of global memory (L2-resident at
// these sizes): the host's plan (ops/megastep.py:cluster_plan) places
// them, the buffers other CTAs read (u, ui, the interface rows, the PCR
// scratch, Z; us in the mixed entry) always in shared memory.  F's and J's
// 2h halo nodes, the PCR levels' neighbours c -+ d, the shifts' neighbour
// chunks and the closure's end chunks are read from the owning CTA's
// shared memory through cluster.map_shared_rank (rank K-1 and rank 0 are
// neighbours on a ring).  Phases that read another CTA's share are
// separated from the phases that wrote it by a cluster barrier
// (barrier.cluster arrive / wait), the others by __syncthreads(); threads
// stride over the CTA's nodes for F, J and the combinations and over its
// chunks for the sweeps and PCR levels.  Each chunk's, node's and level's
// arithmetic is the one-block body's (the headers' bodies, in their order):
// only the home of the data moved, so at the same chunk plan the outputs
// are the L2-scratch body's bit for bit (the adaptive kernels' where nvcc
// fuses their products and sums alike: PERF.md).  A member on one CTA with
// every buffer in shared memory (s <= 2) runs the kOne instantiation of
// each kernel: the same body with every chunk its own (tf::Local, the PCR
// factor's inverses stored once) and every address in the shared window.
//
// Bound: a member's step is a chain of dependent phases, about
// n_stages * (2 Mc + log2 C + 4) row and level latencies plus the factor's
// 2 Mc rows and log2 C levels (and on a Woodbury plan log2 C more), each a
// shared-memory round trip and, between CTAs, a cluster barrier; the bytes
// (a few state vectors per stage) and the operations are far below the
// card's rates at these sizes.  The design spends no launch, no host round
// trip and no device-memory round trip between phases, and keeps the
// working set next to the threads that use it; what it leaves on the table
// is the barrier latency of every level, and for one grid the SMs beyond
// its cluster.
#include <cooperative_groups.h>

#include <cuda/std/limits>
#include <cuda/std/type_traits>

#include "common.cuh"

// ---- GENERATED: model constants and expression bodies ----
// @GENERATED@
// ---- end of generated block ----

#include "factor.cuh"
#include "pcr.cuh"
#include "stencil.cuh"
#include "sweep.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 256;
constexpr int kMaxCluster = 16;
constexpr int kMaxDevices = 16;
constexpr int kSmemPerCta = 232448;  // the card's opt-in shared memory per block
constexpr int kG = TF_H > 1 ? TF_H : 1;
constexpr int kS = TF_NVAR * kG;
constexpr int kS2 = 2 * kS;
constexpr int kMaxStages = 6;
constexpr int kCombos = kMaxStages + 1;
constexpr int kCols = kMaxStages + 1;
constexpr int kInfo = 5;  // per member: err, dt_i, attempts, status, output steps done
constexpr int kSnapInfo = 4;  // per output step: t_i, dt_i, attempts, status

using tf::add_rn;
using tf::div_rn;
using tf::mul_rn;
using tf::sub_rn;

// The buffers of a member's working set, in the order of
// ops/megastep.py:BUFFERS
enum Buf : int {
  bU, bBands, bFac, bDhinv, bDU, bWsp, bVsp, bLred, bUred, bAlphas, bBetas, bDinv, bPscr, bZ,
  bUs, bUi, bBias, bRhs, bY, bYred, bXm1, bXp1, bBands32, bR32, bD32, kBufs
};

// The host's cluster plan: K CTAs of `threads` threads per member, Cc
// chunks and Nr = Cc Mc g nodes per CTA, `smem` bytes of dynamic shared
// memory and `gslab` bytes of global memory per CTA, and each buffer's
// share: home 0 at byte off in the shared memory, home 1 in the CTA's
// global slab.
struct Layout {
  int K, threads, Cc, Nr, smem, gslab;
  int off[kBufs];
  unsigned char home[kBufs];
};

// The combinations of one step.  Combination k < n_stages gives stage k's
// input (row 0) and, with rows[k] = 2, its bias (row 1), over the columns
// (u, u_0, ..., u_{k-1}); combination n_stages gives u_new (row 0) and,
// with rows = 2, the error row u_new - u_pred, over (u, u_0, ..., u_last).
template <typename T>
struct Table {
  T coef[kCombos][2][kCols];
  unsigned char role[kCombos][2][kCols];
  unsigned char rows[kCombos];
  unsigned char is_u[kMaxStages];  // stage k's input is u itself
  int n_stages;
  T g00;  // the adaptive entries' factor shift is -g00 * dt
};

// The operands and the plan every entry takes.
template <typename T>
struct Grid {
  const T* u0;
  const T* hlp;
  const T* par;
  const T* x;
  double* info;        // (B, kInfo), or kInfo for the shared adaptive mode
  T* out;
  unsigned char* gwork;  // the CTAs' global slabs, CTA k's at k * gslab bytes
  T *buf0, *buf1;      // accepted and trial states, member m's at m * n
  int N, Mc, C, cyclic, wrap, periodic;
};

template <typename T>
struct Work : Grid<T> {
  const T* beta_b;     // per-member factor shift of the step entry, or null
  const T* scale_b;    // per-member F scale of the step entry, or null
  const T* idt_b;      // per-member starting internal dt (per-member mode)
  unsigned* sync;      // grid barrier: arrivals, generation
  T* errs;             // 2 x gridDim CTA maxima of err (shared mode)
  T* snap;             // one grid's per-step states (nsteps, nvar, N), or null
  double* snap_info;   // (nsteps, kSnapInfo) of the adaptive scan, or null
  T* carry;            // the Kahan carry (B, nvar, N), or null
  int B;
};

template <typename T>
struct Ctl {
  T t, dt, internal_dt, tol, safety, dt_min;
  int max_iter, has_dt_min;
};

template <typename T>
using Lim = cuda::std::numeric_limits<T>;

// This CTA's part of a member: its chunks (sp) and its nodes [i0, i0 + nn)
// of Nr per CTA.  kOne: a member on one CTA with its whole working set in
// shared memory (tf::Local, and every buffer addressed from the shared
// window: the same arithmetic without the cluster's address mapping).
template <bool kOne>
struct Part {
  using Sp = typename cuda::std::conditional<kOne, tf::Local, tf::Spread>::type;
  Sp sp;
  int N, Nr;
  long i0, nn;

  // node i's entry 0 in its owner's share of the node buffer whose share
  // here is `share` (a shared-memory buffer, when i is another's)
  template <typename U>
  __device__ __forceinline__ U* node(U* share, long i) const {
    if constexpr (kOne) {
      return share + i;
    } else {
      const long l = i - i0;
      if (l >= 0 && l < nn) return share + l;
      const int r = (int)(i / Nr);
      return cg::this_cluster().map_shared_rank(share, r) + (i - (long)r * Nr);
    }
  }

  // no CTA leaves while another may still read its shared memory
  __device__ __forceinline__ void end() const {
    if (sp.K > 1) sp.sync();
  }
};

template <bool kOne, typename T>
__device__ __forceinline__ Part<kOne> part_of(const Grid<T>& g, const Layout& L) {
  Part<kOne> P;
  const int rank = !kOne && L.K > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int c0 = rank * L.Cc;
  const int nc = max(0, min(L.Cc, g.C - c0));
  P.sp = typename Part<kOne>::Sp{L.K, rank, L.Cc, g.C, c0, nc};
  P.N = g.N;
  P.Nr = L.Nr;
  P.i0 = (long)rank * L.Nr;
  P.nn = (long)nc * g.Mc * kG;
  return P;
}

template <bool kOne, typename U>
__device__ __forceinline__ U* share_of(const Layout& L, unsigned char* sm, unsigned char* gl,
                                       int b) {
  if constexpr (kOne) return reinterpret_cast<U*>(sm + L.off[b]);
  return reinterpret_cast<U*>((L.home[b] ? gl : sm) + L.off[b]);
}

// The solver's buffers (type F: the model's, or float in the mixed entry)
template <typename F>
struct Solver {
  F *fac, *Dhinv, *DU, *Wsp, *Vsp, *Lred, *Ured, *alphas, *betas, *Dinv, *pscr, *Z;
  F *y, *yred, *xm1, *xp1;
};

template <bool kOne, typename F>
__device__ __forceinline__ Solver<F> solver_of(const Layout& L, unsigned char* sm,
                                               unsigned char* gl) {
  Solver<F> s;
  s.fac = share_of<kOne, F>(L, sm, gl, bFac);
  s.Dhinv = share_of<kOne, F>(L, sm, gl, bDhinv);
  s.DU = share_of<kOne, F>(L, sm, gl, bDU);
  s.Wsp = share_of<kOne, F>(L, sm, gl, bWsp);
  s.Vsp = share_of<kOne, F>(L, sm, gl, bVsp);
  s.Lred = share_of<kOne, F>(L, sm, gl, bLred);
  s.Ured = share_of<kOne, F>(L, sm, gl, bUred);
  s.alphas = share_of<kOne, F>(L, sm, gl, bAlphas);
  s.betas = share_of<kOne, F>(L, sm, gl, bBetas);
  s.Dinv = share_of<kOne, F>(L, sm, gl, bDinv);
  s.pscr = share_of<kOne, F>(L, sm, gl, bPscr);
  s.Z = share_of<kOne, F>(L, sm, gl, bZ);
  s.y = share_of<kOne, F>(L, sm, gl, bY);
  s.yred = share_of<kOne, F>(L, sm, gl, bYred);
  s.xm1 = share_of<kOne, F>(L, sm, gl, bXm1);
  s.xp1 = share_of<kOne, F>(L, sm, gl, bXp1);
  return s;
}

// The stage vectors and J's bands, in the model's type T
template <typename T>
struct Stage {
  T *u, *bands, *us, *ui, *bias, *rhs;
};

template <bool kOne, typename T>
__device__ __forceinline__ Stage<T> stage_of(const Layout& L, unsigned char* sm,
                                             unsigned char* gl) {
  return Stage<T>{share_of<kOne, T>(L, sm, gl, bU),   share_of<kOne, T>(L, sm, gl, bBands),
                  share_of<kOne, T>(L, sm, gl, bUs),  share_of<kOne, T>(L, sm, gl, bUi),
                  share_of<kOne, T>(L, sm, gl, bBias), share_of<kOne, T>(L, sm, gl, bRhs)};
}

// This CTA's nodes of the state src (global, the grid's layout) into its
// share of u; the caller syncs over the cluster before J or F read it.
template <typename T, typename Pt>
__device__ __forceinline__ void load_state(const Pt& P, const T* src, T* u) {
  for (int v = 0; v < TF_NVAR; ++v)
    for (long l = threadIdx.x; l < P.nn; l += blockDim.x)
      u[(long)v * P.Nr + l] = src[(long)v * P.N + P.i0 + l];
}

// the state read by the stencil bodies: variable v at node j, wherever its
// owner keeps it
template <typename T, typename Pt>
__device__ __forceinline__ auto reader(const Pt& P, const T* share) {
  return [&P, share](int v, long j, int) { return P.node(share, j)[(long)v * P.Nr]; };
}

// Stage k's input sum a*u_j into ui (unless the input is u itself) and,
// with rows[k] = 2, its bias sum c*u_j into bias, over the columns (u,
// us_0, ...), at this CTA's nodes.  The caller syncs.
template <typename T, typename Pt>
__device__ void stage_sums(const Table<T>& tab, int k, const Pt& P, const T* u, const T* us,
                           T* ui, T* bias) {
  const bool with_bias = tab.rows[k] == 2;
  if (tab.is_u[k] && !with_bias) return;
  const long n = (long)TF_NVAR * P.Nr;
  for (int v = 0; v < TF_NVAR; ++v)
    for (long l = threadIdx.x; l < P.nn; l += blockDim.x) {
      const long e = (long)v * P.Nr + l;
      auto value = [&](int j) { return j == 0 ? u[e] : us[(long)(j - 1) * n + e]; };
      if (!tab.is_u[k])
        ui[e] = tf::lin_comb(k + 1, tab.coef[k][0], tab.role[k][0], value);
      if (with_bias)
        bias[e] = tf::lin_comb(k + 1, tab.coef[k][1], tab.role[k][1], value);
    }
}

// The final combination into dst (global, the grid's layout) and the
// step's err = max|error row| over the member, which every thread of every
// CTA gets (inf without an error row, and where a term is not finite).
template <typename T, typename Pt>
__device__ T finish(const Table<T>& tab, const Pt& P, const T* u, const T* us, T* dst) {
  __shared__ T s_max[kMaxThreads];
  __shared__ T s_cta;
  __shared__ int s_bad, s_cta_bad;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int fin = tab.n_stages;
  const bool with_err = tab.rows[fin] == 2;
  const long n = (long)TF_NVAR * P.Nr;
  T mx = T(0);
  int bad = 0;
  for (int v = 0; v < TF_NVAR; ++v)
    for (long l = tid; l < P.nn; l += nt) {
      const long e = (long)v * P.Nr + l;
      auto value = [&](int j) { return j == 0 ? u[e] : us[(long)(j - 1) * n + e]; };
      dst[(long)v * P.N + P.i0 + l] = tf::lin_comb(fin + 1, tab.coef[fin][0], tab.role[fin][0], value);
      if (with_err) {
        const T d = fabs(tf::lin_comb(fin + 1, tab.coef[fin][1], tab.role[fin][1], value));
        // fmax drops NaN: a non-finite term is flagged on its own
        if (isfinite(d))
          mx = fmax(mx, d);
        else
          bad = 1;
      }
    }
  if (tid == 0) s_bad = 0;
  s_max[tid] = mx;
  __syncthreads();
  if (bad) s_bad = 1;
  for (int off = nt / 2; off > 0; off >>= 1) {
    if (tid < off) s_max[tid] = fmax(s_max[tid], s_max[tid + off]);
    __syncthreads();
  }
  if (P.sp.K > 1) {
    // the cluster's max and flag from every CTA's (max is exact in any order)
    if (tid == 0) {
      s_cta = s_max[0];
      s_cta_bad = s_bad;
    }
    P.sp.sync();
    if (tid == 0) {
      cg::cluster_group cluster = cg::this_cluster();
      T m = s_cta;
      int b = s_cta_bad;
      for (int r = 0; r < P.sp.K; ++r) {
        if (r == P.sp.rank) continue;
        m = fmax(m, *cluster.map_shared_rank(&s_cta, r));
        b |= *cluster.map_shared_rank(&s_cta_bad, r);
      }
      s_max[0] = m;
      s_bad = b;
    }
    __syncthreads();
  }
  const T err = (with_err && !s_bad) ? s_max[0] : Lim<T>::infinity();
  __syncthreads();
  return err;
}

// The Kahan update of an accepted state at this CTA's nodes (Neumaier's
// variant, ops/compensated.py's kahan_update in its order): dst = fl(src +
// ((dst - src) + c)) and c the rounding residual of that addition, src the
// state the step started from and dst its result, each node by the thread
// that wrote it in finish.  Every entry with a carry calls it where a state
// is accepted.
template <typename T, typename Pt>
__device__ __forceinline__ void kahan_nodes(const Pt& P, const T* src, T* dst, T* c) {
  for (int v = 0; v < TF_NVAR; ++v)
    for (long l = threadIdx.x; l < P.nn; l += blockDim.x) {
      const long e = (long)v * P.N + P.i0 + l;
      const T u = src[e];
      const T y = add_rn(sub_rn(dst[e], u), c[e]);
      const T u2 = add_rn(u, y);
      c[e] = sub_rn(y, sub_rn(u2, u));
      dst[e] = u2;
    }
  __syncthreads();
}

// c = 0 at this CTA's nodes, each by the thread that kahan_nodes gives it.
template <typename T, typename Pt>
__device__ __forceinline__ void zero_nodes(const Pt& P, T* c) {
  for (int v = 0; v < TF_NVAR; ++v)
    for (long l = threadIdx.x; l < P.nn; l += blockDim.x) c[(long)v * P.N + P.i0 + l] = T(0);
}

// nsteps steps of one_step(src, dst) from src, between the state buffers
// buf0 and buf1, the last into out, or with snap (one grid) step k into
// snap + k * n and no write to out: the last step's err.
template <typename T, typename OneStep>
__device__ T run_steps(const T* src, T* out, T* buf0, T* buf1, T* snap, long n, int nsteps,
                       OneStep one_step) {
  T err = Lim<T>::infinity();
  for (int k = 0; k < nsteps; ++k) {
    T* dst = snap ? snap + k * n : (k == nsteps - 1 ? out : (k % 2 ? buf1 : buf0));
    err = one_step(src, dst);
    src = dst;
  }
  return err;
}

// J at this CTA's nodes into its share of the bands, `round` (a float copy,
// or null) beside them; the state is its share of u and its neighbours'.
template <typename T, typename R, typename Pt>
__device__ __forceinline__ void eval_J(const Pt& P, const Grid<T>& g, const T* hlp,
                                       const T* par, const T* u, T* bands, R* round) {
  for (long l = threadIdx.x; l < P.nn; l += blockDim.x) {
    T b[tf::kNJ];
    tf::stencil_J_vals<T>(reader<T>(P, u), hlp, par, g.x, P.N, g.periodic, P.i0 + l, b);
#pragma unroll
    for (int e = 0; e < tf::kNJ; ++e) {
      bands[(long)e * P.Nr + l] = b[e];
      if (round) round[(long)e * P.Nr + l] = (R)b[e];
    }
  }
}

// rhs = scale*F(stage_u) + bias at this CTA's nodes, `round` (a float copy,
// or null) beside it
template <typename T, typename R, typename Pt>
__device__ __forceinline__ void eval_F(const Pt& P, const Grid<T>& g, const T* hlp,
                                       const T* par, const T* stage_u, const T* bias, T* rhs,
                                       T scale, R* round) {
  for (long l = threadIdx.x; l < P.nn; l += blockDim.x) {
    T f[TF_NVAR];
    tf::stencil_F_vals<T>(reader<T>(P, stage_u), hlp, par, g.x, P.N, g.periodic, P.i0 + l, f);
#pragma unroll
    for (int m = 0; m < TF_NVAR; ++m) {
      const long e = (long)m * P.Nr + l;
      const T v = scale * f[m];
      rhs[e] = bias ? v + bias[e] : v;
      if (round) round[e] = (R)rhs[e];
    }
  }
}

// The chunked factor of alpha I + beta J from this CTA's share of the
// bands, the PCR factor of the interface system and, on a Woodbury plan,
// the closure's set-up (cap_inv this CTA's own); the caller syncs (a block
// barrier) before the stages.
template <typename F, typename G, typename Pt>
__device__ __forceinline__ void factor(const Pt& P, const G& g, const Solver<F>& s,
                                       const F* bands, F beta, F* cap_inv) {
  for (int l = threadIdx.x; l < P.sp.nc; l += blockDim.x) {
    const int c = P.sp.c0 + l;
    tf::spike_factor_chunk<F, kS>(bands, s.fac, s.Dhinv, s.DU, s.Wsp, s.Vsp, s.Lred, s.Ured, P.Nr,
                                  TF_NVAR, kG, TF_H, g.Mc, P.sp.Cc, !g.wrap && c == 0,
                                  !g.wrap && c == g.C - 1, F(1), beta, l);
  }
  __syncthreads();
  tf::pcr_factor_cluster<F, kS2>(s.Lred, s.Ured, s.alphas, s.betas, s.Dinv, s.pscr, P.sp,
                                 g.cyclic);
  __syncthreads();
  if (g.wrap && !g.cyclic) {
    tf::woodbury_cluster<F, kS2>(s.alphas, s.betas, s.Dinv, s.Lred, s.Ured, s.Z, cap_inv, s.pscr,
                                 P.sp);
    __syncthreads();
  }
}

// One solve of rhs (this CTA's share) on the factor: the chunk sweep, the
// reduced solve with shifts over the cluster, and the spike correction
// into out, each node then handed to post(l); the caller syncs.
template <typename F, typename G, typename Post, typename Pt>
__device__ __forceinline__ void solve(const Pt& P, const G& g, const Solver<F>& s, const F* rhs,
                                      const F* cap_inv, F* out, Post post) {
  for (int l = threadIdx.x; l < P.sp.nc; l += blockDim.x)
    tf::thomas_sweep_chunk<F, kS>(s.fac, s.Dhinv, s.DU, rhs, s.y, s.yred, P.Nr, TF_NVAR, kG, g.Mc,
                                  P.sp.Cc, l);
  __syncthreads();
  if (g.wrap && !g.cyclic)
    tf::pcr_solve_shift_cluster<F, kS2, true>(s.alphas, s.betas, s.Dinv, s.yred, s.Z, cap_inv,
                                              s.xm1, s.xp1, s.pscr, P.sp, g.wrap);
  else
    tf::pcr_solve_shift_cluster<F, kS2, false>(s.alphas, s.betas, s.Dinv, s.yred, nullptr,
                                               nullptr, s.xm1, s.xp1, s.pscr, P.sp, g.wrap);
  __syncthreads();
  for (long l = threadIdx.x; l < P.nn; l += blockDim.x) {
    tf::spike_correct_node<F, kS>(s.y, s.Wsp, s.Vsp, s.xm1, s.xp1, nullptr, out, P.Nr, TF_NVAR,
                                  kG, g.Mc, P.sp.Cc, l);
    post(l);
  }
}

// One step of member m's grid from src to dst (global); every thread gets
// err (inf without an error row).  All threads of the cluster must call it.
template <typename T, bool kMembers, typename Pt>
__device__ T one_step(const Work<T>& w, const Table<T>& tab, const Pt& P, const Stage<T>& st,
                      const Solver<T>& s, int m, const T* src, T* dst, T beta, T scale) {
  __shared__ T s_cap_inv[kS2 * kS2];
  const T* hlp = kMembers ? w.hlp + (long)m * TF_NHELP * w.N : w.hlp;
  const T* par = kMembers ? w.par + (long)m * TF_NPAR * w.N : w.par;
  T* none = nullptr;

  load_state<T>(P, src, st.u);
  P.sp.sync();
  eval_J<T>(P, w, hlp, par, st.u, st.bands, none);
  __syncthreads();
  factor<T>(P, w, s, st.bands, beta, s_cap_inv);

  const long n = (long)TF_NVAR * P.Nr;
  for (int k = 0; k < tab.n_stages; ++k) {
    stage_sums<T>(tab, k, P, st.u, st.us, st.ui, st.bias);
    // F reads the neighbours' stage input
    if (!tab.is_u[k])
      P.sp.sync();
    else
      __syncthreads();
    eval_F<T>(P, w, hlp, par, tab.is_u[k] ? st.u : st.ui, tab.rows[k] == 2 ? st.bias : nullptr,
              st.rhs, scale, none);
    __syncthreads();
    solve<T>(P, w, s, st.rhs, s_cap_inv, st.us + (long)k * n, [](long) {});
    __syncthreads();
  }
  return finish<T>(tab, P, st.u, st.us, dst);
}

template <typename T, bool kMembers, bool kOne>
__global__ void __launch_bounds__(kMaxThreads, 1)
    step_kernel(const Work<T> w, const Layout L, const Table<T> tab_in, T beta, T scale,
                int nsteps) {
  __shared__ Table<T> tab;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* gl = w.gwork + (long)blockIdx.x * L.gslab;
  const Part<kOne> P = part_of<kOne>(w, L);
  const Stage<T> st = stage_of<kOne, T>(L, smem, gl);
  const Solver<T> s = solver_of<kOne, T>(L, smem, gl);
  if (threadIdx.x == 0) tab = tab_in;
  __syncthreads();
  const long n = (long)TF_NVAR * w.N;
  const int cid = blockIdx.x / L.K, ncl = gridDim.x / L.K;
  for (int m = kMembers ? cid : 0; m < (kMembers ? w.B : 1); m += kMembers ? ncl : 1) {
    const long at = kMembers ? m * n : 0;
    const T bm = w.beta_b ? w.beta_b[m] : beta;
    const T sm = w.scale_b ? w.scale_b[m] : scale;
    const T err = run_steps<T>(w.u0 + at, w.out + at, w.buf0 + at, w.buf1 + at,
                               kMembers ? nullptr : w.snap, n, nsteps, [&](const T* src, T* dst) {
                                 const T e = one_step<T, kMembers>(w, tab, P, st, s, m, src, dst,
                                                                   bm, sm);
                                 if (w.carry) kahan_nodes<T>(P, src, dst, w.carry + at);
                                 return e;
                               });
    if (threadIdx.x == 0 && P.sp.rank == 0) w.info[(long)m * kInfo] = (double)err;
  }
  P.end();
}

// All CTAs of a grid that is resident at once meet here (the kernel's
// thread 0 of every CTA arrives; the last arrival resets the count and
// bumps the generation the others spin on).
__device__ __forceinline__ void grid_sync(unsigned* sync) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = sync + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(sync, 1u) == gridDim.x - 1) {
      atomicExch(sync, 0u);
      __threadfence();
      atomicAdd(sync + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// One adaptive output step of one grid (the entry ROW_general._adaptive
// launches, with no member axis) on a cluster: the controller's state in
// shared memory, the same in every CTA, the accepted and trial states
// switched by pointer.  A one-grid output step on one CTA with every
// buffer in shared memory runs scan_kernel's kOne instantiation instead:
// a kOne instantiation of this kernel rounded a product and a sum of the
// step apart from step_kernel's (PERF.md), which check_clusters catches.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1)
    adaptive_kernel(const Work<T> w, const Layout L, const Table<T> tab_in, const Ctl<T> ctl) {
  __shared__ Table<T> tab;
  __shared__ T s_t, s_next_t, s_eps, s_floor, s_dt_i, s_dt_eff;
  __shared__ int s_go, s_accept, s_clamped, s_niter, s_status;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* gl = w.gwork + (long)blockIdx.x * L.gslab;
  const Part<false> P = part_of<false>(w, L);
  const Stage<T> st = stage_of<false, T>(L, smem, gl);
  const Solver<T> s = solver_of<false, T>(L, smem, gl);
  const int tid = threadIdx.x;
  const T tiny = Lim<T>::min();
  if (tid == 0) {
    tab = tab_in;
    // in the order of ROW_general._adaptive
    const T next_t = add_rn(ctl.t, ctl.dt);
    s_next_t = next_t;
    s_eps = mul_rn(T(1e-12), fmax(fabs(next_t), T(1)));
    s_floor = ctl.has_dt_min
                  ? ctl.dt_min
                  : add_rn(mul_rn(T(1e3), tiny), mul_rn(mul_rn(T(2), Lim<T>::epsilon()), fabs(next_t)));
    s_t = ctl.t;
    s_dt_i = fmin(ctl.internal_dt, ctl.dt);
    s_niter = 0;
    s_status = 0;
    s_go = sub_rn(next_t, s_t) > s_eps;
  }
  __syncthreads();
  const T* cur = w.u0;
  T* trial = w.buf0;
  T err = Lim<T>::infinity();
  while (s_go) {
    if (tid == 0) {
      const T remaining = sub_rn(s_next_t, s_t);
      s_clamped = s_dt_i >= remaining;
      s_dt_eff = fmin(s_dt_i, remaining);
    }
    __syncthreads();
    const T dt_eff = s_dt_eff;
    const T gdt = mul_rn(tab.g00, dt_eff);
    err = one_step<T, false>(w, tab, P, st, s, 0, cur, trial, -gdt, gdt);
    if (tid == 0) {
      const bool accept = err <= ctl.tol;
      T dt_next = mul_rn(mul_rn(ctl.safety, dt_eff), sqrt(div_rn(ctl.tol, fmax(err, tiny))));
      dt_next = fmin(fmax(dt_next, mul_rn(T(0.1), dt_eff)), mul_rn(T(10), dt_eff));
      if (accept) s_t = add_rn(s_t, dt_eff);
      if (!(accept && s_clamped)) s_dt_i = dt_next;
      s_niter += 1;
      if (ctl.max_iter >= 0 && s_niter > ctl.max_iter) s_status = 1;
      if (s_dt_i < s_floor) s_status = 2;
      s_accept = accept;
      s_go = sub_rn(s_next_t, s_t) > s_eps && s_status == 0;
    }
    __syncthreads();
    if (s_accept) {
      if (w.carry) kahan_nodes<T>(P, cur, trial, w.carry);
      cur = trial;
      trial = trial == w.buf0 ? w.buf1 : w.buf0;
    }
  }
  // this CTA's nodes of the accepted state (it wrote them itself)
  for (int v = 0; v < TF_NVAR; ++v)
    for (long l = tid; l < P.nn; l += blockDim.x) {
      const long e = (long)v * w.N + P.i0 + l;
      w.out[e] = cur[e];
    }
  if (tid == 0 && P.sp.rank == 0) {
    w.info[0] = (double)err;
    w.info[1] = (double)s_dt_i;
    w.info[2] = (double)s_niter;
    w.info[3] = (double)s_status;
    w.info[4] = 1.0;
  }
  P.end();
}

// nsteps adaptive output steps of an ensemble.  shared: one clock and dt
// for every member, err the max over all members (clusters agree through
// grid_sync); otherwise each member of the cluster runs its own clock, dt
// and attempts.
// The mode is a runtime flag: a template parameter doubled the kernel's
// code and the s = 4 library's build time (96 s against 47 s on H100).
// The controller's state lives in shared memory, written by thread 0:
// across a member's step (one_step, the kernel's register peak) only the
// member index and the CTA's err maximum stay in registers.
template <typename T, bool kOne>
__global__ void __launch_bounds__(kMaxThreads, 1)
    scan_kernel(const Work<T> w, const Layout L, const Table<T> tab_in, const Ctl<T> ctl,
                int nsteps, int shared) {
  __shared__ Table<T> tab;
  __shared__ T s_tout, s_t, s_next_t, s_eps, s_floor, s_dt_i, s_dt_eff, s_err;
  __shared__ int s_go, s_clamped, s_niter, s_total, s_status, s_done, s_cur, s_par;
  __shared__ int s_prev;  // the accepted state before the last accept
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* gl = w.gwork + (long)blockIdx.x * L.gslab;
  const Part<kOne> P = part_of<kOne>(w, L);
  const Stage<T> st = stage_of<kOne, T>(L, smem, gl);
  const Solver<T> s = solver_of<kOne, T>(L, smem, gl);
  const int tid = threadIdx.x;
  const int cid = blockIdx.x / L.K, ncl = gridDim.x / L.K;
  if (tid == 0) tab = tab_in;
  // shared: one pass of the controller for all of the cluster's members
  // (clusters k, k + ncl, ...); otherwise one pass per member
  for (int mm = cid; mm < w.B; mm += shared ? w.B : ncl) {
    if (tid == 0) {
      s_tout = ctl.t;
      s_dt_i = shared ? ctl.internal_dt : w.idt_b[mm];
      s_status = 0;
      s_done = 0;
      s_total = 0;
      s_cur = 0;  // the accepted state: 0 u0, 1 buf0, 2 buf1
      s_par = 0;
      s_err = Lim<T>::infinity();
    }
    __syncthreads();
    while (s_done < nsteps && s_status == 0) {
      if (tid == 0) {
        // in the order of ROW_general._adaptive
        const T next_t = add_rn(s_tout, ctl.dt);
        s_next_t = next_t;
        s_eps = mul_rn(T(1e-12), fmax(fabs(next_t), T(1)));
        s_floor = ctl.has_dt_min
                      ? ctl.dt_min
                      : add_rn(mul_rn(T(1e3), Lim<T>::min()),
                               mul_rn(mul_rn(T(2), Lim<T>::epsilon()), fabs(next_t)));
        s_t = s_tout;
        s_dt_i = fmin(s_dt_i, ctl.dt);
        s_niter = 0;
        s_go = sub_rn(next_t, s_t) > s_eps;
      }
      if (w.carry && s_done > 0)
        for (int m = shared ? cid : mm; m < w.B; m += shared ? ncl : w.B)
          zero_nodes<T>(P, w.carry + (long)m * TF_NVAR * w.N);
      __syncthreads();
      while (s_go) {
        if (tid == 0) {
          const T remaining = sub_rn(s_next_t, s_t);
          s_clamped = s_dt_i >= remaining;
          s_dt_eff = fmin(s_dt_i, remaining);
        }
        __syncthreads();
        T bmax = T(0);
        for (int m = shared ? cid : mm; m < w.B; m += shared ? ncl : w.B) {
          const long at = (long)m * TF_NVAR * w.N;
          const T* src = s_cur == 0 ? w.u0 + at : (s_cur == 1 ? w.buf0 : w.buf1) + at;
          T* dst = (s_cur == 1 ? w.buf1 : w.buf0) + at;
          const T gdt = mul_rn(tab.g00, s_dt_eff);
          bmax = fmax(bmax, one_step<T, true>(w, tab, P, st, s, m, src, dst, -gdt, gdt));
        }
        if (shared && ncl > 1) {
          if (tid == 0) w.errs[s_par * gridDim.x + blockIdx.x] = bmax;
          grid_sync(w.sync);
          if (tid == 0) {
            volatile const T* e = w.errs + s_par * gridDim.x;
            T mx = e[0];
            for (int k = 1; k < gridDim.x; ++k) mx = fmax(mx, e[k]);
            bmax = mx;
            s_par ^= 1;
          }
        }
        if (tid == 0) {
          const T err = bmax, dt_eff = s_dt_eff;
          const bool accept = err <= ctl.tol;
          T dt_next = mul_rn(mul_rn(ctl.safety, dt_eff),
                             sqrt(div_rn(ctl.tol, fmax(err, Lim<T>::min()))));
          dt_next = fmin(fmax(dt_next, mul_rn(T(0.1), dt_eff)), mul_rn(T(10), dt_eff));
          if (accept) s_t = add_rn(s_t, dt_eff);
          if (!(accept && s_clamped)) s_dt_i = dt_next;
          s_niter += 1;
          if (ctl.max_iter >= 0 && s_niter > ctl.max_iter) s_status = 1;
          const bool still = sub_rn(s_next_t, s_t) > s_eps;
          // a member that reached the output time is frozen: its dt floor
          // no longer trips (the per-member controller)
          if (s_dt_i < s_floor && (shared || still)) s_status = 2;
          s_prev = accept ? s_cur : -1;
          if (accept) s_cur = s_cur == 1 ? 2 : 1;
          s_err = err;
          s_go = still && s_status == 0;
        }
        __syncthreads();
        if (w.carry && s_prev >= 0)
          for (int m = shared ? cid : mm; m < w.B; m += shared ? ncl : w.B) {
            const long at = (long)m * TF_NVAR * w.N;
            const T* src = s_prev == 0 ? w.u0 + at : (s_prev == 1 ? w.buf0 : w.buf1) + at;
            kahan_nodes<T>(P, src, (s_cur == 1 ? w.buf0 : w.buf1) + at, w.carry + at);
          }
      }
      if (tid == 0) {
        s_tout = s_next_t;
        s_total += s_niter;
        s_done += 1;
      }
      __syncthreads();
      if (w.snap) {
        // one grid: this CTA's nodes of the accepted state, and the step's
        // clock, dt, attempts and status, into output step s_done - 1's slots
        const long n = (long)TF_NVAR * w.N, k = s_done - 1;
        const T* src = s_cur == 0 ? w.u0 : (s_cur == 1 ? w.buf0 : w.buf1);
        for (int v = 0; v < TF_NVAR; ++v)
          for (long l = tid; l < P.nn; l += blockDim.x) {
            const long e = (long)v * w.N + P.i0 + l;
            w.snap[k * n + e] = src[e];
          }
        if (tid == 0 && P.sp.rank == 0) {
          double* si = w.snap_info + k * kSnapInfo;
          si[0] = (double)s_tout;
          si[1] = (double)s_dt_i;
          si[2] = (double)s_niter;
          si[3] = (double)s_status;
        }
      }
    }
    for (int m = shared ? cid : mm; m < w.B; m += shared ? ncl : w.B) {
      const long at = (long)m * TF_NVAR * w.N;
      const T* src = s_cur == 0 ? w.u0 + at : (s_cur == 1 ? w.buf0 : w.buf1) + at;
      for (int v = 0; v < TF_NVAR; ++v)
        for (long l = tid; l < P.nn; l += blockDim.x) {
          const long e = (long)v * w.N + P.i0 + l;
          w.out[at + e] = src[e];
        }
      if (tid == 0 && P.sp.rank == 0 && (!shared || m == 0)) {
        double* info = w.info + (long)m * kInfo;
        info[0] = (double)s_err;
        info[1] = (double)s_dt_i;
        info[2] = (double)s_total;
        info[3] = (double)s_status;
        info[4] = (double)s_done;
      }
    }
    __syncthreads();
  }
  P.end();
}

#if TF_MIXED
// ---- K6's mixed entry (a df64 model's mixed library only) ----
static_assert(!TF_F32, "the mixed entry steps a float64 state");

// K8's residual body at this CTA's node l, variable m: matvec.cuh's band
// walk sum_k sum_q A[k, m, q, i] * v[q, i + k - h] in (k, q) order, A this
// CTA's share of the double bands, v the stage solution wherever its
// owner keeps it
template <typename Pt>
__device__ __forceinline__ double band_row_at(const Pt& P, int periodic, const double* A,
                                              const double* v, long l, int m) {
  constexpr int h = tf::kW / 2;
  const long i = P.i0 + l, N = P.N, n = (long)TF_NVAR * P.Nr;
  double acc = 0.0;
  for (int k = 0; k < tf::kW; ++k) {
    long j = i + k - h;
    if (j < 0 || j >= N) {
      if (!periodic) continue;
      j = ((j % N) + N) % N;
    }
    const double* Akm = A + (long)(k * TF_NVAR + m) * n;
    const double* vj = P.node(v, j);
    for (int q = 0; q < TF_NVAR; ++q) acc += Akm[(long)q * P.Nr + l] * vj[(long)q * P.Nr];
  }
  return acc;
}

// One mixed-precision step of the grid from src to dst; every thread gets
// err (inf without an error row).  All threads of the cluster must call
// it.
template <typename Pt>
__device__ double one_step_mixed(const Grid<double>& w, const Table<double>& tab, const Pt& P,
                                 const Stage<double>& st, const Solver<float>& s, float* bands32,
                                 float* r32, float* d32, int passes, const double* src,
                                 double* dst, double beta, double scale) {
  __shared__ float s_cap_inv[kS2 * kS2];
  // the residual's coefficient: the system is I + beta J = I - coef J
  const double coef = -beta;
  const long n = (long)TF_NVAR * P.Nr;

  // J in double, and the bands the float factor takes: each thread rounds
  // the entries of its own nodes
  load_state<double>(P, src, st.u);
  P.sp.sync();
  eval_J<double>(P, w, w.hlp, w.par, st.u, st.bands, bands32);
  __syncthreads();
  factor<float>(P, w, s, bands32, (float)beta, s_cap_inv);

  for (int k = 0; k < tab.n_stages; ++k) {
    stage_sums<double>(tab, k, P, st.u, st.us, st.ui, st.bias);
    if (!tab.is_u[k])
      P.sp.sync();
    else
      __syncthreads();
    double* uk = st.us + (long)k * n;
    // rhs = scale F + bias in double; the first solve takes its rounding
    eval_F<double>(P, w, w.hlp, w.par, tab.is_u[k] ? st.u : st.ui,
                   tab.rows[k] == 2 ? st.bias : nullptr, st.rhs, scale, r32);
    __syncthreads();
    for (int pass = 0; pass <= passes; ++pass) {
      if (pass > 0) {
        // K8's residual body: float((rhs - k) + coef * J k) against the
        // double bands, k read at the neighbours' nodes too
        P.sp.sync();
        for (long l = threadIdx.x; l < P.nn; l += blockDim.x)
          for (int m = 0; m < TF_NVAR; ++m) {
            const long e = (long)m * P.Nr + l;
            const double Jk = band_row_at(P, w.periodic, st.bands, uk, l, m);
            r32[e] = (float)((st.rhs[e] - uk[e]) + coef * Jk);
          }
        __syncthreads();
      }
      // the float correction, widened into the stage's double solution by
      // the thread that wrote it
      solve<float>(P, w, s, r32, s_cap_inv, d32, [&](long l) {
        for (int m = 0; m < TF_NVAR; ++m) {
          const long e = (long)m * P.Nr + l;
          uk[e] = pass == 0 ? (double)d32[e] : uk[e] + (double)d32[e];
        }
      });
      __syncthreads();
    }
  }
  return finish<double>(tab, P, st.u, st.us, dst);
}

template <bool kOne>
__global__ void __launch_bounds__(kMaxThreads, 1)
    step_mixed_kernel(const Grid<double> w, const Layout L, const Table<double> tab_in,
                      double beta, double scale, int passes, int nsteps) {
  __shared__ Table<double> tab;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* gl = w.gwork + (long)blockIdx.x * L.gslab;
  const Part<kOne> P = part_of<kOne>(w, L);
  const Stage<double> st = stage_of<kOne, double>(L, smem, gl);
  const Solver<float> s = solver_of<kOne, float>(L, smem, gl);
  float* bands32 = share_of<kOne, float>(L, smem, gl, bBands32);
  float* r32 = share_of<kOne, float>(L, smem, gl, bR32);
  float* d32 = share_of<kOne, float>(L, smem, gl, bD32);
  if (threadIdx.x == 0) tab = tab_in;
  __syncthreads();
  const double err = run_steps<double>(w.u0, w.out, w.buf0, w.buf1, nullptr, 0, nsteps,
                                       [&](const double* src, double* dst) {
                                         return one_step_mixed(w, tab, P, st, s, bands32, r32,
                                                               d32, passes, src, dst, beta,
                                                               scale);
                                       });
  if (threadIdx.x == 0 && P.sp.rank == 0) w.info[0] = err;
  P.end();
}
#endif

// ---- host side ----

// ptrs (device addresses: u0, hlp, par, x, info, out, gwork, buf0, buf1,
// then for the step and adaptive entries beta_b, scale_b, idt_b, sync,
// errs, snap, snap_info: null, or one grid's per-step states and the
// adaptive scan's per-step (t_i, dt_i, attempts, status), and the Kahan
// carry or null), ints (N, Mc, C, cyclic, wrap, periodic, n_stages, nsteps, max_iter
// (-1: none), has_dt_min, B, ncl (clusters launched), then the cluster
// plan's K, threads, Cc, Nr, smem, gslab, then the rows of the kCombos
// combinations, then kBufs homes and kBufs byte offsets) and reals (beta,
// scale, g00, t, dt, internal_dt, tol, safety, dt_min, then the kCombos x 2
// x kCols coefficients [combination][row][column]) live in host memory and
// are read before the launch returns.
constexpr int kInts = 18;
constexpr int kReals = 9;

// The plan's integers, the cluster plan and the table: 0 or a CUDA error.
template <typename T>
int fill_grid(const void* ptrs, const void* ints, const void* reals, Grid<T>& g, Layout& L,
              Table<T>& tab) {
  const unsigned long long* p = static_cast<const unsigned long long*>(ptrs);
  const int* iv = static_cast<const int*>(ints);
  const double* rv = static_cast<const double*>(reals);
  g.u0 = reinterpret_cast<const T*>(p[0]);
  g.hlp = reinterpret_cast<const T*>(p[1]);
  g.par = reinterpret_cast<const T*>(p[2]);
  g.x = reinterpret_cast<const T*>(p[3]);
  g.info = reinterpret_cast<double*>(p[4]);
  g.out = reinterpret_cast<T*>(p[5]);
  g.gwork = reinterpret_cast<unsigned char*>(p[6]);
  g.buf0 = reinterpret_cast<T*>(p[7]);
  g.buf1 = reinterpret_cast<T*>(p[8]);
  const int N = iv[0], Mc = iv[1], C = iv[2], cyclic = iv[3], wrap = iv[4];
  g.N = N;
  g.Mc = Mc;
  g.C = C;
  g.cyclic = cyclic;
  g.wrap = wrap;
  g.periodic = iv[5];
  tab.n_stages = iv[6];
  if (N < 1 || Mc < 1 || C < 1 || (long)Mc * C * kG != N || tab.n_stages < 1 ||
      tab.n_stages > kMaxStages || (cyclic && !wrap) || (wrap && !cyclic && C < 2))
    return static_cast<int>(cudaErrorInvalidValue);
  L.K = iv[12];
  L.threads = iv[13];
  L.Cc = iv[14];
  L.Nr = iv[15];
  L.smem = iv[16];
  L.gslab = iv[17];
  for (int b = 0; b < kBufs; ++b) {
    L.home[b] = (unsigned char)iv[kInts + kCombos + b];
    L.off[b] = iv[kInts + kCombos + kBufs + b];
    if (L.home[b] > 1 || L.off[b] < 0 || L.off[b] % 16) return static_cast<int>(cudaErrorInvalidValue);
  }
  // K CTAs of Cc chunks each, every one holding at least one; a power of
  // two of threads (the err reduction) of at least 2 S2^2 (the
  // capacitance's Gauss-Jordan)
  if (L.K < 1 || L.K > kMaxCluster || (L.K & (L.K - 1)) || L.Cc < 1 || (long)L.K * L.Cc < C ||
      (long)(L.K - 1) * L.Cc >= C || L.Nr != L.Cc * Mc * kG || L.threads < 2 * kS2 * kS2 ||
      L.threads < 32 || L.threads > kMaxThreads || (L.threads & (L.threads - 1)) || L.smem < 0 ||
      L.smem > kSmemPerCta || L.gslab < 0 || (L.gslab % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < kCombos; ++k) {
    tab.rows[k] = (unsigned char)iv[kInts + k];
    if (k <= tab.n_stages && tab.rows[k] != 1 && tab.rows[k] != 2)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int r = 0; r < 2; ++r)
      for (int j = 0; j < kCols; ++j) {
        const double c = rv[kReals + (k * 2 + r) * kCols + j];
        tab.coef[k][r][j] = T(c);
        tab.role[k][r][j] = c == 0.0 ? tf::kSkip : (c == 1.0 ? tf::kUnit : tf::kScale);
      }
  }
  for (int k = 0; k < kMaxStages; ++k) {
    bool is_u = tab.role[k][0][0] == tf::kUnit;
    for (int j = 1; j < kCols; ++j) is_u = is_u && tab.role[k][0][j] == tf::kSkip;
    tab.is_u[k] = is_u;
  }
  tab.g00 = T(rv[2]);
  return 0;
}

template <typename T>
int fill(const void* ptrs, const void* ints, const void* reals, Work<T>& w, Layout& L,
         Table<T>& tab) {
  const unsigned long long* p = static_cast<const unsigned long long*>(ptrs);
  const int* iv = static_cast<const int*>(ints);
  w.beta_b = reinterpret_cast<const T*>(p[9]);
  w.scale_b = reinterpret_cast<const T*>(p[10]);
  w.idt_b = reinterpret_cast<const T*>(p[11]);
  w.sync = reinterpret_cast<unsigned*>(p[12]);
  w.errs = reinterpret_cast<T*>(p[13]);
  w.snap = reinterpret_cast<T*>(p[14]);
  w.snap_info = reinterpret_cast<double*>(p[15]);
  w.carry = reinterpret_cast<T*>(p[16]);
  w.B = iv[10];
  if (w.B < 1 || iv[11] < 1 || iv[11] > w.B || (w.snap && w.B != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return fill_grid<T>(ptrs, ints, reals, w, L, tab);
}

// The kernel with id kId (a static record per kernel, per device): the
// shared memory opted in only ever grows (a smaller setting would refuse a
// larger plan launched before), and clusters of 16 are allowed once.
template <int kId, typename Kern>
cudaError_t opt_in(Kern fn, int smem, int K) {
  static int set[2][kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= kMaxDevices) return err ? err : cudaErrorInvalidDevice;
  if (smem > set[0][dev]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) set[0][dev] = smem;
  }
  if (err == cudaSuccess && K > 8 && !set[1][dev]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) set[1][dev] = 1;
  }
  return err;
}

cudaLaunchConfig_t config_of(cudaLaunchAttribute* attr, int ncl, const Layout& L, bool coop,
                             cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ncl * L.K);
  cfg.blockDim = dim3(L.threads);
  cfg.dynamicSmemBytes = (size_t)L.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 0;
  if (L.K > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = L.K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.numAttrs = 1;
  } else if (coop) {
    // every CTA resident for the grid barrier: the cooperative launch
    // refuses a grid the card cannot hold at once
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.numAttrs = 1;
  }
  return cfg;
}

// ncl clusters of the kernel kId: 0 or a CUDA error
template <int kId, typename... Exp, typename... Act>
int launch(void (*fn)(Exp...), int ncl, const Layout& L, bool coop, cudaStream_t stream,
           Act&&... args) {
  cudaError_t err = opt_in<kId>(fn, L.smem, L.K);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config_of(attr, ncl, L, coop, stream);
  err = cudaLaunchKernelEx(&cfg, fn, static_cast<Act&&>(args)...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

enum KernelId { kStepMembers = 0, kStepOne = 2, kAdaptive = 4, kScan = 6, kMixed = 8 };

// A layout of one CTA with every buffer in shared memory: the kernels'
// kOne instantiation (built at s <= 2 only: at s = 4 the body spills
// either way, and a second instantiation doubled the library's build)
constexpr bool kOneBody = kS <= 2;

bool one_cta(const Layout& L) {
  if (!kOneBody || L.K != 1) return false;
  for (int b = 0; b < kBufs; ++b)
    if (L.home[b]) return false;
  return true;
}

// Clusters of the kernel kId the card holds at once for the layout;
// negative: a CUDA error
template <int kId, typename... Exp>
int clusters_of(void (*fn)(Exp...), const Layout& L) {
  cudaError_t err = opt_in<kId>(fn, L.smem, L.K);
  int dev = 0, n = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess && L.K == 1) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, L.threads, L.smem);
    n = per_sm * sms;
  } else if (err == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config_of(attr, 1, L, false, nullptr);
    err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// kind 0 step, 1 and 2 adaptive (a shared dt, per member), at the cluster
// plan (K, threads, smem; one: every buffer in shared memory)
template <typename T>
int capacity(int kind, int K, int threads, int smem, int one) {
  Layout L = {};
  L.K = K;
  L.threads = threads;
  L.smem = smem;
  if (K < 1 || K > kMaxCluster || threads < 32 || threads > kMaxThreads || smem < 0 ||
      smem > kSmemPerCta || (one && K != 1))
    return -static_cast<int>(cudaErrorInvalidValue);
  if constexpr (kOneBody) {
    if (one)
      return kind == 0 ? clusters_of<kStepMembers + 1>(step_kernel<T, true, true>, L)
                       : clusters_of<kScan + 1>(scan_kernel<T, true>, L);
  } else if (one) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  return kind == 0 ? clusters_of<kStepMembers>(step_kernel<T, true, false>, L)
                   : clusters_of<kScan>(scan_kernel<T, false>, L);
}

template <typename T>
int step(const void* ptrs, const void* ints, const void* reals, void* stream) {
  Work<T> w = {};
  Layout L = {};
  Table<T> tab = {};
  const int rc = fill<T>(ptrs, ints, reals, w, L, tab);
  if (rc) return rc;
  const int* iv = static_cast<const int*>(ints);
  const double* rv = static_cast<const double*>(reals);
  const int nsteps = iv[7];
  if (nsteps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T beta = T(rv[0]), scale = T(rv[1]);
  if constexpr (kOneBody) {
    if (one_cta(L))
      return w.B > 1 ? launch<kStepMembers + 1>(step_kernel<T, true, true>, iv[11], L, false, s,
                                                w, L, tab, beta, scale, nsteps)
                     : launch<kStepOne + 1>(step_kernel<T, false, true>, 1, L, false, s, w, L,
                                            tab, beta, scale, nsteps);
  }
  return w.B > 1 ? launch<kStepMembers>(step_kernel<T, true, false>, iv[11], L, false, s, w, L,
                                        tab, beta, scale, nsteps)
                 : launch<kStepOne>(step_kernel<T, false, false>, 1, L, false, s, w, L, tab,
                                    beta, scale, nsteps);
}

template <typename T>
int adaptive(const void* ptrs, const void* ints, const void* reals, int per_member, int scan,
             void* stream) {
  Work<T> w = {};
  Layout L = {};
  Table<T> tab = {};
  const int rc = fill<T>(ptrs, ints, reals, w, L, tab);
  if (rc) return rc;
  const int* iv = static_cast<const int*>(ints);
  const double* rv = static_cast<const double*>(reals);
  int nsteps = iv[7];
  const int ncl = iv[11];
  if (tab.rows[tab.n_stages] != 2 || nsteps < 1 || (per_member && !w.idt_b) ||
      (w.snap && (!scan || !w.snap_info)) ||
      (!per_member && ncl > 1 && (!w.sync || !w.errs)) ||
      (!scan && (per_member || w.B != 1 || nsteps != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Ctl<T> ctl;
  ctl.t = T(rv[3]);
  ctl.dt = T(rv[4]);
  ctl.internal_dt = T(rv[5]);
  ctl.tol = T(rv[6]);
  ctl.safety = T(rv[7]);
  ctl.dt_min = T(rv[8]);
  ctl.max_iter = iv[8];
  ctl.has_dt_min = iv[9];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int shared = !per_member;
  // a shared dt over several clusters meets at grid_sync: cooperative
  // where the clusters are single CTAs, else no more clusters than
  // cudaOccupancyMaxActiveClusters holds at once (the caller's ncl)
  const bool coop = shared && ncl > 1;
  if constexpr (kOneBody) {
    // one CTA: the scan kernel also for one grid's output step
    if (one_cta(L))
      return launch<kScan + 1>(scan_kernel<T, true>, ncl, L, coop, s, w, L, tab, ctl, nsteps,
                               shared);
  }
  return scan ? launch<kScan>(scan_kernel<T, false>, ncl, L, coop, s, w, L, tab, ctl, nsteps,
                              shared)
              : launch<kAdaptive>(adaptive_kernel<T>, 1, L, false, s, w, L, tab, ctl);
}

#if TF_MIXED
// ptrs (the first nine of the step entry's), ints and reals as the step
// entry's (B = 1); passes >= 0 residual passes.
int step_mixed(const void* ptrs, const void* ints, const void* reals, int passes,
               void* stream) {
  Grid<double> w = {};
  Layout L = {};
  Table<double> tab = {};
  const int rc = fill_grid<double>(ptrs, ints, reals, w, L, tab);
  if (rc) return rc;
  const int* iv = static_cast<const int*>(ints);
  const double* rv = static_cast<const double*>(reals);
  const int nsteps = iv[7];
  if (nsteps < 1 || passes < 0 || iv[10] != 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (kOneBody) {
    if (one_cta(L))
      return launch<kMixed + 1>(step_mixed_kernel<true>, 1, L, false, s, w, L, tab, rv[0],
                                rv[1], passes, nsteps);
  }
  return launch<kMixed>(step_mixed_kernel<false>, 1, L, false, s, w, L, tab, rv[0], rv[1], passes,
                        nsteps);
}
#endif

}  // namespace

#define TF_ENTRIES(SUFFIX, T)                                                               \
  extern "C" int tf_mega_step_##SUFFIX(const void* ptrs, const void* ints,                 \
                                       const void* reals, void* stream) {                  \
    return step<T>(ptrs, ints, reals, stream);                                             \
  }                                                                                        \
  extern "C" int tf_mega_adaptive_##SUFFIX(const void* ptrs, const void* ints,             \
                                           const void* reals, int per_member, int scan,    \
                                           void* stream) {                                 \
    return adaptive<T>(ptrs, ints, reals, per_member, scan, stream);                       \
  }                                                                                        \
  extern "C" int tf_mega_capacity_##SUFFIX(int kind, int K, int threads, int smem, int one, \
                                           void* stream) {                                 \
    (void)stream;                                                                          \
    return capacity<T>(kind, K, threads, smem, one);                                       \
  }

// a model computes in one dtype: its library carries that dtype's entries;
// a df64 model's mixed library carries the mixed entry alone
#if TF_MIXED
extern "C" int tf_mega_step_mixed_f64(const void* ptrs, const void* ints, const void* reals,
                                      int passes, void* stream) {
  return step_mixed(ptrs, ints, reals, passes, stream);
}
#elif TF_F32
TF_ENTRIES(f32, float)
#else
TF_ENTRIES(f64, double)
#endif
