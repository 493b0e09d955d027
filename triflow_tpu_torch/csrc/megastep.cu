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
// Two entries; a member (one grid of an ensemble of B; B = 1 for one
// grid) is stepped by ONE thread block of kThreads threads, and the grid
// has nblk = min(B, the blocks the card holds at once) blocks, block k
// taking members k, k + nblk, ...:
//   step:          nsteps >= 1 steps of fixed dt from u0 (beta = -gamma00*dt
//                  or -theta*dt factor shift, scale = the F scale, numbers
//                  or per-member device arrays), writing the last state and
//                  each member's last err;
//   adaptive:      nsteps >= 1 output steps of the clamp-and-recompute
//                  controller of ROW_general._adaptive, run by thread 0 in
//                  the model's type with every product, sum and quotient
//                  rounded as the host rounds it, every output step
//                  re-clamping its starting dt to the output dt and the loop
//                  ending at the first nonzero status; it writes the
//                  accepted state, dt_i, the attempts, the status (1:
//                  max_iter exceeded, 2: dt below its floor) and the output
//                  steps done.  Its caller picks the kernel: adaptive_kernel
//                  (one output step of one grid with a shared dt) or
//                  scan_kernel (everything else), and counts that kernel.
// An ensemble's adaptive steps run scan_kernel in two modes.
// Shared dt (one clock for the ensemble, the reference's shared-dt
// controller): an attempt's err is the max over all members, so every
// attempt ends in a grid-wide barrier (the kernel is launched
// cooperatively, every block resident: an atomic counter, a generation
// word, and the block maxima in a double buffer); each block's thread 0
// then runs the same controller on the same err, so the blocks agree with
// no further traffic.  Per member (per_member_dt): each member's clock,
// dt, attempts and status are its own (the reference's masked per-member
// controller, where a member that reached the output time is frozen), so
// members never wait for each other.  The per-block scratch (bands, factor
// rows, interface operators, stage vectors) is reused by the block's
// members one after the other; the accepted and trial states are kept per
// member.  One grid (B = 1) runs kernels without member offsets
// (kMembers false: the scratch addresses straight from the parameters)
// and its one-output-step adaptive entry its own kernel (adaptive_kernel):
// the member versions cost one grid registers and time (PERF.md).
// A df64 model's mixed library (TF_MIXED, built only where its mixed
// solve runs) has one entry instead, K6's mixed entry (step_mixed, one
// grid): nsteps >= 1 steps of the df64 precision mode's mixed-precision
// stage solve, the reference's row_step_df_folded / theta_step_df_folded
// (ops/megastep.py) on native float64.  Per step: J in double (K1's node
// body), its bands rounded to float, the chunked factor, the PCR factor
// and on a Woodbury plan the closure's set-up in float (the float
// instantiations of factor.cuh and pcr.cuh); per stage the stage sums and
// F in double, the first solve in float on the rounded right-hand side,
// then `passes` times K8's residual body (matvec.cuh's band walk against
// the block's double bands, rounded to float) and a float solve whose
// widened result is added to the stage's double solution; the final
// combination and err in double.  The factor takes the rounded bands of
// J(u), not J of the rounded state: both are float-accurate
// preconditioners, and the residual passes correct against the double
// operator either way.  Its scratch is two slabs, one double and one float.
// It shares one_step's stage sums, final combination and err (stage_sums,
// finish) and the step loop (run_steps).
// One step, in the order of the multi-launch path (K1-K5):
//   1. J at every node (K1's body), the chunked factor of I + beta*J (K2's
//      body, one thread per chunk) and the PCR factor of the interface
//      system (K4's body); on a Woodbury plan (a ring whose chunk count is
//      no power of two >= 8) the closure's set-up (K4's solve body: Z and
//      the capacitance inverse, kept in shared memory);
//   2. per stage: the stage input sum a*u_j and bias sum c*u_j (K5's
//      arithmetic), rhs = scale*F + bias (K1), the chunk sweep (K3), the
//      reduced solve with the Woodbury correction where the plan has one
//      and the shifts (K4) and the spike correction (K3);
//   3. the final combination and err = max|sum (m - mhat)*u_j|, NaN and inf
//      becoming inf.
// Phases are separated by __syncthreads(); threads stride over nodes for F,
// J and the combinations, and over chunks for the sweeps and PCR levels.
// The working set (bands, factor rows, interface operators, stage vectors)
// is global scratch the wrapper allocates; at the sizes the gate admits it
// stays in L2.
//
// Bound: a member's step is a chain of dependent phases on one SM, about
// n_stages * (2 Mc + 2 log2 C) row and level latencies plus the factor's
// Mc rows and log2 C levels, each an L2 round trip; the bytes (a few state
// vectors per stage) and the operations are far below the card's rates at
// these sizes.  The design spends no launch, no host round trip and no
// device-memory round trip between phases; what it leaves on the table is
// the L2 latency of every phase (shared memory would shorten it) and, for
// one grid, the other 131 SMs.
#include <cuda/std/limits>

#include "common.cuh"

// ---- GENERATED: model constants and expression bodies ----
// @GENERATED@
// ---- end of generated block ----

#include "factor.cuh"
#include "matvec.cuh"
#include "pcr.cuh"
#include "stencil.cuh"
#include "sweep.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kG = TF_H > 1 ? TF_H : 1;
constexpr int kS = TF_NVAR * kG;
constexpr int kMaxStages = 6;
constexpr int kCombos = kMaxStages + 1;
constexpr int kCols = kMaxStages + 1;
constexpr int kPtrs = 34;
constexpr int kInfo = 5;  // per member: err, dt_i, attempts, status, output steps done

using tf::add_rn;
using tf::div_rn;
using tf::mul_rn;
using tf::sub_rn;

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
  int N, Mc, C, cyclic, wrap, periodic;
};

template <typename T>
struct Work : Grid<T> {
  const T* beta_b;     // per-member factor shift of the step entry, or null
  const T* scale_b;    // per-member F scale of the step entry, or null
  const T* idt_b;      // per-member starting internal dt (per-member mode)
  unsigned* sync;      // grid barrier: arrivals, generation
  T* errs;             // 2 x nblk block maxima of err (shared mode)
  // block 0's scratch; block k's at k * slab elements further
  T *bands, *fac, *Dhinv, *DU, *Wsp, *Vsp, *Lred, *Ured, *alphas, *betas, *Dinv, *pscr, *Z;
  T *us, *ui, *bias, *rhs, *y, *yred, *xm1, *xp1;
  T *buf0, *buf1;      // accepted and trial states, member m's at m * n
  int B, slab;
};

template <typename T>
struct Ctl {
  T t, dt, internal_dt, tol, safety, dt_min;
  int max_iter, has_dt_min;
};

template <typename T>
using Lim = cuda::std::numeric_limits<T>;

// Stage k's input sum a*u_j into ui (unless the input is u itself) and, with
// rows[k] = 2, its bias sum c*u_j into bias, over the columns (src, us_0,
// ...).  All threads of the block must call it.
template <typename T>
__device__ void stage_sums(const Table<T>& tab, int k, const T* src, const T* us, T* ui,
                           T* bias, long n) {
  const bool with_bias = tab.rows[k] == 2;
  if (tab.is_u[k] && !with_bias) return;
  for (long e = threadIdx.x; e < n; e += kThreads) {
    auto value = [&](int j) { return j == 0 ? src[e] : us[(long)(j - 1) * n + e]; };
    if (!tab.is_u[k])
      ui[e] = tf::lin_comb(k + 1, tab.coef[k][0], tab.role[k][0], value);
    if (with_bias)
      bias[e] = tf::lin_comb(k + 1, tab.coef[k][1], tab.role[k][1], value);
  }
  __syncthreads();
}

// The final combination into dst and the step's err = max|error row|, which
// every thread gets (inf without an error row, and where a term is not
// finite).  All threads of the block must call it.
template <typename T>
__device__ T finish(const Table<T>& tab, const T* src, const T* us, T* dst, long n) {
  __shared__ T s_max[kThreads];
  __shared__ int s_bad;
  const int tid = threadIdx.x;
  const int fin = tab.n_stages;
  const bool with_err = tab.rows[fin] == 2;
  T mx = T(0);
  int bad = 0;
  for (long e = tid; e < n; e += kThreads) {
    auto value = [&](int j) { return j == 0 ? src[e] : us[(long)(j - 1) * n + e]; };
    dst[e] = tf::lin_comb(fin + 1, tab.coef[fin][0], tab.role[fin][0], value);
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
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (tid < off) s_max[tid] = fmax(s_max[tid], s_max[tid + off]);
    __syncthreads();
  }
  const T err = (with_err && !s_bad) ? s_max[0] : Lim<T>::infinity();
  __syncthreads();
  return err;
}

// nsteps steps of one_step(src, dst) from src, between the state buffers
// buf0 and buf1, the last into out: the last step's err.
template <typename T, typename OneStep>
__device__ T run_steps(const T* src, T* out, T* buf0, T* buf1, int nsteps, OneStep one_step) {
  T err = Lim<T>::infinity();
  for (int k = 0; k < nsteps; ++k) {
    T* dst = k == nsteps - 1 ? out : (k % 2 ? buf1 : buf0);
    err = one_step(src, dst);
    src = dst;
  }
  return err;
}

// One step of member m's grid from src to dst; every thread gets err (inf
// without an error row).  All threads of the block must call it.
template <typename T, bool kMembers>
__device__ T one_step(const Work<T>& w, const Table<T>& tab, int m, const T* src, T* dst,
                      T beta, T scale) {
  __shared__ T s_cap_inv[4 * kS * kS];
  const int tid = threadIdx.x;
  const int N = w.N;
  const long n = (long)TF_NVAR * N;
  const bool wood = w.wrap && !w.cyclic;
  const T* hlp = kMembers ? w.hlp + (long)m * TF_NHELP * N : w.hlp;
  const T* par = kMembers ? w.par + (long)m * TF_NPAR * N : w.par;
  // this block's scratch (block 0's for one grid: the parameters as they are)
  const long o = kMembers ? (long)blockIdx.x * w.slab : 0;
  T *bands = w.bands + o, *fac = w.fac + o, *Dhinv = w.Dhinv + o, *DU = w.DU + o;
  T *Wsp = w.Wsp + o, *Vsp = w.Vsp + o, *Lred = w.Lred + o, *Ured = w.Ured + o;
  T *alphas = w.alphas + o, *betas = w.betas + o, *Dinv = w.Dinv + o, *pscr = w.pscr + o;
  T *Z = w.Z + o, *us = w.us + o, *ui = w.ui + o, *bias = w.bias + o, *rhs = w.rhs + o;
  T *y = w.y + o, *yred = w.yred + o, *xm1 = w.xm1 + o, *xp1 = w.xp1 + o;

  for (long i = tid; i < N; i += kThreads)
    tf::stencil_J_node<T>(src, hlp, par, w.x, bands, N, w.periodic, i);
  __syncthreads();
  for (int c = tid; c < w.C; c += kThreads)
    tf::spike_factor_chunk<T, kS>(bands, fac, Dhinv, DU, Wsp, Vsp, Lred, Ured, N, TF_NVAR, kG,
                                  TF_H, w.Mc, w.C, w.wrap, T(1), beta, c);
  __syncthreads();
  tf::pcr_factor_block<T, 2 * kS>(Lred, Ured, alphas, betas, Dinv, pscr, w.C, w.cyclic);
  __syncthreads();
  if (wood) {
    tf::woodbury_block<T, 2 * kS>(alphas, betas, Dinv, Lred, Ured, Z, s_cap_inv, pscr, w.C);
    __syncthreads();
  }

  for (int k = 0; k < tab.n_stages; ++k) {
    stage_sums<T>(tab, k, src, us, ui, bias, n);
    const T* stage_u = tab.is_u[k] ? src : ui;
    for (long i = tid; i < N; i += kThreads)
      tf::stencil_F_node<T>(stage_u, hlp, par, w.x, tab.rows[k] == 2 ? bias : nullptr, rhs,
                            N, w.periodic, scale, i);
    __syncthreads();
    for (int c = tid; c < w.C; c += kThreads)
      tf::thomas_sweep_chunk<T, kS>(fac, Dhinv, DU, rhs, y, yred, N, TF_NVAR, kG, w.Mc, w.C, c);
    __syncthreads();
    if (wood)
      tf::pcr_solve_shift_block<T, 2 * kS, true>(alphas, betas, Dinv, yred, Z, s_cap_inv, xm1,
                                                 xp1, pscr, w.C, w.wrap);
    else
      tf::pcr_solve_shift_block<T, 2 * kS, false>(alphas, betas, Dinv, yred, nullptr, nullptr,
                                                  xm1, xp1, pscr, w.C, w.wrap);
    __syncthreads();
    T* uk = us + (long)k * n;
    for (long i = tid; i < N; i += kThreads)
      tf::spike_correct_node<T, kS>(y, Wsp, Vsp, xm1, xp1, nullptr, uk, N, TF_NVAR, kG, w.Mc,
                                    w.C, i);
    __syncthreads();
  }
  return finish<T>(tab, src, us, dst, n);
}

template <typename T, bool kMembers>
__global__ void __launch_bounds__(kThreads, 1)
    step_kernel(const Work<T> w, const Table<T> tab_in, T beta, T scale, int nsteps) {
  __shared__ Table<T> tab;
  if (threadIdx.x == 0) tab = tab_in;
  __syncthreads();
  const long n = (long)TF_NVAR * w.N;
  for (int m = kMembers ? (int)blockIdx.x : 0; m < (kMembers ? w.B : 1);
       m += kMembers ? gridDim.x : 1) {
    const long at = kMembers ? m * n : 0;
    const T bm = w.beta_b ? w.beta_b[m] : beta;
    const T sm = w.scale_b ? w.scale_b[m] : scale;
    const T err = run_steps<T>(w.u0 + at, w.out + at, w.buf0 + at, w.buf1 + at, nsteps,
                               [&](const T* src, T* dst) {
                                 return one_step<T, kMembers>(w, tab, m, src, dst, bm, sm);
                               });
    if (threadIdx.x == 0) w.info[(long)m * kInfo] = (double)err;
  }
}

// All blocks of a cooperative launch meet here (the kernel's thread 0 of
// every block arrives; the last arrival resets the count and bumps the
// generation the others spin on).
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
// launches, with no member axis): the controller's state in shared memory,
// the accepted and trial states switched by pointer.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    adaptive_kernel(const Work<T> w, const Table<T> tab_in, const Ctl<T> ctl) {
  __shared__ Table<T> tab;
  __shared__ T s_t, s_next_t, s_eps, s_floor, s_dt_i, s_dt_eff;
  __shared__ int s_go, s_accept, s_clamped, s_niter, s_status;
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
    err = one_step<T, false>(w, tab, 0, cur, trial, -gdt, gdt);
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
      cur = trial;
      trial = trial == w.buf0 ? w.buf1 : w.buf0;
    }
  }
  const long n = (long)TF_NVAR * w.N;
  for (long e = tid; e < n; e += kThreads) w.out[e] = cur[e];
  if (tid == 0) {
    w.info[0] = (double)err;
    w.info[1] = (double)s_dt_i;
    w.info[2] = (double)s_niter;
    w.info[3] = (double)s_status;
    w.info[4] = 1.0;
  }
}

// nsteps adaptive output steps of an ensemble.  shared: one clock and dt
// for every member, err the max over all members (blocks agree through
// grid_sync); otherwise each member of the block runs its own clock, dt
// and attempts.
// The mode is a runtime flag: a template parameter doubled the kernel's
// code and the s = 4 library's build time (96 s against 47 s on H100).
// The controller's state lives in shared memory, written by thread 0:
// across a member's step (one_step, the kernel's register peak) only the
// member index and the block's err maximum stay in registers.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    scan_kernel(const Work<T> w, const Table<T> tab_in, const Ctl<T> ctl, int nsteps,
                int shared) {
  __shared__ Table<T> tab;
  __shared__ T s_tout, s_t, s_next_t, s_eps, s_floor, s_dt_i, s_dt_eff, s_err;
  __shared__ int s_go, s_clamped, s_niter, s_total, s_status, s_done, s_cur, s_par;
  const int tid = threadIdx.x;
  if (tid == 0) tab = tab_in;
  // shared: one pass of the controller for all of the block's members
  // (blocks k, k + nblk, ...); otherwise one pass per member
  for (int mm = blockIdx.x; mm < w.B; mm += shared ? w.B : gridDim.x) {
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
      __syncthreads();
      while (s_go) {
        if (tid == 0) {
          const T remaining = sub_rn(s_next_t, s_t);
          s_clamped = s_dt_i >= remaining;
          s_dt_eff = fmin(s_dt_i, remaining);
        }
        __syncthreads();
        T bmax = T(0);
        for (int m = shared ? (int)blockIdx.x : mm; m < w.B; m += shared ? gridDim.x : w.B) {
          const long at = (long)m * TF_NVAR * w.N;
          const T* src = s_cur == 0 ? w.u0 + at : (s_cur == 1 ? w.buf0 : w.buf1) + at;
          T* dst = (s_cur == 1 ? w.buf1 : w.buf0) + at;
          const T gdt = mul_rn(tab.g00, s_dt_eff);
          bmax = fmax(bmax, one_step<T, true>(w, tab, m, src, dst, -gdt, gdt));
        }
        if (shared && gridDim.x > 1) {
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
          if (accept) s_cur = s_cur == 1 ? 2 : 1;
          s_err = err;
          s_go = still && s_status == 0;
        }
        __syncthreads();
      }
      if (tid == 0) {
        s_tout = s_next_t;
        s_total += s_niter;
        s_done += 1;
      }
      __syncthreads();
    }
    for (int m = shared ? (int)blockIdx.x : mm; m < w.B; m += shared ? gridDim.x : w.B) {
      const long at = (long)m * TF_NVAR * w.N;
      const T* src = s_cur == 0 ? w.u0 + at : (s_cur == 1 ? w.buf0 : w.buf1) + at;
      for (long e = tid; e < (long)TF_NVAR * w.N; e += kThreads) w.out[at + e] = src[e];
      if (tid == 0 && (!shared || m == 0)) {
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
}

#if TF_MIXED
// ---- K6's mixed entry (a df64 model's mixed library only) ----
static_assert(!TF_F32, "the mixed entry steps a float64 state");

// The mixed entry's scratch (one grid): the double slab (bands, stage
// solutions, stage input, bias, right-hand side, the states between steps)
// and the float slab (the rounded bands, the factor, the interface
// operators, the solve's vectors).
struct MixedWork : Grid<double> {
  double *bands, *us, *ui, *bias, *rhs, *buf0, *buf1;
  float *bands32, *fac, *Dhinv, *DU, *Wsp, *Vsp, *Lred, *Ured, *alphas, *betas, *Dinv, *pscr,
      *Z, *r32, *y, *yred, *xm1, *xp1, *d32;
  int passes;
};

// One mixed-precision step of the grid from src to dst; every thread gets
// err (inf without an error row).  All threads of the block must call it.
__device__ double one_step_mixed(const MixedWork& w, const Table<double>& tab,
                                 const double* src, double* dst, double beta, double scale) {
  __shared__ float s_cap_inv[4 * kS * kS];
  const int tid = threadIdx.x;
  const int N = w.N;
  const long n = (long)TF_NVAR * N;
  const bool wood = w.wrap && !w.cyclic;
  // the residual's coefficient: the system is I + beta J = I - coef J
  const double coef = -beta;

  // J in double, and the bands the float factor takes: each thread rounds
  // the entries of its own nodes, which it has just written
  for (long i = tid; i < N; i += kThreads) {
    tf::stencil_J_node<double>(src, w.hlp, w.par, w.x, w.bands, N, w.periodic, i);
    for (int e = 0; e < tf::kNJ; ++e) w.bands32[e * N + i] = (float)w.bands[e * N + i];
  }
  __syncthreads();
  for (int c = tid; c < w.C; c += kThreads)
    tf::spike_factor_chunk<float, kS>(w.bands32, w.fac, w.Dhinv, w.DU, w.Wsp, w.Vsp, w.Lred,
                                      w.Ured, N, TF_NVAR, kG, TF_H, w.Mc, w.C, w.wrap, 1.0f,
                                      (float)beta, c);
  __syncthreads();
  tf::pcr_factor_block<float, 2 * kS>(w.Lred, w.Ured, w.alphas, w.betas, w.Dinv, w.pscr, w.C,
                                      w.cyclic);
  __syncthreads();
  if (wood) {
    tf::woodbury_block<float, 2 * kS>(w.alphas, w.betas, w.Dinv, w.Lred, w.Ured, w.Z, s_cap_inv,
                                      w.pscr, w.C);
    __syncthreads();
  }

  for (int k = 0; k < tab.n_stages; ++k) {
    stage_sums<double>(tab, k, src, w.us, w.ui, w.bias, n);
    const double* stage_u = tab.is_u[k] ? src : w.ui;
    double* uk = w.us + (long)k * n;
    // rhs = scale F + bias in double; the first solve takes its rounding
    for (long i = tid; i < N; i += kThreads) {
      tf::stencil_F_node<double>(stage_u, w.hlp, w.par, w.x, tab.rows[k] == 2 ? w.bias : nullptr,
                                 w.rhs, N, w.periodic, scale, i);
      for (int m = 0; m < TF_NVAR; ++m) w.r32[m * N + i] = (float)w.rhs[m * N + i];
    }
    __syncthreads();
    for (int pass = 0; pass <= w.passes; ++pass) {
      if (pass > 0) {
        // K8's residual body: float((rhs - k) + coef * J k) against the
        // double bands
        for (long i = tid; i < N; i += kThreads)
          for (int m = 0; m < TF_NVAR; ++m) {
            const long e = (long)m * N + i;
            const double Jk = tf::band_row(w.bands, uk, tf::kW, TF_NVAR, N, w.periodic, i, m);
            w.r32[e] = (float)((w.rhs[e] - uk[e]) + coef * Jk);
          }
        __syncthreads();
      }
      for (int c = tid; c < w.C; c += kThreads)
        tf::thomas_sweep_chunk<float, kS>(w.fac, w.Dhinv, w.DU, w.r32, w.y, w.yred, N, TF_NVAR,
                                          kG, w.Mc, w.C, c);
      __syncthreads();
      if (wood)
        tf::pcr_solve_shift_block<float, 2 * kS, true>(w.alphas, w.betas, w.Dinv, w.yred, w.Z,
                                                       s_cap_inv, w.xm1, w.xp1, w.pscr, w.C,
                                                       w.wrap);
      else
        tf::pcr_solve_shift_block<float, 2 * kS, false>(w.alphas, w.betas, w.Dinv, w.yred,
                                                        nullptr, nullptr, w.xm1, w.xp1, w.pscr,
                                                        w.C, w.wrap);
      __syncthreads();
      // the float correction, widened into the stage's double solution by
      // the thread that wrote it
      for (long i = tid; i < N; i += kThreads) {
        tf::spike_correct_node<float, kS>(w.y, w.Wsp, w.Vsp, w.xm1, w.xp1, nullptr, w.d32, N,
                                          TF_NVAR, kG, w.Mc, w.C, i);
        for (int m = 0; m < TF_NVAR; ++m) {
          const long e = (long)m * N + i;
          uk[e] = pass == 0 ? (double)w.d32[e] : uk[e] + (double)w.d32[e];
        }
      }
      __syncthreads();
    }
  }
  return finish<double>(tab, src, w.us, dst, n);
}

__global__ void __launch_bounds__(kThreads, 1)
    step_mixed_kernel(const MixedWork w, const Table<double> tab_in, double beta, double scale,
                      int nsteps) {
  __shared__ Table<double> tab;
  if (threadIdx.x == 0) tab = tab_in;
  __syncthreads();
  const double err = run_steps<double>(w.u0, w.out, w.buf0, w.buf1, nsteps,
                                       [&](const double* src, double* dst) {
                                         return one_step_mixed(w, tab, src, dst, beta, scale);
                                       });
  if (threadIdx.x == 0) w.info[0] = err;
}
#endif

// ptrs (kPtrs device addresses, in the order of Work: block 0's scratch),
// ints (N, Mc, C, cyclic, wrap, periodic, n_stages, nsteps, max_iter (-1:
// none), has_dt_min, B, nblk, slab, then the rows of the kCombos
// combinations) and reals (beta, scale, g00, t, dt, internal_dt, tol,
// safety, dt_min, then the kCombos x 2 x kCols coefficients
// [combination][row][column]) live in host memory and are read before the
// launch returns.
constexpr int kInts = 13;
constexpr int kReals = 9;

template <typename T>
int fill_table(const void* ints, const void* reals, Table<T>& tab);

// The operands (the first six addresses, in the order of Grid), the plan's
// integers and the table: 0 or a CUDA error.
template <typename T>
int fill_grid(const void* ptrs, const void* ints, const void* reals, Grid<T>& g,
              Table<T>& tab) {
  const unsigned long long* p = static_cast<const unsigned long long*>(ptrs);
  const int* iv = static_cast<const int*>(ints);
  g.u0 = reinterpret_cast<const T*>(p[0]);
  g.hlp = reinterpret_cast<const T*>(p[1]);
  g.par = reinterpret_cast<const T*>(p[2]);
  g.x = reinterpret_cast<const T*>(p[3]);
  g.info = reinterpret_cast<double*>(p[4]);
  g.out = reinterpret_cast<T*>(p[5]);
  g.N = iv[0];
  g.Mc = iv[1];
  g.C = iv[2];
  g.cyclic = iv[3];
  g.wrap = iv[4];
  g.periodic = iv[5];
  return fill_table<T>(ints, reals, tab);
}

template <typename T>
int fill(const void* ptrs, const void* ints, const void* reals, Work<T>& w, Table<T>& tab) {
  const unsigned long long* p = static_cast<const unsigned long long*>(ptrs);
  const int* iv = static_cast<const int*>(ints);
  w.beta_b = reinterpret_cast<const T*>(p[6]);
  w.scale_b = reinterpret_cast<const T*>(p[7]);
  w.idt_b = reinterpret_cast<const T*>(p[8]);
  w.sync = reinterpret_cast<unsigned*>(p[9]);
  w.errs = reinterpret_cast<T*>(p[10]);
  T** slots[] = {&w.bands, &w.fac, &w.Dhinv, &w.DU, &w.Wsp, &w.Vsp, &w.Lred,
                 &w.Ured, &w.alphas, &w.betas, &w.Dinv, &w.pscr, &w.Z, &w.us,
                 &w.ui, &w.bias, &w.rhs, &w.y, &w.yred, &w.xm1, &w.xp1, &w.buf0, &w.buf1};
  for (int k = 0; k < kPtrs - 11; ++k) *slots[k] = reinterpret_cast<T*>(p[11 + k]);
  w.B = iv[10];
  w.slab = iv[12];
  if (w.B < 1 || iv[11] < 1 || iv[11] > w.B) return static_cast<int>(cudaErrorInvalidValue);
  return fill_grid<T>(ptrs, ints, reals, w, tab);
}

// The plan's integers and the table, as fill_grid reads them: 0 or a CUDA
// error.
template <typename T>
int fill_table(const void* ints, const void* reals, Table<T>& tab) {
  const int* iv = static_cast<const int*>(ints);
  const double* rv = static_cast<const double*>(reals);
  const int N = iv[0], Mc = iv[1], C = iv[2], cyclic = iv[3], wrap = iv[4];
  tab.n_stages = iv[6];
  if (N < 1 || Mc < 1 || C < 1 || (long)Mc * C * kG != N || tab.n_stages < 1 ||
      tab.n_stages > kMaxStages || (cyclic && !wrap) || (wrap && !cyclic && C < 2))
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

// Blocks of each kernel the card holds at once (its SMs times the blocks
// per SM): kind 0 step, 1 and 2 adaptive (a shared dt, per member);
// negative: a CUDA error.
template <typename T>
int capacity(int kind) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    if (kind == 0)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, step_kernel<T, true>,
                                                        kThreads, 0);
    else
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scan_kernel<T>, kThreads, 0);
  }
  return e == cudaSuccess ? per_sm * sms : -static_cast<int>(e);
}

template <typename T>
int step(const void* ptrs, const void* ints, const void* reals, void* stream) {
  Work<T> w = {};
  Table<T> tab = {};
  const int rc = fill<T>(ptrs, ints, reals, w, tab);
  if (rc) return rc;
  const int* iv = static_cast<const int*>(ints);
  const double* rv = static_cast<const double*>(reals);
  const int nsteps = iv[7];
  if (nsteps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w.B > 1)
    step_kernel<T, true><<<iv[11], kThreads, 0, s>>>(w, tab, T(rv[0]), T(rv[1]), nsteps);
  else
    step_kernel<T, false><<<1, kThreads, 0, s>>>(w, tab, T(rv[0]), T(rv[1]), nsteps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int adaptive(const void* ptrs, const void* ints, const void* reals, int per_member, int scan,
             void* stream) {
  Work<T> w = {};
  Table<T> tab = {};
  const int rc = fill<T>(ptrs, ints, reals, w, tab);
  if (rc) return rc;
  const int* iv = static_cast<const int*>(ints);
  const double* rv = static_cast<const double*>(reals);
  int nsteps = iv[7];
  const int nblk = iv[11];
  if (tab.rows[tab.n_stages] != 2 || nsteps < 1 || (per_member && !w.idt_b) ||
      (!per_member && nblk > 1 && (!w.sync || !w.errs)) ||
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
  int shared = !per_member;
  if (!scan) {
    adaptive_kernel<T><<<1, kThreads, 0, s>>>(w, tab, ctl);
  } else if (!shared || nblk == 1) {
    scan_kernel<T><<<nblk, kThreads, 0, s>>>(w, tab, ctl, nsteps, shared);
  } else {
    // every block must be resident for the grid barrier: the cooperative
    // launch refuses a grid the card cannot hold at once
    void* args[] = {&w, &tab, &ctl, &nsteps, &shared};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(scan_kernel<T>), dim3(nblk), dim3(kThreads), args, 0, s));
  }
  return static_cast<int>(cudaGetLastError());
}

#if TF_MIXED
// ptrs (6 + 7 + 19 device addresses, in the order of MixedWork), ints and
// reals as the step entry's (B = 1); passes >= 0 residual passes.
int step_mixed(const void* ptrs, const void* ints, const void* reals, int passes,
               void* stream) {
  MixedWork w = {};
  Table<double> tab = {};
  const int rc = fill_grid<double>(ptrs, ints, reals, w, tab);
  if (rc) return rc;
  const unsigned long long* p = static_cast<const unsigned long long*>(ptrs);
  const int* iv = static_cast<const int*>(ints);
  const double* rv = static_cast<const double*>(reals);
  double** dslots[] = {&w.bands, &w.us, &w.ui, &w.bias, &w.rhs, &w.buf0, &w.buf1};
  for (int k = 0; k < 7; ++k) *dslots[k] = reinterpret_cast<double*>(p[6 + k]);
  float** fslots[] = {&w.bands32, &w.fac, &w.Dhinv, &w.DU, &w.Wsp, &w.Vsp, &w.Lred,
                      &w.Ured, &w.alphas, &w.betas, &w.Dinv, &w.pscr, &w.Z, &w.r32,
                      &w.y, &w.yred, &w.xm1, &w.xp1, &w.d32};
  for (int k = 0; k < 19; ++k) *fslots[k] = reinterpret_cast<float*>(p[13 + k]);
  w.passes = passes;
  const int nsteps = iv[7];
  if (nsteps < 1 || passes < 0 || iv[10] != 1) return static_cast<int>(cudaErrorInvalidValue);
  step_mixed_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(w, tab, rv[0], rv[1],
                                                                            nsteps);
  return static_cast<int>(cudaGetLastError());
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
  extern "C" int tf_mega_capacity_##SUFFIX(int kind, void* stream) {                       \
    (void)stream;                                                                          \
    return capacity<T>(kind);                                                              \
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
