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
// Two entries, each ONE thread block of kThreads threads:
//   step:     nsteps >= 1 steps of fixed dt from u0 (beta = -gamma00*dt or
//             -theta*dt factor shift, scale = the F scale), writing the last
//             state and the last step's err;
//   adaptive: one output step of the clamp-and-recompute controller of
//             ROW_general._adaptive, run by thread 0 in the model's type
//             with every product, sum and quotient rounded as the host
//             rounds it; it writes the accepted state, dt_i, the attempts
//             and the status (1: max_iter exceeded, 2: dt below its floor).
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
// Bound: a step is a chain of dependent phases on one SM, about
// n_stages * (2 Mc + 2 log2 C) row and level latencies plus the factor's
// Mc rows and log2 C levels, each an L2 round trip; the bytes (a few state
// vectors per stage) and the operations are far below the card's rates at
// these sizes.  The design spends no launch, no host round trip and no
// device-memory round trip between phases; what it leaves on the table is
// the L2 latency of every phase (shared memory would shorten it) and the
// other 131 SMs.
#include <cuda/std/limits>

#include "common.cuh"

// ---- GENERATED: model constants and expression bodies ----
// @GENERATED@
// ---- end of generated block ----

#include "factor.cuh"
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
constexpr int kPtrs = 29;

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
  T g00;  // the adaptive entry's factor shift is -g00 * dt
};

template <typename T>
struct Work {
  const T* u0;
  const T* hlp;
  const T* par;
  const T* x;
  T* out;
  double* info;  // err, dt_i, attempts, status
  T *bands, *fac, *Dhinv, *DU, *Wsp, *Vsp, *Lred, *Ured, *alphas, *betas, *Dinv, *pscr, *Z;
  T *us, *ui, *bias, *rhs, *y, *yred, *xm1, *xp1, *buf0, *buf1;
  int N, Mc, C, cyclic, wrap, periodic;
};

template <typename T>
struct Ctl {
  T t, dt, internal_dt, tol, safety, dt_min;
  int max_iter, has_dt_min;
};

template <typename T>
using Lim = cuda::std::numeric_limits<T>;

// One step from src to dst; every thread gets err (inf without an error
// row).  All threads of the block must call it.
template <typename T>
__device__ T one_step(const Work<T>& w, const Table<T>& tab, const T* src, T* dst, T beta,
                      T scale) {
  __shared__ T s_max[kThreads];
  __shared__ T s_cap_inv[4 * kS * kS];
  __shared__ int s_bad;
  const int tid = threadIdx.x;
  const int N = w.N;
  const long n = (long)TF_NVAR * N;
  const bool wood = w.wrap && !w.cyclic;

  for (long i = tid; i < N; i += kThreads)
    tf::stencil_J_node<T>(src, w.hlp, w.par, w.x, w.bands, N, w.periodic, i);
  __syncthreads();
  for (int c = tid; c < w.C; c += kThreads)
    tf::spike_factor_chunk<T, kS>(w.bands, w.fac, w.Dhinv, w.DU, w.Wsp, w.Vsp, w.Lred,
                                  w.Ured, N, TF_NVAR, kG, TF_H, w.Mc, w.C, w.wrap, T(1),
                                  beta, c);
  __syncthreads();
  tf::pcr_factor_block<T, 2 * kS>(w.Lred, w.Ured, w.alphas, w.betas, w.Dinv, w.pscr, w.C,
                                  w.cyclic);
  __syncthreads();
  if (wood) {
    tf::woodbury_block<T, 2 * kS>(w.alphas, w.betas, w.Dinv, w.Lred, w.Ured, w.Z, s_cap_inv,
                                  w.pscr, w.C);
    __syncthreads();
  }

  for (int k = 0; k < tab.n_stages; ++k) {
    const bool with_bias = tab.rows[k] == 2;
    if (!tab.is_u[k] || with_bias) {
      for (long e = tid; e < n; e += kThreads) {
        auto value = [&](int j) { return j == 0 ? src[e] : w.us[(long)(j - 1) * n + e]; };
        if (!tab.is_u[k]) w.ui[e] = tf::lin_comb(k + 1, tab.coef[k][0], tab.role[k][0], value);
        if (with_bias) w.bias[e] = tf::lin_comb(k + 1, tab.coef[k][1], tab.role[k][1], value);
      }
      __syncthreads();
    }
    const T* stage_u = tab.is_u[k] ? src : w.ui;
    for (long i = tid; i < N; i += kThreads)
      tf::stencil_F_node<T>(stage_u, w.hlp, w.par, w.x, with_bias ? w.bias : nullptr, w.rhs,
                            N, w.periodic, scale, i);
    __syncthreads();
    for (int c = tid; c < w.C; c += kThreads)
      tf::thomas_sweep_chunk<T, kS>(w.fac, w.Dhinv, w.DU, w.rhs, w.y, w.yred, N, TF_NVAR, kG,
                                    w.Mc, w.C, c);
    __syncthreads();
    if (wood)
      tf::pcr_solve_shift_block<T, 2 * kS, true>(w.alphas, w.betas, w.Dinv, w.yred, w.Z,
                                                 s_cap_inv, w.xm1, w.xp1, w.pscr, w.C, w.wrap);
    else
      tf::pcr_solve_shift_block<T, 2 * kS, false>(w.alphas, w.betas, w.Dinv, w.yred, nullptr,
                                                  nullptr, w.xm1, w.xp1, w.pscr, w.C, w.wrap);
    __syncthreads();
    T* uk = w.us + (long)k * n;
    for (long i = tid; i < N; i += kThreads)
      tf::spike_correct_node<T, kS>(w.y, w.Wsp, w.Vsp, w.xm1, w.xp1, nullptr, uk, N, TF_NVAR,
                                    kG, w.Mc, w.C, i);
    __syncthreads();
  }

  const int fin = tab.n_stages;
  const bool with_err = tab.rows[fin] == 2;
  T m = T(0);
  int bad = 0;
  for (long e = tid; e < n; e += kThreads) {
    auto value = [&](int j) { return j == 0 ? src[e] : w.us[(long)(j - 1) * n + e]; };
    dst[e] = tf::lin_comb(fin + 1, tab.coef[fin][0], tab.role[fin][0], value);
    if (with_err) {
      const T d = fabs(tf::lin_comb(fin + 1, tab.coef[fin][1], tab.role[fin][1], value));
      // fmax drops NaN: a non-finite term is flagged on its own
      if (isfinite(d))
        m = fmax(m, d);
      else
        bad = 1;
    }
  }
  if (tid == 0) s_bad = 0;
  s_max[tid] = m;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    step_kernel(const Work<T> w, const Table<T> tab_in, T beta, T scale, int nsteps) {
  __shared__ Table<T> tab;
  if (threadIdx.x == 0) tab = tab_in;
  __syncthreads();
  const T* src = w.u0;
  T err = Lim<T>::infinity();
  for (int k = 0; k < nsteps; ++k) {
    T* dst = k == nsteps - 1 ? w.out : (k % 2 ? w.buf1 : w.buf0);
    err = one_step(w, tab, src, dst, beta, scale);
    src = dst;
  }
  if (threadIdx.x == 0) w.info[0] = (double)err;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
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
    err = one_step(w, tab, cur, trial, -gdt, gdt);
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
  }
}

// ptrs (kPtrs device addresses, in the order of Work), ints (N, Mc, C,
// cyclic, wrap, periodic, n_stages, nsteps, max_iter (-1: none),
// has_dt_min, then the rows of the kCombos combinations) and reals (beta, scale, g00, t, dt,
// internal_dt, tol, safety, dt_min, then the kCombos x 2 x kCols
// coefficients [combination][row][column]) live in host memory and are
// read before the launch returns.
template <typename T>
int fill(const void* ptrs, const void* ints, const void* reals, Work<T>& w, Table<T>& tab) {
  const unsigned long long* p = static_cast<const unsigned long long*>(ptrs);
  const int* iv = static_cast<const int*>(ints);
  const double* rv = static_cast<const double*>(reals);
  T** slots[] = {&w.out, &w.bands, &w.fac, &w.Dhinv, &w.DU, &w.Wsp, &w.Vsp, &w.Lred,
                 &w.Ured, &w.alphas, &w.betas, &w.Dinv, &w.pscr, &w.Z, &w.us, &w.ui,
                 &w.bias, &w.rhs, &w.y, &w.yred, &w.xm1, &w.xp1, &w.buf0, &w.buf1};
  w.u0 = reinterpret_cast<const T*>(p[0]);
  w.hlp = reinterpret_cast<const T*>(p[1]);
  w.par = reinterpret_cast<const T*>(p[2]);
  w.x = reinterpret_cast<const T*>(p[3]);
  w.info = reinterpret_cast<double*>(p[4]);
  for (int k = 0; k < kPtrs - 5; ++k) *slots[k] = reinterpret_cast<T*>(p[5 + k]);
  w.N = iv[0];
  w.Mc = iv[1];
  w.C = iv[2];
  w.cyclic = iv[3];
  w.wrap = iv[4];
  w.periodic = iv[5];
  tab.n_stages = iv[6];
  if (w.N < 1 || w.Mc < 1 || w.C < 1 || (long)w.Mc * w.C * kG != w.N || tab.n_stages < 1 ||
      tab.n_stages > kMaxStages || (w.cyclic && !w.wrap) || (w.wrap && !w.cyclic && w.C < 2))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < kCombos; ++k) {
    tab.rows[k] = (unsigned char)iv[10 + k];
    if (k <= tab.n_stages && tab.rows[k] != 1 && tab.rows[k] != 2)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int r = 0; r < 2; ++r)
      for (int j = 0; j < kCols; ++j) {
        const double c = rv[9 + (k * 2 + r) * kCols + j];
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
int step(const void* ptrs, const void* ints, const void* reals, void* stream) {
  Work<T> w = {};
  Table<T> tab = {};
  const int rc = fill<T>(ptrs, ints, reals, w, tab);
  if (rc) return rc;
  const int* iv = static_cast<const int*>(ints);
  const double* rv = static_cast<const double*>(reals);
  const int nsteps = iv[7];
  if (nsteps < 1) return static_cast<int>(cudaErrorInvalidValue);
  step_kernel<T><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(w, tab, T(rv[0]),
                                                                        T(rv[1]), nsteps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int adaptive(const void* ptrs, const void* ints, const void* reals, void* stream) {
  Work<T> w = {};
  Table<T> tab = {};
  const int rc = fill<T>(ptrs, ints, reals, w, tab);
  if (rc) return rc;
  const int* iv = static_cast<const int*>(ints);
  const double* rv = static_cast<const double*>(reals);
  if (tab.rows[tab.n_stages] != 2) return static_cast<int>(cudaErrorInvalidValue);
  Ctl<T> ctl;
  ctl.t = T(rv[3]);
  ctl.dt = T(rv[4]);
  ctl.internal_dt = T(rv[5]);
  ctl.tol = T(rv[6]);
  ctl.safety = T(rv[7]);
  ctl.dt_min = T(rv[8]);
  ctl.max_iter = iv[8];
  ctl.has_dt_min = iv[9];
  adaptive_kernel<T><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(w, tab, ctl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define TF_ENTRIES(SUFFIX, T)                                                               \
  extern "C" int tf_mega_step_##SUFFIX(const void* ptrs, const void* ints,                 \
                                       const void* reals, void* stream) {                  \
    return step<T>(ptrs, ints, reals, stream);                                             \
  }                                                                                        \
  extern "C" int tf_mega_adaptive_##SUFFIX(const void* ptrs, const void* ints,             \
                                           const void* reals, void* stream) {              \
    return adaptive<T>(ptrs, ints, reals, stream);                                         \
  }

TF_ENTRIES(f32, float)
TF_ENTRIES(f64, double)
