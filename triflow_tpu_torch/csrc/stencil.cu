// K1: the stencil RHS F and the banded Jacobian J of one model, generated
// per model from its SymPy expressions (ops/stencil.py prints them into
// the block marked GENERATED below) and compiled at first use.  The
// per-node bodies live in stencil.cuh, shared with K6 (megastep.cu).
//
// Replaces, on the TPU: ops/folded.py eval_F_folded (the theta step's
// dt * F and, in its scale/bias mode, the ROW stage right-hand side
// g00 dt F(u_i) + csum) and, for J, ops/folded.py eval_J_folded and ops/pallas_stencil.py
// eval_F / eval_J_bands, which compute the same functions in other layouts.
//
// One thread per node i, in the reference's node layout: u (nvar, N),
// helpers (nhelp, N), parameters (npar, N), x (N,).  The thread gathers the
// argument vector of the expressions (x, every variable at every stencil
// offset, the parameters, dx) with the boundary closure applied to the
// index (periodic: modular; edge: clamped, as compiler.shift does), then
//   F entry: out[m, i] = scale * F_m (+ bias[m, i] when a bias is given;
//            a null bias pointer means none, as add_to in K3)
//   F_terms entry (the reference's u_terms mode, run by its ensemble
//            plans): out[m, i] = scale * F_m(sum_k a_k u_k)
//            + sum_k c_k u_k[m, i] over A <= 8 stage vectors u_k, the ROW
//            stage right-hand side in one pass: the stage input is
//            combined at every stencil point and never written
//            (stencil.cuh has the order of the sums)
//   J entry: bands[k, m, n, i] = dF_m(i) / du_n(i + k - h), shape
//            (W, nvar, nvar, N), with the edge fold of compiler.fold_edges
//            applied on the boundary nodes when not periodic.
// dx = (x[N-1] - x[0]) / (N - 1) is computed in the kernel, so the caller
// never reads the grid back to the host.
//
// Member axis: every entry takes B grids (an ensemble) in one launch, one
// thread per (member, node).  u, helpers, parameters, bias, out and the
// stage vectors lead with B (member b at b times one grid's size), x is
// shared; the F scale is a number, or (scale_b not null) member b's entry
// of a device array, so shared and per-member step sizes take one code.
// One grid (B = 1) launches F and J without member offsets (kMembers).
//
// Bound: a stencil of a few flops per loaded value, so both entries are
// bound by device-memory bandwidth: each reads the (nvar + nhelp) rows W
// times (neighbours hit in L1/L2) and writes nvar (F) or W * nvar^2 (J)
// rows once, all coalesced.  The bias costs one more coalesced read of
// nvar rows, which saves the separate pass of the stage algebra that would
// re-read F and the bias and write the sum.  F_terms reads the A stage
// vectors (W times each, neighbours in L1/L2) and writes the right-hand
// side once: the stage input and its bias sum never reach device memory,
// which saves the combination pass (A reads, two writes) and the biased
// F's two extra reads.
#include "common.cuh"

// ---- GENERATED: model constants and expression bodies ----
// @GENERATED@
// ---- end of generated block ----

#include "stencil.cuh"

namespace {

constexpr int kMaxTerms = 8;

template <typename T>
struct Terms {
  const T* in[kMaxTerms];
  T ca[kMaxTerms], cc[kMaxTerms];
  unsigned char ra[kMaxTerms], rc[kMaxTerms];
  int A;
};

template <typename T, bool kMembers>
__global__ void stencil_F_kernel(const T* __restrict__ u, const T* __restrict__ hlp,
                                 const T* __restrict__ par, const T* __restrict__ x,
                                 const T* __restrict__ bias, T* __restrict__ out,
                                 const T* __restrict__ scale_b, long N, int B, int periodic,
                                 T scale) {
  const long q = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= B * N) return;
  const long b = kMembers ? q / N : 0, i = kMembers ? q % N : q, n = TF_NVAR * N;
  tf::stencil_F_node<T>(u + b * n, hlp + b * TF_NHELP * N, par + b * TF_NPAR * N, x,
                        bias ? bias + b * n : nullptr, out + b * n, N, periodic,
                        scale_b ? scale_b[b] : scale, i);
}

// sum_k c[k] * in[k][at] over the terms of a role table (kSkip terms
// skipped, kUnit ones unmultiplied), in term order, rounded one by one,
// added to acc (or starting the sum when acc_set is false).  The loop runs
// over kMaxTerms with compile-time indices, so every term's address comes
// from the kernel's parameters: indexed at run time, the pointers sat in
// local memory.
template <typename T>
__device__ __forceinline__ T terms_sum(const Terms<T>& terms, const T* c,
                                       const unsigned char* role, long at, T acc,
                                       bool acc_set) {
#pragma unroll
  for (int k = 0; k < kMaxTerms; ++k) {
    if (k >= terms.A || role[k] == tf::kSkip) continue;
    const T v = terms.in[k][at];
    const T t = role[k] == tf::kUnit ? v : tf::mul_rn(c[k], v);
    acc = acc_set ? tf::add_rn(acc, t) : t;
    acc_set = true;
  }
  return acc_set ? acc : T(0);
}

// One block per (tile of kTile nodes, member): the block first combines the
// stage vectors once per node of its tile and halo (the boundary closure
// applied to the index), in shared memory, then every thread evaluates F
// at its node from the tile and adds the bias terms.  Combining at each of
// the W stencil points instead read the A vectors W times per node: 1.5x
// the time of the separate combination and biased F at config 5 (PERF.md).
constexpr int kTile = 256;

template <typename T>
__global__ void __launch_bounds__(kTile)
    stencil_F_terms_kernel(const Terms<T> terms, const T* __restrict__ hlp,
                           const T* __restrict__ par, const T* __restrict__ x,
                           T* __restrict__ out, const T* __restrict__ scale_b, long N,
                           int periodic, T scale) {
  __shared__ T tile[TF_NVAR][kTile + 2 * TF_H];
  const long b = blockIdx.y, i0 = (long)blockIdx.x * kTile, n = TF_NVAR * N;
  for (int t = threadIdx.x; t < kTile + 2 * TF_H; t += kTile) {
    long j = i0 - TF_H + t;
    if (periodic) {
      j %= N;
      if (j < 0) j += N;
    } else {
      j = j < 0 ? 0 : (j > N - 1 ? N - 1 : j);
    }
#pragma unroll
    for (int v = 0; v < TF_NVAR; ++v)
      tile[v][t] = terms_sum(terms, terms.ca, terms.ra, b * n + v * N + j, T(0), false);
  }
  __syncthreads();
  const long i = i0 + threadIdx.x;
  if (i >= N) return;
  T a[TF_NARGS];
  T f[TF_NVAR];
  tf::gather(a, i, N, periodic,
             [&](int v, long, int off) { return tile[v][threadIdx.x + TF_H + off]; },
             hlp + b * TF_NHELP * N, par + b * TF_NPAR * N, x);
  tf_F(a, f);
  const T sc = scale_b ? scale_b[b] : scale;
#pragma unroll
  for (int m = 0; m < TF_NVAR; ++m) {
    const long at = b * n + m * N + i;
    out[at] = terms_sum(terms, terms.cc, terms.rc, at, tf::mul_rn(sc, f[m]), true);
  }
}

template <typename T, bool kMembers>
__global__ void stencil_J_kernel(const T* __restrict__ u, const T* __restrict__ hlp,
                                 const T* __restrict__ par, const T* __restrict__ x,
                                 T* __restrict__ bands, long N, int B, int periodic) {
  const long q = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= B * N) return;
  const long b = kMembers ? q / N : 0, i = kMembers ? q % N : q;
  tf::stencil_J_node<T>(u + b * TF_NVAR * N, hlp + b * TF_NHELP * N, par + b * TF_NPAR * N,
                        x, bands + b * tf::kNJ * N, N, periodic, i);
}

long blocks_of(long n, int threads) { return (n + threads - 1) / threads; }

template <typename T>
int launch_F(const T* u, const T* hlp, const T* par, const T* x, const T* bias, T* out,
             const T* scale_b, long N, int B, int periodic, double scale,
             cudaStream_t stream) {
  const int threads = 256;
  if (B > 1)
    stencil_F_kernel<T, true><<<blocks_of(B * N, threads), threads, 0, stream>>>(
        u, hlp, par, x, bias, out, scale_b, N, B, periodic, T(scale));
  else
    stencil_F_kernel<T, false><<<blocks_of(N, threads), threads, 0, stream>>>(
        u, hlp, par, x, bias, out, scale_b, N, B, periodic, T(scale));
  return static_cast<int>(cudaGetLastError());
}

// in_ptrs: A device addresses; coefs: the A stage-input coefficients, then
// the A bias coefficients (doubles); both in host memory, read before the
// launch returns.  A coefficient's role is decided from its double value,
// as K5 decides it.
template <typename T>
int launch_F_terms(const void* in_ptrs, const void* coefs, const T* hlp, const T* par,
                   const T* x, T* out, const T* scale_b, int A, long N, int B, int periodic,
                   double scale, cudaStream_t stream) {
  if (A < 1 || A > kMaxTerms) return static_cast<int>(cudaErrorInvalidValue);
  Terms<T> terms = {};
  const unsigned long long* ins = static_cast<const unsigned long long*>(in_ptrs);
  const double* c = static_cast<const double*>(coefs);
  auto role = [](double v) { return v == 0.0 ? tf::kSkip : (v == 1.0 ? tf::kUnit : tf::kScale); };
  for (int k = 0; k < A; ++k) {
    terms.in[k] = reinterpret_cast<const T*>(ins[k]);
    terms.ca[k] = T(c[k]);
    terms.cc[k] = T(c[A + k]);
    terms.ra[k] = role(c[k]);
    terms.rc[k] = role(c[A + k]);
  }
  terms.A = A;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  stencil_F_terms_kernel<T><<<dim3(blocks_of(N, kTile), B), kTile, 0, stream>>>(
      terms, hlp, par, x, out, scale_b, N, periodic, T(scale));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_J(const T* u, const T* hlp, const T* par, const T* x, T* bands, long N, int B,
             int periodic, cudaStream_t stream) {
  const int threads = 256;
  if (B > 1)
    stencil_J_kernel<T, true><<<blocks_of(B * N, threads), threads, 0, stream>>>(
        u, hlp, par, x, bands, N, B, periodic);
  else
    stencil_J_kernel<T, false><<<blocks_of(N, threads), threads, 0, stream>>>(
        u, hlp, par, x, bands, N, B, periodic);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define TF_ENTRIES(SUFFIX, T)                                                               \
  extern "C" int tf_stencil_F_##SUFFIX(const void* u, const void* hlp, const void* par,    \
                                       const void* x, const void* bias, void* out,         \
                                       const void* scale_b, int N, int B, int periodic,    \
                                       double scale, void* stream) {                       \
    return launch_F<T>(static_cast<const T*>(u), static_cast<const T*>(hlp),               \
                       static_cast<const T*>(par), static_cast<const T*>(x),               \
                       static_cast<const T*>(bias), static_cast<T*>(out),                  \
                       static_cast<const T*>(scale_b), N, B, periodic, scale,              \
                       static_cast<cudaStream_t>(stream));                                 \
  }                                                                                        \
  extern "C" int tf_stencil_F_terms_##SUFFIX(const void* in_ptrs, const void* coefs,       \
                                             const void* hlp, const void* par,             \
                                             const void* x, void* out, const void* scale_b,\
                                             int A, int N, int B, int periodic,            \
                                             double scale, void* stream) {                 \
    return launch_F_terms<T>(in_ptrs, coefs, static_cast<const T*>(hlp),                   \
                             static_cast<const T*>(par), static_cast<const T*>(x),         \
                             static_cast<T*>(out), static_cast<const T*>(scale_b), A, N,   \
                             B, periodic, scale, static_cast<cudaStream_t>(stream));       \
  }                                                                                        \
  extern "C" int tf_stencil_J_##SUFFIX(const void* u, const void* hlp, const void* par,    \
                                       const void* x, void* bands, int N, int B,           \
                                       int periodic, void* stream) {                       \
    return launch_J<T>(static_cast<const T*>(u), static_cast<const T*>(hlp),               \
                       static_cast<const T*>(par), static_cast<const T*>(x),               \
                       static_cast<T*>(bands), N, B, periodic,                             \
                       static_cast<cudaStream_t>(stream));                                 \
  }

// a model computes in one dtype: its library carries that dtype's entries
#if TF_F32
TF_ENTRIES(f32, float)
#else
TF_ENTRIES(f64, double)
#endif
