// K1: the stencil RHS F and the banded Jacobian J of one model, generated
// per model from its SymPy expressions (ops/stencil.py prints them into
// the block marked GENERATED below) and compiled at first use.  The
// per-node bodies live in stencil.cuh, shared with K6 (megastep.cu).
//
// Replaces, on the TPU: ops/folded.py:469 eval_F_folded (the theta step's
// dt * F and, in its scale/bias mode, the ROW stage right-hand side
// g00 dt F(u_i) + csum), ops/folded.py:667 eval_J_folded (J), and
// ops/pallas_stencil.py:180 eval_F / :203 eval_J_bands, which compute the
// same functions in other layouts.
//
// In the reference's node layout: u (nvar, N), helpers (nhelp, N),
// parameters (npar, N), x (N,).  Each node's argument vector of the
// expressions holds x, every variable and helper at every stencil offset,
// the parameters and dx, with the boundary closure applied to the index
// (periodic: modular; edge: clamped, as compiler.shift does).  Every entry
// reads each row's span once, coalesced, the closure applied to the halo's
// indices only: F and F_terms take a block per tile of nodes, which loads
// the tile and its halo into shared memory, and every thread gathers from
// there; J takes a warp per 32 nodes, whose lanes exchange the span by
// shuffles (below):
//   F entry: out[m, i] = scale * F_m (+ bias[m, i] when a bias is given;
//            a null bias pointer means none, as add_to in K3)
//   F_terms entry (the reference's u_terms mode, run by its ensemble
//            plans): out[m, i] = scale * F_m(sum_k a_k u_k)
//            + sum_k c_k u_k[m, i] over A <= 8 stage vectors u_k, the ROW
//            stage right-hand side in one pass: the stage input is
//            combined once per node of the tile and never written
//            (terms_sum has the order of the sums)
//   J entry: bands[k, m, n, i] = dF_m(i) / du_n(i + k - h), shape
//            (W, nvar, nvar, N), with the edge fold of compiler.fold_edges
//            applied on the boundary nodes when not periodic.
// dx = (x[N-1] - x[0]) / (N - 1) is computed in the kernel, so the caller
// never reads the grid back to the host.  F and F_terms evaluate the same
// expression on the same operands as a gather from device memory would.
//
// Member axis: every entry takes B grids (an ensemble) in one launch, the
// member along the grid's y (F and F_terms: B <= 65535; J any B, a block
// going on to member b + 65535 past the grid's y).  u, helpers,
// parameters, bias, out and the stage vectors lead with B (member b at b
// times one grid's size), x is shared; the F scale is a number, or
// (scale_b not null) member b's entry of a device array, so shared and
// per-member step sizes take one code.  The per-node bodies of F and J
// (K6's, stencil.cuh) stay as entries of their own on no path
// (tf_stencil_F_nodes_*, tf_stencil_J_nodes_*), which the kernel checks
// hold the tiled entries to bit for bit.
//
// Bound: a stencil of a few flops per loaded value, so every entry is
// bound by device-memory bandwidth: each reads the (nvar + nhelp + npar)
// rows and x once (and 2h halo nodes a tile more) and writes nvar (F) or
// W nvar^2 (J) rows once, all coalesced.  J writes the most: at KS N =
// 2^20 (W = 5, nvar 1) 5 rows of bands beside 2 rows read, 58.7 MB in
// float64, 17.5 us at the H100's 3.35 TB/s (NVIDIA H100 80GB HBM3, 700 W
// power limit; PERF.md); at config 5 (B = 1024 KS members at N = 10^5)
// 4.1 GB of bands, about 1.2 ms.  The per-node J gathered W stencil points
// of every row from device memory through L1 and paid a 64-bit division
// per point on a ring, one per node for its member and dx's per node; the
// warp-tiled J reads each span once, closes only the halo's indices and
// divides once a warp.
// The bias costs one more coalesced read of nvar rows, which saves the
// separate pass of the stage algebra that would re-read F and the bias
// and write the sum.  F_terms reads the A stage vectors once and writes
// the right-hand side once: the stage input and its bias sum never reach
// device memory, which saves the combination pass (A reads, two writes)
// and the biased F's two extra reads.
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

// The F entries (F and F_terms): one block per (tile of kTile nodes,
// member), member blockIdx.y, a node a thread.  The block loads its tile and
// the h halo nodes on each side of every variable and helper into shared
// memory, once and coalesced, the boundary closure applied to the halo's
// indices only (close_index), and each thread its node's x and parameters
// into registers before the block's barrier, so that their loads are in
// flight with the tile's; then every thread gathers its node's arguments
// from the tiles (gather_tile: stencil.cuh's gather order, the same
// operands) and evaluates F.  A thread per node gathering from device
// memory paid a 64-bit division per stencil point on a ring (and one per
// node for its member), more than the copy.  (Two nodes a thread with the
// bias read ahead, its sum rounded apart, took 6-12 % less at KS 2^20 but
// 18 % more on the film, whose per-node body fuses that sum: off its bits;
// PERF.md.)
constexpr int kTile = 256;
constexpr int kSpan = kTile + 2 * TF_H;
constexpr int kHelpRows = TF_NHELP > 0 ? TF_NHELP : 1;
constexpr int kParRows = TF_NPAR > 0 ? TF_NPAR : 1;

// Node j of a tile's span under the boundary closure: j itself inside the
// grid; periodic, j -+ N (a compare and an add where h < N; the loops
// serve grids of fewer nodes than the halo); edge, clamped.  The node
// stencil.cuh's gather takes (j % N, or the clamp), without a division.
__device__ __forceinline__ long close_index(long j, long N, int periodic) {
  if (j >= 0 && j < N) return j;
  if (!periodic) return j < 0 ? 0 : N - 1;
  while (j < 0) j += N;
  while (j >= N) j -= N;
  return j;
}

// The argument vector of the node at tile position lt in stencil.cuh's
// gather order: x and the parameters at the node (xi, pi) and dx, read
// before the block's barrier, the variables and helpers from the tiles
template <typename T>
__device__ __forceinline__ void gather_tile(T* a, int lt, const T (*tu)[kSpan],
                                            const T (*th)[kSpan], T xi, const T* pi, T dx) {
  int idx = 0;
  a[idx++] = xi;
#pragma unroll
  for (int off = -TF_H; off <= TF_H; ++off) {
#pragma unroll
    for (int v = 0; v < TF_NVAR; ++v) a[idx++] = tu[v][lt + TF_H + off];
#pragma unroll
    for (int v = 0; v < TF_NHELP; ++v) a[idx++] = th[v][lt + TF_H + off];
  }
#pragma unroll
  for (int q = 0; q < TF_NPAR; ++q) a[idx++] = pi[q];
  a[idx] = dx;
}

// A block's loads: its span (its nodes in the grid and h halo nodes on each
// side) of the variables (load(v, j): variable v at node j) and helpers
// into the tiles, and the thread's node's x and parameters into xi / pi;
// dx = (x[N-1] - x[0]) / (N - 1) once, by thread 0, into s_dx (the same
// division every thread of the per-node body makes)
template <typename T, typename Load>
__device__ __forceinline__ void load_tiles(T (*tu)[kSpan], T (*th)[kSpan], T* s_dx, long i0,
                                           long N, int periodic, Load load, const T* hlp,
                                           const T* par, const T* x, T& xi, T* pi) {
  const long i = i0 + threadIdx.x;
  if (i < N) {
    xi = x[i];
#pragma unroll
    for (int q = 0; q < TF_NPAR; ++q) pi[q] = par[q * N + i];
  }
  if (threadIdx.x == 0) *s_dx = (x[N - 1] - x[0]) / T(N - 1);
  const int span = (int)(N - i0 < kTile ? N - i0 : kTile) + 2 * TF_H;
  for (int t = threadIdx.x; t < span; t += kTile) {
    const long j = close_index(i0 - TF_H + t, N, periodic);
#pragma unroll
    for (int v = 0; v < TF_NVAR; ++v) tu[v][t] = load(v, j);
#pragma unroll
    for (int v = 0; v < TF_NHELP; ++v) th[v][t] = hlp[v * N + j];
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kTile)
    stencil_F_kernel(const T* __restrict__ u, const T* __restrict__ hlp,
                     const T* __restrict__ par, const T* __restrict__ x,
                     const T* __restrict__ bias, T* __restrict__ out,
                     const T* __restrict__ scale_b, long N, int periodic, T scale) {
  __shared__ T tu[TF_NVAR][kSpan];
  __shared__ T th[kHelpRows][kSpan];
  __shared__ T s_dx;
  const long b = blockIdx.y, i0 = (long)blockIdx.x * kTile, n = TF_NVAR * N;
  u += b * n;
  T xi = T(0), pi[kParRows];
  load_tiles(tu, th, &s_dx, i0, N, periodic, [&](int v, long j) { return u[v * N + j]; },
             hlp + b * TF_NHELP * N, par + b * TF_NPAR * N, x, xi, pi);
  const long i = i0 + threadIdx.x;
  if (i >= N) return;
  T a[TF_NARGS];
  T f[TF_NVAR];
  gather_tile(a, threadIdx.x, tu, th, xi, pi, s_dx);
  tf_F(a, f);
  const T sc = scale_b ? scale_b[b] : scale;
  // the bias added as the per-node body adds it, read under the same test
#pragma unroll
  for (int m = 0; m < TF_NVAR; ++m) {
    const long at = b * n + m * N + i;
    const T v = sc * f[m];
    out[at] = bias ? v + bias[at] : v;
  }
}

// The F entry of before the tiles: one thread per (member, node) running
// K6's per-node body (stencil.cuh: stencil_F_node), which gathers from
// device memory; launched alone, on no path: the kernel checks hold the
// tiled entry to it bit for bit (ops/kernel_checks.py: check_tiled_F), and
// chip_smoke.py times the two side by side.  One grid without member
// offsets (kMembers).
template <typename T, bool kMembers>
__global__ void stencil_F_nodes_kernel(const T* __restrict__ u, const T* __restrict__ hlp,
                                       const T* __restrict__ par, const T* __restrict__ x,
                                       const T* __restrict__ bias, T* __restrict__ out,
                                       const T* __restrict__ scale_b, long N, int B,
                                       int periodic, T scale) {
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

// F_terms, tiled as the F entry: the block first combines the stage
// vectors once per node of its span, into the variables' tile, beside the
// helpers' tile; then every thread evaluates F at its node from the tiles
// and adds the bias terms.  Combining at each of the W stencil points
// instead read the A vectors W times per node: 1.5x the time of the
// separate combination and biased F at config 5 (PERF.md).
template <typename T>
__global__ void __launch_bounds__(kTile)
    stencil_F_terms_kernel(const Terms<T> terms, const T* __restrict__ hlp,
                           const T* __restrict__ par, const T* __restrict__ x,
                           T* __restrict__ out, const T* __restrict__ scale_b, long N,
                           int periodic, T scale) {
  __shared__ T tu[TF_NVAR][kSpan];
  __shared__ T th[kHelpRows][kSpan];
  __shared__ T s_dx;
  const long b = blockIdx.y, i0 = (long)blockIdx.x * kTile, n = TF_NVAR * N;
  T xi = T(0), pi[kParRows];
  // the stage input combined once per node of the span
  auto combined = [&](int v, long j) {
    return terms_sum(terms, terms.ca, terms.ra, b * n + v * N + j, T(0), false);
  };
  load_tiles(tu, th, &s_dx, i0, N, periodic, combined, hlp + b * TF_NHELP * N,
             par + b * TF_NPAR * N, x, xi, pi);
  const long i = i0 + threadIdx.x;
  if (i >= N) return;
  T a[TF_NARGS];
  T f[TF_NVAR];
  gather_tile(a, threadIdx.x, tu, th, xi, pi, s_dx);
  tf_F(a, f);
  const T sc = scale_b ? scale_b[b] : scale;
#pragma unroll
  for (int m = 0; m < TF_NVAR; ++m) {
    const long at = b * n + m * N + i;
    out[at] = terms_sum(terms, terms.cc, terms.rc, at, tf::mul_rn(sc, f[m]), true);
  }
}

// The J entry: a warp per 32 consecutive nodes of one member (kJThreads
// threads a block), the member along the grid's y.  Each lane loads its
// node of every variable and helper row, and lanes 0..2h-1 the warp's h
// halo nodes on each side, once and coalesced, the boundary closure
// applied to those indices only (close_index: the lanes past the grid's
// end load the wrapped or clamped node their neighbours read); the stencil
// neighbours come from the other lanes by shuffles (warp_at), so a warp
// waits on no other warp.  Each thread then builds its node's argument
// vector in stencil.cuh's gather order (the per-node body's operands, dx
// by one division a warp), evaluates tf_J, folds the edge on the boundary
// nodes (fold_edges, the per-node body's) and writes its kNJ rows, each
// coalesced across the warp.  (F's block tiles, load_tiles and a barrier,
// measured 3-14 % slower than the per-node J at KS and config 5, and the
// warp tiles as fast or faster everywhere: PERF.md.)  Past the 65535
// members a grid's y takes, each block goes on to member b + gridDim.y
// (kLoop; the loop cost a warp tile 5-10 % at KS and config 5, so it runs
// only there).
constexpr int kJThreads = 64;

// A row's value at node i0w + lane + off (|off| <= h), where each lane of
// the warp holds the row at its own node in c and lanes 0..2h-1 hold the
// h nodes left of the warp's 32, then the h right of them, in e
template <typename T>
__device__ __forceinline__ T warp_at(T c, T e, int lane, int off) {
  const int src = lane + off;
  const T own = __shfl_sync(0xffffffffu, c, src & 31);
  const T halo = __shfl_sync(0xffffffffu, e, (src < 0 ? src + TF_H : src - 32 + TF_H) & 31);
  return src >= 0 && src < 32 ? own : halo;
}

// Member b's J at node i = i0w + lane (jc, je: the closed indices of the
// lane's node and of its halo node)
template <typename T>
__device__ __forceinline__ void stencil_J_warp(const T* __restrict__ u,
                                               const T* __restrict__ hlp,
                                               const T* __restrict__ par,
                                               const T* __restrict__ x,
                                               T* __restrict__ bands, long N, int periodic,
                                               long b, long i, long jc, long je, int lane) {
  const T* ub = u + b * TF_NVAR * N;
  const T* hb = hlp + b * TF_NHELP * N;
  const T* pb = par + b * TF_NPAR * N;
  const bool halo = lane < 2 * TF_H;
  T cu[TF_NVAR], eu[TF_NVAR], ch[kHelpRows], eh[kHelpRows], pi[kParRows];
#pragma unroll
  for (int v = 0; v < TF_NVAR; ++v) {
    cu[v] = ub[v * N + jc];
    eu[v] = halo ? ub[v * N + je] : T(0);
  }
#pragma unroll
  for (int v = 0; v < TF_NHELP; ++v) {
    ch[v] = hb[v * N + jc];
    eh[v] = halo ? hb[v * N + je] : T(0);
  }
  const T xi = i < N ? x[i] : T(0);
#pragma unroll
  for (int q = 0; q < TF_NPAR; ++q) pi[q] = i < N ? pb[q * N + i] : T(0);
  T dx = T(0);
  if (lane == 0) dx = (x[N - 1] - x[0]) / T(N - 1);
  dx = __shfl_sync(0xffffffffu, dx, 0);
  // the argument vector in stencil.cuh's gather order
  T a[TF_NARGS];
  int idx = 0;
  a[idx++] = xi;
#pragma unroll
  for (int off = -TF_H; off <= TF_H; ++off) {
#pragma unroll
    for (int v = 0; v < TF_NVAR; ++v) a[idx++] = off ? warp_at(cu[v], eu[v], lane, off) : cu[v];
#pragma unroll
    for (int v = 0; v < TF_NHELP; ++v) a[idx++] = off ? warp_at(ch[v], eh[v], lane, off) : ch[v];
  }
#pragma unroll
  for (int q = 0; q < TF_NPAR; ++q) a[idx++] = pi[q];
  a[idx] = dx;
  if (i >= N) return;
  T e[tf::kNJ];
#pragma unroll
  for (int k = 0; k < tf::kNJ; ++k) e[k] = T(0);
  tf_J(a, e);
  if (!periodic) tf::fold_edges(e, i, N);
  T* out = bands + b * tf::kNJ * N + i;
#pragma unroll
  for (int k = 0; k < tf::kNJ; ++k) out[k * N] = e[k];
}

template <typename T, bool kLoop>
__global__ void __launch_bounds__(kJThreads)
    stencil_J_kernel(const T* __restrict__ u, const T* __restrict__ hlp,
                     const T* __restrict__ par, const T* __restrict__ x,
                     T* __restrict__ bands, long N, int B, int periodic) {
  const int lane = threadIdx.x & 31;
  const long i0w = (long)blockIdx.x * kJThreads + (threadIdx.x & ~31);
  if (i0w >= N) return;
  const long i = i0w + lane;
  const long jc = close_index(i, N, periodic);
  const long je = close_index(lane < TF_H ? i0w - TF_H + lane : i0w + 32 + lane - TF_H, N,
                              periodic);
  if (kLoop) {
    for (long b = blockIdx.y; b < B; b += gridDim.y)
      stencil_J_warp(u, hlp, par, x, bands, N, periodic, b, i, jc, je, lane);
  } else {
    stencil_J_warp(u, hlp, par, x, bands, N, periodic, (long)blockIdx.y, i, jc, je, lane);
  }
}

// The J entry of before the tiles: one thread per (member, node) running
// K6's per-node body (stencil.cuh: stencil_J_node), which gathers from
// device memory; launched alone, on no path: the kernel checks hold the
// tiled entry to it bit for bit (ops/kernel_checks.py: check_tiled_J), and
// chip_smoke.py times the two side by side.  One grid without member
// offsets (kMembers).
template <typename T, bool kMembers>
__global__ void stencil_J_nodes_kernel(const T* __restrict__ u, const T* __restrict__ hlp,
                                       const T* __restrict__ par, const T* __restrict__ x,
                                       T* __restrict__ bands, long N, int B, int periodic) {
  const long q = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= B * N) return;
  const long b = kMembers ? q / N : 0, i = kMembers ? q % N : q;
  tf::stencil_J_node<T>(u + b * TF_NVAR * N, hlp + b * TF_NHELP * N, par + b * TF_NPAR * N,
                        x, bands + b * tf::kNJ * N, N, periodic, i);
}

long blocks_of(long n, int threads) { return (n + threads - 1) / threads; }

// the most blocks a grid's y takes
constexpr int kMaxGridY = 65535;

template <typename T>
int launch_F(const T* u, const T* hlp, const T* par, const T* x, const T* bias, T* out,
             const T* scale_b, long N, int B, int periodic, double scale,
             cudaStream_t stream) {
  if (B < 1 || B > 65535 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  stencil_F_kernel<T><<<dim3(blocks_of(N, kTile), B), kTile, 0, stream>>>(
      u, hlp, par, x, bias, out, scale_b, N, periodic, T(scale));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_F_nodes(const T* u, const T* hlp, const T* par, const T* x, const T* bias, T* out,
                   const T* scale_b, long N, int B, int periodic, double scale,
                   cudaStream_t stream) {
  const int threads = 256;
  if (B > 1)
    stencil_F_nodes_kernel<T, true><<<blocks_of(B * N, threads), threads, 0, stream>>>(
        u, hlp, par, x, bias, out, scale_b, N, B, periodic, T(scale));
  else
    stencil_F_nodes_kernel<T, false><<<blocks_of(N, threads), threads, 0, stream>>>(
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
  if (B < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)blocks_of(N, kJThreads), (unsigned)(B < kMaxGridY ? B : kMaxGridY));
  if (B > kMaxGridY)
    stencil_J_kernel<T, true><<<grid, kJThreads, 0, stream>>>(u, hlp, par, x, bands, N, B,
                                                              periodic);
  else
    stencil_J_kernel<T, false><<<grid, kJThreads, 0, stream>>>(u, hlp, par, x, bands, N, B,
                                                               periodic);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_J_nodes(const T* u, const T* hlp, const T* par, const T* x, T* bands, long N,
                   int B, int periodic, cudaStream_t stream) {
  const int threads = 256;
  if (B > 1)
    stencil_J_nodes_kernel<T, true><<<blocks_of(B * N, threads), threads, 0, stream>>>(
        u, hlp, par, x, bands, N, B, periodic);
  else
    stencil_J_nodes_kernel<T, false><<<blocks_of(N, threads), threads, 0, stream>>>(
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
  extern "C" int tf_stencil_F_nodes_##SUFFIX(const void* u, const void* hlp, const void* par, \
                                             const void* x, const void* bias, void* out,   \
                                             const void* scale_b, int N, int B,            \
                                             int periodic, double scale, void* stream) {   \
    return launch_F_nodes<T>(static_cast<const T*>(u), static_cast<const T*>(hlp),         \
                             static_cast<const T*>(par), static_cast<const T*>(x),         \
                             static_cast<const T*>(bias), static_cast<T*>(out),            \
                             static_cast<const T*>(scale_b), N, B, periodic, scale,        \
                             static_cast<cudaStream_t>(stream));                           \
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
  }                                                                                        \
  extern "C" int tf_stencil_J_nodes_##SUFFIX(const void* u, const void* hlp, const void* par, \
                                             const void* x, void* bands, int N, int B,     \
                                             int periodic, void* stream) {                 \
    return launch_J_nodes<T>(static_cast<const T*>(u), static_cast<const T*>(hlp),         \
                             static_cast<const T*>(par), static_cast<const T*>(x),         \
                             static_cast<T*>(bands), N, B, periodic,                       \
                             static_cast<cudaStream_t>(stream));                           \
  }

// a model computes in one dtype: its library carries that dtype's entries
#if TF_F32
TF_ENTRIES(f32, float)
#else
TF_ENTRIES(f64, double)
#endif
