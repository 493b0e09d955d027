// K7: the block-banded matrix-vector product of B members,
//   out[b, m, i] = scale_b * sum_k sum_n A[b, k, m, n, i] * v[b, n, i + k - h],
// h = W / 2, in the node layout: bands (B, W, nvar, nvar, N), v and out
// (B, nvar, N); one grid is B = 1.  In edge mode a column outside [0, N)
// contributes zero (the compiler has already folded the ghost nodes into
// the bands); on a ring the column index wraps.  scale is one number, or
// one value per member read from device memory (an ensemble's g00 * dt).
//
// Replaces, on the TPU: ops/pallas_stencil.py:381 banded_matvec_pallas (the
// node layout, reached through ops/banded.py banded_matvec) and, as the
// same function in the TPU's folded layout, ops/folded.py:700
// matvec_folded.  The ROW schemes' residual refinement (r = rhs - k + g00
// dt J k) and the right-hand side of Theta with a custom solver (dt F -
// theta dt J u + u) call it.
//
// Bound: device-memory bandwidth.  Each launch reads the bands once
// (W nvar^2 values per node), v and writes out: B N (W nvar^2 + 2 nvar)
// values, 56 MB in float64 at KS N = 10^6 (W = 5, nvar = 1), 16.7 us at
// the H100's 3.35 TB/s (NVIDIA H100 80GB HBM3, 700 W power limit;
// PERF.md), 8.4 us in float32; 2 W nvar^2 operations per node are far
// below the arithmetic peaks.
//
// Design (matvec_tiled_kernel): a block of kThreads threads per (tile of
// kThreads * kV nodes, member), member blockIdx.y.  The block stages the v
// span of every variable (its nodes and h halo nodes on each side) into
// shared memory once, coalesced, the ring's wrap applied to the halo
// indices only (close_index), so the product's inner loop has no modulo
// and no branch; a block whose nodes reach past an edge (not periodic)
// runs the same body with the out-of-grid terms skipped, as band_row
// skips them.  Each thread owns kV consecutive nodes (16 bytes of T: 4
// float, 2 double): it reads its window of v (kV + W - 1 values a
// variable) from shared memory into registers, then streams each band
// row's 16 bytes with one vector load (the bands are node-minor, so a
// warp reads 512 contiguous bytes of each row), W nvar^2 loads in flight
// a thread.  (W, nvar) are compile-time for W = 3, 5, 7 and nvar = 1, 2,
// 3; offsets inside a member are 32-bit (the entry takes this body where
// a member's bands hold under 2^31 values).  A row start that is not
// 16-byte aligned (N no multiple of kV, or an offset view) reads the same
// nodes with scalar loads.  Terms are summed in (k, n) order, as band_row
// sums them, so the product is bit for bit that of the per-node body.
// (Two runs of kV nodes a thread, 64 or 256 threads a block and streaming
// stores measured no faster: PERF.md.)
//
// matvec_nodes_kernel is the body of before the tiles: one thread per
// (node, member) walking tf::band_row, v read through L1, W and nvar and
// 64-bit offsets at run time.  The entry runs it for every other shape
// and for members of 2^31 band values or more; it is also an entry of its
// own on no path (tf_matvec_nodes_*), which the kernel checks hold the
// tiled body to bit for bit and chip_smoke.py times beside it.
#include "common.cuh"
#include "matvec.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxMembers = 65535;  // gridDim.y

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
};

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, T (&out)[Vec<T>::n]) {
  const typename Vec<T>::type r = *reinterpret_cast<const typename Vec<T>::type*>(p);
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int c = 0; c < Vec<T>::n; ++c) out[c] = e[c];
}

template <typename T>
__device__ __forceinline__ void load_vec_ldg(const T* p, T (&out)[Vec<T>::n]) {
  const typename Vec<T>::type r = __ldg(reinterpret_cast<const typename Vec<T>::type*>(p));
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int c = 0; c < Vec<T>::n; ++c) out[c] = e[c];
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const T (&in)[Vec<T>::n]) {
  typename Vec<T>::type r;
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int c = 0; c < Vec<T>::n; ++c) e[c] = in[c];
  *reinterpret_cast<typename Vec<T>::type*>(p) = r;
}

// Node j of a span under the closure: j itself inside the grid; periodic,
// j -+ N (a compare and an add where h < N; the loops serve grids of fewer
// nodes than the halo); edge, clamped (a value no term reads)
template <typename I>
__device__ __forceinline__ I close_index(I j, I N, int periodic) {
  if (j >= 0 && j < N) return j;
  if (!periodic) return j < 0 ? 0 : N - 1;
  while (j < 0) j += N;
  while (j >= N) j -= N;
  return j;
}

// The tiled body's product for the thread's kV nodes from node i (i < N):
// w[q][e] is v at node i - h + e; kVec: one vector load a band row (else
// kV scalar loads, nodes past N read as zero); kCheck: terms whose column
// leaves [0, N) skipped (a block that reaches past an edge, not periodic)
template <typename T, int W, int NV, bool kVec, bool kCheck>
__device__ __forceinline__ void tiled_rows(const T* __restrict__ A, T* __restrict__ ob,
                                           const T (&w)[NV][Vec<T>::n + W - 1], T sc, int i,
                                           int N) {
  constexpr int kV = Vec<T>::n;
  constexpr int kH = W / 2;
#pragma unroll
  for (int m = 0; m < NV; ++m) {
    T acc[kV];
#pragma unroll
    for (int c = 0; c < kV; ++c) acc[c] = T(0);
#pragma unroll
    for (int k = 0; k < W; ++k) {
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const T* row = A + ((k * NV + m) * NV + q) * N + i;
        T a[kV];
        if constexpr (kVec) {
          load_vec_ldg(row, a);
        } else {
#pragma unroll
          for (int c = 0; c < kV; ++c) a[c] = i + c < N ? __ldg(row + c) : T(0);
        }
#pragma unroll
        for (int c = 0; c < kV; ++c) {
          const int j = i + c + k - kH;
          if (!kCheck || (j >= 0 && j < N)) acc[c] += a[c] * w[q][c + k];
        }
      }
    }
    T res[kV];
#pragma unroll
    for (int c = 0; c < kV; ++c) res[c] = sc * acc[c];
    T* o = ob + m * N + i;
    if constexpr (kVec) {
      store_vec(o, res);
    } else {
#pragma unroll
      for (int c = 0; c < kV; ++c)
        if (i + c < N) o[c] = res[c];
    }
  }
}

template <typename T, int W, int NV>
__global__ void __launch_bounds__(kThreads)
    matvec_tiled_kernel(const T* __restrict__ bands, const T* __restrict__ v,
                        T* __restrict__ out, const T* __restrict__ scale_b, T scale, int N,
                        int periodic, int vec) {
  constexpr int kV = Vec<T>::n;
  constexpr int kH = W / 2;
  constexpr int kNodes = kThreads * kV;
  constexpr int kWin = kV + W - 1;
  // each thread reads its window as whole vectors from a 16-byte boundary
  constexpr int kWinV = (kWin + kV - 1) / kV;
  constexpr int kRow = kV * (kThreads - 1 + kWinV);
  __shared__ __align__(16) T sv[NV][kRow];
  const int i0 = blockIdx.x * kNodes;
  const long b = blockIdx.y;
  const T* vb = v + b * NV * (long)N;
  const int span = (N - i0 < kNodes ? N - i0 : kNodes) + W - 1;
  for (int t = threadIdx.x; t < span; t += kThreads) {
    const int j = close_index(i0 - kH + t, N, periodic);
#pragma unroll
    for (int q = 0; q < NV; ++q) sv[q][t] = vb[q * N + j];
  }
  __syncthreads();
  const int i = i0 + kV * threadIdx.x;
  if (i >= N) return;
  T w[NV][kWin];
#pragma unroll
  for (int q = 0; q < NV; ++q)
#pragma unroll
    for (int g = 0; g < kWinV; ++g) {
      T part[kV];
      load_vec(&sv[q][kV * threadIdx.x + kV * g], part);
#pragma unroll
      for (int c = 0; c < kV; ++c)
        if (kV * g + c < kWin) w[q][kV * g + c] = part[c];
    }
  const T sc = scale_b ? scale_b[b] : scale;
  const T* A = bands + b * (W * NV * NV) * (long)N;
  T* ob = out + b * NV * (long)N;
  const bool check = !periodic && (i0 < kH || i0 + kNodes + kH > N);
  if (vec) {
    if (check) tiled_rows<T, W, NV, true, true>(A, ob, w, sc, i, N);
    else tiled_rows<T, W, NV, true, false>(A, ob, w, sc, i, N);
  } else {
    if (check) tiled_rows<T, W, NV, false, true>(A, ob, w, sc, i, N);
    else tiled_rows<T, W, NV, false, false>(A, ob, w, sc, i, N);
  }
}

// The body of before the tiles (the head comment)
template <typename T>
__global__ void matvec_nodes_kernel(const T* __restrict__ bands, const T* __restrict__ v,
                                    T* __restrict__ out, const T* __restrict__ scale_b,
                                    T scale, int W, int nvar, long N, int periodic) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const long b = blockIdx.y;
  const long n = (long)nvar * N;
  const T* A = bands + b * W * nvar * n;
  const T* vb = v + b * n;
  const T sc = scale_b ? scale_b[b] : scale;
  for (int m = 0; m < nvar; ++m)
    out[b * n + m * N + i] = sc * tf::band_row(A, vb, W, nvar, N, periodic, i, m,
                                               tf::ReadOnlyLoad());
}

bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

template <typename T, int W, int NV>
int launch_tiled(const T* bands, const T* v, T* out, const T* scale_b, int N, int B,
                 int periodic, T scale, cudaStream_t stream) {
  constexpr int kV = Vec<T>::n;
  const int vec = N % kV == 0 && aligned16(bands) && aligned16(v) && aligned16(out);
  const dim3 grid((unsigned)((N + kThreads * kV - 1) / (kThreads * kV)), (unsigned)B);
  matvec_tiled_kernel<T, W, NV><<<grid, kThreads, 0, stream>>>(bands, v, out, scale_b,
                                                               scale, N, periodic, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_nodes(const T* bands, const T* v, T* out, const T* scale_b, int W, int nvar, int N,
                 int B, int periodic, double scale, void* stream) {
  if (W < 1 || nvar < 1 || N < 0 || B < 1 || B > kMaxMembers)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const int threads = 256;
  const dim3 grid((unsigned)(((long)N + threads - 1) / threads), (unsigned)B);
  matvec_nodes_kernel<T><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      bands, v, out, scale_b, T(scale), W, nvar, N, periodic);
  return static_cast<int>(cudaGetLastError());
}

// The tiled body at the compile-time shapes (W = 3, 5, 7 and nvar = 1, 2,
// 3) where a member's bands and a tile hold under 2^31 values, else the
// per-node body
template <typename T>
int matvec(const T* bands, const T* v, T* out, const T* scale_b, int W, int nvar, int N,
           int B, int periodic, double scale, void* stream_) {
  if (W < 1 || nvar < 1 || N < 0 || B < 1 || B > kMaxMembers)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if ((long)W * nvar * nvar * N + kThreads * Vec<T>::n < (1L << 31)) {
#define TF_SHAPE(W_, NV_)                                                             \
  if (W == W_ && nvar == NV_)                                                         \
    return launch_tiled<T, W_, NV_>(bands, v, out, scale_b, N, B, periodic, T(scale), \
                                    stream);
    TF_SHAPE(3, 1) TF_SHAPE(3, 2) TF_SHAPE(3, 3)
    TF_SHAPE(5, 1) TF_SHAPE(5, 2) TF_SHAPE(5, 3)
    TF_SHAPE(7, 1) TF_SHAPE(7, 2) TF_SHAPE(7, 3)
#undef TF_SHAPE
  }
  return launch_nodes(bands, v, out, scale_b, W, nvar, N, B, periodic, scale, stream_);
}

}  // namespace

// scale_b: a device address of B values, or 0 for the number scale.
#define TF_ENTRIES(SUFFIX, T)                                                             \
  extern "C" int tf_matvec_##SUFFIX(const void* bands, const void* v, void* out,         \
                                    const void* scale_b, int W, int nvar, int N, int B,  \
                                    int periodic, double scale, void* stream) {          \
    return matvec<T>(static_cast<const T*>(bands), static_cast<const T*>(v),              \
                     static_cast<T*>(out), static_cast<const T*>(scale_b), W, nvar, N, B, \
                     periodic, scale, stream);                                            \
  }                                                                                       \
  extern "C" int tf_matvec_nodes_##SUFFIX(const void* bands, const void* v, void* out,   \
                                          const void* scale_b, int W, int nvar, int N,   \
                                          int B, int periodic, double scale,             \
                                          void* stream) {                                 \
    return launch_nodes<T>(static_cast<const T*>(bands), static_cast<const T*>(v),        \
                           static_cast<T*>(out), static_cast<const T*>(scale_b), W, nvar, \
                           N, B, periodic, scale, stream);                                \
  }

// a library built by dtype (ops/_build.py: Library) keeps one type's entries
#ifndef TF_ONLY_F64
TF_ENTRIES(f32, float)
#endif
#ifndef TF_ONLY_F32
TF_ENTRIES(f64, double)
#endif
