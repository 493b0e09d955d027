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
// u, x and the parameters (the generated tf_F and tf_J at the supernode's
// g nodes), so neither writes bands, factor rows, a right-hand side or a
// sweep intermediate to device memory: the step's only state-sized output
// is u2.
//
//   interface entry: the chunk's rows of the reduced interface system, in
//     K2's and K3's layouts, which K4 takes as they are: Lred, Ured
//     (2S, 2S, C) from the first and last blocks of the spikes
//     W = T_c^-1 (Tl e_0) and V = T_c^-1 (Tr e_{Mc-1}), and yred (2S, C)
//     from the first and last rows of y = T_c^-1 (dt F).
//   correct entry: u2 = u + T_c^-1 (dt F - Tl x_{c-1} e_0 - Tr x_{c+1}
//     e_{Mc-1}), x_{c-1} the bottom interface unknowns of chunk c - 1 (xm1)
//     and x_{c+1} the top ones of chunk c + 1 (xp1), both from
//     K4.pcr_solve_shift: the reference's u + y - W xm1 - V xp1.
//
// Bound: the step reads u, x and the parameters in each pass and writes
// u2 once (about 7 state passes for Burgers), with a few tens of
// operations per node, so the work is bound by bytes; but eliminating a
// chunk's rows one after the other is a chain of dependent operations (a
// J and F evaluation, an S x S inverse, block products) per row, which
// with at most pcr.MAX_C = 16384 chunks leaves each pass bound by the
// chain's latency.  The design shortens the chain by a second SPIKE level
// inside the chunk: one warp per chunk (a block each), its kP = 32 lanes
// owning consecutive sub-chunks of ceil(Mc / 32) or floor(Mc / 32) rows
// (Mc < 32: one row each on Mc lanes, the rest idle).  The last row of a
// lane's sub-chunk is its separator z_k; the rows before it, its
// interior, couple to z_{k-1} (through the interior's first row; lane 0:
// to chunk c - 1's last row through Tl) and to z_k.
//
//   1. The block copies the chunk's span of the state and helpers (its
//      nodes and h halo nodes on each side, the ring's wrap applied to the
//      halo) and its nodes' parameters (and x, where the model reads it:
//      TF_USES_X) into shared memory by cp.async, coalesced, once; every
//      row is evaluated from there.  One element of padding after every
//      128 bytes (64 where that would cancel the lanes' stride) spreads the
//      lanes, which read nodes about Mc g / 32 apart, over the banks.  The generated bodies take 1 / dx in dx's place
//      (ops/stencil.py: generate_source's inverse_dx), so a node's stencil
//      multiplies by powers of it where K1's divides: those divisions made
//      most of a row's float64 work.
//   2. Each lane eliminates its interior top-down (no pivoting, as K2) with
//      two right-hand sides, dt F and the column L_a of the interior's
//      first row, and keeps Dh U, Dh b and Dh w of every interior row in
//      shared memory (its own ceil(Mc / 32) - 1 rows, lane-minor); the
//      interior's last row is then x = gL - PL z_{k-1} - QL z_k, and a back
//      substitution over the kept rows gives its first row x = gF - PF
//      z_{k-1} - QF z_k (an empty interior: x_{m-1} = z_{k-1}, x_a = z_k).
//   3. The separator rows L_m x_{m-1} + D_m z_k + U_m x_{m+1} = r_m, with
//      x_{m-1} from the lane's own interior and x_{m+1} from the next
//      lane's (gF, PF, QF) by a shuffle, form a block-tridiagonal system
//      of S x S blocks over the lanes, A_k z_{k-1} + B_k z_k + C_k z_{k+1}
//      = d_k, whose outer couplings A_0 (to chunk c - 1) and C_{p-1} (to
//      chunk c + 1, Tr) go to the right-hand side: the interface entry
//      solves for d and the two spike columns (1 + 2S columns), the
//      correct entry for d - A_0 xm1 - C_{p-1} xp1.  Parallel cyclic
//      reduction across the lanes by __shfl_sync solves it in
//      ceil(log2 p) levels.
//   4. The interface entry writes its rows from lane 0 (the chunk's first
//      row, through lane 0's (gF, PF, QF)) and the last active lane (the
//      chunk's last row, its separator).  The correct entry gives each
//      lane z_{k-1} and z_k, back-substitutes its interior over the kept
//      rows, adds x to the staged state and writes u2 coalesced.
//
// The chain per chunk is ceil(Mc / 32) rows of elimination and as many of
// back substitution (twice in the correct entry) plus the levels, against
// 2 Mc rows when one lane eliminated the chunk.  The elimination order
// differs from the plain versions' (one top-down and one bottom-up sweep
// over the whole chunk), so the kernel agrees with them to the solver
// pieces' limits, not bit for bit.
#include "common.cuh"

// ---- GENERATED: model constants and expression bodies ----
// @GENERATED@
// ---- end of generated block ----

#include "cp_async.cuh"
#include "factor.cuh"
#include "stencil.cuh"

namespace {

constexpr int kG = TF_H > 0 ? TF_H : 1;
constexpr int kS = TF_NVAR * kG;
// lanes of a chunk, each a sub-chunk: one warp, one block
constexpr int kP = 32;
constexpr unsigned kAll = 0xffffffffu;
// staged rows with a halo: the variables, then the helpers; rows of the
// chunk's nodes: the parameters, then x where the model reads it
constexpr int kURows = TF_NVAR + TF_NHELP;
constexpr int kNRows = TF_NPAR + TF_USES_X;
// per kept interior row: Dh U, Dh b, Dh w
constexpr int kStore = 2 * kS * kS + kS;

template <typename T>
using Blk = tf::Blk<T, kS>;

// One element of padding after every 2^sh elements of a staged row: 128
// bytes, or 64 in float32 where the lanes' stride of q g = 31 mod 32
// elements would cancel the padding and put most lanes on one bank
__host__ __device__ __forceinline__ int pad(int t, int sh) { return t + (t >> sh); }

template <typename T>
__host__ __device__ __forceinline__ int pad_shift(int Mc) {
  if (sizeof(T) == 8) return 4;
  return (Mc / kP) * kG % 32 == 31 ? 4 : 5;
}

// The lanes' rows: lane l owns rows [first(l), first(l) + rows(l)) of the
// chunk, the first rem lanes one more than the rest; p lanes are active
// (Mc < kP: one row each on Mc lanes)
struct Split {
  int q, rem, p;
  __host__ __device__ explicit Split(int Mc) : q(Mc / kP), rem(Mc % kP), p(Mc < kP ? Mc : kP) {}
  __host__ __device__ int first(int l) const { return l * q + (l < rem ? l : rem); }
  __host__ __device__ int rows(int l) const { return q + (l < rem ? 1 : 0); }
};

// The block's shared memory, in elements of T: the span's kURows rows
// (lsp each), the kNRows rows of the chunk's nodes (lnd each), then each
// lane's kept interior rows (at most `rows`, kStore values each,
// lane-minor).  ops/megatheta.py's smem_bytes computes the same sum.
template <typename T>
struct Layout {
  int sh, nodes, span, lsp, lnd, rows;
  __host__ __device__ explicit Layout(int Mc)
      : sh(pad_shift<T>(Mc)), nodes(Mc * kG), span(Mc * kG + 2 * TF_H),
        lsp(pad(Mc * kG + 2 * TF_H - 1, sh) + 1), lnd(pad(Mc * kG - 1, sh) + 1),
        rows((Mc + kP - 1) / kP - 1) {}
  __host__ __device__ long elems() const {
    return (long)kURows * lsp + (long)kNRows * lnd + (long)rows * kStore * kP;
  }
};

// The staged inputs of a chunk: node t of the chunk sits at pad(t + h) of
// a row of u (the variables, then the helpers) and at pad(t) of a row of p
// (the parameters, then x); the lane's kept rows from `store`; dxi = 1 / dx
template <typename T>
struct Span {
  T* u;
  const T* p;
  T* store;
  int lsp, lnd, sh;
  T dxi;
};

// Step 1: the chunk's span into shared memory by cp.async (node i0 - h + t
// at span position t; only the halo leaves [0, N), and the ring's wrap
// brings it back), and 1 / dx, dx = (x[N-1] - x[0]) / (N - 1) as every
// node's evaluation in K1 takes it, once, by lane 0, while the copies fly
template <typename T>
__device__ __forceinline__ Span<T> stage(T* sm, const Layout<T>& lay, const T* u,
                                         const T* hlp, const T* par, const T* x, long N,
                                         long i0) {
  const int lane = threadIdx.x;
  T* su = sm;
  T* sp = su + (long)kURows * lay.lsp;
  T* st = sp + (long)kNRows * lay.lnd;
  for (int t = lane; t < lay.span; t += kP) {
    long j = i0 - TF_H + t;
    if (j < 0) j += N;
    else if (j >= N) j -= N;
    const int at = pad(t, lay.sh);
#pragma unroll
    for (int v = 0; v < TF_NVAR; ++v) tf::cp_async(su + v * lay.lsp + at, u + v * N + j);
#pragma unroll
    for (int v = 0; v < TF_NHELP; ++v)
      tf::cp_async(su + (TF_NVAR + v) * lay.lsp + at, hlp + v * N + j);
  }
  for (int t = lane; t < lay.nodes; t += kP) {
    const int at = pad(t, lay.sh);
#pragma unroll
    for (int q = 0; q < TF_NPAR; ++q) tf::cp_async(sp + q * lay.lnd + at, par + q * N + i0 + t);
    if (TF_USES_X) tf::cp_async(sp + TF_NPAR * lay.lnd + at, x + i0 + t);
  }
  tf::cp_async_commit();
  T dxi = lane == 0 ? T(1) / ((x[N - 1] - x[0]) / T(N - 1)) : T(0);
  dxi = __shfl_sync(kAll, dxi, 0);
  tf::cp_async_wait<0>();
  __syncwarp();
  return {su, sp, st + lane, lay.lsp, lay.lnd, lay.sh, dxi};
}

template <typename T>
struct Row {
  Blk<T> L, D, U;  // couplings of supernode J to J - 1, J and J + 1
  T r[kS];         // dt F at the supernode's nodes
};

// Row J (of the chunk) of A = I + beta J and its right-hand side, from the
// staged span: each node's arguments in stencil.cuh's gather order (x, the
// variables and helpers at offsets -h..h, the parameters, 1 / dx); J's
// bands at the supernode's g nodes go into a local array laid out as K1's
// bands of a grid of g nodes, so K2's band_block assembles the blocks from
// it.
template <typename T>
__device__ __forceinline__ void eval_row(const Span<T>& sp, int J, T beta, T dt, Row<T>& row) {
  T bands[tf::kNJ * kG];
#pragma unroll
  for (int a = 0; a < kG; ++a) {
    const int t = J * kG + a;
    T args[TF_NARGS];
    T f[TF_NVAR];
    T b[tf::kNJ];
    int idx = 0;
    args[idx++] = TF_USES_X ? sp.p[TF_NPAR * sp.lnd + pad(t, sp.sh)] : T(0);
#pragma unroll
    for (int off = -TF_H; off <= TF_H; ++off) {
      const int at = pad(t + TF_H + off, sp.sh);
#pragma unroll
      for (int v = 0; v < kURows; ++v) args[idx++] = sp.u[v * sp.lsp + at];
    }
#pragma unroll
    for (int q = 0; q < TF_NPAR; ++q) args[idx++] = sp.p[q * sp.lnd + pad(t, sp.sh)];
    args[idx] = sp.dxi;
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

template <typename T>
__device__ __forceinline__ Blk<T> minus_eye() {
  Blk<T> e;
  tf::eye(e);
  return neg(e);
}

// r -= a * v
template <typename T>
__device__ __forceinline__ void sub_mv(T (&r)[kS], const Blk<T>& a, const T (&v)[kS]) {
  T t[kS];
  tf::mv(a, v, t);
#pragma unroll
  for (int q = 0; q < kS; ++q) r[q] = r[q] - t[q];
}

template <typename T>
__device__ __forceinline__ void zero_vec(T (&r)[kS]) {
#pragma unroll
  for (int q = 0; q < kS; ++q) r[q] = T(0);
}

// An S x K right-hand side of the separator system
template <typename T, int K>
struct Rhs {
  T v[kS][K];
};

// r += a * b
template <typename T, int K>
__device__ __forceinline__ void add_mm(Rhs<T, K>& r, const Blk<T>& a, const Rhs<T, K>& b) {
#pragma unroll
  for (int i = 0; i < kS; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) {
      T acc = a.v[i][0] * b.v[0][j];
#pragma unroll
      for (int q = 1; q < kS; ++q) acc += a.v[i][q] * b.v[q][j];
      r.v[i][j] += acc;
    }
}

template <typename T, int K>
__device__ __forceinline__ Rhs<T, K> mm_rhs(const Blk<T>& a, const Rhs<T, K>& b) {
  Rhs<T, K> r;
#pragma unroll
  for (int i = 0; i < kS; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) r.v[i][j] = T(0);
  add_mm(r, a, b);
  return r;
}

// a + b
template <typename T>
__device__ __forceinline__ Blk<T> add(const Blk<T>& a, const Blk<T>& b) {
  Blk<T> c;
#pragma unroll
  for (int i = 0; i < kS; ++i)
#pragma unroll
    for (int j = 0; j < kS; ++j) c.v[i][j] = a.v[i][j] + b.v[i][j];
  return c;
}

// Shuffles of whole blocks: lane + d (down) or lane - d (up)
template <typename T, int R, int K>
__device__ __forceinline__ void shfl_down(const T (&a)[R][K], T (&b)[R][K], int d) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) b[i][j] = __shfl_down_sync(kAll, a[i][j], d);
}

template <typename T, int R, int K>
__device__ __forceinline__ void shfl_up(const T (&a)[R][K], T (&b)[R][K], int d) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) b[i][j] = __shfl_up_sync(kAll, a[i][j], d);
}

// What a lane's elimination leaves: its separator row m = a + n - 1, and
// the first (gF, PF, QF) and last (gL, PL, QL) rows of its interior as
// x = g - P z_{k-1} - Q z_k
template <typename T>
struct Faces {
  Blk<T> Lm, Dm, Um;
  T rm[kS];
  T gF[kS], gL[kS];
  Blk<T> PF, QF, PL, QL;
};

// Step 2 over the lane's rows [a, a + n), n >= 1
template <typename T>
__device__ __forceinline__ Faces<T> eliminate(const Span<T>& sp, int a, int n, int Mc, int C,
                                              int c, int wrap, T beta, T dt) {
  Faces<T> fc;
  T* st = sp.store;
  Blk<T> dh, up, wt;
  T bt[kS];
  for (int k = 0; k < n; ++k) {
    const int j = a + k;
    Row<T> row;
    eval_row(sp, j, beta, dt, row);
    // the chunk's outer couplings, zero at the grid's ends without the wrap
    if (!wrap && j == 0 && c == 0) tf::zero(row.L);
    if (!wrap && j == Mc - 1 && c == C - 1) tf::zero(row.U);
    if (k == n - 1) {
      fc.Lm = row.L;
      fc.Dm = row.D;
      fc.Um = row.U;
#pragma unroll
      for (int q = 0; q < kS; ++q) fc.rm[q] = row.r[q];
      break;
    }
    if (k == 0) {
      dh = tf::inv(row.D);
      wt = row.L;
    } else {
      const Blk<T> f = tf::mm(row.L, dh);
      dh = tf::inv(tf::sub(row.D, tf::mm(f, up)));
      sub_mv(row.r, f, bt);
      wt = neg(tf::mm(f, wt));
    }
#pragma unroll
    for (int q = 0; q < kS; ++q) bt[q] = row.r[q];
    // Dh U, Dh b, Dh w: the interior's last row's g, P, Q when k = n - 2
    fc.QL = tf::mm(dh, row.U);
    fc.PL = tf::mm(dh, wt);
    tf::mv(dh, bt, fc.gL);
    T* s = st + (long)k * kStore * kP;
#pragma unroll
    for (int p = 0; p < kS; ++p) {
#pragma unroll
      for (int q = 0; q < kS; ++q) {
        s[(p * kS + q) * kP] = fc.QL.v[p][q];
        s[(kS * kS + p * kS + q) * kP] = fc.PL.v[p][q];
      }
      s[(2 * kS * kS + p) * kP] = fc.gL[p];
    }
    up = row.U;
  }
  if (n == 1) {
    // no interior: x_{m-1} = z_{k-1}, and the row after the previous
    // separator is z_k
    zero_vec(fc.gL);
    fc.PL = minus_eye<T>();
    tf::zero(fc.QL);
    zero_vec(fc.gF);
    tf::zero(fc.PF);
    fc.QF = minus_eye<T>();
    return fc;
  }
  // back substitution to the interior's first row: g_k = hb_k - DU_k
  // g_{k+1}, P_k = hw_k - DU_k P_{k+1}, Q_k = -DU_k Q_{k+1}
  Blk<T> P = fc.PL, Q = fc.QL;
  T g[kS];
#pragma unroll
  for (int q = 0; q < kS; ++q) g[q] = fc.gL[q];
  for (int k = n - 3; k >= 0; --k) {
    const T* s = st + (long)k * kStore * kP;
    Blk<T> DU, hw;
    T hb[kS];
#pragma unroll
    for (int p = 0; p < kS; ++p) {
#pragma unroll
      for (int q = 0; q < kS; ++q) {
        DU.v[p][q] = s[(p * kS + q) * kP];
        hw.v[p][q] = s[(kS * kS + p * kS + q) * kP];
      }
      hb[p] = s[(2 * kS * kS + p) * kP];
    }
    sub_mv(hb, DU, g);
#pragma unroll
    for (int q = 0; q < kS; ++q) g[q] = hb[q];
    P = tf::sub(hw, tf::mm(DU, P));
    Q = neg(tf::mm(DU, Q));
  }
#pragma unroll
  for (int q = 0; q < kS; ++q) fc.gF[q] = g[q];
  fc.PF = P;
  fc.QF = Q;
  return fc;
}

// Step 3: the lane's row of the separator system, A z_{k-1} + B z_k +
// C z_{k+1} = d, from its faces and the next lane's first interior row
// (the last active lane's next row is chunk c + 1's first, x = z_p)
template <typename T>
__device__ __forceinline__ void separator(const Faces<T>& fc, int p, Blk<T>& A, Blk<T>& B,
                                          Blk<T>& Cc, T (&d)[kS]) {
  const int lane = threadIdx.x;
  Blk<T> PF2, QF2;
  T gF2[1][kS];
  shfl_down(fc.PF.v, PF2.v, 1);
  shfl_down(fc.QF.v, QF2.v, 1);
  {
    T g1[1][kS];
#pragma unroll
    for (int q = 0; q < kS; ++q) g1[0][q] = fc.gF[q];
    shfl_down(g1, gF2, 1);
  }
  if (lane == p - 1) {
    tf::zero(PF2);
    QF2 = minus_eye<T>();
#pragma unroll
    for (int q = 0; q < kS; ++q) gF2[0][q] = T(0);
  }
  A = neg(tf::mm(fc.Lm, fc.PL));
  B = tf::sub(tf::sub(fc.Dm, tf::mm(fc.Lm, fc.QL)), tf::mm(fc.Um, PF2));
  Cc = neg(tf::mm(fc.Um, QF2));
#pragma unroll
  for (int q = 0; q < kS; ++q) d[q] = fc.rm[q];
  sub_mv(d, fc.Lm, fc.gL);
  sub_mv(d, fc.Um, gF2[0]);
}

// Steps 2 and 3 on every lane: its faces and its row of the separator
// system, an identity row past the p active lanes
template <typename T>
struct LaneRow {
  Faces<T> fc;
  Blk<T> A, B, C;
  T d[kS];
};

template <typename T>
__device__ __forceinline__ LaneRow<T> lane_row(const Span<T>& sp, const Split& sl, int a,
                                               int n, int Mc, int C, int c, int wrap, T beta,
                                               T dt) {
  LaneRow<T> lr{};
  if (n > 0) lr.fc = eliminate(sp, a, n, Mc, C, c, wrap, beta, dt);
  separator(lr.fc, sl.p, lr.A, lr.B, lr.C, lr.d);
  if (n == 0) {
    tf::zero(lr.A);
    tf::eye(lr.B);
    tf::zero(lr.C);
    zero_vec(lr.d);
  }
  return lr;
}

// Step 3's solve: parallel cyclic reduction of the separator system over
// the warp's lanes (lanes past the p active ones: identity rows), then
// z = B^-1 R on every lane
template <typename T, int K>
__device__ __forceinline__ Rhs<T, K> pcr_lanes(Blk<T> A, Blk<T> B, Blk<T> Cc, Rhs<T, K> R,
                                               int p) {
  const int lane = threadIdx.x;
  for (int d = 1; d < p; d <<= 1) {
    const Blk<T> Bi = tf::inv(B);
    Blk<T> An, Cn, Bn = B;
    Rhs<T, K> Rn = R;
    tf::zero(An);
    tf::zero(Cn);
    {
      Blk<T> Ao, Bo, Co;
      Rhs<T, K> Ro;
      shfl_up(A.v, Ao.v, d);
      shfl_up(Bi.v, Bo.v, d);
      shfl_up(Cc.v, Co.v, d);
      shfl_up(R.v, Ro.v, d);
      if (lane >= d) {
        const Blk<T> al = neg(tf::mm(A, Bo));
        An = tf::mm(al, Ao);
        Bn = add(Bn, tf::mm(al, Co));
        add_mm(Rn, al, Ro);
      }
    }
    {
      Blk<T> Ao, Bo, Co;
      Rhs<T, K> Ro;
      shfl_down(A.v, Ao.v, d);
      shfl_down(Bi.v, Bo.v, d);
      shfl_down(Cc.v, Co.v, d);
      shfl_down(R.v, Ro.v, d);
      if (lane + d < kP) {
        const Blk<T> ga = neg(tf::mm(Cc, Bo));
        Cn = tf::mm(ga, Co);
        Bn = add(Bn, tf::mm(ga, Ao));
        add_mm(Rn, ga, Ro);
      }
    }
    A = An;
    B = Bn;
    Cc = Cn;
    R = Rn;
  }
  return mm_rhs(tf::inv(B), R);
}

// the interface entry's right-hand side: dt F, then Tl's and Tr's spike
// columns
constexpr int kIfaceCols = 1 + 2 * kS;

template <typename T>
__global__ void __launch_bounds__(kP)
    megatheta_interface_kernel(const T* __restrict__ u, const T* __restrict__ hlp,
                               const T* __restrict__ par, const T* __restrict__ x,
                               T* __restrict__ Lred, T* __restrict__ Ured,
                               T* __restrict__ yred, long N, int Mc, int C, int wrap, T beta,
                               T dt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x, lane = threadIdx.x;
  const Split sl(Mc);
  const int a = sl.first(lane), n = lane < sl.p ? sl.rows(lane) : 0;
  const Span<T> sp = stage(reinterpret_cast<T*>(smem), Layout<T>(Mc), u, hlp, par, x, N,
                           (long)c * Mc * kG);
  LaneRow<T> lr = lane_row(sp, sl, a, n, Mc, C, c, wrap, beta, dt);
  Rhs<T, kIfaceCols> R{};
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    R.v[i][0] = lr.d[i];
    // the chunk's outer couplings leave the system as spike columns
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      if (lane == 0) R.v[i][1 + j] = lr.A.v[i][j];
      if (lane == sl.p - 1) R.v[i][1 + kS + j] = lr.C.v[i][j];
    }
  }
  if (lane == 0) tf::zero(lr.A);
  if (lane == sl.p - 1) tf::zero(lr.C);
  const Rhs<T, kIfaceCols> z = pcr_lanes(lr.A, lr.B, lr.C, R, sl.p);
  const Faces<T>& fc = lr.fc;
  // the chunk's first row (lane 0: x_0 = gF - PF z_{-1} - QF z_0) and its
  // last (the last active lane's separator), as y - W xm1 - V xp1
  const bool first = lane == 0, last = lane == sl.p - 1;
  if (!first && !last) return;
  T y[kS];
  Blk<T> W, V;
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    y[i] = z.v[i][0];
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      W.v[i][j] = z.v[i][1 + j];
      V.v[i][j] = z.v[i][1 + kS + j];
    }
  }
  const bool keep_l = wrap || c != 0;
  const bool keep_u = wrap || c != C - 1;
  // lane 0 writes rows 0..S-1 of the chunk's interface rows, the last
  // active lane rows S..2S-1
  for (int half = 0; half < 2; ++half) {
    if (half == 0 && !first) continue;
    if (half == 1 && !last) continue;
    T yh[kS];
    Blk<T> Wh, Vh;
    if (half == 0) {
      tf::mv(fc.QF, y, yh);
#pragma unroll
      for (int q = 0; q < kS; ++q) yh[q] = fc.gF[q] - yh[q];
      Wh = tf::sub(fc.PF, tf::mm(fc.QF, W));
      Vh = neg(tf::mm(fc.QF, V));
    } else {
#pragma unroll
      for (int q = 0; q < kS; ++q) yh[q] = y[q];
      Wh = W;
      Vh = V;
    }
#pragma unroll
    for (int rr = 0; rr < kS; ++rr) {
      const int r = half * kS + rr;
#pragma unroll
      for (int q = 0; q < 2 * kS; ++q) {
        const T lv = q >= kS ? Wh.v[rr][q - kS] : T(0);
        const T uv = q < kS ? Vh.v[rr][q] : T(0);
        Lred[((long)r * 2 * kS + q) * C + c] = keep_l ? lv : T(0);
        Ured[((long)r * 2 * kS + q) * C + c] = keep_u ? uv : T(0);
      }
      yred[(long)r * C + c] = yh[rr];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kP)
    megatheta_correct_kernel(const T* __restrict__ u, const T* __restrict__ hlp,
                             const T* __restrict__ par, const T* __restrict__ x,
                             const T* __restrict__ xm1, const T* __restrict__ xp1,
                             T* __restrict__ out, long N, int Mc, int C, int wrap, T beta,
                             T dt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x, lane = threadIdx.x;
  const long i0 = (long)c * Mc * kG;
  const Split sl(Mc);
  const int a = sl.first(lane), n = lane < sl.p ? sl.rows(lane) : 0;
  const Span<T> sp = stage(reinterpret_cast<T*>(smem), Layout<T>(Mc), u, hlp, par, x, N, i0);
  LaneRow<T> lr = lane_row(sp, sl, a, n, Mc, C, c, wrap, beta, dt);
  T zm[kS];
#pragma unroll
  for (int q = 0; q < kS; ++q) zm[q] = xm1[(long)q * C + c];
  // the neighbours' interface unknowns folded into the end rows
  if (lane == 0) {
    sub_mv(lr.d, lr.A, zm);
    tf::zero(lr.A);
  }
  if (lane == sl.p - 1) {
    T zp[kS];
#pragma unroll
    for (int q = 0; q < kS; ++q) zp[q] = xp1[(long)q * C + c];
    sub_mv(lr.d, lr.C, zp);
    tf::zero(lr.C);
  }
  Rhs<T, 1> R;
#pragma unroll
  for (int q = 0; q < kS; ++q) R.v[q][0] = lr.d[q];
  const Rhs<T, 1> z = pcr_lanes(lr.A, lr.B, lr.C, R, sl.p);
  // z_{k-1} from the lane before (lane 0: xm1)
  {
    T zz[1][kS], zu[1][kS];
#pragma unroll
    for (int q = 0; q < kS; ++q) zz[0][q] = z.v[q][0];
    shfl_up(zz, zu, 1);
    if (lane > 0) {
#pragma unroll
      for (int q = 0; q < kS; ++q) zm[q] = zu[0][q];
    }
  }
  // every lane's evaluations have read the span: x goes into it, u + x
  __syncwarp();
  if (n > 0) {
    T xn[kS];
#pragma unroll
    for (int q = 0; q < kS; ++q) xn[q] = z.v[q][0];
    for (int k = n - 1; k >= 0; --k) {
      if (k < n - 1) {
        // x_k = Dh b_k - Dh w_k z_{k-1} - Dh U_k x_{k+1}
        const T* s = sp.store + (long)k * kStore * kP;
        Blk<T> DU, hw;
        T hb[kS];
#pragma unroll
        for (int p = 0; p < kS; ++p) {
#pragma unroll
          for (int q = 0; q < kS; ++q) {
            DU.v[p][q] = s[(p * kS + q) * kP];
            hw.v[p][q] = s[(kS * kS + p * kS + q) * kP];
          }
          hb[p] = s[(2 * kS * kS + p) * kP];
        }
        sub_mv(hb, hw, zm);
        sub_mv(hb, DU, xn);
#pragma unroll
        for (int q = 0; q < kS; ++q) xn[q] = hb[q];
      }
#pragma unroll
      for (int q = 0; q < kS; ++q) {
        T* at = sp.u + (q % TF_NVAR) * sp.lsp + pad((a + k) * kG + TF_H + q / TF_NVAR, sp.sh);
        *at = *at + xn[q];
      }
    }
  }
  // u2 written coalesced
  __syncwarp();
  for (int t = lane; t < Mc * kG; t += kP) {
    const int at = pad(t + TF_H, sp.sh);
#pragma unroll
    for (int v = 0; v < TF_NVAR; ++v) out[v * N + i0 + t] = sp.u[v * sp.lsp + at];
  }
}

// Shared memory of a chunk of Mc rows, opted into above the 48 KB a block
// takes by default
template <typename T>
int smem_for(const void* fn, int Mc, int* bytes) {
  *bytes = (int)(Layout<T>(Mc).elems() * (long)sizeof(T));
  if (*bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename T>
int launch_interface(const T* u, const T* hlp, const T* par, const T* x, T* Lred, T* Ured,
                     T* yred, long N, int Mc, int C, int wrap, double beta, double dt,
                     cudaStream_t stream) {
  if (Mc < 2 || (long)Mc * C * kG != N) return static_cast<int>(cudaErrorInvalidValue);
  int bytes = 0;
  if (const int err = smem_for<T>((const void*)megatheta_interface_kernel<T>, Mc, &bytes))
    return err;
  megatheta_interface_kernel<T><<<C, kP, bytes, stream>>>(u, hlp, par, x, Lred, Ured, yred, N,
                                                          Mc, C, wrap, T(beta), T(dt));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_correct(const T* u, const T* hlp, const T* par, const T* x, const T* xm1,
                   const T* xp1, T* out, long N, int Mc, int C, int wrap, double beta,
                   double dt, cudaStream_t stream) {
  if (Mc < 2 || (long)Mc * C * kG != N) return static_cast<int>(cudaErrorInvalidValue);
  int bytes = 0;
  if (const int err = smem_for<T>((const void*)megatheta_correct_kernel<T>, Mc, &bytes))
    return err;
  megatheta_correct_kernel<T><<<C, kP, bytes, stream>>>(u, hlp, par, x, xm1, xp1, out, N, Mc,
                                                        C, wrap, T(beta), T(dt));
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
