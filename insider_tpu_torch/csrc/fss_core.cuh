// The column solves of the fused (fss.cu), streamed (fss_streamed.cu) and
// shared-gram (fss_shared.cu) kernels: the feature-sign search (FSS) with
// its polish, one gene by one warp (fss_column) or, in the shared-gram
// kernel at K <= 32, by a group of L lanes (fss_group_columns and
// polish_group_columns), and the cold strong-rule coordinate descent (CD),
// one gene by a group of L lanes.  Each kernel is a template on the
// solver (Solver<false> FSS, Solver<true> CD) and calls solve_column (FSS),
// the grouped FSS loops or cd_group_columns (CD).
//
// fss_column replaces the per-column iteration of
// insider_tpu/kernels/fss_pallas.py:_fss_compute.  For column j, with gram
// G_j and b_j = Xty[:, j], it minimizes
//     1/2 b^T G_j b - b_j^T b + l2/2 |b|^2 + l1 |b|_1
// from the warm start beta0[:, j], with the TPU kernel's iteration:
//   * outer step: solve the active subsystem by forward elimination without
//     pivoting + back substitution, over the active coordinates only
//     (active_solve_regs, active_solve_shared); step to the first sign
//     crossing, whose coordinates become exact zeros (a coordinate that is
//     active with beta == 0 was just picked and is exempt: the livelock
//     guard); when no crossing, activate ONE KKT violator, the largest
//     |grad| with the lowest index on ties, |grad| > l1 + 1e-5 (l1 +
//     max|b_j|); the column converges when there is none; at most max_outer
//     steps;
//   * polish: the CD sweeps of cd_sweeps with every coordinate active.
//
// cd_group_columns replaces the per-column iteration of
// insider_tpu/kernels/cd_pallas.py:_cd_compute (and of cd_packed.py's
// _cd_core, the same iteration in a TPU sublane layout): strong screening
// thr = alpha (2 lam - max|b_j|), the screened coordinates' warm start set
// to zero, then CD sweeps with KKT reactivation of every violator.  It is
// the cold-CD loop of every CD kernel up to K = CD_GROUP_MAX_K (320);
// past that cd_streamed and cd_shared run the block solve of fss_wide.cuh
// (wide_cd_column), whose bits the grouped loop's equal at every K.
//
// Columns are independent: a converged column is frozen in the TPU block
// (fss_pallas.py:173-177, :262; cd_pallas.py:127, :157-168), so a warp or
// group per column that stops on its own computes what the TPU block
// computes.
//
// FSS layout: lane r holds coordinates r + 32 q for q < C (C = 1 covers K
// <= 32, C = 2 K <= 64, C = 3 K <= 96, C = 4 K <= 128).  The grams are K x
// GS tiles in shared memory (GS = K + 1 against bank conflicts).  FSS compacts
// each outer step's active set; up to 32 active coordinates are eliminated
// with one compact row per lane in registers, more (K > 32 only) in a
// per-warp shared workspace.  Column-wide min / max / first-index use warp
// shuffles and ballots.  Loops over coordinates run group by group (q = 0,
// 1, ...), so every register array is indexed by a constant.
//
// cd_group_columns runs P = 32 / L columns on one warp (L = 8, 16 or 32),
// one column to each group of L lanes, on grams packed to their upper
// triangle: one issue of the per-coordinate scalar chain serves P columns,
// and a group whose column converges stores it and takes the next at a
// sweep boundary, where the kernel has one to give.  A lane holds C =
// ceil(K / L) coordinates in registers, about nine registers a slot: up to
// C = 8 at K <= 128, and past 128 C = 5 to 10 at L = 32 and (cd_streamed's
// grams read through L2, past K = 192) 14 to 20 at L = 16, K rounded up to
// a multiple of 32 (by_wide_slots), to K = 320.  A
// column's bits depend neither on L nor on the columns beside it or before
// it, and equal those of fss_wide.cuh's block solve on the same symmetric
// gram (every gram the port builds is symmetric bit for bit).
// fss_group_columns does the same for FSS's outer steps (L = 4 to 32, lane
// r of a group holding coordinates r + L q and compact rows r + L q'), and
// polish_group_columns for the polish (polish_sweep); their bits are
// fss_column's.  fss_column keeps its own polish, cd_sweeps: run through
// polish_sweep at L = 32 it gave the same bits and cost the streamed
// kernel about 3% at K=128 (chip_ab.py, NVIDIA H100 80GB HBM3 at 700 W).
// At K <= 128 the fused and streamed kernels could move onto the grouped
// FSS loops as the CD kernels did onto cd_group_columns; they have not.
// Past K = 128 feature_sign and feature_sign_shared polish on
// cd_group_columns itself (polish: every coordinate active, nothing
// screened), bit for bit fss_wide.cuh's wide_cd_sweeps; their steps run a
// block a column (fss_wide.cuh: steps_kernel).
#pragma once

#include <mutex>
#include <type_traits>

#include "common.cuh"

namespace insider {
namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float KKT_RTOL = 1e-5f;   // fss_pallas.py:KKT_RTOL

// A column whose Xty or warm start holds a NaN or an Inf comes out of the
// FSS solves all NaN, as it does from the plain version
// (ops/fss.feature_sign_search) and from the TPU kernel: the solve's
// comparisons would pass over the non-finite values and return a finite
// column, which no finiteness check of the fit could see.  finite_coords:
// whether a lane's coordinates are all finite (slots past K hold 0).
__device__ __forceinline__ float not_a_number() {
  return __int_as_float(0x7fc00000);
}

template <int C>
__device__ __forceinline__ bool finite_coords(const float (&xty)[C],
                                              const float (&beta)[C]) {
  bool fin = true;
#pragma unroll
  for (int q = 0; q < C; ++q)
    fin = fin && isfinite(xty[q]) && isfinite(beta[q]);
  return fin;
}

__device__ __forceinline__ float sgn(float x) {
  return static_cast<float>((x > 0.f) - (x < 0.f));
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// The max over each group of L lanes (mask: the lanes taking part, whole
// groups).
template <int L>
__device__ __forceinline__ float group_max(float v, unsigned mask) {
  for (int o = L / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(mask, v, o, L));
  return v;
}

// The min over each group of L lanes (mask: the lanes taking part, whole
// groups).
template <int L>
__device__ __forceinline__ float group_min(float v, unsigned mask) {
  for (int o = L / 2; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(mask, v, o, L));
  return v;
}

// s[q] = sum_c G[i_q][c] * beta_c for the coordinates i_q = r + L q of a
// group of L lanes (Gr[q]: row i_q), summed as fma(G, beta, s) in order c =
// 0..K-1 from zero.  mask: the lanes calling, whole groups.
template <int C, int L = 32>
__device__ __forceinline__ void gram_times(const float* (&Gr)[C],
                                           const float (&beta)[C], int K,
                                           float (&s)[C],
                                           unsigned mask = FULL) {
#pragma unroll
  for (int q = 0; q < C; ++q) s[q] = 0.f;
#pragma unroll
  for (int qc = 0; qc < C; ++qc) {
    const int c_end = min(K, L * (qc + 1));
    for (int c = L * qc; c < c_end; ++c) {
      const float bc = __shfl_sync(mask, beta[qc], c & (L - 1), L);
#pragma unroll
      for (int q = 0; q < C; ++q) s[q] = __fmaf_rn(Gr[q][c], bc, s[q]);
    }
  }
}

// The state of the FSS polish of one column on a group of L lanes
// (coordinates r + L q): s = G beta, the diagonal d and the denominators.
template <int C>
struct Polish {
  float s[C], d[C], inv_den[C], half_den[C];
};

// The polish's prologue: s = G beta (gram_times), d = G[i][i], den = d +
// l2 (1 where not positive), inv_den = 1 / den, half_den = den / 2.  G: the
// column's K x K gram, row stride GS; mask: the lanes calling, whole groups.
template <int C, int L>
__device__ __forceinline__ void polish_start(const float* __restrict__ G,
                                             int GS, int K,
                                             const float (&beta)[C], float l2,
                                             Polish<C>& p,
                                             unsigned mask = FULL) {
  const int r = threadIdx.x & (L - 1);
  const float* Gr[C];
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int i = r + L * q;
    Gr[q] = G + (i < K ? i : 0) * GS;
  }
  gram_times<C, L>(Gr, beta, K, p.s, mask);
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int i = r + L * q;
    p.d[q] = i < K ? Gr[q][i] : 0.f;
    float den = __fadd_rn(p.d[q], l2);
    den = den > 0.f ? den : 1.f;
    p.inv_den[q] = 1.f / den;
    p.half_den[q] = 0.5f * den;
  }
}

// One polish sweep of a group's column with every coordinate active: the
// sweep loop of cd_pallas.py:_cd_compute (:111-175) in the fixed order
// 0..K-1.  Every coordinate k takes the soft-threshold update, s = G beta
// is kept by rank-1 updates (lane i reads G[k][i], row k, as the plain
// version does), and the sweep's loss decrease is summed in the
// cancellation-free form, in order k.  A frozen group (no column) keeps w
// = beta, so nothing of it moves.  Every rounding is written out (u =
// fma(beta, d, xty - s); term = fma(delta, half_den delta, l1 fma(-xi,
// beta, |beta|)); s = fma(G, delta, s)), so a column's bits depend neither
// on L nor on the columns beside it.  Every lane of the warp calls it;
// returns the group's decrease.
template <int C, int L>
__device__ __forceinline__ float polish_sweep(const float* __restrict__ G,
                                              int GS, int K,
                                              const float (&xty)[C],
                                              float (&beta)[C], Polish<C>& p,
                                              float l1, float inv_l1,
                                              bool frozen) {
  const int r = threadIdx.x & (L - 1);
  auto sign = [](float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f); };
  float dec = 0.f;
#pragma unroll
  for (int qk = 0; qk < C; ++qk) {
    const int k_end = min(K, L * (qk + 1));
    for (int k = L * qk; k < k_end; ++k) {
      // every lane evaluates the update; lane k % L's is the one used
      const float b = beta[qk];
      const float u = __fmaf_rn(b, p.d[qk], __fsub_rn(xty[qk], p.s[qk]));
      float w = __fmul_rn(
          __fmul_rn(sign(u), fmaxf(__fsub_rn(fabsf(u), l1), 0.f)),
          p.inv_den[qk]);
      if (frozen) w = b;
      const float delta = __fsub_rn(w, b);
      const float xi = w != 0.f
                           ? sign(w)
                           : fminf(fmaxf(__fmul_rn(u, inv_l1), -1.f), 1.f);
      const float term =
          __fmaf_rn(delta, __fmul_rn(p.half_den[qk], delta),
                    __fmul_rn(l1, __fmaf_rn(-xi, b, fabsf(b))));
      const float delta_k = __shfl_sync(FULL, delta, k & (L - 1), L);
      dec = __fadd_rn(dec, __shfl_sync(FULL, term, k & (L - 1), L));
      const float* Gk = G + k * GS;
#pragma unroll
      for (int q = 0; q < C; ++q)
        if (r + L * q < K)
          p.s[q] = __fmaf_rn(Gk[r + L * q], delta_k, p.s[q]);
      if (r == (k & (L - 1))) beta[qk] = w;
    }
  }
  return dec;
}

// CD sweeps of one column by one warp with every coordinate active, the
// FSS polish: the sweep loop of cd_pallas.py:_cd_compute (:111-175) in the
// fixed order 0..K-1.  G: the column's K x K gram, row stride GS; xty[q],
// beta[q]: coordinate r + 32 q (zero where r + 32 q >= K).  Per sweep,
// every coordinate k takes the soft-threshold update, s = G beta is kept by
// rank-1 updates (lane i reads G[k][i], row k, as the plain version does;
// the grams are symmetric), and the sweep's loss decrease is summed in the
// cancellation-free form; the column converges when the decrease is <=
// tol.  At most max_sweeps sweeps.
template <int C>
__device__ __forceinline__ void cd_sweeps(const float* __restrict__ G, int K,
                                          int GS, const float (&xty)[C],
                                          float (&beta)[C], float l1, float l2,
                                          float tol, int max_sweeps) {
  const int r = threadIdx.x & 31;
  bool ok[C];
  const float* Gr[C];
  float d[C], s[C], inv_den[C], half_den[C];
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int i = r + 32 * q;
    ok[q] = i < K;
    Gr[q] = G + (ok[q] ? i : 0) * GS;
  }
  gram_times<C>(Gr, beta, K, s);
#pragma unroll
  for (int q = 0; q < C; ++q) {
    d[q] = ok[q] ? Gr[q][r + 32 * q] : 0.f;
    float den = d[q] + l2;
    den = den > 0.f ? den : 1.f;
    inv_den[q] = 1.f / den;
    half_den[q] = 0.5f * den;
  }
  const float inv_l1 = 1.f / fmaxf(l1, 1e-30f);
  bool conv = false;
  for (int sweep = 0; sweep < max_sweeps && !conv; ++sweep) {
    float dec = 0.f;
#pragma unroll
    for (int qk = 0; qk < C; ++qk) {
      const int k_end = min(K, 32 * (qk + 1));
      for (int k = 32 * qk; k < k_end; ++k) {
        // every lane evaluates the update; lane k's is the one used
        const float u = xty[qk] - s[qk] + beta[qk] * d[qk];
        const float w = sgn(u) * fmaxf(fabsf(u) - l1, 0.f) * inv_den[qk];
        const float delta = w - beta[qk];
        const float xi = w != 0.f ? sgn(w)
                                  : fminf(fmaxf(u * inv_l1, -1.f), 1.f);
        const float term = half_den[qk] * delta * delta +
                           l1 * (fabsf(beta[qk]) - xi * beta[qk]);
        const float delta_k = __shfl_sync(FULL, delta, k & 31);
        dec = dec + __shfl_sync(FULL, term, k & 31);
        const float* Gk = G + k * GS;
#pragma unroll
        for (int q = 0; q < C; ++q)
          if (ok[q]) s[q] = s[q] + Gk[r + 32 * q] * delta_k;
        if (r == (k & 31)) beta[qk] = w;
      }
    }
    conv = fabsf(dec) <= tol;   // warp-uniform
  }
}

// Position of the (k+1)-th set bit of m, k < popc(m): a binary search on
// the popcounts of the low halves.
__device__ __forceinline__ int nth_set_bit(unsigned m, int k) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    const int lo = __popc(m & ((1u << w) - 1u));
    if (k >= lo) {
      k -= lo;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

// Row stride of the shared elimination workspace: >= K, 4 (mod 8) floats,
// so rows are 16-byte aligned and the 16-byte loads of eight lanes from
// eight rows fall in distinct banks.
__host__ __device__ constexpr int ws_stride(int K) {
  return ((K + 3) & ~7) + 4;
}

// Floats of one warp's shared workspace for active sets above 32
// coordinates: the compacted system (K x ws_stride), the active list and
// its right-hand side, rounded up to keep what follows 16-byte aligned.
__host__ __device__ constexpr int wide_workspace_floats(int K) {
  return K * ws_stride(K) + ((2 * K + 3) & ~3);
}

// Floats of one pivot-row buffer of active_solve_regs (32 entries and the
// right-hand side's), two of which lead every warp's FSS workspace.
constexpr int PIVOT_ROW = 36;

// The active subsystem of fss_column,
//     (G + l2 I)[A, A] x = rhs[A],
// solved over the compacted active coordinates A (a = |A| of them, in
// ascending order) by forward elimination without pivoting + back
// substitution.  rhs[q] holds coordinate r + 32 q (lane r) on entry and its
// solution on return, 0 where inactive.  bal[q]: the ballot of active
// coordinates of group q; base[q]: the active coordinates in groups < q.
//
// The TPU kernel (fss_pallas.py:120-160) eliminates all K pivots, inactive
// ones as identity rows; an inactive pivot or row only ever subtracts exact
// zeros (x - 0 * y == x), so skipping them computes the same values with a^3
// work in place of K^3.  Every update keeps the form x - colk * y of the
// full-width elimination, so nvcc contracts it into the same FMA.
//
// Here a <= 32: compact row r sits in lane r, in registers (u[c], column c
// of the compact system; AMAX >= a is the register width, a multiple of
// 4).  The pivot lane normalizes its row in registers and writes it to a
// pivot-row buffer in shared memory (P: two of PIVOT_ROW floats, used in
// turn, so one barrier a pivot suffices); each lane below reads it as
// 16-byte broadcasts and updates its own row in registers, independent
// FMAs.
template <int AMAX, int C>
__device__ __forceinline__ void active_solve_regs(const float* __restrict__ G,
                                                  int GS,
                                                  const unsigned (&bal)[C],
                                                  const int (&base)[C], int a,
                                                  float l2, float (&rhs)[C],
                                                  float* __restrict__ P) {
  static_assert(AMAX % 4 == 0 && AMAX <= 32, "AMAX: a multiple of 4, <= 32");
  const int r = threadIdx.x & 31;
  int ci = 0;                    // the coordinate of compact row r
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int k = r - base[q];
    if (k >= 0 && k < __popc(bal[q])) ci = 32 * q + nth_set_bit(bal[q], k);
  }
  float b = 0.f;
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const float v = __shfl_sync(FULL, rhs[q], ci & 31);
    if ((ci >> 5) == q) b = v;
  }
  const float* Gi = G + ci * GS;
  float u[AMAX];
#pragma unroll
  for (int c = 0; c < AMAX; ++c) {
    const int cc = __shfl_sync(FULL, ci, c);
    const float g = c < a ? Gi[cc] : 0.f;
    u[c] = c == r ? g + l2 : g;
  }

  // forward elimination: rows below the pivot take x - colk * (pivot row
  // entry / pivot); the pivot lane keeps its normalized row
#pragma unroll
  for (int p = 0; p < AMAX; ++p) {
    if (p >= a) break;                       // warp-uniform
    float* Pp = P + (p & 1) * PIVOT_ROW;
    if (r == p) {
      const float inv = 1.f / u[p];
      b = b * inv;
#pragma unroll
      for (int c = p + 1; c < AMAX; ++c) u[c] = u[c] * inv;
#pragma unroll
      for (int c0 = (p + 1) & ~3; c0 < AMAX; c0 += 4)
        if (c0 < a)
          *reinterpret_cast<float4*>(Pp + c0) =
              make_float4(u[c0], u[c0 + 1], u[c0 + 2], u[c0 + 3]);
      Pp[32] = b;
    }
    __syncwarp();
    if (r > p) {
      const float colk = u[p];
#pragma unroll
      for (int c0 = (p + 1) & ~3; c0 < AMAX; c0 += 4) {
        if (c0 < a) {
          const float4 v = *reinterpret_cast<const float4*>(Pp + c0);
          if (c0 > p) u[c0] = u[c0] - colk * v.x;
          if (c0 + 1 > p) u[c0 + 1] = u[c0 + 1] - colk * v.y;
          if (c0 + 2 > p) u[c0 + 2] = u[c0 + 2] - colk * v.z;
          u[c0 + 3] = u[c0 + 3] - colk * v.w;
        }
      }
      b = b - colk * Pp[32];
    }
  }
  __syncwarp();
  // back substitution
#pragma unroll
  for (int k = AMAX - 1; k >= 1; --k) {
    if (k < a) {                             // warp-uniform
      const float xk = __shfl_sync(FULL, b, k);
      if (r < k) b = b - u[k] * xk;
    }
  }
  // back to the coordinates' lanes
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int pos = base[q] + __popc(bal[q] & ((1u << r) - 1u));
    const float v = __shfl_sync(FULL, b, pos & 31);
    rhs[q] = (bal[q] >> r) & 1u ? v : 0.f;
  }
}

// The same solve for a > 32 (K > 32), in the shared workspace W
// (wide_workspace_floats(K)): the compacted system U (a x WS), the active
// list and its right-hand side.  Lane r holds compact rows r + 32 q.  The
// pivots go in pairs (p, p + 1): the lanes normalize row p's entries (one
// each, as in the full-width kernel), bring row p + 1 and each row's entry
// in column p + 1 through pivot p, normalize row p + 1, and then update
// every row below p + 1 with both pivots in one pass, eight columns at a
// time: each entry takes x - colk_p y_p, then - colk_{p+1} y_{p+1}, the
// full-width kernel's two updates in its order, for one load and one store
// of the trailing rows a pair.  A chunk's loads are issued together, ahead
// of its stores; it starts at the 16-byte boundary at or below the first
// trailing column, and the columns left of it that it also writes are
// never read again.
template <int C>
__device__ __forceinline__ void active_solve_shared(
    const float* __restrict__ G, int GS, float* __restrict__ W, int K,
    const unsigned (&bal)[C], const int (&base)[C], int a, float l2,
    float (&rhs)[C]) {
  const int r = threadIdx.x & 31;
  const int WS = ws_stride(K);
  float* U = W;
  int* idx = reinterpret_cast<int*>(W + K * WS);
  float* vec = W + K * WS + K;
#pragma unroll
  for (int q = 0; q < C; ++q) {
    if ((bal[q] >> r) & 1u) {
      const int pos = base[q] + __popc(bal[q] & ((1u << r) - 1u));
      idx[pos] = r + 32 * q;
      vec[pos] = rhs[q];
    }
  }
  __syncwarp();
  float b[C];
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int cr = r + 32 * q;
    b[q] = 0.f;
    if (cr < a) {
      const float* Gi = G + idx[cr] * GS;
      float* Ui = U + cr * WS;
      for (int c = 0; c < a; c += 4) {
        int cc[4];
        float g[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) cc[h] = c + h < a ? idx[c + h] : 0;
#pragma unroll
        for (int h = 0; h < 4; ++h) g[h] = Gi[cc[h]];
#pragma unroll
        for (int h = 0; h < 4; ++h)
          if (c + h < a) Ui[c + h] = c + h == cr ? g[h] + l2 : g[h];
      }
      b[q] = vec[cr];
    }
  }
  __syncwarp();

  // b of compact row i (a shuffle from its lane; C is a constant)
  auto b_of = [&](int i) {
    float v = b[0];
#pragma unroll
    for (int q = 1; q < C; ++q)
      if ((i >> 5) == q) v = b[q];
    return __shfl_sync(FULL, v, i & 31);
  };
  // the pivot row's entries past it over the pivot, one a lane; the
  // pivot's right-hand side too (in its lane)
  auto normalize = [&](float* Up, int p) {
    const float inv = 1.f / Up[p];
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int c = r + 32 * q;
      if (c > p && c < a) Up[c] = Up[c] * inv;
      if (c == p) b[q] = b[q] * inv;
    }
  };
  for (int p = 0; p < a;) {
    const bool two = p + 1 < a;              // warp-uniform
    const int p2 = two ? p + 1 : p;          // the last pivot of this pass
    float* Up = U + p * WS;
    float* Uq = Up + WS;
    normalize(Up, p);
    __syncwarp();
    const float b_p = b_of(p);
    float colk[C], colk1[C];
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int i = r + 32 * q;
      const bool live = i > p && i < a;
      colk[q] = live ? U[i * WS + p] : 0.f;
      if (live) b[q] = b[q] - colk[q] * b_p;
      colk1[q] = 0.f;
    }
    if (two) {
      const float l = Uq[p];
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const int c = r + 32 * q;
        if (c > p && c < a) Uq[c] = Uq[c] - l * Up[c];
      }
      __syncwarp();
      normalize(Uq, p2);
      __syncwarp();
      const float b_p2 = b_of(p2);
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const int i = r + 32 * q;
        if (i > p2 && i < a) {
          colk1[q] = U[i * WS + p2] - colk[q] * Up[p2];
          b[q] = b[q] - colk1[q] * b_p2;
        }
      }
    }
    bool live[C];
#pragma unroll
    for (int q = 0; q < C; ++q) live[q] = r + 32 * q > p2 && r + 32 * q < a;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = (p2 + 1) & ~3; c0 < a; c0 += 8) {
      const bool hi = c0 + 4 < a;
      const float4 y0 = *reinterpret_cast<const float4*>(Up + c0);
      const float4 y1 = hi ? *reinterpret_cast<const float4*>(Up + c0 + 4)
                           : zero;
      const float4 z0 = two ? *reinterpret_cast<const float4*>(Uq + c0)
                            : zero;
      const float4 z1 = two && hi
                            ? *reinterpret_cast<const float4*>(Uq + c0 + 4)
                            : zero;
      float4 x0[C], x1[C];
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const float* Ui = U + (r + 32 * q) * WS + c0;
        if (live[q]) {
          x0[q] = *reinterpret_cast<const float4*>(Ui);
          if (hi) x1[q] = *reinterpret_cast<const float4*>(Ui + 4);
        }
      }
#pragma unroll
      for (int q = 0; q < C; ++q) {
        float* Ui = U + (r + 32 * q) * WS + c0;
        if (live[q]) {
          const float k = colk[q], k1 = colk1[q];
          x0[q].x = x0[q].x - k * y0.x;
          x0[q].y = x0[q].y - k * y0.y;
          x0[q].z = x0[q].z - k * y0.z;
          x0[q].w = x0[q].w - k * y0.w;
          if (two) {
            x0[q].x = x0[q].x - k1 * z0.x;
            x0[q].y = x0[q].y - k1 * z0.y;
            x0[q].z = x0[q].z - k1 * z0.z;
            x0[q].w = x0[q].w - k1 * z0.w;
          }
          *reinterpret_cast<float4*>(Ui) = x0[q];
          if (hi) {
            x1[q].x = x1[q].x - k * y1.x;
            x1[q].y = x1[q].y - k * y1.y;
            x1[q].z = x1[q].z - k * y1.z;
            x1[q].w = x1[q].w - k * y1.w;
            if (two) {
              x1[q].x = x1[q].x - k1 * z1.x;
              x1[q].y = x1[q].y - k1 * z1.y;
              x1[q].z = x1[q].z - k1 * z1.z;
              x1[q].w = x1[q].w - k1 * z1.w;
            }
            *reinterpret_cast<float4*>(Ui + 4) = x1[q];
          }
        }
      }
    }
    __syncwarp();
    p = p2 + 1;
  }
#pragma unroll
  for (int qk = C - 1; qk >= 0; --qk) {
    const int k_top = min(a, 32 * (qk + 1)) - 1;
    for (int k = k_top; k >= max(1, 32 * qk); --k) {
      const float xk = __shfl_sync(FULL, b[qk], k & 31);
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const int i = r + 32 * q;
        if (i < k) b[q] = b[q] - U[i * WS + k] * xk;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < C; ++q)
    if (r + 32 * q < a) vec[r + 32 * q] = b[q];
  __syncwarp();
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int pos = base[q] + __popc(bal[q] & ((1u << r) - 1u));
    rhs[q] = (bal[q] >> r) & 1u ? vec[pos] : 0.f;
  }
  __syncwarp();
}

// FSS + polish of one column by one warp.  G: the column's K x K gram, row
// stride GS; W: this warp's shared workspace, 16-byte aligned
// (Solver<false>::workspace_floats(C, K): two pivot-row buffers, then for
// C > 1 the wide solve's); xty[q], beta[q]: coordinate r + 32 q (zero where
// r + 32 q >= K; those slots take part only in shuffles).  beta is updated
// in place.  AMAX >= min(K, 32), a multiple of 4: the register width of the
// active solve.
template <int AMAX, int C>
__device__ __forceinline__ void fss_column(const float* __restrict__ G,
                                           float* __restrict__ W, int K,
                                           int GS, const float (&xty)[C],
                                           float (&beta)[C], float l1,
                                           float l2, float tol,
                                           int max_outer, int polish_sweeps) {
  const int r = threadIdx.x & 31;
  bool ok[C];
  const float* Gr[C];
  float act[C], theta[C];
  float xmax = fabsf(xty[0]);
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int i = r + 32 * q;
    ok[q] = i < K;
    Gr[q] = G + (ok[q] ? i : 0) * GS;
    act[q] = beta[q] != 0.f ? 1.f : 0.f;
    theta[q] = sgn(beta[q]);
    if (q > 0) xmax = fmaxf(xmax, fabsf(xty[q]));
  }
  const float thresh = l1 + KKT_RTOL * (l1 + warp_max(xmax));

  bool conv = false;
  for (int outer = 0; outer < max_outer && !conv; ++outer) {
    // the active set, compacted in ascending order, and its right-hand side
    unsigned bal[C];
    int base[C], a = 0;
    float rhs[C];
#pragma unroll
    for (int q = 0; q < C; ++q) {
      bal[q] = __ballot_sync(FULL, ok[q] && act[q] > 0.5f);
      base[q] = a;
      a += __popc(bal[q]);
      rhs[q] = xty[q] - l1 * theta[q];
    }
    if (C == 1 || a <= 32)                   // warp-uniform
      active_solve_regs<AMAX, C>(G, GS, bal, base, a, l2, rhs, W);
    else
      active_solve_shared<C>(G, GS, W + 2 * PIVOT_ROW, K, bal, base, a, l2,
                             rhs);

    // Line search to the first sign crossing.
    bool flip[C];
    float tk[C];
#pragma unroll
    for (int q = 0; q < C; ++q) {
      flip[q] = ok[q] && act[q] > 0.5f && sgn(rhs[q]) != theta[q] &&
                beta[q] != 0.f;
      const float denom = beta[q] - rhs[q];
      const float safe = (flip[q] && denom != 0.f) ? denom : 1.f;
      tk[q] = fminf(fmaxf(flip[q] ? beta[q] / safe : 1.f, 0.f), 1.f);
    }
    float tl = tk[0];
#pragma unroll
    for (int q = 1; q < C; ++q) tl = fminf(tl, tk[q]);
    const float t = warp_min(tl);
#pragma unroll
    for (int q = 0; q < C; ++q) {
      if (act[q] > 0.5f) beta[q] = beta[q] + t * (rhs[q] - beta[q]);
      if (flip[q] && tk[q] <= t && t < 1.f) beta[q] = 0.f;
      act[q] = beta[q] != 0.f ? 1.f : 0.f;
      theta[q] = sgn(beta[q]);
    }

    // Single-violator KKT activation on a solved column: the largest
    // |grad|, the lowest index across all C groups on ties (groups are
    // ballotted in order, so the first group holding a maximum wins).
    const bool solved = t >= 1.f;
    float s[C];
    gram_times<C>(Gr, beta, K, s);
    float grad[C], score[C];
    bool viol[C];
    float smax = -1.f;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      grad[q] = s[q] + l2 * beta[q] - xty[q];
      viol[q] = ok[q] && act[q] < 0.5f && fabsf(grad[q]) > thresh && solved;
      score[q] = viol[q] ? fabsf(grad[q]) : -1.f;
      smax = q == 0 ? score[q] : fmaxf(smax, score[q]);
    }
    const float best = warp_max(smax);
    bool picked = false;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const unsigned first = __ballot_sync(FULL, viol[q] && score[q] >= best);
      if (!picked && first != 0u) {
        if (r == __ffs(first) - 1) {
          act[q] = 1.f;
          theta[q] = -sgn(grad[q]);
        }
        picked = true;
      }
    }
    conv = solved && !(best > 0.f);
    __syncwarp();
  }

  if (polish_sweeps > 0) {
    cd_sweeps<C>(G, K, GS, xty, beta, l1, l2, tol, polish_sweeps);
  }
}

// A gram packed to its upper triangle for a group of L lanes: row a holds
// G[a][a..K-1] from offset R[a], so G[i][c] lies at R[min(i, c)] + |i - c|.
// R[a] - a takes distinct values mod L over each block of L rows (the
// rows of one slot of a group's lanes, coordinates r + L q): the L lanes
// of a group then read one row (R[k] - k + i) or one column (R[i] - i + k)
// of their gram in distinct banks, and the P groups of a warp, whose grams
// lie L (mod 32) floats apart, in distinct ones too.  The rows of a block
// are laid out one after the other, each time the first row of the block
// not yet placed whose residue is free at the next offset, else the
// offset moves on by one float: K (K + 1) / 2 floats and a few more (57 at
// K=50, L=16; in row order 315).  Writes R[0..K-1] where R is given;
// returns the floats of the packed gram.
template <int L>
__host__ __device__ int packed_rows(int K, int* R = nullptr) {
  int v = 0;
  for (int b = 0; b < K; b += L) {
    const int n = K - b < L ? K - b : L;
    unsigned used = 0, left = n == 32 ? FULL : (1u << n) - 1u;
    while (left != 0u) {
      int a = -1;
      for (int t = 0; t < n && a < 0; ++t)
        if (((left >> t) & 1u) && !((used >> ((v - b - t) & (L - 1))) & 1u))
          a = b + t;
      if (a < 0) {
        ++v;
        continue;
      }
      used |= 1u << ((v - a) & (L - 1));
      left &= ~(1u << (a - b));
      if (R != nullptr) R[a] = v;
      v += K - a;
    }
  }
  return v;
}

// Floats from one packed gram to the next where several lie side by side:
// packed_rows rounded up to L (mod 32), so that column c's gram starts c L
// floats (mod 32) from column 0's.
template <int L>
__host__ __device__ int packed_stride(int K) {
  const int n = packed_rows<L>(K);
  return n + ((L - n) & 31);
}

// The largest K of cd_group_columns' instances (CD_GROUP_MAX_K / 32 slots
// a lane at L = 32, twice that at L = 16); past it the block solve runs.
constexpr int CD_GROUP_MAX_K = 320;

// The row starts of a packed gram and packed_stride, as the host computes
// them for a launch (kernel parameters, 1.3 KB; the kernel copies them to
// shared memory).
struct Rows {
  int start[CD_GROUP_MAX_K];
  int stride;
};

// Calls f(std::integral_constant<int, C16>(), std::integral_constant<int,
// C32>()) with the slots a lane of cd_group_columns' instances past 128
// coordinates, at L = 16 and L = 32: K rounded up to a multiple of 32, for
// 128 < K <= CD_GROUP_MAX_K.
template <class F>
inline cudaError_t by_wide_slots(int K, F f) {
  using std::integral_constant;
  if (K <= 160)
    return f(integral_constant<int, 10>(), integral_constant<int, 5>());
  if (K <= 192)
    return f(integral_constant<int, 12>(), integral_constant<int, 6>());
  if (K <= 224)
    return f(integral_constant<int, 14>(), integral_constant<int, 7>());
  if (K <= 256)
    return f(integral_constant<int, 16>(), integral_constant<int, 8>());
  if (K <= 288)
    return f(integral_constant<int, 18>(), integral_constant<int, 9>());
  return f(integral_constant<int, 20>(), integral_constant<int, 10>());
}

// An instance of cd_group_columns: C slots a lane in groups of L lanes;
// GLOBAL: its grams read from device memory through L2 (cd_streamed past
// 128 coordinates), else from shared memory.
template <int C_, int L_, bool GLOBAL_ = false>
struct Group {
  static constexpr int C = C_, L = L_;
  static constexpr bool GLOBAL = GLOBAL_;
};

// Runs launch(g) for the first of the instances gs whose group width is
// `lanes` (the first of all where lanes is 0): cudaErrorInvalidValue where
// none is.
template <class Launch, class... Gs>
cudaError_t launch_width(int lanes, Launch&& launch, Gs... gs) {
  cudaError_t err = cudaErrorInvalidValue;
  bool found = false;
  (
      [&](auto g) {
        using G = decltype(g);
        if (found || (lanes != 0 && lanes != G::L)) return;
        found = true;
        err = launch(g);
      }(gs),
      ...);
  return err;
}

// The next value of a counter in shared or device memory for a group of L
// lanes: its first lane adds one; mask: the lanes calling, whole groups.
template <int L>
__device__ __forceinline__ int group_take(int* counter, unsigned mask) {
  int t = 0;
  if ((threadIdx.x & (L - 1)) == 0) t = atomicAdd(counter, 1);
  return __shfl_sync(mask, t, 0, L);
}

// Cold strong-rule CD, the loop of every CD kernel up to CD_GROUP_MAX_K
// coordinates: P = 32 / L columns on one warp, one to each group of L
// lanes.  Lane g L + r holds
// coordinates r + L q, q < C, of group g's column, whose gram is packed
// (packed_rows; R: its row starts, shared by every column).  The columns
// come from `feed`:
//   int next(unsigned mask)   the group's next column, -1 when none is
//                             left (called by the lanes of mask, whole
//                             groups; the same value across a group);
//   static bool REFILL        whether next is asked again at the sweep
//                             boundaries (else only before the first);
//   const float* gram(int c)  column c's packed gram (gram(0) is readable
//                             by every group);
//   float xty(int c, int i), float beta0(int c, int i)
//                             coordinate i of column c's Xty and warm start;
//   void store(int c, int i, float v)
//                             coordinate i of column c's solution.
// A group takes a column, runs its prologue (cd_pallas.py:91-100: the
// screening threshold in the TPU kernel's operation order, the screened
// coordinates' warm start set to zero, s = G beta, the diagonal and the
// denominators) and sweeps it, coordinates in the fixed order 0..K-1 (the
// sweep loop of cd_pallas.py:_cd_compute, :111-175).  The groups of a warp
// sweep in lockstep while any holds a column.  With REFILL a group whose
// column converged or ran max_sweeps sweeps stores it and takes the next
// at the sweep boundary, while the others wait there; without, each group
// sweeps one column, frozen once converged, until every group of the warp
// has converged or max_sweeps sweeps have run.  A group with no column, or
// frozen, keeps w = beta, so nothing of it moves.  Per sweep, every active
// coordinate k takes the soft-threshold update, s = G beta is kept by
// rank-1 updates (lane i reads G[i][k], the plain version's row k; the
// grams are symmetric), and the sweep's loss decrease is summed in the
// cancellation-free form.  A column whose decrease is <= tol is a
// candidate: every inactive coordinate with |s - xty| > l1 is activated,
// and it converges when there is none.  The active set changes only
// between sweeps.
//
// Every rounding is written out (s = fma(G, beta, s) in order c; l2 = lam
// (1 - alpha), den = d + l2, each rounded, as the JAX kernel and the plain
// version compute them; u = fma(beta, d, xty - s); term = fma(delta,
// half_den delta, l1 fma(-xi, beta, |beta|)); s = fma(G, delta, s)), the
// sign is taken by selects, and each coordinate's decrease term is kept in
// its lane and summed after the sweep in order k, off the chain from one
// coordinate to the next.  Shuffles and ballots stay inside the group.  So
// a column's bits depend neither on L nor on the columns beside it, nor on
// when or where it was taken.  They equal wide_cd_column's (fss_wide.cuh),
// which reads the gram's row k where this loop reads its column k: the
// same values on a symmetric gram.
//
// ROW_MAJOR: the grams are K x K, row-major (R is not read), and lane i reads
// G[k][i], row k, where the packed loop reads column k: on the symmetric
// gram the same value, and a group's L lanes read L neighbouring floats.
// For grams in device memory (cd_streamed's copies past 128 coordinates,
// read through L2): a sweep issues each coordinate's row one coordinate
// ahead, so its loads are in flight while the chain before it runs.
//
// polish: the FSS polish past 128 coordinates (feature_sign and
// feature_sign_shared run the CD kernels' grouped instances on their FSS
// result): lam and alpha are the solver's l1 and l2, every coordinate is
// active and no warm start is screened, so a column converges when a
// sweep's decrease is <= tol: the sweeps of fss_wide.cuh's wide_cd_sweeps
// with every flag set, bit for bit.
template <int C, int L, bool ROW_MAJOR = false, class Feed>
__device__ __forceinline__ void cd_group_columns(Feed& feed,
                                                 const int* __restrict__ R,
                                                 int K, float lam,
                                                 float alpha, float tol,
                                                 int max_sweeps,
                                                 bool polish = false) {
  static_assert(L == 8 || L == 16 || L == 32, "L: 8, 16 or 32");
  const int r = threadIdx.x & (L - 1);
  const unsigned group = (FULL >> (32 - L)) << (threadIdx.x & 31 & ~(L - 1));
  const float l1 = polish ? lam : lam * alpha;
  const float l2 = polish ? alpha : __fmul_rn(lam, __fsub_rn(1.f, alpha));
  const float inv_l1 = 1.f / fmaxf(l1, 1e-30f);
  bool ok[C];
  int below[C];                            // R[i] - i: G[i][c] for c >= i
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int i = r + L * q;
    ok[q] = i < K;
    below[q] = !ok[q] ? 0 : ROW_MAJOR ? i * K : R[i] - i;
  }
  // where column c's entries start: R[c] - c (packed), c K (ROW_MAJOR)
  auto row = [&](int c) { return ROW_MAJOR ? c * K : R[c] - c; };
  // G[i_q][c]: column c of rows above it (slots past qc), row i_q at and
  // past the diagonal (slots before qc), either in slot qc; ROW_MAJOR:
  // row c
  auto at = [&](int q, int qc, int c, int above) {
    const int i = r + L * q;
    if constexpr (ROW_MAJOR) return above + i;
    return q > qc   ? above + i
           : q < qc ? below[q] + c
                    : (c <= i ? above + i : below[q] + c);
  };
  auto sign = [](float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f); };
  // the group's column is stored all NaN: its warm start holds a NaN or an
  // Inf, or its Xty an Inf, where the plain version's column comes out
  // non-finite and the sweeps' selects would pass over the values and
  // return a finite one (a NaN in Xty fails the screen and the KKT check
  // here as there, and the column solves to its screened warm start)
  bool nonfinite = false;
  auto store = [&](int c, const float (&beta)[C]) {
#pragma unroll
    for (int q = 0; q < C; ++q)
      if (ok[q])
        feed.store(c, r + L * q, nonfinite ? not_a_number() : beta[q]);
  };

  // the group's column (-1: none) and its state
  int c = -1, sweep = 0;
  bool left = true;                        // the feed may have more
  const float* G = feed.gram(0);
  float xty[C], beta[C], d[C], s[C], inv_den[C], half_den[C];
  bool act[C];
#pragma unroll
  for (int q = 0; q < C; ++q) {
    xty[q] = beta[q] = d[q] = s[q] = inv_den[q] = half_den[q] = 0.f;
    act[q] = false;
  }
  // a group without a column takes the feed's next and runs its prologue
  // (mask: the groups taking, whole)
  auto take = [&](unsigned mask) {
    c = feed.next(mask);
    left = c >= 0;
    const unsigned got = __ballot_sync(mask, left);
    if (!left) return;
    G = feed.gram(c);
    float xmax = 0.f;                      // slots past K hold 0
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int i = r + L * q;
      xty[q] = ok[q] ? feed.xty(c, i) : 0.f;
      beta[q] = ok[q] ? feed.beta0(c, i) : 0.f;
      xmax = fmaxf(xmax, fabsf(xty[q]));
    }
    if (polish) {
#pragma unroll
      for (int q = 0; q < C; ++q) {
        act[q] = ok[q];
        s[q] = 0.f;
      }
    } else {
      const float thr =
          __fmul_rn(alpha, __fsub_rn(2.f * lam, group_max<L>(xmax, got)));
#pragma unroll
      for (int q = 0; q < C; ++q) {
        act[q] = ok[q] && fabsf(xty[q]) >= thr;
        beta[q] = beta[q] * (act[q] ? 1.f : 0.f);
        s[q] = 0.f;
      }
    }
#pragma unroll
    for (int qc = 0; qc < C; ++qc) {
      const int c_end = min(K, L * (qc + 1));
      for (int cc = L * qc; cc < c_end; ++cc) {
        const float bc = __shfl_sync(got, beta[qc], cc & (L - 1), L);
        const int above = row(cc);
#pragma unroll
        for (int q = 0; q < C; ++q)
          if (ok[q]) s[q] = __fmaf_rn(G[at(q, qc, cc, above)], bc, s[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < C; ++q) {
      d[q] = ok[q] ? G[below[q] + r + L * q] : 0.f;
      float den = __fadd_rn(d[q], l2);
      den = den > 0.f ? den : 1.f;
      inv_den[q] = 1.f / den;
      half_den[q] = 0.5f * den;
    }
    sweep = 0;
    bool bad = false;
#pragma unroll
    for (int q = 0; q < C; ++q)
      bad = bad || !isfinite(beta[q]) || isinf(xty[q]);
    nonfinite = (__ballot_sync(got, bad) & group) != 0u;
    if (max_sweeps <= 0 || nonfinite) {
      store(c, beta);
      c = -1;
    }
  };
  // refill: each group without a column takes the next, until it holds
  // one that still sweeps or none is left
  auto refill = [&]() {
    for (;;) {
      const bool want = c < 0 && left;     // uniform over the group
      const unsigned mask = __ballot_sync(FULL, want);
      if (mask == 0u) break;
      if (want) take(mask);
    }
  };
  // one sweep of every group; a frozen group (converged, or with no
  // column) keeps w = beta.  Returns whether the group's column converged
  auto sweep_once = [&](bool frozen) {
    float terms[C] = {};                   // coordinate r + L q's term
    float ahead[C];                        // ROW_MAJOR: the next row
    if constexpr (ROW_MAJOR) {
#pragma unroll
      for (int q = 0; q < C; ++q) ahead[q] = ok[q] ? G[r + L * q] : 0.f;
    }
#pragma unroll
    for (int qk = 0; qk < C; ++qk) {
      const int k_end = min(K, L * (qk + 1));
      for (int k = L * qk; k < k_end; ++k) {
        float gk[C];                       // ROW_MAJOR: row k, G[k][i_q]
        if constexpr (ROW_MAJOR) {
          const float* Gn = G + (k + 1 < K ? k + 1 : k) * K + r;
#pragma unroll
          for (int q = 0; q < C; ++q) {
            gk[q] = ahead[q];
            ahead[q] = ok[q] ? Gn[L * q] : 0.f;
          }
        }
        // every lane evaluates the update; lane k % L's is the one used
        const float b = beta[qk];
        const float u = __fmaf_rn(b, d[qk], __fsub_rn(xty[qk], s[qk]));
        float w = __fmul_rn(
            __fmul_rn(sign(u), fmaxf(__fsub_rn(fabsf(u), l1), 0.f)),
            inv_den[qk]);
        if (!act[qk] || frozen) w = b;
        const float delta = __fsub_rn(w, b);
        const float xi = w != 0.f
                             ? sign(w)
                             : fminf(fmaxf(__fmul_rn(u, inv_l1), -1.f), 1.f);
        const float term =
            __fmaf_rn(delta, __fmul_rn(half_den[qk], delta),
                      __fmul_rn(l1, __fmaf_rn(-xi, b, fabsf(b))));
        const float delta_k = __shfl_sync(FULL, delta, k & (L - 1), L);
        const int above = row(k);
#pragma unroll
        for (int q = 0; q < C; ++q) {
          if (!ok[q]) continue;
          if constexpr (ROW_MAJOR)
            s[q] = __fmaf_rn(gk[q], delta_k, s[q]);
          else
            s[q] = __fmaf_rn(G[at(q, qk, k, above)], delta_k, s[q]);
        }
        if (r == (k & (L - 1))) {
          beta[qk] = w;
          terms[qk] = term;
        }
      }
    }
    float dec = 0.f;
#pragma unroll
    for (int qk = 0; qk < C; ++qk) {
      const int k_end = min(K, L * (qk + 1));
      for (int k = L * qk; k < k_end; ++k)
        dec = __fadd_rn(dec, __shfl_sync(FULL, terms[qk], k & (L - 1), L));
    }
    bool viol[C], any = false;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      viol[q] = ok[q] && !act[q] && fabsf(__fsub_rn(s[q], xty[q])) > l1;
      any = any || viol[q];
    }
    const bool has_viol = (__ballot_sync(FULL, any) & group) != 0u;
    const bool cand = fabsf(dec) <= tol;   // uniform over the group
    if (cand)
#pragma unroll
      for (int q = 0; q < C; ++q) act[q] = act[q] || viol[q];
    return cand && !has_viol;
  };

  if (Feed::REFILL) {
    // a group stores its column as it finishes and takes the next
    for (;;) {
      refill();
      if (!__any_sync(FULL, c >= 0)) break;
      const bool conv = sweep_once(c < 0);
      if (c >= 0 && (conv || ++sweep >= max_sweeps)) {
        store(c, beta);
        c = -1;
      }
    }
  } else {
    // one column a group: a converged group is frozen until every group
    // of the warp has converged or max_sweeps sweeps have run
    refill();
    bool done = c < 0;
    for (int sw = 0; sw < max_sweeps && __any_sync(FULL, !done); ++sw)
      done = sweep_once(done) || done;
    if (c >= 0) store(c, beta);
  }
}

// The active subsystem of an FSS step for a group of L lanes (K <= 32):
// active_solve_regs' elimination with compact row r + L q' in lane r's
// slot q' (u[q'][c], column c of the compact system; AMAX >= a, a
// multiple of 4, at most L C).  bal[q]: the group's ballot of active
// coordinates r + L q (bit r); base[q]: the active coordinates in slots <
// q; a: the group's active count, amax: the largest of the warp's groups.
// P: the group's two pivot-row buffers (PIVOT_ROW floats each), used in
// turn, so one barrier a pivot suffices.  rhs[q] holds coordinate r + L q
// on entry and its solution on return, 0 where inactive.  Every update
// keeps active_solve_regs' form and order (x - colk y as one fma, the
// pivot row times the pivot's reciprocal), so a column's values do not
// depend on L.  Every lane of the warp calls it.
template <int AMAX, int C, int L>
__device__ __forceinline__ void group_active_solve(
    const float* __restrict__ G, int GS, const unsigned (&bal)[C],
    const int (&base)[C], int a, int amax, float l2, float (&rhs)[C],
    float* __restrict__ P) {
  static_assert(AMAX % 4 == 0 && AMAX <= 32 && AMAX <= L * C,
                "AMAX: a multiple of 4, <= 32, <= L C");
  const int r = threadIdx.x & (L - 1);
  int ci[C];                               // the coordinate of row r + L q'
#pragma unroll
  for (int q2 = 0; q2 < C; ++q2) {
    ci[q2] = 0;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int t = r + L * q2 - base[q];
      if (t >= 0 && t < __popc(bal[q]))
        ci[q2] = L * q + nth_set_bit(bal[q], t);
    }
  }
  float b[C];
#pragma unroll
  for (int q2 = 0; q2 < C; ++q2) {
    b[q2] = 0.f;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const float v = __shfl_sync(FULL, rhs[q], ci[q2] & (L - 1), L);
      if (ci[q2] / L == q) b[q2] = v;
    }
  }
  float u[C][AMAX];
#pragma unroll
  for (int c = 0; c < AMAX; ++c) {
    const int cc = __shfl_sync(FULL, ci[c / L], c & (L - 1), L);
#pragma unroll
    for (int q2 = 0; q2 < C; ++q2) {
      const float g = c < a ? G[ci[q2] * GS + cc] : 0.f;
      u[q2][c] = c == r + L * q2 ? __fadd_rn(g, l2) : g;
    }
  }

  // forward elimination: rows below the pivot take x - colk * (pivot row
  // entry / pivot); the pivot's lane keeps its normalized row
#pragma unroll
  for (int p = 0; p < AMAX; ++p) {
    if (p >= amax) break;                    // warp-uniform
    const int qp = p / L;                    // constants: p is unrolled
    float* Pp = P + (p & 1) * PIVOT_ROW;
    const bool live = p < a;                 // uniform over the group
    if (live && r == (p & (L - 1))) {
      const float inv = 1.f / u[qp][p];
      b[qp] = __fmul_rn(b[qp], inv);
#pragma unroll
      for (int c = p + 1; c < AMAX; ++c) u[qp][c] = __fmul_rn(u[qp][c], inv);
#pragma unroll
      for (int c0 = (p + 1) & ~3; c0 < AMAX; c0 += 4)
        if (c0 < a)
          *reinterpret_cast<float4*>(Pp + c0) =
              make_float4(u[qp][c0], u[qp][c0 + 1], u[qp][c0 + 2],
                          u[qp][c0 + 3]);
      Pp[32] = b[qp];
    }
    __syncwarp();
    if (live) {
#pragma unroll
      for (int q2 = 0; q2 < C; ++q2) {
        if (r + L * q2 <= p) continue;
        const float colk = u[q2][p];
#pragma unroll
        for (int c0 = (p + 1) & ~3; c0 < AMAX; c0 += 4) {
          if (c0 < a) {
            const float4 v = *reinterpret_cast<const float4*>(Pp + c0);
            float(&x)[AMAX] = u[q2];
            if (c0 > p) x[c0] = __fmaf_rn(-colk, v.x, x[c0]);
            if (c0 + 1 > p) x[c0 + 1] = __fmaf_rn(-colk, v.y, x[c0 + 1]);
            if (c0 + 2 > p) x[c0 + 2] = __fmaf_rn(-colk, v.z, x[c0 + 2]);
            x[c0 + 3] = __fmaf_rn(-colk, v.w, x[c0 + 3]);
          }
        }
        b[q2] = __fmaf_rn(-colk, Pp[32], b[q2]);
      }
    }
  }
  __syncwarp();
  // back substitution
#pragma unroll
  for (int k = AMAX - 1; k >= 1; --k) {
    if (k < amax) {                          // warp-uniform
      const float xk = __shfl_sync(FULL, b[k / L], k & (L - 1), L);
      if (k < a) {
#pragma unroll
        for (int q2 = 0; q2 < C; ++q2)
          if (r + L * q2 < k) b[q2] = __fmaf_rn(-u[q2][k], xk, b[q2]);
      }
    }
  }
  // back to the coordinates' lanes
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int pos = base[q] + __popc(bal[q] & ((1u << r) - 1u));
    float v = 0.f;
#pragma unroll
    for (int q2 = 0; q2 < C; ++q2) {
      const float x = __shfl_sync(FULL, b[q2], pos & (L - 1), L);
      if (pos / L == q2) v = x;
    }
    rhs[q] = (bal[q] >> r) & 1u ? v : 0.f;
  }
}

// FSS of P = 32 / L columns on one warp (K <= 32), one to each group of L
// lanes: fss_column's outer steps (its header) with lane g L + r holding
// coordinates r + L q, q < C, of group g's column.  All columns read the
// one gram G (K x K, row stride GS); P: the group's two pivot-row buffers.
// The columns come from `feed` (cd_group_columns' interface; REFILL is not
// read: a group always refills): a group takes a column (its Xty, its warm
// start beta0, and thresh = l1 + 1e-5 (l1 + max|Xty|)) and steps it; the
// groups of a warp step in lockstep while any holds a column, and a group
// whose column converged or ran max_outer steps stores the FSS result and
// takes the next at the step boundary.  Every rounding is written out
// (fss_column's, as nvcc contracts them: thresh = fma(1e-5, l1 + xmax,
// l1); rhs = fma(-l1, theta, xty); beta + t (rhs - beta) as one fma; grad
// = fma(l2, beta, s) - xty), the min, max and first-index picks do not
// depend on their order, and shuffles and ballots stay inside the group:
// a column's bits depend neither on L nor on the columns beside it.
template <int AMAX, int C, int L, class Feed>
__device__ __forceinline__ void fss_group_columns(Feed& feed,
                                                  const float* __restrict__ G,
                                                  int GS, float* P, int K,
                                                  float l1, float l2,
                                                  int max_outer) {
  static_assert(L == 4 || L == 8 || L == 16 || L == 32, "L: 4 to 32");
  const int r = threadIdx.x & (L - 1);
  const int g0 = threadIdx.x & 31 & ~(L - 1);   // the group's first lane
  const unsigned low = L == 32 ? FULL : (1u << L) - 1u;
  auto sign = [](float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f); };
  bool ok[C];
  const float* Gr[C];
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int i = r + L * q;
    ok[q] = i < K;
    Gr[q] = G + (ok[q] ? i : 0) * GS;
  }
  int c = -1, outer = 0;
  bool left = true;                        // the feed may have more
  bool nonfinite = false;                  // the group's column is NaN
  float xty[C], beta[C], theta[C], thresh = 0.f;
  bool act[C];
#pragma unroll
  for (int q = 0; q < C; ++q) {
    xty[q] = beta[q] = theta[q] = 0.f;
    act[q] = false;
  }
  auto store = [&]() {
#pragma unroll
    for (int q = 0; q < C; ++q)
      if (ok[q])
        feed.store(c, r + L * q, nonfinite ? not_a_number() : beta[q]);
    c = -1;
  };
  // a group without a column takes the feed's next (mask: the groups
  // taking, whole)
  auto take = [&](unsigned mask) {
    c = feed.next(mask);
    left = c >= 0;
    const unsigned got = __ballot_sync(mask, left);
    if (!left) return;
    float xmax = 0.f;                      // slots past K hold 0
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int i = r + L * q;
      xty[q] = ok[q] ? feed.xty(c, i) : 0.f;
      beta[q] = ok[q] ? feed.beta0(c, i) : 0.f;
      act[q] = beta[q] != 0.f;
      theta[q] = sign(beta[q]);
      xmax = fmaxf(xmax, fabsf(xty[q]));
    }
    thresh = __fmaf_rn(KKT_RTOL, __fadd_rn(l1, group_max<L>(xmax, got)), l1);
    outer = 0;
    nonfinite =
        ((__ballot_sync(got, !finite_coords<C>(xty, beta)) >> g0) & low) != 0u;
    if (max_outer <= 0 || nonfinite) store();
  };
  // one outer step of every group (live: the group holds a column).
  // Returns whether the group's column converged
  auto step = [&](bool live) {
    unsigned bal[C];
    int base[C], a = 0;
    float rhs[C];
#pragma unroll
    for (int q = 0; q < C; ++q) {
      bal[q] = (__ballot_sync(FULL, live && ok[q] && act[q]) >> g0) & low;
      base[q] = a;
      a += __popc(bal[q]);
      rhs[q] = __fmaf_rn(-l1, theta[q], xty[q]);
    }
    int amax = a;
    for (int o = 16; o >= L; o >>= 1)
      amax = max(amax, __shfl_xor_sync(FULL, amax, o));
    group_active_solve<AMAX, C, L>(G, GS, bal, base, a, amax, l2, rhs, P);

    // line search to the first sign crossing
    bool flip[C];
    float tk[C];
#pragma unroll
    for (int q = 0; q < C; ++q) {
      flip[q] = live && ok[q] && act[q] && sign(rhs[q]) != theta[q] &&
                beta[q] != 0.f;
      const float denom = __fsub_rn(beta[q], rhs[q]);
      const float safe = (flip[q] && denom != 0.f) ? denom : 1.f;
      tk[q] = fminf(fmaxf(flip[q] ? beta[q] / safe : 1.f, 0.f), 1.f);
    }
    float tl = tk[0];
#pragma unroll
    for (int q = 1; q < C; ++q) tl = fminf(tl, tk[q]);
    const float t = group_min<L>(tl, FULL);
#pragma unroll
    for (int q = 0; q < C; ++q) {
      if (live && act[q])
        beta[q] = __fmaf_rn(t, __fsub_rn(rhs[q], beta[q]), beta[q]);
      if (flip[q] && tk[q] <= t && t < 1.f) beta[q] = 0.f;
      act[q] = beta[q] != 0.f;
      theta[q] = sign(beta[q]);
    }

    // single-violator KKT activation on a solved column: the largest
    // |grad|, the lowest index on ties (slots are ballotted in order, so
    // the first slot holding a maximum wins)
    const bool solved = t >= 1.f;
    float s[C];
    gram_times<C, L>(Gr, beta, K, s);
    float grad[C], score[C];
    bool viol[C];
    float smax = -1.f;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      grad[q] = __fsub_rn(__fmaf_rn(l2, beta[q], s[q]), xty[q]);
      viol[q] = live && ok[q] && !act[q] && fabsf(grad[q]) > thresh && solved;
      score[q] = viol[q] ? fabsf(grad[q]) : -1.f;
      smax = fmaxf(smax, score[q]);
    }
    const float best = group_max<L>(smax, FULL);
    bool picked = false;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const unsigned first =
          (__ballot_sync(FULL, viol[q] && score[q] >= best) >> g0) & low;
      if (!picked && first != 0u) {
        if (r == __ffs(first) - 1) {
          act[q] = true;
          theta[q] = -sign(grad[q]);
        }
        picked = true;
      }
    }
    return solved && !(best > 0.f);
  };

  for (;;) {
    // refill: each group without a column takes the next, until it holds
    // one that still steps or none is left
    for (;;) {
      const bool want = c < 0 && left;     // uniform over the group
      const unsigned mask = __ballot_sync(FULL, want);
      if (mask == 0u) break;
      if (want) take(mask);
    }
    if (!__any_sync(FULL, c >= 0)) break;
    const bool live = c >= 0;
    const bool conv = step(live);
    if (live && (conv || ++outer >= max_outer)) store();
  }
}

// The FSS polish of the columns of `feed` (cd_group_columns' interface;
// beta0: the FSS result) on groups of L lanes, P = 32 / L columns a warp:
// polish_start, then polish_sweep until a sweep's decrease is <= tol or
// max_sweeps sweeps have run.  The groups of a warp sweep in lockstep
// while any holds a column; a group whose column is done stores it and
// takes the next at the sweep boundary.
template <int C, int L, class Feed>
__device__ __forceinline__ void polish_group_columns(
    Feed& feed, const float* __restrict__ G, int GS, int K, float l1,
    float l2, float tol, int max_sweeps) {
  const int r = threadIdx.x & (L - 1);
  const int g0 = threadIdx.x & 31 & ~(L - 1);   // the group's first lane
  const unsigned low = L == 32 ? FULL : (1u << L) - 1u;
  const float inv_l1 = 1.f / fmaxf(l1, 1e-30f);
  int c = -1, sweep = 0;
  bool left = true, nonfinite = false;
  float xty[C], beta[C];
  Polish<C> p;
#pragma unroll
  for (int q = 0; q < C; ++q)
    xty[q] = beta[q] = p.s[q] = p.d[q] = p.inv_den[q] = p.half_den[q] = 0.f;
  auto store = [&]() {
#pragma unroll
    for (int q = 0; q < C; ++q)
      if (r + L * q < K)
        feed.store(c, r + L * q, nonfinite ? not_a_number() : beta[q]);
    c = -1;
  };
  for (;;) {
    for (;;) {
      const bool want = c < 0 && left;
      const unsigned mask = __ballot_sync(FULL, want);
      if (mask == 0u) break;
      if (want) {
        c = feed.next(mask);
        left = c >= 0;
        const unsigned got = __ballot_sync(mask, left);
        if (left) {
#pragma unroll
          for (int q = 0; q < C; ++q) {
            const int i = r + L * q;
            xty[q] = i < K ? feed.xty(c, i) : 0.f;
            beta[q] = i < K ? feed.beta0(c, i) : 0.f;
          }
          polish_start<C, L>(G, GS, K, beta, l2, p, got);
          sweep = 0;
          nonfinite = ((__ballot_sync(got, !finite_coords<C>(xty, beta)) >>
                        g0) & low) != 0u;
          if (max_sweeps <= 0 || nonfinite) store();
        }
      }
    }
    if (!__any_sync(FULL, c >= 0)) break;
    const bool live = c >= 0;
    const float dec =
        polish_sweep<C, L>(G, GS, K, xty, beta, p, l1, inv_l1, !live);
    if (live && (fabsf(dec) <= tol || ++sweep >= max_sweeps)) store();
  }
}

// The column solvers as the kernels take them, with their scalars.
// workspace_floats(C, K): the shared floats a warp of the FSS solve needs
// (the pivot rows, and for C > 1 the solve of more than 32 active
// coordinates), a multiple of 4.
template <bool CD>
struct Solver;

// tol: the polish's (FSS) or the sweeps' (CD) stop, one f32 in device
// memory that the kernel reads, so a launch captured in a CUDA graph takes
// the value the buffer holds when it is replayed.
template <>
struct Solver<false> {   // FSS + polish; l1 = lam*alpha, l2 = lam*(1-alpha)
  float l1, l2;
  const float* tol;
  int max_outer, polish_sweeps;
  __host__ __device__ static constexpr int workspace_floats(int C, int K) {
    return 2 * PIVOT_ROW + (C > 1 ? wide_workspace_floats(K) : 0);
  }
};

template <>
struct Solver<true> {    // cold strong-rule CD (cd_group_columns)
  float lam, alpha;
  const float* tol;
  int max_sweeps;
};

// AMAX: fss_column's register width, >= min(K, 32).
template <int AMAX, int C>
__device__ __forceinline__ void solve_column(const Solver<false>& s,
                                             const float* G, float* W, int K,
                                             int GS, const float (&xty)[C],
                                             float (&beta)[C]) {
  if (!__all_sync(FULL, finite_coords<C>(xty, beta))) {
#pragma unroll
    for (int q = 0; q < C; ++q) beta[q] = not_a_number();
    return;
  }
  fss_column<AMAX, C>(G, W, K, GS, xty, beta, s.l1, s.l2, *s.tol,
                      s.max_outer, s.polish_sweeps);
}

// Hands out columns to warps one at a time from the counter `next` (shared
// or device memory, zeroed before the solve): a warp that finishes early
// takes the next column, so the work ends with the last column, not with
// the slowest warp's share.  Each column's arithmetic does not depend on
// the warp that runs it.
__device__ __forceinline__ int next_column(int* next) {
  int c = 0;
  if ((threadIdx.x & 31) == 0) c = atomicAdd(next, 1);
  return __shfl_sync(FULL, c, 0);
}

// Blocks an SM holds at once of `kernel` with `threads` threads and `smem`
// bytes of dynamic shared memory, and the card's SMs (remembered for the
// last device, threads and size asked, under a lock: host threads may
// launch at once).  The kernel's largest dynamic shared memory is set to
// the most it may take (max_dynamic_smem), so that no launch is refused
// for a size that another thread set.
struct Residency {
  int per_sm = 0, sms = 0;
};

template <auto kernel>
cudaError_t residency(int threads, size_t smem, Residency& out) {
  static std::mutex lock;
  static int last_dev = -1, last_threads = 0;
  static size_t last_smem = 0;
  static Residency last;
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> held(lock);
  if (dev != last_dev || threads != last_threads || smem != last_smem) {
    Residency r;
    if ((err = max_dynamic_smem<kernel>(most)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&r.sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &r.per_sm, kernel, threads, smem)) != cudaSuccess)
      return err;
    last_dev = dev;
    last_threads = threads;
    last_smem = smem;
    last = r;
  }
  out = last;
  return cudaSuccess;
}

// Calls f(std::integral_constant<int, C>()) with C = ceil(K / 32), the
// coordinates per lane of the gram-input kernels, for 1 <= K <= 128.
template <class F>
inline cudaError_t by_lane_count(int K, F f) {
  if (K <= 32) return f(std::integral_constant<int, 1>());
  if (K <= 64) return f(std::integral_constant<int, 2>());
  if (K <= 96) return f(std::integral_constant<int, 3>());
  return f(std::integral_constant<int, 4>());
}

// Calls f(std::integral_constant<int, C>(), std::integral_constant<int,
// AMAX>()) with C = ceil(K / 32) and AMAX, fss_column's register width: K
// rounded up to a multiple of 8 for K <= 32, else 32.
template <class F>
inline cudaError_t by_width(int K, F f) {
  using std::integral_constant;
  if (K <= 8)
    return f(integral_constant<int, 1>(), integral_constant<int, 8>());
  if (K <= 16)
    return f(integral_constant<int, 1>(), integral_constant<int, 16>());
  if (K <= 24)
    return f(integral_constant<int, 1>(), integral_constant<int, 24>());
  return by_lane_count(
      K, [&](auto c) { return f(c, integral_constant<int, 32>()); });
}

// Reads coordinates r + 32 q of column j of a row-major (K, M) matrix (r:
// the lane).
template <int C>
__device__ __forceinline__ void load_coords(const float* __restrict__ X,
                                            int K, int M, int j,
                                            float (&v)[C]) {
  const int r = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int i = r + 32 * q;
    v[q] = i < K ? X[(size_t)i * M + j] : 0.f;
  }
}

template <int C>
__device__ __forceinline__ void store_coords(float* __restrict__ X, int K,
                                             int M, int j,
                                             const float (&v)[C]) {
  const int r = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int i = r + 32 * q;
    if (i < K) X[(size_t)i * M + j] = v[q];
  }
}

}  // namespace
}  // namespace insider
