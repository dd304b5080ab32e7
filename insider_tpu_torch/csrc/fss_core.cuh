// The column solves of one gene by one warp, shared by the fused (fss.cu),
// streamed (fss_streamed.cu) and shared-gram (fss_shared.cu) kernels: the
// feature-sign search (FSS) with its polish, and the cold strong-rule
// coordinate descent (CD).  Each kernel is a template on the solver
// (Solver<false> FSS, Solver<true> CD) and calls solve_column.
//
// fss_column replaces the per-column iteration of
// insider_tpu/kernels/fss_pallas.py:_fss_compute.  For column j, with gram
// G_j and b_j = Xty[:, j], it minimizes
//     1/2 b^T G_j b - b_j^T b + l2/2 |b|^2 + l1 |b|_1
// from the warm start beta0[:, j], with the TPU kernel's iteration:
//   * outer step: solve the active subsystem by forward elimination without
//     pivoting + back substitution; step to the first sign crossing, whose
//     coordinates become exact zeros (a coordinate that is active with
//     beta == 0 was just picked and is exempt: the livelock guard); when no
//     crossing, activate ONE KKT violator, the largest |grad| with the
//     lowest index on ties, |grad| > l1 + 1e-5 (l1 + max|b_j|); the column
//     converges when there is none; at most max_outer steps;
//   * polish: the CD sweeps of cd_sweeps with every coordinate active.
//
// cd_column replaces the per-column iteration of
// insider_tpu/kernels/cd_pallas.py:_cd_compute (and of cd_packed.py's
// _cd_core, the same iteration in a TPU sublane layout): strong screening
// thr = alpha (2 lam - max|b_j|), the screened coordinates' warm start set
// to zero, then cd_sweeps with KKT reactivation of every violator.
//
// Columns are independent: a converged column is frozen in the TPU block
// (fss_pallas.py:173-177, :262; cd_pallas.py:127, :157-168), so one warp
// per column that exits on its own computes what the TPU block computes.
//
// Layout: lane r holds coordinates r + 32 q for q < C (C = 1 covers K <= 32,
// C = 2 K <= 64, C = 3 K <= 96, C = 4 K <= 128).  The elimination workspace
// U is a K x GS tile in shared memory per warp (GS = K + 1 against bank
// conflicts); pivot rows are read as shared-memory broadcasts, and
// column-wide min / max / first-index use warp shuffles and ballots.  Loops
// over coordinates run group by group (q = 0, 1, ...), so every register
// array is indexed by a constant.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace insider {
namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float KKT_RTOL = 1e-5f;   // fss_pallas.py:KKT_RTOL

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

// s[q] = sum_c G[i_q][c] * beta_c, summed in order c = 0..K-1.
template <int C>
__device__ __forceinline__ void gram_times(const float* (&Gr)[C],
                                           const float (&beta)[C], int K,
                                           float (&s)[C]) {
#pragma unroll
  for (int q = 0; q < C; ++q) s[q] = 0.f;
#pragma unroll
  for (int qc = 0; qc < C; ++qc) {
    const int c_end = min(K, 32 * (qc + 1));
    for (int c = 32 * qc; c < c_end; ++c) {
      const float bc = __shfl_sync(FULL, beta[qc], c & 31);
#pragma unroll
      for (int q = 0; q < C; ++q) s[q] += Gr[q][c] * bc;
    }
  }
}

// CD sweeps of one column by one warp, coordinates in the fixed order
// 0..K-1: the sweep loop of cd_pallas.py:_cd_compute (:111-175).  G: the
// column's K x K gram, row stride GS; xty[q], beta[q], act[q]: coordinate
// r + 32 q (zero / false where r + 32 q >= K).  Per sweep, every active
// coordinate k takes the soft-threshold update, s = G beta is kept by
// rank-1 updates (lane i reads G[k][i], row k, as the plain version does;
// the grams are symmetric), and the sweep's loss decrease is summed in the
// cancellation-free form.  A column whose decrease is <= tol is a
// candidate: with STRONG every inactive coordinate with |s - xty| > l1 is
// activated, and the candidate converges only when there is none; without
// it (every coordinate active: the FSS polish) the candidate converges.
// The active set changes only between sweeps.  At most max_sweeps sweeps.
template <int C, bool STRONG>
__device__ __forceinline__ void cd_sweeps(const float* __restrict__ G, int K,
                                          int GS, const float (&xty)[C],
                                          float (&beta)[C], bool (&act)[C],
                                          float l1, float l2, float tol,
                                          int max_sweeps) {
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
        float w = sgn(u) * fmaxf(fabsf(u) - l1, 0.f) * inv_den[qk];
        if (STRONG && !act[qk]) w = beta[qk];
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
    const bool cand = fabsf(dec) <= tol;   // warp-uniform
    if (STRONG) {
      bool viol[C], any = false;
#pragma unroll
      for (int q = 0; q < C; ++q) {
        viol[q] = ok[q] && !act[q] && fabsf(s[q] - xty[q]) > l1;
        any = any || viol[q];
      }
      const bool has_viol = __any_sync(FULL, any);
      if (cand)
#pragma unroll
        for (int q = 0; q < C; ++q) act[q] = act[q] || viol[q];
      conv = cand && !has_viol;
    } else {
      conv = cand;
    }
  }
}

// FSS + polish of one column by one warp.  G: the column's K x K gram, row
// stride GS; U: this warp's K x GS workspace; xty[q], beta[q]: coordinate
// r + 32 q (zero where r + 32 q >= K; those slots take part only in
// shuffles).  beta is updated in place.
template <int C>
__device__ __forceinline__ void fss_column(const float* __restrict__ G, float* __restrict__ U,
                           int K, int GS, const float (&xty)[C],
                           float (&beta)[C], float l1, float l2, float tol,
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
    // U = G restricted to the active set, + l2 on active diagonals,
    // identity on inactive ones.
    float rhs[C];
#pragma unroll
    for (int q = 0; q < C; ++q) rhs[q] = (xty[q] - l1 * theta[q]) * act[q];
#pragma unroll
    for (int qc = 0; qc < C; ++qc) {
      const int c_end = min(K, 32 * (qc + 1));
      for (int c = 32 * qc; c < c_end; ++c) {
        const float ac = __shfl_sync(FULL, act[qc], c & 31);
#pragma unroll
        for (int q = 0; q < C; ++q)
          if (ok[q]) U[(r + 32 * q) * GS + c] = Gr[q][c] * act[q] * ac;
      }
    }
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int i = r + 32 * q;
      if (ok[q]) U[i * GS + i] = U[i * GS + i] + l2 * act[q] + (1.f - act[q]);
    }
    __syncwarp();

    // Forward elimination: the lane of row i > p normalizes entry i of
    // pivot row p, then updates row i.  Columns <= p of the rows below are
    // never read again, so they are not updated.
#pragma unroll
    for (int qp = 0; qp < C; ++qp) {
      const int p_end = min(K, 32 * (qp + 1));
      for (int p = 32 * qp; p < p_end; ++p) {
        const float inv = 1.f / U[p * GS + p];
        if (r == (p & 31)) rhs[qp] = rhs[qp] * inv;
#pragma unroll
        for (int q = 0; q < C; ++q) {
          const int i = r + 32 * q;
          if (ok[q] && i > p) U[p * GS + i] = U[p * GS + i] * inv;
        }
        __syncwarp();
        const float rhs_p = __shfl_sync(FULL, rhs[qp], p & 31);
#pragma unroll
        for (int q = 0; q < C; ++q) {
          const int i = r + 32 * q;
          if (ok[q] && i > p) {
            const float colk = U[i * GS + p];
            for (int c = p + 1; c < K; ++c)
              U[i * GS + c] = U[i * GS + c] - colk * U[p * GS + c];
            rhs[q] = rhs[q] - colk * rhs_p;
          }
        }
        __syncwarp();
      }
    }
#pragma unroll
    for (int qk = C - 1; qk >= 0; --qk) {
      const int k_top = min(K, 32 * (qk + 1)) - 1;
      for (int k = k_top; k >= max(1, 32 * qk); --k) {
        const float xk = __shfl_sync(FULL, rhs[qk], k & 31);
#pragma unroll
        for (int q = 0; q < C; ++q) {
          const int i = r + 32 * q;
          if (i < k) rhs[q] = rhs[q] - U[i * GS + k] * xk;
        }
      }
    }

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
    bool all[C];
#pragma unroll
    for (int q = 0; q < C; ++q) all[q] = true;
    cd_sweeps<C, false>(G, K, GS, xty, beta, all, l1, l2, tol, polish_sweeps);
  }
}

// Cold strong-rule CD of one column by one warp (cd_pallas.py:91-100, then
// cd_sweeps).  lam and alpha as f32; the threshold is computed in the TPU
// kernel's operation order, so a coordinate on the edge is screened alike.
template <int C>
__device__ __forceinline__ void cd_column(const float* __restrict__ G, int K,
                                          int GS, const float (&xty)[C],
                                          float (&beta)[C], float lam,
                                          float alpha, float tol,
                                          int max_sweeps) {
  const int r = threadIdx.x & 31;
  const float l1 = lam * alpha;
  const float l2 = lam * (1.f - alpha);
  float xmax = 0.f;                        // slots past K hold 0
#pragma unroll
  for (int q = 0; q < C; ++q) xmax = fmaxf(xmax, fabsf(xty[q]));
  const float thr = alpha * (2.f * lam - warp_max(xmax));
  bool act[C];
#pragma unroll
  for (int q = 0; q < C; ++q) {
    act[q] = r + 32 * q < K && fabsf(xty[q]) >= thr;
    beta[q] = beta[q] * (act[q] ? 1.f : 0.f);
  }
  cd_sweeps<C, true>(G, K, GS, xty, beta, act, l1, l2, tol, max_sweeps);
}

// The column solvers as the kernels take them, with their scalars.
// WORKSPACE: the solve needs a K x GS elimination workspace per warp.
template <bool CD>
struct Solver;

template <>
struct Solver<false> {   // FSS + polish; l1 = lam*alpha, l2 = lam*(1-alpha)
  static constexpr bool WORKSPACE = true;
  float l1, l2, tol;
  int max_outer, polish_sweeps;
};

template <>
struct Solver<true> {    // cold strong-rule CD
  static constexpr bool WORKSPACE = false;
  float lam, alpha, tol;
  int max_sweeps;
};

template <int C>
__device__ __forceinline__ void solve_column(const Solver<false>& s,
                                             const float* G, float* U, int K,
                                             int GS, const float (&xty)[C],
                                             float (&beta)[C]) {
  fss_column<C>(G, U, K, GS, xty, beta, s.l1, s.l2, s.tol, s.max_outer,
                s.polish_sweeps);
}

template <int C>
__device__ __forceinline__ void solve_column(const Solver<true>& s,
                                             const float* G, float*, int K,
                                             int GS, const float (&xty)[C],
                                             float (&beta)[C]) {
  cd_column<C>(G, K, GS, xty, beta, s.lam, s.alpha, s.tol, s.max_sweeps);
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

// Copies the grams of columns j0 .. j0 + CB - 1 of a gene-last (K, K, M)
// tensor into shared memory as CB row-major K x GS tiles, CB consecutive
// floats of each (k, l) row at a time, so the read is coalesced; columns
// past M are staged as zeros.  The caller synchronizes the block after it.
__device__ __forceinline__ void stage_grams(const float* __restrict__ xtx,
                                            float* __restrict__ Gs, int K,
                                            int GS, int M, int j0, int CB) {
  const int KK = K * K;
  for (int e = threadIdx.x; e < KK * CB; e += blockDim.x) {
    const int kl = e / CB, jj = e % CB, j = j0 + jj;
    const int k = kl / K, l = kl % K;
    Gs[((size_t)jj * K + k) * GS + l] = j < M ? xtx[(size_t)kl * M + j] : 0.f;
  }
}

// Reads coordinates r + 32 q of column j of a row-major (K, M) matrix.
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
