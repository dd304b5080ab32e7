// feature_sign_fused: the masked column update.  Per gene column j it builds
// the masked gram and Xty from the row factor, runs feature-sign search
// (FSS), then a plain coordinate-descent polish.
//
// Replaces insider_tpu/kernels/fss_pallas.py:feature_sign_fused_pallas
// (bodies _fss_fused_kernel and _fss_compute).  Per column j, with
//     G_j = sum_i mask_ij r_i r_i^T,   b_j = sum_i r_i (mask_ij data_ij),
// it minimizes 1/2 b^T G_j b - b_j^T b + l2/2 |b|^2 + l1 |b|_1 from the warm
// start beta0[:, j], with the TPU kernel's iteration:
//   * outer step: solve the active subsystem by forward elimination without
//     pivoting + back substitution; step to the first sign crossing, whose
//     coordinates become exact zeros (a coordinate that is active with
//     beta == 0 was just picked and is exempt: the livelock guard); when no
//     crossing, activate ONE KKT violator, the largest |grad| with the
//     lowest index on ties, |grad| > l1 + 1e-5 (l1 + max|b_j|); the column
//     converges when there is none; at most max_outer steps;
//   * polish: CD sweeps in fixed order 0..K-1 with the cancellation-free
//     decrease, until a sweep's decrease is <= tol (at most polish_sweeps).
//
// Columns are independent: a converged column is frozen in the TPU block
// (fss_pallas.py:173-177, :262), so one warp per column that exits on its
// own computes what the TPU block computes.
//
// Bound on the H100: the gram build, N*K^2 f32 FMAs per column (9.7 GFMA
// at N=377, K=24, M=44477), which the three-bf16-plane MXU trick of the TPU
// kernel (fss_pallas.py:288-337) exists to speed up; here it is plain f32
// FMA accumulation of the same sum.  The FSS itself is serial per column
// (K pivots, each a K-wide row update) and latency-bound.
//
// Design: a block of 8 warps owns 32 consecutive columns.  Row chunks of R,
// mask and data are staged through shared memory with coalesced loads, so
// one kernel covers any N.  Lane r of the warp that owns column j
// accumulates row r of G_j and entry r of b_j in registers (K <= 32); the
// finished grams go to shared memory.  FSS then runs one warp per column:
// lane r holds coordinate r, the elimination workspace is a K x (K+1)
// shared tile per warp, the pivot row is read as a shared-memory broadcast
// and column-wide min / max / first-index use warp shuffles and ballots.
// The ragged column tail (M = 44477) is masked in the kernel, not padded.
#include "common.cuh"

namespace {

constexpr int CB = 32;         // columns per block
constexpr int WARPS = 8;       // warp w owns columns w, w + 8, w + 16, w + 24
constexpr int CPW = CB / WARPS;
constexpr int RCH = 32;        // rows per staged chunk
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

// FSS + polish of one column by one warp.  G: the column's K x K gram, row
// stride GS; U: this warp's K x GS workspace; lane r < K holds coordinate r
// (xty, beta); lanes r >= K hold zeros and take part only in shuffles.
__device__ float fss_column(const float* __restrict__ G, float* __restrict__ U,
                            int K, int GS, float xty, float beta, float l1,
                            float l2, float tol, int max_outer,
                            int polish_sweeps) {
  const int r = threadIdx.x & 31;
  const bool ok = r < K;
  const float* Gr = G + (ok ? r : 0) * GS;
  float act = beta != 0.f ? 1.f : 0.f;
  float theta = sgn(beta);
  const float thresh = l1 + KKT_RTOL * (l1 + warp_max(fabsf(xty)));

  bool conv = false;
  for (int outer = 0; outer < max_outer && !conv; ++outer) {
    // U = G restricted to the active set, + l2 on active diagonals,
    // identity on inactive ones.
    float rhs = (xty - l1 * theta) * act;
    for (int c = 0; c < K; ++c) {
      const float ac = __shfl_sync(FULL, act, c);
      if (ok) U[r * GS + c] = Gr[c] * act * ac;
    }
    if (ok) U[r * GS + r] = U[r * GS + r] + l2 * act + (1.f - act);
    __syncwarp();

    // Forward elimination: lane r > p normalizes entry r of pivot row p,
    // then updates its own row.  Columns <= p of the rows below are never
    // read again, so they are not updated.
    for (int p = 0; p < K; ++p) {
      const float inv = 1.f / U[p * GS + p];
      if (r == p) rhs = rhs * inv;
      if (ok && r > p) U[p * GS + r] = U[p * GS + r] * inv;
      __syncwarp();
      const float rhs_p = __shfl_sync(FULL, rhs, p);
      if (ok && r > p) {
        const float colk = U[r * GS + p];
        for (int c = p + 1; c < K; ++c)
          U[r * GS + c] = U[r * GS + c] - colk * U[p * GS + c];
        rhs = rhs - colk * rhs_p;
      }
      __syncwarp();
    }
    for (int k = K - 1; k >= 1; --k) {
      const float xk = __shfl_sync(FULL, rhs, k);
      if (r < k) rhs = rhs - U[r * GS + k] * xk;
    }
    const float bstar = rhs;

    // Line search to the first sign crossing.
    const bool flip = ok && act > 0.5f && sgn(bstar) != theta && beta != 0.f;
    const float denom = beta - bstar;
    const float safe = (flip && denom != 0.f) ? denom : 1.f;
    const float tk = fminf(fmaxf(flip ? beta / safe : 1.f, 0.f), 1.f);
    const float t = warp_min(tk);
    if (act > 0.5f) beta = beta + t * (bstar - beta);
    if (flip && tk <= t && t < 1.f) beta = 0.f;
    act = beta != 0.f ? 1.f : 0.f;
    theta = sgn(beta);

    // Single-violator KKT activation on a solved column.
    const bool solved = t >= 1.f;
    float s = 0.f;
    for (int c = 0; c < K; ++c) s += Gr[c] * __shfl_sync(FULL, beta, c);
    const float grad = s + l2 * beta - xty;
    const bool viol = ok && act < 0.5f && fabsf(grad) > thresh && solved;
    const float score = viol ? fabsf(grad) : -1.f;
    const float best = warp_max(score);
    const unsigned first = __ballot_sync(FULL, viol && score >= best);
    if (first != 0u && r == __ffs(first) - 1) {
      act = 1.f;
      theta = -sgn(grad);
    }
    conv = solved && !(best > 0.f);
    __syncwarp();
  }

  if (polish_sweeps > 0) {
    const float d = ok ? Gr[r] : 0.f;
    float s = 0.f;
    for (int c = 0; c < K; ++c) s += Gr[c] * __shfl_sync(FULL, beta, c);
    float den = d + l2;
    den = den > 0.f ? den : 1.f;
    const float inv_den = 1.f / den;
    const float half_den = 0.5f * den;
    const float inv_l1 = 1.f / fmaxf(l1, 1e-30f);
    bool pconv = false;
    for (int sweep = 0; sweep < polish_sweeps && !pconv; ++sweep) {
      float dec = 0.f;
      for (int k = 0; k < K; ++k) {
        // every lane evaluates the update; lane k's is the one used
        const float u = xty - s + beta * d;
        const float w = sgn(u) * fmaxf(fabsf(u) - l1, 0.f) * inv_den;
        const float delta = w - beta;
        const float xi = w != 0.f ? sgn(w)
                                  : fminf(fmaxf(u * inv_l1, -1.f), 1.f);
        const float term =
            half_den * delta * delta + l1 * (fabsf(beta) - xi * beta);
        const float delta_k = __shfl_sync(FULL, delta, k);
        dec = dec + __shfl_sync(FULL, term, k);
        s = s + Gr[k] * delta_k;   // G symmetric: G[k][r] == G[r][k]
        if (r == k) beta = w;
      }
      pconv = fabsf(dec) <= tol;
    }
  }
  return beta;
}

template <int KMAX>
size_t smem_floats(int K) {
  const int GS = K + 1;
  return (size_t)RCH * KMAX + 2 * (size_t)RCH * CB + (size_t)CB * K * GS +
         (size_t)CB * K + (size_t)WARPS * K * GS;
}

template <int KMAX>
__global__ void __launch_bounds__(WARPS * 32)
fss_fused_kernel(const float* __restrict__ mask, const float* __restrict__ data,
                 const float* __restrict__ R, const float* __restrict__ beta0,
                 float* __restrict__ out, float l1, float l2, float tol, int N,
                 int M, int K, int max_outer, int polish_sweeps) {
  extern __shared__ __align__(16) float smem[];
  const int GS = K + 1;
  float* Rs = smem;                       // (RCH, KMAX), zero beyond K
  float* Ms = Rs + RCH * KMAX;            // (RCH, CB) mask tile
  float* Xs = Ms + RCH * CB;              // (RCH, CB) data tile
  float* Gs = Xs + RCH * CB;              // (CB, K, GS) grams
  float* Bs = Gs + (size_t)CB * K * GS;   // (CB, K) Xty
  float* Us = Bs + (size_t)CB * K;        // (WARPS, K, GS) workspaces

  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int r = tid & 31;
  const int j0 = blockIdx.x * CB;

  // --- gram and Xty build ---
  float acc[CPW][KMAX];
  float b[CPW];
#pragma unroll
  for (int q = 0; q < CPW; ++q) {
    b[q] = 0.f;
#pragma unroll
    for (int c = 0; c < KMAX; ++c) acc[q][c] = 0.f;
  }
  for (int i0 = 0; i0 < N; i0 += RCH) {
    const int rows = min(RCH, N - i0);
    __syncthreads();                      // previous chunk consumed
    for (int e = tid; e < RCH * KMAX; e += WARPS * 32) {
      const int i = e / KMAX, k = e % KMAX;
      Rs[e] = (i < rows && k < K) ? R[(size_t)(i0 + i) * K + k] : 0.f;
    }
    for (int e = tid; e < RCH * CB; e += WARPS * 32) {
      const int i = e / CB, j = j0 + e % CB;
      const bool in = i < rows && j < M;
      Ms[e] = in ? mask[(size_t)(i0 + i) * M + j] : 0.f;
      Xs[e] = in ? data[(size_t)(i0 + i) * M + j] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < rows; ++i) {
      const float ri = r < KMAX ? Rs[i * KMAX + r] : 0.f;
      float m[CPW];
#pragma unroll
      for (int q = 0; q < CPW; ++q) {
        m[q] = Ms[i * CB + w + WARPS * q];
        b[q] = fmaf(ri, m[q] * Xs[i * CB + w + WARPS * q], b[q]);
      }
#pragma unroll
      for (int c = 0; c < KMAX; ++c) {
        const float p = ri * Rs[i * KMAX + c];   // the outer-product table
#pragma unroll
        for (int q = 0; q < CPW; ++q) acc[q][c] = fmaf(m[q], p, acc[q][c]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < CPW; ++q) {
    const int cl = w + WARPS * q;
    if (r < K) {
#pragma unroll
      for (int c = 0; c < KMAX; ++c)
        if (c < K) Gs[((size_t)cl * K + r) * GS + c] = acc[q][c];
      Bs[cl * K + r] = b[q];
    }
  }
  __syncwarp();

  // --- FSS + polish, one warp per column ---
  float* U = Us + (size_t)w * K * GS;
  for (int q = 0; q < CPW; ++q) {
    const int cl = w + WARPS * q;
    const int j = j0 + cl;
    if (j >= M) continue;                 // warp-uniform
    const float xty = r < K ? Bs[cl * K + r] : 0.f;
    float beta = r < K ? beta0[(size_t)r * M + j] : 0.f;
    beta = fss_column(Gs + (size_t)cl * K * GS, U, K, GS, xty, beta, l1, l2,
                      tol, max_outer, polish_sweeps);
    if (r < K) out[(size_t)r * M + j] = beta;
  }
}

template <int KMAX>
cudaError_t launch(const float* mask, const float* data, const float* R,
                   const float* beta0, float* out, float l1, float l2,
                   float tol, int N, int M, int K, int max_outer,
                   int polish_sweeps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<KMAX>(K);
  cudaError_t err = cudaFuncSetAttribute(
      fss_fused_kernel<KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fss_fused_kernel<KMAX><<<insider::ceil_div(M, CB), WARPS * 32, smem,
                           stream>>>(mask, data, R, beta0, out, l1, l2, tol,
                                     N, M, K, max_outer, polish_sweeps);
  return cudaGetLastError();
}

}  // namespace

// out (K, M) = the FSS + polish solution of every column.  mask, data
// (N, M), R (N, K), beta0 (K, M): row-major f32.  l1 = lam*alpha and
// l2 = lam*(1-alpha) as f32; 1 <= K <= 32.
INSIDER_API int insider_fss_fused(const float* mask, const float* data,
                                  const float* R, const float* beta0,
                                  float* out, float l1, float l2, float tol,
                                  int N, int M, int K, int max_outer,
                                  int polish_sweeps, cudaStream_t stream) {
  if (N < 1 || M < 1 || K < 1 || K > 32) return (int)cudaErrorInvalidValue;
  if (K <= 8)
    return (int)launch<8>(mask, data, R, beta0, out, l1, l2, tol, N, M, K,
                          max_outer, polish_sweeps, stream);
  if (K <= 16)
    return (int)launch<16>(mask, data, R, beta0, out, l1, l2, tol, N, M, K,
                           max_outer, polish_sweeps, stream);
  if (K <= 24)
    return (int)launch<24>(mask, data, R, beta0, out, l1, l2, tol, N, M, K,
                           max_outer, polish_sweeps, stream);
  return (int)launch<32>(mask, data, R, beta0, out, l1, l2, tol, N, M, K,
                         max_outer, polish_sweeps, stream);
}
