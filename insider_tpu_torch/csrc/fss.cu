// feature_sign_fused and cd_fused: the masked column update.  Per gene
// column j it builds the masked gram and Xty from the row factor,
//     G_j = sum_i mask_ij r_i r_i^T,   b_j = sum_i r_i (mask_ij data_ij),
// then solves the elastic net with a solver of fss_core.cuh: the
// feature-sign search (FSS) and its plain-CD polish, or cold strong-rule
// coordinate descent (CD).
//
// Replaces insider_tpu/kernels/fss_pallas.py:feature_sign_fused_pallas
// (bodies _fss_fused_kernel and _fss_compute), insider_tpu/kernels/
// cd_pallas.py:elastic_net_cd_fused_pallas (bodies _cd_fused_kernel and
// _cd_compute) and insider_tpu/kernels/cd_packed.py:
// elastic_net_cd_fused_packed_pallas (the CD iteration with the column axis
// in an (8, BM/8) TPU sublane layout, a layout question that does not arise
// on the GPU).  One coordinate per lane, so K <= 32; larger K takes the
// streamed route, col_gram_xty.cu + fss_streamed.cu, as the JAX package
// does when its fused kernels do not fit.  For CD the caller permutes R's
// columns and beta0's rows to set the sweep order.
//
// Bound on the H100: the gram build, N*K^2 f32 FMAs per column (9.7 GFMA
// at N=377, K=24, M=44477), which the three-bf16-plane MXU trick of the TPU
// kernels (fss_pallas.py:288-337, used by cd_pallas.py:_cd_fused_kernel
// too) exists to speed up; here it is plain f32 FMA accumulation of the
// same sum.  The solve is serial per column and latency-bound: FSS takes K
// pivots per outer step, each a K-wide row update; CD up to max_sweeps x K
// dependent coordinate updates.
//
// Design: a block of 8 warps owns 32 consecutive columns.  Row chunks of R,
// mask and data are staged through shared memory with coalesced loads, so
// one kernel covers any N.  Lane r of the warp that owns column j
// accumulates row r of G_j and entry r of b_j in registers (K <= 32); the
// finished grams go to shared memory.  The solver then runs one warp per
// column (fss_core.cuh), FSS with its own K x (K+1) elimination workspace.
// The ragged column tail (M = 44477) is masked in the kernel, not padded.
#include "fss_core.cuh"

namespace {

using insider::ceil_div;
using insider::load_coords;
using insider::Solver;
using insider::solve_column;
using insider::store_coords;

constexpr int CB = 32;         // columns per block
constexpr int WARPS = 8;       // warp w owns columns w, w + 8, w + 16, w + 24
constexpr int CPW = CB / WARPS;
constexpr int RCH = 32;        // rows per staged chunk

// Shared-memory floats: the staged R chunk (RCH, KMAX), the mask and data
// tiles (RCH, CB) each, the grams (CB, K, K + 1), Xty (CB, K) and, for
// FSS, the workspaces (WARPS, K, K + 1), in that order.
template <int KMAX, bool CD>
size_t smem_floats(int K) {
  const int GS = K + 1;
  return (size_t)RCH * KMAX + 2 * (size_t)RCH * CB + (size_t)CB * K * GS +
         (size_t)CB * K +
         (Solver<CD>::WORKSPACE ? (size_t)WARPS * K * GS : 0);
}

template <int KMAX, bool CD>
__global__ void __launch_bounds__(WARPS * 32, 1)
fused_kernel(const float* __restrict__ mask, const float* __restrict__ data,
             const float* __restrict__ R, const float* __restrict__ beta0,
             float* __restrict__ out, int N, int M, int K,
             Solver<CD> solver) {
  extern __shared__ __align__(16) float smem[];
  const int GS = K + 1;
  float* Rs = smem;                       // (RCH, KMAX), zero beyond K
  float* Ms = Rs + RCH * KMAX;            // (RCH, CB) mask tile
  float* Xs = Ms + RCH * CB;              // (RCH, CB) data tile
  float* Gs = Xs + RCH * CB;              // (CB, K, GS) grams
  float* Bs = Gs + (size_t)CB * K * GS;   // (CB, K) Xty
  float* Us = Bs + (size_t)CB * K;        // (WARPS, K, GS) FSS workspaces

  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int r = tid & 31;
  const int j0 = blockIdx.x * CB;

  // 1. grams and Xty of this block's columns
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
  // each warp writes only its own columns' grams, which it alone reads
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

  // 2. the solve, one warp per column
  float* U = Us + (size_t)w * K * GS;
  for (int q = 0; q < CPW; ++q) {
    const int cl = w + WARPS * q;
    const int j = j0 + cl;
    if (j >= M) continue;                 // warp-uniform
    const float xty[1] = {r < K ? Bs[cl * K + r] : 0.f};
    float beta[1];
    load_coords<1>(beta0, K, M, j, beta);
    solve_column<1>(solver, Gs + (size_t)cl * K * GS, U, K, GS, xty, beta);
    store_coords<1>(out, K, M, j, beta);
  }
}

template <int KMAX, bool CD>
cudaError_t launch(const float* mask, const float* data, const float* R,
                   const float* beta0, float* out, int N, int M, int K,
                   Solver<CD> solver, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<KMAX, CD>(K);
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel<KMAX, CD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fused_kernel<KMAX, CD><<<ceil_div(M, CB), WARPS * 32, smem, stream>>>(
      mask, data, R, beta0, out, N, M, K, solver);
  return cudaGetLastError();
}

template <bool CD>
int fused(const float* mask, const float* data, const float* R,
          const float* beta0, float* out, int N, int M, int K,
          Solver<CD> solver, cudaStream_t stream) {
  if (N < 1 || M < 1 || K < 1 || K > 32) return (int)cudaErrorInvalidValue;
  if (K <= 8)
    return (int)launch<8>(mask, data, R, beta0, out, N, M, K, solver, stream);
  if (K <= 16)
    return (int)launch<16>(mask, data, R, beta0, out, N, M, K, solver,
                           stream);
  if (K <= 24)
    return (int)launch<24>(mask, data, R, beta0, out, N, M, K, solver,
                           stream);
  return (int)launch<32>(mask, data, R, beta0, out, N, M, K, solver, stream);
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
  return fused(mask, data, R, beta0, out, N, M, K,
               Solver<false>{l1, l2, tol, max_outer, polish_sweeps}, stream);
}

// out (K, M) = the cold strong-rule CD solution of every column, at most
// max_sweeps sweeps.  mask, data (N, M), R (N, K), beta0 (K, M): row-major
// f32.  lam, alpha, tol as f32; 1 <= K <= 32.
INSIDER_API int insider_cd_fused(const float* mask, const float* data,
                                 const float* R, const float* beta0,
                                 float* out, float lam, float alpha, float tol,
                                 int N, int M, int K, int max_sweeps,
                                 cudaStream_t stream) {
  return fused(mask, data, R, beta0, out, N, M, K,
               Solver<true>{lam, alpha, tol, max_sweeps}, stream);
}
