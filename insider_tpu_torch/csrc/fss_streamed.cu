// feature_sign: the column update on streamed per-gene grams.  Per gene
// column j it runs feature-sign search (FSS) and the plain-CD polish of
// fss_core.cuh on the gram xtx[:, :, j] and Xty xty[:, j].
//
// Replaces insider_tpu/kernels/fss_pallas.py:feature_sign_pallas (body
// _fss_kernel -> _fss_compute).  The grams come from col_gram_xty.cu: the
// JAX package's streamed route (insider_tpu/ops/col_update.py:378-390),
// which the port takes for 32 < K <= 64, where the fused kernel's one
// coordinate per lane does not reach.
//
// Bound on the H100: the (K, K, M) gram read, K^2 M f32 (445 MB at K=50,
// M=44477), and the serial FSS of each column (K pivots, each a K-wide row
// update), which is latency-bound.
//
// Design: a block owns CB consecutive columns.  It first copies their grams
// into shared memory, CB consecutive floats of each (k, l) row of xtx at a
// time, so the read of the gene-last layout is coalesced; then one warp per
// column runs the FSS with its own K x (K+1) elimination workspace.  K <= 32
// keeps one coordinate per lane (8 warps, 32 columns); K <= 64 two (4
// warps, 4 columns: 82 KB of shared memory at K=50, so two blocks share an
// SM; 133 KB at K=64).
#include "fss_core.cuh"

namespace {

using insider::ceil_div;
using insider::fss_column;
using insider::load_coords;
using insider::store_coords;

template <int C>
struct Shape;
template <>
struct Shape<1> {
  static constexpr int WARPS = 8, CPW = 4;
};
template <>
struct Shape<2> {
  static constexpr int WARPS = 4, CPW = 1;
};

template <int C>
size_t smem_floats(int K) {
  constexpr int CB = Shape<C>::WARPS * Shape<C>::CPW;
  return (size_t)(CB + Shape<C>::WARPS) * K * (K + 1);
}

template <int C>
__global__ void __launch_bounds__(Shape<C>::WARPS * 32)
fss_streamed_kernel(const float* __restrict__ xtx,
                    const float* __restrict__ xty,
                    const float* __restrict__ beta0, float* __restrict__ out,
                    float l1, float l2, float tol, int M, int K, int max_outer,
                    int polish_sweeps) {
  constexpr int WARPS = Shape<C>::WARPS;
  constexpr int CB = WARPS * Shape<C>::CPW;
  extern __shared__ __align__(16) float smem[];
  const int GS = K + 1;
  float* Gs = smem;                        // (CB, K, GS) grams
  float* Us = Gs + (size_t)CB * K * GS;    // (WARPS, K, GS) workspaces

  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int j0 = blockIdx.x * CB;
  const int KK = K * K;
  for (int e = tid; e < KK * CB; e += WARPS * 32) {
    const int kl = e / CB, jj = e % CB, j = j0 + jj;
    const int k = kl / K, l = kl % K;
    Gs[((size_t)jj * K + k) * GS + l] = j < M ? xtx[(size_t)kl * M + j] : 0.f;
  }
  __syncthreads();

  float* U = Us + (size_t)w * K * GS;
  for (int q = 0; q < Shape<C>::CPW; ++q) {
    const int cl = w + WARPS * q;
    const int j = j0 + cl;
    if (j >= M) continue;                  // warp-uniform
    float b[C], beta[C];
    load_coords<C>(xty, K, M, j, b);
    load_coords<C>(beta0, K, M, j, beta);
    fss_column<C>(Gs + (size_t)cl * K * GS, U, K, GS, b, beta, l1, l2, tol,
                  max_outer, polish_sweeps);
    store_coords<C>(out, K, M, j, beta);
  }
}

template <int C>
cudaError_t launch(const float* xtx, const float* xty, const float* beta0,
                   float* out, float l1, float l2, float tol, int M, int K,
                   int max_outer, int polish_sweeps, cudaStream_t stream) {
  constexpr int CB = Shape<C>::WARPS * Shape<C>::CPW;
  const size_t smem = sizeof(float) * smem_floats<C>(K);
  cudaError_t err = cudaFuncSetAttribute(
      fss_streamed_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fss_streamed_kernel<C><<<ceil_div(M, CB), Shape<C>::WARPS * 32, smem,
                           stream>>>(xtx, xty, beta0, out, l1, l2, tol, M, K,
                                     max_outer, polish_sweeps);
  return cudaGetLastError();
}

}  // namespace

// out (K, M) = the FSS + polish solution of every column.  xtx (K, K, M),
// xty and beta0 (K, M): row-major f32.  l1 = lam*alpha and l2 =
// lam*(1-alpha) as f32; 1 <= K <= 64.
INSIDER_API int insider_fss_streamed(const float* xtx, const float* xty,
                                     const float* beta0, float* out, float l1,
                                     float l2, float tol, int M, int K,
                                     int max_outer, int polish_sweeps,
                                     cudaStream_t stream) {
  if (M < 1 || K < 1 || K > 64) return (int)cudaErrorInvalidValue;
  if (K <= 32)
    return (int)launch<1>(xtx, xty, beta0, out, l1, l2, tol, M, K, max_outer,
                          polish_sweeps, stream);
  return (int)launch<2>(xtx, xty, beta0, out, l1, l2, tol, M, K, max_outer,
                        polish_sweeps, stream);
}
