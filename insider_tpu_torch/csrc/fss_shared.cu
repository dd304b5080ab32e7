// feature_sign_shared: the dense column update.  Every gene column solves
// its elastic net against ONE (K, K) gram, XtX = R^T R, with its own Xty
// and warm start: feature-sign search (FSS) and the plain-CD polish of
// fss_core.cuh.
//
// Replaces insider_tpu/kernels/fss_pallas.py:feature_sign_shared_pallas
// (body _fss_shared_kernel -> _fss_compute with shared_gram=True), the
// column update of the dense fit (partition=0,
// insider_tpu/ops/col_update.py:519-532).
//
// Bound on the H100: the serial FSS of each column (K pivots, each a K-wide
// row update), latency-bound; the inputs are only the (K, M) Xty and warm
// start.
//
// Design: each block copies the one gram into shared memory once; its warps
// share it and keep their own K x (K+1) elimination workspaces, because the
// active sets differ per column (fss_pallas.py:82-88).  A warp solves
// CPW columns in turn.  K <= 32 keeps one coordinate per lane (8 warps);
// K <= 64 two (4 warps, 83 KB of shared memory at K=64).
#include "fss_core.cuh"

namespace {

using insider::ceil_div;
using insider::fss_column;
using insider::load_coords;
using insider::store_coords;

constexpr int CPW = 4;   // columns per warp

template <int C>
struct Warps {
  static constexpr int value = C == 1 ? 8 : 4;
};

template <int C>
__global__ void __launch_bounds__(Warps<C>::value * 32)
fss_shared_kernel(const float* __restrict__ xtx, const float* __restrict__ xty,
                  const float* __restrict__ beta0, float* __restrict__ out,
                  float l1, float l2, float tol, int M, int K, int max_outer,
                  int polish_sweeps) {
  constexpr int WARPS = Warps<C>::value;
  constexpr int CB = WARPS * CPW;
  extern __shared__ __align__(16) float smem[];
  const int GS = K + 1;
  float* Gs = smem;                        // (K, GS) the shared gram
  float* Us = Gs + (size_t)K * GS;         // (WARPS, K, GS) workspaces

  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int j0 = blockIdx.x * CB;
  for (int e = tid; e < K * K; e += WARPS * 32)
    Gs[(e / K) * GS + e % K] = xtx[e];
  __syncthreads();

  float* U = Us + (size_t)w * K * GS;
  for (int q = 0; q < CPW; ++q) {
    const int j = j0 + w + WARPS * q;
    if (j >= M) continue;                  // warp-uniform
    float b[C], beta[C];
    load_coords<C>(xty, K, M, j, b);
    load_coords<C>(beta0, K, M, j, beta);
    fss_column<C>(Gs, U, K, GS, b, beta, l1, l2, tol, max_outer,
                  polish_sweeps);
    store_coords<C>(out, K, M, j, beta);
  }
}

template <int C>
cudaError_t launch(const float* xtx, const float* xty, const float* beta0,
                   float* out, float l1, float l2, float tol, int M, int K,
                   int max_outer, int polish_sweeps, cudaStream_t stream) {
  constexpr int WARPS = Warps<C>::value;
  const size_t smem = sizeof(float) * (size_t)(1 + WARPS) * K * (K + 1);
  cudaError_t err = cudaFuncSetAttribute(
      fss_shared_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fss_shared_kernel<C><<<ceil_div(M, WARPS * CPW), WARPS * 32, smem,
                         stream>>>(xtx, xty, beta0, out, l1, l2, tol, M, K,
                                   max_outer, polish_sweeps);
  return cudaGetLastError();
}

}  // namespace

// out (K, M) = the FSS + polish solution of every column against the one
// gram xtx (K, K).  xty and beta0 (K, M): row-major f32.  l1 = lam*alpha
// and l2 = lam*(1-alpha) as f32; 1 <= K <= 64.
INSIDER_API int insider_fss_shared(const float* xtx, const float* xty,
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
