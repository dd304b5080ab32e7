// feature_sign_shared and cd_shared: the dense column update.  Every gene
// column solves its elastic net against ONE (K, K) gram, XtX = R^T R, with
// its own Xty and warm start, by a solver of fss_core.cuh: the feature-sign
// search (FSS) and its plain-CD polish, or cold strong-rule coordinate
// descent (CD).
//
// Replaces insider_tpu/kernels/fss_pallas.py:feature_sign_shared_pallas
// (body _fss_shared_kernel -> _fss_compute with shared_gram=True) and
// insider_tpu/kernels/cd_pallas.py:elastic_net_cd_shared_pallas (body
// _cd_shared_kernel -> _cd_compute with shared_gram=True), the column
// update of the dense fit (partition=0, insider_tpu/ops/col_update.py:
// 519-532, :543-551).  For CD the caller permutes both axes of the gram,
// and the rows of xty and beta0, to set the sweep order.
//
// Bound on the H100: the serial solve of each column, latency-bound (FSS:
// a pivots per outer step, a the active coordinates, each an a-wide row
// update; CD: up to max_sweeps x K dependent coordinate updates); the
// inputs are only the (K, M) Xty and warm start.
//
// Design: each block copies the one gram into shared memory once; its warps
// share it and take the block's WARPS x CPW columns one at a time from a
// shared counter.  FSS solves an active set of up to 32 coordinates in
// registers (with two pivot-row buffers a warp) and a larger one (K > 32
// only) in a shared workspace per warp, because the active sets differ per
// column (fss_pallas.py:82-88): K <= 32 one coordinate per lane (8 warps),
// K <= 64 two (4 warps, 89 KB of shared memory at K=64), K <= 96 three and
// K <= 128 four (one warp: 77 KB at K=96, 135 KB at K=128).  CD needs no
// workspace and runs 8 warps at every K (66 KB at K=128).
#include "fss_core.cuh"

namespace {

using insider::by_lane_count;
using insider::by_width;
using insider::ceil_div;
using insider::load_coords;
using insider::next_column;
using insider::Solver;
using insider::solve_column;
using insider::store_coords;

constexpr int CPW = 4;   // columns per warp, on average

// Warps per block; shared memory: the gram (K, K + 1), padded to 16 bytes,
// then each warp's solver workspace.
template <int C, bool CD>
struct Shape {
  static constexpr bool WS = Solver<CD>::workspace_floats(C, 1) > 0;
  static constexpr int WARPS = !WS ? 8 : C == 2 ? 4 : 1;
  __host__ __device__ static size_t gram_floats(int K) {
    return ((size_t)K * (K + 1) + 3) & ~(size_t)3;
  }
  static size_t smem_bytes(int K) {
    return sizeof(float) *
           (gram_floats(K) +
            (size_t)WARPS * Solver<CD>::workspace_floats(C, K));
  }
};

template <int AMAX, int C, bool CD>
__global__ void __launch_bounds__(Shape<C, CD>::WARPS * 32)
shared_kernel(const float* __restrict__ xtx, const float* __restrict__ xty,
              const float* __restrict__ beta0, float* __restrict__ out, int M,
              int K, Solver<CD> solver) {
  constexpr int WARPS = Shape<C, CD>::WARPS;
  extern __shared__ __align__(16) float smem[];
  const int GS = K + 1;
  float* Gs = smem;                        // (K, GS) the shared gram
  __shared__ int next;                     // the solve's column counter

  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int j0 = blockIdx.x * WARPS * CPW;
  for (int e = tid; e < K * K; e += WARPS * 32)
    Gs[(e / K) * GS + e % K] = xtx[e];
  if (tid == 0) next = 0;
  __syncthreads();

  float* W = smem + Shape<C, CD>::gram_floats(K) +
             (size_t)w * Solver<CD>::workspace_floats(C, K);
  for (;;) {
    const int cl = next_column(&next);
    const int j = j0 + cl;
    if (cl >= WARPS * CPW || j >= M) break;   // warp-uniform
    float b[C], beta[C];
    load_coords<C>(xty, K, M, j, b);
    load_coords<C>(beta0, K, M, j, beta);
    solve_column<AMAX, C>(solver, Gs, W, K, GS, b, beta);
    store_coords<C>(out, K, M, j, beta);
  }
}

template <int AMAX, int C, bool CD>
cudaError_t launch(const float* xtx, const float* xty, const float* beta0,
                   float* out, int M, int K, Solver<CD> solver,
                   cudaStream_t stream) {
  constexpr int WARPS = Shape<C, CD>::WARPS;
  const size_t smem = Shape<C, CD>::smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      shared_kernel<AMAX, C, CD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  shared_kernel<AMAX, C, CD><<<ceil_div(M, WARPS * CPW), WARPS * 32, smem,
                               stream>>>(xtx, xty, beta0, out, M, K, solver);
  return cudaGetLastError();
}

template <bool CD>
int shared(const float* xtx, const float* xty, const float* beta0,
           float* out, int M, int K, Solver<CD> solver, cudaStream_t stream) {
  if (M < 1 || K < 1 || K > 128) return (int)cudaErrorInvalidValue;
  auto go = [&](auto c, auto amax) {
    return launch<decltype(amax)::value, decltype(c)::value>(
        xtx, xty, beta0, out, M, K, solver, stream);
  };
  if constexpr (CD)
    return (int)by_lane_count(
        K, [&](auto c) { return go(c, std::integral_constant<int, 32>()); });
  else
    return (int)by_width(K, go);
}

}  // namespace

// out (K, M) = the FSS + polish solution of every column against the one
// gram xtx (K, K).  xty and beta0 (K, M): row-major f32.  l1 = lam*alpha
// and l2 = lam*(1-alpha) as f32; 1 <= K <= 128.
INSIDER_API int insider_fss_shared(const float* xtx, const float* xty,
                                   const float* beta0, float* out, float l1,
                                   float l2, float tol, int M, int K,
                                   int max_outer, int polish_sweeps,
                                   cudaStream_t stream) {
  return shared(xtx, xty, beta0, out, M, K,
                Solver<false>{l1, l2, tol, max_outer, polish_sweeps}, stream);
}

// out (K, M) = the cold strong-rule CD solution of every column against the
// one gram xtx (K, K), at most max_sweeps sweeps.  xty and beta0 (K, M):
// row-major f32.  lam, alpha, tol as f32; 1 <= K <= 128.
INSIDER_API int insider_cd_shared(const float* xtx, const float* xty,
                                  const float* beta0, float* out, float lam,
                                  float alpha, float tol, int M, int K,
                                  int max_sweeps, cudaStream_t stream) {
  return shared(xtx, xty, beta0, out, M, K,
                Solver<true>{lam, alpha, tol, max_sweeps}, stream);
}
