// feature_sign and cd_streamed: the column update on streamed per-gene
// grams.  Per gene column j one warp solves the elastic net on the gram
// xtx[:, :, j] and Xty xty[:, j] with a solver of fss_core.cuh: the
// feature-sign search (FSS) and its plain-CD polish, or cold strong-rule
// coordinate descent (CD).
//
// Replaces insider_tpu/kernels/fss_pallas.py:feature_sign_pallas (body
// _fss_kernel -> _fss_compute), insider_tpu/kernels/cd_pallas.py:
// elastic_net_cd_pallas (body _cd_kernel -> _cd_compute) and
// insider_tpu/kernels/cd_packed.py:elastic_net_cd_packed_pallas (the CD
// iteration with the column axis in an (8, BM/8) TPU sublane layout, a
// layout question that does not arise on the GPU).  The grams come from
// col_gram_xty.cu: the JAX package's streamed route
// (insider_tpu/ops/col_update.py:378-390, :463-478), which the port takes
// for 32 < K <= 128, where the fused kernel's one coordinate per lane does
// not reach.  For CD the caller permutes the problem to set the sweep
// order.
//
// Bound on the H100: the (K, K, M) gram read, K^2 M f32 (445 MB at K=50,
// M=44477), and the serial solve of each column, latency-bound: FSS takes
// K pivots per outer step, each a K-wide row update; CD up to max_sweeps x
// K dependent coordinate updates (two warp shuffles and a K-wide
// shared-memory row read each).
//
// Design: a block owns CB consecutive columns.  It first copies their grams
// into shared memory (fss_core.cuh: stage_grams, coalesced); then one warp
// per column runs the solver, FSS with its own K x (K+1) elimination
// workspace.  K <= 32 keeps one coordinate per lane (8 warps, 32 columns);
// K <= 64 two, K <= 96 three and K <= 128 four, with one column per warp.
// FSS there runs 4, 1 and 1 warps (82 KB of shared memory at K=50, so two
// blocks share an SM; 74 KB at K=96, 132 KB at K=128); CD, which needs no
// workspace, 8, 4 and 2 (82 KB at K=50, 149 KB at K=96, 132 KB at K=128).
#include "fss_core.cuh"

namespace {

using insider::by_lane_count;
using insider::ceil_div;
using insider::load_coords;
using insider::Solver;
using insider::solve_column;
using insider::stage_grams;
using insider::store_coords;

template <int C, bool CD>
struct Shape {
  static constexpr bool WS = Solver<CD>::WORKSPACE;
  static constexpr int WARPS = C == 1   ? 8
                               : WS     ? (C == 2 ? 4 : 1)
                               : C == 2 ? 8
                               : C == 3 ? 4
                                        : 2;
  static constexpr int CPW = C == 1 ? 4 : 1;   // columns per warp
  static constexpr int CB = WARPS * CPW;       // columns per block
  static size_t smem_bytes(int K) {
    return sizeof(float) * (size_t)(CB + (WS ? WARPS : 0)) * K * (K + 1);
  }
};

template <int C, bool CD>
__global__ void __launch_bounds__(Shape<C, CD>::WARPS * 32)
streamed_kernel(const float* __restrict__ xtx, const float* __restrict__ xty,
                const float* __restrict__ beta0, float* __restrict__ out,
                int M, int K, Solver<CD> solver) {
  using S = Shape<C, CD>;
  extern __shared__ __align__(16) float smem[];
  const int GS = K + 1;
  float* Gs = smem;                        // (CB, K, GS) grams
  float* Us = Gs + (size_t)S::CB * K * GS; // (WARPS, K, GS) FSS workspaces

  const int w = threadIdx.x >> 5;
  const int j0 = blockIdx.x * S::CB;
  stage_grams(xtx, Gs, K, GS, M, j0, S::CB);
  __syncthreads();

  float* U = Us + (size_t)w * K * GS;
  for (int q = 0; q < S::CPW; ++q) {
    const int cl = w + S::WARPS * q;
    const int j = j0 + cl;
    if (j >= M) continue;                  // warp-uniform
    float b[C], beta[C];
    load_coords<C>(xty, K, M, j, b);
    load_coords<C>(beta0, K, M, j, beta);
    solve_column<C>(solver, Gs + (size_t)cl * K * GS, U, K, GS, b, beta);
    store_coords<C>(out, K, M, j, beta);
  }
}

template <int C, bool CD>
cudaError_t launch(const float* xtx, const float* xty, const float* beta0,
                   float* out, int M, int K, Solver<CD> solver,
                   cudaStream_t stream) {
  using S = Shape<C, CD>;
  const size_t smem = S::smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      streamed_kernel<C, CD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  streamed_kernel<C, CD><<<ceil_div(M, S::CB), S::WARPS * 32, smem,
                           stream>>>(xtx, xty, beta0, out, M, K, solver);
  return cudaGetLastError();
}

template <bool CD>
int streamed(const float* xtx, const float* xty, const float* beta0,
             float* out, int M, int K, Solver<CD> solver,
             cudaStream_t stream) {
  if (M < 1 || K < 1 || K > 128) return (int)cudaErrorInvalidValue;
  return (int)by_lane_count(K, [&](auto c) {
    return launch<decltype(c)::value>(xtx, xty, beta0, out, M, K, solver,
                                      stream);
  });
}

}  // namespace

// out (K, M) = the FSS + polish solution of every column.  xtx (K, K, M),
// xty and beta0 (K, M): row-major f32.  l1 = lam*alpha and l2 =
// lam*(1-alpha) as f32; 1 <= K <= 128.
INSIDER_API int insider_fss_streamed(const float* xtx, const float* xty,
                                     const float* beta0, float* out, float l1,
                                     float l2, float tol, int M, int K,
                                     int max_outer, int polish_sweeps,
                                     cudaStream_t stream) {
  return streamed(xtx, xty, beta0, out, M, K,
                  Solver<false>{l1, l2, tol, max_outer, polish_sweeps},
                  stream);
}

// out (K, M) = the cold strong-rule CD solution of every column, at most
// max_sweeps sweeps.  xtx (K, K, M), xty and beta0 (K, M): row-major f32.
// lam, alpha, tol as f32; 1 <= K <= 128.
INSIDER_API int insider_cd_streamed(const float* xtx, const float* xty,
                                    const float* beta0, float* out, float lam,
                                    float alpha, float tol, int M, int K,
                                    int max_sweeps, cudaStream_t stream) {
  return streamed(xtx, xty, beta0, out, M, K,
                  Solver<true>{lam, alpha, tol, max_sweeps}, stream);
}
