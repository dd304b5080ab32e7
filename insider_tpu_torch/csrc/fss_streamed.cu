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
// M=44477), and the serial solve of each column, latency-bound: FSS
// eliminates a pivots per outer step (a the active coordinates), each an
// a-wide row update; CD up to max_sweeps x K dependent coordinate updates
// (two warp shuffles and a K-wide shared-memory row read each).
//
// Design: persistent one-warp blocks, as many as the card holds at once.
// A warp takes the next column from a grid-wide counter (an atomic add on
// `next`, which the entry point zeroes), copies that column's gram into its
// own slice of shared memory, runs the solver, writes the column and takes
// the next: a column that needs many steps holds up no other, and no block
// waits for its slowest warp.  Which warp takes a column differs from run
// to run; a column's arithmetic does not depend on it, so repeated runs
// agree bit for bit.  A gram's K^2 entries lie M floats apart, so
// a warp's copy reads one 32-byte sector per entry; the warps hold
// neighbouring columns at about the same time (the counter hands them out
// in order), so the sectors are read from device memory about once and
// from L2 up to eight times.  FSS solves an active set of up to 32
// coordinates in registers, a larger one (K > 32 only) in its slice
// (fss_core.cuh: Solver<false>::workspace_floats).  A slice is 21 KB at
// K=50 (ten warps an SM), 77 KB at K=96, 135 KB at K=128 for FSS; 10 KB,
// 37 KB and 66 KB for CD.
#include "fss_core.cuh"

namespace {

using insider::by_lane_count;
using insider::by_width;
using insider::load_coords;
using insider::next_column;
using insider::Solver;
using insider::solve_column;
using insider::store_coords;

// Floats of one warp's slice of shared memory: its column's gram (K, K + 1),
// padded to 16 bytes, then the solver's workspace.
template <int C, bool CD>
__host__ __device__ int slice_floats(int K) {
  return ((K * (K + 1) + 3) & ~3) + Solver<CD>::workspace_floats(C, K);
}

template <int AMAX, int C, bool CD>
__global__ void __launch_bounds__(32)
streamed_kernel(const float* __restrict__ xtx, const float* __restrict__ xty,
                const float* __restrict__ beta0, float* __restrict__ out,
                int* __restrict__ next, int M, int K, Solver<CD> solver) {
  extern __shared__ __align__(16) float smem[];
  const int GS = K + 1;
  const int lane = threadIdx.x;
  float* Gs = smem;                                  // (K, GS) the gram
  float* W = smem + ((K * GS + 3) & ~3);             // the solver's
  for (;;) {
    const int j = next_column(next);
    if (j >= M) break;                               // warp-uniform
#pragma unroll 4
    for (int k = 0; k < K; ++k)
      for (int l = lane; l < K; l += 32)
        Gs[k * GS + l] = xtx[((size_t)k * K + l) * M + j];
    __syncwarp();
    float b[C], beta[C];
    load_coords<C>(xty, K, M, j, b);
    load_coords<C>(beta0, K, M, j, beta);
    solve_column<AMAX, C>(solver, Gs, W, K, GS, b, beta);
    store_coords<C>(out, K, M, j, beta);
    __syncwarp();                                    // Gs is read no more
  }
}

// Launches as many one-warp blocks as the card holds at once at this
// shared-memory size (remembered for the last device and size asked).
template <int AMAX, int C, bool CD>
cudaError_t launch(const float* xtx, const float* xty, const float* beta0,
                   float* out, int* next, int M, int K, Solver<CD> solver,
                   cudaStream_t stream) {
  static int last_dev = -1, last_blocks = 0;
  static size_t last_smem = 0;
  const size_t smem = sizeof(float) * slice_floats<C, CD>(K);
  const auto kernel = streamed_kernel<AMAX, C, CD>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != last_dev || smem != last_smem) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, 32, smem)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    last_dev = dev;
    last_smem = smem;
    last_blocks = per_sm * sms;
  }
  if ((err = cudaMemsetAsync(next, 0, sizeof(int), stream)) != cudaSuccess)
    return err;
  kernel<<<M < last_blocks ? M : last_blocks, 32, smem, stream>>>(
      xtx, xty, beta0, out, next, M, K, solver);
  return cudaGetLastError();
}

template <bool CD>
int streamed(const float* xtx, const float* xty, const float* beta0,
             float* out, int* next, int M, int K, Solver<CD> solver,
             cudaStream_t stream) {
  if (M < 1 || K < 1 || K > 128) return (int)cudaErrorInvalidValue;
  auto go = [&](auto c, auto amax) {
    return launch<decltype(amax)::value, decltype(c)::value>(
        xtx, xty, beta0, out, next, M, K, solver, stream);
  };
  if constexpr (CD)
    return (int)by_lane_count(
        K, [&](auto c) { return go(c, std::integral_constant<int, 32>()); });
  else
    return (int)by_width(K, go);
}

}  // namespace

// out (K, M) = the FSS + polish solution of every column.  xtx (K, K, M),
// xty and beta0 (K, M): row-major f32; next: one int of device scratch (the
// column counter).  l1 = lam*alpha and l2 = lam*(1-alpha) as f32;
// 1 <= K <= 128.
INSIDER_API int insider_fss_streamed(const float* xtx, const float* xty,
                                     const float* beta0, float* out,
                                     int* next, float l1, float l2,
                                     float tol, int M, int K, int max_outer,
                                     int polish_sweeps, cudaStream_t stream) {
  return streamed(xtx, xty, beta0, out, next, M, K,
                  Solver<false>{l1, l2, tol, max_outer, polish_sweeps},
                  stream);
}

// out (K, M) = the cold strong-rule CD solution of every column, at most
// max_sweeps sweeps.  xtx (K, K, M), xty and beta0 (K, M): row-major f32;
// next: one int of device scratch (the column counter).  lam, alpha, tol
// as f32; 1 <= K <= 128.
INSIDER_API int insider_cd_streamed(const float* xtx, const float* xty,
                                    const float* beta0, float* out, int* next,
                                    float lam, float alpha, float tol, int M,
                                    int K, int max_sweeps,
                                    cudaStream_t stream) {
  return streamed(xtx, xty, beta0, out, next, M, K,
                  Solver<true>{lam, alpha, tol, max_sweeps}, stream);
}
