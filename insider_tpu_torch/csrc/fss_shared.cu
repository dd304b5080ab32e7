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
// column (fss_pallas.py:82-88): K <= 32 one coordinate per lane, K <= 64
// two (4 warps, 89 KB of shared memory at K=64), K <= 96 three and K <= 128
// four (77 KB at K=96, 135 KB at K=128); one warp a block except at 32 <
// K <= 64, K <= 32 included.  CD runs the one cold-CD loop (fss_core.cuh:
// cd_group_columns) on the gram packed to its upper triangle (packed_rows;
// 33 KB at K=128), 8 warps at every K, P = 32 / L columns a warp: L = 8 at
// K <= 32, 16 at K <= 64, 32 above (cd_width).  A group whose column
// converges takes the block's next at the next sweep boundary (refill),
// and a block owns 4 columns a group, so that refills happen: every column
// reads the one gram, so a block's columns cost it no shared memory.  At
// K=24 (L = 8) it took 0.23-0.24 ms on chip_smoke.py's phase-5 input and
// 2.31-2.32 ms a launch in the cold-CD flagship dense fit, against
// 0.37-0.38 and 4.99-5.02 for one column a warp on the full (K, K + 1)
// gram (chip_ab.py, NVIDIA H100 80GB HBM3 at 700 W).
#include "fss_core.cuh"

namespace {

using insider::by_lane_count;
using insider::by_width;
using insider::cd_group_columns;
using insider::ceil_div;
using insider::group_take;
using insider::load_coords;
using insider::next_column;
using insider::packed_rows;
using insider::Rows;
using insider::Solver;
using insider::solve_column;
using insider::store_coords;

constexpr int CPW = 4;   // columns per warp (CD: per group), on average

// Warps per block (FSS: 4 at C = 2, else 1) and the columns a block owns
// (L: the CD groups' width, FSS 32); shared memory: FSS the gram (K, K +
// 1), padded to 16 bytes, then each warp's solver workspace; CD the packed
// gram's row starts (K ints, padded to 16 bytes), then the packed gram.
template <int C, bool CD, int L = 32>
struct Shape {
  static constexpr int WARPS = CD ? 8 : C == 2 ? 4 : 1;
  static constexpr int COLUMNS = WARPS * CPW * (32 / L);
  static size_t smem_bytes(int K) {
    if (CD)
      return sizeof(float) * (((K + 3) & ~3) + packed_rows<L>(K));
    return sizeof(float) *
           ((((size_t)K * (K + 1) + 3) & ~(size_t)3) +
            (size_t)WARPS * Solver<false>::workspace_floats(C, K));
  }
};

// The CD solve's columns (cd_group_columns' feed): each group takes the
// block's next column from its counter; every column reads the one gram.
template <int L>
struct SharedColumns {
  static constexpr bool REFILL = true;
  int* counter;
  const float* gram_;
  const float* xty_;
  const float* beta0_;
  float* out;
  int M, j0, cols;
  __device__ int next(unsigned mask) {
    const int c = group_take<L>(counter, mask);
    return c < cols && j0 + c < M ? c : -1;
  }
  __device__ const float* gram(int) const { return gram_; }
  __device__ float xty(int c, int i) const {
    return xty_[(size_t)i * M + j0 + c];
  }
  __device__ float beta0(int c, int i) const {
    return beta0_[(size_t)i * M + j0 + c];
  }
  __device__ void store(int c, int i, float v) const {
    out[(size_t)i * M + j0 + c] = v;
  }
};

template <int AMAX, int C, bool CD, int L>
__global__ void __launch_bounds__(Shape<C, CD>::WARPS * 32)
shared_kernel(const float* __restrict__ xtx, const float* __restrict__ xty,
              const float* __restrict__ beta0, float* __restrict__ out, int M,
              int K, Solver<CD> solver, Rows rows) {
  using Sh = Shape<C, CD, L>;
  constexpr int WARPS = Sh::WARPS;
  extern __shared__ __align__(16) float smem[];
  __shared__ int next;                     // the solve's column counter

  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int j0 = blockIdx.x * Sh::COLUMNS;
  if (tid == 0) next = 0;
  if constexpr (CD) {
    int* R = reinterpret_cast<int*>(smem);  // the packed gram's rows
    float* Gs = smem + ((K + 3) & ~3);      // the packed gram
    for (int a = tid; a < K; a += WARPS * 32) R[a] = rows.start[a];
    for (int e = tid; e < K * K; e += WARPS * 32) {
      const int k = e / K, l = e % K;
      if (l >= k) Gs[rows.start[k] + l - k] = xtx[e];
    }
    __syncthreads();
    SharedColumns<L> cols{&next, Gs, xty, beta0, out, M, j0, Sh::COLUMNS};
    cd_group_columns<C, L>(cols, R, K, solver.lam, solver.alpha, solver.tol,
                           solver.max_sweeps);
  } else {
    const int GS = K + 1;
    float* Gs = smem;                      // (K, GS) the shared gram
    for (int e = tid; e < K * K; e += WARPS * 32)
      Gs[(e / K) * GS + e % K] = xtx[e];
    __syncthreads();
    float* W = smem + (((size_t)K * (K + 1) + 3) & ~(size_t)3) +
               (size_t)w * Solver<false>::workspace_floats(C, K);
    for (;;) {
      const int cl = next_column(&next);
      const int j = j0 + cl;
      if (cl >= Sh::COLUMNS || j >= M) break;   // warp-uniform
      float b[C], beta[C];
      load_coords<C>(xty, K, M, j, b);
      load_coords<C>(beta0, K, M, j, beta);
      solve_column<AMAX, C>(solver, Gs, W, K, GS, b, beta);
      store_coords<C>(out, K, M, j, beta);
    }
  }
}

template <int AMAX, int C, bool CD, int L = 32>
cudaError_t launch(const float* xtx, const float* xty, const float* beta0,
                   float* out, int M, int K, Solver<CD> solver,
                   cudaStream_t stream) {
  using Sh = Shape<C, CD, L>;
  const size_t smem = Sh::smem_bytes(K);
  const auto kernel = shared_kernel<AMAX, C, CD, L>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  Rows rows{};                             // CD: the packed gram's rows
  if (CD) packed_rows<L>(K, rows.start);
  kernel<<<ceil_div(M, Sh::COLUMNS), Sh::WARPS * 32, smem, stream>>>(
      xtx, xty, beta0, out, M, K, solver, rows);
  return cudaGetLastError();
}

// Calls f(std::integral_constant<int, C>(), std::integral_constant<int,
// L>()) with CD's group width L at K (header) and C = ceil(K / L).
template <class F>
cudaError_t cd_width(int K, F f) {
  using std::integral_constant;
  auto go = [&](auto l) {
    constexpr int L = decltype(l)::value;
    return by_lane_count(K * 32 / L, [&](auto c) { return f(c, l); });
  };
  if (K <= 32) return go(integral_constant<int, 8>());
  if (K <= 64) return go(integral_constant<int, 16>());
  return go(integral_constant<int, 32>());
}

int fss_shared(const float* xtx, const float* xty, const float* beta0,
               float* out, int M, int K, Solver<false> solver,
               cudaStream_t stream) {
  if (M < 1 || K < 1 || K > 128) return (int)cudaErrorInvalidValue;
  return (int)by_width(K, [&](auto c, auto amax) {
    return launch<decltype(amax)::value, decltype(c)::value>(
        xtx, xty, beta0, out, M, K, solver, stream);
  });
}

int cd_shared(const float* xtx, const float* xty, const float* beta0,
              float* out, int M, int K, Solver<true> solver,
              cudaStream_t stream) {
  if (M < 1 || K < 1 || K > 128) return (int)cudaErrorInvalidValue;
  return (int)cd_width(K, [&](auto c, auto l) {
    return launch<32, decltype(c)::value, true, decltype(l)::value>(
        xtx, xty, beta0, out, M, K, solver, stream);
  });
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
  return fss_shared(xtx, xty, beta0, out, M, K,
                    Solver<false>{l1, l2, tol, max_outer, polish_sweeps},
                    stream);
}

// out (K, M) = the cold strong-rule CD solution of every column against the
// one gram xtx (K, K), at most max_sweeps sweeps.  xty and beta0 (K, M):
// row-major f32.  lam, alpha, tol as f32; 1 <= K <= 128.
INSIDER_API int insider_cd_shared(const float* xtx, const float* xty,
                                  const float* beta0, float* out, float lam,
                                  float alpha, float tol, int M, int K,
                                  int max_sweeps, cudaStream_t stream) {
  return cd_shared(xtx, xty, beta0, out, M, K,
                   Solver<true>{lam, alpha, tol, max_sweeps}, stream);
}
