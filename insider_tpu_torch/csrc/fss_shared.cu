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
// Design: each block copies the one gram into shared memory once, and its
// warps share it: a block's columns cost it no shared memory.  Its columns
// are handed out from a shared counter, so a warp or group that finishes
// early takes the next; the grid holds no more blocks than the card runs
// at once, each with an equal share of the columns (at least CPW a warp
// or group), so the work ends with the last column, not in a part-empty
// last wave.
//
// FSS at K <= 32: 8 warps, P = 32 / L columns a warp, one to each group
// of L lanes (fss_core.cuh: fss_group_columns): one issue of an outer
// step's chain (pivots, shuffles, ballots) serves P columns.  The gram is
// (K, K + 1) as the one-warp solve read it (the FSS reads both triangles,
// so a gram that is not symmetric gives the one-warp solve's bits too);
// each group has its own pair of pivot-row buffers (288 bytes).  The
// groups take the block's columns for their outer steps, storing each FSS
// result; after a block barrier they take them again for the polish
// (polish_group_columns), refilled at sweep boundaries.  With the polish
// inside the step loop a warp ran both bodies while its groups were in
// both phases: 0.133 against 0.117 ms a launch in the dense fit at K=24,
// 1.42 against 0.97-1.01 ms alone.  Two blocks an SM where the registers
// allow it (group_blocks).  The width L is fixed by K (fss_instances: the
// first listed runs) from the times of every width: L = 4 at K <= 4
// (PsychENCODE's K=3: 0.062-0.085 ms, L = 8 0.066-0.084, one column a
// warp 0.102-0.106), L = 8 at K <= 24 (K=24: 1.007-1.010 ms alone, L = 16
// 1.41, L = 32 1.38-1.39; in the dense fit 0.115 ms a launch, L = 16
// 0.173-0.174, L = 32 0.234-0.235), L = 16 at K <= 32 (BrainSpan's K=25:
// 2.07-2.13 ms, L = 8 2.09-2.11, L = 32 2.37-2.42; K = 28 and 32 alike).
// At K=24, L = 8: 128 registers, 2 blocks (16 warps, 64 columns) an SM,
// 12 KB of shared memory a block.  (chip_ab.py, NVIDIA H100 80GB HBM3 at
// 700 W, also on trees with the polish inside the step loop and with one
// or two blocks an SM.)
//
// FSS at 32 < K <= 128: one column a warp (fss_column), an active set
// above 32 coordinates in a per-warp shared workspace; the warps of a
// block share its gram, as many as shared memory allows, at most 4 (4 at
// K <= 96, 195 KB at K=96, one block an SM; 2 at K=128, 204 KB), against
// one gram a warp before (two warps an SM at K=96, one at K=128): 9.93-9.99
// against 14.89-15.01 ms at K=96 and 40.39-40.55 against 66.59-67.18 at
// K=128 (M=2048).
//
// CD runs the one cold-CD loop (fss_core.cuh: cd_group_columns) on the
// gram packed to its upper triangle (packed_rows; 33 KB at K=128), 8
// warps at every K, P = 32 / L columns a warp: L = 8 at K <= 32, 16 at K
// <= 64, 32 above (cd_width).  A group whose column converges takes the
// block's next at the next sweep boundary (refill), and a block owns 4
// columns a group, so that refills happen.  At K=24 (L = 8) it took
// 0.23-0.24 ms on chip_smoke.py's phase-5 input and 2.31-2.32 ms a launch
// in the cold-CD flagship dense fit, against 0.37-0.38 and 4.99-5.02 for
// one column a warp on the full (K, K + 1) gram (chip_ab.py, NVIDIA H100
// 80GB HBM3 at 700 W).
#include "fss_core.cuh"

namespace {

using insider::by_lane_count;
using insider::cd_group_columns;
using insider::ceil_div;
using insider::fss_group_columns;
using insider::group_take;
using insider::load_coords;
using insider::max_dynamic_smem;
using insider::next_column;
using insider::packed_rows;
using insider::PIVOT_ROW;
using insider::polish_group_columns;
using insider::residency;
using insider::Residency;
using insider::Rows;
using insider::Solver;
using insider::solve_column;
using insider::store_coords;

constexpr int CPW = 4;   // columns per warp (CD, grouped FSS: per group)
constexpr int CD_WARPS = 8, GROUP_WARPS = 8, WIDE_WARPS = 4;

// Floats of the FSS gram (K, K + 1), padded to 16 bytes.
__host__ __device__ size_t gram_floats(int K) {
  return ((size_t)K * (K + 1) + 3) & ~(size_t)3;
}

// The columns of a block (ragged at M: a column past it is not taken).
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

// Copies the gram xtx (K, K) into Gs with row stride K + 1.
__device__ __forceinline__ void copy_gram(const float* __restrict__ xtx,
                                          float* Gs, int K) {
  for (int e = threadIdx.x; e < K * K; e += blockDim.x)
    Gs[(e / K) * (K + 1) + e % K] = xtx[e];
}

// Blocks an SM of the grouped FSS instance (AMAX, L) that its registers
// are held to: two where a lane's compact rows (C x AMAX floats) take at
// most 72 registers, which then fit beside the rest in 128 (at K=24, L =
// 8: in the dense fit 0.117 against 0.162 ms a launch with one block of
// 137 registers an SM); else one (L = 8 at AMAX = 32, 128 registers of
// compact rows: held to 128 they spill, 2.98 against 2.07-2.14 ms alone at
// K=25).  (chip_ab.py, header.)
constexpr int group_blocks(int AMAX, int L) {
  return (AMAX + L - 1) / L * AMAX <= 72 ? 2 : 1;
}

// FSS at K <= 32: an FSS pass and a polish pass over the block's `cols`
// columns, P = 32 / L a warp.  Shared memory: the gram, then two pivot-row
// buffers a group.
template <int AMAX, int L>
__global__ void __launch_bounds__(GROUP_WARPS * 32, group_blocks(AMAX, L))
shared_kernel_groups(const float* __restrict__ xtx,
                     const float* __restrict__ xty,
                     const float* __restrict__ beta0, float* __restrict__ out,
                     int M, int K, int cols, Solver<false> solver) {
  constexpr int C = (AMAX + L - 1) / L;
  extern __shared__ __align__(16) float smem[];
  __shared__ int next[2];                  // the two passes' counters
  if (threadIdx.x < 2) next[threadIdx.x] = 0;
  copy_gram(xtx, smem, K);
  __syncthreads();
  const int j0 = blockIdx.x * cols;
  float* P = smem + gram_floats(K) + (threadIdx.x / L) * 2 * PIVOT_ROW;
  SharedColumns<L> fss{&next[0], smem, xty, beta0, out, M, j0, cols};
  fss_group_columns<AMAX, C, L>(fss, smem, K + 1, P, K, solver.l1, solver.l2,
                                solver.max_outer);
  if (solver.polish_sweeps > 0) {
    __syncthreads();                       // every FSS result is stored
    SharedColumns<L> polish{&next[1], smem, xty, out, out, M, j0, cols};
    polish_group_columns<C, L>(polish, smem, K + 1, K, solver.l1, solver.l2,
                               solver.tol, solver.polish_sweeps);
  }
}

// FSS at K > 32: one column a warp (C = ceil(K / 32) coordinates a lane),
// the block's warps taking its `cols` columns one at a time.  Shared
// memory: the gram, then each warp's workspace.
template <int C>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
shared_kernel_wide(const float* __restrict__ xtx,
                   const float* __restrict__ xty,
                   const float* __restrict__ beta0, float* __restrict__ out,
                   int M, int K, int cols, Solver<false> solver) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int next;
  if (threadIdx.x == 0) next = 0;
  copy_gram(xtx, smem, K);
  __syncthreads();
  float* W = smem + gram_floats(K) + (threadIdx.x >> 5) *
             (size_t)Solver<false>::workspace_floats(C, K);
  for (;;) {
    const int cl = next_column(&next);
    const int j = blockIdx.x * cols + cl;
    if (cl >= cols || j >= M) break;       // warp-uniform
    float b[C], beta[C];
    load_coords<C>(xty, K, M, j, b);
    load_coords<C>(beta0, K, M, j, beta);
    solve_column<32, C>(solver, smem, W, K, K + 1, b, beta);
    store_coords<C>(out, K, M, j, beta);
  }
}

// CD: the packed gram's row starts (K ints, padded to 16 bytes), then the
// packed gram; CPW columns a group.
template <int C, int L>
__global__ void __launch_bounds__(CD_WARPS * 32)
shared_kernel(const float* __restrict__ xtx, const float* __restrict__ xty,
              const float* __restrict__ beta0, float* __restrict__ out, int M,
              int K, Solver<true> solver, Rows rows) {
  constexpr int COLUMNS = CD_WARPS * CPW * (32 / L);
  extern __shared__ __align__(16) float smem[];
  __shared__ int next;                     // the solve's column counter
  const int tid = threadIdx.x;
  if (tid == 0) next = 0;
  int* R = reinterpret_cast<int*>(smem);   // the packed gram's rows
  float* Gs = smem + ((K + 3) & ~3);       // the packed gram
  for (int a = tid; a < K; a += CD_WARPS * 32) R[a] = rows.start[a];
  for (int e = tid; e < K * K; e += CD_WARPS * 32) {
    const int k = e / K, l = e % K;
    if (l >= k) Gs[rows.start[k] + l - k] = xtx[e];
  }
  __syncthreads();
  SharedColumns<L> cols{&next, Gs, xty, beta0, out, M,
                        (int)blockIdx.x * COLUMNS, COLUMNS};
  cd_group_columns<C, L>(cols, R, K, solver.lam, solver.alpha, solver.tol,
                         solver.max_sweeps);
}

// Launches `kernel` on no more blocks than the card runs at once, each
// with an equal share of the M columns and at least CPW a unit (a warp or
// group; `units` a block).
template <auto kernel>
cudaError_t launch_shared(int threads, size_t smem, int units,
                          const float* xtx, const float* xty,
                          const float* beta0, float* out, int M, int K,
                          Solver<false> solver, cudaStream_t stream) {
  Residency res;
  cudaError_t err = residency<kernel>(threads, smem, res);
  if (err != cudaSuccess) return err;
  if (res.per_sm < 1) return cudaErrorInvalidConfiguration;
  const int most = ceil_div(M, units * CPW);
  const int blocks = most < res.per_sm * res.sms ? most : res.per_sm * res.sms;
  kernel<<<blocks, threads, smem, stream>>>(xtx, xty, beta0, out, M, K,
                                            ceil_div(M, blocks), solver);
  return cudaGetLastError();
}

// The grouped FSS instance (AMAX, L): its threads, groups and shared
// bytes.
template <int AMAX, int L>
struct Grouped {
  static constexpr int THREADS = GROUP_WARPS * 32, UNITS = THREADS / L;
  static size_t smem(int K) {
    return sizeof(float) * (gram_floats(K) + (size_t)UNITS * 2 * PIVOT_ROW);
  }
};

// Calls f(amax, widths...) with the grouped FSS instances' register width
// AMAX (K rounded up to 4, 8, 16, 24 or 32) and group widths L at K <= 32,
// the one the kernel runs first (header) listed first.
template <class F>
cudaError_t fss_instances(int K, F&& f) {
  using std::integral_constant;
  using I4 = integral_constant<int, 4>;
  using I8 = integral_constant<int, 8>;
  using I16 = integral_constant<int, 16>;
  using I32 = integral_constant<int, 32>;
  if (K <= 4) return f(I4(), I4(), I8(), I32());
  if (K <= 8) return f(I8(), I8(), I4(), I32());
  if (K <= 16) return f(I16(), I8(), I16(), I32());
  if (K <= 24) return f(integral_constant<int, 24>(), I8(), I16(), I32());
  return f(I32(), I16(), I8(), I32());
}

// The warps of a K > 32 block: as many workspaces as fit beside the gram
// in the shared memory a block may take, at most WIDE_WARPS.
template <int C>
cudaError_t wide_warps(int K, int& warps) {
  int most = 0;
  const cudaError_t err = max_dynamic_smem<shared_kernel_wide<C>>(most);
  if (err != cudaSuccess) return err;
  const long ws = sizeof(float) * Solver<false>::workspace_floats(C, K);
  const long left = most - (long)(sizeof(float) * gram_floats(K));
  warps = (int)(left / ws);
  warps = warps < WIDE_WARPS ? warps : WIDE_WARPS;
  return warps < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

int fss_shared(const float* xtx, const float* xty, const float* beta0,
               float* out, int M, int K, Solver<false> solver, int lanes,
               cudaStream_t stream) {
  if (M < 1 || K < 1 || K > 128) return (int)cudaErrorInvalidValue;
  if (K > 32) {
    if (lanes != 0 && lanes != 32) return (int)cudaErrorInvalidValue;
    return (int)by_lane_count(K, [&](auto c) {
      constexpr int C = decltype(c)::value;
      int warps = 0;
      cudaError_t err = wide_warps<C>(K, warps);
      if (err != cudaSuccess) return err;
      const size_t smem =
          sizeof(float) *
          (gram_floats(K) +
           (size_t)warps * Solver<false>::workspace_floats(C, K));
      return launch_shared<shared_kernel_wide<C>>(warps * 32, smem, warps,
                                                  xtx, xty, beta0, out, M, K,
                                                  solver, stream);
    });
  }
  return (int)fss_instances(K, [&](auto amax, auto... ls) {
    constexpr int AMAX = decltype(amax)::value;
    cudaError_t err = cudaErrorInvalidValue;
    bool found = false;
    (
        [&](auto l) {
          constexpr int L = decltype(l)::value;
          using G = Grouped<AMAX, L>;
          if (found || (lanes != 0 && lanes != L)) return;
          found = true;
          err = launch_shared<shared_kernel_groups<AMAX, L>>(
              G::THREADS, G::smem(K), G::UNITS, xtx, xty, beta0, out, M, K,
              solver, stream);
        }(ls),
        ...);
    return err;
  });
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

int cd_shared(const float* xtx, const float* xty, const float* beta0,
              float* out, int M, int K, Solver<true> solver,
              cudaStream_t stream) {
  if (M < 1 || K < 1 || K > 128) return (int)cudaErrorInvalidValue;
  return (int)cd_width(K, [&](auto c, auto l) {
    constexpr int C = decltype(c)::value, L = decltype(l)::value;
    const size_t smem = sizeof(float) * (((K + 3) & ~3) + packed_rows<L>(K));
    const auto kernel = shared_kernel<C, L>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    Rows rows{};                           // the packed gram's rows
    packed_rows<L>(K, rows.start);
    kernel<<<ceil_div(M, CD_WARPS * CPW * (32 / L)), CD_WARPS * 32, smem,
             stream>>>(xtx, xty, beta0, out, M, K, solver, rows);
    return cudaGetLastError();
  });
}

}  // namespace

// out (K, M) = the FSS + polish solution of every column against the one
// gram xtx (K, K).  xty and beta0 (K, M): row-major f32.  l1 = lam*alpha
// and l2 = lam*(1-alpha) as f32; 1 <= K <= 128.  lanes: the group width L,
// 0 for the instance the kernel runs at this K (header), else that of an
// instance covering K (insider_fss_shared_widths; cudaErrorInvalidValue
// where none does).
INSIDER_API int insider_fss_shared(const float* xtx, const float* xty,
                                   const float* beta0, float* out, float l1,
                                   float l2, float tol, int M, int K,
                                   int max_outer, int polish_sweeps,
                                   int lanes, cudaStream_t stream) {
  return fss_shared(xtx, xty, beta0, out, M, K,
                    Solver<false>{l1, l2, tol, max_outer, polish_sweeps},
                    lanes, stream);
}

// The FSS instances of insider_fss_shared that cover K, the one it runs
// first: *n of them (at most 3), their group widths L into widths[] (32:
// one column a warp), and where `columns` is given, the columns an SM of
// the current device solves at once with each into columns[].
INSIDER_API int insider_fss_shared_widths(int K, int* n, int* widths,
                                          int* columns) {
  if (K < 1 || K > 128) return (int)cudaErrorInvalidValue;
  *n = 0;
  Residency res;
  if (K > 32)
    return (int)by_lane_count(K, [&](auto c) {
      constexpr int C = decltype(c)::value;
      int warps = 0;
      cudaError_t err = wide_warps<C>(K, warps);
      if (err == cudaSuccess && columns != nullptr)
        err = residency<shared_kernel_wide<C>>(
            warps * 32,
            sizeof(float) * (gram_floats(K) +
                             (size_t)warps *
                                 Solver<false>::workspace_floats(C, K)),
            res);
      if (err != cudaSuccess) return err;
      if (columns != nullptr) columns[0] = res.per_sm * warps;
      widths[(*n)++] = 32;
      return cudaSuccess;
    });
  return (int)fss_instances(K, [&](auto amax, auto... ls) {
    constexpr int AMAX = decltype(amax)::value;
    cudaError_t err = cudaSuccess;
    (
        [&](auto l) {
          constexpr int L = decltype(l)::value;
          using G = Grouped<AMAX, L>;
          if (err != cudaSuccess) return;
          if (columns != nullptr &&
              (err = residency<shared_kernel_groups<AMAX, L>>(
                   G::THREADS, G::smem(K), res)) == cudaSuccess)
            columns[*n] = res.per_sm * G::UNITS;
          widths[(*n)++] = L;
        }(ls),
        ...);
    return err;
  });
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
