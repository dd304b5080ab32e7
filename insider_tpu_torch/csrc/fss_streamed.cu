// feature_sign and cd_streamed: the column update on streamed per-gene
// grams.  Per gene column j one warp (CD: one group of L lanes) solves the
// elastic net on the gram xtx[:, :, j] and Xty xty[:, j] with a solver of
// fss_core.cuh: the feature-sign search (FSS) and its plain-CD polish, or
// cold strong-rule coordinate descent (CD).
//
// Replaces insider_tpu/kernels/fss_pallas.py:feature_sign_pallas (body
// _fss_kernel -> _fss_compute), insider_tpu/kernels/cd_pallas.py:
// elastic_net_cd_pallas (body _cd_kernel -> _cd_compute) and
// insider_tpu/kernels/cd_packed.py:elastic_net_cd_packed_pallas (the CD
// iteration with the column axis in an (8, BM/8) TPU sublane layout, a
// layout question that does not arise on the GPU).  The grams come from
// col_gram_xty.cu: the JAX package's streamed route
// (insider_tpu/ops/col_update.py:378-390, :463-478), which the port takes
// for K > 32, where the fused kernel's one coordinate per lane does not
// reach.  For CD the caller permutes the problem to set the sweep order.
// Above K = 128, to K = 320, FSS runs the grouped solve (below) and CD the
// grouped loop; past 320 both run the block solve, one column a block
// (fss_wide.cuh).
//
// Bound on the H100: the (K, K, M) gram read, K^2 M f32 (445 MB at K=50,
// M=44477), and the serial solve of each column, latency-bound: FSS
// eliminates a pivots per outer step (a the active coordinates), each an
// a-wide row update; CD up to max_sweeps x K dependent coordinate updates
// (two warp shuffles and a K-wide shared-memory row read each).
//
// Design: persistent one-warp blocks, as many as the card holds at once.
// A warp takes the next columns from a grid-wide counter (an atomic add on
// `next`, which the entry point zeroes), copies those columns' grams into
// its own slice of shared memory, runs the solver, writes the columns and
// takes the next: a column that needs many steps holds up no other, and no
// block waits for its slowest warp.  Which warp takes a column differs from
// run to run; a column's arithmetic does not depend on it, so repeated runs
// agree bit for bit.  A gram's K^2 entries lie M floats apart; the warps
// hold neighbouring columns at about the same time (the counter hands them
// out in order), so each 32-byte sector is read from device memory about
// once and from L2 the rest.  FSS solves an active set of up to 32
// coordinates in registers, a larger one (K > 32 only) in its slice
// (fss_core.cuh: Solver<false>::workspace_floats).  FSS: one column a warp,
// a slice of 21 KB at K=50 (ten warps an SM), 77 KB at K=96, 135 KB at
// K=128.
//
// CD: the one cold-CD loop (fss_core.cuh: cd_group_columns), P = 32 / L
// columns a warp, one to each group of L lanes, on grams packed to their
// upper triangle; the counter hands out P neighbouring columns at a time.
// With one column a warp, each coordinate update issues its whole scalar
// chain (soft threshold, decrease term, two shuffles) for the one lane
// that uses it, and the card holds as many columns as slices fit (20 an
// SM at K=50 with K x (K + 1) slices, 6 at K=96, 3 at K=128): with few
// warps a scheduler, each waits on its own chain.  A group of L lanes
// issues the chain once for P columns, and a packed gram takes half the
// floats, so an SM holds about twice the columns (38 at K=50, 12 at K=96,
// 6 at K=128 for L = 16).  The packed rows start where the L lanes of a
// group, and the P groups of a warp, read a row or a column of their
// grams in distinct banks (fss_core.cuh: packed_rows); the copy moves each
// entry with cp.async, many in flight a lane.  Every width gives the same
// bits (tests/test_torch_cuda.py, chip_ab.py).
//
// The width is fixed by K (cd_instances: the first instance listed), from
// times on an NVIDIA H100 80GB HBM3 at 700 W (chip_ab.py).  With every
// column at the 200-sweep cap (M=8192), L = 16 takes 0.57-0.85 of one
// column a warp's time at K = 33-80, 0.94-0.95 at K = 103 and 1.03-1.10 at
// K = 96, 113 and 128, where packed grams leave room for twice the
// one-column warps (PERF.md).  Four columns a warp (L = 8) took
// 0.81-1.27 of L = 16's at K = 33-64, less only at K = 33, 50 and 57; in
// the cold-CD K=50 fit, where columns stop at different sweeps and the
// groups of a warp wait for its slowest, L = 16 took 14.7 ms a launch, L
// = 8 15.6 and one column a warp 17.9; so L = 8 is not built.  The L = 32
// instances at K > 32 are no fit's choice: the tests and timings run them
// through the lanes hook.  At K <= 32 (where cd_fused, not this kernel,
// runs in a fit) L = 16 took 0.99-1.02 ms at K=16 and 1.40-1.42 at K=24
// with every column at the cap, L = 32 1.62-1.69 and 2.58-2.68.  Instances
// (L, C): K <= 32 (16, 2), (32, 1); K <= 64 (16, 4), (32, 2); K <= 96 (16,
// 6), (32, 3); K <= 128 (16, 8), (32, 4).
//
// Past K = 128, to CD_GROUP_MAX_K = 320, the loop holds C = ceil(K / L)
// slots a lane in two instances.  L = 32 copies one column's packed gram
// into its warp's slice, as above (51.5 KB at K=160: four columns an SM,
// three at 192, two at 224, one from ~235).  L = 16, past K = 192, copies
// its two columns' grams K x K row-major into device scratch and reads
// their rows through L2 (streamed_global_kernel; cd_group_columns with
// ROW_MAJOR, each row issued a coordinate ahead): 16 columns an SM, as
// many as its 212-255 registers allow.  With every column at the
// 200-sweep cap (M=2048; chip_ab.py --wide-cd, NVIDIA H100 80GB HBM3 at
// 700 W) L = 32 took 14.8 ms at K=160 and 23.0 at 192, where L = 16 took
// 21.9 and 28.3; L = 16 took 36.7, 44.2 and 70.2 ms at K = 224, 256 and
// 320, L = 32 41.5, 92.9 and 127.7; the block solve 75.7-198.  So L = 32
// runs to K = 192 and L = 16 past it, first.  On phase 6's problems (M =
// 2048 columns at most a few times what the card holds, so the slowest
// column sets the time) L = 32 is the faster by 3-28% at K = 224 and
// 288-320.  Every width gives the block solve's bits (lanes = 128, which
// selects it).
//
// FSS past K = 128, to 320, the grouped solve, two launches: the steps
// (fss_wide.cuh: steps_kernel), a block a column, each column's gram
// copied K x K into the block's slice of scratch and read through L2, two
// blocks of 8 warps an SM where two active systems of K fit in its shared
// memory (K <= 160), else one of 16; then the polish on the CD instance
// above with polish on (cd_group_columns: every coordinate active),
// reading the steps' output as its warm start, L = 32 at every K
// (polish_width).  Its width is named by the polish's L; it gives the
// block solve's bits (lanes = 128).  In the K = 160 masked fit
// (chip_smoke.py phase 18, NVIDIA H100 80GB HBM3 at 700 W) 63.1 ms a launch
// against the block's 387.6, the fit 325.9 ms/iter against 2472.2
// (PERF.md).
//
// The groups of a warp sweep in lockstep, so a column that converges early
// waits for the other of its warp; handing it a new column in mid-flight
// (as cd_fused does) is not done here.  In the cold-CD K=50 fit's steady
// state 30% of the columns stop before the cap, and two neighbouring
// columns swept together take 1.26 times the sweeps of each alone
// (chip_smoke.py phase 12).
#include "fss_wide.cuh"

namespace {

using insider::by_width;
using insider::cd_group_columns;
using insider::ceil_div;
using insider::load_coords;
using insider::next_column;
using insider::packed_rows;
using insider::packed_stride;
using insider::residency;
using insider::Residency;
using insider::Rows;
using insider::Solver;
using insider::solve_column;
using insider::store_coords;

// Floats of one warp's slice of shared memory.  FSS (L = 32): its column's
// gram (K, K + 1), padded to 16 bytes, then the solver's workspace.  CD:
// the packed grams' row starts (K ints, padded to 32), then P = 32 / L
// packed grams (fss_core.cuh: packed_rows, packed_stride).
template <int C, int L, bool CD>
__host__ __device__ int slice_floats(int K) {
  if (!CD)
    return ((K * (K + 1) + 3) & ~3) + Solver<false>::workspace_floats(C, K);
  return ((K + 31) & ~31) + 32 / L * packed_stride<L>(K);
}

// Copies 4 bytes from device to shared memory without a register
// (cp.async), so that a lane keeps many loads in flight.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// The CD solve's columns (cd_group_columns' feed): group g of the warp
// takes column j0 + g once, its gram packed in slot g of the slice.
template <int L>
struct StreamedColumns {
  static constexpr bool REFILL = false;
  const float* grams;
  const float* xty_;
  const float* beta0_;
  float* out;
  int S, M, j0;
  bool given;
  __device__ int next(unsigned) {
    const int g = (threadIdx.x & 31) / L;
    const bool first = !given;
    given = true;
    return first && j0 + g < M ? g : -1;
  }
  __device__ const float* gram(int c) const { return grams + c * S; }
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

template <int AMAX, int C, int L, bool CD>
__global__ void __launch_bounds__(32)
streamed_kernel(const float* __restrict__ xtx, const float* __restrict__ xty,
                const float* __restrict__ beta0, float* __restrict__ out,
                int* __restrict__ next, int M, int K, Solver<CD> solver,
                Rows rows, bool polish) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x;
  if constexpr (!CD) {
    static_assert(L == 32, "FSS: one column a warp");
    const int GS = K + 1;
    float* Gs = smem;                                // (K, GS) the gram
    float* W = smem + ((K * GS + 3) & ~3);           // the solver's
    for (;;) {
      const int j = next_column(next);
      if (j >= M) break;                             // warp-uniform
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
      __syncwarp();                                  // Gs is read no more
    }
  } else {
    constexpr int P = 32 / L;
    int* R = reinterpret_cast<int*>(smem);           // the row starts
    for (int a = lane; a < K; a += 32) R[a] = rows.start[a];
    __syncwarp();
    float* grams = smem + ((K + 31) & ~31);
    const int S = rows.stride;                       // one column's gram
    const int h = lane & (P - 1);                    // the column it copies
    const int n = K * (K + 1) / 2;
    for (;;) {
      const int j0 = next_column(next) * P;
      if (j0 >= M) break;                            // warp-uniform
      // lane h + P t copies entries t, t + 32 / P, ... of the upper
      // triangle of column j0 + h in row order, (k, l >= k) from
      // xtx[k][l] (a group past the last column takes none)
      if (j0 + h < M) {
        float* Gh = grams + h * S;
        const float* src = xtx + j0 + h;
        int k = 0, l = lane / P;
#pragma unroll 8
        for (int e = lane / P; e < n; e += 32 / P, l += 32 / P) {
          while (l >= K) l -= K - ++k;               // next row: l from k
          copy_async(Gh + R[k] + l - k, src + ((size_t)k * K + l) * M);
        }
        asm volatile("cp.async.wait_all;\n" ::);
      }
      __syncwarp();
      StreamedColumns<L> cols{grams, xty, beta0, out, S, M, j0, false};
      cd_group_columns<C, L>(cols, R, K, solver.lam, solver.alpha,
                             *solver.tol, solver.max_sweeps, polish);
      __syncwarp();                                  // the grams are read
    }                                                // no more
  }
}

// Floats of one column's gram in streamed_global_kernel's slices: K x K,
// rounded up to 128 bytes.
__host__ __device__ inline int square_stride(int K) {
  return (K * K + 31) & ~31;
}

// CD past 128 coordinates with the grams read through L2: each one-warp
// block copies the grams of its P = 32 / L columns from xtx into its own
// slice of device scratch, K x K row-major (each entry of the upper
// triangle, xtx[k][l] for l >= k, written to [k][l] and [l][k]; stride
// square_stride), and the solve reads them there (cd_group_columns with
// ROW_MAJOR: a group's lanes read neighbouring floats of one row); no gram
// takes shared memory, so the registers, not the grams, decide how many
// warps an SM holds.
template <int C, int L>
__global__ void __launch_bounds__(32)
streamed_global_kernel(const float* __restrict__ xtx,
                       const float* __restrict__ xty,
                       const float* __restrict__ beta0,
                       float* __restrict__ out, int* __restrict__ next,
                       float* __restrict__ scratch, int M, int K,
                       Solver<true> solver) {
  constexpr int P = 32 / L;
  const int lane = threadIdx.x;
  const int S = square_stride(K);                   // one column's gram
  float* grams = scratch + (size_t)blockIdx.x * P * S;
  const int h = lane & (P - 1);                      // the column it copies
  const int n = K * (K + 1) / 2;
  for (;;) {
    const int j0 = next_column(next) * P;
    if (j0 >= M) break;                              // warp-uniform
    // lane h + P t copies entries t, t + 32 / P, ... of the upper triangle
    // of column j0 + h in row order, through registers
    if (j0 + h < M) {
      float* Gh = grams + h * S;
      const float* src = xtx + j0 + h;
      int k = 0, l = lane / P;
#pragma unroll 8
      for (int e = lane / P; e < n; e += 32 / P, l += 32 / P) {
        while (l >= K) l -= K - ++k;                 // next row: l from k
        const float v = src[((size_t)k * K + l) * M];
        Gh[k * K + l] = v;
        Gh[l * K + k] = v;
      }
    }
    __syncwarp();                                    // the copies are seen
    StreamedColumns<L> cols{grams, xty, beta0, out, S, M, j0, false};
    cd_group_columns<C, L, true>(cols, nullptr, K, solver.lam, solver.alpha,
                                 *solver.tol, solver.max_sweeps);
    __syncwarp();                                    // the grams are read
  }                                                  // no more
}

// The one-warp blocks of streamed_global_kernel<C, L> at M: as many as the
// card holds at once, no more than there are groups of P columns; 0 where
// the residency cannot be read.
template <int C, int L>
int global_blocks(int M) {
  Residency res;
  if (residency<streamed_global_kernel<C, L>>(32, 0, res) != cudaSuccess)
    return 0;
  const int most = res.per_sm * res.sms, groups = ceil_div(M, 32 / L);
  return groups < most ? groups : most;
}

// Floats of device scratch streamed_global_kernel<C, L> needs at (M, K).
template <int C, int L>
long global_scratch_floats(int M, int K) {
  return (long)global_blocks<C, L>(M) * (32 / L) * square_stride(K);
}

template <int C, int L>
cudaError_t launch_global(const float* xtx, const float* xty,
                          const float* beta0, float* out, int* next,
                          float* scratch, long scratch_len, int M, int K,
                          Solver<true> solver, cudaStream_t stream) {
  const int blocks = global_blocks<C, L>(M);
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  if (next == nullptr || scratch == nullptr ||
      scratch_len < global_scratch_floats<C, L>(M, K))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(next, 0, sizeof(int), stream);
  if (err != cudaSuccess) return err;
  streamed_global_kernel<C, L><<<blocks, 32, 0, stream>>>(
      xtx, xty, beta0, out, next, scratch, M, K, solver);
  return cudaGetLastError();
}

// Launches as many one-warp blocks as the card holds at once (no more than
// there are groups of P = 32 / L columns); CD with polish: the FSS polish
// (cd_group_columns), solver holding l1 and l2 for lam and alpha.
template <int AMAX, int C, int L, bool CD>
cudaError_t launch(const float* xtx, const float* xty, const float* beta0,
                   float* out, int* next, int M, int K, Solver<CD> solver,
                   cudaStream_t stream, bool polish = false) {
  Residency res;
  cudaError_t err = residency<streamed_kernel<AMAX, C, L, CD>>(
      32, sizeof(float) * slice_floats<C, L, CD>(K), res);
  if (err != cudaSuccess) return err;
  if (res.per_sm < 1) return cudaErrorInvalidConfiguration;
  Rows rows{};                            // CD: the packed grams' rows
  if (CD) {
    packed_rows<L>(K, rows.start);
    rows.stride = packed_stride<L>(K);
  }
  const int blocks = res.per_sm * res.sms, groups = ceil_div(M, 32 / L);
  if ((err = cudaMemsetAsync(next, 0, sizeof(int), stream)) != cudaSuccess)
    return err;
  streamed_kernel<AMAX, C, L, CD>
      <<<groups < blocks ? groups : blocks, 32,
         sizeof(float) * slice_floats<C, L, CD>(K), stream>>>(
          xtx, xty, beta0, out, next, M, K, solver, rows, polish);
  return cudaGetLastError();
}

// Calls f(Group<C, L, GLOBAL>()...) with the CD instances that cover K <=
// CD_GROUP_MAX_K, the one the kernel runs first listed first (header): at K
// <= 128 L = 16 and 32 on grams in shared memory; past it L = 32 on a gram
// in shared memory, and past K = 192 before it L = 16 on grams read
// through L2 (GLOBAL).
template <class F>
cudaError_t cd_instances(int K, F&& f) {
  using insider::Group;
  if (K <= 32) return f(Group<2, 16>(), Group<1, 32>());
  if (K <= 64) return f(Group<4, 16>(), Group<2, 32>());
  if (K <= 96) return f(Group<6, 16>(), Group<3, 32>());
  if (K <= insider::NARROW_MAX_K) return f(Group<8, 16>(), Group<4, 32>());
  return insider::by_wide_slots(K, [&](auto c16, auto c32) {
    using Shared = Group<decltype(c32)::value, 32>;
    using Global = Group<decltype(c16)::value, 16, true>;
    if constexpr (decltype(c16)::value <= 12) return f(Shared());
    else return f(Global(), Shared());
  });
}

// Whether insider_cd_streamed and insider_fss_streamed run the block solve
// (fss_wide.cuh) at K with this lanes argument.
bool block_solve(int K, int lanes) {
  return K > insider::CD_GROUP_MAX_K ||
         (K > insider::NARROW_MAX_K && lanes == insider::WIDE_THREADS);
}

// Runs launch(g) for the CD instance g that polishes the steps' output at
// K: L = 32, a packed gram in shared memory, at every K (lanes 0
// or 32, else cudaErrorInvalidValue).  On phase 6's problems the L = 16
// instance on grams read through L2 was as fast or up to 7% slower (K =
// 224-320, M = 256-2048; chip_ab.py --wide-fss, NVIDIA H100 80GB HBM3 at
// 700 W), where cold CD, every coordinate swept to the cap, takes it past
// K = 192; so the polish runs at L = 32 alone.
template <class Launch>
cudaError_t polish_width(int K, int lanes, Launch&& launch) {
  if (lanes != 0 && lanes != 32) return cudaErrorInvalidValue;
  return insider::by_wide_slots(K, [&](auto, auto c32) {
    return launch(insider::Group<decltype(c32)::value, 32>());
  });
}

int fss_streamed(const float* xtx, const float* xty, const float* beta0,
                 float* out, int* next, float* scratch, long scratch_len,
                 int M, int K, Solver<false> solver, int lanes,
                 cudaStream_t stream) {
  if (M < 1 || K < 1) return (int)cudaErrorInvalidValue;
  if (block_solve(K, lanes)) {                       // fss_wide.cuh
    if (lanes != 0 && lanes != insider::WIDE_THREADS)
      return (int)cudaErrorInvalidValue;
    return (int)launch_wide<false, false>(xtx, xty, beta0, out, next,
                                          scratch, scratch_len, M, K, solver,
                                          stream);
  }
  if (K <= insider::NARROW_MAX_K) {
    if (lanes != 0 && lanes != 32) return (int)cudaErrorInvalidValue;
    return (int)by_width(K, [&](auto c, auto amax) {
      constexpr int AMAX = decltype(amax)::value, C = decltype(c)::value;
      return launch<AMAX, C, 32, false>(xtx, xty, beta0, out, next, M, K,
                                        solver, stream);
    });
  }
  // the steps, then the polish on the grouped CD loop
  return (int)polish_width(K, lanes, [&](auto g) {
    using G = decltype(g);
    cudaError_t err = launch_steps<false>(xtx, xty, beta0, out, next, scratch,
                                          scratch_len, M, K, solver, stream);
    if (err != cudaSuccess || solver.polish_sweeps <= 0) return err;
    const Solver<true> polish{solver.l1, solver.l2, solver.tol,
                              solver.polish_sweeps};
    return launch<32, G::C, G::L, true>(xtx, xty, out, out, next, M, K,
                                        polish, stream, true);
  });
}

}  // namespace

// Floats of device scratch that insider_fss_streamed needs with this lanes
// argument: 0 at K <= 128; past it the block solve's where it runs
// (fss_wide.cuh), else the steps' (their polish takes none).
INSIDER_API long insider_fss_streamed_scratch(int M, int K, int lanes) {
  if (M < 1 || K <= insider::NARROW_MAX_K) return 0;
  if (block_solve(K, lanes)) return wide_scratch_floats<false, false>(M, K);
  return steps_scratch_floats<false>(M, K);
}

// Floats of device scratch that insider_cd_streamed needs with this lanes
// argument: the block solve's (fss_wide.cuh) where it runs, the grams'
// copies of an instance that reads them through L2, else 0.
INSIDER_API long insider_cd_streamed_scratch(int M, int K, int lanes) {
  if (M < 1 || K < 1) return 0;
  if (block_solve(K, lanes)) return wide_scratch_floats<false, true>(M, K);
  long n = 0;
  cd_instances(K, [&](auto... gs) {
    return insider::launch_width(lanes, [&](auto g) {
      using G = decltype(g);
      if constexpr (G::GLOBAL) n = global_scratch_floats<G::C, G::L>(M, K);
      return cudaSuccess;
    }, gs...);
  });
  return n;
}

// out (K, M) = the FSS + polish solution of every column.  xtx (K, K, M),
// symmetric grams, xty and beta0 (K, M): row-major f32; next: one int of
// device scratch (the column counter); scratch:
// insider_fss_streamed_scratch(M, K, lanes) floats of device scratch (none
// at K <= 128).  l1 = lam*alpha and l2 = lam*(1-alpha) as f32; tol: one
// f32 on the device (the polish's stop); K >= 1.  lanes: 0 for the
// instance the kernel runs at this K (header), else that of an instance
// covering K (insider_fss_streamed_widths: 32 at K <= 128; past it the
// polish's group width L, or 128 the block solve; cudaErrorInvalidValue
// where none does).
INSIDER_API int insider_fss_streamed(const float* xtx, const float* xty,
                                     const float* beta0, float* out,
                                     int* next, float* scratch,
                                     long scratch_len, float l1, float l2,
                                     const float* tol, int M, int K,
                                     int max_outer, int polish_sweeps,
                                     int lanes, cudaStream_t stream) {
  return fss_streamed(xtx, xty, beta0, out, next, scratch, scratch_len, M, K,
                      Solver<false>{l1, l2, tol, max_outer, polish_sweeps},
                      lanes, stream);
}

// The FSS instances of insider_fss_streamed that cover K, the one it runs
// first: *n of them (at most 3), their widths into widths[] (32 at K <=
// 128, one column a warp; past it the grouped solve's, named by its
// polish's group width L, and 128 the block solve, fss_wide.cuh), and where
// `columns` is given, the columns an SM of the current device holds at
// once into columns[] (the grouped solve's: in its steps, a block a
// column).
INSIDER_API int insider_fss_streamed_widths(int K, int* n, int* widths,
                                            int* columns) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  *n = 0;
  cudaError_t err = cudaSuccess;
  if (K <= insider::NARROW_MAX_K) {
    if (columns != nullptr)
      err = by_width(K, [&](auto c, auto amax) {
        constexpr int AMAX = decltype(amax)::value, C = decltype(c)::value;
        Residency res;
        const cudaError_t e = residency<streamed_kernel<AMAX, C, 32, false>>(
            32, sizeof(float) * slice_floats<C, 32, false>(K), res);
        columns[0] = res.per_sm;
        return e;
      });
    widths[(*n)++] = 32;
    return (int)err;
  }
  if (K <= insider::CD_GROUP_MAX_K) {      // the polish's group width
    int per_sm = 0;
    if ((err = steps_columns<false>(K, per_sm)) != cudaSuccess)
      return (int)err;
    if (columns != nullptr) columns[*n] = per_sm;
    widths[(*n)++] = 32;
  }
  int per_sm = 0;                          // the block solve
  if ((err = wide_columns<false, false>(K, per_sm)) != cudaSuccess)
    return (int)err;
  if (columns != nullptr) columns[*n] = per_sm;
  widths[(*n)++] = insider::WIDE_THREADS;
  return (int)cudaSuccess;
}

// out (K, M) = the cold strong-rule CD solution of every column, at most
// max_sweeps sweeps.  xtx (K, K, M), symmetric grams, xty and beta0 (K,
// M): row-major f32; next: one int of device scratch (the column counter);
// scratch: insider_cd_streamed_scratch(M, K, lanes) floats of device
// scratch.  lam, alpha as f32; tol: one f32 on the device; K >= 1.  lanes:
// the group width L, 0 for the instance the kernel runs at this K
// (header), else that of an instance covering K (insider_cd_streamed_widths;
// 128 past K = 128 the block solve; cudaErrorInvalidValue where none does).
INSIDER_API int insider_cd_streamed(const float* xtx, const float* xty,
                                    const float* beta0, float* out, int* next,
                                    float* scratch, long scratch_len,
                                    float lam, float alpha, const float* tol,
                                    int M, int K, int max_sweeps, int lanes,
                                    cudaStream_t stream) {
  if (M < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const Solver<true> solver{lam, alpha, tol, max_sweeps};
  if (block_solve(K, lanes)) {                       // fss_wide.cuh
    if (lanes != 0 && lanes != insider::WIDE_THREADS)
      return (int)cudaErrorInvalidValue;
    return (int)launch_wide<false, true>(xtx, xty, beta0, out, next, scratch,
                                         scratch_len, M, K, solver, stream);
  }
  return (int)cd_instances(K, [&](auto... gs) {
    return insider::launch_width(lanes, [&](auto g) {
      using G = decltype(g);
      if constexpr (G::GLOBAL)
        return launch_global<G::C, G::L>(xtx, xty, beta0, out, next, scratch,
                                         scratch_len, M, K, solver, stream);
      else
        return launch<32, G::C, G::L, true>(xtx, xty, beta0, out, next, M, K,
                                            solver, stream);
    }, gs...);
  });
}

// The CD instances of insider_cd_streamed that cover K, the one it runs
// first: *n of them (at most 3), their group widths L into widths[] (past
// K = 128: 32 on a gram in shared memory, 16 on grams read through L2, 128
// one column a block of 128 threads, fss_wide.cuh), and where `columns` is
// given, the columns an SM of the current device holds of each into
// columns[].
INSIDER_API int insider_cd_streamed_widths(int K, int* n, int* widths,
                                           int* columns) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  *n = 0;
  cudaError_t err = cudaSuccess;
  if (K <= insider::CD_GROUP_MAX_K)
    err = cd_instances(K, [&](auto... gs) {
      cudaError_t e = cudaSuccess;
      (
          [&](auto g) {
            using G = decltype(g);
            if (e != cudaSuccess) return;
            Residency res;
            if (columns != nullptr) {
              if constexpr (G::GLOBAL)
                e = residency<streamed_global_kernel<G::C, G::L>>(32, 0, res);
              else
                e = residency<streamed_kernel<32, G::C, G::L, true>>(
                    32, sizeof(float) * slice_floats<G::C, G::L, true>(K),
                    res);
              if (e == cudaSuccess) columns[*n] = res.per_sm * (32 / G::L);
            }
            widths[(*n)++] = G::L;
          }(gs),
          ...);
      return e;
    });
  if (err != cudaSuccess || K <= insider::NARROW_MAX_K) return (int)err;
  int per_sm = 0;                          // the block solve
  if ((err = wide_columns<false, true>(K, per_sm)) != cudaSuccess)
    return (int)err;
  if (columns != nullptr) columns[*n] = per_sm;
  widths[(*n)++] = insider::WIDE_THREADS;
  return (int)cudaSuccess;
}
