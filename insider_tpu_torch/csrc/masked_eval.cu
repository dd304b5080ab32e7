// masked_eval: train / test sums of squared residuals and element counts.
//
// Replaces insider_tpu/kernels/eval_pallas.py:masked_eval_pallas (body
// _eval_kernel), which computes, with the residual data - R F existing only
// on chip,
//     train_sse = sum_ij (train_ij * res_ij)^2,  n_train = sum_ij train_ij,
//     test_sse  = sum_ij (test_ij * res_ij)^2,   n_test  = sum_ij test_ij.
// The TPU kernel accumulates double-single (hi, lo) f32 planes because the
// TPU has no f64.  Here the residual is formed in f32 and the squares and
// counts accumulate in f64: the square of an f32 value is exact in f64, and
// the counts stay exact far past the 2^24 at which the TPU kernel's f32
// counts round (eval_pallas.py:194-195).
//
// Bound on the H100: reading data and the two masks, 3 x N x M f32 (200 MB
// at the flagship shape, 0.060 ms at 3.35 TB/s; with uint8 masks, 1.5 x N
// x M x 4 bytes); the prediction's N*M*K
// FMAs (0.012 ms at 67 TFLOP/s f32) come second.  The first version read
// both R and F from shared memory for every FMA, which bound it on shared
// loads, not on HBM.
//
// Design: a block of CT threads x C columns a thread, x RB rows.  The
// thread's columns of F live in registers, the block's rows of R are staged
// in shared memory and read as broadcast 16-byte loads (each feeding 4 C
// FMAs, common.cuh:dot_row), and two register sets of U rows' three loads
// go in turn, one set in flight while the other computes.  The squares
// accumulate in f64; the counts of a batch (U C mask values) are added in
// f32, exact for 0/1 masks, and then once into their f64 sums.  The four
// f64 sums of a block are added by a fixed xor-shuffle tree in each warp
// and then across the warps in order; each block writes its four partials,
// and a second pass adds them in a fixed order (no atomics, so repeated
// runs agree bit for bit).  Global loads are scalar and coalesced (rows
// start at any element); the ragged edges are guarded, not padded.  The
// masks are f32 or uint8 (a template parameter, the memory-lean storage):
// each value is widened to f32 as it is loaded, exactly, so both give the
// same bits.
// What bounds it now (PERF.md, PR 5): the column tiles x row blocks access
// pattern alone reads the three arrays below the card's rate, and the
// arithmetic alone (FMAs, the shared loads of R, the f32 -> f64
// conversions of the squares) takes about as long as the reads.
// Above K = 128 (masked_eval_wide) F no longer fits a thread's registers.
// The first wide version (one column a thread, K in zero-padded tiles of
// 128, each tile's sums added into a shared (rows, columns) tile, then the
// three arrays read with no load in flight, 80 blocks at 300 x 2048) was
// bound by its shared loads, a broadcast 16-byte load of R for 4 FMAs.  Now
// the prediction is the register tile of predict_tile.cuh, shared with
// row_xty (8 x 8 elements a lane, 64 x 128 a block; 16 x 32 where those
// would leave SMs idle), K summed whole in k-chunks of 16, each chunk from
// zero, and the residuals, squares and counts come straight from its
// accumulators.  What bounds it now (PERF.md §6, row 4): the prediction's
// FMAs at two blocks an SM, then the three arrays' reads after the k-loop
// (their 64 values a thread cannot stay in registers beside the 2 x 64
// accumulators; the split not measured).
#include "common.cuh"
#include "predict_tile.cuh"

namespace {

using insider::ceil_div;

constexpr int CT = 128;   // threads per block
constexpr int RB = 64;    // rows per block
constexpr int U = 4;      // rows a batch

// Columns a thread at padded rank KP (a block's tile: CT of them a
// thread); 3 U C loads a thread a batch, two batches in flight.
__host__ __device__ constexpr int cols_per_thread(int KP) {
  return KP <= 64 ? 2 : 1;
}

// The block's four f64 sums (one set a thread) added by a fixed
// xor-shuffle tree in each of its W warps, then across the warps in order,
// into the block's partial.
template <int W = CT / 32>
__device__ __forceinline__ void write_partial(double (&s)[4],
                                              double (&red)[W][4],
                                              double* __restrict__ partial) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    for (int off = 16; off > 0; off >>= 1)
      s[q] += __shfl_xor_sync(0xffffffffu, s[q], off);
  if (tid % 32 == 0)
#pragma unroll
    for (int q = 0; q < 4; ++q) red[tid / 32][q] = s[q];
  __syncthreads();
  if (tid < 4) {
    double t = 0.0;
    for (int w = 0; w < W; ++w) t += red[w][tid];
    partial[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 4 + tid] = t;
  }
}

template <int KP, typename MaskT>
__global__ void __launch_bounds__(CT)
masked_eval_partial(const float* __restrict__ data,
                    const MaskT* __restrict__ train,
                    const MaskT* __restrict__ test,
                    const float* __restrict__ R, const float* __restrict__ F,
                    double* __restrict__ partial, int N, int M, int K) {
  constexpr int C = cols_per_thread(KP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Rs = reinterpret_cast<float*>(smem_raw);             // (RB, KP)
  __shared__ double red[CT / 32][4];

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * (CT * C) + tid;   // columns j0 + c * CT
  const int i0 = blockIdx.y * RB;
  const int rows = min(RB, N - i0);
  int jc[C];                                  // in-bounds loads; results unused
  bool valid[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    valid[c] = j0 + c * CT < M;
    jc[c] = min(j0 + c * CT, M - 1);
  }
  float f[C][KP];
  insider::load_columns<KP, C, CT>(F, M, K, j0, f);
  for (int r0 = 0; r0 < rows; r0 += RB / 2) {
    insider::RowStage<KP, RB / 2, CT> stage;
    stage.load(R, K, rows - r0, [&](int r) { return i0 + r0 + r; });
    stage.store(Rs + r0 * KP, rows - r0);
  }
  __syncthreads();

  // two register sets of U rows' loads in turn: one set's loads are in
  // flight while the other set's rows compute
  double s[4] = {0.0, 0.0, 0.0, 0.0};     // train_sse, test_sse, n_tr, n_te
  float x0[U][C], a0[U][C], b0[U][C], x1[U][C], a1[U][C], b1[U][C];
  auto fetch = [&](int u0, float (&xs)[U][C], float (&as)[U][C],
                   float (&bs)[U][C]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t row = (size_t)(i0 + min(u0 + u, rows - 1)) * M;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        xs[u][c] = data[row + jc[c]];
        as[u][c] = static_cast<float>(train[row + jc[c]]);
        bs[u][c] = static_cast<float>(test[row + jc[c]]);
      }
    }
  };
  // The counts of a batch (at most U C mask values, integers below 2^24
  // for 0/1 masks, so exact in f32) are added in f32 and then once into
  // their f64 sums: one conversion a batch instead of one an element.
  auto consume = [&](int u0, const float (&xs)[U][C], const float (&as)[U][C],
                     const float (&bs)[U][C]) {
    float p[U][C];
#pragma unroll
    for (int u = 0; u < U; ++u)
      insider::dot_row<KP, C>(Rs + min(u0 + u, rows - 1) * KP, f, p[u]);
    float n_tr = 0.f, n_te = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (valid[c] && u0 + u < rows) {
          const float res = xs[u][c] - p[u][c];
          const double rt = (double)(res * as[u][c]);
          const double re = (double)(res * bs[u][c]);
          s[0] += rt * rt;
          s[1] += re * re;
          n_tr += as[u][c];
          n_te += bs[u][c];
        }
      }
    s[2] += (double)n_tr;
    s[3] += (double)n_te;
  };
  fetch(0, x0, a0, b0);
  for (int u0 = 0; u0 < rows; u0 += 2 * U) {
    fetch(u0 + U, x1, a1, b1);
    consume(u0, x0, a0, b0);
    fetch(u0 + 2 * U, x0, a0, b0);
    consume(u0 + U, x1, a1, b1);
  }
  write_partial(s, red, partial);
}

// K > 128: the shared prediction tile (predict_tile.cuh), a block a row
// tile x column tile.  After the k-loop each thread reads its elements'
// data and masks (clamped to the arrays, so that every load issues at
// once) and forms the residuals, squares and counts straight from the
// accumulators: no shared round trip of the prediction.
constexpr int KT = 128;

template <class Tile, typename MaskT>
__global__ void __launch_bounds__(Tile::NT, Tile::MIN_BLOCKS)
masked_eval_wide(const float* __restrict__ data,
                 const MaskT* __restrict__ train,
                 const MaskT* __restrict__ test, const float* __restrict__ R,
                 const float* __restrict__ F, double* __restrict__ partial,
                 int N, int M, int K) {
  extern __shared__ __align__(16) float smem_f[];
  __shared__ double red[Tile::WARPS][4];
  const int j0 = blockIdx.x * Tile::TC, i0 = blockIdx.y * Tile::TR;
  const int rows = min(Tile::TR, N - i0);
  const Tile tile(smem_f);
  float acc[Tile::LR][Tile::LC];
  tile.predict(R, F, K, M, j0, rows, [&](int r) { return i0 + r; }, acc);
  // the thread's counts (at most LR LC mask values, exact in f32 for 0/1
  // masks) added in f32, then once into their f64 sums
  double s[4] = {0.0, 0.0, 0.0, 0.0};     // train_sse, test_sse, n_tr, n_te
  float n_tr = 0.f, n_te = 0.f;
#pragma unroll
  for (int i = 0; i < Tile::LR; ++i) {
    const int r = Tile::row(i);
    const size_t at = (size_t)(i0 + min(r, rows - 1)) * M;
#pragma unroll
    for (int q = 0; q < Tile::LC; ++q) {
      const int j = j0 + Tile::col(q);
      const size_t e = at + min(j, M - 1);
      const float x = data[e];
      const float a = static_cast<float>(train[e]);
      const float b = static_cast<float>(test[e]);
      if (r < rows && j < M) {
        const float res = x - acc[i][q];
        const double rt = (double)(res * a);
        const double re = (double)(res * b);
        s[0] += rt * rt;
        s[1] += re * re;
        n_tr += a;
        n_te += b;
      }
    }
  }
  s[2] = (double)n_tr;
  s[3] = (double)n_te;
  write_partial<Tile::WARPS>(s, red, partial);
}

__global__ void __launch_bounds__(insider::SPLIT_THREADS)
masked_eval_reduce(const double* __restrict__ part, double* __restrict__ out,
                   int n_parts) {
  insider::reduce_split<double>(part, out, n_parts, 4, 4);
}

// The grid of one launch: column tiles x row blocks (past K = 128 the
// prediction tile's).
dim3 grid_for(int N, int M, int K) {
  if (K > KT)
    return insider::with_tile(N, M, [&](auto tile) {
      using Tile = typename decltype(tile)::type;
      return dim3(ceil_div(M, Tile::TC), ceil_div(N, Tile::TR));
    });
  const int C = cols_per_thread(insider::padded_rank(K));
  return dim3(ceil_div(M, CT * C), ceil_div(N, RB));
}

template <class Tile, typename MaskT>
cudaError_t launch_wide(const float* data, const MaskT* train,
                        const MaskT* test, const float* R, const float* F,
                        double* scratch, int N, int M, int K,
                        cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * Tile::floats;
  auto kernel = masked_eval_wide<Tile, MaskT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid_for(N, M, K), Tile::NT, smem, stream>>>(data, train, test, R,
                                                        F, scratch, N, M, K);
  return cudaGetLastError();
}

template <int KP, typename MaskT>
cudaError_t launch_as(const float* data, const MaskT* train,
                      const MaskT* test, const float* R, const float* F,
                      double* scratch, int N, int M, int K,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * RB * KP;
  cudaError_t err = cudaFuncSetAttribute(
      masked_eval_partial<KP, MaskT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  masked_eval_partial<KP, MaskT><<<grid_for(N, M, K), CT, smem, stream>>>(
      data, train, test, R, F, scratch, N, M, K);
  return cudaGetLastError();
}

template <int KP>
cudaError_t launch(const float* data, const void* train, const void* test,
                   int mask_is_u8, const float* R, const float* F,
                   double* scratch, int N, int M, int K,
                   cudaStream_t stream) {
  return insider::with_mask(train, mask_is_u8, [&](auto tr) {
    return launch_as<KP>(data, tr, static_cast<decltype(tr)>(test), R, F,
                         scratch, N, M, K, stream);
  });
}

}  // namespace

// Elements of f64 scratch that insider_masked_eval needs.
INSIDER_API long insider_masked_eval_scratch(int N, int M, int K) {
  const dim3 g = grid_for(N, M, K);
  return 4L * g.x * g.y;
}

// Blocks of insider_masked_eval's main kernel.
INSIDER_API long insider_masked_eval_blocks(int N, int M, int K) {
  const dim3 g = grid_for(N, M, K);
  return (long)g.x * g.y;
}

// out[0..3] = (train_sse, test_sse, n_train, n_test) as f64.  data (N, M),
// R (N, K), F (K, M): row-major f32; train, test (N, M) row-major, both f32
// or both uint8 (mask_is_u8 != 0).  K >= 1.
INSIDER_API int insider_masked_eval(const float* data, const void* train,
                                    const void* test, int mask_is_u8,
                                    const float* R,
                                    const float* F, double* out,
                                    double* scratch, long scratch_len, int N,
                                    int M, int K, cudaStream_t stream) {
  const int KP = K > KT ? KT : insider::padded_rank(K);
  if (KP == 0 || N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_for(N, M, K);
  const long blocks = (long)grid.x * grid.y;
  if (scratch_len < 4 * blocks) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (K > KT) {
    err = insider::with_mask(train, mask_is_u8, [&](auto tr) {
      return insider::with_tile(N, M, [&](auto tile) {
        return launch_wide<typename decltype(tile)::type>(
            data, tr, static_cast<decltype(tr)>(test), R, F, scratch, N, M,
            K, stream);
      });
    });
  } else switch (KP) {
#define INSIDER_EVAL_CASE(P)                                                \
  case P:                                                                   \
    err = launch<P>(data, train, test, mask_is_u8, R, F, scratch, N, M, K, \
                    stream);                                                \
    break;
    INSIDER_EVAL_CASE(8) INSIDER_EVAL_CASE(16) INSIDER_EVAL_CASE(24)
    INSIDER_EVAL_CASE(32) INSIDER_EVAL_CASE(40) INSIDER_EVAL_CASE(48)
    INSIDER_EVAL_CASE(56) INSIDER_EVAL_CASE(64) INSIDER_EVAL_CASE(72)
    INSIDER_EVAL_CASE(80) INSIDER_EVAL_CASE(88) INSIDER_EVAL_CASE(96)
    INSIDER_EVAL_CASE(104) INSIDER_EVAL_CASE(112) INSIDER_EVAL_CASE(120)
    INSIDER_EVAL_CASE(128)
#undef INSIDER_EVAL_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  // partial is (blocks, 4): output q sums elements q, q + 4, ... in order
  masked_eval_reduce<<<1, insider::SPLIT_THREADS, 0, stream>>>(
      scratch, out, (int)blocks);
  return (int)cudaGetLastError();
}
