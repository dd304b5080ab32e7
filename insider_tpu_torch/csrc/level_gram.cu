// level_gram: per-level masked K x K grams of the row update.
//
// Replaces insider_tpu/kernels/row_pallas.py:level_gram_pallas (body
// _gram_kernel), which computes
//     out[l, k1*K + k2] = sum_j Mw[l, j] * (F[k1, j] * F[k2, j])
// for every level l of every confounder (Mw: (sum L, M) per-level mask
// counts, F: (K, M)), building the F outer-product table per column block
// so the (K^2, M) table never exists in device memory.
//
// Bound on the H100: f32 FMA throughput.  At the flagship shape (sum L = 133,
// K = 24, M = 44477) the sum is 3.4 GFMA over 24 MB of Mw and 4 MB of F, far
// above the card's f32 ridge point; the counts in Mw are not exact in bf16/TF32,
// so the tensor cores' low-precision paths are out.
//
// Design: a tiled f32 GEMM C = Mw . PF^T with PF built in shared memory from
// F tile by tile (the TPU kernel's per-block table).  The reduction over M is
// split across gridDim.z column ranges so the card has enough blocks; each
// split writes its own partial (L, K^2) and a second pass adds the partials
// in fixed order (the TPU kernel's sequential `out +=` has no parallel
// counterpart without atomics, and atomics would break run-to-run equality).
#include "common.cuh"

namespace {

constexpr int TL = 64;        // levels per block tile
constexpr int TQ = 64;        // (k1, k2) pairs per block tile
constexpr int TJ = 32;        // columns per shared-memory step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(THREADS)
level_gram_partial(const float* __restrict__ mw, const float* __restrict__ F,
                   float* __restrict__ partial, int L, int M, int K,
                   int chunk) {
  __shared__ float As[TJ][TL + 1];   // Mw tile, column-major in j
  __shared__ float Bs[TJ][TQ + 1];   // outer-product table tile

  const int KK = K * K;
  const int q0 = blockIdx.x * TQ;
  const int l0 = blockIdx.y * TL;
  const int j_begin = blockIdx.z * chunk;
  const int j_end = min(M, j_begin + chunk);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int j0 = j_begin; j0 < j_end; j0 += TJ) {
    // Each thread loads 8 elements of each tile; consecutive threads walk
    // consecutive columns j, so the global loads are coalesced.
#pragma unroll
    for (int e = 0; e < (TL * TJ) / THREADS; ++e) {
      int idx = threadIdx.x + e * THREADS;
      int ll = idx / TJ, jj = idx % TJ;
      int l = l0 + ll, j = j0 + jj;
      As[jj][ll] = (l < L && j < j_end) ? mw[(size_t)l * M + j] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < (TQ * TJ) / THREADS; ++e) {
      int idx = threadIdx.x + e * THREADS;
      int qq = idx / TJ, jj = idx % TJ;
      int q = q0 + qq, j = j0 + jj;
      float v = 0.f;
      if (q < KK && j < j_end) {
        int k1 = q / K, k2 = q % K;
        v = F[(size_t)k1 * M + j] * F[(size_t)k2 * M + j];
      }
      Bs[jj][qq] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int jj = 0; jj < TJ; ++jj) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[jj][ty + 16 * i];
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] = Bs[jj][tx + 16 * i];
#pragma unroll
      for (int ia = 0; ia < 4; ++ia)
#pragma unroll
        for (int ib = 0; ib < 4; ++ib)
          acc[ia][ib] = fmaf(a[ia], b[ib], acc[ia][ib]);
    }
    __syncthreads();
  }

  float* out = partial + (size_t)blockIdx.z * L * KK;
#pragma unroll
  for (int ia = 0; ia < 4; ++ia) {
    int l = l0 + ty + 16 * ia;
    if (l >= L) continue;
#pragma unroll
    for (int ib = 0; ib < 4; ++ib) {
      int q = q0 + tx + 16 * ib;
      if (q < KK) out[(size_t)l * KK + q] = acc[ia][ib];
    }
  }
}

int column_splits(int M) {
  // Enough blocks to fill the card at the flagship shape (27 output tiles x
  // 64 splits), but no split narrower than 512 columns.
  int s = insider::ceil_div(M, 512);
  return s < 1 ? 1 : (s > 64 ? 64 : s);
}

}  // namespace

// Elements of f32 scratch that insider_level_gram needs.
INSIDER_API long insider_level_gram_scratch(int L, int M, int K) {
  return (long)column_splits(M) * L * K * K;
}

// out (L, K*K) = Mw (L, M) . outer_table(F (K, M))^T, all row-major f32.
INSIDER_API int insider_level_gram(const float* mw, const float* F, float* out,
                                   float* scratch, long scratch_len, int L,
                                   int M, int K, cudaStream_t stream) {
  const int splits = column_splits(M);
  if (scratch_len < (long)splits * L * K * K || L < 1 || M < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  // chunk: a multiple of TJ so every split but the last is whole
  int chunk = insider::ceil_div(insider::ceil_div(M, splits), TJ) * TJ;
  dim3 grid(insider::ceil_div(K * K, TQ), insider::ceil_div(L, TL),
            insider::ceil_div(M, chunk));
  level_gram_partial<<<grid, THREADS, 0, stream>>>(mw, F, scratch, L, M, K,
                                                   chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)insider::launch_reduce<float>(scratch, out, (int)grid.z,
                                            L * K * K, stream);
}
