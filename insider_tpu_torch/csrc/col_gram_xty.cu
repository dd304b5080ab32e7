// col_gram_xty: the streamed column update's inputs, every gene's masked
// gram and right-hand side,
//     XtXt[k, l, j] = sum_i mask_ij R_ik R_il        (K, K, M)
//     Xty[k, j]     = sum_i R_ik (mask_ij data_ij)   (K, M)
//
// Replaces insider_tpu/kernels/gram_pallas.py:col_gram_xty_pallas (body
// _gram_xty_kernel).  The TPU kernel accumulates over a sequential grid of
// row chunks and rides the MXU with three exact bf16 planes of the
// outer-product table; here one block loops over the row chunks itself and
// accumulates the same sums in plain f32 FMA.
//
// Bound on the H100: f32 FMA, N K^2 M / 2 for the upper triangle (16.7 GFMA
// at N=300, K=50, M=44477); the gram written is K^2 M f32 (445 MB there,
// 2.9 GB at K=128).
//
// Design: the gram is symmetric and R_ik R_il == R_il R_ik exactly, so only
// the upper triangle of 4 x 4 pair tiles (k-block <= l-block) is computed,
// and each entry is written to both (k, l) and (l, k).  A warp owns one pair
// tile for 128 consecutive columns, 4 per lane: 64 accumulators per lane,
// each row costing 16 products and 64 FMAs.  Row chunks of R, mask and data
// are staged through shared memory (mask as float4 per lane, R as warp
// broadcasts; 48 KB at K=128); rows past N and columns past M are staged
// as zeros by a
// select, never multiplied in (NaN * 0 is NaN, gram_pallas.py:82-91).  The
// warps of a diagonal tile also accumulate Xty for their 4 coordinates.
// The grid runs tile-groups fastest, so the blocks that share a column
// block's mask and data run together and read them from L2.
#include "common.cuh"

namespace {

using insider::ceil_div;

constexpr int KMAX = 128;
constexpr int TP = 4;            // pair tile: TP x TP (k, l) entries
constexpr int TJ = 4;            // columns per lane
constexpr int WARPS = 8;         // one pair tile per warp
constexpr int CB = 32 * TJ;      // columns per block
constexpr int RCH = 32;          // rows per staged chunk

__device__ __forceinline__ float to_float(float m) { return m; }
__device__ __forceinline__ float to_float(uint8_t m) {
  return static_cast<float>(m);
}

template <typename MaskT>
__global__ void __launch_bounds__(WARPS * 32)
col_gram_xty_kernel(const MaskT* __restrict__ mask,
                    const float* __restrict__ data,
                    const float* __restrict__ R, float* __restrict__ gram,
                    float* __restrict__ xty, int N, int M, int K) {
  const int nb = (K + TP - 1) / TP;
  const int KS = nb * TP;                  // staged coordinates per row
  extern __shared__ __align__(16) float smem[];
  float(*Ms)[CB] = reinterpret_cast<float(*)[CB]>(smem);   // (RCH, CB)
  float(*Xs)[CB] = Ms + RCH;                               // (RCH, CB)
  float* Rs = smem + 2 * RCH * CB;         // (RCH, KS), zero beyond K

  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int j0 = blockIdx.y * CB;
  const int n_tiles = nb * (nb + 1) / 2;

  // pair tile of this warp: (kb, lb), kb <= lb, in row-major order
  int tile = blockIdx.x * WARPS + w;
  const bool live = tile < n_tiles;        // warp-uniform
  int kb = 0;
  if (live)
    while (tile >= nb - kb) {
      tile -= nb - kb;
      ++kb;
    }
  const int lb = kb + tile;
  const bool diag = kb == lb;

  float acc[TP][TP][TJ];
  float bx[TP][TJ];
#pragma unroll
  for (int a = 0; a < TP; ++a)
#pragma unroll
    for (int t = 0; t < TJ; ++t) {
      bx[a][t] = 0.f;
#pragma unroll
      for (int b = 0; b < TP; ++b) acc[a][b][t] = 0.f;
    }

  for (int i0 = 0; i0 < N; i0 += RCH) {
    const int rows = min(RCH, N - i0);
    __syncthreads();                       // previous chunk consumed
    for (int e = tid; e < RCH * KS; e += WARPS * 32) {
      const int i = e / KS, k = e % KS;
      Rs[e] = (i < rows && k < K) ? R[(size_t)(i0 + i) * K + k] : 0.f;
    }
    for (int e = tid; e < RCH * CB; e += WARPS * 32) {
      const int i = e / CB, jj = e % CB, j = j0 + jj;
      const bool in = i < rows && j < M;
      const size_t off = (size_t)(i0 + i) * M + j;
      Ms[i][jj] = in ? to_float(mask[off]) : 0.f;
      Xs[i][jj] = in ? data[off] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < rows; ++i) {
      const float4 m4 = *reinterpret_cast<const float4*>(&Ms[i][TJ * lane]);
      const float m[TJ] = {m4.x, m4.y, m4.z, m4.w};
      float rk[TP], rl[TP];
#pragma unroll
      for (int a = 0; a < TP; ++a) {
        rk[a] = Rs[i * KS + kb * TP + a];
        rl[a] = Rs[i * KS + lb * TP + a];
      }
#pragma unroll
      for (int a = 0; a < TP; ++a)
#pragma unroll
        for (int b = 0; b < TP; ++b) {
          const float p = rk[a] * rl[b];   // the outer-product table
#pragma unroll
          for (int t = 0; t < TJ; ++t)
            acc[a][b][t] = fmaf(m[t], p, acc[a][b][t]);
        }
      if (diag) {
        const float4 x4 =
            *reinterpret_cast<const float4*>(&Xs[i][TJ * lane]);
        const float wx[TJ] = {m[0] * x4.x, m[1] * x4.y, m[2] * x4.z,
                              m[3] * x4.w};
#pragma unroll
        for (int a = 0; a < TP; ++a)
#pragma unroll
          for (int t = 0; t < TJ; ++t)
            bx[a][t] = fmaf(rk[a], wx[t], bx[a][t]);
      }
    }
  }
  if (!live) return;

#pragma unroll
  for (int a = 0; a < TP; ++a) {
    const int k = kb * TP + a;
#pragma unroll
    for (int b = 0; b < TP; ++b) {
      const int l = lb * TP + b;
      if (k >= K || l >= K) continue;
#pragma unroll
      for (int t = 0; t < TJ; ++t) {
        const int j = j0 + TJ * lane + t;
        if (j >= M) continue;
        gram[((size_t)k * K + l) * M + j] = acc[a][b][t];
        if (!diag) gram[((size_t)l * K + k) * M + j] = acc[a][b][t];
      }
    }
    if (diag && k < K)
#pragma unroll
      for (int t = 0; t < TJ; ++t) {
        const int j = j0 + TJ * lane + t;
        if (j < M) xty[(size_t)k * M + j] = bx[a][t];
      }
  }
}

template <typename MaskT>
cudaError_t launch(const void* mask, const float* data, const float* R,
                   float* gram, float* xty, int N, int M, int K,
                   cudaStream_t stream) {
  const int nb = (K + TP - 1) / TP;
  const size_t smem = sizeof(float) * RCH * (2 * CB + nb * TP);
  cudaError_t err = cudaFuncSetAttribute(
      col_gram_xty_kernel<MaskT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(nb * (nb + 1) / 2, WARPS), ceil_div(M, CB));
  col_gram_xty_kernel<MaskT><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const MaskT*>(mask), data, R, gram, xty, N, M, K);
  return cudaGetLastError();
}

}  // namespace

// gram (K, K, M) and xty (K, M) of the masked column update.  mask (N, M)
// f32 or uint8 (mask_is_u8 != 0) with 0/1 entries, data (N, M) and R (N, K)
// f32, all row-major; 1 <= K <= 128.
INSIDER_API int insider_col_gram_xty(const void* mask, int mask_is_u8,
                                     const float* data, const float* R,
                                     float* gram, float* xty, int N, int M,
                                     int K, cudaStream_t stream) {
  if (N < 1 || M < 1 || K < 1 || K > KMAX) return (int)cudaErrorInvalidValue;
  if (mask_is_u8)
    return (int)launch<uint8_t>(mask, data, R, gram, xty, N, M, K, stream);
  return (int)launch<float>(mask, data, R, gram, xty, N, M, K, stream);
}
