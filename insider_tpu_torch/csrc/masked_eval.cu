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
// at the flagship shape), plus N*M*K FMAs for the prediction.
//
// Design: one thread per column, a block of CW columns x RB rows.  The
// block stages its R rows and its F columns in shared memory, walks its rows
// with coalesced loads, and reduces its four f64 sums in shared memory in a
// fixed tree order.  Each block writes its four partials; a second pass adds
// them in block order (no atomics, so repeated runs agree bit for bit).  The
// ragged edges are guarded in the kernel, not padded.
#include "common.cuh"

namespace {

constexpr int CW = 128;   // columns per block, one per thread
constexpr int RB = 64;    // rows per block

size_t smem_bytes(int K) {
  return sizeof(float) * ((size_t)RB * K + (size_t)K * CW) +
         sizeof(double) * 4 * CW;
}

__global__ void __launch_bounds__(CW)
masked_eval_partial(const float* __restrict__ data,
                    const float* __restrict__ train,
                    const float* __restrict__ test,
                    const float* __restrict__ R, const float* __restrict__ F,
                    double* __restrict__ partial, int N, int M, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* red = reinterpret_cast<double*>(smem_raw);          // (4, CW)
  float* Rs = reinterpret_cast<float*>(red + 4 * CW);          // (RB, K)
  float* Fs = Rs + (size_t)RB * K;                             // (K, CW)

  const int tid = threadIdx.x;
  const int j = blockIdx.x * CW + tid;
  const int i0 = blockIdx.y * RB;
  const int rows = min(RB, N - i0);
  const bool valid = j < M;

  for (int e = tid; e < rows * K; e += CW) Rs[e] = R[(size_t)i0 * K + e];
  for (int k = 0; k < K; ++k) Fs[k * CW + tid] = valid ? F[(size_t)k * M + j] : 0.f;
  __syncthreads();

  double sse_tr = 0.0, sse_te = 0.0, n_tr = 0.0, n_te = 0.0;
  if (valid) {
    for (int i = 0; i < rows; ++i) {
      const size_t at = (size_t)(i0 + i) * M + j;
      float p = 0.f;
      for (int k = 0; k < K; ++k) p = fmaf(Rs[i * K + k], Fs[k * CW + tid], p);
      const float res = data[at] - p;
      const float tm = train[at], em = test[at];
      const double rt = (double)(res * tm), re = (double)(res * em);
      sse_tr += rt * rt;
      sse_te += re * re;
      n_tr += (double)tm;
      n_te += (double)em;
    }
  }
  red[0 * CW + tid] = sse_tr;
  red[1 * CW + tid] = sse_te;
  red[2 * CW + tid] = n_tr;
  red[3 * CW + tid] = n_te;
  __syncthreads();
  for (int h = CW / 2; h > 0; h >>= 1) {
    if (tid < h)
      for (int q = 0; q < 4; ++q) red[q * CW + tid] += red[q * CW + tid + h];
    __syncthreads();
  }
  if (tid < 4) {
    const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    partial[blk * 4 + tid] = red[tid * CW];
  }
}

dim3 grid_for(int N, int M) {
  return dim3(insider::ceil_div(M, CW), insider::ceil_div(N, RB));
}

}  // namespace

// Elements of f64 scratch that insider_masked_eval needs.
INSIDER_API long insider_masked_eval_scratch(int N, int M) {
  const dim3 g = grid_for(N, M);
  return 4L * g.x * g.y;
}

// out[0..3] = (train_sse, test_sse, n_train, n_test) as f64.  data, train,
// test (N, M), R (N, K), F (K, M): row-major f32.
INSIDER_API int insider_masked_eval(const float* data, const float* train,
                                    const float* test, const float* R,
                                    const float* F, double* out,
                                    double* scratch, long scratch_len, int N,
                                    int M, int K, cudaStream_t stream) {
  if (N < 1 || M < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_for(N, M);
  const long blocks = (long)grid.x * grid.y;
  if (scratch_len < 4 * blocks) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      masked_eval_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  masked_eval_partial<<<grid, CW, smem, stream>>>(data, train, test, R, F,
                                                  scratch, N, M, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // partial is (blocks, 4): output q sums elements q, q + 4, ... in order
  return (int)insider::launch_reduce<double>(scratch, out, (int)blocks, 4,
                                             stream);
}
