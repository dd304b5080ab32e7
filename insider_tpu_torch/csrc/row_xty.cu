// row_xty: the right-hand sides of one confounder's level ridge solves.
//
// Replaces insider_tpu/kernels/row_pallas.py:row_xty_pallas (body
// _xty_kernel) and its large-N variant row_xty_chunked_pallas
// (_xty_chunked_kernel); row_xty_auto picks between the two only because of
// the TPU's VMEM cap.  Both compute
//     out[l, k] = sum_j (D[l, j] - T[l, j]) * F[k, j],
//     T[l, j]   = sum_{i : code_i = l} mask[i, j] * (R_minus[i, :] . F[:, j]),
// with the prediction R_minus . F existing only on chip.  E is one-hot by
// construction (insider_tpu/train/als.py:371), so this kernel takes the int32
// level codes in its place: E^T x is a sum over the rows of each level.
//
// Cancellation: S = D - T is formed per column, from the COMPLETE T of that
// column, before the contraction with F (row_pallas.py:157-162).  The form
// D.F^T - T.F^T loses the small residual sums to cancellation.
//
// Bound on the H100: reading mask (N x M f32, 67 MB at the flagship shape)
// once per confounder, plus N*M*K FMAs for the prediction (0.4 GFMA).
// Design: one thread per column j, a block of `cw` columns.  The block
// streams R_minus and the codes through shared memory in row chunks (any N),
// reads mask rows coalesced, and keeps T (L x cw) in shared memory, each
// thread owning its own column, so no two threads touch one T entry.  The
// block then writes its (L, K) partial of the F contraction; a second pass
// adds the partials in fixed order (no atomics).
#include "common.cuh"

namespace {

constexpr int RCH = 64;                   // rows per shared-memory chunk
constexpr int SMEM_LIMIT = 200 * 1024;    // of the 227 KB a block may use

size_t smem_bytes(int L, int K, int cw) {
  return sizeof(float) * ((size_t)L * cw + (size_t)K * (cw + 1) +
                          (size_t)RCH * K) +
         sizeof(int) * RCH;
}

int columns_per_block(int L, int K) {
  for (int cw = 128; cw >= 32; cw /= 2)
    if (smem_bytes(L, K, cw) <= SMEM_LIMIT) return cw;
  return 0;
}

__global__ void row_xty_partial(const int* __restrict__ codes,
                                const float* __restrict__ R,
                                const float* __restrict__ mask,
                                const float* __restrict__ D,
                                const float* __restrict__ F,
                                float* __restrict__ partial, int N, int M,
                                int L, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cw = blockDim.x;
  const int fs = cw + 1;                  // padded stride of Fs
  float* T = reinterpret_cast<float*>(smem_raw);   // (L, cw)
  float* Fs = T + (size_t)L * cw;                  // (K, fs)
  float* Rs = Fs + (size_t)K * fs;                 // (RCH, K)
  int* cs = reinterpret_cast<int*>(Rs + RCH * K);  // (RCH,)

  const int tid = threadIdx.x;
  const int j = blockIdx.x * cw + tid;
  const bool valid = j < M;

  for (int l = 0; l < L; ++l) T[l * cw + tid] = 0.f;
  for (int k = 0; k < K; ++k) Fs[k * fs + tid] = valid ? F[(size_t)k * M + j] : 0.f;

  for (int r0 = 0; r0 < N; r0 += RCH) {
    const int rows = min(RCH, N - r0);
    __syncthreads();                      // previous chunk fully consumed
    for (int idx = tid; idx < rows * K; idx += cw)
      Rs[idx] = R[(size_t)r0 * K + idx];
    for (int idx = tid; idx < rows; idx += cw) cs[idx] = codes[r0 + idx];
    __syncthreads();
    if (valid) {
      for (int r = 0; r < rows; ++r) {
        const float m = mask[(size_t)(r0 + r) * M + j];
        float p = 0.f;
        for (int k = 0; k < K; ++k) p = fmaf(Rs[r * K + k], Fs[k * fs + tid], p);
        const int lv = cs[r];
        if (lv >= 0 && lv < L) T[lv * cw + tid] += m * p;   // codes out of range add nothing
      }
    }
  }

  // S = D - T per column, before the contraction (cancellation fix).
  for (int l = 0; l < L; ++l)
    T[l * cw + tid] = valid ? D[(size_t)l * M + j] - T[l * cw + tid] : 0.f;
  __syncthreads();

  float* out = partial + (size_t)blockIdx.x * L * K;
  for (int o = tid; o < L * K; o += cw) {
    const int l = o / K, k = o % K;
    float acc = 0.f;
    for (int c = 0; c < cw; ++c) acc = fmaf(T[l * cw + c], Fs[k * fs + c], acc);
    out[o] = acc;
  }
}

}  // namespace

// Elements of f32 scratch that insider_row_xty needs; 0 when L levels do
// not fit the kernel's shared memory.
INSIDER_API long insider_row_xty_scratch(int M, int L, int K) {
  int cw = columns_per_block(L, K);
  return cw ? (long)insider::ceil_div(M, cw) * L * K : 0;
}

// out (L, K) = (D - E^T (mask .* (R_minus F))) F^T.  codes (N,) int32 in
// [0, L); R_minus (N, K), mask (N, M), D (L, M), F (K, M): row-major f32.
INSIDER_API int insider_row_xty(const int* codes, const float* R,
                                const float* mask, const float* D,
                                const float* F, float* out, float* scratch,
                                long scratch_len, int N, int M, int L, int K,
                                cudaStream_t stream) {
  const int cw = columns_per_block(L, K);
  if (cw == 0 || N < 1 || M < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const int blocks = insider::ceil_div(M, cw);
  if (scratch_len < (long)blocks * L * K) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(L, K, cw);
  cudaError_t err = cudaFuncSetAttribute(
      row_xty_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  row_xty_partial<<<blocks, cw, smem, stream>>>(codes, R, mask, D, F, scratch,
                                                N, M, L, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)insider::launch_reduce<float>(scratch, out, blocks, L * K, stream);
}
