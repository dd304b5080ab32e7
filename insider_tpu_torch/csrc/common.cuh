// Shared helpers of the port's CUDA kernels.
//
// Every entry point has a plain C interface (loaded with ctypes by
// insider_tpu_torch/kernels/_lib.py), launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() so that a refused launch
// is reported to the Python wrapper.  Cross-block sums are written as
// per-block partials and reduced by a second, fixed-order pass: no float
// atomics, so repeated runs agree bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define INSIDER_API extern "C" __attribute__((visibility("default")))

namespace insider {
// Internal linkage: each translation unit that includes this header gets
// its own copy of these helpers.
namespace {

inline int ceil_div(long a, long b) { return (int)((a + b - 1) / b); }

// The body of a fixed-order reduction over many partials, for a block of
// SPLIT_THREADS threads: out[i] = sum_{p < n_parts} part[p * n + i] for the
// `ob` outputs i = blockIdx.x * ob + o of the block (ob a power of two, at
// most 32).  Its SPLIT_THREADS / ob slices s each add the parts s, s + sl,
// s + 2 sl, ... in order (sl slices, so each thread reads n_parts / sl
// partials, neighbouring threads neighbouring outputs); thread o of slice 0
// then adds the slices' sums in slice order.  Wraps into a kernel of the
// caller's own name, so that a profile tells the reductions apart.
constexpr int SPLIT_THREADS = 1024;

template <typename T>
__device__ __forceinline__ void reduce_split(const T* __restrict__ part,
                                             T* __restrict__ out, int n_parts,
                                             int n, int ob) {
  __shared__ T red[SPLIT_THREADS];
  const int o = threadIdx.x % ob, s = threadIdx.x / ob;
  const int sl = SPLIT_THREADS / ob;
  const int i = blockIdx.x * ob + o;
  T acc = 0;
  if (i < n)
    for (int p = s; p < n_parts; p += sl) acc += part[(size_t)p * n + i];
  red[threadIdx.x] = acc;
  __syncthreads();
  if (s == 0 && i < n) {
    T t = 0;
    for (int q = 0; q < sl; ++q) t += red[q * ob + o];
    out[i] = t;
  }
}

// Outputs per block of reduce_split for n outputs: the least power of two
// >= n, at most 32.
inline int split_outputs(int n) {
  int ob = 1;
  while (ob < 32 && ob < n) ob *= 2;
  return ob;
}

// The predictions p = R[i, :] . F[:, j] of a thread's C columns, for the
// row kernels that form a residual on chip (row_xty.cu, masked_eval.cu).
// The thread's columns are j0 + c * STRIDE (c < C, neighbouring threads on
// neighbouring columns); their F lives in registers, f[c][k] for k < KP (KP
// the rank rounded up to a multiple of 8, zero above K and past M).  The
// row of R comes from shared memory, KP floats 16-byte aligned and zero
// above K, as broadcast 16-byte loads.  Such a load costs the shared memory
// as much as a warp's full 16 bytes a lane, so each one feeds 4 C FMAs:
// with C = 4 the FMAs, not the shared loads, bound the prediction.
template <int KP, int C, int STRIDE>
__device__ __forceinline__ void load_columns(const float* __restrict__ F,
                                             int M, int K, int j0,
                                             float (&f)[C][KP]) {
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < KP; ++k)
      f[c][k] = (j0 + c * STRIDE < M && k < K)
                    ? F[(size_t)k * M + j0 + c * STRIDE]
                    : 0.f;
}

template <int KP, int C>
__device__ __forceinline__ void dot_row(const float* rs,
                                        const float (&f)[C][KP],
                                        float (&p)[C]) {
  const float4* r4 = reinterpret_cast<const float4*>(rs);
#pragma unroll
  for (int c = 0; c < C; ++c) p[c] = 0.f;
#pragma unroll
  for (int q = 0; q < KP / 4; ++q) {
    const float4 a = r4[q];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      p[c] = fmaf(a.x, f[c][4 * q], p[c]);
      p[c] = fmaf(a.y, f[c][4 * q + 1], p[c]);
      p[c] = fmaf(a.z, f[c][4 * q + 2], p[c]);
      p[c] = fmaf(a.w, f[c][4 * q + 3], p[c]);
    }
  }
}

// Rows of R (row-major, K wide) staged into shared memory through
// registers, as rows of KP floats zero above K: a thread holds elements
// e = threadIdx.x + q * NT (q < PER) of a (ROWS, KP) chunk.  load() issues
// all of its loads before any is used (one round trip for the chunk, and a
// caller may issue it a chunk ahead of use); store() writes them out.
template <int KP, int ROWS, int NT>
struct RowStage {
  static constexpr int PER = (ROWS * KP + NT - 1) / NT;
  float v[PER];

  template <typename RowOf>
  __device__ __forceinline__ void load(const float* __restrict__ R, int K,
                                       int rows, RowOf row_of) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = threadIdx.x + q * NT, r = e / KP, k = e - r * KP;
      v[q] = (r < rows && k < K) ? R[(size_t)row_of(r) * K + k] : 0.f;
    }
  }

  __device__ __forceinline__ void store(float* rs, int rows) const {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = threadIdx.x + q * NT;
      if (e < rows * KP) rs[e] = v[q];
    }
  }
};

// Rank K in [1, 128] rounded up to the kernels' register width (multiple
// of 8); 0 outside that range.
inline int padded_rank(int K) { return (K < 1 || K > 128) ? 0 : 8 * ceil_div(K, 8); }

// Calls f with a mask operand as the typed pointer of its storage format
// (train/als.mask_storage): const uint8_t* where mask_is_u8, else
// const float*.  The one place an entry point's mask_is_u8 is read.
template <class Fn>
auto with_mask(const void* mask, int mask_is_u8, Fn&& f) {
  if (mask_is_u8) return f(static_cast<const uint8_t*>(mask));
  return f(static_cast<const float*>(mask));
}

}  // namespace
}  // namespace insider
