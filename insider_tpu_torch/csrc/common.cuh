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
// its own copy of these kernels.
namespace {

// out[i] = sum_{p < n_parts} part[p * n + i], summed in order p = 0, 1, ...
template <typename T>
__global__ void reduce_partials(const T* __restrict__ part, T* __restrict__ out,
                                int n_parts, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T acc = 0;
  for (int p = 0; p < n_parts; ++p) acc += part[(size_t)p * n + i];
  out[i] = acc;
}

template <typename T>
inline cudaError_t launch_reduce(const T* part, T* out, int n_parts, int n,
                                 cudaStream_t stream) {
  const int threads = 256;
  reduce_partials<T><<<(n + threads - 1) / threads, threads, 0, stream>>>(
      part, out, n_parts, n);
  return cudaGetLastError();
}

inline int ceil_div(long a, long b) { return (int)((a + b - 1) / b); }

}  // namespace
}  // namespace insider
