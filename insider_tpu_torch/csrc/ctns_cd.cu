// ctns_cd: the continuous covariate's K-space ridge coordinate descent.
//
// No Pallas counterpart: it replaces the XLA while_loop of
// insider_tpu/ops/continuous.py:101 _ctns_cd (src/optimize.cpp:102-126),
// which sweeps the K coordinates of one covariate's coefficient row w in
// order 0..K-1,
//     u    = b_k - s_k + w_k XtX_kk,   w_k' = u / (XtX_kk + lam),
//     s   += XtX[:, k] (w_k' - w_k),                       s = XtX w,
// and stops once a sweep's sum |delta w| (or, with loss_criterion, its sum
// of 0.5 (XtX_kk + lam) delta^2) is below tol, or after max_sweeps; at
// least one sweep runs.  Eager PyTorch would spend about five launches a
// coordinate and a host sync a sweep on it; here the whole loop is one
// launch that reads the stop test on the card.
//
// Bound on the H100: 2 K^2 flops a sweep, but each coordinate waits on the
// one before it, so the loop is a chain of K dependent steps a sweep (a
// shuffle and a few f32 operations each), far from both the memory and the
// arithmetic bound.  A simple design is right here: one warp in one block.
//
// Design: XtX (K <= 128) is staged in shared memory at an odd row stride,
// so that the 32 lanes reading column k fall in 32 banks.  Lane l owns the
// coordinates l, l + 32, l + 64, l + 96 of s, w, b and the diagonal, in
// registers.  At coordinate k every lane computes a candidate step from its
// own slot k / 32 (a compile-time index); the owner's delta is broadcast
// with __shfl_sync, every lane updates its slots of s, and every lane adds
// |delta| (or the decrement) to the sweep's criterion in the coordinate
// order.  Every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn, __fdiv_rn, never fused), and s starts from zero with the same
// rank-1 steps over w0, so the kernel follows its plain version
// (kernels/ctns.ctns_cd_plain) bit for bit, sweep counts included.
#include "common.cuh"

namespace {

constexpr int MAX_K = 128;
constexpr int SLOTS = MAX_K / 32;   // coordinates a lane holds

__device__ __forceinline__ float rank1(float s, float x, float d) {
  return __fadd_rn(s, __fmul_rn(x, d));
}

__global__ void __launch_bounds__(32)
ctns_cd_kernel(const float* __restrict__ XtX, const float* __restrict__ b,
               const float* __restrict__ w0, float* __restrict__ w_out,
               int* __restrict__ sweeps_out, float lam, float tol,
               int max_sweeps, int loss_criterion, int K, int stride) {
  extern __shared__ float X[];                  // (K, stride), row-major
  const int lane = threadIdx.x;
  for (int e = lane; e < K * K; e += 32)
    X[(e / K) * stride + e % K] = XtX[e];
  __syncwarp();

  float s[SLOTS], w[SLOTS], bb[SLOTS], dd[SLOTS], dl[SLOTS];
#pragma unroll
  for (int c = 0; c < SLOTS; ++c) {
    const int i = lane + 32 * c;
    const bool on = i < K;
    s[c] = 0.0f;
    w[c] = on ? w0[i] : 0.0f;
    bb[c] = on ? b[i] : 0.0f;
    dd[c] = on ? X[i * stride + i] : 0.0f;
    dl[c] = on ? __fadd_rn(dd[c], lam) : 1.0f;
  }
  // s = XtX w0, one rank-1 step a coordinate, in order
#pragma unroll
  for (int c = 0; c < SLOTS; ++c)
    for (int l = 0; l < 32; ++l) {
      const int k = 32 * c + l;
      if (k >= K) break;
      const float wk = __shfl_sync(0xffffffffu, w[c], l);
#pragma unroll
      for (int r = 0; r < SLOTS; ++r)
        if (lane + 32 * r < K)
          s[r] = rank1(s[r], X[(lane + 32 * r) * stride + k], wk);
    }

  int sweeps = 0;
  float crit;
  do {
    crit = 0.0f;
#pragma unroll
    for (int c = 0; c < SLOTS; ++c)
      for (int l = 0; l < 32; ++l) {
        const int k = 32 * c + l;
        if (k >= K) break;
        // this lane's candidate from its slot c; lane l's is the one used
        const float u = __fadd_rn(__fsub_rn(bb[c], s[c]),
                                  __fmul_rn(w[c], dd[c]));
        const float w_new = __fdiv_rn(u, dl[c]);
        const float delta = __shfl_sync(0xffffffffu, __fsub_rn(w_new, w[c]),
                                        l);
        const float dlk = __shfl_sync(0xffffffffu, dl[c], l);
        if (lane == l) w[c] = w_new;
#pragma unroll
        for (int r = 0; r < SLOTS; ++r)
          if (lane + 32 * r < K)
            s[r] = rank1(s[r], X[(lane + 32 * r) * stride + k], delta);
        crit = loss_criterion
                   ? __fadd_rn(crit, __fmul_rn(__fmul_rn(__fmul_rn(0.5f, dlk),
                                                         delta), delta))
                   : __fadd_rn(crit, fabsf(delta));
      }
    ++sweeps;
  } while (crit >= tol && sweeps < max_sweeps);

#pragma unroll
  for (int c = 0; c < SLOTS; ++c)
    if (lane + 32 * c < K) w_out[lane + 32 * c] = w[c];
  if (lane == 0) *sweeps_out = sweeps;
}

}  // namespace

// XtX (K, K), b (K), w0 (K) -> w (K) and the sweeps run (one int32), on
// `stream`.  1 <= K <= 128, max_sweeps >= 1.
INSIDER_API int insider_ctns_cd(const float* XtX, const float* b,
                                const float* w0, float* w, int* sweeps,
                                float lam, float tol, int max_sweeps,
                                int loss_criterion, int K, void* stream) {
  if (K < 1 || K > MAX_K || max_sweeps < 1) return (int)cudaErrorInvalidValue;
  const int stride = K | 1;                     // odd: conflict-free columns
  const size_t smem = sizeof(float) * (size_t)K * stride;
  if (smem > 48 * 1024) {                      // K > 109
    const cudaError_t err = cudaFuncSetAttribute(
        ctns_cd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ctns_cd_kernel<<<1, 32, smem, (cudaStream_t)stream>>>(
      XtX, b, w0, w, sweeps, lam, tol, max_sweeps, loss_criterion, K, stride);
  return (int)cudaGetLastError();
}
