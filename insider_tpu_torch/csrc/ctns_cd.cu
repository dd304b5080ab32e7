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
// shuffle, or a barrier, and a few f32 operations each), far from both the
// memory and the arithmetic bound.  A simple design is right here: one
// block, one warp up to K = 128 and 128 threads above.
//
// Design at K <= 128: XtX is staged in shared memory at an odd row stride,
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
//
// Design at K > 128, where four register slots a lane no longer reach
// (ctns_cd_block): one block of WIDE threads runs the same sweep.  XtX
// lies in shared memory at the odd stride where it fits beside the vectors
// (K (K | 1) 4 bytes within the card's opt-in limit: K <= 235 on the
// H100), else it is read in place from device memory (row i of thread i's
// coordinate, walked along k, stays in L1).  w, s, b, the diagonal and
// XtX_kk + lam lie in shared memory; thread t owns coordinates t, t +
// WIDE, ...  At coordinate k every thread computes k's step from the
// shared values (the same operations on the same bits, so the same
// delta), updates s for its own coordinates but k, and adds the criterion
// term in coordinate order; k's own s term and its new w are written at
// step k + 1 (every thread must read them as they were at step k), so one
// barrier a coordinate.  Every operation is rounded on its own as at K <=
// 128, and each s_i takes its terms in coordinate order, so the kernel is
// its plain version bit for bit, sweep counts included; the stop test,
// decided alike by every thread, runs on the card.
#include "common.cuh"

namespace {

constexpr int NARROW_K = 128;
constexpr int SLOTS = NARROW_K / 32;   // coordinates a lane holds
constexpr int WIDE = 128;              // threads of the K > 128 block

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

// XtX (K, K) read in place (SMEM false) or staged at row stride `stride`
// (SMEM), b, w0 (K) -> w (K) and the sweeps run, for K > 128.  Shared
// memory: w, s, b, the diagonal and the diagonal + lam, each padded to 4
// floats, then the staged XtX.
template <bool SMEM>
__global__ void __launch_bounds__(WIDE)
ctns_cd_block(const float* __restrict__ XtX, const float* __restrict__ b,
              const float* __restrict__ w0, float* __restrict__ w_out,
              int* __restrict__ sweeps_out, float lam, float tol,
              int max_sweeps, int loss_criterion, int K, int stride) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, P = (K + 3) & ~3;
  float *w = sm, *s = sm + P, *bb = sm + 2 * P, *dd = sm + 3 * P,
        *dl = sm + 4 * P;
  float* Xs = sm + 5 * P;
  if (SMEM)
    for (int e = tid; e < K * K; e += WIDE)
      Xs[(e / K) * stride + e % K] = XtX[e];
  const float* X = SMEM ? Xs : XtX;
  const int XS = SMEM ? stride : K;
  for (int i = tid; i < K; i += WIDE) {
    w[i] = w0[i];
    bb[i] = b[i];
    s[i] = 0.0f;
  }
  __syncthreads();
  for (int i = tid; i < K; i += WIDE) {
    dd[i] = X[i * XS + i];
    dl[i] = __fadd_rn(dd[i], lam);
    // s = XtX w0, one rank-1 step a coordinate, in order
    float si = 0.0f;
    for (int k = 0; k < K; ++k) si = rank1(si, X[i * XS + k], w[k]);
    s[i] = si;
  }
  __syncthreads();

  int sweeps = 0;
  float crit;
  do {
    crit = 0.0f;
    int prev = -1;                  // the last coordinate, its terms pending
    float prev_delta = 0.0f, prev_w = 0.0f;
    for (int k = 0; k < K; ++k) {
      // every thread computes k's step from the shared values
      const float wk = w[k], dlk = dl[k];
      const float u = __fadd_rn(__fsub_rn(bb[k], s[k]), __fmul_rn(wk, dd[k]));
      const float w_new = __fdiv_rn(u, dlk);
      const float delta = __fsub_rn(w_new, wk);
      for (int i = tid; i < K; i += WIDE) {
        if (i == k) continue;
        float si = s[i];
        if (i == prev) si = rank1(si, X[i * XS + i], prev_delta);
        s[i] = rank1(si, X[i * XS + k], delta);
      }
      if (tid == 0 && prev >= 0) w[prev] = prev_w;
      crit = loss_criterion
                 ? __fadd_rn(crit, __fmul_rn(__fmul_rn(__fmul_rn(0.5f, dlk),
                                                       delta), delta))
                 : __fadd_rn(crit, fabsf(delta));
      prev = k;
      prev_delta = delta;
      prev_w = w_new;
      __syncthreads();
    }
    for (int i = tid; i < K; i += WIDE)
      if (i == prev) s[i] = rank1(s[i], X[i * XS + i], prev_delta);
    if (tid == 0) w[prev] = prev_w;
    __syncthreads();
    ++sweeps;
  } while (crit >= tol && sweeps < max_sweeps);   // the same in every thread

  for (int i = tid; i < K; i += WIDE) w_out[i] = w[i];
  if (tid == 0) *sweeps_out = sweeps;
}

}  // namespace

// XtX (K, K), b (K), w0 (K) -> w (K) and the sweeps run (one int32), on
// `stream`.  K >= 1 (one warp up to 128, a block of 128 threads above),
// max_sweeps >= 1.
INSIDER_API int insider_ctns_cd(const float* XtX, const float* b,
                                const float* w0, float* w, int* sweeps,
                                float lam, float tol, int max_sweeps,
                                int loss_criterion, int K, void* stream) {
  if (K < 1 || max_sweeps < 1) return (int)cudaErrorInvalidValue;
  const int stride = K | 1;                     // odd: conflict-free columns
  if (K > NARROW_K) {
    const size_t vec = sizeof(float) * 5 * (size_t)((K + 3) & ~3);
    const size_t staged = vec + sizeof(float) * (size_t)K * stride;
    int most = 0;
    cudaError_t err = insider::max_dynamic_smem<ctns_cd_block<true>>(most);
    if (err == cudaSuccess && staged <= (size_t)most)
      err = cudaFuncSetAttribute(ctns_cd_block<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)staged);
    if (err != cudaSuccess) return (int)err;
    if (staged <= (size_t)most)
      ctns_cd_block<true><<<1, WIDE, staged, (cudaStream_t)stream>>>(
          XtX, b, w0, w, sweeps, lam, tol, max_sweeps, loss_criterion, K,
          stride);
    else
      ctns_cd_block<false><<<1, WIDE, vec, (cudaStream_t)stream>>>(
          XtX, b, w0, w, sweeps, lam, tol, max_sweeps, loss_criterion, K,
          stride);
    return (int)cudaGetLastError();
  }
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
