// The block solves: feature_sign (fss_streamed.cu) and feature_sign_shared
// (fss_shared.cu) above 128 coordinates, where a warp's register slots
// (four coordinates a lane) and its K x (K + 1) gram plus workspace in
// shared memory (past 227 KB at K ~ 170) no longer reach; and the cold-CD
// block instance of cd_streamed and cd_shared: past K = 320, where
// cd_group_columns' instances stop, and at every K > 128 as the width 128
// of their lanes hook, bit for bit the grouped loop there (fss_core.cuh).
//
// FSS computes fss_column's iteration (fss_core.cuh; the TPU kernel's
// fss_pallas.py:_fss_compute) for any K: forward elimination without
// pivoting over the active coordinates, compacted in ascending order; the
// step to the first sign crossing with the livelock guard; ONE KKT violator
// activated, the largest |grad| and the lowest index on ties, |grad| > l1 +
// 1e-5 (l1 + max|b_j|); at most max_outer steps; then the polish, CD sweeps
// in the fixed order 0..K-1 stopped when a sweep's decrease is <= tol.  A
// column whose Xty or warm start holds a NaN or an Inf comes out all NaN.
// CD computes cd_group_columns' iteration (the TPU kernel's
// cd_pallas.py:_cd_compute): the strong screen, sweeps in the fixed order
// 0..K-1 over the active coordinates, and after a sweep whose decrease is
// <= tol EVERY inactive violator |s - xty| > l1 activated; at most
// max_sweeps sweeps.  Its column comes out all NaN where the warm start
// holds a NaN or an Inf, or Xty an Inf; a NaN in Xty fails the screen.
// The polish and CD are one sweep loop (wide_cd_sweeps), the polish's
// flags all active.
//
// Bound on the H100: the serial solve of each column, latency-bound (a
// barrier a pivot and a barrier a sweep's coordinate); the streamed grams'
// K^2 M f32 read comes second.  The CD block took 2.6-27 times the
// grouped loop's time with every column at the 200-sweep cap at K =
// 160-320 (chip_ab.py --wide-cd, NVIDIA H100 80GB HBM3 at 700 W), so it
// runs by default only past K = 320.
//
// Design: one block of WIDE_THREADS threads solves one column; the blocks
// are persistent, as many as the card holds at once, and take their columns
// from a grid-wide counter (an atomic add on `next`, zeroed by the launch).
// Coordinate i belongs to thread i mod WIDE_THREADS.  The per-coordinate
// vectors (Xty, beta, theta, the active flags, s = G beta, the solution,
// the compacted right-hand side and active list, the polish's diagonal
// terms) lie in shared memory.  The gram lies there too, K x (K + 1),
// where it fits beside them (K <= 235 at 227 KB a block); past that it is
// read from device memory through L2: the shared gram (dense fit) in place,
// a streamed column's gram copied out of its (K, K, M) layout into the
// block's own K x K slice of scratch.  The compacted active system (a x a,
// an odd row stride >= a, so a column's entries fall in distinct banks)
// lies in shared memory too where the gram does and the system fits in what
// the vectors and the gram leave (a <= u_rows: every a at K <= 167), else
// in the block's slice of scratch (where the gram is in device memory, so
// is the system: a block then takes ~11 KB of shared memory, and the many
// blocks an SM holds hid the latency better, in a timing on the H100, than
// one block an SM with the system in shared memory); a pivot row is
// normalized, then every trailing entry takes x - colk * y, the threads
// spread over the trailing columns (neighbouring threads on neighbouring
// columns) and, where fewer columns are left than threads, over rows too,
// a barrier each.
// The sweeps (the polish, CD) run a coordinate a step: every thread
// evaluates coordinate k's update from the shared vectors (the same
// values, so the same bits), then updates s for its own coordinates; k's
// own diagonal term and its new beta are written one step later (the
// coordinate's shared values must stay as read until every thread has read
// them), so one barrier a step; CD skips its screened coordinates.  CD
// solves no system: its blocks take the vectors and the gram only.
// Scratch and counter come from the wrapper (kernels/_lib.launch_on_grams),
// which asks for their size (insider_fss_*_scratch, insider_cd_*_scratch):
// nothing is allocated or read back inside a launch, so the launch is
// captured by a CUDA graph like the others.  Each column's arithmetic is
// independent of the block that runs it, so repeated runs agree bit for
// bit.
#pragma once

#include "fss_core.cuh"

namespace insider {
namespace {

constexpr int WIDE_THREADS = 128;          // a block solves one column
constexpr int WIDE_WARPS = WIDE_THREADS / 32;
constexpr int NARROW_MAX_K = 128;          // the wide solves run above
constexpr int WIDE_VECTORS = 11;           // per-coordinate vectors

// The shared per-coordinate vectors of a block, each padded to 4 floats.
struct WideVectors {
  float *xty, *beta, *theta, *act, *s, *sol, *rhs, *d, *inv_den, *half_den;
  int* idx;
};

__host__ __device__ constexpr int wide_stride(int K) { return (K + 3) & ~3; }

__device__ __forceinline__ WideVectors wide_vectors(float* base, int K) {
  const int S = wide_stride(K);
  WideVectors v;
  float** f[] = {&v.xty, &v.beta, &v.theta, &v.act, &v.s,
                 &v.sol, &v.rhs,  &v.d,     &v.inv_den, &v.half_den};
  for (int q = 0; q < 10; ++q) *f[q] = base + q * S;
  v.idx = reinterpret_cast<int*>(base + 10 * S);
  return v;
}

// Block-wide min / max of one value a thread (every thread gets it); red:
// WIDE_WARPS words of shared memory, free again on return.
__device__ __forceinline__ float block_min(float v, float* red) {
  v = warp_min(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < WIDE_WARPS; ++w) r = fminf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < WIDE_WARPS; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ int block_min_int(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = red[0];
  for (int w = 1; w < WIDE_WARPS; ++w) r = min(r, red[w]);
  __syncthreads();
  return r;
}

// The active coordinates in ascending order into idx; returns their number
// (every thread).  wcount: WIDE_WARPS ints of shared memory.
__device__ __forceinline__ int compact_active(const float* act, int* idx,
                                              int K, int* wcount) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int total = 0;
  for (int base = 0; base < K; base += WIDE_THREADS) {
    const int i = base + threadIdx.x;
    const bool on = i < K && act[i] > 0.5f;
    const unsigned bal = __ballot_sync(FULL, on);
    if (lane == 0) wcount[warp] = __popc(bal);
    __syncthreads();
    int at = total;
    for (int w = 0; w < warp; ++w) at += wcount[w];
    if (on) idx[at + __popc(bal & ((1u << lane) - 1u))] = i;
    for (int w = 0; w < WIDE_WARPS; ++w) total += wcount[w];
    __syncthreads();
  }
  return total;
}

// The step to the first sign crossing of coordinate i (fss_column's line
// search): its tk, and whether it may cross (flip).
__device__ __forceinline__ float crossing(float b, float r, float th,
                                          bool act, bool& flip) {
  flip = act && sgn(r) != th && b != 0.f;
  const float denom = b - r;
  const float safe = (flip && denom != 0.f) ? denom : 1.f;
  return fminf(fmaxf(flip ? b / safe : 1.f, 0.f), 1.f);
}

// s = G[i, :] . beta in order c = 0..K-1 from zero (gram_times).
__device__ __forceinline__ float gram_row_times(const float* Gi,
                                                const float* beta, int K) {
  float s = 0.f;
  for (int c = 0; c < K; ++c) s = __fmaf_rn(Gi[c], beta[c], s);
  return s;
}

// CD sweeps of one column by the block, the one sweep loop of the wide
// solves: cold CD (wide_cd_column) and the FSS polish, whose coordinates
// are all active.  cd_group_columns' iteration (the sweep loop of
// cd_pallas.py:_cd_compute, :111-175) in the fixed order 0..K-1.  G: the
// column's K x K gram, row stride GS; v.act: the active flags (1 or 0),
// v.xty and v.beta loaded, all visible to every thread.  The prologue
// sets s = G beta (gram_row_times), the diagonal and the denominators; a
// sweep takes every active coordinate's soft-threshold update and sums
// its loss decrease in the cancellation-free form, in order.  Every thread
// evaluates coordinate k's update from the shared vectors (the same
// values, so the same bits), then updates s for its own coordinates; k's
// own diagonal term and its new beta are written at the next active
// coordinate's step (the coordinate's shared values must stay as read
// until every thread has read them), so one barrier a coordinate.  An
// inactive coordinate has beta 0 and would not move: it is skipped, with
// no barrier (the flags change only between sweeps, so every thread skips
// alike).  After a sweep whose decrease is <= tol every inactive
// coordinate with |s - xty| > l1 is activated, and the column converges
// when there is none (a block-wide or, the same in every thread; with
// every coordinate active, when the decrease is <= tol).  At most
// max_sweeps sweeps; beta is updated in place in v.beta, visible to every
// thread on return.
__device__ __noinline__ void wide_cd_sweeps(const float* G, int GS,
                                            WideVectors v, int K, float l1,
                                            float l2, float tol,
                                            int max_sweeps) {
  constexpr int NT = WIDE_THREADS;
  const int tid = threadIdx.x;
  for (int i = tid; i < K; i += NT) {
    const float* Gi = G + i * GS;
    v.s[i] = gram_row_times(Gi, v.beta, K);
    const float d = Gi[i];
    float den = d + l2;
    den = den > 0.f ? den : 1.f;
    v.d[i] = d;
    v.inv_den[i] = 1.f / den;
    v.half_den[i] = 0.5f * den;
  }
  __syncthreads();
  const float inv_l1 = 1.f / fmaxf(l1, 1e-30f);
  bool conv = false;
  for (int sweep = 0; sweep < max_sweeps && !conv; ++sweep) {
    float dec = 0.f, prev_delta = 0.f, prev_w = 0.f;
    int prev = -1;                 // the last coordinate updated
    for (int k = 0; k < K; ++k) {
      if (v.act[k] < 0.5f) continue;              // block-uniform
      // every thread evaluates coordinate k's update (the same bits)
      const float b = v.beta[k];
      const float u = v.xty[k] - v.s[k] + b * v.d[k];
      const float w = sgn(u) * fmaxf(fabsf(u) - l1, 0.f) * v.inv_den[k];
      const float delta = w - b;
      const float xi = w != 0.f ? sgn(w)
                                : fminf(fmaxf(u * inv_l1, -1.f), 1.f);
      const float term = v.half_den[k] * delta * delta +
                         l1 * (fabsf(b) - xi * b);
      dec = dec + term;
      // s += G[k, :] delta; prev's own term, and its beta, now
      const float* Gk = G + k * GS;
      for (int i = tid; i < K; i += NT) {
        if (i == k) continue;
        float s = v.s[i];
        if (i == prev) s = s + G[i * GS + i] * prev_delta;
        v.s[i] = s + Gk[i] * delta;
      }
      if (tid == 0 && prev >= 0) v.beta[prev] = prev_w;
      prev = k;
      prev_delta = delta;
      prev_w = w;
      __syncthreads();
    }
    if (prev >= 0) {                              // block-uniform
      for (int i = tid; i < K; i += NT)
        if (i == prev) v.s[i] = v.s[i] + G[i * GS + i] * prev_delta;
      if (tid == 0) v.beta[prev] = prev_w;
    }
    // KKT reactivation after a sweep whose decrease is <= tol; each
    // thread reads and sets only its own coordinates' s and flags
    const bool cand = fabsf(dec) <= tol;          // block-uniform
    bool viol = false;
    for (int i = tid; i < K; i += NT)
      if (v.act[i] < 0.5f && fabsf(__fsub_rn(v.s[i], v.xty[i])) > l1) {
        viol = true;
        if (cand) v.act[i] = 1.f;
      }
    conv = !__syncthreads_or(viol) && cand;       // also the barrier
  }
}

// FSS + polish of one column by the block.  G: the column's K x K gram, row
// stride GS (shared or device memory); Us: shared room for an active system
// of up to u_rows coordinates (u_rows rows of stride u_rows | 1), Ug:
// device room for one of K (used only where a > u_rows); v: the shared
// vectors, v.xty and v.beta loaded (finite) and
// visible to every thread; xm: this thread's max |Xty| over its
// coordinates.  beta is updated in place in v.beta, visible to every thread
// on return.
__device__ __noinline__ void wide_fss_column(const float* G, int GS,
                                             float* Us, int u_rows, float* Ug,
                                             WideVectors v,
                                             int K, float l1, float l2,
                                             float tol, int max_outer,
                                             int polish_sweeps, float xm,
                                             float* red, int* ired) {
  constexpr int NT = WIDE_THREADS;
  const int tid = threadIdx.x;
  const float thresh = l1 + KKT_RTOL * (l1 + block_max(xm, red));
  for (int i = tid; i < K; i += NT) {
    v.act[i] = v.beta[i] != 0.f ? 1.f : 0.f;
    v.theta[i] = sgn(v.beta[i]);
  }
  __syncthreads();

  bool conv = false;
  for (int outer = 0; outer < max_outer && !conv; ++outer) {
    // the compacted system (G + l2 I)[A, A] and its right-hand side, in
    // shared memory where it fits
    const int a = compact_active(v.act, v.idx, K, ired);
    float* U = a <= u_rows ? Us : Ug;
    const int US = a | 1;
    for (int r = 0; r < a; ++r) {
      const float* Gr = G + v.idx[r] * GS;
      float* Ur = U + r * US;
      for (int c = tid; c < a; c += NT) {
        const float g = Gr[v.idx[c]];
        Ur[c] = r == c ? g + l2 : g;
      }
    }
    for (int r = tid; r < a; r += NT) {
      const int i = v.idx[r];
      v.rhs[r] = v.xty[i] - l1 * v.theta[i];
    }
    for (int i = tid; i < K; i += NT) v.sol[i] = 0.f;
    __syncthreads();
    // forward elimination without pivoting: row p over its pivot, then
    // every row below takes x - colk * (row p's entry)
    for (int p = 0; p < a; ++p) {
      float* Up = U + p * US;
      const float inv = 1.f / Up[p];
      for (int c = p + 1 + tid; c < a; c += NT) Up[c] = Up[c] * inv;
      if (tid == 0) v.rhs[p] = v.rhs[p] * inv;
      __syncthreads();
      // the trailing block: cw threads across its columns, rg rows apart
      const int n = a - p - 1;
      if (n > 0) {
        const int cw = n < NT ? n : NT, rg = NT / cw;
        const int tc = tid % cw, tr = tid / cw;
        if (tr < rg)
          for (int c = p + 1 + tc; c < a; c += cw) {
            const float y = Up[c];
#pragma unroll 4
            for (int i = p + 1 + tr; i < a; i += rg)
              U[i * US + c] = U[i * US + c] - U[i * US + p] * y;
          }
      }
      const float bp = v.rhs[p];
      for (int i = p + 1 + tid; i < a; i += NT)
        v.rhs[i] = v.rhs[i] - U[i * US + p] * bp;
      __syncthreads();
    }
    // back substitution
    for (int k = a - 1; k >= 1; --k) {
      const float xk = v.rhs[k];
      for (int i = tid; i < k; i += NT)
        v.rhs[i] = v.rhs[i] - U[i * US + k] * xk;
      __syncthreads();
    }
    for (int r = tid; r < a; r += NT) v.sol[v.idx[r]] = v.rhs[r];
    __syncthreads();

    // line search to the first sign crossing
    float tl = 1.f;
    for (int i = tid; i < K; i += NT) {
      bool flip;
      tl = fminf(tl, crossing(v.beta[i], v.sol[i], v.theta[i],
                              v.act[i] > 0.5f, flip));
    }
    const float t = block_min(tl, red);
    for (int i = tid; i < K; i += NT) {
      float b = v.beta[i];
      const float r = v.sol[i];
      const bool act = v.act[i] > 0.5f;
      bool flip;
      const float tk = crossing(b, r, v.theta[i], act, flip);
      if (act) b = b + t * (r - b);
      if (flip && tk <= t && t < 1.f) b = 0.f;
      v.beta[i] = b;
      v.act[i] = b != 0.f ? 1.f : 0.f;
      v.theta[i] = sgn(b);
    }
    __syncthreads();

    // single-violator KKT activation on a solved column: the largest
    // |grad|, the lowest index on ties
    const bool solved = t >= 1.f;
    float smax = -1.f;
    for (int i = tid; i < K; i += NT) {
      const float g = gram_row_times(G + i * GS, v.beta, K) +
                      l2 * v.beta[i] - v.xty[i];
      const bool viol = v.act[i] < 0.5f && fabsf(g) > thresh && solved;
      const float score = viol ? fabsf(g) : -1.f;
      v.s[i] = score;
      v.sol[i] = g;
      smax = fmaxf(smax, score);
    }
    const float best = block_max(smax, red);
    int first = K;
    for (int i = tid; i < K; i += NT)
      if (v.s[i] >= 0.f && v.s[i] >= best) first = min(first, i);
    const int pick = block_min_int(first, ired);
    if (tid == 0 && best > 0.f && pick < K) {
      v.act[pick] = 1.f;
      v.theta[pick] = -sgn(v.sol[pick]);
    }
    conv = solved && !(best > 0.f);
    __syncthreads();
  }

  if (polish_sweeps <= 0) return;
  // the polish: cold CD's sweeps with every coordinate active
  for (int i = tid; i < K; i += NT) v.act[i] = 1.f;
  __syncthreads();
  wide_cd_sweeps(G, GS, v, K, l1, l2, tol, polish_sweeps);
}

// Cold strong-rule CD of one column by the block (cd_group_columns'
// iteration, the TPU kernel's cd_pallas.py:_cd_compute): the screen thr =
// alpha (2 lam - max|xty|) in the TPU kernel's operation order, the
// screened coordinates' warm start set to zero, then wide_cd_sweeps.  v:
// the shared vectors, v.xty and v.beta loaded (the warm start finite, Xty
// free of Infs) and visible to every thread; xm: this thread's max |Xty|
// over its coordinates (a NaN passed over, as fmaxf does: a column whose
// Xty is NaN fails the screen everywhere and solves to zero).  beta is
// updated in place in v.beta, visible to every thread on return.
__device__ __noinline__ void wide_cd_column(const float* G, int GS,
                                            WideVectors v, int K, float lam,
                                            float alpha, float tol,
                                            int max_sweeps, float xm,
                                            float* red) {
  const float thr =
      __fmul_rn(alpha, __fsub_rn(2.f * lam, block_max(xm, red)));
  for (int i = threadIdx.x; i < K; i += WIDE_THREADS) {
    const bool on = fabsf(v.xty[i]) >= thr;
    v.act[i] = on ? 1.f : 0.f;
    v.beta[i] = v.beta[i] * (on ? 1.f : 0.f);
  }
  __syncthreads();
  wide_cd_sweeps(G, GS, v, K, lam * alpha,
                 __fmul_rn(lam, __fsub_rn(1.f, alpha)), tol, max_sweeps);
}

}  // namespace
}  // namespace insider

namespace {

// Floats of the room for an active system of up to r coordinates: r rows
// of stride r | 1.
__host__ __device__ inline size_t wide_u_floats(int r) {
  return ((size_t)r * (r | 1) + 3) & ~(size_t)3;
}

// Floats of a block's slice of device scratch: room for an active system
// of K where shared memory holds fewer (u_rows < K), and for a streamed
// gram not in shared memory (smem) its copy (K x K).
__host__ __device__ inline size_t wide_block_floats(bool shared, bool smem,
                                                    int u_rows, int K) {
  return (u_rows < K ? wide_u_floats(K) : 0) +
         (!shared && !smem ? (size_t)K * K : 0);
}

// Floats of the gram in shared memory, K x (K + 1) padded to 4.
__host__ __device__ inline size_t wide_gram_floats(int K) {
  return ((size_t)K * (K + 1) + 3) & ~(size_t)3;
}

// One column a block, from the counter `next`.  SHARED: xtx is one (K, K)
// gram for every column (else (K, K, M), gene axis last); SMEM: the gram
// lies in shared memory after the vectors (else in device memory); CD: cold
// strong-rule CD (else FSS + polish); u_rows: the active coordinates whose
// FSS system fits in shared memory after them (CD: K, no system).
template <bool SHARED, bool SMEM, bool CD>
__global__ void __launch_bounds__(insider::WIDE_THREADS)
wide_kernel(const float* __restrict__ xtx, const float* __restrict__ xty,
            const float* __restrict__ beta0, float* __restrict__ out,
            int* next, float* scratch, int M, int K, int u_rows,
            insider::Solver<CD> solver) {
  using insider::WIDE_THREADS;
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[insider::WIDE_WARPS];
  __shared__ int ired[insider::WIDE_WARPS];
  __shared__ int column;
  const int tid = threadIdx.x;
  const insider::WideVectors v = insider::wide_vectors(smem, K);
  float* Gs = smem + insider::WIDE_VECTORS * insider::wide_stride(K);
  float* slice =
      scratch + blockIdx.x * wide_block_floats(SHARED, SMEM, u_rows, K);
  float* Us = Gs + (SMEM ? wide_gram_floats(K) : 0);     // a <= u_rows
  float* Ug = slice;                                      // a > u_rows
  float* Gg = slice + (u_rows < K ? wide_u_floats(K) : 0);  // streamed, not
                                                             // in shared
  const float* G = SMEM ? Gs : (SHARED ? xtx : Gg);
  const int GS = SMEM ? K + 1 : K;
  if (SHARED && SMEM) {
    for (int e = tid; e < K * K; e += WIDE_THREADS)
      Gs[(e / K) * (K + 1) + e % K] = xtx[e];
  }
  const float tol = *solver.tol;
  for (;;) {
    if (tid == 0) column = atomicAdd(next, 1);
    __syncthreads();              // also: the last column's reads are done
    const int j = column;
    if (j >= M) break;            // block-uniform
    if (!SHARED) {
      for (int e = tid; e < K * K; e += WIDE_THREADS) {
        const float g = xtx[(size_t)e * M + j];
        if (SMEM)
          Gs[(e / K) * (K + 1) + e % K] = g;
        else
          Gg[e] = g;
      }
    }
    // a column comes out all NaN where its warm start holds a NaN or an
    // Inf, or its Xty an Inf (FSS: also a NaN), as cd_group_columns' and
    // fss_column's do
    bool fin = true;
    float xm = 0.f;
    for (int i = tid; i < K; i += WIDE_THREADS) {
      const float x = xty[(size_t)i * M + j], b = beta0[(size_t)i * M + j];
      v.xty[i] = x;
      v.beta[i] = b;
      fin = fin && isfinite(b) && (CD ? !isinf(x) : isfinite(x));
      xm = fmaxf(xm, fabsf(x));
    }
    if (!__syncthreads_and(fin)) {
      for (int i = tid; i < K; i += WIDE_THREADS)
        out[(size_t)i * M + j] = insider::not_a_number();
      continue;
    }
    if constexpr (CD)
      insider::wide_cd_column(G, GS, v, K, solver.lam, solver.alpha, tol,
                              solver.max_sweeps, xm, red);
    else
      insider::wide_fss_column(G, GS, Us, u_rows, Ug, v, K, solver.l1,
                               solver.l2, tol, solver.max_outer,
                               solver.polish_sweeps, xm, red, ired);
    for (int i = tid; i < K; i += WIDE_THREADS)
      out[(size_t)i * M + j] = v.beta[i];
  }
}

// The launch of a shape: the gram in shared memory or not, the dynamic
// shared bytes and the blocks (as many as the card holds at once, at most
// M).
struct WidePlan {
  bool smem_gram;
  int u_rows;
  size_t smem;
  int blocks, per_sm;
};

template <bool SHARED, bool CD>
cudaError_t wide_plan(int M, int K, WidePlan& p) {
  const size_t vec =
      sizeof(float) * insider::WIDE_VECTORS * insider::wide_stride(K);
  const size_t gram = sizeof(float) * wide_gram_floats(K);
  int most = 0;
  cudaError_t err =
      insider::max_dynamic_smem<wide_kernel<SHARED, true, CD>>(most);
  if (err != cudaSuccess) return err;
  p.smem_gram = vec + gram <= (size_t)most;
  p.smem = p.smem_gram ? vec + gram : vec;
  p.u_rows = CD ? K : 0;                 // CD solves no system
  while (!CD && p.smem_gram && p.u_rows < K &&
         p.smem + sizeof(float) * wide_u_floats(p.u_rows + 1) <=
             (size_t)most)
    ++p.u_rows;
  if (!CD) p.smem += sizeof(float) * wide_u_floats(p.u_rows);
  insider::Residency res;
  err = p.smem_gram
            ? insider::residency<wide_kernel<SHARED, true, CD>>(
                  insider::WIDE_THREADS, p.smem, res)
            : insider::residency<wide_kernel<SHARED, false, CD>>(
                  insider::WIDE_THREADS, p.smem, res);
  if (err != cudaSuccess) return err;
  if (res.per_sm < 1) return cudaErrorInvalidConfiguration;
  p.per_sm = res.per_sm;
  const int most_blocks = res.per_sm * res.sms;
  p.blocks = M < most_blocks ? M : most_blocks;
  return cudaSuccess;
}

// Floats of device scratch the wide solve needs at (M, K): 0 at K <= 128
// (the narrow kernels) and where no plan exists (the launch then reports
// the CUDA error).
template <bool SHARED, bool CD>
long wide_scratch_floats(int M, int K) {
  WidePlan p;
  if (M < 1 || K <= insider::NARROW_MAX_K ||
      wide_plan<SHARED, CD>(M, K, p) != cudaSuccess)
    return 0;
  return (long)p.blocks *
         (long)wide_block_floats(SHARED, p.smem_gram, p.u_rows, K);
}

template <bool SHARED, bool CD>
cudaError_t launch_wide(const float* xtx, const float* xty,
                        const float* beta0, float* out, int* next,
                        float* scratch, long scratch_len, int M, int K,
                        insider::Solver<CD> solver, cudaStream_t stream) {
  WidePlan p;
  cudaError_t err = wide_plan<SHARED, CD>(M, K, p);
  if (err != cudaSuccess) return err;
  const long need =
      (long)p.blocks *
      (long)wide_block_floats(SHARED, p.smem_gram, p.u_rows, K);
  if (next == nullptr || (need > 0 && scratch == nullptr) ||
      scratch_len < need)
    return cudaErrorInvalidValue;
  if ((err = cudaMemsetAsync(next, 0, sizeof(int), stream)) != cudaSuccess)
    return err;
  if (p.smem_gram)
    wide_kernel<SHARED, true, CD><<<p.blocks, insider::WIDE_THREADS, p.smem,
                                    stream>>>(xtx, xty, beta0, out, next,
                                              scratch, M, K, p.u_rows,
                                              solver);
  else
    wide_kernel<SHARED, false, CD><<<p.blocks, insider::WIDE_THREADS,
                                     p.smem, stream>>>(
        xtx, xty, beta0, out, next, scratch, M, K, p.u_rows, solver);
  return cudaGetLastError();
}

// The wide instance's columns an SM solves at once (insider_*_widths).
template <bool SHARED, bool CD>
cudaError_t wide_columns(int K, int& columns) {
  WidePlan p;
  const cudaError_t err = wide_plan<SHARED, CD>(1, K, p);
  if (err == cudaSuccess) columns = p.per_sm;
  return err;
}

}  // namespace
