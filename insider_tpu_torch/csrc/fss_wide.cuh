// The wide column solves, above 128 coordinates, where a warp's register
// slots (four coordinates a lane) and its K x (K + 1) gram plus workspace
// in shared memory (past 227 KB at K ~ 170) no longer reach:
//   * the FSS steps of feature_sign (fss_streamed.cu) and
//     feature_sign_shared (fss_shared.cu) to K = 320, a block a column
//     (steps_column, panel_solve), their polish on the grouped CD loop
//     (fss_core.cuh: cd_group_columns with polish on);
//   * the block solves, one column a block of 128 threads: FSS with its
//     polish (wide_fss_column) and cold CD (wide_cd_column), past K = 320,
//     where cd_group_columns' instances stop, and at every K > 128 as the
//     width 128 of the four kernels' lanes hook, bit for bit the grouped
//     solves there.
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
// The block's polish and CD are one sweep loop (wide_cd_sweeps), the
// polish's flags all active.
//
// Bound on the H100: the serial solve of each column.  An FSS step
// eliminates a active coordinates, a^3 / 3 FMAs in a chain of a pivots and
// then a rows of back substitution, each latency-bound; the streamed grams'
// K^2 M f32 read comes second.  In the K = 160 fits (chip_ab.py --wide-fss,
// NVIDIA H100 80GB HBM3 at 700 W) a column's first update takes 48 steps
// of ~136 coordinates and 32 polish sweeps, a later one ~4 steps of ~120
// and one sweep: the elimination was 93-95% of the block solve's time.
//
// The FSS steps (steps_column): a block of STEPS_WARPS warps a column, two
// blocks of half that an SM where the vectors and a system of K fit twice
// in its shared memory (K <= 160: one block's serial chains overlap the
// other's parallel work; 1.27-1.42 times one block's speed on the K = 160
// fits' updates).  The per-coordinate vectors lie in shared memory, the
// gram in device memory read through L2 (the dense fit's one gram in
// place, a streamed column's copied K x K into the block's slice of
// scratch), the compacted active system (row stride ws_stride(a): 16-byte
// rows) in shared memory where it fits, else in the slice.  panel_solve
// eliminates in panels of PANEL pivots: warp 0 the panel's diagonal block
// in registers, a pivot's row and column by shuffles; the panel's rows to
// the right a column a thread, the rows below their multipliers a row a
// thread; then the trailing block with a thread's four columns of the
// panel's rows in registers, each entry loaded and stored once a panel;
// three barriers a panel, where the block solve took two a pivot and three
// shared-memory accesses an FMA.  Back substitution by warp 0, a lane
// holding rows lane + 32 q, a shuffle a row.  Every entry takes the block
// solve's updates in its order and form (x = fma(-colk, y, x), a row times
// the pivot's reciprocal, back substitution rows a-1..1), so the bits are
// the block solve's.  What bounds a step (a per-phase count of clock64
// cycles at K = 160, one block of 16 warps an SM, chip runs): warp 0's
// chain of a pivots (~33%) and of a rows of back substitution (~18%), the
// panels' rows and multipliers (~14%), the trailing update (~24%), the
// system's build and the gradient (~11%).
//
// The block solve: one block of WIDE_THREADS threads solves one column;
// the blocks are persistent, as many as the card holds at once, and take
// their columns from a grid-wide counter (an atomic add on `next`, zeroed
// by the launch).  Coordinate i belongs to thread i mod WIDE_THREADS.  The
// per-coordinate vectors (Xty, beta, theta, the active flags, s = G beta,
// the solution, the compacted right-hand side and active list, the
// polish's diagonal terms) lie in shared memory.  The gram lies there too,
// K x (K + 1), where it fits beside them (K <= 235 at 227 KB a block); past
// that it is read from device memory through L2: the shared gram (dense
// fit) in place, a streamed column's gram copied out of its (K, K, M)
// layout into the block's own K x K slice of scratch.  The compacted
// active system (a x a, an odd row stride >= a, so a column's entries fall
// in distinct banks) lies in shared memory too where the gram does and the
// system fits in what the vectors and the gram leave (a <= u_rows: every a
// at K <= 167), else in the block's slice of scratch; a pivot row is
// normalized, then every trailing entry takes x - colk * y, the threads
// spread over the trailing columns (neighbouring threads on neighbouring
// columns) and, where fewer columns are left than threads, over rows too,
// a barrier each.  The sweeps (the polish, CD) run a coordinate a step:
// every thread evaluates coordinate k's update from the shared vectors (the
// same values, so the same bits), then updates s for its own coordinates;
// k's own diagonal term and its new beta are written one step later, so
// one barrier a step; CD skips its screened coordinates.  CD solves no
// system: its blocks take the vectors and the gram only.  The CD block
// took 2.6-27 times the grouped loop's time with every column at the
// 200-sweep cap at K = 160-320, and the FSS block 4.7-42 times the grouped
// solve's on phase 6's problems and the K = 160 fits' updates (chip_ab.py
// --wide-cd, --wide-fss), so they run by default only past K = 320.
//
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

// Block-wide min / max of one value a thread (every thread gets it), NT
// threads a block; red: NT / 32 words of shared memory, free again on
// return.
template <int NT = WIDE_THREADS>
__device__ __forceinline__ float block_min(float v, float* red) {
  v = warp_min(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < NT / 32; ++w) r = fminf(r, red[w]);
  __syncthreads();
  return r;
}

template <int NT = WIDE_THREADS>
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < NT / 32; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

template <int NT = WIDE_THREADS>
__device__ __forceinline__ int block_min_int(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = red[0];
  for (int w = 1; w < NT / 32; ++w) r = min(r, red[w]);
  __syncthreads();
  return r;
}

// The active coordinates in ascending order into idx; returns their number
// (every thread).  wcount: NT / 32 ints of shared memory.
template <int NT = WIDE_THREADS>
__device__ __forceinline__ int compact_active(const float* act, int* idx,
                                              int K, int* wcount) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int total = 0;
  for (int base = 0; base < K; base += NT) {
    const int i = base + threadIdx.x;
    const bool on = i < K && act[i] > 0.5f;
    const unsigned bal = __ballot_sync(FULL, on);
    if (lane == 0) wcount[warp] = __popc(bal);
    __syncthreads();
    int at = total;
    for (int w = 0; w < warp; ++w) at += wcount[w];
    if (on) idx[at + __popc(bal & ((1u << lane) - 1u))] = i;
    for (int w = 0; w < NT / 32; ++w) total += wcount[w];
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

// ---- The grouped solve past 128 coordinates: FSS steps by a block ----


constexpr int PANEL = 8;            // pivots a panel of the elimination
constexpr int STEPS_SLOTS = CD_GROUP_MAX_K / 32;   // back substitution
constexpr int STEPS_WARPS = 16;     // feature_sign's steps, a block a column

// A column's gram as the FSS steps read it: K x K row-major in device
// memory, through L2 (the dense fit's one gram in place, a streamed
// column's copied out of its (K, K, M) layout).  On the bit-symmetric
// grams every caller gives, at(i, c) is the block solve's G[i][c], and
// sym(i, c) reads G[c][i], the same value, where neighbouring i lie side
// by side (the gradient's rows, a thread each).
struct SquareGram {
  const float* G;
  int K;
  __device__ __forceinline__ float at(int i, int c) const {
    return G[i * K + c];
  }
  __device__ __forceinline__ float sym(int i, int c) const {
    return G[c * K + i];
  }
};

// Forward elimination without pivoting and back substitution of the
// compacted active system U (a x a, row stride US = ws_stride(a), shared or
// device memory, 16-byte aligned) with right-hand side rhs (a floats of
// shared memory), NT threads: the block solve's arithmetic (wide_fss_column)
// entry by entry.  Each entry takes the updates of the pivots before it in
// pivot order, each x - colk y as one fma (x = fma(-colk, y, x)), a pivot
// row is normalized as row x (1 / pivot), and back substitution takes
// rows a-1..1 in that order; only the schedule differs.  The pivots go in
// panels of PANEL: warp 0 eliminates the panel's diagonal block and
// right-hand side pivot by pivot (pinv: PANEL floats of shared memory,
// the pivots' reciprocals); then the panel's rows past the block, a column
// a thread, each row updated by the panel's earlier pivots in order and
// normalized; then every row below the panel computes its multipliers
// (its panel columns, updated by the panel's earlier pivots) and takes the
// panel's PANEL updates in order on four columns at a time in registers,
// one 16-byte load and store of the entry a panel where the block solve
// took a load, a load and a store an update and two barriers a pivot.
// Three barriers a panel.  Back substitution by warp 0 in registers, each
// lane holding rows lane + 32 q, a shuffle a row.  The solution replaces
// rhs; every thread sees it on return.
template <int NT>
__device__ __forceinline__ void panel_solve(float* __restrict__ U, int US,
                                            float* __restrict__ rhs, int a,
                                            float* __restrict__ pinv) {
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int p0 = 0; p0 < a; p0 += PANEL) {
    const int p1 = min(p0 + PANEL, a), nb = p1 - p0;
    // 1. the diagonal block and the panel's right-hand side, in registers
    // of warp 0: lane c < nb holds the block's column p0 + c, lane PANEL
    // the right-hand side; a pivot's row and column go by shuffles
    if (warp == 0) {
      const bool held = lane < nb || lane == PANEL;
      float x[PANEL];
#pragma unroll
      for (int r = 0; r < PANEL; ++r)
        x[r] = !(held && r < nb) ? 0.f
               : lane == PANEL   ? rhs[p0 + r]
                                 : U[(p0 + r) * US + p0 + lane];
#pragma unroll
      for (int pl = 0; pl < PANEL; ++pl) {
        if (pl < nb) {                         // warp-uniform
          const float piv = __shfl_sync(FULL, x[pl], pl);
          float l[PANEL];                      // column pl below the pivot
#pragma unroll
          for (int r = pl + 1; r < PANEL; ++r)
            l[r] = __shfl_sync(FULL, x[r], pl);
          const float inv = 1.f / piv;
          const bool right = (lane > pl && lane < nb) || lane == PANEL;
          if (right) x[pl] = __fmul_rn(x[pl], inv);
#pragma unroll
          for (int r = pl + 1; r < PANEL; ++r)
            if (right && r < nb) x[r] = __fmaf_rn(-l[r], x[pl], x[r]);
          if (lane == 0) pinv[pl] = inv;
        }
      }
#pragma unroll
      for (int r = 0; r < PANEL; ++r)
        if (held && r < nb) {
          if (lane == PANEL)
            rhs[p0 + r] = x[r];
          else
            U[(p0 + r) * US + p0 + lane] = x[r];
        }
    }
    __syncthreads();
    // 2. the panel's rows past the block, a column a thread, each row
    // updated by the panel's earlier pivots in order and normalized; and
    // the rows below the panel, a row a thread, their multipliers (their
    // panel columns, updated by the panel's earlier pivots in order, in
    // place) and their right-hand side
    const int n = a - p1;
    for (int t = tid; t < 2 * n; t += NT) {
      if (t < n) {
        const int c = p1 + t;
        float x[PANEL];
#pragma unroll
        for (int r = 0; r < PANEL; ++r) {
          const float* Ur = U + (p0 + r) * US;
          float v = Ur[c];
#pragma unroll
          for (int q = 0; q < r; ++q) v = __fmaf_rn(-Ur[p0 + q], x[q], v);
          x[r] = __fmul_rn(v, pinv[r]);
          U[(p0 + r) * US + c] = x[r];
        }
      } else {
        const int i = p1 + t - n;
        float* Ui = U + i * US + p0;
        float L[PANEL];
        float b = rhs[i];
#pragma unroll
        for (int r = 0; r < PANEL; ++r) {
          float v = Ui[r];
#pragma unroll
          for (int q = 0; q < r; ++q)
            v = __fmaf_rn(-L[q], U[(p0 + q) * US + p0 + r], v);
          L[r] = v;
          Ui[r] = v;
          b = __fmaf_rn(-v, rhs[p0 + r], b);
        }
        rhs[i] = b;
      }
    }
    __syncthreads();
    // 3. the trailing block, rows and columns p1..a-1: a thread takes four
    // columns (the panel's rows there in registers) and rows rg, rg + RG,
    // ... of them, each row's multipliers read once (two 16-byte loads the
    // lanes of a warp share) and its four entries loaded and stored once,
    // two rows an iteration
    if (n > 0) {
      const int n4 = (n + 3) >> 2, RG = NT / n4;
      const int ch = tid % n4, rg = tid / n4;
      if (rg < RG) {
        const int c = p1 + 4 * ch;
        float4 y[PANEL];
#pragma unroll
        for (int r = 0; r < PANEL; ++r)
          y[r] = *reinterpret_cast<const float4*>(U + (p0 + r) * US + c);
        for (int i = p1 + rg; i < a; i += 2 * RG) {
          const int i2 = i + RG < a ? i + RG : i;
          float* Ui = U + i * US;
          float* Uj = U + i2 * US;
          const float4 l0 = *reinterpret_cast<const float4*>(Ui + p0);
          const float4 l1 = *reinterpret_cast<const float4*>(Ui + p0 + 4);
          const float4 m0 = *reinterpret_cast<const float4*>(Uj + p0);
          const float4 m1 = *reinterpret_cast<const float4*>(Uj + p0 + 4);
          const float L[PANEL] = {l0.x, l0.y, l0.z, l0.w,
                                  l1.x, l1.y, l1.z, l1.w};
          const float N[PANEL] = {m0.x, m0.y, m0.z, m0.w,
                                  m1.x, m1.y, m1.z, m1.w};
          float4 x = *reinterpret_cast<const float4*>(Ui + c);
          float4 z = *reinterpret_cast<const float4*>(Uj + c);
#pragma unroll
          for (int r = 0; r < PANEL; ++r) {
            x.x = __fmaf_rn(-L[r], y[r].x, x.x);
            x.y = __fmaf_rn(-L[r], y[r].y, x.y);
            x.z = __fmaf_rn(-L[r], y[r].z, x.z);
            x.w = __fmaf_rn(-L[r], y[r].w, x.w);
            z.x = __fmaf_rn(-N[r], y[r].x, z.x);
            z.y = __fmaf_rn(-N[r], y[r].y, z.y);
            z.z = __fmaf_rn(-N[r], y[r].z, z.z);
            z.w = __fmaf_rn(-N[r], y[r].w, z.w);
          }
          *reinterpret_cast<float4*>(Ui + c) = x;
          if (i2 != i) *reinterpret_cast<float4*>(Uj + c) = z;
        }
      }
    }
    __syncthreads();
  }
  // back substitution: x_k final, then every row above it takes -U[i][k]
  // x_k; rows k of slot qk (a constant) in turn
  if (warp == 0) {
    float x[STEPS_SLOTS];
#pragma unroll
    for (int q = 0; q < STEPS_SLOTS; ++q)
      x[q] = lane + 32 * q < a ? rhs[lane + 32 * q] : 0.f;
#pragma unroll
    for (int qk = STEPS_SLOTS - 1; qk >= 0; --qk) {
      const int k_top = min(a, 32 * (qk + 1)) - 1, k_end = max(1, 32 * qk);
      if (k_top < k_end) continue;             // warp-uniform
      float u[STEPS_SLOTS];                    // column k, loaded a row ahead
#pragma unroll
      for (int q = 0; q <= qk; ++q) {
        const int i = lane + 32 * q;
        u[q] = i < k_top ? U[i * US + k_top] : 0.f;
      }
      for (int k = k_top; k >= k_end; --k) {
        const float xk = __shfl_sync(FULL, x[qk], k & 31);
#pragma unroll
        for (int q = 0; q <= qk; ++q) {
          const int i = lane + 32 * q;
          const float uk = u[q];
          u[q] = i < k - 1 ? U[i * US + k - 1] : 0.f;
          if (i < k) x[q] = __fmaf_rn(-uk, xk, x[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < STEPS_SLOTS; ++q)
      if (lane + 32 * q < a) rhs[lane + 32 * q] = x[q];
  }
  __syncthreads();
}

// One step's compacted system (G + l2 I)[A, A] (the a active coordinates,
// v.idx) built into U (row stride ws_stride(a)) and solved (panel_solve)
// against v.rhs, which holds the solution on return.
template <int NT>
__device__ __forceinline__ void active_system(const SquareGram& G, float* U,
                                              WideVectors v, int a, float l2,
                                              float* pinv) {
  const int tid = threadIdx.x, US = ws_stride(a);
  if (a > 0 && a <= NT) {
    const int rg = NT / a, c = tid % a;
    if (tid / a < rg) {
      const int ic = v.idx[c];
      for (int r = tid / a; r < a; r += rg) {
        const float g = G.at(v.idx[r], ic);
        U[r * US + c] = r == c ? __fadd_rn(g, l2) : g;
      }
    }
  } else {
    for (int r = 0; r < a; ++r)
      for (int c = tid; c < a; c += NT) {
        const float g = G.at(v.idx[r], v.idx[c]);
        U[r * US + c] = r == c ? __fadd_rn(g, l2) : g;
      }
  }
  __syncthreads();
  panel_solve<NT>(U, US, v.rhs, a, pinv);
}

// The FSS steps of one column by a block of NT threads, wide_fss_column's
// outer steps (its header) with the solve of panel_solve: beta holds the
// FSS result on return (no polish: the kernels polish in a phase of their
// own, cd_group_columns with polish on).  G: the column's gram; Us: shared
// room for an active system of up to u_rows
// coordinates (u_rows rows of stride ws_stride(u_rows)), Ug: device room
// for one of K (used only where a > u_rows); v: the shared vectors, v.xty
// and v.beta loaded (finite) and visible to every thread; xm: this thread's
// max |Xty| over its coordinates; pinv: PANEL floats, red and ired NT / 32
// words of shared memory.
template <int NT>
__device__ __forceinline__ void steps_column(const SquareGram& G, float* Us,
                                             int u_rows, float* Ug,
                                             WideVectors v, int K, float l1,
                                             float l2, int max_outer,
                                             float xm, float* pinv,
                                             float* red, int* ired) {
  const int tid = threadIdx.x;
  const float thresh =
      __fmaf_rn(KKT_RTOL, __fadd_rn(l1, block_max<NT>(xm, red)), l1);
  for (int i = tid; i < K; i += NT) {
    v.act[i] = v.beta[i] != 0.f ? 1.f : 0.f;
    v.theta[i] = sgn(v.beta[i]);
  }
  __syncthreads();

  bool conv = false;
  for (int outer = 0; outer < max_outer && !conv; ++outer) {
    // the compacted system (G + l2 I)[A, A] and its right-hand side
    const int a = compact_active<NT>(v.act, v.idx, K, ired);
    for (int r = tid; r < a; r += NT) {
      const int i = v.idx[r];
      v.rhs[r] = __fmaf_rn(-l1, v.theta[i], v.xty[i]);
    }
    for (int i = tid; i < K; i += NT) v.sol[i] = 0.f;
    // in shared memory where it fits (a path of its own, so that its
    // accesses are shared-memory ones), else in device memory
    if (a <= u_rows)
      active_system<NT>(G, Us, v, a, l2, pinv);
    else
      active_system<NT>(G, Ug, v, a, l2, pinv);
    for (int r = tid; r < a; r += NT) v.sol[v.idx[r]] = v.rhs[r];
    __syncthreads();

    // line search to the first sign crossing
    float tl = 1.f;
    for (int i = tid; i < K; i += NT) {
      bool flip;
      tl = fminf(tl, crossing(v.beta[i], v.sol[i], v.theta[i],
                              v.act[i] > 0.5f, flip));
    }
    const float t = block_min<NT>(tl, red);
    for (int i = tid; i < K; i += NT) {
      float b = v.beta[i];
      const float r = v.sol[i];
      const bool act = v.act[i] > 0.5f;
      bool flip;
      const float tk = crossing(b, r, v.theta[i], act, flip);
      if (act) b = __fmaf_rn(t, __fsub_rn(r, b), b);
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
      float s = 0.f;
      for (int c = 0; c < K; ++c) s = __fmaf_rn(G.sym(i, c), v.beta[c], s);
      const float g = __fsub_rn(__fmaf_rn(l2, v.beta[i], s), v.xty[i]);
      const bool viol = v.act[i] < 0.5f && fabsf(g) > thresh && solved;
      const float score = viol ? fabsf(g) : -1.f;
      v.s[i] = score;
      v.sol[i] = g;
      smax = fmaxf(smax, score);
    }
    const float best = block_max<NT>(smax, red);
    int first = K;
    for (int i = tid; i < K; i += NT)
      if (v.s[i] >= 0.f && v.s[i] >= best) first = min(first, i);
    const int pick = block_min_int<NT>(first, ired);
    if (tid == 0 && best > 0.f && pick < K) {
      v.act[pick] = 1.f;
      v.theta[pick] = -sgn(v.sol[pick]);
    }
    conv = solved && !(best > 0.f);
    __syncthreads();
  }
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

// The grouped solve's FSS steps past 128 coordinates, the first launch of
// feature_sign (SHARED false) and feature_sign_shared (SHARED true), the
// polish their second (the CD kernels' grouped instances with polish on):
// floats of shared and device memory, the kernel and its launch.

// Room for an active system of up to r coordinates: r rows of stride
// ws_stride(r) (16-byte aligned rows).
__host__ __device__ inline size_t steps_u_floats(int r) {
  return (size_t)r * insider::ws_stride(r);
}

__host__ __device__ inline size_t pad4(size_t n) { return (n + 3) & ~(size_t)3; }

// A block's slice of device scratch: room for an active system of K where
// shared memory holds fewer (u_rows < K), and a streamed column's gram, K x
// K (!SHARED).
__host__ __device__ inline size_t steps_block_floats(bool shared, int u_rows,
                                                     int K) {
  return pad4((u_rows < K ? steps_u_floats(K) : 0) +
              (!shared ? (size_t)K * K : 0));
}

// One column a block of WARPS warps, persistent blocks taking columns from
// the counter `next` (zeroed by the launch); the vectors in shared memory,
// then room for an active system of up to u_rows coordinates (larger ones
// in the block's slice of scratch).  The gram is read through L2: SHARED,
// the one (K, K) gram in place; else each column's copied out of its (K,
// K, M) layout, K x K, into the slice.  Writes each column's FSS result (all
// NaN where its Xty or warm start holds a NaN or an Inf, as the block
// solve's).
template <bool SHARED, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, insider::STEPS_WARPS / WARPS)
steps_kernel(const float* __restrict__ xtx, const float* __restrict__ xty,
             const float* __restrict__ beta0, float* __restrict__ out,
             int* next, float* scratch, int M, int K, int u_rows,
             insider::Solver<false> solver) {
  constexpr int NT = WARPS * 32;
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[32];
  __shared__ int ired[32];
  __shared__ float pinv[insider::PANEL];
  __shared__ int column;
  const int tid = threadIdx.x;
  const insider::WideVectors v = insider::wide_vectors(smem, K);
  float* Us = smem + insider::WIDE_VECTORS * insider::wide_stride(K);
  float* slice = scratch + blockIdx.x * steps_block_floats(SHARED, u_rows, K);
  float* Ug = slice;                                      // a > u_rows
  float* Gg = slice + (u_rows < K ? steps_u_floats(K) : 0);
  const int n = K * (K + 1) / 2;
  for (;;) {
    if (tid == 0) column = atomicAdd(next, 1);
    __syncthreads();              // also: the last column's reads are done
    const int j = column;
    if (j >= M) break;            // block-uniform
    if (!SHARED) {
      // the upper triangle in row order, (k, l >= k) from xtx[k][l], to
      // both triangles of the copy
      int k = 0, l = tid;
      for (int e = tid; e < n; e += NT, l += NT) {
        while (l >= K) l -= K - ++k;
        const float g = xtx[((size_t)k * K + l) * M + j];
        Gg[k * K + l] = g;
        Gg[l * K + k] = g;
      }
    }
    bool fin = true;
    float xm = 0.f;
    for (int i = tid; i < K; i += NT) {
      const float x = xty[(size_t)i * M + j], b = beta0[(size_t)i * M + j];
      v.xty[i] = x;
      v.beta[i] = b;
      fin = fin && isfinite(b) && isfinite(x);
      xm = fmaxf(xm, fabsf(x));
    }
    if (!__syncthreads_and(fin)) {  // also: the gram's copy is seen
      for (int i = tid; i < K; i += NT)
        out[(size_t)i * M + j] = insider::not_a_number();
      continue;
    }
    insider::steps_column<NT>(insider::SquareGram{SHARED ? xtx : Gg, K}, Us,
                              u_rows, Ug, v, K, solver.l1, solver.l2,
                              solver.max_outer, xm, pinv, red, ired);
    for (int i = tid; i < K; i += NT) out[(size_t)i * M + j] = v.beta[i];
  }
}

// The steps' launch at (M, K): two blocks of STEPS_WARPS / 2 warps an SM
// where the vectors and a system of K fit twice in its shared memory (K <=
// 160: one block's serial chains, a pivot and a row of back substitution
// at a time, overlap the other's parallel work), else one block of
// STEPS_WARPS, the system's rows in shared memory as many as fit; the
// bytes and the blocks (as many as the card holds, at most M).
struct StepsPlan {
  int warps, u_rows;
  size_t smem;
  int blocks, per_sm;
};

constexpr int HALF_WARPS = insider::STEPS_WARPS / 2;

template <bool SHARED>
cudaError_t steps_plan(int M, int K, StepsPlan& p) {
  using insider::max_dynamic_smem;
  using insider::residency;
  const size_t fixed =
      sizeof(float) * insider::WIDE_VECTORS * insider::wide_stride(K);
  int most = 0;
  cudaError_t err = max_dynamic_smem<steps_kernel<SHARED, HALF_WARPS>>(most);
  if (err != cudaSuccess) return err;
  insider::Residency res;
  p.warps = HALF_WARPS;
  p.u_rows = K;
  p.smem = fixed + sizeof(float) * steps_u_floats(K);
  if (p.smem <= (size_t)most &&
      (err = residency<steps_kernel<SHARED, HALF_WARPS>>(
           HALF_WARPS * 32, p.smem, res)) != cudaSuccess)
    return err;
  if (p.smem > (size_t)most || res.per_sm < 2) {
    constexpr int W = insider::STEPS_WARPS;
    if ((err = max_dynamic_smem<steps_kernel<SHARED, W>>(most)) !=
        cudaSuccess)
      return err;
    if (fixed > (size_t)most) return cudaErrorInvalidConfiguration;
    p.warps = W;
    p.u_rows = 0;
    while (p.u_rows < K &&
           fixed + sizeof(float) * steps_u_floats(p.u_rows + 1) <=
               (size_t)most)
      ++p.u_rows;
    p.smem = fixed + sizeof(float) * steps_u_floats(p.u_rows);
    if ((err = residency<steps_kernel<SHARED, W>>(W * 32, p.smem, res)) !=
        cudaSuccess)
      return err;
  }
  if (res.per_sm < 1) return cudaErrorInvalidConfiguration;
  p.per_sm = res.per_sm;
  p.blocks = M < res.per_sm * res.sms ? M : res.per_sm * res.sms;
  return cudaSuccess;
}

// Floats of device scratch the steps need at (M, K); 0 where no plan
// exists (the launch then reports the CUDA error).
template <bool SHARED>
long steps_scratch_floats(int M, int K) {
  StepsPlan p;
  if (M < 1 || steps_plan<SHARED>(M, K, p) != cudaSuccess) return 0;
  return (long)p.blocks * (long)steps_block_floats(SHARED, p.u_rows, K);
}

template <bool SHARED>
cudaError_t launch_steps(const float* xtx, const float* xty,
                         const float* beta0, float* out, int* next,
                         float* scratch, long scratch_len, int M, int K,
                         insider::Solver<false> solver, cudaStream_t stream) {
  StepsPlan p;
  cudaError_t err = steps_plan<SHARED>(M, K, p);
  if (err != cudaSuccess) return err;
  const long need =
      (long)p.blocks * (long)steps_block_floats(SHARED, p.u_rows, K);
  if (next == nullptr || (need > 0 && scratch == nullptr) ||
      scratch_len < need)
    return cudaErrorInvalidValue;
  if ((err = cudaMemsetAsync(next, 0, sizeof(int), stream)) != cudaSuccess)
    return err;
  constexpr int W = insider::STEPS_WARPS;
  if (p.warps == W)
    steps_kernel<SHARED, W><<<p.blocks, W * 32, p.smem, stream>>>(
        xtx, xty, beta0, out, next, scratch, M, K, p.u_rows, solver);
  else
    steps_kernel<SHARED, HALF_WARPS>
        <<<p.blocks, HALF_WARPS * 32, p.smem, stream>>>(
            xtx, xty, beta0, out, next, scratch, M, K, p.u_rows, solver);
  return cudaGetLastError();
}

// The steps' columns an SM solves at once (insider_*_widths).
template <bool SHARED>
cudaError_t steps_columns(int K, int& columns) {
  StepsPlan p;
  const cudaError_t err = steps_plan<SHARED>(1, K, p);
  if (err == cudaSuccess) columns = p.per_sm;
  return err;
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
