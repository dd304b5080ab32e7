// row_xty: the right-hand sides of one confounder's level ridge solves.
//
// Replaces insider_tpu/kernels/row_pallas.py:row_xty_pallas (body
// _xty_kernel) and its large-N variant row_xty_chunked_pallas
// (_xty_chunked_kernel); row_xty_auto picks between the two only because of
// the TPU's VMEM cap.  Both compute
//     out[l, k] = sum_j (D[l, j] - T[l, j]) * F[k, j],
//     T[l, j]   = sum_{i : code_i = l} mask[i, j] * (R_minus[i, :] . F[:, j]),
// with the prediction R_minus . F existing only on chip.  E is one-hot by
// construction (insider_tpu/train/als.py:371), so this kernel takes the rows
// sorted by level in its place (kernels/row.level_order: `order`, each
// level's first position `offsets`, and the level each sorted position
// ends, `level_end`): E^T x is a sum over the rows of each level.
//
// Cancellation: S = D - T is formed per column, from the COMPLETE T of that
// column, before the contraction with F (row_pallas.py:157-162).  The form
// D.F^T - T.F^T loses the small residual sums to cancellation.
//
// Bound on the H100: reading mask (N x M f32, 67 MB at the flagship shape;
// uint8, 17 MB) and D (L x M) once, at 3.35 TB/s; the prediction's N*M*K
// FMAs (0.4 GFMA, 0.012 ms at 67 TFLOP/s f32) come second.  The first
// version was bound by neither: it read R and F from shared memory for every
// FMA, did a shared read-modify-write of T per element, and walked all N
// rows per column tile with one mask load in flight.
// Design:
//   * a block owns a tile of CT x C columns (C a thread) and a group of
//     WHOLE levels: the rows sorted by level are cut into groups of about G
//     rows, and a level belongs to the group its first row falls in.  T of
//     each (level, column) is therefore complete inside one block, so the
//     cancellation fix holds while the rows are split across blocks, and the
//     grid is column tiles x groups for any number of levels;
//   * the thread's columns of F live in registers and each row of R comes
//     as broadcast 16-byte shared loads, each feeding 4 C FMAs (such a load
//     costs the shared memory as much as 16 distinct bytes a lane, so at
//     C = 1 the shared loads, not the FMAs, would bound the prediction);
//     T accumulates in registers;
//   * the rows of R and the row order are staged a chunk ahead through
//     registers, and two register sets of U mask rows load in turn, one
//     set in flight while the other computes;
//   * the levels of a group go in batches of LB: the batch's D lands in a
//     shared S tile by cp.async as the batch starts, each level's flush
//     forms S = D - T there, and the batch's contraction with F is a
//     register-tiled product (4 levels x 4 coordinates a thread, float4
//     shared loads, one per eight FMAs), the threads of a tile added by a
//     fixed xor-shuffle tree;
//   * each block writes its levels' rows of its column tile's (L, K)
//     partial; a second pass adds the column tiles in a fixed order (no
//     atomics, so repeated runs agree bit for bit).
// Global loads are scalar and coalesced (a row of mask starts at any
// element: M need not be a multiple of 4), the ragged column edge is
// guarded, not padded.  The mask is f32 or uint8 (a template parameter, the
// memory-lean storage of a quarter of the bytes): each value is widened to
// f32 as it is loaded, exactly, so both give the same bits.  What bounds it
// now (PERF.md §6, row 1): the prediction's FMAs and the mask reads each take
// about as long as a block's serial chain of staging, batch and contraction
// steps, at two blocks (8 warps) an SM, which the register columns of F and
// the shared tiles set.
#include "common.cuh"
#include "mma.cuh"

namespace {

using insider::ceil_div;

constexpr int CT = 128;        // threads per block
constexpr int G = 128;         // rows per level group

// Columns a thread at padded rank KP: four while their F fits the
// registers (KP <= 32), then two, then one.
__host__ __device__ constexpr int cols_per_thread(int KP) {
  return KP <= 32 ? 4 : (KP <= 64 ? 2 : 1);
}

// At padded rank KP: C columns a thread, a block's tile of TW columns, the
// row stride of the (., TW) shared tiles, LB levels a batch, U mask rows a
// register set (two sets in turn), and the rows staged per chunk (at most
// 16 staging registers a thread).
template <int KP>
struct Shape {
  static constexpr int C = cols_per_thread(KP);
  static constexpr int TW = CT * C;
  static constexpr int FST = TW + 4;
  static constexpr int LB = C == 1 ? 32 : 16;
  static constexpr int U = C == 4 ? 4 : 8;
  static constexpr int RCH = KP <= 32 ? 64 : (KP <= 64 ? 32 : 16);
  static constexpr size_t smem =
      sizeof(float) * ((size_t)KP * FST + (size_t)LB * FST + (size_t)RCH * KP) +
      sizeof(int) * 2 * RCH;
};

// The levels of group g: level l belongs to group min(offsets[l] / G, NG -
// 1), nondecreasing in l, so group g's levels are [lo, hi), where lo is the
// first level whose group is >= g (L if none) and hi the same for g + 1.
// Every thread tests its share of the levels for those two boundaries at
// once (one round trip of loads), and the one that finds a boundary writes
// it; the result is in range[0..1] after the call (which syncs the block).
__device__ void group_levels(const int* __restrict__ offsets, int L, int NG,
                             int g, int* range) {
  if (threadIdx.x == 0) range[0] = range[1] = L;
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const int here = min(offsets[l] / G, NG - 1);
    const int before = l > 0 ? min(offsets[l - 1] / G, NG - 1) : -1;
    if (before < g && here >= g) range[0] = l;
    if (before < g + 1 && here >= g + 1) range[1] = l;
  }
  __syncthreads();
}

// out[l * K + k] = sum_c Ss[l][c] Fs[k][c] over the TW columns, for l < nl,
// k < K.  Tiles of 4 levels x 4 coordinates; tpt adjacent lanes (a power of
// two) share a tile, each adding every tpt-th float4 of the columns, then
// an xor-shuffle tree adds their sums (both lanes of a pair add the same two
// values, so the result does not depend on the lane).  Every thread runs the
// same number of rounds, so the shuffles see full warps.
template <int KP>
__device__ void contract(const float* Ss, const float* Fs, int nl,
                         float* __restrict__ out, int K) {
  constexpr int NKT = KP / 4, TW = Shape<KP>::TW, FST = Shape<KP>::FST;
  const int tiles = ((nl + 3) / 4) * NKT;
  int tpt = 32;
  while (tpt > 1 && tpt * tiles > CT) tpt >>= 1;
  const int q = threadIdx.x % tpt;
  const int slots = CT / tpt;
  for (int base = 0; base < tiles; base += slots) {
    const int t = base + (int)threadIdx.x / tpt;
    const bool act = t < tiles;
    const int lt = act ? t / NKT : 0, kt = act ? t % NKT : 0;
    const float* srow[4];
    const float* frow[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      srow[a] = Ss + min(4 * lt + a, nl - 1) * FST;
      frow[a] = Fs + (4 * kt + a) * FST;
    }
    float acc[4][4] = {};
    for (int c = 4 * q; c < TW; c += 4 * tpt) {
      float4 s[4], f[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        s[a] = *reinterpret_cast<const float4*>(srow[a] + c);
        f[a] = *reinterpret_cast<const float4*>(frow[a] + c);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          float v = acc[a][b];
          v = fmaf(s[a].x, f[b].x, v);
          v = fmaf(s[a].y, f[b].y, v);
          v = fmaf(s[a].z, f[b].z, v);
          v = fmaf(s[a].w, f[b].w, v);
          acc[a][b] = v;
        }
    }
    for (int off = tpt / 2; off > 0; off >>= 1)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          acc[a][b] += __shfl_xor_sync(0xffffffffu, acc[a][b], off);
    if (act && q == 0)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (4 * lt + a < nl && 4 * kt + b < K)
            out[(4 * lt + a) * K + 4 * kt + b] = acc[a][b];
  }
}

template <int KP, typename MaskT>
__global__ void __launch_bounds__(CT)
row_xty_partial(const int* __restrict__ order, const int* __restrict__ offsets,
                const int* __restrict__ level_end, const float* __restrict__ R,
                const MaskT* __restrict__ mask, const float* __restrict__ D,
                const float* __restrict__ F, float* __restrict__ partial,
                int M, int L, int K, int NG) {
  using S = Shape<KP>;
  constexpr int C = S::C, FST = S::FST, LB = S::LB, U = S::U, RCH = S::RCH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Fs = reinterpret_cast<float*>(smem_raw);      // (KP, FST)
  float* Ss = Fs + KP * FST;                           // (LB, FST)
  float* Rs = Ss + LB * FST;                           // (RCH, KP)
  int* rid = reinterpret_cast<int*>(Rs + RCH * KP);    // (RCH,) row index
  int* ends = rid + RCH;         // (RCH,) the batch level ending at the row, or -1

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * S::TW + tid;    // columns j0 + c * CT
  int jc[C];                                  // in-bounds loads; results unused
#pragma unroll
  for (int c = 0; c < C; ++c) jc[c] = min(j0 + c * CT, M - 1);
  float f[C][KP];
  insider::load_columns<KP, C, CT>(F, M, K, j0, f);
  __shared__ int range[2];
  group_levels(offsets, L, NG, blockIdx.y, range);
  const int l_lo = range[0], l_hi = range[1];
  if (l_lo == l_hi) return;               // no level starts in this group
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < KP; ++k) Fs[k * FST + c * CT + tid] = f[c][k];

  // A batch's D goes into Ss by cp.async as the batch starts (each thread
  // copies and later reads only its own columns); each flush then forms
  // S = D - T of its level in place.  Columns past M are zero-filled, and
  // their T is 0 (their F is 0), so their S is 0.
  auto load_d = [&](int lb, int nl) {
    for (int l = 0; l < nl; ++l)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const bool ok = j0 + c * CT < M;
        insider::cp_async4(Ss + l * FST + c * CT + tid,
                           D + (ok ? (size_t)(lb + l) * M + j0 + c * CT : 0),
                           ok);
      }
    insider::cp_async_commit();
  };
  // A chunk's rows of R, and for thread t < rows the chunk's row t and the
  // batch level it ends (or -1), fetched into registers a chunk ahead of use
  // (the next batch's first chunk while this batch contracts).
  insider::RowStage<KP, RCH, CT> stage;
  int next_row = 0, next_end = -1;
  auto fetch = [&](int r0, int r_end, int lb) {
    const int rows = min(RCH, r_end - r0);
    stage.load(R, K, rows, [&](int r) { return order[r0 + r]; });
    if (tid < rows) {
      next_row = order[r0 + tid];
      const int e = level_end[r0 + tid];
      next_end = e >= 0 ? e - lb : -1;
    }
  };
  int lb = l_lo, nl = min(LB, l_hi - lb);
  load_d(lb, nl);
  if (offsets[lb] < offsets[lb + nl]) fetch(offsets[lb], offsets[lb + nl], lb);
  while (lb < l_hi) {
    const int r_begin = offsets[lb], r_end = offsets[lb + nl];
    float T[C];
#pragma unroll
    for (int c = 0; c < C; ++c) T[c] = 0.f;
    for (int r0 = r_begin; r0 < r_end; r0 += RCH) {
      const int rows = min(RCH, r_end - r0);
      __syncthreads();                    // the previous chunk is consumed
      stage.store(Rs, rows);
      if (tid < rows) {
        rid[tid] = next_row;
        ends[tid] = next_end;
      }
      __syncthreads();
      if (r0 + RCH < r_end) fetch(r0 + RCH, r_end, lb);
      insider::cp_async_wait<0>();        // this batch's D has landed
      // two register sets of U mask rows in turn: one set's loads are in
      // flight while the other set's rows compute
      float m0[U][C], m1[U][C];
      auto load_mask = [&](int u0, float (&ms)[U][C]) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const size_t row = (size_t)rid[min(u0 + u, rows - 1)] * M;
#pragma unroll
          for (int c = 0; c < C; ++c)
            ms[u][c] = static_cast<float>(mask[row + jc[c]]);
        }
      };
      auto consume = [&](int u0, const float (&ms)[U][C]) {
        float p[U][C];
#pragma unroll
        for (int u = 0; u < U; ++u)
          insider::dot_row<KP, C>(Rs + min(u0 + u, rows - 1) * KP, f, p[u]);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (u0 + u < rows) {
#pragma unroll
            for (int c = 0; c < C; ++c) T[c] = fmaf(ms[u][c], p[u][c], T[c]);
            const int e = ends[u0 + u];
            if (e >= 0) {
              // S = D - T from the complete T (the cancellation fix)
#pragma unroll
              for (int c = 0; c < C; ++c) {
                Ss[e * FST + c * CT + tid] -= T[c];
                T[c] = 0.f;
              }
            }
          }
        }
      };
      load_mask(0, m0);
      for (int u0 = 0; u0 < rows; u0 += 2 * U) {
        load_mask(u0 + U, m1);
        consume(u0, m0);
        load_mask(u0 + 2 * U, m0);
        consume(u0 + U, m1);
      }
    }
    insider::cp_async_wait<0>();          // a batch without rows: S = D
    __syncthreads();
    const int lb_next = lb + nl, nl_next = min(LB, l_hi - lb_next);
    if (lb_next < l_hi && offsets[lb_next] < offsets[lb_next + nl_next])
      fetch(offsets[lb_next], offsets[lb_next + nl_next], lb_next);
    contract<KP>(Ss, Fs, nl, partial + ((size_t)blockIdx.x * L + lb) * K, K);
    __syncthreads();                      // Ss is rewritten by the next batch
    if (lb_next < l_hi) load_d(lb_next, nl_next);
    lb = lb_next;
    nl = nl_next;
  }
}

__global__ void __launch_bounds__(insider::SPLIT_THREADS)
row_xty_reduce(const float* __restrict__ part, float* __restrict__ out,
               int n_parts, int n, int ob) {
  insider::reduce_split<float>(part, out, n_parts, n, ob);
}

template <int KP, typename MaskT>
cudaError_t launch_as(const int* order, const int* offsets,
                      const int* level_end, const float* R, const MaskT* mask,
                      const float* D, const float* F, float* scratch, int N,
                      int M, int L, int K, cudaStream_t stream) {
  const size_t smem = Shape<KP>::smem;
  cudaError_t err = cudaFuncSetAttribute(
      row_xty_partial<KP, MaskT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int NG = ceil_div(N, G);
  row_xty_partial<KP, MaskT>
      <<<dim3(ceil_div(M, Shape<KP>::TW), NG), CT, smem, stream>>>(
      order, offsets, level_end, R, mask, D, F, scratch, M, L, K, NG);
  return cudaGetLastError();
}

template <int KP>
cudaError_t launch(const int* order, const int* offsets, const int* level_end,
                   const float* R, const void* mask, int mask_is_u8,
                   const float* D, const float* F, float* scratch, int N,
                   int M, int L, int K, cudaStream_t stream) {
  return insider::with_mask(mask, mask_is_u8, [&](auto m) {
    return launch_as<KP>(order, offsets, level_end, R, m, D, F, scratch, N,
                         M, L, K, stream);
  });
}

// Column tiles of one launch at rank K (a block's tile: CT threads of C
// columns each).
int column_tiles(int M, int K) {
  return ceil_div(M, CT * cols_per_thread(insider::padded_rank(K)));
}

}  // namespace

// Elements of f32 scratch that insider_row_xty needs.
INSIDER_API long insider_row_xty_scratch(int M, int L, int K) {
  return (long)column_tiles(M, K) * L * K;
}

// out (L, K) = (D - E^T (mask .* (R_minus F))) F^T.  order (N,) int32: the
// rows sorted by level; offsets (L + 1,) int32: level l's rows are
// order[offsets[l] : offsets[l + 1]]; level_end (N,) int32: l where sorted
// position p is the last row of level l, else -1 (kernels/row.level_order).
// R_minus (N, K), D (L, M), F (K, M): row-major f32; mask (N, M)
// row-major, f32 or uint8 (mask_is_u8 != 0); 1 <= K <= 128.
INSIDER_API int insider_row_xty(const int* order, const int* offsets,
                                const int* level_end,
                                const float* R, const void* mask,
                                int mask_is_u8,
                                const float* D, const float* F, float* out,
                                float* scratch, long scratch_len, int N, int M,
                                int L, int K, cudaStream_t stream) {
  const int KP = insider::padded_rank(K);
  if (KP == 0 || N < 1 || M < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const int tiles = column_tiles(M, K);
  if (scratch_len < (long)tiles * L * K) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (KP) {
#define INSIDER_ROW_XTY_CASE(P)                                            \
  case P:                                                                  \
    err = launch<P>(order, offsets, level_end, R, mask, mask_is_u8, D, F,  \
                    scratch, N, M, L, K, stream);                          \
    break;
    INSIDER_ROW_XTY_CASE(8) INSIDER_ROW_XTY_CASE(16) INSIDER_ROW_XTY_CASE(24)
    INSIDER_ROW_XTY_CASE(32) INSIDER_ROW_XTY_CASE(40) INSIDER_ROW_XTY_CASE(48)
    INSIDER_ROW_XTY_CASE(56) INSIDER_ROW_XTY_CASE(64) INSIDER_ROW_XTY_CASE(72)
    INSIDER_ROW_XTY_CASE(80) INSIDER_ROW_XTY_CASE(88) INSIDER_ROW_XTY_CASE(96)
    INSIDER_ROW_XTY_CASE(104) INSIDER_ROW_XTY_CASE(112)
    INSIDER_ROW_XTY_CASE(120) INSIDER_ROW_XTY_CASE(128)
#undef INSIDER_ROW_XTY_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int n = L * K, ob = insider::split_outputs(n);
  row_xty_reduce<<<ceil_div(n, ob), insider::SPLIT_THREADS, 0, stream>>>(
      scratch, out, tiles, n, ob);
  return (int)cudaGetLastError();
}
