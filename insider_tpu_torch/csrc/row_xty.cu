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
// Above K = 128 F no longer fits a thread's registers.  The first wide
// version (one column a thread, K in zero-padded tiles of 128, the mask read
// again for each tile, 48 blocks at 300 x 2048) was bound by its shared
// loads: a broadcast 16-byte load of R for every 4 FMAs.  Now two kernels:
// row_xty_wide builds the prediction in the register tiles of
// predict_tile.cuh (8 x 8 elements a lane, 64 x 128 a block; 16 x 32 where
// those would leave SMs idle), K summed whole in k-chunks of 16, each chunk
// from zero (one f32 chain over K failed the near-cancel gate at K = 300),
// so the mask is read once a call and K = 160 runs 160 coordinates, not
// 256; its blocks
// are row tiles, not groups of whole levels, so that a long level's rows
// spread over the card (two levels of ~190 rows at N = 377 gave 696 blocks
// of three row tiles each, a third of them left for a second wave), and
// each writes its levels' sums over its rows; row_xty_contract adds each
// level's sums in row-tile order, then S = D - T from the complete T (the
// cancellation fix), and contracts S with F by the narrow kernel's
// contract, a staged k-chunk of F at a time.  What bounds it now (PERF.md
// §6, row 1): the prediction's FMAs at two blocks an SM (the chunk sums'
// second set of accumulators), then the contraction at many levels (its
// prologue, each level's D and segments, and its staging of F not told
// apart from its FMAs, PERF.md §7).
#include "common.cuh"
#include "mma.cuh"
#include "predict_tile.cuh"

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

// out[l * K + k] = sum_c Ss[l][c] Fs[k][c] over the TW columns (shared rows
// of FST f32), for l < nl and k < kn <= NK, Fs holding NK rows of F: all KP
// of the narrow kernel's (kn = K), or a staged k-chunk of row_xty_contract's
// (out at its first coordinate).  Tiles of 4 levels x 4 coordinates; tpt
// adjacent lanes (a power of two, at most TPT) share a tile, each adding
// every tpt-th float4 of the columns, then an xor-shuffle tree adds their
// sums (both lanes of a pair add the same two values, so the result does
// not depend on the lane).  Every thread runs the same number of rounds, so
// the shuffles see full warps.
template <int NK, int TW, int FST, int TPT = 32>
__device__ void contract(const float* Ss, const float* Fs, int nl,
                         float* __restrict__ out, int K, int kn) {
  constexpr int NKT = NK / 4;
  const int tiles = ((nl + 3) / 4) * NKT;
  int tpt = TPT;
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
          if (4 * lt + a < nl && 4 * kt + b < kn)
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
    contract<KP, S::TW, FST>(Ss, Fs, nl,
                             partial + ((size_t)blockIdx.x * L + lb) * K, K,
                             K);
    __syncthreads();                      // Ss is rewritten by the next batch
    if (lb_next < l_hi) load_d(lb_next, nl_next);
    lb = lb_next;
    nl = nl_next;
  }
}

// K > 128: two kernels on the shared prediction tile (predict_tile.cuh).
// row_xty_wide: a block a row tile (TR of the rows sorted by level) x
// column tile; its mask rows land in shared memory during the k-loop, the
// epilogue forms m P from the accumulators, sums it over each lane's runs
// of four rows, and one thread a column walks the runs in row order,
// writing each level's sum over its rows in the tile (the level's segment
// in tile t) into row l + t of Tpart (rows sorted by level make l + t
// distinct for distinct segments).  row_xty_contract: a block a column
// range x batch of levels adds each level's segments in tile order -- its
// complete T --, forms S = D - T (the cancellation fix), and contracts S
// with F a staged k-chunk at a time by the narrow kernel's contract (at
// most 8 lanes a tile: few levels leave most tiles' lanes idle otherwise).
// row_xty_reduce adds the column ranges' partials.
constexpr int KT = 128;        // the narrow instances' largest rank
constexpr int CLB = 64;        // levels of a contraction block
constexpr int CKC = 32;        // its k-chunk: CLB / 4 x CKC / 4 = CT tiles
constexpr int CTPT = 8;        // its most lanes a tile
constexpr int CNS = 2;         // stages of its ring
constexpr int CFST = CT + 4;   // f32 stride of its shared rows

// The level of sorted position p: the last l with offsets[l] <= p.
__device__ int level_of(const int* __restrict__ offsets, int L, int p) {
  int lo = 0, hi = L;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (offsets[mid] <= p)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

// The w-th of the 16-byte aligned chunks that cover the bytes [src, src +
// n) into dst (16-byte aligned) by cp.async: from the chunk that holds src
// on, zero past src + n, nothing read where the chunk lies past it (n = 0:
// all zero).  The bytes before src in its chunk lie in the same 16-byte
// aligned block of the allocation.
__device__ __forceinline__ void copy_cover(void* dst, const void* src, int n,
                                           int w) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t at = (a & ~(uintptr_t)15) + 16 * (uintptr_t)w;
  const uintptr_t end = a + n;
  int len = 0;
  const void* from = reinterpret_cast<const void*>(a & ~(uintptr_t)15);
  if (n > 0 && at < end) {
    len = end - at < 16 ? (int)(end - at) : 16;
    from = reinterpret_cast<const void*>(at);
  }
  insider::cp_async16(dst, from, len);
}

// Bytes of a staged mask row of a tile TC wide: the 16-byte chunks that
// cover TC values from any offset.
template <class Tile, typename MaskT>
__host__ __device__ constexpr int mask_row_bytes() {
  return 16 * (Tile::TC * (int)sizeof(MaskT) / 16 + 1);
}

// Shared bytes of row_xty_wide: the tile's stages (Ps lies over them once
// the k-loop is done), then the row tile's mask rows.
template <class Tile, typename MaskT>
constexpr size_t wide_smem() {
  return sizeof(float) * Tile::floats +
         (size_t)Tile::TR * mask_row_bytes<Tile, MaskT>();
}

template <class Tile, typename MaskT>
__global__ void __launch_bounds__(Tile::NT, Tile::MIN_BLOCKS)
row_xty_wide(const int* __restrict__ order, const int* __restrict__ offsets,
             const int* __restrict__ level_end, const float* __restrict__ R,
             const MaskT* __restrict__ mask, const float* __restrict__ F,
             float* __restrict__ Tpart, int N, int M, int L, int K) {
  constexpr int TR = Tile::TR, TC = Tile::TC, PST = TC + 4;
  constexpr int LR = Tile::LR, LC = Tile::LC;
  constexpr int MB = mask_row_bytes<Tile, MaskT>(), CH = MB / 16;
  static_assert(Tile::NT == TC && TR * PST <= Tile::floats, "walker");
  extern __shared__ __align__(16) float smem_f[];
  float* Ps = smem_f;          // (TR, PST) m P, over the stages
  unsigned char* Ms =          // (TR, MB) the mask rows, each at moff[r]
      reinterpret_cast<unsigned char*>(smem_f + Tile::floats);
  __shared__ int rid[TR], ends[TR], moff[TR], last;

  const int tid = threadIdx.x, t = blockIdx.y, p0 = t * TR;
  const int rows = min(TR, N - p0), j0 = blockIdx.x * TC;
  const int jn = min(TC, M - j0);
  for (int r = tid; r < rows; r += Tile::NT) {
    const int i = order[p0 + r];
    rid[r] = i;
    ends[r] = level_end[p0 + r];
    moff[r] = (int)(reinterpret_cast<uintptr_t>(mask + (size_t)i * M + j0) &
                    15) / (int)sizeof(MaskT);
  }
  if (tid == 0) last = level_of(offsets, L, p0 + rows - 1);
  __syncthreads();
  const Tile tile(smem_f);
  float acc[LR][LC];
  // the mask rows land with the second k-chunk, in flight while the
  // first computes
  tile.predict(R, F, K, M, j0, rows, [&](int r) { return rid[r]; }, acc,
               [&](int c) {
                 if (c == 1)
                   for (int e = tid; e < rows * CH; e += Tile::NT) {
                     const int r = e / CH;
                     copy_cover(Ms + r * MB + 16 * (e - r * CH),
                                mask + (size_t)rid[r] * M + j0,
                                (int)sizeof(MaskT) * jn, e - r * CH);
                   }
               });
  __syncthreads();             // the stages under Ps are read
  // Each run of four rows of the thread (rows 4 u .. 4 u + 3): m P summed
  // in registers, in row order, written to Ps at each level's last row and
  // at the run's last row (or the tile's).
#pragma unroll
  for (int q = 0; q < LC; ++q) {
    const int c = Tile::col(q);
#pragma unroll
    for (int h = 0; h < LR / 4; ++h) {
      float run = 0.f;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = Tile::row(4 * h + x);
        if (r < rows) {
          const float m = static_cast<float>(reinterpret_cast<const MaskT*>(
              Ms + r * MB)[moff[r] + c]);
          run = fmaf(m, acc[4 * h + x][q], run);
          if (ends[r] >= 0 || x == 3 || r == rows - 1) {
            Ps[r * PST + c] = run;
            run = 0.f;
          }
        }
      }
    }
  }
  __syncthreads();
  // One thread a column walks the runs' sums in row order: T of each
  // level's segment in the tile.  Columns past M hold zeros (F's are 0).
  const int j = j0 + tid;
  if (j < M) {
    float T = 0.f;
    for (int r = 0; r < rows; ++r) {
      const int e = ends[r];
      if (e >= 0 || r % 4 == 3 || r == rows - 1) {
        T += Ps[r * PST + tid];
        if (e >= 0) {                // level e's last row
          Tpart[(size_t)(e + t) * M + j] = T;
          T = 0.f;
        }
      }
    }
    if (ends[rows - 1] < 0) Tpart[(size_t)(last + t) * M + j] = T;
  }
}

__global__ void __launch_bounds__(CT, 3)
row_xty_contract(const int* __restrict__ offsets, const float* __restrict__ D,
                 const float* __restrict__ F, const float* __restrict__ Tpart,
                 float* __restrict__ partial, int M, int L, int K, int TR) {
  extern __shared__ __align__(16) float smem_f[];
  float* Ss = smem_f;                  // (CLB, CFST) S
  float* Fs = Ss + CLB * CFST;         // CNS stages of (CKC, CFST) F
  __shared__ int offs[CLB + 1];        // the batch's level offsets
  const int tid = threadIdx.x, j0 = blockIdx.x * CT, j = j0 + tid;
  const int jc = min(j, M - 1);        // in-bounds loads
  const int lb = blockIdx.y * CLB, nl = min(CLB, L - lb);
  for (int l = tid; l <= nl; l += CT) offs[l] = offsets[lb + l];
  __syncthreads();
  // LG levels at a time: their D and first segments loaded at once, then
  // the rest of each level's segments (a level longer than a row tile) in
  // tile order
  constexpr int LG = 16;
  for (int l0 = 0; l0 < nl; l0 += LG) {
    float d[LG], T[LG];
#pragma unroll
    for (int u = 0; u < LG; ++u) {
      const int l = l0 + u;
      const int a = offs[min(l, nl)], b = offs[min(l + 1, nl)];
      d[u] = l < nl ? D[(size_t)(lb + l) * M + jc] : 0.f;
      T[u] = l < nl && a < b ? Tpart[(size_t)(lb + l + a / TR) * M + jc]
                             : 0.f;
    }
#pragma unroll
    for (int u = 0; u < LG; ++u) {
      const int l = l0 + u;
      if (l < nl) {
        const int a = offs[l], b = offs[l + 1];
        for (int t = a / TR + 1; t <= (b - 1) / TR; ++t)
          T[u] += Tpart[(size_t)(lb + l + t) * M + jc];
        // S = D - T from the complete T (the cancellation fix)
        Ss[l * CFST + tid] = j < M ? d[u] - T[u] : 0.f;
      }
    }
  }
  float* out = partial + ((size_t)blockIdx.x * L + lb) * K;
  insider::stage_ring<CNS>(
      (K + CKC - 1) / CKC,
      [&](int c, int s) {
        insider::stage_f_rows<CT, CFST, CT, CKC>(Fs + s * CKC * CFST, F, K,
                                                 M, j0, c);
      },
      [&](int c, int s) {
        contract<CKC, CT, CFST, CTPT>(Ss, Fs + s * CKC * CFST, nl,
                                      out + c * CKC, K, min(CKC, K - c * CKC));
      });
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

// Column tiles of the partials at rank K (a block's tile: CT threads of C
// columns each; above K = 128 the contraction's CT columns).
int column_tiles(int M, int K) {
  return ceil_div(M, K > KT ? CT
                            : CT * cols_per_thread(insider::padded_rank(K)));
}

// The grid of row_xty_wide: column tiles x row tiles.
template <class Tile>
dim3 wide_grid(int N, int M) {
  return dim3(ceil_div(M, Tile::TC), ceil_div(N, Tile::TR));
}

// f32 of Tpart past K = 128: a row of M for each level and each row tile
// after the first (l + t < L + row tiles - 1); 0 up to K = 128.
long segments(int N, int M, int L, int K) {
  if (K <= KT) return 0;
  return insider::with_tile(N, M, [&](auto tile) {
    using Tile = typename decltype(tile)::type;
    return (long)(L + wide_grid<Tile>(N, M).y - 1) * M;
  });
}

template <class Tile, typename MaskT>
cudaError_t launch_wide(const int* order, const int* offsets,
                        const int* level_end, const float* R,
                        const MaskT* mask, const float* D, const float* F,
                        float* Tpart, float* partial, int N, int M, int L,
                        int K, cudaStream_t stream) {
  constexpr size_t smem = wide_smem<Tile, MaskT>();
  auto kernel = row_xty_wide<Tile, MaskT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<wide_grid<Tile>(N, M), Tile::NT, smem, stream>>>(
      order, offsets, level_end, R, mask, F, Tpart, N, M, L, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t csmem = sizeof(float) * (CLB + CNS * CKC) * CFST;
  err = cudaFuncSetAttribute(row_xty_contract,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)csmem);
  if (err != cudaSuccess) return err;
  row_xty_contract<<<dim3(ceil_div(M, CT), ceil_div(L, CLB)), CT, csmem,
                     stream>>>(offsets, D, F, Tpart, partial, M, L, K,
                               Tile::TR);
  return cudaGetLastError();
}

}  // namespace

// Elements of f32 scratch that insider_row_xty needs.
INSIDER_API long insider_row_xty_scratch(int N, int M, int L, int K) {
  return segments(N, M, L, K) + (long)column_tiles(M, K) * L * K;
}

// Blocks of insider_row_xty's main kernel (past K = 128 row_xty_wide).
INSIDER_API long insider_row_xty_blocks(int N, int M, int K) {
  if (K <= KT) return (long)column_tiles(M, K) * ceil_div(N, G);
  return insider::with_tile(N, M, [&](auto tile) {
    const dim3 g = wide_grid<typename decltype(tile)::type>(N, M);
    return (long)g.x * g.y;
  });
}

// out (L, K) = (D - E^T (mask .* (R_minus F))) F^T.  order (N,) int32: the
// rows sorted by level; offsets (L + 1,) int32: level l's rows are
// order[offsets[l] : offsets[l + 1]]; level_end (N,) int32: l where sorted
// position p is the last row of level l, else -1 (kernels/row.level_order).
// R_minus (N, K), D (L, M), F (K, M): row-major f32; mask (N, M)
// row-major, f32 or uint8 (mask_is_u8 != 0); K >= 1.
INSIDER_API int insider_row_xty(const int* order, const int* offsets,
                                const int* level_end,
                                const float* R, const void* mask,
                                int mask_is_u8,
                                const float* D, const float* F, float* out,
                                float* scratch, long scratch_len, int N, int M,
                                int L, int K, cudaStream_t stream) {
  const int KP = K > KT ? KT : insider::padded_rank(K);
  if (KP == 0 || N < 1 || M < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const int tiles = column_tiles(M, K);
  const long seg = segments(N, M, L, K);
  if (scratch_len < seg + (long)tiles * L * K)
    return (int)cudaErrorInvalidValue;
  float* partial = scratch + seg;
  cudaError_t err;
  if (K > KT) {
    err = insider::with_mask(mask, mask_is_u8, [&](auto m) {
      return insider::with_tile(N, M, [&](auto tile) {
        return launch_wide<typename decltype(tile)::type>(
            order, offsets, level_end, R, m, D, F, scratch, partial, N, M, L,
            K, stream);
      });
    });
  } else switch (KP) {
#define INSIDER_ROW_XTY_CASE(P)                                            \
  case P:                                                                  \
    err = launch<P>(order, offsets, level_end, R, mask, mask_is_u8, D, F,  \
                    partial, N, M, L, K, stream);                          \
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
      partial, out, tiles, n, ob);
  return (int)cudaGetLastError();
}
