// The prediction tile of the row kernels past K = 128 (row_xty_wide in
// row_xty.cu, masked_eval_wide in masked_eval.cu): P = R[rows] . F[:, j0 :
// j0 + TC] for TR rows and TC columns, built in registers.
//
// A block has WR x WC warps; a warp owns 4 RT rows and 8 CT columns of the
// tile, its lanes 4 row groups x 8 column groups, and lane (g, c) the RT x
// CT elements at the rows 16 h + 4 g + x (h < RT / 4, x < 4) and the
// columns 32 h + 4 c + x (h < CT / 4) of the warp's.  The K coordinates go
// in chunks of KC through a ring of NS stages in shared memory, NS - 1
// chunks in flight:
//   * F's KC rows of the tile's columns by 4-byte cp.async, aligned in
//     shared memory (a row of F starts at any element), zero past the
//     valid columns and past K;
//   * Rᵀ's KC rows of the tile's rows by 4-byte cp.async, gathered (row_of:
//     the sorted rows of row_xty, the consecutive ones of masked_eval) and
//     stored transposed, zero past the rows and past K.
// A k-step reads RT / 4 + CT / 4 16-byte shared loads for RT CT FMAs: at
// RT = CT = 8, 64 FMAs for four loads, each of them one pass of the
// shared memory (the R loads are 4 distinct 16-byte words a warp, the F
// loads 8 consecutive ones).  The first wide version read a broadcast
// 16-byte load of R for every 4 FMAs of its one column a thread.  Each
// element's sum is blocked by chunk: a chunk's KC products are one fmaf
// chain from zero (the chunks' zero padding adds +0), and the chunks' sums
// are added into the element in order, so P does not depend on the tile's
// shape.  One fmaf chain over all K coordinates rounds a running sum as
// large as P at every step: at K = 300 its error took row_xty's near-cancel
// gate (the residual D - T is ~1e-3 of T) to twice its limit, and to 0.95
// of it at K = 161, while the blocked sum's error grows with KC + K / KC
// steps, not K.  The chunk sums
// cost a second set of accumulators: 2 x 64 registers a lane of the large
// tile, so two of its blocks an SM, not three.
// K is summed whole inside the block: a caller reads its mask, data or D
// once a call.  A warp whose rows all lie past the tile's rows skips the
// FMAs (the last row tile may hold a few rows), leaving the SM's pipes to
// the other warps.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace insider {
namespace {

constexpr int TILE_KC = 16;     // coordinates a chunk
constexpr int TILE_NS = 3;      // stages in a ring

// The ring over chunks 0 .. nc - 1 of a block's staged operand, NS - 1 of
// them in flight.  issue(c, s) issues chunk c's copies into stage s;
// consume(c, s) reads chunk c from stage s.  One committed group a chunk
// (empty past the last), so waiting for all but the NS - 2 newest means
// chunk c has landed; one barrier a chunk, after which chunk c - 1's
// stage, read by every thread, takes chunk c + NS - 1.  Begins with a
// barrier (the stages may still be read by the caller's previous use).
template <int NS, class Issue, class Consume>
__device__ __forceinline__ void stage_ring(int nc, Issue issue,
                                           Consume consume) {
  __syncthreads();
#pragma unroll
  for (int c = 0; c < NS - 1; ++c) {
    if (c < nc) issue(c, c);
    cp_async_commit();
  }
  for (int c = 0; c < nc; ++c) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    const int n = c + NS - 1;
    if (n < nc) issue(n, n % NS);
    cp_async_commit();
    consume(c, c % NS);
  }
}

// F's rows c KC .. c KC + KC - 1, columns j0 .. j0 + TC - 1, into dst
// (KC rows of FST f32) by the NT threads' 4-byte copies, zero past K and
// past M: neighbouring threads copy neighbouring columns.
template <int TC, int FST, int NT, int KC>
__device__ __forceinline__ void stage_f_rows(float* dst,
                                             const float* __restrict__ F,
                                             int K, int M, int j0, int c) {
  static_assert((TC * KC) % NT == 0, "F chunk");
#pragma unroll
  for (int i = 0; i < TC * KC / NT; ++i) {
    const int e = threadIdx.x + i * NT, kk = e / TC, col = e % TC;
    const int k = c * KC + kk;
    const bool ok = k < K && j0 + col < M;
    cp_async4(dst + kk * FST + col, ok ? F + ((size_t)k * M + j0 + col) : F,
              ok);
  }
}

template <int WR, int WC, int RT, int CT>
struct PredictTile {
  static constexpr int WARPS = WR * WC;
  static constexpr int NT = 32 * WARPS;     // threads
  static constexpr int TR = WR * 4 * RT;    // rows of the tile
  static constexpr int TC = WC * 8 * CT;    // columns of the tile
  static constexpr int LR = RT, LC = CT;    // a lane's rows and columns
  static constexpr int KC = TILE_KC, NS = TILE_NS;
  static constexpr int RST = TR + 4;        // f32 stride of a k-row of Rᵀ
  static constexpr int FST = TC + 4;        // of a k-row of F
  static constexpr int STAGE = KC * (RST + FST);   // f32 a stage
  static constexpr int floats = NS * STAGE;        // shared f32
  static constexpr int RPT = TR * KC / NT;   // R elements a thread copies
  // blocks an SM that its kernels' registers must allow (the large tile's
  // 2 x 64 accumulators a lane leave room for two)
  static constexpr int MIN_BLOCKS = 256 / NT;
  static_assert(RT % 4 == 0 && CT % 4 == 0 && (TR * KC) % NT == 0,
                "tile shape");

  float* smem;      // NS stages: [KC][RST] of Rᵀ, then [KC][FST] of F

  __device__ explicit PredictTile(float* smem_) : smem(smem_) {}

  __device__ float* rs(int s) const { return smem + s * STAGE; }
  __device__ float* fs(int s) const { return smem + s * STAGE + KC * RST; }

  // The tile row of the thread's accumulator row i, and the tile column of
  // its accumulator column q.
  __device__ static int row(int i) {
    const int w = threadIdx.x / 32, g = threadIdx.x % 32 / 8;
    return w / WC * 4 * RT + i / 4 * 16 + 4 * g + i % 4;
  }
  __device__ static int col(int q) {
    const int w = threadIdx.x / 32, c = threadIdx.x % 8;
    return w % WC * 8 * CT + q / 4 * 32 + 4 * c + q % 4;
  }

  // Rᵀ's chunk c into stage s by 4-byte copies, transposed: element e =
  // threadIdx.x + q NT is row e / KC, coordinate c KC + e % KC
  // (neighbouring threads read along a row of R); zero past the rows
  // (rrow[q] < 0) and past K.
  __device__ void stage_r(const float* __restrict__ R, int K,
                          const int (&rrow)[RPT], int c, int s) const {
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int e = threadIdx.x + q * NT, k = c * KC + e % KC;
      const bool ok = rrow[q] >= 0 && k < K;
      cp_async4(rs(s) + (e % KC) * RST + e / KC,
                ok ? R + (size_t)rrow[q] * K + k : R, ok);
    }
  }

  // acc += the products of stage s's coordinates below kn (in groups of
  // four; the staged zeros past K add +0), summed from zero first, for a
  // warp that holds any of the tile's `rows` rows.
  __device__ void fma_chunk(int s, int kn, int rows,
                            float (&acc)[RT][CT]) const {
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (w / WC * 4 * RT >= rows) return;
    const float* r4 = rs(s) + w / WC * 4 * RT + 4 * (lane / 8);
    const float* f4 = fs(s) + w % WC * 8 * CT + 4 * (lane % 8);
    float part[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int q = 0; q < CT; ++q) part[i][q] = 0.f;
#pragma unroll
    for (int k4 = 0; k4 < KC; k4 += 4) {
      if (k4 < kn) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int kk = k4 + x;
          float r[RT], f[CT];
#pragma unroll
          for (int h = 0; h < RT / 4; ++h) {
            const float4 v =
                *reinterpret_cast<const float4*>(r4 + kk * RST + 16 * h);
            r[4 * h] = v.x;
            r[4 * h + 1] = v.y;
            r[4 * h + 2] = v.z;
            r[4 * h + 3] = v.w;
          }
#pragma unroll
          for (int h = 0; h < CT / 4; ++h) {
            const float4 v =
                *reinterpret_cast<const float4*>(f4 + kk * FST + 32 * h);
            f[4 * h] = v.x;
            f[4 * h + 1] = v.y;
            f[4 * h + 2] = v.z;
            f[4 * h + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int q = 0; q < CT; ++q)
              part[i][q] = fmaf(r[i], f[q], part[i][q]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int q = 0; q < CT; ++q) acc[i][q] += part[i][q];
  }

  // acc[i][q] = P[row(i)][col(q)] for the tile's `rows` rows (row_of maps
  // a tile row to its row of R; rows past `rows` give 0) and the columns
  // from j0 (past M: 0).  row_of's data must be visible to every thread.
  // side(c) issues the caller's own copies with chunk c's (they have landed
  // and are visible to the block once chunk c is consumed).
  template <class RowOf, class Side>
  __device__ void predict(const float* __restrict__ R,
                          const float* __restrict__ F, int K, int M, int j0,
                          int rows, RowOf row_of, float (&acc)[RT][CT],
                          Side side) const {
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int q = 0; q < CT; ++q) acc[i][q] = 0.f;
    int rrow[RPT];      // the rows of R this thread copies from, or -1
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int r = (threadIdx.x + q * NT) / KC;
      rrow[q] = r < rows ? row_of(r) : -1;
    }
    stage_ring<NS>(
        (K + KC - 1) / KC,
        [&](int c, int s) {
          stage_f_rows<TC, FST, NT, KC>(fs(s), F, K, M, j0, c);
          stage_r(R, K, rrow, c, s);
          side(c);
        },
        [&](int c, int s) { fma_chunk(s, min(KC, K - c * KC), rows, acc); });
  }
  template <class RowOf>
  __device__ void predict(const float* __restrict__ R,
                          const float* __restrict__ F, int K, int M, int j0,
                          int rows, RowOf row_of, float (&acc)[RT][CT]) const {
    predict(R, F, K, M, j0, rows, row_of, acc, [](int) {});
  }
};

// The two tiles of both kernels: 2 x 2 warps of 8 x 8 elements a lane (64
// x 128, 128 threads), or one warp of 4 x 4 a lane (16 x 32) where the
// large tiles would not give each of the H100's 132 SMs a block.  The
// choice is a constant of the shapes, not the card's count, so that the
// order of the kernels' sums depends on the shapes alone.
using LargeTile = PredictTile<2, 2, 8, 8>;
using SmallTile = PredictTile<1, 1, 4, 4>;

inline bool large_tile(int N, int M) {
  return (long)ceil_div(N, LargeTile::TR) * ceil_div(M, LargeTile::TC) >= 132;
}

template <class T>
struct TileOf {
  using type = T;
};

// Calls f with TileOf<the tile of an N x M launch>.
template <class Fn>
auto with_tile(int N, int M, Fn&& f) {
  return large_tile(N, M) ? f(TileOf<LargeTile>{}) : f(TileOf<SmallTile>{});
}

}  // namespace
}  // namespace insider
