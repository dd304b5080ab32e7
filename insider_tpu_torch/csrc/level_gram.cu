// level_gram: per-level masked K x K grams of the row update.
//
// Replaces insider_tpu/kernels/row_pallas.py:level_gram_pallas (body
// _gram_kernel), which computes, at precision HIGHEST,
//     out[l, k1, k2] = sum_j Mw[l, j] * (F[k1, j] * F[k2, j])
// for every level l of every confounder (Mw: (sum L, M) per-level mask
// counts, F: (K, M)), building the F outer-product table per column block
// so the (K^2, M) table never exists in device memory.
//
// Bound on the H100: the tensor cores.  At the flagship shape (sum L = 133,
// K = 24, M = 44477) the K (K + 1) / 2 = 300 symmetric pairs need 1.78
// GFMA; split exactly into bf16 planes (2 for the counts below 65536, 3 for
// the table) that is 10.7 G bf16 FMA, 0.022 ms at 989 TFLOP/s (16.0 G with
// a third count plane), against 0.053 ms for the f32 sum on the CUDA cores
// and 0.008 ms to read the 28 MB of Mw and F.
//
// Design: a GEMM C (pairs x levels) = table (pairs x M) . Mw^T (M x levels)
// on mma.sync m16n8k16 (bf16 in, f32 accumulate) over the upper triangle
// k1 <= k2 only, mirrored as it is written.  The counts split into exact
// bf16 planes (csrc/mma.cuh): two below 65536 (split_count2), three below
// 2^24, f32's exact integer range (split_count), so any N; the caller gives
// the largest count, and the kernel is a template on the number of count
// planes CP.  The table splits into three (split3).  Each k-step's 3 CP
// plane products start from zero, smallest first, and are added into the
// running sums in f32 (mma_bf16_zero): the f32 sum up to its order.  A
// block owns 64 pairs (4 m-tiles of 16), up to 144 levels and one range of
// columns.  Warp w owns m-tile w % 4 and every other n-tile
// of 8 levels, their number a template constant (straight-line MMA code),
// so the flagship's 133 levels pad to 144 and K = 50's 37 to 48.  The
// columns go in 32-column steps, software-pipelined: while the MMAs of step
// c run from one buffer of bf16 planes in shared memory (ldmatrix
// fragments), the block builds the planes of step c + 1 in the other -- the
// count planes from Mw loaded into registers a step ahead (coalesced; rows
// of Mw are not 16-byte aligned at odd M), the table planes from rows of F
// staged by cp.async, each pair product once -- with one barrier per step.
// The reduction over M is split across gridDim.z column ranges to fill the
// card; each range writes its own partial and a second pass adds them in
// fixed order (no atomics: repeated runs agree bit for bit).
//
// Two instances of the same sums, which differ in the pairs of a block,
// the rows of F it stages and how it writes its sums:
//   * narrow, K <= NARROW_K: a block owns 64 consecutive pairs of the
//     triangle and stages all K rows of F a step, 4 bytes a copy (the
//     ring: 2 x K x 32 f32); one wave of blocks, as many column ranges as
//     the card holds blocks beside the pair and level tiles; each range
//     writes an upper-triangle partial, which level_gram_reduce adds and
//     mirrors;
//   * wide, K > NARROW_K (level_gram_wide): a block owns a tile of the
//     triangle, k1 in [a, a + 8) x k2 in [b, b + 8) with b >= a (on a
//     diagonal tile the pairs with k1 > k2 read zero planes and are not
//     written), and stages only its 16 rows of F a step, as the 16-byte
//     aligned chunks that cover them (rows of F are not 16-byte aligned at
//     odd M) in a ring of three steps, each table entry rounded to f32
//     (__fmul_rn) before its split; a warp runs three n-tiles' MMA chains
//     interleaved; the column ranges are chosen so that the blocks come
//     closest to whole waves, and a block writes its tile through shared
//     memory in 8-float rows: both triangles into the grams themselves
//     where there is one range, else the upper triangle into its range's
//     packed partial, which level_gram_reduce adds and mirrors as for the
//     narrow instance.  No shared memory grows with K (at most 104 KB a
//     block: two blocks an SM); K is bounded by the pairs' 16-bit packing
//     (K < 32768) and by the bytes of the grams and partials (L K^2 f32,
//     and L K (K + 1) / 2 for each column range past one).
#include "common.cuh"
#include "mma.cuh"

namespace {

using insider::ceil_div;
using insider::cp_async16;
using insider::cp_async4;
using insider::cp_async_commit;
using insider::cp_async_wait;
using insider::ldmatrix_x2;
using insider::ldmatrix_x4;
using insider::mma_bf16;
using insider::mma_bf16_zero;
using insider::pair_of;
using insider::split3;
using insider::split_count;
using insider::split_count2;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int PT = 64;       // pairs per block: 4 m-tiles of 16
constexpr int LBMAX = 144;   // levels per block at most: 18 n-tiles of 8
constexpr int JC = 32;       // columns per pipeline step: two k-steps of 16
constexpr int PS = JC + 8;   // bf16 row stride of the planes (80 bytes:
                             // ldmatrix rows fall in distinct banks)
constexpr int MWP = LBMAX * JC / 2 / THREADS;   // Mw pairs per thread a step
constexpr int NARROW_K = 128;    // the largest K of the narrow instance

// Shared bytes at NTW n-tiles per warp (two warps share an m-tile, so a
// block covers 16 NTW count rows) and CP count planes: the F ring (2 x K x
// JC f32), two buffers of the count planes (CP x 16 NTW x PS bf16) and the
// table planes (3 x PT x PS bf16), then the block's pair list (PT ints).
size_t narrow_smem_bytes(int NTW, int K, int CP) {
  return sizeof(float) * 2 * (size_t)K * JC +
         sizeof(bf16) * 2 * (CP * (size_t)16 * NTW + 3 * PT) * PS +
         sizeof(int) * PT;
}

// NTW: n-tiles (8 levels each) per warp, a constant so that the MMA chains
// of a warp's n-tiles are independent straight-line code the scheduler can
// interleave; levels past the block's own read zero count planes.  CP: the
// count planes, 2 or 3.
template <int NTW, int CP>
__global__ void __launch_bounds__(THREADS, 2)
level_gram_partial(const float* __restrict__ mw, const float* __restrict__ F,
                   float* __restrict__ partial, int L, int M, int K, int LB,
                   int chunk) {
  constexpr int LP = 16 * NTW;             // count-plane rows of a block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Q = K * (K + 1) / 2;
  const int q0 = blockIdx.x * PT;
  const int l0 = blockIdx.y * LB;
  const int lb = min(LB, L - l0);
  const int j_begin = blockIdx.z * chunk;
  const int j_end = min(M, j_begin + chunk);
  const int nsteps = (j_end - j_begin + JC - 1) / JC;
  float* Fs = reinterpret_cast<float*>(smem_raw);       // [2][K][JC]
  bf16* planes = reinterpret_cast<bf16*>(Fs + 2 * K * JC);
  constexpr int plane_set = (CP * LP + 3 * PT) * PS;    // one buffer
  int* pk = reinterpret_cast<int*>(planes + 2 * plane_set);  // k1 | k2 << 16

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int mt = warp & 3, half = warp >> 2;

  // the block's pairs (k1, k2) of the upper triangle
  for (int p = tid; p < PT; p += THREADS) pk[p] = pair_of(q0 + p, K);

  // F of step c into ring slot c % 2 (an empty group past the last step)
  auto stage_f = [&](int c) {
    if (c < nsteps) {
      const int jc = j_begin + c * JC;
      float* fs = Fs + (c & 1) * K * JC;
      for (int e = tid; e < K * JC; e += THREADS) {
        const int j = jc + e % JC;
        const bool ok = j < j_end;
        cp_async4(fs + e, ok ? F + (size_t)(e / JC) * M + j : F, ok);
      }
    }
    cp_async_commit();
  };
  // Mw of step c into registers: column pairs (l, jj), (l, jj + 1)
  float mwr[MWP][2];
  auto load_mw = [&](int c) {
    const int jc = j_begin + c * JC;
#pragma unroll
    for (int r = 0; r < MWP; ++r) {
      const int e = tid + r * THREADS;
      const int l = e / (JC / 2), j = jc + 2 * (e % (JC / 2));
      const float* src = mw + (size_t)(l0 + l) * M + j;
      const bool row = l < lb && c < nsteps;
      mwr[r][0] = row && j < j_end ? src[0] : 0.f;
      mwr[r][1] = row && j + 1 < j_end ? src[1] : 0.f;
    }
  };
  // the planes of step c into buffer c % 2: counts from the registers,
  // pair products from the staged F
  auto build = [&](int c) {
    bf16* Mh = planes + (c & 1) * plane_set;   // count planes hi, (mid,) lo
    bf16* Mm = Mh + LP * PS;
    bf16* Ml = Mh + (CP - 1) * LP * PS;
    bf16* Ph = Ml + LP * PS;
    bf16* Pm = Ph + PT * PS;
    bf16* Pl = Pm + PT * PS;
#pragma unroll
    for (int r = 0; r < MWP; ++r) {
      const int e = tid + r * THREADS;
      const int l = e / (JC / 2), jj = 2 * (e % (JC / 2));
      if (l < LP) {
        uint32_t hi, mid, lo;
        if constexpr (CP == 3) {
          split_count(mwr[r][0], mwr[r][1], hi, mid, lo);
          *reinterpret_cast<uint32_t*>(Mm + l * PS + jj) = mid;
        } else {
          split_count2(mwr[r][0], mwr[r][1], hi, lo);
        }
        *reinterpret_cast<uint32_t*>(Mh + l * PS + jj) = hi;
        *reinterpret_cast<uint32_t*>(Ml + l * PS + jj) = lo;
      }
    }
    const float* fs = Fs + (c & 1) * K * JC;
    for (int e = tid; e < PT * (JC / 2); e += THREADS) {
      const int p = e / (JC / 2), jj = 2 * (e % (JC / 2));
      const int v = pk[p];
      float x0 = 0.f, x1 = 0.f;
      if (v >= 0) {
        const float2 a =
            *reinterpret_cast<const float2*>(fs + (v & 0xffff) * JC + jj);
        const float2 b =
            *reinterpret_cast<const float2*>(fs + (v >> 16) * JC + jj);
        x0 = a.x * b.x;
        x1 = a.y * b.y;
      }
      uint32_t hi, mid, lo;
      split3(x0, x1, hi, mid, lo);
      *reinterpret_cast<uint32_t*>(Ph + p * PS + jj) = hi;
      *reinterpret_cast<uint32_t*>(Pm + p * PS + jj) = mid;
      *reinterpret_cast<uint32_t*>(Pl + p * PS + jj) = lo;
    }
  };

  float acc[NTW][4];
#pragma unroll
  for (int u = 0; u < NTW; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[u][r] = 0.f;

  // prologue: F of steps 0 and 1 in flight, Mw of step 0 in registers
  stage_f(0);
  stage_f(1);
  load_mw(0);
  cp_async_wait<1>();
  __syncthreads();                         // F of step 0 and pk are in
  build(0);
  load_mw(1);
  for (int c = 0; c < nsteps; ++c) {
    cp_async_wait<0>();
    // the planes of step c are built, F of step c + 1 has landed, and the
    // MMAs of step c - 1 are done with the other plane buffer
    __syncthreads();
    stage_f(c + 2);
    if (c + 1 < nsteps) {
      build(c + 1);
      load_mw(c + 2);
    }

    // MMAs of step c: this warp's m-tile against its n-tiles
    const bf16* Mh = planes + (c & 1) * plane_set;
    const bf16* Mm = Mh + LP * PS;
    const bf16* Ml = Mh + (CP - 1) * LP * PS;
    const bf16* Ph = Ml + LP * PS;
    const bf16* Pm = Ph + PT * PS;
    const bf16* Pl = Pm + PT * PS;
#pragma unroll
    for (int ks = 0; ks < JC; ks += 16) {
      const int arow = (mt * 16 + (lane & 15)) * PS + ks + (lane >> 4) * 8;
      uint32_t a[3][4];
      ldmatrix_x4(a[0], Ph + arow);
      ldmatrix_x4(a[1], Pm + arow);
      ldmatrix_x4(a[2], Pl + arow);
      // b: lanes 0-15 address the high count plane, 16-31 the next one
      // (the low one at CP = 2); bl (CP = 3): lanes 0-15 the low one
      const bf16* bp = (lane & 16) ? Mm : Mh;
      const int bcol = ks + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int u = 0; u < NTW; ++u) {
        const int nt = half + 2 * u;
        const int brow = (nt * 8 + (lane & 7)) * PS + bcol;
        uint32_t b[4];
        ldmatrix_x4(b, bp + brow);
        // this k-step's products from zero, smallest planes first (table
        // planes lo, mid, hi = a[2], a[1], a[0])
        float d[4];
        if constexpr (CP == 3) {
          uint32_t bl[2];
          ldmatrix_x2(bl, Ml + brow);
          mma_bf16_zero(d, a[2], bl[0], bl[1]);
          mma_bf16(d, a[2], b[2], b[3]);
          mma_bf16(d, a[1], bl[0], bl[1]);
          mma_bf16(d, a[2], b[0], b[1]);
          mma_bf16(d, a[1], b[2], b[3]);
          mma_bf16(d, a[0], bl[0], bl[1]);
          mma_bf16(d, a[1], b[0], b[1]);
          mma_bf16(d, a[0], b[2], b[3]);
          mma_bf16(d, a[0], b[0], b[1]);
        } else {
          mma_bf16_zero(d, a[2], b[2], b[3]);
          mma_bf16(d, a[2], b[0], b[1]);
          mma_bf16(d, a[1], b[2], b[3]);
          mma_bf16(d, a[1], b[0], b[1]);
          mma_bf16(d, a[0], b[2], b[3]);
          mma_bf16(d, a[0], b[0], b[1]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[u][r] += d[r];
      }
    }
  }

  // partial[z][l][q], upper triangle only
  float* out = partial + (size_t)blockIdx.z * L * Q;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int u = 0; u < NTW; ++u) {
    const int nt = half + 2 * u;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q = q0 + mt * 16 + g + (r >> 1) * 8;
      const int l = nt * 8 + 2 * t + (r & 1);
      if (q < Q && l < lb) out[(size_t)(l0 + l) * Q + q] = acc[u][r];
    }
  }
}

// out[l, k1, k2] = sum_{z < n_parts} partial[z][l][pair(min, max)], summed
// in order z = 0, 1, ...: the fixed-order reduction and the mirror.
__global__ void level_gram_reduce(const float* __restrict__ partial,
                                  float* __restrict__ out, int n_parts, int L,
                                  int K) {
  const long o = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= (long)L * K * K) return;
  const int Q = K * (K + 1) / 2;
  const int l = (int)(o / ((long)K * K)), r = (int)(o % ((long)K * K));
  const int k1 = min(r / K, r % K), k2 = max(r / K, r % K);
  const int q = k1 * K - k1 * (k1 - 1) / 2 + (k2 - k1);
  const float* p = partial + (size_t)l * Q + q;
  float acc = 0.f;
  for (int z = 0; z < n_parts; ++z) acc += p[(size_t)z * L * Q];
  out[o] = acc;
}

// The wide instance (K > NARROW_K): a block's pairs are a TW x TW tile
// of the triangle, k1 in [ka, ka + TW) x k2 in [kb, kb + TW), kb >= ka.
constexpr int TW = 8;
constexpr int FR = 2 * TW;       // rows of F a block stages a step
constexpr int FRS = 4 * ((3 + JC + 3) / 4);   // f32 row stride of the F
                                 // stage: the 16-byte chunks that cover a
                                 // row's JC columns from any offset
constexpr int WRING = 3;         // F stages in the ring, two ahead
constexpr int SP = TW * (TW + 1);    // f32 row stride of the output staging
static_assert(TW * TW == PT, "a pair tile is a block's pairs");

// Shared bytes of the wide instance: the ring of F (WRING x FR x FRS f32)
// and two buffers of the count planes and the table planes as the narrow
// instance's (the output staging, 16 NTW x SP f32, lies over them after
// the last step).
size_t wide_smem_bytes(int NTW, int CP) {
  return sizeof(float) * WRING * FR * FRS +
         sizeof(bf16) * 2 * (CP * (size_t)16 * NTW + 3 * PT) * PS;
}

// Pair tiles of the wide instance: band i (k1 in [TW i, TW (i + 1))) holds
// the tiles kb = TW i, TW (i + 1), ... below K.
long wide_tiles(int K) {
  const long B = (K + TW - 1) / TW;
  return B * (B + 1) / 2;
}

// The plane products of one k-step in the narrow instance's order,
// smallest first: product s takes table plane a(s) (0 hi, 1 mid, 2 lo) and
// count plane b(s) (0 hi, 1 the next, 2 the low one at CP = 3), one
// hexadecimal digit each, first product first.
template <int CP>
struct PlaneOrder {
  static constexpr int N = 3 * CP;
  static constexpr unsigned long long A = CP == 3 ? 0x221210100ull : 0x221100ull;
  static constexpr unsigned long long B = CP == 3 ? 0x212012010ull : 0x101010ull;
  __device__ static constexpr int a(int s) {
    return (int)((A >> (4 * (N - 1 - s))) & 0xf);
  }
  __device__ static constexpr int b(int s) {
    return (int)((B >> (4 * (N - 1 - s))) & 0xf);
  }
};

// The wide instance: the narrow instance's sums (each k-step's plane
// products from zero, the table entry rounded to f32 with __fmul_rn, then
// split), from a TW x TW pair tile whose 2 TW rows of F alone are staged,
// 16-byte chunks in a ring of WRING steps issued two ahead, Mw loaded into
// registers a step ahead; a warp's n-tiles run their MMA chains in groups
// of three, interleaved (at 9 n-tiles a warp, 128 registers and no
// spills).  The block writes its sums through shared memory in 8-float
// rows: where gridDim.z is 1, both triangles into the (L, K, K) grams
// (out); else the upper triangle into its range's packed partial (out +
// z L K (K + 1) / 2), which level_gram_reduce adds.
template <int NTW, int CP>
__global__ void __launch_bounds__(THREADS, 2)
level_gram_wide(const float* __restrict__ mw, const float* __restrict__ F,
                float* __restrict__ out, int L, int M, int K, int LB,
                int chunk) {
  constexpr int LP = 16 * NTW;             // count-plane rows of a block
  constexpr int MWN = LP * JC / 2 / THREADS;   // Mw pairs a thread a step
  constexpr int FS = FR * FRS;             // floats of one F stage
  constexpr int PR = PT * JC / 2 / THREADS;    // table pairs a thread a step
  constexpr int G = 3;                     // n-tiles' chains interleaved
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int l0 = blockIdx.y * LB;
  const int lb = min(LB, L - l0);
  const int j_begin = blockIdx.z * chunk;
  const int j_end = min(M, j_begin + chunk);
  const int nsteps = (j_end - j_begin + JC - 1) / JC;
  float* Fs = reinterpret_cast<float*>(smem_raw);       // [WRING][FR][FRS]
  bf16* planes = reinterpret_cast<bf16*>(Fs + WRING * FS);
  constexpr int plane_set = (CP * LP + 3 * PT) * PS;    // one buffer

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int mt = warp & 3, half = warp >> 2;

  // the tile: band i, its tile t
  int t = blockIdx.x, i = 0;
  const int B = (K + TW - 1) / TW;
  while (t >= B - i) {
    t -= B - i;
    ++i;
  }
  const int ka = TW * i, kb = TW * (i + t);

  // this thread's table pairs: column pair jj, k2 = kb + rb, and k1 = ka +
  // ra[r]; where they start in the staged rows (each row at its offset in
  // its first chunk: chunks start at multiples of 4 floats and a step's
  // first column at a multiple of JC), -1 where k1 > k2 or k2 >= K
  const int jj = 2 * (tid % (JC / 2));
  const int rb = (tid / (JC / 2)) % TW;
  const int bo = (TW + rb) * FRS + (((kb + rb) * (M & 3)) & 3);
  int ao[PR];
#pragma unroll
  for (int r = 0; r < PR; ++r) {
    const int ra = tid / (TW * JC / 2) + r * (THREADS / (TW * JC / 2));
    const int k1 = ka + ra, k2 = kb + rb;
    ao[r] = k1 <= k2 && k2 < K ? ra * FRS + ((k1 * (M & 3)) & 3) : -1;
  }

  // F of step c into ring slot c % WRING (an empty group past the last
  // step): rows ka .. ka + TW - 1 and kb .. kb + TW - 1, each as the
  // 16-byte chunks that cover its columns (the bytes past the array end
  // zero-filled by the copy)
  auto stage_f = [&](int c) {
    if (c < nsteps) {
      const int jc = j_begin + c * JC;
      float* fs = Fs + (c % WRING) * FS;
      const size_t total = (size_t)K * M;
      for (int e = tid; e < FR * FRS / 4; e += THREADS) {
        const int r = e / (FRS / 4), w = e % (FRS / 4);
        const int k = r < TW ? ka + r : kb + r - TW;
        size_t at = 0;
        int n = 0;
        if (k < K) {
          at = (((size_t)k * M + jc) & ~(size_t)3) + 4 * w;
          if (at < total) n = 4 * (int)(total - at < 4 ? total - at : 4);
        }
        cp_async16(fs + r * FRS + 4 * w, F + (n ? at : 0), n);
      }
    }
    cp_async_commit();
  };
  // Mw of step c into registers: column pairs (l, jj), (l, jj + 1)
  float mwr[MWN][2];
  auto load_mw = [&](int c) {
    const int jc = j_begin + c * JC;
#pragma unroll
    for (int r = 0; r < MWN; ++r) {
      const int e = tid + r * THREADS;
      const int l = e / (JC / 2), j = jc + 2 * (e % (JC / 2));
      const float* src = mw + (size_t)(l0 + l) * M + j;
      const bool row = l < lb && c < nsteps;
      mwr[r][0] = row && j < j_end ? src[0] : 0.f;
      mwr[r][1] = row && j + 1 < j_end ? src[1] : 0.f;
    }
  };
  // the planes of step c into buffer c % 2: counts from the registers,
  // pair products from the staged F (columns past the range's end, another
  // range's or past M, selected away)
  auto build = [&](int c) {
    bf16* Mh = planes + (c & 1) * plane_set;   // count planes hi, (mid,) lo
    bf16* Mm = Mh + LP * PS;
    bf16* Ml = Mh + (CP - 1) * LP * PS;
    bf16* Ph = Ml + LP * PS;
    bf16* Pm = Ph + PT * PS;
    bf16* Pl = Pm + PT * PS;
#pragma unroll
    for (int r = 0; r < MWN; ++r) {
      const int e = tid + r * THREADS;
      const int l = e / (JC / 2), cj = 2 * (e % (JC / 2));
      uint32_t hi, mid, lo;
      if constexpr (CP == 3) {
        split_count(mwr[r][0], mwr[r][1], hi, mid, lo);
        *reinterpret_cast<uint32_t*>(Mm + l * PS + cj) = mid;
      } else {
        split_count2(mwr[r][0], mwr[r][1], hi, lo);
      }
      *reinterpret_cast<uint32_t*>(Mh + l * PS + cj) = hi;
      *reinterpret_cast<uint32_t*>(Ml + l * PS + cj) = lo;
    }
    const float* fs = Fs + (c % WRING) * FS;
    const int j = j_begin + c * JC + jj;
    const float b0 = fs[bo + jj], b1 = fs[bo + jj + 1];
#pragma unroll
    for (int r = 0; r < PR; ++r) {
      float x0 = 0.f, x1 = 0.f;
      if (ao[r] >= 0) {
        if (j < j_end) x0 = __fmul_rn(fs[ao[r] + jj], b0);
        if (j + 1 < j_end) x1 = __fmul_rn(fs[ao[r] + jj + 1], b1);
      }
      const int p = (tid / (JC / 2)) + r * (THREADS / (JC / 2));
      uint32_t hi, mid, lo;
      split3(x0, x1, hi, mid, lo);
      *reinterpret_cast<uint32_t*>(Ph + p * PS + jj) = hi;
      *reinterpret_cast<uint32_t*>(Pm + p * PS + jj) = mid;
      *reinterpret_cast<uint32_t*>(Pl + p * PS + jj) = lo;
    }
  };

  float acc[NTW][4];
#pragma unroll
  for (int u = 0; u < NTW; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[u][r] = 0.f;

  // MMAs of step c: this warp's m-tile against its n-tiles, G n-tiles'
  // chains at a time, each chain this k-step's plane products from zero in
  // PlaneOrder's order
  auto mma_step = [&](int c) {
    using O = PlaneOrder<CP>;
    const bf16* Mh = planes + (c & 1) * plane_set;
    const bf16* Mm = Mh + LP * PS;
    const bf16* Ml = Mh + (CP - 1) * LP * PS;
    const bf16* Ph = Ml + LP * PS;
    const bf16* Pm = Ph + PT * PS;
    const bf16* Pl = Pm + PT * PS;
#pragma unroll
    for (int ks = 0; ks < JC; ks += 16) {
      const int arow = (mt * 16 + (lane & 15)) * PS + ks + (lane >> 4) * 8;
      uint32_t a[3][4];
      ldmatrix_x4(a[0], Ph + arow);
      ldmatrix_x4(a[1], Pm + arow);
      ldmatrix_x4(a[2], Pl + arow);
      // b: lanes 0-15 address the high count plane, 16-31 the next one
      // (the low one at CP = 2); CP = 3: lanes 0-15 the low one, too
      const bf16* bp = (lane & 16) ? Mm : Mh;
      const int bcol = ks + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int u0 = 0; u0 < NTW; u0 += G) {
        uint32_t b[G][CP][2];
        float d[G][4];
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (u0 + g < NTW) {
            const int nt = half + 2 * (u0 + g);
            const int brow = (nt * 8 + (lane & 7)) * PS + bcol;
            uint32_t b4[4];
            ldmatrix_x4(b4, bp + brow);
            b[g][0][0] = b4[0];
            b[g][0][1] = b4[1];
            b[g][1][0] = b4[2];
            b[g][1][1] = b4[3];
            if constexpr (CP == 3) {
              uint32_t bl[2];
              ldmatrix_x2(bl, Ml + brow);
              b[g][2][0] = bl[0];
              b[g][2][1] = bl[1];
            }
          }
#pragma unroll
        for (int s = 0; s < O::N; ++s)
#pragma unroll
          for (int g = 0; g < G; ++g)
            if (u0 + g < NTW) {
              if (s == 0)
                mma_bf16_zero(d[g], a[O::a(s)], b[g][O::b(s)][0],
                              b[g][O::b(s)][1]);
              else
                mma_bf16(d[g], a[O::a(s)], b[g][O::b(s)][0],
                         b[g][O::b(s)][1]);
            }
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (u0 + g < NTW)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[u0 + g][r] += d[g][r];
      }
    }
  };

  // prologue: F of steps 0-2 in flight, Mw of step 0 in registers
  stage_f(0);
  stage_f(1);
  stage_f(2);
  load_mw(0);
  cp_async_wait<WRING - 1>();
  __syncthreads();                         // F of step 0 is in
  build(0);
  load_mw(1);
  for (int c = 0; c < nsteps; ++c) {
    cp_async_wait<WRING - 2>();
    // F of step c + 1 has landed, the planes of step c are built, and the
    // MMAs of step c - 1 are done with the other plane buffer; step c's F
    // slot takes step c + WRING
    __syncthreads();
    stage_f(c + WRING);
    if (c + 1 < nsteps) {
      build(c + 1);
      load_mw(c + 2);
    }
    mma_step(c);
  }

  // the sums through shared memory (over the planes, once every warp's
  // MMAs are done): S[l][ra (TW + 1) + rb]
  cp_async_wait<0>();
  __syncthreads();
  float* S = reinterpret_cast<float*>(planes);
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int u = 0; u < NTW; ++u) {
    const int nt = half + 2 * u;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = mt * 16 + g + (r >> 1) * 8;
      const int l = nt * 8 + 2 * tq + (r & 1);
      S[l * SP + (p / TW) * (TW + 1) + p % TW] = acc[u][r];
    }
  }
  __syncthreads();
  if (gridDim.z > 1) {
    // the range's partial[z][l][pair(k1, k2)], 8 k2 a row
    const int Q = K * (K + 1) / 2;
    float* o = out + (size_t)blockIdx.z * L * Q;
    for (int e = tid; e < lb * PT; e += THREADS) {
      const int l = e / PT, x = (e % PT) / TW, y = e % TW;
      const int k1 = ka + x, k2 = kb + y;
      if (k1 <= k2 && k2 < K)
        o[(size_t)(l0 + l) * Q + k1 * K - k1 * (k1 - 1) / 2 + (k2 - k1)] =
            S[l * SP + x * (TW + 1) + y];
    }
    return;
  }
  // out[l][k1][k2] row by row (8 k2 a row), then the mirror out[l][k2][k1]
  // (8 k1 a row), the diagonal once
  for (int e = tid; e < lb * PT; e += THREADS) {
    const int l = e / PT, x = (e % PT) / TW, y = e % TW;
    const size_t ol = (size_t)(l0 + l) * K;
    if (ka + x <= kb + y && kb + y < K)
      out[(ol + ka + x) * K + kb + y] = S[l * SP + x * (TW + 1) + y];
    if (ka + y < kb + x && kb + x < K)
      out[(ol + kb + x) * K + ka + y] = S[l * SP + y * (TW + 1) + x];
  }
}

// The kernel at NTW n-tiles per warp, 1 <= NTW <= 9, CP count planes, of
// the narrow or the wide instance (one signature: the wide instance's
// third argument is its output, the narrow one's its partials).
using PartialFn = void (*)(const float*, const float*, float*, int, int, int,
                           int, int);
template <int CP>
PartialFn narrow_kernel(int ntw) {
  static const PartialFn fns[9] = {
      level_gram_partial<1, CP>, level_gram_partial<2, CP>,
      level_gram_partial<3, CP>, level_gram_partial<4, CP>,
      level_gram_partial<5, CP>, level_gram_partial<6, CP>,
      level_gram_partial<7, CP>, level_gram_partial<8, CP>,
      level_gram_partial<9, CP>};
  return fns[ntw - 1];
}

template <int CP>
PartialFn wide_kernel(int ntw) {
  static const PartialFn fns[9] = {
      level_gram_wide<1, CP>, level_gram_wide<2, CP>, level_gram_wide<3, CP>,
      level_gram_wide<4, CP>, level_gram_wide<5, CP>, level_gram_wide<6, CP>,
      level_gram_wide<7, CP>, level_gram_wide<8, CP>, level_gram_wide<9, CP>};
  return fns[ntw - 1];
}

PartialFn partial_kernel(int ntw, int cp, bool wide) {
  if (wide) return cp == 3 ? wide_kernel<3>(ntw) : wide_kernel<2>(ntw);
  return cp == 3 ? narrow_kernel<3>(ntw) : narrow_kernel<2>(ntw);
}

// The launch plan of a shape: levels per block, n-tiles per warp, count
// planes, instance, column range per block, grid, shared bytes.
struct Plan {
  int LB, ntw, cp, chunk;
  bool wide;
  dim3 grid;
  size_t smem;
};

// Blocks of the kernel at (ntw, cp, wide) that the device holds at once at
// `smem` bytes, remembered for the last device, kernel and size asked (a
// fit asks for one).
cudaError_t resident_blocks(int ntw, int cp, bool wide, size_t smem,
                            int* blocks) {
  static int last_dev = -1, last_ntw = 0, last_cp = 0, last_blocks = 0;
  static bool last_wide = false;
  static size_t last_smem = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != last_dev || ntw != last_ntw || cp != last_cp ||
      wide != last_wide || smem != last_smem) {
    const PartialFn fn = partial_kernel(ntw, cp, wide);
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, fn, THREADS, smem)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    last_dev = dev;
    last_ntw = ntw;
    last_cp = cp;
    last_wide = wide;
    last_smem = smem;
    last_blocks = per_sm * sms;
  }
  *blocks = last_blocks;
  return cudaSuccess;
}

cudaError_t plan(int L, int M, int K, int cp, Plan* p) {
  const int level_tiles = ceil_div(L, LBMAX);
  p->LB = 8 * ceil_div(ceil_div(L, level_tiles), 8);
  p->ntw = ceil_div(p->LB, 16);
  p->cp = cp;
  p->wide = K > NARROW_K;
  p->smem = p->wide ? wide_smem_bytes(p->ntw, cp)
                    : narrow_smem_bytes(p->ntw, K, cp);
  int resident = 0;
  cudaError_t err = resident_blocks(p->ntw, cp, p->wide, p->smem, &resident);
  if (err != cudaSuccess) return err;
  const long pair_tiles =
      p->wide ? wide_tiles(K) : ceil_div(K * (K + 1) / 2, PT);
  const long tiles = pair_tiles * level_tiles;
  // no column range shorter than four steps
  const int most = ceil_div(M, 4 * JC);
  int splits = 1;
  if (!p->wide) {
    // one wave: as many column ranges as the card holds blocks beside the
    // pair and level tiles
    splits = (int)(resident / tiles);
    splits = splits < most ? splits : most;
    if (splits < 1) splits = 1;
  } else {
    // the number of ranges s whose waves of blocks, ceil(tiles s /
    // resident), take the least time, waves / s, the fewest ranges among
    // equals; s up to four times the ranges one wave holds
    long top = 4 * resident / tiles;
    if (top > most) top = most;
    long best_waves = 0;
    for (long s = 1; s <= (top > 1 ? top : 1); ++s) {
      const long waves = (tiles * s + resident - 1) / resident;
      if (s == 1 || waves * splits < best_waves * s) {
        best_waves = waves;
        splits = (int)s;
      }
    }
  }
  p->chunk = ceil_div(ceil_div(M, splits), JC) * JC;
  if (pair_tiles >= 1L << 31) return cudaErrorInvalidValue;
  p->grid = dim3((unsigned)pair_tiles, level_tiles, ceil_div(M, p->chunk));
  return cudaSuccess;
}

// f32 scratch of a plan: the packed partials of its column ranges, none
// where the wide instance has one range.
long scratch_floats(const Plan& p, int L, int K) {
  if (p.wide && p.grid.z == 1) return 0;
  return (long)p.grid.z * L * (K * (K + 1) / 2);
}

}  // namespace

// Elements of f32 scratch that insider_level_gram needs (0 where no plan
// exists; insider_level_gram then reports the CUDA error).
INSIDER_API long insider_level_gram_scratch(int L, int M, int K,
                                            int count_planes) {
  Plan p;
  if (L < 1 || M < 1 || K < 1 || K >= 1 << 15 ||
      (count_planes != 2 && count_planes != 3) ||
      plan(L, M, K, count_planes, &p) != cudaSuccess)
    return 0;
  return scratch_floats(p, L, K);
}

// out (L, K*K) = Mw (L, M) . outer_table(F (K, M))^T, all row-major f32;
// Mw holds integer counts, below 65536 for count_planes = 2, below 2^24 for
// count_planes = 3; F 16-byte aligned where K > NARROW_K; 1 <= K < 32768.
INSIDER_API int insider_level_gram(const float* mw, const float* F, float* out,
                                   float* scratch, long scratch_len, int L,
                                   int M, int K, int count_planes,
                                   cudaStream_t stream) {
  if (L < 1 || M < 1 || K < 1 || K >= 1 << 15 ||
      (count_planes != 2 && count_planes != 3))
    return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan(L, M, K, count_planes, &p);
  if (err != cudaSuccess) return (int)err;
  if (scratch_len < scratch_floats(p, L, K)) return (int)cudaErrorInvalidValue;
  // the wide instance with one column range writes the grams itself
  const bool direct = p.wide && p.grid.z == 1;
  partial_kernel(p.ntw, p.cp, p.wide)<<<p.grid, THREADS, p.smem, stream>>>(
      mw, F, direct ? out : scratch, L, M, K, p.LB, p.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess || direct) return (int)err;
  const long n = (long)L * K * K;
  level_gram_reduce<<<ceil_div(n, 256), 256, 0, stream>>>(
      scratch, out, (int)p.grid.z, L, K);
  return (int)cudaGetLastError();
}
