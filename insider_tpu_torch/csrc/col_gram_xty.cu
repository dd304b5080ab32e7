// col_gram_xty: the streamed column update's inputs, every gene's masked
// gram and right-hand side,
//     XtXt[k, l, j] = sum_i mask_ij R_ik R_il        (K, K, M)
//     Xty[k, j]     = sum_i R_ik (mask_ij data_ij)   (K, M)
//
// Replaces insider_tpu/kernels/gram_pallas.py:col_gram_xty_pallas (body
// _gram_xty_kernel), which accumulates over a sequential grid of row chunks,
// rides the MXU with the outer-product table split into three exact bf16
// planes against the exact 0/1 mask (_bf16_planes, _planes_dot) and forms
// Xty at precision HIGHEST.
//
// Bound on the H100: the bytes.  At N=300, K=50, M=44477 the call moves 560
// MB, 445 MB of it the K^2 M f32 grams written: 0.167 ms at 3.35 TB/s,
// against 0.103 ms for the K(K+1)/2 pair sums in three bf16 planes on the
// tensor cores (6 pairs N M = 102 GFLOP) and 0.020 ms for Xty's f32 FMAs.
// Measured on the card (PERF.md) it takes several times that bound, most
// likely because a block's k-step is short -- 48 MMAs a warp beside the
// plane build, the mask conversion and the staging -- with 16 warps a SM and
// one barrier a step to hide the latency.
//
// Design: the grams are a GEMM
//     G (pairs x columns) = table (pairs x rows) . mask (rows x columns)
// on mma.sync m16n8k16, bf16 in and f32 out, over the upper-triangle pairs
// k1 <= k2 only: the table entry R_ik R_il rounded to f32 (as the TPU kernel
// forms it), split into three exact bf16 planes (split3), the 0/1 mask exact
// in bf16, each k-step of 16 rows summed from zero (lo, then mid, then hi
// plane: mma_bf16_zero) and added into the running f32 sums -- the
// arithmetic of the fused build (fss.cu) and of ops/planes.
// planes_col_gram_xty.  A block owns 128 pairs and 128 columns; its 8 warps
// each own 32 pairs x 64 columns (2 m-tiles x 8 n-tiles).  The table planes
// are built once per block and k-step, into shared memory, and serve all 128
// columns (the fused build rebuilds them per warp for every 32 columns);
// that work grows with N like the MMAs' and needs no scratch, so one kernel
// takes any N.  The k-steps' inputs are staged by cp.async in a ring of NST
// steps, NST - 1 ahead: the rows of R transposed that the block's pairs
// read, and the mask's rows as the 16-byte aligned chunks that cover them
// (rows of the (N, M) inputs are not 16-byte aligned at odd M; a row starts
// at its offset in its first chunk, the bytes past the array end are
// zero-filled by the copy).  While the MMAs of a k-step run from one buffer
// (ldmatrix fragments; ldmatrix.trans for the mask), the block builds the
// next step's table planes and bf16 mask tile in the other, one barrier a
// step.  Rows past N are zeros from the copy and columns past M are
// selected away (a NaN left in shared memory would survive a zero mask).
// The accumulators go through shared memory, and each warp writes whole
// 128-column rows of the grams, coalesced along the gene axis, to (k1, k2)
// and (k2, k1) from the same value (symmetric bit for bit; the diagonal
// once), with evict-first stores so that the mask stays in L2.  The first
// ceil(K / 128) blocks of each column tile compute Xty alone in f32 FMA (the
// TPU kernel's HIGHEST), 128 coordinates a block, a thread per column and
// every other coordinate, each k-step from zero in row order and then
// added; they are the only blocks that read data.  The grid runs a column
// tile's blocks together, so the mask is read from device memory once and
// from L2 by the other pair groups.
//
// Two instances, the same sums in the same order (so the same bits):
//   * narrow, K <= NARROW_K: a gram block owns 128 consecutive pairs of the
//     triangle and stages all K rows of R^T a k-step, from R, 4 bytes a
//     copy (the ring: 3 x K x 80 bytes);
//   * wide, K > NARROW_K: a gram block owns a tile of the triangle, k1 in
//     [a, a + TA) x k2 in [b, b + TB) with b >= a (TA x TB = 128 pairs; on a
//     diagonal tile the pairs with k1 > k2 read zero planes and are not
//     written), and stages only its TA + TB rows of R^T, an Xty block only
//     its 128, as 16-byte copies from a (K, N) copy of R^T in scratch (rows
//     padded to a multiple of 4 floats, so that a k-step of a row is 64
//     aligned bytes) that a transpose kernel writes first.  No shared
//     memory grows with K: 82 KB a block with f32 masks, two blocks an SM.
//     K is bounded by the pairs' 16-bit packing (K < 32768) and by the
//     (K, K, M) grams' bytes alone.
#include "common.cuh"
#include "mma.cuh"

namespace {

using insider::ceil_div;
using insider::cp_async16;
using insider::cp_async4;
using insider::cp_async_commit;
using insider::cp_async_wait;
using insider::ldmatrix_x4;
using insider::ldmatrix_x4_trans;
using insider::mma_bf16;
using insider::mma_bf16_zero;
using insider::pack_exact;
using insider::pair_of;
using insider::split3;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int KS = 16;         // rows per pipeline step: one k-step
constexpr int P = 128;         // pairs per gram block: 8 m-tiles of 16
constexpr int C = 128;         // columns per block: 16 n-tiles of 8
constexpr int RS = KS + 4;     // f32 row stride of the transposed R step
                               // (80 bytes: 16-byte aligned rows)
constexpr int PS = KS + 8;     // bf16 row stride of the table planes (48
                               // bytes: ldmatrix rows in distinct banks)
constexpr int CS = C + 8;      // bf16 row stride of the mask tile (272 bytes)
constexpr int SS = C + 8;      // f32 row stride of the accumulator staging
constexpr int XK = 128;        // Xty coordinates of one Xty block
constexpr int XU = XK / 2;     // Xty coordinates per thread at most
constexpr int NST = 3;         // staging steps in the ring (two blocks a SM
                               // still fit at K = 128)
constexpr int NARROW_K = 128;  // the largest K of the narrow instance
constexpr int TA = 16;         // a wide pair tile: TA values of k1 ...
constexpr int TB = 8;          // ... x TB values of k2 (TA TB = P)
static_assert(TA * TB == P && TA % TB == 0, "a pair tile is a gram block");

// Rows of an (N, M) input staged a step at a time: the 16-byte chunks that
// cover columns j0 .. j0 + C - 1 of rows i0 .. i0 + KS - 1.
template <typename T>
struct Rows {
  static constexpr int CE = 16 / sizeof(T);               // per chunk
  static constexpr int CH = (CE - 1 + C + CE - 1) / CE;   // chunks a row
  static constexpr int BYTES = KS * CH * 16;

  static __device__ void stage(const T* src, void* dst, int i0, int j0,
                               int N, int M, int tid) {
    const size_t total = (size_t)N * M;
    for (int e = tid; e < KS * CH; e += THREADS) {
      const int i = e / CH, w = e % CH;
      size_t at = 0;
      int n = 0;
      if (i0 + i < N) {
        at = (((size_t)(i0 + i) * M + j0) & ~(size_t)(CE - 1)) +
             (size_t)CE * w;
        if (at < total)
          n = (int)sizeof(T) * (int)(total - at < CE ? total - at : CE);
      }
      cp_async16(static_cast<unsigned char*>(dst) + 16 * e,
                 src + (n ? at : 0), n);
    }
  }
  // element (i, jj) of the staged step as f32, 0 past the edges
  static __device__ float at(const void* dst, int i, int jj, int i0, int j0,
                             int M) {
    const unsigned o = ((unsigned)(i0 + i) * (unsigned)M + (unsigned)j0) &
                       (CE - 1);
    const T* row = static_cast<const T*>(dst) + i * CH * CE;
    return j0 + jj < M ? static_cast<float>(row[o + jj]) : 0.f;
  }
};

// Rows of the transposed R step: K rounded up to 8, zeros past K (the Xty
// threads take their coordinates four at a time).
__host__ __device__ constexpr int r_rows(int K) { return (K + 7) & ~7; }

__host__ __device__ constexpr long pairs(int K) {
  return (long)K * (K + 1) / 2;
}

// Rows of R^T a block stages a step: the narrow instance all r_rows(K); a
// wide gram block its tile's TA + TB, a wide Xty block its XK coordinates.
template <bool WIDE>
__host__ __device__ constexpr int staged_rows(int K, bool xty) {
  return WIDE ? (xty ? XK : TA + TB) : r_rows(K);
}

// The row stride of the wide instance's R^T copy: N rounded up to a
// multiple of 4 floats.
constexpr int rt_stride(int N) { return (N + 3) & ~3; }

// Pair tiles of the wide instance: band i (k1 in [TA i, TA (i + 1))) holds
// ceil(K / TB) - (TA / TB) i tiles, b = TA i, TA i + TB, ... below K.
constexpr int T_STEP = TA / TB;
__host__ __device__ constexpr long wide_tiles(int K) {
  return (long)((K + TA - 1) / TA) * ((K + TB - 1) / TB) -
         (long)T_STEP * ((K + TA - 1) / TA) * ((K + TA - 1) / TA - 1) / 2;
}

// Shared memory: the block's pair list, then the ring of NST staging steps
// -- R^T (staged_rows, RS) f32 and the mask rows, and the data rows in the
// Xty block -- and, in a gram block, two buffers each of the table planes
// (3 x P x PS bf16) and of the bf16 mask tile (KS x CS); the accumulator
// staging (P x SS f32) lies over the ring after the last step.
constexpr size_t PK_BYTES = sizeof(int) * P;
constexpr size_t PLANE_BYTES = sizeof(bf16) * 3 * P * PS;
constexpr size_t TILE_BYTES = sizeof(bf16) * KS * CS;

template <typename MaskT, bool WIDE>
__host__ __device__ constexpr size_t stage_bytes(int K, bool xty) {
  return sizeof(float) * staged_rows<WIDE>(K, xty) * RS + Rows<MaskT>::BYTES +
         (xty ? Rows<float>::BYTES : 0);
}

template <typename MaskT, bool WIDE>
size_t smem_bytes(int K) {
  const size_t gram = NST * stage_bytes<MaskT, WIDE>(K, false) +
                      2 * (PLANE_BYTES + TILE_BYTES);
  const size_t xty = NST * stage_bytes<MaskT, WIDE>(K, true);
  const size_t out = sizeof(float) * P * SS;
  size_t most = gram > xty ? gram : xty;
  return PK_BYTES + (most > out ? most : out);
}

// R (N, K) -> Rt (K, ld), the wide instance's R^T, through 32 x 32 tiles
// in shared memory (reads and writes coalesced); columns N .. ld - 1 of Rt
// are left as they are, and never read.
__global__ void col_gram_xty_transpose(const float* __restrict__ R,
                            float* __restrict__ Rt, int N, int K, int ld) {
  __shared__ float t[32][33];
  const int i0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  for (int y = threadIdx.y; y < 32; y += blockDim.y)
    if (i0 + y < N && k0 + (int)threadIdx.x < K)
      t[y][threadIdx.x] = R[(size_t)(i0 + y) * K + k0 + threadIdx.x];
  __syncthreads();
  for (int y = threadIdx.y; y < 32; y += blockDim.y)
    if (k0 + y < K && i0 + (int)threadIdx.x < N)
      Rt[(size_t)(k0 + y) * ld + i0 + threadIdx.x] = t[threadIdx.x][y];
}

// R: (N, K) for the narrow instance; Rt: the wide instance's (K, ld) R^T.
template <typename MaskT, bool WIDE>
__global__ void __launch_bounds__(THREADS, 2)
col_gram_xty_kernel(const MaskT* __restrict__ mask,
                    const float* __restrict__ data,
                    const float* __restrict__ R, const float* __restrict__ Rt,
                    int ld, float* __restrict__ gram, float* __restrict__ xty,
                    int N, int M, int K) {
  using MaskRows = Rows<MaskT>;
  using DataRows = Rows<float>;
  extern __shared__ __align__(16) unsigned char smem[];
  int* pk = reinterpret_cast<int*>(smem);               // k1 | k2 << 16
  unsigned char* ring = smem + PK_BYTES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int j0 = blockIdx.y * C;
  const int nsteps = (N + KS - 1) / KS;
  const int xty_blocks = (K + XK - 1) / XK;
  const bool xty_block = (int)blockIdx.x < xty_blocks;  // block-uniform
  const size_t SB = stage_bytes<MaskT, WIDE>(K, xty_block);
  // the wide instance's rows: an Xty block's coordinates h0 .. h0 + XK - 1;
  // a gram block's tile k1 in [ka, ka + TA) x k2 in [kb, kb + TB), staged
  // as rows 0 .. TA - 1 and TA .. TA + TB - 1
  const int h0 = WIDE && xty_block ? blockIdx.x * XK : 0;
  int ka = 0, kb = 0;
  if (WIDE && !xty_block) {
    int t = blockIdx.x - xty_blocks, i = 0;
    const int T = (K + TB - 1) / TB;
    while (t >= T - T_STEP * i) {
      t -= T - T_STEP * i;
      ++i;
    }
    ka = TA * i;
    kb = ka + TB * t;
  }

  // the parts of ring slot s: R^T, mask rows, data rows
  auto Rt_of = [&](int s) {
    return reinterpret_cast<float*>(ring + s * SB);
  };
  auto mask_of = [&](int s) {
    return ring + s * SB + sizeof(float) * staged_rows<WIDE>(K, xty_block) *
                               RS;
  };
  auto data_of = [&](int s) { return mask_of(s) + MaskRows::BYTES; };

  const int KR = r_rows(K);
  const int r_i = tid / KR, r_k = tid % KR, di = THREADS / KR,
            dk = THREADS % KR;
  // staging step c into slot c % NST (an empty group past the last)
  auto stage = [&](int c) {
    if (c < nsteps) {
      const int s = c % NST, i0 = c * KS;
      float* Rs = Rt_of(s);
      if constexpr (WIDE) {
        // row r of the step: its k-step of R^T, four 16-byte chunks
        const int rows = staged_rows<WIDE>(K, xty_block);
        for (int e = tid; e < 4 * rows; e += THREADS) {
          const int r = e >> 2, i = i0 + 4 * (e & 3);
          const int k = xty_block ? h0 + r : r < TA ? ka + r : kb + r - TA;
          const int n = k < K && i < N ? 4 * min(4, N - i) : 0;
          cp_async16(Rs + r * RS + 4 * (e & 3),
                     n ? Rt + (size_t)k * ld + i : Rt, n);
        }
      } else {
        // element (i, k) of the step, THREADS apart: (di, dk) a stride
        for (int i = r_i, k = r_k; i < KS; i += di, k += dk) {
          if (k >= KR) {
            k -= KR;
            ++i;
            if (i >= KS) break;
          }
          const bool ok = i0 + i < N && k < K;
          cp_async4(Rs + k * RS + i, ok ? R + (size_t)(i0 + i) * K + k : R,
                    ok);
        }
      }
      MaskRows::stage(mask, mask_of(s), i0, j0, N, M, tid);
      if (xty_block) DataRows::stage(data, data_of(s), i0, j0, N, M, tid);
    }
    cp_async_commit();
  };

  if (xty_block) {
    // Xty: column jc, coordinates h, h + 2, ... of this block's 128 (h
    // warp-uniform), staged rows from h - h0
    const int h = blockIdx.x * XK + tid / C, jc = tid % C;
    float acc[XU];
#pragma unroll
    for (int u = 0; u < XU; ++u) acc[u] = 0.f;
    for (int c = 0; c < NST - 1; ++c) stage(c);
    for (int c = 0; c < nsteps; ++c) {
      cp_async_wait<NST - 2>();
      // step c has landed for every thread; step c - 1 is consumed, so its
      // slot takes step c + NST - 1
      __syncthreads();
      stage(c + NST - 1);
      const int s = c % NST, i0 = c * KS;
      const float* Rs = Rt_of(s);
      float md[KS];
#pragma unroll
      for (int i = 0; i < KS; ++i)
        md[i] = MaskRows::at(mask_of(s), i, jc, i0, j0, M) *
                DataRows::at(data_of(s), i, jc, i0, j0, M);
      // coordinates four at a time (rows past K of R^T are zeros): four
      // independent chains, each this k-step's rows in order from zero
#pragma unroll
      for (int u0 = 0; u0 < XU; u0 += 4) {
        if (h + 2 * u0 >= K) break;
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < KS; q += 4)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const float4 r4 = *reinterpret_cast<const float4*>(
                Rs + (h - h0 + 2 * (u0 + v)) * RS + q);
            sum[v] = fmaf(r4.x, md[q], sum[v]);
            sum[v] = fmaf(r4.y, md[q + 1], sum[v]);
            sum[v] = fmaf(r4.z, md[q + 2], sum[v]);
            sum[v] = fmaf(r4.w, md[q + 3], sum[v]);
          }
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u0 + v] += sum[v];
      }
    }
    cp_async_wait<0>();
    const int j = j0 + jc;
    if (j < M)
#pragma unroll
      for (int u = 0; u < XU; ++u) {
        const int k = h + 2 * u;
        if (k >= K) break;
        xty[(size_t)k * M + j] = acc[u];
      }
    return;
  }

  // the grams: the narrow instance's pairs q0 .. q0 + P - 1 of the upper
  // triangle, the wide instance's tile (pair ra TB + rb is (ka + ra, kb +
  // rb); -1 where k1 > k2 or k2 >= K)
  bf16* planes = reinterpret_cast<bf16*>(ring + NST * SB);
  bf16* tiles = reinterpret_cast<bf16*>(ring + NST * SB + 2 * PLANE_BYTES);
  if (tid < P) {
    if constexpr (WIDE) {
      const int k1 = ka + tid / TB, k2 = kb + tid % TB;
      pk[tid] = k1 <= k2 && k2 < K ? k1 | k2 << 16 : -1;
    } else {
      pk[tid] = pair_of((blockIdx.x - xty_blocks) * P + tid, K);
    }
  }
  // the staged row of k1 is k1 - sa, of k2 k2 - sb
  const int sa = ka, sb = kb - (WIDE ? TA : 0);

  // the table planes and the bf16 mask tile of step c into buffer c % 2
  auto build = [&](int c) {
    const int s = c % NST, i0 = c * KS;
    const float* Rs = Rt_of(s);
    bf16* pl = planes + (c & 1) * 3 * P * PS;           // hi, mid, lo
    bf16* mt = tiles + (c & 1) * KS * CS;
#pragma unroll
    for (int r = 0; r < P * KS / 2 / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int p = e / (KS / 2), ii = 2 * (e % (KS / 2));
      const int v = pk[p];
      float x0 = 0.f, x1 = 0.f;
      if (v >= 0) {
        const float2 a = *reinterpret_cast<const float2*>(
            Rs + ((v & 0xffff) - sa) * RS + ii);
        const float2 b = *reinterpret_cast<const float2*>(
            Rs + ((v >> 16) - sb) * RS + ii);
        x0 = __fmul_rn(a.x, b.x);         // rounded to f32, never fused
        x1 = __fmul_rn(a.y, b.y);
      }
      uint32_t hi, mid, lo;
      split3(x0, x1, hi, mid, lo);
      *reinterpret_cast<uint32_t*>(pl + p * PS + ii) = hi;
      *reinterpret_cast<uint32_t*>(pl + (P + p) * PS + ii) = mid;
      *reinterpret_cast<uint32_t*>(pl + (2 * P + p) * PS + ii) = lo;
    }
    // row i, columns jj .. jj + 7: one group of 8 per thread
    const int i = tid / (C / 8), jj = 8 * (tid % (C / 8));
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = pack_exact(MaskRows::at(mask_of(s), i, jj + 2 * q, i0, j0, M),
                        MaskRows::at(mask_of(s), i, jj + 2 * q + 1, i0, j0,
                                     M));
    *reinterpret_cast<uint4*>(mt + i * CS + jj) =
        make_uint4(w[0], w[1], w[2], w[3]);
  };

  // warp tile: pairs wm * 32 .. + 31 (2 m-tiles), columns wn * 64 .. + 63
  // (8 n-tiles)
  const int wm = warp & 3, wn = warp >> 2;
  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[m][n][r] = 0.f;

  for (int c = 0; c < NST; ++c) stage(c);
  cp_async_wait<NST - 1>();
  __syncthreads();                        // step 0 and the pair list are in
  build(0);
  for (int c = 0; c < nsteps; ++c) {
    cp_async_wait<NST - 2>();
    // the planes of step c are built, step c + 1 has landed, and the MMAs
    // of step c - 1 are done with the other buffers; step c's slot is
    // consumed and takes step c + NST
    __syncthreads();
    stage(c + NST);
    if (c + 1 < nsteps) build(c + 1);

    const bf16* pl = planes + (c & 1) * 3 * P * PS;
    const bf16* mt = tiles + (c & 1) * KS * CS;
    uint32_t a[2][3][4];                  // [m-tile][hi, mid, lo]
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int row = wm * 32 + m * 16 + (lane & 15);
#pragma unroll
      for (int s = 0; s < 3; ++s)
        ldmatrix_x4(a[m][s], pl + (s * P + row) * PS + (lane >> 4) * 8);
    }
    // B fragments of n-tiles 2 np and 2 np + 1: mask rows (lane & 7) and +8
    const int brow = ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(
          b, mt + brow * CS + wn * 64 + (2 * np + (lane >> 4)) * 8);
      // this k-step's three products from zero, smallest plane first,
      // for the four (n-tile, m-tile) tiles in turn, so that each MMA's
      // predecessor in its chain is three MMAs back
      float d[2][2][4];
#pragma unroll
      for (int s = 2; s >= 0; --s)
#pragma unroll
        for (int hn = 0; hn < 2; ++hn)
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            if (s == 2)
              mma_bf16_zero(d[hn][m], a[m][2], b[2 * hn], b[2 * hn + 1]);
            else
              mma_bf16(d[hn][m], a[m][s], b[2 * hn], b[2 * hn + 1]);
          }
#pragma unroll
      for (int hn = 0; hn < 2; ++hn)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[m][2 * np + hn][r] += d[hn][m][r];
    }
  }
  cp_async_wait<0>();
  __syncthreads();                        // every step is consumed

  // the accumulators into the staging tile (P x SS) over the ring
  float* S = reinterpret_cast<float*>(ring);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int p = wm * 32 + m * 16 + g + 8 * rh;
        *reinterpret_cast<float2*>(S + p * SS + wn * 64 + n * 8 + 2 * t) =
            make_float2(acc[m][n][2 * rh], acc[m][n][2 * rh + 1]);
      }
  __syncthreads();
  // each warp writes whole rows: pair p to (k1, k2) and, off the diagonal,
  // to (k2, k1)
  for (int p = warp; p < P; p += THREADS / 32) {
    const int v = pk[p];
    if (v < 0) continue;                  // warp-uniform: no such pair
    const int k1 = v & 0xffff, k2 = v >> 16;
    float* o1 = gram + ((size_t)k1 * K + k2) * M + j0;
    float* o2 = gram + ((size_t)k2 * K + k1) * M + j0;
#pragma unroll
    for (int q = 0; q < C / 32; ++q) {
      const int jj = lane + 32 * q;
      if (j0 + jj < M) {
        const float x = S[p * SS + jj];
        __stcs(o1 + jj, x);
        if (k1 != k2) __stcs(o2 + jj, x);
      }
    }
  }
}

template <typename MaskT, bool WIDE>
cudaError_t launch_instance(const MaskT* mask, const float* data,
                            const float* R, const float* Rt, int ld,
                            float* gram, float* xty, int N, int M, int K,
                            cudaStream_t stream) {
  const size_t smem = smem_bytes<MaskT, WIDE>(K);
  const long blocks =
      ceil_div(K, XK) + (WIDE ? wide_tiles(K) : ceil_div(pairs(K), P));
  if (ceil_div(M, C) > 65535 || blocks >= 1L << 31)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, ceil_div(M, C));
  cudaError_t err = cudaFuncSetAttribute(
      col_gram_xty_kernel<MaskT, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  col_gram_xty_kernel<MaskT, WIDE><<<grid, THREADS, smem, stream>>>(
      mask, data, R, Rt, ld, gram, xty, N, M, K);
  return cudaGetLastError();
}

template <typename MaskT>
cudaError_t launch(const MaskT* mask, const float* data, const float* R,
                   float* scratch, float* gram, float* xty, int N, int M,
                   int K, cudaStream_t stream) {
  if (K <= NARROW_K)
    return launch_instance<MaskT, false>(mask, data, R, nullptr, 0, gram,
                                         xty, N, M, K, stream);
  // the wide instance reads R^T, written into scratch first
  const int ld = rt_stride(N);
  col_gram_xty_transpose<<<dim3(ceil_div(N, 32), ceil_div(K, 32)),
                           dim3(32, 8), 0, stream>>>(R, scratch, N, K, ld);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_instance<MaskT, true>(mask, data, nullptr, scratch, ld, gram,
                                      xty, N, M, K, stream);
}

}  // namespace

// Floats of scratch that insider_col_gram_xty needs at (N, K): the wide
// instance's R^T, none for the narrow one.
INSIDER_API long insider_col_gram_xty_scratch(int N, int K) {
  return K > NARROW_K ? (long)K * rt_stride(N) : 0;
}

// gram (K, K, M) and xty (K, M) of the masked column update.  mask (N, M)
// f32 or uint8 (mask_is_u8 != 0) with 0/1 entries, data (N, M) and R (N, K)
// f32, all row-major, mask and data 16-byte aligned; scratch: at least
// insider_col_gram_xty_scratch(N, K) floats, 16-byte aligned; 1 <= K <
// 32768, M at most 65535 x 128.
INSIDER_API int insider_col_gram_xty(const void* mask, int mask_is_u8,
                                     const float* data, const float* R,
                                     float* scratch, long scratch_len,
                                     float* gram, float* xty, int N, int M,
                                     int K, cudaStream_t stream) {
  if (N < 1 || M < 1 || K < 1 || K >= 1 << 15 ||
      scratch_len < insider_col_gram_xty_scratch(N, K))
    return (int)cudaErrorInvalidValue;
  return (int)insider::with_mask(mask, mask_is_u8, [&](auto m) {
    return launch(m, data, R, scratch, gram, xty, N, M, K, stream);
  });
}
