// feature_sign_fused and cd_fused: the masked column update.  Per gene
// column j it builds the masked gram and Xty from the row factor,
//     G_j = sum_i mask_ij r_i r_i^T,   b_j = sum_i r_i (mask_ij data_ij),
// then solves the elastic net with a solver of fss_core.cuh: the
// feature-sign search (FSS) and its plain-CD polish, or cold strong-rule
// coordinate descent (CD).
//
// Replaces insider_tpu/kernels/fss_pallas.py:feature_sign_fused_pallas
// (bodies _fss_fused_kernel and _fss_compute), insider_tpu/kernels/
// cd_pallas.py:elastic_net_cd_fused_pallas (bodies _cd_fused_kernel and
// _cd_compute) and insider_tpu/kernels/cd_packed.py:
// elastic_net_cd_fused_packed_pallas (the CD iteration with the column axis
// in an (8, BM/8) TPU sublane layout, a layout question that does not arise
// on the GPU).  One coordinate per lane, so K <= 32; larger K takes the
// streamed route, col_gram_xty.cu + fss_streamed.cu, as the JAX package
// does when its fused kernels do not fit.  For CD the caller permutes R's
// columns and beta0's rows to set the sweep order.
//
// Bound on the H100: reading the 134 MB of mask and data (0.040 ms at
// N=377, M=44477), level with the gram build on the tensor cores: N K(K+1)/2
// products per column in three bf16 planes, 15.1 G bf16 FMA (0.031 ms),
// plus Xty's N K f32 FMAs per column (0.012 ms).  The solve is serial per
// column and latency-bound: FSS eliminates a pivots per outer step (a the
// active coordinates), each an a-wide row update; CD up to max_sweeps x K
// dependent coordinate updates.
//
// Design: a block of 8 warps owns CB consecutive columns (FSS 32, CD 64)
// and builds them in batches of 32.  Row chunks of R (transposed), mask and
// data are staged with 4-byte cp.async in a ring of three, two steps ahead
// (rows of the (N, M) inputs are not 16-byte aligned at odd M), so one
// kernel covers any N.  The mask is f32 or uint8 (a template parameter,
// the memory-lean storage of a quarter of the bytes; MaskTile): a uint8
// row starts at any byte, and cp.async moves 4, 8 or 16 aligned bytes, so
// its rows are staged as the aligned 16-byte chunks that cover a batch's
// columns, and each value is widened to f32 where the tile is read.  The
// values are the same 0/1 either way, summed in the same order, so both
// give the same bits.  The grams are the TPU kernel's arithmetic
// (fss_pallas.py:_build_gram_table, _planes_dot): a GEMM
//     G (pairs x columns) = table (pairs x rows) . mask (rows x columns)
// on mma.sync m16n8k16, bf16 in and f32 out, over the K(K+1)/2 pairs
// k1 <= k2 (m-tiles of 16) and a batch's 32 columns (4 n-tiles of 8).
// The table is never stored: each warp builds the A fragments of its own
// m-tiles (tile w, w + 8, ...) from the staged R chunk, one product per
// entry split into three exact bf16 planes (csrc/mma.cuh: split3); the 0/1
// mask is exact in bf16.  Each k-step's three plane products start from
// zero and are added into the running sums in f32 (mma_bf16_zero): the f32
// sum up to its order.  Xty is f32 FMA as in the TPU kernel (precision
// HIGHEST): warp w accumulates coordinates w * K/8 .. for the 32 columns,
// lane = column, in row order.  The ragged column tail (M = 44477) is
// masked in the kernel, not padded.
//
// FSS: the accumulators are scattered into the grams (CB, K, K + 1), both
// triangles, in the shared memory that held the staging ring, and one warp
// solves a column at a time (fss_core.cuh: fss_column, its compacted
// active system in registers, a row a lane, with a pivot-row buffer in
// shared memory), the warps taking the block's columns from a shared
// counter.
//
// CD: each column's upper triangle is scattered packed (fss_core.cuh:
// packed_rows, 300 floats at K=24 where the full form takes 600), so a
// block holds 64 columns in about the room that 32 full ones took; the ring,
// whose steps hold 32 rows, lies over the second batch's grams.  The solve
// is cd_group_columns: P = 32 / L columns a warp, one to each group of L
// lanes, so one issue of the per-coordinate scalar chain serves P columns,
// and a block's 8 warps sweep 8 P columns at once, two blocks an SM at K
// <= 24.  The columns stop at very different sweeps (the cold-CD flagship
// fit's: 63 at the median, 120 at most; chip_smoke.py phase 12), so a
// group whose column converges takes the block's next at the next sweep
// boundary (refill) while the other groups of its warp wait there; group
// g of every warp takes the columns c = g (mod P) from its own counter, so
// the P grams a warp reads lie L (mod 32) floats apart, in distinct banks.
// Every width L gives the same bits.  The width is fixed by K
// (cd_instances: the first listed runs), from times on an NVIDIA H100 80GB
// HBM3 at 700 W (chip_ab.py): in the cold-CD flagship fit (K=24) L = 8
// took 3.04-3.10 ms a launch, L = 16 4.14-4.15 and L = 32 7.25-7.27; a
// replay of the refill schedule on that fit's sweep counts (chip_smoke.py
// phase 12) puts the warps' sweeps at 1.30 times the columns' own at L =
// 8, against 1.53 in lockstep without refill.
#include "fss_core.cuh"
#include "mma.cuh"

namespace {

using insider::cd_group_columns;
using insider::ceil_div;
using insider::cp_async16;
using insider::cp_async4;
using insider::cp_async_commit;
using insider::cp_async_wait;
using insider::group_take;
using insider::load_coords;
using insider::mma_bf16;
using insider::mma_bf16_zero;
using insider::next_column;
using insider::pack_exact;
using insider::packed_rows;
using insider::packed_stride;
using insider::pair_of;
using insider::Rows;
using insider::Solver;
using insider::solve_column;
using insider::split3;
using insider::store_coords;

constexpr int WARPS = 8;       // FSS: the solve takes the columns one at a time
constexpr int BW = 32;         // columns of one build batch: 4 n-tiles of 8
constexpr int NT = BW / 8;
constexpr int MS = BW + 4;     // row stride of the mask and data tiles
constexpr int RING = 3;        // staging steps in flight

// The columns a block owns, in batches of BW, and the rows of a staging
// step (four k-steps of 16 for FSS, two for CD, whose ring lies beside the
// first batch's grams).
template <bool CD>
struct Block {
  static constexpr int BATCHES = CD ? 2 : 1;
  static constexpr int CB = BW * BATCHES;
  static constexpr int RCH = CD ? 32 : 64;
  static constexpr int RS = RCH + 8;    // row stride of the transposed R chunk
};

// A staging step's mask rows: RCH rows of the batch's BW columns, as f32
// (each element copied by a 4-byte cp.async, zeros past the edges) or as
// uint8 (the 16-byte aligned chunks that cover them, CH to a row), read
// back as f32 by at().  Both fit the (RCH, MS) f32 tile.
template <typename MaskT>
struct MaskTile;

template <>
struct MaskTile<float> {
  static __device__ void stage(const float* mask, float* Ms, int RCH,
                               int i0, int jb, int N, int M, int tid) {
    for (int e = tid; e < RCH * BW; e += WARPS * 32) {
      const int i = e / BW, jj = e % BW, j = jb + jj;
      const bool ok = i0 + i < N && j < M;
      cp_async4(Ms + i * MS + jj, ok ? mask + (size_t)(i0 + i) * M + j : mask,
                ok);
    }
  }
  static __device__ float at(const float* Ms, int i, int jj, int, int, int) {
    return Ms[i * MS + jj];
  }
};

template <>
struct MaskTile<uint8_t> {
  static constexpr int CH = (15 + BW + 15) / 16;   // chunks a row
  static_assert(16 * CH <= sizeof(float) * MS, "a row overflows the tile");
  static __device__ void stage(const uint8_t* mask, float* Ms, int RCH,
                               int i0, int jb, int N, int M, int tid) {
    const size_t total = (size_t)N * M;
    unsigned char* dst = reinterpret_cast<unsigned char*>(Ms);
    for (int e = tid; e < RCH * CH; e += WARPS * 32) {
      const int i = e / CH, w = e % CH;
      size_t at = 0;
      int n = 0;
      if (i0 + i < N) {
        at = (((size_t)(i0 + i) * M + jb) & ~(size_t)15) + 16 * (size_t)w;
        if (at < total) n = total - at < 16 ? (int)(total - at) : 16;
      }
      cp_async16(dst + (size_t)i * sizeof(float) * MS + 16 * w,
                 mask + (n ? at : 0), n);
    }
  }
  // element (i, jj) of the batch, 0 past the column edge (rows past N were
  // zero-filled); the row's chunks start (i0 + i) M + jb mod 16 bytes early
  static __device__ float at(const float* Ms, int i, int jj, int i0, int jb,
                             int M) {
    const unsigned o =
        ((unsigned)(i0 + i) * (unsigned)M + (unsigned)jb) & 15u;
    const unsigned char* row =
        reinterpret_cast<const unsigned char*>(Ms + i * MS);
    return jb + jj < M ? static_cast<float>(row[o + jj]) : 0.f;
  }
};

// Shapes of the build at a KMAX: pairs, m-tiles per warp, Xty coordinates
// per warp, and the f32 words of one staging step (R^T, mask, data).
template <int KMAX, bool CD>
struct Build {
  static constexpr int MTILES = (KMAX * (KMAX + 1) / 2 + 15) / 16;
  static constexpr int MTW = (MTILES + WARPS - 1) / WARPS;
  static constexpr int XW = KMAX / WARPS;
  static constexpr int STAGE =
      KMAX * Block<CD>::RS + 2 * Block<CD>::RCH * MS;
};

// Shared-memory layout, in floats.  FSS: the grams (CB, K, K + 1), Xty
// (CB, K) and the solver's workspaces (WARPS of them), in that order, the
// staging ring over them while they are not yet written.  CD: the packed
// grams' row starts (K ints), Xty (CB, K), then the CB packed grams, one
// every S = packed_stride<L>(K) floats, the ring over the last batch's.
template <int KMAX, bool CD>
struct Layout {
  size_t xty, grams, ring, total;
  __host__ __device__ Layout(int K, int S) {
    const size_t ring_floats = RING * (size_t)Build<KMAX, CD>::STAGE;
    constexpr int CB = Block<CD>::CB;
    if (CD) {
      xty = (K + 3) & ~3;
      grams = xty + (((size_t)CB * K + 3) & ~(size_t)3);
      ring = grams + (size_t)(CB - BW) * S;
      const size_t last = (size_t)BW * S;
      total = ring + (last > ring_floats ? last : ring_floats);
    } else {
      const size_t solve =
          (size_t)CB * K * (K + 1) + (size_t)CB * K +
          (size_t)WARPS * Solver<false>::workspace_floats(1, K);
      grams = ring = 0;
      xty = (size_t)CB * K * (K + 1);
      total = solve > ring_floats ? solve : ring_floats;
    }
  }
};

// The CD solve's columns (cd_group_columns' feed): group g of each warp
// takes the block's columns c = g (mod P) from counter g, the packed gram
// of column c at grams + c S and its Xty at Bs + c K.
template <int L>
struct FusedColumns {
  static constexpr int P = 32 / L;
  static constexpr bool REFILL = true;
  int* counters;
  const float* grams;
  const float* Bs;
  const float* beta0_;
  float* out;
  int S, K, M, j0;
  __device__ int next(unsigned mask) {
    const int g = (threadIdx.x & 31) / L;
    const int t = group_take<L>(counters + g, mask);
    const int c = g + P * t;
    return t < Block<true>::CB / P && j0 + c < M ? c : -1;
  }
  __device__ const float* gram(int c) const { return grams + (size_t)c * S; }
  __device__ float xty(int c, int i) const { return Bs[c * K + i]; }
  __device__ float beta0(int c, int i) const {
    return beta0_[(size_t)i * M + j0 + c];
  }
  __device__ void store(int c, int i, float v) const {
    out[(size_t)i * M + j0 + c] = v;
  }
};

// Two blocks per SM where the shared memory allows it (K <= 24): the solve
// is latency-bound, and a second block's warps hide it.  L: the CD solve's
// group width (FSS: 32, unused).  MaskT: float or uint8_t.
template <int KMAX, bool CD, int L, typename MaskT>
__global__ void __launch_bounds__(WARPS * 32, KMAX <= 24 ? 2 : 1)
fused_kernel(const MaskT* __restrict__ mask, const float* __restrict__ data,
             const float* __restrict__ R, const float* __restrict__ beta0,
             float* __restrict__ out, int N, int M, int K,
             Solver<CD> solver, Rows rows) {
  using B = Build<KMAX, CD>;
  using Bk = Block<CD>;
  extern __shared__ __align__(16) float smem[];
  const int GS = K + 1;                   // FSS: the grams' row stride
  const int S = rows.stride;              // CD: one packed gram
  const Layout<KMAX, CD> lay(K, S);
  int* Rs = reinterpret_cast<int*>(smem);  // CD: the packed grams' rows
  float* Bs = smem + lay.xty;             // (CB, K) Xty
  float* ring = smem + lay.ring;
  __shared__ int next[4];                 // the solve's column counters

  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * Bk::CB;
  if (CD)
    for (int a = tid; a < K; a += WARPS * 32) Rs[a] = rows.start[a];

  // 1. grams and Xty of this block's columns, a batch of BW at a time
  // this lane's A-fragment rows: pairs mt * 16 + g and + 8 of each m-tile
  int pa[B::MTW], pb[B::MTW];
#pragma unroll
  for (int u = 0; u < B::MTW; ++u) {
    const int q = (w + WARPS * u) * 16 + g;
    pa[u] = pair_of(q, K);
    pb[u] = pair_of(q + 8, K);
  }
  const int nchunks = (N + Bk::RCH - 1) / Bk::RCH;
#pragma unroll 1
  for (int bt = 0; bt < Bk::BATCHES; ++bt) {
    const int jb = j0 + bt * BW;
    float acc[B::MTW][NT][4];
    float xty[B::XW];
#pragma unroll
    for (int u = 0; u < B::MTW; ++u)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[u][n][r] = 0.f;
#pragma unroll
    for (int u = 0; u < B::XW; ++u) xty[u] = 0.f;

    // staging step c: R^T (KMAX, RS), mask and data (RCH, MS), zeros past
    // the edges (a NaN left in shared memory would survive a zero mask)
    auto stage = [&](int c) {
      if (c >= nchunks) {                 // an empty group keeps the count
        cp_async_commit();
        return;
      }
      float* Rt = ring + (c % RING) * B::STAGE;
      float* Ms = Rt + KMAX * Bk::RS;
      float* Xs = Ms + Bk::RCH * MS;
      const int i0 = c * Bk::RCH;
      for (int e = tid; e < Bk::RCH * K; e += WARPS * 32) {
        const int i = e / K, k = e % K;
        const bool ok = i0 + i < N;
        cp_async4(Rt + k * Bk::RS + i, ok ? R + (size_t)(i0 + i) * K + k : R,
                  ok);
      }
      MaskTile<MaskT>::stage(mask, Ms, Bk::RCH, i0, jb, N, M, tid);
      for (int e = tid; e < Bk::RCH * BW; e += WARPS * 32) {
        const int i = e / BW, jj = e % BW, j = jb + jj;
        const bool ok = i0 + i < N && j < M;
        cp_async4(Xs + i * MS + jj,
                  ok ? data + (size_t)(i0 + i) * M + j : data, ok);
      }
      cp_async_commit();
    };

    stage(0);
    stage(1);
    for (int c = 0; c < nchunks; ++c) {
      cp_async_wait<1>();
      // step c has landed for every thread, and step c - 1 is consumed: its
      // slot, (c + 2) % RING, takes step c + 2
      __syncthreads();
      stage(c + 2);
      const float* Rt = ring + (c % RING) * B::STAGE;
      const float* Ms = Rt + KMAX * Bk::RS;
      const float* Xs = Ms + Bk::RCH * MS;
      const int i0 = c * Bk::RCH;
      auto mask_at = [&](int i, int jj) {
        return MaskTile<MaskT>::at(Ms, i, jj, i0, jb, M);
      };

#pragma unroll
      for (int ks = 0; ks < Bk::RCH; ks += 16) {
        // B fragments: mask rows ks + 2t, +1, +8, +9 of column n * 8 + g
        uint32_t bf[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int i = ks + 2 * t, jj = n * 8 + g;
          bf[n][0] = pack_exact(mask_at(i, jj), mask_at(i + 1, jj));
          bf[n][1] = pack_exact(mask_at(i + 8, jj), mask_at(i + 9, jj));
        }
#pragma unroll
        for (int u = 0; u < B::MTW; ++u) {
          if ((w + WARPS * u) * 16 >= K * (K + 1) / 2) break;  // warp-uniform
          // A fragments: table rows (pairs) pa, pb at rows ks + 2t, +1, +8,
          // +9
          float xa[4], xb[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = ks + 2 * t + 8 * h;
            float2 a1 = make_float2(0.f, 0.f), a2 = a1, b1 = a1, b2 = a1;
            if (pa[u] >= 0) {
              a1 = *reinterpret_cast<const float2*>(
                  Rt + (pa[u] & 0xffff) * Bk::RS + i);
              a2 = *reinterpret_cast<const float2*>(
                  Rt + (pa[u] >> 16) * Bk::RS + i);
            }
            if (pb[u] >= 0) {
              b1 = *reinterpret_cast<const float2*>(
                  Rt + (pb[u] & 0xffff) * Bk::RS + i);
              b2 = *reinterpret_cast<const float2*>(
                  Rt + (pb[u] >> 16) * Bk::RS + i);
            }
            xa[2 * h] = a1.x * a2.x;
            xa[2 * h + 1] = a1.y * a2.y;
            xb[2 * h] = b1.x * b2.x;
            xb[2 * h + 1] = b1.y * b2.y;
          }
          uint32_t a[3][4];
          split3(xa[0], xa[1], a[0][0], a[1][0], a[2][0]);
          split3(xb[0], xb[1], a[0][1], a[1][1], a[2][1]);
          split3(xa[2], xa[3], a[0][2], a[1][2], a[2][2]);
          split3(xb[2], xb[3], a[0][3], a[1][3], a[2][3]);
          // this k-step's three products from zero, smallest plane first
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            float d[4];
            mma_bf16_zero(d, a[2], bf[n][0], bf[n][1]);
            mma_bf16(d, a[1], bf[n][0], bf[n][1]);
            mma_bf16(d, a[0], bf[n][0], bf[n][1]);
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[u][n][r] += d[r];
          }
        }
      }

      // Xty: coordinates w * XW + u of column lane, rows in order (the rows
      // past N are zeros and add nothing); R four rows at a time
#pragma unroll 2
      for (int i = 0; i < Bk::RCH; i += 4) {
        float md[4];
#pragma unroll
        for (int h = 0; h < 4; ++h)
          md[h] = mask_at(i + h, lane) * Xs[(i + h) * MS + lane];
#pragma unroll
        for (int u = 0; u < B::XW; ++u) {
          const float4 r = *reinterpret_cast<const float4*>(
              Rt + (w * B::XW + u) * Bk::RS + i);
          xty[u] = fmaf(r.x, md[0], xty[u]);
          xty[u] = fmaf(r.y, md[1], xty[u]);
          xty[u] = fmaf(r.z, md[2], xty[u]);
          xty[u] = fmaf(r.w, md[3], xty[u]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();                      // every step is consumed

    // scatter into the grams over the drained ring: FSS both triangles,
    // CD the upper one packed
#pragma unroll
    for (int u = 0; u < B::MTW; ++u) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int v = (r < 2) ? pa[u] : pb[u];
        if (v < 0) continue;
        const int k1 = v & 0xffff, k2 = v >> 16;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int cl = bt * BW + n * 8 + 2 * t + (r & 1);
          if (CD) {
            smem[lay.grams + (size_t)cl * S + Rs[k1] + k2 - k1] =
                acc[u][n][r];
          } else {
            smem[((size_t)cl * K + k1) * GS + k2] = acc[u][n][r];
            smem[((size_t)cl * K + k2) * GS + k1] = acc[u][n][r];
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < B::XW; ++u) {
      const int k = w * B::XW + u;
      if (k < K) Bs[(bt * BW + lane) * K + k] = xty[u];
    }
    __syncthreads();          // the batch is written; the ring is free
  }
  if (tid < 4) next[tid] = 0;
  __syncthreads();

  // 2. the solve
  if constexpr (CD) {
    FusedColumns<L> cols{next, smem + lay.grams, Bs, beta0, out, S, K, M,
                         j0};
    cd_group_columns<(KMAX + L - 1) / L, L>(cols, Rs, K, solver.lam,
                                            solver.alpha, solver.tol,
                                            solver.max_sweeps);
  } else {
    // one warp per column
    float* W = smem + lay.xty + (size_t)Bk::CB * K +
               (size_t)w * Solver<false>::workspace_floats(1, K);
    for (;;) {
      const int cl = next_column(next);
      const int j = j0 + cl;
      if (cl >= Bk::CB || j >= M) break;  // warp-uniform
      const float xq[1] = {lane < K ? Bs[cl * K + lane] : 0.f};
      float beta[1];
      load_coords<1>(beta0, K, M, j, beta);
      solve_column<KMAX, 1>(solver, smem + (size_t)cl * K * GS, W, K, GS,
                            xq, beta);
      store_coords<1>(out, K, M, j, beta);
    }
  }
}

template <int KMAX, bool CD, int L>
size_t smem_bytes(int K) {
  return sizeof(float) * Layout<KMAX, CD>(K, packed_stride<L>(K)).total;
}

template <int KMAX, bool CD, int L, typename MaskT>
cudaError_t launch_as(const MaskT* mask, const float* data, const float* R,
                      const float* beta0, float* out, int N, int M, int K,
                      Solver<CD> solver, cudaStream_t stream) {
  const size_t smem = smem_bytes<KMAX, CD, L>(K);
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel<KMAX, CD, L, MaskT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  Rows rows{};                            // CD: the packed grams' rows
  if (CD) {
    packed_rows<L>(K, rows.start);
    rows.stride = packed_stride<L>(K);
  }
  fused_kernel<KMAX, CD, L, MaskT>
      <<<ceil_div(M, Block<CD>::CB), WARPS * 32, smem, stream>>>(
          mask, data, R, beta0, out, N, M, K, solver, rows);
  return cudaGetLastError();
}

// mask: f32, or uint8 when mask_is_u8 (16-byte aligned)
template <int KMAX, bool CD, int L>
cudaError_t launch(const void* mask, int mask_is_u8, const float* data,
                   const float* R, const float* beta0, float* out, int N,
                   int M, int K, Solver<CD> solver, cudaStream_t stream) {
  if (mask_is_u8 && reinterpret_cast<uintptr_t>(mask) % 16)
    return cudaErrorInvalidValue;
  return insider::with_mask(mask, mask_is_u8, [&](auto m) {
    return launch_as<KMAX, CD, L>(m, data, R, beta0, out, N, M, K, solver,
                                  stream);
  });
}

// Calls f(std::integral_constant<int, KMAX>()) with K rounded up to a
// multiple of 8, 1 <= K <= 32.
template <class F>
cudaError_t by_kmax(int K, F&& f) {
  using std::integral_constant;
  if (K <= 8) return f(integral_constant<int, 8>());
  if (K <= 16) return f(integral_constant<int, 16>());
  if (K <= 24) return f(integral_constant<int, 24>());
  return f(integral_constant<int, 32>());
}

// Calls f(kmax, widths...) with the CD instances' group widths L at K's
// KMAX, the one the kernel runs first (header) listed first.
template <class F>
cudaError_t cd_instances(int K, F&& f) {
  using std::integral_constant;
  return by_kmax(K, [&](auto kmax) {
    return f(kmax, integral_constant<int, 8>(), integral_constant<int, 16>(),
             integral_constant<int, 32>());
  });
}

}  // namespace

// out (K, M) = the FSS + polish solution of every column.  data (N, M),
// R (N, K), beta0 (K, M): row-major f32; mask (N, M) row-major 0/1, f32 or
// uint8 (mask_is_u8 != 0; then 16-byte aligned).  l1 = lam*alpha and
// l2 = lam*(1-alpha) as f32; 1 <= K <= 32.
INSIDER_API int insider_fss_fused(const void* mask, int mask_is_u8,
                                  const float* data,
                                  const float* R, const float* beta0,
                                  float* out, float l1, float l2, float tol,
                                  int N, int M, int K, int max_outer,
                                  int polish_sweeps, cudaStream_t stream) {
  if (N < 1 || M < 1 || K < 1 || K > 32) return (int)cudaErrorInvalidValue;
  const Solver<false> solver{l1, l2, tol, max_outer, polish_sweeps};
  return (int)by_kmax(K, [&](auto kmax) {
    return launch<decltype(kmax)::value, false, 32>(
        mask, mask_is_u8, data, R, beta0, out, N, M, K, solver, stream);
  });
}

// out (K, M) = the cold strong-rule CD solution of every column, at most
// max_sweeps sweeps.  data (N, M), R (N, K), beta0 (K, M): row-major f32;
// mask as for insider_fss_fused.  lam, alpha, tol as f32; 1 <= K <= 32.
// lanes: the group width L, 0 for the instance the kernel runs at this K
// (header), else that of an instance covering K (insider_cd_fused_widths;
// cudaErrorInvalidValue where none does).
INSIDER_API int insider_cd_fused(const void* mask, int mask_is_u8,
                                 const float* data,
                                 const float* R, const float* beta0,
                                 float* out, float lam, float alpha, float tol,
                                 int N, int M, int K, int max_sweeps,
                                 int lanes, cudaStream_t stream) {
  if (N < 1 || M < 1 || K < 1 || K > 32) return (int)cudaErrorInvalidValue;
  const Solver<true> solver{lam, alpha, tol, max_sweeps};
  return (int)cd_instances(K, [&](auto kmax, auto... ls) {
    constexpr int KMAX = decltype(kmax)::value;
    cudaError_t err = cudaErrorInvalidValue;
    bool found = false;
    (
        [&](auto l) {
          constexpr int L = decltype(l)::value;
          if (found || (lanes != 0 && lanes != L)) return;
          found = true;
          err = launch<KMAX, true, L>(mask, mask_is_u8, data, R, beta0, out,
                                      N, M, K, solver, stream);
        }(ls),
        ...);
    return err;
  });
}

// The CD instances of insider_cd_fused that cover K, the one it runs
// first: *n of them (at most 3), their group widths L into widths[], and
// where `columns` is given, the columns an SM of the current device
// sweeps at once with each (blocks an SM x 8 warps x 32 / L) into
// columns[].
INSIDER_API int insider_cd_fused_widths(int K, int* n, int* widths,
                                        int* columns) {
  if (K < 1 || K > 32) return (int)cudaErrorInvalidValue;
  *n = 0;
  return (int)cd_instances(K, [&](auto kmax, auto... ls) {
    constexpr int KMAX = decltype(kmax)::value;
    cudaError_t err = cudaSuccess;
    (
        [&](auto l) {
          constexpr int L = decltype(l)::value;
          if (err != cudaSuccess) return;
          if (columns != nullptr) {
            const size_t smem = smem_bytes<KMAX, true, L>(K);
            const auto kernel = fused_kernel<KMAX, true, L, float>;
            int per_sm = 0;
            if ((err = cudaFuncSetAttribute(
                     kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                     (int)smem)) != cudaSuccess ||
                (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &per_sm, kernel, WARPS * 32, smem)) != cudaSuccess)
              return;
            columns[*n] = per_sm * WARPS * (32 / L);
          }
          widths[(*n)++] = L;
        }(ls),
        ...);
    return err;
  });
}
