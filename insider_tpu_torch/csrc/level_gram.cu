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
// k1 <= k2 only; the second pass mirrors it.  The counts split into exact
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
// of Mw are not 16-byte aligned at odd M), the table planes from a tile of
// F staged by 4-byte cp.async in a ring of two, each pair product once --
// with one barrier per step.  The reduction over M is split across
// gridDim.z column ranges to fill the card; each writes its own
// upper-triangle partial and the second pass adds them in fixed order (no
// atomics: repeated runs agree bit for bit).
#include "common.cuh"
#include "mma.cuh"

namespace {

using insider::ceil_div;
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

// Shared bytes at NTW n-tiles per warp (two warps share an m-tile, so a
// block covers 16 NTW count rows) and CP count planes: the F ring (2 x K x
// JC f32), two buffers of the count planes (CP x 16 NTW x PS bf16) and the
// table planes (3 x PT x PS bf16), then the block's pair list (PT ints).
size_t smem_bytes(int NTW, int K, int CP) {
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
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= L * K * K) return;
  const int Q = K * (K + 1) / 2;
  const int l = o / (K * K), r = o % (K * K);
  const int k1 = min(r / K, r % K), k2 = max(r / K, r % K);
  const int q = k1 * K - k1 * (k1 - 1) / 2 + (k2 - k1);
  const float* p = partial + (size_t)l * Q + q;
  float acc = 0.f;
  for (int z = 0; z < n_parts; ++z) acc += p[(size_t)z * L * Q];
  out[o] = acc;
}

// The kernel at NTW n-tiles per warp, 1 <= NTW <= 9, and CP count planes.
using PartialFn = void (*)(const float*, const float*, float*, int, int, int,
                           int, int);
template <int CP>
PartialFn partial_kernel_cp(int ntw) {
  static const PartialFn fns[9] = {
      level_gram_partial<1, CP>, level_gram_partial<2, CP>,
      level_gram_partial<3, CP>, level_gram_partial<4, CP>,
      level_gram_partial<5, CP>, level_gram_partial<6, CP>,
      level_gram_partial<7, CP>, level_gram_partial<8, CP>,
      level_gram_partial<9, CP>};
  return fns[ntw - 1];
}

PartialFn partial_kernel(int ntw, int cp) {
  return cp == 3 ? partial_kernel_cp<3>(ntw) : partial_kernel_cp<2>(ntw);
}

// The launch plan of a shape: levels per block, n-tiles per warp, count
// planes, column range per block, grid, shared bytes.
struct Plan {
  int LB, ntw, cp, chunk;
  dim3 grid;
  size_t smem;
};

// Blocks of the kernel at (ntw, cp) that the device holds at once at
// `smem` bytes, remembered for the last device, kernel and size asked (a
// fit asks for one).
cudaError_t resident_blocks(int ntw, int cp, size_t smem, int* blocks) {
  static int last_dev = -1, last_ntw = 0, last_cp = 0, last_blocks = 0;
  static size_t last_smem = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != last_dev || ntw != last_ntw || cp != last_cp ||
      smem != last_smem) {
    const PartialFn fn = partial_kernel(ntw, cp);
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
  p->smem = smem_bytes(p->ntw, K, cp);
  int resident = 0;
  cudaError_t err = resident_blocks(p->ntw, cp, p->smem, &resident);
  if (err != cudaSuccess) return err;
  // one wave: as many column ranges as the card holds blocks beside the
  // pair and level tiles, none shorter than four steps
  const int tiles = ceil_div(K * (K + 1) / 2, PT) * level_tiles;
  int splits = resident / tiles;
  splits = splits < ceil_div(M, 4 * JC) ? splits : ceil_div(M, 4 * JC);
  if (splits < 1) splits = 1;
  p->chunk = ceil_div(ceil_div(M, splits), JC) * JC;
  p->grid = dim3(ceil_div(K * (K + 1) / 2, PT), level_tiles,
                 ceil_div(M, p->chunk));
  return cudaSuccess;
}

}  // namespace

// Elements of f32 scratch that insider_level_gram needs (0 where no plan
// exists; insider_level_gram then reports the CUDA error).
INSIDER_API long insider_level_gram_scratch(int L, int M, int K,
                                            int count_planes) {
  Plan p;
  if (L < 1 || M < 1 || K < 1 || (count_planes != 2 && count_planes != 3) ||
      plan(L, M, K, count_planes, &p) != cudaSuccess)
    return 0;
  return (long)p.grid.z * L * (K * (K + 1) / 2);
}

// out (L, K*K) = Mw (L, M) . outer_table(F (K, M))^T, all row-major f32;
// Mw holds integer counts, below 65536 for count_planes = 2, below 2^24 for
// count_planes = 3.
INSIDER_API int insider_level_gram(const float* mw, const float* F, float* out,
                                   float* scratch, long scratch_len, int L,
                                   int M, int K, int count_planes,
                                   cudaStream_t stream) {
  if (L < 1 || M < 1 || K < 1 || (count_planes != 2 && count_planes != 3))
    return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan(L, M, K, count_planes, &p);
  if (err != cudaSuccess) return (int)err;
  if (scratch_len < (long)p.grid.z * L * (K * (K + 1) / 2))
    return (int)cudaErrorInvalidValue;
  partial_kernel(p.ntw, p.cp)<<<p.grid, THREADS, p.smem, stream>>>(
      mw, F, scratch, L, M, K, p.LB, p.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n = L * K * K;
  level_gram_reduce<<<ceil_div(n, 256), 256, 0, stream>>>(scratch, out,
                                                          (int)p.grid.z, L, K);
  return (int)cudaGetLastError();
}
