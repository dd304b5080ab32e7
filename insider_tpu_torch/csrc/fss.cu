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
// Design: a block of 8 warps owns 32 consecutive columns.  Row chunks of R
// (transposed), mask and data are staged with 4-byte cp.async in a ring of
// three, two steps ahead (rows of the (N, M) inputs are not 16-byte aligned
// at odd M), so one kernel covers any N.  The grams are the TPU kernel's arithmetic
// (fss_pallas.py:_build_gram_table, _planes_dot): a GEMM
//     G (pairs x columns) = table (pairs x rows) . mask (rows x columns)
// on mma.sync m16n8k16, bf16 in and f32 out, over the K(K+1)/2 pairs
// k1 <= k2 (m-tiles of 16) and the block's 32 columns (4 n-tiles of 8).
// The table is never stored: each warp builds the A fragments of its own
// m-tiles (tile w, w + 8, ...) from the staged R chunk, one product per
// entry split into three exact bf16 planes (csrc/mma.cuh: split3); the 0/1
// mask is exact in bf16.  Each k-step's three plane products start from
// zero and are added into the running sums in f32 (mma_bf16_zero): the f32
// sum up to its order.  Xty is f32 FMA as in the TPU kernel (precision HIGHEST): warp w
// accumulates coordinates w * K/8 .. for the 32 columns, lane = column, in
// row order.  The accumulators are scattered into the grams (CB, K, K + 1),
// both triangles, in the shared memory that held the staging ring.  The
// solver then runs one warp per column (fss_core.cuh; FSS keeps its
// compacted active system in registers, a row a lane, with a pivot-row
// buffer in shared memory), the warps taking the block's columns one at a
// time from a shared counter.  The ragged column tail
// (M = 44477) is masked in the kernel, not padded.
#include "fss_core.cuh"
#include "mma.cuh"

namespace {

using insider::ceil_div;
using insider::cp_async4;
using insider::cp_async_commit;
using insider::cp_async_wait;
using insider::load_coords;
using insider::mma_bf16;
using insider::mma_bf16_zero;
using insider::next_column;
using insider::pack_exact;
using insider::pair_of;
using insider::Solver;
using insider::solve_column;
using insider::split3;
using insider::store_coords;

constexpr int CB = 32;         // columns per block: 4 n-tiles of 8
constexpr int WARPS = 8;       // the solve takes the CB columns one at a time
constexpr int NT = CB / 8;
constexpr int RCH = 64;        // rows per staged chunk: four k-steps of 16
constexpr int RS = RCH + 8;    // row stride of the transposed R chunk
constexpr int MS = CB + 4;     // row stride of the mask and data tiles

// Shapes of the build at a KMAX: pairs, m-tiles per warp, Xty coordinates
// per warp, and the f32 words of one staging step (R^T, mask, data).
template <int KMAX>
struct Build {
  static constexpr int MTILES = (KMAX * (KMAX + 1) / 2 + 15) / 16;
  static constexpr int MTW = (MTILES + WARPS - 1) / WARPS;
  static constexpr int XW = KMAX / WARPS;
  static constexpr int STAGE = KMAX * RS + 2 * RCH * MS;
};
constexpr int RING = 3;        // staging steps in flight

// Shared-memory floats: the grams (CB, K, K + 1), Xty (CB, K) and the
// solver's workspaces (WARPS of them), in that order; the staging ring of
// the build lies over them while they are not yet written.
template <int KMAX, bool CD>
size_t smem_floats(int K) {
  const int GS = K + 1;
  const size_t solve = (size_t)CB * K * GS + (size_t)CB * K +
                       (size_t)WARPS * Solver<CD>::workspace_floats(1, K);
  const size_t ring = RING * (size_t)Build<KMAX>::STAGE;
  return solve > ring ? solve : ring;
}

// Two blocks per SM where the shared memory allows it (K <= 24): the solve
// is latency-bound, and a second block's warps hide it.
template <int KMAX, bool CD>
__global__ void __launch_bounds__(WARPS * 32, KMAX <= 24 ? 2 : 1)
fused_kernel(const float* __restrict__ mask, const float* __restrict__ data,
             const float* __restrict__ R, const float* __restrict__ beta0,
             float* __restrict__ out, int N, int M, int K,
             Solver<CD> solver) {
  using B = Build<KMAX>;
  extern __shared__ __align__(16) float smem[];
  const int GS = K + 1;
  float* Gs = smem;                       // (CB, K, GS) grams
  float* Bs = Gs + (size_t)CB * K * GS;   // (CB, K) Xty
  float* Ws = Bs + (size_t)CB * K;        // (WARPS, workspace) the solver's
  __shared__ int next;                    // the solve's column counter

  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * CB;

  // 1. grams and Xty of this block's columns
  // this lane's A-fragment rows: pairs mt * 16 + g and + 8 of each m-tile
  int pa[B::MTW], pb[B::MTW];
#pragma unroll
  for (int u = 0; u < B::MTW; ++u) {
    const int q = (w + WARPS * u) * 16 + g;
    pa[u] = pair_of(q, K);
    pb[u] = pair_of(q + 8, K);
  }
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
  const int nchunks = (N + RCH - 1) / RCH;
  auto stage = [&](int c) {
    if (c >= nchunks) {                   // an empty group keeps the count
      cp_async_commit();
      return;
    }
    float* Rt = smem + (c % RING) * B::STAGE;
    float* Ms = Rt + KMAX * RS;
    float* Xs = Ms + RCH * MS;
    const int i0 = c * RCH;
    for (int e = tid; e < RCH * K; e += WARPS * 32) {
      const int i = e / K, k = e % K;
      const bool ok = i0 + i < N;
      cp_async4(Rt + k * RS + i, ok ? R + (size_t)(i0 + i) * K + k : R, ok);
    }
    for (int e = tid; e < RCH * CB; e += WARPS * 32) {
      const int i = e / CB, jj = e % CB, j = j0 + jj;
      const bool ok = i0 + i < N && j < M;
      const size_t at = (size_t)(i0 + i) * M + j;
      cp_async4(Ms + i * MS + jj, ok ? mask + at : mask, ok);
      cp_async4(Xs + i * MS + jj, ok ? data + at : data, ok);
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
    const float* Rt = smem + (c % RING) * B::STAGE;
    const float* Ms = Rt + KMAX * RS;
    const float* Xs = Ms + RCH * MS;

#pragma unroll
    for (int ks = 0; ks < RCH; ks += 16) {
      // B fragments: mask rows ks + 2t, +1, +8, +9 of column n * 8 + g
      uint32_t bf[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* m = Ms + (ks + 2 * t) * MS + n * 8 + g;
        bf[n][0] = pack_exact(m[0], m[MS]);
        bf[n][1] = pack_exact(m[8 * MS], m[9 * MS]);
      }
#pragma unroll
      for (int u = 0; u < B::MTW; ++u) {
        if ((w + WARPS * u) * 16 >= K * (K + 1) / 2) break;  // warp-uniform
        // A fragments: table rows (pairs) pa, pb at rows ks + 2t, +1, +8, +9
        float xa[4], xb[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = ks + 2 * t + 8 * h;
          float2 a1 = make_float2(0.f, 0.f), a2 = a1, b1 = a1, b2 = a1;
          if (pa[u] >= 0) {
            a1 = *reinterpret_cast<const float2*>(Rt + (pa[u] & 0xffff) * RS + i);
            a2 = *reinterpret_cast<const float2*>(Rt + (pa[u] >> 16) * RS + i);
          }
          if (pb[u] >= 0) {
            b1 = *reinterpret_cast<const float2*>(Rt + (pb[u] & 0xffff) * RS + i);
            b2 = *reinterpret_cast<const float2*>(Rt + (pb[u] >> 16) * RS + i);
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
    for (int i = 0; i < RCH; i += 4) {
      float md[4];
#pragma unroll
      for (int h = 0; h < 4; ++h)
        md[h] = Ms[(i + h) * MS + lane] * Xs[(i + h) * MS + lane];
#pragma unroll
      for (int u = 0; u < B::XW; ++u) {
        const float4 r =
            *reinterpret_cast<const float4*>(Rt + (w * B::XW + u) * RS + i);
        xty[u] = fmaf(r.x, md[0], xty[u]);
        xty[u] = fmaf(r.y, md[1], xty[u]);
        xty[u] = fmaf(r.z, md[2], xty[u]);
        xty[u] = fmaf(r.w, md[3], xty[u]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                        // every step is consumed

  // scatter into the grams, both triangles, over the drained ring
#pragma unroll
  for (int u = 0; u < B::MTW; ++u) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int v = (r < 2) ? pa[u] : pb[u];
      if (v < 0) continue;
      const int k1 = v & 0xffff, k2 = v >> 16;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int cl = n * 8 + 2 * t + (r & 1);
        Gs[((size_t)cl * K + k1) * GS + k2] = acc[u][n][r];
        Gs[((size_t)cl * K + k2) * GS + k1] = acc[u][n][r];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < B::XW; ++u) {
    const int k = w * B::XW + u;
    if (k < K) Bs[lane * K + k] = xty[u];
  }
  if (tid == 0) next = 0;
  __syncthreads();

  // 2. the solve, one warp per column
  float* W = Ws + (size_t)w * Solver<CD>::workspace_floats(1, K);
  for (;;) {
    const int cl = next_column(&next);
    const int j = j0 + cl;
    if (cl >= CB || j >= M) break;        // warp-uniform
    const float xq[1] = {lane < K ? Bs[cl * K + lane] : 0.f};
    float beta[1];
    load_coords<1>(beta0, K, M, j, beta);
    solve_column<KMAX, 1>(solver, Gs + (size_t)cl * K * GS, W, K, GS, xq,
                          beta);
    store_coords<1>(out, K, M, j, beta);
  }
}

template <int KMAX, bool CD>
cudaError_t launch(const float* mask, const float* data, const float* R,
                   const float* beta0, float* out, int N, int M, int K,
                   Solver<CD> solver, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<KMAX, CD>(K);
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel<KMAX, CD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fused_kernel<KMAX, CD><<<ceil_div(M, CB), WARPS * 32, smem, stream>>>(
      mask, data, R, beta0, out, N, M, K, solver);
  return cudaGetLastError();
}

template <bool CD>
int fused(const float* mask, const float* data, const float* R,
          const float* beta0, float* out, int N, int M, int K,
          Solver<CD> solver, cudaStream_t stream) {
  if (N < 1 || M < 1 || K < 1 || K > 32) return (int)cudaErrorInvalidValue;
  if (K <= 8)
    return (int)launch<8>(mask, data, R, beta0, out, N, M, K, solver, stream);
  if (K <= 16)
    return (int)launch<16>(mask, data, R, beta0, out, N, M, K, solver,
                           stream);
  if (K <= 24)
    return (int)launch<24>(mask, data, R, beta0, out, N, M, K, solver,
                           stream);
  return (int)launch<32>(mask, data, R, beta0, out, N, M, K, solver, stream);
}

}  // namespace

// out (K, M) = the FSS + polish solution of every column.  mask, data
// (N, M), R (N, K), beta0 (K, M): row-major f32.  l1 = lam*alpha and
// l2 = lam*(1-alpha) as f32; 1 <= K <= 32.
INSIDER_API int insider_fss_fused(const float* mask, const float* data,
                                  const float* R, const float* beta0,
                                  float* out, float l1, float l2, float tol,
                                  int N, int M, int K, int max_outer,
                                  int polish_sweeps, cudaStream_t stream) {
  return fused(mask, data, R, beta0, out, N, M, K,
               Solver<false>{l1, l2, tol, max_outer, polish_sweeps}, stream);
}

// out (K, M) = the cold strong-rule CD solution of every column, at most
// max_sweeps sweeps.  mask, data (N, M), R (N, K), beta0 (K, M): row-major
// f32.  lam, alpha, tol as f32; 1 <= K <= 32.
INSIDER_API int insider_cd_fused(const float* mask, const float* data,
                                 const float* R, const float* beta0,
                                 float* out, float lam, float alpha, float tol,
                                 int N, int M, int K, int max_sweeps,
                                 cudaStream_t stream) {
  return fused(mask, data, R, beta0, out, N, M, K,
               Solver<true>{lam, alpha, tol, max_sweeps}, stream);
}
