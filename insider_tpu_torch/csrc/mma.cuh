// Tensor-core helpers of the gram builds (level_gram.cu, fss.cu,
// col_gram_xty.cu): 4- and 16-byte cp.async staging, the bf16 m16n8k16
// mma.sync with f32 accumulation and its ldmatrix fragment loads, the
// numbering of a gram's upper-triangle pairs, and the exact bf16 splits
// that let f32 sums run on bf16 tensor cores.
//
// A bf16 x bf16 product is exact in f32 (8 + 8 significant bits), so a sum
// of products of exact bf16 planes, accumulated in f32, is the f32 sum of
// the unsplit values up to the order of summation:
//   * split3: an f32 value is hi + mid + lo exactly, each plane rounded to
//     nearest even from the remainder of the one before -- the TPU kernels'
//     _bf16_planes (insider_tpu/kernels/fss_pallas.py:297-303); the plain
//     version is ops/planes.py:bf16_planes;
//   * split_count: an integer count c in [0, 2^24), f32's exact integer
//     range, is hi = 65536 floor(c / 65536), mid = 256 floor((c - hi) /
//     256) and lo = c - hi - mid, each exact in bf16 (8 significant bits);
//     below 65536 hi is 0 and split_count2 gives mid and lo alone;
//   * a 0/1 mask is exact in bf16 as it is.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace insider {
namespace {

// 4-byte asynchronous copy global -> shared.  With valid false nothing is
// read (src may be any mapped address) and the shared word is zeroed.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

// 16-byte asynchronous copy global -> shared (through L2 only) of the
// first n (0 <= n <= 16) bytes of the 16-byte aligned chunk at src; the
// rest of the shared chunk is zeroed, and with n = 0 nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a (16 x 16, row-major) . b (16 x 8, column-major); bf16 in, f32
// accumulate.  Fragments per lane (g = lane / 4, t = lane % 4):
// a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1], a2 = A[g][2t+8, 2t+9],
// a3 = A[g+8][2t+8, 2t+9]; b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g];
// d0 = D[g][2t], d1 = D[g][2t+1], d2 = D[g+8][2t], d3 = D[g+8][2t+1].
// The lower index of a pair sits in the low 16 bits.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b, the same product from a zero accumulator.  The tensor cores
// align the terms of one accumulation to the largest and drop the bits
// below: a long chain of MMAs into one accumulator loses low bits at every
// step.  The builds therefore sum each k-step's few plane products from
// zero and add that into their running f32 sums with a rounded f32 add.
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// Two 8 x 8 bf16 matrices from shared memory; lanes 8m .. 8m + 7 (m < 2)
// give the 16-byte row addresses of matrix m, which lands in r[m].
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            const __nv_bfloat16* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s));
}

// Four 8 x 8 bf16 matrices from shared memory; lanes 8m .. 8m + 7 give the
// 16-byte row addresses of matrix m, which lands in r[m].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The same four matrices transposed: with matrix m stored row by row (8
// rows of 8 bf16), lane l receives its elements (2 (l % 4), l / 4) and
// (2 (l % 4) + 1, l / 4) -- an mma B fragment from a row-major (k x n) tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// (x0, x1) rounded to nearest even into one bf16 pair, x0 in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The pair's halves back in f32 (exact).
__device__ __forceinline__ float low_f32(uint32_t p) {
  return __uint_as_float(p << 16);
}
__device__ __forceinline__ float high_f32(uint32_t p) {
  return __uint_as_float(p & 0xffff0000u);
}

// Two values whose low 16 bits are zero (0/1, or any bf16 value held in
// f32) packed into one bf16 pair without rounding.
__device__ __forceinline__ uint32_t pack_exact(float x0, float x1) {
  return __byte_perm(__float_as_uint(x0), __float_as_uint(x1), 0x7632);
}

// The exact three-plane split of (x0, x1): hi + mid + lo == x.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  x0 -= low_f32(hi);
  x1 -= high_f32(hi);
  mid = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - low_f32(mid), x1 - high_f32(mid));
}

// (k1, k2) of pair q of the upper triangle k1 <= k2 of a K x K gram, the
// pairs numbered row by row (row k1 starts at k1 K - k1 (k1 - 1) / 2),
// packed k1 | k2 << 16; -1 past the last pair.  The row comes from the
// quadratic's root, corrected in integers.
__device__ __forceinline__ int pair_of(int q, int K) {
  if (q >= K * (K + 1) / 2) return -1;
  const float b = 2.f * K + 1.f;
  int k1 = (int)(0.5f * (b - sqrtf(b * b - 8.f * q)));
  k1 = max(0, min(k1, K - 1));
  while (k1 > 0 && k1 * K - k1 * (k1 - 1) / 2 > q) --k1;
  while ((k1 + 1) * K - (k1 + 1) * k1 / 2 <= q) ++k1;
  return k1 | ((k1 + q - (k1 * K - k1 * (k1 - 1) / 2)) << 16);
}

// The exact two-plane split of integer counts in [0, 65536): hi = 256
// floor(c / 256) and lo = c - hi.
__device__ __forceinline__ void split_count2(float c0, float c1, uint32_t& hi,
                                             uint32_t& lo) {
  const float h0 = floorf(c0 * (1.f / 256.f)) * 256.f;
  const float h1 = floorf(c1 * (1.f / 256.f)) * 256.f;
  hi = pack_exact(h0, h1);
  lo = pack_exact(c0 - h0, c1 - h1);
}

// The exact three-plane split of integer counts in [0, 2^24): every step
// (a power-of-two scale, floor, difference) is exact in f32.
__device__ __forceinline__ void split_count(float c0, float c1, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  const float h0 = floorf(c0 * (1.f / 65536.f)) * 65536.f;
  const float h1 = floorf(c1 * (1.f / 65536.f)) * 65536.f;
  const float r0 = c0 - h0, r1 = c1 - h1;
  const float m0 = floorf(r0 * (1.f / 256.f)) * 256.f;
  const float m1 = floorf(r1 * (1.f / 256.f)) * 256.f;
  hi = pack_exact(h0, h1);
  mid = pack_exact(m0, m1);
  lo = pack_exact(r0 - m0, r1 - m1);
}

}  // namespace
}  // namespace insider
