// Tensor-core building blocks shared by attention.cu, vit_block.cu and
// mamba_fused.cu (sm_90a): warp-level mma.sync products, the 3xTF32 split
// of an fp32 operand, ldmatrix loads, and cp.async copies into shared
// memory.
//
// Precision policy. An fp32 product runs in 3xTF32: each fp32 operand x is
// split in registers into hi = tf32(x) (cvt.rna) and lo = tf32(x - hi), and
// a*b is accumulated as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b into fp32, the
// small terms first. That keeps about 21 bits of each operand, where one
// TF32 product keeps 10 and misses the port's 1e-4 checks; the dropped
// lo_a*lo_b term is below fp32 rounding. bf16 operands go to the bf16 MMA as
// they are: a bf16 x bf16 product is exact in fp32, so only the order of the
// fp32 sums changes.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k8" and
// "mma.m16n8k16"), with g = lane / 4 and t = lane % 4:
//   m16n8k8 tf32   A: a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//                  B: b0 (k=t, n=g)  b1 (k=t+4, n=g)
//   m16n8k16 bf16  A: a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                     a3 (g+8, 2t+8..)
//                  B: b0 (k=2t..2t+1, n=g)  b1 (k=2t+8..2t+9, n=g)
//   C (both)       c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
//
// Everything here has internal linkage: each source that includes it gets
// its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {
namespace tc {

// fp32 -> tf32, rounded to nearest (ties away), as a 32-bit pattern.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The 3xTF32 split of x: hi + lo carries about 21 of x's 24 bits.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// An fp32 operand fragment of n registers, split.
template <int N>
struct Split {
  uint32_t hi[N], lo[N];
  __device__ __forceinline__ void set(int i, float x) { split(x, hi[i], lo[i]); }
};

// d += a b, m16n8k8, tf32 operands, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the two small cross terms first, then hi x hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const Split<4>& a,
                                           const Split<2>& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// d += a b, m16n8k16, bf16 operands (two to a register), fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Accumulator tiles (N m16n8 tiles of 4 floats a thread): cleared, and one
// added into another by fp32 adds. A long reduction takes its MMAs a tile
// at a time into cleared accumulators and adds them up here: the tensor
// cores truncate inside their sums, and a sum kept in their accumulators
// over thousands of MMAs drifts toward zero.
template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.0f;
}
template <int N>
__device__ __forceinline__ void add_to(float (&a)[N][4],
                                       const float (&b)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] += b[i][e];
}

// Two floats as a bf16 pair, lo in the low half (the lower column or k).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The B fragments of two neighbouring n8 tiles of a bf16 operand stored
// k-rows x n-columns in shared memory (n contiguous, rows 16-byte aligned):
// rows k0 .. k0+15, columns n0 .. n0+15; b[0..1] for columns n0 .. n0+7,
// b[2..3] for n0+8 .. n0+15. Lane l passes the address of row
// k0 + (l & 7) + 8 * ((l >> 3) & 1), column n0 + 8 * (l >> 4).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&b)[4],
                                              const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(a));
}

// Four 8 x 4 fp32 (tf32) matrices from shared memory, each 8 rows of 16
// bytes, by ldmatrix of b16 pairs: lane l passes the address of row l % 8
// of matrix l / 8 and gets element (l / 4, l % 4) of matrix i in r[i],
// which is a tf32 A fragment's a0..a3 (rows along m, k contiguous) or two
// B fragments' b0, b1 (rows along n, k contiguous).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows r0 .. r0+ROWS-1 of a (L, HD) slice whose row r starts at
// src + r * ld (elements), into dst[ROWS][SP], zeros past row L; by the
// NT threads of the block, one 16-byte chunk at a time (cp.async).
template <typename T, int HD, int ROWS, int SP, int NT>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long ld,
                                          int r0, int L) {
  constexpr int kChunks = HD * static_cast<int>(sizeof(T)) / 16;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += NT) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * (16 / static_cast<int>(sizeof(T)));
    const bool valid = r0 + r < L;
    cp_async16(dst + r * SP + c,
               valid ? src + static_cast<long long>(r0 + r) * ld + c : src,
               valid);
  }
}

constexpr float kLog2e = 1.4426950408889634f;

}  // namespace tc
}  // namespace
