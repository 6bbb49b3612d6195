// Device helpers shared by the flash-attention kernels (flash_fwd.cu and
// flash_bwd_{bf16,f32}.cu): tile constants, cp.async copies into shared memory,
// ldmatrix, the bf16 mma.sync and its packing, and the TF32 mma.sync in
// split TF32 that both f32 kernels compute with. Header-only and included
// by one source of each library, so everything is inline.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int BLOCK_M = 64;   // query rows per block
constexpr int BLOCK_N = 64;   // kv rows per tile
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;
constexpr float MASK_GATE = -5e29f;  // NEG_INF * 0.5, the TPU kernel's gate
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

// 64-row tiles covering t rows (BLOCK_M == BLOCK_N)
__host__ __device__ __forceinline__ int n_tiles(int t) { return (t + BLOCK_M - 1) / BLOCK_M; }

// ------------------------------------------------------------- shared ----
// Shared memory is addressed with 32-bit shared-window addresses: a thread
// computes its own base once, and every tile offset is a compile-time
// immediate of the instruction.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with !pred nothing is read and zeros land
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 16 : 0) : "memory");
}

// 4 bytes global -> shared, zero-filled when !pred
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ROWS rows of a [T, D] slice (token stride `st`) into a tile of padded
// rows of ROW bytes, 16 bytes a thread, RS rows a pass of the block. This
// thread loads one chunk of rows first_row + i*RS: `dst` and `src` are its
// chunk of the first. Rows at or past `limit` are zero-filled (read from
// `any`, a valid address, with size 0).
template <int RS, int ROW, int ROWS = BLOCK_M, typename T>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* src, int64_t st,
                                          int first_row, int limit, const T* any) {
  static_assert(ROWS % RS == 0, "a pass of the block loads RS whole rows");
#pragma unroll
  for (int i = 0; i < ROWS / RS; ++i) {
    const bool ok = first_row + i * RS < limit;
    cp_async16(dst + i * RS * ROW, ok ? src + i * RS * st : any, ok);
  }
}

// ------------------------------------------------------------- mma.sync ----

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to nearest even, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------ split TF32 ----
// A tensor core reads an f32 operand as TF32 (10 mantissa bits). The f32
// kernels keep f32 accuracy by splitting each operand x into hi = x rounded
// to TF32 and lo = x - hi truncated to TF32, and taking each product step as
// three mma: a_lo*b_hi, a_hi*b_lo, then a_hi*b_hi, accumulated in f32 (the
// dropped a_lo*b_lo is about 2^-22 of the product).

// x = hi + lo in TF32 parts (10 mantissa bits each, low 13 bits zero): hi
// is x rounded to nearest with ties away from zero, the bits cvt.rna.tf32
// gives for finite x; lo is x - hi (exact in f32) truncated. Two integer
// ops and a subtraction a part: cvt.rna compiles to several instructions
// (it also handles NaN and Inf), and the split is most of the ALU work.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// c += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One product step in split TF32: c += a * b as a_lo*b_hi + a_hi*b_lo +
// a_hi*b_hi, the small terms first. a: the A fragment, split; b0, b1: the
// B fragment, as f32.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(c, a_lo, bh0, bh1);
  mma_tf32(c, a_hi, bl0, bl1);
  mma_tf32(c, a_hi, bh0, bh1);
}

}  // namespace flash
