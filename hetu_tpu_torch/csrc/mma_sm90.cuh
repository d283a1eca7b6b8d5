// Device helpers shared by the port's kernels: fp32 / bf16 conversions and
// cp.async staging (flash_attn.cu, lm_head_ce.cu, paged_decode.cu,
// fused_ln.cu), the TF32 split of the 3xTF32 products, mma.sync and
// ldmatrix (the tensor-core kernels).  Everything sits in
// an anonymous namespace, so each translation unit that includes this
// header gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes global -> shared, bypassing L1; bytes < 16 zero-fills the rest
// (0: nothing is read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}
// 4 bytes global -> shared; bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo: hi is x rounded to TF32; lo, the exact remainder, is passed
// as it is (the tensor core reads its top 19 bits, an error of at most
// 2^-21 of x).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// The same split with hi = x truncated to TF32 (its low 13 bits cleared):
// one logic op where cvt.rna is a longer sequence.  lo, at most 2^-10 of
// x, is still exact, and a 3xTF32 product keeps about 20 bits.
__device__ __forceinline__ void split_tf32_trunc(float x, uint32_t& hi,
                                                 uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c (16 x 8, fp32) += a (16 x 16) b (16 x 8), bf16.  Fragments as in the
// PTX ISA, g = lane / 4, t = lane % 4: A (g, 2t), (g+8, 2t), (g, 2t+8),
// (g+8, 2t+8), each a pair along k; B (k = 2t, n = g), (2t+8, g); C (g,
// 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c (16 x 8, fp32) += a (16 x 8) b (8 x 8), TF32: A (g, t), (g+8, t),
// (g, t+4), (g+8, t+4); B (k = t, n = g), (t+4, g); C as mma_bf16.
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 16-byte matrices; lane 8j + r gives the address of row r of
// matrix j, and lane 4g + t receives 32-bit word t of row g of each.  On
// fp32 rows that word is element (g, t): the TF32 fragment layout.
__device__ __forceinline__ void ldmatrix_x4(const void* p, uint32_t r[4]) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(const bf16* p,
                                                  uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2,
                                                  uint32_t& r3) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(s));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats rounded to bf16 in one 32-bit register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace
