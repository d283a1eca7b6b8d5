// Fused LM-head cross entropy, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of hetu_tpu/ops/pallas/lm_head.py:
//   forward  _head_fwd (_fwd_kernel): per row, the logsumexp of
//            h @ W^T + b over the vocabulary and the label's logit;
//   backward _head_bwd (_dh_kernel, _dw_kernel): with
//            t = (softmax - onehot(y)) * dnll,  dh = t @ W,  dW = t^T @ h,
//            db = colsum(t).
// h is (N, E); W is read, and dW written, in the embedding's (V, E)
// layout, so the tied head needs no transposed copy of the weight.  fp32
// or bf16 inputs; products accumulate in fp32; as in the TPU kernels, t is
// rounded to the inputs' type before the gradient products (a no-op in
// fp32).  The (N, V) logits never reach device memory.
//
// Bound on the H100 (80GB HBM3, 700 W): operations.  At N = 8184,
// E = 768, V = 50257 the logits are 2*N*E*V = 6.3e11 flops over 180 MB of
// fp32 operands, 3500 flops a byte.  fp32-accurate products run on the
// TF32 tensor cores as 3xTF32 (below): 495 / 3 = 165 TFLOP/s, so the
// forward's bound is 3.83 ms and the backward's, three products of that
// size (the logits once, t @ W, t^T @ h), 11.49 ms.  bf16 runs at 989
// TFLOP/s: 0.64 and 1.92 ms.  fp32 on the SIMT units (67 TFLOP/s) could
// not do better than 9.43 and 28.29 ms.
//
// Design.  One tensor-core GEMM mainloop (tile_mma) serves every product:
// a 128 x 128 block tile of eight warps, the accumulators in registers,
// operand slabs of 128 bytes along K (32 fp32 or 64 bf16) staged by
// cp.async into a ring of four shared-memory stages, rows padded so that
// fragment loads are free of bank conflicts.  An operand is read K-major
// (K contiguous: h and W in the logits, t in dh) or M/N-major (t^T in dW,
// W in dh, h in dW); the padding differs, the staging does not.
//  - fp32: wgmma m64n128k8 TF32 in the 3xTF32 split, two warpgroups of 64
//    rows.  Each fp32 value x becomes hi = cvt.rna.tf32(x) and lo = x - hi
//    (about 22 bits of x), and a product is lo*hi + hi*lo + hi*hi.  A
//    comes from registers, split there; B, which wgmma reads from shared
//    memory K-major only, is split by the block into TF32 hi and lo planes
//    in the no-swizzle K-major layout, transposing W (dh) and h (dW) on
//    the way, one slab ahead while the tensor cores run.  The tensor
//    core's fp32 accumulation truncates, so each slab is summed into fresh
//    registers and added to the accumulator by a rounding fp32 add: the
//    truncation's drift stays within a slab.  One-pass TF32 keeps 11 bits
//    and is not this function (chip_smoke.py's control shows it).
//  - bf16: mma.sync m16n8k16, fp32 accumulation, warps of 64 x 32; the
//    M/N-major operands go through ldmatrix.trans.
// Forward: grid (row tiles of 128, vocab chunks).  Blocks of one chunk run
// together (the row tile is the fast grid axis), so each chunk of W comes
// from memory about once while h (25 MB) stays in the 50 MB L2.  A block
// walks its chunk's 128-column tiles; each thread keeps an online (max,
// normalizer, label logit) for its own rows and columns, merged across
// the block in a fixed order at the end; a second pass merges the
// chunks' partials of each row in order.
// Backward: the vocabulary in chunks of vchunk columns, in order; for each
// chunk three launches of the same mainloop:
//  (a) t pass: T_c = round((exp(h W_c^T + b_c - lse) - onehot) * g),
//      written (N, vchunk) in the inputs' type;
//  (b) dh: dh_acc (N, E) fp32 += T_c @ W_c, an epilogue that reads, adds
//      and writes; the last chunk writes dh in the inputs' type (in fp32
//      dh is its own accumulator);
//  (c) dW: dW_c = T_c^T @ h (K = N), and db_c, the column sums of T_c
//      taken by the blocks of the first E tile as the slabs stream by.
// The logits are computed once.  No atomics and no shared-memory
// accumulator: every sum has a fixed order, so a rerun gives bitwise the
// same gradients, and E has no limit.
// Scratch, all from the caller: the forward's partials (3 x N x chunks
// fp32); the backward's T_c (N x vchunk, inputs' type: 239 MB at N = 8184,
// V = 50257 in fp32, seven chunks of 7296) and, for bf16, the fp32 dh
// accumulator (N x E).
// Rows with E * sizeof(T) not a multiple of 16 bytes are staged by plain
// loads instead of cp.async; the ragged edges of N, V and E are zero-
// filled in shared memory and masked in the epilogues.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 128;         // block tile: rows and columns
constexpr int kThreads = 256;      // 8 warps
constexpr int kStages = 4;         // cp.async ring depth
constexpr int kStageBytes = 18432; // one operand's slab, larger layout
constexpr int kSplitFloats = 128 * 32;  // one TF32 plane of a B slab
// Dynamic shared memory: the cp.async ring of A and B slabs and, in fp32,
// two slabs of B split into TF32 hi and lo planes for wgmma.
template <typename T> constexpr int smem_bytes() {
  return 2 * kStages * kStageBytes +
         (sizeof(T) == 4 ? 2 * 2 * kSplitFloats * 4 : 0);
}
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// A row-major matrix: rows x cols valid elements, leading dimension ld.
template <typename T> struct Mat {
  const T* p;
  int64_t ld;
  int rows, cols;
};

// Shared-memory layout of one operand slab.  K-major: 128 rows (M or N)
// of kK values; M/N-major: kK rows of 128 values.
template <typename T, bool kKMajor> struct Layout {
  static constexpr int kK = 128 / (int)sizeof(T);
  static constexpr int kRows = kKMajor ? kTile : kK;
  static constexpr int kCols = kKMajor ? kK : kTile;
  static constexpr int kStride =
      kKMajor ? kK + 16 / (int)sizeof(T) : kTile + 8;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [r0, r0 + R) x cols [c0, c0 + C) of m into s (row stride S),
// zero outside m.  vec: 16-byte cp.async (m.p and m.ld 16-byte aligned);
// else plain loads and stores.
template <typename T, int R, int C, int S>
__device__ __forceinline__ void load_tile(T* s, const Mat<T>& m, int r0,
                                          int c0, bool vec) {
  constexpr int kV = 16 / (int)sizeof(T);
  constexpr int kPerRow = C / kV;
  static_assert(R * kPerRow % kThreads == 0, "whole copies per thread");
  if (vec) {
#pragma unroll
    for (int it = 0; it < R * kPerRow / kThreads; ++it) {
      const int i = it * kThreads + threadIdx.x;
      const int r = i / kPerRow, c = (i % kPerRow) * kV;
      const int gr = r0 + r, gc = c0 + c;
      const T* src = m.p;
      int bytes = 0;
      if (gr < m.rows && gc < m.cols) {
        bytes = min(kV, m.cols - gc) * (int)sizeof(T);
        src = m.p + (int64_t)gr * m.ld + gc;
      }
      cp_async16(s + r * S + c, src, bytes);
    }
  } else {
    for (int i = threadIdx.x; i < R * C; i += kThreads) {
      const int r = i / C, c = i % C, gr = r0 + r, gc = c0 + c;
      s[r * S + c] = (gr < m.rows && gc < m.cols)
                         ? m.p[(int64_t)gr * m.ld + gc]
                         : from_f<T>(0.f);
    }
  }
}

// x = hi + lo: hi is x rounded to TF32; lo, the exact remainder, is passed
// as it is (the tensor core reads its top 19 bits, an error of at most
// 2^-21 of x).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// wgmma descriptor of a no-swizzle K-major operand: 8 x 16-byte core
// matrices of 128 bytes; the next core matrix along K 128 bytes on (LBO),
// the next 8 rows 1024 bytes on (SBO).
__device__ __forceinline__ uint64_t wgmma_desc(const float* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32);
}

// d (64 x 128 per warpgroup, fp32) += a (registers, the m16n8k8 A layout
// per warp) x b (shared memory, 128 x 8 K-major), TF32.
__device__ __forceinline__ void wgmma_tf32(float d[64], const uint32_t a[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of r across the async wgmma.
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
// Orders this thread's shared-memory stores before wgmma reads them.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

// One bf16 slab of the warp's 64 x 32 product: acc[i][j] is the m16n8
// tile at rows wm*64 + 16i, columns wn*32 + 8j.  Fragment layouts as in
// the PTX ISA for m16n8k16: A (g, 2t), (g+8, 2t), (g, 2t+8), (g+8, 2t+8),
// B (k = 2t, n = g), (2t+8, g), each a pair along k; g = lane/4,
// t = lane%4.  A k step loads all its fragments first, then issues its
// products, so that consecutive mma.sync are independent.
template <bool kKA, bool kKB>
__device__ __forceinline__ void slab_mma(const bf16* sa, const bf16* sb,
                                         float acc[4][4][4], int wm, int wn,
                                         int lane) {
  constexpr int SA = Layout<bf16, kKA>::kStride;
  constexpr int SB = Layout<bf16, kKB>::kStride;
  const int g = lane >> 2, t = lane & 3;
  const int q = lane & 7, mat = lane >> 3;  // ldmatrix: row, matrix
#pragma unroll
  for (int k0 = 0; k0 < 64; k0 += 16) {
    uint32_t b[4][2];
    if (kKB) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* p = sb + (wn * 32 + j * 8 + g) * SB + k0 + 2 * t;
        b[j][0] = ld32(p);
        b[j][1] = ld32(p + 8);
      }
    } else {
      // matrices: (k0, n), (k0 + 8, n), (k0, n + 8), (k0 + 8, n + 8)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int k = k0 + q + 8 * (mat & 1);
        const int n = wn * 32 + jj * 16 + 8 * (mat >> 1);
        ldmatrix_x4_trans(sb + k * SB + n, b[2 * jj][0], b[2 * jj][1],
                          b[2 * jj + 1][0], b[2 * jj + 1][1]);
      }
    }
    uint32_t a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m0 = wm * 64 + i * 16;
      if (kKA) {
        const bf16* p = sa + (m0 + g) * SA + k0 + 2 * t;
        a[i][0] = ld32(p);
        a[i][1] = ld32(p + 8 * SA);
        a[i][2] = ld32(p + 8);
        a[i][3] = ld32(p + 8 * SA + 8);
      } else {
        // matrices: (k0, m0), (k0, m0 + 8), (k0 + 8, m0), (k0 + 8, m0 + 8)
        const int k = k0 + q + 8 * (mat >> 1);
        const int m = m0 + 8 * (mat & 1);
        ldmatrix_x4_trans(sa + k * SA + m, a[i][0], a[i][1], a[i][2],
                          a[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
  }
}

struct NoSlabHook {
  template <typename T> __device__ void operator()(const T*) const {}
};

// Stage slab k of A and B (the tiles at a0 and b0, K-major or not) into
// ring stage `stage`.
template <typename T, bool kKA, bool kKB>
__device__ __forceinline__ void load_slab(T* sa, T* sb, int stage, int k,
                                          const Mat<T>& A, bool vec_a,
                                          int a0, const Mat<T>& B,
                                          bool vec_b, int b0) {
  using LA = Layout<T, kKA>;
  using LB = Layout<T, kKB>;
  constexpr int kK = LA::kK;
  constexpr int kElems = kStageBytes / (int)sizeof(T);
  T* da = sa + stage * kElems;
  T* db = sb + stage * kElems;
  if (kKA)
    load_tile<T, LA::kRows, LA::kCols, LA::kStride>(da, A, a0, k * kK, vec_a);
  else
    load_tile<T, LA::kRows, LA::kCols, LA::kStride>(da, A, k * kK, a0, vec_a);
  if (kKB)
    load_tile<T, LB::kRows, LB::kCols, LB::kStride>(db, B, b0, k * kK, vec_b);
  else
    load_tile<T, LB::kRows, LB::kCols, LB::kStride>(db, B, k * kK, b0, vec_b);
}

// Split a staged fp32 B slab (128 x 32; K-major or N-major) into TF32 hi
// and lo planes in the no-swizzle K-major layout wgmma reads: element
// (n, k) at (n/8)*256 + (k/4)*32 + (n%8)*4 + k%4 floats.  A thread does
// four 16-byte chunks (4 k of one row); consecutive threads write
// consecutive chunks and read from distinct banks.
template <bool kKB>
__device__ __forceinline__ void split_b(const float* sb, float* hi,
                                        float* lo) {
  constexpr int SB = Layout<float, kKB>::kStride;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int c = it * kThreads + threadIdx.x;
    const int r = c & 7;
    const int kc = kKB ? (c >> 3) & 7 : c >> 7;
    const int g8 = kKB ? c >> 6 : (c >> 3) & 15;
    const int n = g8 * 8 + r, k = kc * 4;
    float x[4];
    if (kKB) {
      const float4 v = *reinterpret_cast<const float4*>(sb + n * SB + k);
      x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = sb[(k + e) * SB + n];
    }
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(x[e], h[e], l[e]);
    const int at = g8 * 256 + kc * 32 + r * 4;
    *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The shared mainloop: acc = A[a0 : a0 + 128] . B[b0 : b0 + 128] over K.
// kKA: A is (M, K) row-major, tile rows a0..; else A is stored (K, M) and
// the tile is its columns a0...  kKB likewise for B as (N, K) or (K, N).
// hook(sa) sees each staged A slab once.  Ends with a barrier, so the
// caller may reuse the shared memory.
//
// fp32: two warpgroups of 64 rows, each a wgmma m64n128k8 TF32 per term
// and k step, A from registers (split there), B from its hi and lo planes,
// which the block splits one slab ahead while the tensor cores run.  The
// tensor core's fp32 accumulation truncates, so each slab is summed into
// fresh registers and added to acc by a rounding fp32 add: over a long K
// (N = 8184 in dW) the sum would otherwise drift toward zero.
template <bool kKA, bool kKB, typename Hook>
__device__ __forceinline__ void tile_wgmma(const Mat<float>& A, bool vec_a,
                                           int a0, const Mat<float>& B,
                                           bool vec_b, int b0, int K,
                                           float* smem, float* acc,
                                           Hook hook) {
  using LA = Layout<float, kKA>;
  constexpr int kK = LA::kK;
  constexpr int kElems = kStageBytes / 4;
  constexpr int SA = LA::kStride;
  float* sa = smem;
  float* sb = smem + kStages * kElems;
  float* split = smem + 2 * kStages * kElems;  // [slab % 2][hi, lo]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m = (warp >> 2) * 64 + (warp & 3) * 16 + g;
#pragma unroll
  for (int x = 0; x < 64; ++x) acc[x] = 0.f;
  const int nk = (K + kK - 1) / kK;
  auto load = [&](int stage, int k) {
    load_slab<float, kKA, kKB>(sa, sb, stage, k, A, vec_a, a0, B, vec_b, b0);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_commit();
  }
  cp_wait<kStages - 2>();
  __syncthreads();
  split_b<kKB>(sb, split, split + kSplitFloats);
  fence_async_smem();
  __syncthreads();
  for (int k = 0; k < nk; ++k) {
    const float* st = sa + (k % kStages) * kElems;
    hook(st);
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int mm = m + 8 * (q & 1), kk = 8 * s + t + 4 * (q >> 1);
        split_tf32(kKA ? st[mm * SA + kk] : st[kk * SA + mm], ah[s][q],
                   al[s][q]);
      }
    const float* hi = split + (k & 1) * 2 * kSplitFloats;
    const float* lo = hi + kSplitFloats;
    float part[64];
#pragma unroll
    for (int x = 0; x < 64; ++x) {
      part[x] = 0.f;
      reg_fence(part[x]);
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      wgmma_tf32(part, al[s], wgmma_desc(hi + s * 64));
      wgmma_tf32(part, ah[s], wgmma_desc(lo + s * 64));
      wgmma_tf32(part, ah[s], wgmma_desc(hi + s * 64));
    }
    wgmma_commit();
    if (k + 1 < nk) {
      cp_wait<kStages - 3>();  // slab k + 1 has landed
      __syncthreads();
      const int next = k + kStages - 1;
      if (next < nk) load(next % kStages, next);
      cp_commit();
      float* nhi = split + ((k + 1) & 1) * 2 * kSplitFloats;
      split_b<kKB>(sb + ((k + 1) % kStages) * kElems, nhi,
                   nhi + kSplitFloats);
      fence_async_smem();
    }
    wgmma_wait();
#pragma unroll
    for (int x = 0; x < 64; ++x) {
      reg_fence(part[x]);
      acc[x] += part[x];
    }
    __syncthreads();
  }
  cp_wait<0>();
  __syncthreads();
}

template <typename T, bool kKA, bool kKB, typename Hook = NoSlabHook>
__device__ __forceinline__ void tile_mma(const Mat<T>& A, bool vec_a,
                                         int a0, const Mat<T>& B,
                                         bool vec_b, int b0, int K, T* smem,
                                         float acc[4][4][4],
                                         Hook hook = Hook()) {
  if constexpr (sizeof(T) == 4) {
    tile_wgmma<kKA, kKB>(A, vec_a, a0, B, vec_b, b0, K, smem, &acc[0][0][0],
                         hook);
    return;
  } else {
    constexpr int kK = Layout<T, kKA>::kK;
    constexpr int kElems = kStageBytes / (int)sizeof(T);
    T* sa = smem;
    T* sb = smem + kStages * kElems;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
    const int nk = (K + kK - 1) / kK;
    auto load = [&](int stage, int k) {
      load_slab<T, kKA, kKB>(sa, sb, stage, k, A, vec_a, a0, B, vec_b, b0);
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) load(s, s);
      cp_commit();
    }
    for (int k = 0; k < nk; ++k) {
      cp_wait<kStages - 2>();
      __syncthreads();
      const int next = k + kStages - 1;
      if (next < nk) load(next % kStages, next);
      cp_commit();
      const int s = k % kStages;
      hook(sa + s * kElems);
      slab_mma<kKA, kKB>(sa + s * kElems, sb + s * kElems, acc, wm, wn,
                         lane);
    }
    cp_wait<0>();
    __syncthreads();
  }
}

// Position of accumulator element acc[i][j][c] in the 128 x 128 tile.
// bf16 (mma.sync): warps 2 (rows) x 4 (columns) of 64 x 32, acc[i][j] the
// m16n8 tile (i, j).  fp32 (wgmma): warp w holds rows 16w .. 16w + 15 and
// all 128 columns, acc[i][j] the 8 columns 8 (4i + j).
template <typename T> __device__ __forceinline__ int acc_row(int i, int c) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = (lane >> 2) + 8 * (c >> 1);
  if constexpr (sizeof(T) == 4) return warp * 16 + r;
  return (warp >> 2) * 64 + i * 16 + r;
}
template <typename T>
__device__ __forceinline__ int acc_col(int i, int j, int c) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cc = 2 * (lane & 3) + (c & 1);
  if constexpr (sizeof(T) == 4) return (4 * i + j) * 8 + cc;
  return (warp & 3) * 32 + j * 8 + cc;
}
// Which of a row's four column groups acc[i] holds (the forward merges
// the row's four partial states in this order).
template <typename T> __device__ __forceinline__ int acc_group(int i) {
  if constexpr (sizeof(T) == 4) return i;
  return (threadIdx.x >> 5) & 3;
}

// Merge (m2, l2) into (m, l): the online logsumexp's combine.
__device__ __forceinline__ void lse_merge(float& m, float& l, float m2,
                                          float l2) {
  const float mx = fmaxf(m, m2);
  l = l * expf(m - mx) + l2 * expf(m2 - mx);
  m = mx;
}

// Forward, stage 1: per (row, vocab chunk) the partial max, normalizer and
// label logit, written to part[{0,1,2}][row][chunk].
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ce_fwd_partial(Mat<T> h, bool vec_h, Mat<T> w, bool vec_w,
                   const float* __restrict__ bias, const int* __restrict__ y,
                   int vchunk, float* __restrict__ part, int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int N = h.rows, E = h.cols, V = w.rows;
  const int n0 = blockIdx.x * kTile, chunk = blockIdx.y;
  const int v_end = min(V, (chunk + 1) * vchunk);
  // this thread's 8 (row, column group) states: r = 2i + half
  float m[8], l[8], yl[8];
  int lab[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int n = n0 + acc_row<T>(r >> 1, 2 * (r & 1));
    m[r] = kNeg;
    l[r] = 0.f;
    yl[r] = 0.f;
    lab[r] = n < N ? y[n] : -1;
  }
  float acc[4][4][4];
  for (int vb = chunk * vchunk; vb < v_end; vb += kTile) {
    tile_mma<T, true, true>(h, vec_h, n0, w, vec_w, vb, E, smem, acc);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = r >> 1, hf = 2 * (r & 1);
      float s[4][2];
      bool live[4][2];
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int v = vb + acc_col<T>(i, j, c);
          live[j][c] = v < v_end;
          s[j][c] = acc[i][j][hf + c] +
                    (bias != nullptr && live[j][c] ? bias[v] : 0.f);
          if (live[j][c]) {
            if (v == lab[r]) yl[r] = s[j][c];
            mx = fmaxf(mx, s[j][c]);
          }
        }
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          sum += live[j][c] ? expf(s[j][c] - mx) : 0.f;
      l[r] = l[r] * expf(m[r] - mx) + sum;
      m[r] = mx;
    }
  }
  // the four lanes of a row, then the row's four column groups, in order
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[r], o);
      yl[r] += __shfl_xor_sync(0xffffffffu, yl[r], o);
      lse_merge(m[r], l[r], m2, l2);
    }
  float* red = reinterpret_cast<float*>(smem_raw);  // [4 groups][128][3]
  if ((threadIdx.x & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float* at = red + (acc_group<T>(r >> 1) * kTile +
                         acc_row<T>(r >> 1, 2 * (r & 1))) * 3;
      at[0] = m[r];
      at[1] = l[r];
      at[2] = yl[r];
    }
  }
  __syncthreads();
  const int n = n0 + threadIdx.x;
  if (threadIdx.x < kTile && n < N) {
    float M = kNeg, L = 0.f, Y = 0.f;
    for (int c = 0; c < 4; ++c) {
      const float* at = red + (c * kTile + threadIdx.x) * 3;
      lse_merge(M, L, at[0], at[1]);
      Y += at[2];
    }
    const int64_t at = (int64_t)n * n_chunks + chunk;
    const int64_t plane = (int64_t)N * n_chunks;
    part[at] = M;
    part[plane + at] = L;
    part[2 * plane + at] = Y;
  }
}

// Forward, stage 2: one thread per row merges its chunks in order.
__global__ void __launch_bounds__(kThreads)
    ce_fwd_merge(const float* __restrict__ part, int N, int n_chunks,
                 float* __restrict__ lse, float* __restrict__ ylog) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const int64_t plane = (int64_t)N * n_chunks;
  const float* pm = part + (int64_t)n * n_chunks;
  float mx = kNeg;
  for (int c = 0; c < n_chunks; ++c) mx = fmaxf(mx, pm[c]);
  float sum = 0.f, ys = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    sum += pm[plane + c] * expf(pm[c] - mx);
    ys += pm[2 * plane + c];
  }
  lse[n] = mx + logf(sum);
  ylog[n] = ys;
}

// Backward (a): T_c[n][j] = round((exp(logit - lse[n]) - [c0 + j ==
// y[n]]) * g[n]) for the chunk's columns j < wc.rows.  Grid (row tiles,
// chunk column tiles).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ce_t_pass(Mat<T> h, bool vec_h, Mat<T> wc, bool vec_w,
              const float* __restrict__ bias_c, const int* __restrict__ y,
              const float* __restrict__ lse, const float* __restrict__ g,
              int c0, T* __restrict__ tc, int ldt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = h.rows, len = wc.rows;
  const int n0 = blockIdx.x * kTile, j0 = blockIdx.y * kTile;
  float acc[4][4][4];
  tile_mma<T, true, true>(h, vec_h, n0, wc, vec_w, j0, h.cols,
                          reinterpret_cast<T*>(smem_raw), acc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hf = 0; hf < 4; hf += 2) {
      const int n = n0 + acc_row<T>(i, hf);
      if (n >= N) continue;
      const float ln = lse[n], gn = g[n];
      const int yn = y[n] - c0;
      T* out = tc + (int64_t)n * ldt;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = j0 + acc_col<T>(i, j, c);
          if (col >= len) continue;
          const float b = bias_c != nullptr ? bias_c[col] : 0.f;
          const float p = expf(acc[i][j][hf + c] + b - ln);
          out[col] = from_f<T>((p - (col == yn ? 1.f : 0.f)) * gn);
        }
    }
}

// Backward (b): dh_acc += T_c @ W_c over the chunk (K = its columns).
// first: no earlier sum to read; last: write dh in T (dh may be dh_acc).
// Grid (E tiles, row tiles): the blocks of one row tile run together.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ce_dh(Mat<T> tc, bool vec_t, Mat<T> wc, bool vec_w, float* dh_acc,
          T* dh, int first, int last) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = tc.rows, E = wc.cols;
  const int e0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  float acc[4][4][4];
  tile_mma<T, true, false>(tc, vec_t, n0, wc, vec_w, e0, tc.cols,
                           reinterpret_cast<T*>(smem_raw), acc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = n0 + acc_row<T>(i, c), e = e0 + acc_col<T>(i, j, c);
        if (n >= N || e >= E) continue;
        const int64_t at = (int64_t)n * E + e;
        float v = acc[i][j][c];
        if (!first) v += dh_acc[at];
        if (last)
          dh[at] = from_f<T>(v);
        else
          dh_acc[at] = v;
      }
}

// Backward (c): dW_c = T_c^T @ h (K = N tokens); with db_c, the blocks of
// the first E tile also sum the columns of T_c as its slabs stream by.
// Grid (E tiles, chunk row tiles).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ce_dw(Mat<T> tc, bool vec_t, Mat<T> h, bool vec_h, T* __restrict__ dw_c,
          float* __restrict__ db_c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using LA = Layout<T, false>;
  const int len = tc.cols, E = h.cols;
  const int e0 = blockIdx.x * kTile, j0 = blockIdx.y * kTile;
  const bool sums = db_c != nullptr && blockIdx.x == 0;
  // thread: column threadIdx.x % 128 of the slab, rows of one half
  const int col = threadIdx.x & (kTile - 1);
  const int r0 = (threadIdx.x >> 7) * (LA::kK / 2);
  float colsum = 0.f;
  auto hook = [&](const T* sa) {
    if (!sums) return;
#pragma unroll 8
    for (int r = r0; r < r0 + LA::kK / 2; ++r)
      colsum += to_f(sa[r * LA::kStride + col]);
  };
  float acc[4][4][4];
  tile_mma<T, false, false>(tc, vec_t, j0, h, vec_h, e0, tc.rows,
                            reinterpret_cast<T*>(smem_raw), acc, hook);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int v = j0 + acc_row<T>(i, c), e = e0 + acc_col<T>(i, j, c);
        if (v < len && e < E)
          dw_c[(int64_t)v * E + e] = from_f<T>(acc[i][j][c]);
      }
  if (sums) {
    float* red = reinterpret_cast<float*>(smem_raw);
    red[threadIdx.x] = colsum;
    __syncthreads();
    if (threadIdx.x < kTile && j0 + threadIdx.x < len)
      db_c[j0 + threadIdx.x] = red[threadIdx.x] + red[threadIdx.x + kTile];
  }
}

template <typename T> bool aligned16(const void* p, int64_t ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (ld * (int64_t)sizeof(T)) % 16 == 0;
}

template <typename T, typename K> cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
}

unsigned tiles(int n) { return (unsigned)((n + kTile - 1) / kTile); }

template <typename T>
cudaError_t fwd(const void* h, const void* w, const void* bias,
                const void* y, int N, int E, int V, int vchunk, void* part,
                void* lse, void* ylog, cudaStream_t stream) {
  cudaError_t err = allow_smem<T>(ce_fwd_partial<T>);
  if (err != cudaSuccess) return err;
  const int n_chunks = (V + vchunk - 1) / vchunk;
  const Mat<T> hm{static_cast<const T*>(h), E, N, E};
  const Mat<T> wm{static_cast<const T*>(w), E, V, E};
  constexpr int smem = smem_bytes<T>();
  ce_fwd_partial<T><<<dim3(tiles(N), n_chunks), kThreads, smem, stream>>>(
      hm, aligned16<T>(h, E), wm, aligned16<T>(w, E),
      static_cast<const float*>(bias), static_cast<const int*>(y), vchunk,
      static_cast<float*>(part), n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_fwd_merge<<<(N + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const float*>(part), N, n_chunks, static_cast<float*>(lse),
      static_cast<float*>(ylog));
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* h, const void* w, const void* bias,
                const void* y, const void* lse, const void* g, int N, int E,
                int V, int vchunk, void* tbuf, void* dh_acc, void* dh,
                void* dw, void* db, cudaStream_t stream) {
  cudaError_t err;
  if ((err = allow_smem<T>(ce_t_pass<T>)) != cudaSuccess ||
      (err = allow_smem<T>(ce_dh<T>)) != cudaSuccess ||
      (err = allow_smem<T>(ce_dw<T>)) != cudaSuccess)
    return err;
  constexpr int smem = smem_bytes<T>();
  const T* h_ = static_cast<const T*>(h);
  const T* w_ = static_cast<const T*>(w);
  T* t_ = static_cast<T*>(tbuf);
  float* acc_ = dh_acc != nullptr ? static_cast<float*>(dh_acc)
                                  : static_cast<float*>(dh);
  const Mat<T> hm{h_, E, N, E};
  const bool vec_h = aligned16<T>(h_, E);
  const bool vec_w = aligned16<T>(w_, E);
  const bool vec_t = aligned16<T>(t_, vchunk);
  for (int c0 = 0; c0 < V; c0 += vchunk) {
    const int len = min(vchunk, V - c0);
    const Mat<T> wc{w_ + (int64_t)c0 * E, E, len, E};
    const Mat<T> tc{t_, vchunk, N, len};
    ce_t_pass<T><<<dim3(tiles(N), tiles(len)), kThreads, smem, stream>>>(
        hm, vec_h, wc, vec_w,
        bias != nullptr ? static_cast<const float*>(bias) + c0 : nullptr,
        static_cast<const int*>(y), static_cast<const float*>(lse),
        static_cast<const float*>(g), c0, t_, vchunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ce_dh<T><<<dim3(tiles(E), tiles(N)), kThreads, smem, stream>>>(
        tc, vec_t, wc, vec_w, acc_, static_cast<T*>(dh), c0 == 0,
        c0 + vchunk >= V);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ce_dw<T><<<dim3(tiles(E), tiles(len)), kThreads, smem, stream>>>(
        tc, vec_t, hm, vec_h, static_cast<T*>(dw) + (int64_t)c0 * E,
        db != nullptr ? static_cast<float*>(db) + c0 : nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of h and w).  h (N, E); w (V, E);
// bias (V,) float32 or null; y (N,) int32 labels in [0, V) or a sentinel
// outside it.  part is 3 * N * ceil(V / vchunk) float32 scratch; lse and
// ylog (N,) float32 are the outputs.  Returns cudaGetLastError().
extern "C" int hetu_ce_fwd(int dtype, const void* h, const void* w,
                           const void* bias, const void* y, int N, int E,
                           int V, int vchunk, void* part, void* lse,
                           void* ylog, void* stream) {
  if (N < 1 || E < 1 || V < 1 || vchunk < 1 ||
      (V + vchunk - 1) / vchunk > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)fwd<float>(h, w, bias, y, N, E, V, vchunk, part, lse, ylog,
                           s);
  if (dtype == 1)
    return (int)fwd<bf16>(h, w, bias, y, N, E, V, vchunk, part, lse, ylog,
                          s);
  return (int)cudaErrorInvalidValue;
}

// Gradients given g = dnll (N,) float32, already zero on ignored rows, and
// the forward's lse.  tbuf is N * vchunk scratch in the inputs' type (row
// stride vchunk); dh_acc is N * E float32 scratch, or null in fp32 (dh is
// then its own accumulator); dh (N, E) and dw (V, E) are in the inputs'
// type; db (V,) float32 or null.  Three launches per vocab chunk of
// vchunk columns, on the stream.  Returns cudaGetLastError().
extern "C" int hetu_ce_bwd(int dtype, const void* h, const void* w,
                           const void* bias, const void* y, const void* lse,
                           const void* g, int N, int E, int V, int vchunk,
                           void* tbuf, void* dh_acc, void* dh, void* dw,
                           void* db, void* stream) {
  if (N < 1 || E < 1 || V < 1 || vchunk < 1 ||
      (N + kTile - 1) / kTile > 65535 || (vchunk + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)bwd<float>(h, w, bias, y, lse, g, N, E, V, vchunk, tbuf,
                           dh_acc, dh, dw, db, s);
  if (dtype == 1 && dh_acc != nullptr)
    return (int)bwd<bf16>(h, w, bias, y, lse, g, N, E, V, vchunk, tbuf,
                          dh_acc, dh, dw, db, s);
  return (int)cudaErrorInvalidValue;
}
