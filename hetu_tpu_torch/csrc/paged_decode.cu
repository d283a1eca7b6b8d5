// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hetu_tpu/ops/pallas/paged_decode.py:_kernel
// (entry paged_decode_attention): one new query per sequence attends over
// its K/V history, read in place from the paged pool through the row's page
// table, with an fp32 online softmax.
//
// Bound on the H100: memory.  The kernel reads each live K and V row once,
// sum_b 2 * len_b * H * D * sizeof(T) bytes, and does 4 flops per element
// read, far below the ~20 flops/byte where fp32 arithmetic would bind.
//
// Design (flash-decoding).  The TPU kernel walked pages as the innermost,
// sequential grid axis and carried (m, l, acc) in VMEM scratch.  Here each
// row is cut into fixed chunks of chunk_pages whole pages, a plan that
// depends on the page size alone (the wrapper's chunk_plan), so a row's
// bits never depend on the batch.  Kernel 1, paged_decode_partial, has one
// block per (head group, row, chunk): hb heads, one warp each.  A chunk
// that starts at or past the row's length exits without reading anything.
// The block reads its chunk's live page numbers into shared memory once,
// then stages the chunk in tiles of 32 positions through a two-stage
// cp.async ring in shared memory: every position's head-group row is one
// contiguous run of hb * D values in the pool, copied as 16-byte pieces,
// and only positions below the length are copied, so a NaN in the scratch
// page or a page tail can reach no output.  A warp scores the tile's 32
// positions at once, one a lane, from shared memory (a padded row stride
// keeps the 16-byte reads conflict-free), then folds them into its fp32
// running max, normaliser and accumulator (D / 32 columns a lane) and writes
// the chunk's (m, l, acc[D]) to fp32 scratch.  Kernel 2, paged_decode_merge,
// combines each (row, head)'s live chunks in chunk order and casts the
// output once: no atomics, so the result is bitwise repeatable.  It is
// launched as a programmatic dependent of kernel 1, so its launch overlaps
// kernel 1's run, and it waits on the device for kernel 1's writes.  A row of
// length 0 has no live chunk and gives 0 / 0 = NaN, as the TPU kernel does.
// Pool offsets are 64-bit; the pools must be 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kTile = 32;           // positions a stage holds, one a lane
constexpr int kStages = 2;          // tiles in flight
constexpr int kMaxHeads = 8;        // heads (warps) a block takes at most
constexpr int kMaxSmem = 232448;    // a block's shared memory on an H100
constexpr float kNegInit = -1e30f;  // finite, as in the TPU kernel

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Bytes between two positions' head-group rows in a stage: the row plus 16
// bytes, so the 8 lanes of a quarter warp reading 16 bytes of 8 positions'
// rows hit 8 distinct 16-byte bank groups.
template <typename T, int D>
__host__ __device__ __forceinline__ int row_stride_bytes(int hb) {
  return hb * D * (int)sizeof(T) + 16;
}

// Two stages of K and V, q of the head group in fp32, the chunk's page
// numbers.
template <typename T, int D>
__host__ __device__ __forceinline__ size_t smem_bytes(int hb,
                                                      int chunk_pages) {
  return (size_t)2 * kStages * kTile * row_stride_bytes<T, D>(hb) +
         (size_t)hb * D * sizeof(float) + (size_t)chunk_pages * sizeof(int);
}

// q . k over D for one lane's position: k_row in shared memory (T), q_h in
// shared memory (fp32, the same address in every lane: a broadcast).
template <int D>
__device__ __forceinline__ float dot_row(const float* k, const float* q) {
  float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 kk = *reinterpret_cast<const float4*>(k + d);
    const float4 qq = *reinterpret_cast<const float4*>(q + d);
    a[0] += kk.x * qq.x;
    a[1] += kk.y * qq.y;
    a[2] += kk.z * qq.z;
    a[3] += kk.w * qq.w;
  }
  return (a[0] + a[1]) + (a[2] + a[3]);
}
template <int D>
__device__ __forceinline__ float dot_row(const __nv_bfloat16* k,
                                         const float* q) {
  float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int d = 0; d < D; d += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(k + d);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    const float4 q0 = *reinterpret_cast<const float4*>(q + d);
    const float4 q1 = *reinterpret_cast<const float4*>(q + d + 4);
    const float qv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 kf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      a[i] += kf.x * qv[2 * i] + kf.y * qv[2 * i + 1];
    }
  }
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// Kernel 1: the (m, l, acc) of one chunk of one row for hb heads.
// DPL = D / 32: the columns of the accumulator a lane holds.
template <typename T, int DPL>
__global__ void __launch_bounds__(kMaxHeads * 32)
    paged_decode_partial(const T* __restrict__ q, const T* __restrict__ k_pool,
                         const T* __restrict__ v_pool,
                         const int* __restrict__ tables,
                         const int* __restrict__ lens,
                         float* __restrict__ part_ml,
                         float* __restrict__ part_acc, int H, int hb,
                         int page, int pages_per_seq, int chunk_pages,
                         int n_chunks, float scale) {
  constexpr int D = DPL * 32;
  // the chunk is the slowest grid axis: every row's first chunks are
  // scheduled before any row's later ones, which at short lengths are dead
  const int c = blockIdx.z;
  const int b = blockIdx.y;
  const int len = min(lens[b], pages_per_seq * page);
  const int chunk = chunk_pages * page;
  const int start = c * chunk;
  if (start >= len) return;  // dead chunk: nothing is read or written
  // the merge may launch now: it waits for this grid before reading
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int h0 = blockIdx.x * hb;
  const int hv = min(hb, H - h0);  // heads of this group
  const int n = min(chunk, len - start);
  const int tiles = (n + kTile - 1) / kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  const int rs = row_stride_bytes<T, D>(hb);
  unsigned char* k_st = smem;
  unsigned char* v_st = smem + kStages * kTile * rs;
  float* s_q = reinterpret_cast<float*>(smem + 2 * kStages * kTile * rs);
  int* s_pages = reinterpret_cast<int*>(s_q + hb * D);

  // The chunk's live page numbers and the group's q, both loaded at once
  // (the copies below must not wait on a table load each).
  const int* row = tables + (int64_t)b * pages_per_seq + c * chunk_pages;
  for (int i = threadIdx.x; i < (n + page - 1) / page; i += blockDim.x)
    s_pages[i] = row[i];
  const int64_t qoff = ((int64_t)b * H + h0) * D;
  for (int i = threadIdx.x; i < hv * D; i += blockDim.x)
    s_q[i] = to_f(q[qoff + i]);
  __syncthreads();
  const int pieces = hv * D * (int)sizeof(T) / 16;  // of a position's row

  // Copy tile i's live positions into stage s: warp-strided positions,
  // lane-strided 16-byte pieces of each position's head-group row.
  auto issue = [&](int i, int s) {
    const int t0 = i * kTile;
    const int nt = min(kTile, n - t0);
    for (int t = warp; t < nt; t += nwarps) {
      const int p = (t0 + t) / page;  // page of the chunk
      const int64_t off =
          (((int64_t)s_pages[p] * page + (t0 + t - p * page)) * H + h0) * D;
      const unsigned char* gk =
          reinterpret_cast<const unsigned char*>(k_pool + off);
      const unsigned char* gv =
          reinterpret_cast<const unsigned char*>(v_pool + off);
      unsigned char* sk = k_st + (s * kTile + t) * rs;
      unsigned char* sv = v_st + (s * kTile + t) * rs;
      for (int pc = lane; pc < pieces; pc += 32) {
        cp_async16(sk + pc * 16, gk + pc * 16, 16);
        cp_async16(sv + pc * 16, gv + pc * 16, 16);
      }
    }
    cp_commit();
  };

  issue(0, 0);
  if (tiles > 1) issue(1, 1);

  float m = kNegInit, l = 0.f, acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;
  const bool active = warp < hv;

  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();
    const int s = i & 1;
    if (active) {
      const int nt = min(kTile, n - i * kTile);
      const T* k_row = reinterpret_cast<const T*>(
                           k_st + (s * kTile + lane) * rs) + warp * D;
      const float dot = dot_row<D>(k_row, s_q + warp * D);
      // a lane past the length read an unwritten row: select, never use it
      const float sc = lane < nt ? dot * scale : kNegInit;
      const float m_new = fmaxf(m, warp_max(sc));
      const float alpha = expf(m - m_new);
      const float pw = expf(sc - m_new);
      l = l * alpha + warp_sum(pw);
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[j] *= alpha;
      const unsigned char* v_tile = v_st + s * kTile * rs;
      const int col = warp * D + lane;
      if (nt == kTile) {
#pragma unroll 8
        for (int t = 0; t < kTile; ++t) {
          const float pt = __shfl_sync(0xffffffffu, pw, t);
          const T* vr = reinterpret_cast<const T*>(v_tile + t * rs) + col;
#pragma unroll
          for (int j = 0; j < DPL; ++j) acc[j] += pt * to_f(vr[32 * j]);
        }
      } else {
        for (int t = 0; t < nt; ++t) {
          const float pt = __shfl_sync(0xffffffffu, pw, t);
          const T* vr = reinterpret_cast<const T*>(v_tile + t * rs) + col;
#pragma unroll
          for (int j = 0; j < DPL; ++j) acc[j] += pt * to_f(vr[32 * j]);
        }
      }
      m = m_new;
    }
    __syncthreads();
    if (i + 2 < tiles) issue(i + 2, s);
  }

  if (active) {
    const int64_t slot = ((int64_t)b * n_chunks + c) * H + h0 + warp;
    if (lane == 0) {
      part_ml[2 * slot] = m;
      part_ml[2 * slot + 1] = l;
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j) part_acc[slot * D + lane + 32 * j] = acc[j];
  }
}

// Kernel 2: one warp per (row, head) merges the row's live chunks in chunk
// order and writes the output in T.  Lane c reads chunk c's (m, l), so the
// statistics of 32 chunks arrive together, and the accumulators are read 4
// chunks at a time.
template <typename T, int DPL>
__global__ void __launch_bounds__(128)
    paged_decode_merge(const float* __restrict__ part_ml,
                       const float* __restrict__ part_acc,
                       const int* __restrict__ lens, T* __restrict__ out,
                       int B, int H, int page, int pages_per_seq,
                       int chunk_pages, int n_chunks) {
  constexpr int D = DPL * 32;
  const int w = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (w >= B * H) return;
  const int lane = threadIdx.x & 31;
  const int b = w / H;
  const int h = w - b * H;
  const int len = min(lens[b], pages_per_seq * page);
  const int chunk = chunk_pages * page;
  const int live = len > 0 ? (len + chunk - 1) / chunk : 0;
  const int64_t first = (int64_t)b * n_chunks * H + h;
  // launched early (programmatic dependent launch): wait for the chunk
  // kernel's grid and its writes
  asm volatile("griddepcontrol.wait;" ::: "memory");
  float M = kNegInit;
  for (int c = lane; c < live; c += 32)
    M = fmaxf(M, part_ml[2 * (first + (int64_t)c * H)]);
  M = warp_max(M);
  float L = 0.f, a[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) a[j] = 0.f;
  for (int c0 = 0; c0 < live; c0 += 32) {
    float wc = 0.f, lc = 0.f;  // chunk c0 + lane's weight and its l
    if (c0 + lane < live) {
      const int64_t slot = first + (int64_t)(c0 + lane) * H;
      wc = expf(part_ml[2 * slot] - M);
      lc = part_ml[2 * slot + 1] * wc;
    }
    const int nc = min(32, live - c0);
#pragma unroll 4
    for (int k = 0; k < nc; ++k) {
      const float wk = __shfl_sync(0xffffffffu, wc, k);
      L += __shfl_sync(0xffffffffu, lc, k);
      const float* pa = part_acc + (first + (int64_t)(c0 + k) * H) * D + lane;
#pragma unroll
      for (int j = 0; j < DPL; ++j) a[j] += pa[32 * j] * wk;
    }
  }
  // no live chunk (length 0): 0 / 0 = NaN, as the TPU kernel gives
  const int64_t o = ((int64_t)b * H + h) * D + lane;
#pragma unroll
  for (int j = 0; j < DPL; ++j) out[o + 32 * j] = from_f<T>(a[j] / L);
}

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* tables, const void* lens, void* out,
                   void* part, int B, int H, int hb, int page,
                   int pages_per_seq, int chunk_pages, int n_chunks,
                   float scale, cudaStream_t stream) {
  constexpr int D = DPL * 32;
  const size_t smem = smem_bytes<T, D>(hb, chunk_pages);
  static bool attr_set = false;  // stages above 48 KB need the opt-in
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_partial<T, DPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  float* ml = static_cast<float*>(part);
  float* acc = ml + (size_t)2 * B * n_chunks * H;
  const dim3 grid((H + hb - 1) / hb, B, n_chunks);
  paged_decode_partial<T, DPL><<<grid, hb * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(lens), ml, acc, H, hb, page, pages_per_seq,
      chunk_pages, n_chunks, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the merge launches while the chunk kernel runs, and waits for it on
  // the device (griddepcontrol.wait) before it reads the partials
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B * H + 3) / 4);
  cfg.blockDim = dim3(128);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_decode_merge<T, DPL>,
                           static_cast<const float*>(ml),
                           static_cast<const float*>(acc),
                           static_cast<const int*>(lens), static_cast<T*>(out),
                           B, H, page, pages_per_seq, chunk_pages, n_chunks);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     const void* tables, const void* lens, void* out,
                     void* part, int B, int H, int hb, int page, int pps,
                     int cp, int nc, float scale, cudaStream_t s) {
  switch (D / 32) {
#define HETU_PD_CASE(N)                                                   \
  case N:                                                                 \
    if (smem_bytes<T, N * 32>(hb, cp) > (size_t)kMaxSmem)                 \
      return cudaErrorInvalidValue;                                       \
    return launch<T, N>(q, k, v, tables, lens, out, part, B, H, hb, page, \
                        pps, cp, nc, scale, s);
    HETU_PD_CASE(1)
    HETU_PD_CASE(2)
    HETU_PD_CASE(3)
    HETU_PD_CASE(4)
    HETU_PD_CASE(5)
    HETU_PD_CASE(6)
    HETU_PD_CASE(7)
    HETU_PD_CASE(8)
#undef HETU_PD_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q and out are (B, H, D); k and v point
// at one layer's (pages, page, H, D) pool, 16-byte aligned; tables is (B,
// pages_per_seq) int32; lens is (B,) int32.  Each row is split into
// n_chunks chunks of chunk_pages pages (n_chunks * chunk_pages >=
// pages_per_seq); hb heads go to a block.  part is fp32 scratch of B *
// n_chunks * H * (D + 2) floats.  Two launches on the stream; returns
// cudaGetLastError() after them.
extern "C" int hetu_paged_decode(int dtype, const void* q, const void* k,
                                 const void* v, const void* tables,
                                 const void* lens, void* out, void* part,
                                 int B, int H, int D, int page,
                                 int pages_per_seq, int chunk_pages,
                                 int n_chunks, int hb, float scale,
                                 void* stream) {
  if (D < 32 || D > 256 || D % 32 != 0 || B < 1 || H < 1 || page < 1 ||
      pages_per_seq < 1 || chunk_pages < 1 || n_chunks < 1 ||
      (int64_t)n_chunks * chunk_pages < pages_per_seq || hb < 1 ||
      hb > kMaxHeads || hb > H || B > 65535 || n_chunks > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(D, q, k, v, tables, lens, out, part, B, H,
                                hb, page, pages_per_seq, chunk_pages,
                                n_chunks, scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(D, q, k, v, tables, lens, out, part,
                                        B, H, hb, page, pages_per_seq,
                                        chunk_pages, n_chunks, scale, s);
  return (int)cudaErrorInvalidValue;
}
