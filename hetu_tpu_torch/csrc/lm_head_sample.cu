// Fused LM-head top-k sampling for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hetu_tpu/ops/pallas/lm_head.py:_sample_kernel
// (entry lm_head_sample_pallas): the top-k (value, index) pairs of each row
// of  h @ W^T (+ b)  [or  g + (h @ W^T + b) / T  with a Gumbel field g].
// The order is the same on every path, k = 1 and k > 1 alike: a NaN of
// either sign first, then the values descending with -0 equal to +0, and
// equal values (NaNs among themselves) smallest index first; a row of -inf,
// or of NaN, gives index 0.  k = 1 is greedy decoding.  The (N, V) logits
// never reach device memory.
//
// Bound on the H100: memory, at decode batch sizes.  Every call streams the
// whole weight once, V * E * sizeof(T) bytes (154 MB for GPT-2 small in
// fp32, 46 us at 3.35 TB/s), against 2 * N * E * V flops: at N = 8 that is
// 4 flops per fp32 weight byte, far under the card's balance point.
//
// Design.  W is read in the embedding's (V, E) row-major layout (the tied
// head needs no transposed or padded copy), so a vocab range is one
// contiguous range of W.
//  - One wave: grid (blocks, row groups of kRows) with as many blocks as
//    fit on the card at once (one an SM at E = 768: 176 KB of shared
//    memory), each over a contiguous range of 16-row vocab fragments
//    (their counts differ by at most one).
//  - Streaming: a block walks its range in tiles of kWarps fragments (one
//    a warp) and each tile's E in slabs of 256 bytes a row, staged by
//    16-byte cp.async into a ring of kStages 34 KB shared-memory stages
//    (rows padded by 16 bytes, so the fragment loads are free of bank
//    conflicts).  Three stages stay in flight while one is consumed, and
//    the ring runs on across tiles, so it never drains inside a block.
//    The block's 8 rows of h stay in shared memory, staged once with the
//    first stage (staging them with every stage instead, from L2, read
//    slower on the H100), which bounds E: 2368 in fp32, 4736 in bf16.
//  - Tensor cores: a warp's 16 vocab rows are the M of mma.sync and the
//    block's 8 rows of h its n = 8.  fp32 runs m16n8k8 in 3xTF32 (W split
//    by truncation in registers, h split by rounding), bf16 m16n8k16.  The
//    A fragment comes from one ldmatrix.x4 (the same addressing for both
//    types: 32 bytes of K a step), the B fragment from h's rows (two
//    32-bit loads a step).  Each W element is read from shared
//    memory once; the SIMT kernel this replaced read one h value from
//    shared memory and ran one FMA per element and row (8 of each).  Each
//    slab is summed into fresh registers and added to the accumulator by
//    a rounding fp32 add: the tensor core's accumulation truncates.
//  - Selection: each tile's logits (bias, Gumbel and temperature applied,
//    the ragged vocab edge masked) go to shared memory; then each row's k
//    best of the block's range are chosen in k rounds of one warp max over
//    ordered 64-bit words (rank(): the value's ordered key above ~index,
//    so one unsigned compare applies the whole order), round s taking the
//    largest word below round s - 1's.
//  - Merge: a second kernel, launched as a programmatic dependent, takes
//    each row's k best of the blocks' candidates in the same way.  No
//    atomics: the result is bitwise repeatable, and a row's result does
//    not depend on which other rows share its batch (the block plan
//    depends on the type, E and V alone).
// Why mma.sync and not wgmma: n = 8 rows is mma.sync's own shape, and the
// product is 4 flops a weight byte, so the tensor cores idle either way;
// what matters is that W crosses shared memory once and few instructions
// touch it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;                 // rows of h per block: mma's n
constexpr int kFrag = 16;                // vocab rows per warp fragment: M
constexpr int kTileRows = kWarps * kFrag;
constexpr int kSlab = 256;               // bytes of a row per stage
constexpr int kRowBytes = kSlab + 16;    // padded: conflict-free fragments
constexpr int kStageBytes = kTileRows * kRowBytes;
constexpr int kStages = 4;
constexpr int kMaxFrags = 32;            // fragments per block at most
constexpr int kMaxRange = kMaxFrags * kFrag;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMergeThreads = 128;
constexpr int kIdxPad = 2147483647;      // sentinel index: loses every tie

// The order of every path as one word an unsigned compare orders: the
// value's key (a NaN of either sign above +inf; -0 + 0 = +0) above
// ~index, so equal values rank smallest index first.  A real value's word
// is never 0, which marks "no candidate".
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t b = __float_as_uint(v + 0.f);
  return isnan(v) ? 0xffffffffu
                  : b ^ ((uint32_t)((int32_t)b >> 31) | 0x80000000u);
}
__device__ __forceinline__ uint64_t rank(float v, int i) {
  return ((uint64_t)order_key(v) << 32) | (0xffffffffu - (uint32_t)i);
}

// cp_async16 with a hint that L2 fetch the whole 256-byte segment: a
// slab row is one 256-byte piece of W.
__device__ __forceinline__ void cp_async16_l2_256(void* smem,
                                                  const void* gmem,
                                                  int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(s),
      "l"(gmem), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void warp_argmax(uint64_t& w, int& p) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint64_t ow = __shfl_xor_sync(0xffffffffu, w, o);
    const int op = __shfl_xor_sync(0xffffffffu, p, o);
    if (ow > w) {
      w = ow;
      p = op;
    }
  }
}

// Bytes of a staged row of h: all of E's slabs, padded by 16 bytes.
template <typename T> __host__ __device__ int h_row_bytes(int E) {
  return (E * (int)sizeof(T) + kSlab - 1) / kSlab * kSlab + 16;
}
template <typename T> size_t smem_bytes(int E) {
  return (size_t)kStages * kStageBytes + (size_t)kRows * h_row_bytes<T>(E) +
         (size_t)kRows * kMaxRange * sizeof(float);
}

// Stage slab `slab` (bytes [256 slab, 256 slab + 256) of each row) of
// rows [row0, row0 + R) of the (rows, E) matrix m into st (row stride ld
// bytes), zero from row row_end on and beyond E.  vec: 16-byte cp.async
// (m and its rows 16-byte aligned); else plain loads and stores.
template <typename T, int R>
__device__ __forceinline__ void load_slab(unsigned char* st, int ld,
                                          const T* __restrict__ m, int E,
                                          int row0, int row_end, int slab,
                                          bool vec) {
  if (vec) {
    const int64_t row_bytes = (int64_t)E * sizeof(T);
    const int b0 = slab * kSlab;
#pragma unroll
    for (int i = threadIdx.x; i < R * (kSlab / 16); i += kThreads) {
      const int r = i / (kSlab / 16), c = (i % (kSlab / 16)) * 16;
      const int row = row0 + r;
      const char* src = reinterpret_cast<const char*>(m);
      int bytes = 0;
      const int64_t rest = row_bytes - (b0 + c);
      if (row < row_end && rest > 0) {
        bytes = rest < 16 ? (int)rest : 16;
        src += row * row_bytes + b0 + c;
      }
      cp_async16_l2_256(st + r * ld + c, src, bytes);
    }
  } else {
    constexpr int kPer = kSlab / (int)sizeof(T);
    for (int i = threadIdx.x; i < R * kPer; i += kThreads) {
      const int r = i / kPer, c = i % kPer;
      const int row = row0 + r, col = slab * kPer + c;
      reinterpret_cast<T*>(st + r * ld)[c] =
          (row < row_end && col < E) ? m[(int64_t)row * E + col]
                                     : from_f<T>(0.f);
    }
  }
}

// One slab of a warp's 16 x 8 product, c += W rows (16 x slab) h^T, for
// the type of the unnamed pointer: the warp's W rows from row 16 warp of
// the stage st, h's 8 rows at this slab from hb (row stride hld bytes).
__device__ __forceinline__ const unsigned char* frag_a(
    const unsigned char* st, int warp, int lane) {
  // ldmatrix.x4: lanes 0-7 / 8-15 give rows 0-7 / 8-15 of bytes 0-15 of a
  // 32-byte K step, lanes 16-31 the same rows at bytes 16-31
  return st + (warp * kFrag + (lane & 7) + ((lane >> 3) & 1) * 8) *
                  kRowBytes + (lane >> 4) * 16;
}

__device__ __forceinline__ void slab_mma(float c[4], const float*,
                                         const unsigned char* st,
                                         const unsigned char* hb, int hld,
                                         int warp, int lane) {
  const unsigned char* ap = frag_a(st, warp, lane);
  const float* hp =
      reinterpret_cast<const float*>(hb + (lane >> 2) * hld) + (lane & 3);
  float hh[4] = {0.f, 0.f, 0.f, 0.f}, hl[4] = {0.f, 0.f, 0.f, 0.f},
        lh[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ks = 0; ks < kSlab / 32; ++ks) {
    uint32_t ar[4], ahi[4], alo[4], bhi[2], blo[2];
    ldmatrix_x4(ap + ks * 32, ar);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      split_tf32_trunc(__uint_as_float(ar[j]), ahi[j], alo[j]);
    split_tf32(hp[ks * 8], bhi[0], blo[0]);
    split_tf32(hp[ks * 8 + 4], bhi[1], blo[1]);
    mma_tf32(hh, ahi, bhi);
    mma_tf32(hl, ahi, blo);
    mma_tf32(lh, alo, bhi);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) c[j] += hh[j] + (hl[j] + lh[j]);
}

__device__ __forceinline__ void slab_mma(float c[4], const bf16*,
                                         const unsigned char* st,
                                         const unsigned char* hb, int hld,
                                         int warp, int lane) {
  const unsigned char* ap = frag_a(st, warp, lane);
  const bf16* hp =
      reinterpret_cast<const bf16*>(hb + (lane >> 2) * hld) + 2 * (lane & 3);
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ks = 0; ks < kSlab / 32; ++ks) {
    uint32_t ar[4], b[2];
    ldmatrix_x4(ap + ks * 32, ar);
    b[0] = ld32(hp + ks * 16);
    b[1] = ld32(hp + ks * 16 + 8);
    mma_bf16(s, ar, b);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) c[j] += s[j];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    head_topk_partial(const T* __restrict__ h, const T* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ g, float temp, int N, int E,
                      int V, int k, bool vec_w, bool vec_h,
                      float* __restrict__ part_v,
                      int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* hs = smem + kStages * kStageBytes;
  const int hld = h_row_bytes<T>(E);
  float* lv = reinterpret_cast<float*>(hs + kRows * hld);

  const int G = gridDim.x, b = blockIdx.x;
  const int frags = (V + kFrag - 1) / kFrag;
  const int f0 = (int)((int64_t)b * frags / G);
  const int f1 = (int)((int64_t)(b + 1) * frags / G);
  const int v0 = f0 * kFrag;
  const int v_end = min(f1 * kFrag, V);
  const int slabs = (E * (int)sizeof(T) + kSlab - 1) / kSlab;
  const int tiles = (f1 - f0 + kWarps - 1) / kWarps;
  const int total = tiles * slabs;
  const int r0 = blockIdx.y * kRows;
  const int nr = min(kRows, N - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  auto stage = [&](int it) { return smem + (it % kStages) * kStageBytes; };
  auto load = [&](int it) {
    if (it < total)
      load_slab<T, kTileRows>(stage(it), kRowBytes, w, E,
                              v0 + (it / slabs) * kTileRows, v_end,
                              it % slabs, vec_w);
    cp_commit();
  };
  // h rows r0.. (zero from row nr on), in slab 0's copy group
  for (int s = 0; s < slabs; ++s)
    load_slab<T, kRows>(hs + s * kSlab, hld, h, E, r0, r0 + nr, s, vec_h);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load(s);

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int it = 0; it < total; ++it) {
    cp_wait<kStages - 2>();
    __syncthreads();   // slab it is in; every warp is done with it - 1
    load(it + kStages - 1);
    const int tile = it / slabs, slab = it % slabs;
    const int f = f0 + tile * kWarps + warp;
    if (f < f1)
      slab_mma(acc, h, stage(it), hs + slab * kSlab, hld, warp, lane);
    if (slab == slabs - 1) {
      if (f < f1) {
        // acc: (vocab row g, h row 2t), (g, 2t + 1), (g + 8, 2t), (g + 8,
        // 2t + 1)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int v = f * kFrag + (lane >> 2) + (j >> 1) * 8;
          const int n = 2 * (lane & 3) + (j & 1);
          if (v < V && n < nr) {
            const float lg = bias != nullptr ? acc[j] + bias[v] : acc[j];
            lv[n * kMaxRange + (v - v0)] =
                g != nullptr ? g[(int64_t)(r0 + n) * V + v] + lg / temp : lg;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = 0.f;
    }
  }
  cp_wait<0>();
  // the merge may launch now; it waits for this grid before it reads
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  __syncthreads();

  const int nv = v_end - v0;
  for (int n = warp; n < nr; n += kWarps) {
    const float* row = lv + n * kMaxRange;
    const int64_t out = ((int64_t)(r0 + n) * G + b) * k;
    uint64_t prev = 0;
    for (int s = 0; s < k; ++s) {
      uint64_t best = 0;
      int bp = -1;
      for (int p = lane; p < nv; p += 32) {
        const uint64_t wd = rank(row[p], v0 + p);
        if ((s == 0 || wd < prev) && wd > best) {
          best = wd;
          bp = p;
        }
      }
      warp_argmax(best, bp);
      if (lane == 0) {
        part_v[out + s] = bp >= 0 ? row[bp] : -INFINITY;
        part_i[out + s] = bp >= 0 ? v0 + bp : kIdxPad;
      }
      prev = best;
    }
  }
}

// One block per row: the row's k best of its G * k candidates, in k rounds
// of a block max over rank() words (the sentinel's word is 0).
__global__ void __launch_bounds__(kMergeThreads)
    head_topk_merge(const float* __restrict__ part_v,
                    const int* __restrict__ part_i, int G, int k,
                    float* __restrict__ vals, int* __restrict__ idx) {
  constexpr int kW = kMergeThreads / 32;
  __shared__ uint64_t s_w[kW];
  __shared__ int s_p[kW];
  __shared__ uint64_t s_prev;
  const int r = blockIdx.x;
  const int n = G * k;
  const float* pv = part_v + (int64_t)r * n;
  const int* pi = part_i + (int64_t)r * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // launched early (programmatic dependent launch): wait for the partial
  // kernel's grid and its writes
  asm volatile("griddepcontrol.wait;" ::: "memory");
  uint64_t prev = 0;
  for (int s = 0; s < k; ++s) {
    uint64_t best = 0;
    int bp = -1;
    for (int c = threadIdx.x; c < n; c += kMergeThreads) {
      const int i = pi[c];
      const uint64_t wd = i == kIdxPad ? 0 : rank(pv[c], i);
      if ((s == 0 || wd < prev) && wd > best) {
        best = wd;
        bp = c;
      }
    }
    warp_argmax(best, bp);
    if (lane == 0) {
      s_w[warp] = best;
      s_p[warp] = bp;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int j = 1; j < kW; ++j) {
        if (s_w[j] > best) {
          best = s_w[j];
          bp = s_p[j];
        }
      }
      vals[(int64_t)r * k + s] = bp >= 0 ? pv[bp] : -INFINITY;
      idx[(int64_t)r * k + s] = bp >= 0 ? pi[bp] : kIdxPad;
      s_prev = best;
    }
    __syncthreads();
    prev = s_prev;
  }
}

template <typename T> cudaError_t allow_smem() {
  static bool done = false;  // the shared memory above 48 KB needs the opt-in
  if (!done) {
    cudaError_t e = cudaFuncSetAttribute(
        head_topk_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return e;
    done = true;
  }
  return cudaSuccess;
}

// Blocks of the partial kernel for (E, V): as many as fit on the card at
// once, and enough that no block holds more than kMaxFrags fragments.
template <typename T> int blocks(int E, int V) {
  int dev = 0, sms = 0, per_sm = 0;
  if (smem_bytes<T>(E) > (size_t)kMaxSmem || allow_smem<T>() != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, head_topk_partial<T>, kThreads, smem_bytes<T>(E)) !=
          cudaSuccess ||
      per_sm < 1)
    return -1;
  const int frags = (V + kFrag - 1) / kFrag;
  const int wave = frags < sms * per_sm ? frags : sms * per_sm;
  const int least = (frags + kMaxFrags - 1) / kMaxFrags;
  return wave > least ? wave : least;
}

template <typename T>
cudaError_t launch(const void* h, const void* w, const void* bias,
                   const void* g, float temp, int N, int E, int V, int k,
                   int G, void* part_v, void* part_i, void* vals, void* idx,
                   cudaStream_t stream) {
  const int frags = (V + kFrag - 1) / kFrag;
  if (G < 1 || G > frags || (frags + G - 1) / G > kMaxFrags ||
      smem_bytes<T>(E) > (size_t)kMaxSmem)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<T>();
  if (err != cudaSuccess) return err;
  const bool rows16 = ((int64_t)E * sizeof(T)) % 16 == 0;
  const bool vec_w = reinterpret_cast<uintptr_t>(w) % 16 == 0 && rows16;
  const bool vec_h = reinterpret_cast<uintptr_t>(h) % 16 == 0 && rows16;
  head_topk_partial<T><<<dim3(G, (N + kRows - 1) / kRows), kThreads,
                         smem_bytes<T>(E), stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(g), temp, N,
      E, V, k, vec_w, vec_h, static_cast<float*>(part_v),
      static_cast<int*>(part_i));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the merge launches while the partial kernel runs, and waits for it on
  // the device (griddepcontrol.wait) before it reads the candidates
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, head_topk_merge,
                           static_cast<const float*>(part_v),
                           static_cast<const int*>(part_i), G, k,
                           static_cast<float*>(vals), static_cast<int*>(idx));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Blocks of the partial kernel for dtype (0 = float32, 1 = bfloat16), E
// and V on the current device: the wrapper sizes the (N, G, k) scratch
// with it and passes it back.  -1 if E is too wide for shared memory (h's
// 8 rows stay there: E above 2368 in fp32, 4736 in bf16) or on a CUDA
// error.
extern "C" int hetu_lm_head_blocks(int dtype, int E, int V) {
  if (E < 1 || V < 1) return -1;
  if (dtype == 0) return blocks<float>(E, V);
  if (dtype == 1) return blocks<bf16>(E, V);
  return -1;
}

// dtype: 0 = float32, 1 = bfloat16 (of h and w).  h (N, E); w (V, E);
// bias (V,) float32 or null; g (N, V) float32 or null, in which case temp is
// unused.  G from hetu_lm_head_blocks; part_v / part_i are (N, G, k)
// scratch; vals (N, k) float32 and idx (N, k) int32 are the outputs.
// Returns cudaGetLastError().
extern "C" int hetu_lm_head_sample(int dtype, const void* h, const void* w,
                                   const void* bias, const void* g,
                                   float temp, int N, int E, int V, int k,
                                   int G, void* part_v, void* part_i,
                                   void* vals, void* idx, void* stream) {
  if (N < 1 || E < 1 || V < 1 || k < 1 || k > 128 || k > V)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(h, w, bias, g, temp, N, E, V, k, G, part_v,
                              part_i, vals, idx, s);
  if (dtype == 1)
    return (int)launch<bf16>(h, w, bias, g, temp, N, E, V, k, G, part_v,
                             part_i, vals, idx, s);
  return (int)cudaErrorInvalidValue;
}
