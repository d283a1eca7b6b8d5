// Fused residual + dropout + LayerNorm, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of hetu_tpu/ops/pallas/fused_ln.py:
//   forward  _ln_fwd (_fwd_kernel): out = LN(x + dropout(y)) per row, with
//            the per-row mean and rstd (fp32) kept for the backward;
//   backward _ln_bwd (_bwd_kernel): dx, dy and dscale / dbias.
// x, y, out, dout, dx and dy are (T, D) in fp32 or bf16; scale and bias are
// fp32 (D,).  Everything is computed in fp32: v = f32(x) + f32(drop(y)) is
// never rounded to the inputs' type, and the variance is the two-pass
// mean((v - mean)^2).
//
// The dropout mask is never stored.  Both kernels regenerate it from the
// key's two words and the global flat index row * D + col with the same
// two murmur3-finalizer rounds as the port's dropout (ops/nn.py
// _hash_bits), kept where the bits fall under `thresh`; thresh = 0 means
// no dropout.  The kept y is y / keep in y's type (keep_y is keep rounded
// to that type, as the JAX code divides by the weakly typed constant); the
// backward's dy is dv / keep in fp32 (keep_g).
//
// Bound on the H100: bytes.  At T = 12288, D = 1024 in bf16 the forward
// moves 75.6 MB (reads x and y, writes out; 22.6 us at 3.35 TB/s), the
// backward 126 MB (reads dout, x, y, writes dx, dy; 37.6 us).  The
// arithmetic, two hash rounds (about 20 integer operations) and a few
// fp32 operations per element, is far below the card's rates.
//
// Design of the forward.  One warp per row, the row held in registers (D /
// 32 values a lane, loaded 4 contiguous elements at a time), every
// reduction a warp shuffle: no shared memory and no barrier.  D must be a
// multiple of 128 and at most 1024.
//
// Design of the backward.  A persistent grid of `parts` blocks of 128
// threads, `parts` a function of the row count alone (the wrapper's
// bwd_parts: at most one wave of 8 blocks on each of the H100's 132 SMs);
// block g takes rows g, g + parts, ...  A row is spread over the block,
// each thread holding D / 128 contiguous columns (16 bytes of each tensor
// at D = 1024 in bf16), so a thread keeps only its own columns' dscale /
// dbias sums.  dout, x and y of the block's next rows, with their mean and
// rstd, are staged into a ring of shared memory by cp.async while the
// current row computes (3 rows ahead at D = 1024 in bf16, 1 in fp32), and
// the row's two sums cross the block's 4 warps through shared memory in a
// fixed order.  Each block writes its columns' sums as one (D,) partial,
// and ln_sum_parts, launched as a programmatic dependent so that its launch
// overlaps ln_bwd's run, adds the partials in a fixed order.  No atomics: a
// rerun is bitwise the same.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kWarps = 4;         // forward: rows per block, one per warp
constexpr int kMaxNJ = 8;         // D / 128 at most: D <= 1024
constexpr int kBwdThreads = 128;  // backward: one row per block at a time

__device__ __forceinline__ uint32_t hash_mix(uint32_t x, uint32_t k) {
  x ^= k;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Four contiguous elements as fp32, and back.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  uint2 t = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&t.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<uint32_t*>(&a);
  t.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// v = x + drop(y) over the lane's NJ x 4 elements of `row`; returns the
// keep bits (bit j * 4 + e) and adds the elements into *sum.
template <typename T, int NJ>
__device__ __forceinline__ uint32_t residual(const T* x, const T* y, int row,
                                             int D, int lane, uint32_t w0,
                                             uint32_t w1, uint32_t thresh,
                                             float keep_y, float v[NJ][4],
                                             float* sum) {
  const size_t base = (size_t)row * D;
  uint32_t keep_bits = 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = (lane + 32 * j) * 4;
    float xv[4], yv[4];
    load4(x + base + c, xv);
    load4(y + base + c, yv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float yd = yv[e];
      if (thresh) {
        const uint32_t flat = (uint32_t)row * (uint32_t)D + (uint32_t)(c + e);
        const bool keep = hash_mix(hash_mix(flat, w0), w1) < thresh;
        yd = keep ? round_to<T>(yv[e] / keep_y) : 0.f;
        keep_bits |= (uint32_t)keep << (j * 4 + e);
      }
      v[j][e] = xv[e] + yd;
      *sum += v[j][e];
    }
  }
  return keep_bits;
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kWarps * 32)
    ln_fwd(const T* __restrict__ x, const T* __restrict__ y,
           const float* __restrict__ scale, const float* __restrict__ bias,
           T* __restrict__ out, float* __restrict__ mean_out,
           float* __restrict__ rstd_out, int rows, int D, uint32_t w0,
           uint32_t w1, uint32_t thresh, float keep_y, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  float v[NJ][4];
  float sum = 0.f;
  residual<T, NJ>(x, y, row, D, lane, w0, w1, thresh, keep_y, v, &sum);
  const float mean = warp_sum(sum) / (float)D;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[j][e] -= mean;
      sq += v[j][e] * v[j][e];
    }
  const float rstd = rsqrtf(warp_sum(sq) / (float)D + eps);
  const size_t base = (size_t)row * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = (lane + 32 * j) * 4;
    const float4 s = *reinterpret_cast<const float4*>(scale + c);
    const float4 b = *reinterpret_cast<const float4*>(bias + c);
    float o[4] = {v[j][0] * rstd * s.x + b.x, v[j][1] * rstd * s.y + b.y,
                  v[j][2] * rstd * s.z + b.z, v[j][3] * rstd * s.w + b.w};
    store4(out + base + c, o);
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// A 32-bit word as its fp32 elements (1 of fp32, 2 of bf16), and back.
__device__ __forceinline__ void unpack(uint32_t w, float* v, float) {
  v[0] = __uint_as_float(w);
}
__device__ __forceinline__ void unpack(uint32_t w, float* v, __nv_bfloat16) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack(const float* v, float) {
  return __float_as_uint(v[0]);
}
__device__ __forceinline__ uint32_t pack(const float* v, __nv_bfloat16) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(v[0])) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(v[1])) << 16);
}

// NV contiguous elements of T at p as fp32, and back, by the widest access
// (16, 8 or 4 bytes) that divides the run; element by element where the run
// is not a whole number of words (bf16 with NV odd).
template <typename T, int NV>
__device__ __forceinline__ void load_run(const T* p, float v[NV]) {
  constexpr int kBytes = NV * (int)sizeof(T);
  if constexpr (kBytes % 4 != 0) {
#pragma unroll
    for (int e = 0; e < NV; ++e) v[e] = __bfloat162float(p[e]);
  } else {
    constexpr int W = kBytes % 16 == 0 ? 4 : kBytes % 8 == 0 ? 2 : 1;
    constexpr int kPer = 4 / (int)sizeof(T);
    const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < kBytes / 4; i += W) {
      uint32_t w[W];
      if constexpr (W == 4) {
        const uint4 t = *reinterpret_cast<const uint4*>(q + i);
        w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
      } else if constexpr (W == 2) {
        const uint2 t = *reinterpret_cast<const uint2*>(q + i);
        w[0] = t.x; w[1] = t.y;
      } else {
        w[0] = q[i];
      }
#pragma unroll
      for (int k = 0; k < W; ++k) unpack(w[k], v + (i + k) * kPer, T());
    }
  }
}
template <typename T, int NV>
__device__ __forceinline__ void store_run(T* p, const float v[NV]) {
  constexpr int kBytes = NV * (int)sizeof(T);
  if constexpr (kBytes % 4 != 0) {
#pragma unroll
    for (int e = 0; e < NV; ++e) p[e] = __float2bfloat16(v[e]);
  } else {
    constexpr int W = kBytes % 16 == 0 ? 4 : kBytes % 8 == 0 ? 2 : 1;
    constexpr int kPer = 4 / (int)sizeof(T);
    uint32_t* q = reinterpret_cast<uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < kBytes / 4; i += W) {
      uint32_t w[W];
#pragma unroll
      for (int k = 0; k < W; ++k) w[k] = pack(v + (i + k) * kPer, T());
      if constexpr (W == 4)
        *reinterpret_cast<uint4*>(q + i) = make_uint4(w[0], w[1], w[2], w[3]);
      else if constexpr (W == 2)
        *reinterpret_cast<uint2*>(q + i) = make_uint2(w[0], w[1]);
      else
        q[i] = w[0];
    }
  }
}

// Rows staged ahead: as many as fit 24 KB (with 8 blocks an SM), 2 to 4:
// 4 at D = 1024 in bf16, 2 in fp32.
template <typename T, int D>
__host__ __device__ constexpr int bwd_stages() {
  constexpr int s = 24576 / (3 * D * (int)sizeof(T));
  return s < 2 ? 2 : s > 4 ? 4 : s;
}

// NV = D / 128: the contiguous columns a thread holds.  Shared memory: a
// ring of bwd_stages() rows of dout, x and y with their mean and rstd.  At
// most 64 registers, so 8 blocks fit an SM.  The row's divisions are done
// by every lane and then selected, never behind a branch on the mask: a
// divergent branch around each exact division made the row loop issue
// bound.
template <typename T, int NV>
__global__ void __launch_bounds__(kBwdThreads, 8)
    ln_bwd(const T* __restrict__ dout, const T* __restrict__ x,
           const T* __restrict__ y, const float* __restrict__ scale,
           const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
           T* __restrict__ dx, T* __restrict__ dy, float* __restrict__ ds_part,
           float* __restrict__ db_part, int rows, uint32_t w0, uint32_t w1,
           uint32_t thresh, float keep_y, float keep_g) {
  constexpr int D = NV * kBwdThreads;
  constexpr int S = bwd_stages<T, D>();
  constexpr int kPieces = D * (int)sizeof(T) / 16;  // of a row of one tensor
  __shared__ __align__(16) T stage[S][3][D];
  __shared__ float stat[S][2];  // the staged rows' mean and rstd
  __shared__ float2 red[kBwdThreads / 32];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int col0 = tid * NV;
  const int stride = gridDim.x;

  // Stage `row` into slot st: 16-byte pieces of dout, x and y (a fixed
  // count a thread, unrolled), and its mean and rstd (4-byte copies).  One
  // commit group per call, even empty.
  auto issue = [&](int row, int st) {
    if (row < rows) {
      const size_t base = (size_t)row * D;
      const T* src[3] = {dout + base, x + base, y + base};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        unsigned char* dst = reinterpret_cast<unsigned char*>(stage[st][a]);
        const unsigned char* from =
            reinterpret_cast<const unsigned char*>(src[a]);
#pragma unroll
        for (int k = 0; k < kPieces / kBwdThreads; ++k) {
          const int pc = tid + k * kBwdThreads;
          cp_async16(dst + pc * 16, from + pc * 16, 16);
        }
        constexpr int kRest = kPieces % kBwdThreads;
        if (kRest && tid < kRest) {
          const int pc = kPieces - kRest + tid;
          cp_async16(dst + pc * 16, from + pc * 16, 16);
        }
      }
      if (tid < 2)
        cp_async4(&stat[st][tid], (tid ? rstd_in : mean_in) + row, 4);
    }
    cp_commit();
  };

  float acc_s[NV], acc_b[NV];
#pragma unroll
  for (int e = 0; e < NV; ++e) acc_s[e] = acc_b[e] = 0.f;

#pragma unroll
  for (int k = 0; k < S - 1; ++k) issue(blockIdx.x + k * stride, k);
  // ln_sum_parts may launch now: it waits for this grid before reading
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  int row = blockIdx.x;
  for (int it = 0; row < rows; ++it, row += stride) {
    const int st = it % S;
    cp_wait<S - 2>();  // this row's copies (later rows' may fly on)
    // this row is visible to all, and every thread is done with the last
    // one, whose slot takes row it + S - 1
    __syncthreads();
    issue(row + (S - 1) * stride, (it + S - 1) % S);
    const float mean = stat[st][0], rstd = stat[st][1];
    // scale is re-read from L1 every row, not held in 8 registers
    float s[NV], dov[NV], xv[NV], yv[NV];
    load_run<float, NV>(scale + col0, s);
    load_run<T, NV>(stage[st][0] + col0, dov);
    load_run<T, NV>(stage[st][1] + col0, xv);
    load_run<T, NV>(stage[st][2] + col0, yv);
    uint32_t keep_bits = 0;
    float xhat[NV], d1 = 0.f, d2 = 0.f;
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      float yd = yv[e];
      if (thresh) {
        const uint32_t flat = (uint32_t)row * (uint32_t)D + (uint32_t)(col0 + e);
        const bool keep = hash_mix(hash_mix(flat, w0), w1) < thresh;
        // every lane divides, then selects: no branch that splits the warp
        const float kept = round_to<T>(yv[e] / keep_y);
        yd = keep ? kept : 0.f;
        keep_bits |= (uint32_t)keep << e;
      }
      xhat[e] = (xv[e] + yd - mean) * rstd;
      acc_s[e] += dov[e] * xhat[e];
      acc_b[e] += dov[e];
      const float g = dov[e] * s[e];  // dxhat
      d1 += g;
      d2 += g * xhat[e];
    }
    d1 = warp_sum(d1);
    d2 = warp_sum(d2);
    if ((tid & 31) == 0) red[warp] = make_float2(d1, d2);
    __syncthreads();
    d1 = d2 = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdThreads / 32; ++w) {
      d1 += red[w].x;
      d2 += red[w].y;
    }
    d1 /= (float)D;
    d2 /= (float)D;
    // dxhat again from the staged dout and scale, not held across the
    // barrier: 8 registers fewer under the 64 a thread may use
    load_run<float, NV>(scale + col0, s);
    load_run<T, NV>(stage[st][0] + col0, dov);
    float gx[NV], gy[NV];
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      const float dv = rstd * (dov[e] * s[e] - d1 - xhat[e] * d2);
      gx[e] = dv;
      gy[e] = dv;
      if (thresh) {
        const float kept = dv / keep_g;  // every lane, as above
        gy[e] = ((keep_bits >> e) & 1u) ? kept : 0.f;
      }
    }
    const size_t base = (size_t)row * D + col0;
    store_run<T, NV>(dx + base, gx);
    store_run<T, NV>(dy + base, gy);
  }
  cp_wait<0>();  // no copy may outlive the block

  float* ps = ds_part + (size_t)blockIdx.x * D + col0;
  float* pb = db_part + (size_t)blockIdx.x * D + col0;
#pragma unroll
  for (int e = 0; e < NV; ++e) {
    ps[e] = acc_s[e];
    pb[e] = acc_b[e];
  }
}

// ds = sum over blocks of ds_part, db likewise, in a fixed order: grid
// (ceil(D / 32), 2), block (32, 32); thread (c, w) sums parts w, w + 32,
// ... and the 32 sums are added in order.
__global__ void __launch_bounds__(1024)
    ln_sum_parts(const float* __restrict__ ds_part,
                 const float* __restrict__ db_part, float* __restrict__ ds,
                 float* __restrict__ db, int parts, int D) {
  __shared__ float sh[32][33];
  // launched early (programmatic dependent launch): wait for ln_bwd's grid
  // and its writes
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const float* p = blockIdx.y ? db_part : ds_part;
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (c < D) {
#pragma unroll 8
    for (int g = threadIdx.y; g < parts; g += 32) s += p[(size_t)g * D + c];
  }
  sh[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < D) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < 32; ++w) t += sh[w][threadIdx.x];
    (blockIdx.y ? db : ds)[c] = t;
  }
}

#define HETU_LN_SWITCH(NJ_, CALL) \
  switch (NJ_) {                  \
    case 1: CALL(1); break;       \
    case 2: CALL(2); break;       \
    case 3: CALL(3); break;       \
    case 4: CALL(4); break;       \
    case 5: CALL(5); break;       \
    case 6: CALL(6); break;       \
    case 7: CALL(7); break;       \
    case 8: CALL(8); break;       \
    default: return cudaErrorInvalidValue; \
  }

template <typename T>
cudaError_t fwd(const void* x, const void* y, const void* scale,
                const void* bias, void* out, void* mean, void* rstd, int rows,
                int D, uint32_t w0, uint32_t w1, uint32_t thresh,
                float keep_y, float eps, cudaStream_t s) {
  const dim3 grid((rows + kWarps - 1) / kWarps), block(kWarps * 32);
#define HETU_LN_FWD(N)                                                     \
  ln_fwd<T, N><<<grid, block, 0, s>>>(                                     \
      static_cast<const T*>(x), static_cast<const T*>(y),                  \
      static_cast<const float*>(scale), static_cast<const float*>(bias),   \
      static_cast<T*>(out), static_cast<float*>(mean),                     \
      static_cast<float*>(rstd), rows, D, w0, w1, thresh, keep_y, eps)
  HETU_LN_SWITCH(D / 128, HETU_LN_FWD)
#undef HETU_LN_FWD
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* dout, const void* x, const void* y,
                const void* scale, const void* mean, const void* rstd,
                void* dx, void* dy, void* ds_part, void* db_part, void* ds,
                void* db, int rows, int D, int parts, uint32_t w0,
                uint32_t w1, uint32_t thresh, float keep_y, float keep_g,
                cudaStream_t s) {
#define HETU_LN_BWD(N)                                                      \
  ln_bwd<T, N><<<parts, kBwdThreads, 0, s>>>(                               \
      static_cast<const T*>(dout), static_cast<const T*>(x),                \
      static_cast<const T*>(y), static_cast<const float*>(scale),           \
      static_cast<const float*>(mean), static_cast<const float*>(rstd),     \
      static_cast<T*>(dx), static_cast<T*>(dy),                             \
      static_cast<float*>(ds_part), static_cast<float*>(db_part), rows, w0, \
      w1, thresh, keep_y, keep_g)
  HETU_LN_SWITCH(D / 128, HETU_LN_BWD)
#undef HETU_LN_BWD
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // ln_sum_parts launches while ln_bwd runs (programmatic dependent launch)
  // and waits for it on the device
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((D + 31) / 32, 2);
  cfg.blockDim = dim3(32, 32);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ln_sum_parts,
                           static_cast<const float*>(ds_part),
                           static_cast<const float*>(db_part),
                           static_cast<float*>(ds), static_cast<float*>(db),
                           parts, D);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool shape_ok(int rows, int D) {
  return rows >= 1 && D >= 128 && D % 128 == 0 && D / 128 <= kMaxNJ;
}

}  // namespace

// The widest D the kernels take (a multiple of 128 up to it).
extern "C" int hetu_fused_ln_max_d(void) { return kMaxNJ * 128; }

// dtype: 0 = float32, 1 = bfloat16 (of x, y and out).  x, y, out (rows,
// D); scale, bias (D,) float32; mean, rstd (rows,) float32 outputs.  (w0,
// w1) the key words, thresh the keep threshold (0: no dropout), keep_y the
// keep probability rounded to the inputs' type.  Returns
// cudaGetLastError().
extern "C" int hetu_fused_ln_fwd(int dtype, const void* x, const void* y,
                                 const void* scale, const void* bias,
                                 void* out, void* mean, void* rstd, int rows,
                                 int D, uint32_t w0, uint32_t w1,
                                 uint32_t thresh, float keep_y, float eps,
                                 void* stream) {
  if (!shape_ok(rows, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)fwd<float>(x, y, scale, bias, out, mean, rstd, rows, D, w0,
                           w1, thresh, keep_y, eps, s);
  if (dtype == 1)
    return (int)fwd<__nv_bfloat16>(x, y, scale, bias, out, mean, rstd, rows,
                                   D, w0, w1, thresh, keep_y, eps, s);
  return (int)cudaErrorInvalidValue;
}

// Gradients from dout (rows, D) and the forward's mean and rstd: dx, dy
// (rows, D) in the inputs' type, ds and db (D,) float32.  `parts` blocks
// (1 <= parts <= rows) each write one (D,) partial: ds_part and db_part are
// parts * D float32 scratch.  keep_g is the keep probability in fp32.  Two
// launches on the stream.  Returns cudaGetLastError().
extern "C" int hetu_fused_ln_bwd(int dtype, const void* dout, const void* x,
                                 const void* y, const void* scale,
                                 const void* mean, const void* rstd, void* dx,
                                 void* dy, void* ds_part, void* db_part,
                                 void* ds, void* db, int rows, int D,
                                 int parts, uint32_t w0, uint32_t w1,
                                 uint32_t thresh, float keep_y, float keep_g,
                                 void* stream) {
  if (!shape_ok(rows, D) || parts < 1 || parts > rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)bwd<float>(dout, x, y, scale, mean, rstd, dx, dy, ds_part,
                           db_part, ds, db, rows, D, parts, w0, w1, thresh,
                           keep_y, keep_g, s);
  if (dtype == 1)
    return (int)bwd<__nv_bfloat16>(dout, x, y, scale, mean, rstd, dx, dy,
                                   ds_part, db_part, ds, db, rows, D, parts,
                                   w0, w1, thresh, keep_y, keep_g, s);
  return (int)cudaErrorInvalidValue;
}
