// Fused biased attention with the head-averaged probability map, for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes); see
// vln_magic_tpu_torch/ops/attention.py.
//
// Replaces the TPU kernel vln_magic_tpu/ops/attention.py `_kernel` (lines
// 37-51, called by `fused_attention`, lines 256-286), which computes, for
// each batch row b and every head h of it,
//
//   s_h   = (q_bh k_bh^T) * (1/sqrt(hd)) + bias[b, h]      (f32 logits)
//   p_h   = softmax_f32(s_h)
//   out_h = round(p_h, V's dtype) v_bh   (f32 accumulation, stored in Q's dtype)
//   probs = (sum_h p_h) / H             (f32, never rounded)
//
// Q [B, H, Lq, hd] and K, V [B, H, Lk, hd] are contiguous.  The bias is read
// in place through four element strides, with stride 0 on every dimension
// the caller broadcast (usually [B, 1, 1, Lk]), so a broadcast bias is never
// materialised.
//
// Design: one block of 4 warps per (tile of 16 query rows, batch row); the
// block loops over all heads, so the head sum of the map stays in registers
// and needs no atomics, and the [B, H, Lq, Lk] scores never reach device
// memory.  For each head the K tiles (32 keys, one key per lane) stream
// through shared memory once; each lane keeps its keys' logits of its warp's
// 4 rows in registers (at most 8 tiles: Lk <= 256), so the softmax is exact
// in one sweep over the registers.  Then the V tiles stream through the same
// buffer and each lane accumulates one output dimension of P.V.  hd in
// {16, 32, 64, 128}, any B, H and Lq, Lk in [1, 256].
//
// Bound: bytes.  At the MAGIC-S global self-attention shape (B 256, H 2,
// L 128, hd 64, bf16, a full f32 [B, H, Lq, Lk] bias) it moves about 67 MB
// with the f32 map, about 20 us at 3.35 TB/s, against 2.1 GFLOP, about 2 us
// at the bf16 tensor-core rate.  This first version uses plain f32 FMAs from
// shared memory; tensor cores and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kQRows = kWarps * kRowsPerWarp;   // query rows per block
constexpr int kKeyTile = 32;                     // keys per tile: one per lane
constexpr int kMaxTiles = 8;                     // Lk <= 256
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fused_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const float* __restrict__ bias, long long bs_b,
                       long long bs_h, long long bs_q, long long bs_k,
                       T* __restrict__ out, float* __restrict__ probs, int H,
                       int Lq, int Lk, float scale) {
  constexpr int kDimsPerLane = (HD + 31) / 32;
  __shared__ float sq[kQRows][HD];
  __shared__ float skv[kKeyTile][HD + 1];   // a K tile, then a V tile

  const int n_qtiles = (Lq + kQRows - 1) / kQRows;
  const int qtile = blockIdx.x % n_qtiles;
  const int b = blockIdx.x / n_qtiles;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = qtile * kQRows;

  // head sum of the probabilities of (row r, key t * 32 + lane)
  float pacc[kRowsPerWarp][kMaxTiles];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) pacc[r][t] = 0.f;

  for (int h = 0; h < H; ++h) {
    const size_t bh = (size_t)b * H + h;
    const T* qh = q + bh * Lq * HD;
    const T* kh = k + bh * Lk * HD;
    const T* vh = v + bh * Lk * HD;
    const float* bias_bh = bias + b * bs_b + h * bs_h;

    __syncthreads();   // the previous head is done with sq and skv
    for (int e = tid; e < kQRows * HD; e += kThreads) {
      const int r = e / HD, c = e % HD;
      const int i = q0 + r;
      sq[r][c] = i < Lq ? to_f32(qh[(size_t)i * HD + c]) : 0.f;
    }

    // logits: lane holds key t * 32 + lane of each of its warp's rows
    float s[kRowsPerWarp][kMaxTiles];
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {
      const int k0 = t * kKeyTile;
      if (k0 < Lk) {   // uniform over the block
        __syncthreads();
        for (int e = tid; e < kKeyTile * HD; e += kThreads) {
          const int r = e / HD, c = e % HD;
          const int j = k0 + r;
          skv[r][c] = j < Lk ? to_f32(kh[(size_t)j * HD + c]) : 0.f;
        }
        __syncthreads();
        float acc[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
          const float kd = skv[lane][d];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            acc[r] = fmaf(sq[warp * kRowsPerWarp + r][d], kd, acc[r]);
        }
        const int j = k0 + lane;
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int i = q0 + warp * kRowsPerWarp + r;
          if (j < Lk) {
            float x = acc[r] * scale;
            if (i < Lq) x = x + bias_bh[i * bs_q + j * bs_k];
            s[r][t] = x;
          } else {
            s[r][t] = -INFINITY;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) s[r][t] = -INFINITY;
      }
    }

    // exact softmax over the registers; keys past Lk give exp(-inf) = 0
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float m = -INFINITY;
#pragma unroll
      for (int t = 0; t < kMaxTiles; ++t) m = fmaxf(m, s[r][t]);
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxTiles; ++t) {
        s[r][t] = expf(s[r][t] - m);
        sum += s[r][t];
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int t = 0; t < kMaxTiles; ++t) {
        const float p = s[r][t] / sum;
        pacc[r][t] += p;
        s[r][t] = to_f32(from_f32<T>(p));   // P in V's dtype for P.V
      }
    }

    // P.V: lane accumulates output dimensions lane, lane + 32, ...
    float o[kRowsPerWarp][kDimsPerLane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int u = 0; u < kDimsPerLane; ++u) o[r][u] = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {
      const int k0 = t * kKeyTile;
      if (k0 < Lk) {
        __syncthreads();
        for (int e = tid; e < kKeyTile * HD; e += kThreads) {
          const int r = e / HD, c = e % HD;
          const int j = k0 + r;
          skv[r][c] = j < Lk ? to_f32(vh[(size_t)j * HD + c]) : 0.f;
        }
        __syncthreads();
        const int n_keys = min(kKeyTile, Lk - k0);
        for (int jj = 0; jj < n_keys; ++jj) {
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const float pj = __shfl_sync(0xffffffffu, s[r][t], jj);
#pragma unroll
            for (int u = 0; u < kDimsPerLane; ++u) {
              const int d = lane + 32 * u;
              if (d < HD) o[r][u] = fmaf(pj, skv[jj][d], o[r][u]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = q0 + warp * kRowsPerWarp + r;
      if (i >= Lq) continue;
#pragma unroll
      for (int u = 0; u < kDimsPerLane; ++u) {
        const int d = lane + 32 * u;
        if (d < HD) out[(bh * Lq + i) * HD + d] = from_f32<T>(o[r][u]);
      }
    }
  }

  const float heads = (float)H;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = q0 + warp * kRowsPerWarp + r;
    if (i >= Lq) continue;
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {
      const int j = t * kKeyTile + lane;
      if (j < Lk) probs[((size_t)b * Lq + i) * Lk + j] = pacc[r][t] / heads;
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, const long long* bias_strides, void* out,
                   float* probs, int B, int H, int Lq, int Lk, float scale,
                   cudaStream_t stream) {
  const long long blocks = (long long)((Lq + kQRows - 1) / kQRows) * B;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fused_attention_kernel<T, HD><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, bias_strides[0], bias_strides[1],
      bias_strides[2], bias_strides[3], static_cast<T*>(out), probs, H, Lq,
      Lk, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const float* bias, const long long* bias_strides,
                        void* out, float* probs, int B, int H, int Lq, int Lk,
                        float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, bias, bias_strides, out, probs, B, H, Lq, Lk, scale, stream);
    case 32: return launch<T, 32>(q, k, v, bias, bias_strides, out, probs, B, H, Lq, Lk, scale, stream);
    case 64: return launch<T, 64>(q, k, v, bias, bias_strides, out, probs, B, H, Lq, Lk, scale, stream);
    case 128: return launch<T, 128>(q, k, v, bias, bias_strides, out, probs, B, H, Lq, Lk, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  bias_strides: the f32 bias's element
// strides over (B, H, Lq, Lk), 0 where it is broadcast.  Returns the
// cudaError_t of the launch (0 on success); the kernel allocates nothing and
// runs on `stream`.
extern "C" int vln_fused_attention(const void* q, const void* k,
                                   const void* v, const float* bias,
                                   const long long* bias_strides, void* out,
                                   float* probs, int B, int H, int Lq, int Lk,
                                   int hd, int dtype, float scale,
                                   void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || Lk > kMaxTiles * kKeyTile)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_hd<float>(hd, q, k, v, bias, bias_strides, out, probs, B, H, Lq, Lk, scale, s);
  else if (dtype == 1)
    err = dispatch_hd<__nv_bfloat16>(hd, q, k, v, bias, bias_strides, out, probs, B, H, Lq, Lk, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
