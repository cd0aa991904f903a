// Packed-head attention for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes); see vln_magic_tpu_torch/ops/attention.py.
//
// Replaces the TPU kernels vln_magic_tpu/ops/attention.py
// `_packed_kernel_grouped` (lines 81-142) and `_packed_kernel` (lines
// 54-78), which compute one function: per batch row b and head h,
//
//   s   = q_bh k_bh^T / sqrt(hd)                      (f32 logits)
//   s  += mask_bias[b]          then  s += sprel[b, h]  (reference order)
//   p   = softmax_f32(s), rounded to V's dtype
//   out = p v_bh  (f32 accumulation), written packed in Q's dtype
//
// Q [B, Lq, H*hd] and K, V [B, Lk, H*hd] are read in place with row stride
// H*hd: the head split never materializes.  The TPU kernel's 128-lane
// block-diagonal grouping is a VMEM layout device and is not carried over.
//
// Design: one block of 4 warps per (query tile of 16 rows, head, batch row).
// K and V stream through shared memory in tiles of 32 keys, one key per
// lane for Q.K^T (K rows padded by one float so the lanes hit distinct
// banks) and one output dimension per lane for P.V.  The softmax takes two
// passes over K: the first finds each row's max and sum, the second forms
// the normalized probabilities, rounds them to V's dtype as the reference
// does, and accumulates P.V.  Any B, Lq and Lk; hd in {16, 32, 64, 128}.
//
// Bound: bytes.  At the global self-attention shape (B 256, L 128, H*hd
// 128, bf16 Q/K/V/out, f32 [B, 2, 128, 128] sprel) the function moves about
// 67 MB, about 20 us at 3.35 TB/s; its 2*2*B*H*Lq*Lk*hd = 2.1 GFLOP take
// about 2 us at the bf16 tensor-core rate.  This first version uses plain
// f32 FMAs and reads K (and the sprel) twice; tensor cores, TMA and a
// one-pass softmax are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kQRows = kWarps * kRowsPerWarp;   // query rows per block
constexpr int kKeyTile = 32;                     // keys per tile: one per lane
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
packed_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ mask,
                        const float* __restrict__ sprel,
                        T* __restrict__ out, int B, int H, int Lq, int Lk,
                        float sqrt_hd) {
  constexpr int kDimsPerLane = (HD + 31) / 32;
  __shared__ float sq[kQRows][HD];
  __shared__ float sk[kKeyTile][HD + 1];
  __shared__ float sv[kKeyTile][HD];

  const int n_qtiles = (Lq + kQRows - 1) / kQRows;
  const int qtile = blockIdx.x % n_qtiles;
  const int h = (blockIdx.x / n_qtiles) % H;
  const int b = blockIdx.x / (n_qtiles * H);
  const int D = H * HD;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = qtile * kQRows;

  // stage this block's query rows (head h's columns) as f32
  for (int e = tid; e < kQRows * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    const int i = q0 + r;
    sq[r][c] = i < Lq ? to_f32(q[((size_t)b * Lq + i) * D + h * HD + c]) : 0.f;
  }

  const float* mask_b = mask + (size_t)b * Lk;
  const float* sprel_bh =
      sprel ? sprel + ((size_t)b * H + h) * Lq * Lk : nullptr;

  float row_max[kRowsPerWarp], row_sum[kRowsPerWarp];
  float acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    row_max[r] = -INFINITY;
    row_sum[r] = 0.f;
#pragma unroll
    for (int t = 0; t < kDimsPerLane; ++t) acc[r][t] = 0.f;
  }

  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < Lk; k0 += kKeyTile) {
      __syncthreads();   // previous tile fully consumed (and sq staged)
      for (int e = tid; e < kKeyTile * HD; e += kThreads) {
        const int r = e / HD, c = e % HD;
        const int j = k0 + r;
        const size_t off = ((size_t)b * Lk + j) * D + h * HD + c;
        sk[r][c] = j < Lk ? to_f32(k[off]) : 0.f;
        if (pass == 1) sv[r][c] = j < Lk ? to_f32(v[off]) : 0.f;
      }
      __syncthreads();

      // logits of this lane's key against the warp's query rows
      const int j = k0 + lane;
      float s[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        const float kd = sk[lane][d];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          s[r] = fmaf(sq[warp * kRowsPerWarp + r][d], kd, s[r]);
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int i = q0 + warp * kRowsPerWarp + r;
        if (j < Lk) {
          float x = s[r] / sqrt_hd;
          x = x + mask_b[j];
          if (sprel_bh && i < Lq) x = x + sprel_bh[(size_t)i * Lk + j];
          s[r] = x;
        } else {
          s[r] = -INFINITY;
        }
      }

      if (pass == 0) {
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float m_new = fmaxf(row_max[r], warp_max(s[r]));
          row_sum[r] = row_sum[r] * expf(row_max[r] - m_new) +
                       warp_sum(expf(s[r] - m_new));
          row_max[r] = m_new;
        }
      } else {
        float p[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          p[r] = to_f32(from_f32<T>(expf(s[r] - row_max[r]) / row_sum[r]));
        const int n_keys = min(kKeyTile, Lk - k0);
        for (int jj = 0; jj < n_keys; ++jj) {
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const float pj = __shfl_sync(0xffffffffu, p[r], jj);
#pragma unroll
            for (int t = 0; t < kDimsPerLane; ++t) {
              const int d = lane + 32 * t;
              if (d < HD) acc[r][t] = fmaf(pj, sv[jj][d], acc[r][t]);
            }
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
    for (int t = 0; t < kDimsPerLane; ++t) {
      const int d = lane + 32 * t;
      if (d < HD) out[((size_t)b * Lq + i) * D + h * HD + d] = from_f32<T>(acc[r][t]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* mask, const float* sprel, void* out, int B,
                   int H, int Lq, int Lk, float sqrt_hd, cudaStream_t stream) {
  const long long n_qtiles = (Lq + kQRows - 1) / kQRows;
  const long long blocks = n_qtiles * H * B;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  packed_attention_kernel<T, HD><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, sprel, static_cast<T*>(out), B, H, Lq,
      Lk, sqrt_hd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const float* mask, const float* sprel, void* out,
                        int B, int H, int Lq, int Lk, float sqrt_hd,
                        cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, mask, sprel, out, B, H, Lq, Lk, sqrt_hd, stream);
    case 32: return launch<T, 32>(q, k, v, mask, sprel, out, B, H, Lq, Lk, sqrt_hd, stream);
    case 64: return launch<T, 64>(q, k, v, mask, sprel, out, B, H, Lq, Lk, sqrt_hd, stream);
    case 128: return launch<T, 128>(q, k, v, mask, sprel, out, B, H, Lq, Lk, sqrt_hd, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  sprel may be NULL.  Returns the
// cudaError_t of the launch (0 on success); the kernel allocates nothing and
// runs on `stream`.
extern "C" int vln_packed_attention(const void* q, const void* k,
                                    const void* v, const float* mask,
                                    const float* sprel, void* out, int B,
                                    int H, int Lq, int Lk, int hd, int dtype,
                                    float sqrt_hd, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_hd<float>(hd, q, k, v, mask, sprel, out, B, H, Lq, Lk, sqrt_hd, s);
  else if (dtype == 1)
    err = dispatch_hd<__nv_bfloat16>(hd, q, k, v, mask, sprel, out, B, H, Lq, Lk, sqrt_hd, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
