// Packed-head attention for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes); see vln_magic_tpu_torch/ops/attention.py.
//
// Replaces the TPU kernels vln_magic_tpu/ops/attention.py
// `_packed_kernel_grouped` (lines 81-142) and `_packed_kernel` (lines
// 54-78), which compute one function: per batch row b and head h,
//
//   s   = q_bh k_bh^T / sqrt(hd)                      (f32 logits)
//   s  += mask_bias[b]          then  s += sprel[b, h]  (reference order)
//   p   = softmax_f32(s), normalized, then rounded to V's dtype
//   out = p v_bh  (f32 accumulation), written packed in Q's dtype
//
// Q [B, Lq, H*hd] and K, V [B, Lk, H*hd] are read in place with row stride
// H*hd: the head split never materializes.  The TPU kernel's 128-lane
// block-diagonal grouping is a VMEM layout device and is not carried over.
//
// Two routes, both chosen by the wrapper from dtype, Lk and alignment:
//
// * Tensor-core route, `vln_packed_attention_tc`: bf16, hd in {16, 32, 64,
//   128}, 1 <= Lk <= 256, Q/K/V/out 16-byte aligned.  Every call of the
//   MAGIC-S main path takes it.  One block of 4 warps per (64 query rows,
//   head, batch row); each warp owns 16 rows.  The block stages its Q tile
//   and the whole K of its (b, h) into shared memory once with 16-byte
//   cp.async, and V in a second group that lands during Q.K^T and the
//   softmax.  Rows past Lq and keys past Lk are zero-filled, so no garbage
//   reaches an MMA, and the staged mask is -inf past Lk, so a padded key
//   gets P = 0 exactly.  Q.K^T and P.V are mma.sync m16n8k16 bf16 products
//   with f32 accumulation (bf16 x bf16 products are exact in f32: only the
//   order of the sums differs from the plain f32 arithmetic), fed by
//   ldmatrix (.trans for V); shared rows are padded by 16 bytes so the 8
//   rows of an ldmatrix hit distinct banks.  Each warp keeps its 16 rows'
//   logits for all keys in registers, in the accumulator layout: a quad's
//   4 lanes hold a row's column pairs, so the sprel is read once, as
//   float2, in whole 32-byte sectors, 4 key tiles of loads in flight at a
//   time.  The row max and sum take two quad shuffles each; p = exp(s -
//   max) times the correctly rounded 1 / sum (within an ulp of the
//   quotient) is rounded to bf16 and packed straight into the A fragments
//   of P.V: the m16n8 accumulator layout of two adjacent key tiles is the
//   m16n8k16 A layout, so P never touches shared memory.  No online
//   rescale: P is normalized before it is rounded, as the reference does.
//   The key count is a template bucket of 2, 4, 8, 13 or 16 chunks of 16
//   (13: MAGIC's 200-token instructions), and every loop over the chunks
//   has a compile-time count, so the MMAs of different chunks interleave
//   (a runtime bound per chunk keeps them apart, and was slower).
//   Budget, from ptxas -v (CUDA 12.8, sm_90a): no instantiation spills;
//   51-210 registers a thread, at hd 64 66 / 128 / 168 / 181 for the 64,
//   128, 208 and 256-key buckets; dynamic shared memory (64 + 2 keys) x
//   (hd + 8) x 2 + 4 keys bytes (`tc_smem_bytes`), 68.3 KB at hd 64 and
//   208 keys.  So the 200-key calls of the main path run 3 blocks (12
//   warps) per SM, limited by registers and shared memory alike.
//
// * SIMT route, `vln_packed_attention`: f32 (tensor cores would run it in
//   TF32, and the golden decodes run in f32 and must stay exact) and bf16
//   with Lk > 256, which no path of the port uses.  One block of 4 warps per
//   (query tile of 16 rows, head, batch row).  K and V stream through
//   shared memory in tiles of 32 keys, one key per lane for Q.K^T (K rows
//   padded by one float so the lanes hit distinct banks) and one output
//   dimension per lane for P.V.  The softmax takes two passes over K: the
//   first finds each row's max and sum, the second forms the normalized
//   probabilities, rounds them to V's dtype as the reference does, and
//   accumulates P.V.  Any B, Lq and Lk; hd in {16, 32, 64, 128}.
//
// Bound: bytes.  At the six MAGIC-S path shapes (B 256, H 2, hd 64, bf16
// Q/K/V/out, f32 [B, Lk] mask, and at global self-attention the f32
// [B, 2, 128, 128] sprel) each input read once and the output written once
// take, at 3.35 TB/s: language 200 x 200 15.71 us, panorama 50 x 50
// 3.93 us, global cross 128 x 200 12.89 us, global self 128 x 128 20.07 us
// (half of it the sprel), local cross 52 x 200 9.92 us, local self 52 x 52
// 4.08 us (chip_smoke.py `bound`); the FLOPs take 0.3-5.3 us at the bf16
// tensor-core rate.  The tensor-core route reads Q, the sprel and the mask
// once and K/V once per 64-row tile (the tiles of one (b, h) are adjacent
// block indices, run side by side and share K/V through L2), and writes
// out once.
//
// Later work: wgmma and TMA in place of mma.sync and cp.async, and a
// persistent grid that overlaps one tile's softmax and store with the next
// tile's loads.

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

// ---- the tensor-core route (bf16, Lk <= 256) --------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcRows = 16 * kTcWarps;           // query rows per block
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcMaxKeys = 256;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes (and no read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b for one m16n8k16 tile: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16; the lower column in the low half, as mma reads it
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// (row[j], row[j + 1]), 0 for keys from Lk on and for a row that is not
// there; `pairs` (Lk even and the sprel 8-byte aligned) reads both with one
// float2.  The sprel is read once, so it is loaded with the evict-first hint.
__device__ __forceinline__ float2 sprel_pair(const float* row, int j, int Lk,
                                             bool pairs) {
  float2 p = make_float2(0.f, 0.f);
  if (row != nullptr) {
    if (pairs) {
      if (j < Lk) p = __ldcs(reinterpret_cast<const float2*>(row + j));
    } else {
      if (j < Lk) p.x = __ldcs(row + j);
      if (j + 1 < Lk) p.y = __ldcs(row + j + 1);
    }
  }
  return p;
}

// NCH: the 16-key chunks of the register arrays and of the staged K and V;
// keys from Lk to 16 NCH are zero rows with a -inf mask.
template <int HD, int NCH>
__global__ void __launch_bounds__(kTcThreads)
packed_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const float* __restrict__ mask,
                           const float* __restrict__ sprel,
                           __nv_bfloat16* __restrict__ out, int H, int Lq,
                           int Lk, float sqrt_hd) {
  constexpr int kStride = HD + 8;      // bf16 per shared row: +16 bytes
  constexpr int kPieces = HD / 8;      // 16-byte pieces per row
  constexpr int kSteps = HD / 16;      // k16 steps of Q.K^T
  constexpr int kKeys = NCH * 16;      // staged keys
  constexpr int kBatch = 4;            // key tiles of sprel loads in flight
  constexpr bool kQInRegs = HD <= 64;  // hd 128 reloads Q per key chunk
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sk = sq + kTcRows * kStride;
  __nv_bfloat16* sv = sk + kKeys * kStride;
  float* smask = reinterpret_cast<float*>(sv + kKeys * kStride);

  const int n_qtiles = (Lq + kTcRows - 1) / kTcRows;
  const int qtile = blockIdx.x % n_qtiles;
  const int h = (blockIdx.x / n_qtiles) % H;
  const int b = blockIdx.x / (n_qtiles * H);
  const int D = H * HD;
  const int q0 = qtile * kTcRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // mma fragment coordinates: this lane holds rows g and g + 8 of its
  // warp's 16, and columns 2t, 2t + 1 of each n8 tile
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
  const bool active = q0 + warp * 16 < Lq;   // warp-uniform

  // group 0: the Q tile and K; group 1: V, which lands during Q.K^T and the
  // softmax
  {
    const __nv_bfloat16* qb = q + (size_t)b * Lq * D + h * HD;
    const __nv_bfloat16* kb = k + (size_t)b * Lk * D + h * HD;
    const __nv_bfloat16* vb = v + (size_t)b * Lk * D + h * HD;
    auto stage_keys = [&](__nv_bfloat16* dst, const __nv_bfloat16* src) {
      for (int e = tid; e < kKeys * kPieces; e += kTcThreads) {
        const int r = e / kPieces, c = (e % kPieces) * 8;
        const bool ok = r < Lk;
        cp_async16(dst + r * kStride + c, src + (size_t)(ok ? r : 0) * D + c, ok);
      }
    };
    for (int e = tid; e < kTcRows * kPieces; e += kTcThreads) {
      const int r = e / kPieces, c = (e % kPieces) * 8;
      const bool ok = q0 + r < Lq;
      cp_async16(sq + r * kStride + c, qb + (size_t)(ok ? q0 + r : 0) * D + c, ok);
    }
    stage_keys(sk, kb);
    cp_async_commit();
    stage_keys(sv, vb);
    cp_async_commit();
    for (int j = tid; j < kKeys; j += kTcThreads)
      smask[j] = j < Lk ? mask[(size_t)b * Lk + j] : -INFINITY;
  }

  // ldmatrix row addresses: A (Q) and trans B (V) take row lane % 16 and
  // column block lane / 16; B (K) takes row lane % 8 + 8 (lane / 16) and
  // column block (lane / 8) % 2
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
  const __nv_bfloat16* qw = sq + (warp * 16 + a_row) * kStride + a_col;

  float s[2 * NCH][4];   // logits, then exp(s - max), of chunk c's key tiles
  uint32_t qf[kQInRegs ? kSteps : 1][4];
  auto qk_chunk = [&](int c) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t kf[4];
      ldmatrix_x4(kf, sk + (c * 16 + b_row) * kStride + kk * 16 + b_col);
      const int i = kQInRegs ? kk : 0;
      if constexpr (!kQInRegs) ldmatrix_x4(qf[0], qw + kk * 16);
      mma_bf16(s[2 * c], qf[i], kf[0], kf[1]);
      mma_bf16(s[2 * c + 1], qf[i], kf[2], kf[3]);
    }
  };
#pragma unroll
  for (int n = 0; n < 2 * NCH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;

  uint32_t pf[NCH][4];   // P as bf16 A fragments, one per 16-key chunk
  cp_async_wait<1>();
  __syncthreads();       // Q, K and the mask are staged
  if (active) {
    if constexpr (kQInRegs) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) ldmatrix_x4(qf[kk], qw + kk * 16);
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) qk_chunk(c);

    // s / sqrt(hd) + mask, then + sprel, in the reference's order; the
    // division is a product where sqrt(hd) is a power of two (exact)
    const float inv = 1.f / sqrt_hd;
    const bool pairs =
        Lk % 2 == 0 && (reinterpret_cast<uintptr_t>(sprel) & 7) == 0;
    auto scaled = [&](float x) {
      if constexpr (HD == 16 || HD == 64) return x * inv;
      else return x / sqrt_hd;
    };
#pragma unroll
    for (int n = 0; n < 2 * NCH; ++n) {
      const float2 mk = *reinterpret_cast<const float2*>(smask + n * 8 + 2 * t);
      s[n][0] = scaled(s[n][0]) + mk.x;
      s[n][1] = scaled(s[n][1]) + mk.y;
      s[n][2] = scaled(s[n][2]) + mk.x;
      s[n][3] = scaled(s[n][3]) + mk.y;
    }
    if (sprel) {
      // the sprel of rows r_lo and r_hi, kBatch key tiles at a time, all
      // loads of a batch in flight together; + 0 leaves a padded key at
      // -inf and a row past Lq as it is
      const float* sp_lo = r_lo < Lq
          ? sprel + (((size_t)b * H + h) * Lq + r_lo) * Lk : nullptr;
      const float* sp_hi = r_hi < Lq ? sp_lo + 8 * (size_t)Lk : nullptr;
#pragma unroll
      for (int n0 = 0; n0 < 2 * NCH; n0 += kBatch) {
        float2 lo[kBatch], hi[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch && n0 + i < 2 * NCH; ++i) {
          lo[i] = sprel_pair(sp_lo, (n0 + i) * 8 + 2 * t, Lk, pairs);
          hi[i] = sprel_pair(sp_hi, (n0 + i) * 8 + 2 * t, Lk, pairs);
        }
#pragma unroll
        for (int i = 0; i < kBatch && n0 + i < 2 * NCH; ++i) {
          s[n0 + i][0] = s[n0 + i][0] + lo[i].x;
          s[n0 + i][1] = s[n0 + i][1] + lo[i].y;
          s[n0 + i][2] = s[n0 + i][2] + hi[i].x;
          s[n0 + i][3] = s[n0 + i][3] + hi[i].y;
        }
      }
    }
    float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2 * NCH; ++n) {
      m_lo = fmaxf(m_lo, fmaxf(s[n][0], s[n][1]));
      m_hi = fmaxf(m_hi, fmaxf(s[n][2], s[n][3]));
    }
    // a row's columns lie in its quad's 4 lanes
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, o));
      m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, o));
    }
    float l_lo = 0.f, l_hi = 0.f;
#pragma unroll
    for (int n = 0; n < 2 * NCH; ++n) {
      s[n][0] = expf(s[n][0] - m_lo);
      s[n][1] = expf(s[n][1] - m_lo);
      s[n][2] = expf(s[n][2] - m_hi);
      s[n][3] = expf(s[n][3] - m_hi);
      l_lo += s[n][0] + s[n][1];
      l_hi += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o);
    }
    // normalize (times the correctly rounded 1 / sum: within an ulp of the
    // quotient), then round; key tiles 2c and 2c + 1 are chunk c's A
    const float i_lo = 1.f / l_lo, i_hi = 1.f / l_hi;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      pf[c][0] = pack_bf16(s[2 * c][0] * i_lo, s[2 * c][1] * i_lo);
      pf[c][1] = pack_bf16(s[2 * c][2] * i_hi, s[2 * c][3] * i_hi);
      pf[c][2] = pack_bf16(s[2 * c + 1][0] * i_lo, s[2 * c + 1][1] * i_lo);
      pf[c][3] = pack_bf16(s[2 * c + 1][2] * i_hi, s[2 * c + 1][3] * i_hi);
    }
  }

  cp_async_wait<0>();
  __syncthreads();       // V is staged
  if (!active) return;
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, sv + (c * 16 + a_row) * kStride + dp * 16 + a_col);
      mma_bf16(o[2 * dp], pf[c], vf[0], vf[1]);
      mma_bf16(o[2 * dp + 1], pf[c], vf[2], vf[3]);
    }
  }

  __nv_bfloat16* ob = out + h * HD + 2 * t;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (r_lo < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + ((size_t)b * Lq + r_lo) * D + n * 8) =
          __floats2bfloat162_rn(o[n][0], o[n][1]);
    if (r_hi < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + ((size_t)b * Lq + r_hi) * D + n * 8) =
          __floats2bfloat162_rn(o[n][2], o[n][3]);
  }
}

constexpr size_t tc_smem_bytes(int hd, int n_keys) {
  return (size_t)(kTcRows + 2 * n_keys) * (hd + 8) * sizeof(__nv_bfloat16) +
         (size_t)n_keys * sizeof(float);
}

template <int HD, int NCH>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const float* mask, const float* sprel, void* out, int B,
                      int H, int Lq, int Lk, float sqrt_hd,
                      cudaStream_t stream) {
  const long long n_qtiles = (Lq + kTcRows - 1) / kTcRows;
  const long long blocks = n_qtiles * H * B;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = packed_attention_tc_kernel<HD, NCH>;
  constexpr size_t smem = tc_smem_bytes(HD, NCH * 16);
  // above 48 KB of dynamic shared memory a kernel must opt in, once per
  // device
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !opted_in[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) opted_in[dev] = true;
  }
  kernel<<<(unsigned)blocks, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mask, sprel,
      static_cast<__nv_bfloat16*>(out), H, Lq, Lk, sqrt_hd);
  return cudaGetLastError();
}

// the key buckets: 16-key chunks for at most 32, 64, 128, 208 (the MAGIC
// instruction length 200, rounded to 16) and 256 keys
template <int HD>
cudaError_t dispatch_keys(const void* q, const void* k, const void* v,
                          const float* mask, const float* sprel, void* out,
                          int B, int H, int Lq, int Lk, float sqrt_hd,
                          cudaStream_t stream) {
  if (Lk <= 32)
    return launch_tc<HD, 2>(q, k, v, mask, sprel, out, B, H, Lq, Lk, sqrt_hd, stream);
  if (Lk <= 64)
    return launch_tc<HD, 4>(q, k, v, mask, sprel, out, B, H, Lq, Lk, sqrt_hd, stream);
  if (Lk <= 128)
    return launch_tc<HD, 8>(q, k, v, mask, sprel, out, B, H, Lq, Lk, sqrt_hd, stream);
  if (Lk <= 208)
    return launch_tc<HD, 13>(q, k, v, mask, sprel, out, B, H, Lq, Lk, sqrt_hd, stream);
  return launch_tc<HD, 16>(q, k, v, mask, sprel, out, B, H, Lq, Lk, sqrt_hd, stream);
}

}  // namespace

// The SIMT route.  dtype: 0 = float32, 1 = bfloat16.  sprel may be NULL.
// Returns the cudaError_t of the launch (0 on success); the kernel
// allocates nothing and runs on `stream`.
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

// The tensor-core route: the same arguments; refuses (cudaErrorInvalidValue)
// anything but bf16 (dtype 1), Lk in [1, 256] and 16-byte aligned q, k, v
// and out.
extern "C" int vln_packed_attention_tc(const void* q, const void* k,
                                       const void* v, const float* mask,
                                       const float* sprel, void* out, int B,
                                       int H, int Lq, int Lk, int hd,
                                       int dtype, float sqrt_hd,
                                       void* stream) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(out);
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || Lk > kTcMaxKeys ||
      dtype != 1 || (any & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return (int)dispatch_keys<16>(q, k, v, mask, sprel, out, B, H, Lq, Lk, sqrt_hd, s);
    case 32: return (int)dispatch_keys<32>(q, k, v, mask, sprel, out, B, H, Lq, Lk, sqrt_hd, s);
    case 64: return (int)dispatch_keys<64>(q, k, v, mask, sprel, out, B, H, Lq, Lk, sqrt_hd, s);
    case 128: return (int)dispatch_keys<128>(q, k, v, mask, sprel, out, B, H, Lq, Lk, sqrt_hd, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
