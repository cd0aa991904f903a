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
// Two routes, chosen by the wrapper from dtype, Lk and alignment:
//
// * Tensor-core route, `vln_fused_attention_tc`: bf16, hd in {16, 32, 64,
//   128}, 1 <= Lk <= 256, Q/K/V/out 16-byte aligned.  One block of 4 warps
//   (2 for at most 32 keys) per (16 or 32 query rows, batch row); the warps
//   of each 16-row tile split its keys: with 4 warps on one tile, warp w
//   takes the 16-key chunks w, w + 4, ...  32-row blocks, which stage K and
//   V once for twice the rows, are taken at hd 64 where they still give
//   264 blocks (two per SM); the teacher layout (B 16, H 12) keeps 16-row
//   blocks to fill the card.  The block loops over the heads.  Per head,
//   Q and K are staged with 16-byte cp.async (one group) and V (another);
//   Q.K^T and P.V are mma.sync m16n8k16 bf16 products with f32
//   accumulation fed by ldmatrix (.trans for V), shared rows padded by 16
//   bytes.  Each warp keeps its chunks' logits in registers in the
//   accumulator layout.  The row max and the row sum go through shared
//   memory between the warps of a tile (the sum added in warp order), so
//   p = exp(s - max) times the correctly rounded 1 / sum is exact in one
//   sweep; p in f32 goes into the map, p rounded to bf16 goes straight from
//   two m16n8 accumulators into the m16n8k16 A fragment of P.V.  The warps'
//   partial P.V go through shared memory (aliasing V) and the tile's first
//   warp adds them in warp order.  The head sum of the map stays in
//   registers: each lane owns the same map positions for every head, so the
//   sum needs no atomics and its order is fixed, and two calls give the
//   same bits.  The map is written once, as float2 from the accumulator
//   layout.  Loads overlap the math: the next head's Q and K are issued as
//   soon as every warp is past Q.K^T, its V as soon as the partial P.V are
//   read.  Keys from Lk to 16 NCH are zero rows with a -inf mask, so P is
//   exactly 0 there.  The bias: [B, 1, 1, Lk] (strides 0 over heads and
//   rows) is staged once per block into the mask; a bias with unit key
//   stride, even strides and Lk, and 8-byte alignment is read as float2
//   from the accumulator layout, 4 key tiles of loads in flight; any other
//   strides take scalar reads.  The key count is a template bucket of 2, 4,
//   8, 13 or 16 chunks of 16 (13: MAGIC's 200-token instructions), so every
//   chunk loop has a compile-time count.  Registers and shared memory per
//   instantiation, from ptxas -v, are in PERF.md; none spills.
//
// * SIMT route, `vln_fused_attention`: f32 (tensor cores would run it in
//   TF32, and the map is held to 2e-5) and bf16 with misaligned inputs.  One
//   block of 4 warps per (tile of 16 query rows, batch row); the block loops
//   over all heads, so the head sum of the map stays in registers.  For each
//   head the K tiles (32 keys, one key per lane) stream through shared
//   memory once; each lane keeps its keys' logits of its warp's 4 rows in
//   registers (at most 8 tiles: Lk <= 256), so the softmax is exact in one
//   sweep over the registers.  Then the V tiles stream through the same
//   buffer and each lane accumulates one output dimension of P.V.  hd in
//   {16, 32, 64, 128}, any B, H and Lq, Lk in [1, 256].
//
// Bound: bytes.  At the MAGIC-S global self-attention shape (B 256, H 2,
// L 128, hd 64, bf16, a full f32 [B, H, Lq, Lk] bias) it moves about 84 MB
// with the f32 map, about 25 us at 3.35 TB/s, against 2.1 GFLOP, about 2 us
// at the bf16 tensor-core rate (chip_smoke.py `fused_bound`).

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

// ---- the tensor-core route (bf16, Lk <= 256) --------------------------------

constexpr int kTcMaxKeys = 256;
constexpr int kMaxDevices = 64;
// a grid of 32-row blocks needs this many blocks (two per SM of the H100)
// to take them; below it 16-row blocks fill the card better
constexpr long long kMinTallBlocks = 264;

// the warps of a block: 4, or 2 for 2 chunks; its RT row tiles of 16 rows
// each take W / RT of them, which split the key chunks
__host__ __device__ constexpr int tc_warps(int nch) { return nch < 4 ? nch : 4; }

// dynamic shared memory of a block: Q [16 RT][hd + 8] and K [keys][hd + 8]
// in bf16; V [keys][hd + 8] in bf16, or the O exchange [warps - RT][16]
// [hd + 8] in f32 that aliases it, whichever is larger; the mask [keys];
// the row max and sum of each warp [2][warps][16] (ops/attention.py
// `fused_tc_smem_bytes` mirrors it)
__host__ __device__ constexpr size_t tc_smem_bytes(int hd, int nch, int rt) {
  const size_t q = (size_t)16 * rt * (hd + 8) * 2;
  const size_t kv = (size_t)nch * 16 * (hd + 8) * 2;
  const size_t ox = (size_t)(tc_warps(nch) - rt) * 16 * (hd + 8) * 4;
  return q + kv + (kv > ox ? kv : ox) + (size_t)nch * 16 * 4 +
         (size_t)2 * tc_warps(nch) * 16 * 4;
}

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

// (row[j], row[j + 1]) of a bias row with key stride bs_k, 0 for keys from
// Lk on and for a row that is not there; `pairs` (bs_k 1, Lk even, the row
// 8-byte aligned) reads both with one float2
__device__ __forceinline__ float2 bias_pair(const float* row, int j, int Lk,
                                            long long bs_k, bool pairs) {
  float2 p = make_float2(0.f, 0.f);
  if (row != nullptr) {
    if (pairs) {
      if (j < Lk) p = __ldg(reinterpret_cast<const float2*>(row + j));
    } else {
      if (j < Lk) p.x = __ldg(row + j * bs_k);
      if (j + 1 < Lk) p.y = __ldg(row + (j + 1) * bs_k);
    }
  }
  return p;
}

// (x, y) at columns j, j + 1 of map row r: one float2 where Lk is even
__device__ __forceinline__ void store_map_pair(float* row, int j, int Lk,
                                               float x, float y) {
  if (Lk % 2 == 0) {
    if (j < Lk) __stcs(reinterpret_cast<float2*>(row + j), make_float2(x, y));
  } else {
    if (j < Lk) __stcs(row + j, x);
    if (j + 1 < Lk) __stcs(row + j + 1, y);
  }
}

// blocks per SM that ptxas must leave room for: 3 for 32-row blocks of at
// most 128 keys (at most 170 registers, which they need no more than), 2
// for longer ones (3 would spill); 16-row blocks take what registers they
// want, which measured faster than ptxas' default budget
__host__ __device__ constexpr int tc_min_blocks(int nch, int rt) {
  return rt == 2 ? (nch <= 8 ? 3 : 2) : 1;
}

// NCH: the 16-key chunks staged per head; RT: the block's row tiles of 16.
// Warp w takes row tile w / KS and, of it, the chunks w % KS + KS i for the
// CPW slots i (a slot past NCH holds no keys)
template <int HD, int NCH, int RT>
__global__ void __launch_bounds__(32 * tc_warps(NCH), tc_min_blocks(NCH, RT))
fused_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const float* __restrict__ bias, long long bs_b,
                          long long bs_h, long long bs_q, long long bs_k,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ probs, int H, int Lq, int Lk,
                          float scale) {
  constexpr int W = tc_warps(NCH);
  constexpr int KS = W / RT;               // warps per row tile
  constexpr int kRows = 16 * RT;           // query rows per block
  constexpr int kThreadsTc = 32 * W;
  constexpr int CPW = (NCH + KS - 1) / KS; // chunk slots per warp
  constexpr int kBatch = 4;                // key tiles of bias loads in flight
  constexpr int kStride = HD + 8;          // bf16 per staged row: +16 bytes
  constexpr int kOStride = HD + 8;         // f32 per row of the O exchange
  constexpr int kPieces = HD / 8;          // 16-byte pieces per row
  constexpr int kSteps = HD / 16;          // k16 steps of Q.K^T
  constexpr int kKeys = NCH * 16;
  constexpr size_t kKVBytes = (size_t)kKeys * kStride * 2;
  constexpr size_t kOxBytes = (size_t)(W - RT) * 16 * kOStride * 4;
  constexpr size_t kVBytes = kKVBytes > kOxBytes ? kKVBytes : kOxBytes;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sk = sq + kRows * kStride;
  __nv_bfloat16* sv = sk + kKeys * kStride;
  float* sox = reinterpret_cast<float*>(sv);     // after P.V: the O exchange
  float* smask = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(sv) + kVBytes);
  float* smax = smask + kKeys;                   // [W][16]
  float* ssum = smax + W * 16;                   // [W][16]

  const int n_qtiles = (Lq + kRows - 1) / kRows;
  const int q0 = (blockIdx.x % n_qtiles) * kRows;
  const int b = blockIdx.x / n_qtiles;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rt = warp / KS, ks = warp % KS;
  // the warps of this row tile: `first` adds their partial P.V
  const int first = rt * KS;
  // mma fragment coordinates: this lane holds rows g and g + 8 of its row
  // tile, and columns 2t, 2t + 1 of each n8 tile
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = q0 + rt * 16 + g, r_hi = r_lo + 8;

  // [B, 1, 1, Lk]: one bias row for every head and query row, staged once
  const bool row_bcast = bs_h == 0 && bs_q == 0;
  const bool pairs = !row_bcast && bs_k == 1 && Lk % 2 == 0 &&
                     ((bs_b | bs_h | bs_q) & 1) == 0 &&
                     (reinterpret_cast<uintptr_t>(bias) & 7) == 0;

  auto stage_keys = [&](__nv_bfloat16* dst, const __nv_bfloat16* src) {
    for (int e = tid; e < kKeys * kPieces; e += kThreadsTc) {
      const int r = e / kPieces, c = (e % kPieces) * 8;
      const bool ok = r < Lk;
      cp_async16(dst + r * kStride + c, src + (size_t)(ok ? r : 0) * HD + c, ok);
    }
  };
  auto stage_qk = [&](int h) {
    const size_t bh = (size_t)b * H + h;
    for (int e = tid; e < kRows * kPieces; e += kThreadsTc) {
      const int r = e / kPieces, c = (e % kPieces) * 8;
      const bool ok = q0 + r < Lq;
      cp_async16(sq + r * kStride + c,
                 q + (bh * Lq + (ok ? q0 + r : 0)) * HD + c, ok);
    }
    stage_keys(sk, k + bh * Lk * HD);
  };

  // groups in flight: Q/K of head h, then V of head h
  stage_qk(0);
  cp_async_commit();
  stage_keys(sv, v + (size_t)b * H * Lk * HD);
  cp_async_commit();
  for (int j = tid; j < kKeys; j += kThreadsTc)
    smask[j] = j >= Lk ? -INFINITY : row_bcast ? bias[b * bs_b + j * bs_k] : 0.f;

  // ldmatrix row addresses: A (Q) and trans B (V) take row lane % 16 and
  // column block lane / 16; B (K) takes row lane % 8 + 8 (lane / 16) and
  // column block (lane / 8) % 2
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;

  float mp[2 * CPW][4];   // the head sum of P at this lane's positions
#pragma unroll
  for (int n = 0; n < 2 * CPW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) mp[n][e] = 0.f;

  for (int h = 0; h < H; ++h) {
    const size_t bh = (size_t)b * H + h;
    cp_async_wait<1>();
    __syncthreads();        // Q and K of head h (and the mask) are staged

    uint32_t qf[kSteps][4];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      ldmatrix_x4(qf[kk], sq + (rt * 16 + a_row) * kStride + kk * 16 + a_col);
    float s[2 * CPW][4];    // logits, then exp(s - max), of this warp's keys
#pragma unroll
    for (int i = 0; i < CPW; ++i) {
      const int c = ks + KS * i;
#pragma unroll
      for (int e = 0; e < 4; ++e) s[2 * i][e] = s[2 * i + 1][e] = 0.f;
      if (c < NCH) {
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          uint32_t kf[4];
          ldmatrix_x4(kf, sk + (c * 16 + b_row) * kStride + kk * 16 + b_col);
          mma_bf16(s[2 * i], qf[kk], kf[0], kf[1]);
          mma_bf16(s[2 * i + 1], qf[kk], kf[2], kf[3]);
        }
      }
    }

    // s * scale + bias, in f32; the mask holds -inf past Lk and, for a
    // [B, 1, 1, Lk] bias, the bias itself
#pragma unroll
    for (int n = 0; n < 2 * CPW; ++n) {
      const int c = ks + KS * (n / 2);
      if (c < NCH) {
        const float2 mk = *reinterpret_cast<const float2*>(
            smask + (2 * c + n % 2) * 8 + 2 * t);
        s[n][0] = s[n][0] * scale + mk.x;
        s[n][1] = s[n][1] * scale + mk.y;
        s[n][2] = s[n][2] * scale + mk.x;
        s[n][3] = s[n][3] * scale + mk.y;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = -INFINITY;
      }
    }
    if (!row_bcast) {
      // rows r_lo and r_hi, kBatch key tiles at a time, all loads of a
      // batch in flight together; + 0 leaves a padded key at -inf and a row
      // past Lq as it is
      const float* bias_bh = bias + b * bs_b + h * bs_h;
      const float* b_lo = r_lo < Lq ? bias_bh + r_lo * bs_q : nullptr;
      const float* b_hi = r_hi < Lq ? bias_bh + r_hi * bs_q : nullptr;
#pragma unroll
      for (int n0 = 0; n0 < 2 * CPW; n0 += kBatch) {
        float2 lo[kBatch], hi[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch && n0 + i < 2 * CPW; ++i) {
          const int n = n0 + i;
          const int j = (2 * (ks + KS * (n / 2)) + n % 2) * 8 + 2 * t;
          lo[i] = bias_pair(b_lo, j, Lk, bs_k, pairs);
          hi[i] = bias_pair(b_hi, j, Lk, bs_k, pairs);
        }
#pragma unroll
        for (int i = 0; i < kBatch && n0 + i < 2 * CPW; ++i) {
          s[n0 + i][0] = s[n0 + i][0] + lo[i].x;
          s[n0 + i][1] = s[n0 + i][1] + lo[i].y;
          s[n0 + i][2] = s[n0 + i][2] + hi[i].x;
          s[n0 + i][3] = s[n0 + i][3] + hi[i].y;
        }
      }
    }

    // the row max: over this warp's keys (a row's columns lie in its
    // quad's 4 lanes), then over the warps of its row tile
    float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2 * CPW; ++n) {
      m_lo = fmaxf(m_lo, fmaxf(s[n][0], s[n][1]));
      m_hi = fmaxf(m_hi, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, o));
      m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, o));
    }
    if (t == 0) {
      smax[warp * 16 + g] = m_lo;
      smax[warp * 16 + g + 8] = m_hi;
    }
    __syncthreads();        // every warp is past Q.K^T: sq and sk are free
    if (h + 1 < H) stage_qk(h + 1);
    cp_async_commit();
    m_lo = smax[first * 16 + g];
    m_hi = smax[first * 16 + g + 8];
#pragma unroll
    for (int w = 1; w < KS; ++w) {
      m_lo = fmaxf(m_lo, smax[(first + w) * 16 + g]);
      m_hi = fmaxf(m_hi, smax[(first + w) * 16 + g + 8]);
    }

    float l_lo = 0.f, l_hi = 0.f;
#pragma unroll
    for (int n = 0; n < 2 * CPW; ++n) {
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
    if (t == 0) {
      ssum[warp * 16 + g] = l_lo;
      ssum[warp * 16 + g + 8] = l_hi;
    }
    __syncthreads();
    // the row sum in warp order, the same in every warp of the row tile
    l_lo = ssum[first * 16 + g];
    l_hi = ssum[first * 16 + g + 8];
#pragma unroll
    for (int w = 1; w < KS; ++w) {
      l_lo += ssum[(first + w) * 16 + g];
      l_hi += ssum[(first + w) * 16 + g + 8];
    }
    // normalize (times the correctly rounded 1 / sum: within an ulp of the
    // quotient); the f32 p goes into the map, p rounded to bf16 into P.V:
    // key tiles 2i and 2i + 1 are slot i's A fragment
    const float i_lo = 1.f / l_lo, i_hi = 1.f / l_hi;
    uint32_t pf[CPW][4];
#pragma unroll
    for (int n = 0; n < 2 * CPW; ++n) {
      const float p0 = s[n][0] * i_lo, p1 = s[n][1] * i_lo;
      const float p2 = s[n][2] * i_hi, p3 = s[n][3] * i_hi;
      mp[n][0] += p0;
      mp[n][1] += p1;
      mp[n][2] += p2;
      mp[n][3] += p3;
      pf[n / 2][2 * (n % 2)] = pack_bf16(p0, p1);
      pf[n / 2][2 * (n % 2) + 1] = pack_bf16(p2, p3);
    }

    cp_async_wait<1>();
    __syncthreads();        // V of head h is staged
    float o[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
    for (int i = 0; i < CPW; ++i) {
      const int c = ks + KS * i;
      if (c < NCH) {
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, sv + (c * 16 + a_row) * kStride + dp * 16 + a_col);
          mma_bf16(o[2 * dp], pf[i], vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], pf[i], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();        // every warp is done with sv: it takes the O exchange
    // row tile rt's partials take slots rt (KS - 1) + ks - 1
    if (ks > 0) {
      float* ox = sox + (rt * (KS - 1) + ks - 1) * 16 * kOStride + 2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<float2*>(ox + g * kOStride + n * 8) =
            make_float2(o[n][0], o[n][1]);
        *reinterpret_cast<float2*>(ox + (g + 8) * kOStride + n * 8) =
            make_float2(o[n][2], o[n][3]);
      }
    }
    __syncthreads();
    if (ks == 0) {
      // the partial P.V added in warp order, rounded once to bf16
#pragma unroll
      for (int w = 1; w < KS; ++w) {
        const float* ox = sox + (rt * (KS - 1) + w - 1) * 16 * kOStride + 2 * t;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          const float2 lo = *reinterpret_cast<const float2*>(ox + g * kOStride + n * 8);
          const float2 hi = *reinterpret_cast<const float2*>(ox + (g + 8) * kOStride + n * 8);
          o[n][0] += lo.x;
          o[n][1] += lo.y;
          o[n][2] += hi.x;
          o[n][3] += hi.y;
        }
      }
      __nv_bfloat16* ob = out + bh * Lq * HD + 2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        if (r_lo < Lq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r_lo * HD + n * 8) =
              __floats2bfloat162_rn(o[n][0], o[n][1]);
        if (r_hi < Lq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r_hi * HD + n * 8) =
              __floats2bfloat162_rn(o[n][2], o[n][3]);
      }
    }
    __syncthreads();        // the exchange is read: V of head h + 1 may land
    if (h + 1 < H) stage_keys(sv, v + (bh + 1) * Lk * HD);
    cp_async_commit();
  }

  // the map: the head sum over H, written once
  const float heads = (float)H;
  float* pm = probs + (size_t)b * Lq * Lk;
#pragma unroll
  for (int n = 0; n < 2 * CPW; ++n) {
    const int c = ks + KS * (n / 2);
    if (c >= NCH) continue;
    const int j = (2 * c + n % 2) * 8 + 2 * t;
    if (r_lo < Lq)
      store_map_pair(pm + (size_t)r_lo * Lk, j, Lk, mp[n][0] / heads,
                     mp[n][1] / heads);
    if (r_hi < Lq)
      store_map_pair(pm + (size_t)r_hi * Lk, j, Lk, mp[n][2] / heads,
                     mp[n][3] / heads);
  }
}

template <int HD, int NCH, int RT>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const float* bias, const long long* bias_strides,
                      void* out, float* probs, int B, int H, int Lq, int Lk,
                      float scale, cudaStream_t stream) {
  const long long blocks = (long long)((Lq + 16 * RT - 1) / (16 * RT)) * B;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = fused_attention_tc_kernel<HD, NCH, RT>;
  constexpr size_t smem = tc_smem_bytes(HD, NCH, RT);
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
  kernel<<<(unsigned)blocks, 32 * tc_warps(NCH), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias, bias_strides[0],
      bias_strides[1], bias_strides[2], bias_strides[3],
      static_cast<__nv_bfloat16*>(out), probs, H, Lq, Lk, scale);
  return cudaGetLastError();
}

// the key bucket: 16-key chunks for at most 32, 64, 128, 208 (the MAGIC
// instruction length 200, rounded to 16) and 256 keys (ops/attention.py
// `fused_tc_chunks` mirrors it)
constexpr int tc_chunks(int Lk) {
  return Lk <= 32 ? 2 : Lk <= 64 ? 4 : Lk <= 128 ? 8 : Lk <= 208 ? 13 : 16;
}

// row tiles per block: 2 (K and V staged once per 32 rows, half the L2
// reads of 16-row blocks) at hd 64 with at least 4 chunks where that still
// gives kMinTallBlocks blocks; else 1 (ops/attention.py `fused_tc_row_tiles`
// mirrors it)
constexpr int tc_row_tiles(int hd, int nch, int B, int Lq) {
  return hd == 64 && nch >= 4 && (long long)B * ((Lq + 31) / 32) >= kMinTallBlocks
      ? 2 : 1;
}

template <int HD, int NCH>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        const float* bias, const long long* bias_strides,
                        void* out, float* probs, int B, int H, int Lq, int Lk,
                        float scale, cudaStream_t stream) {
  if constexpr (HD == 64 && NCH >= 4) {
    if (tc_row_tiles(HD, NCH, B, Lq) == 2)
      return launch_tc<HD, NCH, 2>(q, k, v, bias, bias_strides, out, probs, B, H, Lq, Lk, scale, stream);
  }
  return launch_tc<HD, NCH, 1>(q, k, v, bias, bias_strides, out, probs, B, H, Lq, Lk, scale, stream);
}

template <int HD>
cudaError_t dispatch_keys(const void* q, const void* k, const void* v,
                          const float* bias, const long long* bias_strides,
                          void* out, float* probs, int B, int H, int Lq,
                          int Lk, float scale, cudaStream_t stream) {
  switch (tc_chunks(Lk)) {
    case 2: return launch_rows<HD, 2>(q, k, v, bias, bias_strides, out, probs, B, H, Lq, Lk, scale, stream);
    case 4: return launch_rows<HD, 4>(q, k, v, bias, bias_strides, out, probs, B, H, Lq, Lk, scale, stream);
    case 8: return launch_rows<HD, 8>(q, k, v, bias, bias_strides, out, probs, B, H, Lq, Lk, scale, stream);
    case 13: return launch_rows<HD, 13>(q, k, v, bias, bias_strides, out, probs, B, H, Lq, Lk, scale, stream);
    default: return launch_rows<HD, 16>(q, k, v, bias, bias_strides, out, probs, B, H, Lq, Lk, scale, stream);
  }
}

}  // namespace

// The SIMT route.  dtype: 0 = float32, 1 = bfloat16.  bias_strides: the f32 bias's element
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

// The tensor-core route: the same arguments; refuses (cudaErrorInvalidValue)
// anything but bf16 (dtype 1), Lk in [1, 256] and 16-byte aligned q, k, v
// and out.
extern "C" int vln_fused_attention_tc(const void* q, const void* k,
                                      const void* v, const float* bias,
                                      const long long* bias_strides,
                                      void* out, float* probs, int B, int H,
                                      int Lq, int Lk, int hd, int dtype,
                                      float scale, void* stream) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(out);
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || Lk > kTcMaxKeys ||
      dtype != 1 || (any & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return (int)dispatch_keys<16>(q, k, v, bias, bias_strides, out, probs, B, H, Lq, Lk, scale, s);
    case 32: return (int)dispatch_keys<32>(q, k, v, bias, bias_strides, out, probs, B, H, Lq, Lk, scale, s);
    case 64: return (int)dispatch_keys<64>(q, k, v, bias, bias_strides, out, probs, B, H, Lq, Lk, scale, s);
    case 128: return (int)dispatch_keys<128>(q, k, v, bias, bias_strides, out, probs, B, H, Lq, Lk, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tensor-core route's dynamic shared memory per block, in bytes, for
// head dim hd, B batch rows, Lq query rows and Lk keys (what a launch asks
// for); -1 outside the route.
extern "C" int vln_fused_attention_tc_smem(int hd, int B, int Lq, int Lk) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || Lk > kTcMaxKeys ||
      (hd != 16 && hd != 32 && hd != 64 && hd != 128))
    return -1;
  const int nch = tc_chunks(Lk);
  return (int)tc_smem_bytes(hd, nch, tc_row_tiles(hd, nch, B, Lq));
}
