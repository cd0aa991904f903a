// The observed-subgraph walk for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes); see vln_magic_tpu_torch/ops/walk.py.
//
// Replaces no TPU kernel.  The JAX package walks in `lax.fori_loop`s that
// XLA compiles into one program (vln_magic_tpu/agent/rollout.py, lines 929
// and 1555, over `_observed_next`, line 1492); the port's
// eager loop (agent/rollout.py `Rollout._walk_loop`) issues some 30
// tiny kernels a hop for every one of its 16 or 32 hops, and that issue is
// what a served decision waited on.  This kernel does the whole walk in one
// launch.  Per lane b, from p = cur[b] toward t = target[b], at most `hops`
// hops, only where moving[b] holds:
//
//   cand     = cand_ids[scan[b], p, :]                       C slots
//   safe     = max(cand, 0)
//   stepable = cand_mask[scan[b], p, :] & (visited[b, safe] | cand == t)
//   cost     = stepable ? cand_dist[scan[b], p, :] + obs_dist[b, t, safe]
//                       : INF_DIST                           (one f32 add)
//   j        = the first slot of least cost;  found = cost[j] < INF_DIST / 2
//   if p != t and found: prev = p where cand[j] == t;
//                        nodes[b, min(ln, max_traj)] = cand[j]; ln += 1;
//                        p = cand[j]
//
// which is `_observed_next` then `_record_hop`, hop by hop, bit for bit: the
// walk is integer indexing, one correctly rounded f32 add (no product, so
// nothing for the compiler to contract) and compares.  A lane whose hop
// does not step stops there: nothing it reads changes during the walk, so
// every later hop of the loop would not step either.
//
// Layout: one warp per lane, 4 lanes to a block.  Thread j scans slots j,
// j + 32, ... in order, keeping its first minimum (a strict <); the warp's
// first minimum is then a shuffle reduction over (cost, slot), and the
// warp's first thread writes the trajectory.  Every tensor is read through
// its strides (elements), so the fleet's tables, views into one packed
// upload, and an expanded obs_dist (stride 0) are read in place.
//
// Bound: latency.  A hop is a chain of dependent loads (the node's
// candidate row, then visited and obs_dist at the candidates, then the
// next node's row), a few hundred bytes a lane; a walk of h hops takes h
// such chains, microseconds, against the loop's ~30 launches a hop.

#include <cuda_runtime.h>

namespace {

constexpr float kInfDist = 1e9f;        // ops/walk.py INF_DIST
constexpr int kLanesPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

struct WalkArgs {
  const long long* cand_ids;            // [S, N, C]
  const unsigned char* cand_mask;       // [S, N, C] bool
  const float* cand_dist;               // [S, N, C]
  const long long* scan;                // [B]
  const long long* cur;                 // [B]
  const long long* target;              // [B]
  const unsigned char* moving;          // [B] bool
  const unsigned char* visited;         // [B, N+1] bool
  const float* obs_dist;                // [B, N, N]
  long long* nodes;                     // [B, max_traj + 1], written
  const long long* ln;                  // [B]
  long long* prev_out;                  // [B], contiguous
  long long* ln_out;                    // [B], contiguous
  // element strides, in the order of the tensors above
  long long ci[3], cm[3], cd[3], sc, cu, tg, mv, vi[2], od[3], nd[2], lnst;
  int b, c, hops, max_traj;
};

__global__ void __launch_bounds__(32 * kLanesPerBlock)
observed_walk_kernel(const WalkArgs a) {
  const int lane = blockIdx.x * kLanesPerBlock + threadIdx.x / 32;
  const int j = threadIdx.x % 32;
  if (lane >= a.b) return;              // the whole warp leaves together
  const long long b = lane;
  long long p = a.cur[b * a.cu];
  long long prev = p;
  long long ln = a.ln[b * a.lnst];
  if (a.moving[b * a.mv]) {
    const long long t = a.target[b * a.tg];
    const long long s = a.scan[b * a.sc];
    const float* dcol = a.obs_dist + b * a.od[0] + t * a.od[1];
    const unsigned char* vis = a.visited + b * a.vi[0];
    for (int h = 0; h < a.hops && p != t; ++h) {
      long long cand = -1;                // the candidate at `slot`
      float best = __int_as_float(0x7f800000);   // +inf: no slot here
      int slot = j;
      for (int k = j; k < a.c; k += 32) {
        const long long ck = a.cand_ids[s * a.ci[0] + p * a.ci[1] +
                                        k * a.ci[2]];
        float cost = kInfDist;
        if (a.cand_mask[s * a.cm[0] + p * a.cm[1] + k * a.cm[2]]) {
          const long long safe = ck < 0 ? 0 : ck;
          if (vis[safe * a.vi[1]] || ck == t)
            cost = __fadd_rn(a.cand_dist[s * a.cd[0] + p * a.cd[1] +
                                         k * a.cd[2]],
                             dcol[safe * a.od[2]]);
        }
        if (cost < best) {
          best = cost;
          slot = k;
          cand = ck;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        const float oc = __shfl_xor_sync(kFull, best, off);
        const int os = __shfl_xor_sync(kFull, slot, off);
        if (oc < best || (oc == best && os < slot)) {
          best = oc;
          slot = os;
        }
      }
      if (!(best < kInfDist / 2)) break;
      const long long nxt = __shfl_sync(kFull, cand, slot % 32);
      if (nxt == t) prev = p;
      if (j == 0)
        a.nodes[b * a.nd[0] + (ln < a.max_traj ? ln : a.max_traj) * a.nd[1]] =
            nxt;
      ++ln;
      p = nxt;
    }
  }
  if (j == 0) {
    a.prev_out[b] = prev;
    a.ln_out[b] = ln;
  }
}

}  // namespace

// ptrs: the 13 tensors in WalkArgs' order; strides: the 21 element strides
// of the first 11 in the same order.  Refuses (cudaErrorInvalidValue) B < 1,
// C < 1, hops < 0 and max_traj < 0.
extern "C" int vln_observed_walk(void* const* ptrs, const long long* strides,
                                 int B, int C, int hops, int max_traj,
                                 void* stream) {
  if (B <= 0 || C <= 0 || hops < 0 || max_traj < 0)
    return (int)cudaErrorInvalidValue;
  WalkArgs a;
  a.cand_ids = static_cast<const long long*>(ptrs[0]);
  a.cand_mask = static_cast<const unsigned char*>(ptrs[1]);
  a.cand_dist = static_cast<const float*>(ptrs[2]);
  a.scan = static_cast<const long long*>(ptrs[3]);
  a.cur = static_cast<const long long*>(ptrs[4]);
  a.target = static_cast<const long long*>(ptrs[5]);
  a.moving = static_cast<const unsigned char*>(ptrs[6]);
  a.visited = static_cast<const unsigned char*>(ptrs[7]);
  a.obs_dist = static_cast<const float*>(ptrs[8]);
  a.nodes = static_cast<long long*>(ptrs[9]);
  a.ln = static_cast<const long long*>(ptrs[10]);
  a.prev_out = static_cast<long long*>(ptrs[11]);
  a.ln_out = static_cast<long long*>(ptrs[12]);
  long long* dst[] = {a.ci, a.ci + 1, a.ci + 2, a.cm, a.cm + 1, a.cm + 2,
                      a.cd, a.cd + 1, a.cd + 2, &a.sc, &a.cu, &a.tg, &a.mv,
                      a.vi, a.vi + 1, a.od, a.od + 1, a.od + 2, a.nd,
                      a.nd + 1, &a.lnst};
  static_assert(sizeof(dst) / sizeof(dst[0]) == 21, "stride count");
  for (int i = 0; i < 21; ++i) *dst[i] = strides[i];
  a.b = B;
  a.c = C;
  a.hops = hops;
  a.max_traj = max_traj;
  const int blocks = (B + kLanesPerBlock - 1) / kLanesPerBlock;
  observed_walk_kernel<<<blocks, 32 * kLanesPerBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
