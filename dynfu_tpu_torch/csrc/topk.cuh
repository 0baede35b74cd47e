// k-nearest selection shared by the k-NN gather (knn.cu) and the fused
// warp (warp.cu): one thread per query keeps its k best (distance, index)
// pairs in registers, in ascending order with ties to the lower index — the
// order of nanoflann's results and of the TPU kernels' iterated argmin.
#pragma once

#include <climits>

#include "common.cuh"

// masked nodes sit at (FAR, FAR, FAR): a finite, huge distance (~3e18), so
// they are picked only when fewer than k nodes are valid, exactly as in the
// TPU kernels (knn_pallas.py:35, warp_pallas.py:36)
#define DYNFU_FAR 1e9f

__device__ __forceinline__ bool topk_less(float d, int j, float bd, int bj) {
  return d < bd || (d == bd && j < bj);
}

template <int K>
struct TopK {
  float d[K];
  int i[K];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < K; ++r) {
      d[r] = CUDART_INF_F;
      i[r] = INT_MAX;  // so an all-inf row still selects indices 0..k-1
    }
  }

  // insertion into the sorted list, without early exits (most candidates
  // of a pruned list enter it): the new pair is swapped down the K places,
  // so every lane runs the same steps and a warp does not diverge;
  // candidates arrive in ascending index order, so a tie never displaces
  // an earlier (lower-index) entry
  __device__ __forceinline__ void push_swap(float dd, int j) {
    if (dd != dd) dd = CUDART_INF_F;  // NaN ranks as +inf
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const bool lt = topk_less(dd, j, d[s], i[s]);
      const float td = d[s];
      const int ti = i[s];
      d[s] = lt ? dd : td;
      i[s] = lt ? j : ti;
      dd = lt ? td : dd;
      j = lt ? ti : j;
    }
  }
};

// Stage the D node positions (masked -> FAR) in shared memory; every thread
// of the block must call this before any thread scans.
__device__ __forceinline__ void stage_nodes(float4* s_nodes,
                                            const float* __restrict__ pos,
                                            const unsigned char* __restrict__ mask,
                                            int D) {
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    s_nodes[j] = mask[j] ? make_float4(pos[3 * j], pos[3 * j + 1],
                                       pos[3 * j + 2], 0.f)
                         : make_float4(DYNFU_FAR, DYNFU_FAR, DYNFU_FAR, 0.f);
  }
  __syncthreads();
}

// --- pruned selection (the fused warp and the k-NN) -----------------------
//
// The brute-force selection inserts every slot j, in ascending index order,
// at the squared distance (px - qx)^2 + (py - qy)^2 + (pz - qz)^2 computed
// left to right, in the plain version's operation order (the build passes
// -fmad=false, so nothing is fused into an FMA). A group of queries shares
// one candidate list instead. Its finite queries span the box [lo, hi]; for
// node j, mind_j and maxd_j bound the squared distance from any query in
// the box, computed from per-axis differences in that operation order.
// Rounding is monotone, so mind_j <= d(q, j) <= maxd_j holds for the
// computed distances too. UB = the k-th smallest maxd_j: every query of the
// box has k nodes at d <= UB, so a node with mind_j > UB is strictly
// farther than every query's k-th neighbour and can never be selected, not
// even on a tie. Each query runs the TopK insertion over the candidates {j
// : mind_j <= UB} only, in ascending index order, so its selection equals
// the brute-force one exactly. NaN distances rank as +inf throughout: a NaN
// maxd counts as +inf, a NaN mind keeps the node.
//
// Two levels: the block's box prunes all D slots (every thread bounding a
// share of them), then each warp's box prunes the block's list; the rule
// holds at each level, since the block's list holds every node any of its
// queries can select, k of them with maxd <= the block's UB.

#define DYNFU_FULL_MASK 0xffffffffu
#define DYNFU_MAX_WARPS 8  // blocks of at most 256 threads

struct PruneShared {  // static shared memory of one block
  float box[DYNFU_MAX_WARPS][6];
  float kl[DYNFU_MAX_WARPS][8];
  int cnt[DYNFU_MAX_WARPS];
};

// the k smallest values pushed, ascending (values only: UB needs no index)
template <int K>
__device__ __forceinline__ void kmin_push(float (&v)[K], float x) {
  if (!(x < v[K - 1])) return;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (x < v[s - 1]) {
      v[s] = v[s - 1];
    } else {
      v[s] = x;
      return;
    }
  }
  v[0] = x;
}

// every lane's list becomes the k smallest of the warp's 32 lists
template <int K>
__device__ __forceinline__ void warp_kmin(float (&v)[K]) {
  const int lane = threadIdx.x & 31;
  float out[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    float m = v[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fminf(m, __shfl_xor_sync(DYNFU_FULL_MASK, m, o));
    unsigned who = __ballot_sync(DYNFU_FULL_MASK, v[0] == m);
    if (lane == __ffs(who) - 1) {  // pop one head equal to the minimum
#pragma unroll
      for (int s = 0; s < K - 1; ++s) v[s] = v[s + 1];
      v[K - 1] = CUDART_INF_F;
    }
    out[r] = m;
  }
#pragma unroll
  for (int r = 0; r < K; ++r) v[r] = out[r];
}

// squared-distance bounds of node p over the box [lo, hi]
__device__ __forceinline__ void box_bounds(float4 p, float3 lo, float3 hi,
                                           float& mind, float& maxd) {
  float mx = p.x > hi.x ? p.x - hi.x : (p.x < lo.x ? lo.x - p.x : 0.f);
  float my = p.y > hi.y ? p.y - hi.y : (p.y < lo.y ? lo.y - p.y : 0.f);
  float mz = p.z > hi.z ? p.z - hi.z : (p.z < lo.z ? lo.z - p.z : 0.f);
  float Mx = fmaxf(fabsf(p.x - lo.x), fabsf(p.x - hi.x));
  float My = fmaxf(fabsf(p.y - lo.y), fabsf(p.y - hi.y));
  float Mz = fmaxf(fabsf(p.z - lo.z), fabsf(p.z - hi.z));
  mind = mx * mx + my * my + mz * mz;
  maxd = Mx * Mx + My * My + Mz * Mz;
}

__device__ __forceinline__ bool finite3(float3 v) {
  return isfinite(v.x) && isfinite(v.y) && isfinite(v.z);
}

// the box of the warp's finite queries, as {lo, -hi} (all minima)
__device__ __forceinline__ void warp_box(bool fin, float3 v, float (&b)[6]) {
  b[0] = fin ? v.x : CUDART_INF_F;
  b[1] = fin ? v.y : CUDART_INF_F;
  b[2] = fin ? v.z : CUDART_INF_F;
  b[3] = fin ? -v.x : CUDART_INF_F;
  b[4] = fin ? -v.y : CUDART_INF_F;
  b[5] = fin ? -v.z : CUDART_INF_F;
#pragma unroll
  for (int c = 0; c < 6; ++c)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      b[c] = fminf(b[c], __shfl_xor_sync(DYNFU_FULL_MASK, b[c], o));
}

// the box of the block's finite queries; every thread calls this
__device__ __forceinline__ void block_box(PruneShared& sh, bool fin, float3 v,
                                          float3& lo, float3& hi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float b[6];
  warp_box(fin, v, b);
  if (lane == 0)
#pragma unroll
    for (int c = 0; c < 6; ++c) sh.box[warp][c] = b[c];
  __syncthreads();
  for (int g = 0; g < (int)(blockDim.x >> 5); ++g)
#pragma unroll
    for (int c = 0; c < 6; ++c) b[c] = fminf(b[c], sh.box[g][c]);
  lo = make_float3(b[0], b[1], b[2]);
  hi = make_float3(-b[3], -b[4], -b[5]);
}

// Every thread of the block calls this, after stage_nodes and block_box
// (the block's box [lo, hi] of finite queries). `live`: the thread holds a
// query; `v`: its coordinates. With nw = blockDim / 32, s_cand holds
// nw (C + L) indices: the block's list in one region of C per warp, then
// one list of L per warp (C and L below). A query with a non-finite
// coordinate has every distance +inf, so the brute force would select
// slots 0..k-1 at +inf: it gets exactly that, and stays out of the boxes.
template <int K>
__device__ __forceinline__ void scan_pruned(TopK<K>& top,
                                            const float4* s_nodes,
                                            unsigned short* s_cand,
                                            PruneShared& sh, int D, float3 lo,
                                            float3 hi, bool live, float3 v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const bool fin = live && finite3(v);
  const int C = ((D + nw - 1) / nw + 31) & ~31;  // a warp's share of slots
  const int L = (D + 31) & ~31;                  // a warp list's capacity
  unsigned short* wlist = s_cand + nw * C + warp * L;

  // 1. the block's list: UB over every slot, then the candidates of
  // [w C, (w + 1) C) compacted by warp w into its region
  if (lo.x <= hi.x) {  // uniform over the block
    float kv[K];
#pragma unroll
    for (int r = 0; r < K; ++r) kv[r] = CUDART_INF_F;
    for (int j = threadIdx.x; j < D; j += blockDim.x) {
      float mind, maxd;
      box_bounds(s_nodes[j], lo, hi, mind, maxd);
      kmin_push<K>(kv, maxd != maxd ? CUDART_INF_F : maxd);
    }
    warp_kmin<K>(kv);
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < K; ++r) sh.kl[warp][r] = kv[r];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < K; ++r)
      kv[r] = lane < nw ? sh.kl[lane][r] : CUDART_INF_F;
    warp_kmin<K>(kv);
    const float ub = kv[K - 1];
    const int j0 = warp * C, j1 = min(D, j0 + C);
    int cnt = 0;
    for (int base = j0; base < j1; base += 32) {
      const int j = base + lane;
      bool keep = false;
      if (j < j1) {
        float mind, maxd;
        box_bounds(s_nodes[j], lo, hi, mind, maxd);
        keep = !(mind > ub);
      }
      const unsigned bal = __ballot_sync(DYNFU_FULL_MASK, keep);
      if (keep)
        s_cand[warp * C + cnt + __popc(bal & ((1u << lane) - 1u))] =
            (unsigned short)j;
      cnt += __popc(bal);
    }
    if (lane == 0) sh.cnt[warp] = cnt;
  }
  __syncthreads();

  // 2. the warp's list: the same rule with the warp's box, over the
  // block's list in order
  float b[6];
  warp_box(fin, v, b);
  const float3 wlo = make_float3(b[0], b[1], b[2]);
  const float3 whi = make_float3(-b[3], -b[4], -b[5]);
  int cnt = 0;
  if (wlo.x <= whi.x) {  // uniform over the warp
    float kv[K];
#pragma unroll
    for (int r = 0; r < K; ++r) kv[r] = CUDART_INF_F;
    for (int g = 0; g < nw; ++g)
      for (int c = lane; c < sh.cnt[g]; c += 32) {
        float mind, maxd;
        box_bounds(s_nodes[s_cand[g * C + c]], wlo, whi, mind, maxd);
        kmin_push<K>(kv, maxd != maxd ? CUDART_INF_F : maxd);
      }
    warp_kmin<K>(kv);
    const float ub = kv[K - 1];
    for (int g = 0; g < nw; ++g)
      for (int base = 0; base < sh.cnt[g]; base += 32) {
        const int c = base + lane;
        int j = 0;
        bool keep = false;
        if (c < sh.cnt[g]) {
          float mind, maxd;
          j = s_cand[g * C + c];
          box_bounds(s_nodes[j], wlo, whi, mind, maxd);
          keep = !(mind > ub);
        }
        const unsigned bal = __ballot_sync(DYNFU_FULL_MASK, keep);
        if (keep)
          wlist[cnt + __popc(bal & ((1u << lane) - 1u))] = (unsigned short)j;
        cnt += __popc(bal);
      }
  }
  __syncwarp();

  // 3. each query's TopK insertion over its warp's list only
  if (!live) return;
  if (!fin) {
#pragma unroll
    for (int r = 0; r < K; ++r) {
      top.d[r] = CUDART_INF_F;
      top.i[r] = r;
    }
    return;
  }
  top.init();
  for (int c = 0; c < cnt; ++c) {
    const int j = wlist[c];
    const float4 p = s_nodes[j];
    const float dx = p.x - v.x, dy = p.y - v.y, dz = p.z - v.z;
    top.push_swap(dx * dx + dy * dy + dz * dz, j);
  }
}

// The largest block, a multiple of 32 of at most max_threads (<= 32 *
// DYNFU_MAX_WARPS) threads, whose shared memory fits: `fixed` bytes of its
// own static memory, the static PruneShared and, dynamic (*smem), the D
// staged positions, the block's candidate list (a region of C slots per
// warp) and one list of L per warp (scan_pruned). False if none does.
static inline bool pruned_block(int D, int max_threads, size_t fixed,
                                int* threads, size_t* smem) {
  for (int t = max_threads; t >= 32; t -= 32) {
    const int nw = t / 32;
    const size_t C = (size_t)(((D + nw - 1) / nw + 31) & ~31);
    const size_t L = (size_t)((D + 31) & ~31);
    const size_t need =
        (size_t)D * sizeof(float4) + nw * (C + L) * sizeof(short);
    if (need + sizeof(PruneShared) + fixed <= DYNFU_MAX_SMEM) {
      *threads = t;
      *smem = need;
      return true;
    }
  }
  return false;
}
