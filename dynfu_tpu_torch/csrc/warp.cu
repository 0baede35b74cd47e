// Fused warp: k-NN against the nodes, a dual-quaternion blend, and the
// transform of each point and normal, plus the unsupported ratio.
//
// Replaces warp_fused_tpu (dynfu_tpu/ops/warp_pallas.py:171, body
// _warp_kernel :60), both of its blends. The TPU kernel runs k argmin
// rounds over a (D, TQ) VMEM block and fetches node state by one-hot
// matmuls.
//
// What bounds it on this card. The least any exact implementation needs is
// its bytes: each query and normal read once and 15 floats written (0.026
// ms at Q = 2^20). A first version selected by brute force, one thread per
// query inserting all D staged slots into a register top-k; the nodes are
// in no spatial order, so at most slots some lane of a warp inserts and the
// whole warp pays the insertion's ~8 compare-and-move steps: ~D x 50 warp
// instructions per warp, 1.8 ms at Q = 2^20, D = 640 on an H100 SXM at
// 700 W.
//
// The design: the callers' queries are spatially coherent (the fused band
// comes in z-fastest voxel order), so a block's queries span a few
// centimetres while the nodes span the scene. Each block prunes the slots
// to the few its queries can select, in two levels (scan_pruned in
// topk.cuh): the block's box against all D slots, every thread bounding a
// share of them, then each warp's box against the block's short list; per
// node, distance bounds over the box, the k-th smallest upper bound, and
// the candidates compacted in index order by ballot. Each thread then
// inserts its warp's candidates only, so the selection, its order and its
// ties equal the brute-force scan's. Most of those ~20 candidates enter
// the list, where most of D slots did not, so the insertion runs without
// early exits (TopK::push_swap): the branchy one diverged on nearly every
// candidate and cost as much as all the pruning saved. Incoherent queries
// prune little and insert more candidates: still exact. Positions are
// staged in shared memory with 2-byte candidate lists beside them; each
// selected node's dq, dg_w and mask are read directly (L2-resident: D x
// 13 floats). One thread per query blends in registers; no intermediate
// reaches device memory. A block has 256 threads, the fastest of 64 to
// 256 on the paths' shapes in a one-off sweep (PERF.md), or the most that
// fit where D is large and the lists would not (dynfu_warp_threads says
// how many). Offsets are 64-bit: the moving camera's band warps 2^20
// queries in one launch.
//
// blend = 0, "dqb" — the reference's quirks (warp_pallas.py:98-106,121-126,
// 154-158): invalid slots multiply by the identity, node weights scale the
// dual part only, the product is sequential in nearest-first order, the
// real part alone is normalised, and the "normal" gets the full transform,
// translation included.
// blend = 1, "dlb" — Kavan's linear blend (warp_pallas.py:107-113,127-136,
// 159-162): each dq sign-aligned to the nearest node's real part, weighted
// by its Gaussian weight (0 for invalid slots) and summed with the weights'
// sum; the identity where that sum is <= 1e-12; the whole dq divided by
// |real|; normals rotated only.
// The point transform is dq_transform_point's formula, the normal rotation
// dq_rotate_vector's, in the plain version's operation order
// (ops/warp_cuda.py).
#include "topk.cuh"

struct Q4 {
  float w, x, y, z;
};

__device__ __forceinline__ Q4 qmul(Q4 a, Q4 b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}

__device__ __forceinline__ float3 cross3(float3 a, float3 b) {
  return make_float3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
                     a.x * b.y - a.y * b.x);
}

// v + 2 rv x (rv x v + rw v) + 2 (rw dv - dw rv + rv x dv)
__device__ __forceinline__ float3 transform(Q4 r, Q4 d, float3 v) {
  float3 rv = make_float3(r.x, r.y, r.z), dv = make_float3(d.x, d.y, d.z);
  float3 c1 = cross3(rv, v);
  float3 inner = make_float3(c1.x + r.w * v.x, c1.y + r.w * v.y,
                             c1.z + r.w * v.z);
  float3 c2 = cross3(rv, inner);
  float3 c3 = cross3(rv, dv);
  return make_float3(
      v.x + 2.0f * c2.x + 2.0f * (r.w * dv.x - d.w * rv.x + c3.x),
      v.y + 2.0f * c2.y + 2.0f * (r.w * dv.y - d.w * rv.y + c3.y),
      v.z + 2.0f * c2.z + 2.0f * (r.w * dv.z - d.w * rv.z + c3.z));
}

__device__ __forceinline__ Q4 qconj(Q4 a) { return {a.w, -a.x, -a.y, -a.z}; }

// vec((r * (0, v)) * conj(r))
__device__ __forceinline__ float3 rotate(Q4 r, float3 v) {
  Q4 o = qmul(qmul(r, Q4{0.f, v.x, v.y, v.z}), qconj(r));
  return make_float3(o.x, o.y, o.z);
}

template <int K, bool DLB>
__global__ void warp_fused_kernel(const float* __restrict__ q,
                                  const float* __restrict__ nrm,
                                  const float* __restrict__ pos,
                                  const float* __restrict__ dqs,
                                  const float* __restrict__ w,
                                  const unsigned char* __restrict__ mask,
                                  int Q, int D, float* __restrict__ warped,
                                  float* __restrict__ wnormals,
                                  float* __restrict__ bdq,
                                  float* __restrict__ ratio_out) {
  extern __shared__ float4 s_nodes[];  // D positions, then the lists
  __shared__ PruneShared sh;
  unsigned short* s_cand = reinterpret_cast<unsigned short*>(s_nodes + D);
  stage_nodes(s_nodes, pos, mask, D);
  const long long qi = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = qi < Q;
  const float3 v = live ? make_float3(q[3 * qi], q[3 * qi + 1], q[3 * qi + 2])
                        : make_float3(0.f, 0.f, 0.f);
  float3 lo, hi;
  block_box(sh, live && finite3(v), v, lo, hi);
  TopK<K> top;
  scan_pruned<K>(top, s_nodes, s_cand, sh, D, lo, hi, live, v);
  if (!live) return;
  Q4 ar = {1.f, 0.f, 0.f, 0.f}, ad = {0.f, 0.f, 0.f, 0.f};
  Q4 ref = {0.f, 0.f, 0.f, 0.f};
  float wsum = 0.f;
  float ratio = CUDART_INF_F;
  if (DLB) ar.w = 0.f;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    int j = top.i[r];
    float m = top.d[r];
    bool valid = mask[j] != 0;
    float dg_w = fmaxf(w[j], 1e-12f);
    float wt = expf(-m / (2.0f * dg_w * dg_w));
    ratio = fminf(ratio, valid ? sqrtf(m) / dg_w : CUDART_INF_F);
    const float* n = dqs + 8 * (long long)j;
    if (DLB) {
      Q4 nr = {n[0], n[1], n[2], n[3]};
      if (r == 0) ref = nr;  // the nearest node, valid or not
      float dot = nr.w * ref.w + nr.x * ref.x + nr.y * ref.y + nr.z * ref.z;
      float ws = (valid ? wt : 0.f) * (dot < 0.f ? -1.f : 1.f);
      ar = {ar.w + ws * n[0], ar.x + ws * n[1], ar.y + ws * n[2],
            ar.z + ws * n[3]};
      ad = {ad.w + ws * n[4], ad.x + ws * n[5], ad.y + ws * n[6],
            ad.z + ws * n[7]};
      wsum = wsum + (valid ? wt : 0.f);
    } else {
      Q4 sr = valid ? Q4{n[0], n[1], n[2], n[3]} : Q4{1.f, 0.f, 0.f, 0.f};
      Q4 sd = valid ? Q4{n[4] * wt, n[5] * wt, n[6] * wt, n[7] * wt}
                    : Q4{0.f, 0.f, 0.f, 0.f};
      Q4 nr = qmul(ar, sr);
      Q4 d1 = qmul(ar, sd), d2 = qmul(ad, sr);
      ad = {d1.w + d2.w, d1.x + d2.x, d1.y + d2.y, d1.z + d2.z};
      ar = nr;
    }
  }
  Q4 rn;
  if (DLB) {
    if (!(wsum > 1e-12f)) {  // no support: the identity
      ar = {1.f, 0.f, 0.f, 0.f};
      ad = {0.f, 0.f, 0.f, 0.f};
    }
    float mag = sqrtf(
        fmaxf(ar.w * ar.w + ar.x * ar.x + ar.y * ar.y + ar.z * ar.z, 1e-30f));
    rn = {ar.w / mag, ar.x / mag, ar.y / mag, ar.z / mag};
    ad = {ad.w / mag, ad.x / mag, ad.y / mag, ad.z / mag};
  } else {
    float mag = fmaxf(
        sqrtf(ar.w * ar.w + ar.x * ar.x + ar.y * ar.y + ar.z * ar.z), 1e-30f);
    rn = {ar.w / mag, ar.x / mag, ar.y / mag, ar.z / mag};
  }

  float3 pv = transform(rn, ad, v);
  float3 n3 = make_float3(nrm[3 * qi], nrm[3 * qi + 1], nrm[3 * qi + 2]);
  float3 pn = DLB ? rotate(rn, n3) : transform(rn, ad, n3);
  warped[3 * qi] = pv.x;
  warped[3 * qi + 1] = pv.y;
  warped[3 * qi + 2] = pv.z;
  wnormals[3 * qi] = pn.x;
  wnormals[3 * qi + 1] = pn.y;
  wnormals[3 * qi + 2] = pn.z;
  float* o = bdq + 8 * (long long)qi;
  o[0] = rn.w; o[1] = rn.x; o[2] = rn.y; o[3] = rn.z;
  o[4] = ad.w; o[5] = ad.x; o[6] = ad.y; o[7] = ad.z;
  ratio_out[qi] = ratio;
}

// 256 threads, or the most whose lists fit (pruned_block)
static bool warp_block(int D, int* threads, size_t* smem) {
  return pruned_block(D, 32 * DYNFU_MAX_WARPS, 0, threads, smem);
}

template <int K, bool DLB>
static int warp_launch(const float* queries, const float* normals,
                       const float* pos, const float* dqs, const float* w,
                       const unsigned char* mask, int Q, int D,
                       float* warped, float* wnormals, float* bdq,
                       float* ratio, cudaStream_t s) {
  int threads;
  size_t smem;
  if (!warp_block(D, &threads, &smem)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      warp_fused_kernel<K, DLB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  warp_fused_kernel<K, DLB><<<dynfu_blocks(Q, threads), threads, smem, s>>>(
      queries, normals, pos, dqs, w, mask, Q, D, warped, wnormals, bdq,
      ratio);
  return (int)cudaGetLastError();
}

DYNFU_API int dynfu_warp_fused(const float* queries, const float* normals,
                               const float* pos, const float* dqs,
                               const float* w, const unsigned char* mask,
                               int Q, int D, int k, int blend, float* warped,
                               float* wnormals, float* bdq, float* ratio,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (blend != 0 && blend != 1) return (int)cudaErrorInvalidValue;
  DYNFU_DISPATCH_K(k, {
    return blend == 1
               ? warp_launch<KK, true>(queries, normals, pos, dqs, w, mask, Q,
                                       D, warped, wnormals, bdq, ratio, s)
               : warp_launch<KK, false>(queries, normals, pos, dqs, w, mask,
                                        Q, D, warped, wnormals, bdq, ratio, s);
  });
  return (int)cudaErrorInvalidValue;
}

// the threads per block dynfu_warp_fused launches with for D slots
DYNFU_API int dynfu_warp_threads(int D, int* threads) {
  size_t smem;
  return warp_block(D, threads, &smem) ? 0 : (int)cudaErrorInvalidValue;
}
