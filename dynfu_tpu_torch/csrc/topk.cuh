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

  // insertion into the sorted list; candidates arrive in ascending index
  // order, so a tie never displaces an earlier (lower-index) entry
  __device__ __forceinline__ void push(float dd, int j) {
    if (dd != dd) dd = CUDART_INF_F;  // NaN ranks as +inf
    if (!topk_less(dd, j, d[K - 1], i[K - 1])) return;
#pragma unroll
    for (int s = K - 1; s > 0; --s) {
      if (topk_less(dd, j, d[s - 1], i[s - 1])) {
        d[s] = d[s - 1];
        i[s] = i[s - 1];
      } else {
        d[s] = dd;
        i[s] = j;
        return;
      }
    }
    d[0] = dd;
    i[0] = j;
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

// Squared distance in the plain version's operation order,
// (px - qx)^2 + (py - qy)^2 + (pz - qz)^2 left to right (the build passes
// -fmad=false, so nothing is fused into an FMA).
template <int K>
__device__ __forceinline__ void scan_nodes(TopK<K>& top, const float4* s_nodes,
                                           int D, float qx, float qy,
                                           float qz) {
  top.init();
  for (int j = 0; j < D; ++j) {
    float4 p = s_nodes[j];
    float dx = p.x - qx, dy = p.y - qy, dz = p.z - qz;
    top.push(dx * dx + dy * dy + dz * dz, j);
  }
}

// dispatch a runtime k in 1..8 to the template instance
#define DYNFU_DISPATCH_K(k, ...)                 \
  switch (k) {                                   \
    case 1: { constexpr int KK = 1; __VA_ARGS__; } break; \
    case 2: { constexpr int KK = 2; __VA_ARGS__; } break; \
    case 3: { constexpr int KK = 3; __VA_ARGS__; } break; \
    case 4: { constexpr int KK = 4; __VA_ARGS__; } break; \
    case 5: { constexpr int KK = 5; __VA_ARGS__; } break; \
    case 6: { constexpr int KK = 6; __VA_ARGS__; } break; \
    case 7: { constexpr int KK = 7; __VA_ARGS__; } break; \
    case 8: { constexpr int KK = 8; __VA_ARGS__; } break; \
    default: return (int)cudaErrorInvalidValue;          \
  }
