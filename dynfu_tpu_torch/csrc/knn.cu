// k-NN of queries against the warp-field nodes, with a fetch of each
// neighbour's row of a (D, F) feature table.
//
// Replaces knn_gather_tpu (dynfu_tpu/ops/knn_pallas.py:73, body _knn_kernel
// :42). The TPU kernel builds the (D, TQ) distance block in VMEM, runs k
// argmin rounds over it and fetches features by one-hot matmuls, because
// the chip gathers slowly. Here each thread owns one query: the D node
// positions are staged once per block in shared memory (16 B each, 16 KB
// at D = 1024), the k best are kept in registers by insertion (topk.cuh),
// and features are fetched by direct indexing. Bound: D*Q distance
// evaluations from shared memory (8M at the 128^3 slice) plus Q*k*F*4
// bytes written; one pass, no (Q, D) matrix ever reaches device memory.
#include "topk.cuh"

template <int K>
__global__ void knn_gather_kernel(const float* __restrict__ q,
                                  const float* __restrict__ pos,
                                  const unsigned char* __restrict__ mask,
                                  const float* __restrict__ table, int Q,
                                  int D, int F, int* __restrict__ idx_out,
                                  float* __restrict__ sqd_out,
                                  float* __restrict__ feat_out) {
  extern __shared__ float4 s_nodes[];
  stage_nodes(s_nodes, pos, mask, D);
  int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= Q) return;
  TopK<K> top;
  scan_nodes<K>(top, s_nodes, D, q[3 * qi], q[3 * qi + 1], q[3 * qi + 2]);
#pragma unroll
  for (int r = 0; r < K; ++r) {
    long long o = (long long)qi * K + r;
    int j = top.i[r];
    idx_out[o] = j;
    sqd_out[o] = top.d[r];
    const float* src = table + (long long)j * F;
    float* dst = feat_out + o * F;
    for (int f = 0; f < F; ++f) dst[f] = src[f];
  }
}

DYNFU_API int dynfu_knn_gather(const float* queries, const float* pos,
                               const unsigned char* mask, const float* table,
                               int Q, int D, int F, int k, int* idx_out,
                               float* sqd_out, float* feat_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int T = 128;
  size_t smem = (size_t)D * sizeof(float4);
  DYNFU_DISPATCH_K(k, {
    cudaFuncSetAttribute(knn_gather_kernel<KK>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    knn_gather_kernel<KK><<<dynfu_blocks(Q, T), T, smem, s>>>(
        queries, pos, mask, table, Q, D, F, idx_out, sqd_out, feat_out);
  });
  return (int)cudaGetLastError();
}
