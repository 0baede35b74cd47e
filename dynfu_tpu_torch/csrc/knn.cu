// k-NN of queries against the warp-field nodes, with a fetch of each
// neighbour's row of a (D, F) feature table.
//
// Replaces knn_gather_tpu (dynfu_tpu/ops/knn_pallas.py:73, body _knn_kernel
// :42). The TPU kernel builds the (D, TQ) distance block in VMEM, runs k
// argmin rounds over it and fetches features by one-hot matmuls, because
// the chip gathers slowly.
//
// What bounds it on this card. The least any exact implementation needs is
// its bytes: the queries, the nodes and the table read once, the (Q, k)
// indices and distances and the (Q, k, F) features written once; the
// features dominate (27 MB for parity 512^3's 65664 payload queries, k = 8,
// F = 13). A first version inserted every one of the D slots into each
// query's register top-k and copied each feature with one scalar load and
// store per thread: 0.054-0.062 ms at the paths' largest calls on an H100
// SXM at 700 W, and 16 blocks of 128 threads for the kernel phase's 2048
// queries on a 132-SM card.
//
// The design is the fused warp's selection (warp.cu): the D positions are
// staged in shared memory, each block's and then each warp's box of finite
// queries prunes the slots to the few its queries can select (scan_pruned
// in topk.cuh: per node, distance bounds over the box in the scan's own
// operation order, the k-th smallest upper bound, candidates compacted in
// index order), and each query inserts its warp's candidates without early
// exits (TopK::push_swap). Ties go to the lower index and masked slots sit
// at DYNFU_FAR, so the selection equals the brute-force scan's, bit for
// bit: a masked slot is picked only when fewer than k are valid, and a
// query with a non-finite coordinate gets slots 0..k-1 at +inf. The block
// has 256 threads, or fewer where that leaves fewer than two blocks per SM
// (small Q) or where the lists would not fit in shared memory. The output
// is written by warps: a warp's 32 x k indices and distances go through
// shared memory into contiguous stores, and its 32 x k feature rows, which
// are contiguous in feat_out, are copied together, lane l writing floats l,
// l + 32, ... of the block (the table, D x F floats, stays in L2).
#include "topk.cuh"

struct KnnOut {  // one warp's 32 x k selections, staged for the stores
  int i[32 * 8];
  float d[32 * 8];
};

template <int K>
__global__ void knn_gather_kernel(const float* __restrict__ q,
                                  const float* __restrict__ pos,
                                  const unsigned char* __restrict__ mask,
                                  const float* __restrict__ table, int Q,
                                  int D, int F, int* __restrict__ idx_out,
                                  float* __restrict__ sqd_out,
                                  float* __restrict__ feat_out) {
  extern __shared__ float4 s_nodes[];  // D positions, then the lists
  __shared__ PruneShared sh;
  __shared__ KnnOut so[DYNFU_MAX_WARPS];
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

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long q0 = qi - lane;
  const int nq = (int)max(0LL, min(32LL, (long long)Q - q0));
  KnnOut& o = so[warp];
  if (live)
#pragma unroll
    for (int r = 0; r < K; ++r) {
      o.i[lane * K + r] = top.i[r];
      o.d[lane * K + r] = top.d[r];
    }
  __syncwarp();
  for (int e = lane; e < nq * K; e += 32) {
    idx_out[q0 * K + e] = o.i[e];
    sqd_out[q0 * K + e] = o.d[e];
  }
  float* dst = feat_out + q0 * K * F;
  const int n = nq * K * F;
  for (int e = lane; e < n; e += 32) {
    const int r = e / F;
    dst[e] = table[(long long)o.i[r] * F + (e - r * F)];
  }
}

// 256 threads, halved while that leaves fewer than two blocks per SM (down
// to one warp), and at most as many as fit (pruned_block)
static bool knn_block(int Q, int D, int* threads, size_t* smem) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return false;
  }
  int t = 32 * DYNFU_MAX_WARPS;
  while (t > 32 && dynfu_blocks(Q, t) < 2 * sms) t /= 2;
  return pruned_block(D, t, sizeof(KnnOut) * DYNFU_MAX_WARPS, threads, smem);
}

DYNFU_API int dynfu_knn_gather(const float* queries, const float* pos,
                               const unsigned char* mask, const float* table,
                               int Q, int D, int F, int k, int* idx_out,
                               float* sqd_out, float* feat_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int threads;
  size_t smem;
  if (Q < 1 || !knn_block(Q, D, &threads, &smem))
    return (int)cudaErrorInvalidValue;
  DYNFU_DISPATCH_K(k, {
    cudaError_t e = dynfu_smem_limit<knn_gather_kernel<KK>>(smem);
    if (e != cudaSuccess) return (int)e;
    knn_gather_kernel<KK><<<dynfu_blocks(Q, threads), threads, smem, s>>>(
        queries, pos, mask, table, Q, D, F, idx_out, sqd_out, feat_out);
  });
  return (int)cudaGetLastError();
}

// the launch for Q queries and D slots (k = 8): {threads per block, blocks,
// resident blocks per SM}
DYNFU_API int dynfu_knn_launch(int Q, int D, int* info) {
  size_t smem;
  if (Q < 1 || !knn_block(Q, D, &info[0], &smem))
    return (int)cudaErrorInvalidValue;
  info[1] = dynfu_blocks(Q, info[0]);
  cudaError_t e = dynfu_smem_limit<knn_gather_kernel<8>>(smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[2], knn_gather_kernel<8>, info[0], smem);
}
