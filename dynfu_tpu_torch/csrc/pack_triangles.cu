// Marching-cubes triangle pack.
//
// Replaces pack_triangles_tpu (dynfu_tpu/mesh/mc_pallas.py:69, body
// _pack_kernel :37). The TPU kernel packs each 128-cell chunk with a one-hot
// matmul and one ordered DMA, because the chip scatters rows slowly. Here
// one launch writes the (max_tris, 9) stream in output order, each warp 32
// consecutive output rows. The warp finds the cell of its first row by a
// 32-way search of the monotone t_offsets (32 probes a step, one lane each:
// log32(M) dependent loads, not log2(M)), then loads 32 consecutive cells'
// offsets and counts at a time, and each lane finds its own row's cell
// among them (the last offset at most the row, by shuffles). It then copies the 32 rows' 288
// floats as 9 coalesced 128-byte stores, a float per lane, each read from
// its cell's slot (the row's owner passes the source by shuffle). Rows at
// or past the total count (or the capacity, where the cells hold more) are
// written as zeros in the same pass. Bound: device-memory bytes, the rows
// that land in the stream and the offsets and counts read once, the stream
// written once (at most ~0.85 MB at the 128^3 slice's call, where one
// launch's floor dominates; at most ~6.8 MB at the 512^3 paths').
#include "common.cuh"

#define PACK_THREADS 256

__global__ void __launch_bounds__(PACK_THREADS)
    pack_stream_kernel(const float* __restrict__ tris,
                       const int* __restrict__ t_offsets,
                       const int* __restrict__ n_tris, int M, int max_tris,
                       float* __restrict__ out) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long row0 =
      (((long long)blockIdx.x * PACK_THREADS + threadIdx.x) >> 5) * 32;
  if (row0 >= max_tris) return;  // uniform over the warp
  const long long row = row0 + lane;
  const long long total =
      min((long long)max_tris, (long long)t_offsets[M - 1] + n_tris[M - 1]);
  long long src = -1;  // the row's first float in tris, or -1: zeros
  if (row0 < total) {
    // the last cell whose offset is at most row0, in [lo, hi)
    int lo = 0, hi = M;
    while (hi - lo > 32) {
      const int step = (hi - lo + 31) / 32;
      const int p = lo + lane * step;  // lanes past hi probe nothing
      const unsigned le = __ballot_sync(full, p < hi && t_offsets[p] <= row0);
      const int l = 31 - __clz(le | 1u);  // lane 0's probe is lo: always <=
      const int nlo = lo + l * step;
      hi = min(hi, nlo + step);
      lo = nlo;
    }
    // windows of 32 cells from lo: each lane the last with offset <= row
    const long long far = (long long)1 << 62;
    bool found = row >= total;
    for (int c0 = lo; __any_sync(full, !found); c0 += 32) {
      const bool in = c0 + lane < M;
      const long long off = in ? t_offsets[c0 + lane] : far;
      const int cnt = in ? n_tris[c0 + lane] : 0;
      const long long next = c0 + 32 < M ? t_offsets[c0 + 32] : far;
      long long o = 0;
      int pick = 0, n = 0;
#pragma unroll
      for (int l = 0; l < 32; ++l) {
        const long long v = __shfl_sync(full, off, l);
        const int nl = __shfl_sync(full, cnt, l);
        if (v <= row) { pick = l; o = v; n = nl; }
      }
      if (!found && row < next) {  // the row's cell is in this window
        const long long j = row - o;
        if (j >= 0 && j < n) src = ((long long)(c0 + pick) * 5 + j) * 9;
        found = true;
      }
    }
  }
  float* dst = out + row0 * 9;
  const long long n = min(32LL, (long long)max_tris - row0) * 9;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int o = k * 32 + lane;  // float o of the warp's 32 rows
    const long long s = __shfl_sync(full, src, o / 9);
    if (o < n) dst[o] = s >= 0 ? tris[s + o % 9] : 0.f;
  }
}

DYNFU_API int dynfu_pack_triangles(const float* tris, const int* t_offsets,
                                   const int* n_tris, int M, int max_tris,
                                   float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M < 1 || max_tris < 1) return (int)cudaErrorInvalidValue;
  const long long warps = (max_tris + 31) / 32;
  pack_stream_kernel<<<dynfu_blocks(32 * warps, PACK_THREADS), PACK_THREADS,
                       0, s>>>(tris, t_offsets, n_tris, M, max_tris, out);
  return (int)cudaGetLastError();
}

DYNFU_API const char* dynfu_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
