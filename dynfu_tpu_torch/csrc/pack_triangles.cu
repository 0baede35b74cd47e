// Marching-cubes triangle pack.
//
// Replaces pack_triangles_tpu (dynfu_tpu/mesh/mc_pallas.py:69, body
// _pack_kernel :37). The TPU kernel packs each 128-cell chunk with a one-hot
// matmul and one ordered DMA, because the chip scatters rows slowly. Here
// the store is direct: one thread per (cell, slot) writes its 9 floats at
// t_offsets[cell] + slot, and a second pass zeroes the rows at or past the
// total. Bound: device-memory bytes (M*5*36 read, max_tris*36 written, ~1.5
// MB at the 128^3 slice), far below a millisecond; the design spends no
// effort on coalescing beyond the 9-float row.
#include "common.cuh"

__global__ void pack_rows(const float* __restrict__ tris,
                          const int* __restrict__ t_offsets,
                          const int* __restrict__ n_tris, int M, int max_tris,
                          float* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)M * 5) return;
  int c = (int)(i / 5), j = (int)(i % 5);
  if (j >= n_tris[c]) return;
  long long row = (long long)t_offsets[c] + j;
  if (row >= max_tris) return;  // capacity spill drops, like the scatter
  const float* src = tris + i * 9;
  float* dst = out + row * 9;
#pragma unroll
  for (int f = 0; f < 9; ++f) dst[f] = src[f];
}

__global__ void zero_tail(const int* __restrict__ t_offsets,
                          const int* __restrict__ n_tris, int M, int max_tris,
                          float* __restrict__ out) {
  long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= max_tris) return;
  long long total = (long long)t_offsets[M - 1] + n_tris[M - 1];
  if (r < total) return;
  float* dst = out + r * 9;
#pragma unroll
  for (int f = 0; f < 9; ++f) dst[f] = 0.f;
}

DYNFU_API int dynfu_pack_triangles(const float* tris, const int* t_offsets,
                                   const int* n_tris, int M, int max_tris,
                                   float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int T = 256;
  pack_rows<<<dynfu_blocks((long long)M * 5, T), T, 0, s>>>(
      tris, t_offsets, n_tris, M, max_tris, out);
  zero_tail<<<dynfu_blocks(max_tris, T), T, 0, s>>>(t_offsets, n_tris, M,
                                                    max_tris, out);
  return (int)cudaGetLastError();
}

DYNFU_API const char* dynfu_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
