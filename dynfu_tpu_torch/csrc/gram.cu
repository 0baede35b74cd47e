// GN data-term normal equations from K-sparse weight rows:
//   A = W^T diag(s2) W  (D x D),   b = W^T (s2 * delta)  (D x 3).
//
// Replaces data_normal_tpu (dynfu_tpu/solver/gram_pallas.py:85, body
// _gram_kernel :56). The TPU kernel expands each 256-row tile into dense
// (D, TQ) strips in VMEM and contracts them on the MXU with a 3-pass bf16
// split, carrying A in VMEM from one sequential grid step to the next.
// Blocks here run in no order, so one thread per (row, slot) adds its K
// products s2*w_r*w_r' and its 3 rhs terms straight into A and b with
// float32 atomicAdd — IEEE float32 throughout, the precision the reference
// accumulates in (opt_solver.cpp). Rows with s2 = 0 (masked or Tukey-
// rejected correspondences) add nothing and return early. Bound: atomic
// throughput, N*K*(K+3) adds (2.9M at the 128^3 slice) into a 256 KB
// matrix that stays in L2; the order of the adds, and so the last bits of
// A, changes from run to run.
#include "common.cuh"

__global__ void data_normal_kernel(const int* __restrict__ idx,
                                   const float* __restrict__ w,
                                   const float* __restrict__ s2,
                                   const float* __restrict__ delta, int N,
                                   int K, int D, float* __restrict__ A,
                                   float* __restrict__ b) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)N * K) return;
  int n = (int)(t / K);
  int i = idx[t];
  if (i < 0 || i >= D) return;
  float ws = s2[n] * w[t];
  if (ws == 0.f) return;
  const int* row = idx + (long long)n * K;
  const float* wr = w + (long long)n * K;
  for (int r = 0; r < K; ++r) {
    int j = row[r];
    if (j >= 0 && j < D) atomicAdd(&A[(long long)i * D + j], ws * wr[r]);
  }
  for (int c = 0; c < 3; ++c)
    atomicAdd(&b[3 * i + c], ws * delta[3 * (long long)n + c]);
}

DYNFU_API int dynfu_data_normal(const int* idx, const float* w,
                                const float* s2, const float* delta, int N,
                                int K, int D, float* A, float* b,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(A, 0, sizeof(float) * (size_t)D * D, s);
  cudaMemsetAsync(b, 0, sizeof(float) * (size_t)D * 3, s);
  const int T = 256;
  long long n = (long long)N * K;
  if (n > 0)
    data_normal_kernel<<<dynfu_blocks(n, T), T, 0, s>>>(idx, w, s2, delta, N,
                                                       K, D, A, b);
  return (int)cudaGetLastError();
}
