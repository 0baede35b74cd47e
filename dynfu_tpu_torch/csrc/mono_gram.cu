// Monomial-weighted Grams of the SE(3) data term from K-sparse weight rows:
//   B[m] = (sqrt(s2) W)^T diag(mono_m(y)) (sqrt(s2) W)   (10 x D x D),
//   Bu   = W^T (s2 * delta),   Bw = W^T (s2 * (y x delta))   (D x 3 each),
// monomials [1, yx, yy, yz, yx^2, yx yy, yx yz, yy^2, yy yz, yz^2].
//
// Replaces monomial_grams_tpu (dynfu_tpu/solver/gram_pallas.py:184, body
// _mono_gram_kernel :135). The TPU kernel expands each 256-row tile into a
// dense (D, TQ) strip in VMEM and contracts it against its ten monomial-
// scaled copies on the MXU (3-pass bf16), carrying two (D, D) accumulators
// from one sequential grid step to the next. Blocks here run in no order,
// so one thread per (row, slot a) forms ws_a = sqrt(max(s2, 0)) w_a and the
// row's ten monomials and adds ws_a ws_b m into B[m, idx_a, idx_b] for its
// K partners b, plus its six rhs terms, with float32 atomicAdd — IEEE
// float32 throughout (TF32 plays no part). Rows with s2 = 0 and indices
// outside [0, D) (padding) add nothing.
//
// Bound: the work is N*K*(10K + 6) adds (42 M at N = 65536, K = 8) — ~84
// MFLOP — and ~22 MB of traffic (the 16.4 MB output written once plus the
// rows), ~7 us at 3.35 TB/s. The dense route (an (N, D) strip and ten
// float32 matmuls, ~537 GFLOP) is the yardstick chip_smoke.py times. The
// expected limit is atomic contention: every pair of well-shared nodes
// receives adds from hundreds of rows. The order of the adds, and so the
// last bits of B, changes from run to run.
#include "common.cuh"

__global__ void monomial_grams_kernel(const int* __restrict__ idx,
                                      const float* __restrict__ w,
                                      const float* __restrict__ s2,
                                      const float* __restrict__ y,
                                      const float* __restrict__ delta, int N,
                                      int K, int D, float* __restrict__ B,
                                      float* __restrict__ Bu,
                                      float* __restrict__ Bw) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)N * K) return;
  long long n = t / K;
  int a = idx[t];
  if (a < 0 || a >= D) return;
  float rs = sqrtf(fmaxf(s2[n], 0.f));
  float wsa = rs * w[t];
  if (wsa == 0.f) return;
  float yx = y[3 * n], yy = y[3 * n + 1], yz = y[3 * n + 2];
  float mono[10] = {1.f,     yx,      yy,      yz,      yx * yx,
                    yx * yy, yx * yz, yy * yy, yy * yz, yz * yz};
  const int* row = idx + n * K;
  const float* wr = w + n * K;
  size_t DD = (size_t)D * D;
  for (int r = 0; r < K; ++r) {
    int b = row[r];
    if (b < 0 || b >= D) continue;
    float p = wsa * (rs * wr[r]);
    float* dst = B + (size_t)a * D + b;
#pragma unroll
    for (int m = 0; m < 10; ++m) atomicAdd(dst + m * DD, p * mono[m]);
  }
  float dx = delta[3 * n], dy = delta[3 * n + 1], dz = delta[3 * n + 2];
  float cx = yy * dz - yz * dy, cy = yz * dx - yx * dz, cz = yx * dy - yy * dx;
  atomicAdd(&Bu[3 * a], wsa * (rs * dx));
  atomicAdd(&Bu[3 * a + 1], wsa * (rs * dy));
  atomicAdd(&Bu[3 * a + 2], wsa * (rs * dz));
  atomicAdd(&Bw[3 * a], wsa * (rs * cx));
  atomicAdd(&Bw[3 * a + 1], wsa * (rs * cy));
  atomicAdd(&Bw[3 * a + 2], wsa * (rs * cz));
}

DYNFU_API int dynfu_monomial_grams(const int* idx, const float* w,
                                   const float* s2, const float* y,
                                   const float* delta, int N, int K, int D,
                                   float* B, float* Bu, float* Bw,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(B, 0, sizeof(float) * 10 * (size_t)D * D, s);
  cudaMemsetAsync(Bu, 0, sizeof(float) * (size_t)D * 3, s);
  cudaMemsetAsync(Bw, 0, sizeof(float) * (size_t)D * 3, s);
  const int T = 256;
  long long n = (long long)N * K;
  if (n > 0)
    monomial_grams_kernel<<<dynfu_blocks(n, T), T, 0, s>>>(
        idx, w, s2, y, delta, N, K, D, B, Bu, Bw);
  return (int)cudaGetLastError();
}
