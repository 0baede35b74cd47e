// Windowed 1-NN over x-sorted points, with an exactness certificate and an
// exact fetch of the winner's payload row.
//
// Replaces nn1_window_sweep_tpu (dynfu_tpu/ops/corr_pallas.py:135, body
// _corr_kernel :45). The TPU kernel keeps the whole transposed point set
// resident in VMEM and runs one grid step per 2048-query tile; the winner's
// row comes through a hi/lo bf16 one-hot matmul (~16-bit relative). Here a
// block of 256 threads takes 256 queries of one tile (so all its threads
// share the tile's window start, pre and suf), streams the window's points
// through shared memory in 256-point sub-tiles, and each thread keeps its
// running minimum with a strict '<' — the first (lowest-index) point of
// least distance wins, the TPU kernel's tie rule. The winner's payload row
// (F columns; a caller that wants coordinates passes the points) is then
// read directly by index: exact. Bound: Q*W distance evaluations from
// shared memory (134M at the 128^3 slice, 32768 x 4096), ~10 flops each.
#include "common.cuh"

#define SUB 256
#define BIGX 1e37f

__global__ void nn1_window_kernel(const float* __restrict__ qs,
                                  const float* __restrict__ ps,
                                  const int* __restrict__ lo_el,
                                  const float* __restrict__ pre,
                                  const float* __restrict__ suf,
                                  const float* __restrict__ payload, int Qp,
                                  int tq, int W, int F,
                                  float* __restrict__ vals,
                                  unsigned char* __restrict__ exact) {
  __shared__ float sx[SUB], sy[SUB], sz[SUB];
  __shared__ unsigned char sv[SUB];
  int qi = blockIdx.x * blockDim.x + threadIdx.x;
  int tile = (blockIdx.x * blockDim.x) / tq;  // blockDim divides tq
  int lo = lo_el[tile];
  bool active = qi < Qp;
  float qx = active ? qs[3 * qi] : 0.f;
  float qy = active ? qs[3 * qi + 1] : 0.f;
  float qz = active ? qs[3 * qi + 2] : 0.f;

  float best_d = CUDART_INF_F;
  int best_j = 0;
  for (int s0 = 0; s0 < W; s0 += SUB) {
    int n = min(SUB, W - s0);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      long long j = (long long)lo + s0 + t;
      float px = ps[3 * j], py = ps[3 * j + 1], pz = ps[3 * j + 2];
      bool valid = px < BIGX;  // BIG-masked points are never picked
      sv[t] = valid;
      sx[t] = valid ? px : 0.f;
      sy[t] = valid ? py : 0.f;
      sz[t] = valid ? pz : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      float dx = sx[t] - qx, dy = sy[t] - qy, dz = sz[t] - qz;
      float d = sv[t] ? dx * dx + dy * dy + dz * dz : CUDART_INF_F;
      if (d < best_d) {
        best_d = d;
        best_j = lo + s0 + t;
      }
    }
  }
  if (!active) return;

  // certificate: every point outside the window is at least `gap` away in x
  float gap = fmaxf(fminf(qx - pre[tile], suf[tile] - qx), 0.f);
  exact[qi] = (best_d <= gap * gap) && (qx < BIGX);

  // a winner outside the window (no candidate was taken) fetches zeros,
  // as the TPU kernel's one-hot fetch does
  bool in_win = best_j >= lo && best_j < lo + W;
  const float* src = payload + (long long)best_j * F;
  float* dst = vals + (long long)qi * F;
  for (int f = 0; f < F; ++f) dst[f] = in_win ? src[f] : 0.f;
}

DYNFU_API int dynfu_nn1_window(const float* qs, const float* ps,
                               const int* lo_el, const float* pre,
                               const float* suf, const float* payload, int Qp,
                               int Pp, int tq, int W, int F, float* vals,
                               unsigned char* exact, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int T = 256;
  if (tq % T != 0 || W > Pp || F < 1) return (int)cudaErrorInvalidValue;
  nn1_window_kernel<<<dynfu_blocks(Qp, T), T, 0, s>>>(
      qs, ps, lo_el, pre, suf, payload, Qp, tq, W, F, vals, exact);
  return (int)cudaGetLastError();
}
