// Bounded-window stencil fetch for the rigid ICP's projective association.
//
// Replaces fetch_stencil_tpu (dynfu_tpu/ops/stencil_pallas.py:52, body
// _stencil_kernel :32). out[y, x, c] = img[vi, ui, c] where |vi - y| <= R and
// |ui - x| <= R, NaN elsewhere. The TPU kernel keeps one channel plane in
// VMEM and runs (2R+1)^2 circular rolls and selects over it, because the
// chip gathers elements slowly. On Hopper the same function is one bounded
// gather: one thread per pixel (x fastest) reads its (vi, ui), tests the
// window on the caller's clipped indices, and copies the C floats of that
// row or writes NaN. The flow is bounded by R, so neighbouring threads read
// neighbouring rows and the loads stay nearly coalesced without shared
// memory. Bound: device-memory bytes — indices in (8 B), the gathered row in
// and the output row out (4C B each) per pixel, ~17.2 MB at 640x480 with
// C = 6, ~5 us at 3.35 TB/s. The kernel clamps the indices it reads with,
// so an unclipped index never reads outside the image.
#include "common.cuh"

__global__ void fetch_stencil_kernel(const float* __restrict__ img,
                                     const int* __restrict__ vi,
                                     const int* __restrict__ ui, int H, int W,
                                     int C, int R, float* __restrict__ out) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)H * W) return;
  int y = (int)(p / W), x = (int)(p % W);
  int v = vi[p], u = ui[p];
  bool inside = abs(v - y) <= R && abs(u - x) <= R;
  v = min(max(v, 0), H - 1);
  u = min(max(u, 0), W - 1);
  const float* src = img + ((long long)v * W + u) * C;
  float* dst = out + p * C;
  for (int c = 0; c < C; ++c) dst[c] = inside ? src[c] : CUDART_NAN_F;
}

DYNFU_API int dynfu_fetch_stencil(const float* img, const int* vi,
                                  const int* ui, int H, int W, int C, int R,
                                  float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int T = 256;
  fetch_stencil_kernel<<<dynfu_blocks((long long)H * W, T), T, 0, s>>>(
      img, vi, ui, H, W, C, R, out);
  return (int)cudaGetLastError();
}
