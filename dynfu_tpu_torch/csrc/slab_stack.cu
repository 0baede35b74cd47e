// The slab stack and its sign summary, in one pass over the volume.
//
// Replaces no Pallas kernel. The slab sweep (sweep.cu) reads the volume's
// every m-th z plane as (S, Y, nx) float16 rows contiguous in x
// (volume/tsdf.py `slab_stack`); PyTorch's copy from the strided, transposed
// view gathers each output element from an address Y Z halves away from its
// neighbour's. Here one block owns an x-tile of kTX planes, one brick row
// of kBY rows and a pass of kCH slabs: a warp reads one plane's kBY + 1
// z-rows at once (lane = slab, so a load covers 32 m halves of one row),
// the tile is transposed through shared memory and written as (g, y, x)
// rows, a warp's store 32 neighbouring x. In the same pass it writes the
// sign summary (tsdf.BRICK, `brick_summary`): per brick of kBG slabs x kBY
// rows x kBX planes one bit, set where no stack value that a sample with
// its lower corner in the brick reads (the brick and its +1 row and plane)
// is negative or NaN (every one is >= 0: the free space in front of a
// surface, +1, and the volume no camera has seen, 0); a block's 8 x bricks
// make one byte, so no two blocks write the same byte. The sweep skips the
// samples of the brick layers whose bricks along the ray are all set.
//
// Bound: device-memory bytes — the volume's sectors that hold sampled planes
// read once (every sector at m < 16: 268 MB at 512^3) and the stack and the
// summary written once, ~0.097 ms at 3.35 TB/s. A block re-reads its +1 row
// and plane (9/8 x 65/64 of the volume).
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

// the summary's brick (tsdf.BRICK): slabs, rows, x planes
constexpr int kBG = 4, kBY = 8, kBX = 8;
constexpr int kTX = 64;          // x planes a block writes
constexpr int kCH = 32;          // slabs a pass holds: one per lane
constexpr int kPitch = kCH + 2;  // halves per (y, x) row of the tile: an odd
                                 // word pitch, so a warp's x reads differ in
                                 // bank
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    stack_kernel(const __half* __restrict__ vol, int nx, int Y, int Z, int m,
                 int S, int nyb, int nxb, int nbytes,
                 __half* __restrict__ out,
                 unsigned char* __restrict__ summary) {
  __shared__ __half tile[(kBY + 1) * (kTX + 1) * kPitch];
  __shared__ int flag[kCH / kBG][kTX / kBX];
  const int xt = blockIdx.x * kTX, yb = blockIdx.y, yt = yb * kBY;
  const int g0 = blockIdx.z * kCH, ng = min(kCH, S - g0);
  const int nxr = min(kTX + 1, nx - xt), nyr = min(kBY + 1, Y - yt);
  const int nxw = min(kTX, nx - xt), nyw = min(kBY, Y - yt);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x < (kCH / kBG) * (kTX / kBX))
    flag[threadIdx.x / (kTX / kBX)][threadIdx.x % (kTX / kBX)] = 1;
  __syncthreads();
  // a warp a plane: its kBY + 1 rows' sampled halves, the loads in flight
  // together (rows Z halves apart), lane g0 + lane's slab each
  for (int xx = warp; xx < nxr; xx += kThreads / 32) {
    const __half* row =
        vol + ((long long)(xt + xx) * Y + yt) * Z + (long long)(g0 + lane) * m;
    __half v[kBY + 1];
#pragma unroll
    for (int yy = 0; yy <= kBY; ++yy)
      if (yy < nyr && lane < ng) v[yy] = row[(long long)yy * Z];
    bool neg = false;
#pragma unroll
    for (int yy = 0; yy <= kBY; ++yy) {
      if (yy < nyr && lane < ng) {
        tile[(yy * (kTX + 1) + xx) * kPitch + lane] = v[yy];
        neg |= !(__half2float(v[yy]) >= 0.f);  // NaN is not >= 0
      }
    }
    if (neg) {
      const int li = lane / kBG, xb = xx / kBX;
      if (xb < kTX / kBX) flag[li][xb] = 0;
      if (xx % kBX == 0 && xx > 0) flag[li][xb - 1] = 0;
    }
  }
  __syncthreads();
  static_assert(kTX / kBX == 8, "a block's x bricks make one byte");
  if (threadIdx.x < kCH / kBG) {
    int li = threadIdx.x, bits = 0;
    for (int xi = 0; xi < 8; ++xi)
      if (flag[li][xi] && xt / kBX + xi < nxb) bits |= 1 << xi;
    if (li * kBG < ng && yb < nyb && (int)blockIdx.x < nbytes)
      summary[((long long)(g0 / kBG + li) * nyb + yb) * nbytes +
              blockIdx.x] = (unsigned char)bits;
  }
  // the tile out as (g, y, x) rows, a thread a plane of kThreads / kTX rows
  const int x = threadIdx.x % kTX;
  if (x >= nxw) return;
  for (int g = 0; g < ng; ++g)
    for (int yy = threadIdx.x / kTX; yy < nyw; yy += kThreads / kTX)
      out[((long long)(g0 + g) * Y + yt + yy) * nx + xt + x] =
          tile[(yy * (kTX + 1) + x) * kPitch + g];
}

}  // namespace

DYNFU_API int dynfu_slab_stack(const void* vol, int nx, int Y, int Z, int m,
                               int S, int bg, int by, int bx, int nyb,
                               int nbytes, void* out, void* summary,
                               void* stream) {
  const int nxb = (nx - 2) / kBX + 1;
  if (bg != kBG || by != kBY || bx != kBX || nx < 2 || Y < 2 || m < 1 ||
      S != (Z - 1) / m + 1 || nyb != (Y - 2) / kBY + 1 ||
      nbytes != (nxb + 7) / 8)
    return (int)cudaErrorInvalidValue;
  dim3 grid(dynfu_blocks(nx, kTX), dynfu_blocks(Y, kBY),
            dynfu_blocks(S, kCH));
  stack_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __half*)vol, nx, Y, Z, m, S, nyb, nxb, nbytes, (__half*)out,
      (unsigned char*)summary);
  return (int)cudaGetLastError();
}
