// Windowed 1-NN over x-sorted points, with an exactness certificate and an
// exact fetch of the winner's payload row.
//
// Replaces nn1_window_sweep_tpu (dynfu_tpu/ops/corr_pallas.py:135, body
// _corr_kernel :45). The TPU kernel keeps the whole transposed point set
// resident in VMEM and runs one grid step per 2048-query tile, every query
// against every point of its tile's window; the winner's row comes through
// a hi/lo bf16 one-hot matmul (~16-bit relative).
//
// What bounds it on this card. The least any exact implementation needs is
// its bytes: the queries, the windows' points and the winners' payload rows
// read once, the rows and flags written once. A first version swept every
// query against its whole window (W = 4096 points, 16384 on the escalate
// pass), four shared loads and ~10 flops a pair: 0.17 ms for parity
// 512^3's 49152 queries on an H100 SXM at 700 W, ~10x its byte bound.
//
// The design: the callers' queries come in the points' x order, so a
// group of 32 consecutive queries spans a narrow x range while the window
// spans the scene. nn1_boxes_kernel bounds the valid points of every
// 128-point block of the point array (NN1_SUB) once per launch. A group
// then takes the window's sub-tiles (the blocks it overlaps; their boxes
// may reach beyond the window, which only loosens the bound) starting from
// the one whose box is nearest its queries' box, then alternately right and
// left. Before each, a warp bounds the squared distance from its box to
// the sub-tile's box, per axis in the scan's own operation order (rounding
// is monotone and the build passes -fmad=false, so the bound is at most
// every computed distance), and skips the sub-tile if that bound is
// strictly greater than the largest best distance of its live queries: no
// point there can win, not even on a tie. The winner is the least
// (distance, index) pair, which does not depend on the order the points
// are taken in: the lowest index among equal distances, as a sweep in
// index order keeps with a strict '<'. That lets a scan keep four running
// minima (every fourth point each) to overlap their compare chains, and
// lets a small launch (the escalate pass: 8192 queries) give each group up
// to 4 warps, taking every split-th visit each and merging at the end, so
// that the card fills and the widest group's sub-tiles are shared
// (nn1_split). Blocks of 4 warps with 4 running minima were the fastest of
// 4 or 8 warps with 1 or 4 minima at parity 512^3's shapes, in a one-off
// comparison on an H100 SXM at 700 W. A
// scanned sub-tile is staged as float4 in the warp's own shared memory
// (one 16-byte load a pair); BIG-masked points (x >= 1e37) and points
// outside the window are staged with x = NaN, whose distance never
// compares less or equal, so they are never candidates. A query with no
// candidate keeps (+inf, index 0), the sweep's result. Every query's
// result is the brute-force sweep's, bit for bit. Finally the group's
// first warp copies its 32 winners' payload rows, which are contiguous in
// the output, together: lane l writes floats l, l + 32, ... of the group's
// 32 x F block.
#include "topk.cuh"

#define NN1_SUB 128   // points per sub-tile, the granularity of the boxes
#define NN1_WARPS 4   // warps per block
#define BIGX 1e37f

// the box of the valid points of each NN1_SUB-point block, as (xlo, ylo,
// zlo, xhi, yhi, zhi); a block without a valid point gets lo = +inf and
// hi = -inf. One warp per block.
__global__ void nn1_boxes_kernel(const float* __restrict__ ps, int Pp,
                                 float* __restrict__ boxes) {
  const int lane = threadIdx.x & 31;
  const long long blk = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (blk * NN1_SUB >= Pp) return;  // uniform over the warp
  float b[6];  // lo, then -hi: all minima
#pragma unroll
  for (int c = 0; c < 6; ++c) b[c] = CUDART_INF_F;
  for (int t = lane; t < NN1_SUB; t += 32) {
    const long long j = blk * NN1_SUB + t;
    if (j >= Pp) break;
    const float x = ps[3 * j], y = ps[3 * j + 1], z = ps[3 * j + 2];
    if (x < BIGX) {
      b[0] = fminf(b[0], x);
      b[1] = fminf(b[1], y);
      b[2] = fminf(b[2], z);
      b[3] = fminf(b[3], -x);
      b[4] = fminf(b[4], -y);
      b[5] = fminf(b[5], -z);
    }
  }
#pragma unroll
  for (int c = 0; c < 6; ++c)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      b[c] = fminf(b[c], __shfl_xor_sync(DYNFU_FULL_MASK, b[c], o));
  if (lane == 0)
#pragma unroll
    for (int c = 0; c < 6; ++c) boxes[6 * blk + c] = c < 3 ? b[c] : -b[c];
}

// lower bound of the squared distance between a point of box bx and a
// query of [lo, hi], per axis as the scan computes (p - q)^2
__device__ __forceinline__ float box_gap2(const float* __restrict__ bx,
                                          float3 lo, float3 hi) {
  const float gx = bx[0] > hi.x ? bx[0] - hi.x : (bx[3] < lo.x ? lo.x - bx[3] : 0.f);
  const float gy = bx[1] > hi.y ? bx[1] - hi.y : (bx[4] < lo.y ? lo.y - bx[4] : 0.f);
  const float gz = bx[2] > hi.z ? bx[2] - hi.z : (bx[5] < lo.z ? lo.z - bx[5] : 0.f);
  return gx * gx + gy * gy + gz * gz;
}

// the least (distance, index) pair
__device__ __forceinline__ void lex_min(float& bd, int& bj, float d, int j) {
  if (d < bd || (d == bd && j < bj)) {
    bd = d;
    bj = j;
  }
}

__global__ void __launch_bounds__(32 * NN1_WARPS)
nn1_window_kernel(const float* __restrict__ qs, const float* __restrict__ ps,
                  const float* __restrict__ boxes,
                  const int* __restrict__ lo_el, const float* __restrict__ pre,
                  const float* __restrict__ suf,
                  const float* __restrict__ payload, int Qp, int tq, int W,
                  int F, int split, float* __restrict__ vals,
                  unsigned char* __restrict__ exact) {
  __shared__ float4 s_pts[NN1_WARPS][NN1_SUB];
  __shared__ float s_bd[NN1_WARPS][32];
  __shared__ int s_bj[NN1_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int part = warp % split;  // this warp's share of the group's visits
  const long long q0 =
      ((long long)blockIdx.x * (NN1_WARPS / split) + warp / split) * 32;
  const bool active = q0 < Qp;  // uniform over the warp (Qp % 32 == 0)
  const long long qi = active ? q0 + lane : 0;
  const int tile = (int)(q0 / tq);  // 32 divides tq: one tile per warp
  const int lo = active ? lo_el[tile] : 0;
  const float3 v = active ? make_float3(qs[3 * qi], qs[3 * qi + 1],
                                        qs[3 * qi + 2])
                          : make_float3(CUDART_NAN_F, 0.f, 0.f);
  const bool live = v.x < BIGX && finite3(v);
  float bq[6];
  warp_box(live, v, bq);
  const float3 qlo = make_float3(bq[0], bq[1], bq[2]);
  const float3 qhi = make_float3(-bq[3], -bq[4], -bq[5]);

  float best_d = CUDART_INF_F;
  int best_j = 0;
  if (qlo.x <= qhi.x) {  // the warp holds a live query (uniform)
    const int b0 = lo / NN1_SUB, nsub = (lo + W - 1) / NN1_SUB - b0 + 1;
    const float* bx0 = boxes + 6 * (long long)b0;
    // the first sub-tile: least bound, the lowest on ties
    float m = CUDART_INF_F;
    int s0 = 0;
    for (int s = lane; s < nsub; s += 32)
      lex_min(m, s0, box_gap2(bx0 + 6 * s, qlo, qhi), s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float om = __shfl_xor_sync(DYNFU_FULL_MASK, m, o);
      const int os = __shfl_xor_sync(DYNFU_FULL_MASK, s0, o);
      lex_min(m, s0, om, os);
    }
    float4* sp = s_pts[warp];
    auto visit = [&](int s) {
      const float* bx = bx0 + 6 * s;
      if (!(bx[0] <= bx[3])) return;  // no valid point
      float mb = live ? best_d : -CUDART_INF_F;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mb = fmaxf(mb, __shfl_xor_sync(DYNFU_FULL_MASK, mb, o));
      if (box_gap2(bx, qlo, qhi) > mb) return;  // uniform: nothing can win
      const long long p0 = (long long)(b0 + s) * NN1_SUB;
      __syncwarp();
      for (int t = lane; t < NN1_SUB; t += 32) {
        const long long j = p0 + t;
        float4 p = make_float4(CUDART_NAN_F, 0.f, 0.f, 0.f);
        if (j >= lo && j < lo + W) {
          const float x = ps[3 * j];
          if (x < BIGX) p = make_float4(x, ps[3 * j + 1], ps[3 * j + 2], 0.f);
        }
        sp[t] = p;
      }
      __syncwarp();
      // four running minima, every fourth point each, merged after: the
      // least (distance, index) pair does not depend on the order
      float bd[4];
      int bj[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        bd[u] = best_d;
        bj[u] = best_j;
      }
#pragma unroll 2
      for (int t = 0; t < NN1_SUB; t += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 p = sp[t + u];
          const float dx = p.x - v.x, dy = p.y - v.y, dz = p.z - v.z;
          lex_min(bd[u], bj[u], dx * dx + dy * dy + dz * dz,
                  (int)p0 + t + u);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) lex_min(best_d, best_j, bd[u], bj[u]);
    };
    // s0, then alternately right and left; this warp takes every split-th
    int k = 0;
    if (k++ % split == part) visit(s0);
    for (int r = s0 + 1, l = s0 - 1; r < nsub || l >= 0; ++r, --l) {
      if (r < nsub && k++ % split == part) visit(r);
      if (l >= 0 && k++ % split == part) visit(l);
    }
  }
  if (split > 1) {  // the group's warps merge into its first
    s_bd[warp][lane] = best_d;
    s_bj[warp][lane] = best_j;
    __syncthreads();
    if (part != 0) return;
    for (int w = 1; w < split; ++w)
      lex_min(best_d, best_j, s_bd[warp + w][lane], s_bj[warp + w][lane]);
  }
  if (!active) return;
  if (!live) {  // BIG-masked or non-finite: the sweep takes nothing
    best_d = CUDART_INF_F;
    best_j = 0;
  }

  // certificate: every point outside the window is at least `gap` away in x
  const float gap = fmaxf(fminf(v.x - pre[tile], suf[tile] - v.x), 0.f);
  exact[qi] = (best_d <= gap * gap) && (v.x < BIGX);

  // a winner outside the window (no candidate was taken) fetches zeros, as
  // the TPU kernel's one-hot fetch does
  const int in_win = best_j >= lo && best_j < lo + W;
  float* dst = vals + q0 * F;
  for (int e = lane; e < 32 * F; e += 32) {  // F steps for every lane
    const int t = e / F;
    const int jt = __shfl_sync(DYNFU_FULL_MASK, best_j, t);
    const int ok = __shfl_sync(DYNFU_FULL_MASK, in_win, t);
    dst[e] = ok ? payload[(long long)jt * F + (e - t * F)] : 0.f;
  }
}

// warps per query group: the most of 4, 2, 1 that keeps the launch within
// 8 warps per SM. A group's warps prune with their own best
// distances only, so a split scans more sub-tiles in all; it pays where a
// launch is too small to fill the card (the escalate pass: 8192 queries,
// split 4) and not on the main pass (49152 queries, split 1).
static int nn1_split(int Qp) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
  }
  int split = NN1_WARPS;
  while (split > 1 && (long long)(Qp / 32) * split > 8LL * sms) split /= 2;
  return split;
}

DYNFU_API int dynfu_nn1_window(const float* qs, const float* ps, float* boxes,
                               const int* lo_el, const float* pre,
                               const float* suf, const float* payload, int Qp,
                               int Pp, int tq, int W, int F, float* vals,
                               unsigned char* exact, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int split = nn1_split(Qp);
  if (split == 0 || tq % 32 != 0 || Qp % tq != 0 || W < 1 || W > Pp || F < 1)
    return (int)cudaErrorInvalidValue;
  const int nb = dynfu_blocks(Pp, NN1_SUB);
  nn1_boxes_kernel<<<dynfu_blocks(32LL * nb, 256), 256, 0, s>>>(ps, Pp,
                                                                boxes);
  const int groups = NN1_WARPS / split;
  if (Qp > 0)
    nn1_window_kernel<<<dynfu_blocks(Qp / 32, groups), 32 * NN1_WARPS, 0,
                        s>>>(qs, ps, boxes, lo_el, pre, suf, payload, Qp, tq,
                             W, F, split, vals, exact);
  return (int)cudaGetLastError();
}

// the launch for Qp queries: {threads per block, points per sub-tile,
// warps per query group, blocks, resident blocks per SM}
DYNFU_API int dynfu_nn1_launch(int Qp, int* info) {
  info[0] = 32 * NN1_WARPS;
  info[1] = NN1_SUB;
  info[2] = nn1_split(Qp);
  if (info[2] == 0) return (int)cudaErrorInvalidValue;
  info[3] = dynfu_blocks(Qp / 32, NN1_WARPS / info[2]);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[4], nn1_window_kernel, 32 * NN1_WARPS, 0);
}
