// GN data-term normal equations from K-sparse weight rows:
//   A = W^T diag(s2) W  (D x D),   b = W^T (s2 * delta)  (D x 3).
//
// Replaces data_normal_tpu (dynfu_tpu/solver/gram_pallas.py:85, body
// _gram_kernel :56). The TPU kernel expands each 256-row tile into dense
// (D, TQ) strips in VMEM and contracts them on the MXU, carrying A in VMEM
// from one sequential grid step to the next: every entry of A sums its
// terms in one order. Blocks here run in no order, and a first version
// that added every term into A and b with float32 atomics gave other last
// bits on every launch; the 41 GN solves of a parity run turned those into
// +-0.8 mm of err_after_3x_motion_mm. So every entry now sums its terms in
// one fixed order, whatever the scheduling:
//
// 1. Entry t = n K + r (row n, slot r) is live where idx[t] is a node in
//    [0, D) and s2[n] and w[t] are nonzero; it belongs to node idx[t]'s
//    bucket, and a bucket lists its entries in ascending t. The buckets
//    are laid out by a counting sort in three small kernels, every step in
//    a fixed order: gram_hist counts each chunk's entries per node (chunks
//    of GRAM_CHUNK consecutive entries; integer counts, exact in any
//    order), gram_scan turns them into each node's bucket size and each
//    chunk's offset within the bucket, and gram_place stages a chunk's
//    keys and writes its entries into place, one warp taking them 32 at a
//    time in order (ranks among equal nodes by __match_any_sync); a
//    bucket starts after those of the nodes below it. The layout only
//    orders the entries; the arithmetic is below.
// 2. data_normal_kernel: one block per node i, whose nw warps take equal
//    contiguous shares of its bucket, each in order. A warp stages 32 entries at a
//    time, a lane per entry: the entry's float64 products s2[n] w[n,r]
//    w[n,r'] for the row's slots r' (slots holding the same node summed
//    into the first, in slot order) and s2[n] w[n,r] delta[n, c]. Then, for
//    each entry in order, lane r' < K adds its slot's product into the
//    warp's float64 row of A[i, :] in shared memory and lanes K..K+2 add
//    the rhs terms to b[i, c]. The warps' rows are summed in warp order and
//    rounded once to float32: the result is, but for rare rounding ties,
//    the correctly rounded Gram, and the same bits on every launch.
//
// Bound: its bytes (idx, w, s2, delta read once, A and b written once;
// 2.9M terms at the 128^3 slice, few next to them). A warp waits on device
// memory once per 32 entries; for each entry it does one shared-memory add
// per lane; a node's bucket (~450 entries on parity 512^3's paths) runs
// serially in its block's warps.
#include "common.cuh"

#define GRAM_WARPS 4  // warps per block, fewer where the rows do not fit
#define GRAM_MAX_K 8

#define GRAM_CHUNK 1024  // entries per chunk of the counting sort

__device__ __forceinline__ int gram_key(const int* __restrict__ idx,
                                        const float* __restrict__ w,
                                        const float* __restrict__ s2,
                                        long long t, int K, int D) {
  const int i = idx[t];
  return i >= 0 && i < D && s2[t / K] != 0.f && w[t] != 0.f ? i : D;
}

// H[c][i]: the live entries of chunk c in node i's bucket
__global__ void gram_hist_kernel(const int* __restrict__ idx,
                                 const float* __restrict__ w,
                                 const float* __restrict__ s2, long long NK,
                                 int K, int D, int* __restrict__ H) {
  extern __shared__ int s_h[];
  for (int i = threadIdx.x; i < D; i += blockDim.x) s_h[i] = 0;
  __syncthreads();
  const long long c0 = (long long)blockIdx.x * GRAM_CHUNK;
  for (int u = threadIdx.x; u < GRAM_CHUNK && c0 + u < NK; u += blockDim.x) {
    const int key = gram_key(idx, w, s2, c0 + u, K, D);
    if (key < D) atomicAdd(&s_h[key], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    H[(long long)blockIdx.x * D + i] = s_h[i];
}

// per node i, one warp: O[c][i], the entries of chunks before c in i's
// bucket, and count[i], the bucket's size. Lane l sums a contiguous range
// of chunks, the lanes' sums are scanned, and each lane writes its range.
__global__ void gram_scan_kernel(const int* __restrict__ H, int C, int D,
                                 int* __restrict__ O,
                                 int* __restrict__ count) {
  const int lane = threadIdx.x & 31;
  const int i = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  if (i >= D) return;  // uniform over the warp
  const int per = (C + 31) / 32;
  const int c0 = min(C, lane * per), c1 = min(C, c0 + per);
  int sum = 0;
  for (int c = c0; c < c1; ++c) sum += H[(long long)c * D + i];
  int incl = sum;  // inclusive scan over the lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  int run = incl - sum;
  for (int c = c0; c < c1; ++c) {
    const int v = H[(long long)c * D + i];
    O[(long long)c * D + i] = run;
    run += v;
  }
  if (lane == 31) count[i] = incl;
}

// s_start[i] = the entries of nodes below i, by the whole block
__device__ __forceinline__ void block_exclusive_scan(const int* __restrict__ count,
                                                     int D, int* s_start,
                                                     int* s_part) {
  const int per = (D + blockDim.x - 1) / blockDim.x;
  const int i0 = min(D, (int)threadIdx.x * per), i1 = min(D, i0 + per);
  int sum = 0;
  for (int i = i0; i < i1; ++i) sum += count[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_part[warp] = incl;
  __syncthreads();
  int base = incl - sum;
  for (int g = 0; g < warp; ++g) base += s_part[g];
  for (int i = i0; i < i1; ++i) {
    s_start[i] = base;
    base += count[i];
  }
  __syncthreads();
}

// chunk c's live entries into their buckets, in ascending t: the block
// stages the chunk's keys, then one warp ranks them 32 at a time in order
__global__ void gram_place_kernel(const int* __restrict__ idx,
                                  const float* __restrict__ w,
                                  const float* __restrict__ s2, long long NK,
                                  int K, int D, const int* __restrict__ O,
                                  const int* __restrict__ count,
                                  int* __restrict__ perm) {
  extern __shared__ int s_cur[];  // D cursors
  __shared__ int s_key[GRAM_CHUNK];
  __shared__ int s_part[32];
  const long long c0 = (long long)blockIdx.x * GRAM_CHUNK;
  for (int u = threadIdx.x; u < GRAM_CHUNK; u += blockDim.x)
    s_key[u] = c0 + u < NK ? gram_key(idx, w, s2, c0 + u, K, D) : D;
  block_exclusive_scan(count, D, s_cur, s_part);
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    s_cur[i] += O[(long long)blockIdx.x * D + i];
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  for (int u0 = 0; u0 < GRAM_CHUNK && c0 + u0 < NK; u0 += 32) {
    const int key = s_key[u0 + lane];
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key < D)
      perm[s_cur[key] + __popc(peers & ((1u << lane) - 1u))] =
          (int)(c0 + u0 + lane);
    __syncwarp();
    if (key < D && lane == __ffs(peers) - 1) s_cur[key] += __popc(peers);
    __syncwarp();
  }
}

struct GramStage {  // one warp's batch of 32 entries, slot-major
  int j[GRAM_MAX_K][32];         // the slot's node, or -1 (invalid, merged)
  double p[GRAM_MAX_K + 3][32];  // A's products, then b's
};

template <int K>
__global__ void data_normal_kernel(const int* __restrict__ idx,
                                   const float* __restrict__ w,
                                   const float* __restrict__ s2,
                                   const float* __restrict__ delta,
                                   const int* __restrict__ count,
                                   const int* __restrict__ perm, int D,
                                   float* __restrict__ A,
                                   float* __restrict__ b) {
  extern __shared__ double s_acc[];  // per warp a row of D + 3: A[i, :], b[i]
  __shared__ GramStage st[GRAM_WARPS];
  const int i = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int R = D + 3;
  double* acc = s_acc + (size_t)warp * R;
  for (int j = lane; j < R; j += 32) acc[j] = 0.0;
  // the bucket: after the entries of nodes below i
  __shared__ int s_part[GRAM_WARPS];
  int part = 0;
  for (int k = threadIdx.x; k < i; k += blockDim.x) part += count[k];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, o);
  if (lane == 0) s_part[warp] = part;
  __syncthreads();
  long long start = 0;
  for (int g = 0; g < nw; ++g) start += s_part[g];
  const long long len = count[i];
  const long long e0 = start + len * warp / nw;
  const long long e1 = start + len * (warp + 1) / nw;

  GramStage& s = st[warp];
  for (long long c0 = e0; c0 < e1; c0 += 32) {
    const int m = (int)min(32LL, e1 - c0);
    __syncwarp();
    if (lane < m) {  // stage entry c0 + lane
      const long long t = perm[c0 + lane];
      const long long n = t / K;
      const double ws = (double)s2[n] * (double)w[t];
      int jr[K];
      double pr[K];
#pragma unroll
      for (int r = 0; r < K; ++r) {
        jr[r] = idx[n * K + r];
        pr[r] = ws * (double)w[n * K + r];
      }
      bool dup = false;  // a node in two slots of the row
#pragma unroll
      for (int r = 1; r < K; ++r)
#pragma unroll
        for (int r2 = 0; r2 < r; ++r2) dup = dup || jr[r2] == jr[r];
#pragma unroll
      for (int r = 0; r < K; ++r) {  // a node's first slot takes its sum
        const bool ok = jr[r] >= 0 && jr[r] < D;
        bool first = ok;
        double sum = pr[r];
        if (dup) {
          sum = 0.0;
#pragma unroll
          for (int r2 = 0; r2 < K; ++r2) {
            const bool same = jr[r2] == jr[r];
            first = first && !(same && r2 < r);
            sum += same ? pr[r2] : 0.0;
          }
        }
        s.j[r][lane] = first ? jr[r] : -1;
        s.p[r][lane] = sum;
      }
#pragma unroll
      for (int c = 0; c < 3; ++c)
        s.p[K + c][lane] = ws * (double)delta[3 * n + c];
    }
    __syncwarp();
    if (lane < K) {
      for (int q = 0; q < m; ++q) {
        const int j = s.j[lane][q];
        if (j >= 0) acc[j] += s.p[lane][q];
      }
    } else if (lane < K + 3) {
      for (int q = 0; q < m; ++q) acc[D + lane - K] += s.p[lane][q];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < R; j += blockDim.x) {
    double v = s_acc[j];
    for (int g = 1; g < nw; ++g) v += s_acc[(size_t)g * R + j];
    if (j < D)
      A[(size_t)i * D + j] = (float)v;
    else
      b[3 * (size_t)i + (j - D)] = (float)v;
  }
}

// warps per block whose float64 rows fit beside the static staging
static int gram_warps(int D) {
  const size_t row = sizeof(double) * ((size_t)D + 3);
  const size_t fixed = sizeof(GramStage) * GRAM_WARPS + sizeof(int) * GRAM_WARPS;
  for (int nw = GRAM_WARPS; nw >= 1; --nw)
    if (fixed + nw * row <= DYNFU_MAX_SMEM) return nw;
  return 0;
}

// int32 scratch dynfu_data_normal needs: per chunk and node H and O, per
// node count, per entry perm
DYNFU_API long long dynfu_data_normal_scratch(int N, int K, int D) {
  const long long NK = (long long)N * K;
  const long long C = (NK + GRAM_CHUNK - 1) / GRAM_CHUNK;
  return 2 * C * D + D + NK;
}

DYNFU_API int dynfu_data_normal(const int* idx, const float* w,
                                const float* s2, const float* delta, int N,
                                int K, int D, int* scratch, float* A,
                                float* b, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nw = gram_warps(D);
  const size_t cur = sizeof(int) * (size_t)D;
  if (nw == 0 || D < 1 || cur + sizeof(int) * (GRAM_CHUNK + 32) > DYNFU_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const long long NK = (long long)N * K;
  const int C = (int)((NK + GRAM_CHUNK - 1) / GRAM_CHUNK);
  int* H = scratch;
  int* O = H + (long long)C * D;
  int* count = O + (long long)C * D;
  int* perm = count + D;
  const size_t smem = sizeof(double) * ((size_t)D + 3) * nw;
  cudaError_t e = dynfu_smem_limit<gram_hist_kernel>(cur);
  if (e == cudaSuccess) e = dynfu_smem_limit<gram_place_kernel>(cur);
  if (e != cudaSuccess) return (int)e;
  if (C > 0) {
    gram_hist_kernel<<<C, 256, cur, s>>>(idx, w, s2, NK, K, D, H);
    gram_scan_kernel<<<dynfu_blocks(32LL * D, 256), 256, 0, s>>>(H, C, D, O,
                                                                count);
    gram_place_kernel<<<C, 256, cur, s>>>(idx, w, s2, NK, K, D, O, count,
                                          perm);
  } else {
    cudaMemsetAsync(count, 0, cur, s);
  }
  DYNFU_DISPATCH_K(K, {
    e = dynfu_smem_limit<data_normal_kernel<KK>>(smem);
    if (e != cudaSuccess) return (int)e;
    data_normal_kernel<KK><<<D, 32 * nw, smem, s>>>(idx, w, s2, delta, count,
                                                    perm, D, A, b);
  });
  return (int)cudaGetLastError();
}

// the warps per block dynfu_data_normal launches with for D nodes
DYNFU_API int dynfu_data_normal_warps(int D, int* warps) {
  *warps = gram_warps(D);
  return *warps ? 0 : (int)cudaErrorInvalidValue;
}
