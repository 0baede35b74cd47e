// Monomial-weighted Grams of the SE(3) data term from K-sparse weight rows:
//   B[m] = (sqrt(s2) W)^T diag(mono_m(y)) (sqrt(s2) W)   (10 x D x D),
//   Bu   = W^T (s2 * delta),   Bw = W^T (s2 * (y x delta))   (D x 3 each),
// monomials [1, yx, yy, yz, yx^2, yx yy, yx yz, yy^2, yy yz, yz^2].
//
// Replaces monomial_grams_tpu (dynfu_tpu/solver/gram_pallas.py:184, body
// _mono_gram_kernel :135). The TPU kernel expands each 256-row tile into a
// dense (D, TQ) strip in VMEM and contracts it against its ten monomial-
// scaled copies on the MXU (3-pass bf16), carrying two (D, D) accumulators
// from one sequential grid step to the next. Blocks here run in no order.
//
// What bounds it on this card. The work is N*K*(10K + 6) adds (84 MFLOP at
// N = 2^17, K = 8) and the traffic ~30 MB (the (10, D, D) output written
// once, the rows read once): ~9 us at 3.35 TB/s. Adding every term to
// device memory with a float32 atomic, as a first version did, issued 84 M
// global atomics into 4.1 M addresses, and the rows of one region share
// the same 8 nodes, so hundreds of rows hit each hot (a, b) pair: the
// atomics' contention, not the bytes, set its time (0.79 ms at N = 2^17
// on an H100 SXM at 700 W).
//
// The design: a block takes a tile of consecutive rows (they come in
// surface order, so they share few nodes) and walks it in segments. For
// each it ranks the distinct live node indices (those of slots with
// sqrt(max(s2, 0)) w != 0 and an index in [0, D); padding and rows with
// s2 = 0 drop out) into local slots through a D-byte map in shared memory,
// and accumulates the ten local Grams and the two rhs there with shared-
// memory float atomics. B is symmetric term by term (ws_a ws_b = ws_b
// ws_a), so only local pairs la <= lb are accumulated, in a packed
// triangle, and the flush mirrors each off-diagonal entry: the segment's
// nonzero entries go to B, Bu and Bw with one global atomic each (two for
// a mirrored pair). A segment with more distinct nodes than the MONO_U
// slots is halved; one of MONO_MIN_ROWS rows or fewer that still has more
// adds its rows with global atomics term by term: part of the kernel, counted by
// chip_smoke.py through the plain model of the rule
// (solver/gram_cuda.mono_segments). The tiling was chosen by a one-off
// sweep on the paths' shapes (PERF.md): 64-row tiles, 32 slots, halved
// down to 16 rows, 2048 blocks at N = 2^17 with 22 KB of static shared
// memory each, so eight share an SM and hide each other's atomic latency
// (512-row tiles with u = 64 fill half the card, 85 KB a block, and were
// slower). What is left: the shared atomics on the hot pairs,
// and per segment the flush's global atomics and the ranking's block
// barriers.
//
// IEEE float32 throughout (no TF32, no tensor cores). Each term is the
// plain version's product, p = ws_a (sqrt(s2) w_b) times the monomial;
// only the order of the adds differs, and changes from run to run.
#include "common.cuh"

#define MONO_THREADS 256
#define MONO_ROWS 64      // rows per tile, one block each
#define MONO_U 32         // local slots: the most distinct nodes a segment
                          // accumulates in shared memory (< 255: a byte)
#define MONO_MIN_ROWS 16  // the shortest segment that is halved
#define MONO_TRI (MONO_U * (MONO_U + 1) / 2)

__device__ __forceinline__ void row_monomials(const float* __restrict__ y,
                                              long long n, float* mono) {
  float yx = y[3 * n], yy = y[3 * n + 1], yz = y[3 * n + 2];
  mono[0] = 1.f;
  mono[1] = yx;
  mono[2] = yy;
  mono[3] = yz;
  mono[4] = yx * yx;
  mono[5] = yx * yy;
  mono[6] = yx * yz;
  mono[7] = yy * yy;
  mono[8] = yy * yz;
  mono[9] = yz * yz;
}

// rhs terms of slot a: wsa (rs delta), wsa (rs (y x delta))
__device__ __forceinline__ void row_rhs(const float* __restrict__ y,
                                        const float* __restrict__ delta,
                                        long long n, float wsa, float rs,
                                        float* out) {
  float yx = y[3 * n], yy = y[3 * n + 1], yz = y[3 * n + 2];
  float dx = delta[3 * n], dy = delta[3 * n + 1], dz = delta[3 * n + 2];
  float cx = yy * dz - yz * dy, cy = yz * dx - yx * dz, cz = yx * dy - yy * dx;
  out[0] = wsa * (rs * dx);
  out[1] = wsa * (rs * dy);
  out[2] = wsa * (rs * dz);
  out[3] = wsa * (rs * cx);
  out[4] = wsa * (rs * cy);
  out[5] = wsa * (rs * cz);
}

struct MonoShared {  // static shared memory of one block
  float acc[10 * MONO_TRI + 6 * MONO_U];  // packed triangles, then the rhs
  int node[MONO_U];                       // local slot -> node index
  int wcnt[MONO_THREADS / 32];
};

// Number the distinct live nodes of rows [r0, r0 + nr) into local slots
// (ascending node order) through the D-byte map, if there are at most
// MONO_U; returns their count, uniform over the block.
__device__ __forceinline__ int rank_segment(const int* __restrict__ idx,
                            const float* __restrict__ w,
                            const float* __restrict__ s2, long long r0,
                            int nr, int K, int D, unsigned char* s_map,
                            MonoShared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = MONO_THREADS / 32;
  for (int j = tid; j < D; j += MONO_THREADS) s_map[j] = 255;
  __syncthreads();
  for (int t = tid; t < nr * K; t += MONO_THREADS) {
    int a = idx[r0 * K + t];
    if (a < 0 || a >= D) continue;
    float rs = sqrtf(fmaxf(s2[r0 + t / K], 0.f));
    if (rs * w[r0 * K + t] != 0.f) s_map[a] = 0;
  }
  __syncthreads();
  // warp w counts, then numbers, the marked nodes of [w C, (w + 1) C)
  const int C = ((D + nw - 1) / nw + 31) & ~31;
  const int j0 = warp * C, j1 = min(D, j0 + C);
  int cnt = 0;
  for (int base = j0; base < j1; base += 32) {
    int j = base + lane;
    cnt += __popc(__ballot_sync(0xffffffffu, j < j1 && s_map[j] != 255));
  }
  if (lane == 0) sh.wcnt[warp] = cnt;
  __syncthreads();
  int off = 0, n = 0;
  for (int g = 0; g < nw; ++g) {
    off += g < warp ? sh.wcnt[g] : 0;
    n += sh.wcnt[g];
  }
  if (n <= MONO_U) {
    for (int base = j0; base < j1; base += 32) {
      int j = base + lane;
      bool f = j < j1 && s_map[j] != 255;
      unsigned bal = __ballot_sync(0xffffffffu, f);
      if (f) {
        int slot = off + __popc(bal & ((1u << lane) - 1u));
        s_map[j] = (unsigned char)slot;
        sh.node[slot] = j;
      }
      off += __popc(bal);
    }
  }
  __syncthreads();
  return n;
}

// Rows [r0, r0 + nr): with local set, into the n-slot accumulators in
// shared memory (packed triangles la <= lb, then the rhs) and flushed;
// else term by term with global atomics.
__device__ __forceinline__ void add_segment(const int* __restrict__ idx,
                            const float* __restrict__ w,
                            const float* __restrict__ s2,
                            const float* __restrict__ y,
                            const float* __restrict__ delta, long long r0,
                            int nr, int K, int D, int n, bool local,
                            const unsigned char* s_map, MonoShared& sh,
                            float* __restrict__ B,
                            float* __restrict__ Bu, float* __restrict__ Bw) {
  const int tid = threadIdx.x;
  const size_t DD = (size_t)D * D;
  const int used = n * (n + 1) / 2;  // packed triangle entries
  float* s_acc = sh.acc;
  float* s_rhs = s_acc + 10 * used;
  if (local) {
    for (int e = tid; e < 10 * used + 6 * n; e += MONO_THREADS) s_acc[e] = 0.f;
    __syncthreads();
  }
  for (int t = tid; t < nr * K; t += MONO_THREADS) {
    const long long row = r0 + t / K;
    const int* ri = idx + row * K;
    const float* rw = w + row * K;
    int a = ri[t % K];
    if (a < 0 || a >= D) continue;
    float rs = sqrtf(fmaxf(s2[row], 0.f));
    float wsa = rs * rw[t % K];
    if (wsa == 0.f) continue;
    float mono[10], rhs[6];
    row_monomials(y, row, mono);
    row_rhs(y, delta, row, wsa, rs, rhs);
    int la = local ? s_map[a] : 0;
    for (int r = 0; r < K; ++r) {
      int b = ri[r];
      if (b < 0 || b >= D) continue;
      float wb = rs * rw[r];
      if (wb == 0.f) continue;  // adds nothing
      float p = wsa * wb;
      if (local) {
        int lb = s_map[b];
        if (la > lb) continue;  // the partner's own slot adds it
        float* dst = s_acc + lb * (lb + 1) / 2 + la;
#pragma unroll
        for (int m = 0; m < 10; ++m) atomicAdd(dst + m * used, p * mono[m]);
      } else {
        float* dst = B + (size_t)a * D + b;
#pragma unroll
        for (int m = 0; m < 10; ++m) atomicAdd(dst + m * DD, p * mono[m]);
      }
    }
    if (local) {
#pragma unroll
      for (int c = 0; c < 6; ++c) atomicAdd(s_rhs + 6 * la + c, rhs[c]);
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        atomicAdd(Bu + 3 * a + c, rhs[c]);
        atomicAdd(Bw + 3 * a + c, rhs[3 + c]);
      }
    }
  }
  if (!local) return;
  __syncthreads();
  // the nonzero entries, the off-diagonal ones mirrored
  for (int e = tid; e < 10 * used; e += MONO_THREADS) {
    float v = s_acc[e];
    if (v == 0.f) continue;
    int m = e / used, tri = e - m * used;
    int lb = (int)((sqrtf(8.f * tri + 1.f) - 1.f) * 0.5f);
    while (lb * (lb + 1) / 2 > tri) --lb;
    while ((lb + 1) * (lb + 2) / 2 <= tri) ++lb;
    int la = tri - lb * (lb + 1) / 2;
    int na = sh.node[la], nb = sh.node[lb];
    float* Bm = B + m * DD;
    atomicAdd(Bm + (size_t)na * D + nb, v);
    if (la != lb) atomicAdd(Bm + (size_t)nb * D + na, v);
  }
  for (int e = tid; e < 6 * n; e += MONO_THREADS) {
    float v = s_rhs[e];
    if (v == 0.f) continue;
    int la = e / 6, c = e - 6 * la;
    atomicAdd((c < 3 ? Bu : Bw) + 3 * sh.node[la] + c % 3, v);
  }
}

// One block per tile of MONO_ROWS rows. A segment of the tile with more
// than MONO_U distinct nodes is halved until it fits or is MONO_MIN_ROWS
// long or shorter; only such a short segment takes the global-atomic route.
// The next segment starts at the length the last one ended with.
__global__ void __launch_bounds__(MONO_THREADS)
    monomial_grams_kernel(const int* __restrict__ idx,
                          const float* __restrict__ w,
                          const float* __restrict__ s2,
                          const float* __restrict__ y,
                          const float* __restrict__ delta, int N, int K,
                          int D, float* __restrict__ B,
                          float* __restrict__ Bu, float* __restrict__ Bw) {
  extern __shared__ unsigned char s_map[];  // dynamic: the D-byte map
  __shared__ MonoShared sh;
  const long long end =
      min((long long)N, ((long long)blockIdx.x + 1) * MONO_ROWS);
  long long r0 = (long long)blockIdx.x * MONO_ROWS;
  int len = MONO_ROWS;
  while (r0 < end) {
    const int nr = (int)min((long long)len, end - r0);
    const int n = rank_segment(idx, w, s2, r0, nr, K, D, s_map, sh);
    if (n > MONO_U && nr > MONO_MIN_ROWS) {
      len = (nr + 1) / 2;
      continue;
    }
    add_segment(idx, w, s2, y, delta, r0, nr, K, D, n, n <= MONO_U, s_map,
                sh, B, Bu, Bw);
    __syncthreads();  // the next segment reuses the map and accumulators
    r0 += nr;
  }
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
  if (N > 0 && K > 0) {
    if ((size_t)D + sizeof(MonoShared) > DYNFU_MAX_SMEM)
      return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        monomial_grams_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, D);
    if (e != cudaSuccess) return (int)e;
    monomial_grams_kernel<<<dynfu_blocks(N, MONO_ROWS), MONO_THREADS,
                            (size_t)D, s>>>(idx, w, s2, y, delta, N, K, D, B,
                                            Bu, Bw);
  }
  return (int)cudaGetLastError();
}

// the kernel's tiling: rows per tile, local slots, shortest halved segment
DYNFU_API int dynfu_monomial_grams_tiling(int* rows_u_min) {
  rows_u_min[0] = MONO_ROWS;
  rows_u_min[1] = MONO_U;
  rows_u_min[2] = MONO_MIN_ROWS;
  return 0;
}
