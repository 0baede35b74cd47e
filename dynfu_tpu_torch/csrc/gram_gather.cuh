// The K-sparse Grams of the GN data term, summed in one fixed order: shared
// by the data Gram (gram.cu) and the monomial Grams (mono_gram.cu).
//
// Both Grams have the form G[m][i][j] = sum over rows n holding nodes i and
// j of t_m(n, i, j), with a right-hand side r[c][i] = sum over rows n
// holding i of u_c(n, i). Blocks run in no order on this card, so every
// entry is summed in an order fixed by the data, in float64, and rounded
// once to float32: the same bits on every launch, whatever the scheduling.
// Each Gram also has a partial mode that writes the float64 sums unrounded
// (the sharded solves add the ranks' partials in rank order, then round).
//
// Terms. Slot (n, r) is live where idx[n, r] is a node in [0, D) and its
// weight is nonzero (data Gram: s2[n] != 0 and w[n, r] != 0, weight w; the
// monomial Grams: weight sqrtf(max(s2[n], 0)) * w[n, r], a float32 product).
// A row's live slots holding one node are merged: v(n, j) is the float64
// sum of their weights in slot order. Then, with s = s2[n], p = v(n, i) *
// v(n, j) (a product that commutes, so G is symmetric term by term):
//   data Gram  t = s * p;            u_c = (s * v(n, i)) * delta[n, c]
//   monomials  t_m = p * mono_m(y);  u_c = (v(n, i) * rs) * (delta, y x delta)_c
// with mono = [1, yx, yy, yz, yx yx, yx yy, yx yz, yy yy, yy yz, yz yz] and
// the cross product formed in float64 from float32 y and delta.
//
// Order. Rows are cut into chunks of 32; node i's marked chunks are those
// with a row holding i. One block per node i; its nw warps take equal
// contiguous shares of i's marked chunks (by rank), each share is summed in
// order, starting at +0.0, and the shares are summed in warp order and
// rounded once; within a share the terms are added row by row.
// gram_cuda.gram_fixed_order models that order on the CPU; the kernels
// match it bit for bit.
//
// Two launches each. gg_mark_kernel sets bit c of node i's mask where
// chunk c has a row holding i (integer atomicOr: the same mask in any
// order). Then one block per node, whose warps walk their marked chunks in
// order, one lane per row.
//
// The data Gram (gg_row_kernel) keeps each warp's sums as a float64 row of
// D in shared memory: the lanes whose row holds i stage its terms, which
// are added row by row, a row's distinct nodes one lane each; one walk
// serves every neighbour.
//
// The monomial Grams (gg_gather_kernel) have ten sums per neighbour, too
// many for a row of D per warp. A warp collects the rows holding i into
// batches of 32. The first time a neighbour of i (a node sharing a row with it) is
// seen it gets the block's next column number (an integer atomic: only
// where a column's sum is kept depends on it, not its order). Lane q writes
// its row's terms into a dense 32 x 32 float64 tile in shared memory, row
// q, at its neighbours' columns (cells without a term hold -0.0, which
// adds nothing: x + -0.0 == x for every x); then lane c owns column c and
// adds its ten monomial terms down the tile's rows in order, in registers.
// Neighbours beyond 32 take further passes over the same rows.
//
// Bound: the bytes (idx, w, s2, delta, y read once, the Gram written once).
// Each row is read by the blocks of the nodes it holds (the monomial Grams:
// once per pass); what sets the time is the dependent loads of each warp's
// walk, not the bytes or the float64 adds.
#pragma once

#include "common.cuh"

#define GG_ROWS 32      // rows per chunk (one bit of a node's mask)

static inline long long gg_words(long long N) {  // mask words per node
  return (N + GG_ROWS * 32 - 1) / (GG_ROWS * 32);
}

// 32-bit words of scratch: the masks
static inline long long gg_scratch_words(long long N, int D) {
  return (long long)D * gg_words(N);
}

__device__ __forceinline__ bool gg_none(double v) {  // -0.0: no term
  return __double_as_longlong(v) == (long long)0x8000000000000000ULL;
}

// out[k] = value(0) + ... + value(k - 1) for k < n, by the whole block;
// returns the total. Ends with __syncthreads.
template <typename F>
__device__ __forceinline__ int gg_scan(F value, int n, int* out, int* s_part) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int k0 = min(n, (int)threadIdx.x * per), k1 = min(n, k0 + per);
  int sum = 0;
  for (int k = k0; k < k1; ++k) sum += value(k);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_part[warp] = incl;
  __syncthreads();
  int base = incl - sum, total = 0;
  for (int g = 0; g < (int)(blockDim.x >> 5); ++g) {
    if (g < warp) base += s_part[g];
    total += s_part[g];
  }
  for (int k = k0; k < k1; ++k) {
    out[k] = base;
    base += value(k);
  }
  __syncthreads();
  return total;
}

// One row's slots: node and weight (data Gram: w; monomials: rs * w), and
// which slots are live (bit r of `live`).
template <int K, bool MONO>
struct GGRow {
  int a[K];
  float ws[K];
  float s, rs;  // s2[n] and (monomials) sqrtf(max(s2[n], 0))
  unsigned live;

  __device__ __forceinline__ void load(const int* __restrict__ idx,
                                       const float* __restrict__ w,
                                       const float* __restrict__ s2,
                                       long long n, int D) {
    s = s2[n];
    rs = MONO ? sqrtf(fmaxf(s, 0.f)) : s;
    live = 0u;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      a[r] = idx[n * K + r];
      const float wr = w[n * K + r];
      ws[r] = MONO ? rs * wr : wr;
      const bool ok = a[r] >= 0 && a[r] < D &&
                      (MONO ? ws[r] != 0.f : (s != 0.f && ws[r] != 0.f));
      live |= (unsigned)ok << r;
    }
  }

  // whether node j has a live slot in this row
  __device__ __forceinline__ bool holds(int j) const {
    bool h = false;
#pragma unroll
    for (int r = 0; r < K; ++r) h = h || (((live >> r) & 1u) && a[r] == j);
    return h;
  }

  // bit r: slot r is the first live slot of its node
  __device__ __forceinline__ unsigned firsts() const {
    unsigned f = live;
#pragma unroll
    for (int r = 1; r < K; ++r)
#pragma unroll
      for (int r2 = 0; r2 < r; ++r2)
        if (((live >> r2) & 1u) && a[r2] == a[r]) f &= ~(1u << r);
    return f;
  }

  // the merged weight of the node of first slot r: its live slots' weights
  // summed in float64 in slot order
  __device__ __forceinline__ double merged(int r) const {
    double v = (double)ws[r];
#pragma unroll
    for (int r2 = 0; r2 < K; ++r2)
      if (r2 > r && ((live >> r2) & 1u) && a[r2] == a[r]) v += (double)ws[r2];
    return v;
  }
};

// bit c of node a's mask: chunk c has a row holding a live slot of a. One
// warp per chunk, one lane per row.
template <int K, bool MONO>
__global__ void gg_mark_kernel(const int* __restrict__ idx,
                               const float* __restrict__ w,
                               const float* __restrict__ s2, int N, int D,
                               int words, unsigned* __restrict__ bits) {
  const int lane = threadIdx.x & 31;
  const long long c = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (c * GG_ROWS >= N) return;  // uniform over the warp
  const long long n = c * GG_ROWS + lane;
  GGRow<K, MONO> row;
  const bool ok = n < N;
  row.live = 0u;
  if (ok) row.load(idx, w, s2, n, D);
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const bool live = (row.live >> r) & 1u;
    const int key = live ? row.a[r] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (live && lane == __ffs(peers) - 1)
      atomicOr(&bits[(long long)key * words + (c >> 5)], 1u << (c & 31));
  }
}

// shared memory of one monomial-Gram block: per warp the staged tile (32
// rows of 32 columns), the rows' rhs terms and monomials, whose space then
// holds the warp's sums handed to the block (float64); then the node's
// neighbour numbers, the neighbours, each warp's batch of row ids, the mask
// prefix, scan partials and the neighbour count
#define GG_ST 33  // doubles per staged tile row
#define GG_TILE (32 * GG_ST + 32 * 6)  // the tile and the rhs terms
#define GG_WARP_D (GG_TILE + 32 * 10 + 6)  // + monomials, or the sums
static inline size_t gg_smem(int D, long long words, int nw) {
  return sizeof(double) * (size_t)nw * GG_WARP_D +
         sizeof(int) * (2 * (size_t)D + 32 * (size_t)nw + (size_t)words + 1 +
                        32 + 1);
}

// warps per monomial-Gram block: as many as fit, since a node that holds
// many rows (an anchor's, with thousands) keeps its block, and the launch,
// busy longest
static inline int gg_warps(int D, long long words) {
  int nw = 16;
  while (nw > 1 && gg_smem(D, words, nw) > DYNFU_MAX_SMEM) nw >>= 1;
  return gg_smem(D, words, nw) <= DYNFU_MAX_SMEM ? nw : 0;
}

// One block per node i: B[m][i][:], Bu[i] and Bw[i] in the order described
// at the top (B is (10, D, D)). T = float rounds the float64 sums once; T =
// double writes them before that rounding (the partial Grams of a row
// range, which the sharded SE(3) solve adds over ranks in rank order, then
// rounds).
template <int K, typename T>
__global__ void gg_gather_kernel(const int* __restrict__ idx,
                                 const float* __restrict__ w,
                                 const float* __restrict__ s2,
                                 const float* __restrict__ y,
                                 const float* __restrict__ delta, int N,
                                 int D, int words,
                                 const unsigned* __restrict__ bits,
                                 T* __restrict__ G,
                                 T* __restrict__ rhs0,
                                 T* __restrict__ rhs1) {
  constexpr int C = 10, R = 6, ST = GG_ST;
  const unsigned full = 0xffffffffu;
  extern __shared__ double gg_sd[];
  const int i = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  double* st = gg_sd + (size_t)warp * GG_WARP_D;  // [32][ST]
  double* rh = st + 32 * ST;                      // [32][R]
  double* mo = rh + 32 * R;                       // [32][10]
  double* red = mo;  // [32][C], then [R]: the sums, once the tiles are added
  int* local = (int*)(gg_sd + (size_t)nw * GG_WARP_D);  // [D]
  int* node_of = local + D;                              // [D]
  int* brow = node_of + D + 32 * warp;                   // [32] this warp's
  int* wpre = node_of + D + 32 * nw;                     // [words + 1]
  int* s_part = wpre + words + 1;                        // [32]
  int* s_cnt = s_part + 32;                              // [1]
  const unsigned* mask = bits + (long long)i * words;
  const size_t DD = (size_t)D * D;

  for (int e = lane; e < 32 * ST; e += 32) st[e] = -0.0;
  for (int j = threadIdx.x; j < D; j += blockDim.x) local[j] = -1;
  if (threadIdx.x == 0) *s_cnt = 0;
  const int n_ch = gg_scan([&](int k) { return __popc(mask[k]); }, words,
                           wpre, s_part);
  const int k0 = (int)((long long)n_ch * warp / nw);
  const int k1 = (int)((long long)n_ch * (warp + 1) / nw);

  // the column of neighbour j in this pass, numbering it in the first
  auto column = [&](int j, bool first_pass) {
    if (first_pass && ((volatile int*)local)[j] == -1 &&
        atomicCAS(&local[j], -1, -2) == -1) {
      const int id = atomicAdd(s_cnt, 1);
      node_of[id] = j;
      atomicExch(&local[j], id);
    }
    int id;  // numbered in the first pass, perhaps by another warp
    while ((id = ((volatile int*)local)[j]) < 0) {
    }
    return id;
  };
  // the marked chunk of rank kk in node i's mask
  auto chunk_of = [&](int kk) {
    int lo = 0, hi = words;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (wpre[mid] <= kk) lo = mid; else hi = mid;
    }
    unsigned m = mask[lo];
    for (int s = kk - wpre[lo]; s > 0; --s) m &= m - 1;
    return (long long)lo * 32 + (__ffs(m) - 1);
  };

  for (int base = 0;; base += 32) {
    const bool first_pass = base == 0;
    double acc[C], racc = 0.0;
#pragma unroll
    for (int m = 0; m < C; ++m) acc[m] = 0.0;
    int batch = 0;

    // lane q < batch stages row brow[q] (holding i) into tile row q
    auto stage_rows = [&]() {
      if (lane < batch) {
        const long long n = brow[lane];
        GGRow<K, true> row;
        row.load(idx, w, s2, n, D);
        const unsigned f = row.firsts();
        double v[K], vi = 0.0;
#pragma unroll
        for (int r = 0; r < K; ++r) {
          v[r] = ((f >> r) & 1u) ? row.merged(r) : 0.0;
          if (((f >> r) & 1u) && row.a[r] == i) vi = v[r];
        }
#pragma unroll
        for (int r = 0; r < K; ++r) {
          if (!((f >> r) & 1u)) continue;
          const int lc = column(row.a[r], first_pass) - base;
          if (lc >= 0 && lc < 32) st[lane * ST + lc] = vi * v[r];
        }
        const double yx = y[3 * n], yy = y[3 * n + 1], yz = y[3 * n + 2];
        double* mq = mo + lane * 10;
        mq[0] = 1.0; mq[1] = yx; mq[2] = yy; mq[3] = yz;
        mq[4] = yx * yx; mq[5] = yx * yy; mq[6] = yx * yz;
        mq[7] = yy * yy; mq[8] = yy * yz; mq[9] = yz * yz;
        if (first_pass) {
          const double dx = delta[3 * n], dy = delta[3 * n + 1],
                       dz = delta[3 * n + 2];
          const double u = vi * (double)row.rs;
          double* rq = rh + lane * R;
          rq[0] = u * dx; rq[1] = u * dy; rq[2] = u * dz;
          rq[3] = u * (yy * dz - yz * dy);
          rq[4] = u * (yz * dx - yx * dz);
          rq[5] = u * (yx * dy - yy * dx);
        }
      }
      __syncwarp();
    };
    // lane c adds column c down the tile's rows, in order
    auto add_tile = [&]() {
#pragma unroll 4
      for (int q = 0; q < batch; ++q) {
        double* cell = st + q * ST + lane;
        const double pv = *cell;
#pragma unroll
        for (int m = 0; m < C; ++m) {
          const double v = pv * mo[q * 10 + m];
          acc[m] += gg_none(pv) ? -0.0 : v;
        }
        if (first_pass && lane < R) racc += rh[q * R + lane];
        *cell = -0.0;
      }
      __syncwarp();
      batch = 0;
    };

    // the rows of this warp's share of marked chunks, in order, one lane
    // per row, into batches of 32 (numbering their nodes in the first pass)
    for (int k = k0; k < k1; ++k) {
      const long long n = chunk_of(k) * GG_ROWS + lane;
      GGRow<K, true> row;
      row.live = 0u;
      if (n < N) row.load(idx, w, s2, n, D);
      const bool holds = row.holds(i);
      if (first_pass && holds) {
        const unsigned f = row.firsts();
#pragma unroll
        for (int r = 0; r < K; ++r)
          if ((f >> r) & 1u) column(row.a[r], true);
      }
      const unsigned has = __ballot_sync(full, holds);
      const int cnt = __popc(has);
      if (batch + cnt > 32) {
        stage_rows();
        add_tile();
      }
      if (holds) brow[batch + __popc(has & ((1u << lane) - 1u))] = (int)n;
      batch += cnt;
      __syncwarp();
    }
    stage_rows();
    add_tile();

#pragma unroll
    for (int m = 0; m < C; ++m) red[lane * C + m] = acc[m];
    if (first_pass && lane < R) red[32 * C + lane] = racc;
    __syncthreads();
    const int L = *(volatile int*)s_cnt;
    if (first_pass)  // no term: zero
      for (int j = threadIdx.x; j < D; j += blockDim.x)
        if (local[j] < 0)
#pragma unroll
          for (int m = 0; m < C; ++m) G[m * DD + (size_t)i * D + j] = (T)0;
    const int nl = min(32, L - base);
    for (int t = threadIdx.x; t < nl * C; t += blockDim.x) {
      const int lc = t / C, m = t - lc * C;
      const size_t off = GG_TILE + lc * C + m;
      double v = gg_sd[off];
      for (int g = 1; g < nw; ++g) v += gg_sd[(size_t)g * GG_WARP_D + off];
      G[m * DD + (size_t)i * D + node_of[base + lc]] = (T)v;
    }
    if (first_pass && threadIdx.x < R) {
      const size_t off = GG_TILE + 32 * C + threadIdx.x;
      double v = gg_sd[off];
      for (int g = 1; g < nw; ++g) v += gg_sd[(size_t)g * GG_WARP_D + off];
      const int cc = threadIdx.x;
      if (cc < 3)
        rhs0[3 * (size_t)i + cc] = (T)v;
      else
        rhs1[3 * (size_t)i + cc - 3] = (T)v;
    }
    __syncthreads();  // the sums are read before the next pass writes them
    if (base + 32 >= L) break;
  }
}

// shared memory of one data-Gram row block: per warp its running sums (a
// float64 row of D) and a chunk's staged terms and rhs terms (float64) and
// their columns; the mask prefix and scan partials
static inline size_t gg_row_smem(int D, long long words, int nw, int K) {
  return sizeof(double) * (size_t)nw * ((size_t)D + 32 * (size_t)K + 32 * 3) +
         sizeof(int) * ((size_t)nw * 32 * (size_t)K + (size_t)words + 1 + 32);
}

// warps per data-Gram row block: 8, fewer where the rows do not fit (sized
// for K = 8); more warps shorten a node's walk, fewer keep more blocks
// resident
static inline int gg_row_warps(int D, long long words) {
  int nw = 8;
  while (nw > 1 && gg_row_smem(D, words, nw, 8) > DYNFU_MAX_SMEM) nw >>= 1;
  return gg_row_smem(D, words, nw, 8) <= DYNFU_MAX_SMEM ? nw : 0;
}

// One block per node i: A[i][:] and b[i] of the data Gram, in the order at
// the top. Each warp keeps its share's sums as a float64 row of D in shared
// memory, so that every neighbour is summed in the one walk over the rows
// (no column numbering, no passes). It takes its chunks in order, one lane
// per row: the lanes whose row holds i stage its terms (by rank, so in row
// order), which are then added row by row, a row's K slots (its distinct
// nodes, merged) one lane each. T = float rounds the float64 sums once; T =
// double writes them before that rounding (the partial Gram of a row range,
// which the sharded solve adds over ranks in rank order, then rounds).
template <int K, typename T>
__global__ void gg_row_kernel(const int* __restrict__ idx,
                              const float* __restrict__ w,
                              const float* __restrict__ s2,
                              const float* __restrict__ delta, int N, int D,
                              int words, const unsigned* __restrict__ bits,
                              T* __restrict__ A, T* __restrict__ b) {
  const unsigned full = 0xffffffffu;
  extern __shared__ double gg_sd[];
  const int i = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const size_t WD = (size_t)D + 32 * K + 32 * 3;  // doubles a warp
  double* acc = gg_sd + warp * WD;  // [D] the share's sums
  double* ft = acc + D;             // [32][K] a chunk's terms
  double* fr = ft + 32 * K;         // [32][3] its rhs terms
  int* fc = (int*)(gg_sd + nw * WD) + warp * 32 * K;  // [32][K] columns
  int* wpre = (int*)(gg_sd + nw * WD) + nw * 32 * K;  // [words + 1]
  int* s_part = wpre + words + 1;                      // [32]
  const unsigned* mask = bits + (long long)i * words;

  for (int j = lane; j < D; j += 32) acc[j] = 0.0;
  const int n_ch = gg_scan([&](int k) { return __popc(mask[k]); }, words,
                           wpre, s_part);
  const int k0 = (int)((long long)n_ch * warp / nw);
  const int k1 = (int)((long long)n_ch * (warp + 1) / nw);
  double racc = 0.0;  // lanes 0-2: b[i][lane]

  long long my_c = 0;  // lane t: the marked chunk of rank k + t
  for (int k = k0; k < k1; ++k) {
    if (((k - k0) & 31) == 0 && k + lane < k1) {
      int lo = 0, hi = words;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (wpre[mid] <= k + lane) lo = mid; else hi = mid;
      }
      unsigned m = mask[lo];
      for (int t = k + lane - wpre[lo]; t > 0; --t) m &= m - 1;
      my_c = (long long)lo * 32 + (__ffs(m) - 1);
    }
    const long long n =
        __shfl_sync(full, my_c, (k - k0) & 31) * GG_ROWS + lane;
    GGRow<K, false> row;
    row.live = 0u;
    float dn[3] = {0.f, 0.f, 0.f};
    if (n < N) {
      row.load(idx, w, s2, n, D);
#pragma unroll
      for (int c = 0; c < 3; ++c) dn[c] = delta[3 * n + c];
    }
    const bool holds = row.holds(i);
    const unsigned has = __ballot_sync(full, holds);
    if (holds) {  // stage this row's terms at its rank among the holders
      const int q = __popc(has & ((1u << lane) - 1u));
      const unsigned f = row.firsts();
      double v[K], vi = 0.0;
#pragma unroll
      for (int r = 0; r < K; ++r) {
        v[r] = ((f >> r) & 1u) ? row.merged(r) : 0.0;
        if (((f >> r) & 1u) && row.a[r] == i) vi = v[r];
      }
      const double s = (double)row.s;
#pragma unroll
      for (int r = 0; r < K; ++r) {
        fc[q * K + r] = ((f >> r) & 1u) ? row.a[r] : -1;
        ft[q * K + r] = (vi * v[r]) * s;
      }
      const double u = vi * s;
#pragma unroll
      for (int c = 0; c < 3; ++c) fr[q * 3 + c] = u * (double)dn[c];
    }
    __syncwarp();
    for (int q = 0, cnt = __popc(has); q < cnt; ++q) {  // rows in order
      if (lane < K) {
        const int j = fc[q * K + lane];
        if (j >= 0) acc[j] += ft[q * K + lane];
      }
      if (lane < 3) racc += fr[q * 3 + lane];
      __syncwarp();
    }
  }
  if (lane < 3) fr[lane] = racc;  // this warp's rhs, for the block
  __syncthreads();
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    double v = gg_sd[j];
    for (int g = 1; g < nw; ++g) v += gg_sd[g * WD + j];
    A[(size_t)i * D + j] = (T)v;
  }
  if (threadIdx.x < 3) {
    const size_t off = (size_t)D + 32 * K + threadIdx.x;
    double v = gg_sd[off];
    for (int g = 1; g < nw; ++g) v += gg_sd[g * WD + off];
    b[3 * (size_t)i + threadIdx.x] = (T)v;
  }
}

// Both launches and the mask's memset on `s`. scratch: gg_scratch_words.
// T = double writes the float64 sums unrounded.
template <bool MONO, typename T = float>
static inline int gg_launch(const int* idx, const float* w, const float* s2,
                            const float* y, const float* delta, int N, int K,
                            int D, unsigned* scratch, T* G, T* rhs0,
                            T* rhs1, cudaStream_t s) {
  const long long words = gg_words(N);
  const int nw = MONO ? gg_warps(D, words) : gg_row_warps(D, words);
  if (D < 1 || nw == 0 || words > (1 << 30)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  if (words > 0)
    e = cudaMemsetAsync(scratch, 0, sizeof(unsigned) * (size_t)D * words, s);
  if (e != cudaSuccess) return (int)e;
  const long long chunks = (N + GG_ROWS - 1) / GG_ROWS;
  const size_t smem = MONO ? gg_smem(D, words, nw)
                           : gg_row_smem(D, words, nw, 8);
  DYNFU_DISPATCH_K(K, {
    if (chunks > 0)
      gg_mark_kernel<KK, MONO><<<dynfu_blocks(32 * chunks, 256), 256, 0, s>>>(
          idx, w, s2, N, D, (int)words, scratch);
    if constexpr (MONO) {
      e = dynfu_smem_limit<gg_gather_kernel<KK, T>>(smem);
      if (e != cudaSuccess) return (int)e;
      gg_gather_kernel<KK, T><<<D, 32 * nw, smem, s>>>(
          idx, w, s2, y, delta, N, D, (int)words, scratch, G, rhs0, rhs1);
    } else {
      e = dynfu_smem_limit<gg_row_kernel<KK, T>>(smem);
      if (e != cudaSuccess) return (int)e;
      gg_row_kernel<KK, T><<<D, 32 * nw, smem, s>>>(
          idx, w, s2, delta, N, D, (int)words, scratch, G, rhs0);
    }
  });
  return (int)cudaGetLastError();
}
