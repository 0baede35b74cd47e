// The slab sweep raycast: one thread per ray walks a stack of z-slabs.
//
// Replaces no Pallas kernel: the source's `raycast` and `raycast_separable`
// (dynfu_tpu/volume/tsdf.py:629-911) sweep all rays in lock-step through
// the slabs as an XLA loop (`_slab_sweep`), ~20 operations per slab over
// the whole image. Here one thread owns one ray (x fastest, so a warp's rays
// read neighbouring x of the same slab), walks the slabs in order with the
// state machine's carry in registers, stops at the ray's first event (a +/-
// crossing is a hit, a -/+ crossing ends the ray: nothing after the first
// event can change the result) and writes the hit's point and normal in the
// camera frame. Two sample modes: "general" (any ray towards +z, the
// source's `raycast`) and "separable" (an axis-aligned camera,
// `raycast_separable`, whose bilinear follows the source's one-hot matmuls:
// rows of the slab first, y then x). Slabs beyond the stack read +1.0, the
// source's padding. Every operation is the plain version's
// (volume/tsdf.py `_sampler`, `_slab_sweep`, `_sweep_outputs`) in its order;
// -fmad=false keeps each product and sum rounded on its own.
//
// Block mode (the sharded step, dist/spmd.py): the thread walks only the
// samples whose lower x plane lies in the block [lo, hi) (one run of slabs:
// a ray's x is monotonic in z) and writes a record of 16 words: the run's
// first event and its first and last samples (tsdf.SWEEP_FIELDS). The
// resolve kernel reads every block's record and finds each ray's first
// event over all blocks, a pair across two blocks judged from the one's
// last sample and the next's first, with the same device functions, so the
// result is the single card's bit for bit.
//
// Bound: device-memory bytes — the slab stack read once (103 x 512 x 512 x
// 2 B = 54 MB at 512^3) and the points and normals written (24 B a ray),
// ~0.018 ms at 3.35 TB/s for 640x480. A ray stops at its first event, so it
// reads the slabs up to its surface only; four float16 corners a sample.
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int kGeneral = 0;
constexpr int kSeparable = 1;
constexpr int kFields = 16;

struct Consts {
  int H, W, m, s_pad, X, Y, S, nx, x_off;
  float vsx, vsy, vsz, slab_dz;
};

// a ray: general, the origin and the unit direction (dz the source's
// safe_dz, 1 for a ray that does not run towards +z); separable, the
// camera's position and (qx, qy)
struct Ray {
  float ox, oy, oz, dx, dy, dz;
  bool fwd;
};

struct Sample {
  float f, gx, gy;
  bool valid;
};

__device__ __forceinline__ Ray make_ray(int mode, const float* geo,
                                        const float* rays, int p,
                                        const Consts& c) {
  Ray r;
  r.ox = geo[0];
  r.oy = geo[1];
  r.oz = geo[2];
  if (mode == kGeneral) {
    r.dx = rays[3 * p];
    r.dy = rays[3 * p + 1];
    float dz = rays[3 * p + 2];
    r.fwd = dz > 1e-6f;
    r.dz = r.fwd ? dz : 1.f;
  } else {
    r.dx = rays[p % c.W];
    r.dy = rays[c.W + p / c.W];
    r.dz = 1.f;
    r.fwd = true;
  }
  return r;
}

// floor(v) as an index clipped to [0, hi]; NaN -> 0 (tsdf._clip_index)
__device__ __forceinline__ int clip_floor(float v, int hi) {
  float fl = floorf(v);
  if (!(fl > 0.f)) return 0;
  if (fl >= (float)hi) return hi;
  return (int)fl;
}

// where slab g meets the ray: the lower corner (x0, y0), the bilinear
// weights (a, b) and the validity of the sample
struct Pos {
  int x0, y0;
  float a, b;
  bool valid;
};

__device__ __forceinline__ Pos position(int mode, int g, const Ray& r,
                                        const Consts& c) {
  float z = (float)(g * c.m) * c.vsz;
  float px, py;
  bool valid;
  if (mode == kGeneral) {
    float srel = (z - r.oz) / r.dz;
    px = (r.ox + r.dx * srel) / c.vsx;
    py = (r.oy + r.dy * srel) / c.vsy;
    valid = r.fwd && srel > 0.f && px >= 0.f &&
            px <= (float)((double)(c.X - 1) - 1e-4) && py >= 0.f &&
            py <= (float)((double)(c.Y - 1) - 1e-4);
  } else {
    float dzo = z - r.oz;
    px = (r.ox + r.dx * dzo) / c.vsx;
    py = (r.oy + r.dy * dzo) / c.vsy;
    valid = dzo > 0.f && px >= 0.f && px <= (float)(c.X - 1) && py >= 0.f &&
            py <= (float)(c.Y - 1);
  }
  Pos q;
  q.x0 = clip_floor(px, c.X - 2);
  q.y0 = clip_floor(py, c.Y - 2);
  q.a = fminf(fmaxf(px - (float)q.x0, 0.f), 1.f);
  q.b = fminf(fmaxf(py - (float)q.y0, 0.f), 1.f);
  q.valid = valid;
  return q;
}

__device__ __forceinline__ Sample bilinear(int mode, const __half* slabs,
                                           int g, const Pos& q,
                                           const Consts& c) {
  float f00 = 1.f, f01 = 1.f, f10 = 1.f, f11 = 1.f;
  if (g < c.S) {
    int xl = min(max(q.x0 - c.x_off, 0), c.nx - 2);
    const __half* row = slabs + ((long long)g * c.Y + q.y0) * c.nx + xl;
    f00 = __half2float(row[0]);
    f01 = __half2float(row[1]);
    f10 = __half2float(row[c.nx]);
    f11 = __half2float(row[c.nx + 1]);
  }
  float a = q.a, b = q.b;
  Sample s;
  if (mode == kGeneral) {
    s.f = (f00 * (1.f - a) + f01 * a) * (1.f - b) +
          (f10 * (1.f - a) + f11 * a) * b;
    s.gx = ((f01 - f00) * (1.f - b) + (f11 - f10) * b) / c.vsx;
    s.gy = ((f10 - f00) * (1.f - a) + (f11 - f01) * a) / c.vsy;
  } else {
    float gix = 1.f / c.vsx, giy = 1.f / c.vsy;
    float t0 = f00 * (1.f - a) + f01 * a;
    float t1 = f10 * (1.f - a) + f11 * a;
    s.f = (1.f - b) * t0 + b * t1;
    s.gx = (1.f - b) * (f00 * -gix + f01 * gix) +
           b * (f10 * -gix + f11 * gix);
    s.gy = t0 * -giy + t1 * giy;
  }
  s.valid = q.valid;
  if (!s.valid) s.f = 1.f;
  return s;
}

// tsdf._take: the crossing's fraction and the normal's components at it
__device__ __forceinline__ void take(const Sample& p, const Sample& s,
                                     float v[4]) {
  float fr = p.f / ((p.f - s.f) + 1e-30f);
  v[0] = fr;
  v[1] = p.gx * (1.f - fr) + s.gx * fr;
  v[2] = p.gy * (1.f - fr) + s.gy * fr;
  v[3] = s.f - p.f;
}

// 0: no event, 1: a +/- crossing (a hit), 2: a -/+ crossing (the ray ends)
__device__ __forceinline__ int event(const Sample& p, const Sample& s) {
  if (!(p.valid && s.valid)) return 0;
  if (p.f > 0.f && s.f < 0.f) return 1;
  if (p.f < 0.f && s.f > 0.f) return 2;
  return 0;
}

// tsdf._sweep_outputs and _sweep_points: the hit's point and normal in the
// camera frame, NaN unless hit with a nonzero, finite normal
__device__ __forceinline__ void finish(int mode, bool hit, int k_hit,
                                       const float v[4], const Ray& r,
                                       const float* geo, const Consts& c,
                                       float* pt, float* nm) {
  float z_star = ((float)k_hit + v[0]) * c.slab_dz;
  float gx = v[1], gy = v[2], gz = v[3] / c.slab_dz;
  float nn = sqrtf((gx * gx + gy * gy) + gz * gz);
  float den = nn > 0.f ? nn : 1.f;
  float n[3] = {gx / den, gy / den, gz / den};
  float sum = (n[0] + n[1]) + n[2];
  bool ok = hit && nn > 0.f && sum == sum;  // sum != sum: NaN
  if (!ok) {
    for (int i = 0; i < 3; ++i) pt[i] = nm[i] = CUDART_NAN_F;
    return;
  }
  if (mode == kGeneral) {
    float s_star = (z_star - r.oz) / r.dz;
    float dv[3] = {(r.ox + r.dx * s_star) - r.ox,
                   (r.oy + r.dy * s_star) - r.oy,
                   (r.oz + r.dz * s_star) - r.oz};
    // a ray with dz <= 1e-6 never hits, so r.dz is the ray's own here
    const float* R = geo + 3;  // v R: the camera frame
    for (int j = 0; j < 3; ++j) {
      pt[j] = (dv[0] * R[j] + dv[1] * R[3 + j]) + dv[2] * R[6 + j];
      nm[j] = (n[0] * R[j] + n[1] * R[3 + j]) + n[2] * R[6 + j];
    }
  } else {
    float dzo = z_star - r.oz;
    pt[0] = (r.ox + r.dx * dzo) - r.ox;
    pt[1] = (r.oy + r.dy * dzo) - r.oy;
    pt[2] = dzo;
    for (int j = 0; j < 3; ++j) nm[j] = n[j];
  }
}

template <int MODE>
__global__ void sweep_kernel(const __half* __restrict__ slabs,
                             const float* __restrict__ geo,
                             const float* __restrict__ rays, Consts c,
                             float* __restrict__ points,
                             float* __restrict__ normals) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= c.H * c.W) return;
  Ray r = make_ray(MODE, geo, rays, p, c);
  Sample prev = {1.f, 0.f, 0.f, false};
  bool hit = false;
  int k_hit = 0;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  for (int g = 0; g < c.s_pad; ++g) {
    Sample s = bilinear(MODE, slabs, g, position(MODE, g, r, c), c);
    int e = event(prev, s);
    if (e == 1) {
      hit = true;
      k_hit = g - 1;
      take(prev, s, v);
    }
    if (e) break;
    prev = s;
  }
  finish(MODE, hit, k_hit, v, r, geo, c, points + 3 * (long long)p,
         normals + 3 * (long long)p);
}

__device__ __forceinline__ void put_sample(int* rec, long long n, int g,
                                           const Sample& s) {
  rec[0] = g;
  rec[n] = __float_as_int(s.f);
  rec[2 * n] = __float_as_int(s.gx);
  rec[3 * n] = __float_as_int(s.gy);
  rec[4 * n] = s.valid ? 1 : 0;
}

__device__ __forceinline__ Sample get_sample(const int* rec, long long n) {
  return Sample{__int_as_float(rec[n]), __int_as_float(rec[2 * n]),
                __int_as_float(rec[3 * n]), rec[4 * n] != 0};
}

template <int MODE>
__global__ void sweep_block_kernel(const __half* __restrict__ slabs,
                                   const float* __restrict__ geo,
                                   const float* __restrict__ rays, Consts c,
                                   int lo, int hi, int* __restrict__ record) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  long long n = (long long)c.H * c.W;
  if (p >= n) return;
  Ray r = make_ray(MODE, geo, rays, p, c);
  const int none = c.s_pad + 1;
  int ev_g = none, first_g = -1, last_g = -1;
  bool ev_cross = false;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  Sample first = {0.f, 0.f, 0.f, false}, last = first;
  for (int g = 0; g < c.s_pad; ++g) {
    Pos q = position(MODE, g, r, c);
    if (q.x0 < lo || q.x0 >= hi) {
      if (first_g >= 0) break;  // the block's run of samples has ended
      continue;
    }
    Sample s = bilinear(MODE, slabs, g, q, c);
    if (first_g < 0) {
      first_g = g;
      first = s;
    } else if (ev_g == none) {
      int e = event(last, s);
      if (e) {
        ev_g = g;
        ev_cross = e == 1;
        take(last, s, v);
      }
    }
    last = s;
    last_g = g;
  }
  int* rec = record + p;
  rec[0] = ev_g;
  rec[n] = ev_cross ? 1 : 0;
  for (int i = 0; i < 4; ++i) rec[(2 + i) * n] = __float_as_int(v[i]);
  put_sample(rec + 6 * n, n, first_g, first);
  put_sample(rec + 11 * n, n, last_g, last);
}

__global__ void resolve_kernel(int mode, const int* __restrict__ every,
                               int world, const float* __restrict__ geo,
                               const float* __restrict__ rays, Consts c,
                               float* __restrict__ points,
                               float* __restrict__ normals,
                               bool* __restrict__ straddle) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  long long n = (long long)c.H * c.W;
  if (p >= n) return;
  const int none = c.s_pad + 1;
  const long long stride = kFields * n;  // one block's record
  int best = none;
  bool cross = false, across = false;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r = 0; r < world; ++r) {
    const int* rec = every + r * stride + p;
    if (rec[0] < best) {  // the block's own first event
      best = rec[0];
      cross = rec[n] != 0;
      across = false;
      for (int i = 0; i < 4; ++i) v[i] = __int_as_float(rec[(2 + i) * n]);
    }
    int last_g = rec[11 * n];
    if (last_g < 0) continue;
    for (int q = 0; q < world; ++q) {  // the block that starts after r
      const int* nxt = every + q * stride + p;
      if (q == r || nxt[6 * n] != last_g + 1) continue;
      Sample pv = get_sample(rec + 11 * n, n);
      Sample cur = get_sample(nxt + 6 * n, n);
      int e = event(pv, cur);
      if (e && last_g + 1 < best) {
        best = last_g + 1;
        cross = e == 1;
        across = true;
        take(pv, cur, v);
      }
    }
  }
  bool hit = best < none && cross;
  straddle[p] = hit && across;
  Ray ray = make_ray(mode, geo, rays, p, c);
  finish(mode, hit, hit ? best - 1 : 0, v, ray, geo, c,
         points + 3 * (long long)p, normals + 3 * (long long)p);
}

Consts consts(int H, int W, int m, int s_pad, int X, int Y, int S, int nx,
              int x_off, float vsx, float vsy, float vsz, float slab_dz) {
  Consts c;
  c.H = H;
  c.W = W;
  c.m = m;
  c.s_pad = s_pad;
  c.X = X;
  c.Y = Y;
  c.S = S;
  c.nx = nx;
  c.x_off = x_off;
  c.vsx = vsx;
  c.vsy = vsy;
  c.vsz = vsz;
  c.slab_dz = slab_dz;
  return c;
}

}  // namespace

DYNFU_API int dynfu_slab_sweep(const void* slabs, int S, int nx,
                               const float* geo, const float* rays, int mode,
                               int H, int W, int m, int s_pad, int X, int Y,
                               float vsx, float vsy, float vsz, float slab_dz,
                               int x_off, int lo, int hi, int block,
                               float* points, float* normals, int* record,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((mode != kGeneral && mode != kSeparable) || H * W < 1)
    return (int)cudaErrorInvalidValue;
  Consts c = consts(H, W, m, s_pad, X, Y, S, nx, x_off, vsx, vsy, vsz,
                    slab_dz);
  const __half* sl = (const __half*)slabs;
  const int T = 128;
  int blocks = dynfu_blocks((long long)H * W, T);
  if (block) {
    if (mode == kGeneral)
      sweep_block_kernel<kGeneral><<<blocks, T, 0, st>>>(sl, geo, rays, c,
                                                         lo, hi, record);
    else
      sweep_block_kernel<kSeparable><<<blocks, T, 0, st>>>(sl, geo, rays, c,
                                                           lo, hi, record);
  } else if (mode == kGeneral) {
    sweep_kernel<kGeneral><<<blocks, T, 0, st>>>(sl, geo, rays, c, points,
                                                 normals);
  } else {
    sweep_kernel<kSeparable><<<blocks, T, 0, st>>>(sl, geo, rays, c, points,
                                                   normals);
  }
  return (int)cudaGetLastError();
}

DYNFU_API int dynfu_sweep_resolve(const int* every, int world,
                                  const float* geo, const float* rays,
                                  int mode, int H, int W, int m, int s_pad,
                                  int X, int Y, float vsx, float vsy,
                                  float vsz, float slab_dz, float* points,
                                  float* normals, bool* straddle,
                                  void* stream) {
  if ((mode != kGeneral && mode != kSeparable) || H * W < 1 || world < 1)
    return (int)cudaErrorInvalidValue;
  Consts c = consts(H, W, m, s_pad, X, Y, 0, 2, 0, vsx, vsy, vsz, slab_dz);
  const int T = 128;
  resolve_kernel<<<dynfu_blocks((long long)H * W, T), T, 0,
                   (cudaStream_t)stream>>>(mode, every, world, geo, rays, c,
                                           points, normals, straddle);
  return (int)cudaGetLastError();
}
