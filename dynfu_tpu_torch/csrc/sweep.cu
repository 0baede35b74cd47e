// The slab sweep raycast: one thread per ray walks a stack of z-slabs.
//
// Replaces no Pallas kernel: the source's `raycast` and `raycast_separable`
// (dynfu_tpu/volume/tsdf.py:629-911) sweep all rays in lock-step through
// the slabs as an XLA loop (`_slab_sweep`), ~20 operations per slab over
// the whole image. Here one thread owns one ray and finds the ray's first
// event (a +/- crossing is a hit, a -/+ crossing ends the ray: nothing after
// the first event can change the result), then writes the hit's point and
// normal in the camera frame. Two sample modes: "general" (any ray towards
// +z, the source's `raycast`) and "separable" (an axis-aligned camera,
// `raycast_separable`, whose bilinear follows the source's one-hot matmuls:
// rows of the slab first, y then x). Slabs beyond the stack read +1.0, the
// source's padding. Every operation is the plain version's (volume/tsdf.py
// `_sampler`, `_slab_sweep`, `_sweep_outputs`) in its order; -fmad=false
// keeps each product and sum rounded on its own.
//
// What the ray walks. A sample's position is monotone in the slab index g:
// z, the ray parameter and px, py are chains of correctly rounded
// operations, each monotone. So the samples that can be valid form one run
// of slabs; the ray walks a span that holds it (the first slab ahead of the
// origin, exactly; the x and y bounds from the positions' real-valued
// lines with a margin far above their rounding), tests each sample's
// validity exactly, and a ray whose span is empty samples nothing. Inside
// it, the brick sign summary (slab_stack.cu, tsdf.BRICK) lets the ray skip:
// a bilinear of four float16 corners that are all >= 0 is never negative in
// float32 (each term is a product of non-negative numbers), an invalid
// sample reads 1.0, and an event needs a negative sample, so no pair of
// samples in bricks the summary marks is an event. The ray alternates a
// scan over brick layers (kBG slabs) with a run of samples: where every
// brick a layer's sample corners can reach is marked (the corner is
// monotone in g, so estimates at the layer's two ends, widened by a voxel,
// bound it), the layer costs one check, and a sample only for a marked
// run's first slab where the slab before was sampled (that pair can end
// the ray); an unmarked layer's samples, and the carry before them where
// that was skipped, make the next run. A warp's lanes take one sample a
// step each, whatever their runs, so that they sample together. Warps take
// tiles of 32 rays from a counter until none is left (a ray's work varies
// with its surface), and each block computes the slabs' ray-independent z
// - oz once in shared memory; the summary (13 KB at 512^3) is read where it
// lies, through the read-only cache.
//
// Block mode (the sharded step, dist/spmd.py): the thread's samples are the
// ones whose lower x plane lies in the block [lo, hi) (one run: x is
// monotonic in g), its ends found exactly (an estimate, then exact tests),
// and it writes a record of 16 words: the run's first event and its first
// and last samples (tsdf.SWEEP_FIELDS), the event found as above.
// The resolve kernel reads every block's record and finds each ray's first
// event over all blocks, a pair across two blocks judged from the one's
// last sample and the next's first, with the same device functions, so the
// result is the single card's bit for bit.
//
// With a work buffer, each ray also writes what it did (kWork int32 a ray:
// samples computed, brick layers checked, bricks skipped, samples skipped,
// an empty span, and the samples the one-slab-at-a-time walk took); the
// counting is an instantiation of its own (WORK), so a launch without the
// buffer carries none of it.
//
// Bound: device-memory bytes — the summary, rays and pose read once, the
// points and normals written once (24 B a ray), and the stack's sectors
// that the samples deciding each ray's outcome read (its event's pair of
// samples): given the summary, a ray in marked bricks reads no slab.
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int kGeneral = 0;
constexpr int kSeparable = 1;
constexpr int kFields = 16;
// the sign summary's brick (tsdf.BRICK): slabs, rows, x planes
constexpr int kBG = 4, kBY = 8, kBX = 8;
constexpr int kWork = 6;
constexpr int kThreads = 128;

struct Consts {
  int H, W, m, s_pad, X, Y, S, nx, x_off;
  float vsx, vsy, vsz, slab_dz;
  float xmax, ymax;  // the validity test's upper bounds on px and py
  float rx, ry;      // 1 / vsx, 1 / vsy (estimates only)
  int nyb, nbytes;   // the summary's brick rows, bytes a row (8 bricks each)
};

// a ray: general, the origin and the unit direction (dz the source's
// safe_dz, 1 for a ray that does not run towards +z); separable, the
// camera's position and (qx, qy). inc_x: px does not fall with g; finite:
// every component is finite (else the walk takes every slab in order)
struct Ray {
  float ox, oy, oz, dx, dy, dz;
  bool fwd, inc_x, finite;
};

struct Sample {
  float f, gx, gy;
  bool valid;
};

__device__ __forceinline__ Ray make_ray(int mode, const float* geo,
                                        const float* rays, long long p,
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
  r.inc_x = !(r.dx < 0.f);
  r.finite = isfinite(r.ox) && isfinite(r.oy) && isfinite(r.oz) &&
             isfinite(r.dx) && isfinite(r.dy) && isfinite(r.dz);
  return r;
}

// floor(v) as an index clipped to [0, hi]; NaN -> 0 (tsdf._clip_index)
__device__ __forceinline__ int clip_floor(float v, int hi) {
  float fl = floorf(v);
  if (!(fl > 0.f)) return 0;
  if (fl >= (float)hi) return hi;
  return (int)fl;
}

// where the slab with z - oz = zo meets the ray: the ray parameter (srel,
// or dzo in separable mode) and the voxel coordinates
struct Place {
  float t, px, py;
};

__device__ __forceinline__ Place place(int mode, float zo, const Ray& r,
                                       const Consts& c) {
  Place q;
  q.t = mode == kGeneral ? zo / r.dz : zo;
  q.px = (r.ox + r.dx * q.t) / c.vsx;
  q.py = (r.oy + r.dy * q.t) / c.vsy;
  return q;
}

__device__ __forceinline__ bool valid_at(const Place& q, const Ray& r,
                                         const Consts& c) {
  return r.fwd && q.t > 0.f && q.px >= 0.f && q.px <= c.xmax &&
         q.py >= 0.f && q.py <= c.ymax;
}

// the sample's lower corner (x0, y0), bilinear weights and validity
struct Pos {
  int x0, y0;
  float a, b;
  bool valid;
};

__device__ __forceinline__ Pos locate(const Place& q, const Ray& r,
                                      const Consts& c) {
  Pos p;
  p.x0 = clip_floor(q.px, c.X - 2);
  p.y0 = clip_floor(q.py, c.Y - 2);
  p.a = fminf(fmaxf(q.px - (float)p.x0, 0.f), 1.f);
  p.b = fminf(fmaxf(q.py - (float)p.y0, 0.f), 1.f);
  p.valid = valid_at(q, r, c);
  return p;
}

// the stack's plane of the lower corner (the block's own index)
__device__ __forceinline__ int local_x(int x0, const Consts& c) {
  return min(max(x0 - c.x_off, 0), c.nx - 2);
}

struct Corners {
  float f00, f01, f10, f11;
};

__device__ __forceinline__ Corners fetch(const __half* slabs, int g,
                                         const Pos& q, const Consts& c) {
  Corners k = {1.f, 1.f, 1.f, 1.f};
  if (g < c.S) {
    const __half* row =
        slabs + ((long long)g * c.Y + q.y0) * c.nx + local_x(q.x0, c);
    k.f00 = __half2float(row[0]);
    k.f01 = __half2float(row[1]);
    k.f10 = __half2float(row[c.nx]);
    k.f11 = __half2float(row[c.nx + 1]);
  }
  return k;
}

__device__ __forceinline__ Sample combine(int mode, const Corners& k,
                                          const Pos& q, const Consts& c) {
  float f00 = k.f00, f01 = k.f01, f10 = k.f10, f11 = k.f11;
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

// what a ray did, with a work buffer (kWork fields)
struct Work {
  int samples, layers, bricks, skipped, empty, single;
};

// the slack of the walk's ends, in voxels: far above the rounding of a
// position (~1e-3 voxel for a camera within 1000 voxels of the volume)
constexpr double kSlack = 0.05;
// the largest term, in voxels, of a corner estimate the skip relies on
constexpr float kReach = 16384.f;

// One ray's walk over its slabs: the table of z - oz, the stack, the
// summary; with WORK, counts into the Work.
template <int MODE, bool WORK>
struct Walker {
  const __half* slabs;
  const unsigned char* summary;
  const float* zo;
  Ray r;
  const Consts& c;
  Work* w;

  __device__ __forceinline__ Place at(int g) const {
    return place(MODE, zo[g], r, c);
  }

  __device__ __forceinline__ Sample sample(int g) const {
    if (WORK) ++w->samples;
    Pos p = locate(at(g), r, c);
    return combine(MODE, fetch(slabs, g, p, c), p, c);
  }

  // the first slab of [0, s_pad] where `rises` holds (it holds on a suffix),
  // from the estimate e
  template <class P>
  __device__ __forceinline__ int first_of(P rises, float e) const {
    const int G = c.s_pad;
    int g = (int)fminf(fmaxf(floorf(e), 0.f), (float)G);
    if (g < G && rises(g)) {
      while (g > 0 && rises(g - 1)) --g;
    } else {
      while (g < G && !rises(g)) ++g;
    }
    return g;
  }

  // the last slab of [-1, s_pad) where `falls` holds (on a prefix)
  template <class P>
  __device__ __forceinline__ int last_of(P falls, float e) const {
    const int G = c.s_pad;
    int g = (int)fminf(fmaxf(ceilf(e), -1.f), (float)(G - 1));
    if (g >= 0 && falls(g)) {
      while (g < G - 1 && falls(g + 1)) ++g;
    } else {
      while (g >= 0 && !falls(g)) --g;
    }
    return g;
  }

  // the slab (real-valued) where the ray's voxel coordinate along an axis
  // (origin o, direction d, voxel v) is p, in double precision
  __device__ __forceinline__ double slab_at(double p, float o, float d,
                                            float v) const {
    return ((double)r.oz + (p * v - o) * (double)r.dz / d) /
           ((double)c.m * c.vsz);
  }

  // [v0, v1] holding every slab whose sample can be valid: the exact first
  // slab ahead of the origin (zo rises with g), and the slabs where the
  // voxel coordinates lie within kSlack of [0, max] by the positions'
  // real-valued lines, widened by a slab at each end. Samples in it are
  // tested exactly; outside it none is valid.
  __device__ __forceinline__ void valid_span(int& v0, int& v1) const {
    const int G = c.s_pad;
    v0 = 0;
    v1 = G - 1;
    if (!r.fwd) {
      v1 = -1;
      return;
    }
    if (!r.finite) return;
    int lo = 0, hi = G;  // the first slab with zo > 0, by bisection
    while (lo < hi) {
      int mid = (lo + hi) / 2;
      if (zo[mid] > 0.f) hi = mid; else lo = mid + 1;
    }
    double g_lo = (double)lo, g_hi = (double)(G - 1);
    const float o[2] = {r.ox, r.oy}, d[2] = {r.dx, r.dy};
    const float v[2] = {c.vsx, c.vsy}, top[2] = {c.xmax, c.ymax};
    for (int i = 0; i < 2; ++i) {
      if (d[i] == 0.f) {  // a constant coordinate: its own test
        float p = o[i] / v[i];
        if (!(p >= 0.f && p <= top[i])) v1 = -1;
        continue;
      }
      double ga = slab_at(-kSlack, o[i], d[i], v[i]);
      double gb = slab_at((double)top[i] + kSlack, o[i], d[i], v[i]);
      g_lo = fmax(g_lo, fmin(ga, gb) - 1.0);
      g_hi = fmin(g_hi, fmax(ga, gb) + 1.0);
    }
    if (v1 < 0) return;
    v0 = (int)fmin(fmax(floor(g_lo), 0.0), (double)G);
    v1 = (int)fmin(fmax(ceil(g_hi), -1.0), (double)(G - 1));
  }

  // the run of slabs whose lower x plane lies in [lo, hi): [o0, o1], exact
  __device__ __forceinline__ void block_run(int lo, int hi, int& o0,
                                            int& o1) const {
    const int G = c.s_pad;
    auto x0_at = [&](int g) { return clip_floor(at(g).px, c.X - 2); };
    if (!r.finite) {  // the first run, slab by slab
      o0 = 0;
      while (o0 < G && !(x0_at(o0) >= lo && x0_at(o0) < hi)) ++o0;
      o1 = o0 - 1;
      while (o1 + 1 < G && x0_at(o1 + 1) >= lo && x0_at(o1 + 1) < hi) ++o1;
      return;
    }
    float e_lo = 0.f, e_hi = (float)G;
    if (r.dx != 0.f) {
      float ga = (float)slab_at(lo, r.ox, r.dx, c.vsx);
      float gb = (float)slab_at(hi, r.ox, r.dx, c.vsx);
      e_lo = fminf(ga, gb);
      e_hi = fmaxf(ga, gb);
    }
    if (r.inc_x) {
      o0 = first_of([&](int g) { return x0_at(g) >= lo; }, e_lo);
      o1 = last_of([&](int g) { return x0_at(g) < hi; }, e_hi);
    } else {
      o0 = first_of([&](int g) { return x0_at(g) < hi; }, e_lo);
      o1 = last_of([&](int g) { return x0_at(g) >= lo; }, e_hi);
    }
  }

  // A sample's voxel coordinates estimated as lines in z - oz, px ~ ex0 +
  // ex1 zo and py ~ ey0 + ey1 zo (a multiply-add where a sample divides):
  // within ~1e-3 voxel of the exact ones while their terms stay under
  // kReach voxels, so that the lower corner of every sample lies within a
  // voxel of the estimate's. The corner is monotone in g, so the estimates
  // at a layer's two ends, widened by a voxel, bound its samples' corners.
  float ex0, ex1, ey0, ey1;

  __device__ __forceinline__ void lines() {
    const float rdz = MODE == kGeneral ? 1.f / r.dz : 1.f;
    ex0 = r.ox * c.rx;
    ex1 = (r.dx * rdz) * c.rx;
    ey0 = r.oy * c.ry;
    ey1 = (r.dy * rdz) * c.ry;
  }

  // whether the estimates can bound the corners: a finite ray whose
  // terms stay under kReach voxels at every slab
  __device__ __forceinline__ bool estimable() const {
    const float zmax = fmaxf(fabsf(zo[0]), fabsf(zo[c.s_pad - 1]));
    return r.finite && fabsf(ex0) < kReach && fabsf(ey0) < kReach &&
           fabsf(ex1) * zmax < kReach && fabsf(ey1) * zmax < kReach;
  }

  // the estimated lower corner (stack plane, row) of slab g's sample
  __device__ __forceinline__ void corner(int g, int& x, int& y) const {
    const float z = zo[g];
    x = clip_floor(ex0 + ex1 * z, c.X - 2);
    y = clip_floor(ey0 + ey1 * z, c.Y - 2);
  }

  // whether every brick of layer l that a lower corner between the
  // estimates (xa, ya) and (xb, yb), widened by a voxel, can lie in is
  // marked: no value its samples read is < 0
  __device__ __forceinline__ bool marked(int l, int xa, int ya, int xb,
                                         int yb) const {
    const int x0 = local_x(min(xa, xb) - 1, c) / kBX;
    const int x1 = local_x(max(xa, xb) + 1, c) / kBX;
    const int y0 = max(min(ya, yb) - 1, 0) / kBY;
    const int y1 = min(max(ya, yb) + 1, c.Y - 2) / kBY;
    for (int y = y0; y <= y1; ++y) {
      const unsigned char* row =
          summary + ((long long)l * c.nyb + y) * c.nbytes;
      for (int x = x0; x <= x1; x = (x | 7) + 1) {
        const int hi = min(x1, x | 7);
        const int mask = (2 << (hi & 7)) - (1 << (x & 7));
        if ((__ldg(row + (x >> 3)) & mask) != mask) return false;
      }
    }
    if (WORK) w->bricks += (y1 - y0 + 1) * (x1 - x0 + 1);
    return true;
  }

  // The next run of slabs to sample, from brick layer `layer` on: over the
  // layers the summary marks one check a layer and no sample, but for a
  // marked run's first slab where the slab before it was sampled (that
  // pair can end the ray); then the first unmarked layer's slabs, with the
  // carry before them where that was skipped. Returns false when no layer
  // is left.
  __device__ __forceinline__ bool plan(int w0, int w1, int have, bool skip,
                                       int& layer, int& r0, int& r1) const {
    const int L1 = w1 / kBG;
    int L = layer;
    if (L > L1) return false;
    int a = max(w0, L * kBG);
    if (skip) {
      int M = L, xa, ya;
      corner(a, xa, ya);
      while (M <= L1 && M * kBG < c.S) {
        int xb, yb;
        corner(min(w1, M * kBG + kBG - 1), xb, yb);
        if (WORK) ++w->layers;
        if (!marked(M, xa, ya, xb, yb)) break;
        xa = xb;
        ya = yb;
        ++M;
      }
      if (M > L) {
        const bool first = have == a - 1 && a > w0;
        if (WORK) w->skipped += min(w1, M * kBG - 1) - a + 1 - first;
        if (first) {
          layer = M;
          r0 = r1 = a;
          return true;
        }
        if (M > L1) return false;
        L = M;
        a = L * kBG;
      }
    }
    r0 = a > w0 && have != a - 1 ? a - 1 : a;
    r1 = min(w1, L * kBG + kBG - 1);
    layer = L + 1;
    return true;
  }

  // The first event among the pairs of slabs [w0, w1] (the sample before
  // w0 taken as invalid): its slab (the pair's second sample; `none` if
  // none), its kind and its values (take). Every lane of the warp calls
  // it (an idle lane with an empty span). The ray samples the runs that
  // `plan` gives, one sample a step, so that the warp's lanes sample
  // together whatever their runs; a pair is judged where its first sample
  // is the slab before (a carry's pair lies in marked bricks).
  __device__ void first_event(int w0, int w1, int none, int& ev_g,
                              int& kind, float v[4]) {
    lines();
    const bool skip = estimable();
    Sample prev = {1.f, 0.f, 0.f, false};
    int have = w0 - 1;  // the slab `prev` holds (w0 - 1: none, invalid)
    ev_g = none;
    kind = 0;
    bool live = w0 <= w1;
    int layer = w0 / kBG, g = 0, r1 = -1;
    for (;;) {
      if (live && g > r1) live = plan(w0, w1, have, skip, layer, g, r1);
      if (!__any_sync(0xffffffffu, live)) return;
      if (!live) continue;
      Sample s = sample(g);
      if (have == g - 1) {
        int e = event(prev, s);
        if (e) {
          ev_g = g;
          kind = e;
          take(prev, s, v);
          live = false;
        }
      }
      prev = s;
      have = g++;
    }
  }
};

// the largest table of z - oz a block holds in shared memory (slabs)
constexpr int kMaxSlabs = 4096;

// once a block: the slabs' z - oz (the same operations as a sample's:
// (float)(g m) vz, then minus the origin's z)
__device__ __forceinline__ void block_table(float* zo, const float* geo,
                                            const Consts& c) {
  for (int g = threadIdx.x; g < c.s_pad; g += blockDim.x)
    zo[g] = (float)(g * c.m) * c.vsz - geo[2];
  __syncthreads();
}

// the next tile of 32 rays for this warp (n or more: none left)
__device__ __forceinline__ long long next_tile(int* counter) {
  int base = 0;
  if ((threadIdx.x & 31) == 0) base = atomicAdd(counter, 32);
  return __shfl_sync(0xffffffffu, base, 0);
}

__device__ __forceinline__ void put_work(int* work, long long n,
                                         long long p, const Work& w) {
  const int f[kWork] = {w.samples, w.layers, w.bricks,
                        w.skipped, w.empty,   w.single};
  for (int i = 0; i < kWork; ++i) work[i * n + p] = f[i];
}

// at most 80 registers a thread, six blocks an SM: measured no slower on
// the H100 than the unbounded 96
template <int MODE, bool WORK>
__global__ void __launch_bounds__(kThreads, 6)
    sweep_kernel(const __half* __restrict__ slabs,
                 const unsigned char* __restrict__ summary,
                 const float* __restrict__ geo,
                 const float* __restrict__ rays, Consts c,
                 int* __restrict__ counter, float* __restrict__ points,
                 float* __restrict__ normals, int* __restrict__ work) {
  extern __shared__ float zo[];
  block_table(zo, geo, c);
  const long long n = (long long)c.H * c.W;
  for (long long base = next_tile(counter); base < n;
       base = next_tile(counter)) {
    const long long p = base + (threadIdx.x & 31);
    const bool idle = p >= n;  // walks an empty span with the warp
    Work wk = {};
    Walker<MODE, WORK> wr = {slabs, summary, zo,
                             make_ray(MODE, geo, rays, idle ? n - 1 : p, c),
                             c, &wk};
    int v0 = 0, v1 = -1;
    if (!idle) wr.valid_span(v0, v1);
    int ev_g, kind;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    // a sample beyond the stack reads +1: no hit there, and the first
    // such one's pair is the last that can end the ray
    wr.first_event(v0, min(v1, c.S), c.s_pad + 1, ev_g, kind, v);
    if (idle) continue;
    const bool hit = kind == 1;
    finish(MODE, hit, hit ? ev_g - 1 : 0, v, wr.r, geo, c,
           points + 3 * p, normals + 3 * p);
    if (WORK) {
      wk.empty = v0 > min(v1, c.S);
      wk.single = kind ? ev_g + 1 : c.s_pad;
      put_work(work, n, p, wk);
    }
  }
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

template <int MODE, bool WORK>
__global__ void __launch_bounds__(kThreads)
    sweep_block_kernel(const __half* __restrict__ slabs,
                       const unsigned char* __restrict__ summary,
                       const float* __restrict__ geo,
                       const float* __restrict__ rays, Consts c, int lo,
                       int hi, int* __restrict__ counter,
                       int* __restrict__ record, int* __restrict__ work) {
  extern __shared__ float zo[];
  block_table(zo, geo, c);
  const long long n = (long long)c.H * c.W;
  const int none = c.s_pad + 1;
  for (long long base = next_tile(counter); base < n;
       base = next_tile(counter)) {
    const long long p = base + (threadIdx.x & 31);
    const bool idle = p >= n;  // walks an empty span with the warp
    Work wk = {};
    Walker<MODE, WORK> wr = {slabs, summary, zo,
                             make_ray(MODE, geo, rays, idle ? n - 1 : p, c),
                             c, &wk};
    int o0 = 0, o1 = -1;
    if (!idle) wr.block_run(lo, hi, o0, o1);
    int ev_g = none, kind = 0, first_g = -1, last_g = -1;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    Sample first = {0.f, 0.f, 0.f, false}, last = first;
    int w0 = 0, w1 = -1;
    if (o0 <= o1) {
      first_g = o0;
      last_g = o1;
      first = wr.sample(o0);
      last = o1 == o0 ? first : wr.sample(o1);
      int v0, v1;
      wr.valid_span(v0, v1);
      w0 = max(o0, v0);
      w1 = min(min(o1, v1), c.S);
    }
    wr.first_event(w0, w1, none, ev_g, kind, v);
    if (idle) continue;
    int* rec = record + p;
    rec[0] = ev_g;
    rec[n] = kind == 1 ? 1 : 0;
    for (int i = 0; i < 4; ++i) rec[(2 + i) * n] = __float_as_int(v[i]);
    put_sample(rec + 6 * n, n, first_g, first);
    put_sample(rec + 11 * n, n, last_g, last);
    if (WORK) {
      wk.empty = w0 > w1;
      wk.single = o0 <= o1 ? o1 - o0 + 1 : 0;
      put_work(work, n, p, wk);
    }
  }
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

Consts consts(int mode, int H, int W, int m, int s_pad, int X, int Y, int S,
              int nx, int x_off, float vsx, float vsy, float vsz,
              float slab_dz) {
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
  if (mode == kGeneral) {
    c.xmax = (float)((double)(X - 1) - 1e-4);
    c.ymax = (float)((double)(Y - 1) - 1e-4);
  } else {
    c.xmax = (float)(X - 1);
    c.ymax = (float)(Y - 1);
  }
  c.rx = 1.f / vsx;
  c.ry = 1.f / vsy;
  c.nyb = (Y - 2) / kBY + 1;
  c.nbytes = ((nx - 2) / kBX + 8) / 8;
  return c;
}

// the blocks of a persistent grid: as many as fit on the card at once
template <auto Kernel>
int resident_blocks(size_t smem, long long rays) {
  static int sms[16] = {}, per_sm[16] = {};
  static size_t at_smem[16] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 16) return -1;
  if (!sms[dev] && cudaDeviceGetAttribute(&sms[dev],
                                          cudaDevAttrMultiProcessorCount,
                                          dev) != cudaSuccess)
    return -1;
  if (!per_sm[dev] || at_smem[dev] != smem) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm[dev], Kernel, kThreads, smem) != cudaSuccess)
      return -1;
    at_smem[dev] = smem;
  }
  long long need = dynfu_blocks(rays, kThreads);
  return (int)(need < (long long)sms[dev] * per_sm[dev]
                   ? need
                   : (long long)sms[dev] * per_sm[dev]);
}

template <auto Kernel, class... A>
int launch(long long rays, const Consts& c, cudaStream_t st, A... args) {
  size_t smem = (size_t)c.s_pad * sizeof(float);
  int blocks = resident_blocks<Kernel>(smem, rays);
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  Kernel<<<blocks, kThreads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// the sweep's four kernels with or without the work counts
template <bool WORK>
int sweep_launch(int mode, int block, long long n, const Consts& c,
                 cudaStream_t st, const __half* sl, const unsigned char* sm,
                 const float* geo, const float* rays, int lo, int hi,
                 int* counter, float* points, float* normals, int* record,
                 int* work) {
  if (block) {
    if (mode == kGeneral)
      return launch<sweep_block_kernel<kGeneral, WORK>>(
          n, c, st, sl, sm, geo, rays, c, lo, hi, counter, record, work);
    return launch<sweep_block_kernel<kSeparable, WORK>>(
        n, c, st, sl, sm, geo, rays, c, lo, hi, counter, record, work);
  }
  if (mode == kGeneral)
    return launch<sweep_kernel<kGeneral, WORK>>(
        n, c, st, sl, sm, geo, rays, c, counter, points, normals, work);
  return launch<sweep_kernel<kSeparable, WORK>>(
      n, c, st, sl, sm, geo, rays, c, counter, points, normals, work);
}

}  // namespace

DYNFU_API int dynfu_slab_sweep(const void* slabs, int S, int nx,
                               const void* summary, int bg, int by, int bx,
                               const float* geo, const float* rays, int mode,
                               int H, int W, int m, int s_pad, int X, int Y,
                               float vsx, float vsy, float vsz, float slab_dz,
                               int x_off, int lo, int hi, int block,
                               int* counter, float* points, float* normals,
                               int* record, int* work, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((mode != kGeneral && mode != kSeparable) || H * W < 1 || nx < 2 ||
      Y < 2 || s_pad < 1 || bg != kBG || by != kBY || bx != kBX ||
      s_pad > kMaxSlabs)
    return (int)cudaErrorInvalidValue;
  Consts c = consts(mode, H, W, m, s_pad, X, Y, S, nx, x_off, vsx, vsy, vsz,
                    slab_dz);
  const __half* sl = (const __half*)slabs;
  const unsigned char* sm = (const unsigned char*)summary;
  const long long n = (long long)H * W;
  if (work)
    return sweep_launch<true>(mode, block, n, c, st, sl, sm, geo, rays, lo,
                              hi, counter, points, normals, record, work);
  return sweep_launch<false>(mode, block, n, c, st, sl, sm, geo, rays, lo, hi,
                             counter, points, normals, record, work);
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
  Consts c = consts(mode, H, W, m, s_pad, X, Y, 0, 2, 0, vsx, vsy, vsz,
                    slab_dz);
  const int T = 128;
  resolve_kernel<<<dynfu_blocks((long long)H * W, T), T, 0,
                   (cudaStream_t)stream>>>(mode, every, world, geo, rays, c,
                                           points, normals, straddle);
  return (int)cudaGetLastError();
}
