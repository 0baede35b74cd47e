"""TSDF volume: creation, clearing, projective integration and raycast.

Port of dynfu_tpu/volume/tsdf.py (the reference's TsdfVolume /
TsdfIntegrator / TsdfRaycaster and its cloud and normal extraction,
tsdf_volume.cu:43-679). Storage is the
same: tsdf float16 in [-1, 1], weight uint8, layout (X, Y, Z) with z
fastest.

One per-voxel projective `integrate` replaces both `tv.integrate` and the
separable and rotated MXU formulations of the source: those factor the
pixel lookup into one-hot matmuls because element gathers are slow on a TPU,
and compute the same update. On a GPU the lookup is a plain gather. Likewise
one per-ray `raycast` (the semantics of the source's `raycast_march`, the
lock-step translation of the reference's raycaster) replaces the slab sweeps
and homography raycasts, which are TPU reformulations; it is valid for any
pose.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from dynfu_tpu_torch.core import se3
from dynfu_tpu_torch.core.camera import Intr
from dynfu_tpu_torch.kernels import resolve_device
from dynfu_tpu_torch.ops import compaction

# voxels per integrate chunk: bounds the float32 temporaries at large volumes
_CHUNK_VOXELS = 1 << 24


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt. PyTorch's vectorised CPU sqrt is
    accurate to ~0.5 ulp but not always correctly rounded; the float64 root
    rounded once to float32 is the IEEE result, as on the card."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def norm3(x, y, z) -> torch.Tensor:
    """|(x, y, z)| with the sum of squares rounded once to float32. The
    JAX reference's compiler fuses the sum into multiply-adds; one float32
    ulp of |vc| can flip the float16 rounding of a stored tsdf, and this
    form reproduces the reference's volumes bit for bit in the tests."""
    s = x.double() * x + y.double() * y + z.double() * z
    return sqrt_rn(s.to(torch.float32))


@dataclasses.dataclass(frozen=True)
class TsdfConfig:
    """Static volume geometry + fusion params (KinFuParams subset)."""

    dims: Tuple[int, int, int] = (512, 512, 512)
    size: Tuple[float, float, float] = (3.0, 3.0, 3.0)  # meters
    trunc_dist: float = 0.04
    max_weight: int = 64
    raycast_step_factor: float = 0.75
    gradient_delta_factor: float = 0.5

    @property
    def voxel_size(self) -> Tuple[float, float, float]:
        return tuple(s / d for s, d in zip(self.size, self.dims))


class TsdfVolume(NamedTuple):
    """Volume state; the pose maps volume coords -> world coords."""

    tsdf: torch.Tensor  # (X, Y, Z) float16
    weight: torch.Tensor  # (X, Y, Z) uint8
    pose_r: torch.Tensor  # (3, 3) float32
    pose_t: torch.Tensor  # (3,) float32


def create(config: TsdfConfig, pose=None, device="cuda") -> TsdfVolume:
    device = resolve_device(device)
    X, Y, Z = config.dims
    R, t = se3.identity(device) if pose is None else pose
    return TsdfVolume(
        tsdf=torch.zeros((X, Y, Z), dtype=torch.float16, device=device),
        weight=torch.zeros((X, Y, Z), dtype=torch.uint8, device=device),
        pose_r=torch.as_tensor(R, dtype=torch.float32, device=device),
        pose_t=torch.as_tensor(t, dtype=torch.float32, device=device),
    )


def clear(vol: TsdfVolume) -> TsdfVolume:
    """pack_tsdf(0, 0) everywhere (clear_volume_kernel)."""
    return vol._replace(tsdf=torch.zeros_like(vol.tsdf),
                        weight=torch.zeros_like(vol.weight))


def integrate(vol: TsdfVolume, dists: torch.Tensor, camera_pose,
              intr: Intr, config: TsdfConfig,
              fresh: bool = False) -> TsdfVolume:
    """Projective TSDF update with running-average weights.

    Per voxel: vc = vol2cam * voxel_corner; project; point-sample dists
    (floor); sdf = Dp - |vc|; where sdf >= -trunc, tsdf_avg update and
    weight + 1 clamped to max_weight. The voxel coordinate is the CORNER
    (x * vs), a reference quirk (tsdf_volume.cu:60).

    fresh=True is clear-then-integrate fused (the parity frame clears every
    frame, dyn_fusion.cpp:107-116): with zero previous weight the average is
    exactly the new sample, so the previous state is not read.
    """
    X, Y, Z = config.dims
    vsx, vsy, vsz = config.voxel_size
    H, W = dists.shape
    dev = vol.tsdf.device
    f32 = torch.float32
    trunc_inv = 1.0 / config.trunc_dist

    cam = tuple(torch.as_tensor(a, dtype=f32, device=dev) for a in camera_pose)
    R, t = se3.compose(se3.inverse(cam), (vol.pose_r, vol.pose_t))

    # the source's operation order, so the sample positions round the same
    xs = torch.arange(X, dtype=f32, device=dev) * vsx
    ys = torch.arange(Y, dtype=f32, device=dev) * vsy
    zf = torch.arange(Z, dtype=f32, device=dev)
    zcol = R[:, 2] * vsz
    dists_f = dists.to(f32).reshape(-1)

    tsdf_out = torch.empty_like(vol.tsdf)
    w_out = torch.empty_like(vol.weight)
    cx = max(1, _CHUNK_VOXELS // (Y * Z))
    for x0 in range(0, X, cx):
        x1 = min(X, x0 + cx)
        base = (xs[x0:x1, None, None] * R[:, 0] + ys[None, :, None] * R[:, 1]
                + t)  # (cx, Y, 3)
        vc = base[:, :, None, :] + zf[None, None, :, None] * zcol
        vcx, vcy, vcz = vc.unbind(-1)
        u = intr.fx * vcx / vcz + intr.cx
        v = intr.fy * vcy / vcz + intr.cy
        in_img = (u >= 0) & (v >= 0) & (u < W) & (v < H)
        ui = torch.clamp(torch.floor(u).to(torch.int64), 0, W - 1)
        vi = torch.clamp(torch.floor(v).to(torch.int64), 0, H - 1)
        Dp = dists_f[vi * W + ui]
        norm_vc = norm3(vcx, vcy, vcz)
        sdf = Dp - norm_vc
        update = in_img & (Dp != 0) & (vcz > 0) & (sdf >= -config.trunc_dist)
        tsdf_in = torch.clamp_max(sdf * trunc_inv, 1.0)
        if fresh:
            tsdf_new, w_new = tsdf_in, 1.0
            tsdf_prev = w_prev = 0.0
        else:
            tsdf_prev = vol.tsdf[x0:x1].to(f32)
            w_prev = vol.weight[x0:x1].to(f32)
            tsdf_new = (tsdf_prev * w_prev + tsdf_in) / (w_prev + 1.0)
            w_new = torch.clamp_max(w_prev + 1.0, float(config.max_weight))
        tsdf_out[x0:x1] = torch.where(update, tsdf_new, tsdf_prev).to(
            torch.float16)
        w_out[x0:x1] = torch.where(update, w_new, w_prev).to(torch.uint8)
    return vol._replace(tsdf=tsdf_out, weight=w_out)


# --- trilinear interpolation (tsdf_volume.cu:146-171) ----------------------


def _flat_index(gx, gy, gz, Y: int, Z: int) -> torch.Tensor:
    return (gx * Y + gy) * Z + gz


def _clip_index(g: torch.Tensor, hi: int) -> torch.Tensor:
    """Float lattice coordinate -> int64 index clipped to [0, hi]; NaN -> 0
    (casting NaN or inf to an integer is undefined in torch)."""
    return torch.nan_to_num(g, nan=0.0).clamp(0, hi).long()


def interpolate(tsdf: torch.Tensor, p_voxels: torch.Tensor) -> torch.Tensor:
    """Trilinear TSDF lookup at fractional voxel coordinates (..., 3); NaN
    outside [0, dims - 1) on any axis, like the reference."""
    X, Y, Z = tsdf.shape
    g = torch.floor(p_voxels)
    inside = ((g[..., 0] >= 0) & (g[..., 0] < X - 1) & (g[..., 1] >= 0)
              & (g[..., 1] < Y - 1) & (g[..., 2] >= 0) & (g[..., 2] < Z - 1))
    gx = _clip_index(g[..., 0], X - 2)
    gy = _clip_index(g[..., 1], Y - 2)
    gz = _clip_index(g[..., 2], Z - 2)
    a = p_voxels[..., 0] - gx
    b = p_voxels[..., 1] - gy
    c = p_voxels[..., 2] - gz
    flat = tsdf.reshape(-1)

    def f(dx, dy, dz):
        return flat[_flat_index(gx + dx, gy + dy, gz + dz, Y, Z)].to(
            torch.float32)

    out = (f(0, 0, 0) * (1 - a) * (1 - b) * (1 - c)
           + f(0, 0, 1) * (1 - a) * (1 - b) * c
           + f(0, 1, 0) * (1 - a) * b * (1 - c)
           + f(0, 1, 1) * (1 - a) * b * c
           + f(1, 0, 0) * a * (1 - b) * (1 - c)
           + f(1, 0, 1) * a * (1 - b) * c
           + f(1, 1, 0) * a * b * (1 - c)
           + f(1, 1, 1) * a * b * c)
    return torch.where(inside, out, torch.nan)


def _fetch_nearest(tsdf: torch.Tensor, p_voxels: torch.Tensor) -> torch.Tensor:
    """Round-half-to-even point fetch (TsdfRaycaster::fetch_tsdf)."""
    X, Y, Z = tsdf.shape
    g = torch.round(p_voxels)
    idx = _flat_index(_clip_index(g[..., 0], X - 1),
                      _clip_index(g[..., 1], Y - 1),
                      _clip_index(g[..., 2], Z - 1), Y, Z)
    return tsdf.reshape(-1)[idx].to(torch.float32)


# --- raycast (TsdfRaycaster, tsdf_volume.cu:173-386) -----------------------


def _ray_box(ray_org, ray_dir, box_max):
    """Slab intersection against [0, box_max] (intersect,
    tsdf_volume.cu:127-144), with the reference's max(max(x, y), max(x, z))
    form."""
    inv = 1.0 / ray_dir
    tbot = inv * (0.0 - ray_org)
    ttop = inv * (box_max - ray_org)
    tmin3 = torch.minimum(ttop, tbot)
    tmax3 = torch.maximum(ttop, tbot)
    tnear = torch.maximum(torch.maximum(tmin3[..., 0], tmin3[..., 1]),
                          torch.maximum(tmin3[..., 0], tmin3[..., 2]))
    tfar = torch.minimum(torch.minimum(tmax3[..., 0], tmax3[..., 1]),
                         torch.minimum(tmax3[..., 0], tmax3[..., 2]))
    return tnear, tfar


def _compute_normal(tsdf, vertex, voxel_size_inv, gradient_delta):
    """Central-difference TSDF gradient, normalised
    (tsdf_volume.cu:330-346)."""
    comps = []
    for axis in range(3):
        off = torch.zeros(3, dtype=torch.float32, device=vertex.device)
        off[axis] = gradient_delta[axis]
        f1 = interpolate(tsdf, (vertex + off) * voxel_size_inv)
        f2 = interpolate(tsdf, (vertex - off) * voxel_size_inv)
        comps.append((f1 - f2) / gradient_delta[axis])
    n = torch.stack(comps, -1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


def raycast(vol: TsdfVolume, camera_pose, intr: Intr, shape: Tuple[int, int],
            config: TsdfConfig):
    """Per-ray march with the semantics of the source's `raycast_march`
    (tsdf_volume.cu:262-327): from the ray's entry into the volume box,
    fixed steps of trunc_dist * raycast_step_factor with nearest-voxel
    fetches; the first +/- crossing is a hit, a -/+ crossing ends the ray;
    secant refinement and central-difference normals. Any pose.

    The source loops while any ray is active; this runs the fixed bound
    n_steps = int(diagonal / step) + 2, which no ray outlasts (rays that end
    earlier stay frozen), so the march needs no host read.

    Returns (points, normals) (H, W, 3) in the camera frame, NaN where no
    surface was hit."""
    H, W = shape
    dev = vol.tsdf.device
    f32 = torch.float32
    vs = torch.tensor(config.voxel_size, dtype=f32, device=dev)
    vs_inv = 1.0 / vs
    dims = torch.tensor(config.dims, dtype=f32, device=dev)
    time_step = config.trunc_dist * config.raycast_step_factor
    gradient_delta = vs * config.gradient_delta_factor
    box_max = vs * dims - vs

    cam = tuple(torch.as_tensor(a, dtype=f32, device=dev) for a in camera_pose)
    R, t = se3.compose(se3.inverse((vol.pose_r, vol.pose_t)), cam)
    xs = torch.arange(W, dtype=f32, device=dev)[None, :]
    ys = torch.arange(H, dtype=f32, device=dev)[:, None]
    fx = torch.tensor(intr.fx, dtype=f32, device=dev)
    fy = torch.tensor(intr.fy, dtype=f32, device=dev)
    d = torch.stack([((xs - intr.cx) / fx).expand(H, W),
                     ((ys - intr.cy) / fy).expand(H, W),
                     torch.ones((H, W), dtype=f32, device=dev)], -1)
    ray_dir = d @ R.T
    ray_dir = ray_dir / torch.linalg.vector_norm(ray_dir, dim=-1,
                                                 keepdim=True)
    org = t

    tmin, tmax = _ray_box(org, ray_dir, box_max)
    tmin = torch.clamp_min(tmin, 0.0)
    tmax = tmax - time_step
    active = tmin < tmax
    # rays that never start keep a finite position, so every fetch index is
    # defined; they cannot hit
    tcurr = torch.where(active, tmin, 0.0)

    diag = (config.size[0] ** 2 + config.size[1] ** 2
            + config.size[2] ** 2) ** 0.5
    n_steps = int(diag / time_step) + 2

    def fetch(tt):
        return _fetch_nearest(vol.tsdf, (org + ray_dir * tt[..., None])
                              * vs_inv)

    f_prev = fetch(tcurr)
    hit = torch.zeros((H, W), dtype=torch.bool, device=dev)
    t_hit = torch.zeros((H, W), dtype=f32, device=dev)
    for _ in range(n_steps):
        tnext = tcurr + time_step
        f = fetch(tnext)
        crossing = active & (f_prev > 0.0) & (f < 0.0)
        backface = active & (f_prev < 0.0) & (f > 0.0)
        t_hit = torch.where(crossing, tcurr, t_hit)
        hit = hit | crossing
        active = active & ~crossing & ~backface & (tnext < tmax)
        tcurr, f_prev = tnext, f

    curr = org + ray_dir * t_hit[..., None]
    nxt = curr + ray_dir * time_step
    Ft = interpolate(vol.tsdf, curr * vs_inv)
    Ftdt = interpolate(vol.tsdf, nxt * vs_inv)
    Ts = t_hit - time_step * Ft / (Ftdt - Ft)
    vertex = org + ray_dir * Ts[..., None]
    normal = _compute_normal(vol.tsdf, vertex, vs_inv, gradient_delta)

    ok = (hit & ~torch.isnan(normal.sum(-1)))[..., None]
    return (torch.where(ok, (vertex - org) @ R, torch.nan),
            torch.where(ok, normal @ R, torch.nan))


# --- cloud and normal extraction (FullScan6 + ExtractNormals,
# tsdf_volume.cu:423-679) ---------------------------------------------------


def extract_cloud(vol: TsdfVolume, config: TsdfConfig,
                  capacity: int = 1 << 18):
    """Zero-crossing points along the +x, +y and +z edges, world frame
    (FullScan6, tsdf_volume.cu:460-530).

    An edge emits where both endpoint weights are nonzero, neither tsdf is
    exactly 1 and the signs differ: p = (V |Fn| + Vn |F|) / (|F| + |Fn|)
    between VOXEL CENTRES (+0.5). As in the reference, +x and +y crossings
    in the last z layer are never emitted. Points come in the source's
    order (the x edges, then y, then z, each in (x, y, z) order); the first
    `capacity` are kept, and only they are interpolated. Returns (points
    (capacity, 3), mask (capacity,))."""
    X, Y, Z = config.dims
    dev = vol.tsdf.device
    F = vol.tsdf.to(torch.float32)
    valid = (vol.weight != 0) & (F != 1.0)
    oks, shapes = [], []
    for axis in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis], hi[axis] = slice(0, -1), slice(1, None)
        F0, F1 = F[tuple(lo)], F[tuple(hi)]
        ok = (valid[tuple(lo)] & valid[tuple(hi)]
              & (((F0 > 0) & (F1 < 0)) | ((F0 < 0) & (F1 > 0))))
        if axis != 2:
            ok[:, :, Z - 1] = False
        oks.append(ok.reshape(-1))
        shapes.append(ok.shape)
    flat = torch.cat(oks)
    total = flat.numel()
    idx = compaction.rank_select(flat, capacity, total)
    mask = idx < total

    # each kept edge: its axis, its voxel and the neighbour along the axis
    sizes = torch.tensor([o.numel() for o in oks], device=dev)
    starts = torch.cumsum(sizes, 0) - sizes
    axis = torch.clamp(torch.bucketize(idx, starts, right=True) - 1, 0, 2)
    local = torch.where(mask, idx - starts[axis], 0)
    sy = torch.tensor([s[1] for s in shapes], device=dev)[axis]
    sz = torch.tensor([s[2] for s in shapes], device=dev)[axis]
    i = torch.div(local, sy * sz, rounding_mode="floor")
    j = torch.div(local, sz, rounding_mode="floor") - i * sy
    k = local - (i * sy + j) * sz
    ijk = torch.stack([i, j, k], -1)
    step = torch.nn.functional.one_hot(axis, 3)
    nb = ijk + step
    f0 = F[ijk[:, 0], ijk[:, 1], ijk[:, 2]]
    f1 = F[nb[:, 0], nb[:, 1], nb[:, 2]]

    vs = torch.tensor(config.voxel_size, dtype=torch.float32, device=dev)
    base = (ijk.to(torch.float32) + 0.5) * vs
    b = base.gather(1, axis[:, None])[:, 0]
    d_inv = 1.0 / (f0.abs() + f1.abs())
    interp = (b * f1.abs() + (b + vs[axis]) * f0.abs()) * d_inv
    pts = torch.where(step.bool(), interp[:, None], base)
    out = pts @ vol.pose_r.T + vol.pose_t
    return torch.where(mask[:, None], out, 0.0), mask


def extract_normals(vol: TsdfVolume, points: torch.Tensor,
                    config: TsdfConfig, frame: str = "world") -> torch.Tensor:
    """TSDF-gradient normals at `points` (ExtractNormals,
    tsdf_volume.cu:602-679): NaN unless the nearest voxel lies in
    [2, dims - 2)^3; n = normalize(pose_R grad). With frame="volume" the
    points are in the volume frame (marching-cubes output) and so are the
    normals (no pose on either side)."""
    if frame not in ("world", "volume"):
        raise ValueError(f"unknown frame {frame!r}")
    X, Y, Z = config.dims
    vs = torch.tensor(config.voxel_size, dtype=torch.float32,
                      device=points.device)
    vs_inv = 1.0 / vs
    gradient_delta = vs * config.gradient_delta_factor
    p_vol = (points if frame == "volume"
             else (points - vol.pose_t) @ vol.pose_r)  # R^-1 (p - t)
    # the nearest voxel (round half to even); NaN compares False
    g = torch.round(p_vol * vs_inv)
    inside = ((g[..., 0] > 1) & (g[..., 0] < X - 2)
              & (g[..., 1] > 1) & (g[..., 1] < Y - 2)
              & (g[..., 2] > 1) & (g[..., 2] < Z - 2))
    n = _compute_normal(vol.tsdf, p_vol, vs_inv, gradient_delta)
    if frame == "world":
        n = n @ vol.pose_r.T
    return torch.where(inside[..., None], n, torch.nan)
