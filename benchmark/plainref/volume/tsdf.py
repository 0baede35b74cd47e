"""TSDF volume: creation, clearing, projective integration and raycast.

Port of dynfu_tpu/volume/tsdf.py (the reference's TsdfVolume /
TsdfIntegrator / TsdfRaycaster and its cloud and normal extraction,
tsdf_volume.cu:43-679). Storage is the
same: tsdf float16 in [-1, 1], weight uint8, layout (X, Y, Z) with z
fastest.

The source ships several formulations of the integrate and the raycast,
and its engines pick one by the camera pose (engine/kinfu.py `_integrate`,
`_raycast`); the port has each of them:

* `integrate`, the per-voxel projective update. The source's separable
  integrate factors the same update into one-hot matmuls (element gathers
  are slow on a TPU); `integrate(separable=True)` gives its bits (it
  rounds |vc| in other steps than the gather integrate). `integrate_rotated`
  is NOT the same update: it resamples the depth image by a rotation
  homography (nearest pixel) and integrates from the equivalent
  axis-aligned camera.
* `raycast`, the z-slab sweep: bilinear samples on z-slabs every m voxels,
  the crossing refined linearly in z, normals from the slabs' gradients;
  `raycast_separable`, the same sweep for axis-aligned poses, with the
  bilinear in the source's matmul order; `raycast_rotated`, the separable
  sweep on an enlarged virtual image, mapped back by a homography;
  `raycast_march`, the reference's per-ray march (nearest-voxel steps, a
  trilinear secant, central-difference normals), for any pose. The three
  sweeps find other crossings and normals than the march.

The sweeps' state machine is one CUDA kernel (volume/sweep_cuda.py,
csrc/sweep.cu), fed by the slab stack and its sign summary
(csrc/slab_stack.cu); the plain versions below are what they run on the
CPU.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from plainref.core import se3
from plainref.core.camera import Intr
from plainref.kernels import resolve_device
from plainref.ops import compaction
from plainref.volume import sweep_cuda

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


def set_pose(vol: TsdfVolume, pose) -> TsdfVolume:
    """TsdfVolume::setPose (tsdf_volume.hpp:30): the volume's pose."""
    R, t = pose
    dev = vol.tsdf.device
    return vol._replace(pose_r=torch.as_tensor(R, dtype=torch.float32,
                                               device=dev),
                        pose_t=torch.as_tensor(t, dtype=torch.float32,
                                               device=dev))


def apply_affine(vol: TsdfVolume, affine) -> TsdfVolume:
    """TsdfVolume::applyAffine (tsdf_volume.hpp:42): `affine` composed onto
    the volume's pose."""
    affine = tuple(torch.as_tensor(a, dtype=torch.float32,
                                   device=vol.tsdf.device) for a in affine)
    R, t = se3.compose(affine, (vol.pose_r, vol.pose_t))
    return vol._replace(pose_r=R, pose_t=t)


def clear(vol: TsdfVolume) -> TsdfVolume:
    """pack_tsdf(0, 0) everywhere (clear_volume_kernel)."""
    return vol._replace(tsdf=torch.zeros_like(vol.tsdf),
                        weight=torch.zeros_like(vol.weight))


def integrate(vol: TsdfVolume, dists: torch.Tensor, camera_pose,
              intr: Intr, config: TsdfConfig,
              fresh: bool = False, x0: int = 0,
              separable: bool = False) -> TsdfVolume:
    """Projective TSDF update with running-average weights.

    Per voxel: vc = vol2cam * voxel_corner; project; point-sample dists
    (floor); sdf = Dp - |vc|; where sdf >= -trunc, tsdf_avg update and
    weight + 1 clamped to max_weight. The voxel coordinate is the CORNER
    (x * vs), a reference quirk (tsdf_volume.cu:60).

    fresh=True is clear-then-integrate fused (the parity frame clears every
    frame, dyn_fusion.cpp:107-116): with zero previous weight the average is
    exactly the new sample, so the previous state is not read.

    `vol` may hold a block of the volume: its planes are x0 .. x0 +
    vol.tsdf.shape[0] - 1 (the sharded engine's x-blocks); every voxel's
    update is the whole volume's, bit for bit.

    separable=True is the source's `integrate_separable`, its formulation
    for an axis-aligned camera: the rotation is taken as the identity (the
    caller checks), and |vc|^2 is rounded as its compiled program rounds
    it (x^2 rounded, y^2 added in one fused multiply-add, z^2 rounded and
    added), where the gather integrate's rounds once (`norm3`); the two
    differ by one float32 ulp of |vc| at rare voxels. On a lattice whose
    voxel coordinates round in float32 (80^3 over 1 m, say; not the
    engines' 3 m over 128 or 512 voxels) the source's program fuses
    further multiply-adds, and a few voxels per frame differ by a float16
    ulp.
    """
    X, (_, Y, Z) = vol.tsdf.shape[0], config.dims
    vsx, vsy, vsz = config.voxel_size
    H, W = dists.shape
    dev = vol.tsdf.device
    f32 = torch.float32
    trunc_inv = 1.0 / config.trunc_dist

    cam = tuple(torch.as_tensor(a, dtype=f32, device=dev) for a in camera_pose)
    R, t = se3.compose(se3.inverse(cam), (vol.pose_r, vol.pose_t))
    if separable:
        R = torch.eye(3, dtype=f32, device=dev)

    # the source's operation order, so the sample positions round the same
    xs = torch.arange(x0, x0 + X, dtype=f32, device=dev) * vsx
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
        if separable:  # fl(fl(y^2 + fl(x^2)) + fl(z^2)): y^2 fused
            xy = (vcy.double() * vcy + (vcx * vcx).double()).to(f32)
            norm_vc = sqrt_rn(xy + vcz * vcz)
        else:
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


# --- the rotation homography (source: tsdf.py:370-546) ----------------------
# A rotated camera integrates and raycasts as an axis-aligned camera at the
# same centre, with the rotation moved into an image-plane homography.


def _f32(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _kmat(intr: Intr, dev) -> torch.Tensor:
    return _f32([[intr.fx, 0.0, intr.cx], [0.0, intr.fy, intr.cy],
                 [0.0, 0.0, 1.0]], dev)


def _kmat_inv(intr: Intr, dev) -> torch.Tensor:
    return _f32([[1.0 / intr.fx, 0.0, -intr.cx / intr.fx],
                 [0.0, 1.0 / intr.fy, -intr.cy / intr.fy],
                 [0.0, 0.0, 1.0]], dev)


def _rotation_homography(R_rel: torch.Tensor, intr_dst: Intr,
                         intr_src: Optional[Intr] = None) -> torch.Tensor:
    """The pixel map u_dst = K_dst R K_src^-1 u_src (the same K when
    intr_src is omitted)."""
    dev = R_rel.device
    return _kmat(intr_dst, dev) @ (R_rel @ _kmat_inv(intr_src or intr_dst,
                                                      dev))


def _homography_pixels(Hmat: torch.Tensor, out_shape, in_extent):
    """The homography over an (Ho, Wo) pixel grid: (px, py, ok), ok false
    behind the plane at infinity or outside [0, Wi) x [0, Hi) (in_extent
    the exclusive bounds (Hi, Wi))."""
    Ho, Wo = out_shape
    Hi_ext, Wi_ext = in_extent
    dev = Hmat.device
    u = torch.arange(Wo, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(Ho, dtype=torch.float32, device=dev)[:, None]
    x = Hmat[0, 0] * u + Hmat[0, 1] * v + Hmat[0, 2]
    y = Hmat[1, 0] * u + Hmat[1, 1] * v + Hmat[1, 2]
    w = Hmat[2, 0] * u + Hmat[2, 1] * v + Hmat[2, 2]
    safe_w = torch.where(w.abs() < 1e-12, 1.0, w)
    px, py = x / safe_w, y / safe_w
    ok = ((w > 1e-12) & (px >= 0) & (py >= 0) & (px < Wi_ext)
          & (py < Hi_ext))
    return px, py, ok


def _warp_image_nearest(img: torch.Tensor, Hmat: torch.Tensor, out_shape):
    """out[v', u'] = img[H(u', v')], the floor sample; 0 outside."""
    Hi, Wi = img.shape
    px, py, ok = _homography_pixels(Hmat, out_shape, (float(Hi), float(Wi)))
    out = img[_clip_index(torch.floor(py), Hi - 1),
              _clip_index(torch.floor(px), Wi - 1)]
    return torch.where(ok, out, torch.zeros((), dtype=img.dtype,
                                            device=img.device))


def _vol2cam_rotation_split(vol: TsdfVolume, camera_pose):
    """vol2cam = (R', t') as R' after (I, R'^T t'): the virtual axis-aligned
    camera shares the real camera's centre, and the rotation moves into the
    homography. Returns (R', the virtual camera's pose)."""
    dev = vol.tsdf.device
    cam = tuple(_f32(a, dev) for a in camera_pose)
    R_rel, t_rel = se3.compose(se3.inverse(cam), (vol.pose_r, vol.pose_t))
    t_virt = R_rel.T @ t_rel
    virt = se3.compose((vol.pose_r, vol.pose_t),
                       (torch.eye(3, dtype=torch.float32, device=dev),
                        -t_virt))
    return R_rel, virt


def integrate_separable(vol: TsdfVolume, dists: torch.Tensor, camera_pose,
                        intr: Intr, config: TsdfConfig, fresh: bool = False,
                        emit_bitplanes: bool = False):
    """The source's aligned-camera integrate (its one-hot matmul
    formulation): `integrate(separable=True)`. With emit_bitplanes it
    returns (vol, (ins_w, val_w)), the packed z-column planes
    (compaction.pack_columns(tsdf < 0), pack_columns(weight != 0)) of the
    updated volume that mesh/edges.isosurface_edge_vertices takes in place
    of reading the volume's sign and weight."""
    vol = integrate(vol, dists, camera_pose, intr, config, fresh=fresh,
                    separable=True)
    if not emit_bitplanes:
        return vol
    return vol, (compaction.pack_columns(vol.tsdf < 0),
                 compaction.pack_columns(vol.weight != 0))


def integrate_rotated(vol: TsdfVolume, dists: torch.Tensor, camera_pose,
                      intr: Intr, config: TsdfConfig,
                      fresh: bool = False, emit_bitplanes: bool = False,
                      x0: int = 0):
    """The source's rotated-camera integrate: the dists image warped by the
    rotation homography (nearest pixel), then integrated from the
    equivalent axis-aligned camera (`integrate(separable=True)`). sdf uses
    |vc|, which the rotation does not change, so the update differs from
    `integrate`'s by the image's resampling. emit_bitplanes as
    `integrate_separable`; x0 as `integrate` (an x-block)."""
    R_rel, virt = _vol2cam_rotation_split(vol, camera_pose)
    warped = _warp_image_nearest(dists, _rotation_homography(R_rel, intr),
                                 dists.shape)
    vol = integrate(vol, warped, virt, intr, config, fresh=fresh, x0=x0,
                    separable=True)
    if not emit_bitplanes:
        return vol
    return vol, (compaction.pack_columns(vol.tsdf < 0),
                 compaction.pack_columns(vol.weight != 0))


def raycast_rotated(vol: TsdfVolume, camera_pose, intr: Intr,
                    shape: Tuple[int, int], config: TsdfConfig,
                    fov_margin: float = 1.6):
    """The source's rotated-camera raycast: `raycast_separable` on an
    enlarged virtual image (the same focal length, fov_margin x the pixel
    extent, recentred) from the axis-aligned camera at the same centre;
    each real pixel maps into the virtual image by the homography, and its
    point and normal are the validity-weighted bilinear of the four virtual
    pixels around it (the most-weighted valid one where the four straddle a
    depth step of more than 4 voxels), rotated into the real camera's
    frame. NaN where under half of the bilinear mass is valid."""
    H, W = shape
    Hv = int(H * fov_margin) // 8 * 8 + 8
    Wv = int(W * fov_margin) // 8 * 8 + 8
    vintr = Intr(intr.fx, intr.fy, Wv / 2 - 0.5, Hv / 2 - 0.5)
    R_rel, virt = _vol2cam_rotation_split(vol, camera_pose)
    pts_v, nrm_v = raycast_separable(vol, virt, vintr, (Hv, Wv), config)

    # real pixel -> virtual pixel: u' = Kv R_rel^T K^-1 u
    px, py, ok = _homography_pixels(
        _rotation_homography(R_rel.T, vintr, intr), (H, W),
        (float(Hv - 1) + 1e-6, float(Wv - 1) + 1e-6))
    x0 = _clip_index(torch.floor(px), Wv - 2)
    y0 = _clip_index(torch.floor(py), Hv - 2)
    a = torch.clamp(px - x0, 0.0, 1.0)[..., None]
    b = torch.clamp(py - y0, 0.0, 1.0)[..., None]
    dev = pts_v.device
    psum = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    nsum = torch.zeros_like(psum)
    wsum = torch.zeros((H, W, 1), dtype=torch.float32, device=dev)
    zmin = torch.full((H, W), torch.inf, device=dev)
    zmax = torch.full((H, W), -torch.inf, device=dev)
    best_p = torch.full_like(psum, torch.nan)
    best_n = torch.full_like(psum, torch.nan)
    best_w = torch.full_like(wsum, -1.0)
    wts = [(1 - a) * (1 - b), a * (1 - b), (1 - a) * b, a * b]
    for wt, (dy, dx) in zip(wts, [(0, 0), (0, 1), (1, 0), (1, 1)]):
        pv, nv = pts_v[y0 + dy, x0 + dx], nrm_v[y0 + dy, x0 + dx]
        valid = ~torch.isnan(pv[..., :1])
        wv = torch.where(valid, wt, 0.0)
        psum = psum + torch.nan_to_num(pv) * wv
        nsum = nsum + torch.nan_to_num(nv) * wv
        wsum = wsum + wv
        zmin = torch.minimum(zmin, torch.where(valid[..., 0], pv[..., 2],
                                               torch.inf))
        zmax = torch.maximum(zmax, torch.where(valid[..., 0], pv[..., 2],
                                               -torch.inf))
        wb = torch.where(valid, wt, -2.0)
        take = wb > best_w
        best_p = torch.where(take, pv, best_p)
        best_n = torch.where(take, nv, best_n)
        best_w = torch.where(take, wb, best_w)
    good = ok & (wsum[..., 0] > 0.5)
    p = psum / torch.clamp_min(wsum, 1e-12)
    n = nsum / torch.clamp_min(torch.linalg.vector_norm(
        nsum, dim=-1, keepdim=True), 1e-12)
    # silhouette guard: four taps across a depth step blend into a point in
    # mid air; the most-weighted valid tap stands in
    edge = ((zmax - zmin) > 4.0 * max(config.voxel_size))[..., None]
    p = torch.where(edge, best_p, p)
    n = torch.where(edge, best_n, n)
    good = (good & ~torch.isnan(p[..., 0]))[..., None]
    return (torch.where(good, p @ R_rel.T, torch.nan),
            torch.where(good, n @ R_rel.T, torch.nan))


# --- trilinear interpolation (tsdf_volume.cu:146-171) ----------------------


def _flat_index(gx, gy, gz, Y: int, Z: int) -> torch.Tensor:
    return (gx * Y + gy) * Z + gz


def _clip_index(g: torch.Tensor, hi: int) -> torch.Tensor:
    """Float lattice coordinate -> int64 index clipped to [0, hi]; NaN -> 0
    (casting NaN or inf to an integer is undefined in torch)."""
    return torch.nan_to_num(g, nan=0.0).clamp(0, hi).long()


def interpolate(tsdf: torch.Tensor, p_voxels: torch.Tensor, x_off: int = 0,
                dims=None) -> torch.Tensor:
    """Trilinear TSDF lookup at fractional voxel coordinates (..., 3); NaN
    outside [0, dims - 1) on any axis, like the reference.

    `tsdf` may hold the planes x_off.. of a volume of `dims` (a block of a
    sharded volume with its halo): the clip and the inside test are then the
    whole volume's, and a lookup whose two planes (its clipped floor and
    the next) lie in `tsdf` is the whole volume's, bit for bit; any other
    lookup reads planes clamped into `tsdf` and is not."""
    n, Y, Z = tsdf.shape
    X = n if dims is None else dims[0]
    g = torch.floor(p_voxels)
    inside = ((g[..., 0] >= 0) & (g[..., 0] < X - 1) & (g[..., 1] >= 0)
              & (g[..., 1] < Y - 1) & (g[..., 2] >= 0) & (g[..., 2] < Z - 1))
    gx = _clip_index(g[..., 0], X - 2)
    gy = _clip_index(g[..., 1], Y - 2)
    gz = _clip_index(g[..., 2], Z - 2)
    a = p_voxels[..., 0] - gx
    b = p_voxels[..., 1] - gy
    c = p_voxels[..., 2] - gz
    lx = gx if n == X else (gx - x_off).clamp(0, max(n - 2, 0))
    flat = tsdf.reshape(-1)

    def f(dx, dy, dz):
        return flat[_flat_index(lx + dx, gy + dy, gz + dz, Y, Z)].to(
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


def _nearest(p_voxels: torch.Tensor, dims):
    """The voxel a point fetch reads (round half to even, clipped to the
    volume): global (gx, gy, gz)."""
    g = torch.round(p_voxels)
    return tuple(_clip_index(g[..., i], dims[i] - 1) for i in range(3))


def _fetch_nearest(tsdf: torch.Tensor, p_voxels: torch.Tensor) -> torch.Tensor:
    """Round-half-to-even point fetch (TsdfRaycaster::fetch_tsdf)."""
    _, Y, Z = tsdf.shape
    return tsdf.reshape(-1)[_flat_index(*_nearest(p_voxels, tsdf.shape), Y,
                                        Z)].to(torch.float32)


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


def _compute_normal(lookup, vertex, voxel_size_inv, gradient_delta):
    """Central-difference TSDF gradient, normalised
    (tsdf_volume.cu:330-346). lookup(p (6, ..., 3)) -> (6, ...) is the
    trilinear lookup at voxel coordinates (`interpolate` on the volume)."""
    off = torch.diag(gradient_delta)  # row `axis`: the offset along it
    shape = (3,) + (1,) * (vertex.dim() - 1) + (3,)
    off = off.reshape(shape)
    f = lookup(torch.cat([vertex + off, vertex - off]) * voxel_size_inv)
    n = torch.stack([(f[axis] - f[3 + axis]) / gradient_delta[axis]
                     for axis in range(3)], -1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


class Rays(NamedTuple):
    """A raycast's rays in the volume frame (`cast_rays`)."""

    R: torch.Tensor  # (3, 3) camera -> volume rotation
    org: torch.Tensor  # (3,)
    dirs: torch.Tensor  # (H, W, 3) unit directions
    tcurr: torch.Tensor  # (H, W) the march's start (0 for rays that miss)
    active: torch.Tensor  # (H, W) the ray enters the box
    tmax: torch.Tensor  # (H, W)
    time_step: float
    n_steps: int  # the fixed step bound
    vs_inv: torch.Tensor  # (3,)
    gradient_delta: torch.Tensor  # (3,)


def camera_rays(vol: TsdfVolume, camera_pose, shape: Tuple[int, int],
                 intr: Intr):
    """(R, t) camera -> volume and each pixel's unit ray direction in the
    volume frame, (H, W, 3): R ((x - cx) / fx, (y - cy) / fy, 1),
    normalised."""
    H, W = shape
    dev = vol.tsdf.device
    f32 = torch.float32
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
    return R, t, ray_dir / torch.linalg.vector_norm(ray_dir, dim=-1,
                                                    keepdim=True)


def cast_rays(vol: TsdfVolume, camera_pose, intr: Intr,
              shape: Tuple[int, int], config: TsdfConfig) -> Rays:
    """Each pixel's ray from the camera through the volume's box, and the
    march's fixed step grid: n_steps = int(diagonal / step) + 2 steps of
    trunc_dist * raycast_step_factor from the ray's entry, which no ray
    outlasts."""
    dev = vol.tsdf.device
    f32 = torch.float32
    vs = torch.tensor(config.voxel_size, dtype=f32, device=dev)
    dims = torch.tensor(config.dims, dtype=f32, device=dev)
    time_step = config.trunc_dist * config.raycast_step_factor
    box_max = vs * dims - vs
    R, t, ray_dir = camera_rays(vol, camera_pose, shape, intr)

    tmin, tmax = _ray_box(t, ray_dir, box_max)
    tmin = torch.clamp_min(tmin, 0.0)
    tmax = tmax - time_step
    active = tmin < tmax
    diag = (config.size[0] ** 2 + config.size[1] ** 2
            + config.size[2] ** 2) ** 0.5
    return Rays(R=R, org=t, dirs=ray_dir,
                # rays that never start keep a finite position, so every
                # fetch index is defined; they cannot hit
                tcurr=torch.where(active, tmin, 0.0), active=active,
                tmax=tmax, time_step=time_step,
                n_steps=int(diag / time_step) + 2, vs_inv=1.0 / vs,
                gradient_delta=vs * config.gradient_delta_factor)


def _sample_voxels(rays: Rays, tt: torch.Tensor) -> torch.Tensor:
    """The march's sample positions at ray parameters tt, in voxels."""
    return (rays.org + rays.dirs * tt[..., None]) * rays.vs_inv


def ray_surface(rays: Rays, hit: torch.Tensor, t_hit: torch.Tensor, lookup):
    """Secant refinement between the hit step's two samples and the
    central-difference normal at the vertex; lookup(p (k, H, W, 3)) -> (k,
    H, W) is the trilinear lookup. Returns (points, normals) (H, W, 3) in
    the camera frame, NaN where no surface was hit."""
    org, d = rays.org, rays.dirs
    curr = org + d * t_hit[..., None]
    nxt = curr + d * rays.time_step
    Ft, Ftdt = lookup(torch.stack([curr, nxt]) * rays.vs_inv)
    Ts = t_hit - rays.time_step * Ft / (Ftdt - Ft)
    vertex = org + d * Ts[..., None]
    normal = _compute_normal(lookup, vertex, rays.vs_inv,
                             rays.gradient_delta)
    ok = (hit & ~torch.isnan(normal.sum(-1)))[..., None]
    return (torch.where(ok, (vertex - org) @ rays.R, torch.nan),
            torch.where(ok, normal @ rays.R, torch.nan))


def raycast_march(vol: TsdfVolume, camera_pose, intr: Intr,
                  shape: Tuple[int, int], config: TsdfConfig):
    """The source's `raycast_march`, the reference's per-ray march
    (tsdf_volume.cu:262-327): from the ray's entry into the volume box,
    fixed steps of trunc_dist * raycast_step_factor with nearest-voxel
    fetches; the first +/- crossing is a hit, a -/+ crossing ends the ray;
    secant refinement and central-difference normals. Any pose.

    The source loops while any ray is active; this runs the fixed bound
    n_steps (`cast_rays`), which no ray outlasts (rays that end earlier
    stay frozen), so the march needs no host read.

    Returns (points, normals) (H, W, 3) in the camera frame, NaN where no
    surface was hit."""
    rays = cast_rays(vol, camera_pose, intr, shape, config)
    tcurr, active = rays.tcurr, rays.active
    f_prev = _fetch_nearest(vol.tsdf, _sample_voxels(rays, tcurr))
    hit = torch.zeros_like(active)
    t_hit = torch.zeros_like(tcurr)
    for _ in range(rays.n_steps):
        tnext = tcurr + rays.time_step
        f = _fetch_nearest(vol.tsdf, _sample_voxels(rays, tnext))
        crossing = active & (f_prev > 0.0) & (f < 0.0)
        backface = active & (f_prev < 0.0) & (f > 0.0)
        t_hit = torch.where(crossing, tcurr, t_hit)
        hit = hit | crossing
        active = active & ~crossing & ~backface & (tnext < rays.tmax)
        tcurr, f_prev = tnext, f
    return ray_surface(rays, hit, t_hit,
                       lambda p: interpolate(vol.tsdf, p))


# --- the slab sweeps (source: tsdf.py:629-911) -------------------------------
# The sweep samples the volume on every m-th z plane (a "slab"), bilinearly,
# for every ray at once, and refines the first +/- crossing linearly in z.
# On the card one thread walks one ray through all slabs (csrc/sweep.cu);
# the functions below are its plain version, in the kernel's operation
# order, and what runs on the CPU.


class SweepSpec(NamedTuple):
    """A sweep's static description (the kernel's scalar arguments)."""

    mode: str  # "general" (`raycast`) or "separable" (`raycast_separable`)
    shape: Tuple[int, int]  # (H, W)
    m: int  # slab stride, in z planes
    s_pad: int  # slabs walked: the real ones, then planes of +1.0
    dims: Tuple[int, int]  # the whole volume's X and Y
    voxel: Tuple[float, float, float]

    @property
    def slab_dz(self) -> float:
        """The slabs' spacing in metres, as the float32 the sweep uses."""
        return float(np.float32(self.m * self.voxel[2]))


# the fields of a block's sweep record (`_sweep_block`), in order; the float
# fields hold float32 bits, the flags 0 or 1
SWEEP_FIELDS = ("ev_g", "ev_cross", "ev_frac", "ev_gx", "ev_gy", "ev_gz",
                "first_g", "first_f", "first_gx", "first_gy", "first_valid",
                "last_g", "last_f", "last_gx", "last_gy", "last_valid")


def sweep_spec(mode: str, shape, config: TsdfConfig) -> SweepSpec:
    """The source's stride m ~ the march's step in voxels (>= 1) and its
    slab chunks: 16 slabs for `raycast`, 8 for `raycast_separable`."""
    step = config.trunc_dist * config.raycast_step_factor
    m = max(1, int(round(step / config.voxel_size[2])))
    S = (config.dims[2] - 1) // m + 1
    chunk = 16 if mode == "general" else 8
    return SweepSpec(mode, tuple(shape), m, -(-S // chunk) * chunk,
                     tuple(config.dims[:2]), tuple(config.voxel_size))


def slab_stack(tsdf: torch.Tensor, m: int) -> torch.Tensor:
    """The sampled z planes of an (X, Y, Z) tsdf as (S, Y, X) float16: one
    strided slice and one transposing copy, so that neighbouring rays read
    neighbouring x (sweep_cuda.slab_stack's plain stack)."""
    return tsdf[:, :, ::m].permute(2, 1, 0).contiguous()


# the sign summary's brick: slabs, rows, x planes (csrc/slab_stack.cu and
# csrc/sweep.cu hold the same)
BRICK = (4, 8, 8)


def brick_grid(S: int, Y: int, nx: int) -> Tuple[int, int, int]:
    """(layers, brick rows, x bricks) of an (S, Y, nx) stack: the bricks
    cover the slabs and the samples' lower corners (rows 0..Y - 2, planes
    0..nx - 2)."""
    bg, by, bx = BRICK
    return -(-S // bg), -(-(Y - 1) // by), -(-(nx - 1) // bx)


def summary_shape(S: int, Y: int, nx: int) -> Tuple[int, int, int]:
    """The summary's shape: per layer and brick row, one byte for each 8 x
    bricks (bit i of byte j is x brick 8 j + i)."""
    L, nyb, nxb = brick_grid(S, Y, nx)
    return L, nyb, -(-nxb // 8)


def marked_bricks(summary: torch.Tensor, nx: int) -> torch.Tensor:
    """The summary's bits as (layers, brick rows, x bricks) bool."""
    nxb = -(-(nx - 1) // BRICK[2])
    bit = torch.arange(8, dtype=torch.uint8, device=summary.device)
    bits = (summary[..., None] >> bit) & 1
    return bits.reshape(*summary.shape[:2], -1)[..., :nxb].bool()


def brick_summary(slabs: torch.Tensor) -> torch.Tensor:
    """The stack's sign summary (sweep_cuda.slab_stack's second output,
    packed as `summary_shape` says): brick (l, j, i) is marked where every
    value of slabs [l bg, (l + 1) bg), rows [j by, (j + 1) by] and planes
    [i bx, (i + 1) bx] (the +1 row and plane included, as far as the stack
    reaches) is >= 0 (not negative, not NaN), so that no sample whose lower
    corner lies in it is negative: the free space in front of a surface
    (+1) and the volume no camera has seen (0, `create`)."""
    S, Y, nx = slabs.shape
    bg, by, bx = BRICK
    L, nyb, nxb = brick_grid(S, Y, nx)
    pos = torch.ones((L * bg, nyb * by + 1, nxb * bx + 1), dtype=torch.bool,
                     device=slabs.device)
    pos[:S, :Y, :nx] = slabs >= 0
    pos = pos.reshape(L, bg, *pos.shape[1:]).all(1)
    pos = (pos[:, :, :nxb * bx].reshape(L, -1, nxb, bx).all(-1)
           & pos[:, :, bx::bx])
    pos = (pos[:, :nyb * by].reshape(L, nyb, by, nxb).all(2)
           & pos[:, by::by])
    packed = torch.zeros((L, nyb, summary_shape(S, Y, nx)[2] * 8),
                         dtype=torch.uint8, device=slabs.device)
    packed[..., :nxb] = pos.to(torch.uint8)
    bit = torch.arange(8, dtype=torch.uint8, device=slabs.device)
    return (packed.reshape(L, nyb, -1, 8) << bit).sum(-1, dtype=torch.uint8)


def _sampler(geo: torch.Tensor, rays: torch.Tensor, spec: SweepSpec,
             x_off: int, nx: int):
    """sample(g, slab) -> (f, gx, gy, valid, x0): every ray's bilinear
    sample of slab g (slab (Y, nx) f16 holding the planes x_off..), its
    in-plane gradient, its validity and the lower x plane it reads (global;
    for a plane outside [x_off, x_off + nx - 1) the values are not the
    volume's). Invalid samples read f = 1.

    "general" (`raycast`): rays (H, W, 3) unit directions from the origin
    geo[:3]; a ray samples slab g where it meets the plane z = g m vz.
    "separable" (`raycast_separable`, axis-aligned camera at geo[:3]): rays
    = (qx (W), qy (H)), the ray through pixel (u, v) is t + q (z - t_z) with
    q = (qx[u], qy[v], 1), so x depends on (u, g) only; the bilinear and its
    gradient follow the source's one-hot matmuls (rows first, y then x)."""
    X, Y = spec.dims
    vsx, vsy, vsz = spec.voxel
    H, W = spec.shape
    dev = geo.device
    o = geo[:3]
    vx, vy = _f32(vsx, dev), _f32(vsy, dev)
    general = spec.mode == "general"
    if general:
        dz = rays[..., 2]
        fwd = dz > 1e-6
        safe_dz = torch.where(fwd, dz, 1.0)
    else:
        qx, qy = rays[:W], rays[W:]
        gix = float(np.float32(1.0) / np.float32(vsx))
        giy = float(np.float32(1.0) / np.float32(vsy))

    def sample(g, slab):
        z = float(np.float32(g * spec.m) * np.float32(vsz))
        if general:
            srel = (z - o[2]) / safe_dz
            px = (o[0] + rays[..., 0] * srel) / vx
            py = (o[1] + rays[..., 1] * srel) / vy
            valid = (fwd & (srel > 0.0) & (px >= 0) & (px <= X - 1 - 1e-4)
                     & (py >= 0) & (py <= Y - 1 - 1e-4))
        else:
            dzo = z - o[2]
            px = (o[0] + qx * dzo) / vx  # (W,)
            py = (o[1] + qy * dzo) / vy  # (H,)
            valid = ((py >= 0) & (py <= Y - 1))[:, None] & (
                (dzo > 0) & (px >= 0) & (px <= X - 1))[None, :]
        x0 = _clip_index(torch.floor(px), X - 2)
        y0 = _clip_index(torch.floor(py), Y - 2)
        a = torch.clamp(px - x0, 0.0, 1.0)
        b = torch.clamp(py - y0, 0.0, 1.0)
        xl = (x0 - x_off).clamp(0, nx - 2)
        if not general:
            y0, b = y0[:, None], b[:, None]
            xl, a = xl[None, :], a[None, :]
        f00, f01 = slab[y0, xl].float(), slab[y0, xl + 1].float()
        f10, f11 = slab[y0 + 1, xl].float(), slab[y0 + 1, xl + 1].float()
        if general:
            f = (f00 * (1 - a) + f01 * a) * (1 - b) + (f10 * (1 - a)
                                                       + f11 * a) * b
            gx = ((f01 - f00) * (1 - b) + (f11 - f10) * b) / vx
            gy = ((f10 - f00) * (1 - a) + (f11 - f01) * a) / vy
        else:
            t0, t1 = f00 * (1 - a) + f01 * a, f10 * (1 - a) + f11 * a
            f = (1 - b) * t0 + b * t1
            gx = ((1 - b) * (f00 * -gix + f01 * gix)
                  + b * (f10 * -gix + f11 * gix))
            gy = t0 * -giy + t1 * giy
            x0 = x0[None, :]
        return torch.where(valid, f, 1.0), gx, gy, valid, x0

    return sample


def _take(f_prev, gx_prev, gy_prev, f, gx, gy):
    """A crossing between two samples: (frac, gx_h, gy_h, gz_h), its
    fraction of the way from the first, the in-plane gradient lerped to it
    and the difference across the pair."""
    fr = f_prev / (f_prev - f + 1e-30)
    return (fr, gx_prev * (1 - fr) + gx * fr, gy_prev * (1 - fr) + gy * fr,
            f - f_prev)


def _slab_sweep(slabs: torch.Tensor, s_pad: int, sample_fn, H: int, W: int):
    """The zero-crossing state machine shared by `raycast` and
    `raycast_separable` (source `_slab_sweep`): walk slabs 0..s_pad - 1,
    sample_fn(g, slab) -> (f, gx, gy, valid); the carry records each ray's
    FIRST +/- crossing (slab index, fraction and the normal's components
    resolved at it), while a -/+ crossing only stops the ray."""
    dev = slabs.device
    zero = torch.zeros((H, W), dtype=torch.float32, device=dev)
    no = torch.zeros((H, W), dtype=torch.bool, device=dev)
    c = dict(f_prev=torch.ones_like(zero), gx_prev=zero, gy_prev=zero,
             valid_prev=no, found=no, hit=no,
             k_hit=torch.zeros((H, W), dtype=torch.int32, device=dev),
             frac=zero, gx_h=zero, gy_h=zero, gz_h=zero)
    for g in range(s_pad):
        f, gx, gy, valid = sample_fn(g, slabs[g])
        both = c["valid_prev"] & valid
        crossing = both & (c["f_prev"] > 0.0) & (f < 0.0)
        backface = both & (c["f_prev"] < 0.0) & (f > 0.0)
        take = ~c["found"] & crossing
        fr, gx_h, gy_h, gz_h = _take(c["f_prev"], c["gx_prev"],
                                     c["gy_prev"], f, gx, gy)
        c = dict(f_prev=f, gx_prev=gx, gy_prev=gy, valid_prev=valid,
                 found=c["found"] | crossing | backface,
                 hit=c["hit"] | take,
                 k_hit=torch.where(take, g - 1, c["k_hit"]),
                 frac=torch.where(take, fr, c["frac"]),
                 gx_h=torch.where(take, gx_h, c["gx_h"]),
                 gy_h=torch.where(take, gy_h, c["gy_h"]),
                 gz_h=torch.where(take, gz_h, c["gz_h"]))
    return c


def _sweep_outputs(s: dict, slab_dz: float):
    """(hit, z_star, normal, ok) from a sweep's carry: the crossing's depth
    between its two slabs, and the TSDF gradient (the in-plane gradients
    lerped in z, the difference across the slabs) as the normal."""
    dz = _f32(slab_dz, s["frac"].device)
    z_star = (s["k_hit"].to(torch.float32) + s["frac"]) * dz
    gx, gy, gz = s["gx_h"], s["gy_h"], s["gz_h"] / dz
    nn = sqrt_rn(gx * gx + gy * gy + gz * gz)
    den = torch.where(nn > 0, nn, 1.0)
    normal = torch.stack([gx / den, gy / den, gz / den], -1)
    ok = s["hit"] & (nn > 0) & ~torch.isnan(
        normal[..., 0] + normal[..., 1] + normal[..., 2])
    return s["hit"], z_star, normal, ok


def _sweep_points(spec: SweepSpec, z_star, normal, ok, geo, rays):
    """The hits in the camera frame: (points, normals) (H, W, 3), NaN where
    not ok."""
    t = geo[:3]
    if spec.mode == "general":
        R = geo[3:].reshape(3, 3)
        dz = rays[..., 2]
        s_star = (z_star - t[2]) / torch.where(dz > 1e-6, dz, 1.0)
        dv = (t + rays * s_star[..., None]) - t

        def to_cam(v):  # v R: the camera frame, summed in row order
            return v[..., 0:1] * R[0] + v[..., 1:2] * R[1] + v[..., 2:3] * R[2]
        pts, normal = to_cam(dv), to_cam(normal)
    else:
        W = spec.shape[1]
        dzo = z_star - t[2]
        pts = torch.stack([(t[0] + rays[None, :W] * dzo) - t[0],
                           (t[1] + rays[W:, None] * dzo) - t[1], dzo], -1)
    ok = ok[..., None]
    return (torch.where(ok, pts, torch.nan),
            torch.where(ok, normal, torch.nan))


def _padded(slabs: torch.Tensor, s_pad: int) -> torch.Tensor:
    """The stack padded to s_pad slabs of +1.0 (empty space)."""
    pad = slabs.new_ones((s_pad - slabs.shape[0],) + slabs.shape[1:])
    return torch.cat([slabs, pad])


def _sweep_block(slabs, s_pad, sample_fn, H, W, lo, hi):
    """One x-block's share of a sweep: the samples whose lower x plane lies
    in [lo, hi). A ray's x is monotonic in the slab index, so its samples
    in a block are one run. Per ray the record holds its first event (a +/-
    or -/+ crossing) among the run's pairs (ev_g = s_pad + 1 if none; the
    fraction and the normal's components at it), and the run's first and
    last samples (index, f, gx, gy, valid; index -1 if the block has none).
    Returns int32 (16, H, W) in SWEEP_FIELDS' order."""
    dev = slabs.device
    i32 = torch.int32
    none = s_pad + 1
    zero = torch.zeros((H, W), dtype=torch.float32, device=dev)
    no = torch.zeros((H, W), dtype=torch.bool, device=dev)
    ev_g = torch.full((H, W), none, dtype=i32, device=dev)
    first_g = torch.full_like(ev_g, -1)
    last_g = torch.full_like(ev_g, -1)
    ev_cross = no
    ev = (zero,) * 4
    first = last = (zero, zero, zero, no)
    for g in range(s_pad):
        f, gx, gy, valid, x0 = sample_fn(g, slabs[g])
        own = ((x0 >= lo) & (x0 < hi)).expand(H, W)
        both = own & (first_g >= 0) & last[3] & valid
        crossing = both & (last[0] > 0.0) & (f < 0.0)
        event = ((crossing | (both & (last[0] < 0.0) & (f > 0.0)))
                 & (ev_g == none))
        ev_g = torch.where(event, g, ev_g)
        ev_cross = torch.where(event, crossing, ev_cross)
        ev = tuple(torch.where(event, a, b) for a, b in
                   zip(_take(*last[:3], f, gx, gy), ev))
        new = own & (first_g < 0)
        first_g = torch.where(new, g, first_g)
        cur = (f, gx, gy, valid)
        first = tuple(torch.where(new, a, b) for a, b in zip(cur, first))
        last = tuple(torch.where(own, a, b) for a, b in zip(cur, last))
        last_g = torch.where(own, g, last_g)

    def bits(t):
        return t.to(i32) if t.dtype == torch.bool else t.view(i32)
    return torch.stack([ev_g, bits(ev_cross), *map(bits, ev), first_g,
                        *map(bits, first), last_g, *map(bits, last)])


def _sweep_resolve(every: torch.Tensor, s_pad: int):
    """From every block's record (world, 16, H, W) (`_sweep_block`): the
    whole sweep's carry (hit, k_hit, frac, gx_h, gy_h, gz_h) and where the
    hit's pair of samples lies in two blocks. A ray's first event is the
    earliest of every block's own first event and of the pairs across two
    blocks, each judged from the one block's last sample and the next
    block's first (exactly one block starts where another ends)."""
    rec = dict(zip(SWEEP_FIELDS, every.unbind(1)))
    world = every.shape[0]
    none = s_pad + 1

    def sample(pre, r):
        return tuple(rec[pre + k][r].view(torch.float32)
                     for k in ("_f", "_gx", "_gy")) + (
            rec[pre + "_valid"][r] != 0,)

    best = torch.full_like(rec["ev_g"][0], none)
    cross = torch.zeros_like(best, dtype=torch.bool)
    across = torch.zeros_like(cross)
    vals = tuple(torch.zeros_like(best, dtype=torch.float32)
                 for _ in range(4))
    for r in range(world):
        own_vals = tuple(rec[k][r].view(torch.float32) for k in
                         ("ev_frac", "ev_gx", "ev_gy", "ev_gz"))
        cands = [(rec["ev_g"][r], rec["ev_cross"][r] != 0, own_vals, False)]
        # the pair from block r's last sample to the next block's first
        last_g = rec["last_g"][r]
        prev = sample("last", r)
        nxt = torch.zeros_like(cross)
        cur = tuple(torch.zeros_like(v) for v in prev)
        for q in range(world):
            if q != r:
                m = (last_g >= 0) & (rec["first_g"][q] == last_g + 1)
                nxt = nxt | m
                cur = tuple(torch.where(m, a, b)
                            for a, b in zip(sample("first", q), cur))
        both = nxt & prev[3] & cur[3]
        crossing = both & (prev[0] > 0.0) & (cur[0] < 0.0)
        event = crossing | (both & (prev[0] < 0.0) & (cur[0] > 0.0))
        cands.append((torch.where(event, last_g + 1, none), crossing,
                      _take(*prev[:3], *cur[:3]), True))
        for g, c, v, a in cands:
            earlier = g < best
            best = torch.where(earlier, g, best)
            cross = torch.where(earlier, c, cross)
            across = torch.where(earlier, a, across)
            vals = tuple(torch.where(earlier, x, y) for x, y in zip(v, vals))
    hit = (best < none) & cross
    s = dict(hit=hit, k_hit=torch.where(hit, best - 1, 0),
             frac=vals[0], gx_h=vals[1], gy_h=vals[2], gz_h=vals[3])
    return s, hit & across


def sweep_plain(slabs: torch.Tensor, geo: torch.Tensor, rays: torch.Tensor,
                spec: SweepSpec, block=None):
    """The sweep of volume/sweep_cuda.slab_sweep, in plain PyTorch: (points,
    normals) in the camera frame, or with block = (x_off, lo, hi) the
    block's record (`_sweep_block`)."""
    H, W = spec.shape
    x_off, lo, hi = block or (0, 0, spec.dims[0])
    sample = _sampler(geo, rays, spec, x_off, slabs.shape[2])
    slabs = _padded(slabs, spec.s_pad)
    if block is not None:
        return _sweep_block(slabs, spec.s_pad, sample, H, W, lo, hi)
    s = _slab_sweep(slabs, spec.s_pad, lambda g, sl: sample(g, sl)[:4], H, W)
    _, z_star, normal, ok = _sweep_outputs(s, spec.slab_dz)
    return _sweep_points(spec, z_star, normal, ok, geo, rays)


def resolve_plain(every: torch.Tensor, geo: torch.Tensor, rays: torch.Tensor,
                  spec: SweepSpec):
    """volume/sweep_cuda.sweep_resolve in plain PyTorch: (points, normals,
    straddle) from every block's record."""
    s, straddle = _sweep_resolve(every, spec.s_pad)
    _, z_star, normal, ok = _sweep_outputs(s, spec.slab_dz)
    return _sweep_points(spec, z_star, normal, ok, geo, rays) + (straddle,)


def raycast(vol: TsdfVolume, camera_pose, intr: Intr, shape: Tuple[int, int],
            config: TsdfConfig):
    """The source's `raycast`: the z-slab sweep for any pose whose rays run
    towards +z in the volume (rays with direction z <= 1e-6 report no
    surface). Every ray samples the slabs z = k m vz (m = `sweep_spec`'s
    stride) bilinearly where it meets them; the first +/- crossing between
    two valid samples is a hit, refined linearly in z, with the slabs'
    gradients as its normal; a -/+ crossing ends the ray. Returns (points,
    normals) (H, W, 3) in the camera frame, NaN where no surface was hit."""
    R, t, dirs = camera_rays(vol, camera_pose, shape, intr)
    spec = sweep_spec("general", shape, config)
    return sweep_cuda.slab_sweep(sweep_cuda.slab_stack(vol.tsdf, spec.m),
                                 torch.cat([t, R.reshape(-1)]),
                                 dirs.contiguous(), spec)


def separable_rays(vol: TsdfVolume, camera_pose, intr: Intr, shape):
    """(geo, rays) of `raycast_separable`: the camera's position in the
    volume with an identity rotation, and (qx (W), qy (H))."""
    H, W = shape
    dev = vol.tsdf.device
    f32 = torch.float32
    cam = tuple(_f32(a, dev) for a in camera_pose)
    _, t = se3.compose(se3.inverse((vol.pose_r, vol.pose_t)), cam)
    qx = (torch.arange(W, dtype=f32, device=dev) - intr.cx) / _f32(intr.fx,
                                                                   dev)
    qy = (torch.arange(H, dtype=f32, device=dev) - intr.cy) / _f32(intr.fy,
                                                                   dev)
    geo = torch.cat([t, torch.eye(3, dtype=f32, device=dev).reshape(-1)])
    return geo, torch.cat([qx, qy])


def raycast_separable(vol: TsdfVolume, camera_pose, intr: Intr,
                      shape: Tuple[int, int], config: TsdfConfig):
    """The source's `raycast_separable`: the slab sweep for a camera whose
    rotation in the volume frame is the identity (callers check; the
    engines do). The ray through pixel (u, v) is t + q (z - t_z), q =
    ((u - cx) / fx, (v - cy) / fy, 1), so a sample's x depends on (u, z)
    only and its y on (v, z); the bilinear and its gradient are summed in
    the source's order (its one-hot matmuls: rows of the slab first, y
    then x). Same crossing and refinement as `raycast`."""
    geo, rays = separable_rays(vol, camera_pose, intr, shape)
    spec = sweep_spec("separable", shape, config)
    return sweep_cuda.slab_sweep(sweep_cuda.slab_stack(vol.tsdf, spec.m),
                                 geo, rays, spec)


def raycast_depth(vol: TsdfVolume, camera_pose, intr: Intr,
                  shape: Tuple[int, int], config: TsdfConfig):
    """The depth-map raycast (tsdf_volume.cu:196-256): (depth (H, W) int32
    millimetres, truncated, 0 where no surface; normals (H, W, 3)), from
    `raycast`, the slab sweep, as in the source."""
    points, normals = raycast(vol, camera_pose, intr, shape, config)
    z = points[..., 2]
    mm = torch.nan_to_num(z * 1000.0, nan=0.0).to(torch.int32)
    return torch.where(torch.isnan(z), 0, mm), normals


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
                    config: TsdfConfig, frame: str = "world", x0: int = 0,
                    halo=(0, 0)) -> torch.Tensor:
    """TSDF-gradient normals at `points` (ExtractNormals,
    tsdf_volume.cu:602-679): NaN unless the nearest voxel lies in
    [2, dims - 2)^3; n = normalize(pose_R grad). With frame="volume" the
    points are in the volume frame (marching-cubes output) and so are the
    normals (no pose on either side).

    On an x-block of a sharded volume (dist/), `vol` holds the block's
    planes from x0 with `halo` = (h0, h1) neighbouring planes below and
    above: the normals of points in the block's cells (the x-extent
    [x0, x0 + n] voxels) are the whole volume's, bit for bit, with one
    plane below and two above (their samples reach a voxel beyond the
    cells' upper plane); the NaN rule is read in global coordinates."""
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
    n = _compute_normal(
        lambda p: interpolate(vol.tsdf, p, x0 - halo[0], config.dims), p_vol,
        vs_inv, gradient_delta)
    if frame == "world":
        n = n @ vol.pose_r.T
    return torch.where(inside[..., None], n, torch.nan)
