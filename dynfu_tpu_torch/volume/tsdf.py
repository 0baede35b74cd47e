"""TSDF volume: creation, clearing and projective integration.

Port of the parity-path subset of dynfu_tpu/volume/tsdf.py (the reference's
TsdfVolume / TsdfIntegrator, tsdf_volume.cu:43-121). Storage is the same:
tsdf float16 in [-1, 1], weight uint8, layout (X, Y, Z) with z fastest.

One per-voxel projective `integrate` replaces both `tv.integrate` and the
separable and rotated MXU formulations of the source: those factor the
pixel lookup into one-hot matmuls because element gathers are slow on a TPU,
and compute the same update. On a GPU the lookup is a plain gather.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from dynfu_tpu_torch.core import se3
from dynfu_tpu_torch.core.camera import Intr

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


def create(config: TsdfConfig, pose=None, device="cpu") -> TsdfVolume:
    device = torch.device(device)
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
