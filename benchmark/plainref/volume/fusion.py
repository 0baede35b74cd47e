"""Non-rigid (warped) TSDF integration into a persistent canonical volume.

Port of dynfu_tpu/volume/fusion.py: the DynamicFusion fusion model
(Newcombe et al. 2015, section 3.3) that the reference's clear and
re-integrate workaround stands in for (dyn_fusion.cpp:107-116).

Per active canonical voxel x_c: warp x_c through the field, project it
into the live camera, read the depth along the ray and fold the projective
SDF into the voxel with the rigid integrator's running average and weight
clamp (tsdf_volume.cu:50-94). Voxels outside the field's support
(min_k dist / dg_w >= 1, warp_field.cpp:34-61) are left untouched.

The update has effect only in the truncation band of the canonical surface
plus a dilation margin, so the band is compacted first (the source's
capture rule, ops/compaction.extract_bits) and every per-voxel step runs on
the compacted set: the warp and the support ratio are the fused CUDA warp
kernel (ops/warp_cuda.py), the rest is elementwise PyTorch. The source
packs the f16 depth and the f16 view cosine into one u32 image so that one
TPU gather fetches both; here both maps are gathered directly, and the
cosine is still rounded to float16 as the source's packing does.

The port updates the volume IN PLACE (index_put_ at the unique band
indices), where the source returns a new array: the 512^3 float16 volume is
268 MB.

On an x-block of a sharded volume (dist/), `vol` holds planes x0 .. x0 +
n - 1; `halo_fn(vol, width)` gives the block with `width` of its
neighbours' planes on each side (dist/spmd.halo_slab), on which the band is
dilated across the block faces, and `prefix` applies the band capacities
over all blocks (ops/compaction.py): the block captures exactly the band
voxels of its planes that the whole volume's compaction captures, warps
them at their global coordinates and updates them in place. Its counters
are then its own; the sharded frame sums them over ranks.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from plainref.core import se3
from plainref.core.camera import Intr
from plainref.ops import compaction, warp_cuda
from plainref.ops.imgproc import f32_scalar
from plainref.volume.tsdf import (TsdfConfig, TsdfVolume, norm3,
                                          sqrt_rn)
from plainref.warp.field import WarpField


class FusionStats(NamedTuple):
    n_band: torch.Tensor  # () int32: voxels in the dilated active band
    n_captured: torch.Tensor  # () int32: band voxels processed (<= capacity)
    n_updated: torch.Tensor  # () int32: voxels whose TSDF was updated


def band_budget(config: TsdfConfig, dilate: int) -> int:
    """Per-column bit budget for the active band: the truncation band is
    ~2 trunc / voxel deep per surface crossing; two crossings plus the
    dilation margin."""
    depth = math.ceil(config.trunc_dist / config.voxel_size[2])
    return min(config.dims[2], 8 + 4 * depth + 4 * dilate)


def integrate_warped(vol: TsdfVolume, wf: WarpField, dists: torch.Tensor,
                     camera_pose, intr: Intr, config: TsdfConfig, *,
                     normals: torch.Tensor | None = None,
                     min_cos: float = 0.0, max_active: int = 1 << 19,
                     dilate: int = 2, knn_k: int = 4, col_budget: int = 0,
                     blend: str = "dqb", x0: int = 0, halo_fn=None,
                     prefix=None):
    """Fuse one live depth frame into the canonical volume through the warp.

    dists (H, W) float16 meters; camera_pose (R, t) world <- camera;
    normals (H, W, 3) camera-frame live normals (NaN where invalid), which
    with min_cos > 0 reject grazing observations and weight the pull by the
    view cosine. Returns (vol, FusionStats), vol updated in place;
    n_captured < n_band signals a band-capacity overflow. `col_budget` is
    accepted and ignored, as in the source: the band capture has no
    per-column budget to overflow (two-level rank select)."""
    Xg, Y, Z = config.dims
    X = vol.tsdf.shape[0]  # the planes held: the whole volume, or a block
    vsx, vsy, vsz = config.voxel_size
    H, W = dists.shape
    dev = vol.tsdf.device
    f32 = torch.float32
    F16, Wu8 = vol.tsdf, vol.weight

    # active band: observed near-surface voxels (far free space saturates at
    # exactly +1) plus a growth margin; on a block, dilated on the slab of
    # its planes and `dilate` of its neighbours' on each side
    slab, (h0, _) = (vol, (0, 0)) if halo_fn is None or dilate <= 0 \
        else halo_fn(vol, dilate)
    band = (slab.weight > 0) & (slab.tsdf < 1.0)
    del slab
    if dilate > 0:
        band = compaction.dilate_xy(compaction.dilate_z(band, dilate),
                                    dilate)[h0:h0 + X]
    nwords = (Z + 31) // 32
    flat_idx, n_band, n_captured = compaction.extract_bits(
        band.reshape(X * Y, Z), max_out=max_active, row_stride=Z,
        fill=X * Y * Z, max_words=min(Xg * Y * nwords,
                                      max(max_active // 4, 1 << 15)),
        prefix=prefix)
    del band
    ok = flat_idx < X * Y * Z
    safe = torch.where(ok, flat_idx, 0)
    vx = torch.div(safe, Y * Z, rounding_mode="floor")
    rem = safe - vx * (Y * Z)
    vy = torch.div(rem, Z, rounding_mode="floor")
    vz = rem - vy * Z

    # voxel CORNER coordinates, the rigid integrator's convention
    p_vol = torch.stack([(vx + x0).to(f32) * vsx, vy.to(f32) * vsy,
                         vz.to(f32) * vsz], -1)
    p_warp, _, _, ratio = warp_cuda.warp_fused(
        p_vol, torch.zeros_like(p_vol), wf.pos, wf.dqs, wf.w, wf.mask,
        k=knn_k, blend=blend)
    supported = ratio < 1.0

    cam = tuple(torch.as_tensor(a, dtype=f32, device=dev)
                for a in camera_pose)
    R, t = se3.compose(se3.inverse(cam), (vol.pose_r, vol.pose_t))
    vc = (p_warp[:, 0:1] * R[None, :, 0] + p_warp[:, 1:2] * R[None, :, 1]
          + p_warp[:, 2:3] * R[None, :, 2] + t)
    vcx, vcy, vcz = vc.unbind(-1)
    u = intr.fx * vcx / vcz + intr.cx
    v = intr.fy * vcy / vcz + intr.cy
    in_img = (u >= 0) & (v >= 0) & (u < W) & (v < H) & (vcz > 0)
    # (clamped before the integer cast: u is inf or NaN where vcz == 0)
    ui = torch.nan_to_num(torch.floor(u), nan=0.0).clamp(0, W - 1).long()
    vi = torch.nan_to_num(torch.floor(v), nan=0.0).clamp(0, H - 1).long()
    Dp = dists.to(f32)[vi, ui]
    cos_view = None
    if normals is not None and min_cos > 0.0:
        # ray/normal obliquity per pixel (the floor'd pixel's central ray),
        # rounded to float16 as the source's packed gather does
        xs_r = ((torch.arange(W, dtype=f32, device=dev) - intr.cx)
                / f32_scalar(intr.fx, dev))
        ys_r = ((torch.arange(H, dtype=f32, device=dev) - intr.cy)
                / f32_scalar(intr.fy, dev))
        rn = sqrt_rn((xs_r.double()[None, :] ** 2
                      + ys_r.double()[:, None] ** 2 + 1.0).to(f32))
        cos_img = -(xs_r[None, :] * normals[..., 0]
                    + ys_r[:, None] * normals[..., 1] + normals[..., 2]) / rn
        cos_view = cos_img.to(torch.float16)[vi, ui].to(f32)
    rnorm = norm3(vcx, vcy, vcz)
    sdf = Dp - rnorm

    update = ok & supported & in_img & (Dp != 0) & (sdf >= -config.trunc_dist)
    if cos_view is not None:
        update = update & torch.isfinite(cos_view) & (cos_view > min_cos)

    # running-average update at the compacted voxels
    tsdf_prev = F16[vx, vy, vz].to(f32)
    w_prev = Wu8[vx, vy, vz].to(f32)
    tsdf_in = torch.clamp_max(sdf * (1.0 / config.trunc_dist), 1.0)
    if cos_view is not None:
        # grazing observations pull the value at reduced strength; weights
        # stay the reference's uint8 counter
        conf = torch.clamp(torch.nan_to_num(cos_view, nan=0.0), 0.0, 1.0)
        tsdf_in = tsdf_prev * (1.0 - conf) + tsdf_in * conf
    tsdf_new = (tsdf_prev * w_prev + tsdf_in) / (w_prev + 1.0)
    w_new = torch.clamp_max(w_prev + 1.0, float(config.max_weight))
    tsdf_out = torch.where(update, tsdf_new, tsdf_prev).to(torch.float16)
    w_out = torch.where(update, w_new, w_prev).to(torch.uint8)

    # in place, at the captured (unique) band voxels only
    at = (vx[ok], vy[ok], vz[ok])
    F16.index_put_(at, tsdf_out[ok])
    Wu8.index_put_(at, w_out[ok])
    stats = FusionStats(n_band=n_band, n_captured=n_captured,
                        n_updated=update.sum(dtype=torch.int32))
    return vol, stats
