"""Rigid KinectFusion engine.

Port of dynfu_tpu/engine/kinfu.py (kfusion::KinFu, kinfu.cpp:46-316), the
points (non-USE_DEPTH) variant the reference builds by default:

  dists -> bilateral -> [truncate] -> depth pyramid -> point/normal pyramid
  frame 0: integrate, keep the pyramid as the reference.
  frame k: stencil ICP against the previous raycast pyramid (the gather ICP
    as the rescue tier when it fails) -> reset on a second failure ->
    pose = pose * increment -> clear + integrate -> raycast -> the next
    reference pyramid.

The source fuses the whole frame into one TPU program and resolves its
(R, t, ok) readback one frame late, because a readback costs ~28 ms through
its TPU host. Here the frame runs eagerly on the engine's device and reads
the 13 packed floats once per frame, so a degenerate ICP resets on the
failing frame itself, as the reference does (kinfu.cpp:189-191).

The integrate and the raycast take the formulation the source's dispatch
picks for the pose (`_integrate`, `_raycast`; volume/tsdf.py): an aligned
camera integrates with the separable formulation (the per-voxel integrate
with its rounding) and raycasts with the separable sweep; with
raycast_mode "auto" a camera tilted under 0.6 rad integrates through the
rotation homography and raycasts through the rotated sweep, if a
virtual-image margin covers its frustum; otherwise the per-voxel integrate
and, under 1.1 rad, the slab sweep, beyond it the per-ray march. The
source's fused frame (fused_frame=True) runs the same formulations but
dispatches on a pose up to two frames stale; the port runs every frame
per stage with the current pose, so fused_frame changes nothing here.
FORMULATIONS counts the calls that took each, over every engine. The
stages run inside rigid/* profiler ranges (utils/rigid_profile.py reads
them).
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional, Tuple

import numpy as np
import torch

from plainref.engine.params import KinFuParams
from plainref.kernels import resolve_device
from plainref.ops import imgproc
from plainref.rigid import icp
from plainref.volume import tsdf as tv


# calls per formulation over every engine, e.g. "integrate:rotated",
# "raycast:sweep" (chip_smoke.py reads them per path, as the launch counts)
FORMULATIONS: Counter = Counter()


def _stage(name: str):
    """A named range of the rigid frame for torch.profiler; near free when
    no profiler runs."""
    return torch.profiler.record_function(f"rigid/{name}")


def pull(res) -> np.ndarray:
    """((R, t), ok) of an ICP -> the packed host array (R (9), t (3), ok):
    one read of 13 floats."""
    (R, t), ok = res
    return torch.cat([R.reshape(-1), t,
                      ok.to(torch.float32)[None]]).cpu().numpy()


class KinFu:
    """Rigid fusion engine. Call with (H, W) integer mm depth images (numpy
    or tensor, uint16 or int32)."""

    def __init__(self, params: Optional[KinFuParams] = None, device="cuda"):
        self.device = resolve_device(device)
        self.params = params or KinFuParams.default_params()
        p = self.params
        if p.volume_dims[0] % 32:
            raise ValueError("volume_dims[0] must be a multiple of 32 "
                             "(kinfu.cpp:47)")
        if p.raycast_mode not in ("auto", "exact"):
            raise ValueError(f"raycast_mode {p.raycast_mode!r}: 'auto' or "
                             "'exact'")
        self.tsdf_config = tv.TsdfConfig(
            dims=p.volume_dims, size=p.volume_size,
            trunc_dist=p.tsdf_trunc_dist, max_weight=p.tsdf_max_weight,
            raycast_step_factor=p.raycast_step_factor,
            gradient_delta_factor=p.gradient_delta_factor)
        self.levels = len(p.icp_iter_num)
        self.volume_pose = (
            torch.eye(3, dtype=torch.float32, device=self.device),
            torch.tensor(p.volume_pose_t, dtype=torch.float32,
                         device=self.device))
        self.resets = 0
        self.reset()

    def reset(self):
        """Pose -> identity, volume cleared (kinfu.cpp:121-130). Poses are
        host numpy (R, t) pairs."""
        self.frame_counter = 0
        self.poses: List[Tuple[np.ndarray, np.ndarray]] = [
            (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))]
        self.vol = tv.create(self.tsdf_config, self.volume_pose, self.device)
        self.prev_pyr = None

    # -- accessors (kinfu.hpp:74-90) ----------------------------------------
    def tsdf(self) -> tv.TsdfVolume:
        return self.vol

    def get_camera_pose(self, time: int = -1):
        """poses[time] with the reference's clamp (kinfu.cpp:133-139)."""
        if time > len(self.poses) or time < 0:
            time = len(self.poses) - 1
        return self.poses[time]

    # -- per frame ----------------------------------------------------------
    def _depth(self, depth_mm) -> torch.Tensor:
        if isinstance(depth_mm, torch.Tensor):
            return depth_mm.to(device=self.device, dtype=torch.int32)
        return torch.as_tensor(np.asarray(depth_mm).astype(np.int32),
                               device=self.device)

    def _preprocess(self, depth_mm: torch.Tensor):
        """dists and the point/normal pyramid of the filtered depth
        (kinfu.cpp:144-161)."""
        p = self.params
        dists = imgproc.compute_dists(depth_mm, p.intr)
        filtered = imgproc.bilateral_filter(
            depth_mm, p.bilateral_kernel_size, p.bilateral_sigma_spatial,
            p.bilateral_sigma_depth)
        if p.icp_truncate_depth_dist > 0:
            filtered = imgproc.truncate_depth(filtered,
                                              p.icp_truncate_depth_dist)
        depth_pyr = [filtered]
        for _ in range(1, self.levels):
            depth_pyr.append(imgproc.depth_pyramid_down(
                depth_pyr[-1], p.bilateral_sigma_depth))
        pyr = [imgproc.compute_points_normals(d, p.intr.level(i))
               for i, d in enumerate(depth_pyr)]
        return dists, pyr

    def _track(self, curr_pyr, prev_pyr) -> np.ndarray:
        """The frame's ICP: the stencil association, then the gather one as
        the rescue tier where the stencil system went degenerate. Returns
        the packed (R (9), t (3), ok) on the host: one read per tier run."""
        p = self.params
        packed = None
        if p.icp_assoc == "stencil":
            packed = pull(icp.estimate_transform_stencil(
                curr_pyr, prev_pyr, p.intr, radii=p.icp_stencil_radii,
                **self._icp_kw()))
        if packed is None or packed[12] == 0.0:
            packed = self._track_gather(curr_pyr, prev_pyr)
        return packed

    def _icp_kw(self) -> dict:
        p = self.params
        return dict(iters=p.icp_iter_num, dist_thres=p.icp_dist_thres,
                    angle_thres=p.icp_angle_thres)

    def _track_gather(self, curr_pyr, prev_pyr) -> np.ndarray:
        """The gather ICP alone (rigid/icp.estimate_transform), packed as
        `_track` packs it."""
        return pull(icp.estimate_transform(curr_pyr, prev_pyr,
                                           self.params.intr,
                                           **self._icp_kw()))

    def _push_pose(self, packed: np.ndarray) -> None:
        """pose = pose * increment (kinfu.cpp:194), on the host."""
        R, t = packed[:9].reshape(3, 3), packed[9:12]
        Rp, tp = self.poses[-1]
        self.poses.append((Rp @ R, Rp @ t + tp))

    # -- the integrate / raycast dispatch (source: kinfu.py:223-316) --------
    # camera tilt (radians) up to which the homography formulations cover
    # the real frustum with the default virtual-image margin
    MAX_HOMOGRAPHY_TILT = 0.6
    # the virtual-image margins raycast_rotated may use; beyond the largest
    # the dispatch falls through to the sweep or the march
    RAYCAST_MARGIN_BUCKETS = (1.15, 1.35, 1.6, 2.0, 2.5)
    # beyond this tilt a pixel's ray can leave the +z half-space, which the
    # slab sweep cannot march
    MAX_SWEEP_TILT = 1.1

    def _rotation_angle(self, pose) -> float:
        R = np.asarray(pose[0])
        return float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0,
                                       1.0)))

    def _raycast_margin(self, pose) -> Optional[float]:
        """The smallest margin bucket whose virtual frustum covers the real
        one under this pose's rotation, or None. raycast_rotated maps each
        real pixel into the virtual image by u' = Kv R^T K^-1 u; the image
        rectangle maps to a convex quad, so its four corners (in float64)
        bound every pixel, with 2 % and 0.01 of slack."""
        p = self.params
        W, H = p.cols, p.rows
        R_cam = np.asarray(pose[0], np.float64)
        corners = np.array([[0.0, 0.0], [W - 1.0, 0.0],
                            [0.0, H - 1.0], [W - 1.0, H - 1.0]])
        d = np.stack([(corners[:, 0] - p.intr.cx) / p.intr.fx,
                      (corners[:, 1] - p.intr.cy) / p.intr.fy,
                      np.ones(4)], axis=1)
        dv = d @ R_cam.T
        if np.any(dv[:, 2] < 0.05):  # a corner ray ~parallel to the plane
            return None
        need_x = np.max(np.abs(p.intr.fx * dv[:, 0] / dv[:, 2]))
        need_y = np.max(np.abs(p.intr.fy * dv[:, 1] / dv[:, 2]))
        required = max(need_x / (W / 2.0), need_y / (H / 2.0)) * 1.02 + 0.01
        for m in self.RAYCAST_MARGIN_BUCKETS:
            if m >= required:
                return m
        return None

    def _aligned(self, pose) -> bool:
        """The camera's rotation is the identity (atol 1e-6): the separable
        formulations apply."""
        return bool(np.allclose(np.asarray(pose[0]), np.eye(3), atol=1e-6))

    def _integrate_mode(self, pose) -> str:
        """The source's integrate for the pose, by its names: "separable"
        (aligned), "rotated" (a tilt under MAX_HOMOGRAPHY_TILT) or "gather"
        (per voxel)."""
        if self._aligned(pose):
            return "separable"
        if self._rotation_angle(pose) < self.MAX_HOMOGRAPHY_TILT:
            return "rotated"
        return "gather"

    def _integrate(self, dists, pose, fresh: bool = False):
        """The source's dispatch: aligned -> the separable integrate;
        raycast_mode "auto" and a tilt under MAX_HOMOGRAPHY_TILT -> the
        homography-warped integrate; otherwise per voxel. Returns the new
        volume."""
        p = self.params
        mode = self._integrate_mode(pose)
        if mode == "rotated" and p.raycast_mode != "auto":
            mode = "gather"
        FORMULATIONS[f"integrate:{mode}"] += 1
        args = (self.vol, dists, pose, p.intr, self.tsdf_config)
        if mode == "rotated":
            return tv.integrate_rotated(*args, fresh=fresh)
        return tv.integrate(*args, fresh=fresh,
                            separable=mode == "separable")

    def _raycast(self, pose):
        """The source's dispatch: aligned -> the separable sweep; with
        raycast_mode "auto" and a margin bucket that covers the frustum ->
        the rotated sweep at that margin; under MAX_SWEEP_TILT -> the slab
        sweep; beyond -> the per-ray march. Returns (points, normals)."""
        p = self.params
        margin = (self._raycast_margin(pose) if p.raycast_mode == "auto"
                  else None)
        args = (self.vol, pose, p.intr, (p.rows, p.cols), self.tsdf_config)
        if self._aligned(pose):
            name, fn, kw = "separable", tv.raycast_separable, {}
        elif margin is not None:
            name, fn = "rotated", tv.raycast_rotated
            kw = {"fov_margin": margin}
        elif self._rotation_angle(pose) < self.MAX_SWEEP_TILT:
            name, fn, kw = "sweep", tv.raycast, {}
        else:
            name, fn, kw = "march", tv.raycast_march, {}
        FORMULATIONS[f"raycast:{name}"] += 1
        return fn(*args, **kw)

    def __call__(self, depth_mm, image=None) -> bool:
        """Frame ingestion; `image` is accepted and unused, as in the
        reference. Frames 0 and 1 return False, later frames True
        (kinfu.cpp:229-233); a reset returns False."""
        del image
        with _stage("preprocess"):
            dists, curr_pyr = self._preprocess(self._depth(depth_mm))

        if self.frame_counter == 0:
            self.vol = self._integrate(dists, self.poses[-1])
            self.prev_pyr = curr_pyr
            self.frame_counter += 1
            return False

        with _stage("icp"):
            packed = self._track(curr_pyr, self.prev_pyr)
        if packed[12] == 0.0:
            self.resets += 1
            self.reset()
            return False
        self._push_pose(packed)

        with _stage("integrate"):  # always clear + re-integrate
            self.vol = self._integrate(dists, self.poses[-1], fresh=True)
        with _stage("raycast"):
            pts, nrm = self._raycast(self.poses[-1])
        with _stage("pyramid"):
            self.prev_pyr = icp.build_pyramids(pts, nrm, self.levels)

        was = self.frame_counter
        self.frame_counter += 1
        return was >= 2

    def get_mesh(self, max_voxels: int = 1 << 17,
                 max_verts: int = 3 * 600_000):
        """Marching-cubes triangle soup of the current volume in the WORLD
        frame (KinFu::getMesh, kinfu.cpp:237-259): (vertices (n, 3), n)."""
        from plainref.mesh.mc import marching_cubes, mesh_to_world

        verts, n, _ = marching_cubes(self.vol, self.tsdf_config,
                                     max_voxels=max_voxels,
                                     max_verts=max_verts)
        return mesh_to_world(verts[:int(n)], self.vol), int(n)

    # -- rendering (kinfu.cpp:261-316) --------------------------------------
    def render(self, flag: int = 0) -> torch.Tensor:
        """Phong render of the reference model view (prev_pyr level 0),
        (H, W, 3) uint8 (KinFu::renderImage, kinfu.cpp:261-292)."""
        if self.prev_pyr is None:
            raise RuntimeError("no frames processed")
        return self._render(*self.prev_pyr[0], flag)

    def _render(self, pts, nrm, flag: int) -> torch.Tensor:
        """As the source's code selects: flag 2 the tangent-colour normals,
        1 and 3 the shaded surface and the tangent colours side by side, any
        other flag the shaded surface."""
        light = self.params.light_pose
        if flag < 1 or flag > 3:
            return imgproc.render_image_points(pts, nrm, light)
        if flag == 2:
            return imgproc.render_tangent_colors(nrm)
        return torch.cat([imgproc.render_image_points(pts, nrm, light),
                          imgproc.render_tangent_colors(nrm)], dim=1)
