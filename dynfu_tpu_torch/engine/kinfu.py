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
failing frame itself, as the reference does (kinfu.cpp:189-191). The
integrate is the per-voxel one and the raycast the per-ray march (any pose;
volume/tsdf.py); the separable and homography paths are TPU devices.
The stages run inside rigid/* profiler ranges (utils/rigid_profile.py reads
them).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from dynfu_tpu_torch.engine.params import KinFuParams
from dynfu_tpu_torch.ops import imgproc
from dynfu_tpu_torch.rigid import icp
from dynfu_tpu_torch.volume import tsdf as tv


def _stage(name: str):
    """A named range of the rigid frame for torch.profiler; near free when
    no profiler runs."""
    return torch.profiler.record_function(f"rigid/{name}")


def resolve_device(device) -> torch.device:
    """A torch.device; a CUDA device without a usable card raises — the
    engines never fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is "
                           "False")
    return device


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
        kw = dict(iters=p.icp_iter_num, dist_thres=p.icp_dist_thres,
                  angle_thres=p.icp_angle_thres)

        def pull(res):
            (R, t), ok = res
            return torch.cat([R.reshape(-1), t,
                              ok.to(torch.float32)[None]]).cpu().numpy()

        packed = None
        if p.icp_assoc == "stencil":
            packed = pull(icp.estimate_transform_stencil(
                curr_pyr, prev_pyr, p.intr, radii=p.icp_stencil_radii, **kw))
        if packed is None or packed[12] == 0.0:
            packed = pull(icp.estimate_transform(curr_pyr, prev_pyr, p.intr,
                                                 **kw))
        return packed

    def _push_pose(self, packed: np.ndarray) -> None:
        """pose = pose * increment (kinfu.cpp:194), on the host."""
        R, t = packed[:9].reshape(3, 3), packed[9:12]
        Rp, tp = self.poses[-1]
        self.poses.append((Rp @ R, Rp @ t + tp))

    def __call__(self, depth_mm, image=None) -> bool:
        """Frame ingestion; `image` is accepted and unused, as in the
        reference. Frames 0 and 1 return False, later frames True
        (kinfu.cpp:229-233); a reset returns False."""
        del image
        p = self.params
        with _stage("preprocess"):
            dists, curr_pyr = self._preprocess(self._depth(depth_mm))

        if self.frame_counter == 0:
            self.vol = tv.integrate(self.vol, dists, self.poses[-1], p.intr,
                                    self.tsdf_config)
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
            self.vol = tv.integrate(self.vol, dists, self.poses[-1], p.intr,
                                    self.tsdf_config, fresh=True)
        with _stage("raycast"):
            pts, nrm = tv.raycast(self.vol, self.poses[-1], p.intr,
                                  (p.rows, p.cols), self.tsdf_config)
        with _stage("pyramid"):
            self.prev_pyr = icp.build_pyramids(pts, nrm, self.levels)

        was = self.frame_counter
        self.frame_counter += 1
        return was >= 2

    def get_mesh(self, max_voxels: int = 1 << 17,
                 max_verts: int = 3 * 600_000):
        """Marching-cubes triangle soup of the current volume in the WORLD
        frame (KinFu::getMesh, kinfu.cpp:237-259): (vertices (n, 3), n)."""
        from dynfu_tpu_torch.mesh.mc import marching_cubes, mesh_to_world

        verts, n, _ = marching_cubes(self.vol, self.tsdf_config,
                                     max_voxels=max_voxels,
                                     max_verts=max_verts)
        return mesh_to_world(verts[:int(n)], self.vol), int(n)
