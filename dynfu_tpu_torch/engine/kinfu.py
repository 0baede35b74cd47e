"""Rigid KinectFusion engine state.

Port of the constructor state of dynfu_tpu/engine/kinfu.py (kfusion::KinFu):
the TSDF configuration, the volume and the pose history. The rigid frame
loop (ICP, raycast) is not ported yet; DynFusion builds on this state.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from dynfu_tpu_torch.engine.params import KinFuParams
from dynfu_tpu_torch.volume import tsdf as tv


def resolve_device(device) -> torch.device:
    """A torch.device; a CUDA device without a usable card raises — the
    engines never fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is "
                           "False")
    return device


class KinFu:
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
        self.volume_pose = (
            torch.eye(3, dtype=torch.float32, device=self.device),
            torch.tensor(p.volume_pose_t, dtype=torch.float32,
                         device=self.device))
        self.reset()

    def reset(self):
        """Pose -> identity, volume cleared (kinfu.cpp:121-130). Poses are
        host numpy (R, t) pairs."""
        self.frame_counter = 0
        self.poses: List[Tuple[np.ndarray, np.ndarray]] = [
            (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))]
        self.vol = tv.create(self.tsdf_config, self.volume_pose, self.device)
