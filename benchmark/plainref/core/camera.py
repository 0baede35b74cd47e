"""Pinhole camera intrinsics.

Port of the Intr dataclass of dynfu_tpu/core/camera.py (kfusion::Intr),
with its pyramid-level scaling and its projections.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Intr:
    fx: float
    fy: float
    cx: float
    cy: float

    def level(self, index: int) -> "Intr":
        """The intrinsics of pyramid level `index` (precomp.cpp:10-13):
        focal lengths and centre divided by 2**index."""
        div = 1 << index
        return Intr(self.fx / div, self.fy / div, self.cx / div,
                    self.cy / div)

    def project(self, p: torch.Tensor) -> torch.Tensor:
        """Camera-space points (..., 3) -> pixel coordinates (..., 2) [u, v]
        (device::Projector, device.hpp:40-45): u = fx x / z + cx."""
        z = p[..., 2]
        return torch.stack([self.fx * p[..., 0] / z + self.cx,
                            self.fy * p[..., 1] / z + self.cy], -1)

    def reproject(self, u, v, z) -> torch.Tensor:
        """Pixel coordinates and depth -> camera-space points (..., 3)
        (device::Reprojector, device.hpp:50-54)."""
        z = torch.as_tensor(z)
        return torch.stack([z * (u - self.cx) / self.fx,
                            z * (v - self.cy) / self.fy, z], -1)
