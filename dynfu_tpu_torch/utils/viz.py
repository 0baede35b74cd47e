"""Offline point-cloud visualization — PointCloudViz analog.

Port of dynfu_tpu/utils/viz.py. The reference wraps an interactive OpenCV
Viz3d window (include/dynfu/utils/pointcloud_viz.hpp) which it refuses to
open over SSH (demo.cpp:179-185); this renders offline: a z-buffered splat
of the cloud into a shaded depth image, written as PNG by the caller.
Host-side numpy, as in the source: viz is not a per-frame hot path.
"""

from __future__ import annotations

import numpy as np
import torch

from dynfu_tpu_torch.core.camera import Intr


def render_cloud(
    points,
    intr: Intr,
    shape=(480, 640),
    splat: int = 2,
    background: float = 0.05,
) -> np.ndarray:
    """Render (N, 3) camera/world-frame points (numpy or a tensor on any
    device) to a (H, W, 3) uint8 image.

    Depth-shaded z-buffer splat: nearer points brighter; `splat` is the
    square splat radius in pixels.
    """
    if isinstance(points, torch.Tensor):
        points = points.detach().cpu().numpy()
    H, W = shape
    pts = np.asarray(points, np.float64)
    pts = pts[np.isfinite(pts).all(axis=1)]
    pts = pts[pts[:, 2] > 1e-6]
    zbuf = np.full((H, W), np.inf)
    if len(pts):
        u = np.round(intr.fx * pts[:, 0] / pts[:, 2] + intr.cx).astype(int)
        v = np.round(intr.fy * pts[:, 1] / pts[:, 2] + intr.cy).astype(int)
        ok = (u >= 0) & (u < W) & (v >= 0) & (v < H)
        u, v, z = u[ok], v[ok], pts[ok, 2]
        order = np.argsort(-z)  # nearest last wins
        for du in range(-splat, splat + 1):
            for dv in range(-splat, splat + 1):
                uu = np.clip(u[order] + du, 0, W - 1)
                vv = np.clip(v[order] + dv, 0, H - 1)
                zbuf[vv, uu] = z[order]
    hit = np.isfinite(zbuf)
    img = np.full((H, W), background)
    if hit.any():
        z = zbuf[hit]
        zmin, zmax = z.min(), z.max()
        span = (zmax - zmin) or 1.0
        img[hit] = 1.0 - 0.8 * (z - zmin) / span
    out = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return np.repeat(out[..., None], 3, axis=-1)
