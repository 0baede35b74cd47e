"""Synthetic depth generators.

`sphere_depth` and `generate_synthetic` are copied unchanged from
dynfu_tpu/io/datasets.py (numpy only; the port loads nothing of the JAX
package, whose imports bring JAX in). `dynfu-torch synth <dir>` writes the sequence and
`dynfu-torch run <dir>` consumes it.
"""

from __future__ import annotations

import os

import numpy as np

from dynfu_tpu_torch.io import meshio


def sphere_depth(center, radius, h, w, fx, fy, cx, cy, cam_t=(0.0, 0.0, 0.0)):
    """Analytic depth (int32 mm) of a sphere from a +z-looking camera."""
    u = (np.arange(w) - cx) / fx
    v = ((np.arange(h) - cy) / fy)[:, None]
    d = np.stack([np.broadcast_to(u, (h, w)), np.broadcast_to(v, (h, w)),
                  np.ones((h, w))], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    oc = np.asarray(cam_t, np.float64) - np.asarray(center, np.float64)
    b = 2.0 * d @ oc
    c = oc @ oc - radius * radius
    disc = b * b - 4 * c
    hit = disc > 0
    t = (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0
    z = t * d[..., 2]
    return np.where(hit & (z > 0), z * 1000.0, 0.0).astype(np.int32)


def generate_synthetic(
    out_dir: str,
    frames: int = 30,
    h: int = 480,
    w: int = 640,
    fx: float = 525.0,
    fy: float = 525.0,
    motion: str = "deform",
) -> str:
    """Write a deforming two-blob sequence: a large sphere translating
    laterally while a smaller one 'breathes' — exercises warp tracking AND
    node insertion. Layout: <out_dir>/depth/frame%04d.png (16-bit mm)."""
    cx, cy = w / 2 - 0.5, h / 2 - 0.5
    depth_dir = os.path.join(out_dir, "depth")
    os.makedirs(depth_dir, exist_ok=True)
    for i in range(frames):
        phase = i / max(frames - 1, 1)
        dx = 0.04 * np.sin(2 * np.pi * phase)
        big = sphere_depth((dx, 0.0, 1.5), 0.5, h, w, fx, fy, cx, cy)
        r2 = 0.15 + 0.03 * np.sin(4 * np.pi * phase)
        small = sphere_depth((0.55, 0.35, 1.3), r2, h, w, fx, fy, cx, cy)
        both = np.where(
            (small > 0) & ((big == 0) | (small < big)), small, big
        )
        meshio.save_depth_png(
            os.path.join(depth_dir, f"frame{i:04d}.png"), both
        )
    return out_dir
