"""Synthetic depth generators.

`sphere_depth` is copied unchanged from dynfu_tpu/io/datasets.py (numpy
only; importing it from dynfu_tpu would import jax).
"""

from __future__ import annotations

import numpy as np


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
