"""Kinect-v1-realistic rendering of a deforming umbrella scene.

Copied unchanged (below this docstring) from dynfu_tpu/io/kinect_sim.py: it
is numpy only, but importing it from dynfu_tpu would run
dynfu_tpu/__init__.py, which imports jax.

The scene is the class of the reference's only end-to-end sequence, the
VolumeDeform "umbrella" RGB-D recording: a scalloped canopy opening and
closing on a nodding handle, in front of a wall and a floor, rendered
analytically (`render_umbrella`, the exact geometry at any phase) and passed
through a structured-light sensor model with the measured Kinect-v1 error
characteristics (`kinect_depth`): 1/8-px disparity quantization, axial noise
sigma_z(z) = 1.2 + 1.9 (z - 0.4)^2 mm, projector occlusion shadows,
grazing-incidence dropout and random speckle dropout. Every frame's
randomness is seeded (`umbrella_frame`), so its bytes are the same on every
run; no file is read or downloaded.
"""

from __future__ import annotations

import numpy as np

# Kinect v1 constants
FB_PX_M = 43.5  # focal(px) * baseline(m): 580 px * 0.075 m
DISP_STEP = 1.0 / 8.0  # disparity quantization (px)
SHADOW_DIR = -1  # occlusion shadow falls on the -u side of near edges


def _rays(h, w, fx, fy, cx, cy):
    rx = (np.arange(w) - cx) / fx
    ry = (np.arange(h) - cy) / fy
    rx = np.broadcast_to(rx, (h, w))
    ry = np.broadcast_to(ry[:, None], (h, w))
    return rx, ry  # ray p(z) = z * (rx, ry, 1)


def _sphere_z(rx, ry, center, radius):
    """Smallest positive z with |z*r - C| = R (z-depth, not ray length)."""
    a = rx * rx + ry * ry + 1.0
    b = -2.0 * (rx * center[0] + ry * center[1] + center[2])
    c = center @ center - radius * radius
    disc = b * b - 4 * a * c
    ok = disc > 0
    z = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a)
    return np.where(ok & (z > 0.05), z, np.inf)


def _cylinder_z(rx, ry, p0, axis, radius, length):
    """Finite open cylinder from p0 along unit `axis`."""
    d = np.stack([rx, ry, np.ones_like(rx)], -1)
    dp = d - (d @ axis)[..., None] * axis
    op = p0 - (p0 @ axis) * axis
    a = np.sum(dp * dp, -1)
    b = -2.0 * (dp @ op)
    c = op @ op - radius * radius
    disc = b * b - 4 * a * c
    ok = disc > 0
    z = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * np.maximum(a, 1e-12))
    s = (z[..., None] * d - p0) @ axis  # axial coordinate of the hit
    ok &= (z > 0.05) & (s >= 0.0) & (s <= length)
    return np.where(ok, z, np.inf)


def render_umbrella(phase, h=480, w=640, fx=525.0, fy=525.0,
                    cx=None, cy=None):
    """Clean z-depth (meters, np.inf = no surface) of the umbrella scene at
    deformation phase in [0, 1): the canopy's opening half-angle and the
    handle tilt both breathe — a genuinely non-rigid surface motion."""
    cx = w / 2 - 0.5 if cx is None else cx
    cy = h / 2 - 0.5 if cy is None else cy
    rx, ry = _rays(h, w, fx, fy, cx, cy)

    # deformation: opening angle 43° -> 66°, axis nodding up to ~9°
    theta = 0.75 + 0.40 * 0.5 * (1 - np.cos(2 * np.pi * phase))
    tilt = 0.16 * np.sin(2 * np.pi * phase)
    axis = np.array([np.sin(tilt), np.cos(tilt), -0.25])  # handle direction
    axis = axis / np.linalg.norm(axis)

    C = np.array([0.0, -0.08, 1.35])  # canopy sphere center
    R = 0.42

    z = np.full((h, w), np.inf)

    # canopy: spherical cap about -axis with a scalloped (ribbed) edge
    zs = _sphere_z(rx, ry, C, R)
    hit = np.isfinite(zs)
    with np.errstate(invalid="ignore"):  # rays that miss carry inf/NaN
        p = (np.where(hit, zs, 0.0)[..., None]
             * np.stack([rx, ry, np.ones_like(rx)], -1) - C)
        ca = -(p @ axis) / R  # cos(angle from cap apex)
        # azimuth around the axis for the 8-rib scallop
        e1 = np.cross(axis, [0.0, 0.0, 1.0])
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(axis, e1)
        phi = np.arctan2(p @ e2, p @ e1)
    theta_edge = theta + 0.05 * np.sin(8 * phi)
    cap = hit & (ca >= np.cos(theta_edge))
    z = np.where(cap, zs, z)

    # handle: from the cap apex through the canopy, 0.62 m long
    apex = C - R * axis
    zc = _cylinder_z(rx, ry, apex, axis, 0.018, 0.62 + R)
    z = np.minimum(z, zc)

    # wall + floor
    z = np.minimum(z, 2.15)  # wall plane z = 2.15
    zf = np.where(ry > 1e-6, 0.55 / np.maximum(ry, 1e-6), np.inf)  # y=0.55
    z = np.minimum(z, zf)
    return z


def kinect_depth(z_m, seed=0):
    """Apply the Kinect-v1 sensor model to clean z-depth (meters, inf = no
    return). Returns int32 depth in mm with 0 = invalid, the layout the
    engine and the 16-bit dataset PNGs use."""
    rng = np.random.default_rng(seed)
    h, w = z_m.shape
    valid = np.isfinite(z_m) & (z_m > 0.4) & (z_m < 4.0)
    z = np.where(valid, z_m, np.nan)

    # axial noise then 1/8-px disparity quantization (z² resolution decay)
    sigma = 0.0012 + 0.0019 * (z - 0.4) ** 2
    z = z + sigma * rng.standard_normal((h, w))
    d = FB_PX_M / z
    d = np.round(d / DISP_STEP) * DISP_STEP
    z = FB_PX_M / d

    # occlusion shadow: pixels whose disparity jumps DOWN moving in the
    # shadow direction lose the projector; width = disparity difference
    dq = np.where(valid, d, 0.0)
    shadow = np.zeros((h, w), bool)
    max_w = 8
    for k in range(1, max_w + 1):
        nb = np.roll(dq, -SHADOW_DIR * k, axis=1)  # neighbor toward edge
        edge = (nb - dq) > k  # nearer by >= k px of disparity
        if SHADOW_DIR < 0:
            edge[:, :k] = False
        else:
            edge[:, -k:] = False
        shadow |= edge

    # grazing-incidence dropout from the screen-space depth gradient
    gy, gx = np.gradient(np.where(valid, z, 0.0))
    grad = np.hypot(gx, gy)
    p_drop = np.clip((grad - 0.01) * 30.0, 0.0, 0.9)
    drop = rng.random((h, w)) < p_drop
    speckle = rng.random((h, w)) < 0.004

    ok = valid & ~shadow & ~drop & ~speckle
    out = np.where(ok, np.nan_to_num(z) * 1000.0, 0.0)
    return out.astype(np.int32)


def umbrella_frame(i, frames=16, h=480, w=640, fx=525.0, fy=525.0):
    """Frame i of the vendored sequence (deterministic)."""
    phase = i / float(frames)
    return kinect_depth(render_umbrella(phase, h, w, fx, fy), seed=1000 + i)
