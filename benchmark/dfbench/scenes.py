"""The general traffic generator: depth frames of a mix file, from a seed.

A mix (benchmark/traffic/<name>.json) names a scene kind and its
parameters; `make` renders one period of the mix's depth frames on the
given device, in chunks, and returns them as host uint16 arrays (mm, 0 = no
return), the layout a depth camera delivers. The run replays the period
cyclically from the mix's `start` (a fraction of the period), forwards or
backwards as the seed draws: every seed sees the same frames, from the
same first frame, in one of two orders. (A starting phase drawn from the
seed changed the work: the sweep's first frame sets the canonical surface,
and the farther the sphere then travels from it, the more nodes it needs.)

Scene kinds (copied from the port's generators, which stay as they are):

* "spheres": spheres seen by a +z-looking pinhole camera, per pixel the
  nearest surface (utils/benchmarks.spheres_depth, io/datasets.sphere_depth).
  The spheres move together by `object_step` a frame and the camera by
  `camera_step`, each along a triangle wave of `*_leg` frames a leg,
  centred on `*_center` frames (0 leg: no motion). The first sphere may
  breathe: its radius is r + `radius_amp` sin(2 pi t / `radius_period`)
  (utils/benchmarks._breathing_radius; absent or 0: it keeps its radius).
* "umbrella": the Kinect-v1 umbrella scene (io/kinect_sim.py): a scalloped
  canopy breathing on a nodding handle in front of a wall and a floor,
  through the sensor model (disparity quantisation, axial noise, occlusion
  shadows, grazing and speckle dropout), `period` frames a breath.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

CHUNK = 8  # frames rendered per call: keeps the generator's memory small


class Frames(NamedTuple):
    """One period of a mix: frames[j] is the depth at cycle position j;
    run frame k is frames[(start + step k) % period], step +1 or -1;
    truth[j] what the scene held there (object offset, camera position or
    phase)."""

    frames: list
    start: int
    step: int
    truth: list

    @property
    def period(self) -> int:
        return len(self.frames)

    def index(self, k: int) -> int:
        return (self.start + self.step * k) % self.period

    def depth(self, k: int) -> np.ndarray:
        return self.frames[self.index(k)]


def triangle(t, leg: int, center: float):
    """Position along a back-and-forth path of `leg` frames a leg, minus
    `center`: 0, 1, .., leg, leg - 1, .., 1, 0, ... (t may be an array)."""
    if leg <= 0:
        return np.zeros_like(np.asarray(t, np.float64))
    s = np.asarray(t) % (2 * leg)
    return np.where(s <= leg, s, 2 * leg - s).astype(np.float64) - center


def period_of(mix: dict) -> int:
    if mix["scene"] == "spheres":
        legs = [2 * mix[k] for k in ("object_leg", "camera_leg") if mix[k]]
        if mix.get("radius_amp"):
            legs.append(int(mix["radius_period"]))
        return math.lcm(*legs) if legs else 1
    if mix["scene"] == "umbrella":
        return int(mix["period"])
    raise ValueError(f"unknown scene kind {mix['scene']!r}")


def _rays(rows, cols, fx, fy, cx, cy, device):
    rx = (torch.arange(cols, dtype=torch.float64, device=device) - cx) / fx
    ry = (torch.arange(rows, dtype=torch.float64, device=device) - cy) / fy
    return rx[None, :].expand(rows, cols), ry[:, None].expand(rows, cols)


def sphere_depth(centers: torch.Tensor, radius, cam, rows: int,
                 cols: int, fx: float, fy: float, cx: float, cy: float):
    """(F, rows, cols) int32 mm depth of a sphere at centers (F, 3) with
    radius (a number, or (F,)) seen from cameras at cam (F, 3) looking down
    +z: the ray-sphere hit's z, truncated to mm, 0 where the ray misses
    (io/datasets.sphere_depth)."""
    rx, ry = _rays(rows, cols, fx, fy, cx, cy, centers.device)
    d = torch.stack([rx, ry, torch.ones_like(rx)], -1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    oc = cam - centers  # (F, 3)
    b = 2.0 * torch.einsum("hwc,fc->fhw", d, oc)
    c = (oc * oc).sum(-1) - torch.as_tensor(radius, dtype=oc.dtype,
                                            device=oc.device) ** 2
    disc = b * b - 4 * c[:, None, None]
    hit = disc > 0
    t = (-b - torch.sqrt(torch.clamp_min(disc, 0.0))) / 2.0
    z = t * d[..., 2]
    return torch.where(hit & (z > 0), z * 1000.0, 0.0).to(torch.int32)


def radius_of(mix: dict, ts) -> np.ndarray:
    """The first sphere's radius at times ts."""
    r = mix["spheres"][0][1]
    amp = mix.get("radius_amp", 0.0)
    if not amp:
        return np.full(np.shape(ts), float(r))
    return r + amp * np.sin(2 * np.pi * np.asarray(ts, np.float64)
                            / mix["radius_period"])


def spheres_frames(mix: dict, camera: dict, ts, device):
    """Depth (F, rows, cols) uint16 of the spheres scene at times ts."""
    rows, cols = camera["rows"], camera["cols"]
    fx, fy = camera["fx"], camera["fy"]
    cx, cy = cols / 2 - 0.5, rows / 2 - 0.5
    f64 = torch.float64
    obj = torch.as_tensor(
        triangle(ts, mix["object_leg"], mix["object_center"])[:, None]
        * np.asarray(mix["object_step"]), dtype=f64, device=device)
    cam = torch.as_tensor(
        triangle(ts, mix["camera_leg"], mix["camera_center"])[:, None]
        * np.asarray(mix["camera_step"]), dtype=f64, device=device)
    big = torch.iinfo(torch.int32).max
    out = None
    for i, (c, r) in enumerate(mix["spheres"]):
        if i == 0:
            r = torch.as_tensor(radius_of(mix, ts), dtype=f64, device=device)
        d = sphere_depth(torch.as_tensor(c, dtype=f64, device=device) + obj,
                         r, cam, rows, cols, fx, fy, cx, cy)
        d = torch.where(d == 0, big, d)
        out = d if out is None else torch.minimum(out, d)
    return torch.where(out == big, 0, out).to(torch.int32)


# --- the umbrella scene (io/kinect_sim.py, in torch) ------------------------
FB_PX_M = 43.5  # focal(px) * baseline(m): 580 px * 0.075 m
DISP_STEP = 1.0 / 8.0  # disparity quantization (px)
SHADOW_DIR = -1  # occlusion shadow falls on the -u side of near edges


def _sphere_z(rx, ry, center, radius):
    a = rx * rx + ry * ry + 1.0
    b = -2.0 * (rx * center[0] + ry * center[1] + center[2])
    c = float(center @ center) - radius * radius
    disc = b * b - 4 * a * c
    z = (-b - torch.sqrt(torch.clamp_min(disc, 0.0))) / (2 * a)
    return torch.where((disc > 0) & (z > 0.05), z, math.inf)


def _cylinder_z(rx, ry, p0, axis, radius, length):
    d = torch.stack([rx, ry, torch.ones_like(rx)], -1)
    ax = torch.as_tensor(axis, dtype=d.dtype, device=d.device)
    p0t = torch.as_tensor(p0, dtype=d.dtype, device=d.device)
    dp = d - (d @ ax)[..., None] * ax
    op = p0t - (p0t @ ax) * ax
    a = (dp * dp).sum(-1)
    b = -2.0 * (dp @ op)
    c = float(op @ op) - radius * radius
    disc = b * b - 4 * a * c
    z = (-b - torch.sqrt(torch.clamp_min(disc, 0.0))) / (
        2 * torch.clamp_min(a, 1e-12))
    s = (z[..., None] * d - p0t) @ ax
    ok = (disc > 0) & (z > 0.05) & (s >= 0.0) & (s <= length)
    return torch.where(ok, z, math.inf)


def render_umbrella(phase: float, camera: dict, device) -> torch.Tensor:
    """Clean z-depth (m, inf = no surface) of the umbrella scene at
    deformation phase in [0, 1) (kinect_sim.render_umbrella)."""
    rows, cols = camera["rows"], camera["cols"]
    rx, ry = _rays(rows, cols, camera["fx"], camera["fy"], cols / 2 - 0.5,
                   rows / 2 - 0.5, device)
    theta = 0.75 + 0.40 * 0.5 * (1 - math.cos(2 * math.pi * phase))
    tilt = 0.16 * math.sin(2 * math.pi * phase)
    axis = np.array([math.sin(tilt), math.cos(tilt), -0.25])
    axis = axis / np.linalg.norm(axis)
    C = np.array([0.0, -0.08, 1.35])
    R = 0.42
    zs = _sphere_z(rx, ry, C, R)
    hit = torch.isfinite(zs)
    d = torch.stack([rx, ry, torch.ones_like(rx)], -1)
    p = torch.where(hit, zs, 0.0)[..., None] * d - torch.as_tensor(
        C, dtype=d.dtype, device=device)
    ax = torch.as_tensor(axis, dtype=d.dtype, device=device)
    ca = -(p @ ax) / R
    e1 = np.cross(axis, [0.0, 0.0, 1.0])
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(axis, e1)
    phi = torch.atan2(p @ torch.as_tensor(e2, dtype=d.dtype, device=device),
                      p @ torch.as_tensor(e1, dtype=d.dtype, device=device))
    theta_edge = theta + 0.05 * torch.sin(8 * phi)
    cap = hit & (ca >= torch.cos(theta_edge))
    z = torch.where(cap, zs, math.inf)
    apex = C - R * axis
    z = torch.minimum(z, _cylinder_z(rx, ry, apex, axis, 0.018, 0.62 + R))
    z = torch.clamp_max(z, 2.15)  # the wall
    zf = torch.where(ry > 1e-6, 0.55 / torch.clamp_min(ry, 1e-6), math.inf)
    return torch.minimum(z, zf)  # the floor


def _gradient(a: torch.Tensor, dim: int) -> torch.Tensor:
    """np.gradient along one axis: central differences inside, one-sided
    at the edges."""
    n = a.shape[dim]
    g = torch.empty_like(a)
    sl = lambda s, e: a.narrow(dim, s, e - s)  # noqa: E731
    g.narrow(dim, 1, n - 2).copy_((sl(2, n) - sl(0, n - 2)) / 2.0)
    g.narrow(dim, 0, 1).copy_(sl(1, 2) - sl(0, 1))
    g.narrow(dim, n - 1, 1).copy_(sl(n - 1, n) - sl(n - 2, n - 1))
    return g


def kinect_depth(z_m: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """The Kinect-v1 sensor model on clean z-depth (kinect_sim.kinect_depth):
    int32 mm, 0 = invalid; the randomness from `gen`."""
    h, w = z_m.shape
    dev = z_m.device
    valid = torch.isfinite(z_m) & (z_m > 0.4) & (z_m < 4.0)
    z = torch.where(valid, z_m, math.nan)
    sigma = 0.0012 + 0.0019 * (z - 0.4) ** 2
    z = z + sigma * torch.randn((h, w), generator=gen, dtype=z.dtype,
                                device=dev)
    d = FB_PX_M / z
    d = torch.round(d / DISP_STEP) * DISP_STEP
    z = FB_PX_M / d
    dq = torch.where(valid, d, 0.0)
    shadow = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for k in range(1, 9):
        nb = torch.roll(dq, -SHADOW_DIR * k, dims=1)
        edge = (nb - dq) > k
        if SHADOW_DIR < 0:
            edge[:, :k] = False
        else:
            edge[:, -k:] = False
        shadow |= edge
    zv = torch.where(valid, z, 0.0)
    grad = torch.hypot(_gradient(zv, 1), _gradient(zv, 0))
    p_drop = torch.clamp((grad - 0.01) * 30.0, 0.0, 0.9)
    drop = torch.rand((h, w), generator=gen, dtype=z.dtype,
                      device=dev) < p_drop
    speckle = torch.rand((h, w), generator=gen, dtype=z.dtype,
                         device=dev) < 0.004
    ok = valid & ~shadow & ~drop & ~speckle
    return torch.where(ok, torch.nan_to_num(z) * 1000.0, 0.0).to(torch.int32)


def make(mix: dict, camera: dict, seed: int, device) -> Frames:
    """One period of the mix's frames; `seed` draws the direction."""
    device = torch.device(device)
    P = period_of(mix)
    rng = np.random.default_rng(seed)
    start = round(mix["start"] * P) % P
    step = 1 if rng.integers(2) else -1
    out, truth = [], []
    if mix["scene"] == "spheres":
        for j0 in range(0, P, CHUNK):
            ts = np.arange(j0, min(P, j0 + CHUNK))
            d = spheres_frames(mix, camera, ts, device)
            out.extend(d.cpu().numpy().astype(np.uint16))
        ts = np.arange(P)
        obj = triangle(ts, mix["object_leg"], mix["object_center"])[:, None] \
            * np.asarray(mix["object_step"])
        cam = triangle(ts, mix["camera_leg"], mix["camera_center"])[:, None] \
            * np.asarray(mix["camera_step"])
        rad = radius_of(mix, ts)
        truth = [{"object": obj[j], "camera": cam[j], "radius": rad[j]}
                 for j in range(P)]
    else:
        # the sensor noise of cycle position j is the same for every seed
        # (as the vendored sequence's frame j), so every seed replays the
        # same frames, in the order its seed draws
        gen = torch.Generator(device=device)
        for j in range(P):
            gen.manual_seed(1000 + j)
            d = kinect_depth(render_umbrella(j / P, camera, device), gen)
            out.append(d.cpu().numpy().astype(np.uint16))
            truth.append({"phase": j / P})
    return Frames(out, start, step, truth)
