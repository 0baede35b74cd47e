"""Benchmark harness: end-to-end frames/s and accuracy.

Port of run_rigid_benchmark, run_benchmark and run_fusion_benchmark from
dynfu_tpu/utils/benchmarks.py, with the same workloads and JSON fields, and
a `device` field naming the card (or the CPU) they ran on.

run_rigid_benchmark: the rigid KinFu pipeline on a depth-diverse scene of
five spheres (0.9-2.3 m) seen by a camera moving (2, -1, 3) mm per frame, at
the reference's rigid defaults (KinFuParams: 512^3 over 3 m, ICP iterations
(10, 5, 4, 0), stencil radii (2, 3, 4, 6)); `warmup` frames, then `frames`
timed frames ended by a synchronize. ate_mm is the distance of the final
camera position from the true one.

run_benchmark: a 640x480 depth stream at fx = fy = 525 of a
sphere (r = 0.5 m, 1.5 m away) translating 4 mm per frame along x, fused
into a cubic TSDF over 3 m by the parity DynFusion loop. Capacities come
from DynFuParams.caps_for_volume.

Timing: `repeats` consecutive windows of `frames` frames, each ended by a
device synchronize; the best window gives `value` and `frame_ms`, the
median window `median_window_fps`. Accuracy is pinned to the first window
(median_vertex_err_mm) and to the third (err_after_3x_motion_mm), so
`repeats` must be at least 3. latency_ms synchronizes after every frame.

run_fusion_benchmark: the same moving sphere through fusion mode (a
persistent canonical volume with warped integration) at
DynFuParams.caps_for_volume(volume_dims, fusion=True): `warmup` frames,
then `frames` timed frames with one synchronize at the half-way mark (where
the half-motion error is read) and one at the end. It reports the median
distance of the warped canonical from the live sphere (warped_err_mm, and
warped_err_half_motion_mm) and of the canonical surface from the frame-0
sphere (canonical_err_mm). With camera_motion > 0 the camera moves that far
along y per frame, fusion_camera_tracking recovers it, four static anchor
spheres give the ICP background to track, and the deforming sphere breathes
(its radius oscillates) instead of translating, so that camera motion and
deformation are separable; only the breathing sphere is scored, in the
world (volume) frame.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from dynfu_tpu_torch.core.camera import Intr
from dynfu_tpu_torch.engine.dynfusion import DynFusion
from dynfu_tpu_torch.engine.kinfu import KinFu
from dynfu_tpu_torch.engine.params import DynFuParams, KinFuParams
from dynfu_tpu_torch.io.datasets import sphere_depth
from dynfu_tpu_torch.utils.timers import sync

TARGET_FPS = 30.0  # BASELINE.md north-star target


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))


def spheres_depth(spheres, cam, rows: int, cols: int,
                  f: float = 525.0) -> np.ndarray:
    """uint16 mm depth of several spheres seen from a camera at `cam`
    looking down +z (focal length f, centred principal point): the nearest
    surface per pixel, 0 where none."""
    big = np.iinfo(np.int32).max
    ds = [sphere_depth(tuple(np.asarray(c) - cam), r, rows, cols, f, f,
                       cols / 2 - 0.5, rows / 2 - 0.5)
          for c, r in spheres]
    out = np.stack([np.where(d == 0, big, d) for d in ds]).min(axis=0)
    return np.where(out == big, 0, out).astype(np.uint16)


# the rigid benchmark's depth-diverse scene (0.9-2.3 m): a narrower depth
# range lets the ICP trade y-translation for x-rotation (the source's note)
RIGID_SCENE = [((0.0, 0.0, 1.5), 0.5), ((0.55, 0.35, 1.6), 0.2),
               ((-0.5, -0.4, 1.7), 0.25), ((0.35, -0.45, 1.05), 0.18),
               ((-0.55, 0.5, 2.25), 0.35)]
RIGID_STEP = (0.002, -0.001, 0.003)  # camera motion per frame, m


def rigid_params(volume_dims: int = 512, rows: int = 480,
                 cols: int = 640) -> KinFuParams:
    intr = Intr(525.0, 525.0, cols / 2 - 0.5, rows / 2 - 0.5)
    return dataclasses.replace(KinFuParams.default_params(), rows=rows,
                               cols=cols, intr=intr,
                               volume_dims=(volume_dims,) * 3)


def rigid_frame(i: int, rows: int = 480, cols: int = 640) -> np.ndarray:
    """Depth frame i of the rigid benchmark (uint16 mm)."""
    return spheres_depth(RIGID_SCENE, np.asarray(RIGID_STEP) * i, rows,
                         cols)


def run_rigid_benchmark(volume_dims: int = 512, frames: int = 10,
                        warmup: int = 3, rows: int = 480, cols: int = 640, *,
                        device="cuda") -> dict:
    engine = KinFu(rigid_params(volume_dims, rows, cols), device=device)
    # pre-generated: the benchmark measures the pipeline, not the scene
    _frames = [rigid_frame(i, rows, cols) for i in range(warmup + frames)]
    for i in range(warmup):
        engine(_frames[i])
    sync(engine.vol.tsdf)
    t0 = time.perf_counter()
    for i in range(warmup, warmup + frames):
        engine(_frames[i])
    sync(engine.vol.tsdf)
    dt = (time.perf_counter() - t0) / frames

    _, t = engine.get_camera_pose()
    want = np.asarray(RIGID_STEP) * (warmup + frames - 1)
    ate_mm = float(np.linalg.norm(np.asarray(t) - want)) * 1e3
    # unrounded (the JAX harness rounds; the numbers are the same fields)
    return {
        "metric": f"rigid_fusion_fps_{volume_dims}cube",
        "value": 1.0 / dt,
        "unit": "frames/s",
        "vs_baseline": 1.0 / dt / TARGET_FPS,
        "frame_ms": dt * 1e3,
        "ate_mm": ate_mm,
        "resets": engine.resets,
        "device": _device_name(engine.device),
    }


def bench_params(volume_dims: int, rows: int = 480,
                 cols: int = 640) -> DynFuParams:
    intr = Intr(525.0, 525.0, cols / 2 - 0.5, rows / 2 - 0.5)
    caps = DynFuParams.caps_for_volume(volume_dims)
    return DynFuParams(
        kinfu=KinFuParams(rows=rows, cols=cols, intr=intr,
                          volume_dims=(volume_dims,) * 3),
        **caps)


def bench_frame(i: int, rows: int = 480, cols: int = 640) -> np.ndarray:
    """Depth frame i of the benchmark's moving sphere (uint16 mm)."""
    return np.asarray(sphere_depth((0.004 * i, 0.0, 1.5), 0.5, rows, cols,
                                   525.0, 525.0, cols / 2 - 0.5,
                                   rows / 2 - 0.5), np.uint16)


def run_benchmark(volume_dims: int = 128, frames: int = 12, warmup: int = 3,
                  rows: int = 480, cols: int = 640, *, repeats: int = 6,
                  device="cuda") -> dict:
    if repeats < 3:
        raise ValueError("repeats must be >= 3 (the 3x-motion error is "
                         "read after the third window)")
    engine = DynFusion(bench_params(volume_dims, rows, cols), device=device)
    _frames = [bench_frame(i, rows, cols)
               for i in range(warmup + repeats * frames + 3)]

    for i in range(warmup):
        engine(_frames[i])
        sync(engine.warped_cloud(unique=True)[0])

    best_dt, dts = float("inf"), []
    err_mm = err_last_mm = None
    for rep in range(repeats):
        lo = warmup + rep * frames
        t0 = time.perf_counter()
        for i in range(lo, lo + frames):
            engine(_frames[i])
        wv, _ = engine.warped_cloud(unique=True)
        sync(wv)
        dts.append((time.perf_counter() - t0) / frames)
        best_dt = min(best_dt, dts[-1])
        if rep in (0, 2):
            wv, wm = engine.warped_cloud(unique=True)
            v = wv[wm].cpu().numpy()
            center = np.asarray((0.004 * (lo + frames - 1), 0.0, 1.5)
                                ) - np.asarray((-1.5, -1.5, 0.5))
            e = float(np.median(np.abs(
                np.linalg.norm(v - center, axis=-1) - 0.5))) * 1e3
            if rep == 0:
                err_mm = e
            else:
                err_last_mm = e
    fps = 1.0 / best_dt
    last = warmup + repeats * frames - 1

    t0 = time.perf_counter()
    for i in range(last + 1, last + 4):
        engine(_frames[i])
        sync(engine.warped_cloud(unique=True)[0])
    latency_ms = (time.perf_counter() - t0) / 3 * 1e3

    fs = engine.last_frame_stats
    mc_dropped = int(fs.mc_dropped)
    corr_dropped = int(fs.corr_dropped)
    # both must be 0: capacity overflow and uncertified correspondences are
    # silent accuracy loss otherwise
    if mc_dropped:
        raise RuntimeError(f"marching cubes dropped {mc_dropped} occupied "
                           "cells: raise max_mc_voxels")
    if corr_dropped:
        raise RuntimeError(f"{corr_dropped} correspondences failed the "
                           "window-exactness certificate")
    # unrounded (the JAX harness rounds; the numbers are the same fields)
    return {
        "metric": f"nonrigid_fusion_fps_{volume_dims}cube",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": fps / TARGET_FPS,
        "frame_ms": best_dt * 1e3,
        "latency_ms": latency_ms,
        "median_vertex_err_mm": err_mm,
        "err_after_3x_motion_mm": err_last_mm,
        "mc_dropped_cells": mc_dropped,
        "corr_dropped": corr_dropped,
        "window_frame_ms": [d * 1e3 for d in dts],
        "median_window_fps": 1.0 / sorted(dts)[len(dts) // 2],
        "device": _device_name(engine.device),
    }


# the moving-camera scene: static anchors for the camera tracking, and the
# breathing sphere's amplitude and period (the half-way and final frames sit
# at |sin| = 0.87; peak radial rate ~5 mm per frame)
FUSION_ANCHORS = [((0.62, 0.42, 1.7), 0.22), ((-0.6, -0.45, 1.9), 0.28),
                  ((0.45, -0.5, 1.05), 0.16), ((-0.62, 0.5, 2.3), 0.35)]
BREATHE_AMP, BREATHE_PERIOD = 0.010, 12.0


def _breathing_radius(i: int) -> float:
    return 0.5 + BREATHE_AMP * np.sin(2 * np.pi * i / BREATHE_PERIOD)


def movingcam_frame(i: int, camera_motion: float, rows: int = 480,
                    cols: int = 640) -> np.ndarray:
    """Depth frame i of the moving-camera scene (uint16 mm): the breathing
    sphere at (0, 0, 1.5) and the anchors, the camera at y = camera_motion
    * i."""
    return spheres_depth([((0.0, 0.0, 1.5), _breathing_radius(i))]
                         + FUSION_ANCHORS,
                         np.asarray((0.0, camera_motion * i, 0.0)), rows, cols)


def fusion_params(volume_dims: int, rows: int = 480, cols: int = 640,
                  rotations: bool = False, camera_motion: float = 0.0,
                  similarity_reg: bool = False) -> DynFuParams:
    """DynFuParams.caps_for_volume(volume_dims, fusion=True); a moving
    camera turns on fusion_camera_tracking and, at >= 384^3, the capacities
    its scene needs (the anchors about double the canonical surface, and
    columns crossing two surfaces carry twice the edge bits)."""
    intr = Intr(525.0, 525.0, cols / 2 - 0.5, rows / 2 - 0.5)
    caps = DynFuParams.caps_for_volume(volume_dims, fusion=True)
    params = DynFuParams(
        kinfu=KinFuParams(rows=rows, cols=cols, intr=intr,
                          volume_dims=(volume_dims,) * 3),
        solver_rotations=rotations,
        fusion_camera_tracking=camera_motion != 0.0,
        se3_similarity_reg=similarity_reg, **caps)
    if camera_motion != 0.0 and volume_dims >= 384:
        params = dataclasses.replace(params, max_edge_verts=1 << 17,
                                     edge_col_budget=16,
                                     fusion_max_active=1 << 20)
    return params


def run_fusion_benchmark(volume_dims: int = 512, frames: int = 12,
                         warmup: int = 3, rows: int = 480, cols: int = 640,
                         rotations: bool = False, camera_motion: float = 0.0,
                         similarity_reg: bool = False, *,
                         device="cuda") -> dict:
    engine = DynFusion(fusion_params(volume_dims, rows, cols, rotations,
                                     camera_motion, similarity_reg),
                       device=device, mode="fusion")
    vol_t = np.asarray((-1.5, -1.5, 0.5))
    radius = 0.5
    n_total = warmup + frames
    anchors = FUSION_ANCHORS if camera_motion != 0.0 else []

    def radius_at(i):
        return _breathing_radius(i) if anchors else radius

    def center_at(i):
        return (0.0, 0.0, 1.5) if anchors else (0.004 * i, 0.0, 1.5)

    _frames = [movingcam_frame(i, camera_motion, rows, cols) if anchors
               else bench_frame(i, rows, cols) for i in range(n_total)]

    def median_err(verts, mask, i):
        center = np.asarray(center_at(i)) - vol_t
        v = verts[mask].cpu().numpy()
        d = np.linalg.norm(v - center, axis=-1)
        if anchors:
            # score the deforming sphere only: within 1.5 radii of it and
            # outside every anchor's own 1.5-radius neighbourhood
            keep = d < radius * 1.5
            for ac, ar in anchors:
                keep &= np.linalg.norm(v - (np.asarray(ac) - vol_t),
                                       axis=-1) > ar * 1.5
            d = d[keep]
        return float(np.median(np.abs(d - radius_at(i)))) * 1e3

    for i in range(warmup):
        engine(_frames[i])
        sync(engine.warped_cloud()[0])

    half = warmup + frames // 2
    t0 = time.perf_counter()
    for i in range(warmup, half):
        engine(_frames[i])
    sync(engine.warped_cloud()[0])
    warped_err_half_mm = median_err(*engine.warped_cloud(), half - 1)
    for i in range(half, n_total):
        engine(_frames[i])
    sync(engine.warped_cloud()[0])
    dt = (time.perf_counter() - t0) / frames
    fps = 1.0 / dt

    last = n_total - 1
    warped_err_mm = median_err(*engine.warped_cloud(), last)
    canonical_err_mm = median_err(engine.canonical.vertices,
                                  engine.canonical.mask, 0)
    fs = engine.last_frame_stats
    mc_dropped = int(fs.mc_dropped)
    n_band, n_captured = int(fs.band.n_band), int(fs.band.n_captured)
    if mc_dropped:
        raise RuntimeError(f"edge extraction dropped {mc_dropped} edges: "
                           "raise max_edge_verts or edge_col_budget")
    if n_captured != n_band:
        raise RuntimeError(f"fusion band captured {n_captured} of {n_band} "
                           "voxels: raise fusion_max_active")
    # unrounded (the JAX harness rounds; the numbers are the same fields)
    tag = "_movingcam" if camera_motion else ""
    return {
        "metric": f"fusion_mode_fps_{volume_dims}cube{tag}",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": fps / TARGET_FPS,
        "frame_ms": dt * 1e3,
        "canonical_err_mm": canonical_err_mm,
        "warped_err_mm": warped_err_mm,
        "warped_err_half_motion_mm": warped_err_half_mm,
        "motion_mm": 0.004 * last * 1e3,
        "n_band": n_band,
        "corr_dropped": int(fs.corr_dropped),
        "mc_dropped": mc_dropped,
        "n_captured": n_captured,
        "device": _device_name(engine.device),
    }
