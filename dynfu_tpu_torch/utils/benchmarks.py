"""Benchmark harness: end-to-end non-rigid fusion frames/s and accuracy.

Port of run_benchmark and run_fusion_benchmark from
dynfu_tpu/utils/benchmarks.py, with the same workloads and JSON fields.

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
sphere (canonical_err_mm).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from dynfu_tpu_torch.core.camera import Intr
from dynfu_tpu_torch.engine.dynfusion import DynFusion
from dynfu_tpu_torch.engine.params import DynFuParams, KinFuParams
from dynfu_tpu_torch.io.datasets import sphere_depth
from dynfu_tpu_torch.utils.timers import sync

TARGET_FPS = 30.0  # BASELINE.md north-star target


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
        "device": str(engine.device) if engine.device.type != "cuda"
        else torch.cuda.get_device_name(engine.device),
    }


def fusion_params(volume_dims: int, rows: int = 480, cols: int = 640,
                  rotations: bool = False) -> DynFuParams:
    intr = Intr(525.0, 525.0, cols / 2 - 0.5, rows / 2 - 0.5)
    caps = DynFuParams.caps_for_volume(volume_dims, fusion=True)
    return DynFuParams(
        kinfu=KinFuParams(rows=rows, cols=cols, intr=intr,
                          volume_dims=(volume_dims,) * 3),
        solver_rotations=rotations, **caps)


def run_fusion_benchmark(volume_dims: int = 512, frames: int = 12,
                         warmup: int = 3, rows: int = 480, cols: int = 640,
                         rotations: bool = False, camera_motion: float = 0.0,
                         *, device="cuda") -> dict:
    if camera_motion != 0.0:
        raise NotImplementedError(
            "camera_motion needs fusion_camera_tracking: rigid ICP and the "
            "stencil kernel (ROADMAP.md, the rigid KinFu slice)")
    engine = DynFusion(fusion_params(volume_dims, rows, cols, rotations),
                       device=device, mode="fusion")
    vol_t = np.asarray((-1.5, -1.5, 0.5))
    radius = 0.5
    n_total = warmup + frames
    _frames = [bench_frame(i, rows, cols) for i in range(n_total)]

    def median_err(verts, mask, i):
        center = np.asarray((0.004 * i, 0.0, 1.5)) - vol_t
        v = verts[mask].cpu().numpy()
        d = np.linalg.norm(v - center, axis=-1)
        return float(np.median(np.abs(d - radius))) * 1e3

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
    return {
        "metric": f"fusion_mode_fps_{volume_dims}cube",
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
        "device": str(engine.device) if engine.device.type != "cuda"
        else torch.cuda.get_device_name(engine.device),
    }
