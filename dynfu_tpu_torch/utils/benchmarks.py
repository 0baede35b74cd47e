"""Benchmark harness: end-to-end frames/s and accuracy.

Port of run_rigid_benchmark, run_benchmark, run_fusion_benchmark and
run_umbrella_benchmark from dynfu_tpu/utils/benchmarks.py, with the same
workloads and JSON fields, and a `device` field naming the card (or the
CPU) they ran on.

run_rigid_benchmark: the rigid KinFu pipeline on a depth-diverse scene of
five spheres (0.9-2.3 m) seen by a camera moving (2, -1, 3) mm per frame, at
the reference's rigid defaults (KinFuParams: 512^3 over 3 m, ICP iterations
(10, 5, 4, 0), stencil radii (2, 3, 4, 6)); `warmup` frames, then `frames`
timed frames ended by a synchronize. ate_mm is the distance of the final
camera position from the true one.

run_benchmark: a 640x480 depth stream at fx = fy = 525 of a
sphere (r = 0.5 m, 1.5 m away) translating 4 mm per frame along x, fused
into a cubic TSDF over 3 m by the parity DynFusion loop. Capacities come
from DynFuParams.caps_for_volume. With a `mesh` (dist/spmd.make_mesh),
every rank runs it and the engine is the sharded one
(dist/driver.ShardedDynFusion); the result names the ranks and backend.

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
sphere (canonical_err_mm). With a `mesh`, as in run_benchmark, every rank
runs it on the sharded engine (fusion mode; not with camera_motion, whose
camera tracking the sharded engine refuses). With camera_motion > 0 the
camera moves that far along y per frame, fusion_camera_tracking recovers
it, four static anchor spheres give the ICP background to track, and the
deforming sphere breathes (its radius oscillates) instead of translating,
so that camera motion and deformation are separable; only the breathing
sphere is scored, in the world (volume) frame.

run_umbrella_benchmark: the synthetic Kinect-v1 umbrella sequence
(io/kinect_sim.py) in parity mode, at >= 384^3 with foreground tracking
(see its docstring).
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
                  device="cuda", mesh=None) -> dict:
    if repeats < 3:
        raise ValueError("repeats must be >= 3 (the 3x-motion error is "
                         "read after the third window)")
    if mesh is None:
        engine = DynFusion(bench_params(volume_dims, rows, cols),
                           device=device)
    else:  # every rank of the mesh runs this, the sharded engine
        from dynfu_tpu_torch.dist.driver import ShardedDynFusion

        engine = ShardedDynFusion(bench_params(volume_dims, rows, cols),
                                  mesh=mesh)
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
        "ranks": 1 if mesh is None else mesh.world,
        "backend": None if mesh is None else mesh.backend,
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


def breathing_err_mm(verts: np.ndarray, i: int) -> float:
    """Median |distance to the breathing sphere's centre - its radius at
    frame i| (mm) over volume-frame vertices of the moving-camera scene,
    scoring the deforming sphere only: within 1.5 radii of its centre and
    outside every anchor's own 1.5-radius neighbourhood."""
    vol_t = np.asarray((-1.5, -1.5, 0.5))
    d = np.linalg.norm(verts - (np.asarray((0.0, 0.0, 1.5)) - vol_t),
                       axis=-1)
    keep = d < 0.5 * 1.5
    for ac, ar in FUSION_ANCHORS:
        keep &= np.linalg.norm(verts - (np.asarray(ac) - vol_t),
                               axis=-1) > ar * 1.5
    return float(np.median(np.abs(d[keep] - _breathing_radius(i)))) * 1e3


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
                         device="cuda", mesh=None) -> dict:
    params = fusion_params(volume_dims, rows, cols, rotations, camera_motion,
                           similarity_reg)
    if mesh is None:
        engine = DynFusion(params, device=device, mode="fusion")
    else:  # every rank of the mesh runs this, the sharded engine
        from dynfu_tpu_torch.dist.driver import ShardedDynFusion

        engine = ShardedDynFusion(params, mode="fusion", mesh=mesh)
    vol_t = np.asarray((-1.5, -1.5, 0.5))
    radius = 0.5
    n_total = warmup + frames
    anchors = FUSION_ANCHORS if camera_motion != 0.0 else []

    _frames = [movingcam_frame(i, camera_motion, rows, cols) if anchors
               else bench_frame(i, rows, cols) for i in range(n_total)]

    def median_err(verts, mask, i):
        v = verts[mask].cpu().numpy()
        if anchors:
            return breathing_err_mm(v, i)
        center = np.asarray((0.004 * i, 0.0, 1.5)) - vol_t
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
        "ranks": 1 if mesh is None else mesh.world,
        "backend": None if mesh is None else mesh.backend,
    }


def umbrella_params(volume_dims: int = 512, mode: str = "parity",
                    rows: int = 480, cols: int = 640,
                    foreground: bool = True) -> DynFuParams:
    """run_umbrella_benchmark's parameters: DynFuParams.caps_for_volume,
    and at >= 384^3 in parity mode the capacities the scene needs and the
    foreground box."""
    intr = Intr(525.0, 525.0, cols / 2 - 0.5, rows / 2 - 0.5)
    fusion = mode == "fusion"
    caps = DynFuParams.caps_for_volume(volume_dims, fusion=fusion)
    params = DynFuParams(
        kinfu=KinFuParams(rows=rows, cols=cols, intr=intr,
                          volume_dims=(volume_dims,) * 3),
        solver_rotations=fusion, **caps)
    if caps.get("corr_unique_edges") and volume_dims >= 384:
        # the capacities the scene needs: the wall and floor emit ~512k
        # unique edge vertices at 512^3, and a column of the z-parallel wall
        # carries up to Z edge bits. With `foreground` the tracked set is
        # the first 2^15 vertices of the box that bounds the canopy and
        # handle sweep in the volume frame, short of the wall (z_cam 2.15 ->
        # z_vol 1.65) and the floor (y_cam 0.55 -> y_vol 2.05; the handle
        # tip reaches y_vol ~2.02)
        params = dataclasses.replace(
            params, max_edge_verts=1 << 19, edge_col_budget=256,
            fg_aabb=((0.9, 0.8, 0.25), (2.1, 2.045, 1.6))
            if foreground else None,
            max_fg_verts=(1 << 15) if foreground else 0)
    return params


def run_umbrella_benchmark(volume_dims: int = 512, frames: int = 8,
                           mode: str = "parity", rows: int = 480,
                           cols: int = 640, seq_frames: int = 16,
                           warmup: int = 3, foreground: bool = True, *,
                           device="cuda") -> dict:
    """The umbrella sequence (io/kinect_sim.py): a breathing scalloped
    canopy on a nodding handle before a wall and a floor, seen through the
    Kinect-v1 sensor model, with the exact geometry known at every phase.
    `warmup` frames, then `frames` timed frames ended by the full warped
    cloud and a synchronize.

    Metric: the visible-surface depth error. The warped canonical cloud is
    projected into the live camera; per pixel the nearest projected
    vertex's depth is held against the clean render of the last frame's
    phase (median and 90th percentile, over `coverage_px` pixels that have
    both). Beside the source's fields: the node count, and the canonical
    and the last frame's live vertices that the solve tracks (the
    foreground box's, with `foreground`)."""
    from dynfu_tpu_torch.io import kinect_sim

    intr = Intr(525.0, 525.0, cols / 2 - 0.5, rows / 2 - 0.5)
    params = umbrella_params(volume_dims, mode, rows, cols, foreground)
    engine = DynFusion(params, device=device, mode=mode)
    _frames = [kinect_sim.umbrella_frame(i, frames=seq_frames, h=rows,
                                         w=cols)
               for i in range(warmup + frames)]
    for i in range(warmup):
        engine(_frames[i])
    sync(engine.warped_cloud()[0])
    t0 = time.perf_counter()
    for i in range(warmup, warmup + frames):
        engine(_frames[i])
    wv, wm = engine.warped_cloud()
    sync(wv)
    dt = (time.perf_counter() - t0) / frames

    z_clean = kinect_sim.render_umbrella((warmup + frames - 1) / seq_frames,
                                         h=rows, w=cols)
    cam = wv[wm].cpu().numpy() + engine.vol.pose_t.cpu().numpy()
    z = cam[:, 2]
    u = np.round(intr.fx * cam[:, 0] / z + intr.cx).astype(int)
    vv = np.round(intr.fy * cam[:, 1] / z + intr.cy).astype(int)
    inb = (u >= 0) & (u < cols) & (vv >= 0) & (vv < rows) & (z > 0.1)
    zmin = np.full((rows, cols), np.inf)
    np.minimum.at(zmin, (vv[inb], u[inb]), z[inb])
    got = np.isfinite(zmin) & np.isfinite(z_clean)
    err_mm = np.abs(zmin[got] - z_clean[got]) * 1e3
    fs = engine.last_frame_stats
    tracked = (engine._fg_canonical if engine._fg_enabled()
               else engine.canonical)
    # unrounded (the JAX harness rounds; the numbers are the same fields,
    # and the nodes and the canonical and live vertices the frame tracks)
    return {
        "metric": f"umbrella_{mode}_{volume_dims}cube",
        "value": 1.0 / dt,
        "unit": "frames/s",
        "vs_baseline": 1.0 / dt / TARGET_FPS,
        "frame_ms": dt * 1e3,
        "median_visible_err_mm": float(np.median(err_mm)),
        "p90_visible_err_mm": float(np.percentile(err_mm, 90)),
        "coverage_px": int(got.sum()),
        "mc_dropped": int(fs.mc_dropped),
        "corr_dropped": int(fs.corr_dropped),
        "nodes": int(engine.warpfield.count),
        "tracked_vertices": int(tracked.mask.sum()),
        "live_vertices": int(engine.live.mask.sum()),
        "device": _device_name(engine.device),
    }


# --- per-stage times --------------------------------------------------------


def _stage_clock(device: torch.device, iters: int, stages: dict):
    """clock(name, fn): runs fn once to warm up, then `iters` times, each
    call followed by a device synchronize; stores the mean ms per call in
    stages[name] and returns the last output."""
    def wait():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def clock(name, fn):
        out = fn()
        wait()
        total = 0.0
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fn()
            wait()
            total += time.perf_counter() - t0
        stages[name] = total / iters * 1e3
        return out

    return clock


def run_stage_benchmark(volume_dims: int = 128, iters: int = 10,
                        rows: int = 480, cols: int = 640,
                        warmup_frames: int = 3, *, device="cuda") -> dict:
    """Per-stage times of the parity frame, in milliseconds (port of the
    source's run_stage_benchmark, same keys and stage names). A few engine
    frames of the moving sphere build the state; each stage is then timed
    alone on it, a synchronize after every call. The frame runs its stages
    back to back, so read the stages as relative magnitudes, not as an
    additive decomposition of fused_full_frame."""
    from dynfu_tpu_torch.engine import dynfusion as dyn
    from dynfu_tpu_torch.mesh.edges import isosurface_edge_vertices
    from dynfu_tpu_torch.mesh.mc import marching_cubes
    from dynfu_tpu_torch.ops import imgproc, knn
    from dynfu_tpu_torch.solver import gn
    from dynfu_tpu_torch.volume import tsdf as tv
    from dynfu_tpu_torch.warp import field as wfield

    engine = DynFusion(bench_params(volume_dims, rows, cols), device=device)
    for i in range(warmup_frames):
        engine(bench_frame(i, rows, cols))
    dev = engine.device
    depth = torch.as_tensor(bench_frame(warmup_frames, rows, cols)
                            .astype(np.int32), device=dev)
    dp, config, intr = engine.dynfu_params, engine.tsdf_config, engine.params.intr
    vol, wf, c, pose = (engine.vol, engine.warpfield, engine.canonical,
                        engine.poses[-1])

    stages: dict = {}
    clock = _stage_clock(dev, iters, stages)
    dists = clock("preprocess_dists",
                  lambda: imgproc.compute_dists(depth, intr))
    vol2 = clock("clear_integrate", lambda: tv.integrate(
        vol, dists, pose, intr, config, fresh=True))
    if dp.corr_unique_edges:
        # the frame consumes unique edge vertices; marching cubes runs on
        # demand for mesh()
        verts, n_verts, _ = clock(
            "edge_vertices", lambda: isosurface_edge_vertices(
                vol2, config,
                max_edges=dp.max_edge_verts or dp.max_vertices // 2,
                col_budget=dp.edge_col_budget or dp.mc_col_budget))
        clock("marching_cubes_on_demand", lambda: marching_cubes(
            vol2, config, max_voxels=dp.max_mc_voxels,
            max_verts=dp.max_vertices, col_budget=dp.mc_col_budget))
    else:
        verts, n_verts, _ = clock("marching_cubes", lambda: marching_cubes(
            vol2, config, max_voxels=dp.max_mc_voxels,
            max_verts=dp.max_vertices, col_budget=dp.mc_col_budget))
    live_m = torch.arange(verts.shape[0], device=dev) < n_verts
    wv, _ = clock("warp_canonical", lambda: wfield.warp_points_normals(
        wf, c.vertices, c.normals))
    corr, exact = clock("correspondence_1nn", lambda: knn.nn1_gather_xwindow(
        verts, wv, None, c.mask, live_m, rescue=dp.corr_rescue,
        escalate=dp.corr_escalate, window_blocks=dp.corr_window_blocks))
    clock("gn_solve", lambda: gn.solve(
        wf, corr, verts, vert_mask=live_m & exact,
        tukey_offset=dp.tukey_offset, psi_data=dp.psi_data,
        lambda_reg=dp.lambda_reg, psi_reg=dp.psi_reg,
        linear_iter=dp.solver.linear_iter, knn_k=dp.knn))
    clock("node_insertion", lambda: wfield.update_warpfield(
        wf, wv, c.mask, dp.epsilon, dp.node_voxel_leaf, dp.max_new_nodes,
        vert_weights=engine.canonical_mult))
    clock("fused_full_frame", lambda: dyn._nonrigid_frame(
        vol, wf, c.vertices, c.normals, c.mask, depth, pose, dp=dp,
        intr=intr, config=config, parity=True,
        canonical_mult=engine.canonical_mult))
    return {
        "metric": f"nonrigid_stage_ms_{volume_dims}cube",
        "value": stages["fused_full_frame"],
        "unit": "ms/frame",
        "vs_baseline": 1e3 / stages["fused_full_frame"] / TARGET_FPS,
        "stages_ms": stages,
        "n_mesh_verts": int(n_verts),
        "device": _device_name(dev),
    }


def run_fusion_stage_benchmark(volume_dims: int = 512, iters: int = 5,
                               rows: int = 480, cols: int = 640,
                               warmup_frames: int = 4,
                               rotations: bool = True, *,
                               device="cuda") -> dict:
    """Per-stage times of the fusion-mode frame (port of the source's
    run_fusion_stage_benchmark, same keys and stage names), timed as
    run_stage_benchmark times them. The warped integration updates its
    volume in place, so its stages run on a copy of the engine's volume."""
    from dynfu_tpu_torch.engine import dynfusion as dyn
    from dynfu_tpu_torch.mesh.edges import isosurface_edge_vertices
    from dynfu_tpu_torch.mesh.mc import marching_cubes
    from dynfu_tpu_torch.ops import imgproc
    from dynfu_tpu_torch.volume import fusion as vfusion
    from dynfu_tpu_torch.volume import tsdf as tv
    from dynfu_tpu_torch.warp import field as wfield

    intr = Intr(525.0, 525.0, cols / 2 - 0.5, rows / 2 - 0.5)
    params = DynFuParams(
        kinfu=KinFuParams(rows=rows, cols=cols, intr=intr,
                          volume_dims=(volume_dims,) * 3),
        solver_rotations=rotations,
        **DynFuParams.caps_for_volume(volume_dims, fusion=True))
    engine = DynFusion(params, device=device, mode="fusion")
    for i in range(warmup_frames):
        engine(bench_frame(i, rows, cols))
    dev = engine.device
    depth = torch.as_tensor(bench_frame(warmup_frames, rows, cols)
                            .astype(np.int32), device=dev)
    dp, config = engine.dynfu_params, engine.tsdf_config
    vol, wf, c, pose = (engine.vol, engine.warpfield, engine.canonical,
                        engine.poses[-1])
    work = vol._replace(tsdf=vol.tsdf.clone(), weight=vol.weight.clone())

    stages: dict = {}
    clock = _stage_clock(dev, iters, stages)
    dists = clock("preprocess", lambda: imgproc.compute_dists(depth, intr))
    live = clock("points_normals",
                 lambda: imgproc.compute_points_normals(depth, intr))
    blend = "dlb" if rotations else "dqb"

    def warp(points, normals):
        return (wfield.warp_points_normals_dlb(wf, points, normals)
                if rotations else
                wfield.warp_points_normals(wf, points, normals))

    clock("warp_canonical", lambda: warp(c.vertices, c.normals))
    vol2, _ = clock("integrate_warped_band", lambda: vfusion.integrate_warped(
        work, wf, dists, pose, intr, config, normals=live[1],
        min_cos=dp.fusion_min_cos, max_active=dp.fusion_max_active,
        dilate=dp.fusion_dilate, knn_k=dp.knn, blend=blend))
    if dp.corr_unique_edges:
        mesh_v, n_verts, n_drop, _ = clock(
            "edge_vertices_with_normals", lambda: isosurface_edge_vertices(
                vol2, config,
                max_edges=dp.max_edge_verts or dp.max_vertices // 2,
                convention="corner",
                col_budget=dp.edge_col_budget or dp.mc_col_budget,
                with_normals=True))
    else:
        mesh_v, n_verts, n_drop = clock(
            "marching_cubes_corner", lambda: marching_cubes(
                vol2, config, max_voxels=dp.max_mc_voxels,
                max_verts=dp.max_vertices, convention="corner",
                col_budget=dp.mc_col_budget))
        clock("extract_normals", lambda: tv.extract_normals(
            vol2, mesh_v, config, frame="volume"))
    clock("warp_new_mesh", lambda: warp(mesh_v, mesh_v))
    clock("frame_solve_disabled", lambda: dyn._fusion_frame(
        work, wf, c.vertices, c.normals, c.mask, depth, pose, dp=dp,
        intr=intr, config=config, solve_enabled=False))
    clock("fused_full_frame", lambda: dyn._fusion_frame(
        work, wf, c.vertices, c.normals, c.mask, depth, pose, dp=dp,
        intr=intr, config=config))
    return {
        "metric": f"fusion_stage_ms_{volume_dims}cube",
        "value": stages["fused_full_frame"],
        "unit": "ms/frame",
        "vs_baseline": 1e3 / stages["fused_full_frame"] / TARGET_FPS,
        "stages_ms": stages,
        "n_mesh_verts": int(n_verts),
        "n_extract_dropped": int(n_drop),
        "n_band": int(engine.last_frame_stats.band.n_band),
        "device": _device_name(dev),
    }
