#!/usr/bin/env python
"""The JAX package's figures for fixed mode at 128^3, the reference that
chip_smoke.py's `fixed128` row is held to.

    JAX_PLATFORMS=cpu /opt/venv/bin/python scripts/jax_fixed_reference.py \
        [--per-voxel]

The workload: DynFusion(params, mode="fixed") with run_benchmark(128)'s
parameters (640x480, 128^3, its capacities) on run_fusion_benchmark's
moving-camera scene (camera_motion 0.002): the breathing sphere and four
static anchor spheres, the camera moving 2 mm a frame along y. The anchors
constrain the ICP and the breathing has no rigid interpretation, so the
camera track and the deformation are separable; a lone translating sphere
leaves the ICP's rotations about its centre to roundoff. 3 warmup frames,
then 12; the breathing sphere's error (the port's numpy
`breathing_err_mm`, on the unique warped cloud) half-way (frame 8), at the
end (frame 14), and of the canonical (frame 0's radius), the camera's
translation and its distance from the truth at the end, and the drop
counters of every frame that dropped anything. The frames
(`movingcam_frame`) and the metric are the port's numpy code; the loop is
chip_smoke.fixed_run's. Prints one JSON line. The CPU's timings mean
nothing for the card and are not kept.

As shipped, JAX's fixed mode integrates a rotated pose with its homography
formulation and raycasts with its homography or slab-sweep formulations,
which suit the TPU and which the port does not have. With --per-voxel it
integrates every pose with its per-voxel integrate (the "gather" mode) and
raycasts with raycast_march (the reference's per-ray march), the
formulations the port has (`per_voxel`, which the port's CPU tests use
too).
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FRAMES, WARMUP, CAMERA_MOTION = 12, 3, 0.002


def per_voxel(eng):
    """JAX's fixed-mode engine `eng` with the formulations the port has:
    every pose integrated per voxel (the "gather" mode: no pose counts as
    aligned, none as tilted little enough for the homography) and the model
    raycast by raycast_march, the reference's per-ray march. Returns eng."""
    from dynfu_tpu.volume import tsdf

    eng._aligned = lambda pose: False
    eng.MAX_HOMOGRAPHY_TILT = -1.0
    p = eng.params
    eng._raycast = lambda pose: tsdf.raycast_march(
        eng.vol, pose, p.intr, (p.rows, p.cols), eng.tsdf_config)
    return eng


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-voxel", action="store_true")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    from dynfu_tpu.core.camera import Intr
    from dynfu_tpu.engine.dynfusion import DynFusion
    from dynfu_tpu.engine.params import DynFuParams, KinFuParams
    from dynfu_tpu.utils.benchmarks import _caps_for
    from dynfu_tpu_torch.utils.benchmarks import (breathing_err_mm,
                                                  movingcam_frame)

    rows, cols, dims = 480, 640, 128
    params = DynFuParams(
        kinfu=KinFuParams(rows=rows, cols=cols,
                          intr=Intr(525.0, 525.0, cols / 2 - 0.5,
                                    rows / 2 - 0.5),
                          volume_dims=(dims,) * 3),
        **_caps_for(dims))
    eng = DynFusion(params, mode="fixed")
    if args.per_voxel:
        per_voxel(eng)

    def err(i):
        wv, wm = eng.warped_cloud(unique=True)
        return breathing_err_mm(np.asarray(wv)[np.asarray(wm)], i)

    drops = []
    half, last = WARMUP + FRAMES // 2 - 1, WARMUP + FRAMES - 1
    for i in range(last + 1):
        eng(movingcam_frame(i, CAMERA_MOTION, rows, cols))
        fs = eng.last_frame_stats
        if fs is not None and (int(fs.mc_dropped) or int(fs.corr_dropped)):
            drops.append((i, int(fs.mc_dropped), int(fs.corr_dropped)))
        if i == half:
            err_half = err(i)
    c = eng.canonical
    t = np.asarray(eng.poses[-1][1])
    print(json.dumps({
        "mode": "fixed", "per_voxel": args.per_voxel,
        "device": str(jax.devices()[0]),
        "warped_err_mm": err(last), "warped_err_half_motion_mm": err_half,
        "canonical_err_mm": breathing_err_mm(
            np.asarray(c.vertices)[np.asarray(c.mask)], 0),
        "camera_err_mm": float(np.linalg.norm(
            t - (0.0, CAMERA_MOTION * last, 0.0))) * 1e3,
        "camera_t_m": t.tolist(),
        "mc_dropped": int(eng.last_frame_stats.mc_dropped),
        "corr_dropped": int(eng.last_frame_stats.corr_dropped),
        "frames_with_drops": drops}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
