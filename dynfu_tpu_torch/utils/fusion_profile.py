"""Where the time of the PyTorch port's SE(3) fusion frame goes, on one GPU.

    python3 -m dynfu_tpu_torch.utils.fusion_profile [--dims 512]
        [--frames 8] [--camera-motion M] [--out FILE]

Builds the engine of utils/benchmarks.run_fusion_benchmark (fusion mode,
SE(3) solve, the DynFuParams.caps_for_volume(dims, fusion=True) preset) on
the benchmark's moving sphere — or, with --camera-motion M, on its
moving-camera scene (camera tracking, anchors, the breathing sphere, the
camera moving M m per frame) — runs frame 0 and three warm-up frames, then

1. times `frames` frames with a device synchronize after each (wall_ms);
2. profiles `frames` further frames with torch.profiler (CPU and CUDA
   activities) and reports, per stage (the fusion/* ranges of
   engine/dynfusion._fusion_frame) the host time spent in it (host_ms),
   the device time of the kernels launched in it (kernel_ms) and its span
   on the card (device_span_ms); the device kernel time and the number of
   kernels per frame; the idle share (1 - kernel time / wall_ms); and the
   ten kernels with the most device time (names cut to 120 characters).

With --camera-motion it also reports, for every frame, the tracked camera
against the synthetic truth (the camera at (0, M i, 0), not rotating):
the position error in mm and the rotation angle in degrees
(`camera_track`).

Prints one JSON object (and writes it to FILE with --out).
The profiled frames run slower than wall_ms (the profiler's own cost), so
stage host times are shares, not frame times. `profile_engine` is shared
with utils/rigid_profile.py.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from dynfu_tpu_torch.engine.dynfusion import DynFusion
from dynfu_tpu_torch.utils.benchmarks import (bench_frame, fusion_params,
                                              movingcam_frame)

STAGES = ("track", "inputs", "warp", "associate", "solve", "integrate",
          "extract", "insert")


def profile_engine(eng, frames, warm: int, n: int, prefix: str,
                   stage_names) -> dict:
    """Run frames[:warm], time frames[warm:warm + n] one by one (each ended
    by a synchronize), then profile frames[warm + n:warm + 2n]; the stages
    are the profiler ranges `prefix + name`."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(warm):
        eng(frames[i])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    wall = []
    for i in range(warm, warm + n):
        t0 = time.perf_counter()
        eng(frames[i])
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(warm + n, warm + 2 * n):
            eng(frames[i])
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / n

    stages, kernels = {}, []
    kernel_us, launches = 0.0, 0
    for e in prof.key_averages():
        cuda = str(getattr(e, "device_type", "")).endswith("CUDA")
        if e.key.startswith(prefix):
            s = stages.setdefault(e.key[len(prefix):], {})
            if cuda:  # the range as the card saw it: first to last kernel
                s["device_span_ms"] = e.device_time_total / 1e3 / n
            else:  # the host's time inside the range, and the device time
                # of the kernels launched inside it
                s["host_ms"] = e.cpu_time_total / 1e3 / n
                s["kernel_ms"] = e.device_time_total / 1e3 / n
            continue
        self_dev = e.self_device_time_total
        if self_dev > 0 and cuda:
            kernel_us += self_dev
            launches += e.count
            kernels.append((self_dev / 1e3 / n, e.count / n, e.key))
    kernels.sort(reverse=True)
    wall_ms = sorted(wall)[len(wall) // 2]
    kernel_ms = kernel_us / 1e3 / n
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    return {
        "card": smi, "frames": n,
        "wall_ms_per_frame": wall, "wall_ms_median": wall_ms,
        "profiled_ms_per_frame": prof_ms,
        "kernel_ms_per_frame": kernel_ms,
        "kernels_per_frame": launches / n,
        "idle_share": 1.0 - kernel_ms / wall_ms,
        "stages": {k: stages.get(k) for k in stage_names},
        "top_kernels": [{"ms_per_frame": a, "calls_per_frame": b,
                         "name": c[:120]} for a, b, c in kernels[:10]],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }


def camera_track(poses, motion: float) -> list:
    """Per frame i: the tracked camera position minus the true one (0,
    motion * i, 0) in mm, and the tracked rotation's angle in degrees (the
    true camera does not rotate)."""
    rows = []
    for i, (R, t) in enumerate(poses):
        R = np.asarray(R, np.float64)
        err = (np.asarray(t, np.float64) - (0.0, motion * i, 0.0)) * 1e3
        # the angle from both the skew and the symmetric part: arccos alone
        # loses the small angles
        s = np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                            R[1, 0] - R[0, 1]]) / 2.0
        c = (np.trace(R) - 1.0) / 2.0
        rows.append(dict(frame=i, t_err_mm=err.tolist(),
                         t_err_norm_mm=float(np.linalg.norm(err)),
                         rot_deg=float(np.degrees(np.arctan2(s, c)))))
    return rows


def write(out: dict, path) -> None:
    """Print the JSON object, and write it to `path` if one is given."""
    text = json.dumps(out)
    print(text)
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", type=int, default=512)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--camera-motion", type=float, default=0.0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    m = args.camera_motion
    eng = DynFusion(fusion_params(args.dims, rotations=True, camera_motion=m),
                    device=torch.device("cuda"), mode="fusion")
    n = args.frames
    frames = [movingcam_frame(i, m) if m else bench_frame(i)
              for i in range(4 + 2 * n)]
    out = profile_engine(eng, frames, 4, n, "fusion/", STAGES)
    out.update(dims=args.dims, camera_motion=m,
               nodes=int(eng.warpfield.count))
    if m:
        out["camera_track"] = camera_track(eng.poses, m)
    write(out, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
