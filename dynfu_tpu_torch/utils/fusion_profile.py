"""Where the time of the PyTorch port's SE(3) fusion frame goes, on one GPU.

    python3 -m dynfu_tpu_torch.utils.fusion_profile [--dims 512]
                                                    [--frames 8] [--out FILE]

Builds the engine of utils/benchmarks.run_fusion_benchmark (fusion mode,
SE(3) solve, the DynFuParams.caps_for_volume(dims, fusion=True) preset) on
the benchmark's moving sphere, runs frame 0 and three warm-up frames, then

1. times `frames` frames with a device synchronize after each (wall_ms);
2. profiles `frames` further frames with torch.profiler (CPU and CUDA
   activities) and reports, per stage (the fusion/* ranges of
   engine/dynfusion._fusion_frame) the host time spent in it (host_ms),
   the device time of the kernels launched in it (kernel_ms) and its span
   on the card (device_span_ms); the device kernel time and the number of
   kernels per frame; the idle share (1 - kernel time / wall_ms); and the
   ten kernels with the most device time (names cut to 120 characters).

Prints one JSON object (and writes it to FILE with --out).
The profiled frames run slower than wall_ms (the profiler's own cost), so
stage host times are shares, not frame times.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from dynfu_tpu_torch.engine.dynfusion import DynFusion
from dynfu_tpu_torch.utils.benchmarks import bench_frame, fusion_params

STAGES = ("inputs", "warp", "associate", "solve", "integrate", "extract",
          "insert")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", type=int, default=512)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    eng = DynFusion(fusion_params(args.dims, rotations=True), device=dev,
                    mode="fusion")
    n = args.frames
    frames = [bench_frame(i) for i in range(4 + 2 * n)]
    for i in range(4):
        eng(frames[i])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    wall = []
    for i in range(4, 4 + n):
        t0 = time.perf_counter()
        eng(frames[i])
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(4 + n, 4 + 2 * n):
            eng(frames[i])
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / n

    stages, kernels = {}, []
    kernel_us, launches = 0.0, 0
    for e in prof.key_averages():
        cuda = str(getattr(e, "device_type", "")).endswith("CUDA")
        if e.key.startswith("fusion/"):
            s = stages.setdefault(e.key[7:], {})
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
    out = {
        "card": smi, "dims": args.dims, "frames": n,
        "wall_ms_per_frame": wall, "wall_ms_median": wall_ms,
        "profiled_ms_per_frame": prof_ms,
        "kernel_ms_per_frame": kernel_ms,
        "kernels_per_frame": launches / n,
        "idle_share": 1.0 - kernel_ms / wall_ms,
        "stages": {k: stages.get(k) for k in STAGES},
        "top_kernels": [{"ms_per_frame": a, "calls_per_frame": b,
                         "name": c[:120]} for a, b, c in kernels[:10]],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "nodes": int(eng.warpfield.count),
    }
    text = json.dumps(out)
    print(text)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
