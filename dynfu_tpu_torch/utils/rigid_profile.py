"""Where the time of the PyTorch port's rigid KinFu frame goes, on one GPU.

    python3 -m dynfu_tpu_torch.utils.rigid_profile [--dims 512] [--frames 8]
                                                   [--out FILE]

Builds the engine of utils/benchmarks.run_rigid_benchmark (KinFuParams
defaults, 640x480, the five-sphere scene and its moving camera), runs three
warm-up frames, then fusion_profile.profile_engine's timed and profiled
windows over the rigid/* ranges of engine/kinfu.py (preprocess, icp,
integrate, raycast, pyramid), and counts the host syncs of `frames` more
frames under torch.cuda.set_sync_debug_mode("warn") (syncs_per_frame).

Prints one JSON object (and writes it to FILE with --out).
"""

import argparse
import sys
import warnings
from pathlib import Path

import torch

from dynfu_tpu_torch.engine.kinfu import KinFu
from dynfu_tpu_torch.utils.benchmarks import rigid_frame, rigid_params
from dynfu_tpu_torch.utils.fusion_profile import profile_engine, write

STAGES = ("preprocess", "icp", "integrate", "raycast", "pyramid")


def count_syncs(eng, frames) -> float:
    """Host syncs per frame that torch's sync debug mode reports."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for f in frames:
                eng(f)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    n = sum("synchroniz" in str(w.message) for w in caught)
    return n / len(frames)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", type=int, default=512)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    eng = KinFu(rigid_params(args.dims), device=torch.device("cuda"))
    n = args.frames
    frames = [rigid_frame(i) for i in range(3 + 3 * n)]
    out = profile_engine(eng, frames, 3, n, "rigid/", STAGES)
    out.update(dims=args.dims,
               syncs_per_frame=count_syncs(eng, frames[3 + 2 * n:]),
               resets=eng.resets)
    write(out, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
