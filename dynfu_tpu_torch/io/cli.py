"""`dynfu-torch` command-line entry point (analog of src/apps/demo.cpp).

Usage: dynfu-torch [--cpu] run [--export-viz] [--frames N] [--volume-dims D]
                               [--out DIR] <dataset-dir>
       dynfu-torch [--cpu] bench [--stages] [--fusion] [--rigid] ...
       dynfu-torch synth <out-dir>
The dataset dir must contain depth/*.png (16-bit depth in mm), as in the
reference's VolumeDeform layout (demo.cpp:39-55). `run` writes per-frame
warped clouds (.pcd) and meshes (.ply/.vtk) under <dataset-dir>/out (or
--out). The engines run on the card; --cpu runs them on the CPU, and
without a card and without --cpu, run and bench exit with an error.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import torch


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="dynfu-torch", description=__doc__)
    parser.add_argument("--cpu", action="store_true",
                        help="run the engines on the CPU (their plain "
                             "PyTorch versions) instead of the card")
    sub = parser.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="run non-rigid fusion on a dataset dir")
    run.add_argument("dataset", help="directory with depth/*.png")
    run.add_argument("--export-viz", action="store_true",
                     help="export phong renders per frame")
    run.add_argument("--frames", type=int, default=0,
                     help="max frames (0 = all)")
    run.add_argument("--volume-dims", type=int, default=128)
    run.add_argument("--out", default=None,
                     help="output dir (default <dataset>/out)")
    run.add_argument("--checkpoint-every", type=int, default=0,
                     help="save <out>/checkpoint.npz every N frames")
    run.add_argument("--resume", default=None,
                     help="checkpoint to resume from")
    run.add_argument("--rigid", action="store_true",
                     help="run the rigid kfusion pipeline instead of "
                          "DynFusion")
    run.add_argument("--mode", default=None,
                     choices=["parity", "fixed", "fusion"],
                     help="DynFusion engine mode (default: parity; 'fusion' "
                          "= persistent canonical volume)")
    run.add_argument("--fg-box", default=None, metavar="x0,y0,z0,x1,y1,z1",
                     help="foreground-tracking box in volume-frame meters "
                          "(DynFuParams.fg_aabb): warp, correspondence and "
                          "solve track only vertices inside; the background "
                          "stays in the volume and the exports")
    run.add_argument("--max-fg-verts", type=int, default=1 << 15,
                     help="tracked-set capacity with --fg-box (overflow "
                          "counts as dropped correspondences)")
    run.add_argument("--devices", type=int, default=0,
                     help="devices to shard the engine over; the port runs "
                          "on one (0 or 1)")

    bench = sub.add_parser("bench", help="run the synthetic benchmark")
    bench.add_argument("--volume-dims", type=int, default=128)
    bench.add_argument("--frames", type=int, default=12)
    bench.add_argument("--rigid", action="store_true",
                       help="benchmark the rigid kfusion pipeline instead")
    bench.add_argument("--stages", action="store_true",
                       help="report per-stage ms (each stage timed alone) "
                            "instead of end-to-end fps; with --fusion, the "
                            "fusion frame's stages")
    bench.add_argument("--profile", default=None, metavar="DIR",
                       help="write a torch.profiler Chrome trace of the "
                            "benchmark to DIR/trace.json")
    bench.add_argument("--rotations", action="store_true",
                       help="with --fusion: per-node SE(3) solve + DLB warp")
    bench.add_argument("--fusion", action="store_true",
                       help="benchmark the persistent-canonical fusion mode "
                            "(fps + canonical/warped error in mm)")

    synth = sub.add_parser(
        "synth", help="generate a synthetic deforming depth sequence")
    synth.add_argument("out_dir")
    synth.add_argument("--frames", type=int, default=30)
    synth.add_argument("--rows", type=int, default=480)
    synth.add_argument("--cols", type=int, default=640)

    args = parser.parse_args(argv)

    if args.cmd == "synth":
        from dynfu_tpu_torch.io.datasets import generate_synthetic

        generate_synthetic(args.out_dir, frames=args.frames, h=args.rows,
                           w=args.cols)
        print(f"wrote {args.frames} frames to {args.out_dir}/depth")
        return 0

    from dynfu_tpu_torch.utils.device import (check_platform,
                                              print_short_device_info)

    try:
        device = check_platform("cpu" if args.cpu else "cuda")
    except RuntimeError as e:
        print(f"dynfu-torch: {e}", file=sys.stderr)
        return 1
    if device.type == "cuda":
        print_short_device_info(device.index or 0)

    if args.cmd == "run":
        from dynfu_tpu_torch.io.app import run_dataset

        fg_aabb = None
        if args.fg_box:
            v = [float(x) for x in args.fg_box.split(",")]
            if len(v) != 6:
                parser.error("--fg-box needs 6 comma-separated numbers")
            fg_aabb = (tuple(v[:3]), tuple(v[3:]))
        return run_dataset(
            args.dataset, out_dir=args.out, max_frames=args.frames,
            volume_dims=args.volume_dims, export_viz=args.export_viz,
            checkpoint_every=args.checkpoint_every, resume=args.resume,
            rigid=args.rigid, mode=args.mode, devices=args.devices,
            fg_aabb=fg_aabb, max_fg_verts=args.max_fg_verts, device=device)

    from dynfu_tpu_torch.utils import benchmarks as bm

    if args.stages:
        fn, kw = (bm.run_fusion_stage_benchmark if args.fusion
                  else bm.run_stage_benchmark), {}
    elif args.fusion:
        fn, kw = bm.run_fusion_benchmark, dict(frames=args.frames,
                                               rotations=args.rotations)
    elif args.rigid:
        fn, kw = bm.run_rigid_benchmark, dict(frames=args.frames)
    else:
        fn, kw = bm.run_benchmark, dict(frames=args.frames)
    with _profile(args.profile, device):
        result = fn(volume_dims=args.volume_dims, device=device, **kw)
    print(result)
    return 0


@contextlib.contextmanager
def _profile(out_dir, device):
    """torch.profiler around the benchmark when out_dir is set; the Chrome
    trace goes to out_dir/trace.json."""
    if not out_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"# trace written to {path}")


if __name__ == "__main__":
    sys.exit(main())
