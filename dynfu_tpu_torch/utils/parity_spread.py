"""Run-to-run spread of the parity slice's accuracy on one CUDA card, and
where it comes from.

    python -m dynfu_tpu_torch.utils.parity_spread [--dims 512] [--runs 3]

Runs `run_benchmark(dims, repeats=3)` `--runs` times in each of three
settings, in one process and in this order:

- "kernel": as shipped; the data Gram's kernel (csrc/gram.cu) sums every
  entry in one fixed order, so it gives the same bits on every launch;
- "kernel_det": the same under torch.use_deterministic_algorithms (with
  warn_only, so that an operation with no deterministic version warns and
  runs): every PyTorch operation that has a deterministic version uses it;
- "plain_det": that mode, with the data Gram computed by its plain version
  (`gram_cuda.data_normal_plain`, whose float32 index_add_ is deterministic
  in it).

A setting whose runs differ has a source of run-to-run variation; "kernel"
and "kernel_det" give one value if nothing on the path varies, and
"plain_det" another (its float32 sums round differently). Prints one JSON
line per run (the accuracy metrics and frame_ms), then the operations that
warned.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import warnings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dims", type=int, default=512)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    # cuBLAS is deterministic only with a fixed workspace, set before CUDA
    # starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("parity_spread: needs a CUDA card", file=sys.stderr)
        return 1
    from dynfu_tpu_torch.solver import gram_cuda
    from dynfu_tpu_torch.utils.benchmarks import run_benchmark

    kernel = gram_cuda.data_normal
    warned = set()
    for setting in ("kernel", "kernel_det", "plain_det"):
        torch.use_deterministic_algorithms(setting != "kernel",
                                           warn_only=True)
        gram_cuda.data_normal = (gram_cuda.data_normal_plain
                                 if setting == "plain_det" else kernel)
        try:
            for run in range(args.runs):
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    res = run_benchmark(volume_dims=args.dims, repeats=3,
                                        device="cuda")
                warned |= {str(w.message).split("\n")[0][:160]
                           for w in caught
                           if "deterministic" in str(w.message)}
                print(json.dumps({
                    "setting": setting, "run": run,
                    **{k: res[k] for k in (
                        "median_vertex_err_mm", "err_after_3x_motion_mm",
                        "frame_ms", "mc_dropped_cells", "corr_dropped")}}),
                    flush=True)
        finally:
            gram_cuda.data_normal = kernel
            torch.use_deterministic_algorithms(False)
    print(json.dumps({"nondeterministic_warnings": sorted(warned)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
