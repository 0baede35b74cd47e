"""Run-to-run spread of the parity slice's accuracy on one CUDA card, and
where it comes from.

    python -m dynfu_tpu_torch.utils.parity_spread [--dims 512] [--runs 3]
        [--seeds 5]

Runs `run_benchmark(dims, repeats=3)` `--runs` times in each of four
settings, in one process and in this order:

- "kernel": as shipped; the data Gram's kernel (csrc/gram.cu) sums every
  entry in one fixed order, so it gives the same bits on every launch;
- "kernel_det": the same under torch.use_deterministic_algorithms (with
  warn_only, so that an operation with no deterministic version warns and
  runs): every PyTorch operation that has a deterministic version uses it;
- "plain_det": that mode, with the data Gram computed by its plain version
  (`gram_cuda.data_normal_plain`, whose float32 index_add_ is deterministic
  in it);
- "ulp": once per seed 0 .. `--seeds` - 1 (not `--runs` times), the kernel's
  A and b with every nonzero entry moved one float32 ulp up or down at
  random (A stays symmetric), the signs drawn anew at every solve from a
  generator seeded with the seed. The spread of these runs is how far
  last-bit differences in the Gram carry through the solve chain.

A setting whose runs differ has a source of run-to-run variation; "kernel"
and "kernel_det" give one value if nothing on the path varies, and
"plain_det" another (its float32 sums round differently). The perturbation
is installed by this tool alone, on `gram_cuda.data_normal` (the name the
solver calls), for the "ulp" runs. Prints one JSON line per run (the
accuracy metrics and frame_ms), then, for "ulp", the spread of
err_after_3x_motion_mm, then the operations that warned.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import warnings

def ulp_perturbed(kernel, seed: int):
    """`kernel` with its (A, b) moved one float32 ulp up or down per nonzero
    entry; A's signs are drawn on its upper triangle and mirrored."""
    import torch

    gen = None

    def data_normal(*args, **kw):
        nonlocal gen
        A, b = kernel(*args, **kw)
        if gen is None:
            gen = torch.Generator(device=A.device)
            gen.manual_seed(seed)
        up = torch.rand(A.shape, generator=gen, device=A.device) < 0.5
        up = torch.triu(up) | torch.triu(up, 1).T
        ub = torch.rand(b.shape, generator=gen, device=b.device) < 0.5
        return tuple(torch.where(x != 0, torch.nextafter(
            x, torch.where(s, torch.inf, -torch.inf)), x)
            for x, s in ((A, up), (b, ub)))

    # the kernel's wrapper counts its launches on the name it is called by,
    # which is this function while it is installed
    data_normal.launches = 0
    return data_normal


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dims", type=int, default=512)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seeds", type=int, default=5)
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
    ulp_errs = []
    for setting in ("kernel", "kernel_det", "plain_det", "ulp"):
        torch.use_deterministic_algorithms(setting in ("kernel_det",
                                                       "plain_det"),
                                           warn_only=True)
        runs = range(args.seeds if setting == "ulp" else args.runs)
        try:
            for run in runs:
                gram_cuda.data_normal = (
                    gram_cuda.data_normal_plain if setting == "plain_det"
                    else ulp_perturbed(kernel, run) if setting == "ulp"
                    else kernel)
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    res = run_benchmark(volume_dims=args.dims, repeats=3,
                                        device="cuda")
                warned |= {str(w.message).split("\n")[0][:160]
                           for w in caught
                           if "deterministic" in str(w.message)}
                if setting == "ulp":
                    ulp_errs.append(res["err_after_3x_motion_mm"])
                print(json.dumps({
                    "setting": setting,
                    ("seed" if setting == "ulp" else "run"): run,
                    **{k: res[k] for k in (
                        "median_vertex_err_mm", "err_after_3x_motion_mm",
                        "frame_ms", "mc_dropped_cells", "corr_dropped")}}),
                    flush=True)
        finally:
            gram_cuda.data_normal = kernel
            torch.use_deterministic_algorithms(False)
    if ulp_errs:
        print(json.dumps({"ulp_err_after_3x_motion_mm": {
            "min": min(ulp_errs), "max": max(ulp_errs),
            "values": ulp_errs}}))
    print(json.dumps({"nondeterministic_warnings": sorted(warned)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
