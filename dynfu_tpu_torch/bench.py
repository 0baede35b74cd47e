"""The port's benchmark entry: prints ONE JSON line with the headline metric.

    python3 -m dynfu_tpu_torch.bench

Headline: end-to-end non-rigid DynamicFusion frames/s on one CUDA card at
640x480 depth and a 512^3 TSDF (utils/benchmarks.run_benchmark(512), parity
mode), as `metric`, `value`, `unit` and `vs_baseline` (fps / 30, the
BASELINE.md target). On stderr, `# detail:` lines: the full 512^3 result,
then the reference's own non-rigid configuration (128^3) and SE(3) fusion at
512^3. DYNFU_BENCH_DIMS overrides the headline dims; the detail rows run
only for the default. Any failure, a detail row's included, exits non-zero.
It runs on the card and refuses to start without one.
"""

import json
import os
import sys


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dynfu_tpu_torch.bench: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from dynfu_tpu_torch.utils.benchmarks import (run_benchmark,
                                                  run_fusion_benchmark)

    dims = int(os.environ.get("DYNFU_BENCH_DIMS", "512"))
    result = run_benchmark(volume_dims=dims)
    print(json.dumps({k: result[k]
                      for k in ("metric", "value", "unit", "vs_baseline")}),
          flush=True)
    print(f"# detail: {json.dumps(result)}", file=sys.stderr, flush=True)
    if dims == 512 and not os.environ.get("DYNFU_BENCH_DIMS"):
        for row in (lambda: run_benchmark(volume_dims=128),
                    lambda: run_fusion_benchmark(volume_dims=512,
                                                 rotations=True)):
            print(f"# detail: {json.dumps(row())}", file=sys.stderr,
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
