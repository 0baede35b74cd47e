"""Readings the limits of `correct` are set from: the program against the
plain reference over many seeds, and the control (the reference in
bfloat16) against it over the first few.

    python3 benchmark/calibrate.py --workload <cell> --first-seed <n> \
        [--seeds 12] [--control 3] [--seconds 1]

On the card, from the root of a checkout; one process for every seed, so
the kernels build once. Each seed runs the cell's set-up and a window of
`--seconds` (at least until its checked frames ran), then compares as a
run does; the control's numbers are read from the same frames and states.
Prints one JSON line a seed, with the verdict of `check.judge` on the
program's numbers and on the control's, and, last, each number's lower
reading (the largest of the program's), its upper reading (the smallest of
the control's) and its limit. Exits 1 where a seed of the program is not
correct or a control is. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from dfbench import check, loop

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    limits = loop.cell_files(bench, args.workload)[1]["limits"]
    lower, upper = {}, {}
    bad = 0
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        res = loop.run_cell(bench, args.workload, seed, args.seconds, False,
                            torch.device("cuda", 0), time.time(),
                            log=lambda m: print(m, file=sys.stderr),
                            control=i < args.control)
        for k, v in res["numbers"].items():
            lower[k] = max(lower.get(k, 0.0), v)
        for k, v in res.get("control", {}).items():
            upper[k] = min(upper.get(k, math.inf), v)
        control_ok = (check.judge(res["control"], limits)[0]
                      if "control" in res else None)
        bad += (not res["correct"]) + bool(control_ok)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "numbers": res["numbers"],
                          "control_correct": control_ok,
                          "control": res.get("control")},
                         default=str), flush=True)
    print(json.dumps({k: {"lower": lower[k], "upper": upper.get(k),
                          "limit": limits.get(k)} for k in sorted(lower)},
                     default=str), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
