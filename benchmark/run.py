"""Run one benchmark cell of dynfu_tpu_torch once, on one NVIDIA GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell, its configuration and its traffic
mix are found by name from BENCHMARK.json. Prints the compared numbers
beside their limits on standard error, then one JSON object as the last
line of standard output: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), device (and
breakdown when traced), the card's power limit, and checks last. Exits
non-zero, printing no result, without a CUDA card (or fewer than the cell
asks for), when JAX or the JAX package got loaded, or on any error.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path


def process_start() -> float:
    """The wall-clock time this process started (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()
BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _num(v):
    return v if v is None or math.isfinite(v) else str(v)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))  # the program, dynfu_tpu_torch
    import torch

    from dfbench import loop

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = power_limit()
    kind = torch.cuda.get_device_name(0)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    log(f"card: {kind}, {torch.cuda.device_count()} visible; nvidia-smi: "
        f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    res = loop.run_cell(bench, args.workload, args.seed, args.seconds,
                        bool(args.trace), dev, T_START, log=log)
    bad = loop.forbidden_modules()
    if bad:
        log(f"loaded in this process: {', '.join(bad)} (JAX or the JAX "
            "package); no result")
        return 3
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": res["memory_peak_bytes"]}
    if args.trace:
        device["busy_s"] = res["traced"]["busy_s"]
        device["window_s"] = res["traced"]["window_s"]
        log(f"trace: {res['traced']}")
    log(f"checked frames {res['checked_frames']}")
    for name, v, lim in res["checks"]:
        log(f"check {name}: {v!r} (limit {lim!r})")
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": res["metrics"],
           "device": device}
    if "breakdown" in res:
        out["breakdown"] = res["breakdown"]
    out["card"] = card
    out["checks"] = {name: {"value": _num(v), "limit": lim}
                     for name, v, lim in res["checks"]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
