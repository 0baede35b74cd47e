"""One run of one cell: set-up, the closed-loop window, the check.

`run_cell` is everything a run does after the look for a card (run.py
makes that look and prints the result): it makes the frames from the
seed, builds the program's engine and runs the set-up frames, then hands
the engine one frame at a time for `seconds`, the next once the last one's
output is synchronised on the card, then checks sampled frames against the
plain reference. With trace, the first PROFILED frames of the window run
under torch.profiler, the next SYNC_COUNTED under the sync debug mode, and
the per-layer metrics are read from them and the rest of the window.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from dfbench import check, engines, scenes, trace

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
PROGRAM = "dynfu_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "dynfu_tpu")

PROFILED = 4  # frames under torch.profiler (it drops events on long runs)
SYNC_COUNTED = 4  # frames under the sync debug mode
# the checked frames: the first to start after each of CHECKED times drawn
# from the seed in [0.1, 0.95] of the window, and from its CHECK_FROM-th
# frame on (the traced frames come before)
CHECK_FROM, CHECKED = 8, 2


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, name: str):
    """(cell, configuration, mix) of the cell `name`, found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(ROOT / conf["file"])
    mix = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    return cell, config, mix


def applies(metric: dict, cell: str) -> bool:
    """Whether the cell reports the metric: every cell, or those its
    `workloads` lists."""
    return cell in metric.get("workloads", [cell])


def load_reader(name: str):
    """benchmark/metrics/<name>.py as a module."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (dynfu_tpu_torch is not dynfu_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def p95(values) -> float:
    """The 95th percentile (numpy's linear interpolation)."""
    return float(np.percentile(np.asarray(values, np.float64), 95))


def truth_errors(config, mix, frames, eng, k: int, n: int) -> dict:
    """The program's last frame (k) against the analytic scene (printed,
    not judged): the warped surface's median distance to the sphere, or to
    the umbrella's clean depth along the camera ray, in mm; the rigid
    camera's distance to the true one, in mm, the median over the last n
    frames of its step's distance to the true step (rpe_mm), and the
    resets."""
    j = frames.index(k)
    if config["engine"] == "kinfu":
        cam = [np.asarray(frames.truth[frames.index(i)]["camera"])
               for i in (0, k)]
        out = {"camera_err_mm": float(np.linalg.norm(
            np.asarray(eng.poses[-1][1], np.float64) - (cam[1] - cam[0])))
            * 1e3, "resets": eng.resets}
        n = min(n, len(eng.poses) - 1)
        if eng.resets == 0 and n > 0:
            t = [np.asarray(eng.poses[i][1], np.float64)
                 for i in range(k - n, k + 1)]
            c = [np.asarray(frames.truth[frames.index(i)]["camera"])
                 for i in range(k - n, k + 1)]
            out["rpe_mm"] = float(np.median([np.linalg.norm(
                (t[i + 1] - t[i]) - (c[i + 1] - c[i])) for i in range(n)]))\
                * 1e3
        return out
    v, m = eng.warped_cloud(unique=True)
    v = v[m].double() + eng.vol.pose_t.double()
    if mix["scene"] == "spheres":
        c = mix["spheres"][0][0]
        r = frames.truth[j]["radius"]
        c = torch.as_tensor(c, dtype=torch.float64, device=v.device) + \
            torch.as_tensor(frames.truth[j]["object"], device=v.device)
        err = (torch.linalg.norm(v - c, dim=1) - r).abs()
    else:
        cam = config["camera"]
        z = scenes.render_umbrella(frames.truth[j]["phase"], cam, v.device)
        u = torch.round(cam["fx"] * v[:, 0] / v[:, 2] + cam["cols"] / 2
                        - 0.5).long()
        w = torch.round(cam["fy"] * v[:, 1] / v[:, 2] + cam["rows"] / 2
                        - 0.5).long()
        ok = (u >= 0) & (u < cam["cols"]) & (w >= 0) & (w < cam["rows"])
        zc = z[w[ok], u[ok]]
        err = (v[ok, 2] - zc)[torch.isfinite(zc)].abs()
    return {"surface_err_mm": float(err.median()) * 1e3 if err.numel()
            else math.nan}


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             traced: bool, device, t_start: float, log=print,
             control: bool = False) -> dict:
    """One run; returns the result's fields (and `checks`)."""
    device = torch.device(device)
    _, config, mix = cell_files(bench, name)
    adapter = engines.ADAPTERS[config["engine"]]
    rng = np.random.default_rng(seed)
    voxel_offset = int(rng.integers(engines.VOXEL_STRIDE))
    check_at = sorted(rng.uniform(0.1, 0.95, CHECKED) * seconds)
    frames = scenes.make(mix, config["camera"], seed, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    per_layer = [m for m in bench["per_layer"] if applies(m, name)]
    e2e = [m for m in bench["end_to_end"] if applies(m, name)]
    readers = ({m["name"]: load_reader(m["name"]) for m in per_layer}
               if traced else {})
    probe = engines.Probe(PROGRAM, adapter.probes)
    spans = None
    try:
        eng = engines.build(PROGRAM, config, mix, device)
        # set-up: frame 0 and the warm-up frames; the start check's
        # outputs are read on the way
        first = start = None
        for k in range(config["warmup_frames"] + 1):
            probe.armed = k == adapter.start_frame
            eng(frames.depth(k))
            adapter.output(eng)
            sync(device)
            if k == 0:
                first = adapter.start_outputs(eng)
            if k == adapter.start_frame:
                start = (first, adapter.outputs(eng, probe, voxel_offset))
        probe.armed = False
        if traced:
            groups = {}
            for r in readers.values():
                groups.update(getattr(r, "SPANS", {}))
            spans = trace.Spans(groups)
        g0 = config["warmup_frames"] + 1
        setup_s = time.time() - t_start

        lat, samples, solves, failed = [], [], [], 0
        prof = prof_path = None
        syncs = 0
        t_w0 = time.perf_counter()
        j = 0
        while True:
            k = g0 + j
            if traced and j == 0:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
                win = torch.profiler.record_function("bench/window")
                win.__enter__()
                spans.keep_args = True
            checking = (j >= CHECK_FROM and len(samples) < len(check_at)
                        and time.perf_counter() - t_w0
                        >= check_at[len(samples)])
            if checking:
                pre = adapter.state(eng)
                probe.armed = True
            before = getattr(eng, "resets", 0)

            def step(k=k):
                eng(frames.depth(k))
                adapter.output(eng)
                sync(device)

            t0 = time.perf_counter()
            try:
                if traced and PROFILED <= j < PROFILED + SYNC_COUNTED:
                    syncs += trace.count_syncs(step, 1)
                else:
                    step()
                solves.append(adapter.solve_stats(eng))
            except Exception as e:  # a failed frame counts, the loop goes on
                failed += 1
                log(f"frame {k} raised {type(e).__name__}: {e}")
            t1 = time.perf_counter()
            lat.append((t1 - t0) * 1e3)
            if adapter.failed(eng, before):
                failed += 1
            if checking:
                probe.armed = False
                samples.append((k, pre, adapter.outputs(eng, probe,
                                                        voxel_offset)))
            if traced and j == PROFILED - 1:
                win.__exit__(None, None, None)
                spans.keep_args = False
                prof.__exit__(None, None, None)
                fd, prof_path = tempfile.mkstemp(suffix=".json")
                os.close(fd)
                prof.export_chrome_trace(prof_path)
            if traced and j == PROFILED + SYNC_COUNTED - 1:
                spans.reset_host()
            j += 1
            # the window lasts `seconds`, and until its checked (and, when
            # traced, its profiled and sync-counted) frames have run
            if t1 - t_w0 >= seconds and len(samples) == CHECKED and (
                    not traced or j > PROFILED + SYNC_COUNTED):
                break
        window_s = time.perf_counter() - t_w0
        k_last = g0 + j - 1
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        truth = truth_errors(config, mix, frames, eng, k_last, j)
        solves = [x for x in solves if x is not None]
        if solves:
            it, c0, c1 = torch.stack(solves).cpu().numpy().T
            truth["solve"] = (
                f"the last PCG's iterations median {np.median(it)}, max "
                f"{it.max()}; final / initial cost median "
                f"{np.median(c1 / np.maximum(c0, 1e-30))} over {len(it)} "
                f"frames")

        res = {"attempted": j, "failed": failed}
        if traced:
            tr = trace.Trace(prof_path)
            os.unlink(prof_path)
            tail = PROFILED + SYNC_COUNTED
            readings = trace.RunReadings(
                tr, PROFILED, spans, j - tail, syncs, SYNC_COUNTED,
                lat[tail:])
            metrics = {}
            for m in per_layer:
                v = readers[m["name"]].read(readings)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            lo, hi = tr.window()
            ops = {}
            for d in tr.device_in(lo, hi):
                ops[d[2]] = ops.get(d[2], 0.0) + (d[1] - d[0]) * 1e-6
            res["breakdown"] = {
                "device_ops": [[n[:200], s] for n, s in sorted(
                    ops.items(), key=lambda kv: -kv[1])[:10]],
                "idle_gaps": [[n[:200], s]
                              for n, s in tr.idle_by_host(lo, hi)]}
            res["traced"] = {"busy_s": readings.busy_s,
                             "window_s": readings.window_s,
                             "unmatched_device_ops": tr.unmatched,
                             "device_ops": len(tr.device)}
        else:
            values = {"fps": len(lat) / window_s,
                      "frame_ms_p95": p95(lat),
                      "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
            metrics = {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]} for m in e2e}
        res["metrics"] = metrics
        res["memory_peak_bytes"] = peak
        log(f"window: {j} frames in {window_s:.3f} s, latency median "
            f"{np.median(lat):.3f} ms, p95 {p95(lat):.3f} ms over {len(lat)} "
            f"frames ({sum(x > p95(lat) for x in lat)} beyond it), failed "
            f"{failed}; set-up {setup_s:.3f} s")
        log(f"against the analytic scene (not judged): {truth}")
    finally:
        probe.remove()
        if spans is not None:
            spans.remove()
    del eng
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    nums = check.compare(config, mix, frames, voxel_offset, start, samples,
                         device, np.random.default_rng(seed))
    ok, rows = check.judge(nums, config["limits"])
    if control:  # the control's numbers, for calibrate.py
        res["control"] = check.compare(
            config, mix, frames, voxel_offset, start, samples, device,
            np.random.default_rng(seed), control=True)
    res["correct"] = ok
    res["checks"] = rows
    res["numbers"] = nums
    res["checked_frames"] = [s[0] for s in samples]
    return res
