"""The traced run's readings: spans around the program's calls, the
profiler's device trace, and host syncs.

`Spans` wraps module or class attributes of the program (`pkg.mod:Attr` or
`pkg.mod:Class.method`) in named groups: each outermost call of a group is
a `bench/<group>` profiler range, its host time is kept, and its arguments
are kept while `keep_args` is set (for the roofline readers' byte and
operation counts). `Trace` reads an exported torch.profiler trace: device
operations (kernels, copies, fills) with the host launch that issued each,
the ranges, and the host operations. `RunReadings` is what a per-layer
metric's reader gets.
"""

from __future__ import annotations

import bisect
import functools
import importlib
import json
import time
import warnings
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def resolve(target: str):
    """'pkg.mod:Name.attr' -> (owner object, attribute name)."""
    mod, path = target.split(":")
    owner = importlib.import_module(mod)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


class Spans:
    """Host-clock spans and profiler ranges around the calls of groups of
    program attributes; a call inside an open span of its own group is
    part of that span."""

    def __init__(self, groups: dict):
        self.host = defaultdict(list)  # group -> [seconds]
        self.args = defaultdict(list)  # group -> [(args, kwargs)]
        self.keep_args = False
        self._open = defaultdict(int)
        self._undo = []
        for group, targets in groups.items():
            for target in targets:
                owner, attr = resolve(target)
                fn = getattr(owner, attr)
                setattr(owner, attr, self._wrap(group, fn))
                self._undo.append((owner, attr, fn))

    def _wrap(self, group, fn):
        @functools.wraps(fn)  # keeps the wrapper's counters (`launches`)
        def span(*args, **kw):
            if self._open[group]:
                return fn(*args, **kw)
            self._open[group] += 1
            try:
                with torch.profiler.record_function(f"bench/{group}"):
                    t0 = time.perf_counter()
                    out = fn(*args, **kw)
                    self.host[group].append(time.perf_counter() - t0)
            finally:
                self._open[group] -= 1
            if self.keep_args:
                self.args[group].append((args, kw))
            return out
        return span

    def reset_host(self):
        self.host.clear()

    def remove(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo = []


def count_syncs(step, n: int) -> int:
    """Host syncs that torch's sync debug mode reports over n calls of
    step() (utils/rigid_profile.count_syncs of the port)."""
    if not torch.cuda.is_available():  # the CPU tests: nothing to count
        for _ in range(n):
            step()
        return 0
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(n):
                step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals: overlaps count
    once."""
    total, end = 0.0, None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total


def gaps(intervals, lo: float, hi: float):
    """The idle stretches of [lo, hi] outside the union of intervals."""
    out, t = [], lo
    for a, b in sorted(intervals):
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


class Trace:
    """An exported torch.profiler trace (timestamps in microseconds)."""

    def __init__(self, path):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        launch = {}
        self.device, self.annotations, self.host = [], defaultdict(list), []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat"), float(e["ts"]), float(e["dur"])
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, e["name"], cat, corr))
            elif cat in HOST_CATS:
                self.host.append((ts, ts + dur, e["name"], e.get("tid")))
                if cat == "user_annotation":
                    self.annotations[e["name"]].append((ts, ts + dur))
                if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                    launch[corr] = ts
        # the host time at which each device operation was issued
        self.issued = [launch.get(d[4]) for d in self.device]
        self.unmatched = sum(t is None for t in self.issued)

    def window(self, name: str = "bench/window"):
        return self.annotations[name][0]

    def device_in(self, lo: float, hi: float):
        """Device operations that ran inside [lo, hi]."""
        return [d for d in self.device if d[0] >= lo and d[1] <= hi]

    def device_us_issued_in(self, spans) -> float:
        """Device time of the operations issued inside any of the host
        spans (sorted, disjoint)."""
        starts = [s[0] for s in spans]
        total = 0.0
        for d, t in zip(self.device, self.issued):
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += d[1] - d[0]
        return total

    def idle_by_host(self, lo: float, hi: float, top: int = 10):
        """The device's idle time inside [lo, hi] by what the host thread
        of the window was doing at each gap's midpoint (its innermost
        operation or range): [(name, seconds)], longest first."""
        tid = next(h[3] for h in self.host if h[2] == "bench/window")
        evs = sorted((h for h in self.host if h[3] == tid),
                     key=lambda h: (h[0], -h[1]))
        busy = [(d[0], d[1]) for d in self.device_in(lo, hi)]
        qs = sorted(((a + b) / 2, b - a) for a, b in gaps(busy, lo, hi))
        acc, stack, i = defaultdict(float), [], 0
        for m, g in qs:
            while i < len(evs) and evs[i][0] <= m:
                while stack and stack[-1][1] <= evs[i][0]:
                    stack.pop()
                stack.append(evs[i])
                i += 1
            while stack and stack[-1][1] < m:
                stack.pop()
            acc[stack[-1][2] if stack else "outside any range"] += g * 1e-6
        return sorted(acc.items(), key=lambda kv: -kv[1])[:top]


class RunReadings:
    """What a per-layer metric's reader is given.

    * frames: the profiled frames; window_s / busy_s: their wall time and
      the union of the device's operations in it (s);
    * trace: the Trace; launches: kernels launched in the window;
    * span_device_s(group), span_args(group): a span group's device time
      and calls over the profiled frames;
    * span_host_ms(group): its host time per frame over the frames after
      the profiled and sync-counted ones (span_frames of them);
    * syncs, sync_frames: host syncs over the sync-counted frames;
    * latencies_ms: the frame latencies after the profiled and
      sync-counted frames.
    """

    def __init__(self, trace: Trace, frames: int, spans: Spans,
                 span_frames: int, syncs: int, sync_frames: int,
                 latencies_ms):
        self.trace, self.frames = trace, frames
        lo, hi = trace.window()
        self.lo, self.hi = lo, hi
        self.window_s = (hi - lo) * 1e-6
        inside = trace.device_in(lo, hi)
        self.busy_s = union_length([(d[0], d[1]) for d in inside]) * 1e-6
        self.launches = sum(d[3] == "kernel" for d in inside)
        self.spans, self.span_frames = spans, span_frames
        self.syncs, self.sync_frames = syncs, sync_frames
        self.latencies_ms = list(latencies_ms)

    def span_device_s(self, group: str) -> float:
        spans = sorted(s for s in self.trace.annotations[f"bench/{group}"]
                       if s[0] >= self.lo and s[1] <= self.hi)
        return self.trace.device_us_issued_in(spans) * 1e-6

    def span_args(self, group: str):
        return self.spans.args[group]

    def span_host_ms(self, group: str):
        if not self.span_frames or not self.spans.host.get(group):
            return None
        return sum(self.spans.host[group]) * 1e3 / self.span_frames
