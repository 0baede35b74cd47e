"""Timing / fps instrumentation.

Port of dynfu_tpu/utils/timers.py, the analog of kfusion's ScopeTime and
SampledScopeTime (include/kfusion/types.hpp:70-90, src/kfusion/core.cpp:
213-233): a block timer and an fps meter that prints the average frame time
and fps every EACH = 33 frames, like the reference's demo loop
(demo.cpp:92-95). PyTorch returns before the card finishes, so a span that
should cover the card's work ends in `sync` on a tensor it produced.
"""

from __future__ import annotations

import time

import torch


def sync(*tensors) -> None:
    """Wait for all queued work on the devices of `tensors`."""
    done = set()
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda and t.device not in done:
            torch.cuda.synchronize(t.device)
            done.add(t.device)


class ScopeTime:
    """with ScopeTime("name"): ... -> prints elapsed ms (types.hpp:70-77)."""

    def __init__(self, name: str, quiet: bool = False):
        self.name = name
        self.quiet = quiet
        self.ms = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ms = (time.perf_counter() - self._t0) * 1e3
        if not self.quiet:
            print(f"Time({self.name}) = {self.ms:.2f} ms")
        return False


class SampledScopeTime:
    """Accumulates frame time; prints avg ms + fps every EACH frames
    (types.hpp:79-90, core.cpp:213-223: EACH = 33)."""

    EACH = 33

    def __init__(self):
        self.time_ms = 0.0
        self.i = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.time_ms += (time.perf_counter() - self._t0) * 1e3
        self.i += 1
        if self.i % self.EACH == 0:
            avg = self.time_ms / self.EACH
            print(f"Average frame time = {avg:.2f} ms ( {1000.0 / avg:.1f} fps )")
            self.time_ms = 0.0
        return False

    @property
    def fps(self) -> float:
        done = self.i % self.EACH or self.EACH
        return 1000.0 / (self.time_ms / done) if self.time_ms else 0.0
