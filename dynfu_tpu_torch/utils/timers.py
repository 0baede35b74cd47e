"""Timing helpers.

Port of dynfu_tpu/utils/timers.sync: PyTorch returns before the card
finishes, so a wall-clock span must end in a device synchronize to cover
the work it launched.
"""

from __future__ import annotations

import torch


def sync(*tensors) -> None:
    """Wait for all queued work on the devices of `tensors`."""
    done = set()
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda and t.device not in done:
            torch.cuda.synchronize(t.device)
            done.add(t.device)
