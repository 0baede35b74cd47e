"""The reference's device check. The port's kernel dispatch is not copied:
every wrapper of the reference runs its plain version, on the card as on
the CPU, and nothing here builds or launches a CUDA kernel."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """A torch.device; a CUDA device without a usable card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is "
                           "False")
    return device
