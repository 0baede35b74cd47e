"""Bounded-window stencil fetch, the plain version.

The port's wrapper launches csrc/stencil.cu on the card; here every call
takes the plain version. The rigid ICP's association reaches it through
rigid/icp._fetch_stencil.
"""

from __future__ import annotations

import torch


def _window(vi: torch.Tensor, ui: torch.Tensor, radius: int) -> torch.Tensor:
    H, W = vi.shape
    ys = torch.arange(H, device=vi.device)[:, None]
    xs = torch.arange(W, device=vi.device)[None, :]
    return ((vi - ys).abs() <= radius) & ((ui - xs).abs() <= radius)


def fetch_stencil(img: torch.Tensor, vi: torch.Tensor, ui: torch.Tensor,
                  radius: int) -> torch.Tensor:
    """img (H, W, C) f32, vi / ui (H, W) i32 clipped to the image, radius
    >= 0 -> (H, W, C) f32: img[vi, ui] where the flow (vi - y, ui - x)
    fits [-radius, radius]^2, NaN elsewhere (the source's roll-and-select chain computes the same for
    clipped indices; reads use indices clamped to the image, as the kernel
    does)."""
    H, W = vi.shape
    rows = img[vi.clamp(0, H - 1).long(), ui.clamp(0, W - 1).long()]
    return torch.where(_window(vi, ui, radius)[..., None], rows, torch.nan)
