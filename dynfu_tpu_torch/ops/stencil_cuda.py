"""Bounded-window stencil fetch: CUDA kernel wrapper and plain version.

Replaces the Pallas kernel fetch_stencil_tpu
(dynfu_tpu/ops/stencil_pallas.py:52), which the rigid ICP's association
reaches through rigid/icp._fetch_stencil. Kernel source: csrc/stencil.cu.
"""

from __future__ import annotations

import torch

from dynfu_tpu_torch import kernels


def _window(vi: torch.Tensor, ui: torch.Tensor, radius: int) -> torch.Tensor:
    H, W = vi.shape
    ys = torch.arange(H, device=vi.device)[:, None]
    xs = torch.arange(W, device=vi.device)[None, :]
    return ((vi - ys).abs() <= radius) & ((ui - xs).abs() <= radius)


def fetch_stencil_plain(img: torch.Tensor, vi: torch.Tensor, ui: torch.Tensor,
                        radius: int) -> torch.Tensor:
    """img[vi, ui] where the flow (vi - y, ui - x) fits [-radius, radius]^2,
    NaN elsewhere (the source's roll-and-select chain computes the same for
    clipped indices; reads use indices clamped to the image, as the kernel
    does)."""
    kernels.count_plain(fetch_stencil_plain, img)
    H, W = vi.shape
    rows = img[vi.clamp(0, H - 1).long(), ui.clamp(0, W - 1).long()]
    return torch.where(_window(vi, ui, radius)[..., None], rows, torch.nan)


fetch_stencil_plain.cuda_calls = 0


def fetch_stencil(img: torch.Tensor, vi: torch.Tensor, ui: torch.Tensor,
                  radius: int) -> torch.Tensor:
    """img (H, W, C) f32, vi / ui (H, W) i32 clipped to the image, radius
    >= 0 -> (H, W, C) f32."""
    if not kernels.on_cuda(img, "fetch_stencil"):
        return fetch_stencil_plain(img, vi, ui, radius)
    H, W, C = img.shape
    dev = img.device
    kernels.require(img, "img", torch.float32, (H, W, C), dev)
    kernels.require(vi, "vi", torch.int32, (H, W), dev)
    kernels.require(ui, "ui", torch.int32, (H, W), dev)
    if H * W * C < 1 or radius < 0:
        raise ValueError("fetch_stencil: empty image or negative radius")
    out = torch.empty_like(img)
    lib = kernels.load()
    kernels.check(lib.dynfu_fetch_stencil(
        img.data_ptr(), vi.data_ptr(), ui.data_ptr(), H, W, C, int(radius),
        out.data_ptr(), kernels.stream(img)), "fetch_stencil")
    fetch_stencil.launches += 1
    return out


fetch_stencil.launches = 0
