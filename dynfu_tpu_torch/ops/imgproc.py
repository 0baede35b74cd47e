"""Depth-image preprocessing: the subset the engines run.

Port of compute_dists, bilateral_filter, truncate_depth,
compute_points_normals, depth_pyramid_down, resize_depth_normals and
resize_points_normals from dynfu_tpu/ops/imgproc.py (the reference's
imgproc.cu kernels), with the same quirks: the bilateral and pyramid
windows' exclusive upper bound (the last row and column never contribute),
round-half-to-even of the weighted mean, integer division in the depth
pyramid, unnormalised pooled normals, and dists stored in float16 — the
narrowing is part of the semantics (imgproc.cu:248-262).
"""

from __future__ import annotations

import numpy as np
import torch

from dynfu_tpu_torch.core.camera import Intr
from dynfu_tpu_torch.volume.tsdf import sqrt_rn


def _shift2d(img, dy: int, dx: int, fill):
    """out[y, x] = img[y + dy, x + dx], padded with `fill`."""
    H, W = img.shape[:2]
    out = torch.full_like(img, fill)
    ys, ye = max(-dy, 0), min(H, H - dy)
    xs, xe = max(-dx, 0), min(W, W - dx)
    if ys < ye and xs < xe:
        out[ys:ye, xs:xe] = img[ys + dy:ye + dy, xs + dx:xe + dx]
    return out


def _neighbor_valid(H: int, W: int, dy: int, dx: int, device):
    """Neighbour (y+dy, x+dx) in bounds AND strictly below the last row and
    column (imgproc.cu:18-19)."""
    ys = torch.arange(H, device=device)[:, None] + dy
    xs = torch.arange(W, device=device)[None, :] + dx
    return (ys >= 0) & (ys <= H - 2) & (xs >= 0) & (xs <= W - 2)


def bilateral_filter(depth_mm: torch.Tensor, kernel_size: int = 7,
                     sigma_spatial: float = 4.5,
                     sigma_depth: float = 0.04) -> torch.Tensor:
    """Depth-aware bilateral filter on millimetre depth (int32 -> int32)."""
    H, W = depth_mm.shape
    d = depth_mm.to(torch.float32)
    inv_sp = np.float32(0.5 / (sigma_spatial * sigma_spatial))
    inv_sd = float(np.float32(0.5 / ((sigma_depth * 1000.0) ** 2)))
    half = kernel_size // 2
    num = torch.zeros_like(d)
    den = torch.zeros_like(d)
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            nb = _shift2d(d, dy, dx, 0.0)
            valid = _neighbor_valid(H, W, dy, dx, d.device)
            # the spatial term is one float32 product, as in the source
            space = float(np.float32(dy * dy + dx * dx) * inv_sp)
            color2 = (d - nb) ** 2
            wgt = torch.exp(-(color2 * inv_sd + space))
            wgt = torch.where(valid, wgt, 0.0)
            num = num + nb * wgt
            den = den + wgt
    out = num / torch.clamp_min(den, 1e-30)
    return torch.round(out).to(depth_mm.dtype)


def truncate_depth(depth_mm: torch.Tensor, max_dist_m: float) -> torch.Tensor:
    """Zero out depth beyond max_dist meters (compared in integer mm)."""
    max_mm = int(np.int32(max_dist_m * 1000.0))
    return torch.where(depth_mm > max_mm, 0, depth_mm)


def compute_dists(depth_mm: torch.Tensor, intr: Intr) -> torch.Tensor:
    """Radial ray length in meters, float16 (the reference packs half)."""
    H, W = depth_mm.shape
    dev = depth_mm.device
    x = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    y = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xl = (x - intr.cx) / f32_scalar(intr.fx, dev)
    yl = (y - intr.cy) / f32_scalar(intr.fy, dev)
    lam = sqrt_rn(xl * xl + yl * yl + 1.0)
    return (depth_mm.to(torch.float32) * lam * 0.001).to(torch.float16)


def compute_points_normals(depth_mm: torch.Tensor, intr: Intr):
    """Point and normal maps from right/down finite differences
    (imgproc.cu:186-215): normal = -normalize((v01 - v00) x (v10 - v00));
    valid iff x < W-1, y < H-1 and the three depths are nonzero. Returns
    (points (H, W, 3), normals (H, W, 3)), NaN at invalid pixels."""
    H, W = depth_mm.shape
    dev = depth_mm.device
    fx, fy = f32_scalar(intr.fx, dev), f32_scalar(intr.fy, dev)
    z = depth_mm.to(torch.float32) * 0.001
    x = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    y = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    z01 = _shift2d(z, 0, 1, 0.0)
    z10 = _shift2d(z, 1, 0, 0.0)
    v00 = torch.stack([z * (x - intr.cx) / fx, z * (y - intr.cy) / fy, z], -1)
    v01 = torch.stack([z01 * (x + 1 - intr.cx) / fx,
                       z01 * (y - intr.cy) / fy, z01], -1)
    v10 = torch.stack([z10 * (x - intr.cx) / fx,
                       z10 * (y + 1 - intr.cy) / fy, z10], -1)
    a, b = v01 - v00, v10 - v00
    c = torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                     a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                     a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)
    n = -(c / torch.linalg.vector_norm(c, dim=-1, keepdim=True))
    interior = ((torch.arange(W, device=dev)[None, :] < W - 1)
                & (torch.arange(H, device=dev)[:, None] < H - 1))
    valid = (interior & (z * z01 * z10 != 0))[..., None]
    return (torch.where(valid, v00, torch.nan),
            torch.where(valid, n, torch.nan))


def depth_pyramid_down(depth_mm: torch.Tensor,
                       sigma_depth: float = 0.04) -> torch.Tensor:
    """One 2x downsample level with depth-gated 5x5 averaging
    (imgproc.cu:85-125): neighbours within 3 sigma_depth (mm) of the centre
    pixel src(2y, 2x), window bound exclusive of the last row and column;
    output sum // count, 0 where nothing is kept."""
    H, W = depth_mm.shape
    Ho, Wo = H // 2, W // 2
    dev = depth_mm.device
    d = depth_mm.to(torch.int32)
    thresh = float(np.float32(sigma_depth * 1000.0 * 3.0))
    center = d[:2 * Ho:2, :2 * Wo:2]
    s = torch.zeros((Ho, Wo), dtype=torch.int32, device=dev)
    c = torch.zeros((Ho, Wo), dtype=torch.int32, device=dev)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            nb = _shift2d(d, dy, dx, 0)[:2 * Ho:2, :2 * Wo:2]
            ys = torch.arange(Ho, device=dev)[:, None] * 2 + dy
            xs = torch.arange(Wo, device=dev)[None, :] * 2 + dx
            valid = (ys >= 0) & (ys <= H - 2) & (xs >= 0) & (xs <= W - 2)
            keep = valid & ((nb - center).abs().to(torch.float32) < thresh)
            s = s + torch.where(keep, nb, 0)
            c = c + keep.to(torch.int32)
    out = torch.div(s, torch.clamp_min(c, 1), rounding_mode="floor")
    return torch.where(c == 0, 0, out).to(depth_mm.dtype)


def _quads(img: torch.Tensor):
    """The four pixels of every 2x2 block, (Ho, Wo, ...) each, in the order
    (y0 x0, y0 x1, y1 x0, y1 x1)."""
    H, W = img.shape[:2]
    Ho, Wo = H // 2, W // 2
    return (img[0:2 * Ho:2, 0:2 * Wo:2], img[0:2 * Ho:2, 1:2 * Wo:2],
            img[1:2 * Ho:2, 0:2 * Wo:2], img[1:2 * Ho:2, 1:2 * Wo:2])


def _sum4(a, b, c, d):
    """The 2x2 sum as the source's XLA reduction adds it on the CPU under
    the test suite's settings (tests/conftest.py caps the ISA at AVX2): the
    rows pairwise. Another order differs by an ulp."""
    return (a + b) + (c + d)


def _pool_mean(img: torch.Tensor) -> torch.Tensor:
    return _sum4(*_quads(img)) * 0.25


def resize_depth_normals(depth_mm: torch.Tensor, normals: torch.Tensor):
    """Half-resolution depth and normals (imgproc.cu:262-318): 2x2 mean,
    the depth by integer division; valid iff d00 * d01 != 0 and
    d10 * d11 != 0; normals not renormalised."""
    d00, d01, d10, d11 = _quads(depth_mm)
    valid = (d00 * d01 != 0) & (d10 * d11 != 0)
    dsum = d00 + d01 + d10 + d11
    dout = torch.where(valid, torch.div(dsum, 4, rounding_mode="floor"), 0)
    nout = torch.where(valid[..., None], _pool_mean(normals), torch.nan)
    return dout.to(depth_mm.dtype), nout


def resize_points_normals(points: torch.Tensor, normals: torch.Tensor):
    """Half-resolution point and normal maps (imgproc.cu:321-344): 2x2
    mean, valid iff all four points are finite (their x sum is not NaN);
    normals not renormalised."""
    valid = ~torch.isnan(_sum4(*_quads(points[..., 0])))[..., None]
    return (torch.where(valid, _pool_mean(points), torch.nan),
            torch.where(valid, _pool_mean(normals), torch.nan))


def f32_scalar(v: float, device) -> torch.Tensor:
    """A float32 scalar TENSOR: CUDA divides by a Python-scalar divisor as a
    multiply by its reciprocal, which rounds differently from a division."""
    return torch.tensor(v, dtype=torch.float32, device=device)
