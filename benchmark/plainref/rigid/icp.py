"""Projective point-to-plane ICP, on the tensors' device.

Port of dynfu_tpu/rigid/icp.py (the reference's
ProjectiveICP::estimateTransform, projective_icp.cpp:116-201, and
find_coresp with the 27-term reduction, proj_icp.cu:41-375). The whole
coarse-to-fine schedule stays on the device: correspondence, the 6x6 normal
equations, the pseudo-inverse solve and the pose update. A degenerate
system (|det A| < 1e-15 or NaN) freezes the pose and clears `ok` without a
host read; the caller reads the packed (R, t, ok) once per frame.

Semantics kept (non-USE_DEPTH find_coresp): s = aff * vcurr(y, x); the
previous frame's point and normal are fetched at the FLOOR of the
projection; rejected: NaN, s.z <= 0, outside the image, |s - d|^2 >
dist_thres^2, |dot(R ncurr, nd)| < cos(angle); row = [s x nd, nd],
rhs = dot(nd, d - s); the increment x = [rvec | t] goes through Rodrigues
and composes on the left.

Three association variants, as in the source: the gather (exact reference
semantics), the stencil (the fetch limited to a per-level window, through
the CUDA kernel ops/stencil_cuda.fetch_stencil) and the depth one (USE_DEPTH,
proj_icp.cu:41-68). The source's MXU-avoiding reductions and the
bf16-avoiding precision settings are TPU devices: here A and b come from
one float32 (7, N) x (N, 7) product.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from plainref.core import se3
from plainref.core.camera import Intr
from plainref.ops import imgproc, stencil_cuda

DET_MIN = 1e-15  # projective_icp.cpp:181-191
PINV_RTOL = 1e-10  # cv::solve(DECOMP_SVD)'s cutoff, as the source sets it


def _rot3(p, R):
    """(..., 3) rows times R^T as broadcast sums (the source's _rot3)."""
    return (p[..., 0:1] * R[:, 0] + p[..., 1:2] * R[:, 1]
            + p[..., 2:3] * R[:, 2])


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def pixel(c: torch.Tensor, n: int) -> torch.Tensor:
    """floor(c) clipped to [0, n - 1] as an int32 index; NaN -> 0 (casting
    NaN or inf to an integer is undefined in torch, so clamp before the
    cast)."""
    return torch.nan_to_num(torch.floor(c), nan=0.0).clamp(0, n - 1).to(
        torch.int32)


def _project(s, intr: Intr, H: int, W: int):
    """Projection of camera points: (vi, ui) int32 clipped, in_img."""
    u = intr.fx * s[..., 0] / s[..., 2] + intr.cx
    v = intr.fy * s[..., 1] / s[..., 2] + intr.cy
    in_img = (u >= 0) & (v >= 0) & (u < W) & (v < H) & (s[..., 2] > 0)
    return pixel(v, H), pixel(u, W), in_img, u, v


def _normal_equations(s, nd, d, valid):
    """A = J^T J (6, 6), b = J^T r (6,) over the valid rows, one float32
    product of [J | r]."""
    J = torch.cat([_cross(s, nd), nd], -1)
    r = _dot(nd, d - s)
    Jr = torch.cat([torch.where(valid[..., None], J, 0.0),
                    torch.where(valid, r, 0.0)[..., None]], -1)
    Jr = torch.nan_to_num(Jr).reshape(-1, 7)
    M = Jr.T @ Jr
    return M[:6, :6], M[:6, 6]


def _gates(s, ns, d, nd, dist2_thres: float, min_cosine: float):
    diff = s - d
    return ((_dot(diff, diff) <= dist2_thres)
            & (_dot(ns, nd).abs() >= min_cosine))


def _icp_normal_equations(R, t, vcurr, ncurr, vprev, nprev, intr: Intr,
                          dist2_thres: float, min_cosine: float,
                          radius: int | None = None):
    """Whole-image masked normal equations; radius=None gathers at the
    projected pixel, an int fetches through the stencil window."""
    H, W = vcurr.shape[:2]
    s = _rot3(vcurr, R) + t
    vi, ui, in_img, _, _ = _project(s, intr, H, W)
    if radius is None:
        vil, uil = vi.long(), ui.long()
        d, nd = vprev[vil, uil], nprev[vil, uil]
    else:
        both = stencil_cuda.fetch_stencil(
            torch.cat([vprev, nprev], -1).contiguous(), vi, ui, radius)
        d, nd = both[..., :3], both[..., 3:]
    ns = _rot3(ncurr, R)
    valid = (~torch.isnan(vcurr[..., 0]) & in_img & ~torch.isnan(d[..., 0])
             & _gates(s, ns, d, nd, dist2_thres, min_cosine))
    return _normal_equations(s, nd, d, valid)


def _icp_normal_equations_depth(R, t, dcurr, ncurr, dprev, nprev, intr: Intr,
                                dist2_thres: float, min_cosine: float):
    """USE_DEPTH correspondence (proj_icp.cu:41-68): the current vertex is
    the depth reprojected at its own pixel, the previous one the depth
    fetched at the projected pixel, reprojected there."""
    H, W = dcurr.shape
    dev = dcurr.device
    fx = imgproc.f32_scalar(intr.fx, dev)
    fy = imgproc.f32_scalar(intr.fy, dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    z = dcurr.to(torch.float32) * 0.001
    pcur = torch.stack([z * (xs - intr.cx) / fx, z * (ys - intr.cy) / fy, z],
                       -1)
    s = _rot3(pcur, R) + t
    vi, ui, in_img, u, v = _project(s, intr, H, W)
    vil, uil = vi.long(), ui.long()
    dz = dprev[vil, uil].to(torch.float32) * 0.001
    d = torch.stack([dz * (u - intr.cx) / fx, dz * (v - intr.cy) / fy, dz],
                    -1)
    nd = nprev[vil, uil]
    ns = _rot3(ncurr, R)
    valid = ((dcurr > 0) & in_img & (dz > 0)
             & _gates(s, ns, d, nd, dist2_thres, min_cosine)
             & ~torch.isnan(nd[..., 0]) & ~torch.isnan(ncurr[..., 0]))
    return _normal_equations(s, nd, d, valid)


def _solve_svd(A, b):
    """cv::solve(..., DECOMP_SVD): pseudo-inverse least squares. A
    non-finite system is replaced by (I, 0) first — torch's SVD raises on
    it where the source's returns NaN — and the caller's det guard, taken
    on the original A, rejects the step."""
    finite = torch.isfinite(A).all() & torch.isfinite(b).all()
    eye = torch.eye(6, dtype=A.dtype, device=A.device)
    A = torch.where(finite, A, eye)
    b = torch.where(finite, b, 0.0)
    return torch.linalg.pinv(A, rtol=PINV_RTOL) @ b


def _step(A, b, R, t, ok):
    """One guarded Gauss-Newton update of (R, t); on a degenerate A the pose
    freezes and ok goes False for good."""
    det = torch.linalg.det(A)
    good = ok & (det.abs() >= DET_MIN) & ~torch.isnan(det)
    x = _solve_svd(A, b)
    Rn, tn = se3.compose(se3.from_rodrigues(x[:3], x[3:]), (R, t))
    return torch.where(good, Rn, R), torch.where(good, tn, t), good


def _min_cos(angle_thres: float) -> float:
    """cos of the float32 angle, in float32 (as the source)."""
    return float(torch.cos(torch.tensor(angle_thres, dtype=torch.float32)))


def _schedule(curr_pyr, prev_pyr, intr: Intr, iters, dist_thres: float,
              angle_thres: float, equations):
    """Coarse to fine over the levels with iterations; equations(level,
    R, t, curr, prev, level_intr, dist2, min_cos) -> (A, b)."""
    dist2 = dist_thres * dist_thres
    min_cos = _min_cos(angle_thres)
    dev = curr_pyr[0][0].device
    R, t = se3.identity(dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for level in range(len(iters) - 1, -1, -1):
        for _ in range(iters[level]):
            A, b = equations(level, R, t, curr_pyr[level], prev_pyr[level],
                             intr.level(level), dist2, min_cos)
            R, t, ok = _step(A, b, R, t, ok)
    return (R, t), ok


def build_pyramids(points, normals, levels: int):
    """Point/normal pyramid by the reference's 2x2 resize
    (resizePointsNormals, kinfu.cpp:219-227)."""
    pyr = [(points, normals)]
    for _ in range(levels - 1):
        pyr.append(imgproc.resize_points_normals(*pyr[-1]))
    return pyr


def estimate_transform(curr_pyr: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                       prev_pyr: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                       intr: Intr, iters: Tuple[int, ...] = (10, 5, 4, 0),
                       dist_thres: float = 0.1,
                       angle_thres: float = 0.5235988):
    """Coarse-to-fine rigid pose with the gather association.

    Returns ((R, t), ok): the transform taking the CURRENT camera frame into
    the PREVIOUS one, and False where the system went degenerate (the
    reference then resets the reconstruction)."""
    def eq(level, R, t, curr, prev, lintr, dist2, min_cos):
        return _icp_normal_equations(R, t, *curr, *prev, lintr, dist2,
                                     min_cos)
    return _schedule(curr_pyr, prev_pyr, intr, iters, dist_thres,
                     angle_thres, eq)


def estimate_transform_stencil(
        curr_pyr: Sequence[Tuple[torch.Tensor, torch.Tensor]],
        prev_pyr: Sequence[Tuple[torch.Tensor, torch.Tensor]], intr: Intr,
        iters: Tuple[int, ...] = (10, 5, 4, 0), dist_thres: float = 0.1,
        angle_thres: float = 0.5235988,
        radii: Tuple[int, ...] = (2, 3, 4, 6)):
    """`estimate_transform` with the previous frame fetched through the
    stencil window of each level's radius (coarse levels wider): a flow
    outside the window drops out like an out-of-image projection."""
    def eq(level, R, t, curr, prev, lintr, dist2, min_cos):
        radius = radii[level] if level < len(radii) else radii[-1]
        return _icp_normal_equations(R, t, *curr, *prev, lintr, dist2,
                                     min_cos, radius=radius)
    return _schedule(curr_pyr, prev_pyr, intr, iters, dist_thres,
                     angle_thres, eq)


def estimate_transform_depth(curr_pyr, prev_pyr, intr: Intr,
                             iters: Tuple[int, ...] = (10, 5, 4, 0),
                             dist_thres: float = 0.1,
                             angle_thres: float = 0.5235988):
    """Coarse-to-fine pose on (depth_mm, normals) pyramids (the reference's
    USE_DEPTH build, projective_icp.cpp:116-155); same return contract."""
    def eq(level, R, t, curr, prev, lintr, dist2, min_cos):
        return _icp_normal_equations_depth(R, t, *curr, *prev, lintr, dist2,
                                           min_cos)
    return _schedule(curr_pyr, prev_pyr, intr, iters, dist_thres,
                     angle_thres, eq)
