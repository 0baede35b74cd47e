"""SE(3) rigid transforms as (R (3, 3), t (3,)) tensor pairs.

Port of dynfu_tpu/core/se3.py (cv::Affine3f as the reference uses it:
composition in kinfu.cpp:194, the rotation-vector increments of
projective_icp.cpp:151-152). Every function stays on the tensors' device,
so the ICP loop composes poses without a host read.
"""

from __future__ import annotations

import torch


def identity(device=None, dtype=torch.float32):
    return (torch.eye(3, dtype=dtype, device=device),
            torch.zeros(3, dtype=dtype, device=device))


def compose(a, b):
    """a after b: (Ra Rb, Ra tb + ta)."""
    Ra, ta = a
    Rb, tb = b
    return Ra @ Rb, Ra @ tb + ta


def inverse(a):
    R, t = a
    Rinv = R.T
    return Rinv, -(Rinv @ t)


def from_rodrigues(rvec: torch.Tensor, t: torch.Tensor):
    """Rotation vector (angle * axis) and translation -> (R, t), with
    cv::Rodrigues semantics; a zero vector gives the identity (the source
    divides by 1 where theta is 0)."""
    rvec = rvec.to(torch.float32)
    theta = torch.linalg.vector_norm(rvec)
    k = rvec / torch.where(theta == 0, 1.0, theta)
    k0, k1, k2 = k.unbind()
    z = torch.zeros_like(k0)
    K = torch.stack([z, -k2, k1, k2, z, -k0, -k1, k0, z]).reshape(3, 3)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return R, t.to(rvec.dtype)


def rvec(a) -> torch.Tensor:
    """Rotation vector of R (inverse Rodrigues)."""
    R, _ = a
    cos_theta = torch.clamp((torch.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    axis_raw = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                            R[1, 0] - R[0, 1]])
    s = torch.linalg.vector_norm(axis_raw)
    return theta * (axis_raw / torch.where(s == 0, 1.0, s))
