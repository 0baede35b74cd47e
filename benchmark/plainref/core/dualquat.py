"""Dual-quaternion math on (..., 8) tensors.

Port of dynfu_tpu/core/dualquat.py. Layout ``dq = [rw, rx, ry, rz, dw, dx,
dy, dz]``: the real (rotation) quaternion, then the dual (displacement) one.
The reference's quirks are kept, because its tests and the solver pin them:

* the (rotation, translation) constructor divides the rotation by |q|^2
  (boost's Cayley norm), not by |q|;
* scalar multiplication scales the dual part only;
* ``dq_normalize`` rescales the real part only;
* ``dq_transform_normal`` applies the full transform, translation included.

Every function is elementwise over leading batch dimensions.
"""

from __future__ import annotations

import torch


def _cat(*parts):
    return torch.cat(parts, dim=-1)


def quat_mul(q1, q2):
    """Hamilton product of (..., 4) [w, x, y, z] quaternions."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q):
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_normalize_cayley(q):
    """boost::math normalize quirk: q / |q|^2."""
    return q / torch.sum(q * q, dim=-1, keepdim=True)


def dq_make(real, dual):
    return _cat(real, dual)


def dq_real(dq):
    return dq[..., 0:4]


def dq_dual(dq):
    return dq[..., 4:8]


def dq_identity(dtype=torch.float32, device=None):
    """Unit real, zero dual."""
    return torch.tensor([1.0, 0, 0, 0, 0, 0, 0, 0], dtype=dtype, device=device)


def dq_from_quat_translation(rot, t):
    """real = rot / |rot|^2 (Cayley quirk); dual = 0.5 * (0, t) * real."""
    real = quat_normalize_cayley(rot)
    tq = _cat(torch.zeros_like(t[..., :1]), t)
    dual = 0.5 * quat_mul(tq, real)
    return dq_make(real, dual)


def dq_from_euler(yaw, pitch, roll, x, y, z):
    """From Euler angles and a translation (dual_quaternion.hpp:48-67)."""
    yaw, pitch, roll = (torch.as_tensor(a, dtype=torch.float32)
                        for a in (yaw, pitch, roll))
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    qw = cy * cr * cp + sy * sr * sp
    qx = cy * sr * cp - sy * cr * sp
    qy = cy * cr * sp + sy * sr * cp
    qz = sy * cr * cp - cy * sr * sp
    rot = torch.stack([qw, qx, qy, qz], dim=-1)
    t = torch.stack(
        [torch.broadcast_to(torch.as_tensor(c, dtype=rot.dtype), qw.shape)
         for c in (x, y, z)], dim=-1)
    return dq_from_quat_translation(rot, t)


def dq_from_rodrigues(rodrigues, t):
    """From an Euler-Rodrigues vector (tan(theta/2) * axis) and a
    translation (dual_quaternion.hpp:70-86)."""
    rnorm = torch.linalg.vector_norm(rodrigues, dim=-1, keepdim=True)
    theta = 2.0 * torch.arctan(rnorm)
    axis = rodrigues / torch.where(rnorm == 0, 1.0, rnorm)
    s = torch.sin(0.5 * theta)
    rot = _cat(torch.cos(0.5 * theta), s * axis)
    return dq_from_quat_translation(quat_normalize_cayley(rot), t)


def dq_from_translation(t):
    """Pure translation: real identity, dual (0, t/2)."""
    t = torch.as_tensor(t)
    one = torch.ones_like(t[..., :1])
    zero = torch.zeros_like(t[..., :1])
    return _cat(one, zero, zero, zero, zero, 0.5 * t)


def dq_add(a, b):
    return a + b


def dq_sub(a, b):
    return a - b


def dq_scale(dq, s):
    """Scalar multiply: scales the DUAL part only."""
    s = torch.as_tensor(s, dtype=dq.dtype, device=dq.device)[..., None]
    return dq_make(dq_real(dq), dq_dual(dq) * s)


def dq_mul(a, b):
    """(r1 r2, r1 d2 + d1 r2)."""
    r1, d1 = dq_real(a), dq_dual(a)
    r2, d2 = dq_real(b), dq_dual(b)
    return dq_make(quat_mul(r1, r2), quat_mul(r1, d2) + quat_mul(d1, r2))


def dq_conj(dq):
    return dq_make(quat_conj(dq_real(dq)), quat_conj(dq_dual(dq)))


def dq_normalize(dq):
    """Divide the REAL part by its Euclidean norm; the dual is untouched."""
    real = dq_real(dq)
    mag = torch.sqrt(torch.sum(real * real, dim=-1, keepdim=True))
    return dq_make(real / mag, dq_dual(dq))


def dq_normalize_joint(dq):
    """Proper unit-dual-quaternion normalization: the whole dq over |real|."""
    real = dq_real(dq)
    mag = torch.sqrt(torch.clamp_min(
        torch.sum(real * real, dim=-1, keepdim=True), 1e-30))
    return dq / mag


def dq_rotate_vector(dq, v):
    """Rotate v (..., 3) by the real quaternion only."""
    r = dq_real(dq)
    vq = _cat(torch.zeros_like(v[..., :1]), v)
    return quat_mul(quat_mul(r, vq), quat_conj(r))[..., 1:4]


def dq_translation(dq):
    """vec(2 * dual * conj(real))."""
    return quat_mul(2.0 * dq_dual(dq), quat_conj(dq_real(dq)))[..., 1:4]


def _cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def dq_transform_point(dq, v):
    """v + 2 rv x (rv x v + rw v) + 2 (rw dv - dw rv + rv x dv)."""
    rw = dq[..., 0:1]
    rv = dq[..., 1:4]
    dw = dq[..., 4:5]
    dv = dq[..., 5:8]
    return (v + 2.0 * _cross(rv, _cross(rv, v) + rw * v)
            + 2.0 * (rw * dv - dw * rv + _cross(rv, dv)))


def dq_transform_normal(dq, n):
    """Reference quirk: normals get the FULL transform, translation too."""
    return dq_transform_point(dq, n)


def dq_roll(dq):
    w, x, y, z = dq[..., 0], dq[..., 1], dq[..., 2], dq[..., 3]
    return torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))


def dq_pitch(dq):
    w, x, y, z = dq[..., 0], dq[..., 1], dq[..., 2], dq[..., 3]
    sinp = 2.0 * (w * y - z * x)
    return torch.where(torch.abs(sinp) >= 1.0,
                       torch.sign(sinp) * (torch.pi / 2),
                       torch.arcsin(torch.clamp(sinp, -1.0, 1.0)))


def dq_yaw(dq):
    w, x, y, z = dq[..., 0], dq[..., 1], dq[..., 2], dq[..., 3]
    return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def dq_euler_angles(dq):
    """(roll, pitch, yaw), getEulerAngles order."""
    return torch.stack([dq_roll(dq), dq_pitch(dq), dq_yaw(dq)], dim=-1)


def dq_rodrigues(dq):
    """tan(theta/2) * axis with theta = 2 acos(rw)."""
    w = dq[..., 0:1]
    q = dq[..., 1:4]
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    theta = 2.0 * torch.arccos(torch.clamp(w, -1.0, 1.0))
    return torch.tan(0.5 * theta) * q / torch.where(norm == 0, 1.0, norm)
