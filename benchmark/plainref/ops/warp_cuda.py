"""Fused warp (k-NN + DQB or DLB blend + transform), the plain version.

The port's wrapper launches csrc/warp.cu on the card; here every call takes
the plain version, which computes the same numbers in the kernel's
operation order, column by column.

blend="dqb" is the reference's sequential product (dual-only scaling, real
part normalised, normals fully transformed); blend="dlb" is Kavan's linear
blend (sign-aligned to the nearest node's real part, the identity without
support, joint normalisation, normals rotated only).
"""

from __future__ import annotations

import torch

from plainref.ops.knn_cuda import select_k


def _qmul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw)


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _transform(real, dual, v):
    """v + 2 rv x (rv x v + rw v) + 2 (rw dv - dw rv + rv x dv)."""
    rw, rv = real[0], real[1:]
    dw, dv = dual[0], dual[1:]
    c1 = _cross(rv, v)
    c2 = _cross(rv, [c1[i] + rw * v[i] for i in range(3)])
    c3 = _cross(rv, dv)
    return torch.stack([v[i] + 2.0 * c2[i] + 2.0 * (rw * dv[i] - dw * rv[i]
                                                     + c3[i])
                        for i in range(3)], dim=-1)


def _rotate(real, v):
    """vec((r * (0, v)) * conj(r))."""
    zero = torch.zeros_like(v[0])
    conj = (real[0], -real[1], -real[2], -real[3])
    o = _qmul(_qmul(real, (zero,) + tuple(v)), conj)
    return torch.stack(o[1:], dim=-1)


BLENDS = {"dqb": 0, "dlb": 1}


def _blend_code(blend: str) -> int:
    if blend not in BLENDS:
        raise ValueError(f"unknown blend {blend!r}")
    return BLENDS[blend]


def warp_fused_plain(queries, normals, node_pos, node_dqs, node_w, node_mask,
                     k: int = 8, blend: str = "dqb"):
    dlb = _blend_code(blend) == 1
    idx, sqd = select_k(queries, node_pos, node_mask, k)
    Q = queries.shape[0]
    one = torch.ones(Q, dtype=torch.float32, device=queries.device)
    zero = torch.zeros_like(one)
    ar = (zero if dlb else one, zero, zero, zero)
    ad = (zero, zero, zero, zero)
    wsum = zero
    ratio = torch.full_like(one, torch.inf)
    ref = None
    for r in range(k):
        j, m = idx[:, r], sqd[:, r]
        valid = node_mask[j]
        dg_w = torch.clamp_min(node_w[j], 1e-12)
        wt = torch.exp(-m / (2.0 * dg_w * dg_w))
        ratio = torch.minimum(
            ratio, torch.where(valid, torch.sqrt(m) / dg_w, torch.inf))
        n = node_dqs[j]
        if dlb:
            if ref is None:
                ref = n[:, :4]  # the nearest node, valid or not
            dot = (n[:, 0] * ref[:, 0] + n[:, 1] * ref[:, 1]
                   + n[:, 2] * ref[:, 2] + n[:, 3] * ref[:, 3])
            wn = torch.where(valid, wt, 0.0)
            ws = wn * torch.where(dot < 0.0, -1.0, 1.0)
            ar = tuple(a + ws * n[:, c] for c, a in enumerate(ar))
            ad = tuple(a + ws * n[:, 4 + c] for c, a in enumerate(ad))
            wsum = wsum + wn
            continue
        sr = tuple(torch.where(valid, n[:, c], 1.0 if c == 0 else 0.0)
                   for c in range(4))
        sd = tuple(torch.where(valid, n[:, 4 + c] * wt, 0.0)
                   for c in range(4))
        nr = _qmul(ar, sr)
        d1, d2 = _qmul(ar, sd), _qmul(ad, sr)
        ad = tuple(a + b for a, b in zip(d1, d2))
        ar = nr
    if dlb:
        sup = wsum > 1e-12  # no support: the identity
        ar = tuple(torch.where(sup, a, 1.0 if c == 0 else 0.0)
                   for c, a in enumerate(ar))
        ad = tuple(torch.where(sup, a, 0.0) for a in ad)
        mag = torch.sqrt(torch.clamp_min(ar[0] * ar[0] + ar[1] * ar[1]
                                         + ar[2] * ar[2] + ar[3] * ar[3],
                                         1e-30))
        ad = tuple(a / mag for a in ad)
    else:
        mag = torch.clamp_min(torch.sqrt(ar[0] * ar[0] + ar[1] * ar[1]
                                         + ar[2] * ar[2] + ar[3] * ar[3]),
                              1e-30)
    rn = tuple(a / mag for a in ar)
    warped = _transform(rn, ad, queries.unbind(-1))
    if dlb:
        wnorm = _rotate(rn, normals.unbind(-1))
    else:
        wnorm = _transform(rn, ad, normals.unbind(-1))
    return warped, wnorm, torch.stack(rn + ad, dim=-1), ratio



def warp_fused(queries: torch.Tensor, normals: torch.Tensor,
               node_pos: torch.Tensor, node_dqs: torch.Tensor,
               node_w: torch.Tensor, node_mask: torch.Tensor, k: int = 8,
               blend: str = "dqb"):
    """(warped (Q,3), warped_normals (Q,3), blend_dq (Q,8), ratio (Q,)):
    the warp of every query by the given blend and its unsupported ratio
    min_k sqrt(d_k) / dg_w_k over valid neighbours."""
    return warp_fused_plain(queries, normals, node_pos, node_dqs, node_w,
                            node_mask, k, blend)
