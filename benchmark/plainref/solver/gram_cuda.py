"""Data-term Gram assembly, the plain versions.

`data_normal` is the translation solve's A and b, `monomial_grams` the
SE(3) solve's ten monomial Grams and two rhs. The port's wrappers launch
csrc/gram.cu and csrc/mono_gram.cu on the card, which sum every entry in
one fixed order in float64 and round once to float32; here every call
takes the plain version, which sums in float64 too, in index_add_'s order.
Kernel and plain version agree to float32 roundoff.

With `partial` both return the float64 sums before the rounding: the
partial Grams of a row range.
"""

from __future__ import annotations

import torch


def data_normal(data_idx: torch.Tensor, data_w: torch.Tensor,
                s2: torch.Tensor, delta: torch.Tensor, D: int,
                partial: bool = False):
    """data_idx (N, K) int32, data_w (N, K) f32 (invalid slots 0), s2 (N,)
    f32, delta (N, 3) f32 -> (A (D, D), b (D, 3)) f32, or with `partial`
    the float64 sums before their rounding."""
    f64 = torch.float64
    idx = data_idx.to(torch.int64)
    ok = (idx >= 0) & (idx < D)
    w = data_w.to(f64)
    ws = torch.where(ok, s2.to(f64)[:, None] * w, 0.0)  # (N, K)
    idx = torch.where(ok, idx, 0)
    pair_ok = ok[:, :, None] & ok[:, None, :]
    flat = (idx[:, :, None] * D + idx[:, None, :]).reshape(-1)
    terms = torch.where(pair_ok, ws[:, :, None] * w[:, None, :], 0.0)
    A = torch.zeros(D * D, dtype=f64, device=data_w.device)
    A.index_add_(0, flat, terms.reshape(-1))
    b = torch.zeros((D, 3), dtype=f64, device=data_w.device)
    b.index_add_(0, idx.reshape(-1),
                 (ws[:, :, None] * delta.to(f64)[:, None, :]).reshape(-1, 3))
    A = A.reshape(D, D)
    return (A, b) if partial else (A.to(torch.float32), b.to(torch.float32))


def monomials(y):
    """(10, N): [1, yx, yy, yz, yx^2, yx yy, yx yz, yy^2, yy yz, yz^2]."""
    yx, yy, yz = y.unbind(-1)
    return torch.stack([torch.ones_like(yx), yx, yy, yz, yx * yx, yx * yy,
                        yx * yz, yy * yy, yy * yz, yz * yz])  # (10, N)


def monomial_grams(data_idx: torch.Tensor, data_w: torch.Tensor,
                   s2: torch.Tensor, y: torch.Tensor, delta: torch.Tensor,
                   D: int, partial: bool = False):
    """data_idx (N, K) int32 (indices outside [0, D) are padding), data_w
    (N, K) f32, s2 (N,) f32 >= 0, y (N, 3) f32, delta (N, 3) f32 -> (B (10,
    D, D), Bu (D, 3), Bw (D, 3)) f32: B[m] = (sqrt(s2) W)^T diag(mono_m(y))
    (sqrt(s2) W) over `monomials`, Bu = W^T (s2 delta), Bw = W^T (s2 (y x
    delta)); with `partial` the float64 sums before their rounding. The
    terms are float64 from the float32 weights rs * w."""
    dev = data_w.device
    f64 = torch.float64
    idx = data_idx.to(torch.int64)
    ok = (idx >= 0) & (idx < D)
    rs = torch.sqrt(torch.clamp_min(s2, 0.0))
    ws = torch.where(ok, rs[:, None] * data_w, 0.0).to(f64)  # (N, K)
    idx = torch.where(ok, idx, 0)
    pair = ws[:, :, None] * ws[:, None, :]  # (N, K, K), zero off the rows
    terms = pair[None] * monomials(y.to(f64))[:, :, None, None]
    flat = (idx[:, :, None] * D + idx[:, None, :]).reshape(-1)
    flat = (torch.arange(10, device=dev)[:, None] * (D * D)
            + flat[None, :]).reshape(-1)
    B = torch.zeros(10 * D * D, dtype=f64, device=dev)
    B.index_add_(0, flat, terms.reshape(-1))
    d = delta.to(f64)
    dx, dy, dz = d.unbind(-1)
    yx, yy, yz = y.to(f64).unbind(-1)
    cross = torch.stack([yy * dz - yz * dy, yz * dx - yx * dz,
                         yx * dy - yy * dx], -1)
    rhs = []
    for v in (d, cross):
        acc = torch.zeros((D, 3), dtype=f64, device=dev)
        acc.index_add_(0, idx.reshape(-1),
                       (ws[:, :, None] * (rs.to(f64)[:, None] * v)[:, None, :]
                        ).reshape(-1, 3))
        rhs.append(acc)
    out = (B.reshape(10, D, D), rhs[0], rhs[1])
    return out if partial else tuple(t.to(torch.float32) for t in out)
