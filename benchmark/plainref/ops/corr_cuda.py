"""Windowed 1-NN correspondence sweep, the plain version.

The port's wrapper launches csrc/corr.cu on the card; here every call takes
the plain version. The window starts and bounds come from
ops/knn.window_placement.
"""

from __future__ import annotations

import torch

BIG_X = 1e37  # x at or above this marks a BIG-masked (invalid) row


def nn1_window_sweep(qs: torch.Tensor, ps: torch.Tensor, lo_el: torch.Tensor,
                     pre: torch.Tensor, suf: torch.Tensor, tq: int,
                     window: int, payload: torch.Tensor):
    """qs (Qp, 3) centred queries, BIG-masked, Qp a multiple of tq;
    ps (Pp, 3) centred x-sorted points, BIG-masked, Pp >= window; lo_el,
    pre, suf (Qp // tq,) per query tile; payload (Pp, F) -> (vals (Qp, F),
    exact (Qp,)): the winner's payload row and the certificate
    best_d <= gap^2."""
    Qp = qs.shape[0]
    vals = torch.zeros((Qp, payload.shape[1]), dtype=torch.float32,
                       device=qs.device)
    exact = torch.zeros((Qp,), dtype=torch.bool, device=qs.device)
    for i in range(Qp // tq):
        q = qs[i * tq:(i + 1) * tq]
        lo = int(lo_el[i])
        # BIG-masked points never win: only the valid ones are scanned, in
        # index order, so the first minimum is still the lowest index
        cand = lo + torch.nonzero(ps[lo:lo + window, 0] < BIG_X)[:, 0]
        pb = ps[cand]
        dx = pb[None, :, 0] - q[:, 0:1]
        dy = pb[None, :, 1] - q[:, 1:2]
        dz = pb[None, :, 2] - q[:, 2:3]
        d = dx * dx + dy * dy + dz * dz
        if cand.numel():
            best_d, j = torch.min(d, dim=1)  # first (lowest-index) minimum
            best_j = cand[j]
        else:
            best_d = torch.full((tq,), torch.inf, device=qs.device)
            best_j = torch.zeros((tq,), dtype=torch.int64, device=qs.device)
        # the kernel's rule: no candidate taken (all inf) leaves index 0
        best_j = torch.where(best_d < torch.inf, best_j, 0)
        in_win = (best_j >= lo) & (best_j < lo + window)
        vals[i * tq:(i + 1) * tq] = torch.where(in_win[:, None],
                                                payload[best_j], 0.0)
        gap = torch.clamp_min(torch.minimum(q[:, 0] - pre[i],
                                            suf[i] - q[:, 0]), 0.0)
        exact[i * tq:(i + 1) * tq] = (best_d <= gap * gap) & (q[:, 0] < BIG_X)
    return vals, exact
