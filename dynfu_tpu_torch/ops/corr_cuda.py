"""Windowed 1-NN correspondence sweep: CUDA wrapper and plain version.

Replaces nn1_window_sweep_tpu (dynfu_tpu/ops/corr_pallas.py:135). Kernel
source: csrc/corr.cu. The window starts and bounds come from
ops/knn.window_placement.
"""

from __future__ import annotations

import torch

from dynfu_tpu_torch import kernels

BIG_X = 1e37  # x at or above this marks a BIG-masked (invalid) row


def nn1_window_sweep_plain(qs, ps, lo_el, pre, suf, tq: int, window: int,
                           payload):
    kernels.count_plain(nn1_window_sweep_plain, qs)
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


nn1_window_sweep_plain.cuda_calls = 0


def nn1_window_sweep(qs: torch.Tensor, ps: torch.Tensor, lo_el: torch.Tensor,
                     pre: torch.Tensor, suf: torch.Tensor, tq: int,
                     window: int, payload: torch.Tensor):
    """qs (Qp, 3) centred queries, BIG-masked, Qp a multiple of tq;
    ps (Pp, 3) centred x-sorted points, BIG-masked, Pp >= window; lo_el,
    pre, suf (Qp // tq,) per query tile; payload (Pp, F) -> (vals (Qp, F),
    exact (Qp,)): the winner's payload row and the certificate
    best_d <= gap^2."""
    if not kernels.on_cuda(qs, "nn1_window_sweep"):
        return nn1_window_sweep_plain(qs, ps, lo_el, pre, suf, tq, window,
                                      payload)
    Qp, Pp = qs.shape[0], ps.shape[0]
    dev = qs.device
    nqb = Qp // tq
    F = payload.shape[1]
    kernels.require(qs, "qs", torch.float32, (Qp, 3), dev)
    kernels.require(ps, "ps", torch.float32, (Pp, 3), dev)
    kernels.require(lo_el, "lo_el", torch.int32, (nqb,), dev)
    kernels.require(pre, "pre", torch.float32, (nqb,), dev)
    kernels.require(suf, "suf", torch.float32, (nqb,), dev)
    kernels.require(payload, "payload", torch.float32, (Pp, F), dev)
    if F < 1 or Qp % tq or tq % 256 or not 0 < window <= Pp:
        raise ValueError(f"nn1_window_sweep: bad tiling Qp={Qp} tq={tq} "
                         f"window={window} Pp={Pp}")
    vals = torch.empty((Qp, F), dtype=torch.float32, device=dev)
    exact = torch.empty((Qp,), dtype=torch.bool, device=dev)
    lib = kernels.load()
    kernels.check(lib.dynfu_nn1_window(
        qs.data_ptr(), ps.data_ptr(), lo_el.data_ptr(), pre.data_ptr(),
        suf.data_ptr(), payload.data_ptr(), Qp, Pp,
        tq, window, F, vals.data_ptr(), exact.data_ptr(),
        kernels.stream(qs)), "nn1_window_sweep")
    nn1_window_sweep.launches += 1
    return vals, exact


nn1_window_sweep.launches = 0
