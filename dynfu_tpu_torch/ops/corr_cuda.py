"""Windowed 1-NN correspondence sweep: CUDA wrapper and plain version.

Replaces nn1_window_sweep_tpu (dynfu_tpu/ops/corr_pallas.py:135). Kernel
source: csrc/corr.cu. The window starts and bounds come from
ops/knn.window_placement. The kernel scans each warp's window in sub-tiles
of SUB points, nearest first, and skips those whose box cannot hold a
winner; `pruned_sweep` is a plain model of that rule, for the tests and for
chip_smoke.py's sub-tile counts, and is on no main path.
"""

from __future__ import annotations

import ctypes

import torch

from dynfu_tpu_torch import kernels

BIG_X = 1e37  # x at or above this marks a BIG-masked (invalid) row
SUB = 128  # points per sub-tile (NN1_SUB in csrc/corr.cu)


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


def point_boxes(ps):
    """(lo (nb, 3), hi (nb, 3)): the box of the valid points of each
    SUB-point block of ps; +inf / -inf where a block has none."""
    Pp = ps.shape[0]
    nb = -(-Pp // SUB)
    pb = torch.cat([ps, ps.new_full((nb * SUB - Pp, 3), torch.inf)])
    pb = pb.reshape(nb, SUB, 3)
    valid = (pb[..., 0] < BIG_X)[..., None]
    return (torch.where(valid, pb, torch.inf).amin(1),
            torch.where(valid, pb, -torch.inf).amax(1))


def _box_gap2(blo, bhi, qlo, qhi):
    """Lower bound of the squared distance between boxes, per axis as the
    sweep computes (p - q)^2 (csrc/corr.cu, box_gap2)."""
    g = torch.where(blo > qhi, blo - qhi,
                    torch.where(bhi < qlo, qlo - bhi, 0.0))
    return g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1] + g[..., 2] * g[..., 2]


def pruned_sweep(qs, ps, lo_el, pre, suf, tq: int, window: int, payload,
                 split: int = 1):
    """The kernel's rule, group by group (32 consecutive queries): (vals,
    exact, scanned (Qp // 32, split) the sub-tiles each of the group's
    `split` warps scanned, has (Qp // 32,) whether the group holds a live
    query). A group visits the SUB-point blocks its tile's window overlaps,
    from the one whose box is nearest its live queries' box (the lowest on
    ties), then alternately right and left; its warp v % split takes visit
    v, skipping blocks without a valid point and those whose bound exceeds
    the largest best distance of the warp's live queries; the winner is the
    least (distance, index) over the group's warps. Equal to
    nn1_window_sweep_plain (the tests hold it so)."""
    Qp, Pp = qs.shape[0], ps.shape[0]
    dev = qs.device
    nw = Qp // 32
    q = qs.reshape(nw, 32, 3)
    live = (q[..., 0] < BIG_X) & torch.isfinite(q).all(-1)
    qlo = torch.where(live[..., None], q, torch.inf).amin(1)
    qhi = torch.where(live[..., None], q, -torch.inf).amax(1)
    has = live.any(1)
    lo = lo_el.to(torch.int64)[torch.arange(nw, device=dev) * 32 // tq]
    b0 = lo // SUB
    nsub = (lo + window - 1) // SUB - b0 + 1
    S = int(nsub.max())
    blo, bhi = point_boxes(ps)
    nb = blo.shape[0]
    steps = torch.arange(S, device=dev)
    bi = torch.clamp(b0[:, None] + steps, max=nb - 1)
    gap = _box_gap2(blo[bi], bhi[bi], qlo[:, None], qhi[:, None])
    s0 = torch.argmin(torch.where(steps < nsub[:, None], gap, torch.inf), 1)
    # visit order s0, s0 + 1, s0 - 1, s0 + 2, ... within [0, nsub)
    off = torch.stack([torch.arange(S + 1), -torch.arange(S + 1)], 1)
    off = off.reshape(-1)[1:].to(dev)
    cand = s0[:, None] + off
    ok = (cand >= 0) & (cand < nsub[:, None])
    order = torch.gather(cand, 1, torch.sort((~ok).to(torch.uint8), dim=1,
                                             stable=True).indices)[:, :S]

    best_d = torch.full((split, nw, 32), torch.inf, device=dev)
    best_j = torch.zeros((split, nw, 32), dtype=torch.int64, device=dev)
    scanned = torch.zeros((nw, split), dtype=torch.int64, device=dev)
    t = torch.arange(SUB, device=dev)
    for v in range(S):
        part = v % split
        bd_all, bj_all = best_d[part], best_j[part]
        b = torch.clamp(b0 + order[:, v], max=nb - 1)
        mb = torch.where(live, bd_all, -torch.inf).amax(1)
        g = _box_gap2(blo[b], bhi[b], qlo, qhi)
        scan = (has & (v < nsub) & (blo[b, 0] <= bhi[b, 0]) & ~(g > mb))
        w = torch.nonzero(scan)[:, 0]
        if not w.numel():
            continue
        scanned[w, part] += 1
        j = b[w, None] * SUB + t  # (n, SUB)
        pj = ps[torch.clamp(j, max=Pp - 1)]
        valid = ((j >= lo[w, None]) & (j < lo[w, None] + window)
                 & (pj[..., 0] < BIG_X))
        qw = q[w]
        dx = pj[:, None, :, 0] - qw[:, :, None, 0]
        dy = pj[:, None, :, 1] - qw[:, :, None, 1]
        dz = pj[:, None, :, 2] - qw[:, :, None, 2]
        d = torch.where(valid[:, None, :], dx * dx + dy * dy + dz * dz,
                        torch.inf)
        dmin, arg = torch.min(d, dim=2)  # the first (lowest-index) minimum
        jmin = torch.gather(j, 1, arg)
        bd, bj = bd_all[w], bj_all[w]
        take = (dmin < bd) | ((dmin == bd) & (jmin < bj))
        best_d[part, w] = torch.where(take, dmin, bd)
        best_j[part, w] = torch.where(take, jmin, bj)
    bd, bj = best_d[0], best_j[0]
    for part in range(1, split):  # the least (distance, index) pair
        take = (best_d[part] < bd) | ((best_d[part] == bd)
                                      & (best_j[part] < bj))
        bd = torch.where(take, best_d[part], bd)
        bj = torch.where(take, best_j[part], bj)
    best_d = torch.where(live, bd, torch.inf).reshape(Qp)
    best_j = torch.where(live, bj, 0).reshape(Qp)
    lo_q = lo.repeat_interleave(32)
    in_win = (best_j >= lo_q) & (best_j < lo_q + window)
    vals = torch.where(in_win[:, None], payload[best_j], 0.0)
    tile = torch.arange(Qp, device=dev) // tq
    gap = torch.clamp_min(torch.minimum(qs[:, 0] - pre[tile],
                                        suf[tile] - qs[:, 0]), 0.0)
    exact = (best_d <= gap * gap) & (qs[:, 0] < BIG_X)
    return vals, exact, scanned, has


def launch_info(Qp: int) -> dict:
    """The kernel's launch for Qp queries, as its own launch code picks it:
    threads per block, points per sub-tile, warps per query group, blocks
    and resident blocks per SM; on the card only."""
    out = (ctypes.c_int * 5)()
    kernels.check(kernels.load().dynfu_nn1_launch(Qp, out), "nn1_launch")
    return dict(zip(("threads", "sub", "split", "blocks", "blocks_per_sm"),
                    out))


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
    boxes = torch.empty((-(-Pp // SUB), 6), dtype=torch.float32, device=dev)
    lib = kernels.load()
    kernels.check(lib.dynfu_nn1_window(
        qs.data_ptr(), ps.data_ptr(), boxes.data_ptr(), lo_el.data_ptr(),
        pre.data_ptr(), suf.data_ptr(), payload.data_ptr(), Qp, Pp, tq,
        window, F, vals.data_ptr(), exact.data_ptr(), kernels.stream(qs)),
        "nn1_window_sweep")
    nn1_window_sweep.launches += 1
    return vals, exact


nn1_window_sweep.launches = 0
