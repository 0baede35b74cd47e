"""k-nearest-neighbour search and the windowed 1-NN correspondence.

Port of dynfu_tpu/ops/knn.py (the reference's nanoflann lookups):

* `knn_brute` — the exact k-NN the solver's graphs use, with the source's
  |q|^2 - 2 q.p + |p|^2 distance form and iterated (distance, index)
  successor selection, so the graphs match index for index;
* `nn1_gather_xwindow` — the correspondence: points sorted along x, one
  window per 2048-query tile placed at the tile's mean x (the placement of
  the source's kernel path, `_window_pass_pallas`), the order-free
  exactness certificate, an `escalate` tier that re-sweeps certificate
  failures in a 4x wider window, and an exact brute-force `rescue` tier.
  The sweep itself is the CUDA kernel in ops/corr_cuda.py.
"""

from __future__ import annotations

import torch

from dynfu_tpu_torch.ops import corr_cuda

BIG = 3e38  # coordinate of masked / padding rows


def pairwise_sqdist(queries, points):
    """(Q, P) = max(|q|^2 - 2 q.p + |p|^2, 0)."""
    qn = torch.sum(queries * queries, dim=-1, keepdim=True)
    pn = torch.sum(points * points, dim=-1)
    d = qn - 2.0 * (queries @ points.T) + pn[None, :]
    return torch.clamp_min(d, 0.0)


def _topk_argmin(d, k: int):
    """k smallest per row, ascending, ties to the lower index: each round
    takes the successor of the previous pick in (value, index) order."""
    iota = torch.arange(d.shape[-1], device=d.device)
    v_prev = torch.full(d.shape[:-1], -torch.inf, device=d.device)
    i_prev = torch.full(d.shape[:-1], -1, dtype=torch.int64, device=d.device)
    vals, idxs = [], []
    for _ in range(k):
        after = (d > v_prev[..., None]) | (
            (d == v_prev[..., None]) & (iota > i_prev[..., None]))
        dm = torch.where(after, d, torch.inf)
        v_prev, i_prev = torch.min(dm, dim=-1)
        vals.append(v_prev)
        idxs.append(i_prev)
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def knn_brute(queries, points, k: int, point_mask=None):
    """Exact k-NN: (indices (Q, k) int64, sqdists (Q, k)), ascending;
    masked points are +inf."""
    d = pairwise_sqdist(queries, points)
    if point_mask is not None:
        d = torch.where(point_mask[None, :], d, torch.inf)
    sqd, idx = _topk_argmin(d, k)
    return idx, sqd


def compact(mask: torch.Tensor, size: int):
    """The first `size` True positions of `mask`, ascending, padded with
    len(mask): (idx (size,) int64, ok (size,) bool). Sync-free (a stable
    sort), unlike torch.nonzero."""
    n = mask.shape[0]
    order = torch.argsort((~mask).to(torch.uint8), stable=True)[:size]
    ok = mask[order]
    idx = torch.where(ok, order, n)
    if idx.shape[0] < size:
        pad = size - idx.shape[0]
        idx = torch.cat([idx, idx.new_full((pad,), n)])
        ok = torch.cat([ok, ok.new_zeros(pad)])
    return idx, ok


def _window_bounds(x: torch.Tensor, block: int):
    """Order-free certificate bounds at block granularity for BIG-masked x
    (npb * block,): pre[j] = max valid x over blocks < j (pre[0] = -inf),
    suf[j] = min valid x over blocks >= j (suf[npb] = +inf)."""
    xb = x.reshape(-1, block)
    valid = xb < corr_cuda.BIG_X
    bmax = torch.amax(torch.where(valid, xb, -torch.inf), dim=1)
    bmin = torch.amin(torch.where(valid, xb, torch.inf), dim=1)
    inf = x.new_full((1,), torch.inf)
    pre = torch.cat([-inf, torch.cummax(bmax, 0).values])
    suf = torch.cat([torch.flip(torch.cummin(torch.flip(bmin, [0]), 0).values,
                                [0]), inf])
    return pre, suf


def window_placement(qs0, pts, W: int, tq: int = 2048, B: int = 128):
    """Pad queries and points and place one window per query tile, as the
    source's `_window_pass_pallas` does (knn.py:641-688): 128-point blocks,
    the window centred on the block whose valid-mean x is nearest the tile's
    valid-mean x, aligned down to a block. Returns (qsP, ptsP, lo_el, pre_v,
    suf_v, W)."""
    Q, P = qs0.shape[0], pts.shape[0]
    dev = qs0.device
    Qp = -(-max(Q, tq) // tq) * tq
    Pp = -(-max(P + 1, W) // B) * B
    W = min(W, Pp)
    qsP = torch.cat([qs0, qs0.new_full((Qp - Q, 3), BIG)])
    ptsP = torch.cat([pts, pts.new_full((Pp - P, 3), BIG)])
    npb = Pp // B
    xb = ptsP[:, 0].reshape(npb, B)
    vp = xb < corr_cuda.BIG_X
    nv = torch.clamp_min(vp.sum(1).to(torch.float32), 1.0)
    bmean = torch.where(vp, xb, 0.0).sum(1) / nv
    bmean = torch.where(vp.any(1), bmean, BIG)
    pre, suf = _window_bounds(ptsP[:, 0], B)

    qx = qsP[:, 0].reshape(-1, tq)
    vq = qx < corr_cuda.BIG_X
    nq = torch.clamp_min(vq.sum(1).to(torch.float32), 1.0)
    qmid = torch.where(vq, qx, 0.0).sum(1) / nq
    c = torch.argmin(torch.abs(qmid[:, None] - bmean[None, :]), dim=1)
    lo_el = torch.clamp(c * B - W // 2, 0, Pp - W)
    lo_el = (lo_el // B) * B
    lo_b = lo_el // B
    return (qsP, ptsP, lo_el.to(torch.int32), pre[lo_b].contiguous(),
            suf[lo_b + W // B].contiguous(), W)


def _window_pass(qs0, ps, W: int, vals, tq: int = 2048):
    """One windowed sweep for BIG-masked centred queries qs0 over the
    sorted points: (vals (Q, F) the winners' rows of `vals`, exact (Q,))."""
    Q, P = qs0.shape[0], ps.shape[0]
    qsP, ptsP, lo_el, pre_v, suf_v, W = window_placement(qs0, ps, W, tq)
    valsP = torch.cat([vals, vals.new_zeros((ptsP.shape[0] - P,
                                             vals.shape[1]))])
    out, ex = corr_cuda.nn1_window_sweep(qsP, ptsP, lo_el, pre_v, suf_v,
                                         tq=tq, window=W, payload=valsP)
    return out[:Q], ex[:Q]


def _scatter_pass(vals, exact, qs0, R: int, pass_fn):
    """Compact up to R certificate-failed queries, run `pass_fn` on them
    (BIG-padded), and scatter back the results that came back exact."""
    Q = qs0.shape[0]
    failed = (qs0[:, 0] < corr_cuda.BIG_X) & ~exact
    fidx, fok = compact(failed, R)
    fq = torch.where(fok[:, None], qs0[torch.clamp_max(fidx, Q - 1)], BIG)
    rvals, rex = pass_fn(fq)
    rex = rex & fok
    sidx = torch.where(rex, fidx, Q)  # row Q is a discarded spill row
    vals = torch.cat([vals, vals.new_zeros((1, vals.shape[1]))])
    vals[sidx] = rvals
    exact = torch.cat([exact, exact.new_zeros(1)])
    exact[sidx] = True
    return vals[:Q], exact[:Q]


def _nn1_brute_subset(qs, ps, vs, chunk: int = 32768):
    """Exact 1-NN + fetch of a small query set against ALL points, streamed
    over point chunks; ties to the lowest point index. (vals, found)."""
    best_d = torch.full((qs.shape[0],), torch.inf, device=qs.device)
    best_j = torch.zeros((qs.shape[0],), dtype=torch.int64, device=qs.device)
    for c0 in range(0, ps.shape[0], chunk):
        pb = ps[c0:c0 + chunk]
        valid = pb[:, 0] < corr_cuda.BIG_X
        pz = torch.where(valid[:, None], pb, 0.0)
        dx = qs[:, 0:1] - pz[None, :, 0]
        dy = qs[:, 1:2] - pz[None, :, 1]
        dz = qs[:, 2:3] - pz[None, :, 2]
        d = torch.where(valid[None, :], dx * dx + dy * dy + dz * dz,
                        torch.inf)
        dbest, j = torch.min(d, dim=1)
        take = dbest < best_d  # strict: earlier chunks win ties
        best_d = torch.where(take, dbest, best_d)
        best_j = torch.where(take, c0 + j, best_j)
    return vs[best_j], best_d < corr_cuda.BIG_X


def nn1_gather_xwindow(queries, points, values=None, point_mask=None,
                       query_mask=None, block: int = 4096,
                       window_blocks: int = 3, rescue: int = 0,
                       escalate: int = 0, escalate_factor: int = 4,
                       values_fn=None):
    """Windowed 1-NN + fetch for near-coincident surfaces: (vals, exact).

    vals is the nearest point's row of `values` (or of
    values_fn(sorted points, valid), computed after the sort), or the point
    itself when both are None; exact is False where no tier could certify
    the answer (the caller masks those and counts them)."""
    Q, P = queries.shape[0], points.shape[0]
    dev = queries.device
    valid_p = (point_mask if point_mask is not None
               else torch.ones((P,), dtype=torch.bool, device=dev))
    # cancellation control: centre on the valid cloud
    denom = torch.clamp_min(valid_p.sum().to(torch.float32), 1.0)
    center = torch.where(valid_p[:, None], points, 0.0).sum(0) / denom
    queries = queries - center
    points = points - center
    pts = torch.where(valid_p[:, None], points, BIG)
    qs0 = queries
    if query_mask is not None:
        qs0 = torch.where(query_mask[:, None], qs0, BIG)

    order = torch.sort(pts[:, 0], stable=True).indices
    ps = pts[order].contiguous()
    if values_fn is not None:
        if values is not None:
            raise ValueError("pass values or values_fn, not both")
        valid_s = ps[:, 0] < corr_cuda.BIG_X
        vs = values_fn(ps + center[None, :], valid_s)
        vs = torch.where(valid_s[:, None], vs, 0.0).contiguous()
    elif values is not None:
        vs = values[order].contiguous()
    else:
        vs = ps  # fetch the (centred) points themselves

    def one_pass(q, wb):
        return _window_pass(q, ps, wb * block, vs)

    vals, exact = one_pass(qs0, window_blocks)
    if escalate:
        vals, exact = _scatter_pass(
            vals, exact, qs0, min(escalate, Q),
            lambda fq: one_pass(fq, window_blocks * escalate_factor))
    if rescue:
        vals, exact = _scatter_pass(
            vals, exact, qs0, min(rescue, Q),
            lambda fq: _nn1_brute_subset(fq, ps, vs))
    if values is None and values_fn is None:
        vals = vals + center[None, :]  # un-centre fetched coordinates
    return vals, exact
