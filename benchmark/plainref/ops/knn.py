"""k-nearest-neighbour search and the windowed 1-NN correspondence.

Port of dynfu_tpu/ops/knn.py (the reference's nanoflann lookups):

* `knn_brute`, `knn_blocked`, `nn1`, `nn1_blocked` — the exact k-NN and
  1-NN with the source's |q|^2 - 2 q.p + |p|^2 distance form and iterated
  (distance, index) successor selection, so the graphs match index for
  index; `knn_gather` is the node k-NN with a feature fetch
  (ops/knn_cuda.knn_gather, the CUDA kernel);
* `nn1_gather_xwindow` — the correspondence: points sorted along x, the
  order-free exactness certificate, an `escalate` tier that re-sweeps
  certificate failures in a wider window, and an exact brute-force
  `rescue` tier. The windows are placed as the source places them: inside
  its kernel's envelope (`tile_placement`) one window per 2048-query tile
  at the tile's mean x (`_window_pass_pallas`), beyond it one window of
  `window_blocks` point blocks per block of queries (its XLA sweep,
  `_window_sweep`). Both sweeps are the CUDA kernel in ops/corr_cuda.py;
* `nn1_gather_sorted`, `nn1_gather` — the source's earlier fused 1-NN
  fetches (both sets sorted into blocks of three-block windows; a
  brute-force argmin of |p|^2 - 2 q.p), off the engine's path. The source
  fetches rows by one-hot matmuls, exact to float32; here by indexing.
"""

from __future__ import annotations

import torch

from plainref.ops import corr_cuda, knn_cuda

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


def nn1(queries, points, point_mask=None):
    """1-NN (findCorrespondingFrame, dyn_fusion.cpp:212-242): (idx (Q,)
    int64, sqdist (Q,)), ties to the lower index."""
    d = pairwise_sqdist(queries, points)
    if point_mask is not None:
        d = torch.where(point_mask[None, :], d, torch.inf)
    sqd, idx = torch.min(d, dim=-1)  # the first (lowest-index) minimum
    return idx, sqd


def knn_blocked(queries, points, k: int, point_mask=None, block: int = 8192):
    """knn_brute over blocks of `block` queries, the last one padded with
    zero rows as the source pads it: the (Q, P) buffer bounded by
    (block, P)."""
    Q = queries.shape[0]
    qp = torch.cat([queries, queries.new_zeros(((-Q) % block, 3))])
    out = [knn_brute(qp[i:i + block], points, k, point_mask)
           for i in range(0, qp.shape[0], block)]
    idx = torch.cat([o[0] for o in out]) if out else queries.new_zeros(
        (0, k), dtype=torch.int64)
    sqd = torch.cat([o[1] for o in out]) if out else queries.new_zeros((0, k))
    return idx[:Q], sqd[:Q]


def nn1_blocked(queries, points, point_mask=None, block: int = 4096):
    """nn1 with the (Q, P) buffer bounded by (block, P)."""
    idx, sqd = knn_blocked(queries, points, 1, point_mask, block)
    return idx[:, 0], sqd[:, 0]


def knn_gather(queries, points, k: int, table, point_mask=None):
    """Fused k-NN + feature fetch: (idx (Q, k) int32, sqd (Q, k), feats
    (Q, k, F)) — ops/knn_cuda.knn_gather (k <= 8, D <= 8192), every node
    valid when no mask is given. Its distances are coordinate differences
    (the source's kernel's form, not its XLA function's), and a masked
    node sits at knn_cuda.FAR, not at +inf."""
    if point_mask is None:
        point_mask = torch.ones((points.shape[0],), dtype=torch.bool,
                                device=points.device)
    return knn_cuda.knn_gather(queries, points, k, table, point_mask)


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


# JAX's envelope for its resident-point sweep (dynfu_tpu/ops/knn.py:553):
# inside it the correspondence places one window per query tile (the
# kernel path, `window_placement`), beyond it one window of `window_blocks`
# blocks per query block (the XLA path, `block_placement`)
TILE_MAX_POINTS = (1 << 18) + 8192
TILE_MAX_COLUMNS = 32


def tile_placement(P: int, F: int) -> bool:
    """The source's dispatch for P points fetching F columns (3 when the
    points themselves are fetched): True for the tile placement."""
    return P <= TILE_MAX_POINTS and F <= TILE_MAX_COLUMNS


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


def _valid_mean(x: torch.Tensor, block: int):
    """Per block of `block` entries of BIG-masked x: (mean of the valid
    ones (0 where none), whether any is valid)."""
    xb = x.reshape(-1, block)
    v = xb < corr_cuda.BIG_X
    n = torch.clamp_min(v.sum(1).to(torch.float32), 1.0)
    return torch.where(v, xb, 0.0).sum(1) / n, v.any(1)


def _nearest_block(qmid, x: torch.Tensor, block: int):
    """The block of x whose valid-mean x is nearest each qmid (the lowest
    on ties; blocks without a valid entry sit at BIG): order-free."""
    bmean, has = _valid_mean(x, block)
    bmean = torch.where(has, bmean, BIG)
    return torch.argmin(torch.abs(qmid[:, None] - bmean[None, :]), dim=1)


def window_placement(qs0, pts, W: int, tq: int = 2048, B: int = 128):
    """Pad queries and points and place one window per query tile, as the
    source's `_window_pass_pallas` does (knn.py:641-688): 128-point blocks,
    the window centred on the block whose valid-mean x is nearest the tile's
    valid-mean x, aligned down to a block. Returns (qsP, ptsP, lo_el, pre_v,
    suf_v, W)."""
    Q, P = qs0.shape[0], pts.shape[0]
    Qp = -(-max(Q, tq) // tq) * tq
    Pp = -(-max(P + 1, W) // B) * B
    W = min(W, Pp)
    qsP = torch.cat([qs0, qs0.new_full((Qp - Q, 3), BIG)])
    ptsP = torch.cat([pts, pts.new_full((Pp - P, 3), BIG)])
    pre, suf = _window_bounds(ptsP[:, 0], B)
    qmid, _ = _valid_mean(qsP[:, 0], tq)
    c = _nearest_block(qmid, ptsP[:, 0], B)
    lo_el = torch.clamp(c * B - W // 2, 0, Pp - W)
    lo_el = (lo_el // B) * B
    lo_b = lo_el // B
    return (qsP, ptsP, lo_el.to(torch.int32), pre[lo_b].contiguous(),
            suf[lo_b + W // B].contiguous(), W)


def _window_pass(qs0, ps, W: int, vals, tq: int = 2048):
    """One windowed sweep at the tile placement for BIG-masked centred
    queries qs0 over the sorted points: (vals (Q, F) the winners' rows of
    `vals`, exact (Q,))."""
    Q, P = qs0.shape[0], ps.shape[0]
    qsP, ptsP, lo_el, pre_v, suf_v, W = window_placement(qs0, ps, W, tq)
    valsP = torch.cat([vals, vals.new_zeros((ptsP.shape[0] - P,
                                             vals.shape[1]))])
    out, ex = corr_cuda.nn1_window_sweep(qsP, ptsP, lo_el, pre_v, suf_v,
                                         tq=tq, window=W, payload=valsP)
    return out[:Q], ex[:Q]


def block_placement(qs0, ps, wb: int, block: int, presorted: bool):
    """Pad queries and points to whole blocks and place one window of `wb`
    blocks per query block, as the source's XLA path does (knn.py:564-595):
    the block holding the query block's valid-mean x (searchsorted on the
    blocks' first x), or with `presorted` the block whose valid-mean x is
    nearest it, less (wb - 1) // 2. Returns (qsP, psP, lo_blk (nqb,) int64,
    pre_v, suf_v), the bounds at block granularity."""
    n, P = qs0.shape[0], ps.shape[0]
    W = wb * block
    Qp = -(-n // block) * block
    Pp = max(W, -(-P // block) * block)
    qsP = torch.cat([qs0, qs0.new_full((Qp - n, 3), BIG)])
    psP = torch.cat([ps, ps.new_full((Pp - P, 3), BIG)])
    npb = Pp // block
    qmid, _ = _valid_mean(qsP[:, 0], block)
    if presorted:
        c = _nearest_block(qmid, psP[:, 0], block)
    else:
        c = torch.clamp(torch.searchsorted(psP[::block, 0].contiguous(), qmid)
                        - 1, 0, npb - 1)
    lo = torch.clamp(c - (wb - 1) // 2, 0, max(npb - wb, 0))
    pre, suf = _window_bounds(psP[:, 0], block)
    return qsP, psP, lo, pre[lo].contiguous(), suf[lo + wb].contiguous()


def _block_pass(qs0, ps, vs, wb: int, block: int, presorted: bool):
    """One windowed sweep at the block placement: (vals (n, F), exact (n,)),
    the source's `_window_sweep`. The sweep is the 1-NN kernel with one
    block of queries a tile; its tiles are multiples of 256 queries, so
    each block is padded with BIG rows to the next such multiple and the
    padding's results are dropped. Where no point of the window has a
    finite distance (a masked query, a window without a valid point) the
    source's one-hot fetch returns the window's first row, the kernel
    zeros: the first row is taken."""
    n = qs0.shape[0]
    if n == 0:
        return vs.new_zeros((0, vs.shape[1])), qs0.new_zeros(
            (0,), dtype=torch.bool)
    qsP, psP, lo, pre_v, suf_v = block_placement(qs0, ps, wb, block,
                                                 presorted)
    vsP = torch.cat([vs, vs.new_zeros((psP.shape[0] - ps.shape[0],
                                       vs.shape[1]))])
    nqb, tq = lo.shape[0], -(-block // 256) * 256
    qsT = torch.cat([qsP.reshape(nqb, block, 3),
                     qsP.new_full((nqb, tq - block, 3), BIG)], 1)
    vals, exact = corr_cuda.nn1_window_sweep(
        qsT.reshape(nqb * tq, 3), psP, (lo * block).to(torch.int32), pre_v,
        suf_v, tq=tq, window=wb * block, payload=vsP)
    vals = vals.reshape(nqb, tq, -1)[:, :block].reshape(nqb * block, -1)
    exact = exact.reshape(nqb, tq)[:, :block].reshape(-1)
    nvalid = (psP[:, 0] < corr_cuda.BIG_X).reshape(-1, block).sum(1)
    cum = torch.cat([nvalid.new_zeros(1), torch.cumsum(nvalid, 0)])
    empty = (cum[lo + wb] - cum[lo] == 0).repeat_interleave(block)
    first = vsP[(lo * block).repeat_interleave(block)]
    none = empty | (qsP[:, 0] >= corr_cuda.BIG_X)
    vals = torch.where(none[:, None], first, vals)
    return vals[:n], exact[:n]


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
                       presorted: bool = False, values_fn=None):
    """Windowed 1-NN + fetch for near-coincident surfaces: (vals, exact).

    vals is the nearest point's row of `values` (or of
    values_fn(sorted points, valid), computed after the sort), or the point
    itself when both are None; exact is False where no tier could certify
    the answer (the caller masks those and counts them). `presorted` skips
    the sort of the points (the certificate is order-free; ties then go to
    the lowest index in the caller's order). The windows are placed as the
    source places them for P points and F fetched columns
    (`tile_placement`): per 2048-query tile inside its kernel's envelope,
    per `block` queries beyond it; the tiers follow on the same placement,
    the escalate pass `escalate_factor` times wider."""
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

    if presorted:
        ps = pts.contiguous()
    else:
        order = torch.sort(pts[:, 0], stable=True).indices
        ps = pts[order].contiguous()
    if values_fn is not None:
        if values is not None:
            raise ValueError("pass values or values_fn, not both")
        valid_s = ps[:, 0] < corr_cuda.BIG_X
        vs = values_fn(ps + center[None, :], valid_s)
        vs = torch.where(valid_s[:, None], vs, 0.0).contiguous()
    elif values is not None:
        vs = (values if presorted else values[order]).contiguous()
    else:
        vs = ps  # fetch the (centred) points themselves

    if tile_placement(P, vs.shape[1]):
        def one_pass(q, wb):
            return _window_pass(q, ps, wb * block, vs)
    else:
        def one_pass(q, wb):
            return _block_pass(q, ps, vs, wb, block, presorted)

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


def nn1_gather_sorted(queries, points, values, point_mask=None,
                      block: int = 8192):
    """Windowed 1-NN + fetch, the source's first formulation: (vals (Q, F),
    exact (Q,)). Points and queries sorted along x and cut into blocks of
    `block`; each query block scans the three point blocks around the one
    whose first x precedes its middle query's x, with the
    |q|^2 - 2 q.p + |p|^2 distance form, and is certified against the x
    range of its window (exact = dbest <= gap^2, no gap on a side with no
    block beyond); the results are put back in query order."""
    Q, P = queries.shape[0], points.shape[0]
    dev = queries.device
    center = points.mean(0)  # cancellation control, over every point
    queries = queries - center
    points = points - center
    pts = (points if point_mask is None
           else torch.where(point_mask[:, None], points, BIG))
    porder = torch.sort(pts[:, 0], stable=True).indices
    ps, vs = pts[porder], values[porder]
    qrank = torch.sort(queries[:, 0], stable=True).indices
    qs = queries[qrank]

    qs = torch.cat([qs, qs.new_full(((-Q) % block, 3), BIG)])
    padp = max(3 * block, -(-P // block) * block) - P
    ps = torch.cat([ps, ps.new_full((padp, 3), BIG)])
    vs = torch.cat([vs, vs.new_zeros((padp, vs.shape[1]))])
    nqb, npb = qs.shape[0] // block, ps.shape[0] // block
    qmid = qs[block // 2::block, 0].contiguous()
    c = torch.clamp(torch.searchsorted(ps[::block, 0].contiguous(), qmid) - 1,
                    0, npb - 1)
    los = torch.clamp(c - 1, 0, max(npb - 3, 0)).tolist()

    val_s = vs.new_zeros((nqb * block, vs.shape[1]))
    ex_s = torch.zeros((nqb * block,), dtype=torch.bool, device=dev)
    for i, lo in enumerate(los):
        qb = qs[i * block:(i + 1) * block]
        pb = ps[lo * block:(lo + 3) * block]
        valid = pb[:, 0] < corr_cuda.BIG_X
        pbz = torch.where(valid[:, None], pb, 0.0)
        qn = torch.sum(qb * qb, dim=-1, keepdim=True)
        pn = torch.sum(pbz * pbz, dim=-1)
        d = torch.clamp_min(qn - 2.0 * (qb @ pbz.T) + pn[None, :], 0.0)
        d = torch.where(valid[None, :], d, torch.inf)
        dbest, j = torch.min(d, dim=-1)  # the first (lowest-index) minimum
        val_s[i * block:(i + 1) * block] = vs[lo * block + j]
        gap_lo = (torch.clamp_min(qb[:, 0] - pb[0, 0], 0.0) if lo > 0
                  else torch.full_like(dbest, torch.inf))
        gap_hi = (torch.clamp_min(pb[-1, 0] - qb[:, 0], 0.0) if lo + 3 < npb
                  else torch.full_like(dbest, torch.inf))
        gap = torch.minimum(gap_lo, gap_hi)
        ex_s[i * block:(i + 1) * block] = dbest <= gap * gap
    vals = torch.empty_like(val_s[:Q])
    exact = torch.empty_like(ex_s[:Q])
    vals[qrank] = val_s[:Q]
    exact[qrank] = ex_s[:Q]
    return vals, exact


def nn1_gather(queries, points, values, point_mask=None, block: int = 8192):
    """Brute-force 1-NN + fetch: (idx (Q,) int64, vals (Q, F)). Per block of
    `block` queries the argmin of |p|^2 - 2 q.p over every point (the
    per-query |q|^2 shifts each candidate equally and is left out), centred
    on the cloud, ties to the lower index."""
    Q = queries.shape[0]
    center = points.mean(0)
    queries = queries - center
    points = points - center
    pn = torch.sum(points * points, dim=-1)
    idx = []
    for i in range(0, Q, block):
        d = pn[None, :] - 2.0 * (queries[i:i + block] @ points.T)
        if point_mask is not None:
            d = torch.where(point_mask[None, :], d, torch.inf)
        idx.append(torch.argmin(d, dim=-1))
    idx = (torch.cat(idx) if idx
           else torch.zeros((0,), dtype=torch.int64, device=queries.device))
    return idx, values[idx]
