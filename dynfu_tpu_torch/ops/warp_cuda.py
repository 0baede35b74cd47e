"""Fused warp (k-NN + DQB or DLB blend + transform): CUDA wrapper and plain
version.

Replaces warp_fused_tpu, both blends (dynfu_tpu/ops/warp_pallas.py:171).
Kernel source: csrc/warp.cu. The plain version below computes the same
numbers in the kernel's operation order, column by column, so that on the
card the two agree to the last bit or two. The kernel selects each query's
k nodes from a pruned candidate list (csrc/topk.cuh, scan_pruned);
`pruned_select` is a plain model of that rule, for the tests and for
chip_smoke.py's candidate counts, and is on no main path.

blend="dqb" is the reference's sequential product (dual-only scaling, real
part normalised, normals fully transformed); blend="dlb" is Kavan's linear
blend (sign-aligned to the nearest node's real part, the identity without
support, joint normalisation, normals rotated only). Launches are counted
per blend in `warp_fused.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from dynfu_tpu_torch import kernels
from dynfu_tpu_torch.ops.knn_cuda import FAR, masked_sqdist, select_k


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


def launch_threads(D: int) -> int:
    """The threads per block the kernel launches with for D slots (256, or
    the most whose candidate lists fit in shared memory), as the kernel's
    own launch code picks them; on the card only."""
    out = ctypes.c_int(0)
    kernels.check(kernels.load().dynfu_warp_threads(D, ctypes.byref(out)),
                  "warp_threads")
    return out.value


def _box_bounds(nodes, lo, hi):
    """(mind, maxd) (G, D): bounds of the squared distance from node j to
    any query in box g, per axis as in csrc/topk.cuh's box_bounds."""
    p, lo, hi = nodes[None], lo[:, None], hi[:, None]
    m = torch.where(p > hi, p - hi, torch.where(p < lo, lo - p, 0.0))
    M = torch.maximum((p - lo).abs(), (p - hi).abs())
    mind = m[..., 0] * m[..., 0] + m[..., 1] * m[..., 1] + m[..., 2] * m[..., 2]
    maxd = M[..., 0] * M[..., 0] + M[..., 1] * M[..., 1] + M[..., 2] * M[..., 2]
    return mind, maxd


def _box(q, fin, dim):
    lo = torch.where(fin[..., None], q, torch.inf).amin(dim)
    hi = torch.where(fin[..., None], q, -torch.inf).amax(dim)
    return lo, hi


def _candidates(nodes, lo, hi, k, keep):
    """The rule at one level: nodes in `keep` (G, D) whose mind is not above
    the k-th smallest maxd among `keep` (NaN as +inf)."""
    mind, maxd = _box_bounds(nodes, lo, hi)
    maxd = torch.where(torch.isnan(maxd) | ~keep, torch.inf, maxd)
    ub = torch.kthvalue(maxd, k, dim=1).values
    return keep & ~(mind > ub[:, None])


def group_candidates(queries, node_pos, node_mask, k: int, threads: int):
    """The kernel's candidate lists: (cand (G, D) bool, has_box (G,) bool),
    one per warp (32 consecutive queries) of each block of `threads`. The
    block's list holds the nodes its box does not rule out; the warp's,
    those of the block's list its own box does not rule out. A warp
    without a finite query has no box and no candidates."""
    Q = queries.shape[0]
    B, nw = -(-Q // threads), threads // 32
    nodes = torch.where(node_mask[:, None], node_pos, FAR)
    qb = torch.cat([queries, queries.new_full((B * threads - Q, 3),
                                              torch.nan)])
    qb = qb.reshape(B, threads, 3)
    fin = torch.isfinite(qb).all(-1)
    lo, hi = _box(qb, fin, 1)
    block_cand = _candidates(nodes, lo, hi, k, fin.any(1)[:, None].expand(
        B, nodes.shape[0]))
    fw = fin.reshape(B * nw, 32)
    wlo, whi = _box(qb.reshape(B * nw, 32, 3), fw, 1)
    has_box = fw.any(1)
    keep = block_cand.repeat_interleave(nw, 0) & has_box[:, None]
    return _candidates(nodes, wlo, whi, k, keep), has_box


def pruned_select(queries, node_pos, node_mask, k: int, threads: int):
    """(idx (Q, k) int64, sqd (Q, k)): each query's k nearest among its
    warp's candidates in (distance, index) order; a query with a
    non-finite coordinate gets slots 0..k-1 at +inf. Equal to select_k's
    brute force (the tests hold it so)."""
    cand, _ = group_candidates(queries, node_pos, node_mask, k, threads)
    cand = cand.repeat_interleave(32, 0)[:queries.shape[0]]
    d = masked_sqdist(queries, node_pos, node_mask)
    d, order = torch.sort(d, dim=1, stable=True)
    out = torch.gather(~cand, 1, order).to(torch.int32)
    first = torch.sort(out, dim=1, stable=True).indices[:, :k]
    idx, sqd = torch.gather(order, 1, first), torch.gather(d, 1, first)
    nonfinite = ~torch.isfinite(queries).all(-1)
    idx[nonfinite] = torch.arange(k, device=queries.device)
    sqd[nonfinite] = torch.inf
    return idx, sqd


def warp_fused_plain(queries, normals, node_pos, node_dqs, node_w, node_mask,
                     k: int = 8, blend: str = "dqb"):
    kernels.count_plain(warp_fused_plain, queries)
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


warp_fused_plain.cuda_calls = 0


def warp_fused(queries: torch.Tensor, normals: torch.Tensor,
               node_pos: torch.Tensor, node_dqs: torch.Tensor,
               node_w: torch.Tensor, node_mask: torch.Tensor, k: int = 8,
               blend: str = "dqb"):
    """(warped (Q,3), warped_normals (Q,3), blend_dq (Q,8), ratio (Q,)):
    the warp of every query by the given blend and its unsupported ratio
    min_k sqrt(d_k) / dg_w_k over valid neighbours."""
    code = _blend_code(blend)
    if not kernels.on_cuda(queries, "warp_fused"):
        return warp_fused_plain(queries, normals, node_pos, node_dqs, node_w,
                                node_mask, k, blend)
    Q, D = queries.shape[0], node_pos.shape[0]
    dev = queries.device
    kernels.require(queries, "queries", torch.float32, (Q, 3), dev)
    kernels.require(normals, "normals", torch.float32, (Q, 3), dev)
    kernels.require(node_pos, "node_pos", torch.float32, (D, 3), dev)
    kernels.require(node_dqs, "node_dqs", torch.float32, (D, 8), dev)
    kernels.require(node_w, "node_w", torch.float32, (D,), dev)
    kernels.require(node_mask, "node_mask", torch.bool, (D,), dev)
    if not (1 <= k <= 8 and k <= D <= 8192):
        raise ValueError(f"warp_fused: need 1 <= k <= 8 and k <= D <= 8192, "
                         f"got k={k}, D={D}")
    warped = torch.empty((Q, 3), dtype=torch.float32, device=dev)
    wnorm = torch.empty((Q, 3), dtype=torch.float32, device=dev)
    bdq = torch.empty((Q, 8), dtype=torch.float32, device=dev)
    ratio = torch.empty((Q,), dtype=torch.float32, device=dev)
    if Q == 0:
        return warped, wnorm, bdq, ratio
    lib = kernels.load()
    kernels.check(lib.dynfu_warp_fused(
        queries.data_ptr(), normals.data_ptr(), node_pos.data_ptr(),
        node_dqs.data_ptr(), node_w.data_ptr(), node_mask.data_ptr(), Q, D,
        k, code, warped.data_ptr(), wnorm.data_ptr(), bdq.data_ptr(),
        ratio.data_ptr(), kernels.stream(queries)), "warp_fused")
    warp_fused.launches[blend] += 1
    return warped, wnorm, bdq, ratio


warp_fused.launches = {"dqb": 0, "dlb": 0}
