"""The warp field: deformation nodes and dual-quaternion blending.

Port of dynfu_tpu/warp/field.py (the reference's Warpfield/Node,
warp_field.cpp), with both blends: the reference's DQB and the proper DLB
the SE(3) fusion path warps through. The node set is a fixed-capacity,
mask-padded struct of tensors; `count` stays a 0-d device tensor so that no
frame waits on the host for it.

Semantics kept: DQB is the sequential product of weight-scaled node DQs in
nearest-first order, real part normalised; w(v) = exp(-|v - dg_v|^2 /
(2 dg_w^2)); a vertex is unsupported when min_k dist_k / dg_w_k >= 1; node
insertion voxel-downsamples unsupported vertices (5 cm leaf, centroids) and
seeds each new node with the blend at its position; updates compose the new
transform on the LEFT. DLB (Kavan et al.): normalised Gaussian weights, each
node dq sign-aligned to the nearest node's real part, summed, the identity
without support, the whole dq divided by |real|; points get the full
transform, normals the rotation only.

Kernels: the k-NN feature fetch is ops/knn_cuda.knn_gather, the warp and
the unsupported ratio are ops/warp_cuda.warp_fused.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from plainref.core import dualquat as dq
from plainref.kernels import resolve_device
from plainref.ops import knn, knn_cuda, segsum, warp_cuda

KNN = 8  # warp_field.hpp:27


class WarpField(NamedTuple):
    """Fixed-capacity node set. Active nodes are [0, count)."""

    pos: torch.Tensor  # (D, 3) dg_v
    dqs: torch.Tensor  # (D, 8) dg_se3
    w: torch.Tensor  # (D,) dg_w
    mask: torch.Tensor  # (D,) bool
    count: torch.Tensor  # () int32

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]


def init_warpfield(positions, dqs=None, weights=None,
                   capacity: int | None = None, device="cuda") -> WarpField:
    f32 = torch.float32
    device = resolve_device(device)
    positions = torch.as_tensor(positions, dtype=f32, device=device)
    n = positions.shape[0]
    capacity = capacity or n
    ident = dq.dq_identity(device=positions.device)
    dqs = (ident.repeat(n, 1) if dqs is None
           else torch.as_tensor(dqs, dtype=f32, device=device))
    if weights is None:
        weights = torch.ones((n,), dtype=f32, device=device)
    else:
        weights = torch.broadcast_to(
            torch.as_tensor(weights, dtype=f32, device=device), (n,))
    pad = capacity - n
    pos = torch.cat([positions, positions.new_zeros((pad, 3))])
    dqs = torch.cat([dqs, ident.repeat(pad, 1)])
    w = torch.cat([weights, weights.new_ones((pad,))])
    mask = torch.arange(capacity, device=positions.device) < n
    return WarpField(pos, dqs, w, mask,
                     torch.tensor(n, dtype=torch.int32, device=device))


def transformation_weights(node_pos, node_w, points):
    """w(v) = exp(-|v - dg_v|^2 / (2 dg_w^2)), broadcasting (node.cpp)."""
    d2 = torch.sum((points - node_pos) ** 2, dim=-1)
    return torch.exp(-d2 / (2.0 * node_w * node_w))


def find_neighbors(wf: WarpField, points, k: int = KNN):
    """k-NN node indices (Q, k) int64 + sqdists, nearest first."""
    return knn.knn_brute(points, wf.pos, k, wf.mask)


def node_table(wf: WarpField) -> torch.Tensor:
    """(D, 13) per-node rows [pos | dq | dg_w | mask]."""
    return torch.cat([wf.pos, wf.dqs, wf.w[:, None],
                      wf.mask[:, None].to(torch.float32)], dim=1)


def neighbor_features(wf: WarpField, points, k: int = KNN):
    """k-NN + node-state fetch: (idx (Q,k) int32, sqd (Q,k), n_pos (Q,k,3),
    n_dq (Q,k,8), n_w (Q,k), n_valid (Q,k))."""
    idx, sqd, feats = knn_cuda.knn_gather(
        points.contiguous(), wf.pos.contiguous(), k, node_table(wf),
        wf.mask.contiguous())
    return (idx, sqd, feats[..., 0:3], feats[..., 3:11], feats[..., 11],
            feats[..., 12] > 0.5)


def _dqb_from_features(points, n_pos, n_dq, n_w, n_valid):
    """DQB given prefetched neighbour state (nearest-first order)."""
    k = n_w.shape[-1]
    weights = transformation_weights(n_pos, n_w, points[..., None, :])
    scaled = dq.dq_scale(n_dq, weights)
    ident = dq.dq_identity(device=points.device)
    scaled = torch.where(n_valid[..., None], scaled, ident)
    acc = torch.broadcast_to(ident, points.shape[:-1] + (8,))
    for i in range(k):
        acc = dq.dq_mul(acc, scaled[..., i, :])
    return dq.dq_normalize(acc)


def _dlb_from_features(points, n_pos, n_dq, n_w, n_valid):
    """DLB given prefetched neighbour state (nearest-first order)."""
    w = transformation_weights(n_pos, n_w, points[..., None, :])
    w = torch.where(n_valid, w, 0.0)
    wsum = torch.sum(w, dim=-1, keepdim=True)
    wn = w / torch.clamp_min(wsum, 1e-12)
    ref = n_dq[..., 0:1, :4]  # antipodal alignment to the nearest node
    dots = torch.sum(n_dq[..., :4] * ref, dim=-1, keepdim=True)
    sign = torch.where(dots < 0.0, -1.0, 1.0)
    acc = torch.sum(wn[..., None] * n_dq * sign, dim=-2)
    acc = torch.where(wsum > 1e-12, acc, dq.dq_identity(device=acc.device))
    return dq.dq_normalize_joint(acc)


def warp_points_normals_dlb(wf: WarpField, points, normals):
    """warpToLive through the DLB blend: points get the full transform,
    normals the blended rotation only (the SE(3) solver's warp)."""
    wp, wn, _, _ = warp_cuda.warp_fused(
        points.contiguous(), normals.contiguous(), wf.pos, wf.dqs, wf.w,
        wf.mask, k=KNN, blend="dlb")
    return wp, wn


def calc_dqb(wf: WarpField, points, neighbor_idx=None) -> torch.Tensor:
    """Blend node transforms at query points: (Q, 8) dual quaternions; with
    neighbor_idx (Q, k) the given nodes are blended, in that order."""
    if neighbor_idx is not None:
        n_pos, n_dq = wf.pos[neighbor_idx], wf.dqs[neighbor_idx]
        n_w, n_valid = wf.w[neighbor_idx], wf.mask[neighbor_idx]
    else:
        _, _, n_pos, n_dq, n_w, n_valid = neighbor_features(wf, points)
    return _dqb_from_features(points, n_pos, n_dq, n_w, n_valid)


def warp_points_normals(wf: WarpField, points, normals):
    """warpToLive: per-point DQB then the transform; normals get the full
    transform, translation included (reference quirk)."""
    wp, wn, _, _ = warp_cuda.warp_fused(
        points.contiguous(), normals.contiguous(), wf.pos, wf.dqs, wf.w,
        wf.mask, k=KNN)
    return wp, wn


def unsupported_mask(wf: WarpField, points, point_mask=None):
    """True where min over the 8-NN of dist / dg_w >= 1."""
    _, _, _, ratio = warp_cuda.warp_fused(
        points.contiguous(), torch.zeros_like(points), wf.pos, wf.dqs, wf.w,
        wf.mask, k=KNN)
    unsupported = ratio >= 1.0
    if point_mask is not None:
        unsupported = unsupported & point_mask
    return unsupported


def voxel_downsample(points, point_mask, leaf: float, capacity: int,
                     weights=None):
    """Voxel-grid centroid downsample (PCL VoxelGrid analog): cells are
    hashed into a fixed table and emitted sorted by linear cell id.
    Returns (centroids (capacity, 3), mask (capacity,))."""
    dev = points.device
    wgt = (torch.ones(points.shape[0], dtype=torch.float32, device=dev)
           if weights is None else weights)
    cell = torch.floor(points / leaf).to(torch.int32)
    B = 1 << 10
    cid = ((cell[:, 0] & (B - 1)) * B + (cell[:, 1] & (B - 1))) * B \
        + (cell[:, 2] & (B - 1))
    cid = torch.where(point_mask, cid, -1)
    H = max(2 * capacity, 1024)
    slot = torch.where(cid >= 0, cid % H, H).to(torch.int64)
    w_eff = torch.where(point_mask, wgt, 0.0)
    sums = segsum.index_add(
        torch.zeros((H + 1, 3), dtype=torch.float32, device=dev), slot,
        w_eff[:, None] * points)
    cnts = segsum.index_add(
        torch.zeros((H + 1,), dtype=torch.float32, device=dev), slot, w_eff)
    imax = torch.iinfo(torch.int32).max
    reps = torch.full((H + 1,), imax, dtype=torch.int32, device=dev)
    reps = reps.scatter_reduce(0, slot, torch.where(cid >= 0, cid, imax),
                               reduce="amin")
    occupied = cnts[:H] > 0
    order = torch.argsort(torch.where(occupied, reps[:H], imax), stable=True)
    top = order[:capacity]
    cent = sums[top] / torch.clamp_min(cnts[top, None], 1.0)
    out_mask = occupied[top]
    return torch.where(out_mask[:, None], cent, 0.0), out_mask


def insert_nodes(wf: WarpField, new_pos, new_mask, dg_w: float,
                 blend: str = "dqb") -> WarpField:
    """Masked append of new nodes with dg_se3 = blend(pos) and the given
    dg_w (warp_field.cpp:76-83); blend "dqb" (reference) or "dlb"."""
    D = wf.capacity
    if blend == "dlb":
        _, _, n_pos, n_dq, n_w, n_valid = neighbor_features(wf, new_pos)
        new_dq = _dlb_from_features(new_pos, n_pos, n_dq, n_w, n_valid)
    else:
        new_dq = calc_dqb(wf, new_pos)
    offsets = torch.cumsum(new_mask.to(torch.int32), 0) - 1
    slots = wf.count + offsets
    in_range = new_mask & (slots < D)
    slots = torch.where(in_range, slots, D).to(torch.int64)  # D: spill row

    def put(old, new):
        ext = torch.cat([old, old.new_zeros((1,) + old.shape[1:])])
        ext[slots] = new
        return ext[:D]

    pos = put(wf.pos, torch.where(in_range[:, None], new_pos, 0.0))
    dqs = put(wf.dqs, torch.where(in_range[:, None], new_dq, 0.0))
    w = put(wf.w, torch.where(in_range, dg_w, 0.0))
    count = wf.count + in_range.sum(dtype=torch.int32)
    mask = torch.arange(D, device=pos.device) < count
    return WarpField(pos, dqs, w, mask, count)


def _unsupported_tiered(wf: WarpField, verts, vert_mask, cap: int):
    """unsupported_mask with a 1-NN prefilter: the nearest node certifies
    support (ratio < 1); a nearest node beyond the largest active dg_w
    certifies unsupport; only the shell between gets the exact 8-NN ratio,
    on a `cap`-compacted subset (the rest stay supported this frame)."""
    n = verts.shape[0]
    _, sqd1, _, _, n_w1, n_valid1 = neighbor_features(wf, verts, 1)
    d1 = torch.sqrt(sqd1[:, 0])
    ratio1 = torch.where(n_valid1[:, 0],
                         d1 / torch.clamp_min(n_w1[:, 0], 1e-12), torch.inf)
    dgw_max = torch.amax(torch.where(wf.mask, wf.w, 0.0))
    supported = ratio1 < 1.0
    unsup_sure = (d1 >= dgw_max) & vert_mask & ~supported
    ambiguous = vert_mask & ~supported & ~unsup_sure
    aidx, aok = knn.compact(ambiguous, cap)
    apts = torch.where(aok[:, None], verts[torch.clamp_max(aidx, n - 1)], 0.0)
    aunsup = unsupported_mask(wf, apts, aok)
    unsup = torch.cat([unsup_sure, unsup_sure.new_zeros(1)])
    unsup[torch.where(aok, aidx, n)] = aunsup
    return unsup[:n]


def update_warpfield(wf: WarpField, verts, vert_mask, epsilon: float,
                     leaf: float = 0.05, max_new: int = 1024,
                     blend: str = "dqb", vert_weights=None,
                     aabb=None) -> WarpField:
    """Warpfield::update (warp_field.cpp:63-95): unsupported vertices ->
    voxel-grid downsample -> new nodes with dg_w = 2 epsilon, seeded by
    `blend`. `vert_weights` carries soup multiplicities when `verts` is the
    deduplicated canonical, so centroids stay soup-weighted. `aabb` = (lo3,
    hi3) drops candidates outside the box: a vertex outside the volume was
    dragged there by a rogue warp, not new geometry."""
    n = verts.shape[0]
    cap = min(n, 4 * max_new)
    unsup = _unsupported_tiered(wf, verts, vert_mask, cap)
    if aabb is not None:
        lo, hi = (torch.as_tensor(a, dtype=torch.float32, device=verts.device)
                  for a in aabb)
        unsup = unsup & torch.all((verts >= lo) & (verts <= hi), dim=-1)
    idx, ok = knn.compact(unsup, cap)
    safe = torch.clamp_max(idx, n - 1)
    cand_pts = torch.where(ok[:, None], verts[safe], 0.0)
    cand_w = None if vert_weights is None else torch.where(
        ok, vert_weights[safe], 0.0)
    cand, cand_mask = voxel_downsample(cand_pts, ok, leaf, max_new,
                                       weights=cand_w)
    return insert_nodes(wf, cand, cand_mask, 2.0 * epsilon, blend=blend)


def compose_translations(wf: WarpField, translations) -> WarpField:
    """dg_se3 <- DQ(t) * dg_se3 for each active node (node.cpp:19-23)."""
    new = dq.dq_mul(dq.dq_from_translation(translations), wf.dqs)
    return wf._replace(dqs=torch.where(wf.mask[:, None], new, wf.dqs))
