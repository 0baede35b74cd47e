"""Per-node SE(3) Gauss-Newton solver (the rotations the reference declared
but never wired, energy.t:30,78).

Port of dynfu_tpu/solver/se3.py. Each node carries a twist xi_k = (u_k,
omega_k) linearised in the node's own frame:

  warp(x_v) ~= y_v + sum_k wbar_vk (u_k + omega_k x (y_v - p_k))

with y_v the current DLB-warped position and wbar the normalised blend
weights. Writing J_vk = wbar_vk (U_v + C_k) with U_v = [I | -[y_v]x] and
C_k = [0 | [p_k]x] factorises every block of J^T J into ten monomial-
weighted Grams B_m = W^T diag(s2 m(y)) W, m in {1, y_a, y_a y_b}: the CUDA
kernel solver/gram_cuda.monomial_grams. The reg term ||T_k p_j - T_j p_j||^2
has D*KNN edges and is assembled from batched 6x6 blocks. Each step solves
the 6D x 6D system by Jacobi-PCG (solver/gn.pcg), composes exp(xi_k) into the node dual
quaternions about the node frame and relinearises y through the fixed data
graph.

Kept from the source: the centred assembly frame (the |y|^2 terms cancel
down to lever scale; centring keeps that cancellation out of the roundoff),
the rejection of a step that raises the data cost more than 100x, the
min_update deadband and the max_update sweep gate. The source's one-hot
fetches become direct index reads. IEEE float32 throughout: every
contraction here is elementwise or a float32 matrix product, and the
package turns TF32 off at import (plainref/__init__.py). The data
costs are summed in float64 and rounded once, as gn's c0 is. The only sums
over the data rows, the Grams and the costs, go through `DataTerm`, which
the sharded solve (dist/shard_gram.py) replaces by its ranks' float64
partials added in rank order.

Not copied: the source's fixed 10 pointer-jumping rounds for the
similarity-mode component labels (se3.py:302), which can stop short on a
long path graph; the labels here iterate until they stop changing, at most
D rounds.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from plainref.core import dualquat as dq
from plainref.ops import segsum
from plainref.solver import gram_cuda
from plainref.solver.gn import data_cost64, pcg, tukey_biweights
from plainref.warp import field as wfield


class Se3Stats(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    cg_iters: torch.Tensor  # of the LAST relinearisation
    mean_rot_deg: torch.Tensor  # mean applied rotation over active nodes


def _skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrix [v]x."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1),
                        torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def _cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def _assemble_data(B, Bu, Bw, pos, D: int):
    """(A (D, 6, D, 6), b (D, 6)) of the data term from the monomial Grams
    (se3.py:145-195): with a_vk = y_v - p_k every y-moment comes out of B
    and the node positions broadcast as (D, 1) against (1, D)."""
    G1 = B[0]
    Gy = torch.stack([B[1], B[2], B[3]], -1)  # (D, D, 3)
    iu = torch.as_tensor([[4, 5, 6], [5, 7, 8], [6, 8, 9]], device=B.device)
    Gyy = torch.movedim(B[iu], (0, 1), (2, 3))  # (D, D, 3, 3)
    pk = pos[:, None, :]  # row-block node
    pl = pos[None, :, :]  # column-block node
    eye3 = torch.eye(3, dtype=torch.float32, device=B.device)
    G1e = G1[..., None, None]

    A_uu = G1e * eye3
    A_uw = -_skew(Gy) + G1e * _skew(pl)
    A_wu = torch.swapaxes(-_skew(Gy) + G1e * _skew(pk), -1, -2)
    tr_yy = Gyy[..., 0, 0] + Gyy[..., 1, 1] + Gyy[..., 2, 2]
    y_dot_p_l = torch.sum(Gy * pl, -1)
    y_dot_p_k = torch.sum(Gy * pk, -1)
    pk_dot_pl = torch.sum(pk * pl, -1)
    a_dot_b = tr_yy - y_dot_p_l - y_dot_p_k + G1 * pk_dot_pl
    ba = (Gyy - Gy[..., :, None] * pk[..., None, :]
          - pl[..., :, None] * Gy[..., None, :]
          + G1e * (pl[..., :, None] * pk[..., None, :]))
    A_ww = a_dot_b[..., None, None] * eye3 - ba
    A = torch.cat([torch.cat([A_uu, A_uw], -1), torch.cat([A_wu, A_ww], -1)],
                  -2)  # (D, D, 6, 6)
    A = torch.movedim(A, 1, 2)  # (D, 6, D, 6)
    b = torch.cat([Bu, Bw - _cross(pos, Bu)], -1)
    return A, b


def _component_labels(reg_idx, conn, D: int):
    """Connected components of the reg graph (edge (d, r) joins d and
    reg_idx[d, r] where conn): each node's label is the least node index of
    its component. Min-label propagation with pointer jumping until the
    labels stop changing (at most D rounds)."""
    dev = reg_idx.device
    lab = torch.arange(D, device=dev)
    big = torch.full((D,), D, dtype=lab.dtype, device=dev)
    for _ in range(D):
        pull = torch.where(conn, lab[reg_idx], D).amin(dim=1)
        push = big.scatter_reduce(
            0, reg_idx.reshape(-1),
            torch.where(conn, lab[:, None], D).reshape(-1), reduce="amin")
        new = torch.minimum(lab, torch.minimum(pull, push))
        new = torch.minimum(new, new[new])  # pointer jump
        if torch.equal(new, lab):
            break
        lab = new
    return lab


def _assemble_reg(wf, reg_idx, edge_mask, reg_w2, D: int,
                  psi_reg: float = 0.0, similarity: bool = False):
    """Reg normal equations of r_kj = T_k(p_j) - T_j(p_j) (se3.py:197-318):
    (A_reg (D, 6, D, 6), b_reg (D, 6), cost0). Edge (k, r) joins k to
    reg_idx[k, r]; its Jacobian has the blocks [I | -[T_k(p_j) - p_k]x] at k
    and -[I | -[T_j(p_j) - p_j]x] at j."""
    reg_idx = reg_idx.long()
    K = reg_idx.shape[1]
    dev = reg_idx.device
    pos = wf.pos
    n_pos = pos[reg_idx]  # (D, K, 3)
    yk = dq.dq_transform_point(wf.dqs[:, None, :], n_pos)  # T_k(p_j)
    yj = dq.dq_transform_point(wf.dqs[reg_idx], n_pos)  # T_j(p_j)
    if psi_reg > 0.0:
        e = torch.linalg.vector_norm(yk - yj, dim=-1)
        hw = torch.where(e <= psi_reg, 1.0,
                         psi_reg / torch.clamp_min(e, 1e-30))
        edge_mask = edge_mask * torch.sqrt(hw)
    r0 = (yk - yj) * edge_mask[..., None]

    eye3 = torch.eye(3, dtype=torch.float32, device=dev).expand(D, K, 3, 3)
    em = edge_mask[..., None, None]
    Gk = torch.cat([eye3, -_skew(yk - pos[:, None, :])], -1) * em
    Gj = torch.cat([eye3, -_skew(yj - n_pos)], -1) * em

    def gram(P, Q):  # (D, K, 3, 6) x (D, K, 3, 6) -> (D, K, 6, 6)
        return torch.sum(P[..., :, :, None] * Q[..., :, None, :], -3)

    Mkk, Mkj, Mjj = gram(Gk, Gk), gram(Gk, Gj), gram(Gj, Gj)
    bk = torch.sum(Gk * r0[..., None], (1, 2))  # (D, 6)
    bj = torch.sum(Gj * r0[..., None], 2)  # (D, K, 6)

    rows = torch.arange(D, device=dev)[:, None].expand(D, K)
    flat_j = reg_idx.reshape(-1)
    # cross blocks (one edge per (d, j) block on k-NN rows, whose indices
    # are distinct; repeated indices accumulate)
    cross = torch.zeros((D, D, 6, 6), dtype=torch.float32, device=dev)
    cross.index_put_((rows, reg_idx), Mkj, accumulate=True)
    A = -cross - cross.permute(1, 0, 3, 2)
    diag = segsum.index_add(torch.sum(Mkk, 1), flat_j, Mjj.reshape(-1, 6, 6))
    idx = torch.arange(D, device=dev)
    A[idx, idx] += diag
    A = torch.swapaxes(A, 1, 2)  # (D, 6, D, 6)
    b = bk - segsum.index_add(torch.zeros_like(bk), flat_j, bj.reshape(-1, 6))

    if similarity:
        # marginalise one uniform-scale mode per connected component of the
        # reg graph (se3.py:259-315): a rank-per-component downdate of (A, b)
        d_e = (pos[:, None, :] - n_pos) * edge_mask[..., None]
        Jtd_j = torch.sum(Gj * d_e[..., None], 2).reshape(-1, 6)
        Jtd = (torch.sum(Gk * d_e[..., None], (1, 2))
               - segsum.index_add(torch.zeros((D, 6), device=dev), flat_j,
                                  Jtd_j))
        lab = _component_labels(reg_idx, edge_mask > 0.0, D)
        OHc = (lab[:, None] == idx[None, :]).to(torch.float32)  # (D, D)
        dtd_c = segsum.index_add(torch.zeros(D, device=dev), lab,
                                 torch.sum(d_e * d_e, (1, 2)))
        dtr_c = segsum.index_add(torch.zeros(D, device=dev), lab,
                                 torch.sum(d_e * r0, (1, 2)))
        inv_c = torch.where(dtd_c > 1e-12, 1.0 / torch.clamp_min(dtd_c, 1e-12),
                            0.0)
        V = (Jtd[:, :, None] * OHc[:, None, :]).reshape(D * 6, D)
        A = (A.reshape(D * 6, D * 6) - (V * inv_c) @ V.T).reshape(D, 6, D, 6)
        b = b - torch.sum(V * (inv_c * dtr_c), -1).reshape(D, 6)

    cost0 = torch.sum(r0 * r0)
    return reg_w2 * A, -reg_w2 * b, reg_w2 * cost0


def _exp_update_dq(xi, pos):
    """Per-node update DQ for twist xi (D, 6) about the node frame:
    Trans(p) Rot(exp(omega)) Trans(-p) Trans(u), t = u + p - R p."""
    u, w = xi[:, :3], xi[:, 3:]
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    axis = w / torch.clamp_min(theta, 1e-12)
    half = 0.5 * theta
    rot = torch.cat([torch.cos(half), torch.sin(half) * axis], -1)
    pq = torch.cat([torch.zeros_like(pos[:, :1]), pos], -1)
    rp = dq.quat_mul(dq.quat_mul(rot, pq), dq.quat_conj(rot))[:, 1:]
    return dq.dq_from_quat_translation(rot, u + pos - rp)


def data_cost(s2, delta):
    """The data cost sum s2 |delta|^2, summed in float64 and rounded once."""
    return data_cost64(s2, delta).to(torch.float32)


def data_grams(data_idx, data_w, s2, y_c, delta, D: int):
    """(B, Bu, Bw, cost): the monomial Grams of the rows (the kernel) and
    their data cost."""
    B, Bu, Bw = gram_cuda.monomial_grams(data_idx, data_w, s2, y_c, delta, D)
    return B, Bu, Bw, data_cost(s2, delta)


class DataTerm(NamedTuple):
    """The solve's sums over the data rows, as gn.solve's data_normal_fn:
    grams(data_idx, data_w, s2, y_c, delta, D) -> (B, Bu, Bw, cost) and
    cost(s2, delta) -> cost. The sharded solve (dist/shard_gram.py) passes
    its rows' sums, reduced over ranks in rank order; everything else in
    the solve is per row or per node."""

    grams: object = data_grams
    cost: object = data_cost


def solve(wf: wfield.WarpField, canonical_v, live_v, vert_mask=None, *,
          tukey_offset: float = 4.652, psi_data: float = 0.01,
          lambda_reg: float = 200.0, psi_reg: float = 1e-4,
          linear_iter: int = 256, cg_tol: float = 1e-12,
          knn_k: int = wfield.KNN, relinearize: int = 3,
          min_update: float = 0.0, max_update: float = 0.0,
          incremental: bool = False, rot_prior: float = 0.03,
          trans_prior: float = 0.0, similarity_reg: bool = False,
          data_term: DataTerm = DataTerm()):
    """SE(3) warp solve: (updated WarpField, Se3Stats).

    `relinearize` Gauss-Newton steps, each re-warping y through the fixed
    data graph, re-assembling the factorised normal equations and solving
    them by PCG; Tukey weights come once from the incoming state.
    `incremental`: canonical_v is ALREADY warped by the current field (the
    fusion engine's convention), so the blend starts from the identity and
    the solved updates compose onto the node DQs. `data_term` sums over
    the rows (the costs: float64, rounded once)."""
    dev = wf.pos.device
    f32 = torch.float32
    canonical_v = torch.as_tensor(canonical_v, dtype=f32, device=dev)
    live_v = torch.as_tensor(live_v, dtype=f32, device=dev)
    N, D = canonical_v.shape[0], wf.capacity
    if vert_mask is None:
        vert_mask = torch.ones((N,), dtype=torch.bool, device=dev)
    ident = dq.dq_identity(device=dev)
    mask_c = wf.mask[:, None]

    data_idx, n_sqd, n_pos, n_dq0, n_w, n_valid = wfield.neighbor_features(
        wf, canonical_v, knn_k)
    if incremental:
        n_dq0 = torch.broadcast_to(ident, n_dq0.shape)
    blend = wfield._dlb_from_features(canonical_v, n_pos, n_dq0, n_w, n_valid)
    y0 = dq.dq_transform_point(blend, canonical_v)

    # normalised blend weights; unsupported vertices (every neighbour beyond
    # its support radius) are node-insertion candidates, not data
    w_raw = torch.where(n_valid, wfield.transformation_weights(
        n_pos, n_w, canonical_v[:, None, :]), 0.0)
    wsum = torch.sum(w_raw, -1, keepdim=True)
    data_w = (w_raw / torch.clamp_min(wsum, 1e-12)).contiguous()
    s2 = tukey_biweights(y0, live_v, tukey_offset, psi_data)
    s2 = torch.where(vert_mask & (wsum[:, 0] > 1e-12), s2, 0.0)
    support = torch.where(n_valid,
                          torch.sqrt(n_sqd) / torch.clamp_min(n_w, 1e-12),
                          torch.inf)
    s2 = torch.where(torch.amin(support, -1) < 1.0, s2, 0.0).contiguous()

    reg_idx, _ = wfield.find_neighbors(wf, wf.pos, knn_k)
    edge_mask = (mask_c & wf.mask[reg_idx]).to(f32)
    D_active = torch.clamp_min(wf.count.to(f32), 1.0)
    reg_w2 = lambda_reg / (D_active * knn_k)

    # centred assembly frame (se3.py:472-486); xi composes with the true
    # node positions
    m_act = wf.mask.to(f32)
    center = (torch.sum(wf.pos * m_act[:, None], 0)
              / torch.clamp_min(torch.sum(m_act), 1.0))
    pos_c = torch.where(mask_c, wf.pos - center, 0.0)

    idx64 = data_idx.to(torch.int64)
    upd, y = ident.expand(D, 8), y0
    initial_cost = cost = None  # the data cost at y
    for _ in range(max(relinearize, 1)):
        wf_cur = wf._replace(dqs=torch.where(mask_c, dq.dq_mul(upd, wf.dqs),
                                             wf.dqs))
        delta = (live_v - y).contiguous()
        B, Bu, Bw, cost = data_term.grams(
            data_idx, data_w, s2, (y - center).contiguous(), delta, D)
        if initial_cost is None:
            initial_cost = cost
        A_d, b_d = _assemble_data(B, Bu, Bw, pos_c, D)
        A_r, b_r, _ = _assemble_reg(wf_cur, reg_idx, edge_mask, reg_w2, D,
                                    psi_reg=psi_reg, similarity=similarity_reg)
        A = (A_d + A_r).reshape(D * 6, D * 6)
        b = (b_d + b_r).reshape(D * 6)
        # each node's own data strength: the mean u-block diagonal
        duu = A_d.reshape(D * 6, D * 6).diagonal().reshape(D, 6)[:, :3]
        duu = duu.mean(-1)
        if trans_prior > 0.0:
            # translation step damping scaled by the MEAN data strength
            mean_duu = torch.sum(duu * m_act) / torch.clamp_min(
                torch.sum(m_act), 1.0)
            dvec = torch.zeros((D, 6), device=dev)
            dvec[:, :3] = trans_prior * mean_duu
            A.diagonal().add_(dvec.reshape(-1))
        if rot_prior > 0.0:
            # rotation prior toward zero, a rotation theta priced like a
            # translation theta * dg_w, scaled by the node's own strength
            dvec = torch.zeros((D, 6), device=dev)
            dvec[:, 3:] = (rot_prior * duu * wf.w * wf.w)[:, None]
            A.diagonal().add_(dvec.reshape(-1))
        xi_flat, iters = pcg(A, b, torch.zeros_like(b), linear_iter, cg_tol,
                             matvec=torch.mv)
        xi = torch.where(mask_c, xi_flat.reshape(D, 6), 0.0)
        upd2 = dq.dq_mul(_exp_update_dq(xi, wf.pos), upd)
        # relinearise: the updated node DQs through the fixed graph
        n_dq = dq.dq_mul(upd2[idx64], n_dq0)
        blend2 = wfield._dlb_from_features(canonical_v, n_pos, n_dq, n_w,
                                           n_valid)
        y2 = dq.dq_transform_point(blend2, canonical_v)
        # reject a step that raises the data cost by orders of magnitude
        cost2 = data_term.cost(s2, (live_v - y2).contiguous())
        ok = cost2 <= 100.0 * cost
        upd = torch.where(ok, upd2, upd)
        y = torch.where(ok, y2, y)
        cost = torch.where(ok, cost2, cost)

    if min_update > 0.0 or max_update > 0.0:
        # deadband on the node's own displacement |upd(p_k) - p_k|, and the
        # trust region on the worst-case sweep over its support radius
        moved = dq.dq_transform_point(upd, wf.pos) - wf.pos
        norm = torch.linalg.vector_norm(moved, dim=-1, keepdim=True)
        keep = norm > min_update if min_update > 0.0 else norm >= 0.0
        if max_update > 0.0:
            realp = upd[:, :4]
            half = torch.arccos(torch.clamp(
                torch.abs(realp[:, 0])
                / torch.clamp_min(torch.linalg.vector_norm(realp, dim=-1),
                                  1e-12), 0.0, 1.0))
            sweep = norm[:, 0] + 2.0 * torch.sin(half) * wf.w
            keep = keep & (sweep <= max_update)[:, None]
        upd = torch.where(keep, upd, ident)

    final_cost = cost
    real = upd[:, :4]
    ang = 2.0 * torch.arccos(torch.clamp(
        torch.abs(real[:, 0]) / torch.linalg.vector_norm(real, dim=-1),
        0.0, 1.0))
    mean_rot = torch.sum(ang * m_act) / torch.clamp_min(torch.sum(m_act), 1.0)
    dqs = torch.where(mask_c, dq.dq_mul(upd, wf.dqs), wf.dqs)
    stats = Se3Stats(initial_cost, final_cost, iters, torch.rad2deg(mean_rot))
    return wf._replace(dqs=dqs), stats
