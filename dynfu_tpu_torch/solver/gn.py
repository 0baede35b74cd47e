"""Gauss-Newton solver for the non-rigid warp-field energy.

Port of dynfu_tpu/solver/gn.py (the reference's Opt/Terra energy,
energy.t, driven by opt_solver.cpp). Unknowns are per-node translations
t (D, 3); the energy is

  data: r_v  = sqrt(tukey_v) * (live_v - canonical_v - sum_k w_vk t_{n_k})
  reg:  r_nj = w_reg * (t_j - t_n), w_reg = sqrt(lambda / (D_active * KNN))

assembled as dense normal equations and solved by Jacobi-preconditioned CG
with the reference schedule (24 outer / 16 nonlinear / 256 linear
iterations, earlyOut). The data-term Gram is the CUDA kernel in
solver/gram_cuda.py. The data cost c0 = sum s2 |delta|^2 is summed in
float64 and rounded once. `data_normal_fn` replaces both, as the source's
hook does: the sharded solve (dist/shard_gram.py) passes the Gram and c0
of its rows, reduced over ranks in rank order; everything else in the solve
is per row or per node.

The CG loop (`pcg`, shared with the SE(3) solver) checks its tolerance on
the host between trips of 8 steps, as the source's while_loop does; every
other quantity stays on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dynfu_tpu_torch.core import dualquat as dq
from dynfu_tpu_torch.solver import gram_cuda
from dynfu_tpu_torch.warp import field as wfield

_UNROLL = 8  # CG steps per tolerance check


class SolveStats(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    cg_iters: torch.Tensor
    # mean Huber weight over active nodes; computed on schedule, as the
    # reference does, but read by no energy term (energy.t)
    mean_huber: torch.Tensor


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1))


def tukey_biweights(warped_canonical, live, tukey_offset: float,
                    psi_data: float):
    """Tukey biweight per vertex from the current residual
    (opt_solver.cpp:204-231)."""
    err = _norm(live - warped_canonical) / tukey_offset
    w = (1.0 - (err / psi_data) ** 2) ** 2
    return torch.where(err < psi_data, w, 0.0)


def huber_weights(wf: wfield.WarpField, reg_idx, psi_reg: float):
    """Huber weights on node-pair disagreement, keeping only the LAST
    neighbour's weight per node (the reference's loop overwrite)."""
    n_pos = wf.pos[reg_idx]  # (D, K, 3)
    t1 = dq.dq_transform_point(wf.dqs[:, None, :], n_pos)
    t2 = dq.dq_transform_point(wf.dqs[reg_idx], n_pos)
    e = torch.abs(_norm(t1 - t2))
    w = torch.where(e <= psi_reg, 1.0, psi_reg / torch.clamp_min(e, 1e-30))
    return w[:, -1]


def _dense_reg_normal(reg_idx, edge_mask, D: int):
    """A_reg = M^T M, M the masked edge incidence rows onehot(j) -
    onehot(n); self-edges vanish."""
    eye = torch.eye(D, dtype=torch.float32, device=reg_idx.device)
    A = torch.zeros((D, D), dtype=torch.float32, device=reg_idx.device)
    for r in range(reg_idx.shape[1]):
        M = (eye[reg_idx[:, r]] - eye) * edge_mask[:, r, None]
        A = A + M.T @ M
    return A


def build_graphs(wf: wfield.WarpField, canonical_v, knn_k: int = wfield.KNN):
    """Data graph: each vertex and its K nearest nodes; reg graph: each
    node and its K nearest nodes, itself first (opt_solver.cpp:56-105)."""
    data_idx, _ = wfield.find_neighbors(wf, canonical_v, knn_k)
    reg_idx, _ = wfield.find_neighbors(wf, wf.pos, knn_k)
    return data_idx, reg_idx


def _matvec(M, q):
    return torch.sum(M[:, :, None] * q[None, :, :], dim=1)


def data_normal(data_idx, data_w, s2, delta, D: int):
    """(A, b, c0): the data Gram (the kernel) and the data cost c0 = sum
    s2 |delta|^2, summed in float64 and rounded once."""
    A, b = gram_cuda.data_normal(data_idx, data_w, s2, delta, D)
    return A, b, data_cost64(s2, delta).to(torch.float32)


def data_cost64(s2, delta):
    """sum s2 |delta|^2 in float64."""
    d = delta.to(torch.float64)
    return torch.sum(s2.to(torch.float64)[:, None] * d * d)


def pcg(A, b, x0, linear_iter: int, cg_tol: float, matvec=_matvec):
    """Jacobi-preconditioned CG on A x = b, for b of shape (n,) or (n, c)
    (each column a right-hand side sharing one step size): (x,
    iterations). The tolerance is checked on the host once per trip of 8
    steps, as the source's while_loop does; inside a trip the `active` mask
    freezes a converged state, so the iteration count equals the
    source's."""
    diag = torch.diagonal(A)
    inv_diag = torch.where(diag > 0, 1.0 / torch.clamp_min(diag, 1e-30), 0.0)
    inv_diag = inv_diag.reshape(b.shape[:1] + (1,) * (b.dim() - 1))
    x = x0
    r = b - matvec(A, x)
    z = inv_diag * r
    p = z
    rz = torch.sum(r * z)
    i = torch.zeros((), dtype=torch.int32, device=A.device)
    while bool((i < linear_iter) & (rz > cg_tol)):
        for _ in range(_UNROLL):
            active = rz > cg_tol  # freezes converged state inside the trip
            ap = matvec(A, p)
            denom = torch.sum(p * ap)
            alpha = torch.where(denom > 0, rz / torch.clamp_min(denom, 1e-30),
                                0.0)
            x2 = x + alpha * p
            r2 = r - alpha * ap
            z2 = inv_diag * r2
            rz_new = torch.sum(r2 * z2)
            beta = torch.where(rz > 0, rz_new / torch.clamp_min(rz, 1e-30),
                               0.0)
            p2 = z2 + beta * p
            x = torch.where(active, x2, x)
            r = torch.where(active, r2, r)
            z = torch.where(active, z2, z)
            p = torch.where(active, p2, p)
            rz = torch.where(active, rz_new, rz)
            i = i + active.to(torch.int32)
    return x, i


def solve(wf: wfield.WarpField, canonical_v, live_v, vert_mask=None, *,
          graph_w=None, graph=None, tukey_offset: float = 4.652,
          psi_data: float = 0.01, lambda_reg: float = 200.0,
          psi_reg: float = 1e-4, linear_iter: int = 256,
          cg_tol: float = 1e-12, knn_k: int = wfield.KNN,
          nonlinear_iter: int = 16, num_iter: int = 24,
          early_out: bool = True, min_update: float = 0.0,
          max_update: float = 0.0, data_normal_fn=data_normal):
    """One warp solve: (updated WarpField, SolveStats).

    graph_w = (data_idx, data_w, warped) hands in prefetched data-graph rows
    (the parity engine fetches them with the correspondence); graph =
    (data_idx, n_pos, n_w, n_valid, warped) the neighbour pass the fusion
    frame already ran; otherwise the k-NN and the DQB warp of `canonical_v`
    run here. With early_out the outer loop stops after its first iteration
    (the reference's only mode); without, each outer iteration re-weights
    from the current estimate. Fusion mode gates the result: min_update
    soft-thresholds each node's step (|t| <= min_update -> 0, larger steps
    shrink by it), max_update rejects a step longer than it.
    data_normal_fn(data_idx, data_w, s2, delta, D) -> (A, b, c0) assembles
    the data term (`data_normal`)."""
    dev = wf.pos.device
    canonical_v = torch.as_tensor(canonical_v, dtype=torch.float32,
                                  device=dev)
    live_v = torch.as_tensor(live_v, dtype=torch.float32, device=dev)
    N, D = canonical_v.shape[0], wf.capacity
    if vert_mask is None:
        vert_mask = torch.ones((N,), dtype=torch.bool, device=dev)

    if graph_w is not None:
        data_idx, data_w, warped = graph_w
        data_idx = data_idx.to(torch.int32)
    else:
        if graph is None:
            data_idx, _, n_pos, n_dq, n_w, n_valid = wfield.neighbor_features(
                wf, canonical_v, knn_k)
            blend = wfield._dqb_from_features(canonical_v, n_pos, n_dq, n_w,
                                              n_valid)
            warped = dq.dq_transform_point(blend, canonical_v)
        else:
            data_idx, n_pos, n_w, n_valid, warped = graph
        data_w = wfield.transformation_weights(n_pos, n_w,
                                               canonical_v[:, None, :])
        data_w = torch.where(n_valid, data_w, 0.0)
    data_idx = data_idx.to(torch.int32).contiguous()
    data_w = data_w.contiguous()
    reg_idx, _ = wfield.find_neighbors(wf, wf.pos, knn_k)

    s2 = tukey_biweights(warped, live_v, tukey_offset, psi_data)
    s2 = torch.where(vert_mask, s2, 0.0)

    D_active = torch.clamp_min(wf.count.to(torch.float32), 1.0)
    reg_w2 = lambda_reg / (D_active * knn_k)
    edge_mask = (wf.mask[:, None] & wf.mask[reg_idx]).to(torch.float32)
    delta = (live_v - canonical_v).contiguous()
    A_reg = _dense_reg_normal(reg_idx, edge_mask, D)

    def assemble_and_solve(s2_k, t_init):
        A_data, b, c0 = data_normal_fn(data_idx, data_w, s2_k.contiguous(),
                                       delta, D)
        A = A_data + reg_w2 * A_reg
        # inner nonlinear loop: the energy is linear in t, so each
        # warm-started restart sees the same system
        t = t_init
        for _ in range(max(nonlinear_iter - 1, 0)):
            t, _ = pcg(A, b, t, linear_iter, cg_tol)
        t, iters = pcg(A, b, t, linear_iter, cg_tol)
        costt = c0 - 2.0 * torch.sum(t * b) + torch.sum(t * _matvec(A, t))
        return t, iters, c0, costt

    def huber_mean(t_cur):
        wf_cur = wfield.compose_translations(
            wf, torch.where(wf.mask[:, None], t_cur, 0.0))
        hw = huber_weights(wf_cur, reg_idx, psi_reg)
        m = wf.mask.to(torch.float32)
        return torch.sum(hw * m) / torch.clamp_min(torch.sum(m), 1.0)

    zeros = torch.zeros((D, 3), dtype=torch.float32, device=dev)
    mean_huber = huber_mean(zeros)
    t, iters, initial_cost, costt = assemble_and_solve(s2, zeros)
    for _ in range((1 if early_out else num_iter) - 1):
        idx = data_idx.to(torch.int64)
        warped_k = warped + torch.sum(data_w[..., None] * t[idx], dim=1)
        s2_k = torch.where(vert_mask, tukey_biweights(
            warped_k, live_v, tukey_offset, psi_data), 0.0)
        mean_huber = huber_mean(t)
        t, iters, _, costt = assemble_and_solve(s2_k, t)

    stats = SolveStats(initial_cost, costt, iters, mean_huber)
    t = torch.where(wf.mask[:, None], t, 0.0)
    if min_update > 0.0:
        norm = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
        t = t * torch.clamp_min(
            1.0 - min_update / torch.clamp_min(norm, 1e-12), 0.0)
    if max_update > 0.0:
        norm = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
        t = torch.where(norm <= max_update, t, 0.0)
    return wfield.compose_translations(wf, t), stats
