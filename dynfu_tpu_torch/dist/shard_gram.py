"""The GN data Grams over row-sharded data rows, reduced in rank order.

Port of dynfu_tpu/dist/shard_gram.py:19-60, whose shard_map runs the Gram
kernel per device and reduces (A, b) with one psum. That psum's order is
the collective's own, and a float32 partial sum changes last bits, which
the parity run's 41 solves turn into tenths of a millimetre (ROADMAP F3).
So here each rank assembles its rows' Gram with the data Gram kernel in
its float64 partial mode (solver/gram_cuda.data_normal(partial=True): the
sums before the final rounding), with the data cost c0 of its rows in
float64; one all_gather brings every rank's partials, which each rank adds
in rank order and rounds once to float32. Every rank gets the same bits,
and they are the single card's but where a float64 sum in another order
rounds to another float32 (a tie).

The SE(3) solve's sums (fusion mode) are reduced the same way: each rank's
monomial Grams in their float64 partial mode
(gram_cuda.monomial_grams(partial=True)) with its rows' data cost, one
reduction per relinearisation (10 D^2 + 6 D + 1 float64 values: 33 MB a
rank at D = 640), and the cost of a trial step, one more.
"""

from __future__ import annotations

import torch

from dynfu_tpu_torch.dist import spmd
from dynfu_tpu_torch.solver import gn, gram_cuda
from dynfu_tpu_torch.solver import se3 as se3_solver


def reduce_rank_order(t: torch.Tensor, mesh: spmd.Mesh) -> torch.Tensor:
    """Every rank's float64 `t`, added in rank order, rounded to float32."""
    parts = spmd.all_gather(t, mesh)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out.to(torch.float32)


def data_normal_fn(mesh: spmd.Mesh):
    """gn.solve's data_normal_fn over this rank's rows: (A, b, c0) of all
    ranks' rows."""
    def fn(data_idx, data_w, s2, delta, D: int):
        A, b = gram_cuda.data_normal(data_idx, data_w, s2, delta, D,
                                     partial=True)
        c0 = gn.data_cost64(s2, delta)
        flat = reduce_rank_order(
            torch.cat([A.reshape(-1), b.reshape(-1), c0.reshape(1)]), mesh)
        return (flat[:D * D].reshape(D, D),
                flat[D * D:D * D + 3 * D].reshape(D, 3), flat[-1])

    return fn


def monomial_grams_fn(mesh: spmd.Mesh) -> se3_solver.DataTerm:
    """se3.solve's data term over this rank's rows: (B, Bu, Bw, cost) and
    the cost of all ranks' rows."""
    def grams(data_idx, data_w, s2, y_c, delta, D: int):
        B, Bu, Bw = gram_cuda.monomial_grams(data_idx, data_w, s2, y_c,
                                             delta, D, partial=True)
        flat = reduce_rank_order(torch.cat(
            [B.reshape(-1), Bu.reshape(-1), Bw.reshape(-1),
             gn.data_cost64(s2, delta).reshape(1)]), mesh)
        n = 10 * D * D
        return (flat[:n].reshape(10, D, D),
                flat[n:n + 3 * D].reshape(D, 3),
                flat[n + 3 * D:n + 6 * D].reshape(D, 3), flat[-1])

    def cost(s2, delta):
        return reduce_rank_order(gn.data_cost64(s2, delta).reshape(1),
                                 mesh)[0]

    return se3_solver.DataTerm(grams=grams, cost=cost)


def monomial_grams_sharded(mesh: spmd.Mesh, data_idx, data_w, s2, y, delta,
                           D: int):
    """(B, Bu, Bw) of every row, on every rank; rank r assembles rows
    mesh.block(N)."""
    lo, hi = mesh.block(data_idx.shape[0])
    B, Bu, Bw, _ = monomial_grams_fn(mesh).grams(
        *(t[lo:hi].contiguous() for t in (data_idx, data_w, s2, y, delta)),
        D)
    return B, Bu, Bw


def data_normal_sharded(mesh: spmd.Mesh, data_idx, data_w, s2, delta,
                        D: int):
    """(A (D, D), b (D, 3)) of every row, on every rank; rank r assembles
    rows mesh.block(N)."""
    lo, hi = mesh.block(data_idx.shape[0])
    A, b, _ = data_normal_fn(mesh)(
        data_idx[lo:hi].contiguous(), data_w[lo:hi].contiguous(),
        s2[lo:hi].contiguous(), delta[lo:hi].contiguous(), D)
    return A, b
