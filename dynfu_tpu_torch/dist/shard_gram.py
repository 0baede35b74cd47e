"""The GN data Gram over row-sharded data rows, reduced in rank order.

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
"""

from __future__ import annotations

import torch

from dynfu_tpu_torch.dist import spmd
from dynfu_tpu_torch.solver import gn, gram_cuda


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


def data_normal_sharded(mesh: spmd.Mesh, data_idx, data_w, s2, delta,
                        D: int):
    """(A (D, D), b (D, 3)) of every row, on every rank; rank r assembles
    rows mesh.block(N)."""
    lo, hi = mesh.block(data_idx.shape[0])
    A, b, _ = data_normal_fn(mesh)(
        data_idx[lo:hi].contiguous(), data_w[lo:hi].contiguous(),
        s2[lo:hi].contiguous(), delta[lo:hi].contiguous(), D)
    return A, b
