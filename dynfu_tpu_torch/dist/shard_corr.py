"""The tiered x-window 1-NN over row-sharded queries.

Port of dynfu_tpu/dist/shard_corr.py:25-83. The queries are row-sharded,
the point set (the warped canonical) is replicated, and each rank runs the
whole tiered correspondence (ops/knn.nn1_gather_xwindow: the 1-NN kernel,
the escalate pass, the brute-force rescue) on its rows. Each query's answer
is its own, so the stitched result is the single card's wherever the tier
capacities hold; as in the source, the capacities apply per rank.

The sharded engine frame needs no wrapper: its live set is each block's
vertices already, and the call on it is knn.nn1_gather_xwindow with the
graph payload (engine/dynfusion._correspondence), computed per rank from
the replicated points.
"""

from __future__ import annotations

import torch

from dynfu_tpu_torch.dist import spmd
from dynfu_tpu_torch.ops import knn


def nn1_xwindow_sharded(mesh: spmd.Mesh, queries, points, point_mask,
                        query_mask, values=None, window_blocks: int = 3,
                        escalate: int = 0, rescue: int = 0):
    """(vals (Q, F), exact (Q,)) of every query, on every rank; rank r
    answers rows mesh.block(Q)."""
    n = queries.shape[0]
    lo, hi = mesh.block(n)
    vals, exact = knn.nn1_gather_xwindow(
        queries[lo:hi], points, values, point_mask, query_mask[lo:hi],
        window_blocks=window_blocks, escalate=escalate, rescue=rescue)
    both = spmd.all_gather_rows(
        torch.cat([vals, exact[:, None].to(vals.dtype)], 1), mesh, n)
    return both[:, :-1], both[:, -1] > 0.5
