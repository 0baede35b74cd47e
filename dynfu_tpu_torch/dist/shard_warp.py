"""The fused warp over row-sharded vertices.

Port of dynfu_tpu/dist/shard_warp.py:30-76. The warp is independent per
vertex and the node state is replicated, so each rank runs the fused warp
kernel (ops/warp_cuda.warp_fused) on its row range; one all_gather puts
the rows back together (the source's shard_map returns them row-sharded;
every consumer here, the correspondence and node insertion, reads all of
them).
"""

from __future__ import annotations

import torch

from dynfu_tpu_torch.dist import spmd
from dynfu_tpu_torch.ops import warp_cuda
from dynfu_tpu_torch.warp import field as wfield


def warp_points_normals_sharded(mesh: spmd.Mesh, wf: wfield.WarpField,
                                points: torch.Tensor, normals: torch.Tensor,
                                blend: str = "dqb", k: int = wfield.KNN):
    """(warped, warped_normals) of every row of (points, normals) (N, 3), on
    every rank; rank r warps rows mesh.block(N)."""
    n = points.shape[0]
    lo, hi = mesh.block(n)
    wp, wn, _, _ = warp_cuda.warp_fused(
        points[lo:hi].contiguous(), normals[lo:hi].contiguous(), wf.pos,
        wf.dqs, wf.w, wf.mask, k=k, blend=blend)
    both = spmd.all_gather_rows(torch.cat([wp, wn], 1), mesh, n)
    return both[:, :3], both[:, 3:]
