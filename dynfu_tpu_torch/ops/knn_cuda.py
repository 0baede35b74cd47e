"""k-NN against nodes with a feature fetch: CUDA wrapper and plain version.

Replaces knn_gather_tpu (dynfu_tpu/ops/knn_pallas.py:73). Kernel source:
csrc/knn.cu (the pruned selection shared with the fused warp:
csrc/topk.cuh; ops/warp_cuda.group_candidates models its candidate lists).

Selection rule, kernel and plain alike: ascending squared distance, ties to
the lower node index; masked nodes sit at (FAR, FAR, FAR) — a huge finite
distance — so they are chosen only when fewer than k nodes are valid (the
fetched mask column then marks them invalid); a query with a non-finite
coordinate gets slots 0..k-1 at +inf.
"""

from __future__ import annotations

import ctypes

import torch

from dynfu_tpu_torch import kernels

FAR = 1e9  # masked node coordinate (knn_pallas.py:35 of the source)


def masked_sqdist(queries: torch.Tensor, points: torch.Tensor,
                  point_mask: torch.Tensor) -> torch.Tensor:
    """(Q, D) squared distances in the kernels' operation order; NaN ranks
    as +inf."""
    pts = torch.where(point_mask[:, None], points, FAR)
    dx = pts[None, :, 0] - queries[:, 0:1]
    dy = pts[None, :, 1] - queries[:, 1:2]
    dz = pts[None, :, 2] - queries[:, 2:3]
    d = dx * dx + dy * dy + dz * dz
    return torch.where(torch.isnan(d), torch.inf, d)


def select_k(queries, points, point_mask, k: int):
    """(idx (Q, k) int64, sqd (Q, k)): the k smallest of each row in
    (distance, index) order — a stable sort of the row."""
    d = masked_sqdist(queries, points, point_mask)
    sqd, idx = torch.sort(d, dim=1, stable=True)
    return idx[:, :k], sqd[:, :k]


def knn_gather_plain(queries, points, k: int, table, point_mask):
    kernels.count_plain(knn_gather_plain, queries)
    idx, sqd = select_k(queries, points, point_mask, k)
    return idx.to(torch.int32), sqd, table[idx]


knn_gather_plain.cuda_calls = 0


def launch_info(Q: int, D: int) -> dict:
    """The kernel's launch for Q queries and D slots, as its own launch code
    picks it: threads per block, blocks and resident blocks per SM; on the
    card only."""
    out = (ctypes.c_int * 3)()
    kernels.check(kernels.load().dynfu_knn_launch(Q, D, out), "knn_launch")
    return dict(threads=out[0], blocks=out[1], blocks_per_sm=out[2])


def knn_gather(queries: torch.Tensor, points: torch.Tensor, k: int,
               table: torch.Tensor, point_mask: torch.Tensor):
    """queries (Q, 3) f32, points (D, 3) f32, table (D, F) f32, point_mask
    (D,) bool -> (idx (Q, k) int32, sqd (Q, k) f32, feats (Q, k, F) f32)."""
    if not kernels.on_cuda(queries, "knn_gather"):
        return knn_gather_plain(queries, points, k, table, point_mask)
    Q, D, F = queries.shape[0], points.shape[0], table.shape[1]
    dev = queries.device
    kernels.require(queries, "queries", torch.float32, (Q, 3), dev)
    kernels.require(points, "points", torch.float32, (D, 3), dev)
    kernels.require(table, "table", torch.float32, (D, F), dev)
    kernels.require(point_mask, "point_mask", torch.bool, (D,), dev)
    if not (1 <= k <= 8 and k <= D <= 8192):
        raise ValueError(f"knn_gather: need 1 <= k <= 8 and k <= D <= 8192, "
                         f"got k={k}, D={D}")
    idx = torch.empty((Q, k), dtype=torch.int32, device=dev)
    sqd = torch.empty((Q, k), dtype=torch.float32, device=dev)
    feats = torch.empty((Q, k, F), dtype=torch.float32, device=dev)
    if Q == 0:
        return idx, sqd, feats
    lib = kernels.load()
    kernels.check(lib.dynfu_knn_gather(
        queries.data_ptr(), points.data_ptr(), point_mask.data_ptr(),
        table.data_ptr(), Q, D, F, k, idx.data_ptr(), sqd.data_ptr(),
        feats.data_ptr(), kernels.stream(queries)), "knn_gather")
    knn_gather.launches += 1
    return idx, sqd, feats


knn_gather.launches = 0
