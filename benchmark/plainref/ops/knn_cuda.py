"""k-NN against nodes with a feature fetch, the plain version.

The port's wrapper launches csrc/knn.cu on the card; here every call takes
the plain version.

Selection rule, kernel and plain alike: ascending squared distance, ties to
the lower node index; masked nodes sit at (FAR, FAR, FAR) — a huge finite
distance — so they are chosen only when fewer than k nodes are valid (the
fetched mask column then marks them invalid); a query with a non-finite
coordinate gets slots 0..k-1 at +inf.
"""

from __future__ import annotations

import torch

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


def knn_gather(queries: torch.Tensor, points: torch.Tensor, k: int,
               table: torch.Tensor, point_mask: torch.Tensor):
    """queries (Q, 3) f32, points (D, 3) f32, table (D, F) f32, point_mask
    (D,) bool -> (idx (Q, k) int32, sqd (Q, k) f32, feats (Q, k, F) f32)."""
    idx, sqd = select_k(queries, points, point_mask, k)
    return idx.to(torch.int32), sqd, table[idx]
