"""Marching-cubes triangle pack, the plain version.

The port's wrapper launches csrc/pack_triangles.cu on the card; here every
call takes the plain version.
"""

from __future__ import annotations

import torch


def pack_triangles(tris: torch.Tensor, t_offsets: torch.Tensor,
                   n_tris: torch.Tensor, max_tris: int) -> torch.Tensor:
    """tris (M, 5, 9) f32, t_offsets (M,) i32 exclusive cumsum of n_tris,
    n_tris (M,) i32 in 0..5 -> (max_tris, 9) f32 triangle stream: row
    j < n_tris[c] of cell c goes to row t_offsets[c] + j of the stream; rows past max_tris drop, and rows at or past the
    total count are zero (mc.py:289-297 of the source)."""
    M = tris.shape[0]
    slot = torch.arange(5, device=tris.device)[None, :]
    tgt = t_offsets.to(torch.int64)[:, None] + slot
    tgt = torch.where((slot < n_tris[:, None]) & (tgt < max_tris), tgt,
                      max_tris)
    out = torch.zeros((max_tris + 1, 9), dtype=torch.float32,
                      device=tris.device)
    out[tgt.reshape(-1)] = tris.reshape(M * 5, 9)  # duplicates only at the
    return out[:max_tris]                          # discarded row max_tris
