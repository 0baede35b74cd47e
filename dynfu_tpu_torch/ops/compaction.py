"""Dense-mask compaction: boolean volumes and columns -> flat index lists.

Port of dynfu_tpu/ops/compaction.py. The source packs every z-column into
32-bit words and rank-selects them because XLA lowers `nonzero` as one
scatter per input element on a TPU. A GPU runs `torch.nonzero` as one
stream compaction, so here the masks stay dense `bool` tensors and only the
source's capacity rules are kept, so that the outputs and counters equal the
source's, overflow included:

* `extract_columns`: the first `per_column` set cells of each column, the
  first `max_cols` active columns, the first `max_out` cells;
* `extract_bits`: no per-column budget, but at most `max_words` active
  32-cell z-words are captured (a word is cells 32w .. 32w+31 of a column);
* `dilate_z` / `dilate_xy`: binary dilation by +-r along z, then along x and
  y (a (2r+1)^3 box), zero beyond the edges;
* `rank_select`: the first `size` set positions, padded with `fill`.

Output order is ascending (column, z): the dense row-major scan order.
Every function reads the mask's true count back to the host once
(`torch.nonzero` has a data-dependent size).
"""

from __future__ import annotations

import torch


def rank_select(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """First `size` True indices of a 1-D mask, ascending, `fill` padded
    (int64)."""
    idx = torch.nonzero(mask).reshape(-1)[:size]
    out = torch.full((size,), fill, dtype=torch.int64, device=mask.device)
    out[:idx.shape[0]] = idx
    return out


def _place(flat: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    out = torch.full((size,), fill, dtype=torch.int64, device=flat.device)
    out[:flat.shape[0]] = flat
    return out


def extract_columns(occ: torch.Tensor, *, per_column: int, max_cols: int,
                    max_out: int, row_stride: int, fill: int):
    """occ (ncols, Z) bool -> (flat_idx (max_out,) int64 = column * row_stride
    + z, ascending, `fill` padded; n_total set cells () int32; n_captured ()
    int32). Overflow of any capacity surfaces as n_captured < n_total."""
    n_total = occ.sum(dtype=torch.int32)
    cols = torch.nonzero(occ.any(dim=1)).reshape(-1)[:max_cols]
    sub = occ[cols]  # (n_cols, Z)
    rank = torch.cumsum(sub, dim=1, dtype=torch.int32)  # 1-based, inclusive
    keep = sub & (rank <= per_column)
    nz = torch.nonzero(keep)[:max_out]  # row-major: ascending (column, z)
    flat = cols[nz[:, 0]] * row_stride + nz[:, 1]
    n_captured = torch.clamp_max(keep.sum(dtype=torch.int32), max_out)
    return _place(flat, max_out, fill), n_total, n_captured


def extract_bits(occ: torch.Tensor, *, max_out: int, row_stride: int,
                 fill: int, max_words: int = 0):
    """occ (ncols, Z) bool -> (flat_idx (max_out,) int64, n_total () int32,
    n_captured () int32): every set cell of the first `max_words` active
    z-words (0 = max_out), the first `max_out` of them."""
    ncols, Z = occ.shape
    if max_words <= 0:
        max_words = max_out
    nwords = (Z + 31) // 32
    n_total = occ.sum(dtype=torch.int32)
    if nwords * 32 != Z:
        occ = torch.cat([occ, occ.new_zeros((ncols, nwords * 32 - Z))], 1)
    words = occ.reshape(ncols * nwords, 32)
    widx = torch.nonzero(words.any(dim=1)).reshape(-1)[:max_words]
    sel = words[widx]  # (n_words, 32)
    nz = torch.nonzero(sel)[:max_out]  # ascending (word, bit)
    w = widx[nz[:, 0]]
    c = torch.div(w, nwords, rounding_mode="floor")
    flat = c * row_stride + (w - c * nwords) * 32 + nz[:, 1]
    n_captured = torch.clamp_max(sel.sum(dtype=torch.int32), max_out)
    return _place(flat, max_out, fill), n_total, n_captured


def _dilate_axis(m: torch.Tensor, r: int, axis: int) -> torch.Tensor:
    out = m.clone()
    n = m.shape[axis]
    for s in range(1, min(r, n - 1) + 1):
        out.narrow(axis, s, n - s).logical_or_(m.narrow(axis, 0, n - s))
        out.narrow(axis, 0, n - s).logical_or_(m.narrow(axis, s, n - s))
    return out


def dilate_z(mask: torch.Tensor, r: int) -> torch.Tensor:
    """Binary dilation by +-r along the last axis (zero beyond the ends)."""
    return _dilate_axis(mask, r, mask.dim() - 1)


def dilate_xy(mask: torch.Tensor, r: int) -> torch.Tensor:
    """Binary dilation by +-r along axis 0, then along axis 1."""
    return _dilate_axis(_dilate_axis(mask, r, 0), r, 1)
