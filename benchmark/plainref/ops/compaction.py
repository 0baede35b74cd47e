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

The source's packed words themselves are kept for its integrate's bit
planes (`pack_columns`, `pair_and_z`, `unpack_columns`): torch.uint32
words, bit z of word w = element 32w + z, built and read byte by byte (a
little-endian word's byte k holds bits 8k..8k+7), since torch shifts no
uint32.
Every function reads the mask's true count back to the host once
(`torch.nonzero` has a data-dependent size).

On a block of a volume sharded along x (dist/), `prefix` applies the
capacities globally: prefix(counts) all-gathers this block's counts and
returns, per count, the sum over the blocks before it (in rank order, the
scan order) and over all blocks. A block then keeps exactly what the whole
volume's compaction keeps of it, under overflow too: the columns (words)
past the global column (word) cap, then the cells past `max_out`. Its
`n_total` and `n_captured` stay the block's own.
"""

from __future__ import annotations

import torch


def rank_select(mask: torch.Tensor, size: int, fill: int,
                prefix=None) -> torch.Tensor:
    """First `size` True indices of a 1-D mask, ascending, `fill` padded
    (int64); with `prefix`, the first size - (set positions of the blocks
    before) of them."""
    idx = torch.nonzero(mask).reshape(-1)
    if prefix is not None:
        before, _ = prefix([idx.shape[0]])
        idx = idx[:max(0, size - before[0])]
    idx = idx[:size]
    out = torch.full((size,), fill, dtype=torch.int64, device=mask.device)
    out[:idx.shape[0]] = idx
    return out


def _place(flat: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    out = torch.full((size,), fill, dtype=torch.int64, device=flat.device)
    out[:flat.shape[0]] = flat
    return out


def _block_caps(prefix, n_units: int, n_cells, max_units: int,
                max_out: int):
    """The capacities left to a block: (units (columns or words), cells).
    A block before this one that hit the unit cap leaves it no unit, so the
    cells of the blocks before it are all kept ones."""
    before, _ = prefix([n_units, n_cells])
    return (max(0, min(n_units, max_units - before[0])),
            max(0, max_out - before[1]))


def extract_columns(occ: torch.Tensor, *, per_column: int, max_cols: int,
                    max_out: int, row_stride: int, fill: int, prefix=None):
    """occ (ncols, Z) bool -> (flat_idx (max_out,) int64 = column * row_stride
    + z, ascending, `fill` padded; n_total set cells () int32; n_captured ()
    int32). Overflow of any capacity surfaces as n_captured < n_total."""
    n_total = occ.sum(dtype=torch.int32)
    cols = torch.nonzero(occ.any(dim=1)).reshape(-1)
    out_cap = max_out
    if prefix is None:
        cols = cols[:max_cols]
    sub = occ[cols]  # (n_cols, Z)
    rank = torch.cumsum(sub, dim=1, dtype=torch.int32)  # 1-based, inclusive
    keep = sub & (rank <= per_column)
    if prefix is not None:
        n_cols, out_cap = _block_caps(prefix, cols.shape[0], int(keep.sum()),
                                      max_cols, max_out)
        cols, keep = cols[:n_cols], keep[:n_cols]
    nz = torch.nonzero(keep)[:out_cap]  # row-major: ascending (column, z)
    flat = cols[nz[:, 0]] * row_stride + nz[:, 1]
    n_captured = torch.clamp_max(keep.sum(dtype=torch.int32), out_cap)
    return _place(flat, max_out, fill), n_total, n_captured


def extract_bits(occ: torch.Tensor, *, max_out: int, row_stride: int,
                 fill: int, max_words: int = 0, prefix=None):
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
    widx = torch.nonzero(words.any(dim=1)).reshape(-1)
    out_cap = max_out
    if prefix is None:
        widx = widx[:max_words]
    sel = words[widx]  # (n_words, 32)
    if prefix is not None:
        n_words, out_cap = _block_caps(prefix, widx.shape[0], int(sel.sum()),
                                       max_words, max_out)
        widx, sel = widx[:n_words], sel[:n_words]
    nz = torch.nonzero(sel)[:out_cap]  # ascending (word, bit)
    w = widx[nz[:, 0]]
    c = torch.div(w, nwords, rounding_mode="floor")
    flat = c * row_stride + (w - c * nwords) * 32 + nz[:, 1]
    n_captured = torch.clamp_max(sel.sum(dtype=torch.int32), out_cap)
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


_BYTE_BITS = (1 << torch.arange(8)).to(torch.uint8)


def pack_columns(bits: torch.Tensor) -> torch.Tensor:
    """(..., Z) bool -> (..., ceil(Z/32)) uint32, bit z of word w = element
    32w + z; padding bits (beyond Z) zero (dynfu_tpu/ops/compaction.py:37)."""
    Z = bits.shape[-1]
    nw = (Z + 31) // 32
    b = torch.cat([bits, bits.new_zeros(bits.shape[:-1] + (nw * 32 - Z,))],
                  -1).to(torch.uint8)
    b = b.reshape(bits.shape[:-1] + (nw * 4, 8))
    byte = (b * _BYTE_BITS.to(b.device)).sum(-1, dtype=torch.uint8)
    return byte.contiguous().view(torch.uint32)


def unpack_columns(words: torch.Tensor, Z: int) -> torch.Tensor:
    """pack_columns' inverse: (..., nw) uint32 -> (..., Z) bool."""
    byte = words.contiguous().view(torch.uint8)[..., None]
    bits = (byte & _BYTE_BITS.to(byte.device)) != 0
    return bits.reshape(words.shape[:-1] + (-1,))[..., :Z]


def pair_and_z(w: torch.Tensor) -> torch.Tensor:
    """bit z := bit z AND bit z+1, carried across words (a 2-point z
    stencil: cell occupancy from corner bits); uint32 words."""
    w = w.to(torch.int64)
    nxt = torch.cat([w[..., 1:], torch.zeros_like(w[..., :1])], -1)
    down = (w >> 1) | ((nxt << 31) & 0xFFFFFFFF)
    return (w & down).to(torch.uint32)
