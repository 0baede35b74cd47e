"""Sums into indexed rows in one fixed order, on every device.

`torch.index_add` on a CUDA tensor adds floats with atomics, in arrival
order, so its last bits change from run to run; a solve built on such sums
(the SE(3) reg normal equations, node insertion's cell centroids) then
gives other results on every run. `index_add` here sums each destination's
terms in one order fixed by the index: on the CPU `index_add_` adds in
index order; on a CUDA tensor `index_put_(..., accumulate=True)` sorts the
indices and adds each destination's run serially, starting from its
current value, so it gives the same bits on every call
(tests/test_torch_fusion.py checks that on the card).
"""

from __future__ import annotations

import torch


def index_add(base: torch.Tensor, index: torch.Tensor,
              values: torch.Tensor) -> torch.Tensor:
    """base with values[t] added to row index[t] (dim 0), out of place, each
    row's terms added in an order fixed by the index."""
    if base.device.type == "cuda":
        return base.index_put((index.to(torch.int64),), values,
                              accumulate=True)
    return base.index_add(0, index, values)
