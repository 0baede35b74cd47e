"""Pinhole camera intrinsics.

Port of the Intr dataclass of dynfu_tpu/core/camera.py (kfusion::Intr),
with its pyramid-level scaling.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Intr:
    fx: float
    fy: float
    cx: float
    cy: float

    def level(self, index: int) -> "Intr":
        """The intrinsics of pyramid level `index` (precomp.cpp:10-13):
        focal lengths and centre divided by 2**index."""
        div = 1 << index
        return Intr(self.fx / div, self.fy / div, self.cx / div,
                    self.cy / div)
