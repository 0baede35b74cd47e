"""Pinhole camera intrinsics.

Port of the Intr dataclass of dynfu_tpu/core/camera.py (kfusion::Intr).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Intr:
    fx: float
    fy: float
    cx: float
    cy: float
