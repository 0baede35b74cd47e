"""SE(3) rigid transforms as (R (3, 3), t (3,)) tensor pairs.

Port of the subset of dynfu_tpu/core/se3.py the parity frame loop uses.
"""

from __future__ import annotations

import torch


def identity(device=None, dtype=torch.float32):
    return (torch.eye(3, dtype=dtype, device=device),
            torch.zeros(3, dtype=dtype, device=device))


def compose(a, b):
    """a after b: (Ra Rb, Ra tb + ta)."""
    Ra, ta = a
    Rb, tb = b
    return Ra @ Rb, Ra @ tb + ta


def inverse(a):
    R, t = a
    Rinv = R.T
    return Rinv, -(Rinv @ t)
