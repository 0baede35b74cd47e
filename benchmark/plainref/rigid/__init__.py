"""Rigid camera tracking (projective ICP)."""

from plainref.rigid.icp import build_pyramids, estimate_transform  # noqa: F401
