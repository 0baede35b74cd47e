"""Rigid camera tracking (projective ICP)."""

from dynfu_tpu_torch.rigid.icp import build_pyramids, estimate_transform  # noqa: F401
