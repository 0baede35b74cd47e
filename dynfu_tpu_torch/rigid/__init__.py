"""Rigid camera tracking (projective ICP)."""
