"""mesh subpackage of the PyTorch port (see dynfu_tpu_torch/__init__.py)."""

from dynfu_tpu_torch.mesh.mc import MAX_TRIANGLES, marching_cubes  # noqa: F401
