"""mesh subpackage of the PyTorch port (see plainref/__init__.py)."""

from plainref.mesh.mc import MAX_TRIANGLES, marching_cubes  # noqa: F401
