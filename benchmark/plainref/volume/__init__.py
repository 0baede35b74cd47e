"""volume subpackage of the PyTorch port (see plainref/__init__.py)."""

from plainref.volume.tsdf import (  # noqa: F401
    TsdfConfig,
    TsdfVolume,
    apply_affine,
    clear,
    create,
    extract_cloud,
    extract_normals,
    integrate,
    integrate_rotated,
    integrate_separable,
    interpolate,
    raycast,
    raycast_depth,
    raycast_march,
    raycast_rotated,
    raycast_separable,
    set_pose,
)
