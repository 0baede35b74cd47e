"""core subpackage of the PyTorch port (see dynfu_tpu_torch/__init__.py)."""

from dynfu_tpu_torch.core import dualquat, se3  # noqa: F401
from dynfu_tpu_torch.core.camera import Intr  # noqa: F401
