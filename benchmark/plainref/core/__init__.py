"""core subpackage of the PyTorch port (see plainref/__init__.py)."""

from plainref.core import dualquat, se3  # noqa: F401
from plainref.core.camera import Intr  # noqa: F401
