"""engine subpackage of the PyTorch port (see plainref/__init__.py)."""

from plainref.engine.params import DynFuParams, KinFuParams  # noqa: F401
