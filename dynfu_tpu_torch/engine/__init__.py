"""engine subpackage of the PyTorch port (see dynfu_tpu_torch/__init__.py)."""

from dynfu_tpu_torch.engine.params import DynFuParams, KinFuParams  # noqa: F401
