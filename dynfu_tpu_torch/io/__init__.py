"""io subpackage of the PyTorch port (see dynfu_tpu_torch/__init__.py)."""
