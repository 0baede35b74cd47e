"""solver subpackage of the PyTorch port (see plainref/__init__.py)."""
