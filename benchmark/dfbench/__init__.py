"""The benchmark harness of dynfu_tpu_torch (see benchmark/README.md)."""
