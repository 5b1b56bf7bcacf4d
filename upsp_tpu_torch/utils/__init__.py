"""See the package docstring of upsp_tpu_torch."""
