"""See the package docstring of surge_tpu_torch."""
