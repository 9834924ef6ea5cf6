"""Observability — the port's copy of ``surge_tpu/observability/flight.py`` (the
engine's flight recorder)."""
