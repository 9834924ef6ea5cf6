"""Test support — the port's copy of ``surge_tpu/testing/faults.py`` (the fault
plane the engine hands its resident plane)."""
