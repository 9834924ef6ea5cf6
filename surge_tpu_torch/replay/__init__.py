"""Batched replay on the device (see surge_tpu_torch.replay.engine)."""
