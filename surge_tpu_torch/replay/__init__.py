"""Batched replay on the device (see surge_tpu_torch.replay.engine)."""

from surge_tpu_torch.replay.mixed import MixedReplay, combine_replay_specs

__all__ = ["MixedReplay", "combine_replay_specs"]
