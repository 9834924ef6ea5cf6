"""The keyed state store and its bulk restore — the port's copy of the parts
of ``surge_tpu/store`` a cold start uses."""

from surge_tpu_torch.store.kv import InMemoryKeyValueStore, KeyValueStore
from surge_tpu_torch.store.restore import (
    RestoreResult,
    restore_from_events,
    restore_from_segment,
    restore_from_state_topic,
)

__all__ = ["InMemoryKeyValueStore", "KeyValueStore", "RestoreResult",
           "restore_from_events", "restore_from_segment",
           "restore_from_state_topic"]
