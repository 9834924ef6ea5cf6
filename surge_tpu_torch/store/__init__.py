"""Materialized aggregate-state store — the port's copy of the parts of
``surge_tpu/store`` the engine reaches: the KV store, the state-store indexer
and the bulk restores. Checkpoints (``store/checkpoint.py``) are not ported."""

from surge_tpu_torch.store.kv import InMemoryKeyValueStore, KeyValueStore
from surge_tpu_torch.store.indexer import StateStoreIndexer
from surge_tpu_torch.store.restore import (
    RestoreResult,
    restore_from_events,
    restore_from_segment,
    restore_from_state_topic,
)

__all__ = ["InMemoryKeyValueStore", "KeyValueStore", "RestoreResult",
           "StateStoreIndexer", "restore_from_events", "restore_from_segment",
           "restore_from_state_topic"]
