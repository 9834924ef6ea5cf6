"""Pluggable key-value store backing the materialized state.

The plugin seam mirrors ``SurgeKafkaStreamsPersistencePlugin`` (modules/common/src/main/
scala/surge/kafka/streams/SurgeKafkaStreamsPersistencePlugin.scala:12-51 — RocksDB by
default, loadable by name from ``surge.kafka-streams.state-store-plugin``). Backends here:
``memory`` (dict), and ``native`` (the C++ mmap store in ``csrc/``, loaded via ctypes)
selected by ``surge.state-store.backend``.

The port's copy of ``surge_tpu/store/kv.py``. The native store is a host
library the port has not taken yet: ``native`` raises, naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Protocol, Tuple

from surge_tpu_torch.common import ENGINE_WAITING


class KeyValueStore(Protocol):
    """Byte-oriented KV contract (ReadOnlyKeyValueStore + write side)."""

    def get(self, key: str) -> Optional[bytes]: ...

    def put(self, key: str, value: bytes) -> None: ...

    def delete(self, key: str) -> None: ...

    def all_items(self) -> Iterator[Tuple[str, bytes]]: ...

    def range_items(self, start: str, stop: str) -> Iterator[Tuple[str, bytes]]:
        """Keys in ``[start, stop]`` (inclusive, like ReadOnlyKeyValueStore.range)."""

    def approximate_num_entries(self) -> int: ...

    def clear(self) -> None: ...


class InMemoryKeyValueStore:
    """Dict-backed store (the in-memory persistence plugin analog)."""

    def __init__(self) -> None:
        self._data: Dict[str, bytes] = {}

    def get(self, key: str) -> Optional[bytes]:
        return self._data.get(key)

    def put(self, key: str, value: bytes) -> None:
        self._data[key] = value

    def delete(self, key: str) -> None:
        self._data.pop(key, None)

    def all_items(self) -> Iterator[Tuple[str, bytes]]:
        return iter(sorted(self._data.items()))

    def range_items(self, start: str, stop: str) -> Iterator[Tuple[str, bytes]]:
        return iter((k, v) for k, v in sorted(self._data.items()) if start <= k <= stop)

    def approximate_num_entries(self) -> int:
        return len(self._data)

    def clear(self) -> None:
        self._data.clear()


def create_store(backend: str) -> KeyValueStore:
    """Backend selection by config name (plugin-loader analog,
    SurgeKafkaStreamsPersistencePluginLoader.load:30-51)."""
    if backend == "memory":
        return InMemoryKeyValueStore()
    if backend == "native":
        # the port differs here: the reference falls back to the dict store
        # when its C++ library is unbuilt; the port has no such library yet
        # and says so
        raise NotImplementedError(
            "surge.state-store.backend = native (store/native.py) is not "
            f"ported yet ({ENGINE_WAITING})")
    raise ValueError(f"unknown state-store backend {backend!r}")
