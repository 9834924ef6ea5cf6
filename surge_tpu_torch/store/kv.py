"""The byte-oriented key-value store contract and its in-memory store — a
copy of ``KeyValueStore`` and ``InMemoryKeyValueStore`` from
``surge_tpu/store/kv.py``."""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Protocol, Tuple


class KeyValueStore(Protocol):
    """Byte-oriented KV contract (read side and write side)."""

    def get(self, key: str) -> Optional[bytes]: ...

    def put(self, key: str, value: bytes) -> None: ...

    def delete(self, key: str) -> None: ...

    def all_items(self) -> Iterator[Tuple[str, bytes]]: ...

    def range_items(self, start: str, stop: str) -> Iterator[Tuple[str, bytes]]:
        """Keys in ``[start, stop]`` (inclusive)."""

    def approximate_num_entries(self) -> int: ...

    def clear(self) -> None: ...


class InMemoryKeyValueStore:
    """Dict-backed store."""

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
