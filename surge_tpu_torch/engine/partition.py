"""Partitioning: key hashing, host assignments, and the partition tracker.

Reference semantics preserved exactly:

- ``partition_for_key`` = ``abs(murmur3_string_hash(key) % num_partitions)`` using
  Scala's ``MurmurHash3.stringHash`` (UTF-16 char-pair mixing, seed 0xf7ca7fd2) so a
  migrating application's aggregates land on the same partitions as under the reference
  (KafkaPartitioner.scala:7-9).
- ``PartitionStringUpToColon``: partition by the aggregate id up to the first ``:``
  (KafkaPartitioner.scala:35-42) — the default key→partition-string rule.
- ``PartitionAssignments.update`` returns the revoked/added diff per host
  (PartitionAssignments.scala:24-63) driving region lifecycle on rebalance.
- ``PartitionTracker``: single source of truth for partition→host assignments with
  registered listeners (KafkaConsumerStateTrackingActor.scala:39-118), re-expressed as a
  plain registry on the event loop (no actor ask needed).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from surge_tpu_torch.common import logger

_MASK32 = 0xFFFFFFFF
_STRING_SEED = 0xF7CA7FD2  # scala.util.hashing.MurmurHash3.stringSeed


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def _mix_k(k: int) -> int:
    k = (k * 0xCC9E2D51) & _MASK32
    k = _rotl32(k, 15)
    return (k * 0x1B873593) & _MASK32


def _mix(h: int, k: int) -> int:
    h ^= _mix_k(k)
    h = _rotl32(h, 13)
    return (h * 5 + 0xE6546B64) & _MASK32


def murmur3_string_hash(s: str) -> int:
    """Scala MurmurHash3.stringHash: mixes UTF-16 code units two at a time. Returns a
    signed 32-bit int (negative values possible, as on the JVM)."""
    h = _STRING_SEED
    # UTF-16 code units (JVM chars): astral code points become surrogate pairs, so
    # length and pair-mixing match the JVM exactly
    data = s.encode("utf-16-be")
    units = [(data[i] << 8) | data[i + 1] for i in range(0, len(data), 2)]
    i = 0
    n = len(units)
    while i + 1 < n:
        h = _mix(h, ((units[i] << 16) + units[i + 1]) & _MASK32)
        i += 2
    if i < n:
        h ^= _mix_k(units[i])  # mixLast: no rotate/multiply round
    # finalizeHash(h, length): xor length then avalanche
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _MASK32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _MASK32
    h ^= h >> 16
    return h - (1 << 32) if h >= (1 << 31) else h


def partition_for_key(key: str, num_partitions: int) -> int:
    """abs(hash % n) with JVM remainder semantics (KafkaPartitioner.scala:8)."""
    if num_partitions <= 0:
        raise ValueError("num_partitions must be positive")
    return abs(murmur3_string_hash(key)) % num_partitions


def partition_by_up_to_colon(aggregate_id: str) -> str:
    """Default partition-by rule (PartitionStringUpToColon, KafkaPartitioner.scala:35-42):
    ids like ``tenant:uuid`` co-locate per tenant."""
    idx = aggregate_id.find(":")
    return aggregate_id if idx < 0 else aggregate_id[:idx]


@dataclass(frozen=True, order=True)
class HostPort:
    """A node identity (PartitionAssignments.scala HostPort)."""

    host: str
    port: int

    def __str__(self) -> str:
        return f"{self.host}:{self.port}"


Assignments = Dict[HostPort, List[int]]  # host -> partitions (single topic family)


@dataclass(frozen=True)
class AssignmentChanges:
    """Revoked/added partitions per host (PartitionAssignmentChanges.diff)."""

    revoked: Mapping[HostPort, List[int]]
    added: Mapping[HostPort, List[int]]


def _missing(a: Assignments, b: Assignments) -> Dict[HostPort, List[int]]:
    return {hp: [p for p in parts if p not in b.get(hp, [])]
            for hp, parts in a.items()}


@dataclass
class PartitionAssignments:
    """Current cluster assignment map + diffing update (PartitionAssignments.scala:50-63)."""

    assignments: Assignments = field(default_factory=dict)
    _p2h: Optional[Dict[int, HostPort]] = field(default=None, repr=False, compare=False)

    def partition_to_host(self) -> Dict[int, HostPort]:
        # cached: instances are replaced wholesale by update(), and this sits on the
        # per-message routing hot path
        if self._p2h is None:
            self._p2h = {p: hp for hp, parts in self.assignments.items() for p in parts}
        return self._p2h

    def update(self, new: Assignments) -> Tuple["PartitionAssignments", AssignmentChanges]:
        changes = AssignmentChanges(revoked=_missing(self.assignments, new),
                                    added=_missing(new, self.assignments))
        return PartitionAssignments(dict(new)), changes


class PartitionTracker:
    """Assignment registry + listener broadcast (KafkaConsumerStateTrackingActor)."""

    def __init__(self) -> None:
        self._current = PartitionAssignments()
        self._listeners: List[Callable[[PartitionAssignments, AssignmentChanges], None]] = []

    @property
    def assignments(self) -> PartitionAssignments:
        return self._current

    def register(self, listener: Callable[[PartitionAssignments, AssignmentChanges], None],
                 replay_current: bool = True) -> None:
        """Register + immediately deliver the current state (the tracker actor sends
        the registry state to new listeners, KafkaConsumerStateTrackingActor.scala:70-83)."""
        self._listeners.append(listener)
        if replay_current and self._current.assignments:
            listener(self._current, AssignmentChanges(revoked={},
                                                      added=self._current.assignments))

    def unregister(self, listener: Callable[[PartitionAssignments, AssignmentChanges], None]) -> None:
        """Stop broadcasting to ``listener`` (a stopped router must not keep creating
        regions off a shared tracker)."""
        try:
            self._listeners.remove(listener)
        except ValueError:
            pass

    def update(self, new: Assignments) -> AssignmentChanges:
        self._current, changes = self._current.update(new)
        for fn in list(self._listeners):
            try:
                fn(self._current, changes)
            except Exception:  # noqa: BLE001 — one listener must not break the broadcast
                logger.exception("assignment listener failed")
        return changes
