"""L0 serialization contracts.

Equivalent of the reference's ``modules/serialization``:
- ``SerializedMessage`` (key/value/headers) — serialization/src/main/scala/surge/core/SerializedMessage.scala:6
- ``SerializedAggregate`` — serialization/src/main/scala/surge/core/SerializedAggregate.scala:7
- ``SurgeAggregateReadFormatting`` / ``SurgeAggregateWriteFormatting`` /
  ``SurgeEventWriteFormatting`` — surge/core/SurgeFormatting.scala:5-17

These are pure byte-level contracts between user domain types and the log. The TPU build
adds a parallel *tensor* contract in ``surge_tpu_torch.codec`` (event→tensor codec) so the same
domain events have both a byte form (log/durability path) and a tensor form (replay path).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Callable, Generic, Mapping, Protocol, Sequence, TypeVar

State = TypeVar("State")
Event = TypeVar("Event")


@dataclass(frozen=True)
class SerializedMessage:
    """A serialized event destined for the events topic.

    Mirrors surge.core.SerializedMessage (key, value, headers) — SerializedMessage.scala:6.
    """

    key: str
    value: bytes
    headers: Mapping[str, str] = field(default_factory=dict)


@dataclass(frozen=True)
class SerializedAggregate:
    """A serialized aggregate state snapshot destined for the compacted state topic.

    Mirrors surge.core.SerializedAggregate — SerializedAggregate.scala:7. ``value=None``
    encodes deletion (tombstone on the compacted topic).
    """

    value: bytes | None
    headers: Mapping[str, str] = field(default_factory=dict)


class AggregateWriteFormatting(Protocol[State]):
    """surge.core.SurgeAggregateWriteFormatting — SurgeFormatting.scala:9-11."""

    def write_state(self, state: State | None) -> SerializedAggregate: ...


class AggregateReadFormatting(Protocol[State]):
    """surge.core.SurgeAggregateReadFormatting — SurgeFormatting.scala:5-7."""

    def read_state(self, data: bytes) -> State | None: ...


class EventWriteFormatting(Protocol[Event]):
    """surge.core.SurgeEventWriteFormatting — SurgeFormatting.scala:13-15."""

    def write_event(self, event: Event) -> SerializedMessage: ...


class EventReadFormatting(Protocol[Event]):
    """Inverse of EventWriteFormatting; needed by the replay path (the reference reads
    events back only through Kafka Streams restore; our TPU replay decodes them)."""

    def read_event(self, msg: SerializedMessage) -> Event: ...


# --- JSON convenience formatters (play-json Format equivalents used throughout the
#     reference's tests, e.g. TestBoundedContext.scala:84-110) ---


@dataclass
class JsonFormatting(Generic[State]):
    """Round-trips dataclass-like objects via user-provided to/from dict functions."""

    to_dict: Callable[[Any], dict]
    from_dict: Callable[[dict], Any]

    def write_state(self, state: Any | None) -> SerializedAggregate:
        if state is None:
            return SerializedAggregate(value=None)
        return SerializedAggregate(value=json.dumps(self.to_dict(state)).encode())

    def read_state(self, data: bytes) -> Any | None:
        if not data:
            return None
        return self.from_dict(json.loads(data.decode()))


@dataclass
class JsonCommandFormatting:
    """Command ⇄ bytes codec for cross-node delivery (the Jackson-CBOR envelope
    serialization role of the reference's remoting, core reference.conf:1-11)."""

    to_dict: Callable[[Any], dict]
    from_dict: Callable[[dict], Any]

    def write_command(self, command: Any) -> bytes:
        return json.dumps(self.to_dict(command)).encode()

    def read_command(self, data: bytes) -> Any:
        return self.from_dict(json.loads(data.decode()))


@dataclass
class JsonEventFormatting(Generic[Event]):
    """Event JSON formatter; key is the aggregate id extracted by ``key_of``."""

    to_dict: Callable[[Any], dict]
    from_dict: Callable[[dict], Any]
    key_of: Callable[[Any], str]

    def write_event(self, event: Any) -> SerializedMessage:
        return SerializedMessage(key=self.key_of(event), value=json.dumps(self.to_dict(event)).encode())

    def read_event(self, msg: SerializedMessage) -> Any:
        return self.from_dict(json.loads(msg.value.decode()))

    def read_events_batch(self, values: Sequence[bytes]) -> list:
        """Decode a whole batch of event payloads in ONE C-level JSON parse:
        the payloads join into a single JSON array, so the per-call
        ``json.loads`` overhead (scanner setup, unicode round trip) is paid
        once per BATCH instead of once per event. The resident plane's
        refresh feed rides this (the sustained-fold host leg);
        semantically identical to ``read_event`` per value — a malformed
        payload raises, and the caller degrades to the per-event path to
        find (and poison) the offender."""
        if not values:
            return []
        doc = json.loads(b"[" + b",".join(values) + b"]")
        from_dict = self.from_dict
        return [from_dict(d) for d in doc]


__all__ = [
    "SerializedMessage",
    "SerializedAggregate",
    "AggregateReadFormatting",
    "AggregateWriteFormatting",
    "EventWriteFormatting",
    "EventReadFormatting",
    "JsonFormatting",
    "JsonCommandFormatting",
    "JsonEventFormatting",
]
