"""The serialized event record — a copy of ``SerializedMessage`` from
``surge_tpu/serialization``, the one class the columnar segment build hands
to an app's event deserializer."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping


@dataclass(frozen=True)
class SerializedMessage:
    """A serialized event destined for the events topic: key, value and
    headers."""

    key: str
    value: bytes
    headers: Mapping[str, str] = field(default_factory=dict)
