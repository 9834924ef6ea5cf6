"""Transport-neutral log records — a copy of the parts of
``surge_tpu/log/transport.py`` the resident state plane uses: ``TopicSpec``,
``LogRecord``, the producer's errors and ``page_keyed_records``. The plane
duck-types its log, so any transport with ``read``/``end_offset``/
``wait_for_append``/``num_partitions`` serves."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Optional


class ProducerFencedError(Exception):
    """A newer producer with the same transactional id has been opened; this
    instance is a zombie and must never write again."""


class TransactionStateError(Exception):
    """Illegal transaction op for the current state (commit without begin, etc.)."""


@dataclass(frozen=True)
class TopicSpec:
    """Topic metadata. ``compacted`` marks state topics."""

    name: str
    partitions: int = 1
    compacted: bool = False


@dataclass(frozen=True)
class LogRecord:
    """One record on a topic-partition. ``value=None`` is a tombstone.
    ``offset``/``timestamp`` are assigned by the log."""

    topic: str
    key: Optional[str]
    value: Optional[bytes]
    partition: int = 0
    headers: Mapping[str, str] = field(default_factory=dict)
    offset: int = -1
    timestamp: float = 0.0


def page_keyed_records(log, topic: str, partition: int, *,
                       start: int = 0, upto: Optional[int] = None,
                       page: int = 10_000):
    """Offset-paged scan of one partition's keyed records (tombstones and
    keyless records skipped). ``upto`` clamps the scan to a pre-captured
    watermark so a consumer sees ONE consistent snapshot of a live topic."""
    offset = start
    while True:
        if upto is not None and offset >= upto:
            return
        batch = log.read(topic, partition, from_offset=offset,
                         max_records=page)
        if not batch:
            return
        for r in batch:
            if upto is not None and r.offset >= upto:
                return
            if r.key is not None and r.value is not None:
                yield r
        offset = batch[-1].offset + 1
