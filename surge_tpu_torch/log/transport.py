"""Transport-neutral log contracts.

The engine only touches these protocols, mirroring how the reference's engine depends on
``KafkaProducerTrait``/``KafkaConsumerTrait`` rather than concrete clients
(modules/common/src/main/scala/surge/kafka/KafkaProducer.scala:18-66) — the seam its
entire test suite injects through (SURVEY.md §4). Semantics preserved from the Kafka
substrate:

- **Atomic multi-topic transactional append** (events topic + state topic in one commit;
  KafkaProducer.scala:106-117 begin/commit/abort).
- **Producer-epoch fencing**: opening a transactional producer with an id fences every
  earlier producer holding the same id; fenced producers fail with
  :class:`ProducerFencedError` (the zombie-writer exclusion the single-writer guarantee
  rests on — KafkaProducerActorImpl.scala:502-528).
- **read_committed isolation**: consumers at ``read_committed`` never observe records of
  open or aborted transactions (SurgeStateStoreConsumer.scala:38).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Optional, Protocol, Sequence


class ProducerFencedError(Exception):
    """A newer producer with the same transactional id has been opened; this instance
    is a zombie and must never write again (KafkaProducerActorImpl.scala:502-510)."""


class NotLeaderError(Exception):
    """The addressed broker is a follower (or a fenced ex-leader); writes must
    go to the leader. ``leader_hint`` carries its address when known."""

    def __init__(self, message: str, leader_hint: str = "") -> None:
        super().__init__(message)
        self.leader_hint = leader_hint


class FaultInjector(Protocol):
    """The hook surface the log substrate consults when a fault plane is
    armed (:class:`surge_tpu_torch.testing.faults.FaultPlane` is the one
    implementation; production code only depends on this seam, so the
    testing package never loads unless a plan is actually armed).

    Every hook is called at a named SITE; an unarmed plane answers None /
    returns without effect, so hot paths pay one attribute check."""

    def on_rpc(self, method: str): ...

    def on_ship(self, target: str) -> Optional[str]: ...

    def on_fsync(self, which: str) -> None: ...

    def torn(self, site: str, data: bytes) -> Optional[bytes]: ...

    def crash_point(self, name: str) -> None: ...

    def raise_point(self, site: str) -> None: ...


def load_fault_plane(config) -> Optional[FaultInjector]:
    """Build the configured fault plane (``surge.log.faults.plan``), lazily
    importing the testing package only when a plan is armed."""
    if config is None or not config.get_str("surge.log.faults.plan", ""):
        return None
    from surge_tpu_torch.testing.faults import FaultPlane

    return FaultPlane.from_config(config)


class TransactionStateError(Exception):
    """Illegal transaction op for the current state (commit without begin, etc.)."""


@dataclass(frozen=True)
class TopicSpec:
    """Topic metadata. ``compacted`` marks state topics (latest-record-per-key retention,
    overview.md:8-63: the compacted state topic IS the durable aggregate store)."""

    name: str
    partitions: int = 1
    compacted: bool = False


@dataclass(frozen=True)
class LogRecord:
    """One record on a topic-partition. ``value=None`` is a tombstone (deletes the key
    from a compacted topic). ``offset``/``timestamp`` are assigned by the log."""

    topic: str
    key: Optional[str]
    value: Optional[bytes]
    partition: int = 0
    headers: Mapping[str, str] = field(default_factory=dict)
    offset: int = -1
    timestamp: float = 0.0


class TransactionalProducer(Protocol):
    """Handle for one transactional id (single-writer per id via epoch fencing)."""

    def begin(self) -> None: ...

    def send(self, record: LogRecord) -> None:
        """Buffer a record into the open transaction."""

    def commit(self) -> Sequence[LogRecord]:
        """Atomically append the buffered records; returns them with offsets assigned.
        All records become visible to read_committed consumers at once."""

    def abort(self) -> None:
        """Discard the open transaction's records."""

    def send_immediate(self, record: LogRecord) -> LogRecord:
        """Non-transactional single-record append (the opt-in fast path behind the
        reference's disable-single-record-transactions flag,
        KafkaProducerActorImpl.scala:455-468). Still epoch-fenced."""

    @property
    def fenced(self) -> bool: ...


class LogTransport(Protocol):
    """The log service: topics, producers, reads, offsets.

    Reads are pull-based with an async wait primitive instead of callback consumers —
    idiomatic for asyncio indexer tasks (the KafkaConsumerTrait poll-thread analog,
    KafkaConsumer.scala:17-132).
    """

    def create_topic(self, spec: TopicSpec) -> None: ...

    def topic(self, name: str) -> TopicSpec: ...

    def num_partitions(self, name: str) -> int: ...

    def transactional_producer(self, transactional_id: str) -> TransactionalProducer:
        """Open (and fence any prior holder of) ``transactional_id``."""

    def read(self, topic: str, partition: int, from_offset: int = 0,
             max_records: Optional[int] = None,
             isolation: str = "read_committed") -> Sequence[LogRecord]: ...

    def end_offset(self, topic: str, partition: int,
                   isolation: str = "read_committed") -> int:
        """Next offset to be assigned (read_committed: the last stable offset)."""

    def latest_by_key(self, topic: str, partition: int,
                      isolation: str = "read_committed") -> Mapping[str, LogRecord]:
        """Compacted view: latest non-tombstone record per key (what a compacted topic
        retains; the bulk-restore read path)."""

    async def wait_for_append(self, topic: str, partition: int,
                              after_offset: int) -> None:
        """Resolve once ``end_offset`` exceeds ``after_offset`` (consumer wakeup)."""


def page_keyed_records(log, topic: str, partition: int, *,
                       start: int = 0, upto: Optional[int] = None,
                       page: int = 10_000):
    """Offset-paged scan of one partition's keyed records (tombstones and
    keyless records skipped) — the shared bulk-scan loop of segment builds and
    bounded restores. ``upto`` clamps the scan to a pre-captured watermark so
    multi-pass consumers see ONE consistent snapshot of a live topic: records
    committed after the watermark are left for the tailing indexer instead of
    being half-seen across passes."""
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
