"""Deterministic in-process log with full transactional semantics.

The EmbeddedKafka analog (SURVEY.md §4 test strategy): every broker behavior the engine
depends on — atomic multi-topic commits, epoch fencing, read_committed isolation,
compaction views, offset queries — reproduced in-process so engine/publisher/store tests
are hermetic and fast. Also the default transport for single-process engines.

Offsets are assigned at commit time under one lock, so a transaction's records across
topics become visible atomically and read_committed == read_uncommitted at all times
(open transactions buffer producer-side). This is a simplification of Kafka's
LSO/control-record machinery that preserves the observable contract the engine uses.

The port's copy of ``surge_tpu/log/memory.py``, plus :func:`copy_log`.
"""

from __future__ import annotations

import asyncio
import threading
import time
from bisect import bisect_left
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from surge_tpu_torch.common import cancel_safe_wait_for
from surge_tpu_torch.log.transport import (
    LogRecord,
    ProducerFencedError,
    TopicSpec,
    TransactionStateError,
)


class LogBase:
    """Transport-independent log behavior shared by the in-memory and file backends:
    topic auto-creation, epoch bookkeeping/fencing checks, compaction views built on
    ``read``, and the consumer wakeup primitive. Subclasses provide storage
    (``create_topic``/``read``/``end_offset``/``_append``) and populate ``_topics``,
    ``_epochs``, ``_lock``, ``_append_events``."""

    _topics: Dict[str, TopicSpec]
    _epochs: Dict[str, int]
    _auto_create_partitions: int
    #: lazily-created chained digest index (surge_tpu_torch.log.digest) — None until
    #: the first partition_digest query, so the append path pays one attribute
    #: check when nobody audits
    _digests = None

    def topic(self, name: str) -> TopicSpec:
        with self._lock:
            if name not in self._topics:
                self.create_topic(TopicSpec(name, self._auto_create_partitions))
            return self._topics[name]

    def num_partitions(self, name: str) -> int:
        return self.topic(name).partitions

    def _next_epoch(self, transactional_id: str) -> int:
        with self._lock:
            epoch = self._epochs.get(transactional_id, 0) + 1
            self._epochs[transactional_id] = epoch
            return epoch

    def _check_epoch(self, transactional_id: str, epoch: int) -> None:
        with self._lock:
            if self._epochs.get(transactional_id) != epoch:
                raise ProducerFencedError(
                    f"producer {transactional_id!r} epoch {epoch} fenced by "
                    f"epoch {self._epochs.get(transactional_id)}")

    def _append_fenced(self, transactional_id: str, epoch: int,
                       records: Sequence[LogRecord]) -> List[LogRecord]:
        """Epoch-check + append as one atomic step (the fencing window a
        commit must close). Subclasses whose append has a slow durability
        phase (FileLog's group-commit fsync) override this to run that phase
        OUTSIDE the log lock — holding the lock across an fsync would
        serialize every reader behind the disk."""
        with self._lock:
            self._check_epoch(transactional_id, epoch)
            return self._append(records)

    def latest_by_key(self, topic: str, partition: int,
                      isolation: str = "read_committed") -> Mapping[str, LogRecord]:
        out: Dict[str, LogRecord] = {}
        for r in self.read(topic, partition, isolation=isolation):
            if r.key is None:
                continue
            if r.value is None:
                out.pop(r.key, None)  # tombstone
            else:
                out[r.key] = r
        return out

    def compaction_state(self, topic: str, partition: int) -> Dict[str, int]:
        """Clean frontier of the last compaction pass: ``clean_end`` (offsets
        below it were compacted) and ``clean_count`` (records retained by that
        pass). The dirty-ratio scheduler (surge_tpu_torch.log.compactor) reads this;
        backends update it from ``compact_partition``."""
        clean = getattr(self, "_clean", {})
        end, count = clean.get((topic, partition), (0, 0))
        return {"clean_end": end, "clean_count": count}

    # -- chained digests (the consistency auditor's integrity sensor) -------------------

    def partition_digest(self, topic: str, partition: int,
                         upto: Optional[int] = None) -> dict:
        """Chained CRC digest over ``[clean-base, upto)`` of one partition
        (surge_tpu_torch.log.digest module doc). ``upto`` defaults to — and is
        clamped at — the durable end offset, so leader and follower compare
        at the same offset below the high-watermark without shipping
        records. Creates the digest index on first use; thereafter the
        append paths maintain it eagerly and queries fold only the delta."""
        idx = self._digests
        if idx is None:
            from surge_tpu_torch.log.digest import DigestIndex

            with self._lock:
                if self._digests is None:
                    self._digests = DigestIndex(self)
                idx = self._digests
        end = self.end_offset(topic, partition)
        upto = end if upto is None else min(int(upto), end)
        return idx.digest_at(topic, partition, upto)

    def _digest_observe(self, records) -> None:
        """Eager digest hook — call OUTSIDE the log lock (the digest index
        reads the log under its own lock for catch-up; the only permitted
        ordering is digest-lock → log-lock)."""
        idx = self._digests
        if idx is not None and records:
            idx.observe(records)

    def _notify_append(self, touched) -> None:
        for tp in touched:
            ev = self._append_events.get(tp)
            if ev is not None:
                ev.set()

    async def wait_for_append(self, topic: str, partition: int,
                              after_offset: int) -> None:
        tp = (topic, partition)
        while self.end_offset(topic, partition) <= after_offset:
            ev = self._append_events.get(tp)
            if ev is None or ev.is_set():
                ev = asyncio.Event()
                self._append_events[tp] = ev
            try:
                await cancel_safe_wait_for(ev.wait(), timeout=0.5)
            except asyncio.TimeoutError:
                pass  # re-check end_offset (guards against lost wakeups across loops)


class InMemoryLog(LogBase):
    """In-process :class:`surge_tpu_torch.log.transport.LogTransport` implementation.

    Partition storage is a list of records **sorted by offset but possibly
    sparse**: compaction (``compact_partition``) drops superseded records while
    every survivor keeps its original offset and ``end_offset`` keeps counting —
    the same observable contract a compacted Kafka partition has. A per-key
    latest-record index is maintained incrementally on append, so
    ``latest_by_key`` (the state-topic restore view) is O(keys) instead of a
    full-partition re-scan per call.
    """

    def __init__(self, auto_create_partitions: int = 1) -> None:
        self._topics: Dict[str, TopicSpec] = {}
        self._partitions: Dict[Tuple[str, int], List[LogRecord]] = {}
        self._ends: Dict[Tuple[str, int], int] = {}  # next offset to assign
        # incrementally-maintained compaction view: key -> latest non-tombstone
        self._latest: Dict[Tuple[str, int], Dict[str, LogRecord]] = {}
        self._clean: Dict[Tuple[str, int], Tuple[int, int]] = {}
        self._epochs: Dict[str, int] = {}
        self._lock = threading.RLock()
        self._auto_create_partitions = auto_create_partitions
        # async wakeups for consumers; created lazily per (topic, partition)
        self._append_events: Dict[Tuple[str, int], asyncio.Event] = {}

    # -- topics -------------------------------------------------------------------------

    def create_topic(self, spec: TopicSpec) -> None:
        with self._lock:
            if spec.name in self._topics:
                return
            self._topics[spec.name] = spec
            for p in range(spec.partitions):
                self._partitions[(spec.name, p)] = []
                self._ends[(spec.name, p)] = 0
                self._latest[(spec.name, p)] = {}

    # -- producers ----------------------------------------------------------------------

    def transactional_producer(self, transactional_id: str) -> "InMemoryTxnProducer":
        return InMemoryTxnProducer(self, transactional_id,
                                   self._next_epoch(transactional_id))

    def _append(self, records: Sequence[LogRecord]) -> List[LogRecord]:
        """Atomically append records (possibly spanning topics/partitions)."""
        out: List[LogRecord] = []
        now = time.time()
        with self._lock:
            touched = set()
            for r in records:
                self.topic(r.topic)  # auto-create
                key = (r.topic, r.partition)
                part = self._partitions.get(key)
                if part is None:
                    raise KeyError(f"{r.topic}[{r.partition}] does not exist")
                assigned = LogRecord(
                    topic=r.topic, key=r.key, value=r.value, partition=r.partition,
                    headers=dict(r.headers), offset=self._ends[key], timestamp=now)
                part.append(assigned)
                self._ends[key] += 1
                if r.key is not None:
                    if r.value is None:
                        self._latest[key].pop(r.key, None)  # tombstone
                    else:
                        self._latest[key][r.key] = assigned
                out.append(assigned)
                touched.add(key)
        self._notify_append(touched)
        self._digest_observe(out)
        return out

    # -- reads --------------------------------------------------------------------------

    def read(self, topic: str, partition: int, from_offset: int = 0,
             max_records: Optional[int] = None,
             isolation: str = "read_committed") -> Sequence[LogRecord]:
        del isolation  # open transactions are producer-side buffers; log is all-stable
        with self._lock:
            part = self._partitions.get((topic, partition), [])
            # offsets are sorted but may be sparse after compaction: bisect to
            # the first record at/after from_offset instead of list-slicing
            start = bisect_left(part, from_offset, key=lambda r: r.offset)
            end = len(part) if max_records is None else min(len(part),
                                                            start + max_records)
            return list(part[start:end])

    def end_offset(self, topic: str, partition: int,
                   isolation: str = "read_committed") -> int:
        del isolation
        with self._lock:
            self.topic(topic)
            return self._ends[(topic, partition)]

    def applied_end_offset(self, topic: str, partition: int) -> int:
        """The applied frontier — identical to ``end_offset`` in memory (no
        durability lag); FileLog's differs while an fsync round is open."""
        return self.end_offset(topic, partition)

    # -- replica ingest -----------------------------------------------------------------

    def append_verbatim(self, records: Sequence[LogRecord],
                        allow_gaps: bool = False) -> List[LogRecord]:
        """Append leader-assigned records AS-IS — offsets AND timestamps
        preserved, so a replica converges byte-identically with its leader
        (the follower half of ship-on-commit replication and catch_up).
        Offsets must continue each partition's applied end; with
        ``allow_gaps`` (catch_up over a compacted leader partition) they may
        jump forward, never backward."""
        with self._lock:
            touched = set()
            for r in records:
                self.topic(r.topic)
                key = (r.topic, r.partition)
                part = self._partitions.get(key)
                if part is None:
                    raise KeyError(f"{r.topic}[{r.partition}] does not exist")
                end = self._ends[key]
                if r.offset < end or (r.offset > end and not allow_gaps):
                    raise ValueError(
                        f"verbatim append at {r.topic}[{r.partition}]@"
                        f"{r.offset} but applied end is {end}")
                part.append(r)
                self._ends[key] = r.offset + 1
                if r.key is not None:
                    if r.value is None:
                        self._latest[key].pop(r.key, None)  # tombstone
                    else:
                        self._latest[key][r.key] = r
                touched.add(key)
        self._notify_append(touched)
        self._digest_observe(records)
        return list(records)

    # -- failover truncation ------------------------------------------------------------

    def truncate_partition(self, topic: str, partition: int,
                           to_offset: int) -> int:
        """Drop every record at offset >= ``to_offset`` (the KIP-101 role: a
        deposed leader truncates its divergent unreplicated tail to the new
        leader's epoch-start offset). Returns how many records were dropped."""
        with self._lock:
            self.topic(topic)
            key = (topic, partition)
            part = self._partitions[key]
            cut = bisect_left(part, to_offset, key=lambda r: r.offset)
            dropped = part[cut:]
            if not dropped and self._ends[key] <= to_offset:
                return 0
            del part[cut:]
            self._ends[key] = min(self._ends[key], to_offset)
            # rebuild the per-key latest index for this partition: a dropped
            # record may have superseded (or tombstoned) a surviving one
            latest: Dict[str, LogRecord] = {}
            for r in part:
                if r.key is None:
                    continue
                if r.value is None:
                    latest.pop(r.key, None)
                else:
                    latest[r.key] = r
            self._latest[key] = latest
            clean_end, clean_count = self._clean.get(key, (0, 0))
            if clean_end > to_offset:
                self._clean[key] = (to_offset, min(clean_count, len(part)))
        if self._digests is not None:
            self._digests.on_truncate(topic, partition, to_offset)
        return len(dropped)

    def latest_by_key(self, topic: str, partition: int,
                      isolation: str = "read_committed") -> Mapping[str, LogRecord]:
        del isolation
        with self._lock:
            self.topic(topic)
            # records are immutable (frozen dataclass): sharing them is safe
            return dict(self._latest[(topic, partition)])

    # -- compaction ---------------------------------------------------------------------

    def compact_partition(self, topic: str, partition: int, *,
                          tombstone_retention_s: float = 0.0,
                          now: Optional[float] = None,
                          upto_offset: Optional[int] = None):
        """Rewrite one partition to latest-record-per-key with tombstone GC
        (surge_tpu_torch.log.compactor picks the retained set). Offsets and
        ``end_offset`` are preserved; only superseded records disappear.
        ``upto_offset`` bounds the pass to records below it (the replication
        compaction barrier compacts the same prefix on leader and follower;
        the tail stays verbatim)."""
        from surge_tpu_torch.log.compactor import CompactionStats, select_retained

        t0 = time.perf_counter()
        with self._lock:
            self.topic(topic)
            key = (topic, partition)
            part = self._partitions[key]
            before = len(part)
            bytes_before = sum(_record_bytes(r) for r in part)
            if upto_offset is None:
                head, tail = part, []
                frontier = self._ends[key]
            else:
                cut = bisect_left(part, upto_offset, key=lambda r: r.offset)
                head, tail = part[:cut], part[cut:]
                frontier = upto_offset
            retained, dropped_tombstones = select_retained(
                head, now=now if now is not None else time.time(),
                tombstone_retention_s=tombstone_retention_s)
            retained = retained + tail
            self._partitions[key] = retained
            self._clean[key] = (frontier, len(retained) - len(tail))
            bytes_after = sum(_record_bytes(r) for r in retained)
        if self._digests is not None and len(retained) != before:
            # only a pass that dropped records invalidates the chain; a clean
            # pass leaves the stored bytes (and the digest) untouched
            self._digests.on_compact(topic, partition, frontier)
        return CompactionStats(
            topic=topic, partition=partition,
            records_before=before, records_after=len(retained),
            bytes_before=bytes_before, bytes_after=bytes_after,
            tombstones_dropped=dropped_tombstones,
            duration_s=time.perf_counter() - t0)


def _record_bytes(r: LogRecord) -> int:
    """Approximate storage footprint of one record (stats/dirty-ratio input)."""
    return len(r.value or b"") + len(r.key or "") + 32

class InMemoryTxnProducer:
    """Transactional producer handle; one per transactional id, epoch-fenced."""

    def __init__(self, log: InMemoryLog, transactional_id: str, epoch: int) -> None:
        self._log = log
        self.transactional_id = transactional_id
        self.epoch = epoch
        self._buffer: Optional[List[LogRecord]] = None

    @property
    def fenced(self) -> bool:
        try:
            self._log._check_epoch(self.transactional_id, self.epoch)
            return False
        except ProducerFencedError:
            return True

    @property
    def in_transaction(self) -> bool:
        return self._buffer is not None

    def begin(self) -> None:
        self._log._check_epoch(self.transactional_id, self.epoch)
        if self._buffer is not None:
            raise TransactionStateError("transaction already open")
        self._buffer = []

    def send(self, record: LogRecord) -> None:
        self._log._check_epoch(self.transactional_id, self.epoch)
        if self._buffer is None:
            raise TransactionStateError("no open transaction")
        self._buffer.append(record)

    def commit(self) -> Sequence[LogRecord]:
        # fencing is re-checked inside the atomic append's lock window
        if self._buffer is None:
            raise TransactionStateError("no open transaction")
        records = self._buffer
        self._buffer = None
        return self._log._append_fenced(self.transactional_id, self.epoch,
                                        records)

    def abort(self) -> None:
        if self._buffer is None:
            raise TransactionStateError("no open transaction")
        self._buffer = None

    def send_immediate(self, record: LogRecord) -> LogRecord:
        if self._buffer is not None:
            raise TransactionStateError(
                "send_immediate inside an open transaction")
        return self._log._append_fenced(self.transactional_id, self.epoch,
                                        [record])[0]


def copy_log(src, topics: Optional[Sequence[str]] = None) -> InMemoryLog:
    """A port :class:`InMemoryLog` holding ``src``'s records: the same topics
    (partition counts and ``compacted`` flags), and per partition the same
    offsets, keys, values, headers and timestamps — sparse offsets of a
    compacted partition included. ``src`` is any log with the reference's
    ``LogTransport`` read surface (``topic``, ``num_partitions``, ``read``),
    duck-typed; ``topics`` defaults to every topic ``src`` holds. This is how a
    reference engine's log moves to the port's engine."""
    names = list(topics) if topics is not None else list(src._topics)
    dst = InMemoryLog()
    for name in names:
        spec = src.topic(name)
        parts = src.num_partitions(name)
        dst.create_topic(TopicSpec(name, parts, compacted=spec.compacted))
        for p in range(parts):
            dst.append_verbatim(
                [LogRecord(topic=name, key=r.key, value=r.value, partition=p,
                           headers=dict(r.headers), offset=r.offset,
                           timestamp=r.timestamp)
                 for r in src.read(name, p)], allow_gaps=True)
    return dst
