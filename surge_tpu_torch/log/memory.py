"""Deterministic in-process log — a copy of the parts of
``surge_tpu/log/memory.py`` the resident state plane and ``chip_smoke.py`` use:
topics, the transactional producer (``begin``/``send``/``commit``), ``read``,
``end_offset``, ``latest_by_key`` and the ``wait_for_append`` wakeup. Offsets are assigned at
commit time under one lock, so a transaction's records become visible
atomically. Replication, compaction, digests and fencing of stale producers
beyond the epoch check are not carried."""

from __future__ import annotations

import asyncio
import threading
import time
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

from surge_tpu_torch.common import cancel_safe_wait_for
from surge_tpu_torch.log.transport import (
    LogRecord,
    ProducerFencedError,
    TopicSpec,
    TransactionStateError,
)


class InMemoryLog:
    """In-process log with the reference's offsets and wakeup semantics."""

    def __init__(self, auto_create_partitions: int = 1) -> None:
        self._topics: Dict[str, TopicSpec] = {}
        self._partitions: Dict[Tuple[str, int], List[LogRecord]] = {}
        self._ends: Dict[Tuple[str, int], int] = {}  # next offset to assign
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

    def topic(self, name: str) -> TopicSpec:
        with self._lock:
            if name not in self._topics:
                self.create_topic(TopicSpec(name, self._auto_create_partitions))
            return self._topics[name]

    def num_partitions(self, name: str) -> int:
        return self.topic(name).partitions

    # -- producers ----------------------------------------------------------------------

    def transactional_producer(self, transactional_id: str) -> "InMemoryTxnProducer":
        with self._lock:
            epoch = self._epochs.get(transactional_id, 0) + 1
            self._epochs[transactional_id] = epoch
        return InMemoryTxnProducer(self, transactional_id, epoch)

    def _check_epoch(self, transactional_id: str, epoch: int) -> None:
        with self._lock:
            if self._epochs.get(transactional_id) != epoch:
                raise ProducerFencedError(
                    f"producer {transactional_id!r} epoch {epoch} fenced by "
                    f"epoch {self._epochs.get(transactional_id)}")

    def _append_fenced(self, transactional_id: str, epoch: int,
                       records: Sequence[LogRecord]) -> List[LogRecord]:
        with self._lock:
            self._check_epoch(transactional_id, epoch)
            return self._append(records)

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
                out.append(assigned)
                touched.add(key)
        for tp in touched:
            ev = self._append_events.get(tp)
            if ev is not None:
                ev.set()
        return out

    # -- reads --------------------------------------------------------------------------

    def read(self, topic: str, partition: int, from_offset: int = 0,
             max_records: Optional[int] = None,
             isolation: str = "read_committed") -> Sequence[LogRecord]:
        del isolation  # open transactions are producer-side buffers
        with self._lock:
            part = self._partitions.get((topic, partition), [])
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

    def latest_by_key(self, topic: str, partition: int,
                      isolation: str = "read_committed") -> Dict[str, LogRecord]:
        """The newest record of each key (a tombstone drops the key)."""
        out: Dict[str, LogRecord] = {}
        for r in self.read(topic, partition, isolation=isolation):
            if r.key is None:
                continue
            if r.value is None:
                out.pop(r.key, None)
            else:
                out[r.key] = r
        return out

    async def wait_for_append(self, topic: str, partition: int,
                              after_offset: int) -> None:
        """Resolve once ``end_offset`` exceeds ``after_offset``."""
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


class InMemoryTxnProducer:
    """Transactional producer handle; one per transactional id, epoch-fenced."""

    def __init__(self, log: InMemoryLog, transactional_id: str, epoch: int) -> None:
        self._log = log
        self.transactional_id = transactional_id
        self.epoch = epoch
        self._buffer: Optional[List[LogRecord]] = None

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
