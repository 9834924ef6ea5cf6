"""Background log compaction — latest-record-per-key retention for compacted topics.

The reference's durable aggregate store IS a compacted Kafka topic (overview.md:8-63),
but until this module the repo only *marked* topics compacted and faked the compacted
view with a full-partition scan. This is the real cleaner, re-derived from Kafka's
LogCleaner in two layers:

- **Policy** (here): :func:`select_retained` picks the survivor set of one partition —
  the latest record per key, tombstones garbage-collected once they are older than the
  retention window (``delete.retention.ms`` analog: a tombstone must outlive slow
  consumers so they see the delete before it disappears), keyless control records
  (publisher flush markers) dropped, and the partition's final record always kept so
  the tail of the offset space stays readable. Offsets are never rewritten — a
  compacted partition is the same partition with holes, exactly like Kafka's.
- **Mechanics** (per backend): ``InMemoryLog.compact_partition`` swaps the record
  list; ``FileLog.compact_partition`` rewrites the segment file crash-safely
  (tmp write → fsync → rename → recovery-manifest update, surge_tpu_torch.log.file).

:class:`LogCompactor` is the scheduler: a health-bus supervised
:class:`~surge_tpu_torch.common.BackgroundTask` that wakes on an interval, measures each
compacted partition's **dirty ratio** — records appended since the last clean pass
over total live records, Kafka's ``min.cleanable.dirty.ratio`` — and compacts the
partitions above threshold. It is also directly triggerable (admin RPC
``CompactLog`` / ``tools/compact_log.py``) via :meth:`compact_once`.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from surge_tpu_torch.common import Ack, BackgroundTask, Controllable, logger
from surge_tpu_torch.config import Config, default_config
from surge_tpu_torch.log.transport import LogRecord

__all__ = ["CompactionStats", "LogCompactor", "dirty_ratio", "select_retained"]


@dataclass(frozen=True)
class CompactionStats:
    """Outcome of one partition compaction pass."""

    topic: str
    partition: int
    records_before: int
    records_after: int
    bytes_before: int
    bytes_after: int
    tombstones_dropped: int
    duration_s: float

    @property
    def bytes_reclaimed(self) -> int:
        return max(self.bytes_before - self.bytes_after, 0)

    @property
    def records_dropped(self) -> int:
        return self.records_before - self.records_after

    def as_dict(self) -> dict:
        return {
            "topic": self.topic, "partition": self.partition,
            "records_before": self.records_before,
            "records_after": self.records_after,
            "bytes_before": self.bytes_before, "bytes_after": self.bytes_after,
            "bytes_reclaimed": self.bytes_reclaimed,
            "tombstones_dropped": self.tombstones_dropped,
            "duration_s": self.duration_s,
        }


def select_retained(records: Sequence[LogRecord], *, now: float,
                    tombstone_retention_s: float = 0.0
                    ) -> Tuple[List[LogRecord], int]:
    """The survivor set of one partition, in offset order.

    Keeps the latest record per key; a tombstone survives only while younger
    than ``tombstone_retention_s`` (0 = GC immediately); keyless records are
    dropped (control markers — consumers skip them); the final record is
    always kept so reads from the tail still return data and recovery can
    re-derive the frontier from the last block. Returns
    ``(retained, tombstones_dropped)``.
    """
    latest: Dict[str, LogRecord] = {}
    for r in records:
        if r.key is not None:
            latest[r.key] = r
    keep: set = set()
    expired_tombstones: set = set()
    for r in latest.values():
        if r.value is None and now - r.timestamp >= tombstone_retention_s:
            expired_tombstones.add(r.offset)
            continue
        keep.add(r.offset)
    if records:
        keep.add(records[-1].offset)  # may resurrect an expired tail tombstone
    return ([r for r in records if r.offset in keep],
            len(expired_tombstones - keep))


def dirty_ratio(log, topic: str, partition: int) -> float:
    """Records appended since the last clean pass over total live records —
    Kafka's ``min.cleanable.dirty.ratio`` input. 1.0 for a never-compacted
    non-empty partition, 0.0 for an empty or just-compacted one."""
    state = log.compaction_state(topic, partition)
    end = log.end_offset(topic, partition)
    dirty = max(end - state["clean_end"], 0)
    live = state["clean_count"] + dirty
    return dirty / live if live else 0.0


class LogCompactor(Controllable):
    """Dirty-ratio-driven compaction scheduler over one log's compacted topics.

    Config knobs (docs/compaction.md):

    - ``surge.log.compaction.interval-ms`` — scheduler wake cadence.
    - ``surge.log.compaction.min-dirty-ratio`` — compact partitions at/above.
    - ``surge.log.compaction.min-dirty-records`` — skip partitions with fewer
      new records than this regardless of ratio (tiny partitions churn).
    - ``surge.log.compaction.tombstone-retention-ms`` — tombstone GC window.
    """

    health_name = "log-compactor"

    def __init__(self, log, config: Config | None = None,
                 topics: Optional[Sequence[str]] = None, metrics=None,
                 on_signal: Callable[[str, str], None] | None = None) -> None:
        self.log = log
        self.config = config or default_config()
        self.topics = list(topics) if topics is not None else None
        self.metrics = metrics  # EngineMetrics quiver (optional)
        self.on_signal = on_signal or (lambda name, level: None)
        self._interval_s = self.config.get_seconds(
            "surge.log.compaction.interval-ms", 30_000)
        self._min_ratio = self.config.get_float(
            "surge.log.compaction.min-dirty-ratio", 0.5)
        self._min_records = self.config.get_int(
            "surge.log.compaction.min-dirty-records", 64)
        self._tombstone_retention_s = self.config.get_seconds(
            "surge.log.compaction.tombstone-retention-ms", 60_000)
        self._task = BackgroundTask(self._loop, "log-compactor")
        self.total_stats: List[CompactionStats] = []  # most-recent-first, capped

    # -- lifecycle ----------------------------------------------------------------------

    async def start(self) -> Ack:
        self._task.start()
        return Ack()

    async def stop(self) -> Ack:
        await self._task.stop()
        return Ack()

    @property
    def running(self) -> bool:
        return self._task.running

    # -- scheduling ---------------------------------------------------------------------

    def _compacted_partitions(self, topic: Optional[str] = None):
        """(topic, partition) pairs eligible for compaction. Lookups are
        NON-mutating — ``log.topic()`` would auto-create, so a mistyped
        operator topic (admin RPC / CLI) must resolve to nothing, not to a
        freshly persisted junk topic."""
        known = getattr(self.log, "_topics", {})
        names = ([topic] if topic else
                 (self.topics if self.topics is not None else sorted(known)))
        for name in names:
            spec = known.get(name)
            if spec is None or not spec.compacted:
                continue
            for p in range(spec.partitions):
                yield name, p

    def _eligible(self, topic: str, p: int) -> bool:
        state = self.log.compaction_state(topic, p)
        dirty = max(self.log.end_offset(topic, p) - state["clean_end"], 0)
        return (dirty >= self._min_records
                and dirty_ratio(self.log, topic, p) >= self._min_ratio)

    async def compact_once(self, topic: Optional[str] = None,
                           force: bool = False) -> List[CompactionStats]:
        """One full pass (the admin-RPC / CLI entry): compact every eligible
        compacted partition — all of them when ``force`` (operator-triggered
        compaction must not argue about ratios). File IO runs in the default
        executor so the event loop never blocks on a segment rewrite."""
        out: List[CompactionStats] = []
        if not hasattr(self.log, "compact_partition"):
            return out  # e.g. a remote LogClient: compaction is broker-side
        loop = asyncio.get_running_loop()
        for name, p in list(self._compacted_partitions(topic)):
            if not force and not self._eligible(name, p):
                continue
            stats = await loop.run_in_executor(
                None, lambda name=name, p=p: self.log.compact_partition(
                    name, p,
                    tombstone_retention_s=self._tombstone_retention_s))
            out.append(stats)
            self._record(stats)
        return out

    def _record(self, stats: CompactionStats) -> None:
        self.total_stats.insert(0, stats)
        del self.total_stats[64:]
        logger.info(
            "compacted %s[%d]: %d -> %d records, %d bytes reclaimed (%.3fs)",
            stats.topic, stats.partition, stats.records_before,
            stats.records_after, stats.bytes_reclaimed, stats.duration_s)
        if self.metrics is not None:
            self.metrics.compaction_runs.record()
            self.metrics.compaction_bytes_reclaimed.record(stats.bytes_reclaimed)
            self.metrics.compaction_records_dropped.record(stats.records_dropped)
            self.metrics.compaction_timer.record_ms(stats.duration_s * 1000.0)

    async def _loop(self) -> None:
        # same unkillable-loop discipline as the indexer tail: a failing
        # compaction pass (disk full, transient IO error) must log + signal and
        # retry next interval, never end the task silently
        while True:
            await asyncio.sleep(self._interval_s)
            try:
                if not hasattr(self.log, "compact_partition"):
                    continue  # e.g. a remote LogClient: compaction is broker-side
                if self.metrics is not None:
                    ratios = [dirty_ratio(self.log, t, p)
                              for t, p in self._compacted_partitions()]
                    self.metrics.compaction_max_dirty_ratio.record(
                        max(ratios, default=0.0))
                await self.compact_once()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — keep the scheduler alive
                logger.exception("compaction pass failed; retrying in %.1fs",
                                 self._interval_s)
                try:
                    self.on_signal("surge.log.compaction-error", "error")
                except Exception:  # noqa: BLE001
                    logger.exception("on_signal failed")
