"""State-topic indexer task: compacted topic → KV store, with watermarks.

The asyncio re-expression of the embedded Kafka Streams KTable job
(KafkaStreamManagerActor.scala:20-190 + SurgeStateStoreConsumer.scala:57-76): consume the
state topic read_committed, upsert the latest snapshot per aggregate id into the KV
store, and expose

- ``get_aggregate_bytes(id)`` — the aggregate cold-start read path
  (AggregateStateStoreKafkaStreams.scala:126-140),
- ``indexed_watermark(topic, partition)`` — the lag signal the publisher's
  ``is_aggregate_state_current`` gating consumes (KafkaProducerActorImpl.scala:701-708),
- ``wipe-state-on-start`` (common reference.conf:8-12) and bulk-restore priming
  (watermark fast-forward after a TPU rebuild).

On-change listeners fire on every RUNNING transition / assignment change — the
``KafkaStreamsUpdatePartitionsOnStateChangeListener`` analog that keeps the partition
tracker current (SURVEY.md §3.5).
"""

from __future__ import annotations

import asyncio
from typing import Callable, Dict, List, Optional, Sequence

from surge_tpu_torch.common import (Ack, BackgroundTask, Controllable,
                              cancel_safe_wait_for, logger, spawn_reaped)
from surge_tpu_torch.config import Config, default_config
from surge_tpu_torch.log.transport import LogRecord
from surge_tpu_torch.store.kv import KeyValueStore, create_store


class StateStoreIndexer(Controllable):
    """Materializes one state topic's assigned partitions into a KV store."""

    def __init__(self, log, state_topic: str,
                 partitions: Optional[Sequence[int]] = None,
                 store: Optional[KeyValueStore] = None,
                 config: Config | None = None,
                 on_signal: Callable[[str, str], None] | None = None) -> None:
        self.log = log
        self.state_topic = state_topic
        self.config = config or default_config()
        self.store = store if store is not None else create_store(
            self.config.get_str("surge.state-store.backend", "memory"))
        self.partitions: List[int] = sorted(
            partitions if partitions is not None else range(log.num_partitions(state_topic)))
        self.on_signal = on_signal or (lambda name, level: None)
        self._watermarks: Dict[int, int] = {p: 0 for p in self.partitions}
        self._max_poll = self.config.get_int("surge.state-store.restore-max-poll-records", 500)
        self._poll_timeout = max(
            self.config.get_seconds("surge.state-store.commit-interval-ms", 3000), 0.001)
        self._tasks: Dict[int, BackgroundTask] = {}
        # partition -> in-flight stop() of its previous loop (set_partitions
        # revoke); a re-grant chains its new loop behind this so two loops never
        # tail one partition concurrently
        self._stopping: Dict[int, asyncio.Task] = {}
        self._chains: set = set()  # stop→restart chains in flight (reaped)
        self._running = False
        self._state_listeners: List[Callable[[str], None]] = []

    # -- lifecycle (Controllable) -------------------------------------------------------

    async def start(self) -> Ack:
        if self.config.get_bool("surge.state-store.wipe-state-on-start"):
            logger.info("wipe-state-on-start: clearing %s store", self.state_topic)
            self.store.clear()
            self._watermarks = {p: 0 for p in self.partitions}
        self._tasks = {
            p: BackgroundTask(self._make_partition_loop(p),
                              f"indexer-{self.state_topic}-{p}")
            for p in self.partitions
        }
        for t in self._tasks.values():
            t.start()
        self._running = True
        self._notify_state("running")
        return Ack()

    async def stop(self) -> Ack:
        self._running = False
        for t in self._tasks.values():
            await t.stop()
        self._tasks = {}
        # drain in-flight revoke stops so shutdown never orphans a pending task
        for t in list(self._stopping.values()):
            try:
                await t
            except Exception:  # noqa: BLE001 — stop is best-effort
                pass
        self._stopping = {}
        self._notify_state("stopped")
        return Ack()

    def set_partitions(self, partitions: Sequence[int]) -> None:
        """Retarget which partitions this indexer tails (rebalance: the Kafka
        Streams task-migration analog, SURVEY.md §3.5). Added partitions start
        tailing from their last-known watermark (0 if never tailed); removed
        partitions stop tailing but their already-indexed keys stay in the store
        — routing ownership means this node is no longer asked for them. A
        partition re-granted while its old loop is still stopping gets its new
        loop chained behind the stop, so one partition never has two tailers."""
        new = sorted(set(partitions))
        if new == self.partitions:
            return
        added = [p for p in new if p not in self._tasks]
        removed = [p for p in self.partitions if p not in new]
        self.partitions = new
        for p in new:
            self._watermarks.setdefault(p, 0)
        if not self._running:
            return
        for p in removed:
            task = self._tasks.pop(p, None)
            if task is not None:
                stopper = asyncio.ensure_future(task.stop())
                self._stopping[p] = stopper
                stopper.add_done_callback(
                    lambda t, p=p: self._stopping.pop(p, None)
                    if self._stopping.get(p) is t else None)
        for p in added:
            self._start_partition_loop(p)

    def _start_partition_loop(self, p: int) -> None:
        pending = self._stopping.get(p)
        if pending is not None and not pending.done():
            async def chain() -> None:
                try:
                    await pending
                except Exception:  # noqa: BLE001
                    pass
                # re-check: assignment may have changed again while waiting
                if self._running and p in self.partitions and p not in self._tasks:
                    t = BackgroundTask(self._make_partition_loop(p),
                                       f"indexer-{self.state_topic}-{p}")
                    self._tasks[p] = t
                    t.start()

            spawn_reaped(self._chains, chain(),
                         f"indexer {self.state_topic}[{p}] restart chain")
            return
        t = BackgroundTask(self._make_partition_loop(p),
                           f"indexer-{self.state_topic}-{p}")
        self._tasks[p] = t
        t.start()

    @property
    def running(self) -> bool:
        return self._running

    def register_state_listener(self, fn: Callable[[str], None]) -> None:
        """Listener(state) on running/stopped transitions (partition-tracker feed)."""
        self._state_listeners.append(fn)

    def _notify_state(self, state: str) -> None:
        for fn in self._state_listeners:
            try:
                fn(state)
            except Exception:  # noqa: BLE001 — listener bugs must not kill the indexer
                logger.exception("state listener failed")

    # -- read path ----------------------------------------------------------------------

    def get_aggregate_bytes(self, aggregate_id: str) -> Optional[bytes]:
        return self.store.get(aggregate_id)

    def indexed_watermark(self, topic: str, partition: int) -> int:
        if topic != self.state_topic:
            return 0
        return self._watermarks.get(partition, 0)

    def total_lag(self) -> int:
        """Sum over assigned partitions of (end offset − indexed watermark)."""
        return self.lag_for(self.partitions)

    def lag_for(self, partitions: Sequence[int]) -> int:
        """Sum of (end offset − indexed watermark) over ``partitions`` (the
        standby-lag gauge input; KafkaProducerActorImpl.scala:701-708 role)."""
        return sum(
            max(self.log.end_offset(self.state_topic, p)
                - self._watermarks.get(p, 0), 0)
            for p in partitions)

    # -- restore priming ----------------------------------------------------------------

    def prime(self, watermarks: Dict[int, int]) -> None:
        """Fast-forward watermarks after a bulk restore filled the store out-of-band
        (the TPU replay writeback path, surge_tpu_torch.store.restore)."""
        for p, off in watermarks.items():
            if p in self._watermarks:
                self._watermarks[p] = max(self._watermarks[p], off)

    # -- indexing loop ------------------------------------------------------------------

    def _make_partition_loop(self, partition: int):
        async def loop() -> None:
            # a transient transport failure (e.g. the whole broker set briefly
            # unreachable mid-failover, after the client's own target cycle is
            # exhausted) must not END this task silently: the partition would
            # stop indexing forever, the publisher's lag gate would never
            # advance, and every aggregate on it would stall with no root
            # cause. Log, signal the health bus, back off — escalating, so a
            # DETERMINISTIC failure (poison record, store bug) throttles its
            # own traceback spam and reads differently from transport blips.
            backoff = 0.25
            while True:
                try:
                    offset = self._watermarks[partition]
                    # end captured BEFORE the read: an empty read then proves
                    # [offset, end) held only compacted-away records — anything
                    # committed after the capture has offset >= end and stays
                    # past the fast-forwarded watermark
                    end = self.log.end_offset(self.state_topic, partition)
                    records = self.log.read(self.state_topic, partition,
                                            offset, max_records=self._max_poll)
                    if records:
                        self._apply(records)
                        self._watermarks[partition] = records[-1].offset + 1
                        backoff = 0.25  # reset only on a FULL success, so a
                        continue        # poison _apply still escalates
                    if end > offset:
                        # compaction hole at the tail of our position: without
                        # this the watermark would stall below end_offset
                        # forever and the publisher's lag gate would never open
                        self._watermarks[partition] = end
                        backoff = 0.25
                        continue
                    await cancel_safe_wait_for(
                        self.log.wait_for_append(self.state_topic, partition,
                                                 offset),
                        timeout=self._poll_timeout)
                    backoff = 0.25
                except asyncio.TimeoutError:
                    backoff = 0.25  # an idle wait is healthy too
                except Exception:  # noqa: BLE001 — keep the tail alive
                    logger.exception(
                        "indexer poll failed on %s[%d]; retrying in %.2fs",
                        self.state_topic, partition, backoff)
                    try:
                        self.on_signal("surge.state-store.poll-error", "error")
                    except Exception:  # noqa: BLE001
                        logger.exception("on_signal failed")
                    await asyncio.sleep(backoff)
                    backoff = min(backoff * 2, 30.0)

        return loop

    def _apply(self, records: Sequence[LogRecord]) -> None:
        for r in records:
            if r.key is None:
                continue  # flush/control record (publisher init sentinel)
            if r.value is None:
                self.store.delete(r.key)
            else:
                self.store.put(r.key, r.value)
