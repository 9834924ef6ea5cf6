"""Per-partition transactional publisher — the exactly-once write path.

Re-derivation of the protocol of the reference's ``KafkaProducerActorImpl``
(modules/command-engine/core/src/main/scala/surge/internal/kafka/
KafkaProducerActorImpl.scala:182-528) as an asyncio FSM:

- ``uninitialized`` → ``initializing``: open the transactional producer (fencing any
  zombie holding the same ``{prefix}-{state_topic}-{partition}`` id,
  KafkaProducerActorImpl.scala:124), commit a flush record to establish the epoch
  (:321-340), then
- ``waiting_for_ktable``: hold publishes until the state store has indexed everything
  already on the state topic (lag == 0, :341-376) so ``is_aggregate_state_current``
  answers are sound from the first command, then
- ``processing``: **event-driven group commit** (the Kafka producer's
  linger.ms/batch.size triggers replacing the fixed flush tick this file used
  to run): the first queued publish wakes the lane, the batch commits after
  ``surge.producer.linger-ms`` — or immediately once it hits
  ``batch-max-records``/``batch-max-bytes`` — as ONE transaction spanning
  events + state topics (:397-453). An idle lane therefore acks a lone
  command in ~linger time; a loaded lane fills batches. Commits run OFF the
  event loop (a dedicated lane thread, or pipelined transport futures), so
  the lanes of different partitions commit concurrently — the single-writer
  guarantee is per aggregate and aggregates hash to partitions, making
  cross-partition serialization pure overhead. Transports exposing
  ``commit_pipelined`` (the gRPC log client) additionally keep a bounded
  window of ``surge.producer.max-in-flight`` transactions in flight per lane,
  relying on the broker's replicated per-producer ``txn_seq`` dedup plus its
  in-order apply gate for exactly-once. On commit, acknowledge every batched
  publisher and track the published aggregates as **in-flight by state-topic
  offset** until the store's indexed watermark passes them (:580-699) — the
  gap that ``is_aggregate_state_current`` (:530-540) reports.
- Fencing (``ProducerFencedError``) fails the open batch, then either re-initializes
  (still partition owner: new epoch re-fences the impostor) or shuts down (ownership
  lost) — :502-528.
- Duplicate publish suppression by request id with a TTL (the ``PublishTracker``
  analog, :580-608) so an entity retrying a publish whose commit actually landed does
  not double-write.

Backpressure: publishes past ``surge.producer.pending-max-records`` queued
records await lane headroom instead of growing memory without bound under
overload; callers see added latency, never an unbounded queue.
"""

from __future__ import annotations

# surgelint: fast-path-module — the per-command publish lane

import asyncio
import time
from collections import deque
from dataclasses import dataclass
from typing import (Callable, Deque, Dict, List, Mapping, Optional, Protocol,
                    Sequence)

from surge_tpu_torch.common import (BackgroundTask, cancel_safe_wait_for,
                              fail_future, logger, resolve_future,
                              spawn_reaped)
from surge_tpu_torch.config import Config, default_config
from surge_tpu_torch.log.transport import (
    LogRecord,
    NotLeaderError,
    ProducerFencedError,
)


class PublishFailedError(Exception):
    """The batch containing this publish could not be committed."""


class PublisherNotReadyError(Exception):
    """Publish attempted before initialization finished or after shutdown."""


class StoreProgress(Protocol):
    """The state store's indexing progress, as seen by the publisher (the KTable
    consumer-lag query, KafkaProducerActorImpl.scala:701-708)."""

    def indexed_watermark(self, topic: str, partition: int) -> int:
        """Offsets ``< watermark`` have been indexed into the materialized store."""


@dataclass
class _Pending:
    request_id: str
    aggregate_id: str
    records: List[LogRecord]
    future: "asyncio.Future[None]"
    nbytes: int = 0
    #: the publish span's context captured at enqueue (tracer wired only):
    #: the flush span parents on the batch's FIRST pending's context, so a
    #: command's trace stays contiguous through the group commit down to the
    #: broker — including a timed-out caller whose same-request_id retry
    #: rejoins this queued write (the pending, and so the parenting, is the
    #: ORIGINAL publish's)
    trace_ctx: Optional[object] = None


class _Batch:
    """One group-commit unit: the pendings drained together, their flattened
    records, and (pipelined transports) the commit handle pinning the batch's
    txn_seq so an unknown-outcome batch retries VERBATIM under the same
    sequence number."""

    __slots__ = ("pendings", "records", "handle", "attempts", "index",
                 "dispatch_error", "outcome", "span")

    def __init__(self, pendings: List[_Pending], records: List[LogRecord],
                 index: int) -> None:
        self.pendings = pendings
        self.records = records
        self.handle = None
        self.attempts = 0
        self.index = index  # dispatch order: retries must replay oldest-first
        self.dispatch_error: Optional[Exception] = None
        #: the current attempt's flush span (opened at pipelined dispatch or
        #: by _publish_batch; cleared when the attempt's span finishes so a
        #: retry opens a fresh one in the same trace)
        self.span = None
        #: the current commit attempt's outcome (None = success, exception =
        #: why it failed); registered under _committing for every request id
        #: the moment the batch FORMS — a caller-timeout retry arriving while
        #: the commit task is still being scheduled must join, never re-queue
        self.outcome: Optional["asyncio.Future[Optional[Exception]]"] = None


class _Signal:
    """Level-triggered wakeup for ONE waiter (the flush loop), without
    ``wait_for(event.wait(), t)``: that wrapper costs a task per wait and —
    py3.10's wait_for — can swallow a cancellation racing its timeout,
    leaving the loop task uncancellable (the BackgroundTask.stop hang class
    fixed in surge_tpu_torch.common). A bare awaited future cancels cleanly."""

    __slots__ = ("_set", "_waiter")

    def __init__(self) -> None:
        self._set = False
        self._waiter: Optional["asyncio.Future[None]"] = None

    def set(self) -> None:
        if not self._set:
            self._set = True
            w = self._waiter
            if w is not None and not w.done():
                w.set_result(None)

    def clear(self) -> None:
        self._set = False

    def is_set(self) -> bool:
        return self._set

    async def wait(self, timeout: float) -> bool:
        """True iff set (possibly before the timeout elapsed)."""
        if self._set:
            return True
        loop = asyncio.get_running_loop()
        w: "asyncio.Future[None]" = loop.create_future()
        self._waiter = w
        timer = loop.call_later(timeout, resolve_future, w, None)
        try:
            await w
        finally:
            timer.cancel()
            if self._waiter is w:
                self._waiter = None
        return self._set


@dataclass
class PublisherStats:
    """Counters for tests/metrics (flush loop visibility)."""

    flushes: int = 0
    records_published: int = 0
    batches_failed: int = 0
    fences: int = 0
    reinitializations: int = 0
    dedup_hits: int = 0
    in_flight: int = 0
    max_batch_records: int = 0
    inflight_peak: int = 0


class PartitionPublisher:
    """Single-writer publisher for one (state-topic) partition."""

    def __init__(self, log, state_topic: str, events_topic: Optional[str],
                 partition: int, progress: StoreProgress,
                 config: Config | None = None, transactional_id_prefix: str = "surge",
                 still_owner: Callable[[], bool] = lambda: True,
                 on_signal: Callable[[str, str], None] | None = None,
                 metrics=None, tracer=None, flight=None) -> None:
        self.log = log
        self.state_topic = state_topic
        self.events_topic = events_topic
        self.partition = partition
        self.progress = progress
        self.config = config or default_config()
        self.transactional_id = f"{transactional_id_prefix}-{state_topic}-{partition}"
        self.still_owner = still_owner
        self.on_signal = on_signal or (lambda name, level: None)

        self.state = "uninitialized"
        self.stats = PublisherStats()
        self.metrics = metrics  # EngineMetrics quiver (optional)
        self.tracer = tracer  # None = zero-overhead path
        #: engine flight recorder (optional): lane transitions — group-commit
        #: dispatch / verbatim retry / fence / rejoin — land in the same ring
        #: the broker events merge with on an incident timeline
        self.flight = flight
        self._producer = None
        self._pending: List[_Pending] = []
        self._in_flight: Dict[str, int] = {}  # aggregate_id -> max state offset published
        self._completed: Dict[str, float] = {}  # request_id -> completion time
        # request_id -> outcome future of the batch currently committing it; retries of
        # an in-flight request join the commit instead of re-queueing (exactly-once)
        self._committing: Dict[str, "asyncio.Future[Optional[Exception]]"] = {}
        # aggregate_id -> live commit-batch refcount: a write mid-commit is
        # ahead of the store even though it sits in neither _pending nor
        # _in_flight yet — is_aggregate_state_current must see it
        self._committing_aggs: Dict[str, int] = {}
        self._watermark = 0
        self._ready = asyncio.Event()
        # housekeeping tick: fenced-reinit retries, verbatim-retry pacing,
        # dedup purges (the flush itself is event-driven; pre-group-commit
        # this interval WAS the fixed flush tick, so configs lowering it for
        # fast tests keep their meaning as the recovery cadence)
        self._flush_interval = self.config.get_seconds("surge.producer.flush-interval-ms", 50)
        # group-commit triggers: the legacy flush tick stays an upper bound on
        # linger so configs tuned for the old fixed tick never get slower
        self._linger_s = min(
            self.config.get_seconds("surge.producer.linger-ms", 2),
            self._flush_interval)
        self._batch_max_records = max(1, self.config.get_int(
            "surge.producer.batch-max-records", 512))
        self._batch_max_bytes = max(1, self.config.get_int(
            "surge.producer.batch-max-bytes", 4 << 20))
        self._pending_max = max(1, self.config.get_int(
            "surge.producer.pending-max-records", 16_384))
        self._max_in_flight = max(1, self.config.get_int(
            "surge.producer.max-in-flight", 4))
        self._check_interval = self.config.get_seconds("surge.producer.ktable-check-interval-ms", 500)
        self._slow_txn_s = self.config.get_seconds("surge.producer.slow-transaction-warning-ms", 1000)
        self._dedup_ttl_s = self.config.get_seconds(
            "surge.producer.publish-dedup-ttl-ms", 60_000)
        self._single_record_opt_in = self.config.get_bool(
            "surge.feature-flags.experimental.disable-single-record-transactions")
        # surge.producer.enable-transactions=false: append every record individually
        # (no atomicity across events+state; still epoch-fenced) — the reference's
        # non-transactional producer mode for throughput-over-consistency setups
        self._transactions_enabled = self.config.get_bool(
            "surge.producer.enable-transactions", True)
        # non-transactional mode: request_id -> LogRecords already appended (with
        # offsets). A mid-batch failure keeps every affected request's appended
        # records here so a same-request_id retry resumes after them AND can still
        # contribute the full record list to the success bookkeeping — without this,
        # retries would either re-append (duplicating events on the log) or hand the
        # offset-alignment loop a short `committed` list.
        self._partial_records: Dict[str, List[LogRecord]] = {}
        self._partial_touched: Dict[str, float] = {}  # request_id -> last retry time
        # transactional mode: commits whose OUTCOME IS UNKNOWN (transport
        # died, fencing mid-flight) keep their batches here — in dispatch
        # order — and retry them VERBATIM under the same txn_seq BEFORE any
        # new pendings commit; the broker's (restart-durable, replicated)
        # dedup then answers a commit that actually landed, instead of a
        # re-batched different payload being appended beside it. Kafka's
        # producer retries fixed batches for exactly this reason. A pipelined
        # window can strand up to max-in-flight batches at once.
        self._retry_batches: Deque[_Batch] = deque()
        self._retry_max = self.config.get_int(
            "surge.producer.publish-retry-max", 8)
        # command lane: "direct" = batch-level ack futures +
        # queued-request joins (no per-command future/withdraw machinery);
        # "classic" = the PR-3 per-command path (paired bench arm)
        self._direct = self.config.get_str(
            "surge.producer.command-lane", "direct") != "classic"
        #: entities consult this to pick the right timeout primitive: a
        #: shared ack must never be cancelled by one caller's timeout
        self.shared_acks = self._direct
        #: the forming batch's shared ack future (direct lane). Rotated at
        #: every batch-max-records boundary so a drained batch NEVER shares
        #: its ack with still-queued pendings (the one invariant batch-level
        #: resolution rests on; _take_batch splits only at count boundaries)
        self._forming_ack: Optional["asyncio.Future[None]"] = None
        #: request_id -> queued pending's ack: a caller-timeout retry JOINS
        #: the queued write instead of double-queueing (direct lane's
        #: replacement for classic's cancel-withdraw callback)
        self._queued_rids: Dict[str, "asyncio.Future[None]"] = {}
        # flush machinery: _wake = a pending exists, _batch_full = a size/bytes
        # trigger fired, _pending_room = backpressure gate (multi-waiter,
        # rare path — a plain Event is fine there)
        self._wake = _Signal()
        self._batch_full = _Signal()
        self._self_stops: set = set()  # not-owner teardown tasks (reaped)
        self._pending_room = asyncio.Event()
        self._pending_room.set()
        self._pending_bytes = 0
        self._first_pending_t: Optional[float] = None
        self._batch_counter = 0
        self._inflight = 0
        self._slots = asyncio.Semaphore(self._max_in_flight)
        self._commit_tasks: set = set()
        self._lane_pool = None  # single-thread commit lane (lazy; off-loop fsync)
        self._flush_task = BackgroundTask(self._flush_loop, f"publisher-flush-{partition}")
        self._progress_task = BackgroundTask(self._progress_loop, f"publisher-progress-{partition}")

    # -- lifecycle ----------------------------------------------------------------------

    async def start(self) -> None:
        self.state = "initializing"
        try:
            await self._initialize()
        except Exception as exc:
            # surface init failure to queued publishers instead of letting them ride
            # the timeout ladder with no root cause
            self.state = "failed"
            self.on_signal("surge.producer.init-failed", "error")
            for p in self._pending:
                fail_future(p.future, PublisherNotReadyError(f"init failed: {exc}"))
            self._pending.clear()
            self._queued_rids.clear()
            self._forming_ack = None
            raise
        # pipelining depth: transports without pipelined commits (in-process
        # logs) run ONE commit in flight per lane — the commit's own latency
        # then paces the group commit, growing batches under load instead of
        # queueing linger-sized ones behind the lane thread
        depth = self._max_in_flight if self._pipeline_capable() else 1
        self._slots = asyncio.Semaphore(depth)
        self._flush_task.start()
        self._progress_task.start()

    async def stop(self) -> None:
        self.state = "stopped"
        self._ready.clear()
        self._pending_room.set()  # release backpressure waiters to the state check
        await self._flush_task.stop()
        await self._progress_task.stop()
        if self._commit_tasks:
            # let in-flight commits resolve their waiters; cancel stragglers
            done, still = await asyncio.wait(list(self._commit_tasks),
                                             timeout=5.0)
            for t in still:
                t.cancel()
            if still:
                await asyncio.gather(*still, return_exceptions=True)
        for p in self._pending:
            fail_future(p.future, PublisherNotReadyError("publisher stopped"))
        self._pending.clear()
        self._pending_bytes = 0
        self._queued_rids.clear()
        self._forming_ack = None
        while self._retry_batches:
            batch = self._retry_batches.popleft()
            for p in batch.pendings:
                fail_future(p.future,
                            PublisherNotReadyError("publisher stopped"))
        self._committing.clear()
        self._committing_aggs.clear()
        if self._lane_pool is not None:
            self._lane_pool.shutdown(wait=False)
            self._lane_pool = None

    async def _initialize(self) -> None:
        """Open producer (fences zombies), commit the flush record, gate on store lag."""
        self._producer = self.log.transactional_producer(self.transactional_id)
        self._producer.begin()
        self._producer.send(LogRecord(topic=self.state_topic, key=None, value=b"",
                                      partition=self.partition,
                                      headers={"surge-flush": "1"}))
        # unsequenced when the transport supports it: the epoch marker's
        # duplicates are harmless, and it must not consume the broker's
        # one-shot reopen-absorption window that a stashed
        # landed-but-unacked batch needs after a broker restart
        commit = getattr(self._producer, "commit_unsequenced",
                         self._producer.commit)
        commit()
        self.state = "waiting_for_ktable"
        while True:
            end = self.log.end_offset(self.state_topic, self.partition)
            self._watermark = self.progress.indexed_watermark(self.state_topic, self.partition)
            if self._watermark >= end:
                break
            await asyncio.sleep(self._check_interval)
        self.state = "processing"
        self._ready.set()

    async def wait_ready(self, timeout: float = 30.0) -> None:
        # cancel-safe (and the fast-path lint's sanctioned coroutine wait)
        await cancel_safe_wait_for(self._ready.wait(), timeout)

    # -- publish path -------------------------------------------------------------------

    def publish(self, aggregate_id: str, records: Sequence[LogRecord],
                request_id: str,
                headers: Optional[Mapping[str, str]] = None):
        """Queue records for the next group commit; the returned awaitable
        resolves at commit. The hot path returns a BARE FUTURE (no coroutine,
        so the entity's ``asyncio.wait_for`` needs no wrapper task — a real
        per-command cost at engine throughput); dedup joins, backpressure and
        the traced path return a coroutine.

        Raises :class:`PublishFailedError` if the batch fails — callers (the aggregate
        entity's persistence ladder, KTablePersistenceSupport.scala:71-156) retry with
        the SAME ``request_id`` so a commit that actually landed is not repeated.

        ``headers`` may carry a W3C trace context: the publish span (queue →
        commit ack, the hop the reference wraps around its producer publish)
        then chains under the caller's entity span.
        """
        if self.tracer is None:
            if (self.state == "processing"
                    and request_id not in self._completed
                    and not self._retry_batches
                    and request_id not in self._committing
                    and len(self._pending) < self._pending_max):
                if self._direct:
                    ack = self._queued_rids.get(request_id)
                    if ack is not None:
                        # caller-timeout retry while the original is still
                        # queued: join the queued write, never double-queue
                        self.stats.dedup_hits += 1
                        if ack.cancelled():
                            ack = self._refresh_cancelled_ack(ack)
                        return ack
                return self._queue_pending(aggregate_id, records, request_id)
            return self._publish_slow(aggregate_id, records, request_id)
        return self._publish_traced(aggregate_id, records, request_id, headers)

    async def _publish_traced(self, aggregate_id: str,
                              records: Sequence[LogRecord], request_id: str,
                              headers: Optional[Mapping[str, str]]) -> None:
        span = self.tracer.start_span("publisher.publish",
                                      headers=headers or {})
        span.set_attribute("aggregate_id", aggregate_id)
        span.set_attribute("partition", self.partition)
        span.set_attribute("records", len(records))
        with span:  # records exceptions + finishes
            return await self._publish_slow(aggregate_id, records, request_id)

    def _queue_pending(self, aggregate_id: str, records: Sequence[LogRecord],
                       request_id: str) -> "asyncio.Future[None]":
        """Hot path: enqueue for the next group commit, return the ack future.

        Direct lane: every pending of the forming batch shares ONE ack
        future, resolved once at commit — no per-command future creation,
        no withdraw callback (a timed-out caller's records stay queued; its
        same-request_id retry joins via ``_queued_rids``). The ack rotates
        at each batch-max-records boundary so a drained batch never shares
        its ack with still-queued pendings."""
        nbytes = 0
        for r in records:
            nbytes += ((len(r.value) if r.value else 0)
                       + (len(r.key) if r.key else 0) + 24)
        trace_ctx = None
        if self.tracer is not None:
            # the caller's publish span (active: _publish_traced queues from
            # inside `with span:`): the flush span parents on it, keeping
            # the command's trace contiguous down to the broker
            from surge_tpu_torch.tracing import active_span

            span = active_span()
            if span is not None and span.context.sampled:
                trace_ctx = span.context
        if self._direct:
            fut = self._forming_ack
            if fut is None or fut.done():
                # done() covers a caller having cancelled the shared ack
                # outright: new publishes must never ride a dead future
                fut = self._forming_ack = \
                    asyncio.get_running_loop().create_future()
            pending = _Pending(request_id, aggregate_id, list(records), fut,
                               nbytes, trace_ctx=trace_ctx)
            self._pending.append(pending)
            self._queued_rids[request_id] = fut
            self._pending_bytes += nbytes
            if self._first_pending_t is None:
                self._first_pending_t = time.monotonic()
            self._wake.set()
            if len(self._pending) % self._batch_max_records == 0:
                self._forming_ack = None  # next pending opens a new batch ack
            if (len(self._pending) >= self._batch_max_records
                    or self._pending_bytes >= self._batch_max_bytes):
                self._batch_full.set()
            return fut
        fut = asyncio.get_running_loop().create_future()
        pending = _Pending(request_id, aggregate_id, list(records), fut,
                           nbytes, trace_ctx=trace_ctx)
        self._pending.append(pending)
        self._pending_bytes += nbytes
        if self._first_pending_t is None:
            self._first_pending_t = time.monotonic()
        self._wake.set()
        if (len(self._pending) >= self._batch_max_records
                or self._pending_bytes >= self._batch_max_bytes):
            self._batch_full.set()
        # caller timed out (future cancelled): withdraw the queued write so a
        # same-request_id retry does not double-queue it. If the flush already
        # drained it, the commit may still land — then the retry is absorbed
        # by the _completed dedup (or joins the in-flight commit / in-limbo
        # batch).
        fut.add_done_callback(lambda f: self._withdraw(pending)
                              if f.cancelled() else None)
        return fut

    @staticmethod
    async def _join_shared(fut: "asyncio.Future[None]") -> None:
        """Join a possibly-SHARED future shielded from this caller's
        cancellation, with the wait_future(owned=False) contract: a
        co-holder cancelling the shared future surfaces as a retryable
        PublishFailedError (the queued records still commit; the retry
        ladder rejoins by request id), never as CancelledError — while a
        REAL outer cancellation (which leaves the shared future pending)
        re-raises untouched."""
        try:
            await asyncio.shield(fut)
        except asyncio.CancelledError:
            if fut.cancelled():
                raise PublishFailedError(
                    "shared batch ack cancelled by another holder; retry")
            raise

    def _refresh_cancelled_ack(self, old: "asyncio.Future[None]"
                               ) -> "asyncio.Future[None]":
        """A caller cancelled a shared batch ack directly (the classic
        cancel-to-withdraw reflex; the direct lane's own timeout never
        cancels). The queued records still commit — swap in a fresh future
        for every pending riding the cancelled one so rejoining retries see
        the batch's real outcome, not the stale cancellation."""
        fresh: "asyncio.Future[None]" = \
            asyncio.get_running_loop().create_future()
        for p in self._pending:
            if p.future is old:
                p.future = fresh
        for rid, f in self._queued_rids.items():
            if f is old:
                self._queued_rids[rid] = fresh
        if self._forming_ack is old:
            self._forming_ack = fresh
        return fresh

    def _withdraw(self, pending: _Pending) -> None:
        try:
            self._pending.remove(pending)
            self._pending_bytes = max(0, self._pending_bytes - pending.nbytes)
        except ValueError:
            pass

    async def _publish_slow(self, aggregate_id: str,
                            records: Sequence[LogRecord],
                            request_id: str) -> None:
        if self.state not in ("processing", "waiting_for_ktable", "initializing"):
            raise PublisherNotReadyError(f"publisher state={self.state}")
        if request_id in self._completed:
            self.stats.dedup_hits += 1
            return
        if self._direct:
            ack = self._queued_rids.get(request_id)
            if ack is not None:
                # retry of a still-queued request (caller timed out before
                # the batch formed): join the queued write's batch ack
                self.stats.dedup_hits += 1
                if ack.cancelled():
                    ack = self._refresh_cancelled_ack(ack)
                await self._join_shared(ack)
                return
        for rb in self._retry_batches:
            for sp in rb.pendings:
                if sp.request_id == request_id:
                    # this request rides the in-limbo batch: join its outcome.
                    # If the original caller's timeout CANCELLED the waiter
                    # future, swap in a fresh one — the retry resolves
                    # whatever future the pending holds, and the rejoiner
                    # must see the batch's outcome, not the old cancellation.
                    self.stats.dedup_hits += 1
                    if sp.future.cancelled():
                        sp.future = asyncio.get_running_loop().create_future()  # surgelint: disable=hot-path-asyncio # rare rejoin slow path, not per-command
                    await self._join_shared(sp.future)  # surgelint: disable=hot-path-asyncio # rare rejoin slow path, not per-command
                    return
        committing = self._committing.get(request_id)
        if committing is not None:
            # this request's batch is mid-commit (the caller timed out and retried
            # while the transaction was in flight): join the outcome, never re-queue
            self.stats.dedup_hits += 1
            outcome = await asyncio.shield(committing)
            if outcome is not None:
                raise PublishFailedError(str(outcome))
            return
        # backpressure: overload queues no further than pending-max — the
        # caller waits for lane headroom (memory stays bounded; the entity's
        # publish timeout is the escape hatch if the lane never drains)
        while (len(self._pending) >= self._pending_max
               and self.state in ("processing", "waiting_for_ktable",
                                  "initializing")):
            self._pending_room.clear()
            await self._pending_room.wait()
        if self.state not in ("processing", "waiting_for_ktable", "initializing"):
            raise PublisherNotReadyError(f"publisher state={self.state}")
        ack = self._queue_pending(aggregate_id, records, request_id)
        if self._direct:
            # SHIELD the shared batch ack: this coroutine runs under the
            # entity's cancel-on-timeout wrapper, and a task cancellation
            # lands on the future it is parked on — unshielded, one caller's
            # timeout would cancel every sibling publish in the batch
            await asyncio.shield(ack)
        else:
            await ack

    def request_disposition(self, request_id: str) -> Optional[str]:
        """Where a request id sits in this publisher's dedup window:
        ``"completed"`` (committed inside the TTL window), ``"in-flight"``
        (queued / in-limbo / mid-commit), or None (never seen, or aged out).

        The entity consults this BEFORE running ``process_command`` for a
        caller-supplied request id (the saga manager's deterministic rids):
        a re-delivered command must short-circuit at the entity, because
        re-running the handler would fold its events into in-memory state a
        second time even though the publish itself dedups."""
        if request_id in self._completed:
            return "completed"
        if request_id in self._queued_rids or request_id in self._committing:
            return "in-flight"
        for rb in self._retry_batches:
            if any(sp.request_id == request_id for sp in rb.pendings):
                return "in-flight"
        if any(p.request_id == request_id for p in self._pending):
            return "in-flight"
        return None

    def is_aggregate_state_current(self, aggregate_id: str) -> bool:
        """True iff nothing published for this aggregate is still ahead of the store's
        indexed watermark and nothing is pending (KafkaProducerActorImpl.scala:530-540)."""
        if any(p.aggregate_id == aggregate_id for p in self._pending):
            return False
        if self._committing_aggs.get(aggregate_id):
            return False  # a commit is in flight for this aggregate right now
        for rb in self._retry_batches:
            if any(p.aggregate_id == aggregate_id for p in rb.pendings):
                return False  # an in-limbo write is ahead of the store by definition
        off = self._in_flight.get(aggregate_id)
        if off is None:
            return True
        return off < self._watermark

    # -- internal loops -----------------------------------------------------------------

    async def _flush_loop(self) -> None:
        # the loop must be unkillable by a bug: _publish_batch fails batches
        # on expected errors, but an escape here would end the task SILENTLY
        # and every later command on this partition would time out with no
        # root cause — same hazard class as the broker's replication worker
        while True:
            try:
                # wake-on-first-pending, or the housekeeping tick
                await self._wake.wait(self._flush_interval)
                if self.state in ("fenced", "waiting_for_ktable"):
                    # a fencing-triggered re-init that RAISED mid-way (broker
                    # briefly unreachable — it may already have advanced state
                    # past "fenced" before the escape) left init incomplete:
                    # keep retrying on the tick instead of sitting
                    # dead-but-running forever. _handle_fenced also covers
                    # the lost-ownership shutdown path.
                    await self._handle_fenced()
                if self._retry_batches and self.state == "processing":
                    # in-limbo batches retry VERBATIM, oldest dispatch first,
                    # before any new pendings commit (same txn_seq -> the
                    # broker dedup can answer a commit that landed); the
                    # pipeline drains first so the retry runs alone
                    await self._drain_inflight()
                    if self._retry_batches and self.state == "processing":
                        rb = self._retry_batches[0]
                        if self.flight is not None:
                            self.flight.record(
                                "lane.retry", partition=self.partition,
                                batch=rb.index, attempt=rb.attempts,
                                records=len(rb.records))
                        await self._publish_batch(rb)
                        if self._retry_batches and self._retry_batches[0] is rb:
                            # still failing: pace the next attempt on the tick
                            await asyncio.sleep(self._flush_interval)
                elif self._pending and self.state == "processing":
                    await self._await_linger()
                    if self.state == "processing":
                        batch = self._take_batch()
                        if batch is not None:
                            await self._dispatch(batch)
                self._purge_dedup()
            except Exception:  # noqa: BLE001 — log loudly, keep flushing
                logger.exception("flush loop iteration failed on %s[%d]; "
                                 "continuing", self.state_topic, self.partition)
                try:
                    self.on_signal("surge.producer.flush-loop-error", "error")
                except Exception:  # noqa: BLE001 — a raising signal sink must
                    logger.exception("on_signal failed")  # not kill the loop

    async def _await_linger(self) -> None:
        """Hold the batch open until linger elapses from the FIRST pending —
        or a size/bytes trigger fires first (wake-on-full)."""
        if self._linger_s <= 0 or self._first_pending_t is None:
            return
        deadline = self._first_pending_t + self._linger_s
        while not self._batch_full.is_set() and self.state == "processing":
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            if not await self._batch_full.wait(remaining):
                return

    def _take_batch(self) -> Optional[_Batch]:
        """Drain up to batch-max-records pendings into one commit unit."""
        if not self._pending:
            self._wake.clear()
            self._batch_full.clear()
            self._first_pending_t = None
            return None
        now = time.monotonic()
        formed_at = self._first_pending_t if self._first_pending_t is not None else now
        if len(self._pending) <= self._batch_max_records:
            pendings, self._pending = self._pending, []
            self._forming_ack = None  # the next pending opens a fresh ack
        else:
            pendings = self._pending[:self._batch_max_records]
            del self._pending[:self._batch_max_records]
            # leftovers keep their own ack(s): the rotation at every
            # batch-max boundary guarantees none of them share the drained
            # batch's future
        if self._direct:
            pop = self._queued_rids.pop
            for p in pendings:
                pop(p.request_id, None)
        self._pending_bytes = max(
            0, self._pending_bytes - sum(p.nbytes for p in pendings))
        self._pending_room.set()
        if self._pending:
            self._first_pending_t = now  # leftover pendings restart the linger
            if (len(self._pending) < self._batch_max_records
                    and self._pending_bytes < self._batch_max_bytes):
                self._batch_full.clear()
        else:
            self._wake.clear()
            self._batch_full.clear()
            self._first_pending_t = None
        records = [r for p in pendings for r in p.records]
        self._batch_counter += 1
        if self.metrics is not None:
            self.metrics.producer_linger_timer.record_ms((now - formed_at) * 1000.0)
            self.metrics.producer_lane_pending.record(len(self._pending))
        batch = _Batch(pendings, records, self._batch_counter)
        # register the mid-commit join point NOW (not when the commit task
        # first runs): between drain and task start a caller-timeout retry
        # must find its request in _committing, or it would double-queue
        batch.outcome = asyncio.get_running_loop().create_future()
        for p in pendings:
            self._committing[p.request_id] = batch.outcome
            self._committing_aggs[p.aggregate_id] = \
                self._committing_aggs.get(p.aggregate_id, 0) + 1
        return batch

    def _pipeline_capable(self) -> bool:
        return (self._transactions_enabled
                and not self._single_record_opt_in
                and self._producer is not None
                and hasattr(self._producer, "commit_pipelined"))

    def _open_flush_span(self, batch: _Batch):
        """One commit attempt's flush span, parented on the batch's first
        traced pending (module doc at _publish_batch); trace ids of the
        OTHER commands riding the same group commit go on ``trace.links``."""
        parent = next((p.trace_ctx for p in batch.pendings
                       if p.trace_ctx is not None), None)
        span = self.tracer.start_span("publisher.flush", parent=parent)
        span.set_attribute("partition", self.partition)
        span.set_attribute("batch_publishes", len(batch.pendings))
        span.set_attribute("batch_records", len(batch.records))
        if parent is not None:
            links = {p.trace_ctx.trace_id for p in batch.pendings
                     if p.trace_ctx is not None} - {parent.trace_id}
            if links:
                span.set_attribute("trace.links", sorted(links))
        return span

    def _start_pipelined(self, batch: _Batch) -> None:
        """Assign the batch's txn_seq and ship its Transact NOW (in dispatch
        order, on the loop) — the await happens in the commit task. A dispatch
        failure is recorded on the batch and surfaces through the shared
        commit-failure ladder."""
        try:
            if self.tracer is not None and batch.span is None:
                # opened BEFORE the Transact leaves (and activated around
                # the dispatch): the transport copies the calling context
                # into its pipeline pool, so the broker-call span — and the
                # broker-side span its traceparent seeds — chain under this
                # flush span instead of rooting fresh traces
                batch.span = self._open_flush_span(batch)
            if getattr(self._producer, "in_transaction", False):
                self._producer.abort()  # local buffer left by a failed dispatch
            # activate only if not already active: a re-dispatch from inside
            # _publish_batch's `with span:` block must not consume the with
            # block's activation token (deactivating the flush span for the
            # rest of the attempt — exemplars and child spans would detach)
            did_activate = (batch.span is not None
                            and batch.span._cv_token is None)
            if did_activate:
                batch.span.activate()
            try:
                self._producer.begin()
                for r in batch.records:
                    self._producer.send(r)
                batch.handle = self._producer.commit_pipelined()
            finally:
                if did_activate:
                    batch.span._deactivate()
        except Exception as exc:  # noqa: BLE001
            batch.dispatch_error = exc

    async def _dispatch(self, batch: _Batch) -> None:
        """Acquire an in-flight slot, ship the commit, return to batching."""
        await self._slots.acquire()
        self._inflight += 1
        if self._inflight > self.stats.inflight_peak:
            self.stats.inflight_peak = self._inflight
        if self.metrics is not None:
            self.metrics.producer_in_flight.record(self._inflight)
        if self.flight is not None:
            self.flight.record("lane.dispatch", partition=self.partition,
                               batch=batch.index, records=len(batch.records),
                               inflight=self._inflight)
        if self._pipeline_capable():
            self._start_pipelined(batch)
        task = asyncio.ensure_future(self._commit_task(batch))
        self._commit_tasks.add(task)
        task.add_done_callback(self._commit_tasks.discard)

    async def _commit_task(self, batch: _Batch) -> None:
        try:
            await self._publish_batch(batch)
        except asyncio.CancelledError:
            # publisher stopping: the drained batch's waiters must not hang
            for p in batch.pendings:
                fail_future(p.future,
                            PublisherNotReadyError("publisher stopped"))
            raise
        except Exception as exc:  # noqa: BLE001 — post-commit bookkeeping bug
            logger.exception("publish batch escaped on %s[%d]; failing its "
                             "waiters", self.state_topic, self.partition)
            # fail the waiters so the entity ladder retries with the same
            # request_id. (If the commit actually landed before the escape,
            # the broker's restart-durable txn_seq cache absorbs the replay.)
            for p in batch.pendings:
                fail_future(p.future, PublishFailedError(
                    f"publish batch error: {exc}"))
            try:
                self.on_signal("surge.producer.flush-loop-error", "error")
            except Exception:  # noqa: BLE001
                logger.exception("on_signal failed")
        finally:
            self._inflight -= 1
            if self.metrics is not None:
                self.metrics.producer_in_flight.record(self._inflight)
            self._slots.release()

    async def _drain_inflight(self) -> None:
        """Wait for every dispatched commit to resolve (retry/stop barrier)."""
        while self._commit_tasks:
            await asyncio.wait(list(self._commit_tasks))
            await asyncio.sleep(0)  # let done-callbacks run

    async def _progress_loop(self) -> None:
        while True:
            try:
                self._refresh_watermark()
            except Exception:  # noqa: BLE001 — e.g. transient store lookup
                logger.exception("watermark refresh failed on %s[%d]; "
                                 "continuing", self.state_topic, self.partition)
            await asyncio.sleep(self._check_interval)

    def _refresh_watermark(self) -> None:
        self._watermark = self.progress.indexed_watermark(self.state_topic, self.partition)
        for agg_id in [a for a, off in self._in_flight.items() if off < self._watermark]:
            del self._in_flight[agg_id]
        self.stats.in_flight = len(self._in_flight)

    async def flush_now(self) -> None:
        """Immediate flush (test/shutdown hook; production path is event-driven)."""
        while self._pending and self.state == "processing":
            await self._drain_inflight()
            batch = self._take_batch()
            if batch is None:
                return
            if self._pipeline_capable():
                self._start_pipelined(batch)
            await self._publish_batch(batch)

    async def _publish_batch(self, batch: _Batch) -> None:
        outcome = batch.outcome
        if outcome is None or outcome.done():
            # a RETRY attempt (the previous attempt resolved its outcome):
            # fresh join point under the same request ids. The aggregate
            # refcount stays as _take_batch counted it — the batch was never
            # terminal in between.
            outcome = asyncio.get_running_loop().create_future()
            batch.outcome = outcome
            for p in batch.pendings:
                self._committing[p.request_id] = outcome
        # the flush-transaction span parents on the batch's FIRST pending's
        # publish span (command anatomy): a single command's trace
        # is then contiguous ref → entity → publish → flush → broker call.
        # One commit still serves many pending publishes — the other
        # commands' trace ids ride the `trace.links` attribute (the OTel
        # span-link role), each already tracked by its own publish span.
        span = batch.span
        if span is None and self.tracer is not None:
            span = batch.span = self._open_flush_span(batch)
        try:
            if span is None:
                await self._publish_batch_inner(batch, outcome)
            else:
                with span:
                    await self._publish_batch_inner(batch, outcome)
        finally:
            batch.span = None  # a retry attempt opens a fresh flush span
            if not outcome.done():
                outcome.set_result(RuntimeError("publish batch aborted"))
            # unregister only when the batch is TERMINAL (committed, or its
            # waiters failed); a stashed in-limbo batch keeps its entries —
            # the slow path's retry-join runs BEFORE the committing-join, so
            # a rejoining request still lands on the verbatim retry
            if not any(b is batch for b in self._retry_batches):
                for p in batch.pendings:
                    self._committing.pop(p.request_id, None)
                    n = self._committing_aggs.get(p.aggregate_id, 0)
                    if n <= 1:
                        self._committing_aggs.pop(p.aggregate_id, None)
                    else:
                        self._committing_aggs[p.aggregate_id] = n - 1

    def _lane(self):
        """The lane's single commit thread: producer calls stay strictly
        ordered while fsync-heavy commits run OFF the event loop, letting
        other partitions' lanes (and the loop itself) proceed."""
        if self._lane_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._lane_pool = ThreadPoolExecutor(
                max_workers=1,
                thread_name_prefix=f"surge-commit-{self.partition}")
        return self._lane_pool

    def _commit_txn_blocking(self, batch: _Batch) -> List[LogRecord]:
        if getattr(self._producer, "in_transaction", False):
            self._producer.abort()  # buffer left open by a failed attempt
        self._producer.begin()
        for r in batch.records:
            self._producer.send(r)
        return list(self._producer.commit())

    def _commit_nontxn_blocking(self, batch: _Batch) -> List[LogRecord]:
        # per-record appends: a mid-batch failure must not re-append any
        # already-written record on the entity's same-request_id retry, so
        # the appended records themselves are kept per request and retries
        # resume after them (contributing the full list to `committed` so
        # the offset-alignment loop stays 1:1 with p.records)
        committed: List[LogRecord] = []
        for p in batch.pendings:
            done = self._partial_records.setdefault(p.request_id, [])
            self._partial_touched[p.request_id] = time.time()
            for i in range(len(done), len(p.records)):
                done.append(self._producer.send_immediate(p.records[i]))
            committed.extend(done)
        # every append landed: the batch is durable, drop the resume state
        for p in batch.pendings:
            self._partial_records.pop(p.request_id, None)
            self._partial_touched.pop(p.request_id, None)
        return committed

    async def _run_lane(self, fn, *args):
        """Run one blocking commit call on the lane thread. Traced
        publishers copy the calling context (the flush span above all) into
        the thread so the transport's broker-call span — read off
        ``active_span()`` over there — chains under the flush span instead
        of rooting a fresh trace; untraced publishers pay nothing."""
        loop = asyncio.get_running_loop()
        if self.tracer is None:
            return await loop.run_in_executor(self._lane(), fn, *args)
        import contextvars

        ctx = contextvars.copy_context()
        return await loop.run_in_executor(self._lane(), ctx.run, fn, *args)

    async def _commit_batch(self, batch: _Batch) -> List[LogRecord]:
        """Route one batch to its commit path; raises what the commit raised."""
        if batch.dispatch_error is not None:
            exc, batch.dispatch_error = batch.dispatch_error, None
            raise exc
        if not self._transactions_enabled:
            return await self._run_lane(self._commit_nontxn_blocking, batch)
        if self._single_record_opt_in and len(batch.records) == 1:
            return [await self._run_lane(
                self._producer.send_immediate, batch.records[0])]
        h = batch.handle
        if h is not None:
            if h.future.done() and (h.future.cancelled()
                                    or h.future.exception() is not None):
                # verbatim retry: same txn_seq on the same producer. A
                # producer re-opened since (new epoch after fencing) cannot
                # reuse the old token's seq — re-dispatch fresh below; the
                # broker's reopen absorption / numbering-past-pending-seqs
                # keeps a landed commit from doubling.
                if getattr(h, "producer", None) is self._producer:
                    self._producer.retry_pipelined(h)
                else:
                    batch.handle = None
                    return await self._commit_batch(batch)
            return await asyncio.wrap_future(batch.handle.future)
        if self._pipeline_capable():
            self._start_pipelined(batch)
            if batch.dispatch_error is not None:
                exc, batch.dispatch_error = batch.dispatch_error, None
                raise exc
            return await asyncio.wrap_future(batch.handle.future)
        return await self._run_lane(self._commit_txn_blocking, batch)

    async def _publish_batch_inner(self, batch: _Batch,
                                   outcome: "asyncio.Future[Optional[Exception]]") -> None:
        records = batch.records
        t0 = time.perf_counter()
        try:
            committed = await self._commit_batch(batch)
        except ProducerFencedError as exc:
            self.stats.fences += 1
            if self.metrics is not None:
                self.metrics.fence_counter.record()
            self.on_signal("surge.producer.fenced", "error")
            outcome.set_result(exc)
            if self._transactions_enabled:
                # outcome unknown (a failover ack may have landed): hold the
                # batch for a verbatim retry after re-init — the new broker's
                # replicated/durable dedup absorbs a landed commit
                self._stash_or_exhaust(batch, exc)
            else:
                for p in batch.pendings:
                    fail_future(p.future, PublishFailedError(
                        f"publisher for partition {self.partition} was fenced"))
            self._note_fenced()
            return
        except Exception as exc:  # noqa: BLE001 — transport failure: outcome unknown
            self.stats.batches_failed += 1
            if self.metrics is not None:
                self.metrics.publish_failure_counter.record()
            try:
                if getattr(self._producer, "in_transaction", False):
                    self._producer.abort()
            except Exception:  # noqa: BLE001
                self.on_signal("surge.producer.abort-failed", "error")
            outcome.set_result(exc)
            if self._transactions_enabled:
                self._stash_or_exhaust(batch, exc)
            else:
                # non-transactional mode has its own per-record resume state
                for p in batch.pendings:
                    fail_future(p.future, PublishFailedError(str(exc)))
            return

        elapsed = time.perf_counter() - t0
        if self.metrics is not None:
            self.metrics.flush_timer.record_ms(elapsed * 1000.0)
            self.metrics.producer_batch_records.record(len(records))
            self.metrics.producer_batch_commits.record()
        if len(records) > self.stats.max_batch_records:
            self.stats.max_batch_records = len(records)
        if elapsed > self._slow_txn_s:
            logger.warning("slow publish transaction: %.3fs on %s[%d]",
                           elapsed, self.state_topic, self.partition)
        # in-flight tracking: the max state-topic offset per aggregate in this commit
        by_index = iter(committed)
        now = time.time()
        for p in batch.pendings:
            max_state_off = None
            for _ in p.records:
                rec = next(by_index)
                if rec.topic == self.state_topic:
                    max_state_off = rec.offset if max_state_off is None else max(max_state_off, rec.offset)
            if max_state_off is not None:
                cur = self._in_flight.get(p.aggregate_id)
                if cur is None or max_state_off > cur:
                    self._in_flight[p.aggregate_id] = max_state_off
            self._completed[p.request_id] = now
            resolve_future(p.future, None)
        outcome.set_result(None)
        try:
            self._retry_batches.remove(batch)
        except ValueError:
            pass
        self.stats.flushes += 1
        self.stats.records_published += len(records)
        self.stats.in_flight = len(self._in_flight)

    def _note_fenced(self) -> None:
        """Mark the lane fenced; the flush loop's next tick runs the
        re-initialize-or-shutdown ladder (one reinit even when several
        pipelined commits observe the fence concurrently)."""
        if self.state == "processing":
            self.state = "fenced"
            self._ready.clear()
            if self.flight is not None:
                self.flight.record("lane.fence", partition=self.partition,
                                   fences=self.stats.fences)

    def _stash_or_exhaust(self, batch: _Batch, exc: Exception) -> None:
        """Keep an unknown-outcome batch for verbatim retry, bounded: after
        publish-retry-max attempts its waiters fail (the entity ladder takes
        over) and the batch is dropped — a deterministically-failing batch
        must not block the partition forever. Up to a pipelined window of
        batches can be in limbo at once; they retry in dispatch order."""
        if not any(b is batch for b in self._retry_batches):
            if len(self._retry_batches) >= self._max_in_flight + 1:
                # more limbo than the pipeline window can produce (e.g. a
                # flush_now drain during limbo): fail the newcomer's waiters
                # so their entities retry, leaving the window's accounting
                # untouched
                for p in batch.pendings:
                    fail_future(p.future, PublishFailedError(str(exc)))
                return
            batch.attempts = 1
            at = 0
            for i, b in enumerate(self._retry_batches):
                if b.index > batch.index:
                    break
                at = i + 1
            self._retry_batches.insert(at, batch)
        else:
            batch.attempts += 1
        if batch.attempts > self._retry_max:
            logger.error(
                "publish batch on %s[%d] failed %d verbatim retries (%s); "
                "failing its waiters", self.state_topic, self.partition,
                batch.attempts, exc)
            for p in batch.pendings:
                fail_future(p.future, PublishFailedError(str(exc)))
            try:
                self._retry_batches.remove(batch)
            except ValueError:
                pass
            if batch.handle is not None and getattr(batch.handle, "seq", 0):
                # the dropped batch CONSUMED a txn_seq at dispatch; abandoning
                # it would leave a permanent hole the broker's in-order gate
                # blocks every later seq behind. Force the lane through the
                # re-initialize ladder: the re-opened producer resumes its
                # numbering from the broker's acked/applied frontier, closing
                # the hole (and later in-limbo batches re-dispatch fresh on
                # the new producer).
                self._note_fenced()
        else:
            self.on_signal("surge.producer.publish-retry", "warning")

    async def _handle_fenced(self) -> None:
        """Fenced: re-init if we still own the partition, else shut down
        (KafkaProducerActorImpl.scala:502-528)."""
        self.state = "fenced"
        self._ready.clear()
        if self.still_owner():
            self.stats.reinitializations += 1
            self.on_signal("surge.producer.reinitializing", "warning")
            # partition-routed transports (surge_tpu_torch.cluster.PartitionRouter)
            # cache this partition's leader: a fence very often MEANS the
            # leadership moved, so drop the cached hint before re-opening —
            # the fresh producer then resolves against the current map
            # instead of bouncing off the stale endpoint once more
            invalidate = getattr(self.log, "invalidate_partition", None)
            if invalidate is not None:
                try:
                    invalidate(self.state_topic, self.partition)
                except Exception:  # noqa: BLE001 — routing hint only
                    logger.exception("leader-hint invalidation failed")
            try:
                await self._initialize()
                if self.flight is not None:
                    self.flight.record(
                        "lane.rejoin", partition=self.partition,
                        reinitializations=self.stats.reinitializations)
            except NotLeaderError as exc:
                # the broker cluster is mid-failover (every reachable broker
                # is a follower; promotion has not landed yet): stay fenced
                # and retry on the housekeeping tick — a warning, not the
                # error-spam an exception escape would log
                self.state = "fenced"
                self.on_signal("surge.producer.waiting-for-leader", "warning")
                logger.warning(
                    "publisher %s[%d] waiting for a log leader: %s",
                    self.state_topic, self.partition, exc)
        else:
            self.on_signal("surge.producer.shutdown-not-owner", "warning")
            # runs inside the flush loop: mark stopped now, cancel the loops from a
            # separate task (a task cannot await its own cancellation);
            # retained + reaped so the teardown can't be GC'd mid-stop and a
            # failing stop logs instead of rotting
            self.state = "stopped"
            spawn_reaped(self._self_stops, self.stop(),
                         f"publisher {self.state_topic}[{self.partition}] "
                         "not-owner self-stop")

    def _purge_dedup(self) -> None:
        cutoff = time.time() - self._dedup_ttl_s
        for rid in [r for r, t in self._completed.items() if t < cutoff]:
            del self._completed[rid]
        # partial-resume state whose entity never retried again (crashed out of its
        # retry ladder) ages out on the same TTL
        for rid in [r for r, t in self._partial_touched.items() if t < cutoff]:
            self._partial_touched.pop(rid, None)
            self._partial_records.pop(rid, None)
