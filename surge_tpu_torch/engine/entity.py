"""Per-aggregate single-writer entity — the PersistentActor equivalent.

Re-derivation of the reference FSM (modules/command-engine/core/src/main/scala/surge/
internal/persistence/PersistentActor.scala:100-365) as one asyncio task per live
aggregate id, with the mailbox doubling as the stash:

- ``initializing``: the KTable init protocol (KTableInitializationSupport.scala:20-82) —
  poll ``is_aggregate_state_current`` on the partition publisher with bounded retries,
  then fetch + deserialize the snapshot from the state store; messages arriving
  meanwhile simply wait in the mailbox (the uninitialized-stash of
  PersistentActor.scala:174-195).
- ``free_to_process``: pop one envelope at a time (single-writer guarantee); commands run
  the user model, fold events, serialize off-thread, and
- ``persisting``: publish events + state through the partition publisher with the
  bounded retry ladder of KTablePersistenceSupport.scala:71-156 — same request id on
  every attempt (publisher dedup makes retries idempotent), timeout per attempt, and a
  **crash** after max retries (the parent recreates the entity, which re-reads state
  from the store — PersistentActor.onPersistenceFailure:357-364).
- idle passivation after ``surge.aggregate.idle-passivation-ms`` (:287-296), negotiated
  with the parent shard so late messages are buffered, never lost.

Error surface mirrors ACKSuccess/ACKError/ACKRejection (:33-64): domain rejections
(``RejectedCommand``) → :class:`CommandRejected`; model/fold/serialization exceptions →
:class:`CommandFailure` with the entity staying alive; persistence exhaustion →
:class:`CommandFailure` AND entity crash.
"""

from __future__ import annotations

# surgelint: fast-path-module — the per-command entity FSM

import asyncio
import inspect
import uuid
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

from surge_tpu_torch.common import (DecodedState, cancel_safe_wait_for, fail_future,
                              logger, resolve_future, wait_future)
from surge_tpu_torch.config import Config, RetryConfig, TimeoutConfig, default_config
from surge_tpu_torch.engine.business_logic import SurgeModel
from surge_tpu_torch.engine.model import RejectedCommand
from surge_tpu_torch.engine.publisher import PartitionPublisher
from surge_tpu_torch.metrics import EngineMetrics, engine_metrics

# fallback quiver for entities constructed outside a pipeline (tests, tools)
_DEFAULT_METRICS: EngineMetrics | None = None


def _default_metrics() -> EngineMetrics:
    global _DEFAULT_METRICS
    if _DEFAULT_METRICS is None:
        _DEFAULT_METRICS = engine_metrics()
    return _DEFAULT_METRICS


# -- message + result ADTs (PersistentActor.scala:33-64, AggregateRefResult.scala:5-11) --


#: envelope-header key carrying a caller-supplied request id (the saga
#: manager's deterministic saga-scoped rids). When present, the entity
#: publishes under THIS id instead of minting one — so a re-delivered
#: command after timeout/crash/failover dedups against the publisher's
#: completed window instead of folding twice.
REQUEST_ID_HEADER = "surge-request-id"


@dataclass
class ProcessMessage:
    command: Any


@dataclass
class GetState:
    pass


@dataclass
class ApplyEvents:
    events: Sequence[Any]


class Envelope:
    """One mailbox delivery. A plain __slots__ class, not a dataclass: one
    Envelope is built per command and the generated dataclass __init__ +
    default_factory machinery was measurable at engine throughput."""

    __slots__ = ("message", "reply", "headers")

    def __init__(self, message: Any, reply: "asyncio.Future[Any]",
                 headers: dict | None = None) -> None:
        self.message = message
        self.reply = reply
        self.headers = headers if headers is not None else {}  # trace context


@dataclass
class CommandSuccess:
    state: Any  # the post-command aggregate state (None = deleted/empty)


@dataclass
class CommandRejected:
    reason: Exception


@dataclass
class CommandFailure:
    error: Exception


class EntityCrashed(Exception):
    """The entity died mid-processing (persistence exhaustion or init failure)."""


class _Mailbox:
    """Minimal mailbox: a deque plus one waiter future. ``asyncio.Queue.get``
    under ``wait_for`` costs a wrapper task + timeout machinery per message —
    a real tax at engine throughput; here an idle entity parks on a bare
    future and the idle timeout is a single ``call_later`` handle."""

    __slots__ = ("_items", "_waiter")

    def __init__(self) -> None:
        from collections import deque

        self._items: "deque[Envelope]" = deque()
        self._waiter: Optional["asyncio.Future[Optional[Envelope]]"] = None

    def put_nowait(self, env: Envelope) -> None:
        w = self._waiter
        if w is not None and not w.done():
            self._waiter = None
            w.set_result(env)
        else:
            self._items.append(env)

    def empty(self) -> bool:
        return not self._items

    def get_nowait(self) -> Envelope:
        return self._items.popleft()

    async def get_or_idle(self, idle_s: float) -> Optional[Envelope]:
        """Next envelope, or None after ``idle_s`` with no delivery."""
        if self._items:
            return self._items.popleft()
        loop = asyncio.get_running_loop()
        waiter: "asyncio.Future[Optional[Envelope]]" = loop.create_future()
        self._waiter = waiter
        timer = loop.call_later(idle_s, resolve_future, waiter, None)
        try:
            return await waiter
        finally:
            timer.cancel()
            if self._waiter is waiter:
                self._waiter = None


class AggregateEntity:
    """One live aggregate: mailbox task + FSM state."""

    def __init__(self, aggregate_id: str, surge_model: SurgeModel,
                 publisher: PartitionPublisher,
                 fetch_state: Callable[[str], Optional[bytes]],
                 partition: int = 0, config: Config | None = None,
                 on_passivate: Callable[[str], None] | None = None,
                 on_stopped: Callable[[str, List[Envelope], bool], None] | None = None,
                 metrics: EngineMetrics | None = None, tracer=None) -> None:
        self.aggregate_id = aggregate_id
        self.surge_model = surge_model
        self.model = surge_model.logic.model
        # resolved once: process_command/handle_events run per command — the
        # attribute walk (and the handle_events getattr per fold) is pure
        # per-call overhead on the Transact path
        self._model_process = self.model.process_command
        self._model_batch_fold = getattr(self.model, "handle_events", None)
        self._model_fold = getattr(self.model, "handle_event", None)
        self.publisher = publisher
        self.fetch_state = fetch_state
        self.partition = partition
        self.config = config or default_config()
        self.on_passivate = on_passivate or (lambda agg_id: None)
        self.on_stopped = on_stopped or (lambda agg_id, leftovers, crashed: None)
        self.metrics = metrics or _default_metrics()
        self.tracer = tracer
        self.retry = RetryConfig.from_config(self.config)
        self.timeouts = TimeoutConfig.from_config(self.config)
        self._idle_s = self.config.get_seconds("surge.aggregate.idle-passivation-ms", 30_000)
        self.state_name = "created"
        self.state: Any = None
        self._mailbox = _Mailbox()
        self._task: Optional[asyncio.Task] = None
        # request-id source: one urandom draw per ENTITY (not per command —
        # uuid4's syscall is measurable at engine throughput); a restart makes
        # a fresh entity, so prefix+counter stays globally unique
        self._rid_prefix = uuid.uuid4().hex[:16]
        self._rid_n = 0

    # -- public surface -----------------------------------------------------------------

    def start(self) -> None:
        self._task = asyncio.ensure_future(self._run())
        self._task.set_name(f"entity-{self.aggregate_id}")

    def deliver(self, env: Envelope) -> None:
        if self.state_name == "stopped":
            raise EntityCrashed(f"entity {self.aggregate_id} is stopped")
        self._mailbox.put_nowait(env)

    async def stop(self) -> None:
        if self._task is not None and not self._task.done():
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        self.state_name = "stopped"

    # -- FSM ---------------------------------------------------------------------------

    async def _run(self) -> None:
        crashed = False
        try:
            await self._initialize()
            self.state_name = "free_to_process"
            while True:
                env = await self._mailbox.get_or_idle(self._idle_s)
                if env is None:
                    self.on_passivate(self.aggregate_id)  # parent starts buffering now
                    break
                try:
                    await self._handle(env)
                except _PersistenceExhausted:
                    crashed = True
                    break
            # drain any envelopes that arrived before passivation/crash was signalled
            while not self._mailbox.empty() and not crashed:
                try:
                    await self._handle(self._mailbox.get_nowait())
                except _PersistenceExhausted:
                    crashed = True
        except _InitFailed:
            crashed = True
        except asyncio.CancelledError:
            # externally stopped (shard/engine shutdown): fail queued callers promptly
            # rather than letting their asks ride out the full timeout
            self.state_name = "stopped"
            while not self._mailbox.empty():
                env = self._mailbox.get_nowait()
                fail_future(env.reply, EntityCrashed(
                    f"entity {self.aggregate_id} stopped"))
            raise
        finally:
            if self.state_name != "stopped":
                self.state_name = "stopped"
                leftovers = []
                while not self._mailbox.empty():
                    leftovers.append(self._mailbox.get_nowait())
                self.on_stopped(self.aggregate_id, leftovers, crashed)

    async def _initialize(self) -> None:
        """KTable init protocol: gate on publish lag, then fetch + deserialize."""
        self.state_name = "initializing"
        for attempt in range(self.retry.init_max_attempts):
            if not self.publisher.is_aggregate_state_current(self.aggregate_id):
                await asyncio.sleep(self.retry.init_retry_interval_s)
                continue
            try:
                with self.metrics.state_fetch_timer.time():
                    data = self.fetch_state(self.aggregate_id)
                    if inspect.isawaitable(data):
                        # async fetch backends (the device-resident state
                        # plane's batched gather lane) — the sync KV path
                        # never pays an await
                        data = await data
                if isinstance(data, DecodedState):
                    # the resident plane hands back an already-materialized
                    # domain state; re-serializing it through the byte
                    # contract would undo the gather's amortization
                    self.state = data.state
                    return
                with self.metrics.deserialization_timer.time():
                    self.state = (self.surge_model.deserialize_state(data)
                                  if data is not None else self._initial_state())
                return
            except Exception:  # noqa: BLE001 — fetch/deserialize failure retries
                logger.exception("state fetch failed for %s (attempt %d)",
                                 self.aggregate_id, attempt + 1)
                await asyncio.sleep(self.retry.init_fetch_retry_s)
        logger.error("init exhausted for aggregate %s", self.aggregate_id)
        raise _InitFailed()

    def _initial_state(self) -> Any:
        fn = getattr(self.model, "initial_state", None)
        return fn(self.aggregate_id) if fn is not None else None

    async def _handle(self, env: Envelope) -> None:
        # receive span, child of the ask span via traceparent headers
        # (ActorWithTracing's around-receive + PersistentActor.scala:166-168)
        span = None
        if self.tracer is not None:
            from surge_tpu_torch.tracing import inject_context

            span = self.tracer.start_span(
                f"entity.{type(env.message).__name__}", headers=env.headers)
            # active for this entity task: the command/publish timers recorded
            # inside _handle_inner capture this trace as their exemplar
            span.activate()
            span.set_attribute("aggregate_id", self.aggregate_id)
            span.set_attribute("partition", self.partition)
            # downstream hops (the publisher's publish span) chain under the
            # receive span, completing the ref→router→shard→entity→publisher line
            env.headers = inject_context(span.context, env.headers)
        try:
            await self._handle_inner(env)
            if span is not None and env.reply.done() and not env.reply.cancelled():
                result = env.reply.exception() or env.reply.result()
                if isinstance(result, (CommandFailure, BaseException)):
                    span.status = "error"
        except BaseException as exc:
            if span is not None:
                span.record_exception(exc)
            raise
        finally:
            if span is not None:
                span.finish()

    async def _handle_inner(self, env: Envelope) -> None:
        msg = env.message
        if isinstance(msg, GetState):
            resolve_future(env.reply, self.state)
            return
        if isinstance(msg, ProcessMessage):
            await self._process_command(env, msg.command)
            return
        if isinstance(msg, ApplyEvents):
            await self._apply_events(env, msg.events)
            return
        fail_future(env.reply, TypeError(f"unknown message {type(msg).__name__}"))

    async def _process_command(self, env: Envelope, command: Any) -> None:
        # 1. user command handler (may reject). Async models (the reference's
        # AsyncAggregateCommandModel — e.g. the multilanguage bridge's gRPC
        # round-trip to the business app) return awaitables; the single-writer
        # guarantee holds because this entity task awaits inline.
        self.metrics.command_rate.record()
        rid = env.headers.get(REQUEST_ID_HEADER) if env.headers else None
        if rid is not None:
            # caller-supplied rid: short-circuit a re-delivery BEFORE the
            # model runs. Publish-level dedup alone is not enough here — a
            # re-run handler would fold its events into in-memory state a
            # second time while the log stays exactly-once.
            disposition_of = getattr(self.publisher, "request_disposition", None)
            disposition = disposition_of(rid) if disposition_of else None
            if disposition == "completed":
                resolve_future(env.reply, CommandSuccess(self.state))
                return
            if disposition == "in-flight":
                # the original attempt is still working its way through the
                # publisher (crashed-entity leftovers): the caller backs off
                # and retries once the outcome is known
                resolve_future(env.reply, CommandFailure(RuntimeError(
                    f"request {rid} still in flight")))
                return
        try:
            with self.metrics.command_handling_timer.time():
                result = self._model_process(self.state, command)
                if inspect.isawaitable(result):
                    result = await result
                events = list(result)
        except RejectedCommand as rej:
            self.metrics.rejection_rate.record()
            resolve_future(env.reply, CommandRejected(rej))
            return
        except Exception as exc:  # noqa: BLE001 — user code failure → error ACK
            self.metrics.error_rate.record()
            resolve_future(env.reply, CommandFailure(exc))
            return
        # 2. fold + persist + reply
        await self._fold_and_persist(env, events, reply_state=True)

    async def _apply_events(self, env: Envelope, events: Sequence[Any]) -> None:
        """applyEvents path (PersistentActor.doApplyEvent:245-264): fold externally
        produced events, publish the state snapshot only."""
        await self._fold_and_persist(env, list(events), reply_state=True,
                                     state_only=True)

    async def _fold_and_persist(self, env: Envelope, events: List[Any],
                                reply_state: bool, state_only: bool = False) -> None:
        old_state = self.state
        try:
            with self.metrics.event_handling_timer.time():
                batch_fold = self._model_batch_fold
                if batch_fold is not None:
                    # async/batch fold (AsyncAggregateCommandModel.handleEvents)
                    new_state = batch_fold(old_state, events)
                    if inspect.isawaitable(new_state):
                        new_state = await new_state
                else:
                    fold = self._model_fold
                    new_state = old_state
                    for ev in events:
                        new_state = fold(new_state, ev)
        except Exception as exc:  # noqa: BLE001 — fold failure → error ACK, no persist
            self.metrics.error_rate.record()
            resolve_future(env.reply, CommandFailure(exc))
            return

        if not events and not state_only:
            # no-op command: nothing to persist (reference skips publish when there are
            # no events and state is unchanged)
            resolve_future(env.reply, CommandSuccess(new_state))
            return

        self.state_name = "persisting"
        try:
            try:
                with self.metrics.serialization_timer.time():
                    records = await self.surge_model.serialize_outputs(
                        self.aggregate_id, self.partition, new_state,
                        [] if state_only else events)
            except Exception as exc:  # noqa: BLE001 — serialization failure → error ACK
                self.metrics.error_rate.record()
                resolve_future(env.reply, CommandFailure(exc))
                return

            request_id = env.headers.get(REQUEST_ID_HEADER) if env.headers else None
            if request_id is None:
                self._rid_n += 1
                request_id = f"{self._rid_prefix}-{self._rid_n}"
            last_error: Optional[Exception] = None
            for _ in range(self.retry.publish_max_retries + 1):
                try:
                    with self.metrics.publish_timer.time():
                        aw = self.publisher.publish(self.aggregate_id,
                                                    records, request_id,
                                                    headers=env.headers)
                        if isinstance(aw, asyncio.Future):
                            # bare ack future (the publish fast path): a
                            # slim timer wait, no wrapper task. A shared
                            # batch-level ack (direct lane) must never be
                            # cancelled by THIS caller's timeout — the
                            # records stay queued and the retry below joins
                            # them by request id.
                            await wait_future(
                                aw, self.timeouts.publish_timeout_s,
                                owned=not getattr(self.publisher,
                                                  "shared_acks", False))
                        else:
                            await cancel_safe_wait_for(
                                aw, timeout=self.timeouts.publish_timeout_s)
                    self.state = new_state
                    resolve_future(env.reply, CommandSuccess(new_state))
                    return
                except asyncio.TimeoutError as exc:
                    last_error = exc
                except Exception as exc:  # noqa: BLE001 — publish failure → retry
                    last_error = exc
            # retries exhausted: error the sender, then crash so the next message gets
            # a fresh entity re-initialized from the store
            resolve_future(env.reply, CommandFailure(
                last_error or RuntimeError("publish failed")))
            raise _PersistenceExhausted()
        finally:
            if self.state_name == "persisting":
                self.state_name = "free_to_process"


class _InitFailed(Exception):
    pass


class _PersistenceExhausted(Exception):
    pass
