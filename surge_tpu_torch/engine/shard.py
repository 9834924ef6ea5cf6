"""Entity parent for one partition — the Shard equivalent.

Reference: modules/common/src/main/scala/surge/internal/akka/cluster/Shard.scala:34-200 —
creates a child entity per aggregate id on demand (getOrCreateEntity:101-113), buffers
messages (bounded) while a child passivates (receivePassivate:165-180, buffer:115-123),
and restarts a child that stopped with messages waiting (entityTerminated:134-147).
Crashed children are recreated on the next delivery with their unprocessed mail
redelivered — the fresh entity re-initializes from the state store.
"""

from __future__ import annotations

# surgelint: fast-path-module — the per-command delivery hop

from typing import Callable, Dict, List

from surge_tpu_torch.common import fail_future, logger
from surge_tpu_torch.engine.entity import AggregateEntity, Envelope
# module-level, NOT inside deliver(): a per-message import statement costs a
# sys.modules lookup on every delivery even when tracing is active, and the
# tracer=None path must stay a single `is None` check
from surge_tpu_torch.tracing import inject_context

# factory(aggregate_id, on_passivate, on_stopped) -> started-or-startable entity
EntityFactory = Callable[..., AggregateEntity]


class BufferFullError(Exception):
    """Passivation buffer overflow (Shard.scala:115-123 drops with a warning)."""


class Shard:
    """Owns the live entities of one partition."""

    def __init__(self, name: str, entity_factory: EntityFactory,
                 buffer_limit: int = 1000, tracer=None) -> None:
        self.name = name
        self.entity_factory = entity_factory
        self.buffer_limit = buffer_limit
        self.tracer = tracer
        self._entities: Dict[str, AggregateEntity] = {}
        self._passivating: Dict[str, List[Envelope]] = {}

    # -- delivery -----------------------------------------------------------------------

    def deliver(self, aggregate_id: str, env: Envelope) -> None:
        span = None
        if self.tracer is not None:
            # the Shard hop's span (getOrCreateEntity + mailbox handoff);
            # context re-injected so the entity's receive span chains under it
            span = self.tracer.start_span("shard.deliver", headers=env.headers)
            span.set_attribute("aggregate_id", aggregate_id)
            span.set_attribute("shard", self.name)
            env.headers = inject_context(span.context, env.headers)
        try:
            if aggregate_id in self._passivating:
                buf = self._passivating[aggregate_id]
                if len(buf) >= self.buffer_limit:
                    err = BufferFullError(
                        f"{self.name}: passivation buffer full for {aggregate_id}")
                    if span is not None:
                        span.record_exception(err)
                    fail_future(env.reply, err)
                    return
                buf.append(env)
                if span is not None:
                    span.add_event("buffered-passivating")
                return
            self._get_or_create(aggregate_id).deliver(env)
        finally:
            if span is not None:
                span.finish()

    def _get_or_create(self, aggregate_id: str) -> AggregateEntity:
        entity = self._entities.get(aggregate_id)
        if entity is None or entity.state_name == "stopped":
            entity = self.entity_factory(
                aggregate_id, on_passivate=self._on_passivate,
                on_stopped=self._on_stopped)
            self._entities[aggregate_id] = entity
            entity.start()
        return entity

    @property
    def num_live_entities(self) -> int:
        return len(self._entities)

    def live_entity(self, aggregate_id: str) -> AggregateEntity | None:
        return self._entities.get(aggregate_id)

    # -- passivation protocol (entity callbacks, same event loop) ------------------------

    def _on_passivate(self, aggregate_id: str) -> None:
        self._passivating.setdefault(aggregate_id, [])

    def _on_stopped(self, aggregate_id: str, leftovers: List[Envelope],
                    crashed: bool) -> None:
        self._entities.pop(aggregate_id, None)
        pending = self._passivating.pop(aggregate_id, []) + list(leftovers)
        if crashed:
            logger.warning("%s: entity %s crashed; %d message(s) to redeliver",
                           self.name, aggregate_id, len(pending))
        for env in pending:  # restart-on-buffered (Shard.scala:134-147)
            self.deliver(aggregate_id, env)

    # -- lifecycle ----------------------------------------------------------------------

    async def stop(self) -> None:
        for entity in list(self._entities.values()):
            await entity.stop()  # surgelint: disable=hot-path-asyncio # shutdown path, not per-command
        self._entities.clear()
        for buf in self._passivating.values():
            for env in buf:
                fail_future(env.reply, RuntimeError(f"shard {self.name} stopped"))
        self._passivating.clear()
