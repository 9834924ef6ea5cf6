"""AggregateRef — the client proxy for one aggregate id.

Reference: internal/persistence/AggregateRefTrait.scala:31-102 + the scaladsl surface
(scaladsl/command/AggregateRef.scala:15-60): ``send_command`` / ``get_state`` /
``apply_events`` as ask-style calls with timeout mapping into the result ADTs
(CommandSuccess / CommandRejected / CommandFailure)."""

from __future__ import annotations

# surgelint: fast-path-module — the per-command ask boundary

import asyncio
from typing import Any, Callable, Optional, Sequence

from surge_tpu_torch.common import wait_future
from surge_tpu_torch.config import Config, TimeoutConfig, default_config
from surge_tpu_torch.engine.entity import (
    REQUEST_ID_HEADER,
    ApplyEvents,
    CommandFailure,
    CommandRejected,
    CommandSuccess,
    Envelope,
    GetState,
    ProcessMessage,
)

# deliver(aggregate_id, envelope) — a Shard, or the partition router in front of many
DeliverFn = Callable[[str, Envelope], None]


class AggregateRef:
    """Typed handle on one aggregate (AggregateRefTrait.scala:31-102)."""

    def __init__(self, aggregate_id: str, deliver: DeliverFn,
                 config: Config | None = None,
                 headers_factory: Callable[[], dict] | None = None,
                 tracer=None) -> None:
        self.aggregate_id = aggregate_id
        self._deliver = deliver
        self._timeouts = TimeoutConfig.from_config(config or default_config())
        self._headers_factory = headers_factory or dict
        self._tracer = tracer

    async def _ask(self, message: Any,
                   extra_headers: Optional[dict] = None) -> Any:
        fut: "asyncio.Future[Any]" = asyncio.get_running_loop().create_future()
        headers = self._headers_factory()
        if extra_headers:
            headers.update(extra_headers)
        span = None
        if self._tracer is not None:
            # span at the ask boundary, trace context rides the envelope headers
            # (AggregateRefTrait.scala:77-79 + TracedMessage)
            from surge_tpu_torch.tracing import inject_context

            span = self._tracer.start_span(
                f"aggregate-ref.{type(message).__name__}", headers=headers)
            span.set_attribute("aggregate_id", self.aggregate_id)
            headers = inject_context(span.context, headers)
        env = Envelope(message=message, reply=fut, headers=headers)
        try:
            self._deliver(self.aggregate_id, env)
            # slim timer wait on the exclusively-owned reply future: no
            # wrapper task / waiter per ask (a per-command cost at engine
            # throughput); timeout cancels the reply exactly like wait_for
            return await wait_future(fut, self._timeouts.ask_timeout_s)
        except asyncio.TimeoutError as exc:
            if span is not None:
                span.record_exception(exc)
            return CommandFailure(exc)
        except Exception as exc:  # noqa: BLE001 — routing failures surface as failures
            if span is not None:
                span.record_exception(exc)
            return CommandFailure(exc)
        finally:
            if span is not None:
                span.finish()

    async def send_command(self, command: Any, *,
                           request_id: Optional[str] = None):
        """→ CommandSuccess(new_state) | CommandRejected(reason) | CommandFailure(err)
        (AggregateRefTrait.sendCommand:76-93).

        ``request_id`` rides the envelope headers into the entity, which
        publishes under it instead of minting one — a retried send with the
        same id dedups exactly-once (the saga manager's contract)."""
        result = await self._ask(
            ProcessMessage(command),
            {REQUEST_ID_HEADER: request_id} if request_id is not None else None)
        if isinstance(result, (CommandSuccess, CommandRejected, CommandFailure)):
            return result
        return CommandFailure(TypeError(f"unexpected reply {result!r}"))

    async def get_state(self) -> Optional[Any]:
        """Current state, or None (queryState:62-64). Raises on ask failure."""
        result = await self._ask(GetState())
        if isinstance(result, CommandFailure):
            raise result.error
        return result

    async def apply_events(self, events: Sequence[Any]):
        """Fold externally-produced events; → CommandSuccess | CommandFailure
        (applyEvents:95-101)."""
        result = await self._ask(ApplyEvents(list(events)))
        if isinstance(result, (CommandSuccess, CommandFailure)):
            return result
        return CommandFailure(TypeError(f"unexpected reply {result!r}"))
