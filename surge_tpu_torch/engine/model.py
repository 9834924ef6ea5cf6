"""The processing-model API and the replay contract of a model family — the
port's copy of ``surge_tpu/engine/model.py``: the command half
(``RejectedCommand``, ``AggregateCommandModel``, ``AsyncAggregateCommandModel``,
``AggregateEventModel``) as the reference has it, and the counterparts of
``ReplayHandlers``, ``ReplaySpec`` and ``fold_events``.

Handlers are torch functions over lane batches: ``handler(state {field: [B]},
fields {column: [B]}) -> {field: value}``. A handler may return a partial dict
(missing fields carry through) and 0-dim values or Python scalars (broadcast over
the batch); the step function pins every result to the schema dtype.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional, Protocol, Sequence, TypeVar

import numpy as np

from surge_tpu_torch.codec.schema import SchemaRegistry

S = TypeVar("S")
C = TypeVar("C")
E = TypeVar("E")

StateTree = Dict[str, Any]
TorchEventHandler = Callable[[StateTree, Mapping[str, Any]], StateTree]


class RejectedCommand(Exception):
    """Domain rejection of a command (reference: Failure(...) from processCommand,
    surfaced as CommandFailure — scaladsl/common/AggregateRefResult.scala:5-11)."""


class AggregateCommandModel(Protocol[S, C, E]):
    """Sync command model — scaladsl AggregateCommandModel (CommandModels.scala:12-31).

    ``process_command`` returns the events to persist (raise :class:`RejectedCommand` to
    reject); ``handle_event`` is the pure fold the engine applies — and the function the
    batched replay path folds.
    """

    def initial_state(self, aggregate_id: str) -> Optional[S]:
        return None

    def process_command(self, state: Optional[S], command: C) -> Sequence[E]: ...

    def handle_event(self, state: Optional[S], event: E) -> Optional[S]: ...


class AsyncAggregateCommandModel(Protocol[S, C, E]):
    """Async variant — scaladsl AsyncAggregateCommandModel (CommandModels.scala:33-52).
    Used by the multilanguage bridge where handlers are RPCs to another process
    (GenericAsyncAggregateCommandModel.scala:14-104)."""

    def initial_state(self, aggregate_id: str) -> Optional[S]:
        return None

    async def process_command(self, state: Optional[S], command: C) -> Sequence[E]: ...

    async def handle_events(self, state: Optional[S], events: Sequence[E]) -> Optional[S]: ...


class AggregateEventModel(Protocol[S, E]):
    """Event-engine-only model — scaladsl/event/AggregateEventModel.scala:10-38.
    ``apply_events`` folds externally-produced events; there is no command side."""

    def initial_state(self, aggregate_id: str) -> Optional[S]:
        return None

    def apply_events(self, state: Optional[S], events: Sequence[E]) -> Optional[S]: ...


def fold_events(model: Any, state: Any, events: Sequence[Any]) -> Any:
    """The scalar fold: ``model.handle_event`` over the events in order, or
    a synchronous batch ``handle_events``. A model with neither (an
    async-only model) cannot fold offline and raises."""
    import inspect

    handle_event = getattr(model, "handle_event", None)
    if handle_event is not None:
        for ev in events:
            state = handle_event(state, ev)
        return state
    batch = getattr(model, "handle_events", None)
    if batch is not None and not inspect.iscoroutinefunction(batch):
        return batch(state, list(events))
    raise TypeError(
        f"{type(model).__name__} has no synchronous fold (handle_event or "
        f"non-async handle_events) — offline replay/restore is unavailable for "
        f"async-only models")


@dataclass(frozen=True)
class ReplayHandlers:
    """Per-event-type torch step functions keyed by the registry's type_ids."""

    by_type_id: Mapping[int, TorchEventHandler]

    def ordered(self, num_types: int) -> list[TorchEventHandler]:
        """Dense handler table indexed by type id; missing ids get identity."""
        identity: TorchEventHandler = lambda state, fields: state
        return [self.by_type_id.get(tid, identity) for tid in range(num_types)]


@dataclass(frozen=True)
class KernelPart:
    """One model family of a combined spec (surge_tpu_torch.replay.mixed), as
    the fold kernels fold it: its ``kernel_step`` (None when the kernels have
    no step for it) and its type ids ``[base, base + num_types)`` in the
    combined registry. The step's columns and state fields are found in the
    combined layout by name."""

    model: str
    step: Optional[str]
    base: int
    num_types: int


@dataclass(frozen=True)
class MixedKernelStep:
    """The ``kernel_step`` of a combined spec: its parts, by ascending base.
    The kernels fold it with their mixed step (C step id 4), which picks a
    lane's part by the event's type id and applies that part's own step."""

    parts: tuple[KernelPart, ...]


@dataclass
class ReplaySpec:
    """Everything the replay engine needs to batch-fold one model family.

    - ``registry``: event/state tensor schemas (surge_tpu_torch.codec.schema).
    - ``handlers``: the torch form of ``handle_event``, split per event type.
    - ``init_record``: column values of the "empty" state (the ``None`` aggregate).
    - ``kernel_step``: the name of the model's step in the hand-written tile-scan
      kernel (``surge_tpu_torch/csrc/tile_scan.cu``), e.g. ``"counter"``; a
      :class:`MixedKernelStep` for a combined spec; None for a model the kernel
      does not carry, which then folds only through the plain scan
      (``surge.replay.tile-backend = xla``).
    - ``associative``: an optional ``AssociativeFold``
      (surge_tpu_torch.replay.seqpar) — with one, ``tile-backend = assoc``
      folds each tile by lift + an order-preserving tree of combines + one
      apply instead of a sequential time scan. Law-checked on first use.
    """

    registry: SchemaRegistry
    handlers: ReplayHandlers
    init_record: Dict[str, Any] = field(default_factory=dict)
    kernel_step: "str | MixedKernelStep | None" = None
    associative: Any = None

    def init_state_tree(self) -> StateTree:
        """Scalar init record with schema-complete columns (missing fields → 0)."""
        out: StateTree = {}
        for f in self.registry.state.fields:
            v = self.init_record.get(f.name, 0)
            out[f.name] = np.asarray(v, dtype=f.dtype)
        return out
