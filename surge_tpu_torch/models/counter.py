"""Counter bounded context — the port's copy of ``surge_tpu/models/counter.py``:
the domain dataclasses (commands, events, ``State``), :class:`CounterModel`
(``process_command`` and the scalar fold the ``cpu`` restore backend runs),
the JSON byte formats (``command_formatting``, ``state_formatting``,
``event_formatting``; the same bytes as the reference's), and the tensor path:
``make_registry`` (same wire bit widths, so an event packs into one byte when
``sequence_number`` is derived), ``make_replay_spec`` with torch handlers and
``make_associative_fold``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from surge_tpu_torch.codec.schema import SchemaRegistry
from surge_tpu_torch.engine.model import RejectedCommand, ReplayHandlers, ReplaySpec
from surge_tpu_torch.serialization import (JsonCommandFormatting, JsonEventFormatting,
                                          JsonFormatting)


@dataclass(frozen=True)
class State:
    aggregate_id: str
    count: int
    version: int


@dataclass(frozen=True)
class Increment:
    aggregate_id: str


@dataclass(frozen=True)
class Decrement:
    aggregate_id: str


@dataclass(frozen=True)
class DoNothing:
    aggregate_id: str


@dataclass(frozen=True)
class CreateNoOpEvent:
    aggregate_id: str


@dataclass(frozen=True)
class FailCommandProcessing:
    aggregate_id: str
    error_msg: str


@dataclass(frozen=True)
class CreateExceptionThrowingEvent:
    aggregate_id: str
    error_msg: str


@dataclass(frozen=True)
class CreateUnserializableEvent:
    aggregate_id: str
    error_msg: str


@dataclass(frozen=True)
class CountIncremented:
    aggregate_id: str
    increment_by: int
    sequence_number: int


@dataclass(frozen=True)
class CountDecremented:
    aggregate_id: str
    decrement_by: int
    sequence_number: int


@dataclass(frozen=True)
class NoOpEvent:
    aggregate_id: str
    sequence_number: int


class ExceptionThrowingError(RuntimeError):
    """Raised when an ExceptionThrowingEvent is folded (fault-injection fixture)."""


@dataclass(frozen=True)
class ExceptionThrowingEvent:
    aggregate_id: str
    sequence_number: int
    error_msg: str


@dataclass(frozen=True)
class UnserializableEvent:
    aggregate_id: str
    sequence_number: int
    error_msg: str


INCREMENTED, DECREMENTED, NOOP, UNSERIALIZABLE = 0, 1, 2, 3


class CounterModel:
    def initial_state(self, aggregate_id: str) -> Optional[State]:
        return None

    def process_command(self, state: Optional[State], command) -> Sequence[object]:
        agg_id = command.aggregate_id
        seq = (state.version if state else 0) + 1
        if isinstance(command, Increment):
            return [CountIncremented(agg_id, 1, seq)]
        if isinstance(command, Decrement):
            return [CountDecremented(agg_id, 1, seq)]
        if isinstance(command, DoNothing):
            return []
        if isinstance(command, CreateNoOpEvent):
            return [NoOpEvent(agg_id, seq)]
        if isinstance(command, FailCommandProcessing):
            raise RejectedCommand(command.error_msg)
        if isinstance(command, CreateExceptionThrowingEvent):
            return [ExceptionThrowingEvent(agg_id, seq, command.error_msg)]
        if isinstance(command, CreateUnserializableEvent):
            return [UnserializableEvent(agg_id, seq, command.error_msg)]
        raise RejectedCommand(f"unknown command {command!r}")

    def handle_event(self, state: Optional[State], event) -> Optional[State]:
        current = state if state is not None else State(event.aggregate_id, 0, 0)
        if isinstance(event, CountIncremented):
            return State(current.aggregate_id, current.count + event.increment_by, event.sequence_number)
        if isinstance(event, CountDecremented):
            return State(current.aggregate_id, current.count - event.decrement_by, event.sequence_number)
        if isinstance(event, NoOpEvent):
            return current
        if isinstance(event, UnserializableEvent):
            return State(current.aggregate_id, current.count, event.sequence_number)
        if isinstance(event, ExceptionThrowingEvent):
            raise ExceptionThrowingError(event.error_msg)
        return current

    def replay_spec(self):
        return make_replay_spec()


def make_registry() -> SchemaRegistry:
    """Tensor-path event subset: every event the reference fold handles without
    raising. Increment/decrement deltas are 0..3, so with the 3-bit type
    discriminant a whole event packs into ONE wire byte when sequence_number is
    producer-derived (surge_tpu_torch.codec.wire)."""
    reg = SchemaRegistry()
    reg.register_event(CountIncremented, type_id=INCREMENTED, exclude=("aggregate_id",),
                       bits={"increment_by": 2})
    reg.register_event(CountDecremented, type_id=DECREMENTED, exclude=("aggregate_id",),
                       bits={"decrement_by": 2})
    reg.register_event(NoOpEvent, type_id=NOOP, exclude=("aggregate_id",))
    reg.register_event(UnserializableEvent, type_id=UNSERIALIZABLE,
                       exclude=("aggregate_id", "error_msg"))
    reg.register_state(State, exclude=("aggregate_id",))
    return reg


def make_replay_spec() -> ReplaySpec:
    def incremented(s, f):
        return {"count": s["count"] + f["increment_by"], "version": f["sequence_number"]}

    def decremented(s, f):
        return {"count": s["count"] - f["decrement_by"], "version": f["sequence_number"]}

    def unserializable(s, f):
        # reference: version bumps to sequenceNumber, count unchanged
        return {"version": f["sequence_number"]}

    return ReplaySpec(
        registry=make_registry(),
        handlers=ReplayHandlers({INCREMENTED: incremented, DECREMENTED: decremented,
                                 UNSERIALIZABLE: unserializable}),
        init_record={"count": 0, "version": 0},
        kernel_step="counter",
        associative=make_associative_fold(),
    )


@functools.cache
def make_associative_fold():
    """The counter fold as an associative transform monoid
    (surge_tpu_torch.replay.seqpar). Summary = (d_count, has_version_event,
    last_sequence_number): count is additive; version is the sequence number
    of the LAST version-setting event (inc/dec/unserializable — NoOpEvent
    leaves it). ``combine`` is associative but not commutative (right-biased
    version). Repeated factory calls are structurally equal, sharing the
    one-time law check."""
    from surge_tpu_torch.replay.seqpar import AssociativeFold

    def lift(ev):
        tid = ev["type_id"]
        inc = tid == INCREMENTED
        dec = tid == DECREMENTED
        sets_version = inc | dec | (tid == UNSERIALIZABLE)
        d = (torch.where(inc, ev["increment_by"], 0)
             - torch.where(dec, ev["decrement_by"], 0))
        return {
            "d_count": d.to(torch.int32),
            "has": sets_version,
            "last_seq": torch.where(sets_version, ev["sequence_number"],
                                    0).to(torch.int32),
        }

    def combine(a, b):
        return {
            "d_count": a["d_count"] + b["d_count"],
            "has": a["has"] | b["has"],
            "last_seq": torch.where(b["has"], b["last_seq"], a["last_seq"]),
        }

    def apply(state, s):
        return {
            "count": (state["count"] + s["d_count"]).to(torch.int32),
            "version": torch.where(s["has"], s["last_seq"],
                                   state["version"]).to(torch.int32),
        }

    return AssociativeFold(
        lift=lift, combine=combine, apply=apply,
        identity={"d_count": np.int32(0), "has": np.bool_(False),
                  "last_seq": np.int32(0)})


# --- byte formats (play-json Format equivalents, TestBoundedContext.scala:84-110) ---

_EVENT_TYPES = {c.__name__: c for c in (CountIncremented, CountDecremented, NoOpEvent,
                                        ExceptionThrowingEvent, UnserializableEvent)}


def _event_to_dict(e) -> dict:
    if isinstance(e, UnserializableEvent):
        # parity: the reference's play-json format for this event throws — that is the
        # point of the CreateUnserializableEvent poison command (TestBoundedContext
        # serialization-failure path). The tensor path still folds it.
        raise ValueError(f"deliberately unserializable event: {e.error_msg}")
    return _to_tagged_dict(e)


def _event_from_dict(d: dict):
    return _from_tagged_dict(_EVENT_TYPES, d)


_COMMAND_TYPES = {c.__name__: c for c in (Increment, Decrement, DoNothing,
                                          CreateNoOpEvent, FailCommandProcessing,
                                          CreateExceptionThrowingEvent,
                                          CreateUnserializableEvent)}


def _to_tagged_dict(obj) -> dict:
    d = {k: getattr(obj, k) for k in obj.__dataclass_fields__}
    d["_type"] = type(obj).__name__
    return d


def _from_tagged_dict(type_map: dict, d: dict):
    d = dict(d)
    return type_map[d.pop("_type")](**d)


def command_formatting() -> JsonCommandFormatting:
    """Command codec for cross-node delivery (remote transport tests)."""
    return JsonCommandFormatting(
        to_dict=_to_tagged_dict,
        from_dict=lambda d: _from_tagged_dict(_COMMAND_TYPES, d))


def state_formatting() -> JsonFormatting:
    return JsonFormatting(
        to_dict=lambda s: {"aggregate_id": s.aggregate_id, "count": s.count, "version": s.version},
        from_dict=lambda d: State(**d))


def event_formatting() -> JsonEventFormatting:
    return JsonEventFormatting(to_dict=_event_to_dict, from_dict=_event_from_dict,
                               key_of=lambda e: e.aggregate_id)
