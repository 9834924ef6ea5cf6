"""Counter bounded context, replay half — the counterpart of the tensor path of
``surge_tpu/models/counter.py``: the ``State`` and event dataclasses,
``make_registry`` (same wire bit widths, so an event packs into one byte when
``sequence_number`` is derived), ``make_replay_spec`` with torch handlers and
``make_associative_fold``; and :class:`CounterModel`, the scalar fold the
``cpu`` restore backend runs.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from surge_tpu_torch.codec.schema import SchemaRegistry
from surge_tpu_torch.engine.model import ReplayHandlers, ReplaySpec


@dataclass(frozen=True)
class State:
    aggregate_id: str
    count: int
    version: int


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


@dataclass(frozen=True)
class UnserializableEvent:
    aggregate_id: str
    sequence_number: int
    error_msg: str


INCREMENTED, DECREMENTED, NOOP, UNSERIALIZABLE = 0, 1, 2, 3


class CounterModel:
    """The scalar event fold (``handle_event``) of the reference's
    ``CounterModel``, over the events this module carries."""

    def initial_state(self, aggregate_id: str):
        return None

    def handle_event(self, state, event):
        current = state if state is not None else State(event.aggregate_id, 0, 0)
        if isinstance(event, CountIncremented):
            return State(current.aggregate_id,
                         current.count + event.increment_by, event.sequence_number)
        if isinstance(event, CountDecremented):
            return State(current.aggregate_id,
                         current.count - event.decrement_by, event.sequence_number)
        if isinstance(event, UnserializableEvent):
            return State(current.aggregate_id, current.count, event.sequence_number)
        return current  # NoOpEvent

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
