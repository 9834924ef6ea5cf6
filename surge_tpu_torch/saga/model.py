"""The saga bounded context, replay half — the counterpart of the tensor path of
``surge_tpu/saga/model.py``: the ``SagaState`` and event dataclasses, the
status constants, ``make_registry`` and ``make_replay_spec`` with torch
handlers.

The state is all numeric: step progress is a pair of int32 bitmasks
(``committed`` / ``compensated``), the definition is its ``def_id``, and four
float32 context slots (``c0..c3``) pass through the fold bit for bit. Its wire
packs the type and ``step`` (5 bits) into one byte; ``attempts``, ``c0..c3``,
``def_id`` and ``num_steps`` ride as side columns (and ``sequence_number``
unless it is derived).

Status machine::

    RUNNING --step n committed--> RUNNING (step=n+1)   [all committed -> COMPLETED]
    RUNNING --step n failed-----> COMPENSATING         [nothing committed -> COMPENSATED]
    COMPENSATING --comp n-------> COMPENSATING         [all committed compensated -> COMPENSATED]
    COMPENSATING --comp exhausted-> DEAD_LETTER
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from surge_tpu_torch.codec.schema import SchemaRegistry
from surge_tpu_torch.engine.model import ReplayHandlers, ReplaySpec

#: step-index cap: progress bitmasks live in one int32 state column
MAX_STEPS = 30

#: status enum (int32 state column; 0 must be RUNNING so the plane's
#: zero-initialized row folds correctly from the SagaStarted event)
RUNNING, COMPENSATING, COMPLETED, COMPENSATED, DEAD_LETTER = 0, 1, 2, 3, 4

STATUS_NAMES = {RUNNING: "running", COMPENSATING: "compensating",
                COMPLETED: "completed", COMPENSATED: "compensated",
                DEAD_LETTER: "dead-letter"}

TERMINAL = frozenset((COMPLETED, COMPENSATED, DEAD_LETTER))


@dataclass(frozen=True)
class SagaState:
    aggregate_id: str
    def_id: int
    num_steps: int
    status: int
    step: int          # next forward step index while RUNNING
    committed: int     # bitmask of committed forward steps
    compensated: int   # bitmask of compensated steps
    attempts: int      # attempts burned on the failing step (observability)
    c0: float
    c1: float
    c2: float
    c3: float
    version: int


@dataclass(frozen=True)
class SagaStarted:
    aggregate_id: str
    def_id: int
    num_steps: int
    c0: float
    c1: float
    c2: float
    c3: float
    sequence_number: int


@dataclass(frozen=True)
class SagaStepCommitted:
    aggregate_id: str
    step: int
    sequence_number: int


@dataclass(frozen=True)
class SagaStepFailed:
    aggregate_id: str
    step: int
    attempts: int
    sequence_number: int


@dataclass(frozen=True)
class SagaStepCompensated:
    aggregate_id: str
    step: int
    sequence_number: int


@dataclass(frozen=True)
class SagaDeadLettered:
    aggregate_id: str
    step: int
    sequence_number: int


def _full_mask(num_steps: int) -> int:
    return (1 << num_steps) - 1


STARTED, STEP_COMMITTED, STEP_FAILED, STEP_COMPENSATED, DEAD_LETTERED = \
    0, 1, 2, 3, 4


def make_registry() -> SchemaRegistry:
    reg = SchemaRegistry()
    reg.register_event(SagaStarted, type_id=STARTED, exclude=("aggregate_id",))
    reg.register_event(SagaStepCommitted, type_id=STEP_COMMITTED,
                       exclude=("aggregate_id",), bits={"step": 5})
    reg.register_event(SagaStepFailed, type_id=STEP_FAILED,
                       exclude=("aggregate_id",), bits={"step": 5})
    reg.register_event(SagaStepCompensated, type_id=STEP_COMPENSATED,
                       exclude=("aggregate_id",), bits={"step": 5})
    reg.register_event(SagaDeadLettered, type_id=DEAD_LETTERED,
                       exclude=("aggregate_id",), bits={"step": 5})
    reg.register_state(SagaState, exclude=("aggregate_id",))
    return reg


def _shift(n: torch.Tensor) -> torch.Tensor:
    """``1 << n`` in int32 as the reference's ``jnp.left_shift`` computes it
    on the CPU: 0 for a shift outside [0, 32) (``num_steps`` is an unbounded
    column), ``1 << 31`` wrapping to INT32_MIN. Written out so the result
    does not rest on torch's own out-of-range rule."""
    n = n.to(torch.int32)
    inside = (n >= 0) & (n < 32)
    one = torch.ones((), dtype=torch.int32, device=n.device)
    return torch.where(inside, torch.bitwise_left_shift(one, n.clamp(0, 31)), 0)


def make_replay_spec() -> ReplaySpec:
    """The saga fold in batched tensor form — every branch of
    ``handle_event`` as masked int32 arithmetic (bitmask progress makes the
    status transitions pure compares)."""

    def started(s, f):
        zero = torch.zeros_like(f["num_steps"])
        return {"def_id": f["def_id"], "num_steps": f["num_steps"],
                "status": torch.full_like(f["num_steps"], RUNNING),
                "step": zero, "committed": zero, "compensated": zero,
                "attempts": zero,
                "c0": f["c0"], "c1": f["c1"], "c2": f["c2"], "c3": f["c3"],
                "version": f["sequence_number"]}

    def step_committed(s, f):
        committed = s["committed"] | _shift(f["step"])
        full = _shift(s["num_steps"]) - 1
        done = committed == full
        return {"committed": committed,
                "status": torch.where(done, COMPLETED, RUNNING)
                    .to(s["status"].dtype),
                "step": (f["step"] + 1).to(s["step"].dtype),
                "attempts": torch.zeros_like(s["attempts"]),
                "version": f["sequence_number"]}

    def step_failed(s, f):
        nothing = s["committed"] == 0
        return {"status": torch.where(nothing, COMPENSATED, COMPENSATING)
                    .to(s["status"].dtype),
                "attempts": f["attempts"].to(s["attempts"].dtype),
                "version": f["sequence_number"]}

    def step_compensated(s, f):
        compensated = s["compensated"] | _shift(f["step"])
        done = compensated == s["committed"]
        return {"compensated": compensated,
                "status": torch.where(done, COMPENSATED, COMPENSATING)
                    .to(s["status"].dtype),
                "version": f["sequence_number"]}

    def dead_lettered(s, f):
        return {"status": torch.full_like(s["status"], DEAD_LETTER),
                "version": f["sequence_number"]}

    return ReplaySpec(
        registry=make_registry(),
        handlers=ReplayHandlers({STARTED: started,
                                 STEP_COMMITTED: step_committed,
                                 STEP_FAILED: step_failed,
                                 STEP_COMPENSATED: step_compensated,
                                 DEAD_LETTERED: dead_lettered}),
        init_record={"def_id": 0, "num_steps": 0, "status": RUNNING,
                     "step": 0, "committed": 0, "compensated": 0,
                     "attempts": 0, "c0": 0.0, "c1": 0.0, "c2": 0.0,
                     "c3": 0.0, "version": 0},
        kernel_step="saga",
    )
