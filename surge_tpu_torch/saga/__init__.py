"""The saga aggregate family, replay half (``surge_tpu_torch.saga.model``).

The scalar ``SagaModel``, the saga definitions and the saga manager are host
command-path code of ``surge_tpu.saga`` and have no counterpart here.
"""

from surge_tpu_torch.saga.model import (
    COMPENSATED,
    COMPENSATING,
    COMPLETED,
    DEAD_LETTER,
    MAX_STEPS,
    RUNNING,
    STATUS_NAMES,
    TERMINAL,
    SagaState,
    make_registry,
    make_replay_spec,
)

__all__ = [
    "COMPENSATED",
    "COMPENSATING",
    "COMPLETED",
    "DEAD_LETTER",
    "MAX_STEPS",
    "RUNNING",
    "STATUS_NAMES",
    "TERMINAL",
    "SagaState",
    "make_registry",
    "make_replay_spec",
]
