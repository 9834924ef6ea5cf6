"""surge_tpu_torch — surge_tpu in PyTorch, for NVIDIA Hopper.

A second package beside ``surge_tpu`` (the JAX reference). Module paths and names
mirror the reference, so ``surge_tpu_torch.replay.engine.ReplayEngine`` is the
counterpart of ``surge_tpu.replay.engine.ReplayEngine``. The package imports
``torch`` and numpy and never JAX or ``surge_tpu``: where it needs a numpy-only
reference module it keeps its own copy of the parts it uses.

Hand-written CUDA kernels live in ``csrc/`` and are built at first use by
:mod:`surge_tpu_torch._build`.

The entry point is :func:`create_engine` (``surge_tpu_torch.dsl``): an engine
over the port's :class:`InMemoryLog`, whose cold start, resident state plane,
queries and views run on ``device`` (None: the CUDA card).
"""

from surge_tpu_torch.config import Config, default_config
from surge_tpu_torch.dsl import (
    CommandFailure,
    CommandRejected,
    CommandSuccess,
    SurgeCommandBusinessLogic,
    SurgeEngine,
    SurgeEngineBuilder,
    create_engine,
)
from surge_tpu_torch.log import InMemoryLog, copy_log
from surge_tpu_torch.serialization import (
    AggregateReadFormatting,
    AggregateWriteFormatting,
    EventWriteFormatting,
    SerializedAggregate,
    SerializedMessage,
)

__all__ = [
    "AggregateReadFormatting",
    "AggregateWriteFormatting",
    "CommandFailure",
    "CommandRejected",
    "CommandSuccess",
    "Config",
    "EventWriteFormatting",
    "InMemoryLog",
    "SerializedAggregate",
    "SerializedMessage",
    "SurgeCommandBusinessLogic",
    "SurgeEngine",
    "SurgeEngineBuilder",
    "copy_log",
    "create_engine",
    "default_config",
]
