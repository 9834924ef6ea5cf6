"""Command engine core — the port's copy of ``surge_tpu/engine`` (the L3/L4
equivalent of the reference's command-engine modules). The event engine
(``event_dsl.py``) and the cluster-sharding router (``cluster.py``) are not
ported.

- :mod:`surge_tpu_torch.engine.model` — processing-model API + replay spec
  (scaladsl/command/CommandModels.scala:12-74).
- :mod:`surge_tpu_torch.engine.business_logic` — the user bundle + serialization executor
  (SurgeCommandBusinessLogicTrait, internal/SurgeModel.scala).
- :mod:`surge_tpu_torch.engine.entity` — per-aggregate single-writer FSM
  (internal/persistence/PersistentActor.scala).
- :mod:`surge_tpu_torch.engine.publisher` — per-partition exactly-once publisher
  (internal/kafka/KafkaProducerActorImpl.scala).
- :mod:`surge_tpu_torch.engine.shard` / :mod:`surge_tpu_torch.engine.router` /
  :mod:`surge_tpu_torch.engine.partition` — entity parents, partition routing, assignments
  (Shard.scala, KafkaPartitionShardRouterActor.scala, PartitionAssignments.scala).
- :mod:`surge_tpu_torch.engine.ref` — AggregateRef client surface.
- :mod:`surge_tpu_torch.engine.pipeline` — the wired engine (SurgeMessagePipeline.scala).
"""

from surge_tpu_torch.engine.model import (
    AggregateCommandModel,
    AsyncAggregateCommandModel,
    AggregateEventModel,
    RejectedCommand,
    ReplayHandlers,
    ReplaySpec,
)
from surge_tpu_torch.engine.business_logic import SurgeCommandBusinessLogic, SurgeModel
from surge_tpu_torch.engine.entity import (
    AggregateEntity,
    ApplyEvents,
    CommandFailure,
    CommandRejected,
    CommandSuccess,
    Envelope,
    GetState,
    ProcessMessage,
)
from surge_tpu_torch.engine.partition import (
    HostPort,
    PartitionAssignments,
    PartitionTracker,
    partition_for_key,
)
from surge_tpu_torch.engine.pipeline import EngineNotRunningError, EngineStatus, SurgeEngine
from surge_tpu_torch.engine.publisher import PartitionPublisher
from surge_tpu_torch.engine.ref import AggregateRef
from surge_tpu_torch.engine.router import SurgePartitionRouter
from surge_tpu_torch.engine.shard import Shard

__all__ = [
    "AggregateCommandModel",
    "AggregateEntity",
    "AggregateEventModel",
    "AggregateRef",
    "ApplyEvents",
    "AsyncAggregateCommandModel",
    "CommandFailure",
    "CommandRejected",
    "CommandSuccess",
    "EngineNotRunningError",
    "EngineStatus",
    "Envelope",
    "GetState",
    "HostPort",
    "PartitionAssignments",
    "PartitionPublisher",
    "PartitionTracker",
    "ProcessMessage",
    "RejectedCommand",
    "ReplayHandlers",
    "ReplaySpec",
    "Shard",
    "SurgeCommandBusinessLogic",
    "SurgeEngine",
    "SurgeModel",
    "SurgePartitionRouter",
    "partition_for_key",
]
