"""User-facing engine factories — the scaladsl/javadsl surface.

Mirrors ``SurgeCommand`` (modules/command-engine/scaladsl/src/main/scala/surge/scaladsl/
command/SurgeCommand.scala:24-70): ``create_engine(business_logic)`` builds a fully wired
:class:`~surge_tpu_torch.engine.pipeline.SurgeEngine`; and ``SurgeEngineBuilder`` mirrors the
javadsl's ``SurgeCommandBuilder.withBusinessLogic(...).build()``
(javadsl/command/SurgeCommandBuilder.scala:9-22) for callers preferring fluent wiring.

The result ADTs (:class:`CommandSuccess` / :class:`CommandRejected` /
:class:`CommandFailure`) are re-exported here — scaladsl/common/AggregateRefResult.scala:5-11.

The port's copy of ``surge_tpu/dsl.py``. It differs in one place: the engine
takes a ``device`` (``create_engine(..., device=)``,
``SurgeEngineBuilder.with_device``); None means the CUDA card.
"""

from __future__ import annotations

from typing import Any, Optional

from surge_tpu_torch.config import Config
from surge_tpu_torch.engine.business_logic import SurgeCommandBusinessLogic
from surge_tpu_torch.engine.entity import CommandFailure, CommandRejected, CommandSuccess
from surge_tpu_torch.engine.partition import HostPort, PartitionTracker
from surge_tpu_torch.engine.pipeline import EngineNotRunningError, EngineStatus, SurgeEngine

__all__ = [
    "CommandFailure",
    "CommandRejected",
    "CommandSuccess",
    "EngineNotRunningError",
    "EngineStatus",
    "SurgeCommandBusinessLogic",
    "SurgeEngine",
    "SurgeEngineBuilder",
    "create_engine",
]


def create_engine(business_logic: SurgeCommandBusinessLogic, *, log=None,
                  config: Optional[Config] = None,
                  local_host: Optional[HostPort] = None,
                  tracker: Optional[PartitionTracker] = None,
                  remote_deliver=None, mesh=None, tracer=None,
                  membership=None, shard_allocation=None,
                  device=None) -> SurgeEngine:
    """Build (not start) an engine — ``SurgeCommand(businessLogic)`` equivalent.

    Single-node by default (in-memory log, self-assigned partitions); pass a shared
    ``tracker``/``remote_deliver`` for multi-node routing (SURVEY.md §2.10).
    With ``surge.feature-flags.experimental.enable-cluster-sharding`` the engine uses
    the external-shard-allocation backend; share ``membership``/``shard_allocation``
    across the cluster's engines (engine/cluster.py; the port raises for
    it). ``device`` is where the engine's device-side components run (None:
    the CUDA card, raising without one; ``"cpu"`` runs them on the host)."""
    return SurgeEngine(business_logic, log=log, config=config, local_host=local_host,
                       tracker=tracker, remote_deliver=remote_deliver, mesh=mesh,
                       tracer=tracer, membership=membership,
                       shard_allocation=shard_allocation, device=device)


class SurgeEngineBuilder:
    """Fluent builder (javadsl SurgeCommandBuilder analog)."""

    def __init__(self) -> None:
        self._logic: Optional[SurgeCommandBusinessLogic] = None
        self._kwargs: dict[str, Any] = {}

    def with_business_logic(self, logic: SurgeCommandBusinessLogic) -> "SurgeEngineBuilder":
        self._logic = logic
        return self

    def with_log(self, log) -> "SurgeEngineBuilder":
        self._kwargs["log"] = log
        return self

    def with_config(self, config: Config) -> "SurgeEngineBuilder":
        self._kwargs["config"] = config
        return self

    def with_local_host(self, host: HostPort) -> "SurgeEngineBuilder":
        self._kwargs["local_host"] = host
        return self

    def with_tracker(self, tracker: PartitionTracker) -> "SurgeEngineBuilder":
        self._kwargs["tracker"] = tracker
        return self

    def with_tracer(self, tracer) -> "SurgeEngineBuilder":
        self._kwargs["tracer"] = tracer
        return self

    def with_mesh(self, mesh) -> "SurgeEngineBuilder":
        self._kwargs["mesh"] = mesh
        return self

    def with_device(self, device) -> "SurgeEngineBuilder":
        """Where the engine's device-side components run (None: the card)."""
        self._kwargs["device"] = device
        return self

    def with_membership(self, membership) -> "SurgeEngineBuilder":
        """Shared ClusterMembership for the cluster-sharding backend."""
        self._kwargs["membership"] = membership
        return self

    def with_shard_allocation(self, allocation) -> "SurgeEngineBuilder":
        """Shared ExternalShardAllocation for the cluster-sharding backend."""
        self._kwargs["shard_allocation"] = allocation
        return self

    def build(self) -> SurgeEngine:
        if self._logic is None:
            raise ValueError("business logic is required (with_business_logic)")
        return create_engine(self._logic, **self._kwargs)
