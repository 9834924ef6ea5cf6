"""Partition router: aggregate id → partition → local shard or remote node.

Reference: KafkaPartitionShardRouterActor (modules/common/src/main/scala/surge/kafka/
KafkaPartitionShardRouterActor.scala:25-372) — routes by the producer's partitioner
(deliverMessage:205-222), follows :class:`PartitionTracker` updates (rebalance region
lifecycle, updatePartitionAssignments:114-142), creates local regions on demand
(newActorRegionForPartition:248-283), and supports DR-standby (defer region creation
until first delivery, :174-185,309-316). Remote partitions forward through a pluggable
``remote_deliver`` (the Akka-remoting ActorSelection analog — the control-plane
transport supplies it; SURVEY.md §5.8)."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from surge_tpu_torch.common import (Ack, Controllable, fail_future, logger,
                              spawn_reaped)
from surge_tpu_torch.engine.entity import Envelope
from surge_tpu_torch.engine.partition import (
    AssignmentChanges,
    HostPort,
    PartitionAssignments,
    PartitionTracker,
    partition_by_up_to_colon,
    partition_for_key,
)
# module-level, NOT inside deliver(): a per-message import statement costs a
# sys.modules lookup on every delivery even when tracing is active, and the
# tracer=None path must stay a single `is None` check
from surge_tpu_torch.tracing import inject_context

# region_creator(partition) -> a Shard-like object (deliver(agg_id, env) + async stop())
RegionCreator = Callable[[int], object]
# remote_deliver(host, partition, aggregate_id, envelope) — cross-node forwarding
RemoteDeliver = Callable[[HostPort, int, str, Envelope], None]


class NoRouteError(Exception):
    """No assignment known for the key's partition and no buffering headroom."""


class RouterBase(Controllable):
    """Shared routing machinery: key→partition hashing, pending-buffering while the
    owner is unknown, local-vs-remote dispatch, lazy region creation, and the
    health/regions accessors. Backends differ only in how a partition's owner is
    resolved (``owner_of``) and what drives rebalances."""

    health_name = "router"

    def __init__(self, num_partitions: int, local_host: HostPort,
                 region_creator: RegionCreator,
                 partition_by: Callable[[str], str] = partition_by_up_to_colon,
                 remote_deliver: Optional[RemoteDeliver] = None,
                 pending_limit: int = 1000) -> None:
        self.num_partitions = num_partitions
        self.local_host = local_host
        self.region_creator = region_creator
        self.partition_by = partition_by
        self.remote_deliver = remote_deliver
        self.pending_limit = pending_limit
        # assigned by the engine after construction (None = zero-overhead path);
        # the routing hop's span mirrors KafkaPartitionShardRouterActor:216
        self.tracer = None
        self._regions: Dict[int, object] = {}
        self._region_stops: set = set()  # in-flight region teardowns (reaped)
        self._pending: Dict[int, List[Tuple[str, Envelope]]] = {}
        self._started = False

    # -- backend hook -------------------------------------------------------------------

    def owner_of(self, partition: int) -> Optional[HostPort]:
        raise NotImplementedError

    # -- routing ------------------------------------------------------------------------

    def partition_for(self, aggregate_id: str) -> int:
        return partition_for_key(self.partition_by(aggregate_id), self.num_partitions)

    def deliver(self, aggregate_id: str, env: Envelope) -> None:
        """deliverMessage:205-222 — resolve owner, local-or-remote dispatch."""
        span = None
        if self.tracer is not None:
            span = self.tracer.start_span(
                f"{self.health_name}.deliver", headers=env.headers)
            span.set_attribute("aggregate_id", aggregate_id)
            env.headers = inject_context(span.context, env.headers)
        try:
            partition = self.partition_for(aggregate_id)
            owner = self.owner_of(partition)
            if span is not None:
                span.set_attribute("partition", partition)
                span.set_attribute("owner", "" if owner is None else str(owner))
                span.set_attribute(
                    "remote", owner is not None and owner != self.local_host)
            if owner is None:
                buf = self._pending.setdefault(partition, [])
                if len(buf) >= self.pending_limit:
                    err = NoRouteError(
                        f"no owner for partition {partition} and buffer full")
                    if span is not None:
                        span.record_exception(err)
                    fail_future(env.reply, err)
                    return
                buf.append((aggregate_id, env))
                if span is not None:
                    span.add_event("buffered")
                return
            self._dispatch(owner, partition, aggregate_id, env)
        finally:
            if span is not None:
                span.finish()

    def _dispatch(self, owner: HostPort, partition: int, aggregate_id: str,
                  env: Envelope) -> None:
        if owner == self.local_host:
            self.deliver_local(partition, aggregate_id, env)
        elif self.remote_deliver is not None:
            self.remote_deliver(owner, partition, aggregate_id, env)
        else:
            fail_future(env.reply, NoRouteError(
                f"partition {partition} owned by {owner} and no remote transport"))

    def _create_region(self, partition: int):
        region = self.region_creator(partition)
        self._regions[partition] = region
        return region

    def deliver_local(self, partition: int, aggregate_id: str, env: Envelope) -> None:
        """Deliver into this node's region for ``partition`` WITHOUT re-resolving
        ownership. ``_dispatch`` uses this for locally-owned partitions; the
        node-transport server uses it for envelopes another node already addressed
        here — re-routing those through ``deliver`` could ping-pong unboundedly
        while two nodes' trackers disagree mid-rebalance. Regions materialize
        lazily (DR-standby defers creation to first message, :174-185; normal mode
        lazily materializes too if an assignment listener raced a delivery)."""
        region = self._regions.get(partition)
        if region is None:
            region = self._create_region(partition)
        region.deliver(aggregate_id, env)

    def _stop_region(self, partition: int, why: str) -> None:
        import asyncio

        region = self._regions.pop(partition, None)
        if region is not None:
            logger.info("%s: stopping %s region %d", self.health_name, why, partition)
            spawn_reaped(self._region_stops, region.stop(),
                         f"{self.health_name} region {partition} stop")

    def _drain_pending(self) -> None:
        """Dispatch buffered deliveries whose owner is now known."""
        for p in list(self._pending):
            owner = self.owner_of(p)
            if owner is None:
                continue
            for aggregate_id, env in self._pending.pop(p):
                self._dispatch(owner, p, aggregate_id, env)

    async def _shutdown_regions(self) -> None:
        for region in list(self._regions.values()):
            await region.stop()
        self._regions.clear()
        for buf in self._pending.values():
            for _, env in buf:
                fail_future(env.reply, NoRouteError(f"{self.health_name} stopped"))
        self._pending.clear()

    @property
    def local_partitions(self) -> List[int]:
        return sorted(self._regions)

    def regions(self):
        """Public (partition, region) accessor in partition order: lets health/metrics
        compose without reaching into router internals."""
        return sorted(self._regions.items())

    def health(self) -> dict:
        """Router health snapshot (getHealthCheck:353-366 analog)."""
        return {
            "name": self.health_name,
            "status": "up" if self._started else "down",
            "local_partitions": self.local_partitions,
            "pending": {p: len(b) for p, b in self._pending.items()},
        }


class SurgePartitionRouter(RouterBase):
    """Default backend: partition owners come straight from the tracker's consumer
    assignments."""

    def __init__(self, num_partitions: int, tracker: PartitionTracker,
                 local_host: HostPort, region_creator: RegionCreator,
                 partition_by: Callable[[str], str] = partition_by_up_to_colon,
                 remote_deliver: Optional[RemoteDeliver] = None,
                 dr_standby: bool = False, pending_limit: int = 1000) -> None:
        super().__init__(num_partitions, local_host, region_creator,
                         partition_by=partition_by, remote_deliver=remote_deliver,
                         pending_limit=pending_limit)
        self.tracker = tracker
        self.dr_standby = dr_standby

    def owner_of(self, partition: int) -> Optional[HostPort]:
        return self.tracker.assignments.partition_to_host().get(partition)

    # -- lifecycle ----------------------------------------------------------------------

    async def start(self) -> Ack:
        self._started = True
        self.tracker.register(self._on_assignments)
        return Ack()

    async def stop(self) -> Ack:
        self._started = False
        self.tracker.unregister(self._on_assignments)
        await self._shutdown_regions()
        return Ack()

    # -- rebalance ----------------------------------------------------------------------

    def _on_assignments(self, assignments: PartitionAssignments,
                        changes: AssignmentChanges) -> None:
        if not self._started:
            return
        # stop revoked local regions (PoisonPill analog, :298-307)
        for p in changes.revoked.get(self.local_host, []):
            self._stop_region(p, "revoked")
        # eagerly create added local regions unless DR-standby (:144-156)
        if not self.dr_standby:
            for p in changes.added.get(self.local_host, []):
                if p not in self._regions:
                    self._create_region(p)
        self._drain_pending()
