"""Layered key/value config with env overrides — the port's copy of
``surge_tpu/config/__init__.py`` (``Config``, ``default_config``).

Keys are dotted strings (``surge.replay.batch-size``). Resolution order:
explicit overrides > environment (``SURGE_REPLAY_BATCH_SIZE``) > defaults. The
keys below carry the reference's exact defaults, so one override dict drives
both packages the same way.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Mapping


def _env_key(key: str) -> str:
    return key.upper().replace(".", "_").replace("-", "_")


#: the keys the engine and everything it reaches read (the replay engine, the
#: store restore, the resident state plane, the query engine, the views and
#: the host modules of the command path), with the reference's defaults
#: (surge_tpu/config)
DEFAULTS: dict[str, Any] = {
    # restore_from_events: "tpu" folds through the batched engine (on the
    # engine's device), "cpu" runs the scalar per-aggregate fold
    "surge.replay.backend": "tpu",  # tpu | cpu
    # the engine's cold start folds the events topic (SurgeEngine.start)
    "surge.replay.restore-on-start": False,
    "surge.replay.batch-size": 8192,  # aggregates per device step
    "surge.replay.time-chunk": 512,  # events scanned per tile
    # tail windows shrink through a power-of-two ladder down to this width
    "surge.replay.min-time-window": 8,
    # device-memory budget for one tile's [batch, width] slab (plus its
    # transpose); bounds the tile width of long-log corpora
    "surge.replay.resident-slab-cap-mb": 512,
    # order aggregates by log length (descending) when packing the wire
    "surge.replay.sort-by-length": True,
    # replay_ragged's padded-length buckets
    "surge.replay.length-buckets": "64,256,1024,4096",
    # plain-scan step dispatch: "switch" applies each handler to the lanes
    # that carry its type, "select" runs every handler and mask-combines
    "surge.replay.dispatch": "switch",  # switch | select
    # tile fold: "pallas" is the hand-written kernel (K1), "xla" the plain
    # torch scan, "auto" the kernel on CUDA and the plain scan on the CPU
    "surge.replay.tile-backend": "auto",  # auto | xla | pallas | assoc
    # resident tile layout: "dense" pre-gathers every tile once per corpus
    # when the buffers fit dense-cap-mb of device memory; "flat" gathers
    # per pass
    "surge.replay.resident-layout": "auto",  # auto | flat | dense
    "surge.replay.dense-cap-mb": 2048,
    # pad resident buffers to power-of-two lengths ("pow2") or keep exact
    # lengths ("exact")
    "surge.replay.resident-len-bucket": "pow2",  # pow2 | exact
    # replay_resident_streamed's default piece count (0/1: one upload, then
    # the replay)
    "surge.replay.upload-stream-segments": 0,
    # --- the store restore (store/restore.py) ---
    # restore_from_segment: fold each chunk through the resident path, or
    # stream its windows through replay_columnar
    "surge.replay.segment-backend": "resident",  # resident | streaming
    # cache each chunk's packed wire beside the segment for later restores
    "surge.replay.segment-wire-cache": True,
    # the engine's columnar segment: when set, rebuild_from_events restores
    # from this segment (building it once from the topics if absent) and
    # the query engine scans it
    "surge.replay.segment-path": "",
    # append delta chunks and snapshots for post-build offsets on each
    # segment rebuild or query, so cold starts never re-crawl the topics
    "surge.replay.segment-auto-extend": True,
    # restore_from_events above this many records spills: the tpu backend
    # through a throwaway columnar segment, the cpu backend in key-hash-range
    # passes
    "surge.replay.restore-spill-events": 1_000_000,
    # aggregates per chunk of that throwaway segment
    "surge.replay.restore-chunk-aggregates": 65536,
    # --- the resident state plane (replay/resident_state.py) ---
    # the engine keeps its state resident on the device after the cold
    # start and folds committed batches into it (SurgeEngine)
    "surge.replay.resident.enabled": False,
    # update the slab in place through every refresh window (true) or fold
    # into a copy published at the group's commit (false)
    "surge.replay.donate-refresh": True,
    # hot-set bound: aggregates resident in the device slab at once; the
    # overflow spills to a host-side dict at its exact fold point
    "surge.replay.resident.capacity": 65536,
    # staleness bound for plane-served reads, in records of partition lag
    # (entity init always demands lag 0)
    "surge.replay.resident.max-lag-records": 4096,
    # refresh loop: records pulled per partition per fold round, and how long
    # an idle round waits on wait_for_append before re-polling
    "surge.replay.resident.refresh-max-poll-records": 4096,
    "surge.replay.resident.refresh-interval-ms": 50,
    # decode each round's committed tail with the batch deserializer when
    # one is wired (false: the per-event feed)
    "surge.replay.resident.native-feed": True,
    # "bucketed" deals a round's lanes into pow2 length buckets, one fused
    # program per occupied bucket; "dense" folds one rectangle per round
    "surge.replay.resident.refresh-dispatch": "bucketed",  # bucketed | dense
    # refresh rounds retained in the engine's replay ledger ring
    "surge.replay.resident.ledger-capacity": 512,
    # --- incremental materialized views + changefeeds (replay/views.py) ---
    # per-view delta ring depth: how many fold rounds a changefeed resume
    # watermark may lag before a subscription is answered with a one-shot
    # reconciling snapshot instead of the missed deltas
    "surge.replay.views.changefeed-rounds": 256,
    # group cap of one materialized view (distinct aggregate ids or group-by
    # keys); a view that overflows degrades to an error state
    "surge.replay.views.max-groups": 1_048_576,
    # --- the scan engine over columnar segments (replay/query.py) ---
    # event-axis pad bucket of one scan: chunks pad up to power-of-two
    # buckets at least this large
    "surge.query.chunk-events": 65536,
    # shard the scan's event axis over a mesh (the port has none: a mesh
    # raises, see QueryEngine)
    "surge.query.mesh": True,
    # row cap of one QueryStates/ScanSegments reply
    "surge.query.max-rows": 10_000,
    # --- the engine's host modules (engine/, store/, log/, health/,
    # metrics/, tracing/), with the reference's defaults ---
    # --- log / producer (reference: surge.kafka.publisher.*) ---
    # group-commit flush triggers (the Kafka producer linger.ms /
    # batch.size analog): a batch commits when the FIRST pending publish has
    # lingered this long OR the batch hits max-records/max-bytes, whichever
    # comes first. An idle engine therefore commits a lone command in
    # ~linger time; a loaded engine fills batches.
    "surge.producer.linger-ms": 2,
    "surge.producer.batch-max-records": 512,
    "surge.producer.batch-max-bytes": 4 << 20,
    # bounded pipelining (max.in.flight.requests.per.connection analog):
    # how many publish transactions one partition lane may have in flight
    # concurrently. >1 requires a transport with pipelined commits (the gRPC
    # log client); exactly-once rests on the broker's per-producer txn_seq
    # dedup + in-order apply gate. In-process logs fall back to 1 (their
    # commit latency IS the group-commit pacing).
    "surge.producer.max-in-flight": 4,
    # backpressure: publishes past this many queued records await a slot
    # instead of growing the lane queue without bound under overload
    "surge.producer.pending-max-records": 16_384,
    # housekeeping tick: fenced-reinit retries, verbatim-retry pacing and
    # dedup-TTL purges run on this cadence (pre-group-commit it was the
    # fixed flush tick; the flush itself is event-driven now)
    "surge.producer.flush-interval-ms": 50,
    "surge.producer.slow-transaction-warning-ms": 1_000,
    "surge.producer.ktable-check-interval-ms": 500,
    "surge.producer.enable-transactions": True,
    # publish dedup window (the PublishTracker 60s TTL, KafkaProducerActorImpl.scala:580-608)
    "surge.producer.publish-dedup-ttl-ms": 60_000,
    # verbatim retries of an unknown-outcome batch before its waiters fail
    # over to the entity retry ladder
    "surge.producer.publish-retry-max": 8,
    # --- state store / ktable (reference: surge.kafka-streams.*) ---
    "surge.state-store.commit-interval-ms": 3_000,
    "surge.state-store.restore-max-poll-records": 500,
    "surge.state-store.wipe-state-on-start": False,
    "surge.state-store.backend": "memory",  # memory | native | rocks-like file store
    # warm standby copies of each partition's materialized state on other nodes
    # (Kafka Streams num.standby.replicas, common reference.conf:24-25): each
    # node also tails the partitions it is ring-standby for, so a rebalance
    # promotion needs no state re-read
    "surge.state-store.num-standby-replicas": 0,
    # --- aggregate actor (reference: surge.state-store-actor.*) ---
    "surge.aggregate.ask-timeout-ms": 30_000,
    "surge.aggregate.idle-passivation-ms": 30_000,
    "surge.aggregate.init-retry-interval-ms": 500,
    "surge.aggregate.init-fetch-retry-ms": 2_000,
    "surge.aggregate.init-max-attempts": 10,
    "surge.aggregate.publish-max-retries": 3,
    "surge.aggregate.publish-timeout-ms": 30_000,
    "surge.aggregate.passivation-buffer-limit": 1000,
    # --- serialization (core reference.conf:73-76) ---
    "surge.serialization.thread-pool-size": 32,
    # command-path fast path: event batches at most this long serialize
    # INLINE on the event loop instead of paying the thread-pool hop (~80us
    # per command) — big payloads still offload. 0 = always off-thread.
    "surge.serialization.inline-max-events": 4,
    # --- metrics ---
    # capture OpenMetrics exemplars (trace id per histogram bucket) on the
    # ENGINE registry; broker registries are always exemplar-on
    "surge.metrics.exemplars": False,
    # --- tracing: tail sampling + kept-trace rings (tracing/tail.py) ---
    # buffer head-sampled spans per trace and KEEP a completed trace iff it
    # erred, breached tail.latency-ms, or landed in an SLO breach window —
    # under a bounded keep budget. Only matters when a tracer is wired
    # (tracer=None keeps every hop at zero cost as before).
    "surge.trace.tail.enabled": True,
    # a trace whose slowest span ran at least this is kept (the latency
    # breach criterion of the tail decision)
    "surge.trace.tail.latency-ms": 250,
    # keep budget: at most this many kept traces per budget window; eligible
    # traces past it are dropped and counted (surge.trace.dropped)
    "surge.trace.tail.keep-budget": 64,
    "surge.trace.tail.budget-window-ms": 10_000,
    # bound on spans buffered for in-flight traces; oldest traces evict past
    # it (leaked spans must not grow the buffer without bound)
    "surge.trace.tail.max-buffer-spans": 4096,
    # how long after an SLO breach every completing trace is kept (the
    # breach-adjacent anatomy evidence window)
    "surge.trace.tail.breach-window-ms": 30_000,
    # kept traces retained per engine/broker ring (DumpTraces RPC source)
    "surge.trace.ring-capacity": 256,
    # --- state checkpoints (store/checkpoint.py; compaction.md) ---
    # directory for atomic checkpoint files ("" disables the writer); the
    # incremental writer materializes on interval + min-events cadence and
    # retains the newest `keep` checkpoints
    "surge.store.checkpoint.path": "",
    "surge.store.checkpoint.interval-ms": 30_000,
    "surge.store.checkpoint.min-events": 1,
    "surge.store.checkpoint.keep": 2,
    # --- broker-side log compaction (log/compactor.py; compaction.md) ---
    # dirty-ratio scheduler: a pass runs when dirty/total >= min-dirty-ratio
    # AND dirty records >= min-dirty-records, checked every interval;
    # tombstones older than the retention are GC'd
    "surge.log.compaction.enabled": False,
    "surge.log.compaction.interval-ms": 30_000,
    "surge.log.compaction.min-dirty-ratio": 0.5,
    "surge.log.compaction.min-dirty-records": 64,
    "surge.log.compaction.tombstone-retention-ms": 60_000,
    # --- leader failover (KIP-101/KIP-279 epoch fencing; docs/operations.md) ---
    # a follower started with follower_of= may probe its leader and promote
    # itself once the prober declares it dead (probe-failures consecutive
    # failures at probe-interval). The declare threshold is the availability/
    # split-brain dial: promotion while the leader still serves forks the log.
    "surge.log.failover.auto-promote": False,
    "surge.log.failover.probe-interval-ms": 1_000,
    "surge.log.failover.probe-failures": 3,
    # a peer NEVER seen alive gets probe-failures x this grace before being
    # declared dead (a follower booting first must not promote over a leader
    # that is still starting; bounded so a truly absent leader still fails over)
    "surge.log.failover.bootstrap-grace-factor": 10,
    # --- engine command lane (the de-asyncio'd fast path) ---
    # "direct": entity -> publisher handoff without per-command event-loop
    # machinery — pendings of one forming batch share a single BATCH-LEVEL
    # ack future (resolved once per group commit), a timed-out caller's
    # records stay queued and a same-request_id retry JOINS them (the
    # request-id dedup keeps exactly-once), and entities await publishes
    # through a bare timer wait instead of a wrapper task. "classic": the
    # PR-3 per-command future + cancel-withdraw machinery (the paired bench
    # arm, and the fallback if a workload depends on withdraw-on-timeout).
    "surge.producer.command-lane": "direct",
    # --- fault-injection plane (testing/faults.py) ---
    # a named plan (e.g. "flaky-network") or JSON rule list armed at broker/
    # FileLog construction; empty = no plane, hooks cost one attribute check.
    # Runtime arming: the broker's ArmFaults RPC (tools/chaos.py).
    "surge.log.faults.plan": "",
    "surge.log.faults.seed": 0,
    # --- health (common reference.conf:228-260) ---
    "surge.health.window-frequency-ms": 10_000,
    "surge.health.window-buffer-size": 10,
    "surge.health.signal-buffer-size": 25,
    "surge.health.supervisor-restart-max": 3,
    # --- event-loop starvation prober (execution-context-prober analog) ---
    "surge.event-loop-prober.enabled": True,
    "surge.event-loop-prober.interval-ms": 1_000,
    "surge.event-loop-prober.threshold-ms": 200,
    "surge.event-loop-prober.late-probes": 3,
    # --- feature flags (core reference.conf:64-71) ---
    "surge.feature-flags.experimental.enable-mesh-sharding": False,
    # alternative clustering backend (external shard allocation; the
    # enable-akka-cluster analog, core reference.conf:64-66)
    "surge.feature-flags.experimental.enable-cluster-sharding": False,
    "surge.feature-flags.experimental.disable-single-record-transactions": False,
    # --- engine ---
    "surge.engine.num-partitions": 8,
    "surge.engine.dr-standby-enabled": False,
    # engine-side flight-recorder ring size (events); the admin DumpFlight
    # RPC and BrokerStatus-style stats report occupancy + dropped count
    "surge.engine.flight-capacity": 1024,
    # --- consistency observatory (observability/audit.py) ---
    # opt-in: the auditor is a supervised Controllable the engine only
    # starts when enabled. interval paces cycles; cohort-size bounds the
    # aggregates shadow-replayed per cycle; digest-enabled gates the
    # cross-replica digest compare; dedup-probe gates the exactly-once
    # replay probe (skipped automatically on transports without a seq gate)
    "surge.audit.enabled": False,
    "surge.audit.interval-ms": 2_000,
    "surge.audit.cohort-size": 8,
    "surge.audit.digest-enabled": True,
    "surge.audit.dedup-probe": True,
}


@dataclass
class Config:
    """Layered config: overrides > env > DEFAULTS."""

    overrides: dict[str, Any] = field(default_factory=dict)
    defaults: Mapping[str, Any] = field(default_factory=lambda: DEFAULTS)

    def get(self, key: str, fallback: Any = None) -> Any:
        if key in self.overrides:
            return self.overrides[key]
        env = os.environ.get(_env_key(key))
        if env is not None:
            return _coerce(env, self.defaults.get(key, fallback))
        if key in self.defaults:
            return self.defaults[key]
        return fallback

    def get_int(self, key: str, fallback: int = 0) -> int:
        return int(self.get(key, fallback))

    def get_float(self, key: str, fallback: float = 0.0) -> float:
        return float(self.get(key, fallback))

    def get_bool(self, key: str, fallback: bool = False) -> bool:
        v = self.get(key, fallback)
        if isinstance(v, str):
            return v.strip().lower() in ("1", "true", "yes", "on")
        return bool(v)

    def get_seconds(self, key: str, fallback_ms: int = 0) -> float:
        """Millisecond config value as seconds (asyncio sleeps take seconds)."""
        return self.get_int(key, fallback_ms) / 1000.0

    def get_str(self, key: str, fallback: str = "") -> str:
        return str(self.get(key, fallback))

    def get_int_list(self, key: str, fallback: str = "") -> list[int]:
        raw = self.get_str(key, fallback)
        return [int(p) for p in raw.split(",") if p.strip()]

    def with_overrides(self, overrides: Mapping[str, Any] | None = None,
                       **kv: Any) -> "Config":
        """Layer overrides on top. Dotted keys go in ``overrides``; keyword args
        use underscore form (``surge_replay_time_chunk``) and are canonicalized
        against the known default keys."""
        merged = dict(self.overrides)
        merged.update(overrides or {})
        canonical = {_env_key(k): k for k in self.defaults}
        for k, v in kv.items():
            merged[canonical.get(_env_key(k), k)] = v
        return Config(overrides=merged, defaults=self.defaults)


def _coerce(env_value: str, exemplar: Any) -> Any:
    """Coerce an env-var string to the type of the default it overrides."""
    if isinstance(exemplar, bool):
        return env_value.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(exemplar, int):
        try:
            return int(env_value)
        except ValueError:
            return env_value
    if isinstance(exemplar, float):
        try:
            return float(env_value)
        except ValueError:
            return env_value
    return env_value


_DEFAULT = Config()


def default_config() -> Config:
    return _DEFAULT


# --- Typed accessor bundles (surge/internal/config/*.scala equivalents) ---


@dataclass(frozen=True)
class TimeoutConfig:
    """surge/internal/config/TimeoutConfig.scala equivalent."""

    ask_timeout_s: float
    publish_timeout_s: float

    @staticmethod
    def from_config(cfg: Config) -> "TimeoutConfig":
        return TimeoutConfig(
            ask_timeout_s=cfg.get_seconds("surge.aggregate.ask-timeout-ms"),
            publish_timeout_s=cfg.get_seconds("surge.aggregate.publish-timeout-ms"),
        )


@dataclass(frozen=True)
class RetryConfig:
    """surge/internal/config/RetryConfig.scala equivalent."""

    init_retry_interval_s: float
    init_fetch_retry_s: float
    init_max_attempts: int
    publish_max_retries: int

    @staticmethod
    def from_config(cfg: Config) -> "RetryConfig":
        return RetryConfig(
            init_retry_interval_s=cfg.get_seconds("surge.aggregate.init-retry-interval-ms"),
            init_fetch_retry_s=cfg.get_seconds("surge.aggregate.init-fetch-retry-ms"),
            init_max_attempts=cfg.get_int("surge.aggregate.init-max-attempts"),
            publish_max_retries=cfg.get_int("surge.aggregate.publish-max-retries"),
        )


@dataclass(frozen=True)
class BackoffConfig:
    """surge/internal/config/BackoffConfig.scala equivalent (BackoffSupervisor knobs)."""

    min_backoff_s: float = 0.1
    max_backoff_s: float = 10.0
    random_factor: float = 0.2
    max_retries: int = 3
