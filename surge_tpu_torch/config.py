"""Layered key/value config with env overrides — the port's copy of
``surge_tpu/config/__init__.py`` (``Config``, ``default_config``).

Keys are dotted strings (``surge.replay.batch-size``). Resolution order:
explicit overrides > environment (``SURGE_REPLAY_BATCH_SIZE``) > defaults. The
``surge.replay.*`` keys below carry the reference's exact defaults, so one
override dict drives both packages the same way.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Mapping


def _env_key(key: str) -> str:
    return key.upper().replace(".", "_").replace("-", "_")


#: the ``surge.replay.*`` keys the replay engine, the store restore and the
#: resident state plane read, with the reference's defaults (surge_tpu/config)
DEFAULTS: dict[str, Any] = {
    # restore_from_events: "tpu" folds through the batched engine (on the
    # engine's device), "cpu" runs the scalar per-aggregate fold
    "surge.replay.backend": "tpu",  # tpu | cpu
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
    # restore_from_events above this many records spills: the tpu backend
    # through a throwaway columnar segment, the cpu backend in key-hash-range
    # passes
    "surge.replay.restore-spill-events": 1_000_000,
    # aggregates per chunk of that throwaway segment
    "surge.replay.restore-chunk-aggregates": 65536,
    # --- the resident state plane (replay/resident_state.py) ---
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
