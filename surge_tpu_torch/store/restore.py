"""Bulk store restore, the cold-start rebuild — the port of
``surge_tpu/store/restore.py``:

- :func:`restore_from_state_topic`: the latest snapshot per aggregate of the
  compacted state topic into the store.
- :func:`restore_from_events`: every aggregate's state folded from the events
  topic. ``surge.replay.backend = tpu`` folds through the batched
  :class:`~surge_tpu_torch.replay.engine.ReplayEngine` on the engine's device
  (the CUDA card unless the caller passes ``device``), ``cpu`` runs the scalar
  per-aggregate fold; both write byte-identical stores. Three routes: in
  memory (``replay_ragged``), checkpointed (snapshots plus the tail past the
  checkpoint's watermarks) and, above ``surge.replay.restore-spill-events``
  records, spilled (a throwaway columnar segment, or the cpu backend's
  key-hash-range passes).
- :func:`restore_from_segment`: the store rebuilt from a columnar segment
  (``surge_tpu_torch.log.columnar``), chunk by chunk through the resident
  path (each chunk folded once by K1's list fold from the flat source) or,
  with ``surge.replay.segment-backend = streaming``, through
  ``replay_columnar``.

Each returns the ``partition → next offset`` watermarks an indexer resumes
from. A non-``None`` ``mesh`` raises: the port runs on one device.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence

from surge_tpu_torch.config import Config, default_config
from surge_tpu_torch.engine.model import ReplaySpec, fold_events
from surge_tpu_torch.store.kv import KeyValueStore

_log = logging.getLogger(__name__)


@dataclass
class RestoreResult:
    num_aggregates: int
    num_events: int
    watermarks: Dict[int, int]  # partition -> next offset (on the scanned topic)
    backend: str
    #: seconds per stage of a batched restore (``read``, ``wire``,
    #: ``upload``, ``fold``, ``pull``, ``decode``, ``writeback``; the
    #: non-resident windows' ``pack`` and ``h2d``), where the route keeps them
    stages: Dict[str, float] = field(default_factory=dict)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the port restores on one device; a sharded restore over a mesh "
            "is ROADMAP Queue 1 item 8")


def restore_from_state_topic(log, state_topic: str, store: KeyValueStore,
                             partitions: Optional[Sequence[int]] = None) -> RestoreResult:
    """Latest-snapshot-per-key scan of the compacted state topic into the store."""
    parts = list(partitions if partitions is not None
                 else range(log.num_partitions(state_topic)))
    n = 0
    watermarks: Dict[int, int] = {}
    for p in parts:
        for key, rec in log.latest_by_key(state_topic, p).items():
            store.put(key, rec.value)
            n += 1
        watermarks[p] = log.end_offset(state_topic, p)
    return RestoreResult(num_aggregates=n, num_events=n, watermarks=watermarks,
                         backend="state-topic")


def _engine(replay_spec, cfg, device):
    from surge_tpu_torch.replay.engine import ReplayEngine

    if replay_spec is None:
        raise ValueError("tpu replay backend requires `replay_spec`")
    return ReplayEngine(replay_spec, config=cfg, device=device)


def _write_states(store, agg_ids, states, *, serialize_state, decode_state,
                  batched: bool) -> None:
    for agg_id, state in zip(agg_ids, states):
        if state is None:
            continue
        state = _with_aggregate_id(state, agg_id)
        if decode_state is not None and batched:
            # tensor-schema records back to domain states; the scalar fold's
            # states already are
            state = decode_state(agg_id, state)
        store.put(agg_id, serialize_state(agg_id, state))


def restore_from_events(
        log, events_topic: str, store: KeyValueStore, *,
        deserialize_event: Callable[[bytes], Any],
        serialize_state: Callable[[str, Any], bytes],
        model=None, replay_spec: Optional[ReplaySpec] = None,
        encode_event: Callable[[Any], Any] | None = None,
        decode_state: Callable[[str, Any], Any] | None = None,
        config: Config | None = None, mesh=None,
        partitions: Optional[Sequence[int]] = None,
        checkpoint=None,
        deserialize_state: Callable[[bytes], Any] | None = None,
        encode_state: Callable[[str, Any], Any] | None = None,
        device=None) -> RestoreResult:
    """Fold the whole events topic into per-aggregate states and write them back.

    ``surge.replay.backend``: ``tpu`` batches the fold through the replay
    engine on ``device`` (requires ``replay_spec``; ``encode_event`` maps raw
    events to their tensor-schema form and ``decode_state`` post-processes
    each decoded state given its aggregate id); ``cpu`` runs the scalar fold
    (requires ``model``).

    ``checkpoint`` (``watermarks``, ``states`` of serialized snapshots and
    ``partition_of``; ``deserialize_state`` reopens a snapshot) bounds the
    cold start: only events past the checkpoint's per-partition watermarks
    are folded, on top of the snapshots, and untouched aggregates keep their
    checkpointed bytes; ``encode_state`` maps a domain snapshot to its
    tensor-schema form. The store is byte-identical to the full fold's."""
    _no_mesh(mesh)
    cfg = config or default_config()
    backend = cfg.get_str("surge.replay.backend", "tpu")
    parts = list(partitions if partitions is not None
                 else range(log.num_partitions(events_topic)))
    if checkpoint is not None and deserialize_state is None:
        raise ValueError("checkpointed restore requires `deserialize_state`")
    spill = cfg.get_int("surge.replay.restore-spill-events", 1_000_000)
    if checkpoint is not None:
        tail = sum(max(log.end_offset(events_topic, p)
                       - checkpoint.watermarks.get(p, 0), 0) for p in parts)
        if not (0 <= spill < tail):
            return _restore_events_checkpointed(
                log, events_topic, store, parts, checkpoint=checkpoint,
                deserialize_event=deserialize_event,
                serialize_state=serialize_state,
                deserialize_state=deserialize_state, model=model,
                replay_spec=replay_spec, encode_event=encode_event,
                decode_state=decode_state, encode_state=encode_state,
                backend=backend, cfg=cfg, device=device)
        _log.warning("checkpoint tail (%d events) exceeds the spill "
                     "threshold; falling back to the full restore", tail)

    # above the spill threshold a whole-topic dict of event objects would not
    # fit: the tpu backend restores through a throwaway columnar segment, the
    # cpu backend folds in key-hash-range passes
    total_records = sum(log.end_offset(events_topic, p) for p in parts)
    if 0 <= spill < total_records:
        if backend == "tpu":
            return _restore_events_via_segment(
                log, events_topic, store, parts,
                deserialize_event=deserialize_event,
                serialize_state=serialize_state, replay_spec=replay_spec,
                encode_event=encode_event, decode_state=decode_state,
                cfg=cfg, device=device)
        if backend == "cpu":
            return _restore_events_cpu_ranges(
                log, events_topic, store, parts,
                deserialize_event=deserialize_event,
                serialize_state=serialize_state, model=model,
                total_records=total_records, threshold=spill)

    # group events by aggregate id in per-partition offset order; the
    # watermark is captured before the scan and clamps it, so a record
    # committed mid-restore is never covered but unfolded
    from surge_tpu_torch.log.transport import page_keyed_records

    stages: Dict[str, float] = {}
    t0 = time.perf_counter()
    logs: Dict[str, list] = {}
    num_events = 0
    watermarks: Dict[int, int] = {p: log.end_offset(events_topic, p)
                                  for p in parts}
    for p in parts:
        for rec in page_keyed_records(log, events_topic, p,
                                      upto=watermarks[p]):
            logs.setdefault(rec.key, []).append(deserialize_event(rec.value))
            num_events += 1
    stages["read"] = time.perf_counter() - t0

    agg_ids = list(logs)
    t0 = time.perf_counter()
    if backend == "cpu":
        if model is None:
            raise ValueError("cpu replay backend requires `model`")
        states = [fold_events(model, model.initial_state(a)
                              if hasattr(model, "initial_state") else None,
                              logs[a]) for a in agg_ids]
    elif backend == "tpu":
        from surge_tpu_torch.codec.tensor import decode_states

        engine = _engine(replay_spec, cfg, device)
        result = engine.replay_ragged([logs[a] for a in agg_ids], encode=encode_event)
        stages["fold"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        states = decode_states(replay_spec.registry.state, result.states)
        stages["decode"] = time.perf_counter() - t0
    else:
        raise ValueError(f"unknown replay backend {backend!r}")
    stages.setdefault("fold", time.perf_counter() - t0)

    t0 = time.perf_counter()
    _write_states(store, agg_ids, states, serialize_state=serialize_state,
                  decode_state=decode_state, batched=backend == "tpu")
    stages["writeback"] = time.perf_counter() - t0
    return RestoreResult(num_aggregates=len(agg_ids), num_events=num_events,
                         watermarks=watermarks, backend=backend, stages=stages)


def _restore_events_checkpointed(log, events_topic: str, store, parts, *,
                                 checkpoint, deserialize_event,
                                 serialize_state, deserialize_state,
                                 model, replay_spec, encode_event,
                                 decode_state, encode_state,
                                 backend, cfg, device) -> RestoreResult:
    """Checkpoint snapshots plus a fold of the post-watermark tail only; the
    store is byte-identical to the full fold from offset 0
    (``fold(init, head + tail) == fold(fold(init, head), tail)``, and the
    checkpoint writer serialized with the same ``serialize_state``)."""
    from surge_tpu_torch.log.transport import page_keyed_records

    watermarks: Dict[int, int] = {p: log.end_offset(events_topic, p)
                                  for p in parts}
    logs: Dict[str, list] = {}
    num_events = 0
    for p in parts:
        for rec in page_keyed_records(
                log, events_topic, p,
                start=checkpoint.watermarks.get(p, 0), upto=watermarks[p]):
            logs.setdefault(rec.key, []).append(deserialize_event(rec.value))
            num_events += 1
    # a scoped restore takes only the snapshots of the partitions it owns
    part_set = set(int(p) for p in parts)
    owned_states = {a: raw for a, raw in checkpoint.states.items()
                    if checkpoint.partition_of(a) in part_set}

    def snapshot(agg_id):
        """(present, state): a checkpointed None resumes from None; only
        aggregates the checkpoint lacks start fresh."""
        if agg_id not in owned_states:
            return False, None
        raw = owned_states[agg_id]
        return True, (None if raw is None else deserialize_state(raw))

    agg_ids = list(logs)
    if backend == "cpu":
        if model is None:
            raise ValueError("cpu replay backend requires `model`")
        states = []
        for a in agg_ids:
            present, init = snapshot(a)
            if not present and hasattr(model, "initial_state"):
                init = model.initial_state(a)
            states.append(fold_events(model, init, logs[a]))
    elif backend == "tpu":
        from surge_tpu_torch.codec.tensor import decode_states, encode_states

        engine = _engine(replay_spec, cfg, device)
        carry = engine.init_carry_np(max(len(agg_ids), 1))
        for i, a in enumerate(agg_ids):
            present, st = snapshot(a)
            if not present or st is None:
                continue  # the init record: the tensor form of the None state
            if encode_state is not None:
                st = encode_state(a, st)
            row = encode_states(replay_spec.registry.state, [st])
            for name in carry:
                carry[name][i] = row[name][0]
        result = engine.replay_ragged([logs[a] for a in agg_ids],
                                      encode=encode_event, init_carry=carry)
        states = decode_states(replay_spec.registry.state, result.states)
    else:
        raise ValueError(f"unknown replay backend {backend!r}")

    _write_states(store, agg_ids, states, serialize_state=serialize_state,
                  decode_state=decode_state, batched=backend == "tpu")
    # untouched aggregates keep their checkpointed bytes; snapshots folded to
    # None stay unwritten, like the full fold's None skip
    for agg_id, raw in owned_states.items():
        if agg_id in logs or raw is None:
            continue
        store.put(agg_id, raw)
    num_aggregates = len(set(owned_states) | set(logs))
    return RestoreResult(num_aggregates=num_aggregates, num_events=num_events,
                         watermarks=watermarks, backend=backend)


def _restore_events_via_segment(log, events_topic: str, store, parts, *,
                                deserialize_event, serialize_state,
                                replay_spec, encode_event, decode_state,
                                cfg, device) -> RestoreResult:
    """The tpu backend's bounded restore: topic → throwaway columnar segment
    (raw bytes spilled per chunk, one chunk's events decoded at a time) →
    :func:`restore_from_segment`. Peak host memory is one chunk's events,
    set by ``surge.replay.restore-chunk-aggregates``."""
    import os
    import shutil
    import tempfile

    from surge_tpu_torch.log.columnar import build_segment_from_topic

    if replay_spec is None:
        raise ValueError("tpu replay backend requires `replay_spec`")
    tmp = tempfile.mkdtemp(prefix="surge-restore-seg-")
    try:
        seg_path = os.path.join(tmp, "restore.scol")
        t0 = time.perf_counter()
        info = build_segment_from_topic(
            log, events_topic, replay_spec.registry,
            lambda m: deserialize_event(m.value), seg_path,
            partitions=parts, encode_event=encode_event,
            chunk_aggregates=cfg.get_int(
                "surge.replay.restore-chunk-aggregates", 65536))
        build_s = time.perf_counter() - t0
        res = restore_from_segment(
            seg_path, store, replay_spec=replay_spec,
            serialize_state=serialize_state, decode_state=decode_state,
            # the segment dies with this call: caching its wires is waste
            config=cfg.with_overrides(
                {"surge.replay.segment-wire-cache": False}),
            device=device)
        wm = info["schema"]["extra"]["watermarks"]
        return RestoreResult(
            # distinct keys, as the in-memory route counts them
            num_aggregates=len(info["aggregate_order"]),
            num_events=res.num_events,
            watermarks={int(p): int(v) for p, v in wm.items()}, backend="tpu",
            stages={"segment_build": build_s, **res.stages})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _restore_events_cpu_ranges(log, events_topic: str, store, parts, *,
                               deserialize_event, serialize_state, model,
                               total_records: int,
                               threshold: int) -> RestoreResult:
    """The cpu backend's bounded restore: K key-hash-range passes over the
    topic, each holding about total/K events as objects. Watermarks are
    captured before the first pass and clamp every pass. K is capped at 64."""
    import zlib

    from surge_tpu_torch.log.transport import page_keyed_records

    if model is None:
        raise ValueError("cpu replay backend requires `model`")
    num_ranges = min(64, max(2, -(-total_records // max(threshold, 1))))
    watermarks = {p: log.end_offset(events_topic, p) for p in parts}
    num_aggregates = 0
    num_events = 0
    for j in range(num_ranges):
        logs: Dict[str, list] = {}
        for p in parts:
            for rec in page_keyed_records(log, events_topic, p,
                                          upto=watermarks[p]):
                if zlib.crc32(rec.key.encode()) % num_ranges != j:
                    continue
                logs.setdefault(rec.key, []).append(
                    deserialize_event(rec.value))
                num_events += 1
        for agg_id, events in logs.items():
            init = (model.initial_state(agg_id)
                    if hasattr(model, "initial_state") else None)
            state = fold_events(model, init, events)
            if state is None:
                continue
            state = _with_aggregate_id(state, agg_id)
            store.put(agg_id, serialize_state(agg_id, state))
        num_aggregates += len(logs)
    return RestoreResult(
        num_aggregates=num_aggregates, num_events=num_events,
        watermarks=watermarks, backend="cpu")


def _chunk_wire(engine, segment_path: str, chunk, build_id: str | None = None):
    """The chunk's packed wire, cached beside the segment in
    ``<segment>.wires/<key>/``. Chunks are immutable once written, so the key
    is (the engine's wire-layout fingerprint, the segment's build id, the
    chunk's global ordinal, its event count); a cached wire the engine
    refuses (``check_wire``) is repacked, with a warning. A new entry is
    saved to a temporary directory and renamed into place, and temporary
    directories older than an hour are swept."""
    import hashlib
    import json
    import os
    import shutil

    from surge_tpu_torch.codec.wire import WireFormat
    from surge_tpu_torch.replay.engine import ResidentWire

    if chunk.source_ordinal is None:
        return engine.pack_resident(chunk)  # not from a segment reader
    wire_fmt = WireFormat(engine.spec.registry, dict(chunk.derived_cols))
    h = hashlib.sha1()
    h.update(json.dumps(wire_fmt.layout_fingerprint(),
                        sort_keys=True).encode())
    h.update(f"|{build_id or ''}|{chunk.source_ordinal}|"
             f"{chunk.num_events}".encode())
    cache_root = f"{segment_path}.wires"
    root = os.path.join(cache_root, h.hexdigest()[:20])
    if os.path.isdir(root):
        try:
            wire = ResidentWire.load(root)
            engine.check_wire(wire)
            return wire
        except Exception as exc:  # noqa: BLE001 — fall through to repack
            _log.warning("wire cache entry %s unusable (%s: %s); repacking",
                         root, type(exc).__name__, exc)
    wire = engine.pack_resident(chunk)
    try:
        cutoff = time.time() - 3600
        for entry in os.listdir(cache_root) if os.path.isdir(cache_root) else ():
            if ".tmp-" in entry:
                stale = os.path.join(cache_root, entry)
                if os.path.getmtime(stale) < cutoff:
                    shutil.rmtree(stale, ignore_errors=True)
    except OSError:
        pass
    tmp = f"{root}.tmp-{os.getpid()}"
    try:
        wire.save(tmp)
        os.rename(tmp, root)
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return wire


def restore_from_segment(
        path: str, store: KeyValueStore, *,
        replay_spec: ReplaySpec,
        serialize_state: Callable[[str, Any], bytes],
        decode_state: Callable[[str, Any], Any] | None = None,
        config: Config | None = None, mesh=None,
        partitions: Optional[Sequence[int]] = None,
        device=None) -> RestoreResult:
    """Rebuild the store from a columnar segment: chunks stream through the
    replay engine on ``device`` and only the per-aggregate writeback is
    Python. Each chunk folds through the resident path (``upload_resident``
    once, ``oneshot``: K1's list fold from the flat source) or, with
    ``surge.replay.segment-backend = streaming``, through
    ``replay_columnar``; ``surge.replay.segment-wire-cache`` keeps each
    chunk's packed wire beside the segment (:func:`_chunk_wire`). A delta
    chunk continues its aggregates from the states earlier chunks folded.
    The snapshot sections apply after the chunks, latest wins.

    ``partitions`` restores only the chunks and snapshot sections recorded
    for those source partitions. The result's ``stages`` gives the seconds
    of ``read``, ``wire`` (pack or cache load), ``upload``, ``fold``,
    ``pull``, ``decode``, ``writeback`` and ``snapshots``."""
    import numpy as np

    from surge_tpu_torch.codec.tensor import decode_states
    from surge_tpu_torch.log.columnar import (
        read_segment,
        read_segment_snapshots,
        segment_info,
    )

    _no_mesh(mesh)
    cfg = config or default_config()
    engine = _engine(replay_spec, cfg, device)
    info = segment_info(path)
    extra = info["schema"].get("extra", {})
    part_filter = None if partitions is None else {int(p) for p in partitions}
    use_resident = cfg.get_str("surge.replay.segment-backend",
                               "resident") == "resident"
    wire_cache = cfg.get_bool("surge.replay.segment-wire-cache", True)
    stages = dict.fromkeys(("read", "wire", "upload", "fold", "pull", "decode",
                            "writeback"), 0.0)
    stats0 = dict(engine.stats)

    # delta chunks continue earlier chunks' folds: keep each chunk's states
    # and an id index only when the segment was extended
    track = info.get("num_extends", 0) > 0
    chunk_states: list = []
    where: Dict[str, tuple] = {}
    restored: set = set()
    num_events = 0
    chunks = read_segment(path, partitions=part_filter)
    while True:
        t0 = time.perf_counter()
        chunk = next(chunks, None)
        stages["read"] += time.perf_counter() - t0
        if chunk is None:
            break
        if chunk.aggregate_ids is None:
            raise ValueError(
                f"{path}: segment chunks carry no aggregate ids; rebuild the "
                "segment with build_segment_from_topic to restore through it")
        init = None
        if track:
            hits = [(i, a) for i, a in enumerate(chunk.aggregate_ids)
                    if a in where]
            if hits:
                init = engine.init_carry_np(chunk.num_aggregates)
                for name, col in init.items():
                    for i, a in hits:
                        ci, row = where[a]
                        col[i] = chunk_states[ci][name][row]
        if use_resident:
            t0 = time.perf_counter()
            wire = (_chunk_wire(engine, path, chunk,
                                build_id=extra.get("build_id")) if wire_cache
                    else engine.pack_resident(chunk))
            t1 = time.perf_counter()
            resident = engine.upload_resident(wire)
            stages["wire"] += t1 - t0
            stages["upload"] += time.perf_counter() - t1
            # each chunk folds once: the dense layout's gather never pays
            resident.cache["oneshot"] = True
            res = engine.replay_resident(resident, init_carry=init)
        else:
            t0 = time.perf_counter()
            res = engine.replay_columnar(chunk, init_carry=init)
            stages["fold"] += time.perf_counter() - t0
        if track:
            chunk_states.append({k: np.asarray(v)
                                 for k, v in res.states.items()})
            ci = len(chunk_states) - 1
            for i, agg_id in enumerate(chunk.aggregate_ids):
                where[agg_id] = (ci, i)
        t0 = time.perf_counter()
        states = decode_states(replay_spec.registry.state, res.states)
        t1 = time.perf_counter()
        stages["decode"] += t1 - t0
        for agg_id, state in zip(chunk.aggregate_ids, states):
            if state is None:
                continue
            state = _with_aggregate_id(state, agg_id)
            if decode_state is not None:
                state = decode_state(agg_id, state)
            store.put(agg_id, serialize_state(agg_id, state))
            restored.add(agg_id)
        stages["writeback"] += time.perf_counter() - t1
        num_events += res.num_events
    # snapshot sections apply in file order after the chunks: a delta
    # snapshot supersedes an older chunk-folded state
    t0 = time.perf_counter()
    for key, value in read_segment_snapshots(path, partitions=part_filter):
        store.put(key, value)
        restored.add(key)
    stages["snapshots"] = time.perf_counter() - t0
    if use_resident:
        stages["fold"] += engine.stats["fold_s"] - stats0["fold_s"]
        stages["pull"] += engine.stats["pull_s"] - stats0["pull_s"]
    else:
        stages["pack"] = engine.stats["pack_s"] - stats0["pack_s"]
        stages["h2d"] = engine.stats["h2d_s"] - stats0["h2d_s"]

    # indexer priming: the segment covers the state topic up to its build-time
    # state watermarks (none when it was built without a state topic)
    wm_raw = extra.get("state_watermarks") or {}
    watermarks = {int(p): int(off) for p, off in wm_raw.items()
                  if part_filter is None or int(p) in part_filter}
    return RestoreResult(num_aggregates=len(restored), num_events=num_events,
                         watermarks=watermarks, backend="segment", stages=stages)


def _with_aggregate_id(state: Any, aggregate_id: str) -> Any:
    """Re-attach the aggregate id to a state rebuilt from tensor columns
    (string fields are not in the tensor schema)."""
    if dataclasses.is_dataclass(state) and any(
            f.name == "aggregate_id" for f in dataclasses.fields(state)):
        current = getattr(state, "aggregate_id", None)
        if not current:
            return dataclasses.replace(state, aggregate_id=aggregate_id)
    return state
