"""The port's store restore (surge_tpu_torch.store.restore) and columnar
segments (surge_tpu_torch.log.columnar) on the CPU against the reference's:
over one reference InMemoryLog, both packages restore byte-identical stores
(compared as sorted ``(key, bytes)`` items) on both backends and every route.
The reference's segments are written raw (its ``slz_compress`` patched to
return None) with a fixed build id, so the two packages' segment files are
byte-equal too."""

import json
import random
import uuid

import numpy as np
import pytest

from surge_tpu.config import default_config as jdefault_config
from surge_tpu.log import InMemoryLog, LogRecord, TopicSpec
from surge_tpu.log import columnar as jcolumnar
from surge_tpu.log import segment as jseg
from surge_tpu.models import counter as jcounter
from surge_tpu.serialization import SerializedMessage
from surge_tpu.store import CheckpointStore, CheckpointWriter
from surge_tpu.store.kv import InMemoryKeyValueStore as JStore
from surge_tpu.store.restore import restore_from_events as jrestore_events
from surge_tpu.store.restore import restore_from_segment as jrestore_segment
from surge_tpu_torch.config import Config
from surge_tpu_torch.log import columnar
from surge_tpu_torch.models import counter
from surge_tpu_torch.store import (
    InMemoryKeyValueStore,
    restore_from_events,
    restore_from_segment,
    restore_from_state_topic,
)
from tests.test_torch_isolation import leave_the_worker_as_found  # noqa: F401

EVT_FMT = jcounter.event_formatting()
STATE_FMT = jcounter.state_formatting()
PORT_EVENTS = {c.__name__: c for c in (counter.CountIncremented, counter.CountDecremented,
                                       counter.NoOpEvent, counter.UnserializableEvent)}
BASE = {"surge.replay.batch-size": 16, "surge.replay.time-chunk": 8}


def jdeserialize(raw):
    return EVT_FMT.read_event(SerializedMessage(key="", value=raw))


def pdeserialize(raw):
    """The reference's JSON event record as the port's counter event."""
    d = json.loads(raw.decode())
    return PORT_EVENTS[d.pop("_type")](**d)


def serialize_state(agg_id, state):
    """The reference's state format: port and reference states alike."""
    return json.dumps({"aggregate_id": state.aggregate_id, "count": state.count,
                       "version": state.version}).encode()


def pdeserialize_state(raw):
    return counter.State(**json.loads(raw.decode()))


def items(store):
    return sorted(store.all_items())


@pytest.fixture(autouse=True)
def raw_reference_segments(monkeypatch):
    """The reference writes raw payloads and a fixed build id, as the port."""
    monkeypatch.setattr(jseg, "slz_compress", lambda data: None)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=12345))


def seed_log(n_agg=40, per=5, partitions=2, seed=0):
    """Counter events of every kind, one partition per aggregate."""
    rng = random.Random(seed)
    log = InMemoryLog()
    log.create_topic(TopicSpec("events", partitions))
    prod = log.transactional_producer("seed")
    prod.begin()
    for i in range(n_agg):
        agg = f"agg-{i}"
        for k in range(rng.randrange(1, 2 * per)):
            roll = rng.random()
            ev = (jcounter.NoOpEvent(agg, k + 1) if roll < 0.1 else
                  jcounter.CountDecremented(agg, rng.randrange(1, 3), k + 1)
                  if roll < 0.35 else
                  jcounter.CountIncremented(agg, rng.randrange(1, 4), k + 1))
            prod.send(LogRecord(topic="events", key=agg,
                                value=EVT_FMT.write_event(ev).value,
                                partition=i % partitions))
    prod.commit()
    return log


def port_restore(log, overrides, **kw):
    store = InMemoryKeyValueStore()
    res = restore_from_events(
        log, "events", store, deserialize_event=pdeserialize,
        serialize_state=serialize_state, model=counter.CounterModel(),
        replay_spec=counter.make_replay_spec(),
        config=Config(overrides=dict(BASE, **overrides)), device="cpu", **kw)
    return res, store


def jax_restore(log, overrides, **kw):
    store = JStore()
    res = jrestore_events(
        log, "events", store, deserialize_event=jdeserialize,
        serialize_state=serialize_state, model=jcounter.CounterModel(),
        replay_spec=jcounter.make_replay_spec(),
        config=jdefault_config().with_overrides(dict(BASE, **overrides)), **kw)
    return res, store


# -- restore_from_events: in memory, spilled -----------------------------------------


@pytest.mark.parametrize("spill", [1_000_000, 50])
@pytest.mark.parametrize("backend", ["tpu", "cpu"])
def test_restore_from_events_matches_the_reference(backend, spill):
    """tests/test_restore_bounded.py:61 — the in-memory route and, with the
    spill threshold below the topic, the spilled routes (the tpu backend's
    throwaway segment, the cpu backend's key-hash-range passes)."""
    log = seed_log()
    ov = {"surge.replay.backend": backend,
          "surge.replay.restore-spill-events": spill,
          "surge.replay.restore-chunk-aggregates": 7}
    got, store = port_restore(log, ov)
    want, jstore = jax_restore(log, ov)
    assert items(store) == items(jstore)
    assert (got.backend, got.num_aggregates, got.num_events, got.watermarks) == \
        (want.backend, want.num_aggregates, want.num_events, want.watermarks)
    base, bstore = jax_restore(log, {"surge.replay.backend": "tpu"})
    assert items(store) == items(bstore)


@pytest.mark.parametrize("backend", ["tpu", "cpu"])
def test_checkpoint_plus_tail_is_byte_identical(tmp_path, backend):
    """tests/test_checkpoint.py:81 — the reference's checkpoint plus the
    port's tail fold equals the full fold, and the reference's restore."""
    log = seed_log(n_agg=12, per=20)
    ck_store = CheckpointStore(str(tmp_path), fsync=False)
    CheckpointWriter(log, "events", jcounter.CounterModel(), ck_store,
                     serialize_state=serialize_state,
                     deserialize_event=jdeserialize,
                     deserialize_state=STATE_FMT.read_state).write_now()
    prod = log.transactional_producer("tail")
    prod.begin()
    for i in range(80):
        agg = f"agg-{i % 15}"  # new aggregates join the old ones
        prod.send(LogRecord(topic="events", key=agg, value=EVT_FMT.write_event(
            jcounter.CountIncremented(agg, 1, 1000 + i)).value, partition=i % 2))
    prod.commit()
    ov = {"surge.replay.backend": backend}
    ck = ck_store.latest()
    full, full_store = port_restore(log, ov)
    tail, tail_store = port_restore(log, ov, checkpoint=ck,
                                    deserialize_state=pdeserialize_state)
    assert items(tail_store) == items(full_store)
    assert tail.num_events == 80 < full.num_events
    assert (tail.num_aggregates, tail.watermarks) == (full.num_aggregates,
                                                      full.watermarks)
    want, jstore = jax_restore(log, ov, checkpoint=ck,
                               deserialize_state=STATE_FMT.read_state)
    assert items(tail_store) == items(jstore)
    assert tail.num_events == want.num_events

    # tests/test_checkpoint.py:110: a checkpoint of the whole topic folds nothing
    CheckpointWriter(log, "events", jcounter.CounterModel(), ck_store,
                     serialize_state=serialize_state,
                     deserialize_event=jdeserialize,
                     deserialize_state=STATE_FMT.read_state).write_now()
    zero, zero_store = port_restore(log, ov, checkpoint=ck_store.latest(),
                                    deserialize_state=pdeserialize_state)
    assert zero.num_events == 0
    assert items(zero_store) == items(full_store)


def test_scoped_checkpointed_restore_takes_only_owned_partitions(tmp_path):
    """tests/test_checkpoint.py:183 — partitions=[0] with a checkpoint writes
    exactly the full fold of partition 0."""
    log = seed_log(n_agg=30, per=6)
    ck_store = CheckpointStore(str(tmp_path), fsync=False)
    CheckpointWriter(log, "events", jcounter.CounterModel(), ck_store,
                     serialize_state=serialize_state,
                     deserialize_event=jdeserialize,
                     deserialize_state=STATE_FMT.read_state).write_now()
    ck = ck_store.latest()
    for backend in ("cpu", "tpu"):
        ov = {"surge.replay.backend": backend}
        _, scoped = port_restore(log, ov, partitions=[0], checkpoint=ck,
                                 deserialize_state=pdeserialize_state)
        _, full = port_restore(log, ov, partitions=[0])
        assert items(scoped) == items(full)
        assert all(ck.partition_of(a) == 0 for a, _ in items(scoped))


def test_restore_from_state_topic():
    log = InMemoryLog()
    log.create_topic(TopicSpec("state", 2, compacted=True))
    prod = log.transactional_producer("s")
    prod.begin()
    for i in range(10):
        prod.send(LogRecord(topic="state", key=f"k{i % 4}", value=f"v{i}".encode(),
                            partition=i % 2))
    prod.send(LogRecord(topic="state", key="k1", value=None, partition=1))
    prod.commit()
    store = InMemoryKeyValueStore()
    res = restore_from_state_topic(log, "state", store)
    assert items(store) == [("k0", b"v8"), ("k2", b"v6"), ("k3", b"v7")]
    assert res.watermarks == {0: 5, 1: 6}


def test_a_mesh_raises():
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        port_restore(seed_log(n_agg=2), {}, mesh=object())


# -- columnar segments and restore_from_segment ---------------------------------------


def segment_log():
    """Events and state topics with a state-only key, as
    tests/test_columnar_segment.py:132 builds them."""
    from surge_tpu.engine.model import fold_events

    log = InMemoryLog()
    log.create_topic(TopicSpec("events", 2))
    log.create_topic(TopicSpec("state", 2, compacted=True))
    model = jcounter.CounterModel()
    rng = np.random.default_rng(9)
    prod = log.transactional_producer("seg")
    logs: dict = {}

    def send(agg, events, partition):
        prod.begin()
        for e in events:
            prod.send(LogRecord(topic="events", key=agg,
                                value=EVT_FMT.write_event(e).value,
                                partition=partition))
        st = fold_events(model, None, logs.get(agg, []) + list(events))
        prod.send(LogRecord(topic="state", key=agg,
                            value=STATE_FMT.write_state(st).value,
                            partition=partition))
        prod.commit()
        logs.setdefault(agg, []).extend(events)

    for i in range(20):
        agg = f"agg-{i}"
        send(agg, [jcounter.CountIncremented(agg, int(rng.integers(1, 4)), k + 1)
                   for k in range(int(rng.integers(1, 9)))], i % 2)
    prod.begin()
    prod.send(LogRecord(topic="state", key="lonely", value=b"OLD", partition=0))
    prod.commit()
    return log, logs, send, prod


def build_both(tmp_path, log, name="seg"):
    """One segment from each package, same topics, same settings."""
    jpath, ppath = str(tmp_path / f"{name}-ref.scol"), str(tmp_path / f"{name}-port.scol")
    jinfo = jcolumnar.build_segment_from_topic(
        log, "events", jcounter.make_registry(), EVT_FMT.read_event, jpath,
        derived_cols={"sequence_number": "ordinal"}, chunk_aggregates=8,
        state_topic="state")
    pinfo = columnar.build_segment_from_topic(
        log, "events", counter.make_registry(),
        lambda m: pdeserialize(m.value), ppath,
        derived_cols={"sequence_number": "ordinal"}, chunk_aggregates=8,
        state_topic="state")
    return jpath, ppath, jinfo, pinfo


def test_segment_files_are_byte_equal(tmp_path):
    log, _, _, _ = segment_log()
    jpath, ppath, jinfo, pinfo = build_both(tmp_path, log)
    assert open(jpath, "rb").read() == open(ppath, "rb").read()
    assert jinfo == pinfo
    assert pinfo["num_snapshots"] == 1
    for mine, ref in zip(columnar.read_segment(ppath), jcolumnar.read_segment(jpath)):
        assert (mine.aggregate_ids, mine.source_ordinal) == (ref.aggregate_ids,
                                                             ref.source_ordinal)
        assert mine.type_ids.tobytes() == ref.type_ids.tobytes()
    assert list(columnar.read_segment_snapshots(ppath)) == \
        list(jcolumnar.read_segment_snapshots(jpath))


def _restore_segment_both(path, overrides=None, partitions=None):
    cfg = dict(BASE, **(overrides or {}))
    store, jstore = InMemoryKeyValueStore(), JStore()
    res = restore_from_segment(path, store, replay_spec=counter.make_replay_spec(),
                               serialize_state=serialize_state,
                               config=Config(overrides=cfg), partitions=partitions,
                               device="cpu")
    jres = jrestore_segment(path, jstore, replay_spec=jcounter.make_replay_spec(),
                            serialize_state=serialize_state,
                            config=jdefault_config().with_overrides(cfg),
                            partitions=partitions)
    assert items(store) == items(jstore)
    assert (res.num_aggregates, res.num_events, res.watermarks) == \
        (jres.num_aggregates, jres.num_events, jres.watermarks)
    return res, store


@pytest.mark.parametrize("partitions", [None, [1]])
@pytest.mark.parametrize("route", ["resident", "streaming"])
def test_segment_with_delta_chunks_and_snapshots(tmp_path, route, partitions):
    """A segment the reference extended after more traffic (delta chunks that
    continue earlier folds, a state-only update of a snapshot key, a
    watermark section): both routes, whole and partition-scoped, equal the
    reference's restore and the scalar fold."""
    from surge_tpu.engine.model import fold_events

    log, logs, send, prod = segment_log()
    jpath, _, _, _ = build_both(tmp_path, log)
    for i in range(0, 20, 3):
        agg = f"agg-{i}"
        start = len(logs[agg])
        send(agg, [jcounter.CountIncremented(agg, 2, start + k + 1) for k in range(3)],
             i % 2)
    for i in range(20, 24):
        agg = f"agg-{i}"
        send(agg, [jcounter.CountIncremented(agg, 1, k + 1) for k in range(2)], i % 2)
    prod.begin()
    prod.send(LogRecord(topic="state", key="lonely", value=b"NEW", partition=0))
    prod.commit()
    jcolumnar.extend_segment_from_topic(log, "events", jcounter.make_registry(),
                                        EVT_FMT.read_event, jpath, state_topic="state")
    info = columnar.segment_info(jpath)
    assert info == jcolumnar.segment_info(jpath) and info["num_extends"] == 1
    res, store = _restore_segment_both(
        jpath, {"surge.replay.segment-backend": route}, partitions)
    owned = {f"agg-{i}" for i in range(24) if partitions is None or i % 2 == 1}
    for agg in owned:
        truth = fold_events(jcounter.CounterModel(), None, logs[agg])
        assert json.loads(store.get(agg)) == {"aggregate_id": agg, "count": truth.count,
                                              "version": truth.version}
    assert store.get("lonely") == (b"NEW" if partitions is None else None)
    assert res.backend == "segment"


def test_wire_cache_cold_then_warm(tmp_path):
    """The resident route caches each chunk's wire beside the segment; a
    second restore loads them and writes the same store; an entry the
    engine refuses is repacked."""
    import os

    log, _, _, _ = segment_log()
    _, ppath, _, _ = build_both(tmp_path, log)
    cold, cold_store = _restore_segment_both(ppath)
    entries = sorted(os.listdir(ppath + ".wires"))
    assert len(entries) == columnar.segment_info(ppath)["num_chunks"]
    warm, warm_store = _restore_segment_both(ppath)
    assert items(warm_store) == items(cold_store)
    assert set(cold.stages) >= {"read", "wire", "upload", "fold", "pull", "decode",
                                "writeback"}
    meta = os.path.join(ppath + ".wires", entries[0], "wire.json")
    with open(meta) as f:
        m = json.load(f)
    m["layout"]["type_bits"] += 1
    with open(meta, "w") as f:
        json.dump(m, f)
    again, again_store = _restore_segment_both(ppath)
    assert items(again_store) == items(cold_store)


def test_slz_chunk_is_refused(tmp_path, monkeypatch):
    """A payload the reference stored SLZ-compressed raises on the port's
    read, with the reference's message for an unbuilt native codec."""
    log, _, _, _ = segment_log()
    monkeypatch.setattr(jseg, "slz_compress", lambda data: b"\x00" if data else None)
    path = str(tmp_path / "slz.scol")
    jcolumnar.build_segment_from_topic(
        log, "events", jcounter.make_registry(), EVT_FMT.read_event, path,
        state_topic="state")
    with pytest.raises(RuntimeError, match="native segment codec not built"):
        next(columnar.read_segment(path))
    with pytest.raises(RuntimeError, match="native segment codec not built"):
        list(columnar.read_segment_snapshots(path))


def test_segment_without_ids_is_refused(tmp_path):
    from surge_tpu_torch.replay.corpus import synth_counter_corpus

    path = str(tmp_path / "noids.scol")
    with columnar.ColumnarSegmentWriter(path) as w:
        w.append(synth_counter_corpus(20, 200, seed=2).events)
    with pytest.raises(ValueError, match="no aggregate ids"):
        restore_from_segment(path, InMemoryKeyValueStore(),
                             replay_spec=counter.make_replay_spec(),
                             serialize_state=serialize_state, device="cpu")
