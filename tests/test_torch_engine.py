"""The port's engine (surge_tpu_torch.create_engine on the CPU, ``device="cpu"``)
against the reference's (surge_tpu.create_engine): the same commands go to both,
each over its own package's InMemoryLog, and every reply, topic record, store
entry, restore count, projection, query result, view snapshot, changefeed entry
and health tree must be equal. Everything here is exact: records and states are
compared as bytes, query and view columns by dtype and bytes.

Engines with a resident plane are driven in lock step: after each command the
plane of each engine folds the command's commit before the next one is sent, so
each command is one refresh round on both sides and the views' versions and
changefeeds line up."""

import asyncio
import dataclasses
import uuid

import numpy as np
import pytest
import torch

import surge_tpu
from surge_tpu.engine.partition import HostPort as JHostPort
from surge_tpu.engine.partition import PartitionTracker as JTracker
from surge_tpu.log import InMemoryLog as JInMemoryLog
from surge_tpu.log import columnar as jcolumnar
from surge_tpu.log import segment as jseg
from surge_tpu.models import counter as jcounter
from surge_tpu.replay.query import ScanQuery as JScanQuery
from surge_tpu.replay.query import scan_reference as jscan_reference
from surge_tpu.replay.views import ViewDef as JViewDef
import surge_tpu_torch
from surge_tpu_torch.common import ENGINE_WAITING
from surge_tpu_torch.engine.partition import HostPort, PartitionTracker
from surge_tpu_torch.log import InMemoryLog, copy_log
from surge_tpu_torch.log import columnar
from surge_tpu_torch.models import counter
from surge_tpu_torch.replay.query import ScanQuery
from surge_tpu_torch.replay.views import ViewDef
from tests.test_torch_isolation import leave_the_worker_as_found  # noqa: F401
from tests.test_torch_query import assert_same
from tests.test_views import GROUP_Q, SIMPLE_Q, TOTALS_Q

#: tests/test_engine_e2e.py's overrides
CFG = {
    "surge.producer.flush-interval-ms": 5,
    "surge.producer.ktable-check-interval-ms": 5,
    "surge.state-store.commit-interval-ms": 20,
    "surge.aggregate.init-retry-interval-ms": 5,
    "surge.engine.num-partitions": 4,
    "surge.replay.batch-size": 16,
    "surge.replay.time-chunk": 8,
    "surge.query.chunk-events": 1024,
}
PLANE = {"surge.replay.resident.enabled": True,
         "surge.replay.resident.refresh-interval-ms": 10}


@pytest.fixture(autouse=True)
def raw_reference_segments(monkeypatch):
    """The reference writes raw payloads (the port reads no SLZ codec)."""
    monkeypatch.setattr(jseg, "slz_compress", lambda data: None)


def jlogic():
    return surge_tpu.SurgeCommandBusinessLogic(
        aggregate_name="counter", model=jcounter.CounterModel(),
        state_format=jcounter.state_formatting(),
        event_format=jcounter.event_formatting())


def plogic():
    return surge_tpu_torch.SurgeCommandBusinessLogic(
        aggregate_name="counter", model=counter.CounterModel(),
        state_format=counter.state_formatting(),
        event_format=counter.event_formatting())


def reply_form(r):
    """A reply as plain data: its kind and its state's fields (or the
    rejection's message)."""
    if isinstance(r, (surge_tpu.CommandSuccess, surge_tpu_torch.CommandSuccess)):
        st = r.state
        return ("success", None if st is None else dataclasses.asdict(st))
    err = getattr(r, "reason", None) or getattr(r, "error", None)
    return (type(r).__name__, type(err).__name__, str(err))


def records(log):
    """Every topic's records per partition: offset, key, value bytes."""
    return {name: [[(r.offset, r.key, r.value) for r in log.read(name, p)]
                   for p in range(log.num_partitions(name))]
            for name in sorted(log._topics)}


def store_items(engine):
    return sorted(engine.indexer.store.all_items())


def health_form(h):
    return (h.name, h.status, [health_form(c) for c in h.components])


def states_form(states):
    return {k: dataclasses.asdict(v) for k, v in states.items()}


async def settle(engine, timeout=20.0):
    """Wait until the engine's resident plane has folded every committed
    record (no-op without a plane)."""
    plane = engine.resident_plane
    if plane is None:
        return
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while plane.lag_records() != 0:
        assert loop.time() < deadline, "resident plane never caught up"
        await asyncio.sleep(0.005)


class EngineDuo:
    """The reference engine over a reference log and the port's engine over
    the port's log, built from one override dict (``segments``: each engine
    its own segment path, ``(reference, port)``)."""

    def __init__(self, overrides=None, *, jlog=None, plog=None, jkw=None, pkw=None,
                 segments=None):
        ov = dict(CFG, **(overrides or {}))
        jov, pov = dict(ov), dict(ov)
        if segments is not None:
            jov["surge.replay.segment-path"], pov["surge.replay.segment-path"] = segments
        self.jlog = jlog if jlog is not None else JInMemoryLog()
        self.plog = plog if plog is not None else InMemoryLog()
        self.j = surge_tpu.create_engine(
            jlogic(), log=self.jlog,
            config=surge_tpu.default_config().with_overrides(jov), **(jkw or {}))
        self.p = surge_tpu_torch.create_engine(
            plogic(), log=self.plog,
            config=surge_tpu_torch.default_config().with_overrides(pov),
            device="cpu", **(pkw or {}))

    async def start(self):
        await self.j.start()
        await self.p.start()

    async def stop(self):
        await self.j.stop()
        await self.p.stop()

    async def send(self, name, agg, *args):
        """One command to each engine, in turn; the replies must agree."""
        rj = await self.j.aggregate_for(agg).send_command(
            getattr(jcounter, name)(agg, *args))
        await settle(self.j)
        rp = await self.p.aggregate_for(agg).send_command(
            getattr(counter, name)(agg, *args))
        await settle(self.p)
        assert reply_form(rp) == reply_form(rj), (name, agg)
        return rp

    async def apply(self, agg, by, seq):
        rj = await self.j.aggregate_for(agg).apply_events(
            [jcounter.CountIncremented(agg, by, seq)])
        await settle(self.j)
        rp = await self.p.aggregate_for(agg).apply_events(
            [counter.CountIncremented(agg, by, seq)])
        await settle(self.p)
        assert reply_form(rp) == reply_form(rj)

    def check_logs_and_stores(self):
        assert records(self.plog) == records(self.jlog)
        assert store_items(self.p) == store_items(self.j)


#: a command sequence through every kind of reply the counter gives
SCRIPT = ([("Increment", f"agg{i}") for i in range(10)]
          + [("Increment", "agg3"), ("Decrement", "agg4"), ("DoNothing", "agg5"),
             ("CreateNoOpEvent", "agg6"), ("FailCommandProcessing", "agg1", "no"),
             ("CreateExceptionThrowingEvent", "agg7", "boom"),
             ("Increment", "agg7"), ("Increment", "fresh")])


async def run_script(duo, script=SCRIPT):
    for cmd in script:
        await duo.send(*cmd)


@pytest.mark.parametrize("partitions", [2, 4])
@pytest.mark.parametrize("plane", [False, True], ids=["store", "plane"])
def test_commands_replies_records_and_store(partitions, plane):
    """Replies, every topic's records and the indexer's store, byte for byte,
    and the health tree, through 2 and 4 partitions, with and without the
    resident plane."""
    async def scenario():
        ov = {"surge.engine.num-partitions": partitions, **(PLANE if plane else {})}
        duo = EngineDuo(ov)
        await duo.start()
        assert health_form(duo.p.health_check()) == health_form(duo.j.health_check())
        await run_script(duo)
        assert (duo.p.producer_stats()["records_published"]
                == duo.j.producer_stats()["records_published"])
        await duo.stop()
        duo.check_logs_and_stores()
        assert health_form(duo.p.health_check()) == health_form(duo.j.health_check())

    asyncio.run(scenario())


def test_fluent_surface_and_not_running():
    async def scenario():
        eng = (surge_tpu_torch.SurgeEngineBuilder()
               .with_business_logic(plogic())
               .with_config(surge_tpu_torch.default_config().with_overrides(CFG))
               .with_log(InMemoryLog()).with_device("cpu").build())
        assert eng.status == surge_tpu_torch.dsl.EngineStatus.STOPPED
        await eng.start()
        r = await eng.aggregate_for("a").send_command(counter.Increment("a"))
        assert reply_form(r) == ("success", {"aggregate_id": "a", "count": 1,
                                             "version": 1})
        await eng.stop()
        with pytest.raises(surge_tpu_torch.dsl.EngineNotRunningError):
            eng._deliver_checked("a", None)

    asyncio.run(scenario())
    with pytest.raises(ValueError):
        surge_tpu_torch.SurgeEngineBuilder().build()


async def reference_history(jlog, n=12):
    """Commands through a reference engine: ragged counts, a decrement, a
    no-op event and a state-only aggregate."""
    eng = surge_tpu.create_engine(
        jlogic(), log=jlog, config=surge_tpu.default_config().with_overrides(CFG))
    await eng.start()
    for i in range(n):
        agg = f"agg{i}"
        for _ in range(i % 4 + 1):
            await eng.aggregate_for(agg).send_command(jcounter.Increment(agg))
    await eng.aggregate_for("agg2").send_command(jcounter.Decrement("agg2"))
    await eng.aggregate_for("agg5").send_command(jcounter.CreateNoOpEvent("agg5"))
    await eng.aggregate_for("state-only").apply_events(
        [jcounter.CountIncremented("state-only", 7, 1)])
    await eng.stop()


def test_copy_log_carries_every_record():
    async def scenario():
        jlog = JInMemoryLog()
        await reference_history(jlog)
        # a compacted partition keeps its sparse offsets through the copy
        jlog.compact_partition("counter-state", 0)
        plog = copy_log(jlog)
        assert records(plog) == records(jlog)
        for name in jlog._topics:
            assert plog.topic(name).compacted == jlog.topic(name).compacted
            for p in range(jlog.num_partitions(name)):
                assert plog.end_offset(name, p) == jlog.end_offset(name, p)
        only = copy_log(jlog, topics=["counter-events"])
        assert list(only._topics) == ["counter-events"]

    asyncio.run(scenario())


def segment_form(path):
    """A segment as the reference reads it: every chunk's ids and arrays,
    and the snapshot sections."""
    chunks = [(c.aggregate_ids, c.agg_idx.tobytes(), c.type_ids.tobytes(),
               {k: v.tobytes() for k, v in sorted(c.cols.items())})
              for c in jcolumnar.read_segment(path)]
    return chunks, list(jcolumnar.read_segment_snapshots(path))


def restored(result):
    return (result.num_aggregates, result.num_events, dict(result.watermarks))


@pytest.mark.parametrize("route", ["events-tpu", "events-cpu", "segment"])
def test_cold_start_restores_equal_stores(tmp_path, route):
    """``restore-on-start`` over ``copy_log`` of one reference history: equal
    stores and restore counts on the events route (both backends) and on the
    segment route, cold, then warm after more commands (the segment extends;
    the reference reads both packages' segments to equal arrays)."""
    async def scenario():
        jlog = JInMemoryLog()
        await reference_history(jlog)
        plog = copy_log(jlog)
        ov = {"surge.replay.restore-on-start": True}
        if route == "events-cpu":
            ov["surge.replay.backend"] = "cpu"
        paths = (str(tmp_path / "ref.scol"), str(tmp_path / "port.scol"))

        def duo():
            return EngineDuo(ov, jlog=jlog, plog=plog,
                             segments=paths if route == "segment" else None)

        d = duo()
        await d.start()
        assert d.p.indexer.store.approximate_num_entries() == 13
        assert store_items(d.p) == store_items(d.j)
        assert restored(await d.p.rebuild_from_events()) == \
            restored(await d.j.rebuild_from_events())
        assert store_items(d.p) == store_items(d.j)
        if route == "segment":
            for i in range(6):
                await d.send("Increment", f"agg{i}")
            await d.send("Increment", "late")
            await d.stop()
            d = duo()
            await d.start()  # the stale segments extend, then restore
            assert store_items(d.p) == store_items(d.j)
            assert segment_form(paths[1]) == segment_form(paths[0])
            assert restored(await d.p.rebuild_from_events()) == \
                restored(await d.j.rebuild_from_events())
        await d.stop()
        d.check_logs_and_stores()

    asyncio.run(scenario())


@pytest.mark.parametrize("use_segment", [False, True], ids=["events", "segment"])
def test_two_node_cold_restore_is_partition_scoped(tmp_path, use_segment):
    """tests/test_engine_e2e.py:357 with both packages: each node restores only
    its owned partitions, and the two packages' stores are equal per node."""
    async def scenario():
        jlog = JInMemoryLog()
        await reference_history(jlog, n=24)
        plog = copy_log(jlog)
        ov = {"surge.replay.restore-on-start": True}
        n = CFG["surge.engine.num-partitions"]
        for host_i, parity in ((1, 0), (2, 1)):
            owned = [p for p in range(n) if p % 2 == parity]
            others = [p for p in range(n) if p % 2 != parity]
            jt, pt = JTracker(), PartitionTracker()
            jt.update({JHostPort("node-a", 1 if parity == 0 else 2): owned,
                       JHostPort("node-b", 2 if parity == 0 else 1): others})
            pt.update({HostPort("node-a", 1 if parity == 0 else 2): owned,
                       HostPort("node-b", 2 if parity == 0 else 1): others})
            if use_segment:
                ov["surge.replay.segment-path"] = str(tmp_path / f"two-{host_i}.scol")
            d = EngineDuo(ov, jlog=jlog, plog=plog,
                          jkw={"local_host": JHostPort("node-a", 1 if parity == 0 else 2),
                               "tracker": jt},
                          pkw={"local_host": HostPort("node-a", 1 if parity == 0 else 2),
                               "tracker": pt})
            await d.start()
            assert sorted(d.p.indexer.partitions) == owned
            assert store_items(d.p) == store_items(d.j)
            assert all(d.p.router.partition_for(k) in owned for k, _ in store_items(d.p))
            await d.stop()

    asyncio.run(scenario())


def test_resident_plane_serves_reads():
    """tests/test_engine_e2e.py:156 with both packages: equal projections, a
    passivated entity re-initialised from the plane's gather lane, and a
    rebalance that retargets the plane with the indexer."""
    async def scenario():
        duo = EngineDuo({**PLANE, "surge.aggregate.idle-passivation-ms": 40})
        await duo.start()
        plane = duo.p.resident_plane
        assert plane is not None and plane.running and plane.device.type == "cpu"
        assert plane.partitions == duo.j.resident_plane.partitions == [0, 1, 2, 3]
        aggs = [f"agg{i}" for i in range(8)]
        for agg in aggs:
            await duo.send("Increment", agg)
        assert plane.occupancy() == duo.j.resident_plane.occupancy() == len(aggs)
        want = states_form(await duo.j.project_states(aggs + ["never-seen"]))
        assert states_form(await duo.p.project_states(aggs + ["never-seen"])) == want
        assert set(want) == set(aggs) and plane.stats["gathers"] >= 1

        await asyncio.sleep(0.15)  # passivate; re-init reads the plane
        gathered = plane.stats["gathered_rows"]
        r = await duo.send("Increment", "agg0")
        assert r.state.count == 2
        assert plane.stats["gathered_rows"] > gathered
        assert health_form(duo.p.health_check()) == health_form(duo.j.health_check())

        duo.j.tracker.update({duo.j.local_host: [0, 1]})
        duo.p.tracker.update({duo.p.local_host: [0, 1]})
        assert set(plane.partitions) == set(duo.p.indexer.partitions) == \
            set(duo.j.resident_plane.partitions)
        await duo.stop()
        assert not plane.running
        duo.check_logs_and_stores()

    asyncio.run(scenario())


QUERIES = {
    "counts": {"aggregates": [{"op": "count"},
                              {"op": "sum", "column": "increment_by"}],
               "event_types": ["CountIncremented"]},
    "totals": TOTALS_Q.as_json(),
    "grouped": GROUP_Q.as_json(),
}
STATE_QUERIES = {
    "count-ge": {"select": ["count"],
                 "predicates": [{"column": "count", "op": ">=", "value": 4}]},
    "all": {"select": ["count", "version"]},
}


@pytest.mark.parametrize("partitions", [None, [0, 1]], ids=["all", "scoped"])
def test_engine_query_and_query_states(tmp_path, partitions):
    """tests/test_query_engine.py:466's engine half with both packages: the
    segment builds on the first query and extends on the next, and every
    ``QueryResult`` is equal (ids, counts, column dtypes and bytes); the
    scan equals the numpy reference over the port's segment."""
    async def scenario():
        duo = EngineDuo({"surge.engine.num-partitions": 2},
                        segments=(str(tmp_path / "ref.scol"),
                                  str(tmp_path / "port.scol")))
        await duo.start()
        for i in range(6):
            for _ in range(i + 1):
                await duo.send("Increment", f"q-{i}")
        await duo.send("Decrement", "q-2")
        for round_ in range(2):
            for q in QUERIES.values():
                got = await duo.p.query(q, partitions=partitions)
                want = await duo.j.query(q, partitions=partitions)
                assert_same(got, want)
                oracle = jscan_reference(
                    jcolumnar.read_segment(str(tmp_path / "port.scol"),
                                           partitions=partitions
                                           and set(partitions)),
                    JScanQuery.from_json(q), jcounter.make_registry())
                assert_same(got, oracle, ordered=False)
            for sq in STATE_QUERIES.values():
                assert_same(await duo.p.query_states(sq, partitions=partitions),
                            await duo.j.query_states(sq, partitions=partitions))
            # the second round scans a segment extended by these commands
            await duo.send("Increment", "q-0")
            await duo.send("Increment", "q-new")
        vals = duo.p.metrics_registry.get_metrics()
        assert vals["surge.query.scanned-events"] > 0
        assert (duo.p.replay_ledger.summary()["queries"]
                == duo.j.replay_ledger.summary()["queries"])
        await duo.stop()

    asyncio.run(scenario())


def snapshot_form(snap):
    snap = dict(snap)
    cols = snap.pop("columns", {})
    return snap, {k: (np.asarray(v).dtype.str, np.asarray(v).tobytes())
                  for k, v in cols.items()}


def drain(sub) -> list:
    out = []
    while not sub.queue.empty():
        out.append(sub.queue.get_nowait())
    return out


def test_views_snapshots_and_changefeeds(tmp_path):
    """tests/test_views.py:628's engine half with both packages: a view
    registered before start folds through the seed and every refresh round,
    ``query_view`` snapshots and ``view_summary`` rows are equal, a
    subscription's changefeed entries are equal, and a view registered while
    running backfills to equal snapshots."""
    async def scenario():
        jlog = JInMemoryLog()
        await reference_history(jlog)
        duo = EngineDuo({**PLANE, "surge.engine.num-partitions": 2},
                        jlog=jlog, plog=copy_log(jlog))
        duo.j.register_view({"name": "totals", "query": SIMPLE_Q.as_json()})
        duo.p.register_view({"name": "totals", "query": SIMPLE_Q.as_json()})
        await duo.start()
        await settle(duo.j)
        await settle(duo.p)

        async def same(name):
            assert snapshot_form(await duo.p.query_view(name)) == \
                snapshot_form(await duo.j.query_view(name))

        await same("totals")
        jsub = await duo.j.subscribe_view("totals")
        psub = await duo.p.subscribe_view("totals")
        for i in range(4):
            await duo.send("Increment", f"agg{i}")
        await duo.send("Decrement", "agg9")
        await same("totals")
        duo.j.register_view(JViewDef(name="grouped", query=GROUP_Q))
        duo.p.register_view(ViewDef(name="grouped", query=ScanQuery.from_json(
            GROUP_Q.as_json())))
        await duo.send("Increment", "agg0")
        await same("totals")
        await same("grouped")
        strip = lambda rows: [{k: v for k, v in r.items() if k != "query"}  # noqa: E731
                              for r in rows]
        assert strip(await duo.p.view_summary()) == strip(await duo.j.view_summary())
        for _ in range(3):
            await asyncio.sleep(0)
        got, want = drain(psub), drain(jsub)
        assert got == want and want[0]["reset"] is True and len(want) > 1
        assert duo.p.unregister_view("grouped") is duo.j.unregister_view("grouped")
        await duo.stop()

    asyncio.run(scenario())


def test_a_second_engine_cold_starts_on_the_same_log(tmp_path):
    """stop(), then a second engine on the same log: the plane seeds, the
    segment extends and restores, and both packages agree with each other and
    with the first engines' stores."""
    async def scenario():
        ov = {**PLANE, "surge.replay.restore-on-start": True}
        paths = (str(tmp_path / "ref.scol"), str(tmp_path / "port.scol"))
        d = EngineDuo(ov, segments=paths)
        await d.start()
        await run_script(d)
        before = store_items(d.p)
        await d.stop()
        d2 = EngineDuo(ov, jlog=d.jlog, plog=d.plog, segments=paths)
        await d2.start()
        await settle(d2.j)
        await settle(d2.p)
        assert store_items(d2.p) == store_items(d2.j) == before
        aggs = sorted({cmd[1] for cmd in SCRIPT})
        assert states_form(await d2.p.project_states(aggs)) == \
            states_form(await d2.j.project_states(aggs))
        await d2.stop()

    asyncio.run(scenario())


# -- the device rule and the parts that wait ------------------------------------------


def test_an_engine_that_needs_the_card_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = surge_tpu_torch.default_config().with_overrides({**CFG, **PLANE})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        surge_tpu_torch.create_engine(plogic(), config=cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        surge_tpu_torch.create_engine(plogic(), config=cfg, device="cuda")
    eng = surge_tpu_torch.create_engine(plogic(), config=cfg, device="cpu")
    assert eng.resident_plane.device.type == "cpu"

    async def scenario():
        # no plane and the scalar backend: the cold start touches no device
        ov = {**CFG, "surge.replay.restore-on-start": True,
              "surge.replay.backend": "cpu"}
        eng = surge_tpu_torch.create_engine(
            plogic(), config=surge_tpu_torch.default_config().with_overrides(ov))
        await eng.start()
        await eng.aggregate_for("a").send_command(counter.Increment("a"))
        await eng.stop()
        assert eng._device is None
        # the batched backend needs the card
        ov["surge.replay.backend"] = "tpu"
        eng = surge_tpu_torch.create_engine(
            plogic(), config=surge_tpu_torch.default_config().with_overrides(ov))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            await eng.start()

    asyncio.run(scenario())


def test_a_mesh_raises(monkeypatch):
    cfg = surge_tpu_torch.default_config().with_overrides({**CFG, **PLANE})
    with pytest.raises(NotImplementedError, match="Multi-device"):
        surge_tpu_torch.create_engine(plogic(), config=cfg, device="cpu",
                                      mesh=object())
    flag = cfg.with_overrides(
        {"surge.feature-flags.experimental.enable-mesh-sharding": True})
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    eng = surge_tpu_torch.create_engine(plogic(), config=flag, device="cpu")
    assert eng._resolve_mesh() is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="Multi-device"):
        surge_tpu_torch.create_engine(plogic(), config=flag, device="cpu")


WAITING_OPTIONS = {
    "checkpoint": ({"surge.store.checkpoint.path": "ckpt"}, "store/checkpoint.py"),
    "audit": ({**PLANE, "surge.audit.enabled": True}, "observability/audit.py"),
    "cluster-sharding": (
        {"surge.feature-flags.experimental.enable-cluster-sharding": True},
        "engine/cluster.py"),
    "native-store": ({"surge.state-store.backend": "native"}, "store/native.py"),
}


@pytest.mark.parametrize("option", sorted(WAITING_OPTIONS))
def test_each_waiting_option_raises_naming_its_item(option):
    ov, module = WAITING_OPTIONS[option]
    cfg = surge_tpu_torch.default_config().with_overrides({**CFG, **ov})
    with pytest.raises(NotImplementedError) as err:
        surge_tpu_torch.create_engine(plogic(), config=cfg, device="cpu")
    assert module in str(err.value) and ENGINE_WAITING in str(err.value)


@pytest.mark.parametrize("call", ["serve_metrics", "register_saga_manager"])
def test_each_waiting_call_raises_naming_its_item(call):
    eng = surge_tpu_torch.create_engine(
        plogic(), config=surge_tpu_torch.default_config().with_overrides(CFG),
        device="cpu")
    args = () if call == "serve_metrics" else (object(),)
    with pytest.raises(NotImplementedError, match=ENGINE_WAITING.replace('"', '.')):
        getattr(eng, call)(*args)


# -- the segment's extend half --------------------------------------------------------


async def post_build_traffic(jlog):
    """Events for old and new keys, a command on the state-only aggregate and
    a state-only publish for a key the events topic never saw."""
    eng = surge_tpu.create_engine(
        jlogic(), log=jlog, config=surge_tpu.default_config().with_overrides(CFG))
    await eng.start()
    for agg in ("agg0", "agg5", "agg-new", "state-only"):
        await eng.aggregate_for(agg).send_command(jcounter.Increment(agg))
    await eng.aggregate_for("only-state-2").apply_events(
        [jcounter.CountIncremented("only-state-2", 3, 1)])
    await eng.stop()


@pytest.mark.parametrize("made_by", ["reference", "port"])
def test_extended_segment_reads_equal_in_the_reference(tmp_path, monkeypatch, made_by):
    """A segment built by either package and extended by the port (delta
    chunks, snapshot sections, the watermark section) reads to the same
    arrays in the reference's ``read_segment`` as the same segment extended
    by the reference; with one build id the two files are byte-equal."""
    jlog = JInMemoryLog()
    asyncio.run(reference_history(jlog))
    paths = [str(tmp_path / "a.scol"), str(tmp_path / "b.scol")]
    jspec = jcounter.make_replay_spec()
    jfmt, pfmt = jcounter.event_formatting(), counter.event_formatting()
    with monkeypatch.context() as m:
        m.setattr(uuid, "uuid4", lambda: uuid.UUID(int=3))
        for path in paths:
            if made_by == "reference":
                jcolumnar.build_segment_from_topic(
                    jlog, "counter-events", jspec.registry, jfmt.read_event, path,
                    chunk_aggregates=4, state_topic="counter-state",
                    derived_cols={"sequence_number": "ordinal"})
            else:
                columnar.build_segment_from_topic(
                    copy_log(jlog), "counter-events", counter.make_registry(),
                    pfmt.read_event, path, chunk_aggregates=4,
                    state_topic="counter-state",
                    derived_cols={"sequence_number": "ordinal"})
    asyncio.run(post_build_traffic(jlog))
    jinfo = jcolumnar.extend_segment_from_topic(
        jlog, "counter-events", jspec.registry, jfmt.read_event, paths[0],
        chunk_aggregates=4, state_topic="counter-state")
    plog = copy_log(jlog)
    pinfo = columnar.extend_segment_from_topic(
        plog, "counter-events", counter.make_registry(), pfmt.read_event,
        paths[1], chunk_aggregates=4, state_topic="counter-state")
    assert pinfo == jinfo
    assert open(paths[1], "rb").read() == open(paths[0], "rb").read()
    assert segment_form(paths[1]) == segment_form(paths[0])
    # a second extend with nothing new is a no-op
    size = len(open(paths[1], "rb").read())
    assert columnar.extend_segment_from_topic(
        plog, "counter-events", counter.make_registry(), pfmt.read_event,
        paths[1], chunk_aggregates=4, state_topic="counter-state") == pinfo
    assert len(open(paths[1], "rb").read()) == size
