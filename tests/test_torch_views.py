"""The port's materialized views (surge_tpu_torch.replay.views on the port's
resident plane, on the CPU) against the reference's (surge_tpu.replay.views on
the reference plane), driven in lockstep over ONE log: the same seed, then one
``_refresh_once`` on each plane after every append. After every step each
view's snapshot (keys, columns as raw bytes, rows, version, watermarks) and
every changefeed entry a subscriber received must be equal; the goldens also
hold each port view to a from-scratch port ``scan_chunks`` at its
watermarks. The cases follow tests/test_views.py (its single-device
scenarios)."""

import asyncio

import numpy as np
import pytest

from surge_tpu.config import default_config
from surge_tpu.metrics import Metrics, engine_metrics
from surge_tpu.models import counter as jcounter
from surge_tpu.replay.ledger import ReplayLedger
from surge_tpu.replay.resident_state import ResidentStatePlane as JPlane
from surge_tpu.replay.views import MaterializedViews as JViews
from surge_tpu.replay.views import ViewDef as JViewDef
from surge_tpu.serialization import SerializedMessage
from surge_tpu_torch.codec.tensor import encode_events_columnar
from surge_tpu_torch.config import Config
from surge_tpu_torch.models import counter
from surge_tpu_torch.replay.query import QueryEngine
from surge_tpu_torch.replay.resident_state import ResidentStatePlane
from surge_tpu_torch.replay.views import MaterializedViews, ViewDef, select_top_k
from tests.test_torch_isolation import leave_the_worker_as_found  # noqa: F401
from tests.test_torch_resident_state import port_event
from tests.test_views import (
    EVT,
    GROUP_Q,
    SIMPLE_Q,
    STATE,
    TOPIC,
    TOTALS_Q,
    EventGen,
    append_events,
    apply_entry,
    make_log,
)

VIEW_METRICS = ("surge.replay.views.delta-rows",
                "surge.replay.views.resume-gap-rounds",
                "surge.replay.views.subscribers")


def port_vdef(vdef: JViewDef) -> ViewDef:
    return ViewDef.from_json(vdef.as_json())


class ViewDuo:
    """The reference plane with the reference's views, and the port's plane
    with the port's views, over one log."""

    def __init__(self, log, *, capacity=64, overrides=None):
        base = {"surge.replay.resident.capacity": capacity,
                "surge.replay.resident.max-lag-records": 4096,
                "surge.replay.resident.refresh-interval-ms": 10,
                "surge.replay.batch-size": 16,
                "surge.replay.time-chunk": 8,
                "surge.query.chunk-events": 1024, **(overrides or {})}
        self.log = log
        self.regs = (Metrics(), Metrics())
        self.ledgers = (ReplayLedger(name="engine:j"), ReplayLedger(name="engine:t"))
        jcfg = default_config().with_overrides(base)
        tcfg = Config(overrides=base)
        self.j = JPlane(
            log, TOPIC, jcounter.make_replay_spec(), config=jcfg,
            deserialize_event=lambda raw: EVT.read_event(
                SerializedMessage(key="", value=raw)),
            serialize_state=lambda a, s: STATE.write_state(s).value,
            ledger=self.ledgers[0])
        self.t = ResidentStatePlane(
            log, TOPIC, counter.make_replay_spec(), config=tcfg, device="cpu",
            deserialize_event=port_event,
            serialize_state=lambda a, s: repr(s).encode(),
            ledger=self.ledgers[1])
        self.jv = JViews(jcounter.make_replay_spec(), config=jcfg,
                         metrics=engine_metrics(self.regs[0]),
                         ledger=self.ledgers[0])
        self.tv = MaterializedViews(counter.make_replay_spec(), config=tcfg,
                                    metrics=engine_metrics(self.regs[1]),
                                    ledger=self.ledgers[1], device="cpu")
        self.j.attach_views(self.jv)
        self.t.attach_views(self.tv)
        self.subs: list = []

    def register(self, vdef: JViewDef) -> None:
        self.j.register_view(vdef)
        self.t.register_view(port_vdef(vdef))

    async def seed(self):
        for plane in (self.j, self.t):
            plane._ensure_device_state()
            plane.seed_from_log()
        await self.check()

    async def refresh(self):
        got = await self.t._refresh_once()
        assert got == await self.j._refresh_once()
        await self.check()
        return got

    def subscribe(self, name, from_version=None):
        pair = (self.jv.subscribe(name, from_version),
                self.tv.subscribe(name, from_version))
        self.subs.append(pair)
        return pair

    async def check(self):
        # changefeed entries published from an executor thread land on the
        # loop with call_soon_threadsafe: let them arrive before comparing
        for _ in range(3):
            await asyncio.sleep(0)
        assert self.tv.names == self.jv.names
        for name in self.jv.names:
            want, got = self.jv.snapshot(name), self.tv.snapshot(name)
            wcols, gcols = want.pop("columns", {}), got.pop("columns", {})
            assert got == want, name
            assert list(gcols) == list(wcols), name
            for k, w in wcols.items():
                w = np.asarray(w)
                assert gcols[k].dtype == w.dtype, (name, k)
                assert gcols[k].tobytes() == w.tobytes(), (name, k)
        strip = lambda rows: [{k: v for k, v in r.items() if k != "query"}  # noqa: E731
                              for r in rows]
        assert strip(self.tv.summary()) == strip(self.jv.summary())
        # "snapshots" counts snapshot() calls, which the tests make unevenly
        fold = lambda st: {k: v for k, v in st.items() if k != "snapshots"}  # noqa: E731
        assert fold(self.tv.stats) == fold(self.jv.stats)
        for jsub, tsub in self.subs:
            assert tsub.closed == jsub.closed
            assert drain(tsub) == drain(jsub)
        jm, tm = (r.get_metrics() for r in self.regs)
        for k in VIEW_METRICS:
            assert tm.get(k) == jm.get(k), k
        assert (self.ledgers[1].totals["view_rounds"]
                == self.ledgers[0].totals["view_rounds"])


def drain(sub) -> list:
    out = []
    while not sub.queue.empty():
        out.append(sub.queue.get_nowait())
    return out


def port_scan_at(log, watermarks, query):
    """From-scratch port ``scan_chunks`` over every event the log holds below
    the watermarks, in sorted-key order."""
    logs = {}
    for p_str, wm in watermarks.items():
        for rec in log.read(TOPIC, int(p_str), 0):
            if rec.offset >= wm:
                break
            logs.setdefault(rec.key, []).append(port_event(rec.value))
    if not logs:
        return [], {}
    colev = encode_events_columnar(counter.make_replay_spec().registry,
                                   list(logs.values()))
    colev.aggregate_ids = list(logs)
    res = QueryEngine(counter.make_replay_spec(), config=Config(overrides={
        "surge.query.chunk-events": 1024}), device="cpu").scan_chunks(
        [colev], query)
    order = sorted(range(res.num_aggregates), key=lambda j: res.aggregate_ids[j])
    return ([res.aggregate_ids[j] for j in order],
            {n: np.asarray(res.columns[n])[order] for n in res.columns})


def assert_port_golden(duo, name, query):
    snap = duo.tv.snapshot(name)
    assert "error" not in snap, snap
    keys, cols = port_scan_at(duo.log, snap["watermarks"], port_vdef(
        JViewDef(name=name, query=query)).query)
    assert snap["keys"] == keys
    assert set(snap["columns"]) == set(cols)
    for n in cols:
        assert snap["columns"][n].tobytes() == cols[n].tobytes(), (name, n)
    return snap


def _run(coro):
    return asyncio.run(coro)


def test_views_golden_across_evict_readmit_and_rebalance():
    async def scenario():
        log = make_log()
        gen = EventGen(seed=5)
        append_events(log, [e for a in gen.aggs for e in gen.burst(a, 3)])
        duo = ViewDuo(log, capacity=8)
        duo.register(JViewDef(name="totals", query=TOTALS_Q))
        duo.register(JViewDef(name="by-delta", query=GROUP_Q))
        await duo.seed()
        for rnd in range(4):
            append_events(log, gen.storm(rnd))
            assert await duo.refresh()
            if rnd == 1:
                for parts in ([0, 2, 3], [0, 1, 2, 3]):
                    duo.j.set_partitions(parts)
                    duo.t.set_partitions(parts)
                    await duo.check()
                assert await duo.refresh()  # partition 1 refolds from 0
        assert duo.t.stats["evictions"] == duo.j.stats["evictions"] > 0
        snap = assert_port_golden(duo, "totals", TOTALS_Q)
        assert snap["keys"] == sorted(gen.aggs)
        assert_port_golden(duo, "by-delta", GROUP_Q)
        assert duo.ledgers[1].totals["view_rounds"] > 0
        assert duo.regs[1].get_metrics()["surge.replay.views.delta-rows"] > 0

    _run(scenario())


def test_views_after_mid_round_failure():
    """A round failing on its second fold group re-anchors the polled
    partitions on both planes; the views drop those partials, publish a
    reset, and refold to the same bytes."""
    async def scenario():
        log = make_log()
        gen = EventGen(seed=11, naggs=24)
        append_events(log, [e for a in gen.aggs for e in gen.burst(a, 3)])
        duo = ViewDuo(log, capacity=8)
        duo.register(JViewDef(name="totals", query=TOTALS_Q))
        await duo.seed()
        duo.subscribe("totals")
        await duo.check()
        reals = {}
        for plane in (duo.j, duo.t):
            real = plane._fold_group
            reals[plane] = real
            calls = {"n": 0}

            async def dying(group, logs, parts, gens, real=real, calls=calls):
                calls["n"] += 1
                if calls["n"] == 2:
                    raise RuntimeError("injected mid-round fold failure")
                return await real(group, logs, parts, gens)

            plane._fold_group = dying
        append_events(log, [e for a in gen.aggs for e in gen.burst(a, 2)])
        for plane in (duo.t, duo.j):
            with pytest.raises(RuntimeError, match="injected"):
                await plane._refresh_once()
            plane._fold_group = reals[plane]
        await duo.check()
        while await duo.refresh():
            pass
        assert duo.t.lag_records() == 0
        assert_port_golden(duo, "totals", TOTALS_Q)

    _run(scenario())


def test_changefeed_resume_exact_missed_deltas():
    async def scenario():
        log = make_log()
        gen = EventGen(seed=21, naggs=16)
        append_events(log, [e for a in gen.aggs for e in gen.burst(a, 2)])
        duo = ViewDuo(log)
        duo.register(JViewDef(name="v", query=SIMPLE_Q))
        await duo.seed()
        jsub, tsub = duo.subscribe("v")
        for rnd in range(3):
            append_events(log, gen.storm(rnd, every=2))
            await duo.refresh()
        applied = duo.tv.snapshot("v")["version"]
        duo.jv.unsubscribe(jsub)
        duo.tv.unsubscribe(tsub)
        duo.subs.clear()
        for rnd in range(3, 6):
            append_events(log, gen.storm(rnd, every=2))
            await duo.refresh()
        jsub2, tsub2 = duo.subscribe("v", from_version=applied)
        missed = drain(tsub2)
        assert missed == drain(jsub2)
        assert missed and not any(e.get("reset") for e in missed)
        assert all(e["version"] > applied for e in missed)
        await duo.check()
        assert_port_golden(duo, "v", SIMPLE_Q)

    _run(scenario())


def test_changefeed_resume_beyond_ring_reconciles():
    async def scenario():
        log = make_log()
        gen = EventGen(seed=31, naggs=12)
        append_events(log, [e for a in gen.aggs for e in gen.burst(a, 2)])
        duo = ViewDuo(log, overrides={
            "surge.replay.views.changefeed-rounds": 2})
        duo.register(JViewDef(name="v", query=SIMPLE_Q))
        await duo.seed()
        for rnd in range(5):
            append_events(log, gen.storm(rnd, every=2))
            await duo.refresh()
        assert duo.tv.snapshot("v")["version"] > 3
        jsub, tsub = duo.subscribe("v", from_version=1)
        entries = drain(tsub)
        assert entries == drain(jsub)
        assert len(entries) == 1 and entries[0]["reset"] is True
        state = {}
        apply_entry(state, entries[0])
        assert state == {r["key"]: r for r in duo.tv.snapshot("v")["rows"]}
        await duo.check()

    _run(scenario())


def test_changefeed_resume_after_kill_failover():
    async def scenario():
        log = make_log()
        gen = EventGen(seed=41, naggs=12)
        append_events(log, [e for a in gen.aggs for e in gen.burst(a, 2)])
        duo = ViewDuo(log)
        duo.register(JViewDef(name="v", query=SIMPLE_Q))
        await duo.seed()
        for rnd in range(4):
            append_events(log, gen.storm(rnd, every=2))
            await duo.refresh()
        old_version = duo.tv.snapshot("v")["version"]
        # the replacement owner seeds the same log from 0
        duo2 = ViewDuo(log)
        duo2.register(JViewDef(name="v", query=SIMPLE_Q))
        await duo2.seed()
        assert duo2.tv.snapshot("v")["version"] < old_version
        jsub, tsub = duo2.subscribe("v", from_version=old_version)
        entries = drain(tsub)
        assert entries == drain(jsub)
        assert entries[0]["reset"] is True
        append_events(log, gen.storm(9, every=2))
        await duo2.refresh()
        assert_port_golden(duo2, "v", SIMPLE_Q)

    _run(scenario())


def test_register_while_running_backfills_committed_prefix():
    async def scenario():
        log = make_log()
        gen = EventGen(seed=51, naggs=16)
        append_events(log, [e for a in gen.aggs for e in gen.burst(a, 3)])
        duo = ViewDuo(log)
        await duo.seed()
        append_events(log, gen.storm(0, every=2))
        await duo.refresh()
        duo.register(JViewDef(name="late", query=TOTALS_Q))
        assert duo.tv.has_pending and duo.jv.has_pending
        await duo.check()
        append_events(log, gen.storm(1, every=2))
        await duo.refresh()  # backfill between rounds, then the round
        assert not duo.tv.has_pending
        assert duo.tv.summary()[0]["active"]
        assert_port_golden(duo, "late", TOTALS_Q)

    _run(scenario())


def test_top_k_serving_is_exact():
    async def scenario():
        log = make_log()
        gen = EventGen(seed=61, naggs=20)
        append_events(log, [e for a in gen.aggs for e in gen.burst(a, 4)])
        duo = ViewDuo(log)
        duo.register(JViewDef(name="top", query=SIMPLE_Q, top_k=5,
                              top_k_by="sum_increment_by"))
        await duo.seed()
        append_events(log, gen.storm(0, every=2))
        await duo.refresh()
        snap = duo.tv.snapshot("top")
        assert len(snap["keys"]) == 5
        keys, cols = port_scan_at(log, snap["watermarks"],
                                  port_vdef(JViewDef(name="q", query=SIMPLE_Q)).query)
        want_keys, want_cols = select_top_k(keys, cols, 5, "sum_increment_by")
        assert snap["keys"] == want_keys
        for n in want_cols:
            assert snap["columns"][n].tobytes() == want_cols[n].tobytes(), n

    _run(scenario())


def test_group_cap_degrades_one_view_not_the_plane():
    async def scenario():
        log = make_log()
        gen = EventGen(seed=71, naggs=30)
        append_events(log, [e for a in gen.aggs for e in gen.burst(a, 2)])
        duo = ViewDuo(log, overrides={"surge.replay.views.max-groups": 4})
        duo.register(JViewDef(name="wide", query=TOTALS_Q))
        duo.register(JViewDef(name="narrow", query=GROUP_Q))
        await duo.seed()
        append_events(log, gen.storm(0))
        await duo.refresh()
        assert "group cap exceeded" in duo.tv.snapshot("wide")["error"]
        assert_port_golden(duo, "narrow", GROUP_Q)
        assert duo.t.lag_records() == 0

    _run(scenario())


def test_registration_validation_and_unregister():
    async def scenario():
        log = make_log()
        duo = ViewDuo(log)
        q = port_vdef(JViewDef(name="v", query=SIMPLE_Q)).query
        for bad in ({"aggregates": [{"op": "sum", "column": "no_such_column"}]},
                    {"aggregates": [{"op": "count"}],
                     "event_types": ["NoSuchEvent"]}):
            with pytest.raises(ValueError):
                duo.t.register_view(ViewDef.from_json({"name": "bad",
                                                       "query": bad}))
        with pytest.raises(ValueError):
            ViewDef(name="", query=q)
        with pytest.raises(ValueError):
            ViewDef(name="v", query=q, top_k=0)
        with pytest.raises(ValueError):
            ViewDef(name="v", query=q, top_k=3, top_k_by="nope")
        vd = JViewDef(name="v", query=SIMPLE_Q, top_k=3)
        assert port_vdef(vd).as_json() == vd.as_json()
        assert port_vdef(vd).rank_by == vd.rank_by == "sum_increment_by"
        duo.register(vd)
        with pytest.raises(ValueError):
            duo.t.register_view(port_vdef(vd))
        await duo.seed()
        jsub, tsub = duo.subscribe("v")
        assert duo.tv.unregister("v") and not duo.tv.unregister("v")
        assert duo.jv.unregister("v")
        await asyncio.sleep(0)  # the closing entries land on the loop
        entries = drain(tsub)
        assert entries == drain(jsub)
        assert entries[-1].get("closed") == "unregistered"
        duo.subs.clear()
        with pytest.raises(KeyError):
            duo.tv.snapshot("v")
        with pytest.raises(KeyError):
            duo.tv.subscribe("v")
        with pytest.raises(RuntimeError):
            ResidentStatePlane(log, TOPIC, counter.make_replay_spec(),
                               device="cpu", deserialize_event=port_event,
                               serialize_state=lambda a, s: b"").register_view(vd)

    _run(scenario())
