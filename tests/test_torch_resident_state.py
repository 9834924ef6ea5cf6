"""The port's resident state plane (surge_tpu_torch.replay.resident_state on the
CPU) against the reference plane (surge_tpu.replay.resident_state), driven in
lockstep over ONE log: the same seed, then one ``_refresh_once`` on each after
every append. After every step the two must agree exactly — tracked states,
the ``audit_pull`` (row, ordinal) pairs as raw bytes, the resident set, the
evictions, each round's dispatch buckets and the program signatures — in
four arms: the port's plain K2 against the reference's bucketed Pallas arm,
the plain scan on bucketed windows, the seed through the assoc tree fold (its
windows take the plain arm, as the reference's do), and the plain K1 on dense
windows.
Scenarios follow tests/test_resident_state.py and
tests/test_ragged_refresh.py."""

import asyncio
import dataclasses
import threading

import numpy as np
import pytest
import torch

from surge_tpu.config import default_config
from surge_tpu.models import counter as jcounter
from surge_tpu.replay.resident_state import ResidentStatePlane as JPlane
from surge_tpu.serialization import SerializedMessage
from surge_tpu_torch.config import Config
from surge_tpu_torch.models import counter
from surge_tpu_torch.replay import fold_kernels
from surge_tpu_torch.replay.resident_state import ResidentStatePlane
from tests.test_resident_state import (
    EVT,
    NPART,
    STATE,
    TOPIC,
    Expected,
    append_events,
    make_log,
    part_of,
)
from tests.test_torch_isolation import leave_the_worker_as_found  # noqa: F401

#: arm -> (port overrides, reference overrides)
ARMS = {
    "pallas-bucketed": ({"surge.replay.tile-backend": "pallas"},
                        {"surge.replay.tile-backend": "pallas",
                         "surge.replay.dispatch": "select"}),
    "xla-bucketed": ({"surge.replay.tile-backend": "xla"}, {}),
    "assoc-bucketed": ({"surge.replay.tile-backend": "assoc"},
                       {"surge.replay.tile-backend": "assoc"}),
    "pallas-dense": ({"surge.replay.tile-backend": "pallas",
                      "surge.replay.resident.refresh-dispatch": "dense"},
                     {"surge.replay.resident.refresh-dispatch": "dense"}),
}


def port_event(raw):
    """A logged event as the port's counter event; an event type the port's
    model lacks stays the reference's object, which the port's schema
    refuses (the plane then poisons its aggregate)."""
    ev = EVT.read_event(SerializedMessage(key="", value=raw))
    cls = getattr(counter, type(ev).__name__, None)
    if cls is None or not dataclasses.is_dataclass(cls):
        return ev
    return cls(**{f.name: getattr(ev, f.name) for f in dataclasses.fields(cls)})


class RoundLedger:
    """Duck-typed ledger: keeps every round's buckets and every eviction."""

    def __init__(self):
        self.rounds, self.evicts = [], []

    def record_round(self, **kw):
        self.rounds.append(kw)

    def record_evict(self, count, **kw):
        self.evicts.append(count)

    def record_gather(self, **kw):
        pass


class Duo:
    """The reference plane and the port's plane over one log."""

    def __init__(self, log, arm, *, capacity=8, max_lag=4096, overrides=None):
        base = {"surge.replay.resident.capacity": capacity,
                "surge.replay.resident.max-lag-records": max_lag,
                "surge.replay.resident.refresh-interval-ms": 10,
                "surge.replay.batch-size": 16,
                "surge.replay.time-chunk": 8, **(overrides or {})}
        tover, jover = ARMS[arm]
        self.jled, self.tled = RoundLedger(), RoundLedger()
        self.j = JPlane(
            log, TOPIC, jcounter.make_replay_spec(),
            config=default_config().with_overrides({**base, **jover}),
            deserialize_event=lambda raw: EVT.read_event(
                SerializedMessage(key="", value=raw)),
            serialize_state=lambda a, s: STATE.write_state(s).value,
            ledger=self.jled)
        self.t = ResidentStatePlane(
            log, TOPIC, counter.make_replay_spec(),
            config=Config(overrides={**base, **tover}), device="cpu",
            deserialize_event=port_event,
            serialize_state=lambda a, s: repr(s).encode(), ledger=self.tled)

    def seed(self):
        for plane in (self.j, self.t):
            plane._ensure_device_state()
            plane.seed_from_log()
        self.check()

    async def refresh(self):
        got = await self.t._refresh_once()
        assert got == await self.j._refresh_once()
        self.check()
        return got

    def both(self, fn):
        fn(self.j)
        fn(self.t)

    def check(self):
        j, t = self.j, self.t
        states = lambda p: {a: (s.count, s.version)  # noqa: E731
                            for a, s in p.snapshot_states().items()}
        assert states(t) == states(j)
        assert t.resident_ids() == j.resident_ids()
        jpairs, tpairs = (p.audit_pull(p.resident_ids()) for p in (j, t))
        assert sorted(tpairs) == sorted(jpairs)
        for agg, (jrow, jord) in jpairs.items():
            trow, tord = tpairs[agg]
            assert tord == jord, agg
            for k, v in jrow.items():
                assert trow[k].dtype == np.asarray(v).dtype, (agg, k)
                assert trow[k].tobytes() == np.asarray(v).tobytes(), (agg, k)
        assert t.stats["evictions"] == j.stats["evictions"]
        assert self.tled.evicts == self.jled.evicts
        assert t._watermarks == j._watermarks
        assert [r["buckets"] for r in self.tled.rounds] == \
            [r["buckets"] for r in self.jled.rounds]
        assert t._signatures == j._signatures


def _run(coro):
    return asyncio.run(coro)


# -- lockstep scenarios, in every arm ---------------------------------------------------


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_seed_overflow_spills_and_rounds_evict_and_readmit(arm):
    """Seed past capacity (the longest logs stay resident, the rest spill),
    then rounds that rotate the touched set so rows evict and re-admit at
    their exact fold points."""
    async def scenario():
        log = make_log()
        exp = Expected()
        aggs = [f"agg-{i}" for i in range(24)]
        evs = []
        for i, agg in enumerate(aggs):
            evs.extend(exp.events(agg, 1 + i % 9, decrement_every=4))
        append_events(log, evs)
        duo = Duo(log, arm)
        duo.seed()
        assert duo.t.occupancy() == 8 and len(duo.t._spill) == 16
        for rnd in range(4):
            evs = []
            for i, agg in enumerate(aggs):
                if (i + rnd) % 3 == 0:
                    evs.extend(exp.events(agg, 2 + rnd, decrement_every=3))
            append_events(log, evs)
            assert await duo.refresh()
        assert duo.t.stats["evictions"] > 0
        assert {a: (s.count, s.version) for a, s in
                duo.t.snapshot_states().items()} == {
            a: (s.count, s.version) for a, s in exp.states.items()}

    _run(scenario())


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_revoke_and_regrant_refold_without_double_folding(arm):
    async def scenario():
        log = make_log()
        exp = Expected()
        aggs = [f"agg-{i}" for i in range(12)]
        evs = []
        for agg in aggs:
            evs.extend(exp.events(agg, 4, decrement_every=3))
        append_events(log, evs)
        duo = Duo(log, arm, capacity=16)
        duo.seed()
        duo.both(lambda p: p.set_partitions([0, 2, 3]))
        duo.check()
        assert all(part_of(a) != 1 for a in duo.t.resident_ids())
        evs = []
        for agg in aggs:
            evs.extend(exp.events(agg, 2))
        append_events(log, evs)
        assert await duo.refresh()
        duo.both(lambda p: p.set_partitions([0, 1, 2, 3]))
        assert await duo.refresh()  # partition 1 refolds from offset 0
        assert {a: (s.count, s.version) for a, s in
                duo.t.snapshot_states().items()} == {
            a: (s.count, s.version) for a, s in exp.states.items()}

    _run(scenario())


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_lane_longer_than_three_windows(arm):
    """A lane of 30 events at time-chunk 8 folds through four chained
    windows in one round (shifted starts, clipped counts, ordinals re-read
    after each window's add), beside short lanes."""
    async def scenario():
        log = make_log()
        exp = Expected()
        append_events(log, [e for i in range(6)
                            for e in exp.events(f"agg-{i}", 2)])
        duo = Duo(log, arm, capacity=8)
        duo.seed()
        evs = exp.events("agg-0", 30, decrement_every=7)
        for i in range(1, 9):
            evs.extend(exp.events(f"agg-{i}", 1 + i % 3))
        append_events(log, evs)
        assert await duo.refresh()
        windows = max(b["windows"] for b in duo.tled.rounds[-1]["buckets"])
        assert windows > 3
        assert duo.t.snapshot_states()["agg-0"].count == \
            exp.states["agg-0"].count

    _run(scenario())


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_poisoned_aggregate_degrades_alone(arm):
    async def scenario():
        from surge_tpu.log import LogRecord

        log = make_log()
        exp = Expected()
        append_events(log, exp.events("agg-0", 3) + exp.events("agg-1", 3))
        duo = Duo(log, arm)
        duo.seed()
        prod = log.transactional_producer("poison")
        prod.begin()
        msg = EVT.write_event(jcounter.ExceptionThrowingEvent("agg-0", 4, "boom"))
        prod.send(LogRecord(topic=TOPIC, partition=part_of("agg-0"),
                            key=msg.key, value=msg.value))
        prod.commit()
        append_events(log, exp.events("agg-1", 2))
        assert await duo.refresh()
        assert duo.t._poisoned == duo.j._poisoned == {"agg-0": part_of("agg-0")}
        duo.both(lambda p: setattr(p, "_stopped", False))
        hit, _ = await duo.t.read_state("agg-0")
        assert not hit
        assert duo.t.fallback_causes == {"unschema-poison": 1}
        hit, st = await duo.t.read_state("agg-1")
        assert hit and (st.count, st.version) == (exp.states["agg-1"].count,
                                                  exp.states["agg-1"].version)

    _run(scenario())


# -- the read path and the watermark handoff --------------------------------------------


def test_prime_fast_forwards_and_never_refolds():
    async def scenario():
        log = make_log()
        exp = Expected()
        aggs = [f"agg-{i}" for i in range(6)]
        append_events(log, [e for a in aggs for e in exp.events(a, 4)])
        duo = Duo(log, "pallas-bucketed")
        duo.seed()
        anchored = dict(duo.t._watermarks)
        duo.both(lambda p: p.prime({p_: 0 for p_ in range(NPART)}))
        assert duo.t._watermarks == anchored  # backward prime is a no-op
        append_events(log, [e for a in aggs for e in exp.events(a, 3)])
        assert await duo.refresh()
        before = duo.t.snapshot_states()
        ends = {p: log.end_offset(TOPIC, p) + 1 for p in range(NPART)}
        duo.both(lambda p: p.prime(ends))
        append_events(log, [e for a in aggs[:2] for e in exp.events(a, 1)])
        assert not await duo.refresh()  # primed over: nothing folds
        assert duo.t.snapshot_states() == before

    _run(scenario())


def test_require_current_and_the_lag_fallback():
    async def scenario():
        log = make_log()
        exp = Expected()
        append_events(log, exp.events("agg-0", 4))
        duo = Duo(log, "pallas-bucketed", max_lag=4)
        duo.seed()
        results = []
        for plane in (duo.j, duo.t):
            hit, st = await plane.read_state("agg-0")
            results.append((hit, (st.count, st.version)))
        append_events(log, exp.events("agg-0", 3))
        for plane in (duo.j, duo.t):
            results.append((await plane.read_state("agg-0"))[0])
            results.append((await plane.read_state(
                "agg-0", require_current=True))[0])
        append_events(log, exp.events("agg-0", 3))
        for plane in (duo.j, duo.t):
            results.append((await plane.read_state("agg-0"))[0])
        assert results == [(True, (4, 4)), (True, (4, 4)), True, False, True,
                           False, False, False]
        assert duo.t.stats["fallbacks"] == duo.j.stats["fallbacks"] == 2
        assert duo.t.fallback_causes == duo.j.fallback_causes
        await duo.t.stop()
        assert (await duo.t.read_state("agg-0"))[0] is False
        assert await duo.t.read_many(["agg-0"]) == {}

    _run(scenario())


def test_concurrent_reads_coalesce_into_batched_gathers():
    async def scenario():
        log = make_log()
        exp = Expected()
        aggs = [f"agg-{i}" for i in range(32)]
        append_events(log, [e for a in aggs for e in exp.events(a, 3)])
        duo = Duo(log, "pallas-bucketed", capacity=24)
        duo.seed()
        plane = duo.t
        results = await asyncio.gather(
            *(plane.read_state(a) for a in aggs for _ in range(4)))
        assert all(hit for hit, _ in results)
        assert {st.aggregate_id for _, st in results} == set(aggs)
        # 128 reads of resident rows ride far fewer gathers (spilled rows
        # are served from the host spill without one)
        assert plane.stats["gathered_rows"] == 4 * 24
        assert plane.stats["gathers"] < 96
        got = await plane.read_many(aggs + ["ghost-1"])
        assert {a: (s.count, s.version) for a, s in got.items()} == {
            a: (s.count, s.version) for a, s in exp.states.items()}
        assert plane.stats["fallbacks"] == 1  # the ghost

    _run(scenario())


# -- the live loop: no torn row under concurrent reads ----------------------------------


@pytest.mark.parametrize("donate", [True, False], ids=["in-place", "copying"])
def test_live_refresh_loop_never_serves_a_torn_row(donate):
    """start()/stop() with the refresh loop folding while a reader reads:
    all-increment traffic keeps count == version in every row a fold could
    be half way through, so a torn row or a row folded past its ordinal
    shows; then every aggregate reads back exactly."""
    async def scenario():
        log = make_log()
        exp = Expected()
        aggs = [f"agg-{i}" for i in range(40)]
        append_events(log, [e for a in aggs for e in exp.events(a, 2)])
        plane = ResidentStatePlane(
            log, TOPIC, counter.make_replay_spec(), device="cpu",
            config=Config(overrides={
                "surge.replay.resident.capacity": 24,
                "surge.replay.resident.refresh-interval-ms": 5,
                "surge.replay.time-chunk": 8,
                "surge.replay.donate-refresh": donate}),
            deserialize_event=port_event,
            serialize_state=lambda a, s: repr(s).encode(),
            derived_cols={"sequence_number": "ordinal"})
        await plane.start()
        stop = asyncio.Event()
        reads = []

        async def reader():
            rng = np.random.default_rng(1)
            while not stop.is_set():
                ids = [aggs[i] for i in rng.integers(0, len(aggs), 16)]
                for agg, st in (await plane.read_many(ids)).items():
                    assert st.count == st.version, (agg, st)
                reads.append(1)
                await asyncio.sleep(0)

        task = asyncio.ensure_future(reader())
        try:
            for rnd in range(6):
                append_events(log, [e for i, a in enumerate(aggs)
                                    if (i + rnd) % 2 == 0
                                    for e in exp.events(a, 1 + (i + rnd) % 11)])
                for _ in range(2000):
                    if plane.lag_records() == 0:
                        break
                    await asyncio.sleep(0.005)
                assert plane.lag_records() == 0
        finally:
            stop.set()
            await asyncio.wait_for(task, 30)
        assert reads and plane.stats["evictions"] > 0
        got = await plane.read_many(aggs)
        assert {a: (s.count, s.version) for a, s in got.items()} == {
            a: (s.count, s.version) for a, s in exp.states.items()}
        assert plane.stats["fallbacks"] == 0
        await plane.stop()

    _run(scenario())


def test_the_loop_never_runs_a_fetch_of_a_card_plane():
    """On the card a fetch waits for every window enqueued before it, so both
    the eviction pull and the gather lane run it in the executor. A CPU plane
    set to fetch as on the card must never fetch on the loop's thread while
    rounds evict and reads are served."""
    async def scenario():
        log = make_log()
        exp = Expected()
        aggs = [f"agg-{i}" for i in range(40)]
        append_events(log, [e for a in aggs for e in exp.events(a, 2)])
        plane = ResidentStatePlane(
            log, TOPIC, counter.make_replay_spec(), device="cpu",
            config=Config(overrides={
                "surge.replay.resident.capacity": 24,
                "surge.replay.resident.refresh-interval-ms": 5,
                "surge.replay.time-chunk": 8}),
            deserialize_event=port_event,
            serialize_state=lambda a, s: repr(s).encode())
        await plane.start()
        plane._fetch_off_loop = True
        fetch, threads = plane._fetch, []

        def recording_fetch(mat, o):
            threads.append(threading.current_thread())
            return fetch(mat, o)

        plane._fetch = recording_fetch
        ev0 = plane.stats["evictions"]
        for rnd in range(4):
            append_events(log, [e for i, a in enumerate(aggs)
                                if (i + rnd) % 2 == 0
                                for e in exp.events(a, 1 + i % 5)])
            for _ in range(2000):
                if plane.lag_records() == 0:
                    break
                await asyncio.sleep(0.005)
            got = await plane.read_many(aggs)
            assert {a: (s.count, s.version) for a, s in got.items()} == {
                a: (s.count, s.version) for a, s in exp.states.items()}
        await plane.stop()
        assert plane.stats["evictions"] > ev0 and threads
        assert threading.current_thread() not in threads

    _run(scenario())


# -- construction and backend resolution ------------------------------------------------


def test_plane_without_a_card_raises(monkeypatch):
    log = make_log()
    kw = dict(deserialize_event=port_event,
              serialize_state=lambda a, s: b"")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResidentStatePlane(log, TOPIC, counter.make_replay_spec(), **kw)
    plane = ResidentStatePlane(log, TOPIC, counter.make_replay_spec(),
                               device="cpu", **kw)
    assert plane.device.type == plane.engine.device.type == "cpu"
    # auto resolves to the plain scan on the CPU: bucketed plans fold as
    # windows, as the reference's default arm does
    assert plane._backend == "xla" and not plane._ragged
    for name in ("mesh", "profiler", "tracer", "faults"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ResidentStatePlane(log, TOPIC, counter.make_replay_spec(),
                               device="cpu", **{name: object()}, **kw)


def test_plain_window_fold_under_the_kernel_backend_equals_the_plain_scan():
    """A window plan under ``pallas`` folds through K1's dense window, whose
    lanes stop at their counts; its padded slots decode to the pad code
    either way, so it equals the plain decode + scan of the ``xla`` arm on
    the same windows."""
    async def scenario():
        log = make_log()
        exp = Expected()
        append_events(log, [e for i in range(10)
                            for e in exp.events(f"agg-{i}", 1 + i)])
        planes = {}
        for backend in ("pallas", "xla"):
            planes[backend] = ResidentStatePlane(
                log, TOPIC, counter.make_replay_spec(), device="cpu",
                config=Config(overrides={
                    "surge.replay.tile-backend": backend,
                    "surge.replay.resident.refresh-dispatch": "dense",
                    "surge.replay.time-chunk": 8}),
                deserialize_event=port_event,
                serialize_state=lambda a, s: b"")
            planes[backend]._ensure_device_state()
            planes[backend]._seeded = True
            planes[backend]._watermarks = {p: 0 for p in range(NPART)}
        calls = []
        real = fold_kernels.dense_window

        def counting(*a, **k):
            calls.append(1)
            return real(*a, **k)

        fold_kernels.dense_window = counting
        try:
            for plane in planes.values():
                assert await plane._refresh_once()
        finally:
            fold_kernels.dense_window = real
        assert calls  # the pallas arm went through the K1 window wrapper
        a, b = (p.audit_pull(p.resident_ids()) for p in planes.values())
        assert a.keys() == b.keys()
        for agg in a:
            assert a[agg][1] == b[agg][1]
            for k in a[agg][0]:
                assert a[agg][0][k].tobytes() == b[agg][0][k].tobytes()

    _run(scenario())


def test_kernel_backend_on_the_card_needs_a_kernel_step(monkeypatch):
    """auto on CUDA is the kernels; a spec with no kernel step raises there
    instead of folding with the plain scan."""
    spec = counter.make_replay_spec()
    spec.kernel_step = None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="kernel_step"):
        ResidentStatePlane(make_log(), TOPIC, spec,
                           deserialize_event=port_event,
                           serialize_state=lambda a, s: b"")


def test_gathers_never_read_the_scratch_row():
    plane = ResidentStatePlane(make_log(), TOPIC, counter.make_replay_spec(),
                               device="cpu", deserialize_event=port_event,
                               serialize_state=lambda a, s: b"",
                               config=Config(overrides={
                                   "surge.replay.resident.capacity": 8}))
    plane._ensure_device_state()
    with pytest.raises(RuntimeError, match="scratch row"):
        plane._pull_positions(None, np.asarray([0, 8], dtype=np.int32))


def test_window_enqueue_and_gathers_share_one_lock():
    """A gather cannot run while a window holds the plane lock (the torn-row
    guard on the card, where both only enqueue)."""
    plane = ResidentStatePlane(make_log(), TOPIC, counter.make_replay_spec(),
                               device="cpu", deserialize_event=port_event,
                               serialize_state=lambda a, s: b"")
    plane._ensure_device_state()
    done = threading.Event()
    with plane._dev_lock:
        t = threading.Thread(target=lambda: (plane._pull_positions(
            None, np.asarray([0], dtype=np.int32)), done.set()))
        t.start()
        assert not done.wait(0.2)
    t.join(10)
    assert done.is_set() and not t.is_alive()


def test_decode_wide_follows_device_dtypes_and_words():
    """The wide read wire is keyed on the DEVICE dtypes: a 64-bit schema
    column lives on the device as its 32-bit kin, decodes one u32 word and
    widens back to the schema dtype (the reference's x64-off contract); a
    genuine 64-bit device column would occupy two u32 word-rows."""
    from types import SimpleNamespace

    from surge_tpu_torch.replay.resident_state import _device_dtype

    assert _device_dtype(np.int64) == np.int32
    assert _device_dtype(np.float64) == np.float32
    assert _device_dtype(np.bool_) == np.bool_
    plane = object.__new__(ResidentStatePlane)
    plane._fields = [SimpleNamespace(name="a"), SimpleNamespace(name="b"),
                     SimpleNamespace(name="c")]
    plane._dtypes = {"a": np.dtype(np.int64), "b": np.dtype(np.int64),
                     "c": np.dtype(np.bool_)}
    plane._dev_dts = {"a": _device_dtype(np.int64), "b": np.dtype(np.int64),
                      "c": np.dtype(np.bool_)}
    plane._wide_words = [max(plane._dev_dts[f.name].itemsize // 4, 1)
                         for f in plane._fields]
    assert plane._wide_words == [1, 2, 1]
    a = np.array([1, -2, 2**31 - 1], dtype=np.int32)
    b = np.array([2**40 + 7, -(2**35), 11], dtype=np.int64)
    c = np.array([True, False, True])
    bw = b.view(np.uint32).reshape(3, 2)
    rows = [a.view(np.uint32), bw[:, 0], bw[:, 1], c.astype(np.uint32)]
    mat = np.zeros((len(rows), 8), dtype=np.uint32)
    for i, r in enumerate(rows):
        mat[i, :3] = r
    out = plane._decode_wide(mat, 3)
    assert out["a"].dtype == np.int64 and (out["a"] == a).all()
    assert out["b"].dtype == np.int64 and (out["b"] == b).all()
    assert out["c"].dtype == np.bool_ and (out["c"] == c).all()


def test_host_rows_seed_and_read_back_past_sixteen_bits():
    """Host state columns admitted through the seed scatter (resident up to
    capacity, the rest spilled) read back exactly, values past the 16-bit
    range included: the port pulls wide, with no narrow guess to refetch."""
    async def scenario():
        plane = ResidentStatePlane(
            make_log(), TOPIC, counter.make_replay_spec(), device="cpu",
            config=Config(overrides={"surge.replay.resident.capacity": 8}),
            deserialize_event=port_event, serialize_state=lambda a, s: b"")
        plane._ensure_device_state()
        ids = [f"agg-{i}" for i in range(10)]
        counts = np.array([70_000, -40_000, 7, 2**31 - 1, -(2**31), 0, 1, 2,
                           3, 65_536], dtype=np.int32)
        states = {"count": counts, "version": np.arange(10, dtype=np.int32)}
        plane._seed_from_host_rows(ids, states, np.arange(1, 11, dtype=np.int32),
                                   {a: 0 for a in ids})
        plane._watermarks = {p: 0 for p in range(NPART)}
        plane._seeded = True
        assert plane.occupancy() == 8 and len(plane._spill) == 2
        got = await plane.read_many(ids)
        assert [(got[a].count, got[a].version) for a in ids] == [
            (int(c), v) for v, c in enumerate(counts)]
        pairs = plane.audit_pull(ids)
        assert sorted(o for _, o in pairs.values()) == list(range(1, 9))

    _run(scenario())


@pytest.mark.parametrize("arm", ["pallas-bucketed", "xla-bucketed"])
def test_shadow_replay_rows_match_the_reference(arm):
    """The auditor's shadow replay: per-aggregate event lists refolded from
    scratch through the seed's fold, pulled to the host, in input order."""
    log = make_log()
    exp = Expected()
    logs = [exp.events(f"agg-{i}", 1 + (i * 5) % 13, decrement_every=3)
            for i in range(20)]
    duo = Duo(log, arm)
    duo.seed()
    want = duo.j.shadow_replay_rows(logs)
    got = duo.t.shadow_replay_rows(
        [[port_event(EVT.write_event(e).value) for e in lg] for lg in logs])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k
    assert got["count"].tolist() == [exp.states[f"agg-{i}"].count
                                     for i in range(20)]
