"""The port's profiler, tracer and fault hooks against the reference's, on the
CPU: the same replay or the same plane rounds go through both packages, each
with its own hook object, and the hooks must see the same things — the
profiler's stage counts and summary keys (times are not compared), the
``resident.gather`` spans' names and attribute keys, and the reference's
``FaultPlane`` corrupting the same aggregate to the same bytes and passing
the same number of ``resident.refresh.dispatch`` points. Also the profiler's
``if_enabled`` gate and its ``torch.profiler.record_function`` ranges."""

import asyncio

import numpy as np
import pytest

from surge_tpu.config import Config as JConfig
from surge_tpu.config import default_config
from surge_tpu.metrics import Metrics, RecordingLevel, engine_metrics
from surge_tpu.models import counter as jcounter
from surge_tpu.replay.corpus import synth_counter_corpus as jsynth
from surge_tpu.replay.engine import ReplayEngine as JReplayEngine
from surge_tpu.replay.profiler import ReplayProfiler as JProfiler
from surge_tpu.replay.resident_state import ResidentStatePlane as JPlane
from surge_tpu.serialization import SerializedMessage
from surge_tpu.testing.faults import NAMED_PLANS, FaultPlane, FaultRule
from surge_tpu.tracing import InMemoryTracer
from surge_tpu_torch.config import Config
from surge_tpu_torch.models import counter
from surge_tpu_torch.replay.corpus import synth_counter_corpus
from surge_tpu_torch.replay.engine import ReplayEngine
from surge_tpu_torch.replay.profiler import ReplayProfiler
from surge_tpu_torch.replay.resident_state import ResidentStatePlane
from tests.test_resident_state import (EVT, STATE, TOPIC, Expected,
                                       append_events, make_log)
from tests.test_torch_isolation import leave_the_worker_as_found  # noqa: F401
from tests.test_torch_resident_state import port_event

ENGINE_CFG = {"surge.replay.batch-size": 64, "surge.replay.time-chunk": 8}


def engines(jprof, tprof):
    return (JReplayEngine(jcounter.make_replay_spec(), config=JConfig(ENGINE_CFG),
                          profiler=jprof),
            ReplayEngine(counter.make_replay_spec(), config=Config(overrides=ENGINE_CFG),
                         device="cpu", profiler=tprof))


def replay_both(path, jeng, teng):
    jc, tc = jsynth(100, 900, seed=3), synth_counter_corpus(100, 900, seed=3)
    if path == "resident":
        for _ in range(2):
            jr = jeng.replay_resident(jeng.prepare_resident(jc.events))
            tr = teng.replay_resident(teng.prepare_resident(tc.events))
    elif path == "columnar":
        jr, tr = jeng.replay_columnar(jc.events), teng.replay_columnar(tc.events)
    else:
        wire_j, wire_t = jeng.pack_resident(jc.events), teng.pack_resident(tc.events)
        jr = jeng.replay_resident_streamed(wire_j, segments=3)
        tr = teng.replay_resident_streamed(wire_t, segments=3)
    for k in jr.states:
        assert tr.states[k].tobytes() == np.asarray(jr.states[k]).tobytes()


@pytest.mark.parametrize("path", ["resident", "columnar", "streamed"])
def test_profiler_stages_match_reference_replay(path):
    jprof, tprof = JProfiler.counters(), ReplayProfiler.counters()
    replay_both(path, *engines(jprof, tprof))
    assert tprof.stage_n == jprof.stage_n
    assert tprof.windows == jprof.windows
    jsum, tsum = jprof.summary(), tprof.summary()
    assert list(tsum) == list(jsum)
    assert {k: v["count"] for k, v in tsum.items() if isinstance(v, dict)} == \
        {k: v["count"] for k, v in jsum.items() if isinstance(v, dict)}
    tprof.reset()
    assert not any(tprof.stage_n.values()) and tprof.windows == 0


def test_profiler_if_enabled_gate_and_timers():
    info, debug = Metrics(), Metrics(recording_level=RecordingLevel.DEBUG)
    assert ReplayProfiler.if_enabled(info) is None
    assert JProfiler.if_enabled(info) is None
    metrics = engine_metrics(debug)
    prof = ReplayProfiler.if_enabled(debug, metrics)
    assert isinstance(prof, ReplayProfiler)
    assert isinstance(ReplayProfiler.counters(), ReplayProfiler)
    with prof.stage("dispatch", width=8):
        pass
    prof.record("refresh", 0.002)
    prof.count_windows(3)
    assert prof.stage_n["dispatch"] == prof.stage_n["refresh"] == 1
    assert prof.windows == 3
    assert prof.stage_s["refresh"] == pytest.approx(0.002)


def test_record_function_ranges_in_a_cpu_trace():
    from torch.profiler import ProfilerActivity, profile

    prof = ReplayProfiler.counters()
    _, teng = engines(None, prof)
    corpus = synth_counter_corpus(100, 900, seed=3)
    resident = teng.prepare_resident(corpus.events)
    with profile(activities=[ProfilerActivity.CPU]) as trace:
        teng.replay_resident(resident)
        teng.replay_resident(resident)
    names = [e.name for e in trace.events()]
    for stage, n in (("compile", 1), ("dispatch", 1), ("fetch", 2)):
        assert names.count(f"surge.replay.{stage}") == n, stage
    # the ranges are optional: the same replay runs with annotation off
    quiet = ReplayProfiler.counters(annotate=False)
    _, teng2 = engines(None, quiet)
    with profile(activities=[ProfilerActivity.CPU]) as trace2:
        teng2.replay_resident(teng2.prepare_resident(corpus.events))
    assert not any(e.name.startswith("surge.replay.") for e in trace2.events())
    assert quiet.stage_n["compile"] == 1


# -- the planes --------------------------------------------------------------------------


class CountingFaults(FaultPlane):
    """The reference's fault plane, counting the dispatch points it is
    passed."""

    def __init__(self, rules):
        super().__init__(rules)
        self.points: list = []

    def point(self, site):
        self.points.append(site)
        return super().point(site)


def planes(log, *, capacity=8, **hooks):
    """The reference plane and the port's, seeded; ``hooks[name]`` is a
    factory, or a pair of them (the reference's, the port's), called once a
    plane."""
    pick = lambda i: {k: (f[i] if isinstance(f, tuple) else f)()  # noqa: E731
                      for k, f in hooks.items()}
    base = {"surge.replay.resident.capacity": capacity,
            "surge.replay.resident.max-lag-records": 4096,
            "surge.replay.batch-size": 16, "surge.replay.time-chunk": 8}
    j = JPlane(log, TOPIC, jcounter.make_replay_spec(),
               config=default_config().with_overrides(base),
               deserialize_event=lambda raw: EVT.read_event(
                   SerializedMessage(key="", value=raw)),
               serialize_state=lambda a, s: STATE.write_state(s).value,
               **pick(0))
    t = ResidentStatePlane(log, TOPIC, counter.make_replay_spec(),
                           config=Config(overrides=base), device="cpu",
                           deserialize_event=port_event,
                           serialize_state=lambda a, s: repr(s).encode(),
                           **pick(1))
    for p in (j, t):
        p._ensure_device_state()
        p.seed_from_log()
    return j, t


async def rounds(log, j, t, exp, aggs, n):
    for rnd in range(n):
        append_events(log, [e for i, a in enumerate(aggs) if (i + rnd) % 3 == 0
                            for e in exp.events(a, 2 + rnd % 3, decrement_every=3)])
        assert await t._refresh_once() == await j._refresh_once()


def test_plane_profiler_stages_match_reference():
    async def scenario():
        log = make_log()
        exp = Expected()
        aggs = [f"agg-{i}" for i in range(20)]
        append_events(log, [e for a in aggs for e in exp.events(a, 3)])
        j, t = planes(log, profiler=(JProfiler.counters, ReplayProfiler.counters))
        assert isinstance(t.profiler, ReplayProfiler)
        assert t.engine.profiler is t.profiler  # the seed's replay reports too
        await rounds(log, j, t, exp, aggs, 4)
        assert t.profiler.stage_n == j.profiler.stage_n
        assert t.profiler.stage_n["refresh"] == 4
        assert t.profiler.stage_n["compile"] >= 1
        assert t.profiler.windows == j.profiler.windows
        assert list(t.profiler.summary()) == list(j.profiler.summary())

    asyncio.run(scenario())


def test_gather_spans_match_reference():
    async def scenario():
        log = make_log()
        exp = Expected()
        aggs = [f"agg-{i}" for i in range(12)]
        append_events(log, [e for a in aggs for e in exp.events(a, 2)])
        j, t = planes(log, capacity=16, tracer=InMemoryTracer)
        for p in (j, t):
            got = await p.read_many(aggs)
            assert sorted(got) == sorted(aggs)
            await p.read_state(aggs[0])
        jspans, tspans = j.tracer.finished, t.tracer.finished
        assert [s.name for s in tspans] == [s.name for s in jspans]
        assert {s.name for s in tspans} == {"resident.gather"}
        for js, ts in zip(jspans, tspans):
            assert list(ts.attributes) == list(js.attributes)
            assert ts.attributes["rows"] == js.attributes["rows"]

    asyncio.run(scenario())


def test_fault_plane_corrupts_the_same_row_and_passes_the_same_points():
    async def scenario():
        log = make_log()
        exp = Expected()
        aggs = [f"agg-{i}" for i in range(20)]
        append_events(log, [e for a in aggs for e in exp.events(a, 3)])
        plan = lambda: CountingFaults(NAMED_PLANS["corrupt.slab-row"]())  # noqa: E731
        j, t = planes(log, faults=plan)
        await rounds(log, j, t, exp, aggs, 1)
        jrows, trows = (p.audit_pull(p.resident_ids()) for p in (j, t))
        assert sorted(trows) == sorted(jrows)
        for agg, (jrow, jord) in jrows.items():
            trow, tord = trows[agg]
            assert tord == jord
            for k, v in jrow.items():
                assert trow[k].tobytes() == np.asarray(v).tobytes(), (agg, k)
        victim = next(iter(t._dir))
        assert victim == next(iter(j._dir))
        # exactly one bit off its fold (the count's sign bit), ordinal kept
        truth = exp.states[victim]
        row, ordinal = trows[victim]
        assert ordinal == exp.seqs[victim]
        assert int(row["version"]) == truth.version
        flipped = np.asarray(row["count"]).view(np.uint32) ^ np.uint32(truth.count)
        assert int(flipped) == 1 << 31
        assert t._faults.injected == j._faults.injected == 1
        assert t._faults.points == j._faults.points
        assert set(t._faults.points) == {"resident.refresh.dispatch"}
        assert len(t._faults.points) == t._round_acc["windows"]
        # the rule fired once: a second round corrupts nothing more
        await rounds(log, j, t, exp, aggs, 1)
        assert t._faults.injected == 1

    asyncio.run(scenario())


def test_fault_point_stall_lands_in_the_dispatch_stage():
    """An armed delay at the dispatch point holds the window's executor call,
    so the profiler's dispatch stage measures it."""
    async def scenario():
        log = make_log()
        exp = Expected()
        aggs = [f"agg-{i}" for i in range(6)]
        append_events(log, [e for a in aggs for e in exp.events(a, 2)])
        slept = []
        stall = lambda: FaultPlane(  # noqa: E731
            [FaultRule(site="resident.refresh.dispatch", action="delay",
                       delay_ms=30.0, times=1)], clock=slept.append)
        j, t = planes(log, capacity=16, faults=stall,
                      profiler=(JProfiler.counters, ReplayProfiler.counters))
        await rounds(log, j, t, exp, aggs, 1)
        assert len(slept) == 2  # one stall on each plane
        assert t.profiler.stage_n == j.profiler.stage_n

    asyncio.run(scenario())
