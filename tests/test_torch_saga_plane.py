"""The saga family through the port's resident state plane
(surge_tpu_torch.replay.resident_state on the CPU) in lockstep with the
reference plane over ONE log, across eviction and re-admission, as
tests/test_saga_replay.py drives the reference alone: seed a prefix of 8 saga
logs into a capacity-8 slab, flood 8 new sagas through it (the first set
spills at its exact fold point), then land the first set's suffixes so the
spilled rows re-admit and finish folding. After every step the two planes
agree on every state, the ``audit_pull`` (row, ordinal) pairs as raw bytes,
the resident set, the evictions and the dispatch buckets; at the end every
row equals the scalar ``SagaModel`` fold of its whole log. Arms: the port's
plain K2 (bucketed) and plain K1 window (dense), and the plain scan, each
with the ordinal shipped and derived."""

import asyncio
import dataclasses
import random

import numpy as np
import pytest

from surge_tpu.config import default_config
from surge_tpu.engine.model import fold_events
from surge_tpu.log import InMemoryLog, LogRecord, TopicSpec
from surge_tpu.replay.resident_state import ResidentStatePlane as JPlane
from surge_tpu.saga import model as jsaga
from surge_tpu.serialization import SerializedMessage
from surge_tpu.testing.support import random_saga_log
from surge_tpu_torch.config import Config
from surge_tpu_torch.replay.resident_state import ResidentStatePlane
from surge_tpu_torch.saga import model as saga
from tests.test_torch_isolation import leave_the_worker_as_found  # noqa: F401

EVT = jsaga.event_formatting()
TOPIC = "saga-events"
NPART = 4
FIELDS = tuple(f.name for f in saga.make_registry().state.fields)

#: arm -> (port overrides, reference overrides)
ARMS = {
    "pallas-bucketed": ({"surge.replay.tile-backend": "pallas"},
                        {"surge.replay.tile-backend": "pallas",
                         "surge.replay.dispatch": "select"}),
    "xla-bucketed": ({"surge.replay.tile-backend": "xla"}, {}),
    "pallas-dense": ({"surge.replay.tile-backend": "pallas",
                      "surge.replay.resident.refresh-dispatch": "dense"},
                     {"surge.replay.resident.refresh-dispatch": "dense"}),
}
DERIVED = {"shipped": None, "derived": {"sequence_number": "ordinal"}}


def part_of(agg: str) -> int:
    return int(agg.rsplit("-", 1)[1]) % NPART


def append_events(log, events):
    prod = log.transactional_producer("seed")
    prod.begin()
    for ev in events:
        msg = EVT.write_event(ev)
        prod.send(LogRecord(topic=TOPIC, partition=part_of(ev.aggregate_id),
                            key=msg.key, value=msg.value))
    prod.commit()


def port_event(raw):
    """A logged reference saga event as the port's event of the same name."""
    ev = EVT.read_event(SerializedMessage(key="", value=raw))
    cls = getattr(saga, type(ev).__name__)
    return cls(**{f.name: getattr(ev, f.name) for f in dataclasses.fields(cls)})


def row(state) -> tuple:
    """A state's fields, the float context slots as their f32 bytes."""
    return tuple(np.float32(v).tobytes() if k.startswith("c") else int(v)
                 for k, v in ((k, getattr(state, k)) for k in FIELDS))


class RoundLedger:
    def __init__(self):
        self.rounds, self.evicts = [], []

    def record_round(self, **kw):
        self.rounds.append(kw)

    def record_evict(self, count, **kw):
        self.evicts.append(count)

    def record_gather(self, **kw):
        pass


class Duo:
    """The reference plane and the port's plane over one saga log."""

    def __init__(self, log, arm, derived, capacity=8):
        base = {"surge.replay.resident.capacity": capacity,
                "surge.replay.resident.refresh-interval-ms": 10,
                "surge.replay.batch-size": 16,
                "surge.replay.time-chunk": 8}
        tover, jover = ARMS[arm]
        self.jled, self.tled = RoundLedger(), RoundLedger()
        self.j = JPlane(
            log, TOPIC, jsaga.make_replay_spec(),
            config=default_config().with_overrides({**base, **jover}),
            deserialize_event=lambda raw: EVT.read_event(
                SerializedMessage(key="", value=raw)),
            serialize_state=lambda a, s: b"", derived_cols=derived,
            ledger=self.jled)
        self.t = ResidentStatePlane(
            log, TOPIC, saga.make_replay_spec(),
            config=Config(overrides={**base, **tover}), device="cpu",
            deserialize_event=port_event, derived_cols=derived,
            serialize_state=lambda a, s: b"", ledger=self.tled)

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

    def check(self):
        j, t = self.j, self.t
        states = lambda p: {a: row(s) for a, s in p.snapshot_states().items()}  # noqa: E731
        assert states(t) == states(j)
        assert t.resident_ids() == j.resident_ids()
        jpairs, tpairs = (p.audit_pull(p.resident_ids()) for p in (j, t))
        assert sorted(tpairs) == sorted(jpairs)
        for agg, (jrow, jord) in jpairs.items():
            trow, tord = tpairs[agg]
            assert tord == jord, agg
            for k, v in jrow.items():
                assert trow[k].tobytes() == np.asarray(v).tobytes(), (agg, k)
        assert t.stats["evictions"] == j.stats["evictions"]
        assert self.tled.evicts == self.jled.evicts
        assert [r["buckets"] for r in self.tled.rounds] == \
            [r["buckets"] for r in self.jled.rounds]


def saga_logs(n, seed, min_len=0, first=0):
    rng = random.Random(seed)
    logs = []
    while len(logs) < n:
        log = random_saga_log(rng, f"saga-{first + len(logs)}")
        if len(log) >= min_len:
            logs.append(log)
    return logs


@pytest.mark.parametrize("derived", sorted(DERIVED))
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_saga_plane_in_lockstep_across_evict_and_readmit(arm, derived):
    async def scenario():
        log = InMemoryLog()
        log.create_topic(TopicSpec(TOPIC, NPART))
        first = saga_logs(8, seed=41, min_len=2)
        second = saga_logs(8, seed=1000, first=8)
        cuts = [len(l) // 2 for l in first]
        append_events(log, [e for l, c in zip(first, cuts) for e in l[:c]])
        duo = Duo(log, arm, DERIVED[derived])
        duo.seed()
        assert set(duo.t.resident_ids()) == {f"saga-{i}" for i in range(8)}
        append_events(log, [e for l in second for e in l])
        assert await duo.refresh()
        assert duo.t.stats["evictions"] > 0
        # the first wave's suffixes re-admit the evicted rows at their
        # spilled fold point: no re-seed, no double fold
        append_events(log, [e for l, c in zip(first, cuts) for e in l[c:]])
        assert await duo.refresh()
        model = jsaga.SagaModel()
        want = {f"saga-{i}": fold_events(model, None, l)
                for i, l in enumerate(first + second) if l}
        got = duo.t.snapshot_states()
        assert {a: row(s) for a, s in got.items()} == \
            {a: row(s) for a, s in want.items()}
        statuses = {s.status for s in got.values()}
        assert len(statuses) >= 3  # the walk reached several status arms

    asyncio.run(scenario())
