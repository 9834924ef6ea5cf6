"""Mixed aggregate-type replay in the port (surge_tpu_torch.replay.mixed)
against the reference's (surge_tpu/replay/mixed.py): the same combined
registry, the same codec bridges, byte-identical states on every replay path
and backend, and the resident state plane in lockstep over one mixed log
across eviction and re-admission. On the CPU the port's ``pallas`` backend
folds with the kernels' plain versions; the kernels' own mixed step (C step
id 4) is held to them by ``chip_smoke.py`` phase 13 on the card. Inputs are
the reference's seeded random logs (tests/test_replay_mixed.py)."""

import asyncio
import ctypes
import dataclasses
import functools
import json
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from surge_tpu.codec.schema import FieldSpec as JFieldSpec
from surge_tpu.codec.schema import SchemaRegistry as JSchemaRegistry
from surge_tpu.config import Config as JConfig
from surge_tpu.config import default_config as jdefault_config
from surge_tpu.engine.model import ReplaySpec as JReplaySpec
from surge_tpu.log import InMemoryLog, LogRecord, TopicSpec
from surge_tpu.models import bank_account as jbank
from surge_tpu.models import counter as jcounter
from surge_tpu.models import shopping_cart as jcart
from surge_tpu.replay.engine import ReplayEngine as JEngine
from surge_tpu.replay.mixed import combine_replay_specs as jcombine
from surge_tpu.replay.mixed import combine_replay_specs_with_init as jcombine_init
from surge_tpu.replay.resident_state import ResidentStatePlane as JPlane
from surge_tpu.saga import model as jsaga
from surge_tpu.testing.support import (
    random_bank_log,
    random_cart_log,
    random_counter_log,
    random_saga_log,
)
from surge_tpu_torch.codec.schema import FieldSpec, SchemaRegistry
from surge_tpu_torch.codec.wire import WireFormat
from surge_tpu_torch.config import Config
from surge_tpu_torch.engine.model import MixedKernelStep, ReplaySpec
from surge_tpu_torch.models import bank_account, counter, shopping_cart
from surge_tpu_torch.replay import MixedReplay, combine_replay_specs, fold_kernels
from surge_tpu_torch.replay.engine import ReplayEngine
from surge_tpu_torch.replay.mixed import combine_replay_specs_with_init
from surge_tpu_torch.replay.resident_state import ResidentStatePlane
from surge_tpu_torch.saga import model as saga
from tests.test_torch_isolation import leave_the_worker_as_found  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent

#: model name in a mix -> (port module, reference module); the names are the
#: reference test's (tests/test_replay_mixed.py), so the bases agree with it
FAMILIES = {"counter": (counter, jcounter), "cart": (shopping_cart, jcart),
            "bank": (bank_account, jbank), "saga": (saga, jsaga)}
#: the mixes under test: the reference test's three families, all four, and
#: one family alone
MIXES = {"three": ("bank", "cart", "counter"),
         "four": ("bank", "cart", "counter", "saga"),
         "solo": ("saga",)}
CFG = {"surge.replay.batch-size": 64, "surge.replay.time-chunk": 8}


def _specs(mix, port=True):
    return {m: FAMILIES[m][0 if port else 1].make_replay_spec() for m in MIXES[mix]}


def _port_event(ev):
    """A reference event (bank_account's in its encoded form) as the port's
    event of the same name and fields."""
    for mod in (counter, shopping_cart, bank_account, saga):
        cls = getattr(mod, type(ev).__name__, None)
        if cls is not None:
            return cls(**{f.name: getattr(ev, f.name) for f in dataclasses.fields(cls)})
    raise KeyError(type(ev).__name__)


def _tagged_logs(models, n, seed, first=0, min_len=0):
    """``n`` reference logs tagged with their model, the families taking
    turns: (model, aggregate id, log), bank logs vocab-encoded."""
    rng = random.Random(seed)
    vocab = jbank.Vocab()
    out = []
    while len(out) < n:
        m = models[len(out) % len(models)]
        agg = f"{m}-{first + len(out)}"
        if m == "counter":
            log = random_counter_log(rng, agg)
        elif m == "cart":
            log = random_cart_log(rng, agg)
        elif m == "bank":
            log = [jbank.encode_event(vocab, e) for e in random_bank_log(rng, agg)]
        else:
            log = random_saga_log(rng, agg)
        if len(log) >= min_len:
            out.append((m, agg, log))
    return out


def _row(state, fields) -> tuple:
    """A decoded state's fields as the raw bytes of their schema dtypes."""
    return tuple(np.asarray(getattr(state, f.name), dtype=f.dtype).tobytes()
                 for f in fields)


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].tobytes() == w.tobytes(), k


# -- 1. registry parity ------------------------------------------------------------


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_combined_registry_matches_the_reference(mix):
    got, want = combine_replay_specs(_specs(mix)), jcombine(_specs(mix, port=False))
    assert isinstance(got, MixedReplay)
    assert got.bases == want.bases
    greg, wreg = got.spec.registry, want.spec.registry
    assert [(s.cls.__name__, s.type_id) for s in greg.event_schemas] == \
        [(s.cls.__name__, s.type_id) for s in wreg.event_schemas]
    assert greg.num_event_types == wreg.num_event_types
    assert [(f.name, f.dtype, f.bits) for f in greg.union_columns()] == \
        [(f.name, f.dtype, f.bits) for f in wreg.union_columns()]
    assert [(f.name, f.dtype) for f in greg.state.fields] == \
        [(f.name, f.dtype) for f in wreg.state.fields]
    assert got.spec.init_record == want.spec.init_record == {}
    for m in MIXES[mix]:
        assert got.type_id(m, 1) == want.type_id(m, 1)
    # the kernel descriptor: each part's step and range; the step's columns
    # and fields, which the kernels find in the union by name, are the part's
    step = got.spec.kernel_step
    assert isinstance(step, MixedKernelStep)
    union = {f.name for f in greg.union_columns()}
    for part in step.parts:
        spec = got.parts[part.model]
        assert (part.step, part.base, part.num_types) == (
            spec.kernel_step, got.bases[part.model], spec.registry.num_event_types)
        assert fold_kernels.KERNEL_STEPS[part.step] == (
            spec.registry.state.field_names,
            tuple(f.name for f in spec.registry.union_columns()))
        assert set(fold_kernels.KERNEL_STEPS[part.step][1]) <= union
        assert set(spec.registry.state.field_names) <= set(greg.state.field_names)


def test_union_layouts_of_three_and_four_families():
    three = combine_replay_specs(_specs("three")).spec.registry
    four = combine_replay_specs(_specs("four")).spec.registry
    assert (three.num_event_types, len(three.union_columns()),
            len(three.state.fields)) == (9, 10, 9)
    assert (four.num_event_types, len(four.union_columns()),
            len(four.state.fields)) == (14, 18, 20)
    # the four-family union is exactly the kernel's MixedStep layout
    assert tuple(f.name for f in four.union_columns()) == fold_kernels.MIXED_COLS
    assert four.state.field_names == fold_kernels.MIXED_STATE


def test_refusals_match_the_reference():
    for combine, specs in ((combine_replay_specs, _specs("three")),
                           (jcombine, _specs("three", port=False))):
        shared = specs["counter"]
        with pytest.raises(ValueError):
            combine({"a": shared, "b": shared})
    # a nonzero init record: refused, unless acknowledged
    port = dataclasses.replace(counter.make_replay_spec(),
                               init_record={"count": 5, "version": 0})
    ref = dataclasses.replace(jcounter.make_replay_spec(),
                              init_record={"count": 5, "version": 0})
    for combine, spec in ((combine_replay_specs, port), (jcombine, ref)):
        with pytest.raises(ValueError, match="nonzero init_record"):
            combine({"counter": spec})
    got = combine_replay_specs_with_init({"counter": port})
    want = jcombine_init({"counter": ref})
    _same(got.init_carry(["counter"] * 3), want.init_carry(["counter"] * 3))
    assert got.init_carry(["counter"])["count"].tolist() == [5]


# -- 2. codec parity ----------------------------------------------------------------


@pytest.mark.parametrize("mix", ["three", "four"])
def test_codec_bridges_match_the_reference(mix):
    got, want = combine_replay_specs(_specs(mix)), jcombine(_specs(mix, port=False))
    tagged = _tagged_logs(MIXES[mix], 60, seed=3)
    models = [m for m, _, _ in tagged]
    gcol = got.encode_logs([(m, [_port_event(e) for e in log]) for m, _, log in tagged])
    wcol = want.encode_logs([(m, log) for m, _, log in tagged])
    assert gcol.num_aggregates == wcol.num_aggregates
    for name in ("agg_idx", "type_ids"):
        assert getattr(gcol, name).tobytes() == np.asarray(getattr(wcol, name)).tobytes()
    _same(gcol.cols, wcol.cols)
    _same(got.init_carry(models), want.init_carry(models))
    # decode: the same states (each through its own family's schema) from
    # one folded union carry
    res = JEngine(want.spec, config=JConfig(overrides=CFG)).replay_columnar(
        wcol, init_carry=want.init_carry(models))
    states = {k: np.asarray(v) for k, v in res.states.items()}
    for m, g, w in zip(models, got.decode_states(models, states),
                       want.decode_states(models, states)):
        assert type(g).__name__ == type(w).__name__
        fields = got.parts[m].registry.state.fields
        assert _row(g, fields) == _row(w, fields)


# -- 3. replay parity on every path and backend ------------------------------------


#: path -> (port overrides, how the engines fold the corpus)
PATHS = ("columnar", "resident-dense", "resident-flat", "streamed", "ragged")


def _fold(eng, path, colev, logs, init):
    if path == "columnar":
        return eng.replay_columnar(colev, init_carry=init)
    if path.startswith("resident"):
        return eng.replay_resident(eng.prepare_resident(colev), init_carry=init)
    if path == "streamed":
        return eng.replay_resident_streamed(eng.pack_resident(colev), segments=3,
                                            init_carry=init)
    return eng.replay_ragged(logs, init_carry=init)


def _layout(path):
    return ({"surge.replay.resident-layout": path.split("-")[1]}
            if path.startswith("resident") else {})


@functools.cache
def _reference_states(mix, path, derived):
    want = jcombine(_specs(mix, port=False))
    tagged = _tagged_logs(MIXES[mix], 120, seed=7)
    models = [m for m, _, _ in tagged]
    colev = want.encode_logs([(m, log) for m, _, log in tagged])
    if derived:
        colev = _derive(colev)
    eng = JEngine(want.spec, config=JConfig(overrides={**CFG, **_layout(path)}))
    res = _fold(eng, path, colev, [log for _, _, log in tagged],
                want.init_carry(models))
    return {k: np.asarray(v) for k, v in res.states.items()}, res.num_events


def _derive(colev):
    """The corpus with ``sequence_number`` derived on the device (a lane's
    ordinal), as the chip corpora ship it."""
    cols = dict(colev.cols)
    cols.pop("sequence_number", None)
    return dataclasses.replace(colev, cols=cols,
                               derived_cols={"sequence_number": "ordinal"})


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_replay_paths_match_the_reference(mix, path, backend):
    got = combine_replay_specs(_specs(mix))
    tagged = _tagged_logs(MIXES[mix], 120, seed=7)
    models = [m for m, _, _ in tagged]
    logs = [[_port_event(e) for e in log] for _, _, log in tagged]
    colev = got.encode_logs(list(zip(models, logs)))
    eng = ReplayEngine(got.spec, Config(overrides={
        **CFG, **_layout(path), "surge.replay.tile-backend": backend}), device="cpu")
    init = got.init_carry(models)
    snapshot = {k: v.copy() for k, v in init.items()}
    res = _fold(eng, path, colev, logs, init)
    want, events = _reference_states(mix, path, False)
    _same(res.states, want)
    assert res.num_events == events == sum(len(l) for l in logs)
    _same(init, snapshot)  # the caller's carry is never written


@pytest.mark.parametrize("path", ["resident-dense", "resident-flat", "streamed"])
@pytest.mark.parametrize("mix", ["three", "four"])
def test_resident_paths_with_the_derived_ordinal(mix, path):
    """The chip corpora's wire: ``sequence_number`` derived, not shipped (bank
    lanes carry the ordinal and never read it; a counter's no-op event takes
    an ordinal too, so these states are not the shipped ones)."""
    got = combine_replay_specs(_specs(mix))
    tagged = _tagged_logs(MIXES[mix], 120, seed=7)
    models = [m for m, _, _ in tagged]
    colev = _derive(got.encode_logs(
        [(m, [_port_event(e) for e in log]) for m, _, log in tagged]))
    eng = ReplayEngine(got.spec, Config(overrides={
        **CFG, **_layout(path), "surge.replay.tile-backend": "pallas"}), device="cpu")
    res = _fold(eng, path, colev, None, got.init_carry(models))
    _same(res.states, _reference_states(mix, path, True)[0])


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_one_family_mix_equals_its_own_replay(family, backend):
    """A mix of one family folds every lane as that family's own spec does,
    byte for byte (the union's fields are the family's, sorted by name)."""
    mixed = combine_replay_specs({family: FAMILIES[family][0].make_replay_spec()})
    tagged = _tagged_logs((family,), 80, seed=11)
    logs = [[_port_event(e) for e in log] for _, _, log in tagged]
    ov = Config(overrides={**CFG, "surge.replay.tile-backend": backend})
    spec = FAMILIES[family][0].make_replay_spec()
    own = ReplayEngine(spec, ov, device="cpu")
    eng = ReplayEngine(mixed.spec, ov, device="cpu")
    colev = mixed.encode_logs([(family, l) for l in logs])
    for path in ("columnar", "resident-flat"):
        want = _fold(own, path, colev, logs, None).states
        got = _fold(eng, path, colev, logs, mixed.init_carry([family] * len(logs)))
        _same(got.states, want)


# -- 4. the resident state plane in lockstep over one mixed log --------------------


TOPIC = "mixed-events"
NPART = 4
PLANE_MODELS = MIXES["four"]
#: arm -> (port overrides, reference overrides), as in test_torch_saga_plane.py
ARMS = {
    "pallas-bucketed": ({"surge.replay.tile-backend": "pallas"},
                        {"surge.replay.tile-backend": "pallas",
                         "surge.replay.dispatch": "select"}),
    "pallas-dense": ({"surge.replay.tile-backend": "pallas",
                      "surge.replay.resident.refresh-dispatch": "dense"},
                     {"surge.replay.resident.refresh-dispatch": "dense"}),
}
_REF_CLASSES = {c.__name__: c for mod in (jcounter, jcart, jbank, jsaga)
                for c in vars(mod).values() if dataclasses.is_dataclass(c)}


def _encode_record(ev) -> bytes:
    return json.dumps({"t": type(ev).__name__, "f": {
        f.name: (v.item() if isinstance(v, np.generic) else v)
        for f in dataclasses.fields(ev) for v in [getattr(ev, f.name)]}}).encode()


def _ref_event(raw):
    d = json.loads(raw)
    return _REF_CLASSES[d["t"]](**d["f"])


def _append(log, tagged):
    prod = log.transactional_producer("seed")
    prod.begin()
    for _, agg, events in tagged:
        for ev in events:
            prod.send(LogRecord(topic=TOPIC, partition=int(agg.rsplit("-", 1)[1]) % NPART,
                                key=agg, value=_encode_record(ev)))
    prod.commit()


class _Ledger:
    def __init__(self):
        self.rounds, self.evicts = [], []

    def record_round(self, **kw):
        self.rounds.append(kw)

    def record_evict(self, count, **kw):
        self.evicts.append(count)

    def record_gather(self, **kw):
        pass


class MixedDuo:
    """The reference plane and the port's plane over one mixed log, each with
    its own package's combined spec of all four families."""

    def __init__(self, log, arm, capacity):
        base = {"surge.replay.resident.capacity": capacity,
                "surge.replay.resident.refresh-interval-ms": 10,
                "surge.replay.batch-size": 16, "surge.replay.time-chunk": 8}
        tover, jover = ARMS[arm]
        self.jled, self.tled = _Ledger(), _Ledger()
        self.fields = combine_replay_specs(_specs("four")).spec.registry.state.fields
        self.j = JPlane(log, TOPIC, jcombine(_specs("four", port=False)).spec,
                        config=jdefault_config().with_overrides({**base, **jover}),
                        deserialize_event=_ref_event,
                        serialize_state=lambda a, s: b"", ledger=self.jled)
        self.t = ResidentStatePlane(
            log, TOPIC, combine_replay_specs(_specs("four")).spec,
            config=Config(overrides={**base, **tover}), device="cpu",
            deserialize_event=lambda raw: _port_event(_ref_event(raw)),
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
        states = lambda p: {a: _row(s, self.fields)  # noqa: E731
                            for a, s in p.snapshot_states().items()}
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


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_mixed_plane_in_lockstep_across_evict_and_readmit(arm):
    """Seed half of 16 logs (four of each family) into a 16-row slab, flood
    16 new aggregates through it (the first set spills), then land the first
    set's suffixes so the spilled rows re-admit and finish folding; every
    row ends at its family's scalar fold."""
    async def scenario():
        log = InMemoryLog()
        log.create_topic(TopicSpec(TOPIC, NPART))
        first = _tagged_logs(PLANE_MODELS, 16, seed=41, min_len=2)
        second = _tagged_logs(PLANE_MODELS, 16, seed=1000, first=16, min_len=1)
        cuts = [len(l) // 2 for _, _, l in first]
        _append(log, [(m, a, l[:c]) for (m, a, l), c in zip(first, cuts)])
        duo = MixedDuo(log, arm, capacity=16)
        duo.seed()
        assert len(duo.t.resident_ids()) == 16
        _append(log, second)
        assert await duo.refresh()
        assert duo.t.stats["evictions"] > 0
        _append(log, [(m, a, l[c:]) for (m, a, l), c in zip(first, cuts)])
        assert await duo.refresh()
        # every aggregate read back equals its family's own fold of its log
        mixed = combine_replay_specs(_specs("four"))
        every = first + second
        eng = ReplayEngine(mixed.spec, Config(overrides=CFG), device="cpu")
        models = [m for m, _, _ in every]
        colev = mixed.encode_logs([(m, [_port_event(e) for e in l])
                                   for m, _, l in every])
        want = eng.replay_columnar(colev, init_carry=mixed.init_carry(models)).states
        got = duo.t.snapshot_states()
        for i, (m, agg, _) in enumerate(every):
            assert _row(got[agg], duo.fields) == tuple(
                want[f.name][i].tobytes() for f in duo.fields), agg
        assert len({m for m, _, _ in every}) == 4

    asyncio.run(scenario())


# -- 5. backend resolution and the kernel's layout, without a card ------------------


@pytest.mark.parametrize("derived", [None, {"sequence_number": "ordinal"}])
@pytest.mark.parametrize("mix", ["three", "four"])
def test_mixed_decode_args_map_the_union(mix, derived):
    """The mixed step's decode arguments are built on the host (ctypes only):
    one slot per MIXED_COLS name, absent where the union lacks it, each part's
    type-id range, and maps that land each part on its own columns."""
    mixed = combine_replay_specs(_specs(mix))
    reg = mixed.spec.registry
    wire = WireFormat(reg, derived)
    step_id, dec = fold_kernels._decode_args(mixed.spec.kernel_step, reg, wire)
    assert step_id == fold_kernels.MIXED_STEP_ID == 4
    assert dec.n_cols == len(fold_kernels.MIXED_COLS)
    union = {f.name for f in reg.union_columns()}
    packed = {pf.name: pf for pf in wire.packed_fields}
    sides = {f.name for f in wire.side_fields}
    for c, name in enumerate(fold_kernels.MIXED_COLS):
        kind = (fold_kernels._ABSENT_COL if name not in union
                else fold_kernels._PACKED if name in packed
                else fold_kernels._SIDE if name in sides
                else fold_kernels._ORDINAL)
        assert dec.kind[c] == kind, name
        if kind == fold_kernels._PACKED:
            assert (dec.shift[c], dec.mask[c]) == (packed[name].shift,
                                                   packed[name].mask)
    steps = list(fold_kernels.KERNEL_STEPS)
    by_step = {p.step: p for p in mixed.spec.kernel_step.parts}
    for p, step in enumerate(steps):
        part = by_step.get(step)
        assert (dec.part_base[p], dec.part_types[p]) == (
            (part.base, part.num_types) if part else (0, 0))
    union_cols = [f.name for f in reg.union_columns()]
    for part in mixed.spec.kernel_step.parts:
        slots, fields = fold_kernels.mixed_part_map(part.step)
        own = mixed.parts[part.model].registry
        assert [fold_kernels.MIXED_COLS[s] for s in slots] == \
            [f.name for f in own.union_columns()]
        assert {fold_kernels.MIXED_COLS[s] for s in slots} <= set(union_cols)
        assert [fold_kernels.MIXED_STATE[s] for s in fields] == \
            list(own.state.field_names)
    # the state slots: absent where the spec lacks the field, and the slab's
    # admission rows in the spec's own order
    slab = {f.name: torch.zeros(5, dtype=torch.int32 if f.dtype != np.bool_
                                else torch.bool) for f in reg.state.fields}
    ords = torch.zeros(5, dtype=torch.int32)
    table = torch.zeros((fold_kernels.LANE_ADMIT_VAL + len(slab), 2), dtype=torch.int32)
    sa = fold_kernels._slab_args(slab, ords, table, mixed.spec)
    names = list(reg.state.field_names)
    for i, name in enumerate(fold_kernels.MIXED_STATE):
        if name in names:
            assert sa.admit_row[i] == fold_kernels.LANE_ADMIT_VAL + names.index(name)
            assert sa.col[i] == slab[name].data_ptr()
        else:
            assert sa.kind[i] == fold_kernels._ABSENT_FIELD and not sa.col[i]


def _without_step(spec):
    return dataclasses.replace(spec, kernel_step=None, associative=None)


def test_a_part_without_a_kernel_step_raises_naming_it(monkeypatch):
    specs = _specs("three")
    specs["cart"] = _without_step(specs["cart"])
    mixed = combine_replay_specs(specs)
    wire = WireFormat(mixed.spec.registry)
    with pytest.raises(ValueError, match="'cart'"):
        fold_kernels._decode_args(mixed.spec.kernel_step, mixed.spec.registry, wire)
    explicit = ReplayEngine(mixed.spec, Config(overrides={
        "surge.replay.tile-backend": "pallas"}), device="cpu")
    with pytest.raises(ValueError, match="part 'cart' has none"):
        explicit.tile_backend
    on_card = ReplayEngine(mixed.spec, device="cpu")
    monkeypatch.setattr(on_card, "device", torch.device("cuda"))
    with pytest.raises(ValueError, match="part 'cart' has none"):
        on_card.tile_backend
    # the plane resolves its backend through the same engine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="part 'cart' has none"):
        ResidentStatePlane(InMemoryLog(), TOPIC, mixed.spec,
                           deserialize_event=_ref_event,
                           serialize_state=lambda a, s: b"")
    # the plain scan still folds it on the CPU
    assert ReplayEngine(mixed.spec, device="cpu").tile_backend == "xla"


def test_a_part_whose_step_folds_other_columns_raises_naming_it():
    """The kernels find a part's columns and fields in the union by its
    step's names: a part whose events are not its step's is refused."""
    specs = _specs("three")
    specs["cart"] = dataclasses.replace(specs["cart"], kernel_step="saga")
    mixed = combine_replay_specs(specs)
    wire = WireFormat(mixed.spec.registry)
    with pytest.raises(ValueError, match="part 'cart': the 'saga' step decodes"):
        fold_kernels._decode_args(mixed.spec.kernel_step, mixed.spec.registry, wire)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_auto_on_cuda_is_the_kernel_for_a_combined_spec(mix, monkeypatch):
    """Queue 3's fault repaired: a combined spec of kernel-carried families
    resolves to the kernels on the card, never the plain scan."""
    eng = ReplayEngine(combine_replay_specs(_specs(mix)).spec, device="cpu")
    assert eng.tile_backend == "xla"
    monkeypatch.setattr(eng, "device", torch.device("cuda"))
    assert eng.tile_backend == "pallas"


def _promoted(port):
    """counter beside a cart whose ``version`` is float32: the union promotes
    the shared field to float64."""
    cart = (shopping_cart if port else jcart).make_replay_spec()
    reg = SchemaRegistry() if port else JSchemaRegistry()
    spec_cls, field_cls = (ReplaySpec, FieldSpec) if port else (JReplaySpec, JFieldSpec)
    for s in cart.registry.event_schemas:
        reg.register_event(s.cls, type_id=s.type_id, fields=s.fields)
    reg.register_state(cart.registry.state.cls, fields=tuple(
        field_cls(f.name, np.float32 if f.name == "version" else f.dtype)
        for f in cart.registry.state.fields))
    kw = {"kernel_step": "shopping_cart"} if port else {}
    cart = spec_cls(registry=reg, handlers=cart.handlers, init_record={}, **kw)
    counter_spec = (counter if port else jcounter).make_replay_spec()
    return (combine_replay_specs if port else jcombine)(
        {"counter": counter_spec, "cart": cart})


def test_promoted_dtype_matches_on_the_plain_scan_and_the_kernel_refuses_it(
        monkeypatch):
    """int32 beside float32 promotes to float64 (``np.promote_types``). The
    plain scan matches the reference's float64 states byte for byte; the
    kernels carry i32/f32/bool only, so the kernel path raises naming the
    field (a deliberate difference, ROADMAP Queue 3)."""
    got, want = _promoted(True), _promoted(False)
    assert got.spec.registry.state.fields == tuple(
        FieldSpec(f.name, f.dtype) for f in want.spec.registry.state.fields)
    assert np.dtype(got.spec.registry.state.fields[-1].dtype) == np.float64
    rng = random.Random(3)
    tagged = [("counter", random_counter_log(rng, f"a{i}")) if i % 2 == 0
              else ("cart", random_cart_log(rng, f"a{i}")) for i in range(16)]
    models = [m for m, _ in tagged]
    res = ReplayEngine(got.spec, Config(overrides=CFG), device="cpu").replay_columnar(
        got.encode_logs([(m, [_port_event(e) for e in l]) for m, l in tagged]),
        init_carry=got.init_carry(models))
    ref = JEngine(want.spec, config=JConfig(overrides=CFG)).replay_columnar(
        want.encode_logs(tagged), init_carry=want.init_carry(models))
    _same(res.states, {k: np.asarray(v) for k, v in ref.states.items()})
    with pytest.raises(ValueError, match="state field 'version'"):
        fold_kernels._decode_args(got.spec.kernel_step, got.spec.registry,
                                  WireFormat(got.spec.registry))
    on_card = ReplayEngine(got.spec, device="cpu")
    monkeypatch.setattr(on_card, "device", torch.device("cuda"))
    with pytest.raises(ValueError, match="state field 'version'"):
        on_card.tile_backend


def _header_constant(name: str) -> int:
    text = (ROOT / "surge_tpu_torch" / "csrc" / "fold_common.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_ctypes_mirrors_follow_the_header_caps():
    """The mirrors' array lengths are fold_common.cuh's kMaxCols, kMaxState
    and kParts (and the mixed step's wire bytes its kWireBytes), so a drift
    shows here and not only in the card's struct_size check; the caps hold
    the four-family union."""
    cols, state, parts = (_header_constant(n) for n in ("kMaxCols", "kMaxState",
                                                        "kParts"))
    assert (cols, state) == (len(fold_kernels.MIXED_COLS),
                             len(fold_kernels.MIXED_STATE)) == (18, 20)
    assert parts == len(fold_kernels.KERNEL_STEPS)
    assert _header_constant("kWireBytes<MixedStep>") == fold_kernels._MIXED_WIRE_BYTES
    # every combined spec of the four families packs into those bytes
    assert WireFormat(combine_replay_specs(_specs("four")).spec.registry).nbytes \
        <= fold_kernels._MIXED_WIRE_BYTES
    for struct, field, n in ((fold_kernels._DecodeArgs, "kind", cols),
                             (fold_kernels._DecodeArgs, "side", cols),
                             (fold_kernels._DecodeArgs, "part_base", parts),
                             (fold_kernels._DecodeArgs, "part_types", parts),
                             (fold_kernels._StateArgs, "in_", state),
                             (fold_kernels._SlabArgs, "col", state),
                             (fold_kernels._SlabArgs, "admit_row", state)):
        assert getattr(struct, field).size == n * ctypes.sizeof(
            getattr(struct(), field)._type_), (struct.__name__, field)
    # MixedPart's maps in the header are the ones mixed_part_map derives
    text = (ROOT / "surge_tpu_torch" / "csrc" / "fold_common.cuh").read_text()
    for p, step in enumerate(fold_kernels.KERNEL_STEPS):
        body = text.split(f"struct MixedPart<{p}> {{")[1].split("\n};")[0]
        maps = [[int(x) for x in m.split(",")]
                for m in re.findall(r"constexpr int m\[\] = \{([\d, ]+)\};", body)]
        assert maps == list(fold_kernels.mixed_part_map(step)), step


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels' mixed step has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["columnar", "resident-dense", "resident-flat"])
def test_mixed_kernels_match_the_plain_versions_on_the_card(cuda_card, path):
    """The mixed step through K1 on the card equals the plain versions' fold
    on the CPU, byte for byte (chip_smoke.py phase 13 holds the windows)."""
    got = combine_replay_specs(_specs("four"))
    tagged = _tagged_logs(MIXES["four"], 120, seed=7)
    models = [m for m, _, _ in tagged]
    colev = got.encode_logs([(m, [_port_event(e) for e in l]) for m, _, l in tagged])
    out = {}
    for device in ("cpu", cuda_card):
        eng = ReplayEngine(got.spec, Config(overrides={
            **CFG, **_layout(path), "surge.replay.tile-backend": "pallas"}),
            device=device)
        before = fold_kernels.LAUNCHES["tile_fold_list"]
        out[str(device)] = _fold(eng, path, colev, None, got.init_carry(models)).states
        if device != "cpu":
            assert fold_kernels.LAUNCHES["tile_fold_list"] > before
    _same(out[str(cuda_card)], out["cpu"])
