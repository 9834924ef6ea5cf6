"""The port's replay entry points beyond the resident path
(``replay_resident_streamed``, ``replay_encoded``, ``replay_columnar``,
``replay_ragged``, ``replay_columnar_chunks``, ``replay_stream``) on the CPU
against the reference ReplayEngine's: the same seeded inputs give
byte-identical states. The port folds each non-resident window by its tile
backend: ``xla`` (the plain scan), ``pallas`` (K1's one-tile list fold, whose
plain version CPU tensors run) and ``assoc``; the reference always scans."""

import dataclasses
import random
import unittest.mock as mock

import numpy as np
import pytest

from surge_tpu.codec import encode_events as jencode_events
from surge_tpu.codec.tensor import ColumnarEvents as JColumnarEvents
from surge_tpu.codec.tensor import decode_states as jdecode_states
from surge_tpu.codec.tensor import encode_events_columnar as jencode_columnar
from surge_tpu.config import Config as JConfig
from surge_tpu.models import bank_account as jbank
from surge_tpu.models import counter as jcounter
from surge_tpu.models import shopping_cart as jcart
from surge_tpu.replay.corpus import synth_counter_corpus as jsynth
from surge_tpu.replay.engine import ReplayEngine as JEngine
from surge_tpu.saga import model as jsaga
from surge_tpu.testing.support import random_cart_log, random_saga_log
from surge_tpu_torch.codec.tensor import ColumnarEvents, decode_states, encode_events
from surge_tpu_torch.config import Config
from surge_tpu_torch.models import bank_account, counter, shopping_cart
from surge_tpu_torch.replay import engine as tengine
from surge_tpu_torch.replay import fold_kernels
from surge_tpu_torch.replay.corpus import synth_counter_corpus
from surge_tpu_torch.replay.engine import ReplayEngine
from surge_tpu_torch.saga import model as saga
from tests.test_replay_golden import random_counter_logs
from tests.test_torch_isolation import leave_the_worker_as_found  # noqa: F401

#: the port's tile backends for windows; the reference scans every window
BACKENDS = ["xla", "pallas"]
#: family → (port module, reference module)
FAMILIES = {"counter": (counter, jcounter), "bank_account": (bank_account, jbank),
            "shopping_cart": (shopping_cart, jcart), "saga": (saga, jsaga)}


def _engines(port_mod, jax_mod, overrides, backend="xla"):
    eng = ReplayEngine(port_mod.make_replay_spec(), Config(overrides=dict(
        overrides, **{"surge.replay.tile-backend": backend})), device="cpu")
    return eng, JEngine(jax_mod.make_replay_spec(), config=JConfig(overrides=overrides))


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].tobytes() == w.tobytes(), k


def _port_event(mod, ev):
    """A reference event as the port's event of the same name and fields."""
    return getattr(mod, type(ev).__name__)(**{
        f.name: getattr(ev, f.name) for f in dataclasses.fields(ev)})


def _port_logs(mod, logs):
    return [[_port_event(mod, e) for e in log] for log in logs]


def _port_col(jcol):
    return ColumnarEvents(num_aggregates=jcol.num_aggregates, agg_idx=jcol.agg_idx,
                          type_ids=jcol.type_ids, cols=dict(jcol.cols),
                          derived_cols=dict(jcol.derived_cols),
                          aggregate_ids=jcol.aggregate_ids)


def _jax_col(col):
    return JColumnarEvents(num_aggregates=col.num_aggregates, agg_idx=col.agg_idx,
                           type_ids=col.type_ids, cols=dict(col.cols),
                           derived_cols=dict(col.derived_cols),
                           aggregate_ids=col.aggregate_ids)


def _family_logs(family, n, seed):
    """Reference logs of a family (bank_account: vocab-encoded)."""
    rng = random.Random(seed)
    if family == "counter":
        return random_counter_logs(n, 21, seed=seed)
    if family == "bank_account":
        vocab = jbank.Vocab()
        logs = []
        for i in range(n):
            log = [jbank.BankAccountCreated(str(i), f"o{i % 7}", "s", 100.0)]
            bal = 100.0
            for _ in range(rng.randrange(0, 19)):
                bal += rng.randrange(1, 20) * 0.25
                log.append(jbank.BankAccountUpdated(str(i), bal))
            logs.append([jbank.encode_event(vocab, e) for e in log])
        return logs
    gen = random_cart_log if family == "shopping_cart" else random_saga_log
    return [gen(rng, f"{family}-{i}") for i in range(n)]


# -- replay_encoded, replay_stream: B-chunks, windows, the ladder ---------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_b_chunked_windows_match_the_reference(backend):
    """tests/test_replay_scale.py:54 — batch-size below B, time-chunk below T:
    the same states and the same count of window programs."""
    logs = random_counter_logs(100, 15, seed=22)
    ov = {"surge.replay.batch-size": 16, "surge.replay.time-chunk": 8}
    eng, jeng = _engines(counter, jcounter, ov, backend)
    assert eng.batch_size == jeng.batch_size == 16
    got = eng.replay_encoded(encode_events(counter.make_registry(),
                                           _port_logs(counter, logs)))
    want = jeng.replay_encoded(jencode_events(jcounter.make_registry(), logs))
    _same(got.states, want.states)
    assert (got.num_events, got.padded_events) == (want.num_events, want.padded_events)
    assert eng.num_compiles() == jeng.num_compiles() == 1
    assert eng.stats["windows"] == jeng.stats["windows"]


@pytest.mark.parametrize("min_window", [8, 0])
@pytest.mark.parametrize("backend", BACKENDS)
def test_stream_windows_follow_the_ladder(backend, min_window):
    """tests/test_replay_scale.py:70 — ragged stream chunk widths map onto
    the ladder's programs (or one full-chunk program with the ladder off)."""
    logs = random_counter_logs(8, 33, seed=23)
    ov = {"surge.replay.time-chunk": 16, "surge.replay.min-time-window": min_window}
    eng, jeng = _engines(counter, jcounter, ov, backend)

    def chunks(encode, reg, lg):
        t = max(len(l) for l in lg)
        bounds = [0, 13]
        while bounds[-1] < t:
            bounds.append(min(bounds[-1] + 7, t))
        for s, e in zip(bounds, bounds[1:]):
            yield encode(reg, [l[s:e] for l in lg], pad_to=e - s)

    got = eng.replay_stream(chunks(encode_events, counter.make_registry(),
                                   _port_logs(counter, logs)), batch=8)
    want = jeng.replay_stream(chunks(jencode_events, jcounter.make_registry(), logs),
                              batch=8)
    _same(got.states, want.states)
    assert eng.num_compiles() == jeng.num_compiles() <= (2 if min_window else 1)


@pytest.mark.parametrize("backend", BACKENDS + ["assoc"])
def test_caller_carry_is_never_written(backend):
    """tests/test_replay_scale.py:107 — an init_carry of exactly the lane
    multiple is copied, never folded in place."""
    logs = random_counter_logs(8, 10, seed=24)
    eng, jeng = _engines(counter, jcounter, {}, backend)
    carry = {"count": np.full(8, 5, dtype=np.int32),
             "version": np.zeros(8, dtype=np.int32)}
    enc = encode_events(counter.make_registry(), _port_logs(counter, logs))
    r1 = eng.replay_encoded(enc, init_carry=carry)
    r2 = eng.replay_encoded(enc, init_carry=carry)
    _same(r1.states, r2.states)
    assert np.array_equal(carry["count"], np.full(8, 5))
    want = jeng.replay_encoded(jencode_events(jcounter.make_registry(), logs),
                               init_carry=carry)
    _same(r1.states, want.states)


@pytest.mark.parametrize("backend", BACKENDS)
def test_out_of_range_type_ids_fold_to_nothing(backend):
    """tests/test_replay_scale.py:125 and a mid-log variant: a corrupt id
    between real events carries the state through and does not end the
    lane, so the derived ordinals after it still count its slot."""
    b = 24
    tids = np.tile(np.array([0, 99, 0, -5, 1, 0], dtype=np.int32), b)
    n = tids.size
    col = ColumnarEvents(
        num_aggregates=b, agg_idx=np.repeat(np.arange(b, dtype=np.int32), 6),
        type_ids=tids,
        cols={"increment_by": np.ones(n, dtype=np.int32),
              "decrement_by": np.ones(n, dtype=np.int32)},
        derived_cols={"sequence_number": "ordinal"})
    eng, jeng = _engines(counter, jcounter, {"surge.replay.time-chunk": 8}, backend)
    got = eng.replay_columnar(col)
    want = jeng.replay_columnar(_jax_col(col))
    _same(got.states, want.states)
    assert (got.states["count"] == 2).all() and (got.states["version"] == 6).all()


# -- replay_columnar: length-sorted B-chunks ----------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_columnar_skewed_and_sorted_chunks(backend):
    """tests/test_replay_scale.py:161 and :188 — one long log inflates only
    its own chunk; length-sorted chunks with the tail ladder, and unsorted
    full-pad windows, give the reference's states and padding."""
    rng = np.random.default_rng(7)
    b = 256
    lens = np.where(rng.random(b) < 0.9, rng.integers(1, 12, size=b),
                    rng.integers(200, 400, size=b)).astype(np.int64)
    lens[3] = 700
    agg_idx = np.repeat(np.arange(b, dtype=np.int32), lens)
    n = agg_idx.size
    tids = rng.integers(0, 2, size=n).astype(np.int32)
    cols = {"increment_by": np.where(tids == 0, rng.integers(1, 4, size=n), 0).astype(np.int32),
            "decrement_by": (tids == 1).astype(np.int32),
            "sequence_number": np.ones(n, dtype=np.int32)}
    col = ColumnarEvents(b, agg_idx, tids, cols)
    for ov in ({"surge.replay.batch-size": 32, "surge.replay.time-chunk": 64},
               {"surge.replay.batch-size": 32, "surge.replay.time-chunk": 64,
                "surge.replay.sort-by-length": False,
                "surge.replay.min-time-window": 0}):
        eng, jeng = _engines(counter, jcounter, ov, backend)
        got = eng.replay_columnar(col)
        want = jeng.replay_columnar(_jax_col(col))
        _same(got.states, want.states)
        assert got.padded_events == want.padded_events
        assert eng.num_compiles() == jeng.num_compiles()


@pytest.mark.parametrize("backend", BACKENDS + ["assoc"])
def test_resume_continues_derived_ordinals(backend):
    """tests/test_replay_scale.py:594 — the second half of every log from the
    first half's states and event counts equals the whole fold."""
    c = synth_counter_corpus(64, 4000, seed=11)
    ev = c.events
    starts = np.zeros(c.num_aggregates + 1, dtype=np.int64)
    np.cumsum(c.lengths, out=starts[1:])
    first_len = c.lengths // 2
    keep = np.zeros(c.num_events, dtype=bool)
    for i in range(c.num_aggregates):
        keep[starts[i]: starts[i] + first_len[i]] = True

    def subset(mask):
        return dataclasses.replace(ev, agg_idx=ev.agg_idx[mask],
                                   type_ids=ev.type_ids[mask],
                                   cols={k: v[mask] for k, v in ev.cols.items()})

    eng, jeng = _engines(counter, jcounter, {}, backend)
    r1 = eng.replay_columnar(subset(keep))
    r2 = eng.replay_columnar(subset(~keep), init_carry=r1.states,
                             ordinal_base=first_len.astype(np.int32))
    assert np.array_equal(r2.states["count"], c.expected_count)
    assert np.array_equal(r2.states["version"], c.expected_version)
    j1 = jeng.replay_columnar(_jax_col(subset(keep)))
    j2 = jeng.replay_columnar(_jax_col(subset(~keep)), init_carry=j1.states,
                              ordinal_base=first_len.astype(np.int32))
    _same(r2.states, j2.states)


@pytest.mark.parametrize("backend", BACKENDS)
def test_ordinal_base_past_two_to_the_twenty(backend):
    """Derived ordinals from a resume base past 2^20, through replay_stream's
    cumulative offset: every version is the base plus its position."""
    logs = random_counter_logs(24, 40, seed=5)
    base = (np.arange(24, dtype=np.int32) + (1 << 20) + 3)
    ov = {"surge.replay.time-chunk": 16}
    eng, jeng = _engines(counter, jcounter, ov, backend)
    t = max(len(l) for l in logs)

    def chunks(encode, reg, lg):
        for s in range(0, t, 16):
            e = min(s + 16, t)
            enc = encode(reg, [l[s:e] for l in lg], pad_to=e - s)
            enc.cols.pop("sequence_number")
            enc.derived_cols = {"sequence_number": "ordinal"}
            yield enc

    got = eng.replay_stream(chunks(encode_events, counter.make_registry(),
                                   _port_logs(counter, logs)), batch=24,
                            ordinal_base=base)
    want = jeng.replay_stream(chunks(jencode_events, jcounter.make_registry(), logs),
                              batch=24, ordinal_base=base)
    _same(got.states, want.states)
    assert (got.states["version"][got.states["version"] > 0] > (1 << 20)).all()


# -- all four families on replay_columnar and replay_ragged --------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_families_columnar_match_the_reference(family, backend):
    pmod, jmod = FAMILIES[family]
    jcol = jencode_columnar(jmod.make_registry(), _family_logs(family, 150, seed=31))
    ov = {"surge.replay.batch-size": 64, "surge.replay.time-chunk": 8}
    eng, jeng = _engines(pmod, jmod, ov, backend)
    got = eng.replay_columnar(_port_col(jcol))
    want = jeng.replay_columnar(jcol)
    _same(got.states, want.states)
    assert got.num_events == want.num_events == jcol.num_events


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_families_ragged_match_the_reference(family, backend):
    """tests/test_replay_golden.py:159 — length buckets, every family."""
    pmod, jmod = FAMILIES[family]
    logs = _family_logs(family, 53, seed=5)
    ov = {"surge.replay.length-buckets": "4,8,16,32", "surge.replay.time-chunk": 16}
    eng, jeng = _engines(pmod, jmod, ov, backend)
    got = eng.replay_ragged(_port_logs(pmod, logs))
    want = jeng.replay_ragged(logs)
    _same(got.states, want.states)
    assert (got.num_aggregates, got.num_events, got.padded_events) == \
        (want.num_aggregates, want.num_events, want.padded_events)


# -- the golden tests of tests/test_replay_golden.py ----------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("chunk", [512, 7])
def test_counter_golden_windows(backend, chunk):
    """tests/test_replay_golden.py:45 and :61 — one window, and time-chunk 7."""
    logs = random_counter_logs(37, 50, seed=1)
    eng, jeng = _engines(counter, jcounter, {"surge.replay.time-chunk": chunk},
                         backend)
    got = eng.replay_encoded(encode_events(counter.make_registry(),
                                           _port_logs(counter, logs)))
    want = jeng.replay_encoded(jencode_events(jcounter.make_registry(), logs))
    _same(got.states, want.states)


@pytest.mark.parametrize("backend", BACKENDS)
def test_bank_account_golden_with_vocab(backend):
    """tests/test_replay_golden.py:74 — float side columns, and orphan
    updates that must leave an account uncreated."""
    rng = random.Random(3)
    vocab = jbank.Vocab()
    logs = []
    for i in range(25):
        if rng.random() < 0.8:
            log = [jbank.BankAccountCreated(str(i), f"owner{i}", f"sec{i}", 100.0)]
            bal = 100.0
            for _ in range(rng.randrange(6)):
                bal += rng.randrange(1, 40) * 0.25
                log.append(jbank.BankAccountUpdated(str(i), bal))
        else:
            log = [jbank.BankAccountUpdated(str(i), 42.0)]
        logs.append([jbank.encode_event(vocab, e) for e in log])
    eng, jeng = _engines(bank_account, jbank, {}, backend)
    got = eng.replay_encoded(encode_events(bank_account.make_registry(),
                                           _port_logs(bank_account, logs)))
    want = jeng.replay_encoded(jencode_events(jbank.make_registry(), logs))
    _same(got.states, want.states)
    assert not got.states["created"].all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_resume_from_snapshot_carry(backend):
    """tests/test_replay_golden.py:334 — decode the first half's states,
    re-encode them as the carry (carry_from_states), fold the rest."""
    logs = random_counter_logs(10, 20, seed=11)
    half = [l[:len(l) // 2] for l in logs]
    rest = [l[len(l) // 2:] for l in logs]
    eng, jeng = _engines(counter, jcounter, {}, backend)
    reg = counter.make_registry()
    r1 = eng.replay_encoded(encode_events(reg, _port_logs(counter, half)))
    carry = eng.carry_from_states(decode_states(reg.state, r1.states))
    got = eng.replay_encoded(encode_events(reg, _port_logs(counter, rest)),
                             init_carry=carry)
    jreg = jcounter.make_registry()
    j1 = jeng.replay_encoded(jencode_events(jreg, half))
    jcarry = jeng.carry_from_states(jdecode_states(jreg.state, j1.states))
    want = jeng.replay_encoded(jencode_events(jreg, rest), init_carry=jcarry)
    _same(got.states, want.states)
    whole = eng.replay_encoded(encode_events(reg, _port_logs(counter, logs)))
    _same(got.states, whole.states)


def test_columnar_chunks_carry_aggregate_ids():
    """replay_columnar_chunks concatenates disjoint chunks and their ids."""
    jcol = jencode_columnar(jcounter.make_registry(), random_counter_logs(30, 9, seed=4))
    jcol.aggregate_ids = [f"a{i}" for i in range(30)]
    chunks = [_port_col(jcol).sorted_by_aggregate().slice_aggregates(s, min(s + 8, 30))
              for s in range(0, 30, 8)]
    eng, jeng = _engines(counter, jcounter, {"surge.replay.batch-size": 8})
    got = eng.replay_columnar_chunks(chunks)
    want = jeng.replay_columnar_chunks(_jax_col(c) for c in chunks)
    _same(got.states, want.states)
    assert got.aggregate_ids == want.aggregate_ids == jcol.aggregate_ids
    empty = eng.replay_columnar_chunks([])
    assert (empty.num_aggregates, empty.aggregate_ids) == (0, [])


@pytest.mark.parametrize("bs", [8, 24])
def test_window_kernel_plain_version_equals_the_scan(bs):
    """The one-tile list fold each non-resident window makes (its plain
    version on the CPU) against the plain scan, on a window with padding
    lanes, a mid-log pad and a derived ordinal past 2^20."""
    spec = counter.make_replay_spec()
    logs = _port_logs(counter, random_counter_logs(bs - 3, 30, seed=bs))
    enc = encode_events(spec.registry, logs, pad_to=32)
    enc.type_ids[::2, 4] = 7  # out of range, mid-log
    outs = {}
    for backend in ("xla", "pallas"):
        eng = ReplayEngine(spec, Config(overrides={
            "surge.replay.tile-backend": backend, "surge.replay.time-chunk": 32}),
            device="cpu")
        fold_kernels.LAUNCHES["tile_fold_list"] = 0
        outs[backend] = eng.replay_encoded(
            enc, ordinal_base=np.full(bs - 3, (1 << 20) + 1, np.int32)).states
        assert fold_kernels.LAUNCHES["tile_fold_list"] == 0  # CPU: no launch
    _same(outs["pallas"], outs["xla"])


# -- replay_resident_streamed ---------------------------------------------------------


@pytest.fixture(scope="module")
def streamed_corpus():
    return synth_counter_corpus(3100, 130_000, seed=19), jsynth(3100, 130_000, seed=19)


STREAM_OV = {"surge.replay.batch-size": 256, "surge.replay.time-chunk": 32}


@pytest.mark.parametrize("segments", [1, 2, 3, 7])
def test_streamed_matches_plain_and_the_reference(streamed_corpus, segments):
    """tests/test_replay_scale.py:315 — every segment count gives the plain
    resident replay's states and the reference's streamed states."""
    c, jc = streamed_corpus
    eng, jeng = _engines(counter, jcounter, STREAM_OV, "pallas")
    wire = eng.pack_resident(c.events)
    plain = eng.replay_resident(eng.upload_resident(wire))
    got = eng.replay_resident_streamed(wire, segments=segments)
    _same(got.states, plain.states)
    want = jeng.replay_resident_streamed(jeng.pack_resident(jc.events),
                                         segments=segments)
    _same(got.states, want.states)
    assert got.padded_events == want.padded_events
    assert np.array_equal(got.states["count"], c.expected_count)


def test_streamed_resume_and_default_segments(streamed_corpus):
    """tests/test_replay_scale.py:337 — resume mid-log through the streamed
    path; the segment count defaults to the config key."""
    c, _ = streamed_corpus
    ev = c.events
    half = np.arange(ev.num_events) < ev.num_events // 2

    def subset(mask):
        return dataclasses.replace(ev, agg_idx=ev.agg_idx[mask],
                                   type_ids=ev.type_ids[mask],
                                   cols={k: v[mask] for k, v in ev.cols.items()})

    eng = ReplayEngine(counter.make_replay_spec(), Config(overrides=dict(
        STREAM_OV, **{"surge.replay.upload-stream-segments": 3})), device="cpu")
    r1 = eng.replay_resident_streamed(eng.pack_resident(subset(half)))
    counts1 = np.bincount(ev.agg_idx[half], minlength=ev.num_aggregates)
    real = tengine.ReplayEngine.upload_resident
    with mock.patch.object(tengine.ReplayEngine, "upload_resident", autospec=True,
                           side_effect=real) as up:
        r2 = eng.replay_resident_streamed(eng.pack_resident(subset(~half)),
                                          init_carry=r1.states,
                                          ordinal_base=counts1.astype(np.int32))
    assert up.call_count == 3
    assert np.array_equal(r2.states["count"], c.expected_count)
    assert np.array_equal(r2.states["version"], c.expected_version)


@pytest.mark.parametrize("segments", [2, 5])
def test_streamed_indirect_wire(segments):
    """tests/test_replay_scale.py:686 — a grouped-input wire (lanes point at
    their slabs by indirection) streams exactly."""
    c = synth_counter_corpus(900, 40_000, seed=77)
    ov = dict(STREAM_OV, **{"surge.replay.batch-size": 128,
                            "surge.replay.resident-len-bucket": "exact"})
    eng, jeng = _engines(counter, jcounter, ov)
    wire = eng.pack_resident(c.events)
    cum = np.zeros(wire.lengths.shape[0], dtype=np.int64)
    np.cumsum(wire.lengths[:-1].astype(np.int64), out=cum[1:])
    assert wire.perm is not None and not np.array_equal(wire.starts, cum)
    got = eng.replay_resident_streamed(wire, segments=segments)
    assert np.array_equal(got.states["count"], c.expected_count)
    want = jeng.replay_resident_streamed(
        jeng.pack_resident(jsynth(900, 40_000, seed=77).events), segments=segments)
    _same(got.states, want.states)


@pytest.mark.parametrize("segments", [2, 4])
def test_streamed_indirect_wire_with_empty_aggregates(segments):
    """tests/test_replay_scale.py:718 — zero-length lanes occupy no rows: the
    indirect path still streams (one upload a piece) and returns their
    init state."""
    rng = np.random.default_rng(5)
    b, n = 60, 6000
    live = np.array([a for a in range(b) if a not in (7, 23, 40)])
    agg_idx = np.sort(rng.choice(live, size=n)).astype(np.int32)
    tids = rng.integers(0, 2, size=n).astype(np.int32)
    col = ColumnarEvents(
        num_aggregates=b, agg_idx=agg_idx, type_ids=tids,
        cols={"increment_by": (tids == 0).astype(np.int32),
              "decrement_by": (tids == 1).astype(np.int32)},
        derived_cols={"sequence_number": "ordinal"})
    ov = {"surge.replay.batch-size": 16, "surge.replay.time-chunk": 16,
          "surge.replay.resident-len-bucket": "exact"}
    eng, jeng = _engines(counter, jcounter, ov, "pallas")
    wire = eng.pack_resident(col)
    assert int((wire.lengths == 0).sum()) == 3
    real = tengine.ReplayEngine.upload_resident
    with mock.patch.object(tengine.ReplayEngine, "upload_resident", autospec=True,
                           side_effect=real) as up:
        got = eng.replay_resident_streamed(wire, segments=segments)
    assert up.call_count == segments
    want = jeng.replay_resident_streamed(jeng.pack_resident(_jax_col(col)),
                                         segments=segments)
    _same(got.states, want.states)
    assert (got.states["count"][[7, 23, 40]] == 0).all()


def test_streamed_wire_that_does_not_tile_falls_back():
    """A wire whose slabs overlap is replayed by one upload, as the
    reference does."""
    c = synth_counter_corpus(200, 4000, seed=3)
    eng, jeng = _engines(counter, jcounter, {"surge.replay.batch-size": 64})
    wire = eng.pack_resident(c.events)
    forged = dataclasses.replace(wire, starts=np.zeros_like(wire.starts))
    real = tengine.ReplayEngine.upload_resident
    with mock.patch.object(tengine.ReplayEngine, "upload_resident", autospec=True,
                           side_effect=real) as up:
        got = eng.replay_resident_streamed(forged, segments=4)
    assert up.call_count == 1
    jwire = jeng.pack_resident(jsynth(200, 4000, seed=3).events)
    want = jeng.replay_resident_streamed(
        dataclasses.replace(jwire, starts=np.zeros_like(jwire.starts)), segments=4)
    _same(got.states, want.states)


def test_upload_stream_needs_a_cuda_engine():
    eng = ReplayEngine(counter.make_replay_spec(), device="cpu")
    wire = eng.pack_resident(synth_counter_corpus(10, 50, seed=1).events)
    with pytest.raises(ValueError, match="CUDA"):
        eng.upload_resident(wire, stream=object())
