"""The port's scan engine (surge_tpu_torch.replay.query on the CPU) against the
reference's (surge_tpu.replay.query, ``mesh=None``): one seeded input goes to
both and every output column must be equal byte for byte, float sums
included. The cases follow tests/test_query_engine.py, plus the corners the
port's reduction has to match: a predicate value that float32 rounds
(2**24 + 1 against an int32 column), NaN in min and max, a float sum under
``group_by`` (the port's stable group sort), and the plain reduction held to
the port's numpy ``scan_reference``."""

import random

import numpy as np
import pytest
import torch

from surge_tpu.codec.tensor import ColumnarEvents as JColumnarEvents
from surge_tpu.codec.tensor import encode_events_columnar as jencode_columnar
from surge_tpu.config import Config as JConfig
from surge_tpu.log import segment as jseg
from surge_tpu.log.columnar import ColumnarSegmentWriter as JSegmentWriter
from surge_tpu.models import bank_account as jbank
from surge_tpu.models import counter as jcounter
from surge_tpu.replay import ReplayEngine as JReplayEngine
from surge_tpu.replay import query as jq
from surge_tpu_torch.codec.tensor import ColumnarEvents
from surge_tpu_torch.config import Config
from surge_tpu_torch.log.columnar import read_segment
from surge_tpu_torch.models import bank_account, counter
from surge_tpu_torch.replay import query as tq
from surge_tpu_torch.replay.engine import ReplayEngine
from surge_tpu_torch.replay.scan_reduce import (group_csr, scan_reduce,
                                                scan_reduce_reference)
from tests.test_query_engine import (OR_GROUP_QUERIES, QUERIES, chunked_colev,
                                     counter_logs)
from tests.test_torch_isolation import leave_the_worker_as_found  # noqa: F401

CFG = {"surge.query.chunk-events": 1024}
JSPEC, SPEC = jcounter.make_replay_spec(), counter.make_replay_spec()


@pytest.fixture(autouse=True)
def raw_reference_segments(monkeypatch):
    """The reference writes raw payloads (the port reads no SLZ codec)."""
    monkeypatch.setattr(jseg, "slz_compress", lambda data: None)


def port_chunk(c) -> ColumnarEvents:
    return ColumnarEvents(num_aggregates=c.num_aggregates, agg_idx=c.agg_idx,
                          type_ids=c.type_ids, cols=dict(c.cols),
                          derived_cols=dict(c.derived_cols),
                          aggregate_ids=c.aggregate_ids)


def port_query(q):
    return tq.ScanQuery.from_json(q.as_json())


def engines(jspec=JSPEC, spec=SPEC):
    return (jq.QueryEngine(jspec, config=JConfig(CFG)),
            tq.QueryEngine(spec, config=Config(overrides=CFG), device="cpu"))


def assert_same(got, want, ordered=True):
    """Equal ids, counts and column bytes; ``ordered`` also holds the column
    order (the engines return theirs sorted, the numpy oracles in query
    order)."""
    assert got.aggregate_ids == want.aggregate_ids
    assert got.num_aggregates == want.num_aggregates
    assert got.matched_events == want.matched_events
    if ordered:
        assert list(got.columns) == list(want.columns)
    assert set(got.columns) == set(want.columns)
    for name, w in want.columns.items():
        w = np.asarray(w)
        assert got.columns[name].dtype == w.dtype, name
        assert got.columns[name].tobytes() == w.tobytes(), name


def scan_both(chunks, q, jspec=JSPEC, spec=SPEC):
    jeng, teng = engines(jspec, spec)
    want = jeng.scan_chunks(chunks, q)
    got = teng.scan_chunks([port_chunk(c) for c in chunks], port_query(q))
    assert_same(got, want)
    return got


def numpy_chunk(rng, n_aggs, max_len, cols):
    """A seeded columnar chunk: ragged logs of random types, the union columns
    from ``cols(n) -> {name: array}``, aggregate ids attached."""
    lens = rng.integers(0, max_len + 1, size=n_aggs)
    n = int(lens.sum())
    agg_idx = np.repeat(np.arange(n_aggs, dtype=np.int32), lens)
    arrays = dict(num_aggregates=n_aggs, agg_idx=agg_idx,
                  type_ids=rng.integers(0, 3, size=n).astype(np.int32),
                  cols=cols(n))
    ids = [f"agg-{i}" for i in range(n_aggs)]
    return (JColumnarEvents(**arrays, aggregate_ids=ids),
            ColumnarEvents(**arrays, aggregate_ids=ids))


# -- scans (tests/test_query_engine.py) -------------------------------------------------


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_scan_chunks_equals_reference(qi):
    logs = counter_logs(213, 23, seed=qi + 1)
    got = scan_both(chunked_colev(logs, 64), QUERIES[qi])
    assert got.num_aggregates == 213
    want = tq.scan_reference([port_chunk(c) for c in chunked_colev(logs, 64)],
                             port_query(QUERIES[qi]), SPEC.registry)
    assert_same(got, want, ordered=False)


@pytest.mark.parametrize("qi", range(len(OR_GROUP_QUERIES)))
def test_or_groups_equal_reference(qi):
    logs = counter_logs(143, 21, seed=31 + qi)
    scan_both(chunked_colev(logs, 48), OR_GROUP_QUERIES[qi])


@pytest.mark.parametrize("op", ["<", ">=", "==", "!="])
def test_fractional_predicate_on_integer_column(op):
    logs = counter_logs(40, 9, seed=21)
    q = jq.ScanQuery(aggregates=(jq.Aggregate("count"),),
                     predicates=(jq.Predicate("increment_by", op, 2.5),))
    scan_both(chunked_colev(logs, 40), q)


def test_aggregate_over_type_id_pseudo_column():
    logs = counter_logs(30, 11, seed=23)
    q = jq.ScanQuery(aggregates=(jq.Aggregate("count"),
                                 jq.Aggregate("max", "type_id")))
    assert port_query(q).columns_needed() == []
    scan_both(chunked_colev(logs, 30), q)


@pytest.mark.parametrize("which", ["increment_by", "type_id"])
def test_group_by_event_column_equals_reference(which):
    logs = counter_logs(97, 17, seed=41)
    if which == "increment_by":
        q = jq.ScanQuery(aggregates=(jq.Aggregate("count"),
                                     jq.Aggregate("sum", "sequence_number"),
                                     jq.Aggregate("max", "sequence_number")),
                         group_by="increment_by",
                         event_types=("CountIncremented", "CountDecremented"))
    else:
        q = jq.ScanQuery(aggregates=(jq.Aggregate("count"),), group_by="type_id")
    got = scan_both(chunked_colev(logs, 32), q)
    if which == "increment_by":
        assert sorted(got.aggregate_ids) == ["0", "1", "2", "3"]
    else:
        assert int(got.columns["count"].sum()) == sum(len(lg) for lg in logs)


def test_bank_account_float_columns_scan():
    vocab = jbank.Vocab()
    rng = random.Random(5)
    enc_logs = []
    for i in range(66):
        log = [jbank.BankAccountCreated(str(i), f"o{i}", "s", 100.0)]
        bal = 100.0
        for _ in range(rng.randrange(0, 9)):
            bal += rng.randrange(1, 30) * 0.25
            log.append(jbank.BankAccountUpdated(str(i), bal))
        enc_logs.append([jbank.encode_event(vocab, e) for e in log])
    jspec = jbank.make_replay_spec()
    colev = jencode_columnar(jspec.registry, enc_logs)
    colev.aggregate_ids = [str(i) for i in range(66)]
    q = jq.ScanQuery(aggregates=(jq.Aggregate("count"),
                                 jq.Aggregate("max", "new_balance"),
                                 jq.Aggregate("min", "new_balance"),
                                 jq.Aggregate("sum", "new_balance")),
                     event_types=("EncodedUpdated",))
    scan_both([colev], q, jspec, bank_account.make_replay_spec())


def test_scan_segment_projection_pushdown(tmp_path):
    logs = counter_logs(130, 17, seed=11)
    path = str(tmp_path / "events.scol")
    with JSegmentWriter(path) as w:
        for colev in chunked_colev(logs, 48):
            w.append(colev)
    q = jq.ScanQuery(aggregates=(jq.Aggregate("count"),
                                 jq.Aggregate("sum", "increment_by")),
                     predicates=(jq.Predicate("increment_by", ">", 1),))
    for colev in read_segment(path, columns=q.columns_needed()):
        assert sorted(colev.cols) == ["increment_by"]
    jeng, teng = engines()
    assert_same(teng.scan_segment(path, port_query(q)), jeng.scan_segment(path, q))
    assert teng.stats == jeng.stats
    assert len(teng._programs) == len(jeng._programs)


def test_scan_merges_extended_segment_delta_chunks(tmp_path):
    """Delta chunks repeat base-chunk aggregates: the scan merges them into
    one row per id, and the state query folds them as continuations."""
    from surge_tpu.log import InMemoryLog, LogRecord, TopicSpec
    from surge_tpu.log.columnar import (build_segment_from_topic,
                                        extend_segment_from_topic)

    evt = jcounter.event_formatting()
    log = InMemoryLog()
    log.create_topic(TopicSpec("ev", 1))

    def publish(agg, events):
        prod = log.transactional_producer("t")
        prod.begin()
        for e in events:
            prod.send(LogRecord(topic="ev", key=agg,
                                value=evt.write_event(e).value, partition=0))
        prod.commit()

    publish("a", [jcounter.CountIncremented("a", 2, 1),
                  jcounter.CountIncremented("a", 3, 2)])
    publish("b", [jcounter.CountIncremented("b", 1, 1)])
    path = str(tmp_path / "seg.scol")
    deser = lambda m: evt.read_event(m)  # noqa: E731
    build_segment_from_topic(log, "ev", JSPEC.registry, deser, path)
    publish("a", [jcounter.CountIncremented("a", 3, 3)])
    publish("c", [jcounter.CountIncremented("c", 1, 1)])
    extend_segment_from_topic(log, "ev", JSPEC.registry, deser, path)

    q = jq.ScanQuery(aggregates=(jq.Aggregate("count"),
                                 jq.Aggregate("sum", "increment_by"),
                                 jq.Aggregate("min", "increment_by"),
                                 jq.Aggregate("max", "increment_by")))
    jeng, teng = engines()
    got = teng.scan_segment(path, port_query(q))
    assert_same(got, jeng.scan_segment(path, q))
    assert len(got.aggregate_ids) == len(set(got.aggregate_ids)) == 3

    rcfg = {"surge.replay.batch-size": 16, "surge.replay.time-chunk": 8}
    sq = jq.StateQuery(select=("count", "version"))
    want = jeng.query_states_segment(path, sq, JReplayEngine(
        JSPEC, config=JConfig(rcfg)))
    got = teng.query_states_segment(
        path, tq.StateQuery.from_json(sq.as_json()),
        ReplayEngine(SPEC, config=Config(overrides=rcfg), device="cpu"))
    assert_same(got, want)
    rows = {a: (int(got.columns["count"][j]), int(got.columns["version"][j]))
            for j, a in enumerate(got.aggregate_ids)}
    assert rows == {"a": (8, 3), "b": (1, 1), "c": (1, 1)}


def test_query_states_fold_filter_project():
    logs = counter_logs(97, 19, seed=13)
    q = jq.StateQuery(select=("count",),
                      predicates=(jq.Predicate("count", ">=", 2),
                                  jq.Predicate("version", "<", 15)),
                      limit=50)
    rcfg = {"surge.replay.batch-size": 32, "surge.replay.time-chunk": 8}
    jeng, teng = engines()
    want = jeng.query_states(chunked_colev(logs, 40), q,
                             JReplayEngine(JSPEC, config=JConfig(rcfg)))
    got = teng.query_states(
        [port_chunk(c) for c in chunked_colev(logs, 40)],
        tq.StateQuery.from_json(q.as_json()),
        ReplayEngine(SPEC, config=Config(overrides=rcfg), device="cpu"))
    assert_same(got, want)
    assert list(got.columns) == ["count"]


def test_query_json_round_trip():
    for q in (QUERIES[2], OR_GROUP_QUERIES[1],
              jq.ScanQuery(aggregates=(jq.Aggregate("count"),),
                           group_by="increment_by")):
        pq = port_query(q)
        assert tq.ScanQuery.from_json(pq.as_json()) == pq
        assert pq.as_json() == q.as_json()
        assert pq.signature() == q.signature()
        assert pq.columns_needed() == q.columns_needed()
    sq = tq.StateQuery(select=("count",), predicates=(
        tq.Predicate("count", ">", 1),), limit=7)
    assert tq.StateQuery.from_json(sq.as_json()) == sq
    with pytest.raises(ValueError):
        tq.ScanQuery(aggregates=(tq.Aggregate("count"),), or_groups=((),))
    with pytest.raises(ValueError):
        tq.Predicate("c", "~", 1)
    with pytest.raises(ValueError):
        tq.Aggregate("sum")
    _, teng = engines()
    with pytest.raises(ValueError):
        teng.resolve_type_ids(["NoSuchEvent"])


def test_query_engine_device_and_mesh():
    with pytest.raises(NotImplementedError, match="Multi-device"):
        tq.QueryEngine(SPEC, mesh=object(), device="cpu")
    # surge.query.mesh = false scans single-device whatever mesh is given
    eng = tq.QueryEngine(SPEC, config=Config(overrides={"surge.query.mesh": False}),
                         mesh=object(), device="cpu")
    assert eng.mesh is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tq.QueryEngine(SPEC)


# -- the corners of the port's reduction --------------------------------------------


def counter_cols(rng, big: bool):
    def cols(n):
        hi = (1 << 25) if big else 4
        return {"increment_by": rng.integers(0, hi, size=n).astype(np.int32),
                "decrement_by": rng.integers(0, 3, size=n).astype(np.int32),
                "sequence_number": rng.integers(1, 50, size=n).astype(np.int32)}
    return cols


@pytest.mark.parametrize("op", ["==", "<", ">=", "!="])
def test_predicate_value_rounds_through_float32(op):
    """2**24 + 1 reaches the device as float32 (2**24) in the reference's
    program; the port compares the same way."""
    rng = np.random.default_rng(7)
    j, _ = numpy_chunk(rng, 40, 30, counter_cols(rng, big=True))
    j.cols["increment_by"][::7] = (1 << 24) + 1
    j.cols["increment_by"][3::7] = 1 << 24
    q = jq.ScanQuery(aggregates=(jq.Aggregate("count"),
                                 jq.Aggregate("sum", "increment_by")),
                     predicates=(jq.Predicate("increment_by", op, (1 << 24) + 1),))
    got = scan_both([j], q)
    if op == "==":  # 2**24 + 1 compares as 2**24, the numpy oracle's exact
        assert got.matched_events == int((j.cols["increment_by"] == 1 << 24).sum())


def bank_cols(rng, nan: bool):
    def cols(n):
        bal = rng.standard_normal(n).astype(np.float32) * 1000
        new = rng.standard_normal(n).astype(np.float32) * 1e4
        if nan:
            new[rng.integers(0, n, size=max(n // 20, 1))] = np.nan
        return {"balance": bal, "new_balance": new,
                "owner_code": rng.integers(0, 5, size=n).astype(np.int32),
                "security_code_code": rng.integers(0, 5, size=n).astype(np.int32)}
    return cols


FLOAT_QUERY = jq.ScanQuery(aggregates=(jq.Aggregate("count"),
                                       jq.Aggregate("sum", "new_balance"),
                                       jq.Aggregate("min", "new_balance"),
                                       jq.Aggregate("max", "new_balance"),
                                       jq.Aggregate("sum", "balance")),
                           predicates=(jq.Predicate("balance", ">", -500.5),))


@pytest.mark.parametrize("case", ["nan", "group_by_float_sum", "float_sums"])
def test_float_reductions_in_event_order(case):
    rng = np.random.default_rng({"nan": 1, "group_by_float_sum": 2,
                                 "float_sums": 3}[case])
    chunks = [numpy_chunk(rng, 50, 60, bank_cols(rng, nan=case == "nan"))[0]
              for _ in range(2)]
    q = FLOAT_QUERY
    if case == "group_by_float_sum":
        q = jq.ScanQuery(aggregates=FLOAT_QUERY.aggregates, group_by="owner_code")
    got = scan_both(chunks, q, jbank.make_replay_spec(),
                    bank_account.make_replay_spec())
    if case == "nan":
        assert np.isnan(got.columns["min_new_balance"]).any()


def test_plain_reduce_equals_scan_reference():
    """The plain reduction behind QueryEngine holds to the port's numpy
    oracle, and walks a group order that is not the identity (a stable sort
    of shuffled groups) exactly as an ordered one."""
    rng = np.random.default_rng(11)
    _, t = numpy_chunk(rng, 70, 40, bank_cols(rng, nan=False))
    q = tq.ScanQuery.from_json(FLOAT_QUERY.as_json())
    eng = tq.QueryEngine(bank_account.make_replay_spec(), config=Config(overrides=CFG),
                         device="cpu")
    assert_same(eng.scan_chunks([t], q),
                tq.scan_reference([t], q, bank_account.make_replay_spec().registry),
                ordered=False)
    groups = rng.integers(0, 9, size=t.num_events).astype(np.int32)
    mask = torch.from_numpy(rng.random(t.num_events) < 0.8)
    col = torch.from_numpy(t.cols["new_balance"])
    offsets, order = group_csr(groups, 9, torch.device("cpu"))
    assert order is not None
    count, (s,) = scan_reduce(mask, [col], ["sum"], offsets, order)
    want = np.zeros(9, np.float32)
    np.add.at(want, groups, np.where(mask.numpy(), t.cols["new_balance"], 0))
    assert s.numpy().tobytes() == want.tobytes()
    assert count.numpy().tolist() == np.bincount(groups[mask.numpy()],
                                                 minlength=9).tolist()
    # the twin's tiles do not change its result
    for tile in (1, 3, 16):
        count2, (s2,) = scan_reduce_reference(mask, [col], ["sum"], offsets, order,
                                              tile=tile)
        assert s2.numpy().tobytes() == s.numpy().tobytes()
        assert torch.equal(count2, count)


# -- on the card ------------------------------------------------------------------------


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the scan-reduce kernel has no CPU mode")
    return torch.device("cuda")


def card_groups(rng, case: str) -> tuple[np.ndarray, int]:
    """The group of each event: many small groups in event order or not,
    four large groups not in event order (a group_by), and one group of
    200,000 events among 20,000 small ones in event order. (The plain
    twin steps a float sum one position a call: these sizes keep it to
    seconds.)"""
    if case in ("grouped", "shuffled"):
        groups = rng.integers(0, 700, size=50_000)
        return (np.sort(groups) if case == "grouped" else groups).astype(np.int32), 700
    if case == "few_large":
        return rng.integers(0, 4, size=200_000).astype(np.int32), 4
    small = np.sort(rng.integers(0, 20_000, size=400_000))
    small[small >= 10_000] += 1
    return np.sort(np.concatenate([small, np.full(200_000, 10_000)])).astype(np.int32), 20_001


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["grouped", "shuffled", "few_large", "skewed"])
def test_scan_reduce_kernel_matches_plain_version_on_the_card(cuda_card, case):
    rng = np.random.default_rng(5)
    groups, g = card_groups(rng, case)
    n = groups.shape[0]
    fcol = rng.standard_normal(n).astype(np.float32)
    fcol[::97] = np.nan
    icol = rng.integers(-(1 << 30), 1 << 30, size=n).astype(np.int32)
    mask = rng.random(n) < 0.7
    ops = ["sum", "min", "max", "sum", "min", "max"]
    offsets, order = group_csr(groups, g, cuda_card)
    cols = [torch.from_numpy(c).to(cuda_card) for c in (fcol,) * 3 + (icol,) * 3]
    m = torch.from_numpy(mask).to(cuda_card)
    count, outs = scan_reduce(m, cols, ops, offsets, order)
    want_count, want = scan_reduce_reference(m, cols, ops, offsets, order)
    torch.cuda.synchronize()
    assert torch.equal(count, want_count)
    for k, (got_k, want_k) in enumerate(zip(outs, want)):
        assert got_k.cpu().numpy().tobytes() == want_k.cpu().numpy().tobytes(), k


@pytest.mark.parametrize("op", ["==", "<", ">", "!="])
def test_float_predicate_flushes_denormals_like_the_reference(op):
    """The reference compares on the CPU under denormals-are-zero: a
    denormal column value, or predicate value, compares as a zero of its
    sign; the port's mask does the same."""
    rng = np.random.default_rng(13)
    j, _ = numpy_chunk(rng, 30, 20, bank_cols(rng, nan=False))
    tiny = np.asarray([1, 0x80000001, 0x007FFFFF], np.uint32).view(np.float32)
    j.cols["new_balance"][::3] = tiny[rng.integers(0, 3, size=j.cols["new_balance"][::3].shape)]
    j.cols["new_balance"][1::5] = 0.0
    for value in (0.0, 1e-40):
        q = jq.ScanQuery(aggregates=(jq.Aggregate("count"),
                                     jq.Aggregate("sum", "balance")),
                         predicates=(jq.Predicate("new_balance", op, value),))
        scan_both([j], q, jbank.make_replay_spec(), bank_account.make_replay_spec())
