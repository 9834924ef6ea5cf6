"""The port's scan reduction (surge_tpu_torch.replay.scan_reduce) held to the
reference's CPU scatters (surge_tpu.replay.query, ``mesh=None``) byte for byte.

The twin (``scan_reduce_reference``) follows the kernel's decomposition:
tiles of span positions, per-(tile, group) partials combined in tile order,
and one chain per float sum. Run at tiny tile sizes, every group of a few
events crosses many tiles, so the ordered combine is exercised where the
card's tiles of 4,096 would rarely show it. The inputs are drawn by
hypothesis as a seed for numpy: NaNs with distinct payloads (quiet and
signalling, both signs), signed zeros, infinities, FLT_MAX, denormals and
results that flush to zero; INT_MIN, INT_MAX and wrapping sums; empty
groups, groups whose matched events all fall in a later tile, and groups in
event order (no ``order``) and not (``group_by``, a stable sort)."""

from functools import partial
from unittest import mock

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from surge_tpu.codec.tensor import ColumnarEvents as JColumnarEvents
from surge_tpu.config import Config as JConfig
from surge_tpu.models import bank_account as jbank
from surge_tpu.replay import query as jq
from surge_tpu_torch.codec.tensor import ColumnarEvents
from surge_tpu_torch.config import Config
from surge_tpu_torch.models import bank_account
from surge_tpu_torch.replay import query as tq
from surge_tpu_torch.replay import scan_reduce as sr
from tests.test_torch_isolation import leave_the_worker_as_found  # noqa: F401

F32 = np.float32
CFG = {"surge.query.chunk-events": 1024}
TILES = [1, 2, 3, 5, 16, sr.TILE]


def f32(*bits: int) -> np.ndarray:
    return np.asarray(bits, dtype=np.uint32).view(F32)


FLOAT_SPECIALS = np.concatenate([
    f32(0x7FC00001, 0xFFC00002, 0x7F800003, 0xFF800005, 0x7FFFFFFF),  # NaNs
    f32(0x00000001, 0x80000001, 0x007FFFFF),                          # denormals
    np.asarray([-0.0, 0.0, 1.0, -1.0, 2.5, np.inf, -np.inf,
                np.finfo(F32).max, np.finfo(F32).min, 1.5e-38, -1.6e-38,
                3e38, -3e38, 1e-7, 1.0000001], dtype=F32)])
INT_SPECIALS = np.asarray([0, 1, -1, 7, 1 << 30, 2**31 - 1, -2**31], dtype=np.int32)


@pytest.fixture(scope="module")
def engines():
    return (jq.QueryEngine(jbank.make_replay_spec(), config=JConfig(CFG)),
            tq.QueryEngine(bank_account.make_replay_spec(),
                           config=Config(overrides=CFG), device="cpu"))


def chunk(agg_idx, type_ids, cols, n_aggs):
    ids = [f"acct-{i}" for i in range(n_aggs)]
    arrays = dict(num_aggregates=n_aggs, agg_idx=np.asarray(agg_idx, np.int32),
                  type_ids=np.asarray(type_ids, np.int32), cols=cols)
    return (JColumnarEvents(**arrays, aggregate_ids=ids),
            ColumnarEvents(**arrays, aggregate_ids=ids))


def raw_scans(engines, jchunk, tchunk, query, tile):
    """Both engines' raw outputs for one chunk (min and max keep their
    sentinels), the port's twin cut into tiles of ``tile``."""
    jeng, teng = engines
    j_ids, j_out = jeng._raw_scan(jchunk, query)
    with mock.patch.object(sr, "scan_reduce_reference",
                           partial(sr.scan_reduce_reference, tile=tile)):
        t_ids, t_out = teng._raw_scan(tchunk, tq.ScanQuery.from_json(query.as_json()))
    assert t_ids == j_ids
    return j_out, t_out


def assert_bytes_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = np.asarray(w)
        g = np.asarray(got[name])
        assert g.dtype == w.dtype, name
        if g.tobytes() != w.tobytes():
            bad = np.flatnonzero(g.view(np.uint32) != w.view(np.uint32))[:5]
            raise AssertionError(f"{name} differs at groups {bad}: port "
                                 f"{[hex(x) for x in g.view(np.uint32)[bad]]}, "
                                 f"reference {[hex(x) for x in w.view(np.uint32)[bad]]}")


def agg(op, column=None):
    return jq.Aggregate(op, column)


FLOAT_AGGS = (agg("count"), agg("sum", "new_balance"), agg("min", "new_balance"),
              agg("max", "new_balance"))


@pytest.mark.parametrize("tile", [1, sr.TILE])
def test_float_rules_match_the_reference_pair_by_pair(engines, tile):
    """Every ordered pair of special values as one group of two events: sum,
    min and max equal to the reference's scatter bit for bit (NaN payloads,
    signed zeros, +inf against the FLT_MAX sentinel, denormals, flushed
    results)."""
    n_vals = FLOAT_SPECIALS.shape[0]
    first = np.repeat(FLOAT_SPECIALS, n_vals)
    second = np.tile(FLOAT_SPECIALS, n_vals)
    n_aggs = n_vals * n_vals
    vals = np.stack([first, second], axis=1).reshape(-1)
    n = vals.shape[0]
    cols = {"balance": np.zeros(n, F32), "new_balance": vals,
            "owner_code": np.ones(n, np.int32),
            "security_code_code": np.zeros(n, np.int32)}
    j, t = chunk(np.repeat(np.arange(n_aggs), 2), np.ones(n), cols, n_aggs)
    q = jq.ScanQuery(aggregates=FLOAT_AGGS)
    want, got = raw_scans(engines, j, t, q, tile)
    assert_bytes_equal(got, want)


def seeded_chunk(seed: int, grouping: str):
    """A bank chunk from a numpy seed: ragged logs (some empty), float
    columns of special and ordinary values, an int column of extremes, and
    ``owner_code`` 0 (masked out by the queries) on the first half of some
    logs, so their matched events start late in their span."""
    rng = np.random.default_rng(seed)
    n_aggs = int(rng.integers(1, 40))
    lens = rng.integers(0, 12, size=n_aggs)
    lens[rng.random(n_aggs) < 0.1] = int(rng.integers(20, 60))
    n = int(lens.sum())
    agg_idx = np.repeat(np.arange(n_aggs), lens)
    starts = np.concatenate([[0], np.cumsum(lens)])
    pos = np.arange(n) - starts[agg_idx]

    def floats(p_special):
        v = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4)).astype(F32)
        special = rng.random(n) < p_special
        v[special] = rng.choice(FLOAT_SPECIALS, size=int(special.sum()))
        return v

    late = rng.random(n_aggs) < 0.3
    owner = rng.integers(0, 4, size=n).astype(np.int32)
    owner[late[agg_idx] & (pos < lens[agg_idx] // 2)] = 0
    ints = rng.integers(-1000, 1000, size=n).astype(np.int32)
    big = rng.random(n) < 0.5
    ints[big] = rng.choice(INT_SPECIALS, size=int(big.sum()))
    cols = {"balance": floats(0.1), "new_balance": floats(float(rng.random())),
            "owner_code": owner, "security_code_code": ints}
    q = jq.ScanQuery(
        aggregates=FLOAT_AGGS + (agg("sum", "balance"), agg("max", "balance"),
                                 agg("sum", "security_code_code"),
                                 agg("min", "security_code_code"),
                                 agg("max", "security_code_code")),
        predicates=(jq.Predicate("owner_code", ">=", 1),),
        group_by=None if grouping == "aggregate" else grouping)
    j, t = chunk(agg_idx, rng.integers(0, 2, size=n), cols, n_aggs)
    return j, t, q


@settings(max_examples=60, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.function_scoped_fixture])
@given(seed=st.integers(0, 2**32 - 1), tile=st.sampled_from(TILES),
       grouping=st.sampled_from(["aggregate", "type_id", "owner_code"]))
def test_twin_equals_the_reference_scatters(engines, seed, tile, grouping):
    """The port's scan (the twin at ``tile``) against the reference's
    scatters on one seeded chunk, byte for byte. ``aggregate`` groups are in
    event order (no ``order``); ``type_id`` and ``owner_code`` are not (a
    stable sort gives ``order``; ``owner_code`` 0 is a group with no
    matched event)."""
    j, t, q = seeded_chunk(seed, grouping)
    want, got = raw_scans(engines, j, t, q, tile)
    assert_bytes_equal(got, want)


# -- the twin against a sequential oracle (no JAX) ------------------------------------


def _u(x) -> int:
    return int(np.asarray(x, F32).view(np.uint32))


def _f(b: int):
    return np.asarray(b & 0xFFFFFFFF, np.uint32).view(F32)[()]


def _daz(x):
    return _f(_u(x) & 0x80000000) if _u(x) & 0x7F800000 == 0 else x


def _rule(op, acc, v):
    """One step of the reference's fold (x86 under FTZ and DAZ)."""
    if op == "sum":
        if v != v:
            return _f(_u(v) | 0x400000)
        if acc != acc:
            return acc
        a, b = _daz(acc), _daz(v)
        if np.isinf(a) and np.isinf(b) and a != b:
            return _f(0xFFC00000)
        with np.errstate(all="ignore"):
            return _daz(F32(a) + F32(b))
    v = _daz(v)
    neg = _u(acc) >> 31
    if op == "min":
        x, y = (v, acc) if neg else (acc, v)
        return x if (x < y or x != x) else y
    x, y = (acc, v) if neg else (v, acc)
    return x if (x > y or x != x) else y


def sequential(mask, fcol, icol, groups, n_groups):
    """Each group's outputs, one event at a time in event order."""
    count = np.zeros(n_groups, np.int32)
    fl = {op: np.full(n_groups, sr.sentinel(op, torch.float32), F32)
          for op in ("sum", "min", "max")}
    it = {"sum": np.zeros(n_groups, np.int64),
          "min": np.full(n_groups, 2**31 - 1, np.int64),
          "max": np.full(n_groups, -2**31, np.int64)}
    for i, g in enumerate(groups):
        m = bool(mask[i])
        count[g] += m
        for op in fl:
            v = fcol[i] if m else F32(sr.sentinel(op, torch.float32))
            fl[op][g] = _rule(op, fl[op][g], v)
        if m:
            it["sum"][g] += int(icol[i])
            it["min"][g] = min(it["min"][g], int(icol[i]))
            it["max"][g] = max(it["max"][g], int(icol[i]))
    wrap = lambda x: ((x + 2**31) % 2**32 - 2**31).astype(np.int32)  # noqa: E731
    return count, [fl["sum"], fl["min"], fl["max"], wrap(it["sum"]),
                   it["min"].astype(np.int32), it["max"].astype(np.int32)]


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("ordered", [True, False])
def test_twin_equals_a_sequential_fold(tile, ordered):
    rng = np.random.default_rng(tile * 2 + ordered)
    for _ in range(20):
        n, g = int(rng.integers(0, 80)), int(rng.integers(1, 12))
        groups = rng.integers(0, g, size=n).astype(np.int32)
        if ordered:
            groups = np.sort(groups)
        mask = rng.random(n) < 0.7
        fcol = rng.choice(FLOAT_SPECIALS, size=n)
        icol = rng.choice(INT_SPECIALS, size=n)
        offsets, order = sr.group_csr(groups, g, torch.device("cpu"))
        assert (order is None) == (ordered or n < 2 or
                                   bool(np.all(groups[1:] >= groups[:-1])))
        count, outs = sr.scan_reduce_reference(
            torch.from_numpy(mask), [torch.from_numpy(fcol)] * 3 + [torch.from_numpy(icol)] * 3,
            ["sum", "min", "max"] * 2, offsets, order, tile=tile)
        want_count, want = sequential(mask, fcol, icol, groups, g)
        assert count.numpy().tobytes() == want_count.tobytes()
        for k, (a, b) in enumerate(zip(outs, want)):
            assert a.numpy().tobytes() == b.tobytes(), k


def test_empty_groups_keep_their_sentinels():
    """No events at all, and groups with none among groups with some."""
    for groups, n_groups in ((np.zeros(0, np.int32), 5), (np.array([1, 1, 4], np.int32), 6)):
        offsets, order = sr.group_csr(groups, n_groups, torch.device("cpu"))
        n = groups.shape[0]
        fcol = torch.arange(n, dtype=torch.float32)
        icol = torch.arange(n, dtype=torch.int32)
        count, outs = sr.scan_reduce(torch.ones(n, dtype=torch.bool),
                                     [fcol, fcol, fcol, icol, icol],
                                     ["sum", "min", "max", "min", "max"], offsets, order)
        empty = np.setdiff1d(np.arange(n_groups), groups)
        assert (count.numpy()[empty] == 0).all()
        for out, op in zip(outs, ["sum", "min", "max", "min", "max"]):
            assert (out.numpy()[empty] == sr.sentinel(op, out.dtype)).all()
