"""K1's list fold (surge_tpu_torch.replay.fold_kernels.tile_fold_list): the
per-lane-block schedule, the plain version against the plain backend's
per-tile loop, the port's resident replay through the list path against the
reference ReplayEngine (tile-backend pallas, interpret mode, and xla), resumed
folds and warm-up; on a CUDA card only, the kernel against its plain version.

Corpora: a few thousand aggregates with lognormal lengths at bs 256 and tile
width 8 (both work lists non-empty, bs_small 32), and one small enough that
bs_small is 8; three layouts: counter with a derived ordinal, counter with the
ordinal as a side column, and bank_account."""

import numpy as np
import pytest
import torch

from surge_tpu.codec.tensor import ColumnarEvents as JColumnar
from surge_tpu.config import Config as JConfig
from surge_tpu.models import bank_account as jbank
from surge_tpu.models import counter as jcounter
from surge_tpu.replay.engine import ReplayEngine as JEngine
from surge_tpu_torch.codec.tensor import ColumnarEvents
from surge_tpu_torch.config import Config
from surge_tpu_torch.models import bank_account, counter
from surge_tpu_torch.replay import fold_kernels
from surge_tpu_torch.replay.corpus import synth_counter_corpus
from surge_tpu_torch.replay.engine import ReplayEngine
from tests.test_torch_isolation import leave_the_worker_as_found  # noqa: F401

BASE = {"surge.replay.batch-size": 256, "surge.replay.time-chunk": 8,
        "surge.replay.tile-backend": "pallas"}
#: corpus name -> (aggregates, events)
SIZES = {"lognormal": (3000, 60_000), "tiny": (64, 1_600)}
LAYOUTS = ("counter-derived", "counter-side", "bank")


def _corpus(layout: str, size: str, seed: int = 0) -> ColumnarEvents:
    """A corpus of the layout: the synthetic counter corpus (its ordinal
    derived, or shipped as a side column), or bank_account logs with the same
    lognormal lengths (creates, repeated creates, updates before any create)."""
    aggs, events = SIZES[size]
    c = synth_counter_corpus(aggs, events, seed=seed)
    if layout == "counter-derived":
        return c.events
    ev = c.events
    if layout == "counter-side":
        starts = np.zeros(aggs + 1, dtype=np.int64)
        np.cumsum(c.lengths, out=starts[1:])
        seq = (np.arange(ev.num_events) - starts[ev.agg_idx] + 1).astype(np.int32)
        return ColumnarEvents(num_aggregates=aggs, agg_idx=ev.agg_idx,
                              type_ids=ev.type_ids,
                              cols=dict(ev.cols, sequence_number=seq))
    rng = np.random.default_rng(seed + 1)
    n = ev.num_events
    created = rng.random(n) < 0.1
    type_ids = np.where(created, bank_account.CREATED,
                        bank_account.UPDATED).astype(np.int32)
    quarter = lambda: (rng.integers(0, 4_000_000, size=n) * 0.25).astype(np.float32)  # noqa: E731
    codes = lambda: np.where(created, rng.integers(1, 1 << 20, size=n), 0).astype(np.int32)  # noqa: E731
    cols = {"owner_code": codes(), "security_code_code": codes(),
            "balance": np.where(created, quarter(), 0).astype(np.float32),
            "new_balance": np.where(created, 0, quarter()).astype(np.float32)}
    return ColumnarEvents(num_aggregates=aggs, agg_idx=ev.agg_idx,
                          type_ids=type_ids, cols=cols)


def _specs(layout: str):
    if layout == "bank":
        return bank_account.make_replay_spec(), jbank.make_replay_spec()
    return counter.make_replay_spec(), jcounter.make_replay_spec()


def _engine(layout: str, **overrides) -> ReplayEngine:
    return ReplayEngine(_specs(layout)[0], Config(overrides=dict(BASE, **overrides)),
                        device="cpu")


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        w = want[k].numpy() if isinstance(want[k], torch.Tensor) else want[k]
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), k


def _lists(plan):
    return ((plan.bs_big, plan.big_i0, plan.big_tb),
            (plan.bs_small, plan.small_i0, plan.small_tb))


# -- the schedule -----------------------------------------------------------------------


@pytest.mark.parametrize("case", ["lognormal", "tiny", "unsorted"])
def test_schedule_walks_each_lanes_tiles_in_order(case):
    eng = _engine("counter-derived", **(
        {"surge.replay.sort-by-length": False} if case == "unsorted" else {}))
    resident = eng.prepare_resident(_corpus("counter-derived",
                                            "tiny" if case == "tiny" else "lognormal"))
    plan = eng._plan_for(resident)
    if case == "unsorted":
        assert len(plan.small_i0) == 0 and (np.diff(resident.lengths) > 0).any()
    else:
        assert len(plan.big_i0) and len(plan.small_i0)
        assert plan.bs_small == (8 if case == "tiny" else 32)
    b_pad, lb = resident.b_pad, fold_kernels.LIST_LANE_BLOCK
    for bs, i0s, t_bases in _lists(plan):
        ids, off, tiles = fold_kernels.list_schedule(i0s, bs, b_pad)
        assert ids.dtype == off.dtype == tiles.dtype == np.int32
        assert off[0] == 0 and off[-1] == len(tiles) and (np.diff(ids) > 0).all()
        walked = {lane: [] for lane in range(b_pad)}
        for i, blk in enumerate(ids.tolist()):
            block_tiles = tiles[off[i]:off[i + 1]].tolist()
            assert block_tiles == sorted(block_tiles)  # list order
            for k in block_tiles:
                lo, hi = max(blk * lb, int(i0s[k])), min((blk + 1) * lb, int(i0s[k]) + bs)
                assert lo < hi  # the tile covers some lane of the block
                for lane in range(lo, hi):
                    walked[lane].append(k)
        for lane, ks in walked.items():
            want = [k for k in range(len(i0s)) if i0s[k] <= lane < i0s[k] + bs]
            assert ks == want, lane
            assert (np.diff(t_bases[ks]) > 0).all(), lane  # ascending t_base


def test_schedule_refuses_a_tile_outside_the_slab():
    with pytest.raises(ValueError, match="outside the slab"):
        fold_kernels.list_schedule(np.array([0, 256], np.int32), 256, 300)
    ids, off, tiles = fold_kernels.list_schedule(np.zeros(0, np.int32), 256, 512)
    assert len(ids) == len(tiles) == 0 and off.tolist() == [0]


# -- the plain version against the plain backend's per-tile loop --------------------------


def _per_tile_loop(layout, source, resident, slab, ord_d, limit=None):
    """The plain backend's per-tile loop: the engine (tile-backend xla) walks
    both lists tile by tile with its own time scan (absolute time, switch
    dispatch), where the list fold's plain version runs K1's plain version
    (relative time, the ordinal clamp, select dispatch)."""
    eng = _engine(layout, **{"surge.replay.tile-backend": "xla",
                             "surge.replay.resident-layout": source})
    eng._run_tiles(resident, eng._plan_for(resident), slab, ord_d, limit=limit)


def _random_slab(spec, b_pad, seed):
    """A random carry and ordinal base (ordinals near int32 max wrap)."""
    rng = np.random.default_rng(seed)
    slab = {}
    for f in spec.registry.state.fields:
        dt = np.dtype(f.dtype)
        if dt == np.bool_:
            col = rng.random(b_pad) < 0.5
        elif dt == np.float32:
            col = rng.standard_normal(b_pad).astype(np.float32)
        else:
            col = rng.integers(-(1 << 31), 1 << 31, size=b_pad, dtype=np.int64).astype(np.int32)
        slab[f.name] = torch.from_numpy(col)
    ordv = rng.integers(0, 1 << 31, size=b_pad, dtype=np.int64).astype(np.int32)
    ordv[:3] = np.iinfo(np.int32).max
    return slab, torch.from_numpy(ordv)


@pytest.mark.parametrize("source", ["dense", "flat"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_list_fold_equals_the_per_tile_loop(layout, source):
    eng = _engine(layout)
    resident = eng.prepare_resident(_corpus(layout, "lognormal", seed=2))
    plan = eng._plan_for(resident)
    wire = eng._wire(frozenset(resident.derived_key.items()))
    for limit in (None, 1):
        slab, ord_d = _random_slab(eng.spec, resident.b_pad, seed=3)
        want = {f: v.clone() for f, v in slab.items()}
        _per_tile_loop(layout, source, resident, want, ord_d, limit)
        for bs, i0s, t_bases in _lists(plan):
            if source == "dense":
                words, sides = eng._dense_tiles(resident, plan, bs, i0s, t_bases)
                starts = None
            else:
                words, sides = resident.flat_wire, resident.flat_side
                starts = resident.starts_dev
            fold_kernels.tile_fold_list_reference(
                slab, words, sides, resident.lens_dev, ord_d,
                torch.from_numpy(i0s), torch.from_numpy(t_bases),
                width=plan.width, bs=bs, spec=eng.spec, wire=wire, starts=starts,
                k_n=None if limit is None else min(limit, len(i0s)))
        _same(slab, want)


# -- the port's replay through the list path against the reference -----------------------


def _jax_events(ev: ColumnarEvents) -> JColumnar:
    return JColumnar(num_aggregates=ev.num_aggregates, agg_idx=ev.agg_idx,
                     type_ids=ev.type_ids, cols=dict(ev.cols),
                     derived_cols=dict(ev.derived_cols))


@pytest.fixture(scope="module")
def reference_states():
    """The reference engine's states for each (layout, corpus), under its
    Pallas kernel (interpret mode on the CPU) and its plain scan."""
    cache = {}

    def get(layout, size):
        if (layout, size) not in cache:
            jspec = _specs(layout)[1]
            ev = _jax_events(_corpus(layout, size))
            out = {}
            for backend in ("pallas", "xla"):
                jeng = JEngine(jspec, config=JConfig(overrides=dict(
                    BASE, **{"surge.replay.tile-backend": backend})))
                out[backend] = jeng.replay_resident(jeng.prepare_resident(ev)).states
            cache[layout, size] = out
        return cache[layout, size]

    return get


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("source", ["dense", "flat"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_list_path_replay_matches_the_reference(reference_states, monkeypatch,
                                                layout, source, size):
    eng = _engine(layout, **{"surge.replay.resident-layout": source})
    resident = eng.prepare_resident(_corpus(layout, size))
    plan = eng._plan_for(resident)
    assert eng._use_dense(resident, plan) == (source == "dense")
    assert len(plan.big_i0) and len(plan.small_i0)
    calls = []
    real = fold_kernels.tile_fold_list
    monkeypatch.setattr(fold_kernels, "tile_fold_list", lambda *a, **k: (
        calls.append(k["k_n"]), real(*a, **k)))
    windows = eng.stats["windows"]
    res = eng.replay_resident(resident)
    monkeypatch.undo()
    # one list-fold call per non-empty list, counting every tile as a window
    assert calls == [len(plan.big_i0), len(plan.small_i0)]
    assert eng.stats["windows"] - windows == len(plan.big_i0) + len(plan.small_i0)
    want = reference_states(layout, size)
    _same(res.states, want["pallas"])
    _same(res.states, want["xla"])


@pytest.mark.parametrize("source", ["dense", "flat"])
def test_resumed_list_fold_equals_one_fold(source):
    ev = _corpus("counter-derived", "lognormal", seed=4)
    b = ev.num_aggregates
    lengths = np.bincount(ev.agg_idx, minlength=b)
    starts = np.zeros(b + 1, dtype=np.int64)
    np.cumsum(lengths, out=starts[1:])
    cut = (lengths // 2).astype(np.int32)
    first = (np.arange(ev.num_events) - starts[ev.agg_idx]) < cut[ev.agg_idx]

    def part(mask):
        return ColumnarEvents(num_aggregates=b, agg_idx=ev.agg_idx[mask],
                              type_ids=ev.type_ids[mask],
                              cols={k: v[mask] for k, v in ev.cols.items()},
                              derived_cols=dict(ev.derived_cols))

    eng = _engine("counter-derived", **{"surge.replay.resident-layout": source})
    r1 = eng.replay_resident(eng.prepare_resident(part(first)))
    r2 = eng.replay_resident(eng.prepare_resident(part(~first)),
                             init_carry=r1.states, ordinal_base=cut)
    full = eng.replay_resident(eng.prepare_resident(ev))
    _same(r2.states, full.states)


@pytest.mark.parametrize("source", ["dense", "flat"])
def test_warm_up_leaves_no_trace(source):
    ev = _corpus("bank", "lognormal", seed=6)
    cold = _engine("bank", **{"surge.replay.resident-layout": source})
    want = cold.replay_resident(cold.prepare_resident(ev))
    eng = _engine("bank", **{"surge.replay.resident-layout": source})
    resident = eng.prepare_resident(ev)
    launches = dict(fold_kernels.LAUNCHES)
    eng.warm_resident(resident)
    assert eng.stats["windows"] == 0  # warm-up tiles are not the replay's
    plan = eng._plan_for(resident)
    cached = [k for k in resident.cache if isinstance(k, tuple) and k[0] == "list"]
    assert len(cached) == 2  # both work lists' schedules are built
    if source == "dense":
        assert sum(1 for k in resident.cache if isinstance(k, tuple) and k[0] == "dense") == 2
    res = eng.replay_resident(resident)
    _same(res.states, want.states)
    assert eng.stats["windows"] == len(plan.big_i0) + len(plan.small_i0)
    assert fold_kernels.LAUNCHES == launches  # CPU tensors never launch


def test_list_fold_refuses_other_devices():
    eng = _engine("counter-derived")
    resident = eng.prepare_resident(_corpus("counter-derived", "tiny"))
    plan = eng._plan_for(resident)
    meta = lambda t: torch.empty_like(t, device="meta")  # noqa: E731
    slab, ord_d = _random_slab(eng.spec, resident.b_pad, seed=0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fold_kernels.tile_fold_list(
            {f: meta(v) for f, v in slab.items()}, meta(resident.flat_wire),
            {}, meta(resident.lens_dev), meta(ord_d),
            torch.from_numpy(plan.big_i0), torch.from_numpy(plan.big_tb),
            schedule=eng._work_list(resident, plan, plan.bs_big, plan.big_i0,
                                    plan.big_tb)[2],
            width=plan.width, bs=plan.bs_big, spec=eng.spec,
            wire=eng._wire(frozenset(resident.derived_key.items())),
            starts=meta(resident.starts_dev))


# -- on the card ------------------------------------------------------------------------------


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the list-fold kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("source", ["dense", "flat"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_list_kernel_matches_plain_version_on_the_card(cuda_card, layout, source, size):
    eng = ReplayEngine(_specs(layout)[0], Config(overrides=dict(
        BASE, **{"surge.replay.resident-layout": source})), device=cuda_card)
    resident = eng.prepare_resident(_corpus(layout, size, seed=9))
    plan = eng._plan_for(resident)
    wire = eng._wire(frozenset(resident.derived_key.items()))
    slab, ord_d = _random_slab(eng.spec, resident.b_pad, seed=1)
    slab = {f: v.to(cuda_card) for f, v in slab.items()}
    ord_d = ord_d.to(cuda_card)
    want = {f: v.clone() for f, v in slab.items()}
    before = fold_kernels.LAUNCHES["tile_fold_list"]
    for bs, i0s, t_bases in _lists(plan):
        if source == "dense":
            words, sides = eng._dense_tiles(resident, plan, bs, i0s, t_bases)
            starts = None
        else:
            words, sides = resident.flat_wire, resident.flat_side
            starts = resident.starts_dev
        i0s_d, tb_d, schedule = eng._work_list(resident, plan, bs, i0s, t_bases)
        kw = dict(width=plan.width, bs=bs, spec=eng.spec, wire=wire, starts=starts)
        fold_kernels.tile_fold_list(slab, words, sides, resident.lens_dev, ord_d,
                                    i0s_d, tb_d, schedule=schedule, **kw)
        fold_kernels.tile_fold_list_reference(want, words, sides, resident.lens_dev,
                                              ord_d, i0s_d, tb_d, **kw)
    torch.cuda.synchronize()
    assert fold_kernels.LAUNCHES["tile_fold_list"] == before + 2
    _same({f: v.cpu() for f, v in slab.items()}, {f: v.cpu() for f, v in want.items()})
