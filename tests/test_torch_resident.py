"""The port's resident replay (surge_tpu_torch.replay.engine.ReplayEngine on the
CPU) against the reference ReplayEngine with tile-backend pallas (interpret
mode) and xla: the same corpora give byte-identical states, across the flat
and dense layouts, both port backends, ragged batch sizes, lanes at the end of
the buffer, empty corpora, resumed folds and wires saved by either package."""

import random

import numpy as np
import pytest
import torch

from surge_tpu.codec.tensor import encode_events_columnar as jencode_columnar
from surge_tpu.config import DEFAULTS as JDEFAULTS
from surge_tpu.config import Config as JConfig
from surge_tpu.models import bank_account as jbank
from surge_tpu.models import counter as jcounter
from surge_tpu.replay.corpus import synth_counter_corpus as jsynth
from surge_tpu.replay.engine import ReplayEngine as JEngine
from surge_tpu.replay.engine import ResidentWire as JResidentWire
from surge_tpu_torch.codec.tensor import ColumnarEvents
from surge_tpu_torch.config import DEFAULTS, Config
from surge_tpu_torch.engine.model import ReplaySpec
from surge_tpu_torch.models import bank_account, counter
from surge_tpu_torch.replay import engine as tengine
from surge_tpu_torch.replay.corpus import synth_counter_corpus
from surge_tpu_torch.replay.engine import ReplayEngine, ResidentWire
from tests.test_torch_isolation import leave_the_worker_as_found  # noqa: F401

BASE = {"surge.replay.batch-size": 256, "surge.replay.time-chunk": 32}


def _port_events(jcol):
    """The reference's ColumnarEvents as the port's (same numpy arrays)."""
    return ColumnarEvents(num_aggregates=jcol.num_aggregates, agg_idx=jcol.agg_idx,
                          type_ids=jcol.type_ids, cols=dict(jcol.cols),
                          derived_cols=dict(jcol.derived_cols))


def _port(spec, overrides, events, **kw):
    eng = ReplayEngine(spec, Config(overrides=overrides), device="cpu")
    res = eng.prepare_resident(events)
    eng.warm_resident(res)
    return eng, eng.replay_resident(res, **kw)


def _jax(spec, overrides, jevents, **kw):
    eng = JEngine(spec, config=JConfig(overrides=overrides))
    return eng.replay_resident(eng.prepare_resident(jevents), **kw)


def _same_states(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.fixture(scope="module")
def corpus():
    c = synth_counter_corpus(900, 45_000, seed=8)
    jc = jsynth(900, 45_000, seed=8)
    assert c.events.type_ids.tobytes() == jc.events.type_ids.tobytes()
    assert np.array_equal(c.expected_count, jc.expected_count)
    return c, jc


@pytest.fixture(scope="module")
def jax_states(corpus):
    _, jc = corpus
    return {backend: _jax(jcounter.make_replay_spec(),
                          dict(BASE, **{"surge.replay.tile-backend": backend}),
                          jc.events).states
            for backend in ("pallas", "xla")}


@pytest.mark.parametrize("layout", ["flat", "dense"])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_counter_corpus_matches_reference(corpus, jax_states, backend, layout):
    c, _ = corpus
    ov = dict(BASE, **{"surge.replay.tile-backend": backend,
                       "surge.replay.resident-layout": layout})
    eng, res = _port(counter.make_replay_spec(), ov, c.events)
    assert eng.tile_backend == backend
    _same_states(res.states, jax_states["pallas"])
    _same_states(res.states, jax_states["xla"])
    assert np.array_equal(res.states["count"].astype(np.int64), c.expected_count)
    assert np.array_equal(res.states["version"], c.expected_version)


@pytest.mark.parametrize("batch", [100, 48])
def test_batch_that_does_not_divide_the_lanes(corpus, batch):
    c, jc = corpus
    ov = {"surge.replay.batch-size": batch, "surge.replay.time-chunk": 64,
          "surge.replay.dispatch": "select", "surge.replay.tile-backend": "pallas",
          "surge.replay.resident-len-bucket": "exact"}
    eng, res = _port(counter.make_replay_spec(), ov, c.events)
    assert 900 % eng.batch_size
    plan = eng._plan_for(eng.prepare_resident(c.events))
    assert plan.bs_big % plan.bs_small == 0 and len(plan.small_i0)
    _same_states(res.states, _jax(jcounter.make_replay_spec(), ov, jc.events).states)
    assert np.array_equal(res.states["count"].astype(np.int64), c.expected_count)


def _tail_corpus(mod):
    """A long log first, then short logs at the very end of the buffer: in the
    late tiles the short lanes' slab starts run past the guard rows, which JAX
    clamps (dynamic_slice) and the port must clamp alike."""
    lengths = np.array([9000, 3, 1, 0, 2], dtype=np.int64)
    c = mod(0, 0, seed=4, lengths=lengths)
    return c


@pytest.mark.parametrize("layout", ["flat", "dense"])
def test_lanes_at_the_end_of_the_buffer(layout):
    c, jc = _tail_corpus(synth_counter_corpus), _tail_corpus(jsynth)
    ov = {"surge.replay.batch-size": 8, "surge.replay.time-chunk": 512,
          "surge.replay.dispatch": "select",
          "surge.replay.resident-len-bucket": "exact",
          "surge.replay.resident-layout": layout}
    eng = ReplayEngine(counter.make_replay_spec(), Config(overrides=ov), device="cpu")
    resident = eng.prepare_resident(c.events)
    rows = resident.flat_wire.shape[0]
    plan = eng._plan_for(resident)
    width = plan.width
    # the last tile's slab for the 3-event lane (starting at row 9000) would
    # run past the buffer without the clamp
    last = int(np.concatenate([plan.big_tb, plan.small_tb]).max())
    assert 9000 + last + width > rows
    res = eng.replay_resident(resident)
    assert np.array_equal(res.states["count"].astype(np.int64), c.expected_count)
    assert np.array_equal(res.states["version"], c.expected_version)
    for backend in ("pallas", "xla"):
        _same_states(res.states, _jax(jcounter.make_replay_spec(), dict(
            ov, **{"surge.replay.tile-backend": backend}), jc.events).states)


def test_slab_index_clamps_like_dynamic_slice():
    idx = tengine._slab_index(torch.tensor([0, 5, 95], dtype=torch.int32), 3, 8, 100)
    assert idx.shape == (8, 3)
    assert idx[:, 0].tolist() == list(range(3, 11))
    assert idx[:, 2].tolist() == list(range(92, 100))  # 98 clamps to 100 - 8


def test_tile_past_the_slab_raises():
    with pytest.raises(ValueError, match="outside the slab"):
        tengine._lane_range(16, 8, 20)


def test_empty_corpus():
    empty = ColumnarEvents(num_aggregates=0, agg_idx=np.zeros(0, np.int32),
                           type_ids=np.zeros(0, np.int32),
                           cols={"increment_by": np.zeros(0, np.int32),
                                 "decrement_by": np.zeros(0, np.int32)},
                           derived_cols={"sequence_number": "ordinal"})
    _, res = _port(counter.make_replay_spec(), BASE, empty)
    jempty = jsynth(0, 0, seed=1).events
    want = _jax(jcounter.make_replay_spec(), BASE, jempty).states
    _same_states(res.states, want)
    assert res.num_aggregates == 0 and res.padded_events == 0


def _halves(c):
    ev = c.events
    starts = np.zeros(c.num_aggregates + 1, dtype=np.int64)
    np.cumsum(c.lengths, out=starts[1:])
    cut = (c.lengths // 2).astype(np.int32)
    first = (np.arange(ev.num_events) - starts[ev.agg_idx]) < cut[ev.agg_idx]

    def part(mask):
        return ColumnarEvents(num_aggregates=c.num_aggregates, agg_idx=ev.agg_idx[mask],
                              type_ids=ev.type_ids[mask],
                              cols={k: v[mask] for k, v in ev.cols.items()},
                              derived_cols=dict(ev.derived_cols))

    return part(first), part(~first), cut


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_resume_with_init_carry_and_ordinal_base(corpus, backend):
    c, _ = corpus
    first, second, cut = _halves(c)
    ov = dict(BASE, **{"surge.replay.tile-backend": backend})
    _, r1 = _port(counter.make_replay_spec(), ov, first)
    carry = {k: v.copy() for k, v in r1.states.items()}
    _, r2 = _port(counter.make_replay_spec(), ov, second, init_carry=carry,
                  ordinal_base=cut)
    assert np.array_equal(r2.states["count"].astype(np.int64), c.expected_count)
    assert np.array_equal(r2.states["version"], c.expected_version)
    # the caller's carry and ordinal base are never written
    for k in carry:
        assert carry[k].tobytes() == r1.states[k].tobytes()
    assert np.array_equal(cut, (c.lengths // 2).astype(np.int32))
    jfirst = _jax(jcounter.make_replay_spec(), ov, first)
    jsecond = _jax(jcounter.make_replay_spec(), ov, second,
                   init_carry=jfirst.states, ordinal_base=cut)
    _same_states(r2.states, jsecond.states)


def test_init_carry_left_unmodified_with_a_permuted_corpus(corpus):
    c, _ = corpus
    rng = np.random.default_rng(5)
    carry = {"count": rng.integers(-50, 50, size=900).astype(np.int32),
             "version": np.zeros(900, np.int32)}
    snap = {k: v.copy() for k, v in carry.items()}
    eng = ReplayEngine(counter.make_replay_spec(), Config(overrides=BASE), device="cpu")
    resident = eng.prepare_resident(c.events)
    assert resident.perm is not None
    a = eng.replay_resident(resident, init_carry=carry)
    b = eng.replay_resident(resident, init_carry=carry)
    for k in carry:
        assert carry[k].tobytes() == snap[k].tobytes()
        assert a.states[k].tobytes() == b.states[k].tobytes()
    assert np.array_equal(a.states["count"].astype(np.int64),
                          c.expected_count + snap["count"])


def test_wire_saved_by_either_package_folds_in_the_other(corpus, tmp_path):
    c, jc = corpus
    ov = dict(BASE, **{"surge.replay.tile-backend": "xla"})
    jeng = JEngine(jcounter.make_replay_spec(), config=JConfig(overrides=ov))
    jeng.pack_resident(jc.events).save(str(tmp_path / "from_jax"))
    eng = ReplayEngine(counter.make_replay_spec(), Config(overrides=ov), device="cpu")
    eng.pack_resident(c.events).save(str(tmp_path / "from_port"))

    res = eng.replay_resident(eng.upload_resident(
        ResidentWire.load(str(tmp_path / "from_jax"))))
    jres = jeng.replay_resident(jeng.upload_resident(
        JResidentWire.load(str(tmp_path / "from_port"))))
    _same_states(res.states, jres.states)
    assert np.array_equal(res.states["count"].astype(np.int64), c.expected_count)
    assert sorted(p.name for p in (tmp_path / "from_jax").iterdir()) == \
        sorted(p.name for p in (tmp_path / "from_port").iterdir())


def test_check_wire_refuses_another_schema(corpus):
    c, _ = corpus
    ceng = ReplayEngine(counter.make_replay_spec(), Config(overrides=BASE), device="cpu")
    beng = ReplayEngine(bank_account.make_replay_spec(), Config(overrides=BASE),
                        device="cpu")
    with pytest.raises(ValueError, match="wire layout mismatch"):
        beng.upload_resident(ceng.pack_resident(c.events))


def _bank_logs():
    """The bank_account logs of tests/test_replay_scale.py (pallas vs xla)."""
    rng = random.Random(2)
    vocab = jbank.Vocab()
    enc_logs = []
    for i in range(130):
        log = [jbank.BankAccountCreated(str(i), f"o{i}", "s", 100.0)]
        bal = 100.0
        for _ in range(rng.randrange(0, 9)):
            bal += rng.randrange(1, 20) * 0.25
            log.append(jbank.BankAccountUpdated(str(i), bal))
        enc_logs.append([jbank.encode_event(vocab, e) for e in log])
    return jencode_columnar(jbank.make_registry(), enc_logs)


@pytest.mark.parametrize("layout", ["flat", "dense"])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_bank_account_matches_reference(backend, layout):
    jcol = _bank_logs()
    ov = {"surge.replay.batch-size": 64, "surge.replay.time-chunk": 8,
          "surge.replay.tile-backend": backend, "surge.replay.resident-layout": layout}
    _, res = _port(bank_account.make_replay_spec(), ov, _port_events(jcol))
    for jbackend in ("pallas", "xla"):
        want = _jax(jbank.make_replay_spec(),
                    dict(ov, **{"surge.replay.tile-backend": jbackend}), jcol).states
        _same_states(res.states, want)
    assert res.states["created"].all()


def test_fold_resident_slab_is_the_sorted_state(corpus):
    c, _ = corpus
    eng = ReplayEngine(counter.make_replay_spec(), Config(overrides=BASE), device="cpu")
    resident = eng.prepare_resident(c.events)
    slab, padded = eng.fold_resident_slab(resident)
    assert padded == eng._plan_for(resident).padded_slots
    count = slab["count"][:900].numpy()
    assert np.array_equal(count.astype(np.int64), c.expected_count[resident.perm])


def test_tile_backend_resolution(monkeypatch):
    spec = counter.make_replay_spec()
    assert ReplayEngine(spec, device="cpu").tile_backend == "xla"  # auto on CPU
    assoc = ReplayEngine(spec, Config(overrides={"surge.replay.tile-backend": "assoc"}),
                         device="cpu")
    assert assoc.tile_backend == "assoc"
    no_fold = ReplaySpec(spec.registry, spec.handlers, spec.init_record,
                         kernel_step=spec.kernel_step)
    with pytest.raises(ValueError, match="AssociativeFold"):
        ReplayEngine(no_fold, Config(overrides={"surge.replay.tile-backend": "assoc"}),
                     device="cpu").tile_backend
    # auto stays the kernel on CUDA, even for a spec that ships a fold
    on_card = ReplayEngine(spec, device="cpu")
    monkeypatch.setattr(on_card, "device", torch.device("cuda"))
    assert spec.associative is not None and on_card.tile_backend == "pallas"
    with pytest.raises(ValueError, match="unknown surge.replay.tile-backend"):
        ReplayEngine(spec, Config(overrides={"surge.replay.tile-backend": "triton"}),
                     device="cpu")
    plain = ReplaySpec(spec.registry, spec.handlers, spec.init_record)
    eng = ReplayEngine(plain, Config(overrides={"surge.replay.tile-backend": "pallas"}),
                       device="cpu")
    with pytest.raises(ValueError, match="kernel_step"):
        eng.tile_backend
    xla = ReplayEngine(plain, Config(overrides={"surge.replay.tile-backend": "xla"}),
                       device="cpu")
    assert xla.tile_backend == "xla"


def test_auto_on_cuda_without_kernel_step_raises(monkeypatch):
    spec = counter.make_replay_spec()
    plain = ReplaySpec(spec.registry, spec.handlers, spec.init_record)
    eng = ReplayEngine(plain, device="cpu")
    monkeypatch.setattr(eng, "device", torch.device("cuda"))
    with pytest.raises(ValueError, match="kernel_step"):
        eng.tile_backend


#: the key families the port carries: the replay engine's, the query
#: engine's and those of the engine's host modules
PORT_KEY_FAMILIES = (
    "surge.replay.", "surge.query.", "surge.producer.", "surge.state-store.",
    "surge.aggregate.", "surge.serialization.", "surge.metrics.",
    "surge.trace.", "surge.store.checkpoint.", "surge.log.compaction.",
    "surge.log.failover.", "surge.log.faults.", "surge.health.",
    "surge.event-loop-prober.", "surge.feature-flags.", "surge.engine.",
    "surge.audit.")


def test_replay_keys_and_defaults_match_the_reference():
    for key, value in DEFAULTS.items():
        assert key.startswith(PORT_KEY_FAMILIES), key
        assert JDEFAULTS[key] == value, key
    cfg = Config().with_overrides(surge_replay_time_chunk=99)
    assert cfg.get_int("surge.replay.time-chunk") == 99
    assert cfg.get_int_list("surge.replay.batch-size") == [8192]


@pytest.mark.parametrize("key", sorted(DEFAULTS))
def test_every_port_key_resolves_as_the_reference(key, monkeypatch):
    """Each key the port carries: the reference's default, of its type, and
    an environment override coerced to the same value by both packages."""
    assert type(DEFAULTS[key]) is type(JDEFAULTS[key])
    assert Config().get(key) == JConfig().get(key)
    env = key.upper().replace(".", "_").replace("-", "_")
    monkeypatch.setenv(env, "7" if not isinstance(DEFAULTS[key], bool) else "yes")
    assert Config().get(key) == JConfig().get(key)


@pytest.mark.parametrize("layout", ["dense", "auto", "flat"])
def test_oneshot_corpus_never_densifies(corpus, layout):
    """A corpus marked ``oneshot`` (folded exactly once: the resident plane's
    seed and shadow replay) gathers per pass under every layout, as the
    reference's ``_use_dense`` decides."""
    c, jc = corpus
    ov = dict(BASE, **{"surge.replay.resident-layout": layout})
    eng = ReplayEngine(counter.make_replay_spec(), Config(overrides=ov),
                       device="cpu")
    jeng = JEngine(jcounter.make_replay_spec(), config=JConfig(overrides=ov))
    res, jres = eng.prepare_resident(c.events), jeng.prepare_resident(jc.events)
    plan, jplan = eng._plan_for(res), jeng._plan_for(jres)
    assert eng._use_dense(res, plan) == jeng._use_dense(jres, jplan) \
        == (layout == "dense")
    res.cache["oneshot"] = jres.cache["oneshot"] = True
    assert eng._use_dense(res, plan) is jeng._use_dense(jres, jplan) is False
