"""The port's associative folds (surge_tpu_torch.replay.seqpar and each
model's ``make_associative_fold``) and the ``assoc`` tile backend, against the
reference's (surge_tpu.replay.seqpar, ``tile-backend = assoc``): lift, combine
and apply on the same events, the law check (a wrong combine raises, in the
check and on the engine's first fold), structural fold keys, and resident
cold replay on ``assoc`` byte for byte, both layouts."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from surge_tpu.config import Config as JConfig
from surge_tpu.models import bank_account as jbank
from surge_tpu.models import counter as jcounter
from surge_tpu.models import shopping_cart as jcart
from surge_tpu.replay.engine import ReplayEngine as JEngine
from surge_tpu_torch.config import Config
from surge_tpu_torch.engine.model import ReplaySpec
from surge_tpu_torch.models import bank_account, counter, shopping_cart
from surge_tpu_torch.replay import engine as tengine
from surge_tpu_torch.replay import seqpar
from surge_tpu_torch.replay.engine import ReplayEngine
from surge_tpu_torch.saga import model as saga
from tests.test_torch_resident import _bank_logs, _port_events
from tests.test_torch_cart_saga import _columnar, _logs
from tests.test_torch_isolation import leave_the_worker_as_found  # noqa: F401

MODELS = {
    "counter": (counter, jcounter),
    "bank_account": (bank_account, jbank),
    "shopping_cart": (shopping_cart, jcart),
}


def _events(mod, shape, rng):
    """Random event columns of the family: small ints (cart: products past
    2^31 too), float columns of every bit pattern, type ids with padding and
    corrupt ids."""
    out = {}
    for f in mod.make_registry().union_columns():
        dt = np.dtype(f.dtype)
        if dt == np.float32:
            out[f.name] = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64
                                       ).astype(np.uint32).view(np.float32)
        elif f.bits is not None:
            out[f.name] = rng.integers(0, 1 << f.bits, size=shape).astype(dt)
        else:
            out[f.name] = rng.integers(-(1 << 31), 1 << 31, size=shape,
                                       dtype=np.int64).astype(dt)
    out["type_id"] = rng.choice(np.array([-1, 0, 1, 2, 3, 4, 9], np.int32),
                                size=shape)
    return out


def _state(mod, n, rng):
    out = {}
    for f in mod.make_registry().state.fields:
        dt = np.dtype(f.dtype)
        if dt == np.bool_:
            out[f.name] = rng.random(n) < 0.5
        elif dt == np.float32:
            out[f.name] = rng.standard_normal(n).astype(np.float32)
        else:
            out[f.name] = rng.integers(-(1 << 31), 1 << 31, size=n,
                                       dtype=np.int64).astype(dt)
    return out


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        w = np.asarray(want[k])
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("model", sorted(MODELS))
def test_lift_combine_apply_match_the_reference(model):
    mod, jmod = MODELS[model]
    fold, jfold = mod.make_associative_fold(), jmod.make_associative_fold()
    rng = np.random.default_rng(41)
    ev = _events(mod, (2, 257), rng)
    tev = {k: torch.from_numpy(v) for k, v in ev.items()}
    jev = {k: jnp.asarray(v) for k, v in ev.items()}
    lifts = [fold.lift({k: v[i] for k, v in tev.items()}) for i in range(2)]
    jlifts = [jfold.lift({k: v[i] for k, v in jev.items()}) for i in range(2)]
    for a, b in zip(lifts, jlifts):
        _same(a, b)
    both = fold.combine(*lifts)
    _same(both, jfold.combine(*jlifts))
    state = _state(mod, 257, rng)
    _same(fold.apply({k: torch.from_numpy(v) for k, v in state.items()}, both),
          jfold.apply({k: jnp.asarray(v) for k, v in state.items()},
                      jfold.combine(*jlifts)))
    assert {k: np.asarray(v).dtype for k, v in fold.identity.items()} == \
        {k: np.asarray(v).dtype for k, v in jfold.identity.items()}


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_fixture_folds_pass_the_laws(model, seed):
    mod = MODELS[model][0]
    seqpar.check_associative_fold(mod.make_associative_fold(),
                                  mod.make_replay_spec(), seed=seed)


def _bad_counter_fold():
    good = counter.make_associative_fold()

    def bad_combine(a, b):
        return {
            "d_count": a["d_count"] + b["d_count"],
            "has": a["has"] | b["has"],
            # WRONG: left-biased — "first writer wins" version
            "last_seq": torch.where(a["has"], a["last_seq"], b["last_seq"]),
        }

    return seqpar.AssociativeFold(lift=good.lift, combine=bad_combine,
                                  apply=good.apply, identity=good.identity)


def test_wrong_combine_is_rejected_loudly():
    spec = counter.make_replay_spec()
    with pytest.raises(ValueError, match="violates"):
        seqpar.check_associative_fold(_bad_counter_fold(), spec, seed=4)


def test_a_fold_that_moves_a_float_bit_is_rejected():
    """The laws compare floats byte for byte: an ``apply`` that moves the
    balance by one ulp is as wrong as a wrong combine."""
    good = bank_account.make_associative_fold()

    def nudged_apply(state, s):
        out = good.apply(state, s)
        out["balance"] = torch.nextafter(out["balance"],
                                         torch.tensor(np.inf))
        return out

    bad = seqpar.AssociativeFold(lift=good.lift, combine=good.combine,
                                 apply=nudged_apply, identity=good.identity)
    with pytest.raises(ValueError, match="violates the identity"):
        seqpar.check_associative_fold(bad, bank_account.make_replay_spec())


def test_engine_runs_the_law_check_before_its_first_fold(monkeypatch):
    """A wrong fold fails the engine's assoc backend on first use, every
    time (it never enters the validated set); a right one is checked once."""
    monkeypatch.setattr(seqpar, "_VALIDATED", set())
    good = counter.make_replay_spec()
    bad = ReplaySpec(good.registry, good.handlers, good.init_record,
                     associative=_bad_counter_fold())
    col = _port_events(_counter_logs())
    ov = {"surge.replay.batch-size": 32, "surge.replay.time-chunk": 8,
          "surge.replay.tile-backend": "assoc"}
    for _ in range(2):
        eng = ReplayEngine(bad, Config(overrides=ov), device="cpu")
        with pytest.raises(ValueError, match="violates"):
            eng.replay_resident(eng.prepare_resident(col))
    assert not seqpar._VALIDATED
    calls = []
    real = seqpar.check_associative_fold
    monkeypatch.setattr(seqpar, "check_associative_fold",
                        lambda *a, **k: (calls.append(1), real(*a, **k)))
    for _ in range(2):
        eng = ReplayEngine(good, Config(overrides=ov), device="cpu")
        eng.replay_resident(eng.prepare_resident(col))
    assert len(calls) == 1 and len(seqpar._VALIDATED) == 1


def _counter_logs():
    from surge_tpu.codec.tensor import encode_events_columnar

    from tests.test_replay_seqpar import _long_logs

    return encode_events_columnar(jcounter.make_registry(), _long_logs(40, 30, seed=9))


def test_fold_keys_are_structural():
    for mod in (counter, bank_account, shopping_cart):
        fresh = [mod.make_associative_fold.__wrapped__() for _ in range(2)]
        assert fresh[0] is not fresh[1]
        assert seqpar.fold_key(fresh[0]) == seqpar.fold_key(fresh[1])
        assert seqpar.fold_key(mod.make_associative_fold()) == seqpar.fold_key(fresh[0])
    keys = {seqpar.fold_key(m.make_associative_fold())
            for m in (counter, bank_account, shopping_cart)}
    assert len(keys) == 3
    # the validation key ties the fold to one spec's handlers
    assert seqpar._spec_key(counter.make_replay_spec()) == \
        seqpar._spec_key(counter.make_replay_spec())
    assert seqpar._spec_key(counter.make_replay_spec()) != \
        seqpar._spec_key(shopping_cart.make_replay_spec())


def test_assoc_needs_a_fold_and_a_power_of_two_width():
    spec = saga.make_replay_spec()  # the saga family ships no fold
    assert spec.associative is None
    eng = ReplayEngine(spec, Config(overrides={"surge.replay.tile-backend": "assoc"}),
                       device="cpu")
    with pytest.raises(ValueError, match="AssociativeFold"):
        eng.tile_backend
    with pytest.raises(ValueError, match="power-of-two"):
        tengine._make_assoc_body(counter.make_replay_spec(), None, 12)
    eng = ReplayEngine(counter.make_replay_spec(), Config(overrides={
        "surge.replay.tile-backend": "assoc", "surge.replay.min-time-window": 12,
        "surge.replay.time-chunk": 24, "surge.replay.batch-size": 32}),
        device="cpu")
    assert eng.resident_tile_width() == 24
    with pytest.raises(ValueError, match="power-of-two"):
        eng.replay_resident(eng.prepare_resident(_port_events(_counter_logs())))


def _corpus(model):
    if model == "counter":
        return _port_events(_counter_logs())
    if model == "bank_account":
        return _port_events(_bank_logs())
    return _columnar(model, _logs(model, 200, seed=43), derived=True)


@pytest.mark.parametrize("layout", ["flat", "dense"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_assoc_replay_matches_the_reference(model, layout):
    from surge_tpu.codec.tensor import ColumnarEvents as JColumnarEvents

    col = _corpus(model)
    ov = {"surge.replay.batch-size": 64, "surge.replay.time-chunk": 8,
          "surge.replay.tile-backend": "assoc",
          "surge.replay.resident-layout": layout}
    mod, jmod = MODELS[model]
    eng = ReplayEngine(mod.make_replay_spec(), Config(overrides=ov), device="cpu")
    assert eng.tile_backend == "assoc"
    res = eng.prepare_resident(col)
    eng.warm_resident(res)
    got = eng.replay_resident(res).states
    plain = ReplayEngine(mod.make_replay_spec(), Config(overrides=dict(
        ov, **{"surge.replay.tile-backend": "xla"})), device="cpu")
    _same({k: torch.from_numpy(v) for k, v in got.items()},
          plain.replay_resident(plain.prepare_resident(col)).states)
    jcol = JColumnarEvents(num_aggregates=col.num_aggregates, agg_idx=col.agg_idx,
                           type_ids=col.type_ids, cols=dict(col.cols),
                           derived_cols=dict(col.derived_cols))
    jeng = JEngine(jmod.make_replay_spec(), config=JConfig(overrides=ov))
    assert jeng.tile_backend == "assoc"
    _same({k: torch.from_numpy(v) for k, v in got.items()},
          jeng.replay_resident(jeng.prepare_resident(jcol)).states)
