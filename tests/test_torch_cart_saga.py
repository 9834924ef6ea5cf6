"""The shopping_cart and saga families of the port (surge_tpu_torch.models.
shopping_cart, surge_tpu_torch.saga.model) against the reference's
(surge_tpu.models.shopping_cart, surge_tpu.saga.model) on the same numpy
inputs: registries and wire layouts, the one-event step under both dispatches
with padding, corrupt type ids and the shift and overflow edges, the plain
batch fold, and resident cold replay (both layouts, resumed folds) against the
reference engine's xla backend. Every comparison is byte for byte."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surge_tpu.codec.tensor import encode_events_columnar as jencode_columnar
from surge_tpu.codec.wire import WireFormat as JWireFormat
from surge_tpu.config import Config as JConfig
from surge_tpu.models import shopping_cart as jcart
from surge_tpu.replay.engine import ReplayEngine as JEngine
from surge_tpu.replay.engine import make_batch_fold as jmake_batch_fold
from surge_tpu.replay.engine import make_step_fn as jmake_step_fn
from surge_tpu.saga import model as jsaga
from surge_tpu.testing.support import random_cart_log, random_saga_log
from surge_tpu_torch.codec.tensor import ColumnarEvents
from surge_tpu_torch.codec.wire import WireFormat
from surge_tpu_torch.config import Config
from surge_tpu_torch.models import shopping_cart
from surge_tpu_torch.replay.engine import (ReplayEngine, make_batch_fold,
                                           make_step_fn)
from surge_tpu_torch.saga import model as saga
from tests.test_torch_isolation import leave_the_worker_as_found  # noqa: F401

MODELS = {
    "shopping_cart": (shopping_cart, jcart, random_cart_log),
    "saga": (saga, jsaga, random_saga_log),
}
DERIVED = {"side": {}, "derived": {"sequence_number": "ordinal"}}
#: shift amounts of the saga's ``1 << num_steps`` and ``1 << step``: inside,
#: at and past the word, and negative
SHIFTS = np.array([0, 1, 5, 6, 30, 31, 32, 33, 40, -1, -32, 1 << 30], np.int32)


def _t(d):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        w = np.asarray(want[k])
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), k


def _random(fields, shape, rng):
    out = {}
    for f in fields:
        dt = np.dtype(f.dtype)
        if dt == np.bool_:
            out[f.name] = rng.random(shape) < 0.5
        elif dt == np.float32:
            # every bit pattern: NaN payloads, -0.0 and infinities pass through
            out[f.name] = rng.integers(0, 1 << 32, size=shape,
                                       dtype=np.uint64).astype(np.uint32).view(np.float32)
        else:
            v = rng.integers(-(1 << 31), 1 << 31, size=shape, dtype=np.int64)
            out[f.name] = v.astype(np.int32)
    return out


def _batch(model, shape, rng):
    """(state, events) numpy batches of the family; type ids include -1 and
    corrupt ids; cart quantities and prices whose products pass 2^31; saga
    shifts at every edge and masks that complete or compensate."""
    mod = MODELS[model][0]
    reg = mod.make_registry()
    state = _random(reg.state.fields, shape[-1:], rng)
    events = _random(reg.union_columns(), shape, rng)
    n = shape[-1]
    if model == "shopping_cart":
        big = rng.random(shape) < 0.5
        events["quantity"] = np.where(big, rng.integers(40_000, 70_000, size=shape),
                                      rng.integers(1, 4, size=shape)).astype(np.int32)
        events["unit_price_cents"] = np.where(
            big, rng.integers(40_000, 70_000, size=shape),
            rng.integers(100, 900, size=shape)).astype(np.int32)
    else:
        num = rng.choice(SHIFTS, size=n)
        state["num_steps"] = num
        full = np.where((num >= 0) & (num < 32),
                        (np.int64(1) << np.clip(num, 0, 31)) - 1, -1)
        full = full.astype(np.int64).astype(np.uint32).view(np.int32)
        step = rng.choice(SHIFTS, size=shape)
        events["step"] = step
        # committed: the full mask but the bit the event sets, often enough
        # to reach COMPLETED; compensated: committed but that bit
        bit = np.where((step >= 0) & (step < 32),
                       np.left_shift(np.int64(1), np.clip(step, 0, 31)), 0)
        bit = bit.astype(np.int64).astype(np.uint32).view(np.int32)
        lane_bit = bit.reshape(-1, n)[0]
        state["committed"] = np.where(rng.random(n) < 0.5, full & ~lane_bit,
                                      state["committed"]).astype(np.int32)
        state["compensated"] = np.where(rng.random(n) < 0.5,
                                        state["committed"] & ~lane_bit,
                                        state["compensated"]).astype(np.int32)
        state["committed"][:3] = 0
    events["type_id"] = rng.choice(
        np.array([-1, 0, 1, 2, 3, 4, 5, 7, 99], np.int32), size=shape)
    return state, events


@pytest.mark.parametrize("derived", sorted(DERIVED))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_registry_and_wire_match_the_reference(model, derived):
    mod, jmod, _ = MODELS[model]
    reg, jreg = mod.make_registry(), jmod.make_registry()
    fields = lambda fs: [(f.name, str(f.dtype), f.bits) for f in fs]  # noqa: E731
    assert fields(reg.state.fields) == fields(jreg.state.fields)
    assert fields(reg.union_columns()) == fields(jreg.union_columns())
    assert [(s.type_id, s.cls.__name__, fields(s.fields)) for s in reg.event_schemas] \
        == [(s.type_id, s.cls.__name__, fields(s.fields)) for s in jreg.event_schemas]
    wire = WireFormat(reg, DERIVED[derived])
    jwire = JWireFormat(jreg, DERIVED[derived])
    assert wire.layout_fingerprint() == jwire.layout_fingerprint()
    assert wire.nbytes == jwire.nbytes == 1
    assert wire.wire_bytes_per_event() == jwire.wire_bytes_per_event()
    assert [f.name for f in wire.side_fields] == [f.name for f in jwire.side_fields]
    # the wire sizes the kernels plan for: cart 1 + 12 (or 16) bytes, saga
    # 1 + 28 (or 32)
    side = {"shopping_cart": 3, "saga": 7}[model] + (derived == "side")
    assert wire.wire_bytes_per_event() == 1 + 4 * side
    spec, jspec = mod.make_replay_spec(), jmod.make_replay_spec()
    _same(_t(spec.init_state_tree()), jspec.init_state_tree())


@pytest.mark.parametrize("dispatch", ["switch", "select"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_step_matches_the_reference(model, dispatch):
    mod, jmod, _ = MODELS[model]
    spec, jspec = mod.make_replay_spec(), jmod.make_replay_spec()
    state, events = _batch(model, (613,), np.random.default_rng(21))
    got = make_step_fn(spec, dispatch)(_t(state), _t(events))
    want = jax.vmap(jmake_step_fn(jspec, dispatch), in_axes=(0, 0))(
        _j(state), _j(events))
    _same(got, want)
    pad = (events["type_id"] < 0) | (events["type_id"] >= spec.registry.num_event_types)
    for k, v in got.items():
        assert v.numpy()[pad].tobytes() == state[k][pad].tobytes()


@pytest.mark.parametrize("model", sorted(MODELS))
def test_switch_matches_select(model):
    spec = MODELS[model][0].make_replay_spec()
    state, events = _batch(model, (301,), np.random.default_rng(22))
    a = make_step_fn(spec, "switch")(_t(state), _t(events))
    b = make_step_fn(spec, "select")(_t(state), _t(events))
    _same(a, {k: v.numpy() for k, v in b.items()})


@pytest.mark.parametrize("dispatch", ["switch", "select"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_batch_fold_matches_the_reference(model, dispatch):
    mod, jmod, _ = MODELS[model]
    state, events = _batch(model, (11, 140), np.random.default_rng(23))
    got = make_batch_fold(mod.make_replay_spec(), dispatch=dispatch)(
        _t(state), _t(events))
    want = jmake_batch_fold(jmod.make_replay_spec(), dispatch=dispatch)(
        _j(state), _j(events))
    _same(got, want)


def test_saga_shift_edges_read_from_the_reference():
    """A SagaStepCommitted onto a saga of ``num_steps`` in {0, 1, 6, 31, 32,
    40} whose other bits are all committed: the reference's
    ``jnp.left_shift(1, n) - 1`` is 0, 1, 63, INT32_MAX, -1, -1 (a shift past
    the word gives 0), so a saga of 0 steps never completes and one of 32 or
    40 completes once all 32 bits are committed; the port reads the same."""
    n = np.array([0, 1, 6, 31, 32, 40], np.int32)
    want_full = np.array([0, 1, 63, 0x7FFFFFFF, -1, -1], np.int32)
    assert np.asarray(jnp.left_shift(jnp.int32(1), jnp.asarray(n)) - 1).tobytes() \
        == want_full.tobytes()
    assert (saga._shift(torch.from_numpy(n)) - 1).numpy().tobytes() == want_full.tobytes()
    step = np.array([0, 0, 5, 30, 31, 31], np.int32)
    bit = np.left_shift(np.int64(1), step).astype(np.uint32).view(np.int32)
    state = _random(saga.make_registry().state.fields, (6,),
                    np.random.default_rng(24))
    state["num_steps"] = n
    state["committed"] = (want_full & ~bit).astype(np.int32)
    events = _random(saga.make_registry().union_columns(), (6,),
                     np.random.default_rng(25))
    events["type_id"] = np.full(6, saga.STEP_COMMITTED, np.int32)
    events["step"] = step
    for dispatch in ("switch", "select"):
        got = make_step_fn(saga.make_replay_spec(), dispatch)(_t(state), _t(events))
        want = jax.vmap(jmake_step_fn(jsaga.make_replay_spec(), dispatch))(
            _j(state), _j(events))
        _same(got, want)
        assert got["status"].tolist() == [saga.RUNNING] + [saga.COMPLETED] * 5


def test_cart_product_wraps_as_the_reference():
    q = np.array([50_000, 65_535, 3, 46_341], np.int32)
    p = np.array([50_000, 65_537, 899, 46_341], np.int32)
    state = {"item_count": np.zeros(4, np.int32),
             "total_cents": np.array([0, 7, -5, 2**31 - 1], np.int32),
             "checked_out": np.zeros(4, bool), "version": np.zeros(4, np.int32)}
    events = {"type_id": np.array([0, 1, 0, 0], np.int32), "item_code": q,
              "quantity": q, "unit_price_cents": p,
              "sequence_number": np.arange(1, 5, dtype=np.int32)}
    got = make_step_fn(shopping_cart.make_replay_spec(), "select")(_t(state), _t(events))
    want = jax.vmap(jmake_step_fn(jcart.make_replay_spec(), "select"))(
        _j(state), _j(events))
    _same(got, want)
    wrapped = (state["total_cents"].astype(np.int64)
               + np.array([1, -1, 1, 1]) * q.astype(np.int64) * p)
    assert got["total_cents"].numpy().tolist() == \
        wrapped.astype(np.uint32).view(np.int32).tolist()


# -- resident cold replay against the reference engine ------------------------------


def _logs(model, n, seed):
    rng = random.Random(seed)
    return [MODELS[model][2](rng, f"{model}-{i}") for i in range(n)]


def _columnar(model, logs, derived: bool):
    jcol = jencode_columnar(MODELS[model][1].make_registry(), logs)
    cols = dict(jcol.cols)
    derived_cols = {}
    if derived:  # the command path numbers each log 1, 2, ...: derivable
        cols.pop("sequence_number")
        derived_cols = {"sequence_number": "ordinal"}
    return ColumnarEvents(num_aggregates=jcol.num_aggregates, agg_idx=jcol.agg_idx,
                          type_ids=jcol.type_ids, cols=cols,
                          derived_cols=derived_cols)


def _jax_states(model, col, overrides, **kw):
    from surge_tpu.codec.tensor import ColumnarEvents as JColumnarEvents

    jcol = JColumnarEvents(num_aggregates=col.num_aggregates, agg_idx=col.agg_idx,
                           type_ids=col.type_ids, cols=dict(col.cols),
                           derived_cols=dict(col.derived_cols))
    eng = JEngine(MODELS[model][1].make_replay_spec(),
                  config=JConfig(overrides=dict(overrides, **{
                      "surge.replay.tile-backend": "xla"})))
    return eng.replay_resident(eng.prepare_resident(jcol), **kw).states


def _port_states(model, col, overrides, **kw):
    eng = ReplayEngine(MODELS[model][0].make_replay_spec(),
                       Config(overrides=overrides), device="cpu")
    res = eng.prepare_resident(col)
    eng.warm_resident(res)
    return eng.replay_resident(res, **kw).states


@pytest.mark.parametrize("derived", [False, True])
@pytest.mark.parametrize("layout", ["flat", "dense"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_resident_replay_matches_the_reference(model, layout, derived):
    col = _columnar(model, _logs(model, 150, seed=31), derived)
    ov = {"surge.replay.batch-size": 64, "surge.replay.time-chunk": 8,
          "surge.replay.tile-backend": "xla", "surge.replay.resident-layout": layout}
    got = _port_states(model, col, ov)
    want = _jax_states(model, col, ov)
    _same({k: torch.from_numpy(v) for k, v in got.items()}, want)
    assert got["version"].any()


@pytest.mark.parametrize("model", sorted(MODELS))
def test_resumed_replay_matches_the_reference(model):
    """The second half of each log from the first half's states
    (``init_carry``) and event counts (``ordinal_base``), derived ordinal."""
    logs = _logs(model, 120, seed=32)
    cut = [len(log) // 2 for log in logs]
    first = _columnar(model, [log[:c] for log, c in zip(logs, cut)], True)
    second = _columnar(model, [log[c:] for log, c in zip(logs, cut)], True)
    ov = {"surge.replay.batch-size": 32, "surge.replay.time-chunk": 8,
          "surge.replay.tile-backend": "xla"}
    base = np.asarray(cut, np.int32)
    r1 = _port_states(model, first, ov)
    got = _port_states(model, second, ov, init_carry=r1, ordinal_base=base)
    want = _jax_states(model, second, ov, init_carry=_jax_states(model, first, ov),
                       ordinal_base=base)
    _same({k: torch.from_numpy(v) for k, v in got.items()}, want)
    whole = _port_states(model, _columnar(model, logs, True), ov)
    _same({k: torch.from_numpy(v) for k, v in got.items()}, whole)
