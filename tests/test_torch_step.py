"""The port's one-event step (surge_tpu_torch.replay.engine.make_step_fn) and
plain batch fold against the reference's JAX step on the same random batches:
padding (-1) and corrupt positive type ids carry state through, int32 sums wrap,
and states agree byte for byte under both dispatches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surge_tpu.models import bank_account as jbank
from surge_tpu.models import counter as jcounter
from surge_tpu.replay.engine import make_batch_fold as jmake_batch_fold
from surge_tpu.replay.engine import make_step_fn as jmake_step_fn
from surge_tpu_torch.models import bank_account, counter
from surge_tpu_torch.replay.engine import make_batch_fold, make_step_fn
from tests.test_torch_isolation import leave_the_worker_as_found  # noqa: F401

MODELS = {
    "counter": (counter.make_replay_spec, jcounter.make_replay_spec),
    "bank_account": (bank_account.make_replay_spec, jbank.make_replay_spec),
}


def _random(fields, shape, rng):
    out = {}
    for f in fields:
        dt = np.dtype(f.dtype)
        if dt == np.bool_:
            out[f.name] = rng.random(shape) < 0.5
        elif dt == np.float32:
            out[f.name] = (rng.integers(-4000, 4000, size=shape) * 0.25).astype(np.float32)
        else:
            v = rng.integers(-(1 << 31), 1 << 31, size=shape, dtype=np.int64)
            out[f.name] = v.astype(np.int32)
    return out


def _batch(spec, shape, rng):
    """(state, events) numpy batches; type ids include -1 and corrupt ids."""
    reg = spec.registry
    state = _random(reg.state.fields, shape[-1:], rng)
    state["count" if "count" in state else "owner_code"][:2] = np.iinfo(np.int32).max
    events = _random(reg.union_columns(), shape, rng)
    for name in ("increment_by", "decrement_by"):
        if name in events:
            events[name] = rng.integers(0, 4, size=shape).astype(np.int32)
    events["type_id"] = rng.choice(
        np.array([-1, 0, 1, 2, 3, 4, 7, 99], np.int32)[: reg.num_event_types + 5],
        size=shape).astype(np.int32)
    return state, events


def _t(d):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("dispatch", ["switch", "select"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_step_matches_jax(model, dispatch):
    mk, jmk = MODELS[model]
    spec, jspec = mk(), jmk()
    state, events = _batch(spec, (517,), np.random.default_rng(11))
    got = make_step_fn(spec, dispatch)(_t(state), _t(events))
    want = jax.vmap(jmake_step_fn(jspec, dispatch), in_axes=(0, 0))(
        {k: jnp.asarray(v) for k, v in state.items()},
        {k: jnp.asarray(v) for k, v in events.items()})
    _assert_same(got, want)
    # out-of-range ids never dispatch
    pad = (events["type_id"] < 0) | (events["type_id"] >= spec.registry.num_event_types)
    for k, v in got.items():
        assert (v.numpy()[pad] == state[k][pad]).all()


@pytest.mark.parametrize("model", sorted(MODELS))
def test_switch_matches_select(model):
    spec = MODELS[model][0]()
    state, events = _batch(spec, (301,), np.random.default_rng(12))
    a = make_step_fn(spec, "switch")(_t(state), _t(events))
    b = make_step_fn(spec, "select")(_t(state), _t(events))
    _assert_same(a, {k: v.numpy() for k, v in b.items()})


def test_step_does_not_write_its_input_state():
    spec = counter.make_replay_spec()
    state, events = _batch(spec, (64,), np.random.default_rng(13))
    before = {k: v.copy() for k, v in state.items()}
    ts = _t(state)
    for dispatch in ("switch", "select"):
        make_step_fn(spec, dispatch)(ts, _t(events))
    for k in before:
        assert ts[k].numpy().tobytes() == before[k].tobytes()


def test_unknown_dispatch_raises():
    with pytest.raises(ValueError, match="unknown dispatch"):
        make_step_fn(counter.make_replay_spec(), "branchy")


@pytest.mark.parametrize("dispatch", ["switch", "select"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_batch_fold_matches_jax(model, dispatch):
    mk, jmk = MODELS[model]
    spec, jspec = mk(), jmk()
    state, events = _batch(spec, (9, 130), np.random.default_rng(14))
    got = make_batch_fold(spec, dispatch=dispatch)(_t(state), _t(events))
    want = jmake_batch_fold(jspec, dispatch=dispatch)(
        {k: jnp.asarray(v) for k, v in state.items()},
        {k: jnp.asarray(v) for k, v in events.items()})
    _assert_same(got, want)
