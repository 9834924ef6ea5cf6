"""The port's wire codec (surge_tpu_torch.codec.wire) against the reference's
(surge_tpu.codec.wire): identical pack bytes, and a torch decode equal bit for
bit to the JAX decode on the same inputs — corrupt type ids, invalid slots, a
layout whose 32nd bit is set, and derived ordinals near int32 overflow."""

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surge_tpu.codec.schema import SchemaRegistry as JRegistry
from surge_tpu.codec.wire import WireFormat as JWire
from surge_tpu.models import bank_account as jbank
from surge_tpu.models import counter as jcounter
from surge_tpu_torch.codec.schema import SchemaRegistry
from surge_tpu_torch.codec.wire import WireFormat
from surge_tpu_torch.models import bank_account, counter
from tests.test_torch_isolation import leave_the_worker_as_found  # noqa: F401


@dataclass(frozen=True)
class WideA:
    a: int


@dataclass(frozen=True)
class WideB:
    b: int


def _wide_registry(cls):
    """Two event types (2 type bits) and a 30-bit field: 32 packed bits, so a
    word's top bit is set whenever ``a >= 2**29``."""
    reg = cls()
    reg.register_event(WideA, type_id=0, bits={"a": 30})
    reg.register_event(WideB, type_id=1, bits={"b": 1})
    reg.register_state(WideA)
    return reg


LAYOUTS = {
    "counter-derived": (counter.make_registry, jcounter.make_registry,
                        {"sequence_number": "ordinal"}),
    "counter-side": (counter.make_registry, jcounter.make_registry, {}),
    "bank": (bank_account.make_registry, jbank.make_registry, {}),
    "wide32": (lambda: _wide_registry(SchemaRegistry),
               lambda: _wide_registry(JRegistry), {}),
}


def _wires(name):
    mk, jmk, derived = LAYOUTS[name]
    return WireFormat(mk(), derived), JWire(jmk(), derived)


def _columns(wire, n, rng):
    """Random flat event columns for ``wire``: type ids with padding (-1) and
    corrupt positive ids, packed fields across their full width."""
    tids = rng.integers(-1, wire.num_types + 3, size=n).astype(np.int32)
    cols = {}
    for pf in wire.packed_fields:
        cols[pf.name] = rng.integers(0, pf.mask + 1, size=n,
                                     dtype=np.int64).astype(np.int32)
    for f in wire.side_fields:
        if np.dtype(f.dtype) == np.float32:
            cols[f.name] = rng.standard_normal(n).astype(np.float32)
        else:
            cols[f.name] = rng.integers(-(1 << 31), 1 << 31, size=n,
                                        dtype=np.int64).astype(np.int32)
    for f in wire.derived_fields:
        cols[f.name] = np.zeros(n, dtype=np.int32)
    return tids, cols


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pack_flat_bytes_and_fingerprint_match(layout):
    wire, jwire = _wires(layout)
    assert wire.layout_fingerprint() == jwire.layout_fingerprint()
    assert wire.wire_bytes_per_event() == jwire.wire_bytes_per_event()
    tids, cols = _columns(wire, 3000, np.random.default_rng(1))
    packed, side = wire.pack_flat(tids, cols)
    jpacked, jside = jwire.pack_flat(tids, cols)
    assert packed.dtype == jpacked.dtype and packed.tobytes() == jpacked.tobytes()
    assert sorted(side) == sorted(jside)
    for k in side:
        assert side[k].tobytes() == jside[k].tobytes()


def test_wide_layout_sets_the_top_bit():
    wire, _ = _wires("wide32")
    assert wire.total_bits == 32 and wire.nbytes == 4
    tids = np.zeros(2, np.int32)
    assert [f.name for f in wire.side_fields] == ["b"]  # 33 bits: b spills
    packed, side = wire.pack_flat(tids, {"a": np.array([1 << 29, (1 << 30) - 1], np.int32),
                                         "b": np.zeros(2, np.int32)})
    words = wire.expand_flat(torch.from_numpy(packed))
    assert (words < 0).all()  # int32 bit pattern of a u32 with bit 31 set
    ev = wire.decode_words(words, {"b": torch.from_numpy(side["b"])},
                           torch.ones(2, dtype=torch.bool),
                           torch.zeros(2, dtype=torch.int32), 0)
    assert ev["a"].tolist() == [1 << 29, (1 << 30) - 1]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_expand_and_decode_words_match_jax(layout):
    wire, jwire = _wires(layout)
    rng = np.random.default_rng(2)
    n = 4096
    tids, cols = _columns(wire, n, rng)
    packed, side = wire.pack_flat(tids, cols)
    words = wire.expand_flat(torch.from_numpy(packed))
    jwords = np.asarray(jwire.expand_flat(jnp.asarray(packed)))
    assert jwords.dtype == np.uint32
    _same(words, jwords.view(np.int32))

    # decode_words also takes arbitrary 32-bit words (corrupt ids and bits
    # above the layout), invalid slots, and ordinal bases near int32 max
    raw = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    valid = rng.random(n) < 0.8
    ord_base = rng.integers(0, 1 << 31, size=n, dtype=np.int64).astype(np.int32)
    ord_base[:3] = np.iinfo(np.int32).max
    for t in (0, 5):
        ev = wire.decode_words(torch.from_numpy(raw.view(np.int32)),
                               {k: torch.from_numpy(v) for k, v in side.items()},
                               torch.from_numpy(valid), torch.from_numpy(ord_base), t)
        jev = jwire.decode_words(jnp.asarray(raw), {k: jnp.asarray(v) for k, v in side.items()},
                                 jnp.asarray(valid), jnp.asarray(ord_base), np.int32(t))
        assert sorted(ev) == sorted(jev)
        for k in ev:
            _same(ev[k], jev[k])
        assert (ev["type_id"].numpy()[~valid] == -1).all()


@pytest.mark.parametrize("layout", ["counter-derived", "bank", "wide32"])
def test_decode_window_matches_jax(layout):
    wire, jwire = _wires(layout)
    rng = np.random.default_rng(3)
    b, t = 24, 12
    tids, cols = _columns(wire, b * t, rng)
    tids = tids.reshape(b, t)
    cols = {k: v.reshape(b, t) for k, v in cols.items()}
    packed, side = wire.pack_window(tids, cols, 0, 9, 16, 32)  # padded rows/lanes
    jpacked, jside = jwire.pack_window(tids, cols, 0, 9, 16, 32)
    assert packed.tobytes() == jpacked.tobytes()
    ord_base = rng.integers(0, 1 << 31, size=32, dtype=np.int64).astype(np.int32)
    ev = wire.decode(torch.from_numpy(packed), {k: torch.from_numpy(v) for k, v in side.items()},
                     torch.from_numpy(ord_base))
    jev = jwire.decode(jnp.asarray(packed), {k: jnp.asarray(v) for k, v in side.items()},
                       jnp.asarray(ord_base))
    assert sorted(ev) == sorted(jev)
    for k in ev:
        _same(ev[k], jev[k])


def test_columnar_encoding_and_state_codec_match_the_reference():
    from surge_tpu.codec.tensor import decode_states as jdecode_states
    from surge_tpu.codec.tensor import encode_events_columnar as jencode
    from surge_tpu.codec.tensor import encode_states as jencode_states
    from surge_tpu_torch.codec.tensor import (decode_states, encode_events_columnar,
                                              encode_states)

    rng = np.random.default_rng(4)
    logs, jlogs = [], []
    for i in range(40):
        log, jlog = [], []
        for s in range(int(rng.integers(0, 7))):
            inc = int(rng.integers(0, 4))
            if rng.random() < 0.5:
                log.append(counter.CountIncremented(str(i), inc, s + 1))
                jlog.append(jcounter.CountIncremented(str(i), inc, s + 1))
            else:
                log.append(counter.UnserializableEvent(str(i), s + 1, "x"))
                jlog.append(jcounter.UnserializableEvent(str(i), s + 1, "x"))
        logs.append(log)
        jlogs.append(jlog)
    got = encode_events_columnar(counter.make_registry(), logs)
    want = jencode(jcounter.make_registry(), jlogs)
    assert got.num_aggregates == want.num_aggregates
    assert got.agg_idx.tobytes() == want.agg_idx.tobytes()
    assert got.type_ids.tobytes() == want.type_ids.tobytes()
    assert sorted(got.cols) == sorted(want.cols)
    for k in got.cols:
        assert got.cols[k].tobytes() == want.cols[k].tobytes()

    states = [counter.State(str(i), i - 20, i) for i in range(40)]
    jstates = [jcounter.State(str(i), i - 20, i) for i in range(40)]
    tree = encode_states(counter.make_registry().state, states)
    jtree = jencode_states(jcounter.make_registry().state, jstates)
    for k in jtree:
        assert tree[k].tobytes() == jtree[k].tobytes()
    back = decode_states(counter.make_registry().state, tree)
    jback = jdecode_states(jcounter.make_registry().state, jtree)
    assert [(s.count, s.version) for s in back] == [(s.count, s.version) for s in jback]
