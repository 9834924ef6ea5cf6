"""K1's tile fold (surge_tpu_torch.replay.fold_kernels): its plain torch
version ``tile_scan_reference``, the tile-interior fold of the list fold's and
the dense refresh window's plain versions, against the reference's Pallas
kernel ``make_tile_scan`` run in interpret mode, byte for byte; and the decode
arguments every kernel takes. The dense window's wrapper and kernel are held
in tests/test_torch_refresh_window.py, the list fold in
tests/test_torch_tile_list.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surge_tpu.codec.wire import WireFormat as JWire
from surge_tpu.models import bank_account as jbank
from surge_tpu.models import counter as jcounter
from surge_tpu.replay.pallas_fold import make_tile_scan
from surge_tpu_torch.codec.schema import SchemaRegistry
from surge_tpu_torch.codec.wire import WireFormat
from surge_tpu_torch.models import bank_account, counter
from surge_tpu_torch.replay import fold_kernels
from tests.test_torch_isolation import leave_the_worker_as_found  # noqa: F401

CASES = {
    "counter-derived": (counter.make_replay_spec, jcounter.make_replay_spec,
                        {"sequence_number": "ordinal"}),
    "counter-side": (counter.make_replay_spec, jcounter.make_replay_spec, {}),
    "bank": (bank_account.make_replay_spec, jbank.make_replay_spec, {}),
}


def _inputs(spec, wire, width, bs, seed):
    """Random tile inputs (numpy): full 32-bit words (corrupt type ids, stray
    high bits), negative and over-long lens_rel, ordinals near int32 max."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(width, bs), dtype=np.uint64).astype(np.uint32)
    sides = {}
    for f in wire.side_fields:
        if np.dtype(f.dtype) == np.float32:
            sides[f.name] = rng.standard_normal((width, bs)).astype(np.float32)
        else:
            sides[f.name] = rng.integers(-(1 << 31), 1 << 31, size=(width, bs),
                                         dtype=np.int64).astype(np.int32)
    lens = rng.integers(-width, width + 4, size=bs).astype(np.int32)
    lens[:3] = (-(1 << 29), 0, width)
    ordr = rng.integers(0, 1 << 31, size=bs, dtype=np.int64).astype(np.int32)
    ordr[0] = np.iinfo(np.int32).max
    carry = {}
    for f in spec.registry.state.fields:
        dt = np.dtype(f.dtype)
        if dt == np.bool_:
            carry[f.name] = rng.random(bs) < 0.5
        elif dt == np.float32:
            carry[f.name] = rng.standard_normal(bs).astype(np.float32)
        else:
            carry[f.name] = rng.integers(-(1 << 31), 1 << 31, size=bs,
                                         dtype=np.int64).astype(np.int32)
    return carry, words, sides, lens, ordr


def _torch_args(carry, words, sides, lens, ordr, device="cpu"):
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return ({k: to(v) for k, v in carry.items()}, to(words.view(np.int32)),
            {k: to(v) for k, v in sides.items()}, to(lens), to(ordr))


@pytest.mark.parametrize("bs", [256, 200])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_tile_scan_matches_pallas_interpret(case, bs):
    mk, jmk, derived = CASES[case]
    spec, jspec = mk(), jmk()
    wire, jwire = WireFormat(spec.registry, derived), JWire(jspec.registry, derived)
    width = 16
    carry, words, sides, lens, ordr = _inputs(spec, wire, width, bs, seed=bs)
    got = fold_kernels.tile_scan_reference(
        *_torch_args(carry, words, sides, lens, ordr), spec=spec, wire=wire)
    want = make_tile_scan(jspec, jwire, width, bs, 1)(
        {k: jnp.asarray(v) for k, v in carry.items()}, jnp.asarray(words),
        {k: jnp.asarray(v) for k, v in sides.items()}, jnp.asarray(lens),
        jnp.asarray(ordr))
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), k
    # the caller's carry is not written
    assert all(np.array_equal(a, carry[k]) for k, a in
               _torch_args(carry, words, sides, lens, ordr)[0].items())


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_args_describe_the_wire(case):
    mk, _, derived = CASES[case]
    spec = mk()
    wire = WireFormat(spec.registry, derived)
    step_id, dec = fold_kernels._decode_args(spec.kernel_step, spec.registry, wire)
    assert list(fold_kernels.KERNEL_STEPS)[step_id] == spec.kernel_step
    names = fold_kernels.KERNEL_STEPS[spec.kernel_step][1]
    union = {f.name: f for f in spec.registry.union_columns()}
    assert fold_kernels._describe(dec, names, union) == wire.layout_fingerprint()


def test_decode_args_refuse_what_the_kernel_cannot_fold():
    spec = counter.make_replay_spec()
    wire = WireFormat(spec.registry, {})
    with pytest.raises(ValueError, match="no step"):
        fold_kernels._decode_args(None, spec.registry, wire)
    # the bank step cannot fold the counter schema
    with pytest.raises(ValueError, match="folds state"):
        fold_kernels._decode_args("bank_account", spec.registry, wire)
    # a float64 side column is not something the kernel reads
    reg = SchemaRegistry()
    reg.register_event(bank_account.EncodedCreated, type_id=0,
                       overrides={"balance": np.float64})
    reg.register_event(bank_account.EncodedUpdated, type_id=1)
    reg.register_state(bank_account.EncodedAccountState)
    with pytest.raises(ValueError, match="side column 'balance'"):
        fold_kernels._decode_args("bank_account", reg, WireFormat(reg, {}))
