"""K2's fold (surge_tpu_torch.replay.fold_kernels.ragged_fold_reference, the
fold inside the ragged refresh window's plain version) against the reference's
Pallas kernel ``make_ragged_fold`` run in interpret mode, byte for byte, with
clipped tail reads, empty and over-long lanes and shifted (chained-window)
starts. The window's wrapper and kernel are held in
tests/test_torch_refresh_window.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surge_tpu.codec.wire import WireFormat as JWire
from surge_tpu.models import bank_account as jbank
from surge_tpu.models import counter as jcounter
from surge_tpu.replay.pallas_fold import make_ragged_fold
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
WIDTH, ROWS = 16, 512


def _inputs(spec, wire, bs, rows, width, shift, seed):
    """Random K2 inputs (numpy): full 32-bit words (corrupt type ids, stray
    high bits), lens of 0 and past the width, lanes whose reads clip at the
    last row, starts at or past ``shift``, ordinals near int32 max."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=rows, dtype=np.uint64).astype(np.uint32)
    sides = {}
    for f in wire.side_fields:
        if np.dtype(f.dtype) == np.float32:
            sides[f.name] = rng.standard_normal(rows).astype(np.float32)
        else:
            sides[f.name] = rng.integers(-(1 << 31), 1 << 31, size=rows,
                                         dtype=np.int64).astype(np.int32)
    starts = (rng.integers(0, rows - shift, size=bs) + shift).astype(np.int32)
    starts[:4] = (rows - 1, rows - width // 2, rows - 1, shift)
    lens = rng.integers(0, width + 6, size=bs).astype(np.int32)
    lens[:4] = (width, width + 3, 0, width)
    ordv = rng.integers(0, 1 << 31, size=bs, dtype=np.int64).astype(np.int32)
    ordv[0] = np.iinfo(np.int32).max
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
    return carry, words, sides, starts, lens, ordv


def _torch_args(carry, words, sides, starts, lens, ordv, device="cpu"):
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return ({k: to(v) for k, v in carry.items()}, to(words.view(np.int32)),
            {k: to(v) for k, v in sides.items()}, to(starts), to(lens), to(ordv))


@pytest.mark.parametrize("shift", [0, 200])
@pytest.mark.parametrize("bs", [256, 200])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_ragged_fold_matches_pallas_interpret(case, bs, shift):
    mk, jmk, derived = CASES[case]
    spec, jspec = mk(), jmk()
    wire, jwire = WireFormat(spec.registry, derived), JWire(jspec.registry, derived)
    carry, words, sides, starts, lens, ordv = _inputs(spec, wire, bs, ROWS, WIDTH,
                                                      shift, seed=bs + shift)
    got = fold_kernels.ragged_fold_reference(
        *_torch_args(carry, words, sides, starts, lens, ordv),
        width=WIDTH, spec=spec, wire=wire)
    want = make_ragged_fold(jspec, jwire, WIDTH, bs, ROWS, 1)(
        {k: jnp.asarray(v) for k, v in carry.items()}, jnp.asarray(words),
        {k: jnp.asarray(v) for k, v in sides.items()}, jnp.asarray(starts),
        jnp.asarray(lens), jnp.asarray(ordv))
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), k
    # the caller's carry is not written
    assert all(np.array_equal(a, carry[k]) for k, a in
               _torch_args(carry, words, sides, starts, lens, ordv)[0].items())


def test_lanes_past_their_length_carry_through():
    """lens 0 leaves a lane's carry as it was, whatever its clipped reads
    land on."""
    spec = counter.make_replay_spec()
    wire = WireFormat(spec.registry, {"sequence_number": "ordinal"})
    carry, words, sides, starts, lens, ordv = _inputs(spec, wire, 8, 64, 8, 0, 3)
    lens[:] = 0
    out = fold_kernels.ragged_fold_reference(
        *_torch_args(carry, words, sides, starts, lens, ordv), width=8,
        spec=spec, wire=wire)
    for k in carry:
        assert out[k].numpy().tobytes() == carry[k].tobytes(), k
