"""K2's module (surge_tpu_torch.replay.fold_kernels.ragged_fold): the wrapper on
CPU tensors (its plain torch version) against the reference's Pallas kernel
``make_ragged_fold`` run in interpret mode, byte for byte, with clipped tail
reads, empty and over-long lanes and shifted (chained-window) starts; the
wrapper's argument checks; and, on a CUDA card only, the kernel against its
plain version."""

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
    got = fold_kernels.ragged_fold(
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
    land on; and the plain version never counts a launch."""
    spec = counter.make_replay_spec()
    wire = WireFormat(spec.registry, {"sequence_number": "ordinal"})
    carry, words, sides, starts, lens, ordv = _inputs(spec, wire, 8, 64, 8, 0, 3)
    lens[:] = 0
    before = fold_kernels.LAUNCHES["ragged_fold"]
    out = fold_kernels.ragged_fold(
        *_torch_args(carry, words, sides, starts, lens, ordv), width=8,
        spec=spec, wire=wire)
    assert fold_kernels.LAUNCHES["ragged_fold"] == before
    for k in carry:
        assert out[k].numpy().tobytes() == carry[k].tobytes(), k


def test_ragged_fold_checks_its_arguments():
    spec = counter.make_replay_spec()
    wire = WireFormat(spec.registry, {})
    carry, words, sides, starts, lens, ordv = _torch_args(
        *_inputs(spec, wire, 8, 64, 4, 0, 0), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fold_kernels.ragged_fold(carry, words, sides, starts, lens, ordv,
                                 width=4, spec=spec, wire=wire)
    args = _torch_args(*_inputs(spec, wire, 8, 64, 4, 0, 0))
    with pytest.raises(ValueError, match="rows >= 1"):
        fold_kernels._check_ragged(args[0], args[1][:0], args[2], *args[3:],
                                   4, spec, wire)
    with pytest.raises(ValueError, match="starts"):
        fold_kernels._check_ragged(args[0], args[1], args[2], args[3].long(),
                                   *args[4:], 4, spec, wire)
    with pytest.raises(ValueError, match="side"):
        fold_kernels._check_ragged(args[0], args[1], {}, *args[3:], 4, spec,
                                   wire)
    assert fold_kernels._check_ragged(*args, 4, spec, wire) == (64, 8)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ragged-fold kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4096, 8, 32768, 0), (1000, 512, 4096, 1024)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version_on_the_card(cuda_card, case, shape):
    mk, _, derived = CASES[case]
    spec = mk()
    wire = WireFormat(spec.registry, derived)
    bs, width, rows, shift = shape
    args = _torch_args(*_inputs(spec, wire, bs, rows, width, shift, seed=7),
                       device=cuda_card)
    before = fold_kernels.LAUNCHES["ragged_fold"]
    got = fold_kernels.ragged_fold(*args, width=width, spec=spec, wire=wire)
    want = fold_kernels.ragged_fold_reference(*args, width=width, spec=spec,
                                              wire=wire)
    torch.cuda.synchronize()
    assert fold_kernels.LAUNCHES["ragged_fold"] == before + 1
    for k in want:
        assert got[k].cpu().numpy().tobytes() == want[k].cpu().numpy().tobytes(), k
