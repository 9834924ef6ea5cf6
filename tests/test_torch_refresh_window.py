"""One refresh window of the resident state plane as ONE call
(surge_tpu_torch.replay.fold_kernels.dense_window / ragged_window), held on
the same numpy inputs, made from a seed, against:

- the reference's window program (surge_tpu/replay/resident_state.py:
  ``refresh`` for the dense dispatch, ``_ragged_program`` for the bucketed
  one, its Pallas kernel in interpret mode), byte for byte over the slab and
  the ordinals, every row but the scratch row;
- the lane-aligned admission against the reference's positional
  ``admit_idx`` scatter, over the plans the port's plane deals;
- the unfused eager sequence the plane ran before (positional admission
  ``index_copy_``, ``index_select``, the per-tile fold, ``index_copy_``
  back, ``index_add_``).

First and chained windows, with and without admission, padding lanes, and
five layouts (counter with a derived and a side ordinal, bank_account with
bool and f32 state, shopping_cart with wrapping products and bool state,
saga with seven side columns and twelve state fields). Plus the wrappers' own contract (CPU tensors run the
plain version and count no launch; other devices and bad arguments raise),
the lane table, the kernel-only path report, and, on a CUDA card only,
each kernel against its plain version and the path it reports."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surge_tpu.config import default_config
from surge_tpu.models import bank_account as jbank
from surge_tpu.models import counter as jcounter
from surge_tpu.models import shopping_cart as jcart
from surge_tpu.replay.resident_state import ResidentStatePlane as JPlane
from surge_tpu.saga import model as jsaga
from surge_tpu_torch.codec.wire import WireFormat
from surge_tpu_torch.config import Config
from surge_tpu_torch.models import bank_account, counter, shopping_cart
from surge_tpu_torch.replay import fold_kernels
from surge_tpu_torch.replay.resident_state import ResidentStatePlane
from surge_tpu_torch.saga import model as saga
from tests.test_resident_state import TOPIC, make_log
from tests.test_torch_isolation import leave_the_worker_as_found  # noqa: F401

MODELS = {
    "counter-derived": (counter.make_replay_spec, jcounter.make_replay_spec,
                        {"sequence_number": "ordinal"}),
    "counter-side": (counter.make_replay_spec, jcounter.make_replay_spec, {}),
    "bank": (bank_account.make_replay_spec, jbank.make_replay_spec, {}),
    "cart": (shopping_cart.make_replay_spec, jcart.make_replay_spec,
             {"sequence_number": "ordinal"}),
    "saga": (saga.make_replay_spec, jsaga.make_replay_spec,
             {"sequence_number": "ordinal"}),
}
#: window -> (window offset t_base, whether the window admits)
WINDOWS = {"first-admit": (0, True), "first": (0, False),
           "chained": (8, False)}
CAPACITY, LANES, LIVE, WIDTH = 64, 16, 11, 8


def _random_col(rng, dt, shape):
    dt = np.dtype(dt)
    if dt == np.bool_:
        return rng.random(shape) < 0.5
    if dt == np.float32:
        return rng.standard_normal(shape).astype(np.float32)
    return rng.integers(-(1 << 31), 1 << 31, size=shape,
                        dtype=np.int64).astype(dt)


def _case(model: str, window: str, seed: int):
    """One window's numpy inputs for both packages: events of ``LIVE`` lanes
    at distinct random slots (the rest pad to the scratch row), the dense
    window packed by ``pack_window`` and the bucket packed flat and
    lane-contiguous as ``_pack_ragged`` packs it, a random slab and
    ordinals (near int32 max too), and a random admission of some lanes."""
    mk, jmk, derived = MODELS[model]
    spec, jspec = mk(), jmk()
    wire = WireFormat(spec.registry, derived)
    t_base, admit = WINDOWS[window]
    rng = np.random.default_rng(seed)
    reg = spec.registry
    lengths = rng.integers(1, WIDTH + 1, size=LIVE) + t_base
    lengths[:2] = (t_base + 1, t_base + WIDTH + 5)  # short, and past the window
    t_max = int(lengths.max())
    type_ids = np.full((LIVE, t_max), -1, dtype=np.int32)
    cols = {}
    for f in reg.union_columns():
        if f.bits is not None:
            col = rng.integers(0, 1 << f.bits, size=(LIVE, t_max))
        else:
            col = _random_col(rng, f.dtype, (LIVE, t_max))
        cols[f.name] = np.asarray(col).astype(f.dtype)
    mask = np.arange(t_max)[None, :] < lengths[:, None]
    type_ids[mask] = rng.integers(0, reg.num_event_types, size=int(mask.sum()))
    slots = np.full(LANES, CAPACITY, dtype=np.int32)
    slots[:LIVE] = rng.choice(CAPACITY, LIVE, replace=False)
    counts = np.zeros(LANES, dtype=np.int32)
    counts[:LIVE] = np.clip(lengths - t_base, 0, WIDTH)
    packed, side = wire.pack_window(type_ids, cols, t_base,
                                    min(t_base + WIDTH, t_max), WIDTH, LANES)
    total = int(lengths.sum())
    rows = 8
    while rows < total:
        rows *= 2
    flat_tids = np.full(rows, -1, dtype=np.int32)
    flat_tids[:total] = type_ids[mask]
    flat_cols = {}
    for name, col in cols.items():
        buf = np.zeros(rows, dtype=col.dtype)
        buf[:total] = col[mask]
        flat_cols[name] = buf
    flat, flat_side = wire.pack_flat(flat_tids, flat_cols)
    starts = np.zeros(LANES, dtype=np.int32)
    starts[1:LIVE] = np.cumsum(lengths)[:LIVE - 1]
    slab = {f.name: _random_col(rng, f.dtype, CAPACITY + 1)
            for f in reg.state.fields}
    ords = rng.integers(0, 1 << 31, size=CAPACITY + 1, dtype=np.int64)
    ords[slots[:2]] = np.iinfo(np.int32).max
    flag = np.zeros(LANES, dtype=bool)
    if admit:
        flag[:LIVE] = rng.random(LIVE) < 0.5
        flag[:2] = (True, False)
    admission = (flag, rng.integers(0, 1 << 31, size=LANES).astype(np.int32),
                 {f.name: _random_col(rng, f.dtype, LANES)
                  for f in reg.state.fields})
    return dict(spec=spec, jspec=jspec, wire=wire, derived=derived,
                slots=slots, counts=counts, packed=packed, side=side,
                flat=flat, flat_side=flat_side, starts=starts + t_base,
                rows=rows, slab=slab, ords=ords.astype(np.int32),
                admit=admit, admission=admission)


def _table(c) -> np.ndarray:
    names = tuple(f.name for f in c["spec"].registry.state.fields)
    return fold_kernels.window_table(
        c["slots"], c["counts"], c["starts"],
        c["admission"] if c["admit"] else None, names)


def _positional(c):
    """The reference's positional admission arrays (its _dispatch_plan):
    the admitted lanes' slots first, the rest the scratch row."""
    flag, ordv, vals = c["admission"]
    adm = np.flatnonzero(flag)
    idx = np.full(LANES, CAPACITY, dtype=np.int32)
    idx[:len(adm)] = c["slots"][adm]
    aord = np.zeros(LANES, dtype=np.int32)
    aord[:len(adm)] = ordv[adm]
    init = c["jspec"].init_state_tree()
    avals = {}
    for f in c["spec"].registry.state.fields:
        v = np.full(LANES, init[f.name], dtype=f.dtype)
        v[:len(adm)] = vals[f.name][adm]
        avals[f.name] = v
    return idx, avals, aord


def _torch(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _plain(c, kind: str):
    """The port's window on CPU tensors (its plain version)."""
    slab = {k: _torch(v.copy()) for k, v in c["slab"].items()}
    ords = _torch(c["ords"].copy())
    table = _torch(_table(c))
    if kind == "dense":
        fold_kernels.dense_window(slab, ords, table, _torch(c["packed"]),
                                  {k: _torch(v) for k, v in c["side"].items()},
                                  spec=c["spec"], wire=c["wire"])
    else:
        fold_kernels.ragged_window(
            slab, ords, table, _torch(c["flat"]),
            {k: _torch(v) for k, v in c["flat_side"].items()}, width=WIDTH,
            spec=c["spec"], wire=c["wire"])
    return {k: v.numpy() for k, v in slab.items()}, ords.numpy()


def _reference(c, kind: str):
    """The reference plane's window program on the same inputs."""
    jp = JPlane(make_log(), TOPIC, c["jspec"],
                config=default_config().with_overrides({
                    "surge.replay.resident.capacity": CAPACITY,
                    "surge.replay.donate-refresh": False}),
                deserialize_event=lambda raw: raw,
                serialize_state=lambda a, s: b"", derived_cols=c["derived"])
    jp._ensure_device_state()
    if c["admit"]:
        idx, avals, aord = _positional(c)
    else:  # later windows: the reference's no-op admission
        init = c["jspec"].init_state_tree()
        idx = np.full(LANES, CAPACITY, dtype=np.int32)
        aord = np.zeros(LANES, dtype=np.int32)
        avals = {f.name: np.full(LANES, init[f.name], dtype=f.dtype)
                 for f in c["spec"].registry.state.fields}
    slab = {k: jnp.asarray(v) for k, v in c["slab"].items()}
    args = (slab, jnp.asarray(c["ords"]), idx, avals, aord, c["slots"],
            c["counts"])
    if kind == "dense":
        out, ords = jp._refresh_prog(*args, c["packed"], c["side"])
    else:
        prog = jp._ragged_program(LANES, WIDTH, c["rows"])
        out, ords = prog(*args, c["flat"], c["flat_side"], c["starts"])
    return {k: np.asarray(v) for k, v in out.items()}, np.asarray(ords)


def _unfused(c, kind: str):
    """The plane's window before it was one call: positional admission,
    gather, the per-tile fold of the expanded words, scatter back, ordinal
    add, each a separate eager op."""
    spec, wire = c["spec"], c["wire"]
    slab = {k: _torch(v.copy()) for k, v in c["slab"].items()}
    ords = _torch(c["ords"].copy())
    lanes = _torch(c["slots"].astype(np.int64))
    counts = _torch(c["counts"])
    if c["admit"]:
        idx, avals, aord = _positional(c)
        idx = _torch(idx.astype(np.int64))
        for k, v in slab.items():
            v.index_copy_(0, idx, _torch(avals[k]))
        ords.index_copy_(0, idx, _torch(aord))
    carry = {k: v.index_select(0, lanes) for k, v in slab.items()}
    ord_lane = ords.index_select(0, lanes)
    if kind == "dense":
        words = wire.expand_flat(_torch(c["packed"]).reshape(
            WIDTH * LANES, wire.nbytes)).reshape(WIDTH, LANES)
        out = fold_kernels.tile_scan_reference(
            carry, words, {k: _torch(v) for k, v in c["side"].items()},
            counts, ord_lane, spec=spec, wire=wire)
    else:
        out = fold_kernels.ragged_fold_reference(
            carry, wire.expand_flat(_torch(c["flat"])),
            {k: _torch(v) for k, v in c["flat_side"].items()},
            _torch(c["starts"]), counts, ord_lane, width=WIDTH, spec=spec,
            wire=wire)
    for k, v in slab.items():
        v.index_copy_(0, lanes, out[k])
    ords.index_add_(0, lanes, counts)
    return {k: v.numpy() for k, v in slab.items()}, ords.numpy()


def _assert_rows_equal(got, want):
    """Byte-identical slab columns and ordinals over every row but the
    scratch row (which no gather reads)."""
    (gslab, gords), (wslab, words) = got, want
    assert sorted(gslab) == sorted(wslab)
    for k in wslab:
        g, w = gslab[k][:CAPACITY], wslab[k][:CAPACITY]
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), k
    assert gords[:CAPACITY].tobytes() == words[:CAPACITY].tobytes()


@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("kind", ["dense", "ragged"])
def test_plain_window_matches_the_reference_program(kind, model, window):
    c = _case(model, window, seed=len(model) * 7 + len(window))
    got = _plain(c, kind)
    _assert_rows_equal(got, _reference(c, kind))
    # the window moved the lanes' rows: neither check passes vacuously
    live = c["slots"][:LIVE]
    assert not np.array_equal(got[1][live], c["ords"][live])


@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("kind", ["dense", "ragged"])
def test_plain_window_matches_the_unfused_sequence(kind, model, window):
    c = _case(model, window, seed=len(model) * 11 + len(window))
    _assert_rows_equal(_plain(c, kind), _unfused(c, kind))


@pytest.mark.parametrize("seed", range(4))
def test_lane_aligned_admission_equals_the_positional_scatter(seed):
    """For the plans the port's plane deals from a random group (bucketed
    and dense), every admitted slot is a lane of its plan, and the
    lane-aligned admission gives every lane the carry and ordinal that the
    reference's positional scatter followed by the lanes' gather gives."""
    rng = np.random.default_rng(seed)
    for dispatch in ("bucketed", "dense"):
        plane = ResidentStatePlane(
            make_log(), TOPIC, counter.make_replay_spec(), device="cpu",
            config=Config(overrides={
                "surge.replay.resident.capacity": CAPACITY,
                "surge.replay.tile-backend": "pallas",
                "surge.replay.resident.refresh-dispatch": dispatch,
                "surge.replay.time-chunk": 8}),
            deserialize_event=lambda raw: raw,
            serialize_state=lambda a, s: b"")
        b = int(rng.integers(1, 40))
        logs = [[counter.CountIncremented("", 1, j + 1)
                 for j in range(int(rng.integers(1, 20)))] for _ in range(b)]
        _, plans = plane._encode_pack_group(logs)
        slot_of = rng.choice(CAPACITY, b, replace=False).astype(np.int32)
        admit_lane = rng.random(b) < 0.5
        admit_ord_of = rng.integers(0, 1 << 31, size=b).astype(np.int32)
        admit_val_of = {"count": rng.integers(-9, 9, size=b).astype(np.int32),
                        "version": rng.integers(0, 9, size=b).astype(np.int32)}
        slab = {k: rng.integers(-99, 99, size=CAPACITY + 1).astype(np.int32)
                for k in ("count", "version")}
        ords = rng.integers(0, 99, size=CAPACITY + 1).astype(np.int32)
        seen = set()
        for _, sel, lanes_b, _, _ in plans:
            assert not seen & set(sel.tolist())  # plans' lanes are disjoint
            seen |= set(sel.tolist())
            # the reference's positional arrays (its _dispatch_plan)
            adm = sel[admit_lane[sel]]
            admit_idx = np.full(lanes_b, CAPACITY, dtype=np.int32)
            admit_idx[:len(adm)] = slot_of[adm]
            assert set(slot_of[adm]) <= set(slot_of[sel])
            lane_slots, (flag, ordv, vals) = plane._lane_admission(
                sel, lanes_b, slot_of, admit_lane, admit_ord_of, admit_val_of)
            assert np.array_equal(lane_slots[:len(sel)], slot_of[sel])
            assert (lane_slots[len(sel):] == CAPACITY).all()
            assert not flag[len(sel):].any()
            # positional scatter, then the lanes' gather (JAX, as the
            # reference's program does it)
            jslab = {k: jnp.asarray(v).at[admit_idx].set(
                np.pad(admit_val_of[k][adm], (0, lanes_b - len(adm))))
                for k, v in slab.items()}
            jords = jnp.asarray(ords).at[admit_idx].set(
                np.pad(admit_ord_of[adm], (0, lanes_b - len(adm))))
            live = slice(0, len(sel))
            for k in slab:
                want = np.asarray(jslab[k][lane_slots])[live]
                got = np.where(flag, vals[k], slab[k][lane_slots])[live]
                assert want.tobytes() == got.tobytes(), k
            want = np.asarray(jords[lane_slots])[live]
            got = np.where(flag, ordv, ords[lane_slots])[live]
            assert want.tobytes() == got.tobytes()
        assert seen == set(range(b))


def test_window_table_holds_32_bit_patterns():
    flag = np.array([True, False, True])
    vals = {"b": np.array([True, False, True]),
            "f": np.array([1.5, -0.0, np.nan], dtype=np.float32),
            "i": np.array([-1, 7, np.iinfo(np.int32).min], dtype=np.int32)}
    t = fold_kernels.window_table(np.array([4, 9, 2]), np.array([1, 0, 3]),
                                  np.array([0, 5, 6]),
                                  (flag, np.array([7, 8, 9]), vals),
                                  ("b", "f", "i"))
    assert t.dtype == np.int32 and t.shape == (fold_kernels.LANE_ADMIT_VAL + 3, 3)
    assert t[fold_kernels.LANE_ADMIT].tolist() == [1, 0, 1]
    back = {n: fold_kernels._from_row(torch.from_numpy(
        t[fold_kernels.LANE_ADMIT_VAL + i].copy()), dt)
        for i, (n, dt) in enumerate((("b", torch.bool), ("f", torch.float32),
                                     ("i", torch.int32)))}
    for n, v in vals.items():
        assert back[n].numpy().tobytes() == v.tobytes(), n
    # a later window carries no admission rows
    assert fold_kernels.window_table(np.zeros(3), np.zeros(3)).shape == (
        fold_kernels.LANE_ADMIT, 3)
    with pytest.raises(ValueError, match="32-bit"):
        fold_kernels.window_table(np.zeros(1), np.zeros(1), None,
                                  (np.ones(1, bool), np.zeros(1),
                                   {"d": np.zeros(1)}), ("d",))


@pytest.mark.parametrize("kind", ["dense", "ragged"])
def test_cpu_tensors_never_count_a_launch(kind):
    c = _case("counter-derived", "first-admit", seed=3)
    before = dict(fold_kernels.LAUNCHES)
    _plain(c, kind)
    assert fold_kernels.LAUNCHES == before


@pytest.mark.parametrize("kind", ["dense", "ragged"])
def test_plain_window_refuses_a_path_report(kind):
    """The per-lane path report is the kernel's: the plain version that CPU
    tensors run has no blocks, so asking it for one raises, before the slab
    is touched; the report's buffer is int8 [lanes] on the words' device."""
    c = _case("counter-derived", "first-admit", seed=4)
    slab = {k: _torch(v.copy()) for k, v in c["slab"].items()}
    ords = _torch(c["ords"].copy())
    if kind == "dense":
        words, sides, kw = _torch(c["packed"]), c["side"], {}
    else:
        words, sides, kw = _torch(c["flat"]), c["flat_side"], {"width": WIDTH}
    fn = getattr(fold_kernels, f"{kind}_window")
    with pytest.raises(ValueError, match="paths"):
        fn(slab, ords, _torch(_table(c)), words,
           {k: _torch(v) for k, v in sides.items()}, spec=c["spec"],
           wire=c["wire"], paths=torch.zeros(LANES, dtype=torch.int8), **kw)
    assert ords.numpy().tobytes() == c["ords"].tobytes()
    for k, v in slab.items():
        assert v.numpy().tobytes() == c["slab"][k].tobytes()
    assert fold_kernels._paths_ptr(None, LANES, ords.device) == 0
    with pytest.raises(ValueError, match="paths"):
        fold_kernels._paths_ptr(torch.zeros(LANES, dtype=torch.int32), LANES,
                                ords.device)
    with pytest.raises(ValueError, match="paths"):
        fold_kernels._paths_ptr(torch.zeros(LANES - 1, dtype=torch.int8), LANES,
                                ords.device)


def _meta_args(c, kind):
    to = lambda a: _torch(a).to("meta")  # noqa: E731
    slab = {k: to(v) for k, v in c["slab"].items()}
    if kind == "dense":
        words, sides = to(c["packed"]), {k: to(v) for k, v in c["side"].items()}
    else:
        words = to(c["flat"])
        sides = {k: to(v) for k, v in c["flat_side"].items()}
    return slab, to(c["ords"]), to(_table(c)), words, sides


@pytest.mark.parametrize("kind", ["dense", "ragged"])
def test_window_refuses_other_devices(kind):
    c = _case("counter-side", "first", seed=1)
    fn = getattr(fold_kernels, f"{kind}_window")
    kw = {} if kind == "dense" else {"width": WIDTH}
    with pytest.raises(ValueError, match="cpu or cuda"):
        fn(*_meta_args(c, kind), spec=c["spec"], wire=c["wire"], **kw)


@pytest.mark.parametrize("kind", ["dense", "ragged"])
def test_window_checks_its_arguments(kind):
    c = _case("bank", "first-admit", seed=2)
    spec = c["spec"]
    slab, ords, table, _, _ = (
        {k: _torch(v) for k, v in c["slab"].items()}, _torch(c["ords"]),
        _torch(_table(c)), None, None)
    check = fold_kernels._check_window
    assert check(slab, ords, table, spec, ords.device) == LANES
    with pytest.raises(ValueError, match="table"):
        check(slab, ords, table[:4], spec, ords.device)
    with pytest.raises(ValueError, match="ords"):
        check(slab, ords.long(), table, spec, ords.device)
    with pytest.raises(ValueError, match="balance"):
        check(dict(slab, balance=slab["balance"].double()), ords, table, spec,
              ords.device)
    with pytest.raises(ValueError, match="table"):
        check(slab, ords, table.long(), spec, ords.device)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the window kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("kind", ["dense", "ragged"])
def test_kernel_matches_plain_version_on_the_card(cuda_card, kind, model,
                                                  window):
    c = _case(model, window, seed=5)
    to = lambda a: _torch(a).to(cuda_card)  # noqa: E731
    table = to(_table(c))
    if kind == "dense":
        words, sides = to(c["packed"]), {k: to(v) for k, v in c["side"].items()}
        kw = {}
    else:
        words = to(c["flat"])
        sides = {k: to(v) for k, v in c["flat_side"].items()}
        kw = {"width": WIDTH}
    out = {}
    for route in ("kernel", "plain"):
        slab = {k: to(v.copy()) for k, v in c["slab"].items()}
        ords = to(c["ords"].copy())
        fn = getattr(fold_kernels, f"{kind}_window" + (
            "" if route == "kernel" else "_reference"))
        before = fold_kernels.LAUNCHES[f"{kind}_window"]
        paths = {}
        if route == "kernel":  # one block: its lanes lie back to back
            paths["paths"] = torch.full((LANES,), 9, dtype=torch.int8,
                                        device=cuda_card)
        fn(slab, ords, table, words, sides, spec=c["spec"], wire=c["wire"],
           **kw, **paths)
        torch.cuda.synchronize()
        if paths:
            assert (paths["paths"] == fold_kernels.PATH_STAGED).all()
        assert fold_kernels.LAUNCHES[f"{kind}_window"] == before + (
            route == "kernel")
        out[route] = ({k: v.cpu().numpy() for k, v in slab.items()},
                      ords.cpu().numpy())
    _assert_rows_equal(out["kernel"], out["plain"])
