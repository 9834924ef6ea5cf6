#!/usr/bin/env python3
"""Drive surge_tpu_torch's main paths on one CUDA card and check them.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA card
and the CUDA toolkit (``nvcc``); it builds the kernels from ``surge_tpu_torch/csrc``
first. Phases:

0. the card's name and power limit, and the kernel build time;
1. each kernel against its plain torch version on the card, byte for byte, at
   the main paths' shapes, with its time, bound and the plain time: K1's
   per-tile entry at the dense plane's refresh windows (widths 256 and 512,
   32,768 lanes, chained); K1's list fold over the bench plan's work lists
   (dense) and, on cut corpora, both sources, three model layouts and the
   edges (bs_small 8; batches of 104, 256 and 2,000 lanes, whose tiles start
   and end inside a lane block, staged or loaded per lane; width 512); K2 at
   the refresh buckets (bs, width, rows) = (8, 2, 16), (4096, 8, 32768),
   (65536, 4, 262144) and a chained (8, 512, 4096) window with the starts
   shifted by 512 and 1024, for three model layouts;
2. the main path at full size: ``synth_counter_corpus(1M aggregates, 100M
   events)`` through ``ReplayEngine`` under the bench config (batch 8192,
   time-chunk 64, tile-backend auto), ``pack_resident`` → ``upload_resident``
   → ``warm_resident`` → ``replay_resident`` five times, with the layout
   ``auto`` picks and with ``flat``; the states must equal the closed-form
   expected states exactly, each replay must launch the list fold once per
   non-empty work list, and the per-tile entry never;
3. a resumed fold (first half of each log, then the rest from ``init_carry`` and
   ``ordinal_base``) and a bank_account corpus against the plain scan;
4. the resident state plane (``ResidentStatePlane``) at deployment size: the
   port's ``InMemoryLog`` with 8 partitions, the reference's default config
   with 2^20 resident rows, a cold-start seed of 1,310,720 aggregates through
   K1's list fold, 16 refresh rounds of about 32k events through K2 (evicting and
   re-admitting, with chained windows every fourth round) while a reader
   checks that no row is torn, then every aggregate read back against its
   closed form; and a smaller plane on the dense dispatch through K1's
   per-tile entry, which is then held against its plain version at every
   window shape the plane gave it that phase 1 did not check;
then one JSON line of every kernel's numbers, the card line, and a last line
``{"ok": true, "device": {...}}``.

Any failure raises, exits non-zero and prints no result line. Without a CUDA
card it exits with code 2 before doing anything.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import statistics
import subprocess
import sys
import time

import numpy as np

#: H100 SXM peak rates (NVIDIA data sheet), for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12  # non-tensor-core 32-bit rate

#: bench.py's replay engine config (bench.py make_engine)
BENCH_CONFIG = {
    "surge.replay.batch-size": 8192,
    "surge.replay.time-chunk": 64,
    "surge.replay.dispatch": "switch",
    "surge.replay.tile-backend": "auto",
    "surge.replay.resident-layout": "auto",
    "surge.replay.resident-len-bucket": "exact",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats: int, inner: int) -> float:
    """Median over ``repeats`` of the mean time of ``inner`` back-to-back calls,
    from CUDA events (warmed up first)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(fn, repeats: int, inner: int) -> float:
    """Device time of one call of ``fn``: the median over ``repeats`` of CUDA
    events around ``inner`` back-to-back calls, each group queued behind a
    ~1 ms spin kernel so the host's launch cost leaves no gap in the stream
    (the spin runs before the start event; warmed up first)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_kernel_ms(fn, calls: int, name: str) -> float | None:
    """Mean device time of the CUDA kernels whose name contains ``name`` over
    ``calls`` calls of ``fn``, from the profiler's CUPTI trace; None when the
    trace holds no such kernel time (it holds fewer launches than were made,
    for a cause not found)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for evt in prof.key_averages():
        if name in evt.key:
            total_us += evt.device_time_total
            count += evt.count
    if count == 0 or total_us <= 0:
        return None
    return total_us / count / 1e3


# -- phase 1: kernel against its plain version ---------------------------------------


def kernel_cases():
    """(label, spec, wire) for the three layouts K1 must decode."""
    from surge_tpu_torch.codec.wire import WireFormat
    from surge_tpu_torch.models import bank_account, counter

    cspec = counter.make_replay_spec()
    bspec = bank_account.make_replay_spec()
    return [
        ("counter/derived", cspec,
         WireFormat(cspec.registry, {"sequence_number": "ordinal"})),
        ("counter/side", cspec, WireFormat(cspec.registry, {})),
        ("bank_account", bspec, WireFormat(bspec.registry, {})),
    ]


#: K1's per-tile entry runs on one path: the plane's dense refresh windows
#: (drive_plane, dispatch "dense"). A round there folds ~8,000 lanes, padded
#: to _pow8 = 32,768; its longest log (a tail of 17-256 events) sets the
#: width to 256, and a heavy round's 1,800-event lane sets it to 512 over
#: four chained windows. Checked shapes: (width, lanes_b, window offset)
PLANE_WINDOW_LIVE = 8000
PLANE_WINDOW_SHAPES = [(256, 32768, 0), (512, 32768, 0), (512, 32768, 1024)]


def window_inputs(spec, wire, width: int, lanes_b: int, live: int, shift: int,
                  seed: int, device):
    """Random K1 inputs laid out as the plane's dense window packs a round
    (``_pack_windows``): ``live`` lanes of 1-4 events with a 1.25% tail of
    17-256 and, at width 512, lane 0 with 1,800; lens_rel is the window's
    counts ``clip(lengths - shift, 0, width)`` and the padding lanes past
    ``live`` hold 0. On top: full 32-bit words in every slot (corrupt type
    ids, the 32nd bit set, and garbage in the padded slots that lens_rel
    masks), random side values and carries, ordinals near int32 max."""
    import torch

    rng = np.random.default_rng(seed)
    lengths = np.zeros(lanes_b, dtype=np.int64)
    lengths[:live] = rng.integers(1, 5, size=live)
    tail = np.flatnonzero(rng.random(live) < 0.0125)
    lengths[tail] = rng.integers(17, 257, size=len(tail))
    if width >= 512:
        lengths[0] = 1800
    lens = np.clip(lengths - shift, 0, width).astype(np.int32)
    words = rng.integers(0, 1 << 32, size=(width, lanes_b), dtype=np.uint64)
    words = words.astype(np.uint32).view(np.int32)
    sides = {}
    for f in wire.side_fields:
        if np.dtype(f.dtype) == np.float32:
            col = rng.standard_normal((width, lanes_b)).astype(np.float32)
        else:
            col = rng.integers(-(1 << 31), 1 << 31, size=(width, lanes_b),
                               dtype=np.int64).astype(np.int32)
        sides[f.name] = col
    ordr = rng.integers(0, 1 << 31, size=lanes_b, dtype=np.int64).astype(np.int32)
    ordr[:2] = (np.iinfo(np.int32).max, np.iinfo(np.int32).max - width // 2)
    carry = {}
    for f in spec.registry.state.fields:
        dt = np.dtype(f.dtype)
        if dt == np.bool_:
            carry[f.name] = rng.integers(0, 2, size=lanes_b).astype(bool)
        elif dt == np.float32:
            carry[f.name] = rng.standard_normal(lanes_b).astype(np.float32)
        else:
            carry[f.name] = rng.integers(-(1 << 31), 1 << 31, size=lanes_b,
                                         dtype=np.int64).astype(np.int32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return ({k: to(v) for k, v in carry.items()}, to(words),
            {k: to(v) for k, v in sides.items()}, to(lens), to(ordr))


def tile_work(spec, wire, args, width: int) -> tuple[int, int]:
    """(bytes, valid steps) one K1 launch needs on these inputs: the word
    and side columns of each slot some lane folds (``t < lens_rel``) read
    once, each lane's length and ordinal read once, the carry read and
    written once."""
    lens = args[3].cpu().numpy()
    bs = len(lens)
    steps = int(np.minimum(np.clip(lens, 0, None), width).sum())
    state = sum(np.dtype(f.dtype).itemsize for f in spec.registry.state.fields)
    side = sum(np.dtype(f.dtype).itemsize for f in wire.side_fields)
    return steps * (4 + side) + bs * (4 + 4 + 2 * state), steps


def check_tile_case(label: str, spec, wire, shape: tuple[int, int, int],
                    timed: bool) -> dict:
    """K1's per-tile entry against its plain version at one dense-window
    shape, byte for byte; with ``timed``, its device time, bound and the
    plain version's time."""
    import torch

    from surge_tpu_torch.replay import fold_kernels

    width, lanes_b, shift = shape
    args = window_inputs(spec, wire, width, lanes_b,
                         min(PLANE_WINDOW_LIVE, lanes_b), shift,
                         seed=width + shift + lanes_b + len(label), device="cuda")
    kw = dict(spec=spec, wire=wire)
    out = fold_kernels.tile_scan(*args, **kw)
    ref = fold_kernels.tile_scan_reference(*args, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for name, v in ref.items():
        got, want = out[name].cpu().numpy(), v.cpu().numpy()
        if got.tobytes() != want.tobytes():
            raise AssertionError(
                f"K1 {label} {shape}: field {name!r} differs from the plain "
                f"version at {int(np.flatnonzero(got != want)[0])}")
        err = max(err, float(np.abs(got.astype(np.float64)
                                    - want.astype(np.float64)).max()))
    nbytes, steps = tile_work(spec, wire, args, width)
    row = {"case": label, "width": width, "bs": lanes_b, "shift": shift,
           "max_abs_err": err, "bytes": nbytes, "valid_steps": steps}
    if timed:
        ops = steps * 12  # decode and step: ~a dozen integer ops a step
        bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = ops / INT32_OPS_PER_S * 1e3
        row.update({
            # device time from CUDA events (launches queued behind a spin)
            "ms": device_ms(lambda: fold_kernels.tile_scan(*args, **kw), 7, 10),
            "ms_source": "events",
            "call_ms": cuda_ms(lambda: fold_kernels.tile_scan(*args, **kw), 7, 10),
            # the plain version repeats the kernel's arithmetic in eager
            # torch: a correctness yardstick, not a speed one
            "plain_ms": cuda_ms(
                lambda: fold_kernels.tile_scan_reference(*args, **kw), 3, 1),
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                         else "operations")})
    log("phase1 " + json.dumps(row))
    return row


def phase_kernels() -> dict:
    """K1's per-tile entry at the plane's dense-window shapes, three
    layouts."""
    return {"rows": [check_tile_case(label, spec, wire, shape, timed=True)
                     for label, spec, wire in kernel_cases()
                     for shape in PLANE_WINDOW_SHAPES]}


def check_plane_window_shapes(shapes, checked: set) -> list[dict]:
    """K1's per-tile entry against its plain version at every window shape
    the dense plane gave it (``shapes``: [width, lanes_b, launches]) that
    phase 1 did not hold (counter, derived ordinal: the plane's layout)."""
    label, spec, wire = kernel_cases()[0]
    rows = []
    for width, lanes_b, _ in shapes:
        if (width, lanes_b) not in checked:
            rows.append(check_tile_case(label, spec, wire, (width, lanes_b, 0),
                                        timed=False))
    return rows


#: the list fold's cut cases: (label, layout, corpus, config overrides,
#: whether the dense source's big and small lists take the staged (TMA) path).
#: The corpora are cut from the bench's shape. The edges: small tiles of 8
#: lanes (8 wire bytes a row: the kernel's plain-load path); a batch of 104
#: lanes (104 B rows: plain loads, tiles ending inside a lane block); a
#: batch of 256 (small tiles of 32 lanes, eight staged into each lane
#: block); a batch of 2,000 (big tiles starting and ending inside lane
#: blocks, staged; small tiles of 250 lanes, plain loads); width 512
LIST_CASES = [
    ("counter/derived", "counter/derived", "cut", {}, (True, True)),
    ("counter/side", "counter/side", "cut", {}, (True, True)),
    ("bank_account", "bank_account", "bank", {}, (True, True)),
    ("counter/derived bs_small 8", "counter/derived", "tiny", {},
     (True, False)),
    ("bank_account bs_small 8", "bank_account", "tiny", {}, (True, False)),
    ("counter/derived batch 104", "counter/derived", "small",
     {"surge.replay.batch-size": 104}, (False, False)),
    ("bank_account batch 104", "bank_account", "small",
     {"surge.replay.batch-size": 104}, (False, False)),
    ("counter/derived batch 256", "counter/derived", "small",
     {"surge.replay.batch-size": 256}, (True, True)),
    ("bank_account batch 256", "bank_account", "small",
     {"surge.replay.batch-size": 256}, (True, True)),
    ("counter/derived batch 2000", "counter/derived", "cut",
     {"surge.replay.batch-size": 2000}, (True, False)),
    ("bank_account batch 2000", "bank_account", "bank",
     {"surge.replay.batch-size": 2000}, (True, False)),
    ("counter/derived width 512", "counter/derived", "cut",
     {"surge.replay.time-chunk": 512}, (True, True)),
]


def list_corpus(layout: str, corpus: str):
    """A cut corpus of the layout: the counter corpus's shape (lognormal
    lengths, spread 0.6) at 100k aggregates / 5M events ("cut"), 3,000 / 150k
    ("small") or 64 / 1,600 ("tiny"), with the ordinal derived or shipped as a
    side column; bank_account logs for "bank" (500k accounts of 0-89
    events, as phase 3, cut to 100k) and on the counter's lengths otherwise."""
    from surge_tpu_torch.codec.tensor import ColumnarEvents
    from surge_tpu_torch.models import bank_account as ba
    from surge_tpu_torch.replay.corpus import synth_counter_corpus

    if corpus == "bank":
        return bank_corpus(100_000, seed=6)
    aggs, events = {"cut": (100_000, 5_000_000), "small": (3_000, 150_000),
                    "tiny": (64, 1_600)}[corpus]
    c = synth_counter_corpus(aggs, events, seed=1)
    ev = c.events
    if layout == "counter/derived":
        return ev
    starts = np.zeros(aggs + 1, dtype=np.int64)
    np.cumsum(c.lengths, out=starts[1:])
    if layout == "counter/side":
        seq = (np.arange(ev.num_events) - starts[ev.agg_idx] + 1).astype(np.int32)
        return ColumnarEvents(num_aggregates=aggs, agg_idx=ev.agg_idx,
                              type_ids=ev.type_ids,
                              cols=dict(ev.cols, sequence_number=seq))
    rng = np.random.default_rng(2)
    n = ev.num_events
    created = rng.random(n) < 0.1
    quarter = lambda: (rng.integers(0, 4_000_000, size=n) * 0.25).astype(np.float32)  # noqa: E731
    codes = lambda: np.where(created, rng.integers(1, 1 << 20, size=n), 0).astype(np.int32)  # noqa: E731
    return ColumnarEvents(
        num_aggregates=aggs, agg_idx=ev.agg_idx,
        type_ids=np.where(created, ba.CREATED, ba.UPDATED).astype(np.int32),
        cols={"owner_code": codes(), "security_code_code": codes(),
              "balance": np.where(created, quarter(), 0).astype(np.float32),
              "new_balance": np.where(created, 0, quarter()).astype(np.float32)})


def list_work(eng, resident, plan, source: str) -> tuple[int, int]:
    """(bytes, valid steps) one replay's list folds need: the wire bytes and
    side values of each slot some lane folds (``t < lens - t_base``) read
    once, each touched lane's length and ordinal (and start, flat) read once
    and its carry read and written once, plus the work lists and their
    schedules."""
    from surge_tpu_torch.replay import fold_kernels

    wire = eng._wire(frozenset(resident.derived_key.items()))
    lens = np.zeros(resident.b_pad, dtype=np.int64)
    lens[:len(resident.lengths)] = resident.lengths
    touched = np.zeros(resident.b_pad, dtype=bool)
    steps, extra = 0, 0
    for bs, i0s, t_bases in ((plan.bs_big, plan.big_i0, plan.big_tb),
                             (plan.bs_small, plan.small_i0, plan.small_tb)):
        for i0, tb in zip(i0s.tolist(), t_bases.tolist()):
            steps += int(np.clip(lens[i0:i0 + bs] - tb, 0, plan.width).sum())
            touched[i0:i0 + bs] = True
        ids, off, tiles = fold_kernels.list_schedule(i0s, bs, resident.b_pad)
        extra += 8 * len(i0s) + 4 * (len(ids) + len(off) + len(tiles))
    state = sum(np.dtype(f.dtype).itemsize for f in eng.spec.registry.state.fields)
    side = sum(np.dtype(f.dtype).itemsize for f in wire.side_fields)
    per_lane = 8 + 2 * state + (4 if source == "flat" else 0)
    return (steps * (wire.nbytes + side) + int(touched.sum()) * per_lane + extra,
            steps)


def staged(words, sides, bs: int, nbytes: int) -> bool:
    """Whether the list kernel stages a dense list through shared memory:
    its mirror of ``span_of``'s rule (words and side columns on 16 bytes,
    ``bs * nbytes`` a multiple of 16); off that path it loads per lane."""
    return (all(t.data_ptr() % 16 == 0 for t in (words, *sides.values()))
            and bs * nbytes % 16 == 0)


def check_list_case(label: str, eng, resident, source: str, seed: int,
                    timed: bool, bulk: tuple | None = None) -> dict:
    """The list kernel against its plain version over every work list of the
    corpus's plan, from a random slab and ordinals (near int32 max), byte for
    byte; the dense source's lists must take the staged path as ``bulk``
    says. With ``timed``, its device time per replay (both lists) and per
    launch of each list, the wrapper's time per replay and the plain
    version's."""
    import torch

    from surge_tpu_torch.replay import fold_kernels

    plan = eng._plan_for(resident)
    wire = eng._wire(frozenset(resident.derived_key.items()))
    rng = np.random.default_rng(seed)
    slab = {}
    for f in eng.spec.registry.state.fields:
        dt = np.dtype(f.dtype)
        if dt == np.bool_:
            col = rng.integers(0, 2, size=resident.b_pad).astype(bool)
        elif dt == np.float32:
            col = rng.standard_normal(resident.b_pad).astype(np.float32)
        else:
            col = rng.integers(-(1 << 31), 1 << 31, size=resident.b_pad,
                               dtype=np.int64).astype(np.int32)
        slab[f.name] = torch.from_numpy(col).cuda()
    ordv = rng.integers(0, 1 << 31, size=resident.b_pad, dtype=np.int64)
    ordv[:3] = np.iinfo(np.int32).max
    ord_d = torch.from_numpy(ordv.astype(np.int32)).cuda()
    calls, paths = [], []
    for bs, i0s, t_bases in ((plan.bs_big, plan.big_i0, plan.big_tb),
                             (plan.bs_small, plan.small_i0, plan.small_tb)):
        if not len(i0s):
            paths.append(None)
            continue
        if source == "dense":
            words, sides = eng._dense_tiles(resident, plan, bs, i0s, t_bases)
            starts = None
            paths.append(staged(words, sides, bs, wire.nbytes))
        else:
            paths.append(None)
            words, sides = resident.flat_wire, resident.flat_side
            starts = resident.starts_dev
        i0s_d, tb_d, schedule = eng._work_list(resident, plan, bs, i0s, t_bases)
        calls.append(((words, sides, resident.lens_dev, ord_d, i0s_d, tb_d),
                      dict(width=plan.width, bs=bs, spec=eng.spec, wire=wire,
                           starts=starts), schedule))
    got = {f: v.clone() for f, v in slab.items()}
    want = {f: v.clone() for f, v in slab.items()}
    for args, kw, schedule in calls:
        fold_kernels.tile_fold_list(got, *args, schedule=schedule, **kw)
        fold_kernels.tile_fold_list_reference(want, *args, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for name in slab:
        g, w = got[name].cpu().numpy(), want[name].cpu().numpy()
        if g.tobytes() != w.tobytes():
            raise AssertionError(
                f"list fold {label} ({source}): field {name!r} differs from "
                f"the plain version at {int(np.flatnonzero(g != w)[0])}")
        err = max(err, float(np.abs(g.astype(np.float64) - w.astype(np.float64)).max()))
    if source == "dense" and bulk is not None and tuple(paths) != tuple(
            p if n else None for p, n in zip(bulk, (len(plan.big_i0),
                                                    len(plan.small_i0)))):
        raise AssertionError(f"list fold {label}: the lists' staged paths are "
                             f"{paths}, not {bulk}")
    nbytes, steps = list_work(eng, resident, plan, source)
    row = {"case": label, "source": source, "width": plan.width,
           "bs_big": plan.bs_big, "bs_small": plan.bs_small,
           "tiles": [len(plan.big_i0), len(plan.small_i0)],
           "staged": paths, "launches_per_replay": len(calls),
           "max_abs_err": err, "bytes": nbytes, "valid_steps": steps}
    if timed:
        def fold_list(i):
            args, kw, schedule = calls[i]
            return lambda: fold_kernels.tile_fold_list(got, *args,
                                                       schedule=schedule, **kw)

        def replay_lists():
            for i in range(len(calls)):
                fold_list(i)()

        def replay_lists_plain():
            for args, kw, _ in calls:
                fold_kernels.tile_fold_list_reference(got, *args, **kw)

        plain_ms = cuda_ms(replay_lists_plain, 1, 1)
        bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = steps * 12 / INT32_OPS_PER_S * 1e3
        row.update({
            # device time from CUDA events, launches queued behind a spin:
            # per replay (both lists) and per launch of each list
            "ms": device_ms(replay_lists, 7, 10),
            "ms_per_launch": [device_ms(fold_list(i), 7, 10)
                              for i in range(len(calls))],
            "ms_source": "events",
            # the wrapper's time per replay, host launch cost included
            "call_ms": cuda_ms(replay_lists, 7, 10),
            # the plain version repeats the kernel's arithmetic in eager
            # torch, tile by tile: a correctness yardstick, not a speed one
            "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"})
    log("phase1-list " + json.dumps(row))
    return row


def phase_list_kernel(bench_events) -> dict:
    """K1's list fold against its plain version: the bench plan (counter,
    derived ordinal, dense, as the cold replay runs it) and the cut cases
    under both sources."""
    import torch

    from surge_tpu_torch.config import Config
    from surge_tpu_torch.models import bank_account, counter
    from surge_tpu_torch.replay.engine import ReplayEngine

    specs = {"counter/derived": counter, "counter/side": counter,
             "bank_account": bank_account}
    rows = []
    cfg = Config(overrides=BENCH_CONFIG)
    eng = ReplayEngine(counter.make_replay_spec(), config=cfg)
    resident = eng.upload_resident(eng.pack_resident(bench_events))
    rows.append(check_list_case("counter/derived bench", eng, resident, "dense",
                                seed=0, timed=True, bulk=(True, True)))
    del eng, resident
    for i, (label, layout, corpus, over, bulk) in enumerate(LIST_CASES):
        eng = ReplayEngine(specs[layout].make_replay_spec(),
                           config=Config(overrides=dict(BENCH_CONFIG, **over)))
        resident = eng.upload_resident(eng.pack_resident(list_corpus(layout, corpus)))
        for source in ("dense", "flat"):
            rows.append(check_list_case(label, eng, resident, source,
                                        seed=i + 1, bulk=bulk,
                                        timed=corpus in ("cut", "bank")))
        del eng, resident
    torch.cuda.empty_cache()
    return {"rows": rows}


#: K2's refresh-bucket shapes (bs, width, rows, start shifts): a small bucket,
#: a steady bucket, a large bucket, and a lane folding through chained
#: 512-wide windows (its starts shifted by 512, then 1024)
K2_SHAPES = [(8, 2, 16, (0,)), (4096, 8, 32768, (0,)),
             (65536, 4, 262144, (0,)), (8, 512, 4096, (512, 1024))]


def ragged_inputs(spec, wire, bs: int, width: int, rows: int, shift: int,
                  seed: int, device):
    """Random K2 inputs laid out as the plane packs a refresh bucket: each
    lane's events lie lane-contiguous from the exclusive cumsum of the lane
    lengths, the buffer is ``_pow2(events)`` rows, and padding lanes start at
    row 0 with no events. A bucket of width w holds lanes of w//2+1 to w
    events; lane 0 holds more than the width (three windows at width 512).
    A chained window shifts the starts by ``shift`` and folds
    ``lengths - shift`` events (lens of 0 and of at least the width). On
    top: full 32-bit words (corrupt type ids, random pad rows), two lanes
    moved into the pad tail whose reads clip at rows - 1, and large
    ordinals. Returns the kernel's arguments."""
    import torch

    rng = np.random.default_rng(seed)
    n_pad = max(1, bs // 16)
    lengths = np.zeros(bs, dtype=np.int64)
    lengths[:bs - n_pad] = rng.integers(width // 2 + 1, width + 1,
                                        size=bs - n_pad)
    lengths[0] = 2 * width + 77 if width >= 64 else width + 1
    total = int(lengths.sum())
    if 1 << max(total - 1, 0).bit_length() != rows:
        raise AssertionError(f"K2 inputs: {total} events do not pack into "
                             f"{rows} rows")
    words = rng.integers(0, 1 << 32, size=rows, dtype=np.uint64)
    words = words.astype(np.uint32).view(np.int32)
    sides = {}
    for f in wire.side_fields:
        if np.dtype(f.dtype) == np.float32:
            col = rng.standard_normal(rows).astype(np.float32)
        else:
            col = rng.integers(-(1 << 31), 1 << 31, size=rows,
                               dtype=np.int64).astype(np.int32)
        sides[f.name] = col
    starts = np.zeros(bs, dtype=np.int64)
    starts[1:bs - n_pad] = np.cumsum(lengths)[:bs - n_pad - 1]
    starts[:bs - n_pad] += shift
    lens = np.clip(lengths - shift, 0, None)
    starts[2] = rows - 1                          # every step clips
    starts[3] = max(rows - 1 - width // 2, 0)     # clips half way
    lens[2:4] = width
    starts, lens = starts.astype(np.int32), lens.astype(np.int32)
    ordv = rng.integers(0, 1 << 31, size=bs, dtype=np.int64).astype(np.int32)
    ordv[:2] = (np.iinfo(np.int32).max, np.iinfo(np.int32).max - width // 2)
    carry = {}
    for f in spec.registry.state.fields:
        dt = np.dtype(f.dtype)
        if dt == np.bool_:
            carry[f.name] = rng.integers(0, 2, size=bs).astype(bool)
        elif dt == np.float32:
            carry[f.name] = rng.standard_normal(bs).astype(np.float32)
        else:
            carry[f.name] = rng.integers(-(1 << 31), 1 << 31, size=bs,
                                         dtype=np.int64).astype(np.int32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return ({k: to(v) for k, v in carry.items()}, to(words),
            {k: to(v) for k, v in sides.items()}, to(starts), to(lens),
            to(ordv))


def ragged_work(spec, wire, args, width: int) -> tuple[int, int]:
    """(bytes, valid steps) one K2 launch needs on these inputs: each flat
    row some lane folds (``min(starts + t, rows - 1)`` for ``t < lens``) read
    once as a word and its side columns, each lane's start, length and
    ordinal read once, the carry read and written once."""
    _, words, _, starts, lens, _ = args
    rows = words.shape[0]
    starts = starts.cpu().numpy().astype(np.int64)
    steps = np.minimum(np.clip(lens.cpu().numpy(), 0, None), width)
    t = np.arange(width, dtype=np.int64)
    read = np.minimum(np.clip(starts, 0, None)[:, None] + t[None, :], rows - 1)
    needed = np.unique(read[t[None, :] < steps[:, None]]).size
    bs = len(starts)
    state = sum(np.dtype(f.dtype).itemsize for f in spec.registry.state.fields)
    side = sum(np.dtype(f.dtype).itemsize for f in wire.side_fields)
    return needed * (4 + side) + bs * (12 + 2 * state), int(steps.sum())


def phase_ragged_kernel() -> dict:
    import torch

    from surge_tpu_torch.replay import fold_kernels

    rows_out = []
    for label, spec, wire in kernel_cases():
        for bs, width, rows, shifts in K2_SHAPES:
            for shift in shifts:
                args = ragged_inputs(spec, wire, bs, width, rows, shift,
                                     seed=bs + width + shift + len(label),
                                     device="cuda")
                kw = dict(width=width, spec=spec, wire=wire)
                out = fold_kernels.ragged_fold(*args, **kw)
                ref = fold_kernels.ragged_fold_reference(*args, **kw)
                torch.cuda.synchronize()
                err = 0.0
                for name, v in ref.items():
                    got, want = out[name].cpu().numpy(), v.cpu().numpy()
                    if got.tobytes() != want.tobytes():
                        raise AssertionError(
                            f"K2 {label} {(bs, width, rows, shift)}: field "
                            f"{name!r} differs from the plain version at "
                            f"{int(np.flatnonzero(got != want)[0])}")
                    err = max(err, float(np.abs(got.astype(np.float64)
                                                - want.astype(np.float64)).max()))
                call_ms = cuda_ms(lambda: fold_kernels.ragged_fold(*args, **kw),
                                  15, 20)
                kernel_ms = device_kernel_ms(
                    lambda: fold_kernels.ragged_fold(*args, **kw), 50,
                    "ragged_fold_kernel")
                plain_ms = cuda_ms(
                    lambda: fold_kernels.ragged_fold_reference(*args, **kw), 3, 1)
                nbytes, steps = ragged_work(spec, wire, args, width)
                ops = steps * 14  # clip, decode and step per valid step
                bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                bound_ops_ms = ops / INT32_OPS_PER_S * 1e3
                row = {"case": label, "bs": bs, "width": width, "rows": rows,
                       "shift": shift, "max_abs_err": err,
                       "ms": kernel_ms if kernel_ms is not None else call_ms,
                       "ms_source": ("profiler" if kernel_ms is not None
                                     else "events"),
                       "call_ms": call_ms,
                       # the plain version repeats the kernel's arithmetic in
                       # eager torch: a correctness yardstick, not a speed one
                       "plain_ms": plain_ms, "bytes": nbytes,
                       "valid_steps": steps,
                       "bound_ms": max(bound_bytes_ms, bound_ops_ms),
                       "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                                    else "operations")}
                rows_out.append(row)
                log("phase1-k2 " + json.dumps(row))
    return {"rows": rows_out}


# -- phase 2: the main path -----------------------------------------------------------


def profile_replay(eng, resident, fold_device_ms: float, wall_ms: float
                   ) -> dict:
    """One more replay under the profiler (its launches are not counted as the
    main path's): the device time by kernel, and the device's idle share of
    an unprofiled replay's wall time ``wall_ms``. The CUPTI trace holds fewer
    list-fold launches than were made (1 of 2 in earlier runs; cause not
    found), so the list fold's share of the busy time is its time from CUDA
    events, ``fold_device_ms``, and the trace gives the rest."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.replay_resident(resident)
        profiled_wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, list] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            acc = by_name.setdefault(evt.name, [0.0, 0])
            acc[0] += evt.time_range.elapsed_us()
            acc[1] += 1
    other_ms = sum(v[0] for n, v in by_name.items() if "list_fold" not in n) / 1e3
    busy_ms = other_ms + fold_device_ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms": wall_ms, "profiled_wall_ms": profiled_wall_us / 1e3,
            "device_busy_ms": busy_ms, "other_device_ms": other_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "list_fold_traced": sum(v[1] for n, v in by_name.items()
                                    if "list_fold" in n),
            "top_kernels": [{"name": n[:80], "ms": v[0] / 1e3, "count": v[1]}
                            for n, v in top]}


def drive_main_path(corpus, layout: str, card: str) -> dict:
    import torch

    from surge_tpu_torch.config import Config
    from surge_tpu_torch.models import counter
    from surge_tpu_torch.replay import fold_kernels
    from surge_tpu_torch.replay.engine import ReplayEngine

    cfg = Config(overrides=dict(BENCH_CONFIG, **{
        "surge.replay.resident-layout": layout}))
    torch.cuda.reset_peak_memory_stats()
    for k in fold_kernels.LAUNCHES:
        fold_kernels.LAUNCHES[k] = 0
    eng = ReplayEngine(counter.make_replay_spec(), config=cfg)
    t0 = time.perf_counter()
    wire = eng.pack_resident(corpus.events)
    t1 = time.perf_counter()
    resident = eng.upload_resident(wire)
    t2 = time.perf_counter()
    eng.warm_resident(resident)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    plan = eng._plan_for(resident)
    n_lists = int(len(plan.big_i0) > 0) + int(len(plan.small_i0) > 0)
    folds = []
    for _ in range(5):
        w0 = eng.stats["windows"]
        l0 = fold_kernels.LAUNCHES["tile_fold_list"]
        f0 = time.perf_counter()
        res = eng.replay_resident(resident)  # ends in the device→host pull
        folds.append(time.perf_counter() - f0)
        tiles = eng.stats["windows"] - w0
        if fold_kernels.LAUNCHES["tile_fold_list"] - l0 != n_lists:
            raise AssertionError(
                f"layout {layout}: a replay launched the list fold "
                f"{fold_kernels.LAUNCHES['tile_fold_list'] - l0} times, not "
                f"once per non-empty work list ({n_lists})")
        if not (np.array_equal(res.states["count"].astype(np.int64),
                               corpus.expected_count)
                and np.array_equal(res.states["version"],
                                   corpus.expected_version)):
            bad = np.flatnonzero(res.states["count"] != corpus.expected_count)
            raise AssertionError(f"layout {layout}: states differ from the "
                                 f"closed form at {bad[:5]}")
    launches = dict(fold_kernels.LAUNCHES)
    if eng.tile_backend != "pallas":
        raise AssertionError(f"tile backend resolved to {eng.tile_backend!r}, "
                             "not the kernel")
    if launches["tile_fold_list"] <= 0:
        raise AssertionError("the main path launched K1's list fold no time")
    if launches["tile_scan"] != 0:
        raise AssertionError(f"the cold replay launched K1's per-tile entry "
                             f"{launches['tile_scan']} times")
    # the fold's device time per replay from CUDA events around the work
    # lists' launches alone; launches made here are not the main path's
    slab, ord_d = eng._fresh_slab(resident.b_pad)
    fold_device_ms = device_ms(lambda: eng._run_tiles(resident, plan, slab, ord_d),
                               7, 5)
    log("phase2-profile " + json.dumps(dict(
        profile_replay(eng, resident, fold_device_ms,
                       statistics.median(folds) * 1e3),
        list_fold_launched=n_lists, card=card, layout=layout)))
    row = {
        "card": card, "layout": layout,
        "dense": eng._use_dense(resident, plan),
        "aggregates": corpus.num_aggregates, "events": corpus.num_events,
        "events_per_s_best": corpus.num_events / min(folds),
        "events_per_s_median": corpus.num_events / statistics.median(folds),
        "pack_s": t1 - t0, "upload_s": t2 - t1, "warm_s": t3 - t2,
        "fold_s": folds, "pad_ratio": res.padded_events / corpus.num_events,
        "tiles_per_replay": tiles, "lists_per_replay": n_lists,
        "fold_device_ms": fold_device_ms,
        "list_launches": launches["tile_fold_list"],
        "k1_tile_launches": launches["tile_scan"],
        "wire_bytes": resident.wire_bytes,
        "device_mem_peak_bytes": torch.cuda.max_memory_allocated(),
    }
    log("phase2 " + json.dumps(row))
    return row


# -- phase 3: resume, and a second model ---------------------------------------------


def split_halves(corpus):
    """(first half of each log, second half, per-aggregate cut)."""
    from surge_tpu_torch.codec.tensor import ColumnarEvents

    ev = corpus.events
    b = corpus.num_aggregates
    starts = np.zeros(b + 1, dtype=np.int64)
    np.cumsum(corpus.lengths, out=starts[1:])
    cut = (corpus.lengths // 2).astype(np.int32)
    pos = np.arange(ev.num_events, dtype=np.int64) - starts[ev.agg_idx]
    first = pos < cut[ev.agg_idx]

    def part(mask):
        return ColumnarEvents(num_aggregates=b, agg_idx=ev.agg_idx[mask],
                              type_ids=ev.type_ids[mask],
                              cols={k: v[mask] for k, v in ev.cols.items()},
                              derived_cols=dict(ev.derived_cols))

    return part(first), part(~first), cut


def bank_corpus(num_accounts: int, seed: int):
    """A bank_account columnar corpus: ragged logs of creates (some repeated,
    some missing so updates land on absent accounts) and balance updates."""
    from surge_tpu_torch.codec.tensor import ColumnarEvents
    from surge_tpu_torch.models import bank_account as ba

    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 90, size=num_accounts)
    n = int(lengths.sum())
    agg = np.repeat(np.arange(num_accounts, dtype=np.int32), lengths)
    starts = np.zeros(num_accounts + 1, dtype=np.int64)
    np.cumsum(lengths, out=starts[1:])
    pos = np.arange(n) - starts[agg]
    created = np.where(pos == 0, rng.random(n) < 0.9, rng.random(n) < 0.05)
    type_ids = np.where(created, ba.CREATED, ba.UPDATED).astype(np.int32)
    quarter = lambda: (rng.integers(0, 4_000_000, size=n) * 0.25).astype(np.float32)  # noqa: E731
    cols = {
        "owner_code": np.where(created, rng.integers(1, 1 << 20, size=n), 0).astype(np.int32),
        "security_code_code": np.where(created, rng.integers(1, 1 << 20, size=n), 0).astype(np.int32),
        "balance": np.where(created, quarter(), 0).astype(np.float32),
        "new_balance": np.where(created, 0, quarter()).astype(np.float32),
    }
    return ColumnarEvents(num_aggregates=num_accounts, agg_idx=agg,
                          type_ids=type_ids, cols=cols)


def phase_resume_and_bank(card: str) -> dict:
    from surge_tpu_torch.config import Config
    from surge_tpu_torch.models import bank_account, counter
    from surge_tpu_torch.replay.corpus import synth_counter_corpus
    from surge_tpu_torch.replay.engine import ReplayEngine

    cfg = Config(overrides=BENCH_CONFIG)
    corpus = synth_counter_corpus(1_000_000, 20_000_000, seed=3)
    first, second, cut = split_halves(corpus)
    eng = ReplayEngine(counter.make_replay_spec(), config=cfg)
    r1 = eng.replay_resident(eng.prepare_resident(first))
    r2 = eng.replay_resident(eng.prepare_resident(second), init_carry=r1.states,
                             ordinal_base=cut)
    full = eng.replay_resident(eng.prepare_resident(corpus.events))
    for name in ("count", "version"):
        if r2.states[name].tobytes() != full.states[name].tobytes():
            raise AssertionError(f"resumed fold differs from one fold in {name!r}")
    if not np.array_equal(full.states["count"].astype(np.int64),
                          corpus.expected_count):
        raise AssertionError("full fold differs from the closed form")

    bcol = bank_corpus(500_000, seed=5)
    spec = bank_account.make_replay_spec()
    outs = {}
    for backend in ("auto", "xla"):
        beng = ReplayEngine(spec, config=Config(overrides=dict(
            BENCH_CONFIG, **{"surge.replay.tile-backend": backend})))
        outs[backend] = beng.replay_resident(beng.prepare_resident(bcol)).states
    for name, col in outs["xla"].items():
        if outs["auto"][name].tobytes() != col.tobytes():
            raise AssertionError(f"bank_account: kernel and plain scan differ "
                                 f"in {name!r}")
    row = {"card": card, "resume_aggregates": corpus.num_aggregates,
           "resume_events": corpus.num_events, "bank_accounts": 500_000,
           "bank_events": bcol.num_events, "ok": True}
    log("phase3 " + json.dumps(row))
    return row


# -- phase 4: the resident state plane -----------------------------------------------

PLANE_TOPIC = "counter-events"
PLANE_PARTITIONS = 8
#: the main plane's deployment: 2^20 resident rows, 1.25x as many aggregates
#: (the seed spills the rest), 16 refresh rounds. A cut forced by the time
#: limit lowers the seed's events, then the rounds, and is recorded in PERF.md
PLANE_CAPACITY = 1 << 20
PLANE_AGGREGATES = 1_310_720
PLANE_ROUNDS = 16
#: one counter event on the log: type id (u8), increment_by (u8),
#: sequence_number (u32), little-endian — decoded by deserialize_event(s)
EVENT_RECORD = np.dtype([("type", "u1"), ("inc", "u1"), ("seq", "<u4")])


def deserialize_events(raws):
    """A batch of compact event records → the port's counter events (every
    record this script writes is a CountIncremented)."""
    from surge_tpu_torch.models.counter import CountIncremented

    recs = np.frombuffer(b"".join(raws), dtype=EVENT_RECORD)
    if recs["type"].any():
        raise ValueError("not a CountIncremented record")
    return [CountIncremented("", inc, seq) for inc, seq in
            zip(recs["inc"].tolist(), recs["seq"].tolist())]


def deserialize_event(raw):
    return deserialize_events([raw])[0]


class PlaneLog:
    """The port's InMemoryLog plus the closed-form state of every aggregate
    (all events increment by 1, so count == version == events folded)."""

    def __init__(self, num_aggregates: int):
        from surge_tpu_torch.log import InMemoryLog, TopicSpec

        self.log = InMemoryLog()
        self.log.create_topic(TopicSpec(PLANE_TOPIC, PLANE_PARTITIONS))
        self.ids = [f"a{i}" for i in range(num_aggregates)]
        self.n_events = np.zeros(num_aggregates, dtype=np.int64)
        self._producer = self.log.transactional_producer("chip-smoke")

    def append(self, aggs: np.ndarray, rng) -> int:
        """Append one event per entry of ``aggs`` (aggregate indices, repeats
        allowed), in a shuffled order that keeps each aggregate's own order,
        as one transaction; returns the event count."""
        from surge_tpu_torch.log import LogRecord

        aggs = aggs[rng.permutation(len(aggs))]
        order = np.argsort(aggs, kind="stable")
        cum = np.empty(len(aggs), dtype=np.int64)
        sorted_aggs = aggs[order]
        first = np.r_[0, np.flatnonzero(np.diff(sorted_aggs)) + 1]
        run = np.arange(len(aggs)) - np.repeat(first, np.diff(np.r_[first, len(aggs)]))
        cum[order] = run
        seq = self.n_events[aggs] + cum + 1
        np.add.at(self.n_events, aggs, 1)
        recs = np.zeros(len(aggs), dtype=EVENT_RECORD)
        recs["inc"] = 1
        recs["seq"] = seq
        buf = recs.tobytes()
        w = EVENT_RECORD.itemsize
        ids = self.ids
        prod = self._producer
        prod.begin()
        for j, a in enumerate(aggs.tolist()):
            prod.send(LogRecord(topic=PLANE_TOPIC, key=ids[a],
                                value=buf[j * w:(j + 1) * w],
                                partition=a % PLANE_PARTITIONS))
        prod.commit()
        return len(aggs)


class RoundLedger:
    """A duck-typed refresh-round ledger: keeps every record_round call."""

    def __init__(self):
        self.rounds = []

    def record_round(self, **kw):
        self.rounds.append(kw)

    def record_evict(self, count, **kw):
        pass

    def record_gather(self, **kw):
        pass


def make_plane(plog, overrides: dict, signals: list, ledger=None):
    from surge_tpu_torch.config import Config
    from surge_tpu_torch.models import counter
    from surge_tpu_torch.replay.resident_state import ResidentStatePlane

    return ResidentStatePlane(
        plog.log, PLANE_TOPIC, counter.make_replay_spec(),
        config=Config(overrides=overrides),
        deserialize_event=deserialize_event,
        deserialize_events=deserialize_events,
        serialize_state=lambda agg, st: repr(st).encode(),
        derived_cols={"sequence_number": "ordinal"},
        on_signal=lambda name, level: signals.append((name, level)),
        ledger=ledger)


def round_aggregates(plog, plane, rng, heavy: bool) -> np.ndarray:
    """One refresh round's events (aggregate index per event): per partition
    up to 4096 events (the poll's and the staleness bound's size, so a round
    folds in one poll and reads never fall back for lag), most touched
    aggregates with 1-4 events and a tail with 17-256, about 20% of them
    spilled; a heavy round gives one aggregate 1,800 events (chained
    windows)."""
    n = len(plog.ids)
    spilled = np.fromiter((int(a[1:]) for a in plane._spill), dtype=np.int64)
    parts = []
    for p in range(PLANE_PARTITIONS):
        budget = 4096
        lane = []
        if heavy and p == 0:
            lane.append(np.full(1800, p, dtype=np.int64))  # aggregate 0
            budget -= 1800
        own_spilled = spilled[spilled % PLANE_PARTITIONS == p]
        k = 1400
        n_sp = min(k // 5, len(own_spilled))
        picks = np.concatenate([
            rng.choice(own_spilled, n_sp, replace=False) if n_sp else
            np.zeros(0, dtype=np.int64),
            rng.integers(0, n // PLANE_PARTITIONS, size=k - n_sp)
            * PLANE_PARTITIONS + p])
        picks = np.unique(picks[picks != 0])
        rng.shuffle(picks)
        lens = rng.integers(1, 5, size=len(picks))
        tail = rng.random(len(picks)) < 0.0125
        lens[tail] = rng.integers(17, 257, size=int(tail.sum()))
        keep = np.cumsum(lens) <= budget
        lane.append(np.repeat(picks[keep], lens[keep]))
        parts.append(np.concatenate(lane))
    return np.concatenate(parts)


async def wait_lag_zero(plane, deadline_s: float):
    t0 = time.perf_counter()
    while plane.lag_records() > 0:
        if time.perf_counter() - t0 > deadline_s:
            raise AssertionError(f"refresh never caught up (lag "
                                 f"{plane.lag_records()})")
        await asyncio.sleep(0.002)


async def read_back(plane, plog, batch: int) -> float:
    """read_many over every aggregate in batches; every state must equal its
    closed form. Returns rows/s."""
    t0 = time.perf_counter()
    for lo in range(0, len(plog.ids), batch):
        ids = plog.ids[lo:lo + batch]
        got = await plane.read_many(ids)
        if len(got) != len(ids):
            raise AssertionError(f"read_many served {len(got)} of {len(ids)}")
        want = plog.n_events[lo:lo + batch]
        count = np.fromiter((got[a].count for a in ids), dtype=np.int64,
                            count=len(ids))
        version = np.fromiter((got[a].version for a in ids), dtype=np.int64,
                              count=len(ids))
        if not (np.array_equal(count, want) and np.array_equal(version, want)):
            bad = np.flatnonzero((count != want) | (version != want))[:5]
            raise AssertionError(
                f"states differ from the closed form at {[ids[i] for i in bad]}: "
                f"{[(int(count[i]), int(version[i]), int(want[i])) for i in bad]}")
    return len(plog.ids) / (time.perf_counter() - t0)


async def torn_row_reader(plane, n: int, stop, seen: dict):
    """Read random aggregates while rounds run: with all-increment traffic
    every row must have count == version (a torn or mis-ordinaled row
    breaks it)."""
    rng = np.random.default_rng(11)
    while not stop.is_set():
        ids = [f"a{i}" for i in rng.integers(0, n, size=4096).tolist()]
        got = await plane.read_many(ids)
        for agg, st in got.items():
            if st.count != st.version:
                raise AssertionError(f"torn row {agg}: {st}")
        seen["reads"] += 1
        seen["rows"] += len(got)
        await asyncio.sleep(0)


def profile_round_stats(prof, wall_s: float) -> dict:
    from torch.autograd import DeviceType

    busy_us, k2_us, k2_n = 0.0, 0.0, 0
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            us = evt.time_range.elapsed_us()
            busy_us += us
            if "ragged_fold_kernel" in evt.name:
                k2_us += us
                k2_n += 1
    wall_us = wall_s * 1e6
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / wall_us if wall_us else None,
            "k2_launches": k2_n,
            "k2_ms_per_launch": k2_us / k2_n / 1e3 if k2_n else None}


async def drive_plane(card: str, *, aggregates: int, capacity: int,
                      rounds: int, dispatch: str, seed: int) -> dict:
    """One plane through its seed, refresh rounds and read-back; fails on any
    signal, fallback, torn row or state off its closed form."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from surge_tpu_torch.replay import fold_kernels

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    plog = PlaneLog(aggregates)
    lens = 1 + rng.binomial(7, 0.2, size=aggregates)  # 1-8 events, ~2.4 mean
    plog.append(np.repeat(np.arange(aggregates, dtype=np.int64), lens), rng)
    log_s = time.perf_counter() - t0
    signals: list = []
    ledger = RoundLedger()
    plane = make_plane(plog, {
        "surge.replay.resident.capacity": capacity,
        "surge.replay.resident.refresh-dispatch": dispatch}, signals, ledger)
    if plane.engine.tile_backend != "pallas":
        raise AssertionError("the plane's backend did not resolve to the kernels")
    # host clocks around two plane stages (measurement only): the LRU
    # eviction (sort on the loop + row pull, fetched in the executor) and
    # each window's executor half (uploads + the locked enqueue of its ops)
    stage_s = {"evict": 0.0, "window": 0.0}

    def timed(stage, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                stage_s[stage] += time.perf_counter() - t
        return run

    def timed_async(stage, fn):
        async def run(*a, **k):
            t = time.perf_counter()
            try:
                return await fn(*a, **k)
            finally:
                stage_s[stage] += time.perf_counter() - t
        return run

    plane._evict = timed_async("evict", plane._evict)
    plane._run_window = timed("window", plane._run_window)
    torch.cuda.reset_peak_memory_stats()
    for k in fold_kernels.LAUNCHES:
        fold_kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    await plane.start()
    start_s = time.perf_counter() - t0
    seed_launches = dict(fold_kernels.LAUNCHES)
    for k in fold_kernels.LAUNCHES:
        fold_kernels.LAUNCHES[k] = 0
    # the (width, lanes) of every window the rounds give K1's per-tile entry,
    # so each is held against the plain version after the run
    window_shapes: list = []
    tile_scan = fold_kernels.tile_scan

    def tile_scan_seen(carry, words, *a, **k):
        window_shapes.append(tuple(words.shape))
        return tile_scan(carry, words, *a, **k)

    fold_kernels.tile_scan = tile_scan_seen
    stop = asyncio.Event()
    seen = {"reads": 0, "rows": 0}
    reader = asyncio.ensure_future(torn_row_reader(plane, aggregates, stop, seen))
    per_round = []
    profiled = None
    try:
        for r in range(rounds + 1):  # the last round runs under the profiler
            aggs = round_aggregates(plog, plane, rng, heavy=r % 4 == 3)
            n0 = len(ledger.rounds)
            s0 = dict(stage_s)
            # the round's clock starts once the append returns: the append
            # is synchronous on the loop, so the plane cannot start its
            # round before that
            if r == rounds:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    a0 = time.perf_counter()
                    plog.append(aggs, rng)
                    w0 = time.perf_counter()
                    await wait_lag_zero(plane, 300.0)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - w0
                profiled = profile_round_stats(prof, wall)
            else:
                a0 = time.perf_counter()
                plog.append(aggs, rng)
                w0 = time.perf_counter()
                await wait_lag_zero(plane, 300.0)
                wall = time.perf_counter() - w0
            append_s = w0 - a0
            for kw in ledger.rounds[n0:]:
                per_round.append({
                    "round": r, "events": kw["events"], "lanes": kw["lanes"],
                    "buckets": len(kw["buckets"] or ()),
                    "windows": kw["windows"], "evictions": kw["evictions"],
                    "waste_ratio": (kw["dispatched"] / kw["occupied"]
                                    if kw["occupied"] else 0.0),
                    "feed_ms": kw["feed_us"] / 1e3,
                    "encode_ms": kw["encode_us"] / 1e3,
                    "dispatch_ms": kw["dispatch_us"] / 1e3,
                    "window_exec_ms": (stage_s["window"] - s0["window"]) * 1e3,
                    "evict_ms": (stage_s["evict"] - s0["evict"]) * 1e3,
                    "appended": len(aggs), "append_ms": append_s * 1e3,
                    "wall_ms": wall * 1e3,
                    "profiled": r == rounds})
            if seen["reads"] == 0:
                await asyncio.sleep(0.01)
    finally:
        fold_kernels.tile_scan = tile_scan
        stop.set()
        await reader
    refresh_launches = dict(fold_kernels.LAUNCHES)
    rows_per_s = await read_back(plane, plog, 65536)
    await plane.stop()
    measured = [x for x in per_round if not x["profiled"]]
    ev = sum(x["events"] for x in measured)
    wall_ms = sum(x["wall_ms"] for x in {x["round"]: x for x in measured}.values())
    if signals:
        raise AssertionError(f"the plane signalled {signals}")
    if plane.stats["fallbacks"]:
        raise AssertionError(f"{plane.stats['fallbacks']} reads fell back: "
                             f"{plane.fallback_causes}")
    if plane.stats["evictions"] <= 0:
        raise AssertionError("no round evicted")
    if seed_launches["tile_fold_list"] <= 0:
        raise AssertionError("the seed launched K1's list fold no time")
    if seed_launches["tile_scan"] != 0:
        raise AssertionError("the seed launched K1's per-tile entry")
    key = "ragged_fold" if dispatch == "bucketed" else "tile_scan"
    if refresh_launches[key] <= 0:
        raise AssertionError(f"the refresh rounds launched {key} no time")
    if len(window_shapes) != refresh_launches["tile_scan"]:
        raise AssertionError(f"{len(window_shapes)} windows reached K1's "
                             f"per-tile entry, which launched "
                             f"{refresh_launches['tile_scan']} times")
    if seen["reads"] == 0:
        raise AssertionError("the torn-row reader never read")
    return {
        "card": card, "dispatch": dispatch, "aggregates": aggregates,
        "capacity": capacity, "seed_events": int(lens.sum()),
        "log_build_s": log_s, "start_s": start_s, "seed": plane.seed_timing,
        "seed_launches": seed_launches,
        "refresh_launches": refresh_launches,
        "window_shapes": [[w, b, window_shapes.count((w, b))]
                          for w, b in sorted(set(window_shapes))],
        "rounds": per_round, "refresh_events_per_s": ev / (wall_ms / 1e3),
        "read_many_rows_per_s": rows_per_s,
        "torn_reader": seen, "evictions": plane.stats["evictions"],
        "fallbacks": plane.stats["fallbacks"],
        "device_mem_peak_bytes": torch.cuda.max_memory_allocated(),
        "profiled_round": profiled}


def phase_plane(card: str) -> dict:
    main = asyncio.run(drive_plane(
        card, aggregates=PLANE_AGGREGATES, capacity=PLANE_CAPACITY,
        rounds=PLANE_ROUNDS, dispatch="bucketed", seed=4))
    log("phase4 " + json.dumps(main))
    dense = asyncio.run(drive_plane(
        card, aggregates=65536, capacity=32768, rounds=4, dispatch="dense",
        seed=5))
    log("phase4-dense " + json.dumps(dense))
    return {"main": main, "dense": dense}


def total_launches(paths: dict) -> int | None:
    """The launches of the paths that ran in this call; None if none ran."""
    ran = [n for n in paths.values() if n is not None]
    return sum(ran) if ran else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="0,1,2,3,4",
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from surge_tpu_torch import _build
    from surge_tpu_torch.replay import fold_kernels
    from surge_tpu_torch.replay.corpus import synth_counter_corpus

    card = card_line()
    log(f"phase0 card: {card}")
    build_s = _build.build_all()
    log(f"phase0 build_s: {json.dumps(build_s)}")
    for name in ("tile_scan", "ragged_fold"):
        log(_build.library_path(name).with_suffix(".log").read_text().strip())
    fold_kernels.load()

    corpus = None
    if phases & {1, 2}:
        t0 = time.perf_counter()
        corpus = synth_counter_corpus(1_000_000, 100_000_000, seed=0)
        log(f"phase1 corpus_s: {time.perf_counter() - t0:.3f}")
    k1 = klist = k2 = None
    if 1 in phases:
        k1 = phase_kernels()
        klist = phase_list_kernel(corpus.events)
        k2 = phase_ragged_kernel()
    main_rows = []
    if 2 in phases:
        main_rows.append(drive_main_path(corpus, "auto", card))
        main_rows.append(drive_main_path(corpus, "flat", card))
    del corpus
    if 3 in phases:
        phase_resume_and_bank(card)
    plane = None
    if 4 in phases:
        plane = phase_plane(card)
        checked = ({(w, b) for w, b, _ in PLANE_WINDOW_SHAPES} if k1 is not None
                   else set())
        for row in check_plane_window_shapes(plane["dense"]["window_shapes"],
                                             checked):
            if k1 is not None:
                k1["rows"].append(row)

    if k1 is not None:
        # launches on each main path, read right after that path ran with
        # the counts at 0 (None: the path did not run in this call)
        main_p = plane["main"] if plane else None
        dense_p = plane["dense"] if plane else None
        k1_paths = {
            "cold_replay_auto": (main_rows[0]["k1_tile_launches"] if main_rows
                                 else None),
            "cold_replay_flat": (main_rows[1]["k1_tile_launches"] if main_rows
                                 else None),
            "plane_seed": main_p["seed_launches"]["tile_scan"] if plane else None,
            "plane_refresh": (main_p["refresh_launches"]["tile_scan"]
                              if plane else None),
            "plane_dense_seed": (dense_p["seed_launches"]["tile_scan"]
                                 if plane else None),
            "plane_dense_refresh": (dense_p["refresh_launches"]["tile_scan"]
                                    if plane else None),
        }
        list_paths = {
            "cold_replay_auto": (main_rows[0]["list_launches"] if main_rows
                                 else None),
            "cold_replay_flat": (main_rows[1]["list_launches"] if main_rows
                                 else None),
            "plane_seed": (main_p["seed_launches"]["tile_fold_list"]
                           if plane else None),
            "plane_dense_seed": (dense_p["seed_launches"]["tile_fold_list"]
                                 if plane else None),
        }
        k2_paths = {"plane_refresh": (main_p["refresh_launches"]["ragged_fold"]
                                      if plane else None)}
        # the per-tile entry's line: the plane's heavy-round window (counter,
        # derived ordinal, width 512, 32,768 lanes, the first window)
        head = next(r for r in k1["rows"]
                    if r["case"] == "counter/derived"
                    and (r["width"], r["bs"], r["shift"]) == PLANE_WINDOW_SHAPES[1])
        kernels = [{
            "name": "tile_scan",
            "route": "cuda",
            "source": "surge_tpu_torch/csrc/tile_scan.cu",
            "replaces": "surge_tpu/replay/pallas_fold.py:86",
            "launches": total_launches(k1_paths),
            "launches_by_path": k1_paths,
            "max_abs_err": max(r["max_abs_err"] for r in k1["rows"]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None,  # no PyTorch call folds a per-lane sequence
            "timed_at": [head["width"], head["bs"]],
            "window_shapes": dense_p["window_shapes"] if plane else None,
        }]
        # the list fold's line: one cold replay's work lists on the bench
        # plan (counter, derived ordinal, dense), both launches together
        head = klist["rows"][0]
        kernels.append({
            "name": "tile_fold_list",
            "route": "cuda",
            "source": "surge_tpu_torch/csrc/tile_scan.cu",
            "replaces": "surge_tpu/replay/pallas_fold.py:86",
            "launches": total_launches(list_paths),
            "launches_by_path": list_paths,
            "max_abs_err": max(r["max_abs_err"] for r in klist["rows"]),
            "ms": head["ms"], "ms_per_launch": head["ms_per_launch"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None,  # no PyTorch call folds a per-lane sequence
        })
        # K2's line: the steady refresh bucket (counter, derived ordinal,
        # bs 4096, width 8, rows 32768)
        head = next(r for r in k2["rows"]
                    if r["case"] == "counter/derived" and r["bs"] == 4096)
        kernels.append({
            "name": "ragged_fold",
            "route": "cuda",
            "source": "surge_tpu_torch/csrc/ragged_fold.cu",
            "replaces": "surge_tpu/replay/pallas_fold.py:170",
            "launches": total_launches(k2_paths),
            "launches_by_path": k2_paths,
            "max_abs_err": max(r["max_abs_err"] for r in k2["rows"]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None,  # no PyTorch call folds a per-lane sequence
        })
        log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))  # the run uses one card, whatever else is visible
    return 0


if __name__ == "__main__":
    sys.exit(main())
