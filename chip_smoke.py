#!/usr/bin/env python3
"""Drive surge_tpu_torch's main paths on one CUDA card and check them.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA card
and the CUDA toolkit (``nvcc``); it builds the kernels from ``surge_tpu_torch/csrc``
first. Phases:

0. the card's name and power limit, and the kernel build time;
1. each kernel against its plain torch version on the card, byte for byte, at
   the main paths' shapes, with its time, bound and the plain time. The two
   refresh-window kernels (K1's dense window, K2's ragged window), each one
   launch against a 2^20-row slab by slot, at the plane's windows
   (``WINDOW_CASES``: the dense plane's 32,768-lane windows of width 256 and
   512, first and chained, and an 8-lane window off TMA's rules; the
   bucketed plane's buckets of widths 2, 4, 8 (the steady 4,096-lane
   bucket), 256 and the heavy lane's chained 512, a chained window of long
   lanes over a block's shared memory (the global-read path), clipped
   reads; windows with and without admission, padding lanes), for five
   model layouts (counter with the ordinal derived and shipped,
   bank_account, shopping_cart and saga), with the path each block took as
   the kernel reports it; K1's list fold over the bench plan's work lists
   (dense) and, on cut corpora, both sources, the five layouts and the edges
   (bs_small 8; batches of 104, 256 and 2,000 lanes, whose tiles start and
   end inside a lane block, staged or loaded per lane; width 512), and on
   phase 5's 1M carts and 1M sagas (dense); and K1 at the non-resident
   windows (one-tile dense lists, ``NONRES_*``): every ladder width 8-256
   and the 512 chunk at B-chunks of 8, 24 and 8,192 lanes, a mid-log
   out-of-range type id and an ordinal base past 2^20 in every window, the
   rows past the B-chunk untouched;
2. the main path at full size: ``synth_counter_corpus(1M aggregates, 100M
   events)`` through ``ReplayEngine`` under the bench config (batch 8192,
   time-chunk 64, tile-backend auto), ``pack_resident`` → ``upload_resident``
   → ``warm_resident`` → ``replay_resident`` five times, with the layout
   ``auto`` picks and with ``flat``; the states must equal the closed-form
   expected states exactly, each replay must launch the list fold once per
   non-empty work list, and no window kernel;
3. a resumed fold (first half of each log, then the rest from ``init_carry`` and
   ``ordinal_base``) and a bank_account corpus against the plain scan;
4. the resident state plane (``ResidentStatePlane``) at deployment size: the
   port's ``InMemoryLog`` with 8 partitions, the reference's default config
   with 2^20 resident rows, a cold-start seed of 1,310,720 aggregates (~1.57M
   events) through K1's list fold, 4 refresh rounds of about 32k events
   through K2's window
   (evicting and re-admitting, with chained windows every fourth round)
   while a reader checks that no row is torn, then every aggregate read back
   against its closed form; and a smaller plane on the dense dispatch
   through K1's dense window. Each refresh window must be ONE window-kernel
   launch; the profiled round gives the device busy time, idle share and
   the device operations per window. Each window kernel is then held
   against its plain version at every window shape the planes gave it that
   phase 1 did not check (the saga plane's too);
5. the families' cold replay: 1M carts and 1M sagas (seeded numpy walks of
   the reference's ``random_cart_log`` and ``random_saga_log``) on ``auto``
   (K1, dense), ``flat`` (K1) and ``xla`` (the plain scan), carts also on
   ``assoc``; the counter 1M/100M corpus and 500k bank accounts on K1, then
   on ``assoc``; every arm's states byte-equal to the others' (and to
   the walks' final states), events/s per arm;
6. the saga family through the resident state plane: 327,680 sagas, 2^18
   rows, a seed of the logs' prefixes through K1 and 4 refresh rounds of
   their rests through K2 (one launch a window) while a reader holds every
   row it reads to its saga's state at that version; no fallback, no signal,
   and every saga read back byte-equal to a plain cold replay of the log;
7. cold start from a columnar segment: the bench corpus written once as a
   segment of 16 chunks of 65,536 aggregates, restored twice with
   ``restore_from_segment`` into the in-memory store (wire cache cold, then
   warm; each chunk K1's flat list fold); every stored state decoded and
   held to the closed form; seconds per stage, K1's launches and device
   time per chunk, peak host memory;
8. ``restore_from_events`` over the port's InMemoryLog (8 partitions, the
   plane's counter record): the in-memory route (~200k events, the tpu
   store byte-equal to the cpu backend's), the checkpointed route (a
   checkpoint at half of each log, then the tail) and the spilled route
   (~1.05M events, through a throwaway segment), each against its closed
   form;
9. ``replay_resident_streamed`` on the 1M / 100M wire at 1 and 8
   segments in turns with ``upload_resident`` + ``replay_resident``, all
   byte-equal, each arm's wall beside its upload and fold seconds;
10. ``replay_columnar`` on 1M carts and on the counter corpus cut to 200k
   aggregates / 20M events, against the walk or the closed form and, on a
   subset, the plain eager scan; events/s, windows, K1 launches;
11. the analytics plane on phase 7's segment: the scan-reduce kernel held to
   its plain twin byte for byte on the scans the engine gives it (the first
   chunk's queries, 500k bank accounts' float columns, ``group_by type_id``
   over float sums, one aggregate of millions of events among 65,536; the
   same ``group_by`` over 22M bank events held to the numpy oracle), its
   time beside its byte bound, its float sums' serial floor, the library
   call and, with ``--baseline``, an earlier tree's kernel; ``scan_segment``
   (all ops, and ``group_by type_id``) and ``query_states_segment`` over the
   16 chunks; the views on phase 4's plane, and the plane's fault hooks;
12. the engine at the plane's full deployment: ``create_engine`` over the port's
   InMemoryLog (8 partitions, 1,310,720 counter aggregates, ~3.1M events in
   the counter's JSON, as the publisher writes them) with the resident plane
   (2^20 rows), ``restore-on-start`` and a segment path, one view registered
   before ``start()``. The cold start (segment build, the restore through
   K1, the plane's seed through K1, the view's seed through scan_reduce),
   every stored state decoded against the closed form; 10,000 Increment
   commands over 5,000 aggregates (half resident, half spilled) in turns,
   each reply against the closed form, every refresh window one window-kernel
   launch, at least one entity init served by the plane's gather lane,
   commands/s, reply latency p50 and p99 by kind, the refresh lag after the
   burst and a profiled wave's device idle share; every burst target read
   back through the plane against the closed form;
   ``project_states`` over 65,536 aggregates through the gather lane; the
   view against a from-scratch ``scan_chunks``; ``engine.query`` (the
   segment extended with the commands' events) against ``scan_reference``;
   ``engine.query_states`` against the closed form; then ``stop()`` and a
   second engine on the same log, its store byte-equal to the first's and
   its plane read back against the closed form. K1, a window kernel and
   scan_reduce must each launch in the phase. Then each window kernel is
   held against its plain version at every window shape the burst gave it
   that no earlier check held;
13. mixed aggregate-type replay: the four families in one combined spec
   (``surge_tpu_torch.replay.mixed``), folded by the kernels' mixed step.
   K1 (list fold, dense and flat, over 65,536 aggregates, a quarter of each
   family, interleaved; one non-resident window of 512 x 8,192 lanes; the
   dense window) and K2 against their plain versions at the plane's window
   shapes; a cold replay of 1M counters / 20M events, 1M carts, 1M sagas and
   500k bank accounts (3.5M aggregates, ~50M events) in one corpus, dense
   and flat, every lane equal to its family's own single-family K1 replay
   and to the closed forms; a bucketed plane of 262,144 aggregates on 2^17
   rows and a dense one of 65,536 on 32,768 over a mixed topic, each window
   one kernel launch, every aggregate read back equal to its family's fold;
   then each window kernel at every window shape the mixed planes gave it;
then one JSON line of every kernel's numbers, the card line, and a last line
``{"ok": true, "device": {...}}``.

Any failure raises, exits non-zero and prints no result line. Without a CUDA
card it exits with code 2 before doing anything.
"""

from __future__ import annotations

import argparse
import asyncio
import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
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
    ~10 ms spin kernel so the host's launch cost leaves no gap in the stream
    (the spin runs before the start event; warmed up first). A ~1 ms spin
    was too short on a slow host: ten calls of a wrapper with seven side
    columns took longer to enqueue, and their gaps were timed."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def reset_launches() -> None:
    from surge_tpu_torch.replay import fold_kernels, scan_reduce

    for counts in (fold_kernels.LAUNCHES, scan_reduce.LAUNCHES):
        for k in counts:
            counts[k] = 0


# -- phase 1: kernel against its plain version ---------------------------------------


def kernel_cases():
    """(label, spec, wire) for the five layouts the kernels must decode: the
    counter with its ordinal derived or shipped, bank_account (bool and f32
    state), shopping_cart (three side columns, bool state, wrapping
    products) and saga (seven side columns, twelve state fields), both with
    the ordinal derived."""
    from surge_tpu_torch.codec.wire import WireFormat
    from surge_tpu_torch.models import bank_account, counter, shopping_cart
    from surge_tpu_torch.saga import model as saga

    cspec = counter.make_replay_spec()
    bspec = bank_account.make_replay_spec()
    derived = {"sequence_number": "ordinal"}
    out = [
        ("counter/derived", cspec, WireFormat(cspec.registry, derived)),
        ("counter/side", cspec, WireFormat(cspec.registry, {})),
        ("bank_account", bspec, WireFormat(bspec.registry, {})),
    ]
    for name, mod in (("shopping_cart", shopping_cart), ("saga", saga)):
        spec = mod.make_replay_spec()
        out.append((f"{name}/derived", spec, WireFormat(spec.registry, derived)))
    return out


#: the layout of each family the kernels line times (``ms_by_model``)
MODEL_LAYOUTS = {"counter": "counter/derived",
                 "shopping_cart": "shopping_cart/derived",
                 "saga": "saga/derived"}


#: the refresh windows phase 1 checks, at the plane's shapes: (label, kind,
#: lanes, live lanes, width, window offset t_base, admits, lane lengths).
#: Dense (drive_plane, dispatch "dense"): a round folds ~8,000 lanes padded
#: to _pow8 = 32,768; its longest log (a tail of 17-256 events) sets the
#: width to 256, and a heavy round's 1,800-event lane sets it to 512 over
#: four chained windows; a window of 8 lanes breaks TMA's 16-byte rules and
#: takes the plain-load path. Ragged (dispatch "bucketed"): pow2 length
#: buckets of a round's ~9,000 lanes (widths 2 and 4 hold most of them, the
#: steady bucket is 4,096 lanes of width 8, the tail buckets a few dozen
#: lanes), the heavy lane's chained 512-wide windows, a chained window of
#: 256 long lanes whose span exceeds a block's shared memory (the global-read
#: path), and lanes whose reads clip at the buffer's last row
WINDOW_CASES = [
    ("dense w256", "dense", 32768, 8000, 256, 0, True, "round"),
    ("dense w512", "dense", 32768, 8000, 512, 0, True, "heavy"),
    ("dense w512 chained", "dense", 32768, 8000, 512, 1024, False, "heavy"),
    ("dense 8 lanes", "dense", 8, 5, 8, 0, True, "short"),
    ("ragged w2", "ragged", 8192, 4500, 2, 0, True, (1, 2)),
    ("ragged w4", "ragged", 8192, 4500, 4, 0, True, (3, 4)),
    ("ragged w8 steady", "ragged", 4096, 3500, 8, 0, False, (5, 8)),
    ("ragged w256", "ragged", 64, 40, 256, 0, True, (129, 256)),
    ("ragged w512 chained", "ragged", 8, 1, 512, 512, False, (1800, 1800)),
    ("ragged over budget", "ragged", 256, 256, 512, 512, False, (2000, 2000)),
    ("ragged clipped", "ragged", 8, 6, 2, 0, True, "clip"),
]
#: the rows the kernels line times (counter, derived ordinal): the dense
#: plane's heavy window and the bucketed plane's steady bucket
WINDOW_HEAD = {"dense": "dense w512", "ragged": "ragged w8 steady"}


def lane_lengths(rng, live: int, width: int, spec) -> np.ndarray:
    """Each live lane's events: a dense round's (1-4, a 1.25% tail of
    17-256, and at "heavy" lane 0 with 1,800), a few ("short"), uniform in a
    bucket's (lo, hi), or the given array."""
    if isinstance(spec, np.ndarray):
        return spec
    if spec in ("round", "heavy"):
        n = rng.integers(1, 5, size=live)
        tail = rng.random(live) < 0.0125
        n[tail] = rng.integers(17, 257, size=int(tail.sum()))
        if spec == "heavy":
            n[0] = 1800
        return n
    if spec in ("short", "clip"):
        return rng.integers(1, width + 1, size=live)
    return rng.integers(spec[0], spec[1] + 1, size=live)


def window_case(kind: str, spec, wire, lanes: int, live: int, width: int,
                t_base: int, admit: bool, lengths, seed: int,
                capacity: int, rows: int | None = None) -> dict:
    """One refresh window's inputs on the card, laid out as the plane lays
    them out: ``live`` lanes at distinct random slots of a ``capacity``-row
    slab (the rest pad to the scratch row), counts ``clip(lengths - t_base,
    0, width)``, the ragged bucket's events lane-contiguous from the
    exclusive cumsum of the lengths in ``_pow2(events)`` rows (or ``rows``),
    random wire bytes in every slot and row (corrupt type ids, garbage past
    the counts), random side values, slab and ordinals (near int32 max too),
    and on an admitting window a random fifth of the lanes admitted."""
    import torch

    from surge_tpu_torch.replay import fold_kernels

    rng = np.random.default_rng(seed)
    fields = spec.registry.state.fields

    def col(dt, n):
        dt = np.dtype(dt)
        if dt == np.bool_:
            return rng.integers(0, 2, size=n).astype(bool)
        if dt == np.float32:
            return rng.standard_normal(n).astype(np.float32)
        return rng.integers(-(1 << 31), 1 << 31, size=n,
                            dtype=np.int64).astype(dt)

    n = lane_lengths(rng, live, width, lengths).astype(np.int64)
    slots = np.full(lanes, capacity, dtype=np.int32)
    slots[:live] = rng.choice(capacity, live, replace=False)
    counts = np.zeros(lanes, dtype=np.int32)
    counts[:live] = np.clip(n - t_base, 0, width)
    starts = None
    if kind == "ragged":
        total = int(n.sum())
        if rows is None:
            rows = 8
            while rows < total:
                rows *= 2
        starts = np.zeros(lanes, dtype=np.int64)
        starts[1:live] = np.cumsum(n)[:live - 1]
        starts[:live] += t_base
        if isinstance(lengths, str) and lengths == "clip":  # all, half clip
            starts[2], starts[3] = rows - 1, max(rows - 1 - width // 2, 0)
            counts[2:4] = width
        starts = starts.astype(np.int32)
        words = rng.integers(0, 256, size=(rows, wire.nbytes), dtype=np.uint8)
        sides = {f.name: col(f.dtype, rows) for f in wire.side_fields}
    else:
        words = rng.integers(0, 256, size=(width, lanes, wire.nbytes),
                             dtype=np.uint8)
        sides = {f.name: col(f.dtype, width * lanes).reshape(width, lanes)
                 for f in wire.side_fields}
    admission = None
    if admit:
        flag = np.zeros(lanes, dtype=bool)
        flag[:live] = rng.random(live) < 0.2
        admission = (flag, col(np.int32, lanes),
                     {f.name: col(f.dtype, lanes) for f in fields})
    table = fold_kernels.window_table(slots, counts, starts, admission,
                                      tuple(f.name for f in fields))
    slab = {f.name: col(f.dtype, capacity + 1) for f in fields}
    ords = col(np.int32, capacity + 1)
    ords[slots[:2]] = np.iinfo(np.int32).max
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    return {"kind": kind, "slab": {k: to(v) for k, v in slab.items()},
            "ords": to(ords), "table": to(table), "table_np": table,
            "words": to(words), "sides": {k: to(v) for k, v in sides.items()},
            "width": width, "rows": rows, "lanes": lanes, "live": live,
            "capacity": capacity}


def window_call(c: dict, spec, wire, plain: bool = False, paths=None):
    """A call of the case's window (kernel or plain version) on the case's
    own slab and ordinals, in place; ``paths`` takes the kernel's per-lane
    path report."""
    from surge_tpu_torch.replay import fold_kernels

    fn = getattr(fold_kernels, f"{c['kind']}_window"
                 + ("_reference" if plain else ""))
    kw = {"width": c["width"]} if c["kind"] == "ragged" else {}
    if paths is not None:
        kw["paths"] = paths
    return lambda: fn(c["slab"], c["ords"], c["table"], c["words"], c["sides"],
                      spec=spec, wire=wire, **kw)


def fold_need(spec, wire, tids, lanes, n_lanes: int,
              weights=None) -> tuple[int, np.ndarray]:
    """What folding events of type ids ``tids`` (each in lane ``lanes``,
    ``weights`` events each, else one) needs: (the events' bytes, the state
    bytes of each of ``n_lanes`` lanes). A single-family spec: every event
    its wire bytes and every side column, every lane every state field. A
    combined spec: an event its wire bytes and the side columns of its own
    family (the wire alone where no family holds its type id: the step
    carries the state through it), a lane the state fields of each family
    its events reach (none for a lane without events)."""
    from surge_tpu_torch.engine.model import MixedKernelStep
    from surge_tpu_torch.replay import fold_kernels

    size = {f.name: np.dtype(f.dtype).itemsize for f in spec.registry.state.fields}
    side = {f.name: np.dtype(f.dtype).itemsize for f in wire.side_fields}
    tids = np.asarray(tids, np.int64)
    w = np.ones(len(tids), np.int64) if weights is None else np.asarray(weights, np.int64)
    step = spec.kernel_step
    if not isinstance(step, MixedKernelStep):
        return (int(w.sum()) * (wire.nbytes + sum(side.values())),
                np.full(n_lanes, sum(size.values()), np.int64))
    ev = np.full(len(tids), wire.nbytes, np.int64)
    reached = np.zeros((n_lanes, len(step.parts)), bool)
    for p, part in enumerate(step.parts):
        cols = fold_kernels.KERNEL_STEPS[part.step][1]
        mine = (tids >= part.base) & (tids < part.base + part.num_types)
        ev[mine] += sum(side.get(c, 0) for c in cols)
        reached[np.asarray(lanes)[mine], p] = True
    state = np.zeros(n_lanes, np.int64)
    codes = reached @ (1 << np.arange(len(step.parts)))
    for code in np.unique(codes).tolist():
        names = {f for p, part in enumerate(step.parts) if code >> p & 1
                 for f in fold_kernels.KERNEL_STEPS[part.step][0]}
        state[codes == code] = sum(size[n] for n in names)
    return int((ev * w).sum()), state


def wire_type_ids(wire, words: np.ndarray) -> np.ndarray:
    """The type id of each packed u8 word ``[..., nbytes]`` (-1 at or above
    the wire's ``num_types``: the kernels carry the state through it)."""
    word = np.zeros(words.shape[:-1], np.int64)
    for k in range(words.shape[-1]):
        word |= words[..., k].astype(np.int64) << (8 * k)
    tid = word & ((1 << wire.type_bits) - 1)
    return np.where(tid >= wire.num_types, -1, tid)


def window_work(c: dict, spec, wire) -> tuple[int, int]:
    """(bytes, valid steps) one window needs on these inputs, each read or
    written once: the bytes of each slot a live lane folds (``fold_need``);
    every lane's slot (it marks the padding lanes); each live lane's count,
    its start (ragged) and, on an admitting window, its admit flag; an
    admitted lane's ordinal and values; each live lane's ordinal and its
    state (``fold_need``'s fields) read by slot unless admitted, and written
    by slot (an admitted lane every field)."""
    from surge_tpu_torch.replay import fold_kernels

    t = c["table_np"]
    live = t[fold_kernels.LANE_SLOT] != c["capacity"]
    n_live = int(live.sum())
    counts = np.clip(t[fold_kernels.LANE_COUNT], 0, c["width"]) * live
    steps = int(counts.sum())
    admits = t.shape[0] > fold_kernels.LANE_ADMIT
    admitted = (t[fold_kernels.LANE_ADMIT] != 0) & live if admits else np.zeros_like(live)
    fields = spec.registry.state.fields
    full = sum(np.dtype(f.dtype).itemsize for f in fields) + 4
    lane = np.repeat(np.arange(c["lanes"]), counts)
    at = np.arange(steps) - np.repeat(np.cumsum(counts) - counts, counts)
    words = c["words"].cpu().numpy()
    if c["kind"] == "ragged":
        start = t[fold_kernels.LANE_START].astype(np.int64)
        tids = wire_type_ids(wire, words[np.minimum(start[lane] + at, c["rows"] - 1)])
    else:
        tids = wire_type_ids(wire, words[at, lane])
    ev_bytes, state = fold_need(spec, wire, tids, lane, c["lanes"])
    row = (state + 4)[live]
    table = 4 * (t.shape[1] + n_live * (1 + (c["kind"] == "ragged") + admits)
                 + int(admitted.sum()) * (1 + len(fields)))
    adm = admitted[live]
    nbytes = (ev_bytes + table + int(row[~adm].sum())
              + int(np.where(adm, full, row).sum()))
    return nbytes, steps


def lanes_by_path(paths) -> dict:
    """The kernel's per-lane path report, counted by path."""
    from surge_tpu_torch.replay import fold_kernels

    p = paths.cpu().numpy()
    return {name: int((p == v).sum()) for name, v in (
        ("staged", fold_kernels.PATH_STAGED), ("global", fold_kernels.PATH_GLOBAL),
        ("none", fold_kernels.PATH_NONE))}


def check_window_case(label: str, spec, wire, c: dict, timed: bool) -> dict:
    """A window kernel against its plain version on one case, byte for byte
    over every slab row and ordinal but the scratch row, with the lanes of
    each path the kernel reports; with ``timed``, its device time (CUDA
    events behind a spin kernel), bound and the plain version's time."""
    import torch

    kind = c["kind"]
    slab0 = {k: v.clone() for k, v in c["slab"].items()}
    ords0 = c["ords"].clone()
    paths = torch.full((c["lanes"],), 9, dtype=torch.int8, device="cuda")
    window_call(c, spec, wire, paths=paths)()
    got = ({k: v.clone() for k, v in c["slab"].items()}, c["ords"].clone())
    for k, v in slab0.items():
        c["slab"][k].copy_(v)
    c["ords"].copy_(ords0)
    window_call(c, spec, wire, plain=True)()
    torch.cuda.synchronize()
    cap = c["capacity"]
    err = 0.0
    for name, v in c["slab"].items():
        g, w = got[0][name][:cap].cpu().numpy(), v[:cap].cpu().numpy()
        if g.tobytes() != w.tobytes():
            raise AssertionError(
                f"{kind} window {label}: slab {name!r} differs from the plain "
                f"version at row {int(np.flatnonzero(g != w)[0])}")
        err = max(err, float(np.abs(g.astype(np.float64) - w.astype(np.float64)).max()))
    g, w = got[1][:cap].cpu().numpy(), c["ords"][:cap].cpu().numpy()
    if g.tobytes() != w.tobytes():
        raise AssertionError(f"{kind} window {label}: ordinals differ from the "
                             f"plain version at row {int(np.flatnonzero(g != w)[0])}")
    nbytes, steps = window_work(c, spec, wire)
    row = {"case": label, "kind": kind, "lanes": c["lanes"], "live": c["live"],
           "width": c["width"], "rows": c["rows"], "max_abs_err": err,
           "bytes": nbytes, "valid_steps": steps,
           "lanes_by_path": lanes_by_path(paths)}
    if sum(row["lanes_by_path"].values()) != c["lanes"]:
        raise AssertionError(f"{kind} window {label}: the kernel reported no "
                             f"path for some lanes: {row['lanes_by_path']}")
    if timed:
        bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = steps * 12 / INT32_OPS_PER_S * 1e3
        row.update({
            "ms": device_ms(window_call(c, spec, wire), 7, 10),
            "ms_source": "events",
            "call_ms": cuda_ms(window_call(c, spec, wire), 7, 10),
            # the plain version repeats the kernel's arithmetic in eager
            # torch: a correctness yardstick, not a speed one
            "plain_ms": cuda_ms(window_call(c, spec, wire, plain=True), 3, 1),
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"})
    log("phase1-window " + json.dumps(row))
    return row


def phase_windows() -> dict:
    """Both window kernels against their plain versions at the plane's
    window shapes, five layouts; every case timed on the counter plane's
    layout (counter, derived ordinal), the head shapes (``WINDOW_HEAD``) on
    each family's layout too."""
    import torch

    rows = []
    for li, (layout, spec, wire) in enumerate(kernel_cases()):
        for i, (label, kind, lanes, live, width, t_base, admit, lengths) in \
                enumerate(WINDOW_CASES):
            c = window_case(kind, spec, wire, lanes, live, width, t_base, admit,
                            lengths, seed=100 * li + i, capacity=PLANE_CAPACITY)
            rows.append(dict(check_window_case(
                f"{layout} {label}", spec, wire, c,
                timed=li == 0 or (layout in MODEL_LAYOUTS.values()
                                  and label in WINDOW_HEAD.values())),
                layout=layout))
            del c
    torch.cuda.empty_cache()
    # the paths the kernels reported: a chained window of long lanes spans
    # more than a ragged block's shared memory; a steady bucket, packed back
    # to back, stages; the 8-lane dense window breaks TMA's 16-byte rules
    # and the 32,768-lane one keeps them
    by = {r["case"]: r["lanes_by_path"] for r in rows}
    for layout, _, _ in kernel_cases():
        checks = {"ragged over budget": by[f"{layout} ragged over budget"]["global"] > 0,
                  "ragged w8 steady": by[f"{layout} ragged w8 steady"]["global"] == 0
                  and by[f"{layout} ragged w8 steady"]["staged"] > 0,
                  "dense 8 lanes": by[f"{layout} dense 8 lanes"]["staged"] == 0,
                  "dense w512": by[f"{layout} dense w512"]["global"] == 0
                  and by[f"{layout} dense w512"]["staged"] > 0}
        for label, ok in checks.items():
            if not ok:
                raise AssertionError(f"{layout} {label}: the kernel took an "
                                     f"unexpected path: {by[f'{layout} {label}']}")
    return {"rows": rows}


def check_plane_window_shapes(shapes: dict, checked: set,
                              layout: str = "counter/derived") -> list[dict]:
    """Each window kernel against its plain version at every window shape
    a plane gave it in phase 4, 6, 12 or 13 (``shapes``: {kind: [[lanes, width,
    rows, launches], ...]}) that no earlier check held (``checked``, which
    gains each shape held here), on that plane's layout (the family,
    derived ordinal), timed."""
    _, spec, wire = next(c for c in kernel_cases() + [mixed_case()]
                         if c[0] == layout)
    rows = []
    for kind, seen in shapes.items():
        for lanes, width, nrows, _ in seen:
            if (layout, kind, lanes, width, nrows) in checked:
                continue
            checked.add((layout, kind, lanes, width, nrows))
            if kind == "ragged":  # events that pack into exactly nrows rows
                total = nrows * 3 // 4 if nrows > 8 else 6
                live = min(lanes, total)
                lengths = total // live + (np.arange(live) < total % live)
            else:
                live = max(1, lanes * 8000 // 32768)
                lengths = "round"
            c = window_case(kind, spec, wire, lanes, live, width, 0, True,
                            lengths, seed=lanes + width, capacity=PLANE_CAPACITY,
                            rows=nrows)
            rows.append(dict(check_window_case(
                f"{layout} plane {kind} {lanes}x{width}"
                + (f" rows {nrows}" if kind == "ragged" else ""), spec, wire, c,
                timed=True), layout=layout))
            del c
    return rows


#: the list fold's cut cases: (label, layout, corpus, config overrides,
#: whether the dense source's big and small lists take the staged (TMA) path).
#: The corpora are cut from the bench's shape. The edges: small tiles of 8
#: lanes (8 wire bytes a row: the kernel's plain-load path); a batch of 104
#: lanes (104 B rows: plain loads, tiles ending inside a lane block); a
#: batch of 256 (small tiles of 32 lanes, eight staged into each lane
#: block); a batch of 2,000 (big tiles starting and ending inside lane
#: blocks, staged; small tiles of 250 lanes, plain loads; on the "mid"
#: corpora since the engine's phase joined: on the cut ones their plain
#: versions took ~20 s); width 512
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
    ("counter/derived batch 2000", "counter/derived", "mid",
     {"surge.replay.batch-size": 2000}, (True, False)),
    ("bank_account batch 2000", "bank_account", "mid",
     {"surge.replay.batch-size": 2000}, (True, False)),
    ("counter/derived width 512", "counter/derived", "cut",
     {"surge.replay.time-chunk": 512}, (True, True)),
    ("shopping_cart/derived", "shopping_cart/derived", "cut", {}, (True, True)),
    ("saga/derived", "saga/derived", "cut", {}, (True, True)),
    ("shopping_cart/derived bs_small 8", "shopping_cart/derived", "tiny", {},
     (True, False)),
    ("saga/derived bs_small 8", "saga/derived", "tiny", {}, (True, False)),
    ("saga/derived batch 104", "saga/derived", "small",
     {"surge.replay.batch-size": 104}, (False, False)),
    ("saga/derived batch 2000", "saga/derived", "mid",
     {"surge.replay.batch-size": 2000}, (True, False)),
    # the cold replays of phase 5 (1M carts, 1M sagas): the kernels line's
    # time per cold replay of each family
    ("shopping_cart/derived 1M", "shopping_cart/derived", "full", {},
     (True, True)),
    ("saga/derived 1M", "saga/derived", "full", {}, (True, True)),
]
#: aggregates of the families' corpora, by LIST_CASES corpus name
FAMILY_SIZES = {"tiny": 64, "small": 3_000, "mid": 12_000, "cut": 100_000,
                "full": 1_000_000}


def list_corpus(layout: str, corpus: str):
    """A cut corpus of the layout: the counter corpus's shape (lognormal
    lengths, spread 0.6) at 100k aggregates / 5M events ("cut"), 12,000 /
    600k ("mid"), 3,000 / 150k ("small") or 64 / 1,600 ("tiny"), with the
    ordinal derived or shipped as a side column; bank_account logs for
    "bank" (500k accounts of 0-89 events, as phase 3, cut to 100k) and on
    the counter's lengths otherwise;
    the cart and saga walks of phase 5 at ``FAMILY_SIZES[corpus]``."""
    from surge_tpu_torch.codec.tensor import ColumnarEvents
    from surge_tpu_torch.models import bank_account as ba
    from surge_tpu_torch.replay.corpus import synth_counter_corpus

    if corpus == "bank":
        return bank_corpus(100_000, seed=6)
    family = layout.split("/")[0]
    if family in ("shopping_cart", "saga"):
        return family_corpus(family, FAMILY_SIZES[corpus], seed=7)[0]
    aggs, events = {"cut": (100_000, 5_000_000), "mid": (12_000, 600_000),
                    "small": (3_000, 150_000), "tiny": (64, 1_600)}[corpus]
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
    """(bytes, valid steps) one replay's list folds need: the bytes of each
    slot some lane folds (``t < lens - t_base``; ``fold_need``, each lane's
    events of the family of its first, as an aggregate's are) read once,
    each touched lane's length and ordinal (and start, flat) read once and
    its state (``fold_need``'s fields) read and written once, plus the work
    lists and their schedules."""
    from surge_tpu_torch.replay import fold_kernels

    wire = eng._wire(frozenset(resident.derived_key.items()))
    n = len(resident.lengths)
    lens = np.zeros(resident.b_pad, dtype=np.int64)
    lens[:n] = resident.lengths
    touched = np.zeros(resident.b_pad, dtype=bool)
    lane_steps = np.zeros(resident.b_pad, dtype=np.int64)
    extra = 0
    for bs, i0s, t_bases in ((plan.bs_big, plan.big_i0, plan.big_tb),
                             (plan.bs_small, plan.small_i0, plan.small_tb)):
        for i0, tb in zip(i0s.tolist(), t_bases.tolist()):
            lane_steps[i0:i0 + bs] += np.clip(lens[i0:i0 + bs] - tb, 0, plan.width)
            touched[i0:i0 + bs] = True
        ids, off, tiles = fold_kernels.list_schedule(i0s, bs, resident.b_pad)
        extra += 8 * len(i0s) + 4 * (len(ids) + len(off) + len(tiles))
    first = np.full(resident.b_pad, -1, dtype=np.int64)
    has = np.flatnonzero(resident.lengths > 0)
    rows = resident.flat_wire[resident.starts[has].astype(np.int64)]
    first[has] = wire_type_ids(wire, rows.cpu().numpy())
    ev_bytes, state = fold_need(eng.spec, wire, first, np.arange(resident.b_pad),
                                resident.b_pad, weights=lane_steps)
    per_lane = 8 + 2 * state + (4 if source == "flat" else 0)
    return ev_bytes + int(per_lane[touched].sum()) + extra, int(lane_steps.sum())


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
    # the plain version repeats the kernel's arithmetic in eager torch, tile
    # by tile: a correctness yardstick, not a speed one, timed once here
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for args, kw, _ in calls:
        fold_kernels.tile_fold_list_reference(want, *args, **kw)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
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
    from surge_tpu_torch.models import bank_account, counter, shopping_cart
    from surge_tpu_torch.replay.engine import ReplayEngine
    from surge_tpu_torch.saga import model as saga

    specs = {"counter/derived": counter, "counter/side": counter,
             "bank_account": bank_account,
             "shopping_cart/derived": shopping_cart, "saga/derived": saga}
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
        # the 1M corpora's flat source is phase 5's `flat` arm, held there
        # against the plain scan
        for source in ("dense",) if corpus == "full" else ("dense", "flat"):
            rows.append(check_list_case(
                label, eng, resident, source, seed=i + 1, bulk=bulk,
                timed=corpus in ("cut", "bank") or (corpus == "full"
                                                    and source == "dense")))
        del eng, resident
    torch.cuda.empty_cache()
    return {"rows": rows}


#: K1's non-resident windows (phase 1): the default engine's ladder
#: (min-time-window 8, time-chunk 512: widths 8 to 256 and the 512 chunk) at
#: B-chunks of 8, 24 and 8,192 lanes (bs = min(batch-size, round_up(b, 8)))
#: for the counter with its ordinal derived; the other layouts at three
#: widths and two chunks
NONRES_WIDTHS = (8, 16, 32, 64, 128, 256, 512)
NONRES_LANES = (8, 24, 8192)
NONRES_OTHER = ((8, 64, 512), (24, 8192))
#: the window the kernels line times for every family
NONRES_HEAD = (512, 8192)


def nonres_window(spec, wire, width: int, bs: int, rng):
    """One window as ``ReplayEngine._fold_window`` packs it: ``bs - 3`` real
    lanes (the rest pad), lengths in [0, width] (the first lane full), type
    ids in range, every third lane with an out-of-range id mid-log, packed
    fields inside their widths, random side values. Returns ``(type_ids [b,
    width], packed, sides)``."""
    b = bs - 3
    tids = rng.integers(0, wire.num_types, size=(b, width)).astype(np.int32)
    lens = rng.integers(0, width + 1, size=b)
    lens[0] = width
    tids[np.arange(width)[None, :] >= lens[:, None]] = -1
    tids[::3, width // 2] = wire.num_types + 3
    masks = {pf.name: pf.mask for pf in wire.packed_fields}
    cols = {}
    for f in spec.registry.union_columns():
        if f.name in wire.derived:
            continue
        dt = np.dtype(f.dtype)
        if f.name in masks:
            cols[f.name] = rng.integers(0, masks[f.name] + 1, size=(b, width)).astype(dt)
        elif dt == np.float32:
            cols[f.name] = rng.standard_normal((b, width)).astype(dt)
        else:
            cols[f.name] = rng.integers(-(1 << 31), 1 << 31, size=(b, width),
                                        dtype=np.int64).astype(dt)
    packed, sides = wire.pack_window(tids, cols, 0, width, width, bs)
    return tids, packed, sides


def random_slab(spec, n: int, rng) -> dict:
    """Random state columns ``{field: [n]}`` on the card (every bit pattern
    of an int, bools, normal floats)."""
    import torch

    slab = {}
    for f in spec.registry.state.fields:
        dt = np.dtype(f.dtype)
        if dt == np.bool_:
            col = rng.integers(0, 2, size=n).astype(bool)
        elif dt == np.float32:
            col = rng.standard_normal(n).astype(np.float32)
        else:
            col = rng.integers(-(1 << 31), 1 << 31, size=n, dtype=np.int64).astype(np.int32)
        slab[f.name] = torch.from_numpy(col).cuda()
    return slab


def check_nonres_case(label: str, spec, wire, width: int, bs: int, seed: int,
                      timed: bool) -> dict:
    """K1 on one non-resident window, the call ``ReplayEngine._fold_packed``
    makes (a one-tile dense work list, lanes of ``window_lens``, the ordinal
    base past 2^20), against its plain version on the same inputs, byte for
    byte over every lane of the B-chunk. The carry lies in a longer buffer:
    the rows past the chunk must keep their values."""
    import torch

    from surge_tpu_torch.replay import fold_kernels
    from surge_tpu_torch.replay.engine import ReplayEngine, window_lens

    rng = np.random.default_rng(seed)
    eng = ReplayEngine(spec)
    tids, packed, sides = nonres_window(spec, wire, width, bs, rng)
    words = torch.from_numpy(packed).cuda()
    side_d = {k: torch.from_numpy(v).cuda() for k, v in sides.items()}
    ord_base = rng.integers(1 << 20, (1 << 20) + (1 << 24), size=bs).astype(np.int32)
    guard = 64
    full = random_slab(spec, bs + guard, rng)
    start = {k: v.clone() for k, v in full.items()}
    got = {k: v[:bs] for k, v in full.items()}
    want = {k: v[:bs].clone() for k, v in full.items()}
    eng._fold_packed(got, wire, words, side_d, ord_base, tids)
    lens = window_lens(tids, wire.num_types, bs)
    lens_d = torch.from_numpy(lens).cuda()
    ord_d = torch.from_numpy(ord_base).cuda()
    i0s, t_bases, schedule = eng._window_list(bs)
    kw = dict(width=width, bs=bs, spec=spec, wire=wire)
    t0 = time.perf_counter()
    fold_kernels.tile_fold_list_reference(
        want, words[None], {k: v[None] for k, v in side_d.items()}, lens_d, ord_d,
        i0s, t_bases, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = 0.0
    for name in want:
        g, w = got[name].cpu().numpy(), want[name].cpu().numpy()
        if g.tobytes() != w.tobytes():
            raise AssertionError(
                f"window {label}: field {name!r} differs from the plain version "
                f"at lane {int(np.flatnonzero(g != w)[0])}")
        if full[name][bs:].cpu().numpy().tobytes() != start[name][bs:].cpu().numpy().tobytes():
            raise AssertionError(f"window {label}: K1 wrote past the B-chunk's "
                                 f"{bs} lanes in {name!r}")
        err = max(err, float(np.abs(g.astype(np.float64) - w.astype(np.float64)).max()))
    steps = int(lens.sum())
    # the slots each lane folds, each touched lane's length, ordinal and
    # state in and out (fold_need), the one-tile list and its schedule
    lane = np.repeat(np.arange(bs), lens)
    at = np.arange(steps) - np.repeat(np.cumsum(lens) - lens, lens)
    real = np.full((bs, width), -1, np.int64)
    real[:len(tids)] = tids
    ev_bytes, state = fold_need(spec, wire, np.where(real[lane, at] < wire.num_types,
                                                     real[lane, at], -1), lane, bs)
    nbytes = ev_bytes + int((8 + 2 * state).sum()) + 8 + 12
    row = {"case": label, "width": width, "bs": bs, "valid_steps": steps,
           "bytes": nbytes, "max_abs_err": err}
    if timed:
        tiles = (words[None], {k: v[None] for k, v in side_d.items()}, lens_d, ord_d,
                 i0s, t_bases)
        run = lambda: fold_kernels.tile_fold_list(got, *tiles, schedule=schedule, **kw)  # noqa: E731
        bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = steps * 12 / INT32_OPS_PER_S * 1e3
        row.update({"ms": device_ms(run, 7, 10), "ms_source": "events",
                    "plain_ms": plain_ms,
                    "bound_ms": max(bound_bytes_ms, bound_ops_ms),
                    "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms
                    else "operations"})
    log("phase1-nonres " + json.dumps(row))
    return row


def phase_nonres_windows() -> dict:
    """K1 at every non-resident window shape the default engine gives, each
    layout, against its plain version."""
    rows = []
    for i, (layout, spec, wire) in enumerate(kernel_cases()):
        widths, lanes = ((NONRES_WIDTHS, NONRES_LANES) if layout == "counter/derived"
                         else NONRES_OTHER)
        for width in widths:
            for bs in lanes:
                rows.append(check_nonres_case(
                    f"{layout} w{width} bs{bs}", spec, wire, width, bs,
                    seed=1000 + i * 100 + width + bs, timed=bs == NONRES_HEAD[1]))
    return {"rows": rows}


# -- phase 2: the main path -----------------------------------------------------------


def profile_replay(eng, resident, fold_device_ms: float, wall_ms: float,
                   n_lists: int) -> dict:
    """One more replay under the profiler (its launches are not counted as the
    main path's), with the port's ``ReplayProfiler`` on the engine: the
    device time by kernel, and the device's idle share of an unprofiled
    replay's wall time ``wall_ms``. The CUPTI trace holds fewer list-fold
    launches than were made (1 of 2 in earlier runs; cause not found), so the
    list fold's share of the busy time is its time from CUDA events,
    ``fold_device_ms``, and the trace gives the rest. The replay profiler's
    stage counts must be one fold dispatch (``compile`` the first time a
    shape is seen) and one fetch, and its ``record_function`` ranges must be
    in the trace, the dispatch range around the list fold's launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from surge_tpu_torch.replay import fold_kernels
    from surge_tpu_torch.replay.profiler import ReplayProfiler

    torch.cuda.synchronize()
    rprof = eng.profiler = ReplayProfiler.counters()
    launch = fold_kernels.tile_fold_list

    def watched(*a, **k):
        # each list-fold wrapper call as a range of its own, so the trace
        # shows it inside the replay profiler's dispatch range
        with record_function("chip_smoke.list_fold_call"):
            return launch(*a, **k)

    fold_kernels.tile_fold_list = watched
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.replay_resident(resident)
            profiled_wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        fold_kernels.tile_fold_list = launch
        eng.profiler = None
    n = rprof.stage_n
    if (n["compile"] + n["dispatch"], n["fetch"], n["refresh"]) != (1, 1, 0) \
            or rprof.windows <= 0:
        raise AssertionError(f"replay profiler: stage_n {n}, windows "
                             f"{rprof.windows}")
    ranges = {}
    for evt in prof.events():
        # the CPU ranges (each has a GPU-side annotation twin in the trace)
        if (evt.device_type == DeviceType.CPU
                and evt.name.startswith(("surge.replay.", "chip_smoke."))):
            r = ranges.setdefault(evt.name, [])
            r.append((evt.time_range.start, evt.time_range.end))
    fold_range = "surge.replay." + ("compile" if n["compile"] else "dispatch")
    calls = ranges.get("chip_smoke.list_fold_call", [])
    if len(ranges.get(fold_range, ())) != 1 or \
            len(ranges.get("surge.replay.fetch", ())) != 1 or \
            len(calls) != n_lists:
        raise AssertionError(f"record_function ranges in the trace: {ranges}")
    (r0, r1), = ranges[fold_range]
    if not all(r0 <= c0 and c1 <= r1 for c0, c1 in calls):
        raise AssertionError(f"list-fold calls {calls} outside the "
                             f"{fold_range} range {(r0, r1)}")
    # the device side: kernels and copies by name; the ranges' GPU-side
    # twins (user annotations on the stream) are no device work
    by_name: dict[str, list] = {}
    for evt in prof.events():
        if (evt.device_type != DeviceType.CUDA
                or evt.name.startswith(("surge.replay.", "chip_smoke."))):
            continue
        acc = by_name.setdefault(evt.name, [0.0, 0])
        acc[0] += evt.time_range.elapsed_us()
        acc[1] += 1
    other_ms = sum(v[0] for n, v in by_name.items() if "list_fold" not in n) / 1e3
    busy_ms = other_ms + fold_device_ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms": wall_ms, "profiled_wall_ms": profiled_wall_us / 1e3,
            "replay_profiler": {"stage_n": n, "windows": rprof.windows,
                                "ranges": {k: len(v) for k, v in ranges.items()}},
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
    reset_launches()
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
    if launches["dense_window"] or launches["ragged_window"]:
        raise AssertionError(f"the cold replay launched a window kernel: "
                             f"{launches}")
    # the fold's device time per replay from CUDA events around the work
    # lists' launches alone; launches made here are not the main path's
    slab, ord_d = eng._fresh_slab(resident.b_pad)
    fold_device_ms = device_ms(lambda: eng._run_tiles(resident, plan, slab, ord_d),
                               7, 5)
    log("phase2-profile " + json.dumps(dict(
        profile_replay(eng, resident, fold_device_ms,
                       statistics.median(folds) * 1e3, n_lists),
        list_fold_launched=n_lists, card=card, layout=layout)))
    row = {
        "card": card, "layout": layout,
        "dense": eng._use_dense(resident, plan),
        "aggregates": corpus.num_aggregates, "events": corpus.num_events,
        # bench.py's two clocks (bench.py:273-278,303): events_per_sec over
        # pack + upload + warm (the dense gather) + the first fold;
        # steady_events_per_sec over the best of three replays of the
        # resident corpus (fold and pull)
        "events_per_sec": corpus.num_events / ((t3 - t0) + folds[0]),
        "steady_events_per_sec": corpus.num_events / min(folds[:3]),
        "steady_events_per_sec_median": corpus.num_events / statistics.median(folds),
        "pack_s": t1 - t0, "upload_s": t2 - t1, "warm_s": t3 - t2,
        "fold_s": folds, "pad_ratio": res.padded_events / corpus.num_events,
        "tiles_per_replay": tiles, "lists_per_replay": n_lists,
        "fold_device_ms": fold_device_ms,
        "list_launches": launches["tile_fold_list"], "launches": launches,
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


@functools.cache
def bank_corpus(num_accounts: int, seed: int):
    """A bank_account columnar corpus: ragged logs of creates (some repeated,
    some missing so updates land on absent accounts) and balance updates.
    Made once per argument set: phases 3, 5, 11 and 13 share the 500k
    accounts (callers never write to a corpus)."""
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


def _columnar(n: int, ev_type: np.ndarray, ev_cols: dict):
    """The columnar corpus of per-step event arrays ``[T, n]`` (type -1: no
    event at that step), aggregate-major, with the sequence number derived."""
    from surge_tpu_torch.codec.tensor import ColumnarEvents

    mask = ev_type.T >= 0
    agg = np.repeat(np.arange(n, dtype=np.int32), mask.sum(axis=1))
    return ColumnarEvents(
        num_aggregates=n, agg_idx=agg, type_ids=ev_type.T[mask],
        cols={k: v.T[mask] for k, v in ev_cols.items()},
        derived_cols={"sequence_number": "ordinal"})


@functools.cache
def cart_walk(num_carts: int, seed: int):
    """``(corpus, expected)``: shopping-cart logs with the shape of the
    reference's ``random_cart_log`` (surge_tpu/testing/support.py), walked
    for every cart at once: 0-19 commands, add 60% (item 1-49, quantity 1-3,
    price 100-899), remove 30% (quantity 1-2, at most the items held; none
    held: no event), checkout 10%, which ends the cart. ``expected`` is each
    cart's state after its log. Made once per argument set (phases 5, 10
    and 13 share the 1M carts)."""
    from surge_tpu_torch.models import shopping_cart as sc

    rng = np.random.default_rng(seed)
    n = num_carts
    n_cmd = rng.integers(0, 20, size=n)
    have = np.zeros(n, np.int32)
    total = np.zeros(n, np.int32)
    checked = np.zeros(n, bool)
    ver = np.zeros(n, np.int32)
    ev_type = np.full((19, n), -1, np.int32)
    ev_cols = {k: np.zeros((19, n), np.int32)
               for k in ("item_code", "quantity", "unit_price_cents")}
    for t in range(19):
        active = (t < n_cmd) & ~checked
        r = rng.random(n)
        item = rng.integers(1, 50, size=n, dtype=np.int32)
        price = rng.integers(100, 900, size=n, dtype=np.int32)
        q_add = rng.integers(1, 4, size=n, dtype=np.int32)
        q_rem = np.minimum(rng.integers(1, 3, size=n, dtype=np.int32), have)
        add = active & (r < 0.6)
        rem = active & (r >= 0.6) & (r < 0.9) & (q_rem > 0)
        out = active & (r >= 0.9)
        emit = add | rem | out
        qty = np.where(add, q_add, np.where(rem, q_rem, 0))
        ev_type[t] = np.where(add, sc.ADDED, np.where(
            rem, sc.REMOVED, np.where(out, sc.CHECKED_OUT, -1)))
        ev_cols["item_code"][t] = np.where(add | rem, item, 0)
        ev_cols["quantity"][t] = qty
        ev_cols["unit_price_cents"][t] = np.where(add | rem, price, 0)
        sign = np.where(add, 1, np.where(rem, -1, 0)).astype(np.int32)
        have += sign * qty
        total += sign * qty * np.where(add | rem, price, 0)
        checked |= out
        ver += emit
    expected = {"item_count": have, "total_cents": total,
                "checked_out": checked, "version": ver}
    return _columnar(n, ev_type, ev_cols), expected


#: the saga's state fields, in the schema's order
SAGA_FIELDS = ("def_id", "num_steps", "status", "step", "committed",
               "compensated", "attempts", "c0", "c1", "c2", "c3", "version")
#: its float32 fields (the context slots); the rest are int32
SAGA_FLOATS = ("c0", "c1", "c2", "c3")


@functools.cache
def saga_walk(num_sagas: int, seed: int):
    """``(corpus, prefix)``: saga logs with the walk of the reference's
    ``random_saga_log`` (surge_tpu/testing/support.py), for every saga at
    once: 10% never start; a start has ``num_steps`` 1-6, ``def_id`` 1-3,
    ``c0`` 0-99, ``c1`` 0-1; each running step commits with p 0.75 (all
    committed: completed) and 15% of sagas stop after a commit, else one
    failure (attempts 1-4) flips the saga to compensation (nothing committed:
    compensated); each compensation step undoes the highest pending step,
    10% dead-letter instead, and 10% stop after one. ``prefix[f][k, i]`` is
    field ``f`` of saga ``i`` after its first ``k`` events (the last row
    holds every saga's final state). Made once per argument set (phases 5
    and 13 share the 1M sagas)."""
    from surge_tpu_torch.saga import model as sg

    rng = np.random.default_rng(seed)
    n, t_max = num_sagas, 14
    st = {f: np.zeros(n, np.float32 if f in SAGA_FLOATS else np.int32)
          for f in SAGA_FIELDS}
    prefix = {f: np.zeros((t_max + 1, n), v.dtype) for f, v in st.items()}
    ev_type = np.full((t_max, n), -1, np.int32)
    ev_cols = {k: np.zeros((t_max, n), np.float32 if k in SAGA_FLOATS else np.int32)
               for k in ("attempts", "c0", "c1", "c2", "c3", "def_id",
                         "num_steps", "step")}
    # 1 running, 2 compensating, 0 no further event
    phase = np.where(rng.random(n) < 0.9, 3, 0)  # 3: starts now
    for t in range(t_max):
        r, stop = rng.random(n), rng.random(n)
        start = phase == 3
        commit = (phase == 1) & (r < 0.75)
        fail = (phase == 1) & (r >= 0.75)
        pending = st["committed"] & ~st["compensated"]
        high = np.floor(np.log2(np.maximum(pending, 1))).astype(np.int32)
        dead = (phase == 2) & (r < 0.1)
        comp = (phase == 2) & (r >= 0.1)
        emit = start | commit | fail | dead | comp
        if not emit.any():
            break
        ev_type[t] = np.select([start, commit, fail, comp, dead],
                               [sg.STARTED, sg.STEP_COMMITTED, sg.STEP_FAILED,
                                sg.STEP_COMPENSATED, sg.DEAD_LETTERED], -1)
        num = rng.integers(1, 7, size=n, dtype=np.int32)
        c0 = rng.integers(0, 100, size=n).astype(np.float32)
        c1 = rng.integers(0, 2, size=n).astype(np.float32)
        attempts = rng.integers(1, 5, size=n, dtype=np.int32)
        step = np.where(commit | fail, st["step"], np.where(dead | comp, high, 0))
        ev_cols["step"][t] = step
        ev_cols["attempts"][t] = np.where(fail, attempts, 0)
        ev_cols["def_id"][t] = np.where(start, rng.integers(1, 4, size=n), 0)
        ev_cols["num_steps"][t] = np.where(start, num, 0)
        ev_cols["c0"][t] = np.where(start, c0, 0)
        ev_cols["c1"][t] = np.where(start, c1, 0)
        # the state after the event, as SagaModel.handle_event folds it
        for f in ("def_id", "num_steps", "c0", "c1"):
            st[f] = np.where(start, ev_cols[f][t], st[f])
        for f in ("c2", "c3", "step", "committed", "compensated"):
            st[f] = np.where(start, 0, st[f])
        bit = np.left_shift(1, step).astype(np.int32)
        st["committed"] = np.where(commit, st["committed"] | bit, st["committed"])
        st["compensated"] = np.where(comp, st["compensated"] | bit,
                                     st["compensated"])
        full = (np.left_shift(1, st["num_steps"]) - 1).astype(np.int32)
        done = commit & (st["committed"] == full)
        undone = comp & (st["compensated"] == st["committed"])
        nothing = fail & (st["committed"] == 0)
        st["status"] = np.select(
            [start, commit, fail, comp, dead],
            [sg.RUNNING, np.where(done, sg.COMPLETED, sg.RUNNING),
             np.where(nothing, sg.COMPENSATED, sg.COMPENSATING),
             np.where(undone, sg.COMPENSATED, sg.COMPENSATING),
             sg.DEAD_LETTER], st["status"]).astype(np.int32)
        st["step"] = np.where(commit, step + 1, st["step"])
        st["attempts"] = np.where(start | commit, 0,
                                  np.where(fail, attempts, st["attempts"]))
        st["version"] = st["version"] + emit
        phase = np.select(
            [start, commit & ~done & (stop >= 0.15), fail & ~nothing,
             comp & ~undone & (stop >= 0.1)], [1, 1, 2, 2], 0)
        for f, v in st.items():
            prefix[f][st["version"], np.arange(n)] = np.where(
                emit, v, prefix[f][st["version"], np.arange(n)])
    for f, v in st.items():  # the last row: every saga's final state
        prefix[f][t_max] = v
    return _columnar(n, ev_type, ev_cols), prefix


def family_corpus(model: str, n: int, seed: int):
    """The cold-replay corpus of a family: ``(corpus, expected final
    states)`` (counter and bank_account expect nothing here)."""
    if model == "shopping_cart":
        return cart_walk(n, seed=seed)
    corpus, prefix = saga_walk(n, seed=seed)
    return corpus, {f: v[-1] for f, v in prefix.items()}


@functools.cache
def counter_corpus(aggregates: int, events: int, seed: int):
    """``synth_counter_corpus``, made once per argument set (phases 3 and 13
    share the 1M / 20M corpus)."""
    from surge_tpu_torch.replay.corpus import synth_counter_corpus

    return synth_counter_corpus(aggregates, events, seed=seed)


def phase_resume_and_bank(card: str) -> dict:
    from surge_tpu_torch.config import Config
    from surge_tpu_torch.models import bank_account, counter
    from surge_tpu_torch.replay.engine import ReplayEngine

    cfg = Config(overrides=BENCH_CONFIG)
    corpus = counter_corpus(1_000_000, 20_000_000, seed=3)
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


# -- phase 5: the families' cold replay, and assoc against K1 -----------------------

#: phase 5's corpora: 1M carts and 1M sagas (the walks above), seeded
FAMILY_AGGREGATES = 1_000_000
#: phase 5's arms: K1's list fold on the dense tiles auto picks and on the
#: flat corpus, the plain scan (select dispatch: the same fold, fewer eager
#: ops a step than switch) and the assoc tree fold; phase 13 asks for the
#: dense tiles by name
ARMS = {"auto": {}, "flat": {"surge.replay.resident-layout": "flat"},
        "dense": {"surge.replay.resident-layout": "dense"},
        "xla": {"surge.replay.tile-backend": "xla",
                "surge.replay.dispatch": "select"},
        "assoc": {"surge.replay.tile-backend": "assoc"}}


def run_arm(spec, corpus, arm: str, replays: int, resident=None,
            init_carry=None, device_fold: bool = False) -> dict:
    """One arm of a family's cold replay: pack, upload and warm (unless a
    resident corpus is given) and, but on the plain scan, one untimed
    replay (its first pull pays for the host buffers and the inverse
    permutation: 12-17 ms where the next take 2-6; the plain scan takes
    seconds), then ``replays`` replays from ``init_carry``, timed on the
    host clock (each ends in the device→host pull); the launches made from
    the reset to the end of the last replay; the last replay's states. With
    ``device_fold``, the row adds the list folds' device time per replay,
    the tiles, pad ratio and bound (:func:`list_fold_ms`)."""
    import torch

    from surge_tpu_torch.config import Config
    from surge_tpu_torch.replay import fold_kernels
    from surge_tpu_torch.replay.engine import ReplayEngine

    reset_launches()
    eng = ReplayEngine(spec, config=Config(overrides=dict(BENCH_CONFIG, **ARMS[arm])))
    t0 = time.perf_counter()
    if resident is None:
        resident = eng.upload_resident(eng.pack_resident(corpus))
    eng.warm_resident(resident)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    plan = eng._plan_for(resident)
    n_lists = int(len(plan.big_i0) > 0) + int(len(plan.small_i0) > 0)
    folds, res = [], None
    warm = int(arm != "xla")
    for i in range(replays + warm):
        l0 = fold_kernels.LAUNCHES["tile_fold_list"]
        f0 = time.perf_counter()
        res = eng.replay_resident(resident, init_carry=init_carry)
        if i >= warm:
            folds.append(time.perf_counter() - f0)
        made = fold_kernels.LAUNCHES["tile_fold_list"] - l0
        want = n_lists if eng.tile_backend == "pallas" else 0
        if made != want:
            raise AssertionError(f"{arm}: a replay launched the list fold {made} "
                                 f"times, not {want}")
    launches = dict(fold_kernels.LAUNCHES)
    if launches["dense_window"] or launches["ragged_window"]:
        raise AssertionError(f"{arm}: a cold replay launched a window kernel")
    if eng.tile_backend == "pallas" and launches["tile_fold_list"] <= 0:
        raise AssertionError(f"{arm}: the kernel arm launched K1 no time")
    row = {"arm": arm, "backend": eng.tile_backend,
           "dense": eng._use_dense(resident, plan),
           "events_per_s_median": resident.num_events / statistics.median(folds),
           "events_per_s_best": resident.num_events / min(folds),
           "fold_s": folds, "setup_s": setup_s, "launches": launches}
    if device_fold:
        row["fold_device_ms"], work = list_fold_ms(eng, resident)
        row.update(work)
    return {"states": res.states, "resident": resident, "row": row}


def same_states(label: str, got: dict, want: dict) -> None:
    for name, col in want.items():
        g = np.asarray(got[name])
        if g.dtype != np.asarray(col).dtype or g.tobytes() != np.asarray(col).tobytes():
            bad = np.flatnonzero(g != col)[:5]
            raise AssertionError(f"{label}: field {name!r} differs at {bad}")


def phase_families(card: str, counter_corpus) -> dict:
    """1M carts and 1M sagas replayed on auto (K1, dense), flat (K1) and
    xla (the plain scan), and carts on assoc; the counter 1M/100M corpus
    and a bank_account corpus on K1 against assoc. Every arm's states must
    equal the others' byte for byte, and the families' their walks' closed
    forms. Events/s of every arm; launches of K1 by path."""
    from surge_tpu_torch.models import bank_account, counter, shopping_cart
    from surge_tpu_torch.saga import model as saga

    out: dict = {"card": card, "families": {}, "launches": {}}
    for model, mod, arms in (
            ("shopping_cart", shopping_cart, ("auto", "flat", "xla", "assoc")),
            ("saga", saga, ("auto", "flat", "xla"))):
        t0 = time.perf_counter()
        corpus, expected = family_corpus(model, FAMILY_AGGREGATES, seed=11)
        walk_s = time.perf_counter() - t0
        spec = mod.make_replay_spec()
        rows, states = [], {}
        for arm in arms:
            r = run_arm(spec, corpus, arm, replays=3 if arm in ("auto", "flat") else 1)
            rows.append(r["row"])
            states[arm] = r["states"]
            out["launches"][f"cold_replay_{model}_{arm}"] = r["row"]["launches"]
            del r
            same_states(f"{model} {arm} against the closed form", states[arm],
                        expected)
            same_states(f"{model} {arm} against auto", states[arm], states["auto"])
        out["families"][model] = {"aggregates": FAMILY_AGGREGATES,
                                  "events": corpus.num_events, "walk_s": walk_s,
                                  "arms": rows}
        log(f"phase5 {model} " + json.dumps(out["families"][model]))
    # the counter 1M/100M corpus on K1, then on assoc, on one uploaded
    # corpus; bank_account likewise (the turns K1, assoc, assoc, K1 were cut
    # to two for the time limit)
    for model, spec, corpus, expected in (
            ("counter", counter.make_replay_spec(), counter_corpus.events,
             {"count": counter_corpus.expected_count.astype(np.int32),
              "version": counter_corpus.expected_version.astype(np.int32)}),
            ("bank_account", bank_account.make_replay_spec(),
             bank_corpus(500_000, seed=5), None)):
        rows, resident, first = [], None, None
        for arm in ("auto", "assoc"):
            r = run_arm(spec, corpus, arm, replays=2, resident=resident)
            resident = r["resident"]
            rows.append(r["row"])
            if expected is not None:
                same_states(f"{model} {arm} against the closed form",
                            r["states"], expected)
            first = first or r["states"]
            same_states(f"{model} {arm} against K1", r["states"], first)
            del r
        out["families"][model] = {"events": resident.num_events, "arms": rows}
        del resident
        log(f"phase5 {model} " + json.dumps(out["families"][model]))
    return out


# -- phase 4: the resident state plane -----------------------------------------------

PLANE_TOPIC = "counter-events"
PLANE_PARTITIONS = 8
#: the main plane's deployment: 2^20 resident rows, 1.25x as many aggregates
#: (the seed spills the rest), PLANE_ROUNDS refresh rounds. A cut forced by
#: the time limit lowers the seed's events, then the rounds, never the
#: scale, and is recorded in PERF.md. With phase 12 (the engine over the
#: same deployment) added, the seed's events per aggregate went from 1 +
#: Binomial(7, 0.2) (~2.4) to 1 + Binomial(1, 0.2) (~1.2) and the rounds
#: from 16 to 4 (the heavy round, the mid-run view registration and
#: evictions stay)
PLANE_CAPACITY = 1 << 20
PLANE_AGGREGATES = 1_310_720
PLANE_ROUNDS = 4
PLANE_SEED_TRIALS = 1
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

    def append(self, aggs: np.ndarray, rng, verbatim: bool = False) -> int:
        """Append one event per entry of ``aggs`` (aggregate indices, repeats
        allowed), in a shuffled order that keeps each aggregate's own order,
        as one transaction; returns the event count. With ``verbatim`` (the
        seed), the records a transaction would leave are appended with their
        offsets, a partition at a time: the same log, built in two thirds of
        the time."""
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
        if verbatim:
            now = time.time()
            parts = [[] for _ in range(PLANE_PARTITIONS)]
            ends = [self.log.end_offset(PLANE_TOPIC, p) for p in range(PLANE_PARTITIONS)]
            for j, a in enumerate(aggs.tolist()):
                p = a % PLANE_PARTITIONS
                recs = parts[p]
                recs.append(LogRecord(PLANE_TOPIC, ids[a], buf[j * w:(j + 1) * w], p,
                                      {}, ends[p] + len(recs), now))
            for recs in parts:
                self.log.append_verbatim(recs)
            return len(aggs)
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


def make_plane(plog, overrides: dict, signals: list, ledger=None, **hooks):
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
        ledger=ledger, **hooks)


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


async def wait_lag_zero(plane, deadline_s: float, views=None,
                        rounds0: int = 0):
    """Until the plane's watermarks reach the log's end; with ``views``, also
    until the round that got there has closed (its views' leg folded, its
    ledger record written), which the views' leg delays past the watermark
    advance."""
    t0 = time.perf_counter()
    while plane.lag_records() > 0 or (
            views is not None and (plane.stats["rounds"] <= rounds0
                                   or views.inflight)):
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


def profile_round_stats(prof, wall_s: float, windows: int, window_ops: int
                        ) -> dict:
    """The profiled round's device busy time and idle share, its window
    kernels' launches and time, and its device operations by kind; with
    ``window_ops``, the calls that enqueue device work made inside the
    round's windows (uploads and kernel launches, counted on the host, not
    traced), per window. The trace's window kernels must number one a
    window: the device's own count of what the host count claims."""
    from torch.autograd import DeviceType

    busy_us, win_us, win_n = 0.0, 0.0, 0
    kinds: dict[str, list] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            us = evt.time_range.elapsed_us()
            busy_us += us
            if "window_kernel" in evt.name:
                win_us += us
                win_n += 1
                kind = "window kernels"
            elif "Memcpy HtoD" in evt.name:
                kind = "host to device copies"
            elif "Memcpy DtoH" in evt.name:
                kind = "device to host copies"
            else:
                kind = "other"
            acc = kinds.setdefault(kind, [0, 0.0])
            acc[0] += 1
            acc[1] += us / 1e3
    if win_n != windows:
        raise AssertionError(f"the profiled round traced {win_n} window "
                             f"kernels for {windows} windows")
    wall_us = wall_s * 1e6
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / wall_us if wall_us else None,
            "windows": windows,
            "ops_per_window": window_ops / windows if windows else None,
            "ops_per_window_source": "host count of the upload and launch "
                                     "calls inside each window, not traced",
            "device_ops": {k: {"count": v[0], "ms": v[1]} for k, v in kinds.items()},
            "window_kernels_traced": win_n,
            "window_kernel_ms_per_launch": win_us / win_n / 1e3 if win_n else None}


async def drive_plane(card: str, *, aggregates: int, capacity: int,
                      rounds: int, dispatch: str, seed: int, plog=None,
                      views=None) -> dict:
    """One plane through its seed, refresh rounds and read-back; fails on any
    signal, fallback, torn row or state off its closed form. ``plog`` reuses
    an earlier plane's log (its events are the new plane's seed); ``views``
    (a :class:`ViewArm`) rides the plane with materialized views and a
    recording tracer. The log comes back under ``"plog"``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from surge_tpu_torch.replay import fold_kernels

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    if plog is None:
        plog = PlaneLog(aggregates)
        lens = 1 + rng.binomial(PLANE_SEED_TRIALS, 0.2, size=aggregates)
        plog.append(np.repeat(np.arange(aggregates, dtype=np.int64), lens), rng,
                    verbatim=True)
    seed_events = int(plog.n_events.sum())
    log_s = time.perf_counter() - t0
    signals: list = []
    ledger = RoundLedger()
    plane = make_plane(plog, {
        "surge.replay.resident.capacity": capacity,
        "surge.replay.resident.refresh-dispatch": dispatch}, signals, ledger,
        **(views.hooks() if views is not None else {}))
    if views is not None:
        views.attach(plane)
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
    # the device operations each window enqueues: the uploads made inside
    # _run_window (its thread marks it) and the window kernels' launches
    in_window = threading.local()
    uploads = {"window": 0}
    upload = plane._upload

    def counted_upload(arr):
        if getattr(in_window, "on", False):
            uploads["window"] += 1
        return upload(arr)

    run_window = timed("window", plane._run_window)

    def marked_window(*a, **k):
        in_window.on = True
        try:
            return run_window(*a, **k)
        finally:
            in_window.on = False

    plane._upload = counted_upload
    plane._run_window = marked_window
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    await plane.start()
    start_s = time.perf_counter() - t0
    seed_launches = dict(fold_kernels.LAUNCHES)
    reset_launches()
    # the shape of every window the rounds give each window kernel, so each
    # is held against the plain version after the run
    window_shapes: dict = {"dense": [], "ragged": []}
    real = {kind: getattr(fold_kernels, f"{kind}_window")
            for kind in window_shapes}

    def seen(kind):
        def call(slab, ords, table, words, sides, **kw):
            rows = words.shape[0] if kind == "ragged" else 0
            width = kw["width"] if kind == "ragged" else words.shape[0]
            window_shapes[kind].append((table.shape[1], width, rows))
            return real[kind](slab, ords, table, words, sides, **kw)
        return call

    for kind in window_shapes:
        setattr(fold_kernels, f"{kind}_window", seen(kind))
    stop = asyncio.Event()
    seen_reads = {"reads": 0, "rows": 0}
    reader = asyncio.ensure_future(torn_row_reader(plane, aggregates, stop,
                                                   seen_reads))
    per_round = []
    profiled = None
    try:
        for r in range(rounds + 1):  # the last round runs under the profiler
            if views is not None:
                views.on_round(r, rounds, plane)
            aggs = round_aggregates(plog, plane, rng, heavy=r % 4 == 3)
            n0 = len(ledger.rounds)
            s0 = dict(stage_s)
            # the round's clock starts once the append returns: the append
            # is synchronous on the loop, so the plane cannot start its
            # round before that
            rounds0 = plane.stats["rounds"]
            if r == rounds:
                torch.cuda.synchronize()
                u0 = uploads["window"]
                l0 = sum(fold_kernels.LAUNCHES.values())
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    a0 = time.perf_counter()
                    plog.append(aggs, rng)
                    w0 = time.perf_counter()
                    await wait_lag_zero(plane, 300.0, views, rounds0)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - w0
                n_win = sum(kw["windows"] for kw in ledger.rounds[n0:])
                profiled = profile_round_stats(
                    prof, wall, n_win, uploads["window"] - u0
                    + sum(fold_kernels.LAUNCHES.values()) - l0)
            else:
                a0 = time.perf_counter()
                plog.append(aggs, rng)
                w0 = time.perf_counter()
                await wait_lag_zero(plane, 300.0, views, rounds0)
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
            if seen_reads["reads"] == 0:
                await asyncio.sleep(0.01)
    finally:
        for kind, fn in real.items():
            setattr(fold_kernels, f"{kind}_window", fn)
        stop.set()
        await reader
    refresh_launches = dict(fold_kernels.LAUNCHES)
    view_out = (await views.finish(plane, plog, per_round)
                if views is not None else None)
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
    if seed_launches["dense_window"] or seed_launches["ragged_window"]:
        raise AssertionError("the seed launched a window kernel")
    key = "ragged" if dispatch == "bucketed" else "dense"
    windows = sum(x["windows"] for x in per_round)
    if refresh_launches[f"{key}_window"] <= 0:
        raise AssertionError(f"the refresh rounds launched the {key} window "
                             f"kernel no time")
    # each refresh window is ONE window-kernel launch, and nothing else
    if (refresh_launches[f"{key}_window"] != windows
            or sum(refresh_launches.values()) != windows
            or len(window_shapes[key]) != windows):
        raise AssertionError(
            f"{windows} refresh windows made {refresh_launches} launches "
            f"({len(window_shapes[key])} window calls), not one "
            f"{key}-window launch each")
    if seen_reads["reads"] == 0:
        raise AssertionError("the torn-row reader never read")
    return {
        "card": card, "dispatch": dispatch, "aggregates": aggregates,
        "capacity": capacity, "seed_events": seed_events, "plog": plog,
        "views": view_out,
        "log_build_s": log_s, "start_s": start_s, "seed": plane.seed_timing,
        "seed_launches": seed_launches,
        "refresh_launches": refresh_launches, "refresh_windows": windows,
        "window_shapes": {k: [[*shape, v.count(shape)]
                              for shape in sorted(set(v))]
                          for k, v in window_shapes.items()},
        "rounds": per_round, "refresh_events_per_s": ev / (wall_ms / 1e3),
        "read_many_rows_per_s": rows_per_s,
        "torn_reader": seen_reads, "evictions": plane.stats["evictions"],
        "fallbacks": plane.stats["fallbacks"],
        "device_mem_peak_bytes": torch.cuda.max_memory_allocated(),
        "profiled_round": profiled}


def phase_plane(card: str) -> dict:
    main = asyncio.run(drive_plane(
        card, aggregates=PLANE_AGGREGATES, capacity=PLANE_CAPACITY,
        rounds=PLANE_ROUNDS, dispatch="bucketed", seed=4))
    plog = main.pop("plog")
    log("phase4 " + json.dumps(main))
    dense = asyncio.run(drive_plane(
        card, aggregates=65536, capacity=32768, rounds=4, dispatch="dense",
        seed=5))
    dense.pop("plog")
    log("phase4-dense " + json.dumps(dense))
    return {"main": main, "dense": dense, "plog": plog}


# -- phase 6: the saga family through the resident state plane ----------------------

SAGA_TOPIC = "saga-events"
#: the saga plane's deployment: 2^18 resident rows, 1.25x as many sagas (the
#: seed spills the rest), 4 refresh rounds of about 32k events
SAGA_PLANE_SAGAS = 327_680
SAGA_PLANE_CAPACITY = 1 << 18
SAGA_PLANE_ROUNDS = 4
#: events a round appends to each partition: under the poll's and the
#: staleness bound's 4,096, so a round folds in one poll and reads never
#: fall back for lag
SAGA_ROUND_BUDGET = 3_900
#: one saga event on the log, little-endian — decoded by saga_events
SAGA_RECORD = np.dtype([("type", "u1"), ("step", "u1"), ("attempts", "<i4"),
                        ("def_id", "<i4"), ("num_steps", "<i4"),
                        ("c", "<f4", (4,)), ("seq", "<u4")])


def saga_events(raws):
    """A batch of saga event records → the port's saga events."""
    from surge_tpu_torch.saga import model as sg

    recs = np.frombuffer(b"".join(raws), dtype=SAGA_RECORD)
    out = []
    for t, step, att, d, num, c, seq in zip(
            recs["type"].tolist(), recs["step"].tolist(),
            recs["attempts"].tolist(), recs["def_id"].tolist(),
            recs["num_steps"].tolist(), recs["c"].tolist(), recs["seq"].tolist()):
        if t == sg.STARTED:
            out.append(sg.SagaStarted("", d, num, *c, seq))
        elif t == sg.STEP_COMMITTED:
            out.append(sg.SagaStepCommitted("", step, seq))
        elif t == sg.STEP_FAILED:
            out.append(sg.SagaStepFailed("", step, att, seq))
        elif t == sg.STEP_COMPENSATED:
            out.append(sg.SagaStepCompensated("", step, seq))
        else:
            out.append(sg.SagaDeadLettered("", step, seq))
    return out


def saga_event(raw):
    return saga_events([raw])[0]


def saga_rounds(corpus, rng) -> tuple[np.ndarray, list]:
    """Split the sagas' logs into the seed's events and SAGA_PLANE_ROUNDS
    rounds: per round and partition, sagas whose whole rest of the log (from
    a random cut, 0 for a saga that starts in the round) fits
    SAGA_ROUND_BUDGET events. Returns each event's round (-1: the seed) and
    each round's events."""
    n = corpus.num_aggregates
    lengths = np.bincount(corpus.agg_idx, minlength=n)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=starts[1:])
    pos = np.arange(corpus.num_events) - starts[corpus.agg_idx]
    cut = np.full(n, np.iinfo(np.int64).max)
    rnd = np.full(n, -1)
    order = rng.permutation(np.flatnonzero(lengths > 0))
    for p in range(PLANE_PARTITIONS):
        mine = order[order % PLANE_PARTITIONS == p]
        c = rng.integers(0, lengths[mine])
        rest = lengths[mine] - c
        k = 0
        for r in range(SAGA_PLANE_ROUNDS):
            take = np.searchsorted(np.cumsum(rest[k:]), SAGA_ROUND_BUDGET,
                                   side="right")
            cut[mine[k:k + take]] = c[k:k + take]
            rnd[mine[k:k + take]] = r
            k += take
    ev_round = np.where(pos >= cut[corpus.agg_idx], rnd[corpus.agg_idx], -1)
    return ev_round, [np.flatnonzero(ev_round == r) for r in range(SAGA_PLANE_ROUNDS)]


class SagaLog:
    """The port's InMemoryLog of saga event records."""

    def __init__(self, corpus):
        from surge_tpu_torch.log import InMemoryLog, TopicSpec

        self.log = InMemoryLog()
        self.log.create_topic(TopicSpec(SAGA_TOPIC, PLANE_PARTITIONS))
        self.ids = [f"s{i}" for i in range(corpus.num_aggregates)]
        n = corpus.num_events
        lengths = np.bincount(corpus.agg_idx, minlength=corpus.num_aggregates)
        starts = np.zeros(corpus.num_aggregates + 1, dtype=np.int64)
        np.cumsum(lengths, out=starts[1:])
        recs = np.zeros(n, dtype=SAGA_RECORD)
        recs["type"] = corpus.type_ids
        for f in ("step", "attempts", "def_id", "num_steps"):
            recs[f] = corpus.cols[f]
        recs["c"] = np.stack([corpus.cols[f"c{i}"] for i in range(4)], axis=1)
        recs["seq"] = np.arange(n) - starts[corpus.agg_idx] + 1
        self.buf, self.agg = recs.tobytes(), corpus.agg_idx
        self._producer = self.log.transactional_producer("chip-smoke")

    def append(self, events: np.ndarray) -> int:
        """Append the corpus's events ``events`` (indices, each saga's in log
        order) as one transaction."""
        from surge_tpu_torch.log import LogRecord

        w = SAGA_RECORD.itemsize
        prod, buf, ids = self._producer, self.buf, self.ids
        prod.begin()
        for j, a in zip(events.tolist(), self.agg[events].tolist()):
            prod.send(LogRecord(topic=SAGA_TOPIC, key=ids[a],
                                value=buf[j * w:(j + 1) * w],
                                partition=a % PLANE_PARTITIONS))
        prod.commit()
        return len(events)


def saga_rows(states: dict, ids: list) -> dict:
    """The read states' fields as arrays of the schema's dtypes."""
    return {f: np.fromiter((getattr(states[a], f) for a in ids),
                           dtype=np.float32 if f in SAGA_FLOATS else np.int32,
                           count=len(ids)) for f in SAGA_FIELDS}


async def saga_torn_reader(plane, slog, readable: np.ndarray, prefix: dict,
                           stop, seen: dict):
    """Read random sagas while rounds run: every row must equal its saga's
    state after exactly ``version`` events (a torn row mixes two)."""
    rng = np.random.default_rng(12)
    while not stop.is_set():
        pick = rng.choice(readable, size=4096)
        ids = [slog.ids[i] for i in pick.tolist()]
        got = await plane.read_many(ids)
        if len(got) != len(set(ids)):
            raise AssertionError(f"read_many served {len(got)} of {len(set(ids))}")
        rows = saga_rows(got, ids)
        v = rows["version"]
        for f in SAGA_FIELDS:
            if rows[f].tobytes() != prefix[f][v, pick].tobytes():
                bad = int(np.flatnonzero(rows[f] != prefix[f][v, pick])[0])
                raise AssertionError(f"torn saga row {ids[bad]}: {f} "
                                     f"{rows[f][bad]} at version {v[bad]}")
        seen["reads"] += 1
        seen["rows"] += len(ids)
        await asyncio.sleep(0)


async def drive_saga_plane(card: str) -> dict:
    """The saga family through the plane: a seed of the logs' prefixes, then
    SAGA_PLANE_ROUNDS refresh rounds of their rests (spilled sagas re-admit,
    new sagas start) while a reader checks every row it reads; fails on any
    signal, fallback or torn row, unless each refresh window is one K2
    launch, and unless the final states equal, byte for byte, the walk's
    closed form and a plain cold replay (xla) of the whole log."""
    import torch

    from surge_tpu_torch.config import Config
    from surge_tpu_torch.replay import fold_kernels
    from surge_tpu_torch.replay.engine import ReplayEngine
    from surge_tpu_torch.replay.resident_state import ResidentStatePlane
    from surge_tpu_torch.saga import model as sg

    rng = np.random.default_rng(6)
    t0 = time.perf_counter()
    corpus, prefix = saga_walk(SAGA_PLANE_SAGAS, seed=13)
    ev_round, rounds = saga_rounds(corpus, rng)
    slog = SagaLog(corpus)
    slog.append(np.flatnonzero(ev_round == -1))
    log_s = time.perf_counter() - t0
    seeded = np.unique(corpus.agg_idx[ev_round == -1])
    signals: list = []
    ledger = RoundLedger()
    plane = ResidentStatePlane(
        slog.log, SAGA_TOPIC, sg.make_replay_spec(),
        config=Config(overrides={
            "surge.replay.resident.capacity": SAGA_PLANE_CAPACITY}),
        deserialize_event=saga_event, deserialize_events=saga_events,
        serialize_state=lambda agg, st: repr(st).encode(),
        derived_cols={"sequence_number": "ordinal"},
        on_signal=lambda name, level: signals.append((name, level)),
        ledger=ledger)
    if plane.engine.tile_backend != "pallas":
        raise AssertionError("the saga plane's backend did not resolve to the kernels")
    reset_launches()
    t0 = time.perf_counter()
    await plane.start()
    start_s = time.perf_counter() - t0
    seed_launches = dict(fold_kernels.LAUNCHES)
    reset_launches()
    shapes: list = []
    real = fold_kernels.ragged_window

    def seen_window(slab, ords, table, words, sides, **kw):
        shapes.append((table.shape[1], kw["width"], words.shape[0]))
        return real(slab, ords, table, words, sides, **kw)

    fold_kernels.ragged_window = seen_window
    stop = asyncio.Event()
    seen = {"reads": 0, "rows": 0}
    reader = asyncio.ensure_future(saga_torn_reader(plane, slog, seeded, prefix,
                                                    stop, seen))
    per_round = []
    walls = []
    try:
        for r, events in enumerate(rounds):
            n0 = len(ledger.rounds)
            slog.append(events)
            w0 = time.perf_counter()
            await wait_lag_zero(plane, 300.0)
            wall = time.perf_counter() - w0
            walls.append(wall)
            for kw in ledger.rounds[n0:]:
                per_round.append({"round": r, "events": kw["events"],
                                  "lanes": kw["lanes"],
                                  "windows": kw["windows"],
                                  "evictions": kw["evictions"],
                                  "buckets": [[b["lanes_b"], b["width"]]
                                              for b in kw["buckets"] or ()],
                                  "round_wall_ms": wall * 1e3})
            if seen["reads"] == 0:
                await asyncio.sleep(0.01)
    finally:
        fold_kernels.ragged_window = real
        stop.set()
        await reader
    refresh_launches = dict(fold_kernels.LAUNCHES)
    # every saga with events, read back against the walk's final states and
    # a plain cold replay of the whole log
    with_events = np.flatnonzero(np.bincount(corpus.agg_idx,
                                             minlength=SAGA_PLANE_SAGAS) > 0)
    ids = [slog.ids[i] for i in with_events.tolist()]
    t0 = time.perf_counter()
    got = {}
    for lo in range(0, len(ids), 65536):
        got.update(await plane.read_many(ids[lo:lo + 65536]))
    read_s = time.perf_counter() - t0
    await plane.stop()
    if len(got) != len(ids):
        raise AssertionError(f"read_many served {len(got)} of {len(ids)} sagas")
    rows = saga_rows(got, ids)
    same_states("the saga plane against the walk's final states", rows,
                {f: v[-1][with_events] for f, v in prefix.items()})
    xla = ReplayEngine(sg.make_replay_spec(), config=Config(overrides=dict(
        BENCH_CONFIG, **ARMS["xla"])))
    want = xla.replay_resident(xla.prepare_resident(corpus)).states
    same_states("the saga plane against a plain cold replay", rows,
                {f: v[with_events] for f, v in want.items()})
    windows = sum(r["windows"] for r in per_round)
    if signals:
        raise AssertionError(f"the saga plane signalled {signals}")
    if plane.stats["fallbacks"]:
        raise AssertionError(f"{plane.stats['fallbacks']} saga reads fell back: "
                             f"{plane.fallback_causes}")
    if plane.stats["evictions"] <= 0:
        raise AssertionError("no saga round evicted")
    if seed_launches["tile_fold_list"] <= 0 or (seed_launches["dense_window"]
                                                or seed_launches["ragged_window"]):
        raise AssertionError(f"the saga seed's launches: {seed_launches}")
    if (refresh_launches["ragged_window"] != windows or windows <= 0
            or sum(refresh_launches.values()) != windows
            or len(shapes) != windows):
        raise AssertionError(
            f"{windows} saga refresh windows made {refresh_launches} launches "
            f"({len(shapes)} window calls), not one ragged-window launch each")
    if seen["reads"] == 0:
        raise AssertionError("the saga reader never read")
    ev = sum(r["events"] for r in per_round)
    return {"card": card, "sagas": SAGA_PLANE_SAGAS,
            "capacity": SAGA_PLANE_CAPACITY, "log_build_s": log_s,
            "seed_events": int((ev_round == -1).sum()), "start_s": start_s,
            "seed": plane.seed_timing, "seed_launches": seed_launches,
            "refresh_launches": refresh_launches, "refresh_windows": windows,
            "rounds": per_round,
            "refresh_events_per_s": ev / sum(walls),
            "window_shapes": [[*shape, shapes.count(shape)]
                              for shape in sorted(set(shapes))],
            "read_back_sagas": len(ids),
            "read_back_rows_per_s": len(ids) / read_s, "torn_reader": seen,
            "evictions": plane.stats["evictions"],
            "fallbacks": plane.stats["fallbacks"],
            "device_mem_peak_bytes": torch.cuda.max_memory_allocated()}


def phase_saga_plane(card: str) -> dict:
    row = asyncio.run(drive_saga_plane(card))
    log("phase6 " + json.dumps(row))
    return row


# -- phase 7: cold start from a columnar segment ------------------------------------

#: the restore segment's chunking (the reference's default
#: surge.replay.restore-chunk-aggregates): the bench corpus in 16 chunks
RESTORE_CHUNK_AGGREGATES = 65_536


def state_json(agg_id, state) -> bytes:
    """The counter state as the reference's JSON state format writes it."""
    return json.dumps({"aggregate_id": state.aggregate_id, "count": state.count,
                       "version": state.version}).encode()


def check_store(label: str, store, ids, count, version) -> None:
    """Every stored state decoded and held to its closed form."""
    items = dict(store.all_items())
    if len(items) != len(ids):
        raise AssertionError(f"{label}: {len(items)} states stored, not {len(ids)}")
    got_c = np.empty(len(ids), dtype=np.int64)
    got_v = np.empty(len(ids), dtype=np.int64)
    for i, a in enumerate(ids):
        st = json.loads(items[a])
        if st["aggregate_id"] != a:
            raise AssertionError(f"{label}: {a} stored as {st['aggregate_id']}")
        got_c[i], got_v[i] = st["count"], st["version"]
    if not (np.array_equal(got_c, count) and np.array_equal(got_v, version)):
        bad = np.flatnonzero((got_c != count) | (got_v != version))[:5]
        raise AssertionError(f"{label}: states off their closed form at {bad}")


class RssSampler:
    """The process's resident set at the start of the block and its peak,
    sampled every 20 ms from ``/proc/self/statm`` while the block runs (None
    where the file cannot be read), and ``getrusage``'s peak of the whole
    process so far at its end (it cannot be reset)."""

    def __enter__(self):
        import os

        self.page = os.sysconf("SC_PAGE_SIZE")
        self.start = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _rss(self):
        try:
            with open("/proc/self/statm") as f:
                return int(f.read().split()[1]) * self.page
        except (OSError, ValueError, IndexError):
            return None

    def _run(self):
        while not self._stop.wait(0.02):
            now = self._rss()
            if now is not None and self.peak is not None:
                self.peak = max(self.peak, now)

    def __exit__(self, *exc):
        import resource

        self._stop.set()
        self._thread.join()
        self.process_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def write_bench_segment(corpus, path: str) -> None:
    """The bench corpus as a columnar segment of 16 chunks of 65,536
    aggregates (ids ``a<i>``), chunk ``k`` recorded for partition ``k % 8``."""
    from surge_tpu_torch.log.columnar import ColumnarSegmentWriter

    ev = corpus.events
    n = corpus.num_aggregates
    ids = [f"a{i}" for i in range(n)]
    with ColumnarSegmentWriter(path, extra_header={"topic": "counter-events"}) as w:
        for k, lo in enumerate(range(0, n, RESTORE_CHUNK_AGGREGATES)):
            hi = min(lo + RESTORE_CHUNK_AGGREGATES, n)
            chunk = ev.slice_aggregates(lo, hi)
            chunk.aggregate_ids = ids[lo:hi]
            w.append(chunk, partition=k % PLANE_PARTITIONS)


def phase_restore_segment(card: str, corpus, work: str) -> dict:
    """The bench corpus written once as a segment of 16 chunks (8
    partitions), restored with ``restore_from_segment`` into the in-memory
    store twice (wire cache cold, then warm); every stored state decoded and
    held to the closed form; each restore's stages, K1's launches, its
    device time on every chunk and the peak host memory."""
    import os

    import torch

    from surge_tpu_torch.config import Config
    from surge_tpu_torch.log.columnar import read_segment, segment_info
    from surge_tpu_torch.models import counter
    from surge_tpu_torch.replay import fold_kernels
    from surge_tpu_torch.replay.engine import ReplayEngine
    from surge_tpu_torch.store import InMemoryKeyValueStore, restore_from_segment
    from surge_tpu_torch.store.restore import _chunk_wire

    path = os.path.join(work, "bench.scol")
    n = corpus.num_aggregates
    ids = [f"a{i}" for i in range(n)]
    t0 = time.perf_counter()
    write_bench_segment(corpus, path)
    write_s = time.perf_counter() - t0
    spec = counter.make_replay_spec()
    cfg = Config()
    out = {"card": card, "aggregates": n, "events": corpus.num_events,
           "segment_path": path, "chunks": -(-n // RESTORE_CHUNK_AGGREGATES),
           "segment_bytes": os.path.getsize(path), "write_s": write_s,
           "source": "flat (oneshot chunks)", "restores": []}
    for cache in ("cold", "warm"):
        store = InMemoryKeyValueStore()
        reset_launches()
        with RssSampler() as rss:
            t0 = time.perf_counter()
            res = restore_from_segment(path, store, replay_spec=spec,
                                       serialize_state=state_json, config=cfg)
            wall = time.perf_counter() - t0
        launches = dict(fold_kernels.LAUNCHES)
        out[f"launches_{cache}"] = launches
        if launches["tile_fold_list"] <= 0 or launches["dense_window"] or \
                launches["ragged_window"]:
            raise AssertionError(f"segment restore ({cache}): launches {launches}")
        if (res.num_aggregates, res.num_events) != (n, corpus.num_events):
            raise AssertionError(f"segment restore ({cache}): {res}")
        t1 = time.perf_counter()
        check_store(f"segment restore ({cache})", store, ids,
                    corpus.expected_count, corpus.expected_version)
        row = {"cache": cache, "wall_s": wall, "stages_s": res.stages,
               "events_per_s": corpus.num_events / wall,
               "k1_launches": launches["tile_fold_list"],
               "rss_start_bytes": rss.start, "peak_rss_bytes": rss.peak,
               "process_peak_rss_bytes": rss.process_peak,
               "check_s": time.perf_counter() - t1}
        out["restores"].append(row)
        log("phase7 " + json.dumps(row))
        del store
    # K1's device time on every chunk as the restore folds it (flat,
    # oneshot), from the cached wires; these launches are not the path's
    eng = ReplayEngine(spec, config=cfg)
    build_id = segment_info(path)["schema"]["extra"]["build_id"]
    per_chunk = []
    for chunk in read_segment(path):
        resident = eng.upload_resident(_chunk_wire(eng, path, chunk,
                                                   build_id=build_id))
        resident.cache["oneshot"] = True
        plan = eng._plan_for(resident)
        slab, ord_d = eng._fresh_slab(resident.b_pad)
        per_chunk.append(device_ms(lambda: eng._run_tiles(resident, plan, slab, ord_d),
                                   5, 3))
        del resident, slab
    torch.cuda.empty_cache()
    out["k1_device_ms_per_chunk"] = per_chunk
    out["k1_device_ms"] = sum(per_chunk)
    log("phase7 " + json.dumps({k: v for k, v in out.items() if k != "restores"}))
    return out


# -- phase 8: restore_from_events, its three routes ---------------------------------

#: the in-memory route's log (~200k events) and the spilled route's (~1.05M,
#: over the default 1M spill threshold); events per aggregate 1-9
EVENTS_ROUTE_AGGREGATES = {"inmemory": 40_000, "spilled": 210_000}


class Checkpoint:
    """What restore_from_events reads of a checkpoint: per-partition
    watermarks, each aggregate's serialized state and its partition."""

    def __init__(self, watermarks: dict, states: dict, partitions: dict):
        self.watermarks = watermarks
        self.states = states
        self.partitions = partitions

    def partition_of(self, agg_id: str) -> int:
        return self.partitions.get(agg_id, 0)


def events_log(n: int, seed: int, split: bool = False):
    """The plane phase's counter records on the port's InMemoryLog (8
    partitions): aggregate i gets 1-9 increments of 1-3 in order. With
    ``split``, only the first half of each log is appended and the rest is
    returned to append later. Returns ``(log, ids, count, version, rest)``."""
    from surge_tpu_torch.log import InMemoryLog, LogRecord, TopicSpec

    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 10, size=n)
    agg = np.repeat(np.arange(n), lens)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    seq = np.arange(agg.size) - starts[agg] + 1
    inc = rng.integers(1, 4, size=agg.size)
    order = np.lexsort((agg, seq))  # aggregates interleaved, each in order
    recs = np.zeros(agg.size, dtype=EVENT_RECORD)
    recs["inc"], recs["seq"] = inc, seq
    raw = recs.tobytes()
    w = EVENT_RECORD.itemsize
    ids = [f"a{i}" for i in range(n)]
    log_ = InMemoryLog()
    log_.create_topic(TopicSpec(PLANE_TOPIC, PLANE_PARTITIONS))
    prod = log_.transactional_producer("chip-smoke-restore")
    first = seq <= (lens[agg] + 1) // 2 if split else np.ones(agg.size, dtype=bool)

    def append(mask):
        prod.begin()
        for j in order[mask[order]].tolist():
            a = int(agg[j])
            prod.send(LogRecord(topic=PLANE_TOPIC, key=ids[a],
                                value=raw[j * w:(j + 1) * w],
                                partition=a % PLANE_PARTITIONS))
        prod.commit()

    append(first)
    count = np.bincount(agg, weights=inc, minlength=n).astype(np.int64)
    return log_, ids, count, lens.astype(np.int64), (lambda: append(~first))


def events_restore(log_, backend: str, **kw):
    from surge_tpu_torch.config import Config
    from surge_tpu_torch.models import counter
    from surge_tpu_torch.store import InMemoryKeyValueStore, restore_from_events

    store = InMemoryKeyValueStore()
    t0 = time.perf_counter()
    res = restore_from_events(
        log_, PLANE_TOPIC, store, deserialize_event=deserialize_event,
        serialize_state=state_json, model=counter.CounterModel(),
        replay_spec=counter.make_replay_spec(),
        config=Config(overrides={"surge.replay.backend": backend}), **kw)
    return res, store, time.perf_counter() - t0


def phase_restore_events(card: str) -> dict:
    """restore_from_events over the port's InMemoryLog, each route's store
    held to its closed form: in memory (~200k events; the tpu backend's
    store byte-equal to the cpu backend's), checkpointed (a checkpoint at
    half of each log, then the tail) and spilled (~1.05M events, over the
    default threshold: through a throwaway segment)."""
    from surge_tpu_torch.config import Config
    from surge_tpu_torch.models import counter
    from surge_tpu_torch.replay import fold_kernels

    out = {"card": card, "routes": {}, "launches": {}}

    def run(route, log_, backend, **kw):
        reset_launches()
        res, store, wall = events_restore(log_, backend, **kw)
        launches = dict(fold_kernels.LAUNCHES)
        if backend == "tpu":
            out["launches"][route] = launches
            if launches["tile_fold_list"] <= 0:
                raise AssertionError(f"{route}: the tpu backend launched K1 no time")
        row = {"backend": backend, "wall_s": wall, "events": res.num_events,
               "aggregates": res.num_aggregates, "stages_s": res.stages,
               "k1_launches": launches["tile_fold_list"]}
        out["routes"].setdefault(route, []).append(row)
        log(f"phase8 {route} " + json.dumps(row))
        return res, store

    t0 = time.perf_counter()
    log_, ids, count, version, _ = events_log(EVENTS_ROUTE_AGGREGATES["inmemory"], 21)
    out["inmemory_log_s"] = time.perf_counter() - t0
    _, tpu_store = run("inmemory", log_, "tpu")
    check_store("in-memory route", tpu_store, ids, count, version)
    _, cpu_store = run("inmemory", log_, "cpu")
    if list(tpu_store.all_items()) != list(cpu_store.all_items()):
        raise AssertionError("in-memory route: the tpu store differs from the cpu store")

    log_, ids, count, version, append_rest = events_log(
        EVENTS_ROUTE_AGGREGATES["inmemory"], 22, split=True)
    _, half = run("checkpoint_write", log_, "cpu")
    ck = Checkpoint({p: log_.end_offset(PLANE_TOPIC, p) for p in range(PLANE_PARTITIONS)},
                    dict(half.all_items()),
                    {a: int(a[1:]) % PLANE_PARTITIONS for a in ids})
    append_rest()
    res, store = run("checkpointed", log_, "tpu", checkpoint=ck,
                     deserialize_state=lambda raw: counter.State(**json.loads(raw)))
    if res.num_events >= int(version.sum()) or res.num_events <= 0:
        raise AssertionError(f"checkpointed route folded {res.num_events} events")
    check_store("checkpointed route", store, ids, count, version)

    t0 = time.perf_counter()
    log_, ids, count, version, _ = events_log(EVENTS_ROUTE_AGGREGATES["spilled"], 23)
    out["spilled_log_s"] = time.perf_counter() - t0
    if int(version.sum()) <= Config().get_int("surge.replay.restore-spill-events"):
        raise AssertionError("the spilled route's log does not cross the spill "
                             "threshold")
    res, store = run("spilled", log_, "tpu")
    if "segment_build" not in res.stages:
        raise AssertionError("the spilled route did not restore through a segment")
    check_store("spilled route", store, ids, count, version)
    return out


# -- phase 9: replay_resident_streamed ----------------------------------------------

STREAM_SEGMENTS = (1, 8)


def phase_streamed(card: str, corpus) -> dict:
    """The 1M / 100M wire through ``replay_resident_streamed`` at
    ``STREAM_SEGMENTS`` segments and through ``upload_resident`` +
    ``replay_resident``, in turns (plain, 1, 8, 8, 1, plain); every arm's states byte-equal to
    the plain arm's and the closed form; each arm's wall beside its upload
    and fold seconds."""
    import torch

    from surge_tpu_torch.config import Config
    from surge_tpu_torch.models import counter
    from surge_tpu_torch.replay import fold_kernels
    from surge_tpu_torch.replay.engine import ReplayEngine

    eng = ReplayEngine(counter.make_replay_spec(), config=Config(overrides=BENCH_CONFIG))
    t0 = time.perf_counter()
    wire = eng.pack_resident(corpus.events)
    pack_s = time.perf_counter() - t0
    eng.warm_resident(eng.upload_resident(wire))  # builds and loads the kernel
    torch.cuda.empty_cache()
    order = ["plain", *STREAM_SEGMENTS, *reversed(STREAM_SEGMENTS), "plain"]
    rows, first, launches = [], None, {}
    for arm in order:
        torch.cuda.synchronize()
        s0 = dict(eng.stats)
        reset_launches()
        t0 = time.perf_counter()
        if arm == "plain":
            resident = eng.upload_resident(wire)
            t1 = time.perf_counter()
            res = eng.replay_resident(resident)
            del resident
        else:
            t1 = t0
            res = eng.replay_resident_streamed(wire, segments=arm)
        wall = time.perf_counter() - t0
        launches[f"streamed_{arm}"] = dict(fold_kernels.LAUNCHES)
        if fold_kernels.LAUNCHES["tile_fold_list"] <= 0:
            raise AssertionError(f"streamed {arm}: K1 was launched no time")
        same_states(f"streamed {arm} against the closed form", res.states,
                    {"count": corpus.expected_count.astype(np.int32),
                     "version": corpus.expected_version.astype(np.int32)})
        first = first or res.states
        same_states(f"streamed {arm} against the first arm", res.states, first)
        row = {"arm": arm, "wall_s": wall,
               "upload_s": (t1 - t0) if arm == "plain"
               else eng.stats["h2d_s"] - s0["h2d_s"],
               "fold_s": eng.stats["fold_s"] - s0["fold_s"],
               "pull_s": eng.stats["pull_s"] - s0["pull_s"],
               "k1_launches": fold_kernels.LAUNCHES["tile_fold_list"]}
        rows.append(row)
        log("phase9 " + json.dumps(row))
        torch.cuda.empty_cache()
    plain = [r for r in rows if r["arm"] == "plain"]
    plain_total = statistics.median(r["wall_s"] for r in plain)
    plain_upload = statistics.median(r["upload_s"] for r in plain)
    summary = {"card": card, "pack_s": pack_s, "events": corpus.num_events,
               "plain_wall_s": plain_total, "plain_upload_s": plain_upload,
               "streamed": {str(sg): {
                   "wall_s": [r["wall_s"] for r in rows if r["arm"] == sg],
                   # the upload hid if the streamed wall undercut the plain
                   # upload plus the plain replay
                   "upload_hidden": statistics.median(
                       r["wall_s"] for r in rows if r["arm"] == sg) < plain_total}
                   for sg in STREAM_SEGMENTS},
               "launches": launches}
    log("phase9 " + json.dumps(summary))
    return summary


# -- phase 10: the non-resident paths -------------------------------------------------

#: phase 10's counter corpus: the bench corpus's shape (lognormal lengths, ~100
#: events an aggregate) cut to 200k aggregates / 20M events
NONRES_COUNTER = (200_000, 20_000_000)
#: aggregates the plain eager scan folds as a check (its speed is ~0.2-1 M
#: events/s on the card)
NONRES_PLAIN_SUBSET = {"counter": 8_192, "shopping_cart": 65_536}


def phase_nonresident(card: str) -> dict:
    """``replay_columnar`` on 1M carts and on the counter corpus cut to
    200k aggregates / 20M events: states equal to the walk's or the closed
    form, a subset also equal to the plain eager scan's (``xla``); events/s,
    windows and K1 launches (one a window)."""
    from surge_tpu_torch.config import Config
    from surge_tpu_torch.models import counter, shopping_cart
    from surge_tpu_torch.replay import fold_kernels
    from surge_tpu_torch.replay.corpus import synth_counter_corpus
    from surge_tpu_torch.replay.engine import ReplayEngine

    out = {"card": card, "models": {}, "launches": {}}
    c = synth_counter_corpus(*NONRES_COUNTER, seed=0)
    carts, cart_expected = cart_walk(FAMILY_AGGREGATES, seed=11)
    for model, mod, events, expected in (
            ("counter", counter, c.events,
             {"count": c.expected_count.astype(np.int32),
              "version": c.expected_version.astype(np.int32)}),
            ("shopping_cart", shopping_cart, carts, cart_expected)):
        spec = mod.make_replay_spec()
        eng = ReplayEngine(spec)
        reset_launches()
        t0 = time.perf_counter()
        res = eng.replay_columnar(events)
        wall = time.perf_counter() - t0
        launches = dict(fold_kernels.LAUNCHES)
        stats = dict(eng.stats)
        out["launches"][f"nonresident_{model}"] = launches
        if launches["tile_fold_list"] != stats["windows"] or not stats["windows"] or \
                launches["dense_window"] or launches["ragged_window"]:
            raise AssertionError(f"{model}: {launches} for {stats['windows']} windows")
        same_states(f"non-resident {model} against the closed form", res.states,
                    expected)
        sub_n = NONRES_PLAIN_SUBSET[model]
        sub = events.sorted_by_aggregate().slice_aggregates(0, sub_n)
        plain = ReplayEngine(spec, config=Config(overrides={
            "surge.replay.tile-backend": "xla", "surge.replay.dispatch": "select"}))
        t1 = time.perf_counter()
        want = plain.replay_columnar(sub).states
        plain_s = time.perf_counter() - t1
        got = eng.replay_columnar(sub).states
        same_states(f"non-resident {model} against the plain scan", got, want)
        row = {"events": res.num_events, "aggregates": res.num_aggregates,
               "wall_s": wall, "events_per_s": res.num_events / wall,
               "windows": stats["windows"], "k1_launches": launches["tile_fold_list"],
               "pack_s": stats["pack_s"], "h2d_s": stats["h2d_s"],
               "pad_ratio": res.padded_events / max(res.num_events, 1),
               "plain_subset": {"aggregates": sub_n, "events": sub.num_events,
                                "wall_s": plain_s,
                                "events_per_s": sub.num_events / plain_s}}
        out["models"][model] = row
        log(f"phase10 {model} " + json.dumps(row))
    return out


# -- phase 11: the analytics plane: the scan engine, views, profiler, tracer, faults --

#: scans of phase 11's kernel check on the first chunk of phase 7's segment:
#: tests/test_query_engine.py's QUERIES (all four ops; typed; conjunctive
#: with type_id; zero-match), a group_by type_id and an OR group
def query_cases() -> dict:
    from surge_tpu_torch.replay.query import Aggregate as A
    from surge_tpu_torch.replay.query import Predicate as P
    from surge_tpu_torch.replay.query import ScanQuery as Q

    return {
        "all_ops": Q(aggregates=(A("count"), A("sum", "increment_by"),
                                 A("min", "increment_by"),
                                 A("max", "sequence_number"))),
        "typed": Q(aggregates=(A("count"), A("sum", "increment_by")),
                   event_types=("CountIncremented",)),
        "conjunctive": Q(aggregates=(A("count"), A("max", "sequence_number")),
                         predicates=(P("sequence_number", ">", 3),
                                     P("type_id", "!=", 2))),
        "zero_match": Q(aggregates=(A("count"), A("min", "sequence_number"),
                                    A("max", "increment_by")),
                        predicates=(P("sequence_number", ">=", 10_000),)),
        "group_by_type_id": Q(aggregates=(A("count"), A("sum", "increment_by"),
                                          A("min", "sequence_number"),
                                          A("max", "sequence_number")),
                              group_by="type_id"),
        "or_group": Q(aggregates=(A("count"), A("sum", "increment_by")),
                      predicates=(P("sequence_number", ">", 1),),
                      or_groups=((P("type_id", "==", 0), P("type_id", "==", 1)),
                                 (P("increment_by", "<=", 1),
                                  P("sequence_number", ">=", 50)))),
    }


def bank_query(predicate: bool, group_by: str | None = None):
    from surge_tpu_torch.replay.query import Aggregate as A
    from surge_tpu_torch.replay.query import Predicate as P
    from surge_tpu_torch.replay.query import ScanQuery as Q

    return Q(aggregates=(A("count"), A("sum", "new_balance"),
                         A("min", "new_balance"), A("max", "new_balance")),
             predicates=(P("new_balance", ">", 1000.5),) if predicate else (),
             group_by=group_by)


def capture_scan(eng, colev, query) -> tuple[dict, dict]:
    """``eng._raw_scan(colev, query)`` with the scan-reduce call's inputs
    kept: the exact tensors the scan gives the kernel."""
    import surge_tpu_torch.replay.query as qmod

    got: dict = {}
    real = qmod.scan_reduce

    def keep(mask, cols, ops, offsets, order=None):
        got.update(mask=mask, cols=list(cols), ops=list(ops), offsets=offsets,
                   order=order)
        return real(mask, cols, ops, offsets, order)

    qmod.scan_reduce = keep
    try:
        _, out = eng._raw_scan(colev, query)
    finally:
        qmod.scan_reduce = real
    return got, out


def scan_library(inp: dict, n: int):
    """The same counts, sums, mins and maxes as one PyTorch call each
    (``index_add_``, ``scatter_reduce_``): the yardstick. Float sums add in
    atomic order there, so its bytes may differ run to run."""
    import torch

    from surge_tpu_torch.replay.scan_reduce import sentinel

    mask, offsets, order = inp["mask"][:n], inp["offsets"], inp["order"]
    g_n = offsets.shape[0] - 1
    lens = (offsets[1:] - offsets[:-1]).to(torch.int64)
    grp = torch.repeat_interleave(torch.arange(g_n, device=mask.device), lens)
    if order is not None:
        by_event = torch.empty_like(grp)
        by_event[order.to(torch.int64)] = grp
        grp = by_event

    def run():
        out = [torch.zeros(g_n, dtype=torch.int32, device=mask.device)
               .index_add_(0, grp, mask.to(torch.int32))]
        for col, op in zip(inp["cols"], inp["ops"]):
            c = col[:n]
            if op == "sum":
                out.append(torch.zeros(g_n, dtype=c.dtype, device=c.device)
                           .index_add_(0, grp, torch.where(mask, c, 0)))
            else:
                sent = sentinel(op, c.dtype)
                out.append(torch.full((g_n,), sent, dtype=c.dtype, device=c.device)
                           .scatter_reduce_(0, grp, torch.where(mask, c, sent),
                                            reduce="amin" if op == "min" else "amax"))
        return out
    return run


def scan_bound_ms(inp: dict, n: int) -> float:
    """Bytes the reduction must move at the card's memory rate: the mask
    byte and each distinct column's 4 bytes an event, the order (when the
    groups are not in event order), the offsets, and the outputs."""
    g_n = inp["offsets"].shape[0] - 1
    cols = len({c.data_ptr() for c in inp["cols"]})
    total = (n * (1 + 4 * cols + (4 if inp["order"] is not None else 0))
             + 4 * (g_n + 1) + 4 * g_n * (1 + len(inp["cols"])))
    return total / HBM_BYTES_PER_S * 1e3


def load_baseline(tree: str, work: str):
    """The scan-reduce wrapper of another tree (an earlier commit unpacked,
    ``--baseline``): its ``csrc/scan_reduce.cu`` built with this tree's
    flags into ``work`` and its ``replay/scan_reduce.py`` loaded as a module
    of its own, so the two kernels run on the same inputs in one call."""
    import importlib.util
    from unittest import mock

    from surge_tpu_torch import _build

    src = os.path.join(tree, "surge_tpu_torch", "csrc", "scan_reduce.cu")
    lib = os.path.join(work, "libbaseline_scan_reduce.so")
    out = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, src],
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"the baseline's scan_reduce.cu does not build:\n{out.stdout}")
    spec = importlib.util.spec_from_file_location(
        "baseline_scan_reduce",
        os.path.join(tree, "surge_tpu_torch", "replay", "scan_reduce.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with mock.patch.object(_build, "library", lambda name: lib):
        mod.load()
    log("phase11 baseline: " + json.dumps({"tree": tree, "ptxas": out.stdout.strip()}))
    return mod


def fadd_latency_ns() -> float:
    """One dependent ``add.rn.ftz.f32``'s latency on this card: a one-thread
    chain of 2^22 adds, timed (the unit of a float sum's serial floor)."""
    import torch

    from surge_tpu_torch.replay.scan_reduce import fadd_chain

    steps = 1 << 22
    dev = torch.device("cuda")
    if float(fadd_chain(steps, dev).item()) != float(steps):
        raise AssertionError("fadd_chain: the chain's sum is wrong")
    return device_ms(lambda: fadd_chain(steps, dev), 3, 1) * 1e6 / steps


def pass_device_ms(fn, calls: int = 5) -> dict:
    """Device milliseconds a call of ``fn`` spends in each scan-reduce pass,
    from a ``torch.profiler`` trace of ``calls`` calls, with the launches the
    trace holds (it may hold fewer than were made; the time is per traced
    launch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from surge_tpu_torch.replay.scan_reduce import PASSES

    kernels = {"scan_plan": PASSES[0], "scan_tiles": PASSES[1],
               "scan_spans": PASSES[2], "scan_long": PASSES[3]}
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for evt in prof.key_averages():
        name = next((p for k, p in kernels.items() if k in evt.key), None)
        if name is None:
            continue
        total = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
        out[name] = {"ms": total / max(evt.count, 1) / 1e3, "traced": evt.count}
    return out


def check_scan_case(label: str, eng, colev, query, fadd_ns: float,
                    baseline=None, oracle: bool = False) -> dict:
    """The scan's reduction inputs through the kernel and its plain twin:
    byte for byte, and their times beside the bound, the library call and,
    with ``baseline``, an earlier tree's kernel on the same inputs (in
    turns: baseline, kernel, kernel, baseline). ``oracle`` holds the
    engine's whole scan to the numpy ``scan_reference`` instead, and times
    no plain twin (a float sum's twin steps one position a call: minutes at
    millions of events a group). A case with a float sum also gives its
    serial floor: the longest float-summed span times one add's latency."""
    import torch

    from surge_tpu_torch.replay import scan_reduce as sr
    from surge_tpu_torch.replay.query import scan_reference

    reset_launches()
    inp, _ = capture_scan(eng, colev, query)
    launches = dict(sr.LAUNCHES)
    if any(launches[p] != 1 for p in sr.PASSES) or launches["fadd_chain"]:
        raise AssertionError(f"scan_reduce {label}: launches {launches}, not one a pass")
    n = colev.num_events
    args = (inp["mask"], inp["cols"], inp["ops"], inp["offsets"], inp["order"])
    count, outs = sr.scan_reduce(*args)
    torch.cuda.synchronize()
    err = 0.0
    if oracle:
        got = eng.scan_chunks([colev], query)
        want = scan_reference([colev], query, eng.registry)
        pairs = [(got.columns[k], want.columns[k]) for k in sorted(want.columns)]
        if got.aggregate_ids != want.aggregate_ids or set(got.columns) != set(want.columns):
            raise AssertionError(f"scan_reduce {label}: ids or columns differ "
                                 f"from scan_reference")
    else:
        t0 = time.perf_counter()
        pcount, pouts = sr.scan_reduce_reference(*args)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        pairs = [(a.cpu().numpy(), b.cpu().numpy())
                 for a, b in zip([count] + outs, [pcount] + pouts)]
    for k, (a, b) in enumerate(pairs):
        if a.tobytes() != b.tobytes():
            bad = np.flatnonzero(a.view(np.uint32) != b.view(np.uint32))[:5]
            raise AssertionError(f"scan_reduce {label}: output {k} differs from "
                                 f"the {'oracle' if oracle else 'plain version'} "
                                 f"at groups {bad}: {a[bad]} != {b[bad]}")
        both_nan = np.isnan(a) & np.isnan(b) if a.dtype.kind == "f" else False
        diff = np.where(both_nan, 0.0, np.abs(a.astype(np.float64) - b.astype(np.float64)))
        err = max(err, float(diff.max()) if diff.size else 0.0)
    lib = scan_library(inp, n)
    lib_out = lib()
    torch.cuda.synchronize()

    def reps(fn):
        # a slow call (the baseline's serial walks) is timed on fewer launches
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        return (5, 3) if took < 0.05 else (2, 1) if took < 2.0 else (1, 1)

    kernel = lambda: sr.scan_reduce(*args)  # noqa: E731
    row = {"case": label, "events": n, "groups": inp["offsets"].shape[0] - 1,
           "outputs": inp["ops"], "ordered": inp["order"] is None,
           "matched": int(count.sum()), "checked_against":
           "scan_reference" if oracle else "plain twin",
           "max_abs_err": err, "launches": launches}
    if baseline is None:
        row["ms"] = device_ms(kernel, *reps(kernel))
    else:
        old = lambda: baseline.scan_reduce(*args)  # noqa: E731
        old_reps = reps(old)
        b1 = device_ms(old, *old_reps)
        k1 = device_ms(kernel, *reps(kernel))
        k2 = device_ms(kernel, *reps(kernel))
        b2 = device_ms(old, *old_reps)
        row.update(ms=(k1 + k2) / 2, ms_turns=[k1, k2],
                   baseline_ms=(b1 + b2) / 2, baseline_ms_turns=[b1, b2])
        bcount, bouts = baseline.scan_reduce(*args)
        row["baseline_equal"] = all(
            x.cpu().numpy().tobytes() == y.cpu().numpy().tobytes()
            for x, y in zip([bcount] + bouts, [count] + outs))
    row["pass_ms"] = pass_device_ms(kernel)
    row.update(
        # a twin that steps a long float chain takes seconds: its check
        # call above, synchronised on the host clock, is its time
        plain_ms=None if oracle else (
            plain_s * 1e3 if plain_s >= 2.0 else
            cuda_ms(lambda: sr.scan_reduce_reference(*args), 3, 1)),
        library_ms=device_ms(lib, 5, 3),
        library_equal=all(a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()
                          for a, b in zip(lib_out, [count] + outs)),
        bound_ms=scan_bound_ms(inp, n), bound_by="bytes")
    fsum = any(c.dtype.is_floating_point and op == "sum"
               for c, op in zip(inp["cols"], inp["ops"]))
    if fsum:
        offs = inp["offsets"].cpu().numpy().astype(np.int64)
        longest = int((offs[1:] - offs[:-1]).max())
        row.update(longest_float_span=longest, fadd_ns=fadd_ns,
                   serial_floor_ms=longest * fadd_ns * 1e-6)
    log("phase11-kernel " + json.dumps(row))
    return row


def skewed_chunk(chunk0, huge: int, seed: int):
    """The first chunk with one aggregate of ``huge`` events put in the
    middle of its 65,536 (the counter's columns, its ordinal derived)."""
    from surge_tpu_torch.codec.tensor import ColumnarEvents

    rng = np.random.default_rng(seed)
    mid = chunk0.num_aggregates // 2
    cut = int(np.searchsorted(chunk0.agg_idx, mid))
    big = {"increment_by": rng.integers(0, 4, size=huge).astype(np.int32)}
    cols = {k: np.concatenate([v[:cut], big[k] if k in big else
                               np.zeros(huge, v.dtype), v[cut:]])
            for k, v in chunk0.cols.items()}
    agg_idx = np.concatenate([chunk0.agg_idx[:cut], np.full(huge, mid, np.int32),
                              chunk0.agg_idx[cut:] + 1]).astype(np.int32)
    type_ids = np.concatenate([chunk0.type_ids[:cut],
                               rng.integers(0, 2, size=huge).astype(np.int32),
                               chunk0.type_ids[cut:]])
    ids = (None if chunk0.aggregate_ids is None else list(chunk0.aggregate_ids[:mid])
           + ["skew-huge"] + list(chunk0.aggregate_ids[mid:]))
    return ColumnarEvents(num_aggregates=chunk0.num_aggregates + 1, agg_idx=agg_idx,
                          type_ids=type_ids, cols=cols,
                          derived_cols=dict(chunk0.derived_cols), aggregate_ids=ids)


#: phase 11's skewed case: one aggregate of this many events among the
#: first chunk's 65,536
SKEW_EVENTS = 4_000_000


def phase_query(card: str, corpus, seg_path: str, baseline=None) -> dict:
    """The scan-reduce kernel against its plain twin on the scans of the
    segment's first chunk (65,536 aggregates), phase 3's 500k bank accounts
    (float sums, mins and maxes; once with NaN), a 2**24 + 1 predicate, a
    ``group_by type_id`` of float sums over 2,000 bank accounts, and the
    first chunk with one aggregate of ``SKEW_EVENTS`` events; the same
    ``group_by`` over the 500k accounts against the numpy
    ``scan_reference`` (each time beside ``baseline``'s kernel, when given);
    then ``scan_segment`` over the 16-chunk segment (all ops, and
    ``group_by type_id``) against ``scan_reference``, and
    ``query_states_segment`` against the closed form."""
    import torch

    from surge_tpu_torch.codec.tensor import ColumnarEvents
    from surge_tpu_torch.config import Config
    from surge_tpu_torch.log.columnar import read_segment, segment_info
    from surge_tpu_torch.models import bank_account, counter
    from surge_tpu_torch.replay import fold_kernels, scan_reduce
    from surge_tpu_torch.replay.engine import ReplayEngine
    from surge_tpu_torch.replay.query import (Predicate, QueryEngine, ScanQuery,
                                              StateQuery, scan_reference)

    spec = counter.make_replay_spec()
    qeng = QueryEngine(spec)
    fadd_ns = fadd_latency_ns()
    log("phase11 fadd_ns: " + json.dumps({"card": card, "fadd_ns": fadd_ns}))
    check = lambda *a, **kw: check_scan_case(*a, fadd_ns=fadd_ns,  # noqa: E731
                                             baseline=baseline, **kw)
    chunk0 = next(read_segment(seg_path))
    rows = [check(f"counter chunk0 {name}", qeng, chunk0, q)
            for name, q in query_cases().items()]
    # 2**24 + 1 compares as 2**24 (float32 predicate values, as the reference)
    big = ColumnarEvents(
        num_aggregates=chunk0.num_aggregates, agg_idx=chunk0.agg_idx,
        type_ids=chunk0.type_ids,
        cols={**chunk0.cols, "increment_by": (chunk0.cols["increment_by"]
                                              + np.int32((1 << 24) - 1))},
        derived_cols=dict(chunk0.derived_cols),
        aggregate_ids=chunk0.aggregate_ids)
    q24 = ScanQuery(aggregates=query_cases()["typed"].aggregates,
                    predicates=(Predicate("increment_by", "==", (1 << 24) + 1),))
    rows.append(check("counter chunk0 2^24+1", qeng, big, q24))
    want24 = int((big.cols["increment_by"] == (1 << 24)).sum())
    if rows[-1]["matched"] != want24:
        raise AssertionError(f"2^24 + 1 matched {rows[-1]['matched']} events, "
                             f"not the {want24} at 2^24")
    bcol = bank_corpus(500_000, seed=5)
    beng = QueryEngine(bank_account.make_replay_spec())
    rows.append(check("bank 500k floats", beng, bcol, bank_query(False)))
    rows.append(check("bank 500k floats filtered", beng, bcol, bank_query(True)))
    nan_cols = dict(bcol.cols)
    nan_cols["new_balance"] = bcol.cols["new_balance"].copy()
    nan_cols["new_balance"][::997] = np.nan
    bnan = ColumnarEvents(num_aggregates=bcol.num_aggregates, agg_idx=bcol.agg_idx,
                          type_ids=bcol.type_ids, cols=nan_cols)
    rows.append(check("bank 500k NaN", beng, bnan, bank_query(False)))
    del bnan, nan_cols
    # this slice's cases: few large groups with float sums (two groups in
    # unsorted event order, each one serial chain), and a skewed span
    rows.append(check("bank 2k group_by type_id", beng, bank_corpus(2_000, seed=6),
                      bank_query(False, group_by="type_id")))
    rows.append(check("bank 500k group_by type_id", beng, bcol,
                      bank_query(False, group_by="type_id"), oracle=True))
    del bcol
    rows.append(check(f"counter chunk0 skewed {SKEW_EVENTS}", qeng,
                      skewed_chunk(chunk0, SKEW_EVENTS, seed=7), query_cases()["all_ops"]))
    torch.cuda.empty_cache()

    # scan_segment over the 16 chunks (the main path of a ScanQuery), with
    # each aggregate a group and with group_by type_id (four groups across
    # every chunk, each chunk's groups not in event order)
    group_by = ScanQuery(aggregates=query_cases()["all_ops"].aggregates,
                         group_by="type_id")
    seg = scan_segment_arm(card, spec, seg_path, "all_ops", query_cases()["all_ops"])
    seg_gb = scan_segment_arm(card, spec, seg_path, "group_by_type_id", group_by)
    seg_eng = QueryEngine(spec)

    # query_states_segment: fold (K1, one launch a window), filter, project
    reng = ReplayEngine(spec, config=Config())
    sq = StateQuery(select=("count", "version"),
                    predicates=(Predicate("count", ">=", 50),))
    reset_launches()
    w0 = reng.stats["windows"]
    t0 = time.perf_counter()
    res = seg_eng.query_states_segment(seg_path, sq, reng)
    wall = time.perf_counter() - t0
    st_launches = {**fold_kernels.LAUNCHES, **scan_reduce.LAUNCHES}
    windows = reng.stats["windows"] - w0
    if st_launches["tile_fold_list"] != windows or windows <= 0 or \
            sum(st_launches.values()) != windows:
        raise AssertionError(f"query_states: {windows} windows, launches "
                             f"{st_launches}")
    idx = np.fromiter((int(a[1:]) for a in res.aggregate_ids), dtype=np.int64,
                      count=len(res.aggregate_ids))
    if not (np.array_equal(idx, np.flatnonzero(corpus.expected_count >= 50))
            and np.array_equal(res.columns["count"].astype(np.int64),
                               corpus.expected_count[idx])
            and np.array_equal(res.columns["version"],
                               corpus.expected_version[idx])):
        raise AssertionError("query_states: states off the closed form")
    states = {"card": card, "predicate": "count >= 50", "matched": len(idx),
              "events": res.scanned_events, "wall_s": wall,
              "events_per_sec": res.scanned_events / wall, "windows": windows,
              "launches": st_launches}
    log("phase11-states " + json.dumps(states))
    return {"kernel_rows": rows, "scan": seg, "scan_group_by": seg_gb,
            "states": states}


def scan_segment_arm(card: str, spec, seg_path: str, name: str, q) -> dict:
    """``QueryEngine.scan_segment`` over every chunk of the segment, its
    launches (one of each scan-reduce pass a chunk, nothing else) and its
    result against the numpy ``scan_reference``."""
    from surge_tpu_torch.log.columnar import read_segment, segment_info
    from surge_tpu_torch.replay import fold_kernels, scan_reduce
    from surge_tpu_torch.replay.query import QueryEngine, scan_reference

    seg_eng = QueryEngine(spec)
    reset_launches()
    t0 = time.perf_counter()
    got = seg_eng.scan_segment(seg_path, q)
    wall = time.perf_counter() - t0
    launches = {**fold_kernels.LAUNCHES, **scan_reduce.LAUNCHES}
    chunks = segment_info(seg_path)["num_chunks"]
    passes = scan_reduce.PASSES
    if got.chunks != chunks or any(launches[p] != chunks for p in passes) or \
            sum(launches.values()) != len(passes) * chunks:
        raise AssertionError(f"scan_segment {name}: {got.chunks} of {chunks} chunks, "
                             f"launches {launches}")
    t1 = time.perf_counter()
    want = scan_reference(read_segment(seg_path, columns=q.columns_needed()), q,
                          spec.registry)
    oracle_s = time.perf_counter() - t1
    if got.aggregate_ids != want.aggregate_ids or set(got.columns) != set(want.columns):
        raise AssertionError(f"scan_segment {name}: ids or columns differ from "
                             f"scan_reference")
    for col_name, col in want.columns.items():
        if got.columns[col_name].tobytes() != col.tobytes():
            raise AssertionError(f"scan_segment {name}: {col_name} differs from "
                                 f"scan_reference")
    row = {"card": card, "query": name, "chunks": got.chunks,
           "groups": got.num_aggregates,
           "events": got.scanned_events, "matched": got.matched_events,
           "wall_s": wall, "scan_events_per_sec": got.scanned_events / wall,
           "stages_s": dict(seg_eng.stage_s), "launches": launches,
           "oracle_chunks": list(range(got.chunks)), "oracle_s": oracle_s}
    log("phase11-scan " + json.dumps(row))
    return row


class RecordingTracer:
    """A duck-typed tracer that keeps every finished span (name and
    attributes)."""

    class _Span:
        def __init__(self, tracer, name):
            self._tracer, self.name, self.attributes = tracer, name, {}
            self.start_time = self.start_mono = 0.0

        def set_attribute(self, key, value):
            self.attributes[key] = value

        def finish(self):
            self._tracer.spans.append(self)

    def __init__(self):
        self.spans: list = []

    def start_span(self, name, parent=None):
        return RecordingTracer._Span(self, name)


def view_defs() -> dict:
    from surge_tpu_torch.replay.query import Aggregate as A
    from surge_tpu_torch.replay.query import Predicate as P
    from surge_tpu_torch.replay.query import ScanQuery as Q
    from surge_tpu_torch.replay.views import ViewDef

    return {
        "V1": ViewDef(name="V1", query=Q(
            aggregates=(A("count"), A("sum", "increment_by")),
            event_types=("CountIncremented",))),
        "V2": ViewDef(name="V2", query=Q(
            aggregates=(A("count"), A("sum", "increment_by"),
                        A("min", "sequence_number"),
                        A("max", "sequence_number")),
            group_by="type_id")),
        "V3": ViewDef(name="V3", query=Q(
            aggregates=(A("count"), A("max", "sequence_number")),
            predicates=(P("sequence_number", ">", 2),))),
    }


def committed_columnar(plog, watermarks: dict):
    """Every event the plane log holds below ``watermarks`` as one columnar
    chunk, grouped by aggregate in log order (each aggregate lives in one
    partition), with its ids: the from-scratch scan's input."""
    from surge_tpu_torch.codec.tensor import ColumnarEvents

    keys, vals = [], []
    for p, wm in watermarks.items():
        recs = [r for r in plog.log.read(PLANE_TOPIC, int(p), 0) if r.offset < wm]
        keys.extend(int(r.key[1:]) for r in recs)
        vals.append(np.frombuffer(b"".join(r.value for r in recs),
                                  dtype=EVENT_RECORD))
    agg = np.asarray(keys, dtype=np.int64)
    rec = np.concatenate(vals)
    order = np.argsort(agg, kind="stable")
    uniq, inv = np.unique(agg[order], return_inverse=True)
    rec = rec[order]
    return ColumnarEvents(
        num_aggregates=len(uniq), agg_idx=inv.astype(np.int32),
        type_ids=rec["type"].astype(np.int32),
        cols={"increment_by": rec["inc"].astype(np.int32),
              "decrement_by": np.zeros(len(rec), dtype=np.int32),
              "sequence_number": rec["seq"].astype(np.int32)},
        aggregate_ids=[f"a{i}" for i in uniq.tolist()])


class ViewArm:
    """Phase 4's plane with materialized views: V1 and V2 registered before
    the seed, V3 after half of the rounds (the backfill path), a changefeed
    subscription on each from its first entry, and a recording tracer."""

    def __init__(self):
        self.tracer = RecordingTracer()
        self.defs = view_defs()
        self.subs: dict = {}
        self.folds: list = []  # (kind, seconds, {pass: launches})
        self.inflight = False  # a refresh round has not returned yet

    def hooks(self) -> dict:
        return {"tracer": self.tracer}

    def _timed(self, kind, fn):
        from surge_tpu_torch.replay import scan_reduce

        def run(*a, **k):
            counts = scan_reduce.LAUNCHES
            before = {p: counts[p] for p in scan_reduce.PASSES}
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.folds.append((kind if self.plane._running or kind != "round"
                                   else "seed", time.perf_counter() - t0,
                                   {p: counts[p] - before[p] for p in scan_reduce.PASSES}))
        return run

    def attach(self, plane):
        from surge_tpu_torch.replay.views import MaterializedViews

        self.plane = plane
        refresh_once = plane._refresh_once

        async def watched():
            self.inflight = True
            try:
                return await refresh_once()
            finally:
                self.inflight = False

        plane._refresh_once = watched
        self.views = MaterializedViews(plane.spec, config=plane.config,
                                       device=plane.device)
        self.views.fold_round = self._timed("round", self.views.fold_round)
        self.views.fold_view_backfill = self._timed(
            "backfill", self.views.fold_view_backfill)
        plane.attach_views(self.views)
        for name in ("V1", "V2"):
            plane.register_view(self.defs[name])
            self.subs[name] = self.views.subscribe(name)

    def on_round(self, r: int, rounds: int, plane):
        if r == rounds // 2:
            plane.register_view(self.defs["V3"])
            self.subs["V3"] = self.views.subscribe("V3")

    async def finish(self, plane, plog, per_round) -> dict:
        """Wait for the views' last fold, then hold every view to a
        from-scratch scan at its watermarks and to its replayed changefeed."""
        from surge_tpu_torch.replay.query import QueryEngine

        t0 = time.perf_counter()
        while True:
            summ = {v["view"]: v for v in self.views.summary()}
            if all(v["active"] and v["error"] is None
                   and {int(p): w for p, w in v["watermarks"].items()}
                   == plane._watermarks for v in summ.values()):
                break
            if time.perf_counter() - t0 > 300:
                raise AssertionError(f"views never caught up: {summ}")
            await asyncio.sleep(0.01)
        for _ in range(3):
            await asyncio.sleep(0)  # changefeed entries land on the loop
        out = {}
        committed: dict = {}  # one chunk per set of watermarks
        for name, vdef in self.defs.items():
            snap = self.views.snapshot(name)
            c0 = time.perf_counter()
            key = tuple(sorted(snap["watermarks"].items()))
            if key not in committed:
                committed[key] = committed_columnar(plog, snap["watermarks"])
            colev = committed[key]
            res = QueryEngine(plane.spec, device=plane.device).scan_chunks(
                [colev], vdef.query)
            order = sorted(range(res.num_aggregates),
                           key=lambda j: res.aggregate_ids[j])
            if snap["keys"] != [res.aggregate_ids[j] for j in order]:
                raise AssertionError(f"view {name}: keys differ from the scan")
            for col, arr in res.columns.items():
                if snap["columns"][col].tobytes() != np.asarray(arr)[order].tobytes():
                    raise AssertionError(f"view {name}: {col} differs from a "
                                         f"from-scratch scan_chunks")
            state: dict = {}
            entries = 0
            q = self.subs[name].queue
            while not q.empty():
                e = q.get_nowait()
                entries += 1
                if e.get("reset"):
                    state.clear()
                for row in e["rows"]:
                    state[row["key"]] = row
            if state != {r["key"]: r for r in snap["rows"]}:
                raise AssertionError(f"view {name}: its changefeed does not "
                                     f"rebuild the snapshot")
            out[name] = {"groups": len(snap["keys"]), "version": snap["version"],
                         "changefeed_entries": entries,
                         "check_s": time.perf_counter() - c0}
        gathers = [s for s in self.tracer.spans if s.name == "resident.gather"]
        if not gathers or set(gathers[0].attributes) != {
                "leg.coalesce-ms", "leg.dispatch-ms", "leg.fetch-ms",
                "leg.decode-ms", "rows"}:
            raise AssertionError(f"tracer: {len(gathers)} resident.gather spans")
        kinds = {}
        for kind, sec, launches in self.folds:
            acc = kinds.setdefault(kind, {"calls": 0, "s": 0.0, "launches": 0,
                                          "launches_by_pass": dict.fromkeys(launches, 0)})
            acc["calls"] += 1
            acc["s"] += sec
            acc["launches"] += launches["scan_reduce"]
            for p, n in launches.items():
                acc["launches_by_pass"][p] += n
        rounds_fold = [sec * 1e3 for kind, sec, _ in self.folds if kind == "round"]
        return {"views": out, "folds": kinds,
                "fold_ms_per_round": rounds_fold,
                "gather_spans": len(gathers),
                "stats": dict(self.views.stats)}


def phase_views(card: str, plog, no_views: dict) -> dict:
    """Phase 4's plane again, over the same log (its events are this plane's
    seed), with the view arm, after the arm without views in the same call:
    the same checks, and the views against a from-scratch scan."""
    arm = ViewArm()
    row = asyncio.run(drive_plane(
        card, aggregates=PLANE_AGGREGATES, capacity=PLANE_CAPACITY,
        rounds=PLANE_ROUNDS, dispatch="bucketed", seed=14, plog=plog,
        views=arm))
    row.pop("plog")
    folds = row["views"]["folds"]
    if folds.get("seed", {}).get("launches", 0) <= 0 or \
            folds.get("round", {}).get("launches", 0) <= 0 or \
            folds.get("backfill", {}).get("launches", 0) <= 0:
        raise AssertionError(f"the view legs launched no scan reduction: {folds}")
    row["refresh_events_per_s_without_views"] = no_views["refresh_events_per_s"]
    # the same clock without the round that waited on V3's backfill
    steady = {x["round"]: x for x in row["rounds"]
              if not x["profiled"] and x["round"] != PLANE_ROUNDS // 2}
    row["refresh_events_per_s_without_backfill_round"] = (
        sum(x["events"] for x in steady.values())
        / (sum(x["wall_ms"] for x in steady.values()) / 1e3))
    log("phase11-views " + json.dumps(row))
    return row


class OneShotFaults:
    """A duck-typed fault plane: ``corrupt.slab-row`` fires once; every
    ``point`` is kept."""

    def __init__(self):
        self.armed = True
        self.points: list = []

    def corrupt_point(self, site: str) -> bool:
        fire = self.armed and site == "corrupt.slab-row"
        self.armed = self.armed and not fire
        return fire

    def point(self, site: str) -> None:
        self.points.append(site)


class FlightLog:
    def __init__(self):
        self.events: list = []

    def record(self, kind, **fields):
        self.events.append((kind, fields))


def phase_faults(card: str) -> dict:
    """A 65,536-aggregate plane with ``corrupt.slab-row`` armed once: after a
    round the corrupted row differs from its closed form in exactly the
    count's sign bit, its ordinal unchanged, and the dispatch point was
    passed once a window."""
    rng = np.random.default_rng(21)
    n = 65536
    plog = PlaneLog(n)
    plog.append(np.repeat(np.arange(n, dtype=np.int64),
                          1 + rng.binomial(7, 0.2, size=n)), rng)
    faults, flight, ledger, signals = OneShotFaults(), FlightLog(), RoundLedger(), []

    async def run():
        plane = make_plane(plog, {"surge.replay.resident.capacity": n},
                           signals, ledger, faults=faults, flight=flight)
        await plane.start()
        try:
            plog.append(rng.integers(0, n, size=20_000), rng)
            t0 = time.perf_counter()
            while faults.armed:
                if time.perf_counter() - t0 > 120:
                    raise AssertionError("corrupt.slab-row never fired")
                await asyncio.sleep(0.005)
            victim = next(f["aggregate"] for k, f in flight.events
                          if k == "fault.corrupt")
            (row, ordinal), = plane.audit_pull([victim]).values()
            return victim, row, ordinal
        finally:
            await plane.stop()

    victim, row, ordinal = asyncio.run(run())
    want = int(plog.n_events[int(victim[1:])])
    flipped = int(np.asarray(row["count"], dtype=np.int32).view(np.uint32)
                  ^ np.uint32(want))
    windows = sum(kw["windows"] for kw in ledger.rounds)
    if flipped != 1 << 31 or int(row["version"]) != want or ordinal != want:
        raise AssertionError(f"corrupted row {victim}: {row}, ordinal {ordinal}, "
                             f"closed form {want}")
    if signals:
        raise AssertionError(f"the fault plane's plane signalled {signals}")
    if faults.points != ["resident.refresh.dispatch"] * windows or windows <= 0:
        raise AssertionError(f"{len(faults.points)} dispatch points for "
                             f"{windows} windows")
    out = {"card": card, "aggregates": n, "victim": victim,
           "flipped_bit": 31, "ordinal": ordinal, "windows": windows,
           "dispatch_points": len(faults.points), "signals": signals}
    log("phase11-faults " + json.dumps(out))
    return out


# -- phase 12: the engine at deployment size -----------------------------------------

ENGINE_EVENTS_TOPIC = "counter-events"
ENGINE_STATE_TOPIC = "counter-state"
#: the plane's full deployment behind the engine: the reference's defaults
#: (8 partitions), 2^20 resident rows, 1,310,720 aggregates (~3.1M events)
ENGINE_PARTITIONS = 8
ENGINE_AGGREGATES = 1_310_720
ENGINE_CAPACITY = 1 << 20
#: the burst: ENGINE_COMMANDS Increment commands over
#: ENGINE_COMMAND_AGGREGATES aggregates (half resident after the seed, half
#: spilled), in turns of one command an aggregate, sent in waves of
#: ENGINE_WAVE concurrent commands
ENGINE_COMMANDS = 10_000
ENGINE_COMMAND_AGGREGATES = 5_000
ENGINE_WAVE = 500
ENGINE_PROJECT = 65_536
#: query_states: aggregates with at least this many events
ENGINE_STATE_K = 5
#: the stages whose launches the kernels line reports
ENGINE_STAGES = ("cold_start", "commands", "query", "query_states", "restart")
#: the counter's JSON formats (``counter.event_formatting`` and
#: ``counter.state_formatting``; checked against them before use)
EVENT_JSON = ('{"aggregate_id": "%s", "increment_by": 1, "sequence_number": %d, '
              '"_type": "CountIncremented"}')
STATE_JSON = '{"aggregate_id": "%s", "count": %d, "version": %d}'


def engine_logic():
    from surge_tpu_torch import SurgeCommandBusinessLogic
    from surge_tpu_torch.models import counter

    return SurgeCommandBusinessLogic(
        aggregate_name="counter", model=counter.CounterModel(),
        state_format=counter.state_formatting(),
        event_format=counter.event_formatting())


def key_partitions(ids: list, num_partitions: int) -> np.ndarray:
    """``partition_for_key`` of every id (ASCII ids), in numpy: Scala's
    MurmurHash3.stringHash over the ids' chars two at a time, ids of one
    length at a time: ten times as fast as the scalar function called per
    id, which the log's build would call 1.3M times. The caller holds a
    sample to the scalar function."""
    m = np.uint64(0xFFFFFFFF)

    def rotl(x, r):
        return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & m

    def mix_k(k):
        return (rotl((k * np.uint64(0xCC9E2D51)) & m, 15) * np.uint64(0x1B873593)) & m

    lens = np.fromiter(map(len, ids), dtype=np.int64, count=len(ids))
    out = np.empty(len(ids), dtype=np.int64)
    for n in np.unique(lens).tolist():
        at = np.flatnonzero(lens == n)
        chars = np.frombuffer("".join(ids[i] for i in at.tolist()).encode("ascii"),
                              dtype=np.uint8).reshape(len(at), n).astype(np.uint64)
        h = np.full(len(at), 0xF7CA7FD2, dtype=np.uint64)
        for i in range(0, n - 1, 2):
            h = rotl(h ^ mix_k((chars[:, i] << np.uint64(16)) + chars[:, i + 1]), 13)
            h = (h * np.uint64(5) + np.uint64(0xE6546B64)) & m
        if n % 2:
            h ^= mix_k(chars[:, n - 1])
        h ^= np.uint64(n)
        for shift, mul in ((16, 0x85EBCA6B), (13, 0xC2B2AE35)):
            h = ((h ^ (h >> np.uint64(shift))) * np.uint64(mul)) & m
        h ^= h >> np.uint64(16)
        out[at] = np.abs(h.astype(np.uint32).view(np.int32).astype(np.int64)) % num_partitions
    return out


def engine_log(n: int, rng):
    """The port's InMemoryLog holding what the engine's publisher writes:
    every aggregate's events on the events topic and its latest state on the
    state topic, keyed by aggregate id, partitioned by ``partition_for_key``
    (the router's rule), in the counter's JSON formats. The records are
    appended in bulk with their offsets (``append_verbatim``, one call a
    topic and partition): the same records a transaction a command would
    leave, built once instead of twice. Every event increments by 1 (1-8
    events an aggregate, ~2.4 on average, as phase 4's seed before its
    cut), so count == version == events."""
    from surge_tpu_torch.engine.partition import partition_for_key
    from surge_tpu_torch.log import InMemoryLog, LogRecord, TopicSpec
    from surge_tpu_torch.models import counter

    if (counter.event_formatting().write_event(
            counter.CountIncremented("a7", 1, 3)).value
            != (EVENT_JSON % ("a7", 3)).encode()
            or counter.state_formatting().write_state(
                counter.State("a7", 3, 3)).value
            != (STATE_JSON % ("a7", 3, 3)).encode()):
        raise AssertionError("the log's JSON differs from the counter's formats")
    elog = InMemoryLog()
    elog.create_topic(TopicSpec(ENGINE_STATE_TOPIC, ENGINE_PARTITIONS, compacted=True))
    elog.create_topic(TopicSpec(ENGINE_EVENTS_TOPIC, ENGINE_PARTITIONS))
    ids = [f"a{i}" for i in range(n)]
    lens = 1 + rng.binomial(7, 0.2, size=n)
    parts = key_partitions(ids, ENGINE_PARTITIONS)
    if any(parts[i] != partition_for_key(ids[i], ENGINE_PARTITIONS)
           for i in rng.choice(n, min(n, 4096), replace=False).tolist()):
        raise AssertionError("key_partitions differs from partition_for_key")
    now = time.time()
    events = [[] for _ in range(ENGINE_PARTITIONS)]
    states = [[] for _ in range(ENGINE_PARTITIONS)]
    for a, k, p in zip(ids, lens.tolist(), parts.tolist()):
        ev = events[p]
        for s in range(1, k + 1):
            ev.append(LogRecord(ENGINE_EVENTS_TOPIC, a, (EVENT_JSON % (a, s)).encode(),
                                p, {}, len(ev), now))
        st = states[p]
        st.append(LogRecord(ENGINE_STATE_TOPIC, a, (STATE_JSON % (a, k, k)).encode(),
                            p, {}, len(st), now))
    for recs in events + states:
        elog.append_verbatim(recs)
    return elog, ids, lens.astype(np.int64)


def engine_committed(elog, watermarks: dict, expect_events: np.ndarray):
    """Every event the log holds below ``watermarks`` as one columnar chunk:
    each record's bytes held to the counter's JSON for its key and position
    (so the chunk is the log's content), grouped by aggregate."""
    from surge_tpu_torch.codec.tensor import ColumnarEvents

    keys: list = []
    seqs: list = []
    seen: dict = {}
    for p, wm in watermarks.items():
        for r in elog.read(ENGINE_EVENTS_TOPIC, int(p), 0):
            if r.offset >= wm:
                break
            s = seen.get(r.key, 0) + 1
            seen[r.key] = s
            if r.value != (EVENT_JSON % (r.key, s)).encode():
                raise AssertionError(f"event {r.key}@{r.offset} is not its JSON")
            keys.append(int(r.key[1:]))
            seqs.append(s)
    agg = np.asarray(keys, dtype=np.int64)
    if not np.array_equal(np.bincount(agg, minlength=len(expect_events)),
                          expect_events):
        raise AssertionError("the log's event counts differ from the closed form")
    order = np.argsort(agg, kind="stable")
    uniq, inv = np.unique(agg[order], return_inverse=True)
    n = len(agg)
    return ColumnarEvents(
        num_aggregates=len(uniq), agg_idx=inv.astype(np.int32),
        type_ids=np.zeros(n, dtype=np.int32),
        cols={"increment_by": np.ones(n, dtype=np.int32),
              "decrement_by": np.zeros(n, dtype=np.int32),
              "sequence_number": np.asarray(seqs, dtype=np.int32)[order]},
        aggregate_ids=[f"a{i}" for i in uniq.tolist()])


def check_closed_form(label: str, states: dict, ids, expect: np.ndarray) -> None:
    """Every id's state (domain objects) equals count == version == its
    events."""
    missing = [a for a in ids if a not in states]
    if missing:
        raise AssertionError(f"{label}: {len(missing)} states missing, e.g. {missing[:3]}")
    for a in ids:
        st, want = states[a], int(expect[int(a[1:])])
        if st.count != want or st.version != want or st.aggregate_id != a:
            raise AssertionError(f"{label}: {a} is {st}, not {want}")


def launches_now() -> dict:
    from surge_tpu_torch.replay import fold_kernels, scan_reduce

    return {**fold_kernels.LAUNCHES, **scan_reduce.LAUNCHES}


def device_busy(prof, wall_s: float) -> dict:
    """A profiled slice's device busy time and idle share, and its device
    operations by name."""
    from torch.autograd import DeviceType

    busy_us = 0.0
    by_name: dict = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            us = evt.time_range.elapsed_us()
            busy_us += us
            acc = by_name.setdefault(evt.name[:60], [0, 0.0])
            acc[0] += 1
            acc[1] += us / 1e3
    wall_us = wall_s * 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / wall_us if wall_us else None,
            "device_ops": {k: {"count": v[0], "ms": v[1]} for k, v in top}}


async def drive_engine(card: str, work: str) -> dict:
    """Phase 12: the port's ``create_engine`` over the port's InMemoryLog at
    the plane's full deployment; cold start, a command burst, reads, a view, a query,
    a state query, and a second engine's cold start on the same log. Every
    result is held to its oracle; every stage's kernel launches are counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from surge_tpu_torch import CommandSuccess, create_engine, default_config
    from surge_tpu_torch.log.columnar import read_segment, segment_info
    from surge_tpu_torch.models import counter
    from surge_tpu_torch.replay import fold_kernels, scan_reduce
    from surge_tpu_torch.replay.query import Aggregate as A
    from surge_tpu_torch.replay.query import (Predicate, QueryEngine, ScanQuery,
                                              StateQuery, scan_reference)
    from surge_tpu_torch.replay.views import ViewDef

    rng = np.random.default_rng(12)
    t0 = time.perf_counter()
    elog, ids, expect = engine_log(ENGINE_AGGREGATES, rng)
    log_build_s = time.perf_counter() - t0
    seg_path = os.path.join(work, "engine.scol")
    cfg = default_config().with_overrides({
        "surge.engine.num-partitions": ENGINE_PARTITIONS,
        "surge.replay.resident.enabled": True,
        "surge.replay.resident.capacity": ENGINE_CAPACITY,
        "surge.replay.restore-on-start": True,
        "surge.replay.segment-path": seg_path,
    })
    view = ViewDef(name="per-aggregate", query=ScanQuery(
        aggregates=(A("count"), A("sum", "increment_by")),
        event_types=("CountIncremented",)))
    eng = create_engine(engine_logic(), log=elog, config=cfg)
    if eng._engine_device().type != "cuda":
        raise AssertionError(f"the engine resolved {eng._engine_device()}")
    latest = [elog.latest_by_key(ENGINE_STATE_TOPIC, p)
              for p in range(ENGINE_PARTITIONS)]
    if any(a not in latest[eng.router.partition_for(a)] for a in ids[:1024]):
        raise AssertionError("the log is not partitioned as the router routes")
    del latest
    eng.register_view(view)
    plane = eng.resident_plane
    if plane.engine.tile_backend != "pallas":
        raise AssertionError("the plane's backend did not resolve to the kernels")
    # the restore's result carries its stages, and the engine keeps no copy
    # of it: the one wrapper here returns it unchanged (measurement only)
    rebuild = eng.rebuild_from_events
    captured: dict = {}

    async def captured_rebuild():
        c = time.perf_counter()
        captured["restore"] = await rebuild()
        captured["rebuild_s"] = time.perf_counter() - c
        return captured["restore"]

    eng.rebuild_from_events = captured_rebuild
    ledger = eng.replay_ledger

    async def settle(events: int, deadline_s: float = 600.0) -> float:
        """Until the plane has folded every committed record and the ledger
        holds ``events`` folded events in all: a round records itself once
        it has closed, its views' leg included."""
        c = time.perf_counter()
        while plane.lag_records() > 0 or ledger.totals["events"] < events:
            if time.perf_counter() - c > deadline_s:
                raise AssertionError(f"refresh never caught up (lag "
                                     f"{plane.lag_records()}, ledger events "
                                     f"{ledger.totals['events']} of {events})")
            await asyncio.sleep(0.002)
        return time.perf_counter() - c

    stages: dict = {}
    # 1. cold start: segment build, restore through K1, plane seed through
    # K1, the view's seed through scan_reduce
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    c0 = time.perf_counter()
    await eng.start()
    start_s = time.perf_counter() - c0
    await settle(0)
    stages["cold_start"] = launches_now()
    res = captured["restore"]
    restore_s = sum(res.stages.values())
    if (res.num_aggregates, res.num_events) != (ENGINE_AGGREGATES, int(expect.sum())):
        raise AssertionError(f"restore folded {res.num_aggregates} aggregates, "
                             f"{res.num_events} events")
    c = time.perf_counter()
    store = eng.indexer.store
    if store.approximate_num_entries() != ENGINE_AGGREGATES:
        raise AssertionError(f"the store holds {store.approximate_num_entries()}")
    # every stored state's bytes are the closed form's JSON (the format is
    # deterministic, so this is the decoded check made exact); a sample is
    # decoded through the engine's format too
    if sorted(store.all_items()) != sorted(
            (a, (STATE_JSON % (a, k, k)).encode())
            for a, k in zip(ids, expect.tolist())):
        raise AssertionError("the restored store differs from the closed form")
    read_state = eng.logic.state_format.read_state
    sample = [ids[i] for i in rng.permutation(len(ids))[:ENGINE_PROJECT]]
    check_closed_form("cold start store (decoded)",
                      {a: read_state(store.get(a)) for a in sample}, sample, expect)
    store_check_s = time.perf_counter() - c
    cold = {"card": card, "aggregates": ENGINE_AGGREGATES,
            "events": int(expect.sum()), "log_build_s": log_build_s,
            "start_s": start_s, "rebuild_s": captured["rebuild_s"],
            # the rebuild's time outside the restore's stages: the segment
            # build (the state window and the indexer prime take ~0 here)
            "segment_build_s": captured["rebuild_s"] - restore_s,
            "restore_s": restore_s, "restore_stages_s": res.stages,
            "plane_seed": plane.seed_timing,
            "plane_seed_s": sum(v for k, v in plane.seed_timing.items()
                                if k.endswith("_s")),
            "resident": len(plane._dir), "spilled": len(plane._spill),
            "segment_chunks": segment_info(seg_path)["num_chunks"],
            "store_check_s": store_check_s, "launches": stages["cold_start"],
            "device_mem_peak_bytes": torch.cuda.max_memory_allocated()}
    log("phase12-cold " + json.dumps(cold))

    # 2. commands: half resident, half spilled, in turns
    half = ENGINE_COMMAND_AGGREGATES // 2
    in_dir = [a for a in (ids[i] for i in rng.permutation(len(ids))[:4 * half])
              if a in plane._dir][:half]
    spilled = list(plane._spill)
    sp = [spilled[i] for i in rng.permutation(len(spilled))[:half]]
    if len(in_dir) != half or len(sp) != half:
        raise AssertionError("not enough resident or spilled aggregates")
    kind = {**dict.fromkeys(in_dir, "resident"), **dict.fromkeys(sp, "spilled")}
    targets = in_dir + sp
    turns = ENGINE_COMMANDS // ENGINE_COMMAND_AGGREGATES
    lat: dict = {"resident": [], "spilled": []}
    windows0 = ledger.totals["windows"]
    events0 = ledger.totals["events"]
    rounds0 = plane.stats["rounds"]
    stats0 = dict(plane.stats)
    # the shape of every window the burst gives a window kernel, so each is
    # held against the plain version after the phase
    window_shapes: dict = {"dense": [], "ragged": []}
    real = {wk: getattr(fold_kernels, f"{wk}_window") for wk in window_shapes}

    def seen(wk):
        def call(slab, ords, table, words, sides, **kw):
            rows = words.shape[0] if wk == "ragged" else 0
            width = kw["width"] if wk == "ragged" else words.shape[0]
            window_shapes[wk].append((table.shape[1], width, rows))
            return real[wk](slab, ords, table, words, sides, **kw)
        return call

    async def one(a):
        c = time.perf_counter()
        r = await eng.aggregate_for(a).send_command(counter.Increment(a))
        return a, r, time.perf_counter() - c

    reset_launches()
    prof_out = None
    lag_s = None
    for wk in window_shapes:
        setattr(fold_kernels, f"{wk}_window", seen(wk))
    try:
        c0 = time.perf_counter()
        waves = [(t, lo) for t in range(turns)
                 for lo in range(0, len(targets), ENGINE_WAVE)]
        for w, (turn, lo) in enumerate(waves):
            wave = targets[lo:lo + ENGINE_WAVE] if turn % 2 == 0 else \
                targets[::-1][lo:lo + ENGINE_WAVE]
            if w == len(waves) - 1:  # the last wave and its refresh, profiled
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    p0 = time.perf_counter()
                    results = await asyncio.gather(*(one(a) for a in wave))
                    burst_s = time.perf_counter() - c0
                    # each Increment is one event
                    lag_s = await settle(events0 + ENGINE_COMMANDS)
                    torch.cuda.synchronize()
                    p_wall = time.perf_counter() - p0
                prof_out = device_busy(prof, p_wall)
            else:
                results = await asyncio.gather(*(one(a) for a in wave))
            for a, r, dt in results:
                i = int(a[1:])
                expect[i] += 1
                if (not isinstance(r, CommandSuccess) or r.state.count != expect[i]
                        or r.state.version != expect[i]):
                    raise AssertionError(f"command on {a}: {r}, want {expect[i]}")
                lat[kind[a]].append(dt)
    finally:
        for wk, fn in real.items():
            setattr(fold_kernels, f"{wk}_window", fn)
    stages["commands"] = launches_now()
    windows = ledger.totals["windows"] - windows0
    win_launches = stages["commands"]["dense_window"] + stages["commands"]["ragged_window"]
    if (windows <= 0 or win_launches != windows or stages["commands"]["tile_fold_list"]
            or sum(map(len, window_shapes.values())) != windows):
        raise AssertionError(f"{windows} refresh windows made {stages['commands']} "
                             f"({sum(map(len, window_shapes.values()))} window calls)")
    # an entity's first state comes from the plane: the burst's inits that
    # the gather lane served (the others fell back to the host store)
    inits_gathered = plane.stats["gathered_rows"] - stats0["gathered_rows"]
    if inits_gathered <= 0:
        raise AssertionError("the gather lane served no entity init: "
                             f"{dict(plane.fallback_causes)}")
    # every burst target read back through the plane: the rows K2 folded
    c = time.perf_counter()
    burst_resident = sum(a in plane._dir for a in targets)
    check_closed_form("burst targets through the plane",
                      await plane.read_many(targets), targets, expect)
    burst_read_s = time.perf_counter() - c

    def pct(xs, q):
        return float(np.percentile(np.asarray(xs) * 1e3, q))

    commands = {"card": card, "commands": ENGINE_COMMANDS,
                "aggregates": len(targets), "wave": ENGINE_WAVE, "turns": turns,
                "burst_s": burst_s, "commands_per_s": ENGINE_COMMANDS / burst_s,
                "reply_ms": {k: {"p50": pct(v, 50), "p99": pct(v, 99),
                                 "n": len(v)} for k, v in lat.items()},
                "refresh_lag_after_burst_s": lag_s,
                "rounds": plane.stats["rounds"] - rounds0, "windows": windows,
                "evictions": plane.stats["evictions"] - stats0["evictions"],
                "fallbacks": plane.stats["fallbacks"] - stats0["fallbacks"],
                "fallback_causes": dict(plane.fallback_causes),
                "inits_gathered": inits_gathered,
                "burst_read_back": {"aggregates": len(targets),
                                    "resident": burst_resident, "s": burst_read_s},
                "window_shapes": {k: [[*shape, v.count(shape)]
                                      for shape in sorted(set(v))]
                                  for k, v in window_shapes.items()},
                "launches": stages["commands"], "profiled_wave": prof_out,
                "producer": eng.producer_stats()}
    log("phase12-commands " + json.dumps(commands))

    # 3. reads: project_states over resident and spilled aggregates
    sample = [ids[i] for i in rng.permutation(len(ids))[:ENGINE_PROJECT]]
    resident_n = sum(a in plane._dir for a in sample)
    g0, r0 = plane.stats["gathers"], plane.stats["gathered_rows"]
    reset_launches()
    c = time.perf_counter()
    proj = await eng.project_states(sample)
    project_s = time.perf_counter() - c
    check_closed_form("project_states", proj, sample, expect)
    if (plane.stats["gathers"] <= g0
            or plane.stats["gathered_rows"] - r0 < resident_n):
        raise AssertionError(f"{resident_n} resident reads gathered "
                             f"{plane.stats['gathered_rows'] - r0} rows")
    reads = {"card": card, "aggregates": len(sample), "resident": resident_n,
             "project_s": project_s, "rows_per_s": len(sample) / project_s,
             "gathers": plane.stats["gathers"] - g0,
             "gathered_rows": plane.stats["gathered_rows"] - r0,
             "launches": launches_now()}
    log("phase12-reads " + json.dumps(reads))

    # 4. the view, a query and a state query
    c = time.perf_counter()
    snap = await eng.query_view(view.name)
    view_s = time.perf_counter() - c
    if "error" in snap or {int(p): w for p, w in snap["watermarks"].items()} \
            != plane._watermarks:
        raise AssertionError(f"the view is not at the plane's watermarks: "
                             f"{snap.get('error')}")
    colev = engine_committed(elog, snap["watermarks"], expect)
    want = QueryEngine(plane.spec, device=plane.device).scan_chunks([colev], view.query)
    order = sorted(range(want.num_aggregates), key=lambda j: want.aggregate_ids[j])
    if snap["keys"] != [want.aggregate_ids[j] for j in order]:
        raise AssertionError("the view's keys differ from a from-scratch scan")
    for col, arr in want.columns.items():
        if snap["columns"][col].tobytes() != np.asarray(arr)[order].tobytes():
            raise AssertionError(f"the view's {col} differs from a from-scratch scan")
    all_ops = ScanQuery(aggregates=(A("count"), A("sum", "increment_by"),
                                    A("min", "increment_by"),
                                    A("max", "sequence_number")))
    reset_launches()
    c = time.perf_counter()
    got = await eng.query(all_ops)
    query_s = time.perf_counter() - c
    stages["query"] = launches_now()
    info = segment_info(seg_path)
    if any(stages["query"][p] != info["num_chunks"] for p in scan_reduce.PASSES):
        raise AssertionError(f"query over {info['num_chunks']} chunks launched "
                             f"{stages['query']}")
    oracle = scan_reference(read_segment(seg_path, columns=all_ops.columns_needed()),
                            all_ops, plane.spec.registry)
    if got.aggregate_ids != oracle.aggregate_ids or any(
            got.columns[k].tobytes() != v.tobytes() for k, v in oracle.columns.items()):
        raise AssertionError("engine.query differs from scan_reference")
    if got.scanned_events != int(expect.sum()):
        raise AssertionError(f"the extended segment holds {got.scanned_events} events")
    sq = StateQuery(select=("count", "version"),
                    predicates=(Predicate("count", ">=", ENGINE_STATE_K),))
    reset_launches()
    c = time.perf_counter()
    states = await eng.query_states(sq)
    states_s = time.perf_counter() - c
    stages["query_states"] = launches_now()
    hit = np.flatnonzero(expect >= ENGINE_STATE_K)
    by_id = dict(zip(states.aggregate_ids, np.asarray(states.columns["count"]).tolist()))
    if sorted(by_id) != sorted(f"a{i}" for i in hit.tolist()) or any(
            by_id[f"a{i}"] != int(expect[i]) for i in hit.tolist()):
        raise AssertionError("query_states differs from the closed form")
    if stages["query_states"]["tile_fold_list"] <= 0:
        raise AssertionError("query_states launched K1 no time")
    analytics = {"card": card, "view_snapshot_s": view_s,
                 "view_groups": len(snap["keys"]), "view_version": snap["version"],
                 "query_s": query_s, "query_chunks": info["num_chunks"],
                 "query_events": got.scanned_events,
                 "query_events_per_s": got.scanned_events / query_s,
                 "query_states_s": states_s, "query_states_matched": len(hit),
                 "launches": {k: stages[k] for k in ("query", "query_states")}}
    log("phase12-analytics " + json.dumps(analytics))

    # 5. restart: a second engine on the same log
    c = time.perf_counter()
    while eng.indexer.lag_for(range(ENGINE_PARTITIONS)):
        if time.perf_counter() - c > 120:
            raise AssertionError("the indexer never caught up")
        await asyncio.sleep(0.01)
    first_store = sorted(eng.indexer.store.all_items())
    await eng.stop()
    eng2 = create_engine(engine_logic(), log=elog, config=cfg)
    plane2 = eng2.resident_plane
    reset_launches()
    c = time.perf_counter()
    await eng2.start()
    restart_s = time.perf_counter() - c
    stages["restart"] = launches_now()
    if sorted(eng2.indexer.store.all_items()) != first_store:
        raise AssertionError("the second engine's store differs from the first's")
    c = time.perf_counter()
    back: dict = {}
    for lo in range(0, len(ids), 65_536):
        back.update(await plane2.read_many(ids[lo:lo + 65_536]))
    check_closed_form("second plane", back, ids, expect)
    plane2_read_s = time.perf_counter() - c
    await eng2.stop()
    for stage in ("cold_start", "restart"):
        if stages[stage]["tile_fold_list"] <= 0:
            raise AssertionError(f"{stage} launched K1 no time")
    total = {k: sum(s.get(k, 0) for s in stages.values()) for k in stages["cold_start"]}
    if (total["tile_fold_list"] <= 0 or total["dense_window"] + total["ragged_window"] <= 0
            or total["scan_reduce"] <= 0):
        raise AssertionError(f"the phase's launches {total}")
    restart = {"card": card, "restart_s": restart_s,
               "plane_seed": plane2.seed_timing, "read_back_s": plane2_read_s,
               "launches": stages["restart"]}
    log("phase12-restart " + json.dumps(restart))
    return {"cold": cold, "commands": commands, "reads": reads,
            "analytics": analytics, "restart": restart, "launches": stages,
            "total_launches": total, "window_shapes": commands["window_shapes"],
            # the plane's wire: the counter's ordinal shipped or derived
            "window_layout": "counter/derived" if plane.derived else "counter/side"}


def phase_engine(card: str, work: str) -> dict:
    return asyncio.run(drive_engine(card, work))


# -- phase 13: mixed aggregate-type replay ------------------------------------------

#: phase 13's mix: each family under the model name the combined spec gives
#: it (sorted names set the type-id bases: bank 0, cart 2, counter 5, saga 9)
MIXED_FAMILIES = {"bank": "bank_account", "cart": "shopping_cart",
                  "counter": "counter", "saga": "saga"}
#: the layout the mixed kernel checks run (the four-family union, ordinal
#: derived), as check_plane_window_shapes names layouts
MIXED_LAYOUT = "mixed/derived"
#: the kernel checks' sub-corpus: aggregates in all, a quarter of each family
MIXED_CHECK_AGGREGATES = 65_536
#: the deployment-scale cold replay: aggregates of each family (the counter
#: with its events: phase 3's 1M / 20M, cut from the bench's 100M for the
#: script's time limit, since every event carries the union's 17 four-byte
#: columns through the host's mix, pack and upload)
MIXED_SCALE = {"bank": 500_000, "cart": 1_000_000,
               "counter": (1_000_000, 20_000_000), "saga": 1_000_000}
#: the mixed planes: aggregates (a quarter of each family), rows, rounds
#: (cut from 4 for the script's time limit, PERF.md §4)
MIXED_PLANE_AGGREGATES = 262_144
MIXED_PLANE_CAPACITY = 1 << 17
MIXED_DENSE_AGGREGATES = 65_536
MIXED_DENSE_CAPACITY = 32_768
MIXED_PLANE_ROUNDS = 2
MIXED_PLANE_TOPIC = "mixed-events"
#: events of each log the planes' seed holds (262,144 aggregates: ~0.45M;
#: cut from 5 (~1.04M) for the script's time limit, PERF.md §4)
MIXED_SEED_EVENTS = 2
#: each family's seed at MIXED_SCALE: the corpora of phases 3 and 5
MIXED_SEEDS = {"bank": 5, "cart": 11, "counter": 3, "saga": 11}


@functools.cache
def mixed_replay():
    """The port's combined spec of the four families."""
    from surge_tpu_torch.models import bank_account, counter, shopping_cart
    from surge_tpu_torch.replay import combine_replay_specs
    from surge_tpu_torch.saga import model as saga

    mods = {"bank_account": bank_account, "counter": counter,
            "shopping_cart": shopping_cart, "saga": saga}
    return combine_replay_specs({m: mods[f].make_replay_spec()
                                 for m, f in MIXED_FAMILIES.items()})


@functools.cache
def mixed_case():
    """(layout, spec, wire) of the mixed step, as kernel_cases gives each
    family's."""
    from surge_tpu_torch.codec.wire import WireFormat

    spec = mixed_replay().spec
    return MIXED_LAYOUT, spec, WireFormat(spec.registry,
                                          {"sequence_number": "ordinal"})


def family_columnar(model: str, n, seed: int):
    """A family's cold-replay corpus (grouped by aggregate, the ordinal
    derived) and its closed form (bank accounts have none): the counter's
    ``synth_counter_corpus`` (``n`` is (aggregates, events)), the cart and
    saga walks, the bank corpus."""
    if model == "counter":
        c = counter_corpus(*n, seed=seed)
        return c.events, {"count": c.expected_count.astype(np.int32),
                          "version": c.expected_version.astype(np.int32)}
    if model == "bank":
        return bank_corpus(n, seed=seed), None
    return family_corpus(MIXED_FAMILIES[model], n, seed=seed)


def mix_corpora(mixed, parts: dict, seed: int):
    """One mixed corpus of the families' corpora ``{model: ColumnarEvents}``
    (each grouped by aggregate): type ids offset by the combined spec's
    bases, every union column filled (0 where a family lacks it), the
    aggregates interleaved by a seeded permutation, events grouped by
    aggregate. Returns ``(corpus, model [b], local [b])``: each aggregate's
    model name and its index in that model's corpus."""
    from surge_tpu_torch.codec.tensor import ColumnarEvents

    names = sorted(parts)
    counts = np.array([parts[m].num_aggregates for m in names])
    offs = np.r_[0, np.cumsum(counts)]
    b = int(offs[-1])
    lengths = np.concatenate([np.bincount(parts[m].agg_idx, minlength=c)
                              for m, c in zip(names, counts)])
    starts = np.r_[0, np.cumsum(lengths)]
    n = int(starts[-1])
    for m in names:
        if np.any(np.diff(parts[m].agg_idx) < 0):
            raise ValueError(f"{m}'s corpus is not grouped by aggregate")
    order = np.random.default_rng(seed).permutation(b)  # aggregate at each lane
    new_len = lengths[order]
    new_start = np.empty(b, np.int64)  # each aggregate's first row, mixed
    new_start[order] = np.r_[0, np.cumsum(new_len)[:-1]]
    # the derived ordinal is not a column; every other union column is 0
    # where the event's family lacks it
    tids = np.empty(n, np.int32)
    cols = {f.name: np.zeros(n, f.dtype) for f in mixed.spec.registry.union_columns()
            if f.name != "sequence_number"}
    for i, m in enumerate(names):
        c = parts[m]
        agg = offs[i] + c.agg_idx
        row = new_start[agg] + (np.arange(c.num_events) - (starts[agg] - starts[offs[i]]))
        tids[row] = c.type_ids + mixed.bases[m]
        for name, col in c.cols.items():
            cols[name][row] = col
    corpus = ColumnarEvents(
        num_aggregates=b, agg_idx=np.repeat(np.arange(b, dtype=np.int32), new_len),
        type_ids=tids, cols=cols, derived_cols={"sequence_number": "ordinal"})
    model = np.repeat(np.array(names), counts)[order]
    local = (np.arange(b) - np.repeat(offs[:-1], counts))[order]
    return corpus, model, local


def mixed_parts(scale: dict, seeds: dict) -> dict:
    """Each family's corpus and closed form at ``scale`` (MIXED_SCALE's
    shape), from its seed."""
    return {m: family_columnar(m, scale[m], seeds[m]) for m in sorted(MIXED_FAMILIES)}


def family_seeds(seed: int) -> dict:
    return {m: seed + i for i, m in enumerate(sorted(MIXED_FAMILIES))}


def quarter_scale(aggregates: int) -> dict:
    """A quarter of ``aggregates`` a family (the counter with 20 events an
    aggregate, as MIXED_SCALE's)."""
    q = aggregates // 4
    return {m: (q, 20 * q) if m == "counter" else q for m in MIXED_FAMILIES}


def phase_mixed_kernels() -> dict:
    """K1 (list fold, dense and flat, at the bench config; one non-resident
    window of 512 x 8,192 lanes; the dense window) and K2 with the mixed
    step against their plain versions, byte for byte, at the mixed
    sub-corpus and the planes' window shapes; the head shapes timed."""
    import torch

    from surge_tpu_torch.config import Config
    from surge_tpu_torch.replay.engine import ReplayEngine

    mixed = mixed_replay()
    layout, spec, wire = mixed_case()
    parts = mixed_parts(quarter_scale(MIXED_CHECK_AGGREGATES), family_seeds(31))
    corpus, _, _ = mix_corpora(mixed, {m: c for m, (c, _) in parts.items()},
                               seed=35)
    eng = ReplayEngine(spec, config=Config(overrides=BENCH_CONFIG))
    resident = eng.upload_resident(eng.pack_resident(corpus))
    lists = [check_list_case(f"{layout} {MIXED_CHECK_AGGREGATES}", eng, resident,
                             source, seed=41 + i, timed=True)
             for i, source in enumerate(("dense", "flat"))]
    del eng, resident
    nonres = [check_nonres_case(f"{layout} w{NONRES_HEAD[0]} bs{NONRES_HEAD[1]}",
                                spec, wire, *NONRES_HEAD, seed=43, timed=True),
              check_nonres_case(f"{layout} w8 bs24", spec, wire, 8, 24, seed=44,
                                timed=False)]
    windows = []
    for i, (label, kind, lanes, live, width, t_base, admit, lengths) in \
            enumerate(WINDOW_CASES):
        c = window_case(kind, spec, wire, lanes, live, width, t_base, admit,
                        lengths, seed=700 + i, capacity=PLANE_CAPACITY)
        windows.append(dict(check_window_case(
            f"{layout} {label}", spec, wire, c,
            timed=label in WINDOW_HEAD.values()), layout=layout))
        del c
    torch.cuda.empty_cache()
    by = {r["case"]: r["lanes_by_path"] for r in windows}
    for label, ok in (
            ("ragged over budget", by[f"{layout} ragged over budget"]["global"] > 0),
            ("ragged w8 steady", by[f"{layout} ragged w8 steady"]["global"] == 0
             and by[f"{layout} ragged w8 steady"]["staged"] > 0),
            ("dense w512", by[f"{layout} dense w512"]["global"] == 0
             and by[f"{layout} dense w512"]["staged"] > 0)):
        if not ok:
            raise AssertionError(f"{layout} {label}: the kernel took an "
                                 f"unexpected path: {by[f'{layout} {label}']}")
    return {"lists": lists, "nonres": nonres, "windows": windows}


def mixed_family_check(label: str, mixed, states: dict, model, local,
                       own: dict, expected: dict) -> None:
    """Every lane of the mixed states equal, byte for byte, to its family's
    own single-family states ``own[model]`` (and closed form
    ``expected[model]``, where one exists) in each of its family's fields,
    and 0 in every other union field."""
    for m, spec in mixed.parts.items():
        lanes = model == m
        idx = local[lanes]
        mine = set(spec.registry.state.field_names)
        for f in mixed.spec.registry.state.fields:
            got = np.asarray(states[f.name])[lanes]
            if f.name in mine:
                want = np.asarray(own[m][f.name])[idx]
            else:
                want = np.zeros(len(idx), f.dtype)
            if got.tobytes() != want.tobytes():
                bad = np.flatnonzero(got != want)[:5]
                raise AssertionError(f"{label}: {m} lanes differ from their "
                                     f"family's fold in {f.name!r} at {bad}")
        if expected.get(m) is not None:
            same_states(f"{label}: {m} against its closed form", own[m],
                        expected[m])


def list_fold_ms(eng, resident) -> tuple[float, dict]:
    """The list folds' device time per replay (CUDA events, the work lists'
    launches alone, behind a spin) and the replay's tiles, pad ratio and
    bound; launches made here are not a main path's."""
    plan = eng._plan_for(resident)
    slab, ord_d = eng._fresh_slab(resident.b_pad)
    ms = device_ms(lambda: eng._run_tiles(resident, plan, slab, ord_d), 5, 3)
    nbytes, steps = list_work(eng, resident, plan,
                              "dense" if eng._use_dense(resident, plan) else "flat")
    return ms, {"tiles": len(plan.big_i0) + len(plan.small_i0),
                "pad_ratio": plan.padded_slots / max(resident.num_events, 1),
                "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                                steps * 12 / INT32_OPS_PER_S) * 1e3,
                "bytes": nbytes, "valid_steps": steps}


def phase_mixed_replay(card: str) -> dict:
    """The four families in one corpus at deployment scale (MIXED_SCALE:
    3.5M aggregates, ~50M events) on K1's list fold, dense and flat, one
    untimed replay each and three timed, with each lane's family's init
    record; every lane against its family's own single-family K1 replay of
    the same aggregates and the closed forms; the list fold's device time
    per replay against the four single-family folds'."""
    from surge_tpu_torch.config import Config
    from surge_tpu_torch.models import bank_account, counter, shopping_cart
    from surge_tpu_torch.replay.engine import ReplayEngine
    from surge_tpu_torch.saga import model as saga

    mods = {"bank": bank_account, "cart": shopping_cart, "counter": counter,
            "saga": saga}
    mixed = mixed_replay()
    t0 = time.perf_counter()
    parts = mixed_parts(MIXED_SCALE, MIXED_SEEDS)
    walk_s = time.perf_counter() - t0
    corpus, model, local = mix_corpora(mixed, {m: c for m, (c, _) in parts.items()},
                                       seed=57)
    mix_s = time.perf_counter() - t0 - walk_s
    init = mixed.init_carry(model)
    out: dict = {"card": card, "aggregates": corpus.num_aggregates,
                 "events": corpus.num_events, "walk_s": walk_s, "mix_s": mix_s,
                 "arms": {}, "launches": {}, "families": {}}
    states, resident = {}, None
    for arm in ("dense", "flat"):
        r = run_arm(mixed.spec, corpus, arm, replays=3, resident=resident,
                    init_carry=init, device_fold=True)
        resident = r["resident"]
        states[arm] = r["states"]
        out["launches"][f"cold_replay_mixed_{arm}"] = r["row"]["launches"]
        out["arms"][arm] = r["row"]
        del r
    same_states("mixed flat against dense", states["flat"], states["dense"])
    # what `auto` picks under the default dense-cap-mb (2,048): the dense
    # tiles' bytes decide it
    auto = ReplayEngine(mixed.spec, config=Config(overrides=BENCH_CONFIG))
    plan = auto._plan_for(resident)
    out["auto"] = {"dense": auto._use_dense(resident, plan),
                   "dense_bytes": auto._dense_bytes(resident, plan),
                   "dense_cap_mb": auto._dense_cap_mb}
    del resident, init, auto
    own, expected = {}, {}
    for m, (c, exp) in parts.items():
        r = run_arm(mods[m].make_replay_spec(), c, "auto", replays=3,
                    device_fold=True)
        own[m], expected[m] = r["states"], exp
        out["families"][m] = dict(r["row"], events=c.num_events,
                                  aggregates=c.num_aggregates)
        del r
    mixed_family_check("mixed cold replay", mixed, states["dense"], model, local,
                       own, expected)
    fam_ms = sum(f["fold_device_ms"] for f in out["families"].values())
    out.update({
        "steady_events_per_sec": {arm: corpus.num_events / min(a["fold_s"])
                                  for arm, a in out["arms"].items()},
        "family_steady_events_per_sec": {
            m: f["events"] / min(f["fold_s"]) for m, f in out["families"].items()},
        "list_fold_ms": {arm: a["fold_device_ms"] for arm, a in out["arms"].items()},
        "families_list_fold_ms_sum": fam_ms,
        "list_fold_ratio_to_families": {arm: a["fold_device_ms"] / fam_ms
                                        for arm, a in out["arms"].items()}})
    log("phase13-replay " + json.dumps(out))
    return out


def mixed_record_dtype(mixed) -> np.dtype:
    """One mixed event on the log: the combined type id (u8), every union
    column but the derived ordinal (4 bytes each, little-endian) and the
    sequence number (u32)."""
    cols = [(f.name, "<f4" if np.dtype(f.dtype) == np.float32 else "<i4")
            for f in mixed.spec.registry.union_columns()
            if f.name != "sequence_number"]
    return np.dtype([("type", "u1"), *cols, ("seq", "<u4")])


def mixed_deserializer(mixed):
    """A batch of mixed event records -> the port's events of each family."""
    import dataclasses

    from surge_tpu_torch.codec.tensor import _construct

    dt = mixed_record_dtype(mixed)
    kinds = {}
    for s in mixed.spec.registry.event_schemas:
        names = s.field_names
        # the fields the registry leaves out (an aggregate id), as the codec
        # fills them
        probe = _construct(s.cls, {n: 0 for n in names})
        extra = {f.name: getattr(probe, f.name) for f in dataclasses.fields(s.cls)
                 if f.name not in names}
        kinds[s.type_id] = (s.cls, names, extra)

    def events(raws):
        recs = np.frombuffer(b"".join(raws), dtype=dt)
        cols = {name: recs[name].tolist() for name in dt.names}
        cols["sequence_number"] = cols.pop("seq")
        out = []
        for j, t in enumerate(cols["type"]):
            cls, names, extra = kinds[t]
            out.append(cls(**extra, **{n: cols[n][j] for n in names}))
        return out

    return events


class MixedLog:
    """The port's InMemoryLog of a mixed corpus's event records: each
    aggregate on partition ``index % PLANE_PARTITIONS``; ``cursor`` counts the
    events of each log appended so far."""

    def __init__(self, mixed, corpus):
        from surge_tpu_torch.log import InMemoryLog, TopicSpec

        self.log = InMemoryLog()
        self.log.create_topic(TopicSpec(MIXED_PLANE_TOPIC, PLANE_PARTITIONS))
        self.ids = [f"m{i}" for i in range(corpus.num_aggregates)]
        self.lengths = np.bincount(corpus.agg_idx, minlength=corpus.num_aggregates)
        self.starts = np.r_[0, np.cumsum(self.lengths)]
        self.cursor = np.zeros(corpus.num_aggregates, np.int64)
        dt = mixed_record_dtype(mixed)
        recs = np.zeros(corpus.num_events, dtype=dt)
        recs["type"] = corpus.type_ids
        for name in dt.names[1:-1]:
            recs[name] = corpus.cols[name]
        recs["seq"] = np.arange(corpus.num_events) - self.starts[corpus.agg_idx] + 1
        self.buf, self.w = recs.tobytes(), dt.itemsize
        self._producer = self.log.transactional_producer("chip-smoke")

    def append(self, counts: np.ndarray, verbatim: bool = False) -> int:
        """Append the next ``counts[a]`` events of each log ``a``, in order,
        as one transaction (``verbatim``: the records a transaction would
        leave, a partition at a time)."""
        from surge_tpu_torch.log import LogRecord

        aggs = np.repeat(np.arange(len(counts)), counts)
        events = np.repeat(self.starts[:-1] + self.cursor, counts) + (
            np.arange(len(aggs)) - np.repeat(np.r_[0, np.cumsum(counts)[:-1]], counts))
        self.cursor += counts
        w, buf, ids = self.w, self.buf, self.ids
        if verbatim:
            now = time.time()
            ends = [self.log.end_offset(MIXED_PLANE_TOPIC, p)
                    for p in range(PLANE_PARTITIONS)]
            parts = [[] for _ in range(PLANE_PARTITIONS)]
            for j, a in zip(events.tolist(), aggs.tolist()):
                p = a % PLANE_PARTITIONS
                parts[p].append(LogRecord(MIXED_PLANE_TOPIC, ids[a],
                                          buf[j * w:(j + 1) * w], p, {},
                                          ends[p] + len(parts[p]), now))
            for recs in parts:
                self.log.append_verbatim(recs)
            return len(aggs)
        prod = self._producer
        prod.begin()
        for j, a in zip(events.tolist(), aggs.tolist()):
            prod.send(LogRecord(topic=MIXED_PLANE_TOPIC, key=ids[a],
                                value=buf[j * w:(j + 1) * w],
                                partition=a % PLANE_PARTITIONS))
        prod.commit()
        return len(aggs)

    def round_counts(self, rng) -> np.ndarray:
        """One round's events per log: per partition, random logs with
        events left take their next 1-8 (a 2% tail their next 17-64) while
        the partition's events stay within SAGA_ROUND_BUDGET (the poll's and
        the staleness bound's 4,096)."""
        counts = np.zeros(len(self.ids), np.int64)
        left = self.lengths - self.cursor
        for p in range(PLANE_PARTITIONS):
            mine = np.flatnonzero((left > 0) & (np.arange(len(left)) % PLANE_PARTITIONS == p))
            mine = rng.permutation(mine)[:2000]
            want = rng.integers(1, 9, size=len(mine))
            tail = rng.random(len(mine)) < 0.02
            want[tail] = rng.integers(17, 65, size=int(tail.sum()))
            take = np.minimum(want, left[mine])
            keep = np.cumsum(take) <= SAGA_ROUND_BUDGET
            counts[mine[keep]] = take[keep]
        return counts


async def drive_mixed_plane(card: str, aggregates: int, capacity: int,
                            dispatch: str, seed: int) -> dict:
    """A mixed topic (a quarter of each family) through a plane with the
    combined spec: a seed of each log's first MIXED_SEED_EVENTS events
    through K1, MIXED_PLANE_ROUNDS refresh rounds (spilled aggregates
    re-admit), each window one window-kernel launch; then every aggregate
    read back with read_many against its family's own fold of the events
    appended, byte for byte. Fails on any signal or fallback."""
    import torch

    from surge_tpu_torch.config import Config
    from surge_tpu_torch.models import bank_account, counter, shopping_cart
    from surge_tpu_torch.replay import fold_kernels
    from surge_tpu_torch.replay.engine import ReplayEngine
    from surge_tpu_torch.replay.resident_state import ResidentStatePlane
    from surge_tpu_torch.saga import model as saga

    mixed = mixed_replay()
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    parts = mixed_parts(quarter_scale(aggregates), family_seeds(seed))
    corpus, model, local = mix_corpora(mixed, {m: c for m, (c, _) in parts.items()},
                                       seed=seed + 1)
    mlog = MixedLog(mixed, corpus)
    mlog.append(np.minimum(mlog.lengths, MIXED_SEED_EVENTS), verbatim=True)
    seed_events = int(mlog.cursor.sum())
    log_s = time.perf_counter() - t0
    events = mixed_deserializer(mixed)
    signals: list = []
    ledger = RoundLedger()
    plane = ResidentStatePlane(
        mlog.log, MIXED_PLANE_TOPIC, mixed.spec,
        config=Config(overrides={
            "surge.replay.resident.capacity": capacity,
            "surge.replay.resident.refresh-dispatch": dispatch}),
        deserialize_event=lambda raw: events([raw])[0], deserialize_events=events,
        serialize_state=lambda agg, st: repr(st).encode(),
        derived_cols={"sequence_number": "ordinal"},
        on_signal=lambda name, level: signals.append((name, level)),
        ledger=ledger)
    if plane.engine.tile_backend != "pallas":
        raise AssertionError("the mixed plane's backend did not resolve to the "
                             "kernels")
    reset_launches()
    t0 = time.perf_counter()
    await plane.start()
    start_s = time.perf_counter() - t0
    seed_launches = dict(fold_kernels.LAUNCHES)
    reset_launches()
    key = "ragged" if dispatch == "bucketed" else "dense"
    shapes: list = []
    real = getattr(fold_kernels, f"{key}_window")

    def seen_window(slab, ords, table, words, sides, **kw):
        shapes.append((table.shape[1], kw["width"] if key == "ragged"
                       else words.shape[0], words.shape[0] if key == "ragged" else 0))
        return real(slab, ords, table, words, sides, **kw)

    setattr(fold_kernels, f"{key}_window", seen_window)
    per_round, walls = [], []
    try:
        for r in range(MIXED_PLANE_ROUNDS):
            n0 = len(ledger.rounds)
            mlog.append(mlog.round_counts(rng))
            w0 = time.perf_counter()
            await wait_lag_zero(plane, 300.0)
            walls.append(time.perf_counter() - w0)
            for kw in ledger.rounds[n0:]:
                per_round.append({"round": r, "events": kw["events"],
                                  "lanes": kw["lanes"], "windows": kw["windows"],
                                  "evictions": kw["evictions"],
                                  "round_wall_ms": walls[-1] * 1e3})
    finally:
        setattr(fold_kernels, f"{key}_window", real)
    refresh_launches = dict(fold_kernels.LAUNCHES)
    # every aggregate with events on the log read back, against its
    # family's fold of exactly the events appended (an aggregate with none
    # is not served, and folds to its family's init record)
    logged = np.flatnonzero(mlog.cursor > 0)
    ids = [mlog.ids[i] for i in logged.tolist()]
    t0 = time.perf_counter()
    got = {}
    for lo in range(0, len(ids), 65536):
        got.update(await plane.read_many(ids[lo:lo + 65536]))
    read_s = time.perf_counter() - t0
    await plane.stop()
    if sorted(got) != sorted(ids):
        raise AssertionError(f"read_many served {len(got)} of the {len(ids)} "
                             f"aggregates on the log")
    fields = mixed.spec.registry.state.fields
    rows = {f.name: np.zeros(len(mlog.ids), f.dtype) for f in fields}
    for f in fields:
        rows[f.name][logged] = np.fromiter((getattr(got[a], f.name) for a in ids),
                                           dtype=f.dtype, count=len(ids))
    lengths = np.bincount(corpus.agg_idx, minlength=corpus.num_aggregates)
    pos = np.arange(corpus.num_events) - np.repeat(mlog.starts[:-1], lengths)
    appended = pos < mlog.cursor[corpus.agg_idx]
    mods = {"bank": bank_account, "cart": shopping_cart, "counter": counter,
            "saga": saga}
    own = {}
    for m, (c, _) in parts.items():
        n_local = c.num_aggregates
        lens_local = np.zeros(n_local, np.int64)
        mine = model == m
        lens_local[local[mine]] = mlog.cursor[mine]
        c_starts = np.r_[0, np.cumsum(np.bincount(c.agg_idx, minlength=n_local))]
        keep = (np.arange(c.num_events) - c_starts[c.agg_idx]) < lens_local[c.agg_idx]
        sub = type(c)(num_aggregates=n_local, agg_idx=c.agg_idx[keep],
                      type_ids=c.type_ids[keep],
                      cols={k: v[keep] for k, v in c.cols.items()},
                      derived_cols=dict(c.derived_cols))
        eng = ReplayEngine(mods[m].make_replay_spec(),
                           config=Config(overrides=BENCH_CONFIG))
        own[m] = eng.replay_resident(eng.prepare_resident(sub)).states
    mixed_family_check(f"mixed plane ({dispatch})", mixed, rows, model, local,
                       own, {})
    windows = sum(x["windows"] for x in per_round)
    if signals:
        raise AssertionError(f"the mixed plane signalled {signals}")
    if plane.stats["fallbacks"]:
        raise AssertionError(f"{plane.stats['fallbacks']} mixed reads fell back: "
                             f"{plane.fallback_causes}")
    if plane.stats["evictions"] <= 0:
        raise AssertionError("no mixed round evicted")
    if seed_launches["tile_fold_list"] <= 0 or (seed_launches["dense_window"]
                                                or seed_launches["ragged_window"]):
        raise AssertionError(f"the mixed seed's launches: {seed_launches}")
    if (refresh_launches[f"{key}_window"] != windows or windows <= 0
            or sum(refresh_launches.values()) != windows
            or len(shapes) != windows):
        raise AssertionError(
            f"{windows} mixed refresh windows made {refresh_launches} launches "
            f"({len(shapes)} window calls), not one {key}-window launch each")
    ev = sum(x["events"] for x in per_round)
    row = {"card": card, "dispatch": dispatch, "aggregates": aggregates,
           "capacity": capacity, "log_build_s": log_s,
           "seed_events": seed_events, "appended_events": int(appended.sum()),
           "start_s": start_s, "seed": plane.seed_timing,
           "seed_launches": seed_launches, "refresh_launches": refresh_launches,
           "refresh_windows": windows, "rounds": per_round,
           "refresh_events_per_s": ev / sum(walls),
           "window_shapes": {key: [[*s, shapes.count(s)] for s in sorted(set(shapes))]},
           "read_back_rows_per_s": len(got) / read_s,
           "evictions": plane.stats["evictions"],
           "fallbacks": plane.stats["fallbacks"],
           "device_mem_peak_bytes": torch.cuda.max_memory_allocated()}
    log(f"phase13-plane-{dispatch} " + json.dumps(row))
    return row


def phase_mixed(card: str, checked: set) -> dict:
    """Phase 13: the mixed step's kernel checks, the deployment-scale mixed
    cold replay, the two mixed planes, then each window kernel against its
    plain version at every window shape the mixed planes gave it that no
    earlier check held (lanes_by_path from the kernel's report)."""
    phase_s: dict = {}
    t0 = time.perf_counter()
    kernels = phase_mixed_kernels()
    phase_s["kernels"] = time.perf_counter() - t0
    for r in kernels["windows"]:
        checked.add((r["layout"], r["kind"], r["lanes"], r["width"],
                     r["rows"] if r["kind"] == "ragged" else 0))
    t0 = time.perf_counter()
    replay = phase_mixed_replay(card)
    phase_s["replay"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    planes = {
        "bucketed": asyncio.run(drive_mixed_plane(
            card, MIXED_PLANE_AGGREGATES, MIXED_PLANE_CAPACITY, "bucketed", 61)),
        "dense": asyncio.run(drive_mixed_plane(
            card, MIXED_DENSE_AGGREGATES, MIXED_DENSE_CAPACITY, "dense", 67))}
    phase_s["planes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    shape_rows = check_plane_window_shapes(
        {"ragged": planes["bucketed"]["window_shapes"]["ragged"],
         "dense": planes["dense"]["window_shapes"]["dense"]}, checked, MIXED_LAYOUT)
    phase_s["plane_windows"] = time.perf_counter() - t0
    for p in planes.values():
        p["lanes_by_path"] = {r["case"]: r["lanes_by_path"] for r in shape_rows
                              if r["kind"] == next(iter(p["window_shapes"]))}
    out = {"kernels": kernels, "replay": replay, "planes": planes,
           "plane_window_rows": shape_rows, "phase_s": phase_s}
    log("phase13 " + json.dumps({
        "steady_events_per_sec": replay["steady_events_per_sec"],
        "family_steady_events_per_sec": replay["family_steady_events_per_sec"],
        "list_fold_ms": replay["list_fold_ms"],
        "families_list_fold_ms_sum": replay["families_list_fold_ms_sum"],
        "plane_refresh_events_per_s": {k: p["refresh_events_per_s"]
                                       for k, p in planes.items()},
        "plane_fallbacks": {k: p["fallbacks"] for k, p in planes.items()},
        "plane_lanes_by_path": {k: p["lanes_by_path"] for k, p in planes.items()},
        "phase_s": phase_s}))
    return out


def scan_reduce_line(query: dict, views: dict | None, engine: dict | None) -> dict:
    """The scan-reduce kernel's entry of the ``kernels`` line: its time at
    the head case (the first chunk's all-ops scan), every case's time, bound,
    plain and library time, and its launches on each path of this slice."""
    from surge_tpu_torch.replay.scan_reduce import PASSES

    rows = query["kernel_rows"]
    head = rows[0]
    folds = views["views"]["folds"] if views else {}
    paths = {
        "query_scan_segment": query["scan"]["launches"]["scan_reduce"],
        "query_scan_segment_group_by": query["scan_group_by"]["launches"]["scan_reduce"],
        "query_states_segment": query["states"]["launches"]["scan_reduce"],
        **{f"view_plane_{k}": (folds[k]["launches"] if k in folds else None)
           for k in ("seed", "round", "backfill")},
        **{f"engine_{s}": (engine["launches"][s]["scan_reduce"] if engine else None)
           for s in ENGINE_STAGES},
    }
    # every pass of a call launches once: each pass's launches per path
    passes = {p: {
        "query_scan_segment": query["scan"]["launches"][p],
        "query_scan_segment_group_by": query["scan_group_by"]["launches"][p],
        "query_states_segment": query["states"]["launches"][p],
        **{f"view_plane_{k}": (folds[k]["launches_by_pass"][p] if k in folds else None)
           for k in ("seed", "round", "backfill")},
        **{f"engine_{s}": (engine["launches"][s][p] if engine else None)
           for s in ENGINE_STAGES},
    } for p in PASSES}
    if any(by_path != paths for by_path in passes.values()):
        raise AssertionError(f"scan_reduce: launches by pass {passes}")
    return {
        "name": "scan_reduce", "route": "cuda",
        "source": "surge_tpu_torch/csrc/scan_reduce.cu",
        "replaces": ("no pallas_call: surge_tpu/replay/query.py:549-570 is an "
                     "XLA scatter (the port's own kernel, for a float sum in "
                     "event order)"),
        "launches": total_launches(paths), "launches_by_path": paths,
        "launches_by_pass_by_path": passes,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "timed_at": head["case"],
        "ms_by_case": {r["case"]: r["ms"] for r in rows},
        "bound_ms_by_case": {r["case"]: r["bound_ms"] for r in rows},
        "plain_ms_by_case": {r["case"]: r["plain_ms"] for r in rows},
        "library_ms_by_case": {r["case"]: r["library_ms"] for r in rows},
        "library_equal_by_case": {r["case"]: r["library_equal"] for r in rows},
        "baseline_ms_by_case": {r["case"]: r.get("baseline_ms") for r in rows},
        "serial_floor_ms_by_case": {r["case"]: r["serial_floor_ms"] for r in rows
                                    if "serial_floor_ms" in r},
    }


def total_launches(paths: dict) -> int | None:
    """The launches of the paths that ran in this call; None if none ran."""
    ran = [n for n in paths.values() if n is not None]
    return sum(ran) if ran else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="0,1,2,3,4,5,6,7,8,9,10,11,12,13",
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--baseline", default=None,
                    help="a tree of an earlier commit (unpacked git archive): "
                         "phase 11 times its scan-reduce kernel beside this "
                         "one's on every case")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from surge_tpu_torch import _build
    from surge_tpu_torch.replay import fold_kernels, scan_reduce

    card = card_line()
    log(f"phase0 card: {card}")
    build_s = _build.build_all()
    log(f"phase0 build_s: {json.dumps(build_s)}")
    for name in ("tile_scan", "ragged_fold", "scan_reduce"):
        log(_build.library_path(name).with_suffix(".log").read_text().strip())
    fold_kernels.load()
    scan_reduce.load()

    work = tempfile.mkdtemp(prefix="chip-smoke-")
    try:
        return run_phases(phases, card, work, args.baseline)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_phases(phases: set, card: str, work: str, baseline: str | None = None) -> int:
    import torch

    from surge_tpu_torch.replay import fold_kernels
    from surge_tpu_torch.replay.corpus import synth_counter_corpus

    phase_s: dict = {}
    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now

    corpus = None
    if phases & {1, 2, 5, 7, 9, 11}:
        corpus = synth_counter_corpus(1_000_000, 100_000_000, seed=0)
        lap("corpus")
    windows = klist = nonres = None
    if 1 in phases:
        windows = phase_windows()
        lap("1-windows")
        klist = phase_list_kernel(corpus.events)
        lap("1-list")
        nonres = phase_nonres_windows()
        lap("1-nonres")
    main_rows = []
    if 2 in phases:
        main_rows.append(drive_main_path(corpus, "auto", card))
        main_rows.append(drive_main_path(corpus, "flat", card))
        lap("2")
    families = None
    if 5 in phases:
        families = phase_families(card, corpus)
        lap("5")
    streamed = None
    if 9 in phases:
        streamed = phase_streamed(card, corpus)
        lap("9")
    seg_restore = None
    if 7 in phases:
        seg_restore = phase_restore_segment(card, corpus, work)
        lap("7")
    query = None
    if 11 in phases:
        # phase 7's segment, or the same one written here
        seg_path = (seg_restore["segment_path"] if seg_restore else
                    os.path.join(work, "bench.scol"))
        if seg_restore is None:
            write_bench_segment(corpus, seg_path)
        query = phase_query(card, corpus, seg_path,
                            load_baseline(baseline, work) if baseline else None)
        lap("11-query")
    del corpus
    if 3 in phases:
        phase_resume_and_bank(card)
        lap("3")
    ev_restore = None
    if 8 in phases:
        ev_restore = phase_restore_events(card)
        lap("8")
    nonres_paths = None
    if 10 in phases:
        nonres_paths = phase_nonresident(card)
        lap("10")
    checked = ({(r["layout"], r["kind"], r["lanes"], r["width"],
                 r["rows"] if r["kind"] == "ragged" else 0)
                for r in windows["rows"]} if windows is not None else set())
    plane_rows = []
    plane = None
    if 4 in phases:
        plane = phase_plane(card)
        shapes = {"dense": plane["dense"]["window_shapes"]["dense"],
                  "ragged": plane["main"]["window_shapes"]["ragged"]}
        plane_rows += check_plane_window_shapes(shapes, checked)
    saga_plane = None
    if 6 in phases:
        saga_plane = phase_saga_plane(card)
        plane_rows += check_plane_window_shapes(
            {"ragged": saga_plane["window_shapes"]}, checked, "saga/derived")
    if phases & {4, 6}:
        lap("4,6")
    views = faults = None
    if 11 in phases:
        if plane is None:  # the arm without views runs here, in turns
            plane = phase_plane(card)
        views = phase_views(card, plane.pop("plog"), plane["main"])
        faults = phase_faults(card)
        lap("11-views,faults")
    if plane is not None:
        plane.pop("plog", None)
    engine = None
    if 12 in phases:
        engine = phase_engine(card, work)
        lap("12")
        plane_rows += check_plane_window_shapes(engine["window_shapes"], checked,
                                                engine["window_layout"])
        lap("12-windows")
    mixed = None
    if 13 in phases:
        mixed = phase_mixed(card, checked)
        plane_rows += mixed["kernels"]["windows"] + mixed["plane_window_rows"]
        lap("13")
    if windows is not None:
        windows["rows"].extend(plane_rows)
    log("phase_s " + json.dumps(phase_s))

    if windows is not None:
        # launches on each main path, read right after that path ran with
        # the counts at 0 (None: the path did not run in this call)
        main_p = plane["main"] if plane else None
        dense_p = plane["dense"] if plane else None

        def launches(row, phase, name):
            return row[phase][name] if row else None

        paths = {name: {
            "cold_replay_auto": launches(main_rows[0] if main_rows else None,
                                         "launches", name),
            "cold_replay_flat": launches(main_rows[1] if main_rows else None,
                                         "launches", name),
            **{path: (families["launches"][path][name] if families else None)
               for path in (f"cold_replay_{m}_{a}" for m in ("shopping_cart", "saga")
                            for a in ("auto", "flat", "xla", "assoc")
                            if (m, a) != ("saga", "assoc"))},
            "plane_seed": launches(main_p, "seed_launches", name),
            "plane_refresh": launches(main_p, "refresh_launches", name),
            "plane_dense_seed": launches(dense_p, "seed_launches", name),
            "plane_dense_refresh": launches(dense_p, "refresh_launches", name),
            "saga_plane_seed": launches(saga_plane, "seed_launches", name),
            "saga_plane_refresh": launches(saga_plane, "refresh_launches", name),
            # this slice's paths: the segment restore (wire cache cold and
            # warm), restore_from_events' routes, the streamed replay at each
            # segment count and the non-resident replays
            **{f"restore_segment_{c}": (seg_restore[f"launches_{c}"][name]
                                        if seg_restore else None)
               for c in ("cold", "warm")},
            **{f"restore_events_{r}": (ev_restore["launches"][r][name]
                                       if ev_restore else None)
               for r in ("inmemory", "checkpointed", "spilled")},
            **{f"streamed_{sg}": (streamed["launches"][f"streamed_{sg}"][name]
                                  if streamed else None)
               for sg in STREAM_SEGMENTS},
            **{f"nonresident_{m}": (nonres_paths["launches"][f"nonresident_{m}"][name]
                                    if nonres_paths else None)
               for m in ("counter", "shopping_cart")},
            # this slice's paths: the state query, the view arm's plane
            "query_states_segment": (query["states"]["launches"][name]
                                     if query else None),
            "view_plane_seed": launches(views, "seed_launches", name),
            "view_plane_refresh": launches(views, "refresh_launches", name),
            # this slice's path: the engine (phase 12), stage by stage
            **{f"engine_{s}": (engine["launches"][s][name] if engine else None)
               for s in ENGINE_STAGES},
            # this slice's paths: the mixed cold replay and the mixed planes
            # (phase 13)
            **{f"cold_replay_mixed_{a}": (
                mixed["replay"]["launches"][f"cold_replay_mixed_{a}"][name]
                if mixed else None) for a in ("dense", "flat")},
            **{f"mixed_plane_{k}_{st}": (
                mixed["planes"][k][f"{st}_launches"][name] if mixed else None)
               for k in ("bucketed", "dense") for st in ("seed", "refresh")},
        } for name in fold_kernels.LAUNCHES}
        # each family's layout at the head shapes; the mixed step's too when
        # phase 13 ran
        layouts = dict(MODEL_LAYOUTS, **({"mixed": MIXED_LAYOUT} if mixed else {}))
        kernels = []
        for kind, replaces in (("dense", "surge_tpu/replay/pallas_fold.py:86"),
                               ("ragged", "surge_tpu/replay/pallas_fold.py:170")):
            # the window's line: the plane's layout (counter, derived
            # ordinal) at WINDOW_HEAD's shape, every case's error; each
            # family's time at that shape
            rows = [r for r in windows["rows"] if r["kind"] == kind]
            head = {model: next(r for r in rows
                                if r["case"] == f"{layout} {WINDOW_HEAD[kind]}")
                    for model, layout in layouts.items()}
            kernels.append({
                "name": f"{kind}_window",
                "route": "cuda",
                "source": ("surge_tpu_torch/csrc/tile_scan.cu" if kind == "dense"
                           else "surge_tpu_torch/csrc/ragged_fold.cu"),
                "replaces": replaces,
                "launches": total_launches(paths[f"{kind}_window"]),
                "launches_by_path": paths[f"{kind}_window"],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": head["counter"]["ms"], "plain_ms": head["counter"]["plain_ms"],
                "bound_ms": head["counter"]["bound_ms"],
                "bound_by": head["counter"]["bound_by"],
                "library_ms": None,  # no PyTorch call folds a per-lane sequence
                "timed_at": head["counter"]["case"],
                "lanes_by_path": head["counter"]["lanes_by_path"],
                "ms_by_model": {m: r["ms"] for m, r in head.items()},
                "bound_ms_by_model": {m: r["bound_ms"] for m, r in head.items()},
                "plain_ms_by_model": {m: r["plain_ms"] for m, r in head.items()},
                "lanes_by_path_by_model": {m: r["lanes_by_path"]
                                           for m, r in head.items()},
                "ms_by_shape": {r["case"]: r["ms"] for r in rows if "ms" in r},
            })
        # the list fold's line: one cold replay's work lists on the bench
        # plan (counter, derived ordinal, dense), both launches together;
        # each family's at its phase-5 corpus
        # (the mixed step: its 65,536-aggregate check corpus, dense)
        lists = {"counter": klist["rows"][0], **{
            m: next(r for r in klist["rows"] if r["case"] == f"{m}/derived 1M"
                    and r["source"] == "dense")
            for m in ("shopping_cart", "saga")}}
        nonres_rows = nonres["rows"]
        if mixed:
            lists["mixed"] = next(r for r in mixed["kernels"]["lists"]
                                  if r["source"] == "dense")
            klist["rows"] += mixed["kernels"]["lists"]
            nonres_rows = nonres_rows + mixed["kernels"]["nonres"]
        head = lists["counter"]
        head_nonres = {m: next(r for r in nonres_rows if r["case"] ==
                               f"{layout} w{NONRES_HEAD[0]} bs{NONRES_HEAD[1]}")
                       for m, layout in layouts.items()}
        kernels.insert(1, {
            "name": "tile_fold_list",
            "route": "cuda",
            "source": "surge_tpu_torch/csrc/tile_scan.cu",
            "replaces": "surge_tpu/replay/pallas_fold.py:86",
            "launches": total_launches(paths["tile_fold_list"]),
            "launches_by_path": paths["tile_fold_list"],
            "max_abs_err": max(r["max_abs_err"] for r in klist["rows"] + nonres_rows),
            "ms": head["ms"], "ms_per_launch": head["ms_per_launch"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None,  # no PyTorch call folds a per-lane sequence
            "ms_by_model": {m: r["ms"] for m, r in lists.items()},
            "ms_per_launch_by_model": {m: r["ms_per_launch"] for m, r in lists.items()},
            "bound_ms_by_model": {m: r["bound_ms"] for m, r in lists.items()},
            "plain_ms_by_model": {m: r["plain_ms"] for m, r in lists.items()},
            # the non-resident windows (one launch a window, a one-tile
            # dense list): each family at NONRES_HEAD, every timed shape
            "window_max_abs_err": max(r["max_abs_err"] for r in nonres_rows),
            "window_ms_by_model": {m: head_nonres[m]["ms"] for m in head_nonres},
            "window_bound_ms_by_model": {m: head_nonres[m]["bound_ms"]
                                         for m in head_nonres},
            "window_plain_ms_by_model": {m: head_nonres[m]["plain_ms"]
                                         for m in head_nonres},
            "window_ms_by_shape": {r["case"]: r["ms"] for r in nonres_rows
                                   if "ms" in r},
            "window_bound_ms_by_shape": {r["case"]: r["bound_ms"]
                                         for r in nonres_rows if "ms" in r},
            # the mixed cold replay at deployment scale (phase 13): the list
            # folds' device time per replay, dense and flat, beside the sum
            # of the four families' own folds of the same aggregates
            "mixed_replay": ({
                "aggregates": mixed["replay"]["aggregates"],
                "events": mixed["replay"]["events"],
                "ms": mixed["replay"]["list_fold_ms"],
                "bound_ms": {a: r["bound_ms"]
                             for a, r in mixed["replay"]["arms"].items()},
                "families_ms": {m: f["fold_device_ms"] for m, f in
                                mixed["replay"]["families"].items()},
                "families_ms_sum": mixed["replay"]["families_list_fold_ms_sum"],
            } if mixed else None),
        })
        if query is not None:
            kernels.append(scan_reduce_line(query, views, engine))
        log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))  # the run uses one card, whatever else is visible
    return 0


if __name__ == "__main__":
    sys.exit(main())
