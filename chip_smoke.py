#!/usr/bin/env python3
"""Drive surge_tpu_torch's cold-replay main path on one CUDA card and check it.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA card
and the CUDA toolkit (``nvcc``); it builds the kernels from ``surge_tpu_torch/csrc``
first. Phases:

0. the card's name and power limit, and the kernel build time;
1. each kernel against its plain torch version on the card, byte for byte, at
   the main path's tile shapes, with its time, bound and the plain time;
2. the main path at full size: ``synth_counter_corpus(1M aggregates, 100M
   events)`` through ``ReplayEngine`` under the bench config (batch 8192,
   time-chunk 64, tile-backend auto), ``pack_resident`` → ``upload_resident``
   → ``warm_resident`` → ``replay_resident`` three times, with the layout
   ``auto`` picks and with ``flat``; the states must equal the closed-form
   expected states exactly, and the kernel's launch count must grow;
3. a resumed fold (first half of each log, then the rest from ``init_carry`` and
   ``ordinal_base``) and a bank_account corpus against the plain scan;
4. one JSON line of every kernel's numbers, the card line, and a last line
   ``{"ok": true, "device": {...}}``.

Any failure raises, exits non-zero and prints no result line. Without a CUDA
card it exits with code 2 before doing anything.
"""

from __future__ import annotations

import argparse
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


def device_kernel_ms(fn, calls: int, name: str) -> float | None:
    """Mean device time of the CUDA kernels whose name contains ``name`` over
    ``calls`` calls of ``fn``, from the profiler's CUPTI trace; None when the
    trace holds no such kernel time."""
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


def tile_inputs(spec, wire, width: int, bs: int, seed: int, device):
    """Random kernel inputs: full 32-bit words (corrupt type ids, the 32nd
    bit set), padded slots and negative lens_rel, ordinals near int32 max."""
    import torch

    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(width, bs), dtype=np.uint64)
    words = words.astype(np.uint32).view(np.int32)
    sides = {}
    for f in wire.side_fields:
        if np.dtype(f.dtype) == np.float32:
            col = rng.standard_normal((width, bs)).astype(np.float32)
        else:
            col = rng.integers(-(1 << 31), 1 << 31, size=(width, bs),
                               dtype=np.int64).astype(np.int32)
        sides[f.name] = col
    lens = rng.integers(-width, width + 8, size=bs).astype(np.int32)
    lens[:4] = (-(1 << 29), 0, width, 1)  # sentinel, empty, full, one
    ordr = rng.integers(0, 1 << 31, size=bs, dtype=np.int64).astype(np.int32)
    ordr[:2] = (np.iinfo(np.int32).max, np.iinfo(np.int32).max - width // 2)
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
            {k: to(v) for k, v in sides.items()}, to(lens), to(ordr))


def tile_bytes(spec, wire, width: int, bs: int) -> int:
    """Bytes one launch must move: each input read once, each output written
    once (words, sides, lens, ordinals, carry in and out)."""
    state = sum(np.dtype(f.dtype).itemsize for f in spec.registry.state.fields)
    side = sum(np.dtype(f.dtype).itemsize for f in wire.side_fields)
    return width * bs * (4 + side) + bs * (4 + 4 + 2 * state)


def phase_kernels(width: int, shapes: list[int]) -> dict:
    import torch

    from surge_tpu_torch.replay import fold_kernels

    rows = []
    for label, spec, wire in kernel_cases():
        for bs in shapes:
            args = tile_inputs(spec, wire, width, bs, seed=bs + len(label), device="cuda")
            kw = dict(spec=spec, wire=wire)
            out = fold_kernels.tile_scan(*args, **kw)
            ref = fold_kernels.tile_scan_reference(*args, **kw)
            torch.cuda.synchronize()
            err = 0.0
            for name, v in ref.items():
                got, want = out[name].cpu().numpy(), v.cpu().numpy()
                if got.tobytes() != want.tobytes():
                    raise AssertionError(
                        f"K1 {label} bs={bs}: field {name!r} differs from the "
                        f"plain version at {int(np.flatnonzero(got != want)[0])}")
                err = max(err, float(np.abs(got.astype(np.float64)
                                            - want.astype(np.float64)).max()))
            call_ms = cuda_ms(lambda: fold_kernels.tile_scan(*args, **kw), 15, 20)
            kernel_ms = device_kernel_ms(
                lambda: fold_kernels.tile_scan(*args, **kw), 50, "tile_scan_kernel")
            plain_ms = cuda_ms(
                lambda: fold_kernels.tile_scan_reference(*args, **kw), 3, 1)
            nbytes = tile_bytes(spec, wire, width, bs)
            ops = width * bs * 12  # decode and step: ~a dozen integer ops a slot
            bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            bound_ops_ms = ops / INT32_OPS_PER_S * 1e3
            # ms: the kernel's device time (profiler) where the trace has it,
            # else the per-call time from CUDA events (wrapper included)
            row = {"case": label, "width": width, "bs": bs, "max_abs_err": err,
                   "ms": kernel_ms if kernel_ms is not None else call_ms,
                   "ms_source": "profiler" if kernel_ms is not None else "events",
                   "call_ms": call_ms, "plain_ms": plain_ms, "bytes": nbytes,
                   "bound_ms": max(bound_bytes_ms, bound_ops_ms),
                   "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                                else "operations")}
            rows.append(row)
            log("phase1 " + json.dumps(row))
    return {"rows": rows}


# -- phase 2: the main path -----------------------------------------------------------


def profile_replay(eng, resident) -> dict:
    """One more replay under the profiler (its launches are not counted as the
    main path's): the device's busy share of the replay's wall time and the
    device time by kernel. The profiler's own cost inflates the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.replay_resident(resident)
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, list] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            acc = by_name.setdefault(evt.name, [0.0, 0])
            acc[0] += evt.time_range.elapsed_us()
            acc[1] += 1
    busy_us = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / wall_us if wall_us else None,
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
    fold_kernels.LAUNCHES["tile_scan"] = 0
    eng = ReplayEngine(counter.make_replay_spec(), config=cfg)
    t0 = time.perf_counter()
    wire = eng.pack_resident(corpus.events)
    t1 = time.perf_counter()
    resident = eng.upload_resident(wire)
    t2 = time.perf_counter()
    eng.warm_resident(resident)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    folds = []
    for _ in range(3):
        w0 = eng.stats["windows"]
        f0 = time.perf_counter()
        res = eng.replay_resident(resident)  # ends in the device→host pull
        folds.append(time.perf_counter() - f0)
        tiles = eng.stats["windows"] - w0
        if not (np.array_equal(res.states["count"].astype(np.int64),
                               corpus.expected_count)
                and np.array_equal(res.states["version"],
                                   corpus.expected_version)):
            bad = np.flatnonzero(res.states["count"] != corpus.expected_count)
            raise AssertionError(f"layout {layout}: states differ from the "
                                 f"closed form at {bad[:5]}")
    launches = fold_kernels.LAUNCHES["tile_scan"]
    if eng.tile_backend != "pallas":
        raise AssertionError(f"tile backend resolved to {eng.tile_backend!r}, "
                             "not the kernel")
    if launches <= 0:
        raise AssertionError("the main path launched K1 no time")
    plan = eng._plan_for(resident)
    log("phase2-profile " + json.dumps(dict(profile_replay(eng, resident),
                                            card=card, layout=layout)))
    row = {
        "card": card, "layout": layout,
        "dense": eng._use_dense(resident, plan),
        "aggregates": corpus.num_aggregates, "events": corpus.num_events,
        "events_per_s_best": corpus.num_events / min(folds),
        "events_per_s_median": corpus.num_events / statistics.median(folds),
        "pack_s": t1 - t0, "upload_s": t2 - t1, "warm_s": t3 - t2,
        "fold_s": folds, "pad_ratio": res.padded_events / corpus.num_events,
        "tiles_per_replay": tiles, "k1_launches": launches,
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="0,1,2,3",
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from surge_tpu_torch import _build
    from surge_tpu_torch.config import Config
    from surge_tpu_torch.models import counter
    from surge_tpu_torch.replay import fold_kernels
    from surge_tpu_torch.replay.corpus import synth_counter_corpus
    from surge_tpu_torch.replay.engine import ReplayEngine

    card = card_line()
    log(f"phase0 card: {card}")
    build_s = _build.build_all()
    log(f"phase0 build_s: {json.dumps(build_s)}")
    log(_build.library_path("tile_scan").with_suffix(".log").read_text().strip())
    fold_kernels.load()

    probe = ReplayEngine(counter.make_replay_spec(),
                         config=Config(overrides=BENCH_CONFIG))
    width = probe.resident_tile_width()
    bs_big = probe.batch_size
    bs_small = max(8, bs_big // 8)

    k1 = None
    if 1 in phases:
        k1 = phase_kernels(width, [bs_big, bs_small])
    main_rows = []
    if 2 in phases:
        t0 = time.perf_counter()
        corpus = synth_counter_corpus(1_000_000, 100_000_000, seed=0)
        log(f"phase2 corpus_s: {time.perf_counter() - t0:.3f}")
        main_rows.append(drive_main_path(corpus, "auto", card))
        main_rows.append(drive_main_path(corpus, "flat", card))
        del corpus
    if 3 in phases:
        phase_resume_and_bank(card)

    if k1 is not None:
        # the kernel's line: the bench tile (counter, derived ordinal, bs 8192)
        head = next(r for r in k1["rows"]
                    if r["case"] == "counter/derived" and r["bs"] == bs_big)
        kernels = [{
            "name": "tile_scan",
            "route": "cuda",
            "source": "surge_tpu_torch/csrc/tile_scan.cu",
            "replaces": "surge_tpu/replay/pallas_fold.py:86",
            "launches": main_rows[0]["k1_launches"] if main_rows else 0,
            "max_abs_err": max(r["max_abs_err"] for r in k1["rows"]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None,
        }]
        log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
