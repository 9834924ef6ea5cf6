"""Device-resident materialized state plane — the single-device path of
``surge_tpu/replay/resident_state.py`` in torch.

After a cold-start seed the state slab STAYS on the device, a standing refresh
loop folds each committed batch of the events topic into it incrementally, and
reads are answered by batched device gathers.

- **Slab + directory.** State lives as ``{field: [capacity+1]}`` device
  columns plus an int32 ordinal column (already-folded event count per slot,
  the derived-ordinal base). Row ``capacity`` is a scratch slot that absorbs
  every padded admission and scatter index; it is never gathered. A host-side
  directory maps aggregate id → slot.
- **Refresh round.** Each committed batch is wire-packed on the host
  (surge_tpu_torch.codec.wire) and folded window by window, each window ONE
  call that runs the reference's window program against the slab by slot:
  admission → lane carries → fold → write back → ordinal add. Bucketed plans
  fold through kernel K2 (``fold_kernels.ragged_window``) when the resolved
  tile backend is ``pallas`` (``auto`` on CUDA), window plans through K1's
  dense window (``fold_kernels.dense_window``) or, under an explicit
  ``tile-backend = xla`` or ``assoc``, the plain window around the plain
  torch scan (an ``assoc`` plane seeds through the engine's tree fold; its
  windows take the plain arm, as the reference's do).
- **In place, atomic per window.** Torch updates the slab in place (the
  reference's donated arm; ``surge.replay.donate-refresh = false`` folds into
  a copy published at the group's commit). One plane lock is held around the
  enqueue of a window's call and around the enqueue of every gather, so a
  gather never lands inside a window: it reads each row either before or
  after the window, never torn, and always beside its own ordinal.
- **Admission / eviction, reads, rebalance** follow the reference exactly:
  least-recently-touched rows spill to a host dict at their exact fold point;
  reads coalesce on a gather lane and fall back to the host store when not
  resident or too stale; revoked partitions purge, granted ones re-anchor at 0.
  Reads pull a wide (u32 word) row; the reference's u16 read wire served a
  slow tunnel and is not ported.

Consistency model: every resident or spilled row equals the fold of ALL its
partition's committed events below the partition watermark (mid-round rows of
resident aggregates are folds of committed per-lane prefixes — valid
bounded-stale states).

Hooks, as the reference plane's: materialized views (``attach_views``,
``register_view``; every committed round and the seed fold into them, every
purge drops their partials), the replay profiler (the round's ``refresh``
umbrella, its ``encode``, and a ``compile``/``dispatch`` stage around each
window), the tracer (one ``resident.gather`` span a drained read batch) and
the fault plane (``corrupt.slab-row`` after a round, the
``resident.refresh.dispatch`` point inside each window's executor call);
``tracer`` and ``faults`` are duck-typed. Not carried: the mesh
(ROADMAP.md, Queue 1, "Multi-device"); passing ``mesh`` raises.
"""

from __future__ import annotations

import asyncio
import dataclasses
import functools
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from surge_tpu_torch.codec.tensor import (_EXCLUDED_DEFAULTS, encode_events,
                                          encode_events_columnar)
from surge_tpu_torch.codec.wire import WireFormat, torch_dtype
from surge_tpu_torch.common import (Ack, BackgroundTask, Controllable, logger,
                                    spawn_reaped)
from surge_tpu_torch.config import Config, default_config
from surge_tpu_torch.engine.model import ReplaySpec
from surge_tpu_torch.log.transport import page_keyed_records
from surge_tpu_torch.replay import fold_kernels
from surge_tpu_torch.replay.engine import (ReplayEngine, _resolve_device, _sync,
                                           make_batch_fold)
from surge_tpu_torch.replay.ledger import shard_skew, waste_ratio
from surge_tpu_torch.replay.query import MULTI_DEVICE

__all__ = ["ResidentStatePlane"]



def _pow2(n: int, lo: int = 8) -> int:
    """Next power of two ≥ n (min ``lo``) — the shape bucket every plane
    program runs at."""
    cap = lo
    while cap < n:
        cap *= 2
    return cap


def _pow8(n: int, lo: int = 8) -> int:
    """Next power of EIGHT ≥ n (min ``lo``) — the dense refresh program's
    coarser lane bucket (padding lanes all target the scratch row)."""
    cap = lo
    while cap < n:
        cap *= 8
    return cap


def _device_dtype(dt: np.dtype) -> np.dtype:
    """The dtype a schema column lives in on the device: a 64-bit column as
    its 32-bit kin, as the reference's x64-off JAX canonicalizes it."""
    dt = np.dtype(dt)
    if dt.itemsize <= 4:
        return dt
    return np.dtype(f"{dt.kind}4")


def _with_aggregate_id(state: Any, aggregate_id: str) -> Any:
    """Re-attach the aggregate id to states reconstructed from tensor columns
    (a copy of ``surge_tpu/store/restore.py:_with_aggregate_id``)."""
    if dataclasses.is_dataclass(state) and any(
            f.name == "aggregate_id" for f in dataclasses.fields(state)):
        current = getattr(state, "aggregate_id", None)
        if not current:
            return dataclasses.replace(state, aggregate_id=aggregate_id)
    return state


class ResidentStatePlane(Controllable):
    """Incrementally-maintained KTable over one events topic, on one device.

    ``device=None`` is the CUDA card and raises when there is none (pass
    ``device="cpu"`` to run on the host); the inner seeding ``ReplayEngine``
    gets the same device."""

    def __init__(self, log, events_topic: str, spec: ReplaySpec, *,
                 config: Config | None = None,
                 partitions: Optional[Sequence[int]] = None,
                 deserialize_event: Callable[[bytes], Any],
                 serialize_state: Callable[[str, Any], bytes],
                 deserialize_events: Callable[[Sequence[bytes]], list] | None = None,
                 encode_event: Callable[[Any], Any] | None = None,
                 decode_state: Callable[[str, Any], Any] | None = None,
                 derived_cols: Mapping[str, str] | None = None,
                 mesh=None, metrics=None,
                 on_signal: Callable[[str, str], None] | None = None,
                 profiler=None, flight=None, ledger=None, tracer=None,
                 faults=None, device=None) -> None:
        if mesh is not None:
            raise NotImplementedError(
                f"ResidentStatePlane(..., mesh=...) is not ported yet "
                f"({MULTI_DEVICE})")
        self.log = log
        self.events_topic = events_topic
        self.spec = spec
        self.config = config or default_config()
        self.device = _resolve_device(device)
        self.deserialize_event = deserialize_event
        # one batch deserialize per round when wired (the reference's native
        # feed); a failing batch degrades to the per-event path, which finds
        # and poisons the offending aggregate
        self.deserialize_events = (
            deserialize_events if self.config.get_bool(
                "surge.replay.resident.native-feed", True) else None)
        self.serialize_state = serialize_state
        self.encode_event = encode_event
        self.decode_state = decode_state
        self.derived = dict(derived_cols or {})
        self.metrics = metrics  # duck-typed resident_* instruments, or None
        self.on_signal = on_signal or (lambda name, level: None)
        #: flight recorder (duck-typed ``record(type, **fields)``), or None
        self.flight = flight
        #: refresh-round ledger (duck-typed ``record_round`` /
        #: ``record_evict`` / ``record_gather``), or None
        self.ledger = ledger
        #: replay.profiler.ReplayProfiler, or None (the seeding engine gets
        #: it too)
        self.profiler = profiler
        #: tracer (duck-typed ``start_span``): the gather lane emits
        #: "resident.gather" spans with leg.{coalesce,dispatch,fetch,decode}-ms
        self.tracer = tracer
        #: fault plane (duck-typed ``point`` / ``corrupt_point``): the
        #: "resident.refresh.dispatch" point inside each window's executor
        #: call, and "corrupt.slab-row" after a round
        self._faults = faults

        self.capacity = max(
            self.config.get_int("surge.replay.resident.capacity", 65536), 8)
        self.max_lag = self.config.get_int(
            "surge.replay.resident.max-lag-records", 4096)
        self._max_poll = self.config.get_int(
            "surge.replay.resident.refresh-max-poll-records", 4096)
        self._poll_timeout = max(self.config.get_seconds(
            "surge.replay.resident.refresh-interval-ms", 50), 0.001)
        self._dispatch = self.config.get_str("surge.replay.dispatch", "switch")
        # refresh window width: the time-chunk rounded to a power of two —
        # rounds longer than one window fold through several chained windows
        self._window = _pow2(
            max(self.config.get_int("surge.replay.time-chunk", 512), 8))
        self._refresh_dispatch = self.config.get_str(
            "surge.replay.resident.refresh-dispatch", "bucketed")
        if self._refresh_dispatch not in ("bucketed", "dense"):
            raise ValueError(
                f"unknown surge.replay.resident.refresh-dispatch "
                f"{self._refresh_dispatch!r} (bucketed|dense)")
        self._donate_refresh = self.config.get_bool(
            "surge.replay.donate-refresh", True)
        # the seeding engine on the plane's device; its tile_backend resolves
        # auto (the kernels on CUDA, the plain scan on the CPU) and raises for
        # a spec the kernels cannot fold
        self.engine = ReplayEngine(spec, config=self.config, device=self.device,
                                   profiler=profiler)
        self._backend = self.engine.tile_backend
        # bucketed plans fold through K2 whenever the resolved backend is the
        # kernel (the reference needs an explicit tile-backend = pallas)
        self._ragged = (self._refresh_dispatch == "bucketed"
                        and self._backend == "pallas")
        #: every (lanes_b, width) pair a refresh program may run at
        self.bucket_table = self._build_bucket_table()

        self.partitions: List[int] = sorted(
            partitions if partitions is not None
            else range(log.num_partitions(events_topic)))
        self._watermarks: Dict[int, int] = {}
        self._last_ends: Dict[int, int] = {}
        # anchor generation per partition: bumped by every set_partitions
        # revoke OR grant; a round commits only where the gen is unchanged
        self._anchor_gen: Dict[int, int] = {}
        self._wire = WireFormat(spec.registry, self.derived)
        self._fields = spec.registry.state.fields
        self._dtypes = {f.name: np.dtype(f.dtype) for f in self._fields}
        self._make_state = self._build_state_materializer()
        # a remote (broker) log turns end_offset into a blocking RPC — the
        # read path's freshness check rides the executor there
        self._remote_log = bool(getattr(log, "is_remote", False))

        # host-side bookkeeping
        self._dir: Dict[str, int] = {}          # id -> slot
        self._free: List[int] = list(range(self.capacity))
        self._spill: Dict[str, Tuple[dict, int]] = {}  # id -> (row, ordinal)
        self._agg_part: Dict[str, int] = {}
        self._poisoned: Dict[str, int] = {}     # id -> partition (unfoldable)
        self._lru: Dict[str, int] = {}
        self._tick = 0
        self._warned_poison = False

        # device state (built on first start/seed)
        self._slab: dict | None = None
        self._ords: torch.Tensor | None = None
        self._programs_built = False
        self._signatures: set = set()  # (kind, shape...) — program shapes seen
        #: held around the enqueue of a refresh window's ops and of a gather,
        #: so no gather lands between a window's ops (see the module doc)
        self._dev_lock = threading.Lock()

        # read gather lane
        self._pending: List[Tuple[Any, asyncio.Future]] = []
        self._draining = False
        self._drain_tasks: set = set()

        self._task: Optional[BackgroundTask] = None
        self._running = False
        self._stopped = False  # a STOPPED plane must miss: its freshness view
        #                        (_last_ends) is frozen while the log moves on
        self._seeded = False
        #: MaterializedViews (replay.views) riding this plane's refresh feed,
        #: or None — every committed round folds into the registered views,
        #: and every partition purge drops their partials
        self._views = None
        self.stats = {"rounds": 0, "folded_events": 0, "evictions": 0,
                      "gathers": 0, "gathered_rows": 0, "fallbacks": 0}
        #: seconds of the last cold-start seed, by phase
        self.seed_timing: Dict[str, float] = {}
        #: why reads fell back, cumulatively ({cause: n})
        self.fallback_causes: Dict[str, int] = {}
        self._round_causes: Dict[str, int] = {}  # deltas since last round
        self._round_acc: Dict[str, Any] = self._fresh_round_acc()
        self._pending_t0: Optional[float] = None  # gather coalesce-wait start

    @staticmethod
    def _fresh_round_acc() -> Dict[str, Any]:
        return {"windows": 0, "dispatched": 0, "occupied": 0,
                "dispatch_s": 0.0, "lanes": 0, "batch": 0, "width": 0,
                "evictions": 0, "programs": 0, "lane_slots": 0, "buckets": []}

    def _build_bucket_table(self) -> frozenset:
        """Every (lane bucket, window width) a refresh program may be shaped
        at for this capacity/window layout — O(log capacity × log window)."""
        lanes, cap = [], 8
        top = _pow2(self.capacity)
        while cap <= top:
            lanes.append(cap)
            cap *= 2
        widths, w = [], 2
        while w <= self._window:
            widths.append(w)
            w *= 2
        return frozenset((lb, wb) for lb in lanes for wb in widths)

    def _build_state_materializer(self):
        """Precompiled row → domain-state constructor (``from_record`` +
        aggregate-id reattach + ``decode_state`` with the per-field dispatch
        hoisted out of the per-row loop): the gather lane hands it plain
        Python scalars off one ``ndarray.tolist()`` per column."""
        cls = self.spec.registry.state.cls
        names = [f.name for f in self._fields]
        extras: Dict[str, Any] = {}
        has_agg_id = False
        if dataclasses.is_dataclass(cls):
            for f in dataclasses.fields(cls):
                if f.name == "aggregate_id":
                    has_agg_id = True
                    continue
                if (f.name in names
                        or f.default is not dataclasses.MISSING
                        or f.default_factory is not dataclasses.MISSING):  # type: ignore[misc]
                    continue
                ann = (f.type if isinstance(f.type, type)
                       else {"str": str, "int": int, "float": float,
                             "bool": bool}.get(str(f.type)))
                extras[f.name] = _EXCLUDED_DEFAULTS.get(ann, None)
        decode = self.decode_state
        # one keyword call per row indexing straight into the tolist'd
        # columns (field names are dataclass identifiers)
        parts = (["aggregate_id=a"] if has_agg_id else [])
        parts += [f"{n}=c[{i}][j]" for i, n in enumerate(names)]
        parts += [f"{n}=_extras[{n!r}]" for n in extras]
        base = eval(  # noqa: S307 — names come from dataclass fields
            f"lambda a, c, j: _cls({', '.join(parts)})",
            {"_cls": cls, "_extras": extras})
        if decode is None:
            return base
        return lambda agg_id, c, j: decode(agg_id, base(agg_id, c, j))

    def _states_of_batch(self, ids: Sequence[str],
                         rows: Mapping[str, np.ndarray], k: int) -> list:
        """Materialize ``k`` gathered rows into domain states."""
        cols = [rows[f.name][:k].tolist() for f in self._fields]
        make = self._make_state
        return [make(agg, cols, j) for j, agg in enumerate(ids)]

    # -- device state -------------------------------------------------------------------

    def _ensure_device_state(self) -> None:
        if self._slab is not None:
            return
        self._build_programs()
        init = self.spec.init_state_tree()
        cap1 = self.capacity + 1  # +1: the scratch row
        self._slab = {
            f.name: torch.full((cap1,), init[f.name].item(),
                               dtype=torch_dtype(self._dev_dts[f.name]),
                               device=self.device)
            for f in self._fields}
        self._ords = torch.zeros((cap1,), dtype=torch.int32, device=self.device)

    def _build_programs(self) -> None:
        if self._programs_built:
            return
        names = [f.name for f in self._fields]
        # the device dtypes, not the schema's: a 64-bit schema column lives
        # on the device as its 32-bit kin, and the host decode widens back
        self._dev_dts = {n: _device_dtype(self._dtypes[n]) for n in names}
        # u32 words per gathered field row
        self._wide_words = [max(self._dev_dts[n].itemsize // 4, 1)
                            for n in names]
        self._fold = make_batch_fold(self.spec, dispatch=self._dispatch)
        # a fetch on the card waits for every window enqueued before it, so
        # the gather lane's fetch runs in the executor there; on the host it
        # is a memcpy and the executor hop would cost more than the fetch
        self._fetch_off_loop = self.device.type == "cuda"
        self._programs_built = True

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array onto the plane's device, without waiting for the
        stream (the copy is staged; later ops on the stream see it)."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            self.device, non_blocking=True)

    def _gather_wide(self, slab, ords, idx: torch.Tensor):
        """Gathered rows as u32 words (int32 bit patterns) ``[n_words, k]``
        plus the rows' ordinals (zeros when ``ords`` is None). Enqueue only."""
        cols = []
        for f in self._fields:
            v = slab[f.name].index_select(0, idx)
            if v.dtype in (torch.float16, torch.bfloat16):
                v = v.to(torch.float32).view(torch.int32)
            elif v.dtype == torch.float32:
                v = v.view(torch.int32)
            elif v.dtype != torch.int32:
                v = v.to(torch.int32)
            cols.append(v)
        o = (ords.index_select(0, idx) if ords is not None
             else torch.zeros_like(idx, dtype=torch.int32))
        return torch.stack(cols), o

    def _check_gather_index(self, idx: np.ndarray) -> None:
        """No gather of the plane slab may read the scratch row: padded
        admissions and scatters write it with duplicate indices, whose
        winner is unspecified on CUDA."""
        if (np.asarray(idx) == self.capacity).any():
            raise RuntimeError("a gather of the resident slab would read the "
                               f"scratch row {self.capacity}")

    def _enqueue_gather(self, slab, positions, k_b: int, pad: int):
        """Enqueue one gather of ``positions`` (padded to ``k_b`` with the
        row ``pad``). ``slab=None`` gathers the LIVE slab and its ordinals
        under the plane lock, so each (row, ordinal) pair is one window
        version; another slab (the seed's) gathers with zero ordinals."""
        idx = np.full((k_b,), pad, dtype=np.int64)
        idx[:len(positions)] = positions
        live = slab is None
        if live:
            self._check_gather_index(idx)
        idx_d = self._upload(idx)
        with self._dev_lock:
            if live:
                return self._gather_wide(self._slab, self._ords, idx_d)
            return self._gather_wide(slab, None, idx_d)

    @staticmethod
    def _fetch(mat: torch.Tensor, o: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        """The fetch barrier: device words and ordinals to the host."""
        return mat.cpu().numpy().view(np.uint32), o.cpu().numpy()

    async def _fetch_async(self, mat: torch.Tensor, o: torch.Tensor):
        """``_fetch`` from the loop: in the executor on the card, where it
        waits for every window enqueued before it."""
        if self._fetch_off_loop:
            return await asyncio.get_running_loop().run_in_executor(
                None, self._fetch, mat, o)
        return self._fetch(mat, o)

    def _seed_scatter(self, src_slab, src_pos: np.ndarray, dst: np.ndarray,
                      lens: np.ndarray) -> None:
        """Rows ``src_pos`` of ``src_slab`` into plane slots ``dst`` with
        ordinals ``lens`` (padding targets the scratch row)."""
        pos_d = self._upload(src_pos.astype(np.int64))
        dst_d = self._upload(dst.astype(np.int64))
        lens_d = self._upload(lens.astype(np.int32))
        with self._dev_lock:
            for k, v in self._slab.items():
                v.index_copy_(0, dst_d, src_slab[k].index_select(0, pos_d).to(v.dtype))
            self._ords.index_copy_(0, dst_d, lens_d)

    # -- lifecycle (Controllable) -------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._running

    async def start(self) -> Ack:
        if self._running:
            return Ack()
        self._ensure_device_state()
        if not self._seeded:
            # the cold-start replay: heavy host-side scan/pack runs off the
            # event loop; the folded slab never leaves the device
            await asyncio.get_running_loop().run_in_executor(
                None, self.seed_from_log)
        self._task = BackgroundTask(self._refresh_loop, "resident-refresh")
        self._task.start()
        self._running = True
        self._stopped = False
        return Ack()

    async def stop(self) -> Ack:
        self._running = False
        self._stopped = True
        if self._task is not None:
            await self._task.stop()
            self._task = None
        # fail pending reads over to the host path promptly
        pending, self._pending = self._pending, []
        for target, fut in pending:
            if not fut.done():
                fut.set_result((False, None) if isinstance(target, str)
                               else {})
        return Ack()

    # -- seeding ------------------------------------------------------------------------

    def seed_from_log(self) -> None:
        """Cold-start seed: replay the assigned partitions' events through the
        engine's resident path (``pack_resident`` → ``upload_resident`` →
        ``fold_resident_slab``, kernel K1 on the card) and gather the folded
        rows straight into the plane slab on the device. Watermarks anchor at
        the pre-captured end offsets. Aggregates beyond ``capacity`` (admitted
        longest-log-first) are pulled once and spilled.

        Runs in the executor (``start`` keeps the loop free), so a rebalance
        landing mid-seed is reconciled after the fact: any partition whose
        anchor generation moved while the seed flew is purged and
        de-anchored."""
        self._ensure_device_state()
        gens = {p: self._anchor_gen.get(p, 0) for p in self.partitions}
        ends = {p: self.log.end_offset(self.events_topic, p) for p in gens}
        try:
            self._seed_scan_fold(ends)
        finally:
            for p in ends:
                if (p not in self.partitions
                        or self._anchor_gen.get(p, 0) != gens.get(p, 0)):
                    self._purge_partition(p)
                    self._watermarks.pop(p, None)
        if self.flight is not None:
            self.flight.record("resident.seed",
                               partitions=sorted(ends),
                               resident=len(self._dir),
                               spilled=len(self._spill))

    def _seed_scan_fold(self, ends: Dict[int, int]) -> None:
        timing = self.seed_timing = {}
        t0 = time.perf_counter()
        logs: Dict[str, list] = {}
        part_of: Dict[str, int] = {}
        for p in ends:
            for rec in page_keyed_records(self.log, self.events_topic, p,
                                          upto=ends[p]):
                ev = self._encode_checked(rec.key, rec.value, p)
                if ev is None:
                    logs.pop(rec.key, None)
                    continue
                logs.setdefault(rec.key, []).append(ev)
                part_of[rec.key] = p
        self._watermarks.update(ends)
        self._seeded = True
        timing["scan_s"] = time.perf_counter() - t0
        if self._views is not None and self._views.active_or_pending:
            # the seed IS round zero for every registered view: fold the same
            # scanned logs, anchored at the same end offsets (pending views
            # activate here); seed_from_log's purge reconciles partitions
            # re-anchored mid-seed, their view partials included
            t0 = time.perf_counter()
            self._views.fold_round(logs, part_of, dict(ends),
                                   activate_pending=True)
            timing["views_s"] = time.perf_counter() - t0
        if not logs:
            self._record_gauges()
            return
        # longest logs first: they are the expensive-to-refold rows, keep them
        t0 = time.perf_counter()
        ids = sorted(logs, key=lambda a: len(logs[a]), reverse=True)
        lengths = np.asarray([len(logs[a]) for a in ids], dtype=np.int32)
        colev = encode_events_columnar(self.spec.registry,
                                       [logs[a] for a in ids])
        colev.derived_cols = dict(self.derived)
        timing["encode_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        wire = self.engine.pack_resident(colev)
        timing["pack_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        corpus = self.engine.upload_resident(wire)
        corpus.cache["oneshot"] = True  # folded exactly once
        timing["upload_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        slab_sorted, _ = self.engine.fold_resident_slab(corpus)
        _sync(self.device)
        timing["fold_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # sorted position of original aggregate i: inv[i]
        b = len(ids)
        if corpus.perm is None:
            inv = np.arange(b, dtype=np.int32)
        else:
            inv = np.empty((b,), dtype=np.int32)
            inv[corpus.perm] = np.arange(b, dtype=np.int32)
        n_res = min(b, self.capacity)
        dst = np.fromiter((self._free.pop() for _ in range(n_res)),
                          dtype=np.int32, count=n_res)
        k_b = _pow2(n_res)
        src_p = np.zeros((k_b,), dtype=np.int32)
        src_p[:n_res] = inv[:n_res]
        dst_p = np.full((k_b,), self.capacity, dtype=np.int32)
        dst_p[:n_res] = dst
        lens_p = np.zeros((k_b,), dtype=np.int32)
        lens_p[:n_res] = lengths[:n_res]
        self._seed_scatter(slab_sorted, src_p, dst_p, lens_p)
        _sync(self.device)
        timing["scatter_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for j, agg in enumerate(ids[:n_res]):
            self._dir[agg] = int(dst[j])
            self._agg_part[agg] = part_of[agg]
            self._touch(agg)
        if b > n_res:
            # overflow: one pull of the cold rows into the host spill
            rows, _ = self._pull_positions(slab_sorted, inv[n_res:])
            for j, agg in enumerate(ids[n_res:]):
                self._spill[agg] = ({k: rows[k][j] for k in rows},
                                    int(lengths[n_res + j]))
                self._agg_part[agg] = part_of[agg]
        timing["spill_s"] = time.perf_counter() - t0
        timing["aggregates"] = b
        timing["events"] = int(lengths.sum())

    def _seed_from_host_rows(self, ids, states, lengths, part_of) -> None:
        """Admit host-side state columns into the slab (resident up to
        capacity, the rest spilled)."""
        n_res = min(len(ids), self.capacity)
        dst = np.fromiter((self._free.pop() for _ in range(n_res)),
                          dtype=np.int32, count=n_res)
        k_b = _pow2(max(n_res, 1))
        dst_p = np.full((k_b,), self.capacity, dtype=np.int32)
        dst_p[:n_res] = dst
        vals = {}
        for k in states:
            col = np.zeros((k_b,), dtype=self._dev_dts[k])
            col[:n_res] = states[k][:n_res]
            vals[k] = self._upload(col)
        lens_p = np.zeros((k_b,), dtype=np.int32)
        lens_p[:n_res] = lengths[:n_res]
        self._seed_scatter(vals, np.arange(k_b, dtype=np.int32), dst_p, lens_p)
        for j, agg in enumerate(ids[:n_res]):
            self._dir[agg] = int(dst[j])
            self._agg_part[agg] = part_of[agg]
            self._touch(agg)
        for j, agg in enumerate(ids[n_res:]):
            self._spill[agg] = ({k: states[k][n_res + j] for k in states},
                                int(lengths[n_res + j]))
            self._agg_part[agg] = part_of[agg]

    # -- consistency audit surface ------------------------------------------------------

    def audit_pull(self, agg_ids: Sequence[str]) -> Dict[str, tuple]:
        """ONE gather of the LIVE slab rows + fold ordinals for the given
        aggregates. The rows and ordinals are gathered in one enqueue under
        the plane lock, so each (row, ordinal) pair is atomic w.r.t. refresh
        windows: a row is always the fold of exactly its ordinal's event
        prefix. Aggregates not resident are omitted; returns
        ``{agg: ({field: scalar}, ordinal)}``."""
        ids = [a for a in agg_ids if a in self._dir]
        if not ids:
            return {}
        idx = np.fromiter((self._dir[a] for a in ids), dtype=np.int32,
                          count=len(ids))
        rows, ords = self._pull_positions(None, idx)
        return {a: ({k: rows[k][j] for k in rows}, int(ords[j]))
                for j, a in enumerate(ids)}

    def shadow_replay_rows(self, event_logs: List[list]
                           ) -> Dict[str, np.ndarray]:
        """Re-fold per-aggregate event lists FROM SCRATCH through the seed's
        fold (``pack_resident`` → ``fold_resident_slab``) and pull the folded
        rows to host. Pure w.r.t. plane state. Returns ``{field: np[b]}`` in
        ``event_logs`` order."""
        b = len(event_logs)
        colev = encode_events_columnar(self.spec.registry, event_logs)
        colev.derived_cols = dict(self.derived)
        wire = self.engine.pack_resident(colev)
        corpus = self.engine.upload_resident(wire)
        corpus.cache["oneshot"] = True  # folded exactly once
        slab_sorted, _ = self.engine.fold_resident_slab(corpus)
        if corpus.perm is None:
            inv = np.arange(b, dtype=np.int32)
        else:
            inv = np.empty((b,), dtype=np.int32)
            inv[corpus.perm] = np.arange(b, dtype=np.int32)
        rows, _ = self._pull_positions(slab_sorted, inv)
        return rows

    def _corrupt_resident_row(self) -> Optional[str]:
        """Flip one bit in one LIVE resident slab row (the armed
        ``corrupt.slab-row`` fault firing): the first non-bool field of the
        first resident aggregate gets its top byte's sign bit flipped (a
        bool field would be negated), and the row's fold ordinal is kept, so
        it looks like a validly-folded row. Returns the corrupted aggregate
        id, or None when nothing is resident."""
        if not self._dir:
            return None
        agg = next(iter(self._dir))
        slot = self._dir[agg]
        rows, ords = self._pull_positions(None, np.asarray([slot], dtype=np.int32))
        victim = next((f.name for f in self._fields
                       if f.dtype != np.bool_), self._fields[0].name)
        vals = {}
        for k in rows:
            v = np.asarray(rows[k][:1], dtype=self._dev_dts[k]).copy()
            if k == victim:
                if v.dtype == np.bool_:
                    v[0] = not v[0]
                else:
                    v.view(np.uint8)[-1] ^= 0x80
            vals[k] = self._upload(v)
        self._seed_scatter(vals, np.zeros((1,), dtype=np.int32),
                           np.asarray([slot], dtype=np.int32),
                           np.asarray([int(ords[0])], dtype=np.int32))
        logger.warning("fault plane corrupted resident row of %r "
                       "(field %s)", agg, victim)
        return agg

    def prime(self, watermarks: Dict[int, int]) -> None:
        """Fast-forward fold watermarks after an out-of-band seed covered the
        offsets (only valid together with a slab seed of the same
        coverage)."""
        for p, off in watermarks.items():
            if p in self._watermarks:
                self._watermarks[p] = max(self._watermarks[p], off)

    # -- rebalance ----------------------------------------------------------------------

    def set_partitions(self, partitions: Sequence[int]) -> None:
        """Retarget the assigned partitions. Revoked partitions purge their
        aggregates — resident rows, spill and poison marks. Granted
        partitions re-anchor at offset 0: the refresh loop refolds the whole
        partition, so a revoke→re-grant cycle can never double-fold."""
        new = sorted(set(partitions))
        if new == self.partitions:
            return
        removed = [p for p in self.partitions if p not in new]
        added = [p for p in new if p not in self.partitions]
        self.partitions = new
        for p in removed:
            self._watermarks.pop(p, None)
            self._anchor_gen[p] = self._anchor_gen.get(p, 0) + 1
            self._purge_partition(p)
        for p in added:
            self._purge_partition(p)  # defensive: must never double-fold
            self._watermarks[p] = 0
            self._anchor_gen[p] = self._anchor_gen.get(p, 0) + 1
        if self.flight is not None:
            self.flight.record("resident.re-anchor", granted=added,
                               revoked=removed, resident=len(self._dir))
        self._record_gauges()

    # -- materialized views (replay.views) ----------------------------------------------

    def attach_views(self, views) -> None:
        """Hand the plane a :class:`~surge_tpu_torch.replay.views.MaterializedViews`:
        every committed refresh round (and the seed) folds into it, and every
        re-anchor path drops its per-partition partials."""
        self._views = views

    def register_view(self, vdef) -> None:
        """Register a view against this plane's feed. Before the seed it
        activates (the seed fold covers it from offset 0); on a seeded plane
        it parks PENDING and the refresh loop backfills the already-folded
        prefix between rounds."""
        if self._views is None:
            raise RuntimeError(
                "no MaterializedViews attached to this resident plane")
        self._views.register(vdef, active=not self._seeded)

    def _backfill_pending_views(self) -> None:
        """Executor half of register-while-running: re-read each assigned
        partition's committed prefix [0, watermark) and fold it into every
        pending view. Runs between refresh rounds; partitions whose anchor
        generation moved meanwhile are dropped from the commit."""
        views = self._views
        gens = {p: self._anchor_gen.get(p, 0) for p in self.partitions}
        wms = {p: self._watermarks.get(p, 0) for p in gens}
        logs: Dict[str, list] = {}
        part_of: Dict[str, int] = {}
        for p, wm in wms.items():
            if wm <= 0:
                continue
            for rec in page_keyed_records(self.log, self.events_topic, p,
                                          upto=wm):
                ev = self._encode_checked(rec.key, rec.value, p)
                if ev is None:
                    logs.pop(rec.key, None)
                    continue
                logs.setdefault(rec.key, []).append(ev)
                part_of[rec.key] = p
        committed = {p: wm for p, wm in wms.items()
                     if p in self._watermarks
                     and self._anchor_gen.get(p, 0) == gens[p]}
        for name in [v["view"] for v in views.summary() if not v["active"]]:
            views.fold_view_backfill(name, logs, part_of, committed)

    def _purge_partition(self, p: int) -> None:
        if self._views is not None:
            self._views.drop_partition(p)
        for agg in [a for a, ap in self._agg_part.items() if ap == p]:
            slot = self._dir.pop(agg, None)
            if slot is not None:
                self._free.append(slot)
            self._spill.pop(agg, None)
            self._lru.pop(agg, None)
            self._agg_part.pop(agg, None)
        for agg in [a for a, ap in self._poisoned.items() if ap == p]:
            self._poisoned.pop(agg, None)

    # -- refresh loop -------------------------------------------------------------------

    async def _refresh_loop(self) -> None:
        backoff = 0.25
        while True:
            try:
                t0 = time.perf_counter()
                if await self._refresh_once():
                    backoff = 0.25
                    # pace the loop: at most one fold round per refresh
                    # interval (the interval is the plane's staleness cadence)
                    spent = time.perf_counter() - t0
                    if spent < self._poll_timeout:
                        await asyncio.sleep(self._poll_timeout - spent)
                    continue
                await self._wait_for_any_append()
                backoff = 0.25
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — keep the plane alive
                logger.exception("resident refresh round failed; retrying "
                                 "in %.2fs", backoff)
                try:
                    self.on_signal("surge.replay.resident.refresh-error",
                                   "error")
                except Exception:  # noqa: BLE001
                    logger.exception("on_signal failed")
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 30.0)

    async def _wait_for_any_append(self) -> None:
        if not self.partitions:
            await asyncio.sleep(self._poll_timeout)
            return
        waiters = [asyncio.ensure_future(
            self.log.wait_for_append(self.events_topic, p,
                                     self._watermarks.get(p, 0)))
            for p in self.partitions]
        try:
            await asyncio.wait(waiters, timeout=self._poll_timeout,
                               return_when=asyncio.FIRST_COMPLETED)
        finally:
            for w in waiters:
                if not w.done():
                    w.cancel()
                else:
                    w.exception()  # retrieve, avoid un-awaited warnings

    def _poll_batches(self, watermarks: Dict[int, int]):
        """Executor half of the poll: read each partition's committed tail
        past its watermark. Returns ``(batches, ends)``."""
        batches: Dict[int, list] = {}
        ends: Dict[int, int] = {}
        for p, wm in watermarks.items():
            recs = self.log.read(self.events_topic, p, wm,
                                 max_records=self._max_poll)
            if recs:
                batches[p] = recs
                ends[p] = recs[-1].offset + 1
            else:
                ends[p] = self.log.end_offset(self.events_topic, p)
        return batches, ends

    async def _refresh_once(self) -> bool:
        """One refresh round: read each partition's committed tail, fold it
        into the slab (admitting/evicting as needed), advance watermarks.
        Returns False when nothing was pending."""
        loop = asyncio.get_running_loop()
        if self._views is not None and self._views.has_pending:
            # register-while-running: backfill the committed prefix into the
            # pending views BETWEEN rounds (the loop awaits; no fold races)
            await loop.run_in_executor(None, self._backfill_pending_views)
        wms = {p: self._watermarks.setdefault(p, 0)
               for p in list(self.partitions)}
        gens = {p: self._anchor_gen.get(p, 0) for p in wms}
        feed_t0 = time.perf_counter()
        batches, ends = await loop.run_in_executor(
            None, self._poll_batches, wms)
        self._last_ends = ends
        for p, end in ends.items():
            if (p in batches or p not in self._watermarks
                    or self._anchor_gen.get(p, 0) != gens[p]):
                continue
            if end > self._watermarks[p]:
                # compaction hole at the tail: fast-forward like the indexer
                self._watermarks[p] = end
        if not batches:
            self._record_gauges()
            return False
        t0 = time.perf_counter()
        self._round_acc = self._fresh_round_acc()
        # deserialize + encode run off the event loop
        logs, part_of, n_events, poisons = await loop.run_in_executor(
            None, self._decode_batches, batches)
        feed_s = time.perf_counter() - feed_t0
        if self.metrics is not None:
            self.metrics.resident_feed_timer.record_ms(feed_s * 1000.0)
        for agg, p in poisons.items():
            self._poison(agg, p)
        enc_s = time.perf_counter() - t0
        ids = list(logs)
        try:
            for lo in range(0, len(ids), self.capacity):
                group = ids[lo: lo + self.capacity]
                await self._fold_group(group, logs, part_of, gens)
        except Exception:
            # a mid-round failure leaves the groups committed so far folded
            # past the round's (un-advanced) watermarks, and a window that
            # failed part way leaves its lanes' rows partly written in place.
            # Re-anchor every polled partition through the re-grant path
            # (purge + watermark 0 + gen bump): every lane the round touched
            # is purged and refolds from scratch, never double-folded.
            for p in batches:
                if (p in self._watermarks
                        and self._anchor_gen.get(p, 0) == gens.get(p, 0)):
                    self._purge_partition(p)
                    self._watermarks[p] = 0
                    self._anchor_gen[p] = self._anchor_gen.get(p, 0) + 1
            raise
        committed: Dict[int, int] = {}
        for p, recs in batches.items():
            # skip partitions revoked OR re-anchored while the round flew
            if (p in self._watermarks
                    and self._anchor_gen.get(p, 0) == gens[p]):
                self._watermarks[p] = recs[-1].offset + 1
                committed[p] = recs[-1].offset + 1
        if (self._views is not None and committed
                and self._views.active_or_pending):
            # the views' leg of the round rides the same decoded logs, under
            # the same gen fence the slab commit just passed, off the loop;
            # fold_round never raises (a failing view degrades alone)
            await loop.run_in_executor(
                None, self._views.fold_round, logs, part_of, committed)
        elapsed = time.perf_counter() - t0
        self.stats["rounds"] += 1
        self.stats["folded_events"] += n_events
        if self.metrics is not None:
            self.metrics.resident_fold_round_timer.record_ms(elapsed * 1000.0)
        if self.profiler is not None:
            # encode (the host decode and pack) reported separately; the
            # umbrella `refresh` covers the round, its measured legs as
            # attributes
            self.profiler.record("encode", enc_s, kind="refresh")
            self.profiler.record(
                "refresh", elapsed, events=n_events, aggregates=len(ids),
                **{"leg.decode-ms": round(feed_s * 1000.0, 3),
                   "leg.dispatch-ms": round(
                       self._round_acc["dispatch_s"] * 1000.0, 3)})
        self._observe_round(n_events, feed_s, enc_s)
        self._record_gauges()
        if (self._faults is not None
                and self._faults.corrupt_point("corrupt.slab-row")):
            # rot one live row AFTER the round committed: the log stays
            # right, the slab lies (what only the shadow-replay audit sees)
            corrupted = self._corrupt_resident_row()
            if corrupted is not None and self.flight is not None:
                self.flight.record("fault.corrupt", site="corrupt.slab-row",
                                   aggregate=corrupted)
        return True

    def _observe_round(self, n_events: int, feed_s: float,
                       enc_s: float) -> None:
        """Round close: the padding-waste gauges off the round's slot
        accounting and the ledger's ``round`` event."""
        acc = self._round_acc
        dispatched, occupied = acc["dispatched"], acc["occupied"]
        waste = waste_ratio(dispatched, occupied)
        dispatch_us = acc["dispatch_s"] * 1e6
        lane_slots = acc["lane_slots"]
        if self.metrics is not None:
            m = self.metrics
            m.resident_round_events.record(n_events)
            m.resident_padding_waste_ratio.record(waste)
            m.resident_dispatch_occupancy.record(
                occupied / dispatched if dispatched else 0.0)
            m.resident_events_per_dispatch_us.record(
                n_events / dispatch_us if dispatch_us > 0 else 0.0)
            m.resident_shard_skew.record(shard_skew(None))
            m.resident_bucket_dispatches.record(acc["programs"])
            m.resident_bucket_fill_ratio.record(
                acc["lanes"] / lane_slots if lane_slots else 0.0)
        if self.ledger is not None:
            causes, self._round_causes = self._round_causes, {}
            self.ledger.record_round(
                events=n_events, lanes=acc["lanes"], windows=acc["windows"],
                dispatched=dispatched, occupied=occupied,
                batch=acc["batch"], width=acc["width"],
                feed_us=feed_s * 1e6, encode_us=enc_s * 1e6,
                dispatch_us=dispatch_us, deal_sizes=None,
                causes=causes or None, evictions=acc["evictions"],
                buckets=acc["buckets"] or None,
                bucket_table=len(self.bucket_table))

    def _decode_batches(self, batches: Dict[int, list]):
        """Executor half of a refresh round: deserialize + encode every
        record, grouping events per aggregate. Pure w.r.t. plane state —
        poison candidates are RETURNED (``{agg: partition}``) and applied on
        the loop."""
        logs: Dict[str, list] = {}
        part_of: Dict[str, int] = {}
        n_events = 0
        poisons: Dict[str, int] = {}
        poisoned = self._poisoned
        batch_decode = self.deserialize_events
        for p, recs in batches.items():
            pend = []
            for r in recs:
                key = r.key
                if (key is None or r.value is None or key in poisoned
                        or key in poisons):
                    continue
                pend.append((key, r.value))
            if not pend:
                continue
            events = None
            if batch_decode is not None:
                try:
                    events = batch_decode([v for _k, v in pend])
                    if len(events) != len(pend):
                        events = None  # a misbehaving custom batch decoder
                except Exception:  # noqa: BLE001 — per-event path poisons
                    events = None
            if events is not None:
                encode = self.encode_event
                schema_for = self.spec.registry.schema_for_cls
                for (key, _raw), ev in zip(pend, events):
                    if key in poisons:
                        continue
                    try:
                        if encode is not None:
                            ev = encode(ev)
                        schema_for(type(ev))
                    except Exception:  # noqa: BLE001 — per-agg degradation
                        poisons[key] = p
                        logs.pop(key, None)
                        continue
                    logs.setdefault(key, []).append(ev)
                    part_of[key] = p
                    n_events += 1
                continue
            for key, raw in pend:
                if key in poisons:
                    continue
                try:
                    ev = self._encode_event(raw)
                except Exception:  # noqa: BLE001 — per-aggregate degradation
                    poisons[key] = p
                    logs.pop(key, None)
                    continue
                logs.setdefault(key, []).append(ev)
                part_of[key] = p
                n_events += 1
        return logs, part_of, n_events, poisons

    def _encode_event(self, raw: bytes) -> Any:
        """Deserialize + producer-encode one record and check its type rides
        the replay schema; raises when it can't (callers poison the
        aggregate)."""
        ev = self.deserialize_event(raw)
        if self.encode_event is not None:
            ev = self.encode_event(ev)
        self.spec.registry.schema_for_cls(type(ev))
        return ev

    def _encode_checked(self, agg_id: str, raw: bytes,
                        partition: int) -> Any:
        """:meth:`_encode_event`, or None (and the aggregate poisoned) when
        the aggregate cannot ride the tensor path."""
        if agg_id in self._poisoned:
            return None
        try:
            return self._encode_event(raw)
        except Exception:  # noqa: BLE001 — per-aggregate degradation
            self._poison(agg_id, partition)
            return None

    def _poison(self, agg_id: str, partition: int) -> None:
        self._poisoned[agg_id] = partition
        slot = self._dir.pop(agg_id, None)
        if slot is not None:
            self._free.append(slot)
        self._spill.pop(agg_id, None)
        self._lru.pop(agg_id, None)
        self._agg_part.pop(agg_id, None)
        if not self._warned_poison:
            self._warned_poison = True
            logger.warning(
                "aggregate %s emitted an event type outside the replay "
                "schema; it (and any later such aggregate) is served from "
                "the host store only", agg_id)

    # -- one fold group -----------------------------------------------------------------

    def _encode_pack_group(self, event_logs: List[list]):
        """Executor half of one fold group: ragged encode + wire pack of
        every refresh plan. Pure — touches no plane state.

        Returns ``(b, plans)``. Each plan is ``("win", sel, lanes_b, width,
        wins)`` for the window fold (``wins = [(packed, side, counts), ...]``
        chained windows) or ``("rag", sel, lanes_b, width, (packed_flat,
        sides, starts, wins))`` for K2 (``wins = [(t_base, counts), ...]``).
        ``sel`` indexes the plan's lanes back into the group. Dense dispatch
        is ONE plan at the ``_pow8(b) × _pow2(max_len)`` rectangle; bucketed
        dispatch deals lanes into pow2 LENGTH buckets, one plan each (every
        lane is in exactly one bucket, so the plans scatter to disjoint
        slots)."""
        b = len(event_logs)
        if self._refresh_dispatch == "dense":
            enc = encode_events(self.spec.registry, event_logs)
            width = min(self._window, _pow2(enc.max_len))
            sel = np.arange(b, dtype=np.int64)
            return b, [("win", sel, _pow8(b), width,
                        self._pack_windows(enc, _pow8(b), width))]
        lens = np.fromiter((len(ev) for ev in event_logs), dtype=np.int64,
                           count=b)
        deal: Dict[int, list] = {}
        for i in range(b):
            wb = min(self._window, _pow2(max(int(lens[i]), 1), 2))
            deal.setdefault(wb, []).append(i)
        plans = []
        for wb in sorted(deal):
            sel = np.asarray(deal[wb], dtype=np.int64)
            enc = encode_events(self.spec.registry,
                                [event_logs[i] for i in sel])
            lanes_b = _pow2(len(sel))
            if self._ragged:
                plans.append(("rag", sel, lanes_b, wb,
                              self._pack_ragged(enc, lanes_b, wb)))
            else:
                plans.append(("win", sel, lanes_b, wb,
                              self._pack_windows(enc, lanes_b, wb)))
        return b, plans

    def _pack_windows(self, enc, lanes_b: int, width: int):
        """Chained dense windows of one plan: ``[(packed, side, counts)]``."""
        wins = []
        for s in range(0, enc.max_len, width):
            e = min(s + width, enc.max_len)
            packed, side = self._wire.pack_window(
                enc.type_ids, enc.cols, s, e, width, lanes_b)
            counts = np.zeros((lanes_b,), dtype=np.int32)
            counts[:enc.batch_size] = np.clip(enc.lengths - s, 0, width)
            wins.append((packed, side, counts))
        return wins

    def _pack_ragged(self, enc, lanes_b: int, width: int):
        """Flat-pack one bucket for K2: the bucket's events concatenate
        lane-contiguous into ONE packed buffer of ``_pow2(total)`` rows (pad
        rows pack to the pad sentinel), with per-lane start offsets; chained
        windows shift the starts instead of re-packing."""
        nb, t = enc.batch_size, enc.max_len
        total = int(enc.lengths.sum())
        rows_b = _pow2(max(total, 1))
        mask = np.arange(t, dtype=np.int64)[None, :] < enc.lengths[:, None]
        flat_tids = np.full((rows_b,), -1, dtype=enc.type_ids.dtype)
        flat_tids[:total] = enc.type_ids[mask]
        flat_cols = {}
        for name, col in enc.cols.items():
            buf = np.zeros((rows_b,), dtype=col.dtype)
            buf[:total] = col[mask]
            flat_cols[name] = buf
        packed, sides = self._wire.pack_flat(flat_tids, flat_cols)
        starts = np.zeros((lanes_b,), dtype=np.int32)
        starts[1:nb] = np.cumsum(enc.lengths[:-1], dtype=np.int64)[:nb - 1]
        wins = []
        for s in range(0, t, width):
            counts = np.zeros((lanes_b,), dtype=np.int32)
            counts[:nb] = np.clip(enc.lengths - s, 0, width)
            wins.append((s, counts))
        return packed, sides, starts, wins

    async def _fold_group(self, group: List[str], logs: Dict[str, list],
                          part_of: Dict[str, int],
                          gens: Dict[int, int]) -> None:
        """Admit + fold one ≤capacity group of aggregates' new events.

        Encode+pack and the window enqueues run in the executor. Correctness
        across the awaits rests on DEFERRED COMMIT: slots are reserved but the
        directory, spill and watermarks only change after the fold lands — a
        read of an admitting aggregate is served from its exact spill row or
        falls back, never from a half-admitted slab row. A rebalance racing
        the fold is detected at commit and its aggregates' reservations are
        rolled back."""
        loop = asyncio.get_running_loop()
        b, plans = await loop.run_in_executor(
            None, self._encode_pack_group, [logs[a] for a in group])

        # -- sync: evict + reserve slots + per-lane admission rows ----------
        admit_ids = [a for a in group if a not in self._dir]
        short = len(admit_ids) - len(self._free)
        if short > 0:
            await self._evict(short, protect=set(group))
        init = self.spec.init_state_tree()
        new_slots: Dict[str, int] = {}
        slot_of = np.empty((b,), dtype=np.int32)
        admit_lane = np.zeros((b,), dtype=bool)
        admit_ord_of = np.zeros((b,), dtype=np.int32)
        admit_val_of = {f.name: np.full((b,), init[f.name],
                                        dtype=self._dev_dts[f.name])
                        for f in self._fields}
        for i, agg in enumerate(group):
            s = self._dir.get(agg)
            if s is not None:
                slot_of[i] = s
                continue
            slot = self._free.pop()
            new_slots[agg] = slot
            slot_of[i] = slot
            admit_lane[i] = True
            spilled = self._spill.get(agg)  # peek — popped at commit
            if spilled is not None:
                row, ordinal = spilled
                admit_ord_of[i] = ordinal
                for k in admit_val_of:
                    admit_val_of[k][i] = row[k]

        # -- windows off-loop: in place on the live slab, or on a copy ------
        if self._donate_refresh:
            slab, ords = self._slab, self._ords
        else:
            slab, ords = await loop.run_in_executor(None, self._copy_slab)
        self._round_acc["lanes"] += b
        for plan in plans:
            await self._dispatch_plan(loop, plan, slab, ords, slot_of,
                                      admit_lane, admit_ord_of, admit_val_of)

        # -- sync commit: publish the folded slab + directory ---------------
        if not self._donate_refresh:
            with self._dev_lock:
                self._slab, self._ords = slab, ords
        for agg in group:
            p = part_of[agg]
            if (p not in self._watermarks      # revoked while the fold flew
                    or self._anchor_gen.get(p, 0) != gens.get(p, 0)):
                # ...or re-anchored: this fold used the OLD anchor's
                # carry/events — roll the agg back
                slot = new_slots.pop(agg, None)
                if slot is not None:
                    self._free.append(slot)
                continue
            slot = new_slots.get(agg)
            if slot is not None:
                self._dir[agg] = slot
                self._spill.pop(agg, None)
            elif agg not in self._dir:
                continue  # purged mid-flight; stays purged
            self._agg_part[agg] = p
            self._touch(agg)

    def _copy_slab(self):
        """The out-of-place arm's working copy of the slab and ordinals."""
        with self._dev_lock:
            return ({k: v.clone() for k, v in self._slab.items()},
                    self._ords.clone())

    def _lane_admission(self, sel: np.ndarray, lanes_b: int,
                        slot_of: np.ndarray, admit_lane: np.ndarray,
                        admit_ord_of: np.ndarray,
                        admit_val_of: Dict[str, np.ndarray]):
        """One plan's lanes and admission, aligned to lanes and padded to its
        ``lanes_b`` bucket: ``(lane_slots, (flag, ord, values))``. Padding
        lanes target the scratch row and admit nothing. The reference
        scatters the plan's admitted slots positionally and then gathers the
        lanes' slots; a lane-aligned admission computes the same because
        every admitted slot is a lane of its plan (``sel`` picks both)."""
        nb = len(sel)
        lane_slots = np.full((lanes_b,), self.capacity, dtype=np.int32)
        lane_slots[:nb] = slot_of[sel]
        flag = np.zeros((lanes_b,), dtype=bool)
        flag[:nb] = admit_lane[sel]
        ordv = np.zeros((lanes_b,), dtype=np.int32)
        ordv[:nb] = admit_ord_of[sel]
        init = self.spec.init_state_tree()
        values = {}
        for k, col in admit_val_of.items():
            vals = np.full((lanes_b,), init[k], dtype=col.dtype)
            vals[:nb] = col[sel]
            values[k] = vals
        return lane_slots, (flag, ordv, values)

    async def _dispatch_plan(self, loop, plan, slab, ords,
                             slot_of: np.ndarray, admit_lane: np.ndarray,
                             admit_ord_of: np.ndarray,
                             admit_val_of: Dict[str, np.ndarray]) -> None:
        """Fold one refresh plan's chained windows into ``slab``/``ords`` in
        place, one executor call per window. Each window travels as one lane
        table (``fold_kernels.window_table``); only the first window
        admits."""
        mode, sel, lanes_b, width, payload = plan
        nb = len(sel)
        lane_slots, admission = self._lane_admission(
            sel, lanes_b, slot_of, admit_lane, admit_ord_of, admit_val_of)
        fields = tuple(f.name for f in self._fields)

        if mode == "rag":
            packed_flat, sides_flat, starts, wins = payload
            sig = ("refresh-ragged", lanes_b, width, packed_flat.shape[0])
        else:
            wins = payload
            sig = ("refresh", lanes_b, width)
        fresh = sig not in self._signatures
        self._signatures.add(sig)
        acc = self._round_acc
        acc["batch"] = lanes_b
        acc["width"] = width
        acc["programs"] += 1
        acc["lane_slots"] += lanes_b
        shared: Dict[str, Any] = {}  # the plan's device inputs (executor only)
        occupied = 0
        for w, win in enumerate(wins):
            counts = win[-1]
            table = fold_kernels.window_table(
                lane_slots, counts,
                (starts + win[0]).astype(np.int32) if mode == "rag" else None,
                admission if w == 0 else None, fields)
            run = functools.partial(self._run_window, mode, shared, slab, ords,
                                    width, table, win, payload)
            if self._faults is not None:
                # the stall-anatomy site, INSIDE the executor call so an
                # armed delay lands in the dispatch stage's measured time
                run = functools.partial(
                    (lambda f, thunk: (f.point("resident.refresh.dispatch"),
                                       thunk())[1]), self._faults, run)
            d0 = time.perf_counter()
            if self.profiler is None:
                await loop.run_in_executor(None, run)
            else:
                with self.profiler.stage("compile" if fresh else "dispatch",
                                         width=width, batch=lanes_b):
                    await loop.run_in_executor(None, run)
                fresh = False
            acc["windows"] += 1
            acc["dispatched"] += lanes_b * width
            acc["occupied"] += int(counts.sum())
            occupied += int(counts.sum())
            acc["dispatch_s"] += time.perf_counter() - d0
        acc["buckets"].append({
            "width": width, "lanes_b": lanes_b, "lanes": nb,
            "windows": len(wins), "dispatched": lanes_b * width * len(wins),
            "occupied": occupied, "ragged": mode == "rag" or None})

    def _run_window(self, mode: str, shared: Dict[str, Any], slab, ords,
                    width: int, table: np.ndarray, win, payload) -> None:
        """Executor half of one window: upload its inputs (the lane table,
        and the wire bytes once per plan or per window), then make ONE
        window call under the plane lock — K2's ragged window, K1's dense
        window, or under ``tile-backend = xla`` or ``assoc`` the plain
        window around the plain decode and scan."""
        up = self._upload
        spec, wire = self.spec, self._wire
        if mode == "rag":
            if not shared:
                packed_flat, sides_flat, _, _ = payload
                shared["words"] = up(packed_flat)
                shared["sides"] = {n: up(v) for n, v in sides_flat.items()}
            words, sides = shared["words"], shared["sides"]
        else:
            packed, side, _ = win
            words = up(packed)
            sides = {n: up(v) for n, v in side.items()}
        table_d = up(table)
        with self._dev_lock:
            if mode == "rag":
                fold_kernels.ragged_window(slab, ords, table_d, words, sides,
                                           width=width, spec=spec, wire=wire)
            elif self._backend == "pallas":
                fold_kernels.dense_window(slab, ords, table_d, words, sides,
                                          spec=spec, wire=wire)
            else:
                fold_kernels.dense_window_reference(
                    slab, ords, table_d, words, sides, spec=spec, wire=wire,
                    fold=lambda carry, w, sd, o: self._fold(
                        carry, wire.decode(w, sd, o)))

    # -- eviction and pulls -------------------------------------------------------------

    def _touch(self, agg_id: str) -> None:
        self._tick += 1
        self._lru[agg_id] = self._tick

    async def _evict(self, n: int, protect: set) -> None:
        """Pull the n least-recently-touched unprotected rows to the host
        spill and free their slots (a spilled row re-admits at its exact
        fold point). The pull's fetch runs off the loop on the card; a
        victim purged by a rebalance meanwhile stays purged."""
        victims = sorted((a for a in self._dir if a not in protect),
                         key=lambda a: self._lru.get(a, 0))[:n]
        if len(victims) < n:
            raise RuntimeError(
                f"resident slab cannot hold the refresh batch: need {n} more "
                f"slots, only {len(victims)} evictable "
                f"(capacity {self.capacity})")
        idx = np.fromiter((self._dir[v] for v in victims), dtype=np.int32,
                          count=len(victims))
        mat, o = self._enqueue_gather(None, idx, _pow2(max(n, 1)), pad=0)
        host, ords = await self._fetch_async(mat, o)
        rows = self._decode_wide(host, n)
        evicted = 0
        for j, v in enumerate(victims):
            if self._dir.get(v) != idx[j]:
                continue
            self._spill[v] = ({k: rows[k][j] for k in rows}, int(ords[j]))
            self._free.append(self._dir.pop(v))
            self._lru.pop(v, None)
            evicted += 1
        self.stats["evictions"] += evicted
        self._round_acc["evictions"] += evicted
        if self.metrics is not None:
            self.metrics.resident_evictions.record(evicted)
        if self.flight is not None:
            self.flight.record("resident.evict", count=evicted,
                               resident=len(self._dir),
                               spilled=len(self._spill))
        if self.ledger is not None:
            self.ledger.record_evict(evicted, resident=len(self._dir),
                                     cause="capacity")

    def _pull_positions(self, slab, positions: np.ndarray):
        """Wide (u32) gather of ``positions`` rows + one fetch; returns
        ``({field: np[k]}, ordinals np[k])`` decoded to schema dtypes.
        ``slab=None`` reads the live plane slab and its ordinals (atomic
        pairs); another slab (the seed's) reads zero ordinals."""
        k = len(positions)
        mat, o = self._enqueue_gather(slab, positions, _pow2(max(k, 1)), pad=0)
        host, o = self._fetch(mat, o)
        return self._decode_wide(host, k), o[:k]

    def _decode_wide(self, mat: np.ndarray, k: int) -> Dict[str, np.ndarray]:
        """Decode gathered u32 word rows ``[n_words, k_b]`` by the DEVICE
        dtypes, widening back to the schema dtypes."""
        out: Dict[str, np.ndarray] = {}
        row = 0
        for f, w in zip(self._fields, self._wide_words):
            dev = self._dev_dts[f.name]
            dt = self._dtypes[f.name]  # widen back to the schema dtype
            raw = mat[row: row + w, :k]
            row += w
            if np.issubdtype(dev, np.floating) and dev.itemsize < 4:
                out[f.name] = raw[0].view(np.float32).astype(dt)
            elif dev == np.bool_ or dev.itemsize < 4:
                out[f.name] = raw[0].astype(dt)
            elif w > 1:  # w u32 word-rows -> (k, w) contiguous -> one column
                out[f.name] = np.ascontiguousarray(raw.T).view(dev)[:, 0]
            else:
                out[f.name] = raw[0].view(dev).astype(dt)
        return out

    # -- read path ----------------------------------------------------------------------

    def lag_records(self) -> int:
        """Σ over assigned partitions of (end offset − fold watermark)."""
        return sum(self.partition_lag(p) for p in self.partitions)

    def partition_lag(self, p: int) -> int:
        return max(self.log.end_offset(self.events_topic, p)
                   - self._watermarks.get(p, 0), 0)

    def _ends_sync(self, parts: Sequence[int]) -> Dict[int, int]:
        return {p: self.log.end_offset(self.events_topic, p) for p in parts}

    async def _ends_for(self, parts: Sequence[int]) -> Dict[int, int]:
        """Live end-offset view for a read's freshness check (through the
        executor when the log is remote, where each call is an RPC)."""
        parts = [p for p in parts if p in self._watermarks]
        if not parts:
            return {}
        if self._remote_log:
            return await asyncio.get_running_loop().run_in_executor(
                None, self._ends_sync, parts)
        return self._ends_sync(parts)

    def _fresh_enough(self, p: Optional[int], require_current: bool,
                      ends: Optional[Mapping[int, int]] = None) -> bool:
        if p is None or p not in self._watermarks:
            return False
        bound = 0 if require_current else self.max_lag
        if ends is not None:
            end = ends.get(p)
            if end is None:
                return False
            return max(end - self._watermarks.get(p, 0), 0) <= bound
        return self.partition_lag(p) <= bound

    #: fallback cause -> the metrics counter carrying its split
    _FALLBACK_CAUSE_SENSORS = {
        "lag-exceeded": "resident_fallbacks_lag",
        "lane-error": "resident_fallbacks_lane_error",
        "unschema-poison": "resident_fallbacks_poison",
        "untracked": "resident_fallbacks_untracked",
    }

    def _record_fallback(self, n: int = 1, cause: str = "untracked") -> None:
        """One or more reads fell back to the host store, and why
        (``lag-exceeded``, ``lane-error``, ``unschema-poison``,
        ``untracked``)."""
        self.stats["fallbacks"] += n
        self.fallback_causes[cause] = self.fallback_causes.get(cause, 0) + n
        self._round_causes[cause] = self._round_causes.get(cause, 0) + n
        if self.metrics is not None:
            self.metrics.resident_fallbacks.record(n)
            getattr(self.metrics,
                    self._FALLBACK_CAUSE_SENSORS[cause]).record(n)

    async def read_state(self, aggregate_id: str, *,
                         require_current: bool = False
                         ) -> Tuple[bool, Any]:
        """Read one aggregate's state: ``(hit, state)``. A miss means the
        caller must fall back to the host KV store. ``require_current=True``
        demands lag 0 on the aggregate's partition (the entity-init
        contract); the default tolerates ``max-lag-records``."""
        if self._stopped or not self._seeded:
            self._record_fallback()
            return (False, None)
        p = self._agg_part.get(aggregate_id)
        if p is None or p not in self._watermarks:
            self._record_fallback(cause="unschema-poison"
                                  if aggregate_id in self._poisoned
                                  else "untracked")
            return (False, None)
        ends = await self._ends_for((p,))
        if not self._fresh_enough(p, require_current, ends):
            self._record_fallback(cause="lag-exceeded")
            return (False, None)
        spilled = self._spill.get(aggregate_id)
        if spilled is not None:
            row, _ord = spilled
            return (True, self._state_of(aggregate_id,
                                         {k: np.asarray(v)
                                          for k, v in row.items()}, 0))
        if aggregate_id not in self._dir:
            self._record_fallback()
            return (False, None)
        fut = asyncio.get_running_loop().create_future()
        if not self._pending:
            self._pending_t0 = time.perf_counter()
        self._pending.append((aggregate_id, fut))
        self._touch(aggregate_id)
        self._kick_drain()
        return await fut

    async def read_bytes(self, aggregate_id: str, *,
                         require_current: bool = False
                         ) -> Tuple[bool, Optional[bytes]]:
        """:meth:`read_state` + the restore serialize chain."""
        hit, state = await self.read_state(aggregate_id,
                                           require_current=require_current)
        if not hit:
            return (False, None)
        return (True, self.serialize_state(aggregate_id, state))

    async def read_many(self, aggregate_ids: Sequence[str], *,
                        require_current: bool = False) -> Dict[str, Any]:
        """Bulk read: ``{aggregate_id: state}`` for every id the plane can
        serve; misses are OMITTED (the caller overlays the host store). The
        whole call rides the gather lane as ONE queued item."""
        if self._stopped or not self._seeded:
            self._record_fallback(len(aggregate_ids))
            return {}
        ends = await self._ends_for(self.partitions)
        if all(self._fresh_enough(p, require_current, ends)
               for p in self.partitions):
            ok: Sequence[str] = tuple(aggregate_ids)
        else:
            fresh: Dict[Optional[int], bool] = {None: False}
            ok_list: List[str] = []
            stale = 0
            part = self._agg_part
            for agg in aggregate_ids:
                p = part.get(agg)
                f = fresh.get(p)
                if f is None:
                    f = fresh[p] = self._fresh_enough(p, require_current,
                                                      ends)
                if f:
                    ok_list.append(agg)
                else:
                    stale += 1
            if stale:
                self._record_fallback(stale, cause="lag-exceeded")
            ok = ok_list
        if not ok:
            return {}
        fut = asyncio.get_running_loop().create_future()
        if not self._pending:
            self._pending_t0 = time.perf_counter()
        self._pending.append((ok, fut))
        self._kick_drain()
        return await fut

    async def project(self, aggregate_ids: Sequence[str], *,
                      require_current: bool = False) -> Dict[str, Any]:
        """Batched read-side projection — alias of :meth:`read_many`."""
        return await self.read_many(aggregate_ids,
                                    require_current=require_current)

    def _kick_drain(self) -> None:
        if not self._draining:
            self._draining = True
            spawn_reaped(self._drain_tasks, self._drain_reads(),
                         "resident gather-lane drain")

    async def _drain_reads(self) -> None:
        """The gather lane: coalesce every queued read into one device gather
        + a single fetch."""
        loop = asyncio.get_running_loop()
        try:
            while self._pending:
                batch, self._pending = self._pending, []
                t0, self._pending_t0 = self._pending_t0, None
                wait_s = max(time.perf_counter() - t0, 0.0) if t0 else 0.0
                try:
                    await self._drain_batch(loop, batch, wait_s)
                except Exception:  # noqa: BLE001 — the plane is an optimization:
                    # a device/decode failure fails the batch over to the host
                    # store, never strands its futures
                    logger.exception(
                        "resident gather batch failed; failing %d read(s) "
                        "over to the host store", len(batch))
                    try:
                        self.on_signal("surge.replay.resident.gather-error",
                                       "error")
                    except Exception:  # noqa: BLE001
                        logger.exception("on_signal failed")
                    n = 0
                    for target, fut in batch:
                        if not fut.done():
                            n += 1
                            fut.set_result((False, None)
                                           if isinstance(target, str) else {})
                    if n:
                        self._record_fallback(n, cause="lane-error")
        finally:
            self._draining = False

    async def _drain_batch(self, loop, batch, wait_s: float = 0.0) -> None:
        # snapshot slots on the loop and enqueue their gather right away, in
        # the same await-free section: a slot evicted and re-admitted later
        # is written only by windows enqueued after this gather. Ids evicted
        # since enqueue are served from their exact spill rows instead.
        calls = []
        gather_ids: List[str] = []
        slots: List[int] = []
        dir_get, spill_get = self._dir.get, self._spill.get
        for target, fut in batch:
            if fut.done():
                continue
            single = isinstance(target, str)
            ids = (target,) if single else target
            start = len(slots)
            refs: Optional[List[Any]] = None
            looked = [dir_get(a) for a in ids]
            if None not in looked:  # all resident: contiguous gather rows
                slots.extend(looked)
                gather_ids.extend(ids)
            else:
                refs = []
                for agg, slot in zip(ids, looked):
                    if slot is not None:
                        refs.append(len(slots))
                        slots.append(slot)
                        gather_ids.append(agg)
                    else:
                        spilled = spill_get(agg)
                        refs.append(("spill", spilled[0])
                                    if spilled is not None else None)
            calls.append((fut, single, ids, refs, start))
        states: list = []
        if slots:
            k = len(slots)
            t = time.perf_counter()
            # pad with the first LIVE slot, never the scratch row
            mat, o = self._enqueue_gather(None, slots, _pow2(k), pad=slots[0])
            disp_s = time.perf_counter() - t
            t = time.perf_counter()
            host, _ = await self._fetch_async(mat, o)
            fetch_s = time.perf_counter() - t
            t = time.perf_counter()
            rows = self._decode_wide(host, k)
            states = self._states_of_batch(gather_ids, rows, k)
            dec_s = time.perf_counter() - t
            # one batched LRU touch for every gathered hit
            self._tick += 1
            self._lru.update(dict.fromkeys(gather_ids, self._tick))
            self.stats["gathers"] += 1
            self.stats["gathered_rows"] += k
            if self.metrics is not None:
                self.metrics.resident_gather_batch.record(k)
            if self.ledger is not None:
                self.ledger.record_gather(
                    reads=len(calls), rows=k, wait_us=wait_s * 1e6,
                    dispatch_us=disp_s * 1e6, fetch_us=fetch_s * 1e6,
                    decode_us=dec_s * 1e6)
            if self.tracer is not None:
                self._emit_gather_span(wait_s, disp_s, fetch_s, dec_s, k)
        for fut, single, ids, refs, start in calls:
            if fut.done():
                continue
            try:
                if refs is None:  # all resident, contiguous rows
                    if single:
                        fut.set_result((True, states[start]))
                    else:
                        fut.set_result(dict(zip(
                            ids, states[start:start + len(ids)])))
                    continue
                out: Dict[str, Any] = {}
                misses = poisons = 0
                for agg, ref in zip(ids, refs):
                    if ref is None:
                        if agg in self._poisoned:
                            poisons += 1
                        else:
                            misses += 1
                    elif isinstance(ref, int):
                        out[agg] = states[ref]
                    else:  # exact-fold-point spill row
                        out[agg] = self._state_of(
                            agg, {k: np.asarray(v)
                                  for k, v in ref[1].items()}, 0)
                if misses:
                    self._record_fallback(misses)
                if poisons:
                    self._record_fallback(poisons, cause="unschema-poison")
                if single:
                    agg = ids[0]
                    fut.set_result((agg in out, out.get(agg)))
                else:
                    fut.set_result(out)
            except Exception as exc:  # noqa: BLE001 — decode bug
                if not fut.done():
                    fut.set_exception(exc)

    def _emit_gather_span(self, wait_s: float, disp_s: float, fetch_s: float,
                          dec_s: float, rows: int) -> None:
        """One ``resident.gather`` span per drained batch, its legs as
        ``leg.*-ms`` attributes, retro-dated on both clocks to the measured
        interval."""
        total = wait_s + disp_s + fetch_s + dec_s
        span = self.tracer.start_span("resident.gather")
        span.start_time = time.time() - total
        span.start_mono = time.monotonic() - total
        try:
            span.set_attribute("leg.coalesce-ms", round(wait_s * 1000.0, 3))
            span.set_attribute("leg.dispatch-ms", round(disp_s * 1000.0, 3))
            span.set_attribute("leg.fetch-ms", round(fetch_s * 1000.0, 3))
            span.set_attribute("leg.decode-ms", round(dec_s * 1000.0, 3))
            span.set_attribute("rows", rows)
        finally:
            span.finish()  # unconditional: a leaked span pins its trace

    def _state_of(self, aggregate_id: str, record: Mapping[str, Any],
                  _j: int) -> Any:
        """Tensor row → domain state, through the exact restore chain
        (from_record → aggregate-id reattach → decode_state)."""
        state = self.spec.registry.state.from_record(record)
        state = _with_aggregate_id(state, aggregate_id)
        if self.decode_state is not None:
            state = self.decode_state(aggregate_id, state)
        return state

    # -- introspection ------------------------------------------------------------------

    def occupancy(self) -> int:
        return len(self._dir)

    def resident_ids(self) -> List[str]:
        return sorted(self._dir)

    def _record_gauges(self) -> None:
        if self.metrics is None:
            return
        self.metrics.resident_occupancy.record(len(self._dir))
        ends = self._last_ends
        self.metrics.resident_fold_lag.record(sum(
            max(ends.get(p, 0) - self._watermarks.get(p, 0), 0)
            for p in self.partitions))

    def snapshot_states(self) -> Dict[str, Any]:
        """Host snapshot of every tracked aggregate's state (resident + spill)
        — the golden-test surface; one wide gather for the resident rows."""
        out: Dict[str, Any] = {}
        ids = list(self._dir)
        if ids:
            idx = np.fromiter((self._dir[a] for a in ids), dtype=np.int32,
                              count=len(ids))
            rows, _ = self._pull_positions(None, idx)
            for j, agg in enumerate(ids):
                out[agg] = self._state_of(
                    agg, {k: rows[k][j] for k in rows}, j)
        for agg, (row, _ord) in self._spill.items():
            out[agg] = self._state_of(
                agg, {k: np.asarray(v) for k, v in row.items()}, 0)
        return out
