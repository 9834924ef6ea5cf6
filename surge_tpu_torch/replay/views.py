"""Incremental materialized views + changefeeds off the resident refresh feed:
the port's copy of ``surge_tpu/replay/views.py``, on the port's
:class:`~surge_tpu_torch.replay.query.QueryEngine`.

Named views are OWNED by the resident plane: every refresh round folds the
committed tail into each view's grouped-aggregate partials, and subscribers
ride a push-based per-round delta changefeed.

- **Views are scan queries, kept warm.** A :class:`ViewDef` wraps the exact
  :class:`~surge_tpu_torch.replay.query.ScanQuery` the batch engine runs, plus
  an optional served ``top_k``. A view's per-round fold runs the same scan
  program ``scan_chunks`` uses (``QueryEngine._raw_scan``, the scan-reduce
  kernel on CUDA), so a view equals a from-scratch ``scan_chunks`` at the
  same watermark byte for byte.
- **Per-partition raw partials.** View state is kept per PARTITION as the raw
  sentinel-carrying merge partials (count/sum add, min/max combine;
  zero-match normalization only at serve time). Anything that re-anchors
  partition ``p`` at offset 0 drops ``p``'s partial, and the refresh loop's
  refold rebuilds it; fold watermarks advance only with the plane's own
  gen-fenced commits.
- **One encode per round.** The round's decoded logs are split by partition
  and columnar-encoded ONCE; every registered view scans the same chunk.
- **Changefeed.** Every fold round bumps the view ``version`` and appends the
  changed rows to a bounded delta ring. A resume from version ``V`` replays
  the ring when it still covers ``V`` and otherwise answers with ONE
  reconciling snapshot (``reset``). Applying entries in order always
  reconstructs the snapshot.

Exactness caveat: integer columns merge associatively, so incremental ==
batch bit for bit; float sums are order-sensitive and may differ in the last
ulp between fold orders. ``metrics``, ``ledger`` and ``flight`` are
duck-typed.
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from surge_tpu_torch.codec.tensor import encode_events_columnar
from surge_tpu_torch.config import Config, default_config
from surge_tpu_torch.replay.query import (QueryEngine, ScanQuery,
                                          _normalize_zero_match, _sentinel)

__all__ = ["ViewDef", "MaterializedViews", "ViewSubscription", "select_top_k"]


@dataclass(frozen=True)
class ViewDef:
    """One registered view: a scan query kept incrementally materialized.

    ``top_k`` (with ``top_k_by``, default the first non-count aggregate or
    ``count``) limits what the view SERVES — ranked descending, ties broken
    by ascending key — while the full group set stays materialized, so the
    ranking is exact, never approximate."""

    name: str
    query: ScanQuery
    top_k: Optional[int] = None
    top_k_by: Optional[str] = None

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("view needs a non-empty name")
        if not self.query.aggregates:
            raise ValueError(f"view {self.name!r} needs at least one aggregate")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"view {self.name!r}: top_k must be >= 1")
        outputs = ["count"] + [a.name for a in self.query.aggregates
                               if a.op != "count"]
        if self.top_k_by is not None and self.top_k_by not in outputs:
            raise ValueError(
                f"view {self.name!r}: top_k_by {self.top_k_by!r} is not an "
                f"output column (has {outputs})")

    @property
    def rank_by(self) -> str:
        if self.top_k_by is not None:
            return self.top_k_by
        for a in self.query.aggregates:
            if a.op != "count":
                return a.name
        return "count"

    def as_json(self) -> dict:
        out: dict = {"name": self.name, "query": self.query.as_json()}
        if self.top_k is not None:
            out["top_k"] = self.top_k
        if self.top_k_by is not None:
            out["top_k_by"] = self.top_k_by
        return out

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "ViewDef":
        return cls(name=d["name"], query=ScanQuery.from_json(d["query"]),
                   top_k=d.get("top_k"), top_k_by=d.get("top_k_by"))


def select_top_k(keys: Sequence[str], columns: Mapping[str, np.ndarray],
                 k: int, by: str) -> Tuple[List[str], Dict[str, np.ndarray]]:
    """The served top-k selection, shared with the golden tests so a top-k
    view and a client-side cut of a batch scan rank identically: descending
    on ``by``, ties broken by ascending key."""
    order = sorted(range(len(keys)),
                   key=lambda j: (-float(columns[by][j]), keys[j]))[:k]
    idx = np.asarray(order, dtype=np.int64)
    return ([keys[j] for j in order],
            {name: col[idx] for name, col in columns.items()})


@dataclass
class _Accum:
    """One partition's raw merge partials: unique keys (first-seen order) and
    sentinel-carrying aggregate columns — droppable as a unit when the
    partition re-anchors."""

    keys: List[str] = field(default_factory=list)
    index: Dict[str, int] = field(default_factory=dict)
    cols: Dict[str, np.ndarray] = field(default_factory=dict)


class _View:
    """Runtime state of one registered view."""

    def __init__(self, vdef: ViewDef) -> None:
        self.vdef = vdef
        self.active = False          # pending until seeded or backfilled
        self.version = 0             # fold rounds applied — the resume watermark
        self.watermarks: Dict[int, int] = {}
        self.parts: Dict[int, _Accum] = {}
        self.ring: deque = deque()   # delta entries, bounded by changefeed-rounds
        self.ring_floor = 0          # deltas at/below this version are gone
        self.error: Optional[str] = None
        self.folded_events = 0


class ViewSubscription:
    """One live changefeed subscriber: an asyncio queue the fold thread
    publishes into via ``call_soon_threadsafe`` (folds run in the refresh
    executor; subscribers live on the event loop)."""

    def __init__(self, view: str, loop: asyncio.AbstractEventLoop) -> None:
        self.view = view
        self.queue: asyncio.Queue = asyncio.Queue()
        self._loop = loop
        self.closed = False

    def _publish(self, entry: dict) -> None:
        if self.closed:
            return
        try:
            self._loop.call_soon_threadsafe(self.queue.put_nowait, entry)
        except RuntimeError:  # loop shut down mid-publish
            self.closed = True

    async def get(self) -> dict:
        return await self.queue.get()

    def __aiter__(self) -> "ViewSubscription":
        return self

    async def __anext__(self) -> dict:
        return await self.queue.get()


class MaterializedViews:
    """The view subsystem: registered view defs, per-partition partials, the
    per-round fold, and the changefeed hub. Owned by the engine, driven by
    the resident plane's refresh loop (fold/drop run in the refresh executor;
    registration, snapshots and subscriptions run on the event loop — one
    lock guards all state)."""

    def __init__(self, spec, *, config: Config | None = None, mesh=None,
                 metrics=None, ledger=None, flight=None, device=None) -> None:
        self.spec = spec
        self.config = config or default_config()
        self.metrics = metrics
        self.ledger = ledger
        self.flight = flight
        # the views' scans ride the SAME engine class (and program cache
        # discipline) as batch query(), on ``device`` (None: the CUDA card;
        # a mesh raises there)
        self._qeng = QueryEngine(spec, config=self.config, mesh=mesh,
                                 device=device)
        self._union_cols = {f.name for f in spec.registry.union_columns()}
        #: per-view delta-ring capacity: resumes within this many fold rounds
        #: replay exact deltas; older resumes get a reconciling snapshot
        self._ring_cap = max(self.config.get_int(
            "surge.replay.views.changefeed-rounds", 256), 1)
        #: per-view distinct-group cap — a group_by over an unbounded-
        #: cardinality column must degrade the one view, not the plane
        self._max_groups = self.config.get_int(
            "surge.replay.views.max-groups", 1 << 20)
        self._lock = threading.Lock()
        self._views: Dict[str, _View] = {}
        self._subs: Dict[str, List[ViewSubscription]] = {}
        self.stats = {"fold_rounds": 0, "delta_rows": 0, "resets": 0,
                      "snapshots": 0}

    # -- registration -------------------------------------------------------------------

    def register(self, vdef: ViewDef, *, active: bool) -> None:
        """Install a view. ``active=True`` means its partials start empty and
        the NEXT fold covers it from the start (pre-seed registration);
        ``active=False`` parks it pending until the plane backfills the
        already-folded prefix between refresh rounds."""
        for c in vdef.query.columns_needed():
            if c not in self._union_cols:
                raise ValueError(
                    f"view {vdef.name!r} references unknown event column "
                    f"{c!r} (has {sorted(self._union_cols)})")
        if vdef.query.event_types is not None:
            self._qeng.resolve_type_ids(vdef.query.event_types)  # validates
        with self._lock:
            if vdef.name in self._views:
                raise ValueError(f"view {vdef.name!r} already registered")
            v = _View(vdef)
            v.active = active
            self._views[vdef.name] = v
        if self.flight is not None:
            self.flight.record("views.register", view=vdef.name,
                               active=active)

    def unregister(self, name: str) -> bool:
        with self._lock:
            v = self._views.pop(name, None)
            subs = self._subs.pop(name, [])
        for s in subs:
            s._publish({"view": name, "closed": "unregistered"})
            s.closed = True
        self._record_subscriber_gauge()
        return v is not None

    @property
    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._views)

    @property
    def active_or_pending(self) -> int:
        with self._lock:
            return len(self._views)

    @property
    def has_pending(self) -> bool:
        with self._lock:
            return any(not v.active for v in self._views.values())

    # -- the per-round fold (refresh executor) ------------------------------------------

    def _round_chunks(self, logs: Mapping[str, list],
                      part_of: Mapping[str, int],
                      committed: Mapping[int, int]) -> Dict[int, Any]:
        """Split one round's decoded logs by partition and columnar-encode
        each slice ONCE — every view scans the same chunk (one h2d per
        partition per round, shared across views)."""
        by_part: Dict[int, Tuple[List[str], List[list]]] = {}
        for agg, events in logs.items():
            p = part_of.get(agg)
            if p in committed and events:
                ids, evs = by_part.setdefault(p, ([], []))
                ids.append(agg)
                evs.append(events)
        chunks: Dict[int, Any] = {}
        for p, (ids, evs) in by_part.items():
            colev = encode_events_columnar(self.spec.registry, evs)
            colev.aggregate_ids = ids
            chunks[p] = colev
        return chunks

    def fold_round(self, logs: Mapping[str, list],
                   part_of: Mapping[str, int],
                   committed: Mapping[int, int],
                   activate_pending: bool = False) -> None:
        """Fold one committed refresh round into every active view: scan the
        round's per-partition chunk per view, merge into that partition's
        partials, advance fold watermarks, bump versions, publish deltas.
        Runs in the refresh executor; never raises — a failing view degrades
        to an error state served as such, the plane keeps folding."""
        t0 = time.perf_counter()
        with self._lock:
            if activate_pending:
                for v in self._views.values():
                    v.active = True
            views = [v for v in self._views.values()
                     if v.active and v.error is None]
        if not views:
            return
        chunks = self._round_chunks(logs, part_of, committed)
        delta_rows = 0
        with self._lock:
            for v in views:
                delta_rows += self._fold_view_locked(v, chunks, committed)
        elapsed = time.perf_counter() - t0
        self.stats["fold_rounds"] += 1
        self.stats["delta_rows"] += delta_rows
        if self.metrics is not None:
            self.metrics.views_fold_timer.record_ms(elapsed * 1000.0)
            if delta_rows:
                self.metrics.views_delta_rows.record(delta_rows)
        if self.ledger is not None:
            self.ledger.record_view_round(
                views=len(views), rows=delta_rows,
                events=sum(c.num_events for c in chunks.values()),
                fold_us=elapsed * 1e6)

    def fold_view_backfill(self, name: str, logs: Mapping[str, list],
                           part_of: Mapping[str, int],
                           committed: Mapping[int, int]) -> None:
        """Activate ONE pending view by folding the already-committed prefix
        the plane re-read for it (register-while-running). Its version starts
        at 1 with a reset entry, so an early subscriber reconciles."""
        chunks = self._round_chunks(logs, part_of, committed)
        with self._lock:
            v = self._views.get(name)
            if v is None or v.active:
                return
            v.active = True
            self._fold_view_locked(v, chunks, committed, reset=True)

    def _fold_view_locked(self, v: _View, chunks: Mapping[int, Any],
                          committed: Mapping[int, int],
                          reset: bool = False) -> int:
        changed: set = set()
        for p, colev in chunks.items():
            try:
                ids_c, raw = self._qeng._raw_scan(colev, v.vdef.query)
            except Exception as exc:  # noqa: BLE001 — per-view degradation
                self._fail_view_locked(v, f"fold failed: {exc}")
                return 0
            if ids_c is None:
                ids_c = list(colev.aggregate_ids)
            acc = v.parts.get(p)
            if acc is None:
                acc = v.parts[p] = _Accum()
            self._merge_raw_locked(v, acc, ids_c, raw)
            if v.error is not None:  # group cap tripped mid-merge
                return 0
            for key, c in zip(ids_c, raw["count"].tolist()):
                if c:
                    changed.add(key)
            v.folded_events += colev.num_events
        v.watermarks.update(committed)
        v.version += 1
        if reset:
            entry = self._reset_entry_locked(v)
            self.stats["resets"] += 1
        elif changed:
            keys = sorted(changed)
            entry = {"view": v.vdef.name, "version": v.version,
                     "reset": False,
                     "watermarks": {str(p): w
                                    for p, w in sorted(v.watermarks.items())},
                     "rows": self._rows_locked(v, keys)}
        else:
            return 0
        self._push_delta_locked(v, entry)
        return len(entry["rows"])

    def _merge_raw_locked(self, v: _View, acc: _Accum, ids_c: List[str],
                          raw: Mapping[str, np.ndarray]) -> None:
        """Merge one chunk's RAW scan output into a partition accumulator —
        the same count/sum-add, min/max-combine arithmetic as the batch
        engine's cross-chunk merge, kept un-normalized so later rounds keep
        combining."""
        fresh = [k for k in ids_c if k not in acc.index]
        if fresh:
            if len(acc.keys) + len(fresh) > self._max_groups:
                self._fail_view_locked(
                    v, f"group cap exceeded "
                       f"(surge.replay.views.max-groups={self._max_groups})")
                return
            grow = len(fresh)
            for name, col in acc.cols.items():
                op = self._op_of(v.vdef.query, name)
                init = (0 if op in ("count", "sum")
                        else _sentinel(op, np.dtype(col.dtype)))
                acc.cols[name] = np.concatenate(
                    [col, np.full((grow,), init, dtype=col.dtype)])
            for k in fresh:
                acc.index[k] = len(acc.keys)
                acc.keys.append(k)
        b = len(acc.keys)
        idxs = np.fromiter((acc.index[k] for k in ids_c), dtype=np.int64,
                           count=len(ids_c))
        for name, col in raw.items():
            have = acc.cols.get(name)
            op = self._op_of(v.vdef.query, name)
            if have is None:
                init = (0 if op in ("count", "sum")
                        else _sentinel(op, np.dtype(col.dtype)))
                have = acc.cols[name] = np.full((b,), init, dtype=col.dtype)
            if op in ("count", "sum"):
                np.add.at(have, idxs, col)
            elif op == "min":
                np.minimum.at(have, idxs, col)
            else:
                np.maximum.at(have, idxs, col)

    @staticmethod
    def _op_of(query: ScanQuery, name: str) -> str:
        if name == "count":
            return "count"
        for a in query.aggregates:
            if a.op != "count" and a.name == name:
                return a.op
        raise KeyError(name)

    def _fail_view_locked(self, v: _View, reason: str) -> None:
        v.error = reason
        for s in self._subs.get(v.vdef.name, []):
            s._publish({"view": v.vdef.name, "error": reason,
                        "version": v.version})
        if self.flight is not None:
            self.flight.record("views.error", view=v.vdef.name,
                               reason=reason)

    # -- re-anchor (shared with every plane purge path) ---------------------------------

    def drop_partition(self, p: int) -> None:
        """Partition ``p`` re-anchored (revoke, re-grant, mid-round failure,
        failover): drop every view's partial for it and emit a reset entry —
        subscribers replace their state, and the refresh refold rebuilds the
        partial through normal rounds."""
        with self._lock:
            for v in self._views.values():
                had = v.parts.pop(p, None) is not None
                wm = v.watermarks.pop(p, None) is not None
                if not (had or wm) or not v.active or v.error is not None:
                    continue
                v.version += 1
                self.stats["resets"] += 1
                self._push_delta_locked(v, self._reset_entry_locked(v))

    def _reset_entry_locked(self, v: _View) -> dict:
        keys, cols = self._combined_locked(v)
        return {"view": v.vdef.name, "version": v.version, "reset": True,
                "watermarks": {str(p): w
                               for p, w in sorted(v.watermarks.items())},
                "rows": self._rows_of(v, keys, cols)}

    # -- serving ------------------------------------------------------------------------

    def _combined_locked(self, v: _View, only: Optional[List[str]] = None
                         ) -> Tuple[List[str], Dict[str, np.ndarray]]:
        """Merge the per-partition raw partials into normalized output
        columns over sorted keys (serve order is key-sorted: incremental and
        batch paths discover keys in different orders, the sort is the
        canonical one byte-equality is defined on)."""
        if only is not None:
            keys = only
        else:
            union: set = set()
            for acc in v.parts.values():
                union.update(acc.keys)
            keys = sorted(union)
        index = {k: i for i, k in enumerate(keys)}
        b = len(keys)
        agg_specs = [(a.op, a.name) for a in v.vdef.query.aggregates
                     if a.op != "count"]
        cols: Dict[str, np.ndarray] = {"count": np.zeros((b,), np.int32)}
        for p in sorted(v.parts):
            acc = v.parts[p]
            pairs = [(j, index[k]) for j, k in enumerate(acc.keys)
                     if k in index]
            if not pairs:
                continue
            js = np.asarray([j for j, _ in pairs], dtype=np.int64)
            ks = np.asarray([i for _, i in pairs], dtype=np.int64)
            cols["count"][ks] += acc.cols["count"][js]
            for op, name in agg_specs:
                src = acc.cols.get(name)
                if src is None:
                    continue
                have = cols.get(name)
                if have is None:
                    init = (0 if op == "sum"
                            else _sentinel(op, np.dtype(src.dtype)))
                    have = cols[name] = np.full((b,), init, dtype=src.dtype)
                if op == "sum":
                    have[ks] += src[js]
                elif op == "min":
                    np.minimum.at(have, ks, src[js])
                else:
                    np.maximum.at(have, ks, src[js])
        for _op, name in agg_specs:
            if name not in cols:  # empty view: no chunk ever carried dtypes
                cols[name] = np.zeros((b,), dtype=np.int32)
        return keys, _normalize_zero_match(cols, v.vdef.query)

    def _rows_of(self, v: _View, keys: List[str],
                 cols: Mapping[str, np.ndarray]) -> List[dict]:
        names = list(cols)
        lists = [cols[n].tolist() for n in names]
        return [{"key": k, **{n: lists[i][j] for i, n in enumerate(names)}}
                for j, k in enumerate(keys)]

    def _rows_locked(self, v: _View, keys: List[str]) -> List[dict]:
        keys2, cols = self._combined_locked(v, only=keys)
        return self._rows_of(v, keys2, cols)

    def snapshot(self, name: str) -> dict:
        """The served view: normalized columns over sorted keys (top-k cut
        applied), version + fold watermarks. This is the ``QueryView`` RPC
        payload and the golden-test surface."""
        with self._lock:
            v = self._views.get(name)
            if v is None:
                raise KeyError(f"unknown view {name!r}")
            if v.error is not None:
                return {"view": name, "error": v.error, "version": v.version}
            keys, cols = self._combined_locked(v)
            if v.vdef.top_k is not None:
                keys, cols = select_top_k(keys, cols, v.vdef.top_k,
                                          v.vdef.rank_by)
            self.stats["snapshots"] += 1
            return {"view": name, "version": v.version,
                    "active": v.active,
                    "watermarks": {str(p): w
                                   for p, w in sorted(v.watermarks.items())},
                    "keys": keys,
                    "columns": {n: c for n, c in cols.items()},
                    "rows": self._rows_of(v, keys, cols)}

    def summary(self) -> List[dict]:
        """Operator view (``chaos.py views`` / surgetop): one row per view."""
        with self._lock:
            out = []
            for name in sorted(self._views):
                v = self._views[name]
                groups = len({k for acc in v.parts.values()
                              for k in acc.keys})
                out.append({
                    "view": name, "active": v.active, "version": v.version,
                    "groups": groups, "folded_events": v.folded_events,
                    "watermarks": {str(p): w for p, w
                                   in sorted(v.watermarks.items())},
                    "subscribers": len(self._subs.get(name, [])),
                    "error": v.error,
                    "query": v.vdef.query.as_json(),
                })
            return out

    # -- changefeed ---------------------------------------------------------------------

    def _push_delta_locked(self, v: _View, entry: dict) -> None:
        self.ring_append(v, entry)
        for s in self._subs.get(v.vdef.name, []):
            s._publish(entry)

    def ring_append(self, v: _View, entry: dict) -> None:
        v.ring.append(entry)
        while len(v.ring) > self._ring_cap:
            evicted = v.ring.popleft()
            v.ring_floor = max(v.ring_floor, evicted["version"])

    def subscribe(self, name: str, from_version: Optional[int] = None, *,
                  loop: Optional[asyncio.AbstractEventLoop] = None
                  ) -> ViewSubscription:
        """Open a changefeed. ``from_version=None`` → initial reconciling
        snapshot then live deltas. With a resume watermark: the missed
        deltas replay from the ring when it still covers them (exactly, no
        gap no dup); a gap beyond the ring — or a version from before a
        failover reset — gets ONE reconciling snapshot instead, and the gap
        width lands on ``surge.replay.views.resume-gap-rounds``. Pass
        ``loop`` when calling from an executor thread (the engine hops the
        lock acquisition off the event loop — a fold may hold it through a
        device scan)."""
        if loop is None:
            loop = asyncio.get_running_loop()
        with self._lock:
            v = self._views.get(name)
            if v is None:
                raise KeyError(f"unknown view {name!r}")
            sub = ViewSubscription(name, loop)
            if from_version is None:
                sub.queue.put_nowait(self._reset_entry_locked(v))
            elif (from_version < v.ring_floor or from_version > v.version):
                gap = max(v.version - from_version, 1)
                if self.metrics is not None:
                    self.metrics.views_resume_gap_rounds.record(gap)
                if self.flight is not None:
                    self.flight.record("views.resume-gap", view=name,
                                       from_version=from_version,
                                       gap_rounds=gap)
                sub.queue.put_nowait(self._reset_entry_locked(v))
            else:
                for entry in v.ring:
                    if entry["version"] > from_version:
                        sub.queue.put_nowait(entry)
            self._subs.setdefault(name, []).append(sub)
        self._record_subscriber_gauge()
        return sub

    def unsubscribe(self, sub: ViewSubscription) -> None:
        sub.closed = True
        with self._lock:
            subs = self._subs.get(sub.view)
            if subs and sub in subs:
                subs.remove(sub)
        self._record_subscriber_gauge()

    def subscriber_count(self) -> int:
        with self._lock:
            return sum(len(s) for s in self._subs.values())

    def _record_subscriber_gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.views_subscribers.record(self.subscriber_count())

    def close(self) -> None:
        """Engine stop: end every subscription."""
        with self._lock:
            subs = [s for lst in self._subs.values() for s in lst]
            self._subs.clear()
        for s in subs:
            s._publish({"view": s.view, "closed": "engine-stopped"})
            s.closed = True
        self._record_subscriber_gauge()
