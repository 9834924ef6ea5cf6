"""The scan engine over committed columnar segments (the analytics plane), in
torch: the port's copy of ``surge_tpu/replay/query.py``.

Projection / filter / grouped-aggregation queries run over the struct-of-arrays
chunks of ``log/columnar.py``:

- **Predicate pushdown on typed columns.** A :class:`ScanQuery` carries
  conjunctive predicates and OR groups over the union event columns (plus
  ``type_id`` and an event-type name filter). The segment reader reads only
  the columns the query touches (``read_segment(columns=...)``); the
  predicate mask is torch elementwise ops on the engine's device.
- **Grouped aggregates.** ``count | sum | min | max`` per aggregate id, or per
  distinct value of one column (``group_by``), through one
  :func:`~surge_tpu_torch.replay.scan_reduce.scan_reduce` call a chunk (the
  hand-written kernel on CUDA, its plain version on the CPU): each group's
  events reduce in event order, so float sums equal the reference's scatter
  bit for bit. Chunks cover disjoint aggregate ranges and concatenate;
  chunks repeating an id merge on the host.
- **Bucketed shapes.** Event and group axes pad to power-of-two buckets as
  the reference's do (events at least ``surge.query.chunk-events``); the
  engine caches one program per (query signature, buckets, columns), so
  ``stats`` and ``_programs`` count what the reference's do.
- **Exactness contract.** Arithmetic happens in each column's DEVICE dtype:
  a 64-bit column reduces as its 32-bit kin, as the reference's with x64
  off (the port has no x64 switch). Predicate values reach the device as
  float32, as the reference's ``pred_vals`` do, and cast to the column's
  dtype there (so ``2**24 + 1`` against an int32 column compares as
  ``2**24``). :func:`scan_reference` is the numpy oracle. Aggregates with no
  matched event report 0 for every output (the ``count`` column is the
  tell).

No mesh: ``mesh=`` raises (ROADMAP.md, Queue 1, "Multi-device").
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from surge_tpu_torch.codec.tensor import ColumnarEvents
from surge_tpu_torch.config import Config, default_config
from surge_tpu_torch.replay.engine import _resolve_device, _sync
from surge_tpu_torch.replay.scan_reduce import daz, group_csr, scan_reduce

__all__ = ["Predicate", "Aggregate", "ScanQuery", "StateQuery", "QueryResult",
           "QueryEngine", "scan_reference", "state_query_reference",
           "predicate_mask_np", "MULTI_DEVICE"]

#: the ROADMAP.md item that ports the mesh-sharded paths
MULTI_DEVICE = 'ROADMAP.md, Queue 1, "Multi-device"'

#: comparison ops a predicate may use (conjunctive; applied on device)
_OPS = ("==", "!=", "<", "<=", ">", ">=")

#: the stages of a scan, in seconds (``QueryEngine.stage_s``)
SCAN_STAGES = ("read", "materialize", "h2d", "mask", "reduce", "pull", "merge")


@dataclass(frozen=True)
class Predicate:
    """One comparison over a typed event column (or ``type_id``)."""

    column: str
    op: str
    value: float

    def __post_init__(self) -> None:
        if self.op not in _OPS:
            raise ValueError(f"unknown predicate op {self.op!r} (one of {_OPS})")

    def as_json(self) -> dict:
        return {"column": self.column, "op": self.op, "value": self.value}


@dataclass(frozen=True)
class Aggregate:
    """One grouped aggregate: ``count`` (no column) or ``sum|min|max`` over a
    column. Output column name: ``count`` / ``<op>_<column>``."""

    op: str
    column: Optional[str] = None

    def __post_init__(self) -> None:
        if self.op not in ("count", "sum", "min", "max"):
            raise ValueError(f"unknown aggregate op {self.op!r}")
        if self.op != "count" and not self.column:
            raise ValueError(f"aggregate {self.op!r} needs a column")

    @property
    def name(self) -> str:
        return "count" if self.op == "count" else f"{self.op}_{self.column}"

    def as_json(self) -> dict:
        out: dict = {"op": self.op}
        if self.column:
            out["column"] = self.column
        return out


@dataclass(frozen=True)
class ScanQuery:
    """Filter + grouped-aggregate scan over event columns.

    Rows group by aggregate id, or — with ``group_by`` — by the distinct
    values of one event column (``type_id`` allowed). ``event_types`` filters
    by event class name (resolved to type ids against the registry);
    ``predicates`` are conjunctive, and each entry of ``or_groups`` is a
    disjunction whose groups AND with each other and with ``predicates``
    (CNF). A ``count`` output is always computed, so zero-match groups are
    distinguishable."""

    aggregates: Tuple[Aggregate, ...]
    predicates: Tuple[Predicate, ...] = ()
    event_types: Optional[Tuple[str, ...]] = None
    or_groups: Tuple[Tuple[Predicate, ...], ...] = ()
    group_by: Optional[str] = None

    def __post_init__(self) -> None:
        # normalize nested sequences so signature()/program keys hash
        object.__setattr__(self, "or_groups",
                           tuple(tuple(g) for g in self.or_groups))
        for g in self.or_groups:
            if not g:
                raise ValueError("empty OR-group (would match nothing)")

    def as_json(self) -> dict:
        out: dict = {"aggregates": [a.as_json() for a in self.aggregates],
                     "predicates": [p.as_json() for p in self.predicates]}
        if self.event_types is not None:
            out["event_types"] = list(self.event_types)
        if self.or_groups:
            out["or_groups"] = [[p.as_json() for p in g]
                                for g in self.or_groups]
        if self.group_by is not None:
            out["group_by"] = self.group_by
        return out

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "ScanQuery":
        return cls(
            aggregates=tuple(Aggregate(a["op"], a.get("column"))
                             for a in d.get("aggregates", ())),
            predicates=tuple(Predicate(p["column"], p["op"], p["value"])
                             for p in d.get("predicates", ())),
            event_types=(tuple(d["event_types"])
                         if d.get("event_types") is not None else None),
            or_groups=tuple(
                tuple(Predicate(p["column"], p["op"], p["value"]) for p in g)
                for g in d.get("or_groups", ())),
            group_by=d.get("group_by"))

    def all_predicates(self) -> Tuple[Predicate, ...]:
        """Flat predicate order the device program indexes by: conjunctive
        predicates first, then each OR-group's members in declaration
        order."""
        return self.predicates + tuple(p for g in self.or_groups for p in g)

    def columns_needed(self) -> List[str]:
        """Every stored union column this query touches — the projection the
        segment reader pushes down (``type_id`` rides the chunk's structural
        columns and costs nothing extra)."""
        cols: List[str] = []
        for p in self.all_predicates():
            if p.column not in cols and p.column != "type_id":
                cols.append(p.column)
        for a in self.aggregates:
            if a.column and a.column not in cols and a.column != "type_id":
                cols.append(a.column)
        if self.group_by and self.group_by != "type_id" \
                and self.group_by not in cols:
            cols.append(self.group_by)
        return cols

    def signature(self) -> tuple:
        """Hashable program-cache key: everything that changes the program
        (values are inputs, so they are NOT part of the key — except each
        value's integrality, which picks the comparison dtype)."""
        return (tuple((p.column, p.op, _is_integral(p.value))
                      for p in self.predicates),
                tuple(tuple((p.column, p.op, _is_integral(p.value))
                            for p in g) for g in self.or_groups),
                tuple((a.op, a.column) for a in self.aggregates),
                self.event_types is not None)


@dataclass(frozen=True)
class StateQuery:
    """Projection + filter over FOLDED aggregate state columns: the segment's
    chunks fold through the replay engine, then predicates run over the
    resulting state columns and ``select`` projects the output."""

    select: Optional[Tuple[str, ...]] = None
    predicates: Tuple[Predicate, ...] = ()
    limit: Optional[int] = None

    def as_json(self) -> dict:
        out: dict = {"predicates": [p.as_json() for p in self.predicates]}
        if self.select is not None:
            out["select"] = list(self.select)
        if self.limit is not None:
            out["limit"] = self.limit
        return out

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "StateQuery":
        return cls(
            select=(tuple(d["select"]) if d.get("select") is not None
                    else None),
            predicates=tuple(Predicate(p["column"], p["op"], p["value"])
                             for p in d.get("predicates", ())),
            limit=d.get("limit"))


@dataclass
class QueryResult:
    """Grouped scan output: per-aggregate columns in chunk order."""

    aggregate_ids: Optional[List[str]]
    columns: Dict[str, np.ndarray]
    num_aggregates: int
    scanned_events: int
    matched_events: int
    chunks: int
    elapsed_s: float = 0.0

    def rows(self, limit: Optional[int] = None) -> List[dict]:
        """Row-oriented view (the RPC payload shape): one dict per aggregate."""
        names = list(self.columns)
        ids = (self.aggregate_ids if self.aggregate_ids is not None
               else [str(i) for i in range(self.num_aggregates)])
        n = self.num_aggregates if limit is None else min(limit,
                                                          self.num_aggregates)
        cols = [self.columns[k][:n].tolist() for k in names]
        return [{"aggregate_id": ids[j],
                 **{k: cols[i][j] for i, k in enumerate(names)}}
                for j in range(n)]


def _pow2(n: int, lo: int) -> int:
    cap = lo
    while cap < n:
        cap *= 2
    return cap


def _is_integral(v) -> bool:
    """Whether a predicate value is exactly an integer (picks the compare
    dtype: fractional values against integer columns compare in f32 —
    truncating them to the column dtype would corrupt <=/>=/==/!=)."""
    try:
        return float(v).is_integer()
    except (TypeError, ValueError):
        return True


def _apply_op_np(col, op: str, value):
    if op == "==":
        return col == value
    if op == "!=":
        return col != value
    if op == "<":
        return col < value
    if op == "<=":
        return col <= value
    if op == ">":
        return col > value
    return col >= value


def _pred_mask_one_np(col: np.ndarray, p: Predicate) -> np.ndarray:
    if not _is_integral(p.value) and col.dtype.kind != "f":
        # mirror the device program: fractional vs integer compares in f32,
        # not by truncating the value to the column dtype
        return _apply_op_np(col.astype(np.float32), p.op, np.float32(p.value))
    return _apply_op_np(col, p.op, np.asarray(p.value, dtype=col.dtype))


def predicate_mask_np(cols: Mapping[str, np.ndarray], type_ids: np.ndarray,
                      predicates: Sequence[Predicate],
                      or_groups: Sequence[Sequence[Predicate]] = ()
                      ) -> np.ndarray:
    """Host mirror of the device predicate mask, over DEVICE-dtype columns
    (cast them first — :func:`device_dtype`). Conjunctive ``predicates``
    AND together; each ``or_groups`` entry ORs internally then ANDs with the
    rest."""
    n = len(type_ids)
    mask = np.ones((n,), dtype=bool)
    for p in predicates:
        col = type_ids if p.column == "type_id" else cols[p.column]
        mask &= _pred_mask_one_np(col, p)
    for g in or_groups:
        hit = np.zeros((n,), dtype=bool)
        for p in g:
            col = type_ids if p.column == "type_id" else cols[p.column]
            hit |= _pred_mask_one_np(col, p)
        mask &= hit
    return mask


def _group_key_str(v, dt: np.dtype) -> str:
    """Stable string key for one group-by column value (views and changefeeds
    key rows by these across processes, so the format is part of the wire
    contract)."""
    if dt.kind in "iub":
        return str(int(v))
    return repr(float(v))


def _factorize_group(col: np.ndarray) -> Tuple[List[str], np.ndarray]:
    """Distinct values of a DEVICE-dtype group column → (string keys in
    ascending value order, int32 group index per event)."""
    vals, inv = np.unique(col, return_inverse=True)
    dt = np.dtype(col.dtype)
    return ([_group_key_str(v, dt) for v in vals],
            inv.astype(np.int32).reshape(-1))


def _sentinel(op: str, dt: np.dtype):
    """The identity element min/max partials carry until normalization."""
    if op == "min":
        return np.finfo(dt).max if dt.kind == "f" else np.iinfo(dt).max
    return np.finfo(dt).min if dt.kind == "f" else np.iinfo(dt).min


def _normalize_zero_match(out: Dict[str, np.ndarray], query: ScanQuery
                          ) -> Dict[str, np.ndarray]:
    """Zero-match aggregates report 0 everywhere: min/max sentinels flip to 0
    (the always-present ``count`` column is the tell; sum/count are already
    0). Runs ONCE, after any cross-chunk merge."""
    count = out["count"]
    for a in query.aggregates:
        if a.op in ("min", "max"):
            col = out[a.name]
            out[a.name] = np.where(count > 0, col, np.zeros((), col.dtype))
    return out


def _merge_scan_outputs(collected, query: ScanQuery, saw_ids: bool,
                        has_dup: bool, seen: Dict[str, int]):
    """Combine per-chunk RAW scan outputs into the final grouped columns.

    Disjoint chunks concatenate; chunks repeating an aggregate id (the delta
    chunks of an extended segment) MERGE into one row per id (count/sum add,
    min/max combine over the sentinel-carrying partials). Returns
    ``(aggregate_ids | None, columns)`` post-normalization."""
    agg_specs = [(a.op, a.name) for a in query.aggregates if a.op != "count"]
    if not (saw_ids and has_dup):
        parts: Dict[str, List[np.ndarray]] = {}
        ids: List[str] = []
        for ids_c, out in collected:
            for name, col in out.items():
                parts.setdefault(name, []).append(col)
            if saw_ids:
                ids.extend(ids_c)
        columns = {name: (np.concatenate(arrs) if arrs
                          else np.zeros((0,), np.int32))
                   for name, arrs in parts.items()}
        if not columns:
            columns = {"count": np.zeros((0,), np.int32)}
        return (ids if saw_ids else None,
                _normalize_zero_match(columns, query))
    b = len(seen)
    columns = {"count": np.zeros((b,), np.int32)}
    for ids_c, out in collected:
        if not ids_c:
            continue
        idxs = np.fromiter((seen[a] for a in ids_c), dtype=np.int64,
                           count=len(ids_c))
        np.add.at(columns["count"], idxs, out["count"])
        for op, name in agg_specs:
            col = out[name]
            if name not in columns:
                init = (0 if op == "sum"
                        else _sentinel(op, np.dtype(col.dtype)))
                columns[name] = np.full((b,), init, dtype=col.dtype)
            if op == "sum":
                np.add.at(columns[name], idxs, col)
            elif op == "min":
                np.minimum.at(columns[name], idxs, col)
            else:
                np.maximum.at(columns[name], idxs, col)
    order = [None] * b
    for a, i in seen.items():
        order[i] = a
    return order, _normalize_zero_match(columns, query)


def device_dtype(dt: np.dtype) -> np.dtype:
    """The dtype a column reduces in on the device: a 64-bit column as its
    32-bit kin, as the reference's with x64 off (its default)."""
    dt = np.dtype(dt)
    if dt.itemsize == 8:
        return np.dtype(np.int32 if dt.kind in "iu" else np.float32)
    return dt


def _compare(col: torch.Tensor, op: str, v: torch.Tensor) -> torch.Tensor:
    if col.dtype.is_floating_point:
        # the reference compares on the CPU with denormals-are-zero
        col, v = daz(col), daz(v)
    if op == "==":
        return col == v
    if op == "!=":
        return col != v
    if op == "<":
        return col < v
    if op == "<=":
        return col <= v
    if op == ">":
        return col > v
    return col >= v


class _ScanProgram:
    """One scan program (the reference's jitted ``local_scan``): the
    predicate mask in torch elementwise ops, then one grouped reduction.
    ``pred_vals`` arrive as float32, as the reference's do with x64 off, and
    cast to each column's dtype (or compare in float32 against a fractional
    value)."""

    def __init__(self, query: ScanQuery) -> None:
        self.preds = tuple((p.column, p.op, _is_integral(p.value))
                           for p in query.predicates)
        self.groups = tuple(tuple((p.column, p.op, _is_integral(p.value))
                                  for p in g) for g in query.or_groups)
        self.aggs = tuple((a.op, a.column, a.name) for a in query.aggregates
                          if a.op != "count")
        self.has_types = query.event_types is not None

    def mask(self, type_ids: torch.Tensor, valid: torch.Tensor,
             pred_vals: torch.Tensor, type_allow: torch.Tensor,
             cols: Mapping[str, torch.Tensor]) -> torch.Tensor:
        def compare(cname, op, integral, j):
            col = type_ids if cname == "type_id" else cols[cname]
            if not integral and not col.dtype.is_floating_point:
                # fractional value vs integer column: compare in f32
                return _compare(col.to(torch.float32), op, pred_vals[j])
            return _compare(col, op, pred_vals[j].to(col.dtype))

        mask = valid
        if self.has_types:
            hit_t = torch.zeros_like(mask)
            for t in type_allow.tolist():
                hit_t = hit_t | (type_ids == t)
            mask = mask & hit_t
        j = 0
        for cname, op, integral in self.preds:
            mask = mask & compare(cname, op, integral, j)
            j += 1
        for g in self.groups:
            hit = None
            for cname, op, integral in g:
                leg = compare(cname, op, integral, j)
                hit = leg if hit is None else hit | leg
                j += 1
            mask = mask & hit
        return mask

    def reduce(self, mask: torch.Tensor, type_ids: torch.Tensor,
               cols: Mapping[str, torch.Tensor], offsets: torch.Tensor,
               order: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        src = [type_ids if cname == "type_id" else cols[cname]
               for _, cname, _ in self.aggs]
        count, outs = scan_reduce(mask, src, [op for op, _, _ in self.aggs],
                                  offsets, order)
        out = {"count": count}
        for (_, _, oname), v in zip(self.aggs, outs):
            out[oname] = v
        return out


class QueryEngine:
    """Batched scan executor for one model family, on one device.

    One engine caches a scan program per (query signature, shape buckets,
    columns); chunks stream through :meth:`scan_chunks` /
    :meth:`scan_segment`. ``device=None`` is the CUDA card and raises when
    there is none (pass ``device="cpu"``); ``mesh`` raises (the multi-device
    item of ROADMAP.md)."""

    def __init__(self, spec, config: Config | None = None, mesh=None,
                 device=None) -> None:
        self.spec = spec
        self.registry = spec.registry
        self.config = config or default_config()
        if mesh is not None and self.config.get_bool("surge.query.mesh", True):
            raise NotImplementedError(
                f"QueryEngine(..., mesh=...) is not ported yet ({MULTI_DEVICE})")
        self.mesh = None
        self.device = _resolve_device(device)
        # normalized to a power of two, as the reference's bucket ladder
        self._event_bucket = _pow2(max(
            self.config.get_int("surge.query.chunk-events", 65536), 1), 1024)
        self._programs: dict = {}
        self._col_dtypes = {f.name: np.dtype(f.dtype)
                            for f in self.registry.union_columns()}
        self._type_ids = {s.cls.__name__: s.type_id
                          for s in self.registry.event_schemas}
        self.stats = {"scans": 0, "chunks": 0, "scanned_events": 0,
                      "matched_events": 0}
        #: host seconds of every scan so far, by stage (:data:`SCAN_STAGES`);
        #: on CUDA each device stage ends in a synchronize
        self.stage_s: Dict[str, float] = dict.fromkeys(SCAN_STAGES, 0.0)

    # -- helpers ------------------------------------------------------------------------

    def resolve_type_ids(self, names: Sequence[str]) -> np.ndarray:
        try:
            return np.asarray(sorted(self._type_ids[n] for n in names),
                              dtype=np.int32)
        except KeyError as exc:
            raise ValueError(
                f"unknown event type {exc.args[0]!r} (registry has "
                f"{sorted(self._type_ids)})") from None

    def _materialize_columns(self, colev: ColumnarEvents,
                             needed: Sequence[str]) -> Dict[str, np.ndarray]:
        """The query's columns from a chunk, deriving declared-derived ones
        (an ``ordinal`` column is positional — synthesized from agg_idx, the
        exact inverse of the segment writer's drop)."""
        out: Dict[str, np.ndarray] = {}
        for name in needed:
            col = colev.cols.get(name)
            if col is not None:
                out[name] = col
                continue
            kind = colev.derived_cols.get(name)
            if kind != "ordinal":
                raise ValueError(
                    f"query references column {name!r} which the chunk "
                    f"neither stores nor derives (has "
                    f"{sorted(colev.cols) + sorted(colev.derived_cols)})")
            n = colev.num_events
            starts = np.zeros(colev.num_aggregates + 1, dtype=np.int64)
            np.cumsum(np.bincount(colev.agg_idx,
                                  minlength=colev.num_aggregates),
                      out=starts[1:])
            dt = self._col_dtypes.get(name, np.dtype(np.int32))
            out[name] = (np.arange(n, dtype=np.int64)
                         - starts[colev.agg_idx] + 1).astype(dt)
        return out

    def _program(self, query: ScanQuery, n_bucket: int, b_bucket: int,
                 col_names: Tuple[str, ...]) -> _ScanProgram:
        key = (query.signature(), n_bucket, b_bucket, col_names)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = _ScanProgram(query)
        return prog

    def _lap(self, stage: str, t0: float, sync: bool = False) -> float:
        if sync:
            _sync(self.device)
        now = time.perf_counter()
        self.stage_s[stage] += now - t0
        return now

    # -- chunk / segment scans ----------------------------------------------------------

    def scan_chunk(self, colev: ColumnarEvents, query: ScanQuery
                   ) -> Dict[str, np.ndarray]:
        """Scan one chunk; returns ``{output: np[num_groups]}`` (always
        including ``count``). Zero-match groups report 0 everywhere."""
        return _normalize_zero_match(self._raw_scan(colev, query)[1], query)

    def _raw_scan(self, colev: ColumnarEvents, query: ScanQuery
                  ) -> Tuple[Optional[List[str]], Dict[str, np.ndarray]]:
        """The device scan of one chunk WITHOUT zero-match normalization:
        min/max keep their dtype sentinels, so per-chunk partials of a
        repeated group stay combinable. Returns ``(group keys, raw
        outputs)`` — the chunk's aggregate ids, or under ``group_by`` the
        distinct group-column values of THIS chunk as stable strings."""
        t0 = time.perf_counter()
        n = colev.num_events
        needed = tuple(query.columns_needed())
        cols_np = self._materialize_columns(colev, needed)
        if query.group_by is not None:
            gcol = (colev.type_ids if query.group_by == "type_id"
                    else cols_np[query.group_by])
            gcol = gcol.astype(device_dtype(gcol.dtype))
            ids, grp_idx = _factorize_group(gcol)
            b = len(ids)
        else:
            ids, grp_idx = colev.aggregate_ids, colev.agg_idx
            b = colev.num_aggregates
        n_bucket = _pow2(max(n, 1), self._event_bucket)
        b_bucket = _pow2(max(b, 1), 8)

        # padding as the reference pads: pad events are invalid, type -1,
        # columns 0 (they match nothing, so they change no group)
        type_p = np.full((n_bucket,), -1, dtype=np.int32)
        type_p[:n] = colev.type_ids
        cols_p: Dict[str, np.ndarray] = {}
        for name in needed:
            dt = device_dtype(cols_np[name].dtype)
            cp = np.zeros((n_bucket,), dtype=dt)
            cp[:n] = cols_np[name].astype(dt)
            cols_p[name] = cp
        pred_vals = np.asarray([p.value for p in query.all_predicates()],
                               dtype=np.float64).astype(np.float32)
        type_allow = (self.resolve_type_ids(query.event_types)
                      if query.event_types is not None
                      else np.zeros((0,), dtype=np.int32))
        prog = self._program(query, n_bucket, b_bucket, needed)
        t0 = self._lap("materialize", t0)

        dev = self.device
        up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        type_d = up(type_p)
        valid = torch.zeros((n_bucket,), dtype=torch.bool, device=dev)
        valid[:n] = True
        cols_d = {k: up(v) for k, v in cols_p.items()}
        offsets, order = group_csr(np.asarray(grp_idx), b_bucket, dev)
        t0 = self._lap("h2d", t0, sync=True)
        mask = prog.mask(type_d, valid, torch.from_numpy(pred_vals),
                         torch.from_numpy(type_allow), cols_d)
        t0 = self._lap("mask", t0, sync=True)
        out_dev = prog.reduce(mask, type_d, cols_d, offsets, order)
        t0 = self._lap("reduce", t0, sync=True)
        # in sorted name order, as the reference's jitted dict comes back
        out = {k: out_dev[k].cpu().numpy()[:b] for k in sorted(out_dev)}
        self._lap("pull", t0)
        return ids, out

    def scan_chunks(self, chunks: Iterable[ColumnarEvents], query: ScanQuery
                    ) -> QueryResult:
        """Scan a stream of chunks. Disjoint-aggregate chunks concatenate in
        chunk order; chunks REPEATING an aggregate id MERGE into one row per
        id — count/sum add, min/max combine, zero-match normalization after
        the merge. Chunks without aggregate ids keep the disjointness
        contract. Under ``group_by`` rows key by group value (a value
        recurring across chunks merges like a repeated id)."""
        t_start = time.perf_counter()
        collected: List[Tuple[Optional[List[str]], Dict[str, np.ndarray]]] = []
        saw_ids = True
        has_dup = False
        seen: Dict[str, int] = {}
        scanned = matched = n_chunks = 0
        it = iter(chunks)
        while True:
            t0 = time.perf_counter()
            colev = next(it, None)
            self._lap("read", t0)
            if colev is None:
                break
            ids_c, out = self._raw_scan(colev, query)
            collected.append((ids_c, out))
            scanned += colev.num_events
            matched += int(out["count"].sum())
            n_chunks += 1
            if ids_c is None:
                saw_ids = False
            elif saw_ids:
                for a in ids_c:
                    if a in seen:
                        has_dup = True
                    else:
                        seen[a] = len(seen)
        t0 = time.perf_counter()
        ids, columns = _merge_scan_outputs(collected, query, saw_ids,
                                           has_dup, seen)
        self._lap("merge", t0)
        self.stats["scans"] += 1
        self.stats["chunks"] += n_chunks
        self.stats["scanned_events"] += scanned
        self.stats["matched_events"] += matched
        return QueryResult(
            aggregate_ids=ids, columns=columns,
            num_aggregates=len(next(iter(columns.values()))),
            scanned_events=scanned, matched_events=matched, chunks=n_chunks,
            elapsed_s=time.perf_counter() - t_start)

    def scan_segment(self, path: str, query: ScanQuery,
                     partitions: Optional[set] = None) -> QueryResult:
        """Scan a committed columnar segment file. Only the columns the query
        touches are read (projection pushdown into the reader)."""
        from surge_tpu_torch.log.columnar import read_segment

        return self.scan_chunks(
            read_segment(path, partitions=partitions,
                         columns=query.columns_needed()),
            query)

    # -- state queries (fold + filter + project) ----------------------------------------

    def query_states(self, chunks: Iterable[ColumnarEvents],
                     query: StateQuery, replay_engine) -> QueryResult:
        """Fold the chunks' events to per-aggregate STATE through the port's
        replay engine, then filter on state columns and project ``select``.

        Chunks REPEATING an aggregate id (the delta chunks of an extended
        segment) fold as CONTINUATIONS: the repeated rows' carries and
        already-folded event counts seed the delta fold, and the final row is
        the complete state — one row per id."""
        t0 = time.perf_counter()
        chunk_list = list(chunks)
        state_names = [f.name for f in self.spec.registry.state.fields]
        dtypes = {f.name: np.dtype(f.dtype)
                  for f in self.spec.registry.state.fields}
        if any(c.aggregate_ids is None for c in chunk_list):
            # id-less chunks cannot be matched across chunks: keep the
            # disjoint-aggregate contract verbatim
            res = replay_engine.replay_columnar_chunks(chunk_list)
            states, ids_order = res.states, res.aggregate_ids
            num_events = res.num_events
        else:
            init_tree = self.spec.init_state_tree()
            index: Dict[str, int] = {}
            ids_order = []
            states = {n: np.zeros((0,), dtype=dtypes[n])
                      for n in state_names}
            folded = np.zeros((0,), dtype=np.int32)  # events per id so far
            num_events = 0
            for colev in chunk_list:
                b_c = colev.num_aggregates
                ids_c = colev.aggregate_ids
                rep = [(j, index[a]) for j, a in enumerate(ids_c)
                       if a in index]
                init_carry = None
                ord_base = None
                if rep:
                    # continuation: repeated rows resume from their folded
                    # carry + event count
                    init_carry = {n: np.full((b_c,), init_tree[n],
                                             dtype=dtypes[n])
                                  for n in state_names}
                    ord_base = np.zeros((b_c,), dtype=np.int32)
                    js = np.asarray([j for j, _ in rep], dtype=np.int64)
                    ks = np.asarray([k for _, k in rep], dtype=np.int64)
                    for n in state_names:
                        init_carry[n][js] = states[n][ks]
                    ord_base[js] = folded[ks]
                res = replay_engine.replay_columnar(
                    colev, init_carry=init_carry, ordinal_base=ord_base)
                counts_c = np.bincount(colev.agg_idx,
                                       minlength=b_c).astype(np.int32)
                num_events += res.num_events
                new = [j for j, a in enumerate(ids_c) if a not in index]
                if rep:
                    for n in state_names:
                        states[n][ks] = res.states[n][js]
                    folded[ks] += counts_c[js]
                if new:
                    nj = np.asarray(new, dtype=np.int64)
                    for n in state_names:
                        states[n] = np.concatenate(
                            [states[n], res.states[n][nj]])
                    folded = np.concatenate([folded, counts_c[nj]])
                    for j in new:
                        index[ids_c[j]] = len(ids_order)
                        ids_order.append(ids_c[j])
        n_rows = len(next(iter(states.values()))) if states else 0
        mask = np.ones((n_rows,), dtype=bool)
        for p in query.predicates:
            if p.column not in states:
                raise ValueError(
                    f"state query references unknown state column "
                    f"{p.column!r} (has {state_names})")
            mask &= _apply_op_np(states[p.column], p.op, p.value)
        select = list(query.select) if query.select is not None else state_names
        for name in select:
            if name not in states:
                raise ValueError(f"unknown state column {name!r} in select "
                                 f"(has {state_names})")
        idx = np.nonzero(mask)[0]
        if query.limit is not None:
            idx = idx[: query.limit]
        columns = {name: states[name][idx] for name in select}
        ids = ([ids_order[i] for i in idx]
               if ids_order is not None else None)
        self.stats["scans"] += 1
        self.stats["scanned_events"] += num_events
        return QueryResult(
            aggregate_ids=ids, columns=columns, num_aggregates=len(idx),
            scanned_events=num_events, matched_events=len(idx),
            chunks=len(chunk_list), elapsed_s=time.perf_counter() - t0)

    def query_states_segment(self, path: str, query: StateQuery,
                             replay_engine,
                             partitions: Optional[set] = None) -> QueryResult:
        from surge_tpu_torch.log.columnar import read_segment

        return self.query_states(read_segment(path, partitions=partitions),
                                 query, replay_engine)


# -- numpy host references (the golden the device scans must equal) ------------------


def scan_reference(chunks: Iterable[ColumnarEvents], query: ScanQuery,
                   registry) -> QueryResult:
    """Pure-numpy oracle for :meth:`QueryEngine.scan_chunks` — identical
    dtype discipline (64-bit columns reduce as their 32-bit kin), identical
    zero-match normalization."""
    type_ids_of = {s.cls.__name__: s.type_id for s in registry.event_schemas}
    union_dts = {f.name: np.dtype(f.dtype) for f in registry.union_columns()}
    collected: List[Tuple[Optional[List[str]], Dict[str, np.ndarray]]] = []
    saw_ids = True
    has_dup = False
    seen: Dict[str, int] = {}
    scanned = matched = n_chunks = 0
    for colev in chunks:
        n = colev.num_events
        cols: Dict[str, np.ndarray] = {}
        for name in query.columns_needed():
            col = colev.cols.get(name)
            if col is None and colev.derived_cols.get(name) == "ordinal":
                starts = np.zeros(colev.num_aggregates + 1, dtype=np.int64)
                np.cumsum(np.bincount(colev.agg_idx,
                                      minlength=colev.num_aggregates),
                          out=starts[1:])
                col = (np.arange(n, dtype=np.int64)
                       - starts[colev.agg_idx] + 1).astype(
                    union_dts.get(name, np.dtype(np.int32)))
            cols[name] = col.astype(device_dtype(col.dtype))
        if query.group_by is not None:
            gcol = (colev.type_ids if query.group_by == "type_id"
                    else cols[query.group_by])
            ids_c, grp_idx = _factorize_group(gcol)
            b = len(ids_c)
        else:
            ids_c, grp_idx = colev.aggregate_ids, colev.agg_idx
            b = colev.num_aggregates
        mask = np.ones((n,), dtype=bool)
        if query.event_types is not None:
            allow = {type_ids_of[t] for t in query.event_types}
            mask &= np.isin(colev.type_ids, sorted(allow))
        mask &= predicate_mask_np(cols, colev.type_ids, query.predicates,
                                  query.or_groups)
        count = np.zeros((b,), dtype=np.int32)
        np.add.at(count, grp_idx, mask.astype(np.int32))
        out: Dict[str, np.ndarray] = {"count": count}
        for a in query.aggregates:
            if a.op == "count":
                continue
            col = (colev.type_ids.astype(np.int32) if a.column == "type_id"
                   else cols[a.column])
            dt = col.dtype
            if a.op == "sum":
                acc = np.zeros((b,), dtype=dt)
                np.add.at(acc, grp_idx, np.where(mask, col,
                                                 np.zeros((), dt)))
            elif a.op == "min":
                big = _sentinel("min", dt)
                acc = np.full((b,), big, dtype=dt)
                np.minimum.at(acc, grp_idx,
                              np.where(mask, col, np.asarray(big, dt)))
            else:
                small = _sentinel("max", dt)
                acc = np.full((b,), small, dtype=dt)
                np.maximum.at(acc, grp_idx,
                              np.where(mask, col, np.asarray(small, dt)))
            out[a.name] = acc  # raw: sentinels normalize after the merge
        collected.append((ids_c, out))
        scanned += n
        matched += int(count.sum())
        n_chunks += 1
        if ids_c is None:
            saw_ids = False
        elif saw_ids:
            for a_id in ids_c:
                if a_id in seen:
                    has_dup = True
                else:
                    seen[a_id] = len(seen)
    ids, columns = _merge_scan_outputs(collected, query, saw_ids, has_dup,
                                       seen)
    return QueryResult(aggregate_ids=ids, columns=columns,
                       num_aggregates=len(next(iter(columns.values()))),
                       scanned_events=scanned, matched_events=matched,
                       chunks=n_chunks)


def state_query_reference(states: Mapping[str, np.ndarray],
                          aggregate_ids: Optional[Sequence[str]],
                          query: StateQuery) -> QueryResult:
    """Numpy oracle for :meth:`QueryEngine.query_states`, given already-folded
    state columns."""
    n = len(next(iter(states.values()))) if states else 0
    mask = np.ones((n,), dtype=bool)
    for p in query.predicates:
        mask &= _apply_op_np(states[p.column], p.op, p.value)
    idx = np.nonzero(mask)[0]
    if query.limit is not None:
        idx = idx[: query.limit]
    select = list(query.select) if query.select is not None else list(states)
    return QueryResult(
        aggregate_ids=([aggregate_ids[i] for i in idx]
                       if aggregate_ids is not None else None),
        columns={name: np.asarray(states[name])[idx] for name in select},
        num_aggregates=len(idx), scanned_events=0, matched_events=len(idx),
        chunks=1)
