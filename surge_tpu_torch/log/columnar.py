"""Columnar event-log segments, the bulk-replay storage format — the port's
copy of ``surge_tpu/log/columnar.py``: :class:`ColumnarSegmentWriter` (chunks,
snapshot sections, and the incremental ``extend`` with its watermark
sections), :func:`read_segment`, :func:`segment_info`,
:func:`read_segment_snapshots`, :func:`build_segment_from_topic` and
:func:`extend_segment_from_topic`. The file format is the reference's, byte
for byte, the delta chunks and watermark sections of an extend included
(framed in an ``EXTB`` section).

The port writes every payload raw (codec 0), which the reference reads; a
payload the reference stored SLZ-compressed (codec 1) raises on read
(:func:`surge_tpu_torch.log.segment.slz_decompress`).

Layout (little-endian):
    magic "SCOL" | u32 header_len | header JSON |
    per section: u32 marker | u32 meta_len | meta JSON | payloads
    - chunk section ("CHK1"): column payloads in meta order; meta may carry an
      "ids" payload (newline-joined aggregate-id strings)
    - snapshot section ("SNP1"): one uvarint-framed key/value blob holding the
      latest state snapshots of aggregates absent from the events topic
    - watermark section ("WMK1", no payload): extend-time watermarks
    - extend frame ("EXTB"): u32 length of the delta sections that follow; a
      torn frame is ignored wholesale
Header JSON: {"columns": {name: dtype_str}, "derived": {...}, "type_dtype": str,
              "agg_dtype": str, "extra": {...}}.
Chunk meta JSON: {"num_aggregates": n, "num_events": m,
                  "cols": [[name, codec, stored_len, raw_len], ...],
                  "ids": [codec, stored_len, raw_len] | absent,
                  "partition": p | absent, + per-chunk schema overrides}.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Iterable, Iterator, Optional

import numpy as np

from surge_tpu_torch.codec.tensor import ColumnarEvents
from surge_tpu_torch.log import segment as seg

MAGIC = b"SCOL"
CHUNK_MARKER = 0x43484B31  # "CHK1"
SNAPSHOT_MARKER = 0x534E5031  # "SNP1"
WATERMARK_MARKER = 0x574D4B31  # "WMK1": extend-time watermark override
EXTEND_MARKER = 0x45585442  # "EXTB": length-framed extend batch


def _read_payload(data: bytes, codec: int, raw_len: int) -> bytes:
    if codec == seg.CODEC_SLZ:
        return seg.slz_decompress(data, raw_len)
    return data


class ColumnarSegmentWriter:
    """Writes a fresh segment (aggregate-range chunks, then snapshot
    sections), or extends an existing one (:meth:`extend`)."""

    def __init__(self, path: str, extra_header: Optional[dict] = None) -> None:
        self.path = path
        self._file = None
        self._schema: Optional[dict] = None
        self._extra = dict(extra_header or {})
        self._extend_target: Optional[str] = None

    @classmethod
    def extend(cls, path: str) -> "ColumnarSegmentWriter":
        """Open an existing segment for appending delta sections. The header
        stays as it is; updated watermarks ride a watermark section
        (:meth:`write_watermarks`), and chunks whose schema differs from the
        header's carry per-chunk overrides in their meta. The delta sections
        are staged in memory and appended on ``close()`` as ONE length-framed
        ``EXTB`` section (fsync'd): readers check the frame's length, so a
        torn append is ignored whole."""
        import io

        with open(path, "rb") as f:
            head = f.read(8)
            if head[:4] != MAGIC:
                raise ValueError(f"{path}: not a columnar segment")
            (hlen,) = struct.unpack("<I", head[4:8])
            schema = json.loads(f.read(hlen))
        w = cls(path, extra_header=schema.get("extra"))
        w._schema = schema
        w._file = io.BytesIO()
        w._extend_target = path
        return w

    def write_watermarks(self, watermarks: dict,
                         state_watermarks: Optional[dict] = None) -> None:
        """Append a watermark-override section: readers treat the LAST one as
        authoritative over the header's build-time extra."""
        if self._file is None:
            raise ValueError("no open segment")
        meta_obj: dict = {"watermarks": {str(k): int(v)
                                         for k, v in watermarks.items()}}
        if state_watermarks is not None:
            meta_obj["state_watermarks"] = {str(k): int(v)
                                            for k, v in state_watermarks.items()}
        meta = json.dumps(meta_obj).encode()
        self._file.write(struct.pack("<II", WATERMARK_MARKER, len(meta)) + meta)

    def _write_header(self, schema: dict) -> None:
        # a per-build identity (the restore's wire cache keys on it), and any
        # wire cache of a previous build at this path goes
        import shutil
        import uuid

        self._extra.setdefault("build_id", uuid.uuid4().hex)
        shutil.rmtree(f"{self.path}.wires", ignore_errors=True)
        self._file = open(self.path, "wb")
        header = json.dumps(schema).encode()
        self._file.write(MAGIC + struct.pack("<I", len(header)) + header)
        self._schema = schema

    def append(self, colev: ColumnarEvents,
               partition: Optional[int] = None) -> None:
        """Append one chunk: a disjoint aggregate range (ids chunk-local
        0..n), with ``colev.aggregate_ids`` when set. ``partition`` records
        the chunks' source partition for a partition-scoped restore. A chunk
        whose schema differs from the header's carries per-chunk overrides."""
        colev = colev.sorted_by_aggregate()
        schema = {
            "columns": {name: str(col.dtype) for name, col in sorted(colev.cols.items())},
            "derived": dict(colev.derived_cols),
            "type_dtype": str(colev.type_ids.dtype),
            "agg_dtype": str(colev.agg_idx.dtype),
            "extra": self._extra,
        }
        overrides: dict = {}
        if self._file is None:
            self._write_header(schema)
        elif schema != self._schema:
            overrides = {"dtypes": schema["columns"],
                         "chunk_derived": schema["derived"],
                         "type_dtype": schema["type_dtype"],
                         "agg_dtype": schema["agg_dtype"]}
        cols_meta = []
        payloads = []
        for name, arr in [("agg_idx", colev.agg_idx), ("type_ids", colev.type_ids)] + \
                sorted(colev.cols.items()):
            raw = np.ascontiguousarray(arr).tobytes()
            cols_meta.append([name, seg.CODEC_RAW, len(raw), len(raw)])
            payloads.append(raw)
        meta_obj = {
            "num_aggregates": colev.num_aggregates,
            "num_events": colev.num_events,
            "cols": cols_meta,
            **overrides,
        }
        if partition is not None:
            meta_obj["partition"] = int(partition)
        if colev.aggregate_ids is not None:
            if len(colev.aggregate_ids) != colev.num_aggregates:
                raise ValueError("aggregate_ids length != num_aggregates")
            if any("\n" in i or not i for i in colev.aggregate_ids):
                raise ValueError("aggregate ids must be non-empty and newline-free "
                                 "(newline is the id separator)")
            raw = "\n".join(colev.aggregate_ids).encode()
            meta_obj["ids"] = [seg.CODEC_RAW, len(raw), len(raw)]
            payloads.append(raw)
        meta = json.dumps(meta_obj).encode()
        self._file.write(struct.pack("<II", CHUNK_MARKER, len(meta)) + meta)
        for p in payloads:
            self._file.write(p)

    def append_snapshots(self, items, partition: Optional[int] = None) -> None:
        """Write a snapshot section: ``(key, value bytes)`` pairs of the
        aggregates the events topic does not cover; ``partition`` scopes it
        to one source state partition."""
        if self._file is None:
            raise ValueError("append at least one chunk before snapshots")
        blob = bytearray()
        count = 0
        for key, value in items:
            kb = key.encode()
            seg._put_uvarint(blob, len(kb))
            blob += kb
            seg._put_uvarint(blob, len(value))
            blob += value
            count += 1
        raw = bytes(blob)
        meta_obj = {"count": count, "blob": [seg.CODEC_RAW, len(raw), len(raw)]}
        if partition is not None:
            meta_obj["partition"] = int(partition)
        meta = json.dumps(meta_obj).encode()
        self._file.write(struct.pack("<II", SNAPSHOT_MARKER, len(meta)) + meta)
        self._file.write(raw)

    def close(self) -> None:
        if self._file is None:
            return
        if self._extend_target is not None:
            blob = self._file.getvalue()
            self._file = None
            if blob:
                frame = struct.pack("<II", EXTEND_MARKER, len(blob))
                with open(self._extend_target, "ab") as f:
                    f.write(frame + blob)
                    f.flush()
                    os.fsync(f.fileno())
            return
        self._file.flush()
        self._file.close()
        self._file = None

    def __enter__(self) -> "ColumnarSegmentWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _sections(f, size: int):
    """Walk a segment's sections after the header: yields ``(marker,
    meta)`` with the file positioned at the section's payloads. An extend
    frame yields ``(EXTEND_MARKER, None)`` once validated (a torn one ends
    the walk); its inner sections follow as ordinary sections."""
    while True:
        prefix = f.read(8)
        if len(prefix) < 8:
            return  # end of file (or torn final append)
        marker, mlen = struct.unpack("<II", prefix)
        if marker == EXTEND_MARKER:
            if size - f.tell() < mlen:
                return
            yield marker, None
            continue
        if marker not in (CHUNK_MARKER, SNAPSHOT_MARKER, WATERMARK_MARKER):
            raise ValueError(f"{f.name}: bad section marker {marker:#x}")
        yield marker, json.loads(f.read(mlen))


def _chunk_bytes(meta: dict) -> int:
    return sum(c[2] for c in meta["cols"]) + (meta["ids"][1] if "ids" in meta else 0)


def _open(path: str):
    f = open(path, "rb")
    head = f.read(8)
    if head[:4] != MAGIC:
        f.close()
        raise ValueError(f"{path}: not a columnar segment")
    (hlen,) = struct.unpack("<I", head[4:8])
    header = json.loads(f.read(hlen))
    return f, header, os.fstat(f.fileno()).st_size


def read_segment(path: str, partitions: Optional[set] = None,
                 columns: Optional[Iterable[str]] = None
                 ) -> Iterator[ColumnarEvents]:
    """Stream the segment's chunks as ColumnarEvents (``frombuffer`` views
    of the column bytes), each with its global chunk ordinal
    (``source_ordinal``). ``partitions`` keeps only chunks recorded for
    those source partitions (chunks without one always pass); the payloads
    of the rest are seeked past.

    ``columns`` is the query engine's projection pushdown: when given, only
    those union columns (plus the structural ``agg_idx``/``type_ids`` and the
    id payload) are read, and every other column payload is seeked past. The
    chunks then carry exactly the projected ``cols``."""
    if partitions is not None:
        partitions = {int(p) for p in partitions}
    wanted = None if columns is None else set(columns)
    f, header, size = _open(path)
    with f:
        col_dtypes = {name: np.dtype(dt) for name, dt in header["columns"].items()}
        type_dtype = np.dtype(header["type_dtype"])
        agg_dtype = np.dtype(header["agg_dtype"])
        derived = dict(header.get("derived", {}))
        ordinal = -1  # global chunk ordinal (counts filtered chunks too)
        for marker, meta in _sections(f, size):
            if marker in (EXTEND_MARKER, WATERMARK_MARKER):
                continue
            if marker == SNAPSHOT_MARKER:
                f.seek(meta["blob"][1], 1)
                continue
            ordinal += 1
            if (partitions is not None and "partition" in meta
                    and meta["partition"] not in partitions):
                f.seek(_chunk_bytes(meta), 1)
                continue
            c_cols = ({n: np.dtype(d) for n, d in meta["dtypes"].items()}
                      if "dtypes" in meta else col_dtypes)
            c_type = np.dtype(meta["type_dtype"]) if "type_dtype" in meta else type_dtype
            c_agg = np.dtype(meta["agg_dtype"]) if "agg_dtype" in meta else agg_dtype
            c_derived = (dict(meta["chunk_derived"]) if "chunk_derived" in meta
                         else dict(derived))
            arrays = {}
            for name, codec, stored_len, raw_len in meta["cols"]:
                if (wanted is not None and name not in ("agg_idx", "type_ids")
                        and name not in wanted):
                    f.seek(stored_len, 1)  # projected out: never read
                    continue
                dtype = (c_agg if name == "agg_idx"
                         else c_type if name == "type_ids" else c_cols[name])
                arrays[name] = np.frombuffer(
                    _read_payload(f.read(stored_len), codec, raw_len), dtype=dtype)
            ids = None
            if "ids" in meta:
                codec, stored_len, raw_len = meta["ids"]
                raw = _read_payload(f.read(stored_len), codec, raw_len)
                ids = raw.decode().split("\n") if raw else []
                if len(ids) != meta["num_aggregates"]:
                    raise ValueError(
                        f"{path}: id count {len(ids)} != aggregates "
                        f"{meta['num_aggregates']} — corrupt chunk")
            yield ColumnarEvents(
                num_aggregates=meta["num_aggregates"],
                agg_idx=arrays.pop("agg_idx"),
                type_ids=arrays.pop("type_ids"),
                cols=arrays,
                derived_cols=c_derived,
                aggregate_ids=ids,
                source_ordinal=ordinal)


def segment_info(path: str) -> dict:
    """Totals and schema without reading column payloads. The schema's
    ``extra`` watermarks are the last watermark section's, so an extended
    segment reports its post-extend coverage."""
    total_aggregates = total_events = num_chunks = num_snapshots = 0
    num_extends = 0
    f, header, size = _open(path)
    with f:
        for marker, meta in _sections(f, size):
            if marker == EXTEND_MARKER:
                num_extends += 1
            elif marker == WATERMARK_MARKER:
                header.setdefault("extra", {}).update(meta)
            elif marker == SNAPSHOT_MARKER:
                f.seek(meta["blob"][1], 1)
                num_snapshots += meta["count"]
            else:
                f.seek(_chunk_bytes(meta), 1)
                total_aggregates += meta["num_aggregates"]
                total_events += meta["num_events"]
                num_chunks += 1
    return {"schema": header, "num_aggregates": total_aggregates,
            "num_events": total_events, "num_chunks": num_chunks,
            "num_snapshots": num_snapshots, "num_extends": num_extends}


def read_segment_snapshots(path: str,
                           partitions: Optional[set] = None) -> Iterator[tuple]:
    """Stream the snapshot sections' ``(key, value)`` pairs. ``partitions``
    keeps only sections recorded for those source state partitions (sections
    without one always pass)."""
    if partitions is not None:
        partitions = {int(p) for p in partitions}
    f, _, size = _open(path)
    with f:
        for marker, meta in _sections(f, size):
            if marker in (EXTEND_MARKER, WATERMARK_MARKER):
                continue
            if marker == CHUNK_MARKER:
                f.seek(_chunk_bytes(meta), 1)
                continue
            if (partitions is not None and "partition" in meta
                    and meta["partition"] not in partitions):
                f.seek(meta["blob"][1], 1)
                continue
            codec, stored_len, raw_len = meta["blob"]
            raw = _read_payload(f.read(stored_len), codec, raw_len)
            pos = 0
            for _ in range(meta["count"]):
                klen, pos = seg._get_uvarint(raw, pos)
                key = raw[pos: pos + klen].decode()
                pos += klen
                vlen, pos = seg._get_uvarint(raw, pos)
                value = raw[pos: pos + vlen]
                pos += vlen
                yield key, value


def _drop_derived(colev: ColumnarEvents, derived_cols: dict) -> None:
    """Remove the columns the device re-derives, after checking that the
    data really is what the derivation gives."""
    n = colev.num_events
    if n:
        starts = np.zeros(colev.num_aggregates + 1, dtype=np.int64)
        np.cumsum(np.bincount(colev.agg_idx, minlength=colev.num_aggregates),
                  out=starts[1:])
        ordinal = np.arange(n, dtype=np.int64) - starts[colev.agg_idx] + 1
    for name, kind in derived_cols.items():
        col = colev.cols.get(name)
        if col is not None:
            if kind == "ordinal" and n and not np.array_equal(
                    col.astype(np.int64), ordinal):
                raise ValueError(
                    f"column {name!r} declared derived as ordinal but its values "
                    f"are not positional — refusing to drop it")
            del colev.cols[name]
        colev.derived_cols[name] = kind


def build_segment_from_topic(log, topic: str, registry, deserialize_event,
                             path: str, partitions=None,
                             encode_event=None,
                             derived_cols: Optional[dict] = None,
                             chunk_aggregates: int = 65536,
                             state_topic: Optional[str] = None) -> dict:
    """Events topic → columnar segment. Reads every partition's records up to
    the watermarks captured first, groups events per aggregate (key) and
    writes per-partition chunks of at most ``chunk_aggregates`` sorted keys,
    with their ids; ``deserialize_event`` takes a :class:`SerializedMessage`
    and ``encode_event`` maps each event to its tensor-schema form. The
    header's ``extra`` records the watermarks; with ``state_topic``, the
    latest snapshots of aggregates absent from the events topic ride
    snapshot sections. Records are spilled raw to one file per chunk, so a
    chunk's events are decoded one chunk at a time. Returns
    ``{"aggregate_order": [...], **segment_info(path)}``."""
    import shutil
    import tempfile

    from surge_tpu_torch.codec.tensor import encode_events_columnar
    from surge_tpu_torch.log.transport import page_keyed_records
    from surge_tpu_torch.serialization import SerializedMessage

    if partitions is None:
        partitions = range(log.num_partitions(topic))
    partitions = list(partitions)
    wm_int = {p: log.end_offset(topic, p) for p in partitions}
    watermarks = {str(p): off for p, off in wm_int.items()}

    def scan(p: int):
        return page_keyed_records(log, topic, p, upto=wm_int[p])

    # pass 1: key census (key → source partition)
    key_partition: dict[str, int] = {}
    for p in partitions:
        for r in scan(p):
            key_partition[r.key] = p
    ordered: list[str] = []
    chunk_plan: list[tuple[int, list[str]]] = []  # (partition, keys)
    for p in partitions:
        keys_p = sorted(k for k, kp in key_partition.items() if kp == p)
        ordered.extend(keys_p)
        for start in range(0, len(keys_p), chunk_aggregates):
            chunk_plan.append((p, keys_p[start: start + chunk_aggregates]))
    chunk_of = {k: i for i, (_, ks) in enumerate(chunk_plan) for k in ks}

    extra: dict = {"topic": topic, "watermarks": watermarks}
    snapshots_by_partition: dict[int, list[tuple]] = {}
    if state_topic is not None:
        state_watermarks: dict[str, int] = {}
        for p in range(log.num_partitions(state_topic)):
            for key, rec in log.latest_by_key(state_topic, p).items():
                if key not in key_partition and rec.value:
                    snapshots_by_partition.setdefault(p, []).append((key, rec.value))
            state_watermarks[str(p)] = log.end_offset(state_topic, p)
        extra["state_topic"] = state_topic
        extra["state_watermarks"] = state_watermarks

    # pass 2: spill each record's raw bytes into its chunk's file
    spill_dir = tempfile.mkdtemp(prefix=".scol-build-",
                                 dir=os.path.dirname(path) or ".")
    try:
        spills = [open(os.path.join(spill_dir, f"c{i}"), "wb", buffering=1 << 20)
                  for i in range(len(chunk_plan))]
        try:
            for p in partitions:
                for r in scan(p):
                    kb = r.key.encode()
                    frame = bytearray()
                    seg._put_uvarint(frame, len(kb))
                    frame += kb
                    seg._put_uvarint(frame, len(r.value))
                    frame += r.value
                    spills[chunk_of[r.key]].write(frame)
        finally:
            for f in spills:
                f.close()

        def chunk_events(i: int, chunk_ids: list) -> list:
            with open(os.path.join(spill_dir, f"c{i}"), "rb") as f:
                data = f.read()
            by_key: dict[str, list] = {k: [] for k in chunk_ids}
            pos = 0
            while pos < len(data):
                klen, pos = seg._get_uvarint(data, pos)
                key = data[pos: pos + klen].decode()
                pos += klen
                vlen, pos = seg._get_uvarint(data, pos)
                ev = deserialize_event(SerializedMessage(
                    key=key, value=data[pos: pos + vlen]))
                pos += vlen
                if encode_event is not None:
                    ev = encode_event(ev)
                by_key[key].append(ev)
            return [by_key[a] for a in chunk_ids]

        with ColumnarSegmentWriter(path, extra_header=extra) as writer:
            if not chunk_plan:  # empty topic: one empty schema-bearing chunk
                colev = encode_events_columnar(registry, [])
                if derived_cols:
                    _drop_derived(colev, derived_cols)
                colev.aggregate_ids = []
                writer.append(colev)
            for i, (p, chunk_ids) in enumerate(chunk_plan):
                colev = encode_events_columnar(registry, chunk_events(i, chunk_ids))
                if derived_cols:
                    _drop_derived(colev, derived_cols)
                colev.aggregate_ids = list(chunk_ids)
                writer.append(colev, partition=p)
            for p in sorted(snapshots_by_partition):
                writer.append_snapshots(snapshots_by_partition[p], partition=p)
    finally:
        shutil.rmtree(spill_dir, ignore_errors=True)
    return {"aggregate_order": ordered, **segment_info(path)}


def extend_segment_from_topic(log, topic: str, registry, deserialize_event,
                              path: str, encode_event=None,
                              chunk_aggregates: int = 65536,
                              state_topic: Optional[str] = None) -> dict:
    """Incremental segment maintenance: append DELTA chunks covering the
    events between the segment's recorded watermarks and the topic's current
    end, a snapshot section for aggregates whose post-build changes were
    state-only, then a watermark-override section. No-op when nothing new
    exists. Returns ``segment_info(path)``.

    Delta chunks declare no derived columns: their events' ordinals continue
    each aggregate's, so positional columns are stored (the chunk meta
    carries the schema override) and the restore continues each aggregate's
    fold from its already-restored state."""
    from surge_tpu_torch.codec.tensor import encode_events_columnar
    from surge_tpu_torch.log.transport import page_keyed_records
    from surge_tpu_torch.serialization import SerializedMessage

    info = segment_info(path)
    extra = info["schema"].get("extra", {})
    base_wm = {int(p): int(off)
               for p, off in (extra.get("watermarks") or {}).items()}
    partitions = sorted(base_wm) if base_wm else list(
        range(log.num_partitions(topic)))

    # the new watermark is captured BEFORE the scan and clamps it: commits
    # that land mid-extend wait for the next extend
    delta: dict[int, dict[str, list]] = {}
    new_wm: dict[str, int] = {}
    delta_keys: set[str] = set()
    for p in partitions:
        new_wm[str(p)] = log.end_offset(topic, p)
        per_key: dict[str, list] = {}
        for r in page_keyed_records(log, topic, p, start=base_wm.get(p, 0),
                                    upto=int(new_wm[str(p)])):
            ev = deserialize_event(SerializedMessage(key=r.key, value=r.value))
            if encode_event is not None:
                ev = encode_event(ev)
            per_key.setdefault(r.key, []).append(ev)
            delta_keys.add(r.key)
        if per_key:
            delta[p] = per_key

    state_wm: Optional[dict] = None
    snapshots_by_partition: dict[int, list[tuple]] = {}
    if state_topic is not None:
        base_state_wm = {int(p): int(off) for p, off in
                         (extra.get("state_watermarks") or {}).items()}
        state_wm = {}
        for p in range(log.num_partitions(state_topic)):
            # aggregates changed in the delta window WITHOUT delta events
            # (state-only publishes): carry their newest snapshot
            window_keys: set = set()
            offset = base_state_wm.get(p, 0)
            while True:
                batch = log.read(state_topic, p, from_offset=offset,
                                 max_records=10_000)
                if not batch:
                    break
                window_keys.update(r.key for r in batch
                                   if r.key is not None
                                   and r.key not in delta_keys)
                offset = batch[-1].offset + 1
            if window_keys:
                latest = log.latest_by_key(state_topic, p)
                items = [(k, latest[k].value) for k in sorted(window_keys)
                         if k in latest and latest[k].value]
                if items:
                    snapshots_by_partition[p] = items
            state_wm[str(p)] = log.end_offset(state_topic, p)

    if not delta and not snapshots_by_partition:
        return info

    # a key living only in snapshot sections has no chunk state to continue a
    # fold from: its delta goes in as a fresh snapshot, not an event chunk
    snapshot_keys = {k for k, _ in read_segment_snapshots(path)}
    with ColumnarSegmentWriter.extend(path) as writer:
        for p in sorted(delta):
            keys = sorted(k for k in delta[p] if k not in snapshot_keys)
            demoted = sorted(k for k in delta[p] if k in snapshot_keys)
            if demoted and state_topic is not None:
                latest = log.latest_by_key(state_topic, p)
                snapshots_by_partition.setdefault(p, []).extend(
                    (k, latest[k].value) for k in demoted
                    if k in latest and latest[k].value)
            for start in range(0, len(keys), chunk_aggregates):
                chunk_ids = keys[start: start + chunk_aggregates]
                colev = encode_events_columnar(
                    registry, [delta[p][k] for k in chunk_ids])
                colev.aggregate_ids = list(chunk_ids)
                writer.append(colev, partition=p)
        for p in sorted(snapshots_by_partition):
            writer.append_snapshots(snapshots_by_partition[p], partition=p)
        writer.write_watermarks(new_wm, state_wm)
    return segment_info(path)
