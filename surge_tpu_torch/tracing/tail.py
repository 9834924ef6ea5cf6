"""Tail-based trace sampling + the kept-trace ring (the command-anatomy
plane's capture half).

Head sampling (:class:`~surge_tpu_torch.tracing.Tracer` ``sample_rate``) decides
*per trace, up front, blind* — it bounds tracing cost but keeps a uniform
sample, which on a host with 2-3× run-to-run latency swings is almost all
boring traces. The :class:`TailSampler` decides *per trace, at the end,
informed*: every head-sampled span is buffered per trace id until the trace
quiesces (no span of it still open in this process), and the completed trace
is **kept** iff it

- **erred** — any span finished with ``status="error"``;
- **breached the latency threshold** — its slowest span (the local root
  covers every child) ran at least ``surge.trace.tail.latency-ms``;
- **landed in an SLO breach window** — the SLO burn-rate engine opened a
  window via :meth:`TailSampler.open_breach_window` (breach-adjacent traces
  are evidence even when individually fast); or
- was **marked** explicitly (:meth:`TailSampler.mark_trace` — exemplar ids a
  breach event cites must stay dumpable).

Keeps are **budgeted** (``surge.trace.tail.keep-budget`` per
``surge.trace.tail.budget-window-ms``): an incident that makes *every* trace
keep-worthy must not OOM the ring or the dump path; keep-eligible traces past
the budget are dropped and counted. The span buffer itself is bounded
(``surge.trace.tail.max-buffer-spans``): leaked or never-finishing traces are
evicted oldest-first, also counted. Drop counters ride
``surge.trace.dropped`` next to ``surge.trace.kept`` and the
``surge.trace.tail-buffer-spans`` gauge, on whichever quiver (engine or
broker) the installer wired.

Kept traces land in a :class:`TraceRing` — the flight-recorder pattern: a
bounded ring of merge-ready envelopes, pulled over the new ``DumpTraces``
RPCs (log-service for brokers, engine-admin for engines). The envelope
carries the host's two clocks stamped at one instant (``dumped_wall`` /
``dumped_mono``), so :mod:`surge_tpu_torch.observability.anatomy` can place spans
from several processes on one timeline through the same mono↔wall offset
estimation the flight merge uses — wall skew during the incident cannot
scramble a trace.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

from surge_tpu_torch.tracing import Span

__all__ = ["TailSampler", "TraceRing", "install_tail", "span_to_dict"]


def _span_ms(span: Span) -> float:
    """A span's duration from the MONOTONIC clock when both stamps exist —
    a wall step landing mid-span (the exact skew this module's envelope
    machinery defends against) must not shrink a slow span under the keep
    threshold or inflate a fast one over it."""
    if span.end_mono is not None:
        return max((span.end_mono - span.start_mono) * 1000.0, 0.0)
    return span.duration_ms


def span_to_dict(span: Span) -> dict:
    """The merge-ready span record: both clocks, tree identity, leg attrs."""
    return {
        "name": span.name,
        "trace_id": span.context.trace_id,
        "span_id": span.context.span_id,
        "parent_id": span.parent_id,
        "start_wall": span.start_time,
        "end_wall": span.end_time,
        "start_mono": span.start_mono,
        "end_mono": span.end_mono,
        "duration_ms": _span_ms(span),
        "status": span.status,
        "attributes": dict(span.attributes),
        "events": [{"time": t, "name": n, "attributes": a}
                   for t, n, a in span.events],
    }


class TraceRing:
    """Bounded ring of kept traces (the flight recorder's trace twin).

    One per broker and one per engine. Thread-safe: keeps arrive from gRPC
    handler threads, publisher lane threads and the event loop alike.
    ``dump()`` returns the merge-ready envelope — recorder identity, ring
    stats, the mono↔wall header pair, and one entry per kept trace
    (``{"trace_id", "reason", "spans"}``; a trace whose late spans finished
    after its keep decision may appear as several entries — consumers group
    by trace id).
    """

    def __init__(self, capacity: int = 256, name: str = "",
                 role: str = "broker") -> None:
        self._ring: "deque" = deque(maxlen=max(capacity, 4))
        self._lock = threading.Lock()
        #: kept traces the bounded ring evicted to make room — a dump reader
        #: must be able to tell the ring wrapped mid-incident
        self._dropped = 0
        self._kept_total = 0
        self.name = name  # set lazily (broker: advertised addr at start())
        self.role = role  # "broker" | "engine" — the merged-timeline lane
        self.node = socket.gethostname()

    def keep(self, trace_id: str, reason: str, spans: List[dict]) -> None:
        """Retain one completed trace; never raises (the sampler must not be
        able to take down the path it observes)."""
        try:
            with self._lock:
                self._kept_total += 1
                if len(self._ring) == self._ring.maxlen:
                    self._dropped += 1
                self._ring.append({"trace_id": trace_id, "reason": reason,
                                   "spans": spans})
        except Exception:  # noqa: BLE001 — observability stays passive
            pass

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def stats(self) -> dict:
        with self._lock:
            return self._stats_locked()

    def _stats_locked(self) -> dict:
        return {"traces": len(self._ring),
                "capacity": self._ring.maxlen,
                "kept_total": self._kept_total,
                "dropped": self._dropped}

    def trace_ids(self, last: int = 3) -> List[str]:
        """The newest ``last`` kept trace ids (newest first) — what an SLO
        breach event cites as its exemplars."""
        with self._lock:
            items = list(self._ring)[-max(last, 0):]
        seen: List[str] = []
        for entry in reversed(items):
            tid = entry["trace_id"]
            if tid not in seen:
                seen.append(tid)
        return seen

    def dump(self, last: Optional[int] = None) -> dict:
        """The merge-ready dump envelope. Stats and entries snapshot under
        ONE lock hold; ``dumped_wall``/``dumped_mono`` pair the host's two
        clocks at one instant — the header anatomy.py estimates this host's
        mono↔wall offset from."""
        with self._lock:
            stats = self._stats_locked()
            items = list(self._ring)
        if last is not None:
            items = items[-last:] if last > 0 else []
        return {"recorder": self.name, "node": self.node, "pid": os.getpid(),
                "role": self.role, "stats": stats,
                "dumped_wall": time.time(), "dumped_mono": time.monotonic(),
                "traces": items}

    def dump_to(self, path: str, last: Optional[int] = None) -> None:
        """Write the dump as JSON (best-effort, like the flight twin)."""
        try:
            with open(path, "w") as f:
                json.dump(self.dump(last), f)
        except OSError:
            pass


class _TraceBuf:
    """Per-trace buffer while the trace is in flight: finished span dicts +
    how many of its spans are still open in this process."""

    __slots__ = ("spans", "open", "erred", "max_ms")

    def __init__(self) -> None:
        self.spans: List[dict] = []
        self.open = 0
        self.erred = False
        self.max_ms = 0.0


class TailSampler:
    """Buffers head-sampled spans per trace; keeps completed traces that
    erred / breached latency / landed in a breach window (module doc).

    Attach via :func:`install_tail` (or ``tracer.tail = sampler``). The
    tracer calls :meth:`on_start`/:meth:`on_finish` for sampled spans only —
    head sampling remains the fast-path cost gate.
    """

    def __init__(self, ring: TraceRing, latency_ms: float = 250.0,
                 keep_budget: int = 64, budget_window_s: float = 10.0,
                 max_buffer_spans: int = 4096,
                 breach_window_s: float = 30.0,
                 metrics=None, clock=time.monotonic) -> None:
        self.ring = ring
        self.latency_ms = latency_ms
        self.keep_budget = max(keep_budget, 1)
        self.budget_window_s = budget_window_s
        self.max_buffer_spans = max(max_buffer_spans, 8)
        self.breach_window_s = breach_window_s
        self.metrics = metrics  # quiver with trace_kept/trace_dropped/
        #                         trace_tail_buffer (engine or broker)
        self._clock = clock
        self._lock = threading.Lock()
        #: insertion-ordered: eviction under the buffer bound walks oldest
        #: traces first
        self._buf: Dict[str, _TraceBuf] = {}
        self._buffered_spans = 0
        self._keeps: "deque" = deque()  # keep stamps inside the budget window
        #: recently kept trace ids → keep reason (bounded): spans finishing
        #: AFTER their trace's keep decision (a pipelined retry leg) append
        #: straight to the ring under the original verdict
        self._kept_recent: "OrderedDict[str, str]" = OrderedDict()
        self._breach_until = 0.0
        self._marked: set = set()
        self.kept = 0
        #: drop tallies by reason: "sampled-out" (completed, nothing
        #: keep-worthy), "budget" (keep-worthy past the window budget),
        #: "buffer" (evicted by the span-buffer bound before completing)
        self.dropped: Dict[str, int] = {"sampled-out": 0, "budget": 0,
                                        "buffer": 0}

    @classmethod
    def from_config(cls, config, ring: TraceRing,
                    metrics=None) -> "TailSampler":
        return cls(
            ring,
            latency_ms=config.get_float("surge.trace.tail.latency-ms", 250.0),
            keep_budget=config.get_int("surge.trace.tail.keep-budget", 64),
            budget_window_s=config.get_seconds(
                "surge.trace.tail.budget-window-ms", 10_000),
            max_buffer_spans=config.get_int(
                "surge.trace.tail.max-buffer-spans", 4096),
            breach_window_s=config.get_seconds(
                "surge.trace.tail.breach-window-ms", 30_000),
            metrics=metrics)

    # -- tracer hooks (never raise: recording must not break the traced path) --

    def on_start(self, span: Span) -> None:
        try:
            with self._lock:
                buf = self._buf.get(span.context.trace_id)
                if buf is None:
                    buf = self._buf[span.context.trace_id] = _TraceBuf()
                buf.open += 1
        except Exception:  # noqa: BLE001 — observability stays passive
            pass

    def on_finish(self, span: Span) -> None:
        try:
            self._on_finish(span)
        except Exception:  # noqa: BLE001 — observability stays passive
            pass

    def _on_finish(self, span: Span) -> None:
        tid = span.context.trace_id
        keep: Optional[tuple] = None
        fresh_keep = False
        evicted = 0
        with self._lock:
            buf = self._buf.get(tid)
            reason = self._kept_recent.get(tid)
            if reason is not None:
                # the trace was already kept (a late span finishing after
                # the decision — a pipelined retry leg): append straight
                # through under the original verdict, flushing anything the
                # start hook re-buffered meanwhile
                spans = [span_to_dict(span)]
                if buf is not None:
                    spans = buf.spans + spans
                    self._buffered_spans -= len(buf.spans)
                    self._buf.pop(tid, None)
                keep = (tid, reason, spans)
            else:
                if buf is None:
                    # finish without a start: a span created before the
                    # sampler attached, or its trace was evicted mid-flight —
                    # re-open so a late keep-worthy leg is not silently lost
                    buf = self._buf[tid] = _TraceBuf()
                    buf.open = 1
                buf.spans.append(span_to_dict(span))
                self._buffered_spans += 1
                buf.open = max(buf.open - 1, 0)
                if span.status == "error":
                    buf.erred = True
                buf.max_ms = max(buf.max_ms, _span_ms(span))
                if buf.open == 0:
                    keep = self._decide_locked(tid, buf)
                    fresh_keep = keep is not None
                evicted = self._evict_over_bound_locked()
            buffered = self._buffered_spans
        if keep is not None:
            self.ring.keep(*keep)
        m = self.metrics
        if m is not None:
            if fresh_keep:
                m.trace_kept.record()
            if evicted:
                m.trace_dropped.record(evicted)
            m.trace_tail_buffer.record(buffered)

    # -- decision -------------------------------------------------------------------------

    def _decide_locked(self, tid: str, buf: _TraceBuf) -> Optional[tuple]:
        """Keep/drop a quiescent trace; returns the ring entry to keep (the
        actual ring append happens outside the lock) or None."""
        now = self._clock()
        reason = None
        if buf.erred:
            reason = "error"
        elif buf.max_ms >= self.latency_ms:
            reason = "latency"
        elif tid in self._marked:
            reason = "marked"
        elif now < self._breach_until:
            reason = "breach-window"
        self._marked.discard(tid)
        if reason is None:
            self._drop_locked(tid, buf, "sampled-out")
            return None
        while self._keeps and self._keeps[0] < now - self.budget_window_s:
            self._keeps.popleft()
        if len(self._keeps) >= self.keep_budget:
            self._drop_locked(tid, buf, "budget")
            return None
        self._keeps.append(now)
        self.kept += 1
        self._kept_recent[tid] = reason
        while len(self._kept_recent) > 1024:
            self._kept_recent.popitem(last=False)
        spans, buf.spans = buf.spans, []
        self._buffered_spans -= len(spans)
        self._buf.pop(tid, None)
        return (tid, reason, spans)

    def _drop_locked(self, tid: str, buf: _TraceBuf, why: str) -> None:
        self.dropped[why] = self.dropped.get(why, 0) + 1
        self._buffered_spans -= len(buf.spans)
        self._buf.pop(tid, None)
        if self.metrics is not None:
            self.metrics.trace_dropped.record()

    def _evict_over_bound_locked(self) -> int:
        """Evict oldest traces while the span buffer exceeds its bound (a
        leaked span's trace never quiesces; unbounded growth is not an
        option). Returns evictions for the out-of-lock counter."""
        evicted = 0
        while self._buffered_spans > self.max_buffer_spans and self._buf:
            tid, buf = next(iter(self._buf.items()))
            self.dropped["buffer"] += 1
            self._buffered_spans -= len(buf.spans)
            self._buf.pop(tid, None)
            evicted += 1
        return evicted

    # -- SLO / exemplar wiring ------------------------------------------------------------

    def open_breach_window(self, duration_s: Optional[float] = None) -> None:
        """Keep every trace completing within the window (the SLO engine
        calls this when an objective breaches: breach-adjacent traces are the
        anatomy evidence, even the individually fast ones)."""
        with self._lock:
            self._breach_until = max(
                self._breach_until,
                self._clock() + (duration_s if duration_s is not None
                                 else self.breach_window_s))

    def mark_trace(self, trace_id: str) -> None:
        """Force-keep one trace when it completes (exemplar ids cited by a
        breach event must stay dumpable)."""
        with self._lock:
            self._marked.add(trace_id)

    def stats(self) -> dict:
        with self._lock:
            return {"buffered_spans": self._buffered_spans,
                    "buffered_traces": len(self._buf),
                    "kept": self.kept, "dropped": dict(self.dropped),
                    "breach_window_open":
                        self._clock() < self._breach_until}


def install_tail(tracer, config, *, name: str = "", role: str = "broker",
                 metrics=None) -> Optional[TraceRing]:
    """Attach tail sampling + a kept-trace ring to ``tracer`` (idempotent).

    Returns the ring (the ``DumpTraces`` RPC's source), or None when tracing
    is off (``tracer is None``) or ``surge.trace.tail.enabled`` is false.
    A tracer shared between co-resident components keeps the FIRST
    installer's ring — spans from all of them land in one ring, which is
    exactly what a single-process deployment wants dumped.
    """
    if tracer is None or not config.get_bool("surge.trace.tail.enabled", True):
        return None
    existing = getattr(tracer, "tail", None)
    if existing is not None:
        return existing.ring
    ring = TraceRing(
        capacity=config.get_int("surge.trace.ring-capacity", 256),
        name=name, role=role)
    tracer.tail = TailSampler.from_config(config, ring, metrics=metrics)
    return ring
