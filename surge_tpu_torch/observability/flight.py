"""Broker flight recorder: a bounded ring of structured events + the merge
that reconstructs a failover timeline from several brokers' dumps.

The black-box tradition of production event-sourcing systems: metrics tell an
operator *that* a failover happened (``surge.log.failover.*`` counters); the
flight recorder tells them *what happened in what order* — role transitions,
epoch bumps, truncations, promotion decisions, compaction barriers, fault
firings, journal rotations — without grepping broker logs. Recording is
allocation-cheap (one tuple into a ``deque(maxlen=...)`` under a short lock)
so the sites stay armed in production; dumps are pulled over the broker's
``DumpFlight`` RPC, auto-written on fault-plane crash trips, and merged by
:func:`merge_dumps` into a single ordered timeline
(``tools/flight_timeline.py`` is the CLI; ``SURGE_BENCH_FAILOVER=1`` emits
the reconstruction alongside its 0-lost/0-dup verdict).

**Timestamps.** Every event carries ``mono`` (``time.monotonic()`` — ordering
truth within one host: CLOCK_MONOTONIC is shared by all processes on a Linux
host and never steps) and ``wall`` (``time.time()`` — human anchor, and the
only cross-host merge key). :func:`merge_dumps` orders by ``mono`` when every
dump names the same clock domain (host), by ``wall`` otherwise.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

__all__ = ["FlightRecorder", "merge_dumps", "reconstruct_failover",
           "same_clock_domain", "host_wall_offset"]


def same_clock_domain(dumps: Sequence[dict]) -> bool:
    """Whether every dump came from one host — monotonic timestamps are then
    comparable across them (CLOCK_MONOTONIC is host-shared on Linux); across
    hosts only wall time is, and consumers must key offsets accordingly."""
    return len({d.get("node") for d in dumps if d.get("events")}) <= 1


class FlightRecorder:
    """Bounded ring buffer of ``(seq, mono, wall, type, attrs)`` events.

    One per broker (and, since the fleet telemetry plane, one per ENGINE —
    publisher lane transitions, rebalance fan-out, resident-plane moves and
    health-bus restarts land in the same envelope shape, so engine and broker
    dumps interleave through :func:`merge_dumps` into one incident timeline).
    The cluster autobalancer records into a third lane (``role="balancer"``):
    a self-healing incident reconstructs end to end — kill, page, grace
    reassignment, balancer move, page clear — from one merged timeline.
    Thread-safe: the sites span gRPC handler threads, the replication worker,
    the group-sync thread and the liveness prober.
    """

    def __init__(self, capacity: int = 1024, name: str = "",
                 role: str = "broker") -> None:
        self._ring: "deque" = deque(maxlen=max(capacity, 8))
        self._lock = threading.Lock()
        self._seq = 0
        #: events the bounded ring evicted to make room — an operator reading
        #: a mid-incident dump must be able to tell the ring wrapped
        self._dropped = 0
        #: who recorded (the broker's advertised address, set lazily at
        #: start() — dumps from several brokers must be tellable apart)
        self.name = name
        #: which lane this recorder's events belong to on a merged timeline
        #: ("broker" | "engine"); carried in the dump envelope
        self.role = role
        self.node = socket.gethostname()

    def record(self, etype: str, **attrs) -> None:
        """Append one event; never raises (a recording site must not be able
        to take down the path it observes)."""
        try:
            with self._lock:
                self._seq += 1
                if len(self._ring) == self._ring.maxlen:
                    self._dropped += 1
                self._ring.append((self._seq, time.monotonic(), time.time(),
                                   etype, attrs or None))
        except Exception:  # noqa: BLE001 — observability must stay passive
            pass

    def stats(self) -> dict:
        """Ring occupancy view for status surfaces (BrokerStatus / the engine
        admin plane): whether the bounded ring has wrapped mid-incident."""
        with self._lock:
            return self._stats_locked()

    def _stats_locked(self) -> dict:
        return {"events": len(self._ring),
                "capacity": self._ring.maxlen,
                "dropped": self._dropped}

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def events(self, last: Optional[int] = None) -> List[dict]:
        """The recorded events, oldest first (``last`` keeps only the tail)."""
        with self._lock:
            items = list(self._ring)
        return self._format_events(items, last)

    @staticmethod
    def _format_events(items, last: Optional[int]) -> List[dict]:
        if last is not None:
            items = items[-last:] if last > 0 else []
        out = []
        for seq, mono, wall, etype, attrs in items:
            ev = {"seq": seq, "mono": mono, "wall": wall, "type": etype}
            if attrs:
                ev.update(attrs)
            out.append(ev)
        return out

    def dump(self, last: Optional[int] = None) -> dict:
        """The merge-ready dump envelope: events + clock-domain identity.
        ``dumped_mono``/``dumped_wall`` pair the host's two clocks at ONE
        instant — the header :func:`merge_dumps` estimates the per-host
        mono↔wall offset from, so cross-host merges survive wall-clock skew
        during the incident. Stats and events snapshot under ONE lock hold:
        a mid-incident dump's dropped count must describe exactly the event
        list it ships, not the ring three records later."""
        with self._lock:
            stats = self._stats_locked()
            items = list(self._ring)
        return {"recorder": self.name, "node": self.node, "pid": os.getpid(),
                "role": self.role, "stats": stats,
                "dumped_wall": time.time(), "dumped_mono": time.monotonic(),
                "events": self._format_events(items, last)}

    def dump_to(self, path: str, last: Optional[int] = None) -> None:
        """Write the dump as JSON (the crash auto-dump sink). Best-effort:
        a full disk must not mask the crash being dumped."""
        try:
            with open(path, "w") as f:
                json.dump(self.dump(last), f)
        except OSError:
            pass


def host_wall_offset(dump: dict) -> Optional[float]:
    """The per-host mono→wall offset estimated from the dump HEADER: the
    recorder stamps both clocks at the same instant when dumping, so
    ``dumped_wall - dumped_mono`` maps any of this host's monotonic stamps
    onto its wall timeline AS OF DUMP TIME. Placing events at
    ``offset + ev.mono`` instead of their raw ``wall`` stamp makes the
    cross-host merge immune to wall steps/skew DURING the incident (the NTP
    correction that lands mid-failover and would otherwise scramble raw wall
    ordering) — only the residual skew between hosts at dump time remains.
    None for a legacy dump without the header pair (raw wall fallback)."""
    dw, dm = dump.get("dumped_wall"), dump.get("dumped_mono")
    if dw is None or dm is None:
        return None
    return float(dw) - float(dm)


def merge_dumps(dumps: Sequence[dict]) -> List[dict]:
    """Merge several brokers' dumps into one ordered timeline.

    Each returned event gains ``recorder`` (who recorded it). Ordering: by
    ``mono`` when every dump came from the same host (CLOCK_MONOTONIC is
    host-shared, comparable across the brokers' processes and immune to NTP
    steps); across hosts by the ESTIMATED wall time ``host_wall_offset(dump)
    + ev.mono`` (per-host mono↔wall offsets from the dump headers — wall
    steps during the incident cannot scramble the order), falling back to
    each event's raw ``wall`` stamp only for legacy dumps without the header
    pair. Ties break by wall then per-recorder seq."""
    merged: List[dict] = []
    same_clock = same_clock_domain(dumps)
    for d in dumps:
        who = d.get("recorder") or d.get("node") or "?"
        lane = d.get("role") or "broker"
        offset = host_wall_offset(d)
        for ev in d.get("events", ()):
            e = dict(ev)
            e["recorder"] = who
            e["lane"] = lane
            e["_est_wall"] = (offset + e.get("mono", 0.0)
                              if offset is not None else e.get("wall", 0.0))
            merged.append(e)
    key = ((lambda e: (e.get("mono", 0.0), e.get("wall", 0.0), e.get("seq", 0)))
           if same_clock else
           (lambda e: (e.get("_est_wall", 0.0), e.get("wall", 0.0),
                       e.get("seq", 0))))
    merged.sort(key=key)
    for e in merged:
        del e["_est_wall"]
    return merged


#: the failover phases an incident review walks, in causal order, mapped to
#: the event types the broker records
_PHASE_NAMES = ("promotion_decision", "promotion", "fence", "truncation",
                "first_acked_commit")


def reconstruct_failover(merged: Sequence[dict]) -> dict:
    """Extract the failover phases from a merged timeline: promotion decision
    → promotion → fence → truncation → first acked post-failover commit.

    Phases are ANCHORED to the newest promotion in the ring (the incident an
    operator is looking at): the decision is the latest ``promote-decision``
    at or before it (the promotion itself when promotion was manual — no
    prober ever decided anything), and fence/truncation/first-ack are the
    first matching events from the decision onward. Without the anchor, a
    ring holding two incidents would stitch one incident's promotion to
    another's fence and report a healed failover that never healed.

    Returns ``{"phases": {name: event-or-None}, "complete": bool,
    "span_ms": float-or-None}`` — ``span_ms`` is decision → first ack in
    host-monotonic time (same-host dumps; None when either end is missing).

    Tolerates timelines with NO broker-shaped events at all — a merged set
    holding only engine-lane dumps (lane transitions, rebalances, SLO
    breaches) reconstructs to all-None phases with ``complete=False``
    instead of raising, and events missing ``mono`` stamps (hand-built or
    legacy dumps) simply yield no span."""
    merged = list(merged)
    phases: Dict[str, Optional[dict]] = {n: None for n in _PHASE_NAMES}
    promo_idx = max((i for i, e in enumerate(merged)
                     if e.get("type") == "role.promote"), default=None)
    if promo_idx is not None:
        phases["promotion"] = merged[promo_idx]
        decision_idx = max(
            (i for i, e in enumerate(merged[:promo_idx + 1])
             if e.get("type") == "role.promote-decision"),
            default=promo_idx)
        phases["promotion_decision"] = merged[decision_idx]
        for name, etype in (("fence", "role.fence"),
                            ("truncation", "log.truncate"),
                            ("first_acked_commit", "txn.first-ack")):
            phases[name] = next(
                (e for e in merged[decision_idx:] if e.get("type") == etype),
                None)
    complete = all(phases[n] is not None for n in _PHASE_NAMES)
    span_ms = None
    start, end = phases["promotion_decision"], phases["first_acked_commit"]
    if (start is not None and end is not None
            and start.get("recorder") == end.get("recorder")
            and start.get("mono") is not None
            and end.get("mono") is not None):
        # both phases are recorded by the PROMOTING broker (its prober
        # decides, its Transact acks), so their monotonic stamps share a
        # clock; a mismatch means hand-built dumps — no comparable span
        span_ms = round((end["mono"] - start["mono"]) * 1000.0, 1)
    return {"phases": phases, "complete": complete, "span_ms": span_ms}
