"""Deterministic, seedable fault-injection plane for the log substrate.

"Simple Testing Can Prevent Most Critical Failures" (Yuan et al., OSDI '14)
found most production outages live in untested error-handling paths. Before
this module every failure-semantics test hand-rolled its own monkeypatching;
this is the shared plane those paths are exercised through instead — the
broker (:mod:`surge_tpu_torch.log.server`), the FileLog WAL
(:mod:`surge_tpu_torch.log.file`) and the chaos tooling (``tools/chaos.py``,
``SURGE_BENCH_FAILOVER=1``) all consult one :class:`FaultPlane`.

**Sites.** Instrumented code names the point it is passing through; rules
match sites by ``fnmatch`` pattern:

- ``rpc.<Method>`` — an inbound broker RPC (``rpc.Transact``,
  ``rpc.Replicate``, ``rpc.*``): actions ``drop`` (answer UNAVAILABLE — the
  message never arrives), ``delay``/``reorder`` (hold the handler; reorder
  draws a random hold in ``[0, delay_ms]`` per message, which permutes
  concurrent pipelined seqs), ``dup`` (run the handler twice — exercises
  idempotent ingest / txn dedup), ``error`` (answer UNAVAILABLE with the
  rule's message).
- ``ship.<target>`` — a leader→follower replication ship: ``drop``/``error``
  fail the ship (the follower never sees it — drives ISR eviction), ``delay``
  stalls it.
- ``fsync.journal`` — a FileLog group-sync round: ``error`` fails the round
  (every covered commit sees the failure), ``stall``/``delay`` holds it.
- ``journal.write`` — tear the journal line: the rule's ``fraction`` of the
  line's bytes are written, then :class:`SimulatedCrash` raises (recovery
  must discard the torn tail).
- ``crash.<point>`` — named crash points (``crash.transact.post-apply``,
  ``crash.repl.pre-ship``, the handoff's ``crash.handoff.pre-promote`` /
  ``crash.handoff.post-promote`` …): the broker hard-stops (socket closes,
  in-flight calls answer UNAVAILABLE) exactly there. Cluster-scale RPC sites
  ride the same ``rpc.*`` pattern (``rpc.VoteLeader`` drops starve a quorum;
  ``rpc.InstallSlice`` drops stall a handoff's bulk phase).

**Determinism.** One seeded :class:`random.Random` drives every probability
draw and reorder hold, in call order, under a lock — the same seed against
the same workload schedule fires the same faults. ``times`` bounds how often
a rule fires; ``after`` skips its first N matches (fire on the Nth
crossing, not the first).

Arm it three ways: construct and pass (``FileLog(..., faults=plane)``,
``LogServer(..., faults=plane)``); from config
(``surge.log.faults.plan`` — a named plan or a JSON rule list, with
``surge.log.faults.seed``); or at runtime via the broker's ``ArmFaults`` RPC
(`tools/chaos.py` is the operator CLI for it).
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from fnmatch import fnmatchcase
from random import Random
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["FaultPlane", "FaultRule", "SimulatedCrash", "NAMED_PLANS"]


class SimulatedCrash(Exception):
    """Raised at an armed crash point / torn write: the component must stop
    exactly here, as a real power cut would."""


@dataclass
class FaultRule:
    """One armed fault. ``site`` is an fnmatch pattern against the site names
    above; ``action`` one of drop | delay | reorder | dup | error | stall |
    torn | crash; ``p`` the per-crossing fire probability; ``times`` caps
    total fires (None = unlimited); ``after`` skips the first N matching
    crossings; ``delay_ms`` parameterizes delay/reorder/stall; ``fraction``
    how much of a torn write survives; ``error`` the injected message."""

    site: str
    action: str  # drop|delay|reorder|dup|error|stall|torn|crash|corrupt
    p: float = 1.0
    times: Optional[int] = 1
    after: int = 0
    delay_ms: float = 50.0
    fraction: float = 0.5
    error: str = "fault injected"
    fired: int = field(default=0, compare=False)
    seen: int = field(default=0, compare=False)

    def as_dict(self) -> dict:
        return {"site": self.site, "action": self.action, "p": self.p,
                "times": self.times, "after": self.after,
                "delay_ms": self.delay_ms, "fraction": self.fraction,
                "error": self.error, "fired": self.fired, "seen": self.seen}

    @staticmethod
    def from_dict(obj: dict) -> "FaultRule":
        known = {"site", "action", "p", "times", "after", "delay_ms",
                 "fraction", "error"}
        return FaultRule(**{k: v for k, v in obj.items() if k in known})


#: operator-nameable fault plans (tools/chaos.py arms them by name). Each is a
#: rule-list factory so repeated arms get fresh fire counters.
NAMED_PLANS: Dict[str, Callable[[], List[FaultRule]]] = {
    # kill the leader right after a commit applied locally but before it
    # enqueues for replication — the canonical lost-unreplicated-tail crash
    "leader-crash-mid-commit": lambda: [
        FaultRule(site="crash.transact.post-apply", action="crash")],
    # kill the leader after the batch is queued for replication but before
    # the client is acked (retry + dedup territory)
    "leader-crash-pre-ack": lambda: [
        FaultRule(site="crash.transact.post-enqueue", action="crash")],
    # every ship to every follower fails: drives ISR eviction, then commits
    # proceed at min-insync
    "follower-blackhole": lambda: [
        FaultRule(site="ship.*", action="drop", times=None)],
    # flaky network: 20% of ships fail, 20% of RPCs take an extra 0-40ms
    "flaky-network": lambda: [
        FaultRule(site="ship.*", action="drop", p=0.2, times=None),
        FaultRule(site="rpc.Transact", action="reorder", p=0.2, times=None,
                  delay_ms=40.0)],
    # one journal fsync round fails, later rounds heal (the transient-disk
    # hiccup the broker's retry ladder must absorb)
    "fsync-hiccup": lambda: [
        FaultRule(site="fsync.journal", action="error", times=1)],
    # tear the next journal write mid-line and crash
    "torn-journal": lambda: [
        FaultRule(site="journal.write", action="torn", fraction=0.5)],
    # cluster-scale: drop every VoteLeader RPC this broker receives — a
    # candidate that cannot reach this voter must fail its majority and
    # stand down instead of promoting on its own liveness view
    "vote-blackhole": lambda: [
        FaultRule(site="rpc.VoteLeader", action="drop", times=None)],
    # kill the old leader mid-handoff, AFTER the journal tail shipped but
    # BEFORE the destination promoted: the handoff must fail cleanly (no
    # second leader minted) and the normal kill-failover path takes over
    "handoff-crash-pre-promote": lambda: [
        FaultRule(site="crash.handoff.pre-promote", action="crash")],
    # silent state rot: flip one bit in one resident slab row at the end of
    # the next refresh round (post-fold, post-ack — the log stays correct,
    # the device slab lies). Only the consistency auditor's shadow replay
    # can see this; the corruption-to-page e2e arms it and expects a
    # state-divergence page within 3 audit cycles.
    "corrupt.slab-row": lambda: [
        FaultRule(site="corrupt.slab-row", action="corrupt")],
    # silent replica rot: flip one bit in one record's payload as the NEXT
    # replication ship is ingested on this (follower) broker — leader and
    # follower logs diverge below the hwm with no error anywhere. Only the
    # cross-replica digest compare can see this.
    "corrupt.segment-payload": lambda: [
        FaultRule(site="corrupt.segment-payload", action="corrupt")],
}


class FaultPlane:
    """The armed rule set + the deterministic decision engine."""

    def __init__(self, rules: Optional[Sequence[FaultRule]] = None,
                 seed: int = 0, metrics=None,
                 clock: Callable[[float], None] = time.sleep) -> None:
        self._lock = threading.Lock()
        self._rng = Random(seed)
        self.seed = seed
        self.rules: List[FaultRule] = list(rules or [])
        self.metrics = metrics  # EngineMetrics quiver (optional)
        self._sleep = clock
        #: crash hook installed by the component hosting the plane (the
        #: broker's hard-stop); called once, before SimulatedCrash raises
        self.on_crash: Optional[Callable[[str], None]] = None
        #: optional FlightRecorder (surge_tpu_torch.observability): every fired
        #: rule joins the host's black-box ring, so a post-incident timeline
        #: shows which injected fault preceded which transition
        self.flight = None
        self.injected = 0
        self.crashed: Optional[str] = None  # first crash point that fired

    # -- arming ---------------------------------------------------------------------------

    @staticmethod
    def from_spec(spec: str, seed: int = 0, metrics=None) -> "FaultPlane":
        """Build a plane from a named plan or a JSON rule list / object
        (``{"seed": ..., "rules": [...]}`` or bare ``[...]``)."""
        plan = NAMED_PLANS.get(spec.strip())
        if plan is not None:
            return FaultPlane(plan(), seed=seed, metrics=metrics)
        obj = json.loads(spec)
        if isinstance(obj, dict):
            seed = int(obj.get("seed", seed))
            rules = [FaultRule.from_dict(r) for r in obj.get("rules", [])]
        else:
            rules = [FaultRule.from_dict(r) for r in obj]
        return FaultPlane(rules, seed=seed, metrics=metrics)

    @staticmethod
    def from_config(config) -> Optional["FaultPlane"]:
        """The config arming path (``surge.log.faults.plan``); None when no
        plan is configured — the hot paths then skip every hook."""
        spec = config.get_str("surge.log.faults.plan", "") if config else ""
        if not spec:
            return None
        return FaultPlane.from_spec(spec,
                                    seed=config.get_int(
                                        "surge.log.faults.seed", 0))

    def arm(self, rules: Sequence[FaultRule], seed: Optional[int] = None) -> None:
        """Replace the armed rule set (the ArmFaults RPC path)."""
        with self._lock:
            if seed is not None:
                self._rng = Random(seed)
                self.seed = seed
            self.rules = list(rules)
            self.crashed = None
            self._record_armed()

    def disarm(self) -> None:
        with self._lock:
            self.rules = []
            self._record_armed()

    def stats(self) -> dict:
        with self._lock:
            return {"seed": self.seed, "injected": self.injected,
                    "crashed": self.crashed,
                    "rules": [r.as_dict() for r in self.rules]}

    def _record_armed(self) -> None:
        if self.metrics is not None:
            self.metrics.faults_armed.record(len(self.rules))

    # -- decision engine ------------------------------------------------------------------

    def _match(self, site: str) -> Optional[FaultRule]:
        """First matching armed rule that elects to fire (seeded draw, seen /
        after / times bookkeeping). Caller holds no locks."""
        with self._lock:
            for rule in self.rules:
                if not fnmatchcase(site, rule.site):
                    continue
                rule.seen += 1
                if rule.seen <= rule.after:
                    continue
                if rule.times is not None and rule.fired >= rule.times:
                    continue
                if rule.p < 1.0 and self._rng.random() >= rule.p:
                    continue
                rule.fired += 1
                self.injected += 1
                if self.metrics is not None:
                    self.metrics.faults_injected.record()
                if self.flight is not None:
                    self.flight.record("fault.fire", site=site,
                                       action=rule.action)
                return rule
        return None

    def _hold_s(self, rule: FaultRule) -> float:
        if rule.action == "reorder":
            with self._lock:
                return self._rng.random() * rule.delay_ms / 1000.0
        return rule.delay_ms / 1000.0

    # -- hook surface (what instrumented code calls) --------------------------------------

    def on_rpc(self, method: str) -> Optional[FaultRule]:
        """Inbound-RPC site. Returns the fired rule for the caller to apply
        (the broker wrapper owns drop/dup semantics); delay/reorder/stall are
        applied HERE so every caller gets them uniformly."""
        rule = self._match(f"rpc.{method}")
        if rule is not None and rule.action in ("delay", "reorder", "stall"):
            self._sleep(self._hold_s(rule))
        return rule

    def on_ship(self, target: str) -> Optional[str]:
        """Leader→follower ship site: an error string fails the ship (as a
        transport error would); None lets it proceed (after any delay)."""
        rule = self._match(f"ship.{target}")
        if rule is None:
            return None
        if rule.action in ("delay", "reorder", "stall"):
            self._sleep(self._hold_s(rule))
            return None
        return f"fault injected ({rule.action}): {rule.error}"

    def on_fsync(self, which: str) -> None:
        """fsync-round site: raises to fail the round, sleeps to stall it."""
        rule = self._match(f"fsync.{which}")
        if rule is None:
            return
        if rule.action in ("stall", "delay", "reorder"):
            self._sleep(self._hold_s(rule))
            return
        raise OSError(f"fault injected: fsync {which} failed ({rule.error})")

    def torn(self, site: str, data: bytes) -> Optional[bytes]:
        """Torn-write site: the surviving prefix to write before crashing, or
        None to write normally."""
        rule = self._match(site)
        if rule is None or rule.action != "torn":
            return None
        keep = max(1, int(len(data) * rule.fraction))
        return data[:min(keep, len(data) - 1)]

    def raise_point(self, site: str) -> None:
        """Exception-injection site (action "error"): raises RuntimeError at
        a named internal point — e.g. ``raise.repl.iteration`` poisons the
        replication worker's head item deterministically."""
        rule = self._match(f"raise.{site}")
        if rule is not None and rule.action == "error":
            raise RuntimeError(f"fault injected at {site}: {rule.error}")

    def point(self, site: str) -> None:
        """Generic in-process site matched on the BARE site name (no
        prefix): delay/stall rules hold the caller, error rules raise.
        The resident plane's refresh executor passes through
        ``resident.refresh.dispatch`` — the device-observatory stall
        anatomy e2e arms a delay here and expects the round's
        device-dispatch leg to dominate its kept tail trace."""
        rule = self._match(site)
        if rule is None:
            return
        if rule.action in ("delay", "reorder", "stall"):
            self._sleep(self._hold_s(rule))
        elif rule.action == "error":
            raise RuntimeError(f"fault injected at {site}: {rule.error}")

    def corrupt_point(self, site: str) -> bool:
        """Corruption site matched on the bare name: True when an armed
        ``corrupt`` rule fires and the caller must rot its own state (the
        resident plane's ``corrupt.slab-row`` flips a bit in one live slab
        row). The caller owns the mutation — the plane only decides."""
        rule = self._match(site)
        return rule is not None and rule.action == "corrupt"

    def corrupt_records(self, site: str, records):
        """Record-stream corruption site: when an armed ``corrupt`` rule
        fires, returns a copy of ``records`` with one bit flipped in one
        record's value (the replication-ingest ``corrupt.segment-payload``
        site — the follower durably applies bytes the leader never sent).
        Otherwise returns ``records`` unchanged."""
        rule = self._match(site)
        if rule is None or rule.action != "corrupt" or not records:
            return records
        import dataclasses

        with self._lock:
            i = self._rng.randrange(len(records))
        victim = records[i]
        value = victim.value or b""
        if not value:
            flipped = b"\x01"
        else:
            j = len(value) // 2
            flipped = value[:j] + bytes([value[j] ^ 0x01]) + value[j + 1:]
        out = list(records)
        out[i] = dataclasses.replace(victim, value=flipped)
        return out

    def crash_point(self, name: str) -> None:
        """Named crash point: fires the host's hard-stop then raises."""
        rule = self._match(f"crash.{name}")
        if rule is None or rule.action != "crash":
            return
        with self._lock:
            if self.crashed is None:
                self.crashed = name
        hook = self.on_crash
        if hook is not None:
            try:
                hook(name)
            except Exception:  # noqa: BLE001 — the crash must still happen
                pass
        raise SimulatedCrash(f"crash point {name!r} fired")
