"""Event-loop starvation prober.

The asyncio re-derivation of the reference's thread-starvation detector
(``ExecutionContextProber`` — internal/utils/ExecutionContextProber.scala:17-172,
config ``surge.execution-context-prober.*`` in common reference.conf:291-302): the
reference schedules no-op probes on a target ExecutionContext and warns when they
don't run within a timeout. Here the hazard is blocking the single event loop (long
synchronous serialization, accidental sync IO, an unyielding fold), so the probe is a
timestamped ``sleep(interval)`` whose *lateness* measures how long the loop was
unavailable; sustained lateness past the threshold emits a health signal and a log
warning with the same "possible starvation" message intent.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Callable, Optional

from surge_tpu_torch.common import logger
from surge_tpu_torch.config import Config, default_config


class BrokerLivenessProber:
    """Thread-based peer-liveness prober for the (synchronous) log broker:
    pings a target on an interval and declares it DEAD after a streak of
    consecutive failures — the failure-detector half of automatic leader
    failover (``surge.log.failover.*``). A follower runs one against its
    leader; ``on_dead`` fires exactly once (self-promotion), after which the
    prober retires itself.

    Deliberately conservative: one slow probe never kills a leader — only an
    unbroken failure streak does — and the declare threshold × interval is
    the unavailability floor an operator tunes against split-brain risk
    (docs/operations.md failover runbook)."""

    def __init__(self, target: str, ping: Callable[[], None],
                 config: Config | None = None,
                 on_dead: Optional[Callable[[], None]] = None,
                 on_signal: Optional[Callable[[str, str], None]] = None,
                 flight=None) -> None:
        cfg = config or default_config()
        self.target = target
        #: optional FlightRecorder: the promotion DECISION (leader declared
        #: dead) is the failover timeline's opening event — it must be
        #: reconstructable even though no RPC ever carries it
        self.flight = flight
        self.interval_s = cfg.get_seconds(
            "surge.log.failover.probe-interval-ms", 1_000)
        self.failures_needed = max(1, cfg.get_int(
            "surge.log.failover.probe-failures", 3))
        self._ping = ping
        self._on_dead = on_dead or (lambda: None)
        self._on_signal = on_signal or (lambda name, level: None)
        #: bootstrap grace: a peer NEVER seen alive is probably still booting
        #: (follower started first) — promoting over it would split the brain
        #: the moment it arrives, so the declare threshold is multiplied
        #: until the first successful probe. Bounded, not infinite: a leader
        #: that truly never comes up must still fail over eventually.
        self.bootstrap_factor = max(1, cfg.get_int(
            "surge.log.failover.bootstrap-grace-factor", 10))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.failure_streak = 0
        self.declared_dead = False
        self.probes = 0
        self.ever_alive = False
        #: re-arms after a retired declaration (lost campaigns, stand-downs):
        #: a broker that loses N consecutive elections must STILL detect the
        #: next real leader death — this counts the proof
        self.rearms = 0

    def start(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name=f"surge-broker-prober-{self.target}",
                daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(self.interval_s + 2.0)
        self._thread = None

    def reset(self) -> None:
        """Re-arm after a retired declaration (quorum candidacy lost its vote
        round: the leader may yet return, or the true new leader's stream
        will repoint us) — clears the dead verdict and restarts probing.
        Callable from the prober's own on_dead callback: the current run is
        RETIRING (it returns right after on_dead), so start() must spawn a
        fresh thread instead of seeing the still-alive current one and
        doing nothing. Callable from ANY other thread too: a retiring run
        that has not unwound yet is waited out briefly, so the re-arm can
        never be swallowed by start() observing a corpse as alive (the
        repeated-election case — stand down, re-arm, stand down, re-arm —
        must stay armed however many campaigns are lost)."""
        self.declared_dead = False
        self.failure_streak = 0
        self.rearms += 1
        thread = self._thread
        if thread is threading.current_thread():
            self._thread = None
        elif thread is not None and thread.is_alive():
            self._stop.set()
            thread.join(self.interval_s + 2.0)
            self._stop.clear()
            self._thread = None
        self.start()

    def retarget(self, target: str) -> None:
        """Point the prober at a NEW leader (cluster repoint after another
        broker won promotion): fresh streak, bootstrap grace re-applies until
        the new leader is seen alive once."""
        self.stop()
        self.target = target
        self.failure_streak = 0
        self.declared_dead = False
        self.ever_alive = False
        self._stop.clear()
        self.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.probes += 1
            try:
                self._ping()
                self.failure_streak = 0
                self.ever_alive = True
            except Exception as exc:  # noqa: BLE001 — the failure being counted
                needed = self.failures_needed * (
                    1 if self.ever_alive else self.bootstrap_factor)
                self.failure_streak += 1
                logger.warning("broker %s probe failed (%d/%d): %r",
                               self.target, self.failure_streak,
                               needed, exc)
                self._on_signal("broker.probe-failed", "warning")
                if self.failure_streak >= needed:
                    self.declared_dead = True
                    logger.error("broker %s declared DEAD after %d "
                                 "consecutive probe failures", self.target,
                                 self.failure_streak)
                    self._on_signal("broker.dead", "error")
                    if self.flight is not None:
                        self.flight.record("role.promote-decision",
                                           dead_leader=self.target,
                                           failure_streak=self.failure_streak,
                                           probes=self.probes)
                    try:
                        self._on_dead()
                    except Exception:  # noqa: BLE001
                        logger.exception("on_dead callback failed")
                    return  # one-shot: the promotion owns what happens next


class EventLoopProber:
    """Measures event-loop responsiveness; signals on sustained starvation."""

    def __init__(self, config: Config | None = None,
                 on_signal: Optional[Callable[[str, str], None]] = None) -> None:
        cfg = config or default_config()
        self.interval_s = cfg.get_seconds("surge.event-loop-prober.interval-ms", 1000)
        self.threshold_s = cfg.get_seconds("surge.event-loop-prober.threshold-ms", 200)
        # consecutive late probes before signalling (the reference probes in rounds
        # of numProbes before deciding)
        self.late_probes = cfg.get_int("surge.event-loop-prober.late-probes", 3)
        self._on_signal = on_signal or (lambda name, level: None)
        self._task: Optional[asyncio.Task] = None
        self._late_streak = 0
        self.max_delay_s = 0.0
        self.last_delay_s = 0.0
        self.starvation_events = 0

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._run())
            self._task.set_name("surge-event-loop-prober")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        while True:
            t0 = time.perf_counter()
            await asyncio.sleep(self.interval_s)
            delay = (time.perf_counter() - t0) - self.interval_s
            self.last_delay_s = delay
            self.max_delay_s = max(self.max_delay_s, delay)
            if delay > self.threshold_s:
                self._late_streak += 1
                if self._late_streak >= self.late_probes:
                    self.starvation_events += 1
                    self._late_streak = 0
                    logger.warning(
                        "possible event-loop starvation: probe %.0fms late "
                        "(threshold %.0fms) %d times in a row",
                        delay * 1e3, self.threshold_s * 1e3, self.late_probes)
                    self._on_signal("event-loop.starvation", "warning")
            else:
                self._late_streak = 0
