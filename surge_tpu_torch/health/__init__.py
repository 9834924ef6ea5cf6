"""Health signals, pattern matching, and restart supervision.

Equivalents of the reference health stack (SURVEY.md §5.3/§5.5):

- :class:`HealthSignal` + :class:`HealthSignalBus` — local pub/sub with a ring buffer
  of recent signals and an emit DSL
  (modules/common/src/main/scala/surge/internal/health/HealthSignalBus.scala:162-371).
- :class:`SlidingSignalWindow` — time-windowed signal buffer advancing on expiry or
  buffer threshold (HealthSignalWindowActor.scala:22-120 + WindowSlider.scala:11-37).
- Signal pattern matchers — name-equals / regex / repeating-within-window
  (surge/internal/health/matchers/*.scala).
- :class:`HealthSupervisor` — matches registered restart/shutdown patterns against the
  signal stream and drives each component's ``Controllable`` restart()/shutdown(), with
  a restart budget before escalating to shutdown
  (internal/health/supervisor/HealthSupervisorActor.scala:63-111). Emits
  ``health.component-restarted`` back onto the bus (the ComponentRestarted ack the
  reference spec asserts on, SurgeMessagePipelineSpec:150-253).
"""

from __future__ import annotations

import re
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Pattern, Sequence

from surge_tpu_torch.common import (Ack, CircularBuffer, Controllable, logger,
                              spawn_reaped)
from surge_tpu_torch.config import Config, default_config

__all__ = [
    "HealthSignal",
    "HealthSignalBus",
    "HealthSupervisor",
    "NameEqualsMatcher",
    "RegexMatcher",
    "RepeatingSignalMatcher",
    "SlidingSignalWindow",
]


@dataclass(frozen=True)
class HealthSignal:
    """A named signal (surge.health.HealthSignal): error/warning/trace severity."""

    name: str
    level: str = "warning"  # "error" | "warning" | "trace"
    source: str = ""
    metadata: dict = field(default_factory=dict)
    timestamp: float = field(default_factory=time.time)


class HealthSignalBus:
    """Pub/sub bus with a bounded recent-signal buffer (HealthSignalBus.scala:162-371)."""

    def __init__(self, buffer_size: int = 25) -> None:
        self._recent: CircularBuffer[HealthSignal] = CircularBuffer(buffer_size)
        self._subscribers: List[Callable[[HealthSignal], None]] = []
        # lifetime emit counts by severity level — the ring buffer forgets,
        # the scrape surface (metrics/exposition.health_collector) must not
        self.signal_counts: Dict[str, int] = {}

    def emit(self, name: str, level: str = "warning", source: str = "",
             metadata: Optional[dict] = None) -> HealthSignal:
        signal = HealthSignal(name=name, level=level, source=source,
                              metadata=metadata or {})
        self._recent.push(signal)
        self.signal_counts[level] = self.signal_counts.get(level, 0) + 1
        for fn in list(self._subscribers):
            try:
                fn(signal)
            except Exception:  # noqa: BLE001 — one subscriber must not break the bus
                logger.exception("health subscriber failed")
        return signal

    def signal_fn(self, source: str) -> Callable[[str, str], None]:
        """Adapter matching the components' ``on_signal(name, level)`` hook."""
        return lambda name, level: self.emit(name, level, source=source)

    def subscribe(self, fn: Callable[[HealthSignal], None]) -> None:
        self._subscribers.append(fn)

    def unsubscribe(self, fn: Callable[[HealthSignal], None]) -> None:
        try:
            self._subscribers.remove(fn)
        except ValueError:
            pass

    def recent(self) -> List[HealthSignal]:
        return self._recent.to_list()


# -- windows + matchers -----------------------------------------------------------------


class SlidingSignalWindow:
    """Time window over signals, advancing on expiry or on buffer threshold
    (WindowSlider semantics: slide when the buffer exceeds ``advance_threshold``)."""

    def __init__(self, window_s: float, advance_threshold: int = 10) -> None:
        self.window_s = window_s
        self.advance_threshold = advance_threshold
        self._buffer: Deque[HealthSignal] = deque()

    def add(self, signal: HealthSignal) -> None:
        self._buffer.append(signal)
        self.advance(signal.timestamp)
        while len(self._buffer) > self.advance_threshold:
            self._buffer.popleft()

    def advance(self, now: Optional[float] = None) -> None:
        cutoff = (now if now is not None else time.time()) - self.window_s
        while self._buffer and self._buffer[0].timestamp < cutoff:
            self._buffer.popleft()

    def signals(self) -> List[HealthSignal]:
        return list(self._buffer)

    def __len__(self) -> int:
        return len(self._buffer)


class NameEqualsMatcher:
    """SignalNameEqualsMatcher: fire when one signal's name matches exactly."""

    def __init__(self, name: str) -> None:
        self.name = name

    def matches(self, signal: HealthSignal, window: SlidingSignalWindow) -> bool:
        return signal.name == self.name


class RegexMatcher:
    """SignalNamePatternMatcher: fire when the signal name matches a regex."""

    def __init__(self, pattern: str | Pattern[str]) -> None:
        self.pattern = re.compile(pattern)

    def matches(self, signal: HealthSignal, window: SlidingSignalWindow) -> bool:
        return self.pattern.search(signal.name) is not None

    def __repr__(self) -> str:  # pragma: no cover
        return f"RegexMatcher({self.pattern.pattern!r})"


class RepeatingSignalMatcher:
    """RepeatingSignalMatcher: fire when a signal repeats >= ``times`` within the
    window (the sliding-window stream's raison d'être)."""

    def __init__(self, times: int, inner: NameEqualsMatcher | RegexMatcher) -> None:
        self.times = times
        self.inner = inner

    def matches(self, signal: HealthSignal, window: SlidingSignalWindow) -> bool:
        if not self.inner.matches(signal, window):
            return False
        hits = sum(1 for s in window.signals() if self.inner.matches(s, window))
        return hits >= self.times


# -- supervisor -------------------------------------------------------------------------


@dataclass
class _Registration:
    """One supervised component (HealthRegistration analog)."""

    name: str
    component: Controllable
    restart_matchers: Sequence[object]
    shutdown_matchers: Sequence[object] = ()
    window: SlidingSignalWindow = field(default_factory=lambda: SlidingSignalWindow(10.0))
    restarts: int = 0


class HealthSupervisor:
    """Pattern → restart/shutdown supervision over the signal bus
    (HealthSupervisorActor.scala:63-111)."""

    def __init__(self, bus: HealthSignalBus, config: Config | None = None) -> None:
        self.bus = bus
        cfg = config or default_config()
        self.max_restarts = cfg.get_int("surge.health.supervisor-restart-max", 3)
        self._window_s = cfg.get_seconds("surge.health.window-frequency-ms", 10_000)
        self._threshold = cfg.get_int("surge.health.window-buffer-size", 10)
        self._registrations: Dict[str, _Registration] = {}
        self._started = False
        # restart/shutdown dispatches in flight: retained so a failing
        # action surfaces its exception instead of dying silently with a
        # GC'd task (the supervisor IS the last line of defense)
        self._actions: set = set()

    def start(self) -> None:
        if not self._started:
            self.bus.subscribe(self._on_signal)
            self._started = True

    def stop(self) -> None:
        if self._started:
            self.bus.unsubscribe(self._on_signal)
            self._started = False

    def register(self, name: str, component: Controllable,
                 restart_patterns: Sequence[object],
                 shutdown_patterns: Sequence[object] = ()) -> None:
        """registerSupervisedComponent: the component's Controllable is driven when a
        pattern matches (restartSignalPatterns, AggregateStateStoreKafkaStreams:74-76)."""
        self._registrations[name] = _Registration(
            name=name, component=component, restart_matchers=list(restart_patterns),
            shutdown_matchers=list(shutdown_patterns),
            window=SlidingSignalWindow(self._window_s, self._threshold))

    def registered(self) -> List[str]:
        return sorted(self._registrations)

    def restart_counts(self) -> Dict[str, int]:
        """Restarts driven per registered component (scrape-surface view of
        each registration's budget consumption)."""
        return {name: reg.restarts
                for name, reg in self._registrations.items()}

    async def restart_component(self, name: str) -> None:
        """Operator-initiated restart of a registered component (the JMX MBean
        restart op): same budget/signal path a matched pattern takes.
        Raises KeyError for unknown names."""
        reg = self._registrations[name]
        await self._restart(reg, HealthSignal(name="admin.restart-requested",
                                              level="trace", source=name))

    def _on_signal(self, signal: HealthSignal) -> None:
        for reg in self._registrations.values():
            reg.window.add(signal)
            if any(m.matches(signal, reg.window) for m in reg.shutdown_matchers):
                spawn_reaped(self._actions, self._shutdown(reg, signal),
                             f"supervisor shutdown of {reg.name}")
            elif any(m.matches(signal, reg.window) for m in reg.restart_matchers):
                spawn_reaped(self._actions, self._restart(reg, signal),
                             f"supervisor restart of {reg.name}")

    async def _restart(self, reg: _Registration, signal: HealthSignal) -> None:
        if reg.restarts >= self.max_restarts:
            logger.error("supervisor: %s exceeded restart budget; shutting down", reg.name)
            await self._shutdown(reg, signal)
            return
        reg.restarts += 1
        try:
            await reg.component.restart()
            self.bus.emit("health.component-restarted", "trace", source=reg.name,
                          metadata={"trigger": signal.name, "restarts": reg.restarts})
        except Exception:  # noqa: BLE001
            logger.exception("supervisor: restart of %s failed", reg.name)
            self.bus.emit("health.component-restart-failed", "error", source=reg.name)

    async def _shutdown(self, reg: _Registration, signal: HealthSignal) -> None:
        try:
            await reg.component.shutdown()
            self.bus.emit("health.component-shutdown", "trace", source=reg.name,
                          metadata={"trigger": signal.name})
        except Exception:  # noqa: BLE001
            logger.exception("supervisor: shutdown of %s failed", reg.name)


@dataclass
class HealthCheck:
    """Nested component health (surge.health.SurgeHealthCheck ask-chain analog)."""

    name: str
    status: str  # "up" | "down" | "degraded"
    components: List["HealthCheck"] = field(default_factory=list)

    def is_healthy(self) -> bool:
        return self.status == "up" and all(c.is_healthy() for c in self.components)
