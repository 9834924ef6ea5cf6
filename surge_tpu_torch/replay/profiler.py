"""Per-stage profiler for the replay fold: the port's copy of
``surge_tpu/replay/profiler.py``.

A replay pass splits into the stages the reference's profile reasons about:

- ``encode``  — host-side wire packing / bucketing;
- ``h2d``     — host→device transfer of windows / the resident corpus;
- ``compile`` — fold dispatches of a shape signature seen for the first time
  (the reference compiles a program there; the port keeps the same split,
  detected from the engine's and the plane's signature sets);
- ``dispatch``— steady fold dispatches (the host-side cost of the launch);
- ``fetch``   — dispatch → results on host, closed by the device→host pull;
- ``refresh`` — one incremental fold round of the resident state plane, the
  per-round umbrella (its pack under ``encode``, its windows under
  ``compile``/``dispatch``).

Each stage occurrence bumps ``stage_s``/``stage_n``, feeds the matching timer
of ``metrics`` when one is given (duck-typed: ``replay_encode_timer`` and its
kin, each with ``record_ms``), emits a span when a tracer is attached, and
wraps the device stages in ``torch.profiler.record_function`` ranges, so they
line up with the kernels in a captured ``torch.profiler`` trace. The range is
optional: profiling never needs the profiler to be active.

Two modes, same names: :meth:`ReplayProfiler.counters` (always on) and
:meth:`ReplayProfiler.if_enabled` (only when the metrics registry records at
DEBUG or finer).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Optional

__all__ = ["ReplayProfiler"]

#: stage name -> metrics timer attribute
_STAGE_TIMERS = {
    "encode": "replay_encode_timer",
    "h2d": "replay_h2d_timer",
    "compile": "replay_compile_timer",
    "dispatch": "replay_dispatch_timer",
    "fetch": "replay_fetch_timer",
    "refresh": "replay_refresh_timer",
}

#: stages that dispatch device work — annotated into torch.profiler traces
_DEVICE_STAGES = frozenset({"compile", "dispatch", "fetch"})

#: the value of the reference's ``RecordingLevel.DEBUG``
#: (``surge_tpu/metrics/__init__.py``): a registry records DEBUG sensors at
#: this level or above
DEBUG_LEVEL = 1


def _trace_annotation(name: str):
    """A ``torch.profiler.record_function`` range for device-visible stages,
    or None when the profiler cannot make one — profiling must never fail
    for want of it."""
    try:
        from torch.profiler import record_function

        return record_function(name)
    except Exception:  # noqa: BLE001 — optional integration only
        return None


class ReplayProfiler:
    """Accumulates per-stage wall time and occurrence counts for replay passes
    (one dispatcher thread at a time; ``summary()`` is plain data)."""

    def __init__(self, metrics=None, tracer=None, annotate: bool = True) -> None:
        self.metrics = metrics
        self.tracer = tracer
        self.annotate = annotate
        self.stage_s: Dict[str, float] = {s: 0.0 for s in _STAGE_TIMERS}
        self.stage_n: Dict[str, int] = {s: 0 for s in _STAGE_TIMERS}
        self.windows = 0  # windows/tiles dispatched (engine-reported)
        self._pass_span = None  # current pass-level span (parent of stages)

    @classmethod
    def if_enabled(cls, registry, metrics=None, tracer=None,
                   annotate: bool = True) -> Optional["ReplayProfiler"]:
        """A profiler iff ``registry.recording_level`` is DEBUG or finer —
        the gate that keeps the INFO hot path paying nothing (the engine then
        holds ``profiler=None``)."""
        if int(registry.recording_level) < DEBUG_LEVEL:
            return None
        return cls(metrics=metrics, tracer=tracer, annotate=annotate)

    @classmethod
    def counters(cls, metrics=None, tracer=None,
                 annotate: bool = True) -> "ReplayProfiler":
        """Counter-only mode: ALWAYS returns a profiler (no recording-level
        gate) — cheap ``stage_s``/``stage_n`` bumps, with the timers'
        histogram cost left to the registry's level."""
        return cls(metrics=metrics, tracer=tracer, annotate=annotate)

    # -- recording ----------------------------------------------------------------------

    def record(self, stage: str, seconds: float, **attrs) -> None:
        """Attribute ``seconds`` of wall time to ``stage`` (already measured by
        the caller)."""
        self.stage_s[stage] = self.stage_s.get(stage, 0.0) + seconds
        self.stage_n[stage] = self.stage_n.get(stage, 0) + 1
        if self.metrics is not None:
            getattr(self.metrics, _STAGE_TIMERS[stage]).record_ms(seconds * 1000.0)
        if self.tracer is not None:
            span = self.tracer.start_span(f"replay.{stage}",
                                          parent=self._pass_span)
            # retro-dated to the measured interval on both clocks
            span.start_time = time.time() - seconds
            span.start_mono = time.monotonic() - seconds
            try:
                for k, v in attrs.items():
                    span.set_attribute(k, v)
            finally:
                span.finish()  # unconditional: a leaked span pins its trace

    def count_windows(self, n: int = 1) -> None:
        """Engine-reported window/tile dispatch count."""
        self.windows += n
        if self.metrics is not None:
            self.metrics.replay_profile_windows.record(n)

    @contextmanager
    def stage(self, name: str, **attrs):
        """Time a stage inline, wrapping device stages in a
        ``record_function`` range. The record lands even when the block
        raises."""
        ann = (_trace_annotation(f"surge.replay.{name}")
               if self.annotate and name in _DEVICE_STAGES else None)
        t0 = time.perf_counter()
        try:
            if ann is not None:
                with ann:
                    yield
            else:
                yield
        finally:
            self.record(name, time.perf_counter() - t0, **attrs)

    @contextmanager
    def replay_pass(self, name: str = "replay.pass", **attrs):
        """Span + timing for one whole replay pass; stage spans emitted inside
        become its children."""
        span = None
        if self.tracer is not None:
            span = self.tracer.start_span(name)
            for k, v in attrs.items():
                span.set_attribute(k, v)
            self._pass_span = span
        try:
            yield span
        finally:
            self._pass_span = None
            if span is not None:
                span.finish()

    # -- reporting ----------------------------------------------------------------------

    def summary(self) -> dict:
        """``{stage: {"seconds": s, "count": n}}`` plus the covered total."""
        out = {s: {"seconds": round(self.stage_s[s], 4),
                   "count": self.stage_n[s]}
               for s in _STAGE_TIMERS}
        out["windows"] = self.windows
        out["total_accounted_s"] = round(sum(self.stage_s.values()), 4)
        return out

    def reset(self) -> None:
        for s in self.stage_s:
            self.stage_s[s] = 0.0
            self.stage_n[s] = 0
        self.windows = 0
