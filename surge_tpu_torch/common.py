"""Shared runtime primitives: lifecycle contract, ring buffer, task supervision —
the port's copy of ``surge_tpu/common.py``.

Equivalents of the reference's ``surge.core.Controllable``/``Ack``
(modules/common/src/main/scala/surge/core/Controllable.scala:7-34), ``CircularBuffer``
(surge/internal/utils/CircularBuffer.scala), and the Akka actor-lifecycle plumbing
(``ActorLifecycleManagerActor``) — re-expressed for asyncio tasks instead of actors.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Callable, Coroutine, Generic, List, Optional, TypeVar

logger = logging.getLogger("surge_tpu_torch")

T = TypeVar("T")

#: the ROADMAP.md item that lists the engine's parts the port has not taken
#: yet; each raises with this name when it is asked for
ENGINE_WAITING = 'ROADMAP.md, Queue 1, "The engine\'s waiting parts"'


class Ack:
    """Positive acknowledgement of a lifecycle op (surge.core.Ack)."""

    def __repr__(self) -> str:  # pragma: no cover
        return "Ack()"


class Controllable:
    """Lifecycle contract: start/stop/restart/shutdown (Controllable.scala:7-34).

    Components (store indexer, publishers, router, pipeline) subclass this; the health
    supervisor restarts registered Controllables when fatal signal patterns match
    (HealthSupervisorActor.scala:63-111 analog).
    """

    async def start(self) -> Ack:
        raise NotImplementedError

    async def stop(self) -> Ack:
        raise NotImplementedError

    async def restart(self) -> Ack:
        await self.stop()
        return await self.start()

    async def shutdown(self) -> Ack:
        """Terminal stop (no restart expected)."""
        return await self.stop()


class DecodedState:
    """An already-deserialized aggregate state handed back by a state fetch.

    The resident state plane (surge_tpu_torch.replay.resident_state) materializes
    domain states from device tensor rows, so routing them through the
    byte-oriented fetch contract would serialize + immediately re-deserialize
    every hit. A fetch returning ``DecodedState(state)`` tells the entity to
    adopt ``state`` directly. Defined here (jax-free) so the core engine never
    imports the replay stack just to recognize the marker."""

    __slots__ = ("state",)

    def __init__(self, state: Any) -> None:
        self.state = state


class CircularBuffer(Generic[T]):
    """Fixed-capacity ring (CircularBuffer.scala analog; health bus keeps the last N
    signals in one of these — HealthSignalBus.scala:177)."""

    def __init__(self, capacity: int) -> None:
        self._capacity = max(int(capacity), 1)
        self._items: List[T] = []
        self._next = 0

    def push(self, item: T) -> None:
        if len(self._items) < self._capacity:
            self._items.append(item)
        else:
            self._items[self._next] = item
        self._next = (self._next + 1) % self._capacity

    def to_list(self) -> List[T]:
        """Oldest→newest."""
        if len(self._items) < self._capacity:
            return list(self._items)
        return self._items[self._next:] + self._items[: self._next]

    def __len__(self) -> int:
        return len(self._items)


class BackgroundTask:
    """A supervised asyncio loop task with clean cancel-on-stop semantics."""

    def __init__(self, coro_factory: Callable[[], Coroutine[Any, Any, None]],
                 name: str) -> None:
        self._factory = coro_factory
        self._name = name
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._factory())
            self._task.set_name(self._name)

    async def stop(self) -> None:
        task, self._task = self._task, None
        if task is None or task.done():
            return
        task.cancel()
        if task is asyncio.current_task():
            return  # self-stop: the cancellation lands at our next await point
        # A single cancel() is not enough on Python 3.10: asyncio.wait_for can
        # swallow a cancellation that races a timeout or a completing inner
        # future (bpo-37658 family), so a loop built on wait_for keeps running
        # and a bare `await task` hangs forever — the tier-1 cluster-test hang
        # (stop chains stuck on the indexer during set_partitions). Re-issue
        # the cancel on a short deadline until the task actually ends.
        for attempt in range(120):
            try:
                await asyncio.wait_for(asyncio.shield(task), timeout=0.25)
                return
            except asyncio.TimeoutError:
                task.cancel()
                if attempt == 19:
                    logger.warning("background task %s ignored cancellation "
                                   "for 5s; re-cancelling", self._name)
            except asyncio.CancelledError:
                if task.done():
                    return  # the task ended cancelled — the normal stop path
                raise  # stop() itself was cancelled
            except Exception:  # noqa: BLE001 — stop is best-effort
                return
        logger.error("background task %s failed to stop after repeated "
                     "cancellation; abandoning the await", self._name)

    @property
    def running(self) -> bool:
        return self._task is not None and not self._task.done()


async def cancel_safe_wait_for(awaitable, timeout: float):
    """Drop-in ``asyncio.wait_for`` without the py3.10 cancellation swallow.

    ``asyncio.wait_for`` can swallow an outer cancellation that races a
    timeout or a completing inner future (bpo-37658 family): it catches the
    ``CancelledError``, returns the inner result, and the caller's loop keeps
    running after ``task.cancel()`` — the tier-1 cluster-test hang. Built on
    ``asyncio.wait``, which never catches cancellation: a racing cancel stays
    pending on the task (``_must_cancel``) and fires at the caller's next
    await point instead of vanishing.

    Same contract as ``wait_for``: returns the result, raises
    ``asyncio.TimeoutError`` on timeout (the awaitable is cancelled AND
    awaited first, exactly like ``wait_for``'s ``_cancel_and_wait`` — that
    extra suspension point matters: a caller cancelled while parked here must
    die at the timeout boundary, not run one more loop body), propagates the
    awaitable's exception. If the awaitable completes in the cancel window —
    beating the timeout's cancel — its real result/exception is returned/
    raised rather than masked as TimeoutError (and rather than rotting as an
    unretrieved task exception).
    """
    task = asyncio.ensure_future(awaitable)
    try:
        done, _ = await asyncio.wait((task,), timeout=timeout)
    except BaseException:
        task.cancel()
        try:
            # bpo-32751 parity: the inner task must not outlive wait_for —
            # its cleanup (e.g. a publish lane's finally) finishes before the
            # caller's CancelledError propagates
            await asyncio.wait((task,))
        finally:
            if task.done() and not task.cancelled():
                task.exception()  # retrieve: don't rot as 'never retrieved'
        raise
    if task in done:
        return task.result()
    task.cancel()
    try:
        await asyncio.wait((task,))  # cancellation of the CALLER lands here too
    except BaseException:
        if task.done() and not task.cancelled():
            task.exception()  # retrieve before the caller's cancel wins
        raise
    if not task.cancelled():
        return task.result()  # completion (or a real failure) beat the cancel
    raise asyncio.TimeoutError


async def wait_future(fut: "asyncio.Future", timeout: float,
                      owned: bool = True):
    """Await a BARE future with a timeout — the per-command de-asyncio'd
    twin of :func:`cancel_safe_wait_for` for plain futures. One
    ``call_later`` handle instead of a wrapper task + ``asyncio.wait``'s
    waiter/callback machinery; at engine throughput that difference is paid
    once per command (BENCH_NOTES round 9).

    ``owned=True`` (an exclusively-held future, e.g. an ask reply): the
    timeout CANCELS the future — exactly ``wait_for``'s contract, so a
    producer resolving late finds it cancelled and no-ops. An OUTER task
    cancellation also lands on the future (the task cancels what it awaits),
    and is re-raised — never swallowed, never misread as a timeout.

    ``owned=False`` (a SHARED future, e.g. the publisher direct lane's
    per-batch ack): the timeout must not cancel what other waiters ride, so
    this waiter parks on its own future instead and leaves the shared one
    untouched on timeout AND on outer cancellation.
    """
    if fut.done():
        if not owned and fut.cancelled():
            # same contract as the shared branch below: a co-holder's
            # cancellation surfaces retryable, never CancelledError
            raise RuntimeError("shared future was cancelled by another holder")
        return fut.result()
    loop = asyncio.get_running_loop()
    if owned:
        timed_out = False

        def _on_timeout() -> None:
            nonlocal timed_out
            timed_out = True
            fut.cancel()

        handle = loop.call_later(timeout, _on_timeout)
        try:
            return await fut
        except asyncio.CancelledError:
            if timed_out and fut.cancelled():
                raise asyncio.TimeoutError from None
            raise
        finally:
            handle.cancel()
    waiter: "asyncio.Future" = loop.create_future()

    def _done(f: "asyncio.Future") -> None:
        resolve_future(waiter, f)

    fut.add_done_callback(_done)
    handle = loop.call_later(timeout, resolve_future, waiter, None)
    try:
        inner = await waiter
    finally:
        handle.cancel()
        fut.remove_done_callback(_done)
    if inner is None:
        raise asyncio.TimeoutError
    if inner.cancelled():
        # ANOTHER holder cancelled the shared future. This waiter did not:
        # surface a plain retryable failure, not CancelledError — a
        # BaseException here would blow through the caller's retry ladder
        # and kill a command whose write may well still commit.
        raise RuntimeError("shared future was cancelled by another holder")
    return inner.result()


def spawn_reaped(registry: set, coro: Coroutine[Any, Any, Any],
                 what: str) -> "asyncio.Task":
    """Spawn a fire-and-forget coroutine WITHOUT orphaning it: the task is
    retained in ``registry`` (so it cannot be garbage-collected mid-flight),
    discarded when done, and a non-cancellation failure is logged instead of
    rotting until interpreter exit. The house pattern behind the orphan-task
    lint rule — use this (or BackgroundTask for loops) wherever the result
    genuinely has no awaiter."""
    task = asyncio.ensure_future(coro)
    registry.add(task)

    def _reap(t: "asyncio.Task") -> None:
        registry.discard(t)
        if not t.cancelled() and t.exception() is not None:
            logger.error("%s failed", what, exc_info=t.exception())

    task.add_done_callback(_reap)
    return task


def resolve_future(fut: "asyncio.Future[T]", value: T) -> None:
    if not fut.done():
        fut.set_result(value)


def fail_future(fut: asyncio.Future, exc: BaseException) -> None:
    if not fut.done():
        fut.set_exception(exc)
