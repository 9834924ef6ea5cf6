"""Shared runtime primitives — a copy of the parts of ``surge_tpu/common.py`` the
resident state plane uses: the lifecycle contract (``Ack``, ``Controllable``),
``BackgroundTask``, ``spawn_reaped``, ``cancel_safe_wait_for`` (the in-memory
log's wakeup wait) and the package logger."""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Callable, Coroutine, Optional

logger = logging.getLogger("surge_tpu_torch")


class Ack:
    """Positive acknowledgement of a lifecycle op (surge.core.Ack)."""

    def __repr__(self) -> str:  # pragma: no cover
        return "Ack()"


class Controllable:
    """Lifecycle contract: start/stop/restart/shutdown (Controllable.scala:7-34)."""

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
        # and a bare `await task` hangs forever. Re-issue the cancel on a short
        # deadline until the task actually ends.
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
    """Drop-in ``asyncio.wait_for`` without the py3.10 cancellation swallow:
    built on ``asyncio.wait``, which never catches cancellation. Returns the
    result, raises ``asyncio.TimeoutError`` on timeout (the awaitable is
    cancelled and awaited first) and propagates the awaitable's exception."""
    task = asyncio.ensure_future(awaitable)
    try:
        done, _ = await asyncio.wait((task,), timeout=timeout)
    except BaseException:
        task.cancel()
        try:
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


def spawn_reaped(registry: set, coro: Coroutine[Any, Any, Any],
                 what: str) -> "asyncio.Task":
    """Spawn a fire-and-forget coroutine without orphaning it: the task is
    retained in ``registry`` (so it cannot be garbage-collected mid-flight),
    discarded when done, and a non-cancellation failure is logged."""
    task = asyncio.ensure_future(coro)
    registry.add(task)

    def _reap(t: "asyncio.Task") -> None:
        registry.discard(t)
        if not t.cancelled() and t.exception() is not None:
            logger.error("%s failed", what, exc_info=t.exception())

    task.add_done_callback(_reap)
    return task
