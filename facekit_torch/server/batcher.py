"""Async micro-batcher: aggregate concurrent requests into one device call.

The port's own copy of ``facekit.server.batcher`` (it imports nothing of
``facekit``). The reference serves each HTTP request with its own batch-1
engine call (and races on shared buffers while doing it — SURVEY.md §2.12);
the server instead funnels concurrent requests through this batcher so one
embed + one gallery search serve a whole batch.

Scheduling is adaptive rather than fixed-wait: when the device executor is
idle a request dispatches immediately (a lone request pays zero batching
latency), and while a batch is in flight new arrivals accumulate and flush
as one batch the moment the device frees up — so batch size tracks the
actual arrival rate with no tuning. ``max_wait_ms`` remains only as a
backstop timer.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Any, Callable, List, Optional


class QueueFull(RuntimeError):
    """submit() refused: the pending queue is at ``max_queue`` depth.

    Load shedding, not failure — an unbounded queue converts sustained
    overload into unbounded latency for EVERYONE; a bounded one keeps
    latency for accepted requests proportional to queue depth and tells
    the shed caller immediately (the server maps this to HTTP 503 / the
    WS contract "null")."""


class MicroBatcher:
    """Batches ``submit()`` items into ``fn_batch(list) -> list`` calls.

    ``fn_batch`` runs in ``executor`` (the device thread). Items must be
    batchable by the callee (same static shape); at most ``max_batch``
    items per call. Safe across concurrent asyncio tasks.

    ``max_queue`` bounds the number of ADMITTED-but-incomplete items
    (0 = unbounded): a submit that would exceed it raises
    :class:`QueueFull` instead of enqueueing. The bound covers the whole
    backlog, not just ``_pending`` — full batches drain straight into the
    executor's work queue, which is where overload actually accumulates —
    so worst-case accepted wait is ~``max_queue`` / device throughput by
    construction.
    """

    def __init__(self, fn_batch: Callable[[List[Any]], List[Any]],
                 executor, max_batch: int = 8, max_wait_ms: float = 3.0,
                 adaptive: bool = True, max_queue: int = 0):
        self.fn_batch = fn_batch
        self.executor = executor
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.adaptive = adaptive
        self.max_queue = int(max_queue)
        self._pending: List[tuple] = []
        self._lock = threading.Lock()
        self._flush_scheduled = False
        self._inflight = 0
        self._queued = 0          # admitted, not yet completed (items)
        # observability: dispatched batch count + item count (mean batch
        # size = items / batches) + shed count, exposed via /metrics
        self.batches = 0
        self.items = 0
        self.sheds = 0

    @property
    def depth(self) -> int:
        """Admitted-but-incomplete items (racy read; observability only)."""
        return self._queued

    def _drain_locked(self) -> Optional[List[tuple]]:
        """Take up to max_batch pending items; caller holds the lock."""
        if not self._pending:
            return None
        batch = self._pending[:self.max_batch]
        del self._pending[:self.max_batch]
        self._inflight += 1
        return batch

    async def submit(self, item: Any) -> Any:
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        run_now: Optional[List[tuple]] = None
        with self._lock:
            if self.max_queue and self._queued >= self.max_queue:
                self.sheds += 1
                raise QueueFull(
                    f"backlog at max_queue={self.max_queue} items")
            self._queued += 1
            self._pending.append((item, fut))
            if len(self._pending) >= self.max_batch:
                run_now = self._drain_locked()
            elif self.adaptive and self._inflight == 0:
                # device idle: dispatching now is strictly better than
                # waiting for companions that may never come
                run_now = self._drain_locked()
            elif not self._flush_scheduled:
                self._flush_scheduled = True
                loop.call_later(self.max_wait, self._flush_cb, loop)
        if run_now is not None:
            await self._run(run_now)
        return await fut

    def _flush_cb(self, loop) -> None:
        with self._lock:
            self._flush_scheduled = False
            batch = self._drain_locked()
        if batch:
            loop.create_task(self._run(batch))

    async def _run(self, batch: List[tuple]) -> None:
        items = [b[0] for b in batch]
        with self._lock:
            self.batches += 1
            self.items += len(items)
        loop = asyncio.get_running_loop()
        try:
            outs = await loop.run_in_executor(
                self.executor, self.fn_batch, items)
            for (_, fut), out in zip(batch, outs):
                if not fut.done():
                    fut.set_result(out)
        except Exception as e:  # propagate to every waiter
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)
        finally:
            with self._lock:
                self._inflight -= 1
                self._queued -= len(batch)
                next_batch = (self._drain_locked()
                              if self._inflight == 0 else None)
            if next_batch:
                # accumulated arrivals flush the moment the device frees up
                loop.create_task(self._run(next_batch))
