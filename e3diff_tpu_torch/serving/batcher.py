"""Micro-batching request queue for serving (counterpart of
e3diff_tpu/serving/batcher.py, the same semantics).

The card runs one captured program per bucket shape; the HTTP front-end
receives requests one at a time. The batcher bridges them: a single
worker thread drains the queue, coalescing up to ``max_batch`` slots per
device run (waiting at most ``max_wait_ms`` after the first request, so a
lone request is never stuck behind an empty queue), and resolves each
request's Future with its slice of the batched result. Latency is bounded
by max_wait + one batch; throughput approaches the full-batch rate under
load.

Spans (utils/telemetry.py): each batch runs inside a ``batcher.batch``
span on the worker thread (no profiler range, and no parent of the
spans ``run_batch`` opens), and each ``submit_many`` call (one request)
opens a ``batcher.queue_wait`` span, under the caller's span, that the
worker closes when it dispatches the call's last slot; it names the
batches (``batches``: their span ids) its slots rode in. ``stats()``
reports the 95th percentile of the recent queue waits.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Sequence

from e3diff_tpu_torch.utils import telemetry


class QueueFullError(RuntimeError):
    """Raised by submit when the bounded request queue is at capacity.

    Overload backpressure: an unbounded queue under sustained load beyond
    the device's capacity grows without bound and turns every request
    into a slow timeout; a bounded queue turns overload into an
    immediate, retryable rejection (HTTP 429 upstream) while the accepted
    work keeps its bounded latency. ``retry_after_s`` estimates
    when capacity frees up (queue depth / recent batch rate)."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class MicroBatcher:
    """Coalesces unit requests into batched calls on a worker thread.

    run_batch: Callable[[list[item]], Sequence[result]] — must return one
    result per item, in order. Exceptions fail every request in the batch.

    max_queue bounds the number of pending (queued, not yet dispatched)
    slots: submits beyond it raise QueueFullError instead of growing the
    queue. Default 4 * max_batch — enough to keep the device busy through
    a burst, small enough that accepted requests wait at most ~4 device
    runs. Pass 0 for unbounded. ``name`` tags the batcher's spans.
    """

    def __init__(self, run_batch: Callable, max_batch: int = 64,
                 max_wait_ms: float = 25.0, linger_ms: float = 2.0,
                 max_queue: int | None = None, name: str = "batcher"):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._run_batch = run_batch
        self.name = name
        self._max_batch = max_batch
        self._max_queue = 4 * max_batch if max_queue is None else max_queue
        if self._max_queue < 0:
            raise ValueError("max_queue must be >= 0 (0 = unbounded)")
        self._max_wait_s = max_wait_ms / 1000.0
        # adaptive dispatch: after the first request, each FURTHER slot is
        # awaited for at most linger_ms — a burst arriving back-to-back
        # keeps extending the batch (up to max_wait total), while a lone
        # request dispatches after one linger instead of sleeping the
        # whole window
        self._linger_s = max(0.0, min(linger_ms, max_wait_ms)) / 1000.0
        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._stats = {"requests": 0, "batches": 0, "batched_slots": 0,
                       "errors": 0, "rejected": 0}
        self._latencies: collections.deque = collections.deque(maxlen=1024)
        self._waits: collections.deque = collections.deque(maxlen=1024)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="e3diff-torch-microbatcher")
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, item) -> Future:
        return self.submit_many([item])[0]

    def submit_many(self, items: Sequence) -> list[Future]:
        """Enqueue all of ``items`` atomically, or none of them.

        A multi-slot request (n_designs > 1) either fits in the bounded
        queue entirely or is rejected whole with QueueFullError — no
        partial admission (which would run some slots and 429 the rest
        of one HTTP request)."""
        # stop-check and enqueue are one atomic section vs shutdown()'s
        # stop+drain: a put that wins the lock lands before the drain
        # (which fails it), a put that loses sees _stop and raises —
        # either way no future is left unresolved
        with self._lock:
            if self._stop.is_set():
                raise RuntimeError("batcher is shut down")
            depth = self._queue.qsize()
            if self._max_queue and depth + len(items) > self._max_queue:
                self._stats["rejected"] += len(items)
                # capacity frees at roughly one batch per batch-latency:
                # estimate the wait for `depth` queued slots from the
                # recent mean per-batch wall (fallback 1 s when cold)
                per_batch = (self._recent_batch_s()
                             if self._latencies else 1.0)
                retry = max(0.05, per_batch * (depth / self._max_batch))
                raise QueueFullError(
                    f"request queue full ({depth}/{self._max_queue} "
                    f"pending slots)", retry_after_s=round(retry, 2))
            wait = telemetry.start("batcher.queue_wait", batcher=self.name,
                                   slots=len(items), batches=[])
            wait.attrs["request"] = wait.parent
            ticket = [wait, len(items)]    # the span, its slots not yet run
            out = []
            for item in items:
                fut: Future = Future()
                self._stats["requests"] += 1
                self._queue.put((item, fut, time.monotonic(), ticket))
                out.append(fut)
        return out

    def _recent_batch_s(self) -> float:
        """Rough recent per-batch wall seconds (median recorded latency
        is an upper bound on batch time under steady load; good enough
        for a Retry-After hint). Caller holds the lock."""
        lats = sorted(self._latencies)
        return lats[len(lats) // 2] if lats else 1.0

    def shutdown(self, timeout: float = 5.0) -> None:
        with self._lock:
            self._stop.set()
        self._thread.join(timeout)
        # fail anything still queued so clients don't hang
        while True:
            try:
                _, fut, _, _ = self._queue.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("batcher shut down"))

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            lats = sorted(self._latencies)
            waits = sorted(self._waits)
        out["queue_depth"] = self._queue.qsize()
        out["max_queue"] = self._max_queue
        out["mean_batch_occupancy"] = (
            out["batched_slots"] / out["batches"] if out["batches"] else 0.0)
        if waits:
            out["queue_wait_ms_p95"] = 1e3 * telemetry.nearest_rank(waits,
                                                                    0.95)
        if lats:
            out["latency_ms_p50"] = 1e3 * lats[len(lats) // 2]
            out["latency_ms_p95"] = 1e3 * lats[min(int(len(lats) * 0.95),
                                                   len(lats) - 1)]
            out["latency_ms_p99"] = 1e3 * lats[min(int(len(lats) * 0.99),
                                                   len(lats) - 1)]
        return out

    # ------------------------------------------------------------------
    def _collect(self) -> list:
        """Block for the first request, then coalesce while requests keep
        arriving within ``linger`` of each other, up to a full batch or
        ``max_wait`` total (whichever first). An idle gap > linger
        dispatches immediately — unloaded latency pays one linger, not
        the whole window."""
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        items = [first]
        deadline = time.monotonic() + self._max_wait_s
        while len(items) < self._max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                items.append(
                    self._queue.get(timeout=min(remaining, self._linger_s)))
            except queue.Empty:
                break
        return items

    def _dispatch(self, items, batch) -> None:
        """Tell each item's request that its slot rides in ``batch``;
        close the queue wait of a request whose last slot this is."""
        for it in items:
            ticket = it[3]
            wait = ticket[0]
            batches = wait.attrs["batches"]
            if not batches or batches[-1] != batch.id:
                batches.append(batch.id)
            ticket[1] -= 1
            if ticket[1] == 0:
                telemetry.finish(wait, batch.t0)
                with self._lock:
                    self._waits.append(wait.seconds)

    def _loop(self) -> None:
        while not self._stop.is_set():
            items = self._collect()
            if not items:
                continue
            # opened and closed by hand, so no profiler range: a profiler
            # that run_batch starts or stops would find this span open
            # across its edge and stretch its trace to the span's end
            batch = telemetry.start("batcher.batch", batcher=self.name,
                                    slots=len(items))
            try:
                self._dispatch(items, batch)
                self._run(items)
            finally:
                telemetry.finish(batch)

    def _run(self, items) -> None:
        payloads = [it[0] for it in items]
        futures = [it[1] for it in items]
        t_enq = [it[2] for it in items]
        try:
            results = self._run_batch(payloads)
            if len(results) != len(payloads):
                raise RuntimeError(
                    f"run_batch returned {len(results)} results for "
                    f"{len(payloads)} items")
        except Exception as exc:  # noqa: BLE001 — forwarded to callers
            with self._lock:
                self._stats["errors"] += len(futures)
                self._stats["batches"] += 1
                self._stats["batched_slots"] += len(futures)
            for fut in futures:
                if not fut.done():
                    fut.set_exception(exc)
            return
        now = time.monotonic()
        with self._lock:
            self._stats["batches"] += 1
            self._stats["batched_slots"] += len(futures)
            for t0 in t_enq:
                self._latencies.append(now - t0)
        for fut, res in zip(futures, results):
            if not fut.done():
                fut.set_result(res)
