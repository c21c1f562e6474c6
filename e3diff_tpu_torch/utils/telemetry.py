"""Spans of the port's own stages, in one recorder per process.

A span is a named stretch of host time on one thread::

    with telemetry.span("engine.batch", kind="design") as s:
        ...
        s.attrs["slots"] = n

Each record holds its ``name``, an integer ``id``, the ``parent`` id (the
enclosing span of the same thread, or an explicit ``parent=``), ``t0`` and
``t1`` from ``time.monotonic()``, the ``thread`` ident and ``attrs``. Work
that crosses threads opens its span with ``start`` on one thread and
closes it with ``finish`` on another; the threads' spans are linked by
ids in ``attrs`` (a request's queue wait names the batches its slots rode
in).

``span(..., device=True)`` also records a CUDA event pair on the current
stream around the span's work; ``device_ms`` reads their elapsed time
once the end event is done (``Event.query``), and is None before that:
nothing waits for the card. A record holds its events until it is read
or leaves the ring. While ``torch.profiler`` records on the calling
thread, the span also opens a ``record_function`` range of its
name, so the span lands in the profiler's trace, on its clock, beside the
device's events; with no profiler running no range is made.

Closed spans go to a bounded ring (``RING`` records, the newest kept);
``spans(name, lo, hi)`` returns one name's records inside [lo, hi],
``summary()`` the count, mean and 95th percentile of each name's retained
records, and ``total(name)`` the count and seconds of every span of that
name the process has closed. A span costs two clock reads and one append,
plus an event pair with ``device=True``; none is opened inside a
per-step loop (a sampler's replays, a microbatch).

Who reads what: GET /stats (serving/server.py) shows ``summary()``; the
micro-batcher's ``stats()`` its queue waits; the training loop's history
record the epoch's ``train.data_wait`` and ``train.checkpoint_wait``; the
benchmark's per-layer metrics (benchmark/spans.py) the spans of a run's
window.
"""

from __future__ import annotations

import collections
import itertools
import math
import threading
import time

import torch

RING = 1 << 16

try:
    from torch._C._autograd import _profiler_enabled as _profiling
except ImportError:  # pragma: no cover - a torch without the check
    def _profiling() -> bool:
        return False


class Span:
    """One span's record; also the context manager ``span`` returns."""

    __slots__ = ("name", "id", "parent", "t0", "t1", "thread", "attrs",
                 "_rec", "_device", "_events", "_device_ms", "_range")

    def __init__(self, rec: "Recorder", name: str, parent, device: bool,
                 attrs: dict):
        self._rec = rec
        self.name = name
        self.id = next(rec._ids)
        if parent is None:
            stack = rec._stack()
            parent = stack[-1] if stack else None
        self.parent = parent.id if isinstance(parent, Span) else parent
        self.t0 = self.t1 = None
        self.thread = threading.get_ident()
        self.attrs = attrs
        self._device = device
        self._events = self._device_ms = self._range = None

    @property
    def seconds(self) -> float | None:
        """Host seconds from start to finish (None while open)."""
        return None if self.t1 is None else self.t1 - self.t0

    @property
    def device_ms(self) -> float | None:
        """Milliseconds between the span's CUDA events, once the card has
        passed the second; None before that, or without events."""
        events = self._events
        if events is not None and events[1] is not None and events[1].query():
            self._device_ms = events[0].elapsed_time(events[1])
            self._events = None
        return self._device_ms

    def __enter__(self) -> "Span":
        if _profiling():
            self._range = torch.autograd.profiler.record_function(self.name)
            self._range.__enter__()
        if self._device:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self._events = (start, None)
        self._rec._stack().append(self)
        self.t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = time.monotonic()
        self._rec._stack().pop()
        if self._events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events = (self._events[0], end)
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._rec.finish(self, t1)


class Recorder:
    """The ring of closed spans and the per-name totals."""

    def __init__(self, size: int = RING):
        self._ring: collections.deque = collections.deque(maxlen=size)
        self._totals: dict[str, list] = {}
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, *, parent=None, device: bool = False,
             **attrs) -> Span:
        """A span to open with ``with``; ``parent``: a Span or an id in
        place of the enclosing span; ``device``: time the card too."""
        return Span(self, name, parent, device, attrs)

    def start(self, name: str, *, parent=None, **attrs) -> Span:
        """Open a span that ``finish`` closes, on this thread or another;
        its parent is the enclosing span of this thread unless given."""
        s = Span(self, name, parent, False, attrs)
        s.t0 = time.monotonic()
        return s

    def finish(self, s: Span, t1: float | None = None) -> None:
        """Close ``s`` at ``t1`` (now when None) and keep it."""
        s.t1 = time.monotonic() if t1 is None else t1
        with self._lock:
            self._ring.append(s)
            total = self._totals.setdefault(s.name, [0, 0.0])
            total[0] += 1
            total[1] += s.t1 - s.t0

    def spans(self, name: str, lo: float = -math.inf,
              hi: float = math.inf) -> list[Span]:
        """The retained records of ``name`` that lie inside [lo, hi]."""
        with self._lock:
            ring = list(self._ring)
        return [s for s in ring
                if s.name == name and s.t0 >= lo and s.t1 <= hi]

    def total(self, name: str) -> tuple[int, float]:
        """(count, seconds) of every span of ``name`` closed so far."""
        with self._lock:
            n, secs = self._totals.get(name, (0, 0.0))
        return n, secs

    def summary(self) -> dict:
        """Per name, of the retained records: count, mean and p95 host ms,
        and the mean device ms where the span timed the card."""
        with self._lock:
            ring = list(self._ring)
        by_name: dict[str, list[Span]] = {}
        for s in ring:
            by_name.setdefault(s.name, []).append(s)
        out = {}
        for name, recs in sorted(by_name.items()):
            ms = sorted(1e3 * s.seconds for s in recs)
            row = {"count": len(ms), "mean_ms": sum(ms) / len(ms),
                   "p95_ms": nearest_rank(ms, 0.95)}
            dev = [d for d in (s.device_ms for s in recs) if d is not None]
            if dev:
                row["device_mean_ms"] = sum(dev) / len(dev)
            out[name] = row
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._totals.clear()


def nearest_rank(sorted_values: list, q: float) -> float:
    """The q-quantile of ascending values by the nearest-rank rule."""
    return sorted_values[max(0, math.ceil(q * len(sorted_values)) - 1)]


_RECORDER = Recorder()


def recorder() -> Recorder:
    """The process's one recorder."""
    return _RECORDER


def span(name: str, **kw) -> Span:
    return _RECORDER.span(name, **kw)


def start(name: str, **kw) -> Span:
    return _RECORDER.start(name, **kw)


def finish(s: Span, t1: float | None = None) -> None:
    _RECORDER.finish(s, t1)
