"""Checkpoints on ``torch.save`` (counterpart of
e3diff_tpu/training/checkpoint.py, which writes Orbax directories).

Slots, each a ``<name>.pt`` file in the run directory:
* ``last``: everything a resume needs (the trainer's state_dict: weights,
  optimizer moments and count, EMA, the generator's state) plus the epoch
  and the best monitored value so far;
* ``best_val_model``: the weights of the best epoch by ``BestTracker``;
* ``final`` and ``final_ema``: the weights at the end of training.
Every weights file is a reference-layout state_dict of f32 tensors, the
``.pt`` that ``utils/params_io.py::load_{structure,sequence}_checkpoint``
and ``DesignEngine.from_checkpoints`` read, next to the run's
``config.json`` sidecar. Every tensor is written as a CPU tensor, and a
save is atomic: a temp file, then os.replace. ``torch.save`` writes to
an open file, so the file's bytes depend on nothing but the object (given
a path, it would name the archive inside after the temp file).

Snapshot saves (counterpart of the JAX package's): ``save`` copies the
object's tensors on their device (device to device, queued behind the
work that wrote them) and returns; one background writer pulls each copy
to the host, on a stream of its own, and writes it. Saves are written in
the order they were made. At most two snapshots are alive at once, each
a copy of the state on the device, and a third save waits for a slot. A
writer's error is raised by the next save, and by ``close()``, which
waits for every save. ``E3DIFF_SNAPSHOT_SAVES=0`` makes every save
synchronous. Both kinds write the same bytes.

In a multi-process run one rank (rank 0) writes (``writer``), after the
trainer has gathered the whole state on every rank, and the saves are
synchronous, as the JAX package's ``_snapshot_applicable`` has it.

The reference keeps one best checkpoint by ModelCheckpoint(save_top_k=1,
monitor='val_loss', mode='max'): quirk Q4, 'max' keeps the WORST
validation epoch. ``BestTracker`` defaults to it; mode='min' keeps the
best.
"""

from __future__ import annotations

import os
import tempfile
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import wait as wait_futures
from typing import Callable

import torch

SNAPSHOT_SLOTS = 2


def snapshot_saves_enabled() -> bool:
    return os.environ.get("E3DIFF_SNAPSHOT_SAVES", "1") != "0"


def map_tensors(obj, fn):
    """``obj`` (nested dicts, lists and tuples) with every tensor ``t``
    replaced by ``fn(t)``; other leaves are kept."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_tensors(v, fn) for v in obj)
    return obj


def to_host(obj):
    """``obj`` with every tensor copied to a fresh CPU tensor."""
    return map_tensors(obj, lambda t: t.detach().to("cpu", copy=True))


class CheckpointManager:
    """The run directory's slots. ``writer``: this process writes (False
    on every rank but 0 of a multi-process run, where ``save`` writes
    nothing). Saves are snapshots as ``E3DIFF_SNAPSHOT_SAVES`` says, and
    synchronous in a ``torch.distributed`` job of more than one rank (the
    state a rank saves was gathered by collectives of the same step), as
    the JAX package's ``_snapshot_applicable`` has it."""

    def __init__(self, directory: str, *, writer: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.writer = writer
        multi = (torch.distributed.is_available()
                 and torch.distributed.is_initialized()
                 and torch.distributed.get_world_size() > 1)
        self.snapshot_saves = snapshot_saves_enabled() and not multi
        # one writer: the saves are written in the order they were made
        self._writer = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="ckpt-snapshot")
        self._pending: deque[Future] = deque()
        self._stream = None     # the writer's, for its device-to-host copies

    def path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pt")

    def exists(self, name: str) -> bool:
        self.wait()
        return os.path.isfile(self.path(name))

    def _write(self, name: str, obj) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.directory, prefix=f".{name}.",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(obj, f)
            os.replace(tmp, self.path(name))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def save(self, name: str, obj) -> str:
        """Write ``obj`` (its tensors as CPU tensors) to ``<name>.pt``: as
        a snapshot written in the background, or at once under
        ``E3DIFF_SNAPSHOT_SAVES=0``. Returns the path."""
        if not self.writer:
            return self.path(name)
        if not self.snapshot_saves:
            self._collect(block=True)
            self._write(name, to_host(obj))
            return self.path(name)
        self._collect(block=False)
        if len(self._pending) >= SNAPSHOT_SLOTS:
            # both slots hold a snapshot: wait for the older one's write
            wait_futures([self._pending[0]])
            self._collect(block=False)
        snap = map_tensors(obj, lambda t: t.detach().clone())
        ready = None
        if any(t.is_cuda for t in _tensors(snap)):
            ready = torch.cuda.Event()
            ready.record()
        self._pending.append(
            self._writer.submit(self._write_snapshot, name, snap, ready))
        return self.path(name)

    def _write_snapshot(self, name: str, snap, ready) -> None:
        if ready is not None:
            if self._stream is None:
                self._stream = torch.cuda.Stream()
            self._stream.wait_event(ready)
            with torch.cuda.stream(self._stream):
                snap = to_host(snap)
            self._stream.synchronize()
        self._write(name, snap)

    def _collect(self, block: bool) -> None:
        """Forget the finished writes (every pending one, waiting, under
        ``block``) and raise the first error among them."""
        error = None
        while self._pending and (block or self._pending[0].done()):
            err = self._pending.popleft().exception()
            error = error or err
        if error is not None:
            raise RuntimeError("a background checkpoint save failed") from error

    def wait(self) -> None:
        """Wait until every save made so far is written."""
        wait_futures(list(self._pending))

    def close(self) -> None:
        """Wait for every save; raise if one failed."""
        self._collect(block=True)

    def load(self, name: str):
        self.wait()
        return torch.load(self.path(name), map_location="cpu",
                          weights_only=True)


def _tensors(obj) -> list[torch.Tensor]:
    found: list[torch.Tensor] = []
    map_tensors(obj, found.append)
    return found


class BestTracker:
    """The single best-checkpoint slot on a monitored metric; mode 'max'
    (the reference's, Q4) or 'min'."""

    def __init__(self, manager: CheckpointManager, monitor: str = "val_loss",
                 mode: str = "max", name: str = "best_val_model"):
        if mode not in ("max", "min"):
            raise ValueError(f"ckpt_mode must be max or min, got {mode!r}")
        self.manager, self.monitor, self.mode, self.name = (manager, monitor,
                                                            mode, name)
        self.best: float | None = None

    def update(self, metrics: dict, weights: Callable[[], dict]) -> bool:
        """Save ``weights()`` when ``metrics[monitor]`` beats the best."""
        value = float(metrics[self.monitor])
        better = self.best is None or (value > self.best if self.mode == "max"
                                       else value < self.best)
        if better:
            self.best = value
            self.manager.save(self.name, weights())
        return better
