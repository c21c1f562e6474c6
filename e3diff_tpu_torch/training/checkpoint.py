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
``config.json`` sidecar. Saves are synchronous and atomic (a temp file,
then os.replace).

The reference keeps one best checkpoint by ModelCheckpoint(save_top_k=1,
monitor='val_loss', mode='max'): quirk Q4, 'max' keeps the WORST
validation epoch. ``BestTracker`` defaults to it; mode='min' keeps the
best.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable

import torch


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pt")

    def exists(self, name: str) -> bool:
        return os.path.isfile(self.path(name))

    def save(self, name: str, obj) -> str:
        fd, tmp = tempfile.mkstemp(dir=self.directory, prefix=f".{name}.",
                                   suffix=".tmp")
        os.close(fd)
        try:
            torch.save(obj, tmp)
            os.replace(tmp, self.path(name))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return self.path(name)

    def load(self, name: str):
        return torch.load(self.path(name), map_location="cpu",
                          weights_only=True)


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
