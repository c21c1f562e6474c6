"""The epoch loop (counterpart of e3diff_tpu/training/loop.py, the
reference's Lightning Trainer use, structure_model/train_model.py:99-116):
train and validation epochs, epoch means of the metrics, the best-on-val
slot, the resumable ``last`` slot and the final weights.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Iterable

import torch

from e3diff_tpu_torch.data.prefetch import prefetch_to_device, to_device
from e3diff_tpu_torch.training.checkpoint import BestTracker, CheckpointManager


def mean_metrics(history: list[dict]) -> dict:
    """Epoch means with one device-to-host copy per metric: the steps'
    0-d tensors are stacked and averaged on the device."""
    if not history:
        return {}
    return {k: torch.stack([h[k].float() for h in history]).mean().item()
            for k in history[0]}


def train_loop(trainer, train_batches: Callable[[int], Iterable[dict]],
               val_batches: Callable[[], Iterable[dict]] | None, *,
               max_epochs: int, device, ckpt_dir: str | None = None,
               ckpt_mode: str = "max", ckpt_every: int = 1,
               log_every: int = 30, log_fn: Callable[[str], None] = print,
               resume: bool = True, prefetch: int = 2) -> list[dict]:
    """Train ``trainer`` (a StructureTrainer or SequenceTrainer) to
    ``max_epochs``; returns one record per epoch run. ``train_batches(epoch)``
    and ``val_batches()`` yield numpy batches, copied to ``device`` by a
    background thread ``prefetch`` batches ahead (0: in line).
    ``steps_per_sec`` leaves out the first step of the epoch."""
    manager = best = None
    start_epoch = 0
    if ckpt_dir is not None:
        manager = CheckpointManager(ckpt_dir)
        best = BestTracker(manager, mode=ckpt_mode)
        if resume and manager.exists("last"):
            last = manager.load("last")
            trainer.load_state_dict(last["trainer"])
            start_epoch = int(last["epoch"]) + 1
            if last["best"] is not None and math.isfinite(last["best"]):
                best.best = float(last["best"])
            log_fn(f"resumed from epoch {start_epoch}")

    def staged(batches):
        if prefetch:
            return prefetch_to_device(batches, device, size=prefetch)
        return (to_device(b, device) for b in batches)

    history = []
    for epoch in range(start_epoch, max_epochs):
        epoch_metrics = []
        t_epoch = time.perf_counter()
        t_first_done = None
        for i, batch in enumerate(staged(train_batches(epoch))):
            metrics = trainer.train_step(batch)
            if i == 0:
                metrics["train_loss"].item()  # a host sync: the first step
                t_first_done = time.perf_counter()
            epoch_metrics.append(metrics)
            if log_every and i % log_every == 0:
                log_fn(f"epoch {epoch} step {i}: "
                       f"loss={metrics['train_loss'].item():.4f}")
        if not epoch_metrics:
            raise ValueError(
                f"train_batches yielded no batch for epoch {epoch}: the "
                "train split is smaller than batch_size under drop_last, "
                "and training would save untrained weights. Lower "
                "--batch_size or enlarge the dataset.")
        train_means = mean_metrics(epoch_metrics)   # syncs every step
        t_train_done = time.perf_counter()
        n_steps = len(epoch_metrics)
        steps_per_sec = ((n_steps - 1) / max(t_train_done - t_first_done,
                                             1e-9) if n_steps > 1 else 0.0)
        log_fn(f"Training Loss:{train_means.get('train_loss', math.nan)}")

        val_means = {}
        if val_batches is not None:
            val_means = mean_metrics([trainer.eval_step(b)
                                      for b in staged(val_batches())])
            if val_means:
                log_fn(f"Validation Loss:{val_means['val_loss']}")

        record = {"epoch": epoch, **train_means, **val_means,
                  "steps_per_sec": steps_per_sec,
                  "epoch_seconds": time.perf_counter() - t_epoch}
        history.append(record)

        if manager is not None:
            t_ckpt = time.perf_counter()
            if val_means:
                best.update(val_means, trainer.weights)
            if (epoch + 1) % max(ckpt_every, 1) == 0 \
                    or epoch == max_epochs - 1:
                manager.save("last", {"trainer": trainer.state_dict(),
                                      "epoch": epoch, "best": best.best})
            record["ckpt_wait_seconds"] = time.perf_counter() - t_ckpt

    if manager is not None:
        manager.save("final", trainer.weights())
        ema = trainer.ema_weights()
        if ema is not None:
            manager.save("final_ema", ema)
    return history
