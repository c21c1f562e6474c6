"""The epoch loop (counterpart of e3diff_tpu/training/loop.py, the
reference's Lightning Trainer use, structure_model/train_model.py:99-116):
train and validation epochs, epoch means of the metrics, the best-on-val
slot, the resumable ``last`` slot and the final weights.

On a CUDA device every train step is a replay of the trainer's step
captured as a CUDA graph (Trainer.capture) at the first batch of each
shape, as ``jax.jit`` compiles once per shape, and every eval step a
replay of the eval step captured the same way (Trainer.capture_eval; the
validation batches are zero-padded to one shape, so one graph serves
them); a step that cannot be captured raises. On the CPU, and on a gloo
mesh (whose collectives stage through the host and cannot be captured),
both steps run eagerly. ``profile_dir`` profiles the train steps
of one epoch (the second of the run, or its only one) and prints their
digest (utils/profiling.py); the trainer's spans (utils/telemetry.py)
land in it.

On the trainer's mesh every rank runs the loop on its rows of each batch;
the saves gather the whole state (``Trainer.full_state_dict``) and rank 0
writes them, synchronously; a resume cuts the saved state to the mesh.

Spans: ``train.eval`` over each validation pass and
``train.checkpoint_wait`` over each epoch's saves; each epoch's record
carries the seconds its steps waited for input (``data_wait_seconds``,
the sum of its ``train.data_wait`` spans, data/prefetch.py) and the
seconds of its saves (``ckpt_wait_seconds``).
"""

from __future__ import annotations

import math
import time
from typing import Callable, Iterable

import torch

from e3diff_tpu_torch.data.prefetch import prefetch_to_device, to_device
from e3diff_tpu_torch.sampling.graphs import WARMUP_CALLS
from e3diff_tpu_torch.training.checkpoint import BestTracker, CheckpointManager
from e3diff_tpu_torch.utils import profiling, telemetry
from e3diff_tpu_torch.utils.timing import profiler_trace


class MetricSums:
    """Epoch means of the steps' metrics: each step's 0-d tensors are added
    on the device into sums as the step returns them (a captured step
    rewrites the same tensors at its next replay), and ``means()`` copies
    them to the host once."""

    def __init__(self):
        self.sums: dict[str, torch.Tensor] = {}
        self.n = 0

    def add(self, metrics: dict) -> None:
        values = [v.detach().float() for v in metrics.values()]
        if not self.sums:
            self.sums = dict(zip(metrics, (v.clone() for v in values)))
        else:
            torch._foreach_add_(list(self.sums.values()), values)
        self.n += 1

    def means(self) -> dict:
        if not self.n:
            return {}
        means = (torch.stack(list(self.sums.values())) / self.n).tolist()
        return dict(zip(self.sums, means))


def log_profile_digest(path: str, n_steps: int,
                       log_fn: Callable[[str], None],
                       flops: float | None = None) -> None:
    """Print the digest of a profiled epoch's trace (``flops``: its GEMMs'
    operations, for captured steps); a trace that cannot be read is
    reported and never stops training."""
    try:
        d = profiling.digest(profiling.load_trace(path), max(n_steps, 1),
                             flops)
    except (OSError, ValueError, KeyError, TypeError) as e:
        log_fn(f"profile digest unavailable: {type(e).__name__}: {e}")
        return
    where = "device" if d["on_device"] else "host (a CPU run)"
    log_fn(f"profile [{path}] {where} buckets (ms/step): "
           + ", ".join(f"{k}={v:.3f}" for k, v in d["buckets"].items()))
    idle = d["device_idle_share"]
    log_fn(f"profile roofline: {d['roofline']}; device idle "
           + ("not measured" if idle is None else f"{100 * idle:.1f}%"))


def train_loop(trainer, train_batches: Callable[[int], Iterable[dict]],
               val_batches: Callable[[], Iterable[dict]] | None, *,
               max_epochs: int, device, ckpt_dir: str | None = None,
               ckpt_mode: str = "max", ckpt_every: int = 1,
               log_every: int = 30, log_fn: Callable[[str], None] = print,
               resume: bool = True, prefetch: int = 2,
               profile_dir: str | None = None) -> list[dict]:
    """Train ``trainer`` (a StructureTrainer or SequenceTrainer) to
    ``max_epochs``; returns one record per epoch run. ``train_batches(epoch)``
    and ``val_batches()`` yield numpy batches, copied to ``device`` by a
    background thread ``prefetch`` batches ahead (0: in line).
    ``steps_per_sec`` leaves out the first step of the epoch."""
    device = torch.device(device)
    mesh = trainer.mesh
    if mesh is not None and mesh.rank != 0:
        profile_dir = None   # one trace, rank 0's
    manager = best = None
    start_epoch = 0
    if ckpt_dir is not None:
        manager = CheckpointManager(
            ckpt_dir, writer=mesh is None or mesh.rank == 0)
        best = BestTracker(manager, mode=ckpt_mode)
        if resume and manager.exists("last"):
            last = manager.load("last")
            trainer.load_full_state_dict(last["trainer"])
            start_epoch = int(last["epoch"]) + 1
            if last["best"] is not None and math.isfinite(last["best"]):
                best.best = float(last["best"])
            log_fn(f"resumed from epoch {start_epoch}")

    def staged(batches):
        if prefetch:
            return prefetch_to_device(batches, device, size=prefetch)
        return (to_device(b, device) for b in batches)

    captured = {}   # batch shapes -> CapturedStep
    evals = {}      # batch shapes -> the captured eval step
    capture = device.type == "cuda" and (mesh is None or mesh.can_capture)
    pool = torch.cuda.graph_pool_handle() if capture else None
    # the GEMMs' operations of the epoch's captured steps, their warm-up
    # steps included: a trace of replays shows none (utils/profiling.py)
    gemm_flops = 0.0

    def shapes(batch):
        return tuple((k, tuple(v.shape)) for k, v in batch.items())

    def train_step(batch):
        nonlocal gemm_flops
        if not capture:
            return trainer.train_step(batch)
        key = shapes(batch)
        if key not in captured:
            captured[key] = trainer.capture(batch, pool=pool)
            gemm_flops += WARMUP_CALLS * captured[key].gemm_flops
        gemm_flops += captured[key].gemm_flops
        return captured[key](batch)

    def eval_step(batch):
        if not capture:
            return trainer.eval_step(batch)
        key = shapes(batch)
        if key not in evals:
            evals[key] = trainer.capture_eval(batch, pool=pool)
        return evals[key](batch)

    # the second epoch of this run (past the capture), or its only one
    profile_epoch = (start_epoch + 1 if max_epochs - start_epoch > 1
                     else start_epoch)
    history = []
    for epoch in range(start_epoch, max_epochs):
        sums = MetricSums()
        gemm_flops = 0.0
        t_epoch = time.perf_counter()
        t_first_done = None
        waited = telemetry.recorder().total("train.data_wait")[1]
        with profiler_trace(profile_dir if epoch == profile_epoch
                            else None) as trace_path:
            for i, batch in enumerate(staged(train_batches(epoch))):
                metrics = train_step(batch)
                sums.add(metrics)
                if i == 0:
                    metrics["train_loss"].item()  # a host sync: the first step
                    t_first_done = time.perf_counter()
                if log_every and i % log_every == 0:
                    log_fn(f"epoch {epoch} step {i}: "
                           f"loss={metrics['train_loss'].item():.4f}")
            n_steps = sums.n
            if not n_steps:
                raise ValueError(
                    f"train_batches yielded no batch for epoch {epoch}: the "
                    "train split is smaller than batch_size under drop_last, "
                    "and training would save untrained weights. Lower "
                    "--batch_size or enlarge the dataset.")
            train_means = sums.means()   # waits for every step
        t_train_done = time.perf_counter()
        waited = telemetry.recorder().total("train.data_wait")[1] - waited
        if trace_path is not None:
            log_profile_digest(trace_path, n_steps, log_fn,
                               gemm_flops if captured else None)
        steps_per_sec = ((n_steps - 1) / max(t_train_done - t_first_done,
                                             1e-9) if n_steps > 1 else 0.0)
        log_fn(f"Training Loss:{train_means.get('train_loss', math.nan)}")

        val_means = {}
        if val_batches is not None:
            with telemetry.span("train.eval"):
                val_sums = MetricSums()
                for b in staged(val_batches()):
                    val_sums.add(eval_step(b))
                val_means = val_sums.means()
            if val_means:
                log_fn(f"Validation Loss:{val_means['val_loss']}")

        record = {"epoch": epoch, **train_means, **val_means,
                  "steps_per_sec": steps_per_sec,
                  "data_wait_seconds": waited,
                  "epoch_seconds": time.perf_counter() - t_epoch}
        history.append(record)

        if manager is not None:
            with telemetry.span("train.checkpoint_wait") as saving:
                if val_means:
                    best.update(val_means, trainer.weights)
                if (epoch + 1) % max(ckpt_every, 1) == 0 \
                        or epoch == max_epochs - 1:
                    manager.save("last", {
                        "trainer": trainer.full_state_dict(),
                        "epoch": epoch, "best": best.best})
            record["ckpt_wait_seconds"] = saving.seconds

    for step in (*captured.values(), *evals.values()):
        step.close()
    if manager is not None:
        manager.save("final", trainer.weights())
        ema = trainer.ema_weights()
        if ema is not None:
            manager.save("final_ema", ema)
        manager.close()   # every file is written before the loop returns
    return history
