"""AdamW with the JAX package's clipping, schedule and moments, written
as tensor ops in the order optax applies them (counterpart of
e3diff_tpu/training/optim.py).

The chain is optax.clip_by_global_norm(grad_clip) then optax.adamw:
- clipping: with norm the global L2 norm of all gradients, each gradient
  becomes g / norm * max_norm when norm >= max_norm and stays as it is
  otherwise (torch.nn.utils.clip_grad_norm_ would add 1e-6 to the norm);
- scale_by_adam: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, the
  count incremented, u = mu_hat / (sqrt(nu_hat) + eps) with
  mu_hat = mu / (1 - b1^count); mu is then stored in ``mu_dtype``;
- add_decayed_weights: u + weight_decay p (every parameter: the Fourier
  W is a buffer, neither trained nor decayed);
- scale_by_learning_rate: p + (-lr(step)) u, the schedule read at the
  step count before the update.
The schedule is the reference's per-epoch linear warmup (quirk Q12): HF
get_linear_schedule_with_warmup stepped once per epoch, warmup =
int(0.1 max_epochs) epochs, so with the presets every step of epoch 0 has
learning rate 0. The JAX package leaves the optimizer to XLA, outside any
Pallas kernel; here the clipping and the update after the global norm are
one pass, ops/kernels.py::adamw_update (csrc/adamw.cu on the card, the
chain of _foreach ops, its plain version, on the CPU), with the same bits.

On a mesh the clipping norm is the whole model's: the squares of the
tp-sharded gradients are summed over ``tp_group``, the replicated ones
counted once; clipping and AdamW then run on each rank's shard.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch
from torch import nn

from e3diff_tpu_torch.ops import kernels


def linear_warmup_per_epoch(base_lr: float, max_epochs: int,
                            steps_per_epoch: int) -> Callable[[int], float]:
    """lr(step): HF linear warmup / decay at epoch = step //
    steps_per_epoch, warmup = int(0.1 max_epochs), evaluated in float32 as
    the JAX schedule is."""
    warmup = int(max_epochs * 0.1)
    f32 = np.float32

    def schedule(step: int) -> float:
        epoch = f32(step // steps_per_epoch)
        warm = epoch / f32(max(1.0, float(warmup)))
        decay = (f32(max_epochs) - epoch) / f32(max(1.0, float(
            max_epochs - warmup)))
        factor = warm if epoch < warmup else max(f32(0.0), decay)
        return float(f32(base_lr) * f32(factor))

    return schedule


def global_norm(tensors: Iterable[torch.Tensor], sharded=None,
                mesh=None) -> torch.Tensor:
    """sqrt(sum of every element squared), f32, on the tensors' device.
    ``sharded`` (or None): device int64 indices of the tensors that are
    this rank's tp shards of a larger one, whose squares are summed over
    ``mesh.tp_group``, and of the replicated ones, counted once."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    if sharded is None:
        return torch.linalg.vector_norm(torch.stack(norms))
    split, whole = sharded
    sq = torch.stack(norms) ** 2
    part = mesh.all_reduce_tp_(sq.index_select(0, split).sum())
    return torch.sqrt(sq.index_select(0, whole).sum() + part)


def schedule_table(schedule: Callable[[int], float], steps: int,
                   steps_per_epoch: int, b1: float, b2: float) -> np.ndarray:
    """(steps + 1, 3) float32 rows (lr(r), 1 - b1^(r+1), 1 - b2^(r+1)) for
    the step counts r = 0..steps: what the update of step r reads. Each
    power is numpy's float32 scalar power, as the host arithmetic took it
    (numpy's vectorised power differs from it in the last place)."""
    f32 = np.float32
    per_epoch = [schedule(e * steps_per_epoch)
                 for e in range(steps // steps_per_epoch + 1)]
    table = np.empty((steps + 1, 3), np.float32)
    table[:, 0] = np.repeat(per_epoch, steps_per_epoch)[:steps + 1]
    for r in range(steps + 1):
        c = f32(r + 1)
        table[r, 1] = f32(1) - f32(b1) ** c
        table[r, 2] = f32(1) - f32(b2) ** c
    return table


class AdamW:
    """optax.chain(clip_by_global_norm, adamw) over ``params`` (name ->
    Parameter). ``step(grads)`` applies one update in place and returns
    the gradients' global norm before clipping.

    Every piece of state lives in device tensors that the step updates in
    place, so that a CUDA graph of the step stays bound to it: the moments,
    the step ``count`` (int64) and the ``table`` of schedule_table rows for
    every step of the run, which the step reads at ``count`` (a count past
    the run reads the last row, where the learning rate is 0).
    ``state_dict`` / ``load_state_dict`` carry the moments and the count
    for a resume; loading copies into the same tensors. ``mesh`` and
    ``sharding_rules`` (a mesh model's): the clipping norm sums the
    sharded gradients' squares over tp."""

    def __init__(self, params: dict[str, nn.Parameter], *,
                 base_lr: float = 5e-5, weight_decay: float = 0.1,
                 max_epochs: int = 150, steps_per_epoch: int = 250,
                 grad_clip: float = 1.0, mu_dtype: str = "f32",
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 mesh=None, sharding_rules: dict | None = None):
        if mu_dtype not in ("f32", "bf16"):
            raise ValueError(f"mu_dtype must be f32 or bf16, got {mu_dtype!r}")
        self.names = list(params)
        self.params = [params[n] for n in self.names]
        self.schedule = linear_warmup_per_epoch(base_lr, max_epochs,
                                                steps_per_epoch)
        self.weight_decay, self.grad_clip = weight_decay, grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu_dtype = torch.bfloat16 if mu_dtype == "bf16" else None
        device = self.params[0].device
        self.mesh, self.sharded = mesh, None
        if mesh is not None and mesh.tp > 1:
            split = [sharding_rules[n] != "replicated" for n in self.names]
            if any(split):
                self.sharded = tuple(
                    torch.tensor([i for i, s in enumerate(split) if s == want],
                                 dtype=torch.int64, device=device)
                    for want in (True, False))
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.table = torch.from_numpy(schedule_table(
            self.schedule, max_epochs * steps_per_epoch, steps_per_epoch,
            b1, b2)).to(device)
        self.mu = [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """One update from ``grads`` (in ``self.names`` order)."""
        norm = global_norm(grads, self.sharded, self.mesh)
        kernels.adamw_update(self.params, grads, self.mu, self.nu, norm,
                             self.table, self.count,
                             grad_clip=self.grad_clip, b1=self.b1, b2=self.b2,
                             eps=self.eps, weight_decay=self.weight_decay)
        return norm

    def state_dict(self) -> dict:
        """The live tensors (as nn.Module.state_dict gives them): a save
        copies them."""
        return {"count": self.count,
                "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count.fill_(int(state["count"]))
        for n, m, v in zip(self.names, self.mu, self.nu):
            m.copy_(state["mu"][n])
            v.copy_(state["nu"][n])


def accumulated_grads(loss_fn, params: list[torch.Tensor], batch: dict,
                      n: int):
    """Loss, aux and parameter gradients averaged over ``n``
    microbatches (counterpart of accumulated_value_and_grad): the batch
    (leading axis B, divisible by n) is split interleaved, rows j, j+n, ..
    in microbatch j; each runs ``loss_fn(microbatch) -> (loss, aux dict)``
    forward and backward in turn, and the results are the means of the n
    losses, auxes and gradients. Activation memory is that of one
    microbatch."""
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch size {b} not divisible by accum_steps {n}")
    loss_sum = aux_sum = grad_sum = None
    for j in range(n):
        mb = batch if n == 1 else {k: v[j::n].contiguous()
                                   for k, v in batch.items()}
        loss, aux = loss_fn(mb)
        grads = torch.autograd.grad(loss, params)
        if grad_sum is None:
            loss_sum, aux_sum, grad_sum = loss.detach(), {
                k: v.detach() for k, v in aux.items()}, list(grads)
        else:
            loss_sum = loss_sum + loss.detach()
            aux_sum = {k: aux_sum[k] + v.detach() for k, v in aux.items()}
            torch._foreach_add_(grad_sum, grads)
    if n == 1:
        return loss_sum, aux_sum, grad_sum
    inv = 1.0 / n
    return (loss_sum * inv, {k: v * inv for k, v in aux_sum.items()},
            torch._foreach_mul(grad_sum, inv))


@torch.no_grad()
def ema_update(ema: list[torch.Tensor], params: list[torch.Tensor],
               decay: float) -> None:
    """ema <- decay ema + (1 - decay) params, in place."""
    new = torch._foreach_add(torch._foreach_mul(ema, decay),
                             torch._foreach_mul(params, 1.0 - decay))
    for e, n in zip(ema, new):
        e.copy_(n)
