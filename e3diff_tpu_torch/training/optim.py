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
learning rate 0. The optimizer is plain PyTorch: the JAX package leaves it
to XLA, outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch
from torch import nn


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


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of every element squared), f32, on the tensors' device."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class AdamW:
    """optax.chain(clip_by_global_norm, adamw) over ``params`` (name ->
    Parameter). ``step(grads)`` applies one update in place and returns
    the gradients' global norm before clipping. The moments are tensors
    on the parameters' device; ``state_dict`` / ``load_state_dict`` carry
    them and the count for a resume."""

    def __init__(self, params: dict[str, nn.Parameter], *,
                 base_lr: float = 5e-5, weight_decay: float = 0.1,
                 max_epochs: int = 150, steps_per_epoch: int = 250,
                 grad_clip: float = 1.0, mu_dtype: str = "f32",
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        if mu_dtype not in ("f32", "bf16"):
            raise ValueError(f"mu_dtype must be f32 or bf16, got {mu_dtype!r}")
        self.names = list(params)
        self.params = [params[n] for n in self.names]
        self.schedule = linear_warmup_per_epoch(base_lr, max_epochs,
                                                steps_per_epoch)
        self.weight_decay, self.grad_clip = weight_decay, grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu_dtype = torch.bfloat16 if mu_dtype == "bf16" else None
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """One update from ``grads`` (in ``self.names`` order)."""
        norm = global_norm(grads)
        # clip_by_global_norm: (g / norm) * max_norm where norm >= max_norm
        clipped = torch._foreach_mul(torch._foreach_div(grads, norm),
                                     self.grad_clip)
        keep = norm < self.grad_clip
        grads = [torch.where(keep, g, c) for g, c in zip(grads, clipped)]
        b1, b2 = self.b1, self.b2
        # b1 mu in mu's own dtype, as optax's weak-typed scalar gives: under
        # mu_dtype bf16 both b1 and the product are rounded to bf16; the
        # sum is f32
        b1_mu = float(torch.tensor(b1, dtype=self.mu[0].dtype))
        mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1),
                                torch._foreach_mul(self.mu, b1_mu))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
            torch._foreach_mul(self.nu, b2))
        lr = self.schedule(self.count)
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(b1) ** f32(self.count))
        bc2 = float(f32(1) - f32(b2) ** f32(self.count))
        denom = torch._foreach_add(torch._foreach_sqrt(
            torch._foreach_div(nu, bc2)), self.eps)
        updates = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        if self.weight_decay:
            updates = torch._foreach_add(
                updates, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_add_(self.params, torch._foreach_mul(updates, -lr))
        self.mu = [m if self.mu_dtype is None else m.to(self.mu_dtype)
                   for m in mu]
        self.nu = list(nu)
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count,
                "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.mu = [state["mu"][n].to(m.device, m.dtype)
                   for n, m in zip(self.names, self.mu)]
        self.nu = [state["nu"][n].to(v.device, v.dtype)
                   for n, v in zip(self.names, self.nu)]


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
