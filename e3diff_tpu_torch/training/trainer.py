"""What the two trainers share: the train step (accumulated gradients
through the kernels, clipping and AdamW, EMA), the eval step, the
resumable state and the reference-layout weights."""

from __future__ import annotations

import torch
from torch import nn

from e3diff_tpu_torch.models.blocks import set_dropout_generator
from e3diff_tpu_torch.training.optim import (
    AdamW,
    accumulated_grads,
    ema_update,
)


class Trainer:
    """A model, its diffusion and its optimizer (over the model's
    parameters, built by the caller), with:

    * ``ema_decay``: 0 (off) or the decay of an EMA copy of the
      parameters, updated after each step;
    * ``accum_steps``: microbatches per step (training/optim.py::
      accumulated_grads);
    * ``cond_dropout``: the probability of replacing an example's
      conditioning with the null conditioning during training;
    * ``generator``: the one source of the noising, dropout and
      conditioning-dropout draws, on the model's device.

    Subclasses define ``_loss(batch) -> (loss, aux dict)``, the names of
    the draws a caller may inject (``INJECTED``) and ``_metrics``."""

    INJECTED: tuple[str, ...] = ()

    def __init__(self, model: nn.Module, diffusion, optimizer: AdamW, *,
                 ema_decay: float = 0.0, accum_steps: int = 1,
                 cond_dropout: float = 0.0,
                 generator: torch.Generator | None = None):
        names = [n for n, _ in model.named_parameters()]
        if names != optimizer.names:
            raise ValueError("the optimizer does not hold the model's "
                             "parameters")
        self.model, self.diffusion, self.optimizer = model, diffusion, optimizer
        self.ema_decay, self.accum_steps = ema_decay, accum_steps
        self.cond_dropout = cond_dropout
        self.generator = generator
        set_dropout_generator(model, generator)
        self.ema = ([p.detach().clone() for p in optimizer.params]
                    if ema_decay else None)

    def _with_draws(self, batch: dict, draws: dict) -> dict:
        unknown = set(draws) - set(self.INJECTED)
        if unknown:
            raise TypeError(f"unknown injected draws {sorted(unknown)}")
        return {**batch, **{k: v for k, v in draws.items() if v is not None}}

    def loss(self, batch: dict, **draws):
        """(loss, aux) of one forward over the whole batch in the model's
        current mode, with autograd."""
        return self._loss(self._with_draws(batch, draws))

    def train_step(self, batch: dict, **draws) -> dict:
        """One optimizer step; returns the step's metrics as 0-d tensors on
        the device (no host sync): the loss and its parts, and
        ``grad_norm``, the gradients' global norm before clipping."""
        self.model.train()
        loss, aux, grads = accumulated_grads(
            self._loss, self.optimizer.params, self._with_draws(batch, draws),
            self.accum_steps)
        grad_norm = self.optimizer.step(grads)
        if self.ema is not None:
            ema_update(self.ema, self.optimizer.params, self.ema_decay)
        metrics = self._metrics("train", loss, aux)
        metrics["grad_norm"] = grad_norm
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: dict, **draws) -> dict:
        """The validation metrics of one batch: eval mode (no dropout, no
        conditioning dropout), forward kernels only."""
        self.model.eval()
        loss, aux = self._loss(self._with_draws(batch, draws))
        return self._metrics("val", loss, aux)

    # -- checkpoints -----------------------------------------------------
    def weights(self) -> dict[str, torch.Tensor]:
        """The model's reference-layout state_dict, f32 on the CPU."""
        return {k: v.detach().float().cpu()
                for k, v in self.model.state_dict().items()}

    def ema_weights(self) -> dict[str, torch.Tensor] | None:
        """``weights()`` with the EMA parameters, or None without EMA."""
        if self.ema is None:
            return None
        out = self.weights()
        for name, e in zip(self.optimizer.names, self.ema):
            out[name] = e.detach().float().cpu()
        return out

    def state_dict(self) -> dict:
        """Everything a resume needs: weights, optimizer, EMA, generator."""
        return {
            "model": self.weights(),
            "optimizer": self.optimizer.state_dict(),
            "ema": (None if self.ema is None else
                    dict(zip(self.optimizer.names, self.ema))),
            "generator": (None if self.generator is None
                          else self.generator.get_state()),
        }

    def load_state_dict(self, state: dict) -> None:
        with torch.no_grad():
            self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        if (state["ema"] is None) != (self.ema is None):
            raise ValueError("the checkpoint's EMA does not match ema_decay")
        if self.ema is not None:
            for name, e in zip(self.optimizer.names, self.ema):
                e.copy_(state["ema"][name])
        if self.generator is not None and state["generator"] is not None:
            self.generator.set_state(state["generator"])
