"""Plain reference of the structure model's train step (LabJunBMI/
E3-invaraint-diffusion-model structure_model/model.py:266-359 and
train_model.py:94-95, with optax's clip_by_global_norm and adamw, which
the configuration names): noising, the per-channel radian losses,
autograd, clipping by the global norm, AdamW. Float32; imports nothing of
the program.

The step draws, from one generator and in this order, what the program's
step draws: t uniform in [0, T), the wrapped Gaussian noise, then the
forward's dropout uniforms and attention seeds (nets.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import nets
from benchmark.reference.diffusion import Gaussian, wrap

BETA = math.pi / 10


def loss_terms(pred, noise, mask):
    """(8,) masked losses: radian L1 on the 4 dihedrals, smooth L1 (beta
    pi/10) on the 4 bond angles, each averaged over the ligand."""
    pred, noise, mask = pred.float(), noise.float(), mask.float()
    d = noise % (2 * math.pi) - pred % (2 * math.pi)
    l1 = ((d + math.pi) % (2 * math.pi) - math.pi).abs()
    ds = wrap(noise - pred).abs()
    huber = torch.where(ds < BETA, 0.5 * ds ** 2 / BETA, ds - 0.5 * BETA)
    per = torch.cat([l1[..., :4], huber[..., 4:]], dim=-1)
    return (per * mask[..., None]).sum(dim=(0, 1)) / mask.sum().clamp(min=1)


def lr_at(step: int, base_lr: float, max_epochs: int,
          steps_per_epoch: int) -> float:
    """HF linear warm-up and decay by epoch, in float32."""
    f32 = np.float32
    warmup = int(max_epochs * 0.1)
    epoch = f32(step // steps_per_epoch)
    warm = epoch / f32(max(1.0, float(warmup)))
    decay = (f32(max_epochs) - epoch) / f32(max(1.0, float(max_epochs
                                                          - warmup)))
    factor = warm if epoch < warmup else max(f32(0.0), decay)
    return float(f32(base_lr) * f32(factor))


class AdamW:
    """clip_by_global_norm(clip) then adamw(lr(step), b1, b2, eps,
    weight_decay) over every parameter."""

    def __init__(self, params: dict, job: dict):
        self.job = job
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        """Updates ``params`` in place; returns the clipped gradients."""
        job = self.job
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
        clip = job["grad_clip"]
        if norm >= clip:
            grads = {k: g / norm * clip for k, g in grads.items()}
        b1, b2, eps = job["b1"], job["b2"], job["eps"]
        lr = lr_at(self.count, job["lr"], job["max_epochs"],
                   job["steps_per_epoch"])
        c = self.count + 1
        bc1 = float(np.float32(1) - np.float32(b1) ** c)
        bc2 = float(np.float32(1) - np.float32(b2) ** c)
        self.count += 1
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = b1 * self.mu[k] + (1 - b1) * g
            self.nu[k] = b2 * self.nu[k] + (1 - b2) * g * g
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + eps)
            p -= lr * (u + job["weight_decay"] * p)
        return grads


def train_steps(weights: dict, batches: list[dict], job: dict, cfg: dict,
                gen_seed: int, device, matmul=nets.f32_matmul,
                t_dtype=torch.float32):
    """Run len(batches) steps from ``weights`` (copied). Returns the
    losses, the first step's clipped gradients and the parameters after
    the last step, as dicts of float32 tensors."""
    buffers = {k: v for k, v in weights.items() if k.endswith(".W")}
    params = {k: v.clone().requires_grad_(True) for k, v in weights.items()
              if k not in buffers}
    gen = torch.Generator(device=device).manual_seed(int(gen_seed))
    diff = Gaussian(cfg["timesteps"], device)
    opt = AdamW(params, job)
    losses, first_grads = [], None
    for batch in batches:
        x0 = batch["ligand_angles"]
        n = x0.shape[0]
        t = torch.randint(0, cfg["timesteps"], (n,), generator=gen,
                          device=device)
        noise = wrap(torch.randn(x0.shape, generator=gen, device=device))
        x_t = diff.q_sample(x0, t, noise)
        ctx = nets.Ctx({**params, **buffers}, cfg["num_heads"],
                       cfg["max_seq_len"], matmul=matmul, t_dtype=t_dtype,
                       generator=gen, dropout=cfg["dropout_p"])
        pred = nets.structure_forward(
            ctx, t, x_t, batch["ligand_attn_mask"], batch["receptor_seq"],
            batch["receptor_angles"], batch["receptor_attn_mask"])
        loss = loss_terms(pred, noise, batch["ligand_attn_mask"]).mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        clipped = opt.step(params, dict(zip(params, grads)))
        if first_grads is None:
            first_grads = {k: g.detach() for k, g in clipped.items()}
        losses.append(float(loss.detach()))
    return losses, first_grads, {k: v.detach() for k, v in params.items()}
