"""Training and evaluation steps of the structure (angle) DDPM
(counterpart of e3diff_tpu/training/structure.py; reference Lightning
training_step, structure_model/model.py:266-359).

One step: noising (t uniform in [0, T), wrapped Gaussian eps) + forward +
per-channel radian losses + backward through the kernels + clipping +
AdamW. Loss assignment (reference train_model.py:94-95): the 4 dihedral
channels take radian L1, the 4 bond-angle channels smooth L1 with
beta = pi/10; each channel is averaged over the unmasked ligand positions,
and the loss is the mean over the 8 channels.
"""

from __future__ import annotations

import math

import torch

from e3diff_tpu_torch.diffusion.gaussian import (
    GaussianAngleDiffusion,
    sample_wrapped_noise,
)
from e3diff_tpu_torch.diffusion.guidance import drop_conditioning
from e3diff_tpu_torch.ops.angles import wrap_angle
from e3diff_tpu_torch.training.trainer import Trainer

FEATURE_NAMES = ["phi", "psi", "omega", "dihedral_o",
                 "tau", "CA:C:1N", "1C:N:CA", "CA:C:O"]
SMOOTH_L1_BETA = math.pi / 10


def structure_loss_terms(pred_noise, known_noise, ligand_mask, count=None):
    """(8,) per-channel masked losses in FEATURE_NAMES order, computed in
    f32 whatever the model's compute dtype (the reference's boolean index
    then mean, model.py:293-302). ``count``: the denominator's mask count
    (on a mesh the global one, so that the terms are this rank's share);
    the mask's own sum when None."""
    pred = pred_noise.float()
    known = known_noise.float()
    mask = ligand_mask.float()
    d_l1 = known % (2 * math.pi) - pred % (2 * math.pi)
    d_l1 = (d_l1 + math.pi) % (2 * math.pi) - math.pi
    l1 = d_l1.abs()
    d_s = wrap_angle(known - pred)
    abs_d = d_s.abs()
    huber = torch.where(abs_d < SMOOTH_L1_BETA,
                        0.5 * d_s ** 2 / SMOOTH_L1_BETA,
                        abs_d - 0.5 * SMOOTH_L1_BETA)
    per_elem = torch.cat([l1[..., :4], huber[..., 4:]], dim=-1)
    denom = torch.clamp(mask.sum() if count is None else count, min=1.0)
    return (per_elem * mask[..., None]).sum(dim=(0, 1)) / denom


class StructureTrainer(Trainer):
    """Steps over batches of ligand_angles (B, L, 8), ligand_attn_mask
    (B, L), receptor_angles (B, L, 8), receptor_attn_mask (B, L) and
    receptor_seq (B, L, 20) on the model's device.

    Injected draws (keywords of ``loss``, ``train_step``, ``eval_step``),
    each over the whole batch: ``t`` (B,) steps, ``noise`` (B, L, 8) eps,
    ``cond_drop`` (B,) bool; whatever is not injected is drawn from the
    trainer's generator, in this order: cond_drop, t, noise."""

    diffusion: GaussianAngleDiffusion
    INJECTED = ("t", "noise", "cond_drop")
    MODEL = "structure"

    def _loss(self, batch):
        x0 = batch["ligand_angles"]
        n, gen, dev = x0.shape[0], self.generator, x0.device
        if self.cond_dropout and self.model.training:
            drop = batch.get("cond_drop")
            if drop is None:
                drop = self._draw(lambda m: torch.rand(
                    m, generator=gen, device=dev) < self.cond_dropout, n)
            batch = drop_conditioning(self.cond_dropout, batch, drop=drop)
        t = batch.get("t")
        if t is None:
            t = self._draw(lambda m: torch.randint(
                0, self.diffusion.timesteps, (m,), generator=gen,
                device=dev), n)
        noise = batch.get("noise")
        if noise is None:
            noise = self._draw(lambda m: sample_wrapped_noise(
                (m,) + tuple(x0.shape[1:]), generator=gen, device=dev,
                dtype=x0.dtype), n)
        t, noise, x_t = self.diffusion.noise_batch(x0, t=t, noise=noise)
        pred = self.model(t, x_t, batch["ligand_attn_mask"],
                          batch["receptor_seq"], batch["receptor_angles"],
                          batch["receptor_attn_mask"])
        mask = batch["ligand_attn_mask"]
        terms = structure_loss_terms(pred, noise, mask,
                                     self._global(mask.float().sum()))
        return terms.mean(), {"terms": terms}

    def _metrics(self, prefix, loss, aux):
        metrics = {f"{prefix}_loss_{n}": aux["terms"][i]
                   for i, n in enumerate(FEATURE_NAMES)}
        metrics[f"{prefix}_loss"] = loss
        return metrics
