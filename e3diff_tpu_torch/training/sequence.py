"""Training and evaluation steps of the sequence D3PM (inverse folding)
(counterpart of e3diff_tpu/training/sequence.py; reference
sequence_model/model.py:291-367).

The reference's loss semantics are kept (SURVEY.md Q10, Q11):
* t is drawn uniformly from {0..T} inclusive, and the model is
  conditioned on t/T;
* the noised positions are where the noised class differs from the
  original (padding drops out: both are class 0 there);
* the loss is CE(noised positions) + ELBO(noised positions); the CE over
  the un-noised ligand positions is computed and logged, not added.
The masked means hold their denominators at 1 or more, where the
reference's CE over an empty set would be NaN.
"""

from __future__ import annotations

import torch

from e3diff_tpu_torch.diffusion.d3pm import D3PMDiffusion, sample_gumbel
from e3diff_tpu_torch.diffusion.guidance import drop_conditioning
from e3diff_tpu_torch.ops.elbo import elbo_loss
from e3diff_tpu_torch.training.trainer import Trainer


def masked_cross_entropy(logits, target_onehot, mask, count=None):
    """Mean CE over the masked positions (torch CE on boolean-indexed
    rows); ``count``: the denominator (a global count on a mesh), the
    mask's own sum when None."""
    ce = -(target_onehot * torch.log_softmax(logits, dim=-1)).sum(-1)
    m = mask.to(ce.dtype)
    return (ce * m).sum() / torch.clamp(m.sum() if count is None else count,
                                        min=1.0)


def loss_masks(noised_seq, ligand_seq, ligand_mask):
    """The ligand, noised and un-noised ligand position masks (bool)."""
    lig_mask = ligand_mask.bool()
    noised_mask = noised_seq.argmax(-1) != ligand_seq.argmax(-1)
    return lig_mask, noised_mask, lig_mask & ~noised_mask


def sequence_losses(pred_logits, noised_seq, ligand_seq, ligand_mask,
                    counts=None):
    """(total loss, metrics) of the reference's get_loss
    (sequence_model/model.py:313-345), in f32 whatever the model's
    compute dtype. ``counts``: the three ``loss_masks`` counts that the
    means divide by (f32; on a mesh the global ones, so that every value
    is this rank's share), the masks' own sums when None."""
    pred = pred_logits.float()
    lig_mask, noised_mask, clean_mask = loss_masks(noised_seq, ligand_seq,
                                                   ligand_mask)
    target = ligand_seq.argmax(-1)
    if counts is None:
        denom = torch.clamp(lig_mask.sum(), min=1)
        n_noised = n_clean = None
    else:
        denom = torch.clamp(counts[0], min=1.0)
        n_noised, n_clean = counts[1], counts[2]
    aa_noise_rate = clean_mask.sum() / denom
    aa_recovery_rate = (lig_mask & (pred.argmax(-1) == target)).sum() / denom
    target_onehot = ligand_seq.float()
    aa_noised_loss = masked_cross_entropy(pred, target_onehot, noised_mask,
                                          n_noised)
    aa_all_loss = masked_cross_entropy(pred, target_onehot, clean_mask,
                                       n_clean)
    elbo = elbo_loss(pred, target_onehot, mask=noised_mask, count=n_noised)
    return aa_noised_loss + elbo, {
        "aa_noise_rate": aa_noise_rate,
        "aa_recovery_rate": aa_recovery_rate,
        "aa_noised_loss": aa_noised_loss,
        "aa_all_loss": aa_all_loss,
        "elbo_loss": elbo,
    }


class SequenceTrainer(Trainer):
    """Steps over batches of ligand_seq (B, L, 20), ligand_angles,
    ligand_attn_mask, receptor_seq, receptor_angles and
    receptor_attn_mask on the model's device.

    Injected draws, each over the whole batch: ``t_int`` (B,) steps in
    0..T, ``gumbel`` (B, L, 20) noise of the categorical draw,
    ``cond_drop`` (B,) bool; whatever is not injected is drawn from the
    trainer's generator, in this order: cond_drop, t_int, gumbel."""

    diffusion: D3PMDiffusion
    INJECTED = ("t_int", "gumbel", "cond_drop")
    MODEL = "sequence"

    def _loss(self, batch):
        lig = batch["ligand_seq"]
        n, gen, dev = lig.shape[0], self.generator, lig.device
        if self.cond_dropout and self.model.training:
            drop = batch.get("cond_drop")
            if drop is None:
                drop = self._draw(lambda m: torch.rand(
                    m, generator=gen, device=dev) < self.cond_dropout, n)
            batch = drop_conditioning(self.cond_dropout, batch, drop=drop,
                                      drop_ligand_angles=True)
        t_int = batch.get("t_int")
        if t_int is None:   # Q10: {0..T} inclusive
            t_int = self._draw(lambda m: torch.randint(
                0, self.diffusion.timesteps + 1, (m,), generator=gen,
                device=dev), n)
        gumbel = batch.get("gumbel")
        if gumbel is None:
            gumbel = self._draw(lambda m: sample_gumbel(
                (m,) + tuple(lig.shape[1:]), generator=gen, device=dev), n)
        t_norm = (t_int.float() / self.diffusion.timesteps)[:, None]
        noised = self.diffusion.apply_aa_noise(lig, t_int, gumbel=gumbel)
        pred = self.model(t_norm, noised, batch["ligand_angles"],
                          batch["ligand_attn_mask"], batch["receptor_seq"],
                          batch["receptor_angles"],
                          batch["receptor_attn_mask"])
        counts = None
        if self._dp_split():
            counts = self._global(torch.stack([
                m.float().sum() for m in loss_masks(
                    noised, lig, batch["ligand_attn_mask"])]))
        total, metrics = sequence_losses(pred, noised, lig,
                                         batch["ligand_attn_mask"], counts)
        # a rank's share of the global batch's mean
        metrics["avg_timestep"] = t_int.float().mean() / (
            self.mesh.dp if self._dp_split() else 1)
        return total, metrics

    def _metrics(self, prefix, loss, aux):
        metrics = {f"{prefix}_{k}": v for k, v in aux.items()}
        metrics[f"{prefix}_loss"] = loss
        return metrics
