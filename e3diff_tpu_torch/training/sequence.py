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

from e3diff_tpu_torch.diffusion.d3pm import D3PMDiffusion
from e3diff_tpu_torch.diffusion.guidance import drop_conditioning
from e3diff_tpu_torch.ops.elbo import elbo_loss
from e3diff_tpu_torch.training.trainer import Trainer


def masked_cross_entropy(logits, target_onehot, mask):
    """Mean CE over the masked positions (torch CE on boolean-indexed
    rows)."""
    ce = -(target_onehot * torch.log_softmax(logits, dim=-1)).sum(-1)
    m = mask.to(ce.dtype)
    return (ce * m).sum() / torch.clamp(m.sum(), min=1.0)


def sequence_losses(pred_logits, noised_seq, ligand_seq, ligand_mask):
    """(total loss, metrics) of the reference's get_loss
    (sequence_model/model.py:313-345), in f32 whatever the model's
    compute dtype."""
    pred = pred_logits.float()
    lig_mask = ligand_mask.bool()
    target = ligand_seq.argmax(-1)
    noised_mask = noised_seq.argmax(-1) != target
    denom = torch.clamp(lig_mask.sum(), min=1)
    aa_noise_rate = (lig_mask & ~noised_mask).sum() / denom
    aa_recovery_rate = (lig_mask & (pred.argmax(-1) == target)).sum() / denom
    target_onehot = ligand_seq.float()
    aa_noised_loss = masked_cross_entropy(pred, target_onehot, noised_mask)
    aa_all_loss = masked_cross_entropy(pred, target_onehot,
                                       lig_mask & ~noised_mask)
    elbo = elbo_loss(pred, target_onehot, mask=noised_mask)
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
    trainer's generator."""

    diffusion: D3PMDiffusion
    INJECTED = ("t_int", "gumbel", "cond_drop")

    def _loss(self, batch):
        if self.cond_dropout and self.model.training:
            batch = drop_conditioning(self.cond_dropout, batch,
                                      generator=self.generator,
                                      drop=batch.get("cond_drop"),
                                      drop_ligand_angles=True)
        lig = batch["ligand_seq"]
        t_int = batch.get("t_int")
        if t_int is None:   # Q10: {0..T} inclusive
            t_int = torch.randint(0, self.diffusion.timesteps + 1,
                                  (lig.shape[0],), generator=self.generator,
                                  device=lig.device)
        t_norm = (t_int.float() / self.diffusion.timesteps)[:, None]
        noised = self.diffusion.apply_aa_noise(
            lig, t_int, generator=self.generator, gumbel=batch.get("gumbel"))
        pred = self.model(t_norm, noised, batch["ligand_angles"],
                          batch["ligand_attn_mask"], batch["receptor_seq"],
                          batch["receptor_angles"],
                          batch["receptor_attn_mask"])
        total, metrics = sequence_losses(pred, noised, lig,
                                         batch["ligand_attn_mask"])
        metrics["avg_timestep"] = t_int.float().mean()
        return total, metrics

    def _metrics(self, prefix, loss, aux):
        metrics = {f"{prefix}_{k}": v for k, v in aux.items()}
        metrics[f"{prefix}_loss"] = loss
        return metrics
