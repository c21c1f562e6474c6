"""Classifier-free guidance (counterpart of e3diff_tpu/diffusion/guidance.py).

The null conditioning is a zeroed pocket behind a one-token attention mask.
Training replaces the conditioning with it per example
(``drop_conditioning``). The guided sampler runs both branches as one
forward over a 2B batch (conditional half first) and combines
pred = uncond + w (cond - uncond).
"""

from __future__ import annotations

import torch


def null_receptor(receptor_seq, receptor_angles, receptor_mask):
    """The canonical unconditional pocket: zero features, one valid key."""
    nmask = torch.zeros_like(receptor_mask)
    nmask[:, 0] = 1
    return torch.zeros_like(receptor_seq), torch.zeros_like(receptor_angles), nmask


def drop_conditioning(p: float, batch: dict, *,
                      generator: torch.Generator | None = None, drop=None,
                      drop_ligand_angles: bool = False) -> dict:
    """Per-example conditioning dropout for training: where ``drop`` (a
    (B,) bool, drawn as uniform < p from ``generator`` unless given) is
    true, the pocket fields (and, for the sequence model, the ligand
    angles) take the null conditioning. Returns a new dict; the caller
    skips the call at p = 0, so that no draw is made."""
    mask = batch["receptor_attn_mask"]
    b = mask.shape[0]
    if drop is None:
        drop = torch.rand(b, generator=generator, device=mask.device) < p
    drop = drop.to(device=mask.device, dtype=torch.bool)

    def pick(cond_val, null_val):
        return torch.where(drop.reshape((b,) + (1,) * (cond_val.ndim - 1)),
                           null_val, cond_val)

    nseq, nang, nmask = null_receptor(
        batch["receptor_seq"], batch["receptor_angles"], mask)
    out = dict(batch)
    out["receptor_seq"] = pick(batch["receptor_seq"], nseq)
    out["receptor_angles"] = pick(batch["receptor_angles"], nang)
    out["receptor_attn_mask"] = pick(mask, nmask)
    if drop_ligand_angles:
        out["ligand_angles"] = pick(batch["ligand_angles"],
                                    torch.zeros_like(batch["ligand_angles"]))
    return out


def guided_combine(pred_2b, guidance_scale):
    """Split a 2B prediction (conditional half first) and combine.

    ``guidance_scale``: a scalar or a per-example (B,) vector, as a number
    or a tensor. As in the JAX package, w is float32 and the difference is
    taken in the prediction's dtype before it is scaled."""
    cond, uncond = pred_2b.chunk(2, dim=0)
    w = torch.as_tensor(guidance_scale, dtype=torch.float32,
                        device=pred_2b.device)
    if w.ndim:
        w = w.reshape((-1,) + (1,) * (cond.ndim - 1))
    # float() first: a 0-d f32 tensor would not promote a bf16 operand
    return uncond.float() + w * (cond - uncond).float()


def concat_cond_uncond(batch: dict, drop_ligand_angles: bool = False) -> dict:
    """The 2B guided batch: conditional half, then the null half. Fields
    that are not conditioning are tiled; the pocket fields (and, for the
    sequence model, the ligand angles, zeroed) take the null
    conditioning in the second half. The ligand mask is never dropped:
    the peptide's length is part of the task."""
    nseq, nang, nmask = null_receptor(
        batch["receptor_seq"], batch["receptor_angles"],
        batch["receptor_attn_mask"])
    nulls = {"receptor_seq": nseq, "receptor_angles": nang,
             "receptor_attn_mask": nmask}
    if drop_ligand_angles:
        nulls["ligand_angles"] = torch.zeros_like(batch["ligand_angles"])
    return {k: torch.cat([v, nulls.get(k, v)]) for k, v in batch.items()}
