"""Batched sequence (inverse-folding) sampling with recovery rates
(counterpart of e3diff_tpu/sampling/sequence.py; sequence_model/
sample.py:181-258 and sample_by_generated_angles.py).

Per batch: draw uniform one-hot noise, run the D3PM reverse loop as a
Python loop of full SequenceDenoiser forwards (the receptor fuse takes the
timestep, so nothing is computed once per batch), argmax the final logits,
decode them to amino-acid strings and score them against the true
sequence. ``generated_angles`` replaces the native ligand backbone angles
with the structure sampler's (the end-to-end pipeline).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from e3diff_tpu_torch.data.dataset import AA_VOCAB, strip_meta
from e3diff_tpu_torch.diffusion.d3pm import D3PMDiffusion
from e3diff_tpu_torch.diffusion.guidance import (
    concat_cond_uncond,
    guided_combine,
)
from e3diff_tpu_torch.utils.device import resolve_device

COND_FIELDS = ("ligand_angles", "ligand_attn_mask", "receptor_seq",
               "receptor_angles", "receptor_attn_mask")


def make_sequence_sampler(model, d3pm: D3PMDiffusion, *, diverse: bool = True,
                          n_steps: int | None = None, guidance_scale=1.0,
                          guided: bool | None = None):
    """Returns run(batch, generator=None, noise=None, scale=None) -> final
    logits (B, L, K).

    batch: dict of tensors on the model's device (ligand_seq for the
    shape, plus COND_FIELDS). generator: the device generator that x_init
    and then each step's Gumbel noise are drawn from; or noise =
    {"x_init": (B, L, K) one-hots, "gumbel": (n_pairs, B, L, K)} to inject
    the draws ("gumbel" may be left out when ``diverse`` is False).

    A guidance scale other than 1 (or guided=True) runs classifier-free
    guidance on the logits as one 2B forward per step; the null branch
    drops the pocket and the ligand angles, as training's conditioning
    dropout does. The scale, a number or a (B,) vector, may also be given
    per call."""
    if guided is None:
        guided = not (np.ndim(guidance_scale) == 0
                      and float(guidance_scale) == 1.0)

    @torch.no_grad()
    def run(batch, generator=None, noise=None, scale=None):
        if noise is None and generator is None:
            raise ValueError("pass a generator or injected noise")
        lig = batch["ligand_seq"]
        b, length, _ = lig.shape
        x_init = (noise["x_init"] if noise is not None else
                  d3pm.init_noise(b, length, generator=generator,
                                  device=lig.device, dtype=lig.dtype))
        cond = {f: batch[f] for f in COND_FIELDS}
        if guided:
            cond = concat_cond_uncond(cond, drop_ligand_angles=True)
        w = guidance_scale if scale is None else scale

        def denoise_fn(s_arr, x):
            if guided:
                s_arr = torch.cat([s_arr, s_arr])
                x = torch.cat([x, x])
            logits = model(s_arr, x, cond["ligand_angles"],
                           cond["ligand_attn_mask"], cond["receptor_seq"],
                           cond["receptor_angles"],
                           cond["receptor_attn_mask"])
            return guided_combine(logits, w) if guided else logits

        return d3pm.sample_loop(
            denoise_fn, x_init, generator=generator,
            gumbel=None if noise is None else noise.get("gumbel"),
            diverse=diverse, n_steps=n_steps)

    return run


def decode(indices: np.ndarray, mask: np.ndarray) -> str:
    return "".join(AA_VOCAB[i] for i in indices[mask.astype(bool)])


def sample_sequence_batches(
    model,
    d3pm: D3PMDiffusion,
    batches: Iterable[dict],
    *,
    device="cuda",
    seed: int = 0,
    diverse: bool = True,
    n_steps: int | None = None,
    generated_angles: Sequence[np.ndarray] | None = None,
    guidance_scale: float = 1.0,
) -> dict:
    """Sample numpy batches on ``device`` (where the model lives); returns
    the structure_ids, true_sequence, predict_sequence and recovery_rate
    lists (the reference's pickled DataFrame columns)."""
    device = resolve_device(device)
    run = make_sequence_sampler(model, d3pm, diverse=diverse,
                                n_steps=n_steps,
                                guidance_scale=guidance_scale)
    generator = torch.Generator(device=device).manual_seed(seed)
    out = {"structure_ids": [], "true_sequence": [],
           "predict_sequence": [], "recovery_rate": []}
    for batch_idx, batch in enumerate(batches):
        tbatch = {k: torch.as_tensor(np.asarray(v), device=device)
                  for k, v in strip_meta(batch).items()}
        if generated_angles is not None:
            tbatch["ligand_angles"] = torch.as_tensor(
                np.asarray(generated_angles[batch_idx]),
                dtype=tbatch["ligand_angles"].dtype, device=device)
        pred = run(tbatch, generator).float().argmax(-1).cpu().numpy()
        true = np.asarray(batch["ligand_seq"]).argmax(-1)
        masks = np.asarray(batch["ligand_attn_mask"])
        num_valid = int(batch.get("num_valid", pred.shape[0]))
        ids = batch.get("structure_ids", [{} for _ in range(pred.shape[0])])
        for i in range(num_valid):
            m = masks[i].astype(bool)
            out["recovery_rate"].append(
                float((pred[i][m] == true[i][m]).sum() / max(m.sum(), 1)))
            out["predict_sequence"].append(decode(pred[i], masks[i]))
            out["true_sequence"].append(decode(true[i], masks[i]))
            sid = ids[i] if i < len(ids) else {}
            out["structure_ids"].append(
                f'{sid.get("pdb_id", "?")}_{sid.get("ligand_chain", "?")}')
    return out
