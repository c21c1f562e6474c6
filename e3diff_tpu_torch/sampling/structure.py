"""Batched structure (angle) sampling (counterpart of
e3diff_tpu/sampling/structure.py).

Per batch: draw wrapped-Gaussian initial noise, encode the pocket and
project every decoder layer's cross-attention K/V once, then run the
reverse steps (DDPM or DDIM) as a Python loop of ``decode`` calls, and trim
each sample to its true ligand length. Reference quirk Q5 (only the first
batch is sampled, sample.py:237) is ``first_batch_only=True`` by default.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from e3diff_tpu_torch.data.dataset import strip_meta
from e3diff_tpu_torch.diffusion.gaussian import (
    GaussianAngleDiffusion,
    sample_wrapped_noise,
)
from e3diff_tpu_torch.diffusion.guidance import guided_combine, null_receptor
from e3diff_tpu_torch.utils.device import resolve_device


def make_denoise_fn(model, batch: dict, *, guided: bool, scale=1.0):
    """Encode the pocket and project the cross-attention K/V once; returns
    denoise_fn(t_vec, x) -> eps_hat, one ``decode`` per call (over the 2B
    conditional ‖ null batch, combined with ``scale``, when guided)."""
    rec_seq, rec_ang = batch["receptor_seq"], batch["receptor_angles"]
    rec_mask, lig_mask = batch["receptor_attn_mask"], batch["ligand_attn_mask"]
    if guided:
        nseq, nang, nmask = null_receptor(rec_seq, rec_ang, rec_mask)
        rec_seq = torch.cat([rec_seq, nseq])
        rec_ang = torch.cat([rec_ang, nang])
        rec_mask = torch.cat([rec_mask, nmask])
        lig_mask = torch.cat([lig_mask, lig_mask])
    enc_out = model.encode_receptor(rec_seq, rec_ang, rec_mask)
    cross_kv = model.precompute_cross_kv(enc_out)

    def denoise_fn(t_vec, x):
        if guided:
            t_vec = torch.cat([t_vec, t_vec])
            x = torch.cat([x, x])
        pred = model.decode(t_vec, x, lig_mask, enc_out, rec_mask,
                            cross_kv=cross_kv)
        return guided_combine(pred, scale) if guided else pred

    return denoise_fn


def make_structure_sampler(model, diffusion: GaussianAngleDiffusion, *,
                           step: int = 1, return_trajectory: bool = True,
                           sampler: str = "ddpm", ddim_steps: int = 50,
                           ddim_eta: float = 1.0, guidance_scale=1.0,
                           guided: bool | None = None):
    """Returns run(batch, generator=None, noise=None, scale=None) ->
    (final, trajectory or None).

    batch: dict of tensors on the model's device (ligand_angles,
    ligand_attn_mask, receptor_seq, receptor_angles, receptor_attn_mask).
    generator: the device generator the noise is drawn from, x_init first
    and then one z per step; or noise = {"x_init": (B, L, F),
    "z": (n_steps, B, L, F)} to inject the draws instead.

    sampler "ddpm" is the reference's ancestral loop (T forwards, or T/step
    with the lossy stride); "ddim" runs ddim_steps forwards. A guidance
    scale other than 1 (or guided=True) runs classifier-free guidance as
    one 2B forward per step; the scale, a number or a (B,) vector, may
    also be given per call."""
    if sampler not in ("ddpm", "ddim"):
        raise ValueError(f"unknown sampler {sampler!r}")
    if guided is None:
        guided = not (np.ndim(guidance_scale) == 0
                      and float(guidance_scale) == 1.0)

    def run(batch, generator=None, noise=None, scale=None):
        if noise is None and generator is None:
            raise ValueError("pass a generator or injected noise")
        lig = batch["ligand_angles"]
        x_init = (noise["x_init"] if noise is not None else
                  sample_wrapped_noise(lig.shape, generator=generator,
                                       device=lig.device, dtype=lig.dtype))
        denoise_fn = make_denoise_fn(
            model, batch, guided=guided,
            scale=guidance_scale if scale is None else scale)
        z = None if noise is None else noise["z"]
        if sampler == "ddim":
            return diffusion.sample_loop_ddim(
                denoise_fn, x_init, generator=generator, noise=z,
                n_steps=ddim_steps, eta=ddim_eta,
                return_trajectory=return_trajectory)
        return diffusion.sample_loop(
            denoise_fn, x_init, generator=generator, noise=z, step=step,
            return_trajectory=return_trajectory)

    return run


def sample_structure_batches(
    model,
    diffusion: GaussianAngleDiffusion,
    batches: Iterable[dict],
    *,
    device="cuda",
    seed: int = 0,
    step: int = 1,
    first_batch_only: bool = True,
    return_trajectory: bool = True,
    sampler: str = "ddpm",
    ddim_steps: int = 50,
    ddim_eta: float = 1.0,
    guidance_scale: float = 1.0,
) -> list[np.ndarray]:
    """Sample numpy batches on ``device`` (where the model lives); returns
    per-sample arrays shaped (T, len_i, 8) (trajectory) or (len_i, 8)
    (final only), the reference output.pkl layout."""
    device = resolve_device(device)
    run = make_structure_sampler(
        model, diffusion, step=step, return_trajectory=return_trajectory,
        sampler=sampler, ddim_steps=ddim_steps, ddim_eta=ddim_eta,
        guidance_scale=guidance_scale)
    generator = torch.Generator(device=device).manual_seed(seed)
    results = []
    for batch in batches:
        tbatch = {k: torch.as_tensor(np.asarray(v), device=device)
                  for k, v in strip_meta(batch).items()}
        final, traj = run(tbatch, generator)
        lengths = np.asarray(batch["ligand_attn_mask"]).sum(1).astype(int)
        num_valid = int(batch.get("num_valid", len(lengths)))
        if return_trajectory:
            traj = traj.float().cpu().numpy()
            results.extend(traj[:, i, :lengths[i], :] for i in range(num_valid))
        else:
            final = final.float().cpu().numpy()
            results.extend(final[i, :lengths[i], :] for i in range(num_valid))
        if first_batch_only:
            break
    return results
