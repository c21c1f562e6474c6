"""End-to-end pipeline: sample angles -> write PDBs -> inverse-fold
(counterpart of e3diff_tpu/sampling/pipeline.py; the reference's
structure_model/sample.py -> create_pdb.py -> sample_by_generated_angles.py
flow, SURVEY.md section 2.16).
"""

from __future__ import annotations

import numpy as np

from e3diff_tpu_torch.data.dataset import LigandBindingSiteData
from e3diff_tpu_torch.diffusion.d3pm import D3PMDiffusion
from e3diff_tpu_torch.diffusion.gaussian import GaussianAngleDiffusion
from e3diff_tpu_torch.geometry.chain import write_pdb_folder
from e3diff_tpu_torch.ops.transitions import UniformTransition
from e3diff_tpu_torch.sampling.sequence import sample_sequence_batches
from e3diff_tpu_torch.sampling.structure import sample_structure_batches
from e3diff_tpu_torch.utils.device import resolve_device


def _pad_generated(angles_list, max_len, batches):
    """Pad per-sample (len_i, 8) angle arrays to max_len and chunk them to
    align with the batches, zero-padded final batch included
    (sample_by_generated_angles.py:54-66)."""
    n_feat = angles_list[0].shape[1] if angles_list else 8
    padded = [np.pad(a, ((0, max_len - a.shape[0]), (0, 0)))
              for a in angles_list]
    chunks, pos = [], 0
    for batch in batches:
        rows = batch["ligand_angles"].shape[0]
        valid = int(batch.get("num_valid", rows))
        chunk = padded[pos:pos + valid]
        chunk += [np.zeros((max_len, n_feat), np.float32)] * (rows - valid)
        chunks.append(np.stack(chunk).astype(np.float32))
        pos += valid
    return chunks


def run_pipeline(
    structure_model,
    sequence_model,
    test_data: LigandBindingSiteData,
    *,
    device="cuda",
    seed: int = 0,
    batch_size: int = 64,
    structure_timesteps: int = 1000,
    sequence_timesteps: int = 50,
    step: int = 1,
    pdb_outdir: str | None = None,
    diverse: bool = True,
    sampler: str = "ddpm",
    ddim_steps: int = 50,
    ddim_eta: float = 1.0,
    guidance_scale: float = 1.0,
    sequence_guidance_scale: float = 1.0,
) -> dict:
    """Every batch of ``test_data`` through the structure sampler, one PDB
    per sample (when ``pdb_outdir`` is given), then the sequence D3PM with
    the uniform transition on the generated angles (the reference's
    end-to-end pairing, sample_by_generated_angles.py:253). The two
    samplers draw from generators seeded ``seed`` and ``seed + 1``.
    Returns the inverse-folding results dict plus ``generated_angles`` and
    ``pdb_paths``."""
    device = resolve_device(device)
    diffusion = GaussianAngleDiffusion.cosine(structure_timesteps,
                                              device=device)
    batches = list(test_data.batches(batch_size))
    sampled = sample_structure_batches(
        structure_model, diffusion, batches, device=device, seed=seed,
        step=step, first_batch_only=False, return_trajectory=False,
        sampler=sampler, ddim_steps=ddim_steps, ddim_eta=ddim_eta,
        guidance_scale=guidance_scale)

    pdb_paths = None
    if pdb_outdir is not None:
        pdb_paths = write_pdb_folder(sampled, pdb_outdir)

    d3pm = D3PMDiffusion.create(UniformTransition(20),
                                timesteps=sequence_timesteps, device=device)
    generated = _pad_generated(sampled, test_data.ligand_max_len, batches)
    results = sample_sequence_batches(
        sequence_model, d3pm, batches, device=device, seed=seed + 1,
        diverse=diverse, generated_angles=generated,
        guidance_scale=sequence_guidance_scale)
    results["generated_angles"] = sampled
    results["pdb_paths"] = pdb_paths
    return results
