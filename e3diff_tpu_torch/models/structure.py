"""Structure (backbone-angle) denoiser (counterpart of
e3diff_tpu/models/structure.py): a conditional BERT encoder-decoder.

  receptor: FeatureEmbedding(angles 8) + FeatureEmbedding(seq 20)
            -> SELayer(angles, cond=seq) -> 12-layer encoder
  ligand:   FeatureEmbedding(angles 8) + GaussianFourier(timestep)
            -> SELayer(angles, cond=time) -> 12-layer decoder with
            cross-attention to the encoder output
  head:     MLPHead(768 -> 8) predicting epsilon

The receptor encoding and the decoder's cross-attention K/V do not depend
on the timestep, so samplers run ``encode_receptor`` and
``precompute_cross_kv`` once per batch and only ``decode`` per step; those
three run without autograd. ``forward`` (the training path) runs the same
bodies with autograd, the decoder projecting the cross-attention K/V
itself, as the JAX model's ``__call__`` does.
"""

from __future__ import annotations

import torch
from torch import nn

from e3diff_tpu_torch.models.blocks import (
    FeatureEmbedding,
    GaussianFourierProjection,
    MLPHead,
    SELayer,
    TransformerStack,
    init_torch_default_,
    kernel_mask,
)
from e3diff_tpu_torch.models.config import TransformerConfig
from e3diff_tpu_torch.utils.device import resolve_device


class StructureDenoiser(nn.Module):
    """The 146M structure denoiser at the default full-size configs.

    ``seed`` draws random weights on ``device`` (reference torch-default
    init); ``seed=None`` leaves them uninitialised, for a state_dict load
    or for ``device="meta"``."""

    def __init__(self, encoder_config: TransformerConfig,
                 decoder_config: TransformerConfig, *, n_features: int = 8,
                 n_aa: int = 20, device="cuda", seed: int | None = 0):
        super().__init__()
        device = resolve_device(device)
        enc, dec = encoder_config, decoder_config
        self.encoder_config, self.decoder_config = enc, dec
        self.receptor_angle_emb = FeatureEmbedding(enc, n_features, device)
        self.receptor_seq_emb = FeatureEmbedding(enc, n_aa, device)
        self.receptor_emb = SELayer(enc, device)
        self.encoder = TransformerStack(enc, device)
        self.ligand_angle_emb = FeatureEmbedding(dec, n_features, device)
        self.timestep_projector = GaussianFourierProjection(dec, device)
        self.timestep_emb = SELayer(dec, device)
        self.decoder = TransformerStack(dec, device)
        self.angles_predictor = MLPHead(dec, n_features, device)
        if seed is not None and device.type != "meta":
            gen = torch.Generator(device=device).manual_seed(seed)
            init_torch_default_(self, gen)
        self.eval()

    @torch.no_grad()
    def encode_receptor(self, receptor_seq, receptor_angles, receptor_mask):
        """Timestep-independent pocket encoding -> (B, L, H) memory."""
        return self._encode(receptor_seq, receptor_angles, receptor_mask)

    def _encode(self, receptor_seq, receptor_angles, receptor_mask):
        rec_ext = kernel_mask(receptor_mask, self.encoder_config)
        rec_angles = self.receptor_angle_emb(receptor_angles)
        rec_seq = self.receptor_seq_emb(receptor_seq)
        rec = self.receptor_emb(rec_angles, rec_seq, rec_ext)
        return self.encoder(rec, rec_ext)

    @torch.no_grad()
    def precompute_cross_kv(self, encoder_out):
        """Every decoder layer's cross-attention (K, V), flat (B, Lk, H*D)."""
        return self.decoder.precompute_cross_kv(encoder_out)

    @torch.no_grad()
    def decode(self, timestep, noised_ligand_angles, ligand_mask,
               encoder_out, receptor_mask, cross_kv=None):
        """Predict epsilon for the ligand angles against a pocket encoding;
        ``cross_kv`` (from ``precompute_cross_kv``) replaces the K/V
        projections of ``encoder_out``."""
        return self._decode(timestep, noised_ligand_angles, ligand_mask,
                            encoder_out, receptor_mask, cross_kv)

    def _decode(self, timestep, noised_ligand_angles, ligand_mask,
                encoder_out, receptor_mask, cross_kv=None):
        dec = self.decoder_config
        lig_ext = kernel_mask(ligand_mask, dec)
        rec_ext = kernel_mask(receptor_mask, dec)
        lig = self.ligand_angle_emb(noised_ligand_angles)
        t_emb = self.timestep_projector(timestep)[:, None, :]
        lig = self.timestep_emb(lig, t_emb, lig_ext)
        dec_out = self.decoder(lig, lig_ext,
                               None if cross_kv is not None else encoder_out,
                               rec_ext, cross_kv)
        return self.angles_predictor(dec_out)

    def forward(self, timestep, noised_ligand_angles, ligand_mask,
                receptor_seq, receptor_angles, receptor_mask):
        """Epsilon for the noised ligand angles, (B, L, 8) in the compute
        dtype; differentiable."""
        enc_out = self._encode(receptor_seq, receptor_angles, receptor_mask)
        return self._decode(timestep, noised_ligand_angles, ligand_mask,
                            enc_out, receptor_mask)


def state_dict_numel(model: nn.Module) -> int:
    """Number of values in the state_dict (parameters plus the Fourier W
    buffer): the count the JAX package's parameter tree holds."""
    return sum(v.numel() for v in model.state_dict().values())
