"""Sequence (inverse-folding) denoiser of the discrete D3PM (counterpart of
e3diff_tpu/models/sequence.py; sequence_model/model.py:156-253).

  ligand:   seq FeatureEmbedding(20) + angle FeatureEmbedding(8), the
            Fourier timestep embedding ADDED to the angle (condition)
            embedding -> SELayer(seq, cond=angle+time)
  receptor: built the same way and fused through the SAME SELayer
            instance (quirk Q7: the reference builds a
            receptor_feature_emb it never calls; it is not built here, so
            the parameter count leaves out its ~11M dead values)
  decoder:  6-layer cross-attention stack (ligand queries, receptor
            memory), then ``decoder_normalize``, an SELayer conditioned on
            the timestep, then MLPHead(768 -> 20) logits

The timestep reaches both fuses, so the receptor memory and every layer's
cross-attention K/V change with it and are recomputed at every step: there
is no encode-once path as in the structure model. Quirk Q9: training
conditions on t/T, sampling on the raw integer step; the module embeds
whatever it is handed.
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
    init_xavier_all_,
    kernel_mask,
    shard_init,
)
from e3diff_tpu_torch.models.config import TransformerConfig
from e3diff_tpu_torch.utils.device import resolve_device


class SequenceDenoiser(nn.Module):
    """The 61M sequence denoiser at the default full-size configs.

    ``seed`` draws random weights on ``device`` by the configs'
    ``init_style`` (xavier_all for this model); ``seed=None`` leaves them
    uninitialised, for a state_dict load or for ``device="meta"``.
    ``mesh`` (parallel/mesh.py): the model is this rank's tensor-parallel
    shard, on ``mesh.device``, and ``seed`` draws the one-device model's
    weights and keeps the shard."""

    def __init__(self, encoder_config: TransformerConfig,
                 decoder_config: TransformerConfig, *, n_classes: int = 20,
                 n_angle_features: int = 8, device="cuda",
                 seed: int | None = 0, mesh=None):
        super().__init__()
        device = resolve_device(device if mesh is None else mesh.device)
        enc, dec = encoder_config, decoder_config
        self.encoder_config, self.decoder_config = enc, dec
        self.timestep_projector = GaussianFourierProjection(dec, device)
        self.ligand_seq_embedding = FeatureEmbedding(enc, n_classes, device,
                                                     mesh)
        self.ligand_angle_embedding = FeatureEmbedding(enc, n_angle_features,
                                                       device, mesh)
        # both branches (Q7)
        self.ligand_feature_emb = SELayer(enc, device, mesh)
        self.receptor_seq_embedding = FeatureEmbedding(enc, n_classes, device,
                                                       mesh)
        self.receptor_angle_embedding = FeatureEmbedding(
            enc, n_angle_features, device, mesh)
        self.decoder = TransformerStack(dec, device, mesh)
        self.decoder_normalize = SELayer(dec, device, mesh)
        self.amino_acid_predictor = MLPHead(dec, n_classes, device)
        self.mesh = mesh
        # on a mesh: the rules of the one-device model's state_dict, and
        # its seeded weights cut to this rank's shard
        self.sharding_rules = shard_init(
            self, mesh, lambda dev, seed: SequenceDenoiser(
                enc, dec, n_classes=n_classes,
                n_angle_features=n_angle_features, device=dev, seed=seed),
            None if device.type == "meta" else seed)
        if seed is not None and device.type != "meta" and mesh is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            if enc.init_style == "xavier_all":
                init_xavier_all_(self, gen,
                                 zero_adaln=(self.decoder_normalize,))
            else:
                init_torch_default_(self, gen)
        self.eval()

    def forward(self, timestep, noised_ligand_seq, ligand_angles,
                ligand_mask, receptor_seq, receptor_angles, receptor_mask):
        """Logits (B, L_lig, n_classes) in the compute dtype;
        differentiable (the sampler calls it without autograd).

        timestep: (B,) or (B, 1); noised_ligand_seq: (B, L, 20) one-hot;
        the masks are (B, L) 0/1 (a dead batch slot has all zeros)."""
        enc, dec = self.encoder_config, self.decoder_config
        lig_ext = kernel_mask(ligand_mask, dec)
        rec_ext = kernel_mask(receptor_mask, enc)
        # f32 (W is f32 in every storage mode), so each sum below is f32
        t_emb = self.timestep_projector(timestep)[:, None, :]
        lig = self.ligand_feature_emb(
            self.ligand_seq_embedding(noised_ligand_seq),
            self.ligand_angle_embedding(ligand_angles) + t_emb, lig_ext)
        rec = self.ligand_feature_emb(
            self.receptor_seq_embedding(receptor_seq),
            self.receptor_angle_embedding(receptor_angles) + t_emb, rec_ext)
        dec_out = self.decoder(lig, lig_ext, rec, rec_ext)
        dec_out = self.decoder_normalize(dec_out, t_emb, lig_ext)
        return self.amino_acid_predictor(dec_out)
