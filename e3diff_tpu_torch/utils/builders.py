"""Glue: ExperimentConfig -> models, diffusions, datasets (counterpart of
e3diff_tpu/utils/builders.py). Every builder that makes tensors takes the
device explicitly."""

from __future__ import annotations

import torch

from e3diff_tpu_torch.data.dataset import LigandBindingSiteData, load_complexes
from e3diff_tpu_torch.diffusion import D3PMDiffusion, GaussianAngleDiffusion
from e3diff_tpu_torch.models import SequenceDenoiser, StructureDenoiser
from e3diff_tpu_torch.models.config import TransformerConfig
from e3diff_tpu_torch.ops.transitions import BlosumTransition, UniformTransition
from e3diff_tpu_torch.utils.presets import ExperimentConfig


def transformer_configs(cfg: ExperimentConfig, init_style: str
                        ) -> tuple[TransformerConfig, TransformerConfig]:
    """Encoder and decoder configs of a model built from ``cfg``
    (torch_default for the structure model, xavier_all for the
    sequence model)."""
    base = dict(
        hidden_size=cfg.hidden_size, num_heads=cfg.num_heads,
        num_layers=cfg.num_hidden_layers,
        intermediate_size=cfg.intermediate_size,
        max_position_embeddings=cfg.max_seq_len,
        position_embedding_type=cfg.position_embedding_type,
        dropout=cfg.dropout_p, attention_dropout=cfg.dropout_p,
        init_style=init_style,
        dtype=torch.bfloat16 if cfg.bf16 else torch.float32,
        remat=cfg.remat,
    )
    return (TransformerConfig(**base, add_cross_attention=False),
            TransformerConfig(**base, add_cross_attention=True))


def build_structure_model(cfg: ExperimentConfig, *, device,
                          seed: int | None = None,
                          mesh=None) -> StructureDenoiser:
    """The structure denoiser on ``device``: random weights drawn from
    ``seed``, or uninitialised ones (None) for a checkpoint to fill; on
    ``mesh``, the rank's tensor-parallel shard on its device."""
    return StructureDenoiser(*transformer_configs(cfg, "torch_default"),
                             device=device, seed=seed, mesh=mesh)


def build_sequence_model(cfg: ExperimentConfig, *, device,
                         seed: int | None = None,
                         mesh=None) -> SequenceDenoiser:
    """The sequence denoiser on ``device``, as ``build_structure_model``."""
    return SequenceDenoiser(*transformer_configs(cfg, "xavier_all"),
                            device=device, seed=seed, mesh=mesh)


def build_structure_diffusion(cfg: ExperimentConfig, *, device
                              ) -> GaussianAngleDiffusion:
    return GaussianAngleDiffusion.cosine(cfg.timesteps, device=device)


def build_sequence_diffusion(cfg: ExperimentConfig,
                             transition: str = "blosum", *, device
                             ) -> D3PMDiffusion:
    """The D3PM over ``cfg.timesteps`` with the BLOSUM (training and
    native-angle sampling) or the uniform (generated angles) transition."""
    trans = (BlosumTransition(device=device) if transition == "blosum"
             else UniformTransition(20))
    return D3PMDiffusion.create(trans, timesteps=cfg.timesteps, device=device)


def build_dataset(cfg: ExperimentConfig, data_file: str,
                  split: str | None) -> LigandBindingSiteData:
    return LigandBindingSiteData(
        load_complexes(data_file), split,
        max_len=cfg.max_seq_len, pocket_ext=cfg.pocket_ext,
        ligand_max_len=cfg.ligand_max_len)
