"""Sampling configurations and their checkpoint sidecars (the port's copy
of the parts of e3diff_tpu/utils/{presets,builders}.py that sampling and
serving read).

A ``config.json`` sidecar written next to a checkpoint by the JAX package
reads here unchanged: the fields the port has are taken from it, the
training fields it also holds are left out.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from e3diff_tpu_torch.models.config import TransformerConfig


@dataclasses.dataclass
class ExperimentConfig:
    # data
    pocket_ext: int = 4
    max_seq_len: int = 128
    ligand_max_len: int | None = None   # None = max_seq_len
    # diffusion
    timesteps: int = 1000
    # model
    num_heads: int = 12
    hidden_size: int = 768
    num_hidden_layers: int = 12
    intermediate_size: int = 1024
    position_embedding_type: str = "relative_key"
    bf16: bool = True   # compute dtype: bf16, or f32


def structure_sample_config(**overrides) -> ExperimentConfig:
    """structure_model/sample.py:20-41 (ext 0, max_len 64)."""
    cfg = ExperimentConfig(pocket_ext=0, max_seq_len=64, timesteps=1000,
                           num_hidden_layers=12)
    return dataclasses.replace(cfg, **overrides)


# fields the structure and the sequence checkpoint of one engine must
# share: the data shapes and the widths (their timesteps and depths differ)
SHARED_FIELDS = (
    "pocket_ext", "max_seq_len", "ligand_max_len", "num_heads",
    "hidden_size", "intermediate_size", "position_embedding_type",
)


def load_ckpt_config(ckpt_path: str) -> dict | None:
    """The ``config.json`` sidecar in the checkpoint's directory (or in
    ``ckpt_path`` itself when it is a directory), or None."""
    ckpt_path = os.path.abspath(ckpt_path)
    for d in (ckpt_path, os.path.dirname(ckpt_path)):
        path = os.path.join(d, "config.json")
        if os.path.isfile(path):
            with open(path) as f:
                return json.load(f)
    return None


def config_from_sidecar(base: ExperimentConfig, side: dict | None
                        ) -> ExperimentConfig:
    """``base`` with every field the sidecar names replaced by its value."""
    names = {f.name for f in dataclasses.fields(ExperimentConfig)}
    return dataclasses.replace(base, **{k: v for k, v in (side or {}).items()
                                        if k in names})


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
        init_style=init_style,
        dtype=torch.bfloat16 if cfg.bf16 else torch.float32,
    )
    return (TransformerConfig(**base, add_cross_attention=False),
            TransformerConfig(**base, add_cross_attention=True))
