"""Typed transformer configuration (counterpart of
e3diff_tpu/models/config.py, without the XLA layout knobs scan_layers and
self_attention_impl, which do not change the numbers, and without
param_dtype: parameters are f32). ``remat`` is kept: it trades a layer's
saved activations for a second forward in the backward
(models/blocks.py::TransformerStack)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """One transformer stack (the knobs the reference sets on HF
    BertConfig at structure_model/train_model.py:124-148)."""

    hidden_size: int = 768
    num_heads: int = 12
    num_layers: int = 12
    intermediate_size: int = 1024
    max_position_embeddings: int = 128
    # dropout rates, active only in train mode: ``dropout`` on the
    # attention and MLP outputs and the embeddings, ``attention_dropout``
    # on the attention probabilities
    dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    # "relative_key" (HF learned relative scores) or "absolute" (no
    # positional term: the reference has no absolute embeddings at all)
    position_embedding_type: str = "relative_key"
    add_cross_attention: bool = False
    mlp_ratio: float = 4.0  # SELayer MLP width multiplier (not intermediate_size)
    # random weights when a model is built with a seed: "torch_default"
    # (bare torch modules, the structure model) or "xavier_all" (xavier-
    # uniform weights and zero biases, the sequence model's
    # initialize_weights, sequence_model/model.py:183-198)
    init_style: str = "torch_default"
    dtype: torch.dtype = torch.float32  # activation / compute dtype
    # activation checkpointing of each stack layer in a training forward:
    # "none", "layer" (save the layer's inputs, recompute the rest) or
    # "dots" (save the GEMM outputs too); the numbers are unchanged
    remat: str = "none"

    @property
    def head_dim(self) -> int:
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden {self.hidden_size} not divisible by "
                             f"{self.num_heads} heads")
        return self.hidden_size // self.num_heads


def structure_model_configs(
    max_seq_len: int = 128,
    num_layers: int = 12,
    dtype: torch.dtype = torch.float32,
) -> tuple[TransformerConfig, TransformerConfig]:
    """Encoder/decoder configs of the structure (angle) denoiser
    (structure_model/train_model.py:18-39, :124-148)."""
    base = dict(
        hidden_size=768, num_heads=12, num_layers=num_layers,
        intermediate_size=1024, max_position_embeddings=max_seq_len,
        position_embedding_type="relative_key", dtype=dtype,
    )
    return (TransformerConfig(**base, add_cross_attention=False),
            TransformerConfig(**base, add_cross_attention=True))


def sequence_model_configs(
    max_seq_len: int = 128,
    num_layers: int = 6,
    dtype: torch.dtype = torch.float32,
) -> tuple[TransformerConfig, TransformerConfig]:
    """Encoder/decoder configs of the sequence (D3PM) denoiser
    (sequence_model/train_model.py:17-39, :118-142)."""
    base = dict(
        hidden_size=768, num_heads=12, num_layers=num_layers,
        intermediate_size=1024, max_position_embeddings=max_seq_len,
        position_embedding_type="relative_key", init_style="xavier_all",
        dtype=dtype,
    )
    return (TransformerConfig(**base, add_cross_attention=False),
            TransformerConfig(**base, add_cross_attention=True))
