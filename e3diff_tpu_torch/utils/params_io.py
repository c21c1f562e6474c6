"""Inference weight storage and checkpoint loading (counterpart of
e3diff_tpu/utils/params_io.py).

Storage modes (PARAMS_DTYPES); training keeps f32 weights in every one:

* ``f32``: as trained;
* ``bf16_matmul``: the >=2-D weights (Linear weights and distance tables)
  stored bf16, the 1-D leaves (biases, LayerNorm affines, the Fourier W)
  f32. With bf16 compute the weights are rounded to bf16 where they are
  used anyway, so this is sample-identical to f32 at half the weight bytes;
* ``bf16``: every floating leaf stored bf16, the 1-D ones too. The JAX
  package measured its cost on the structure model: the rounded biases and
  LayerNorm / adaLN affines bias every reverse step the same way, and the
  sampled-angle distribution's TV distance to the data rose from 0.084 to
  0.399 (its BENCHMARKS.md, "bf16 parameter storage"); on the sequence
  model's 50-step D3PM it stayed harmless. The CLIs default to f32;
* ``int8_matmul``: the >=2-D weights as int8 plus a per-output-channel
  bf16 scale (utils/quant.py), dequantized where each weight is used; the
  1-D leaves f32.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from e3diff_tpu_torch.models.blocks import DistanceEmbedding, Linear
from e3diff_tpu_torch.ops.schedules import DiscreteNoiseSchedule
from e3diff_tpu_torch.utils.quant import quantize_int8

PARAMS_DTYPES = ("f32", "bf16", "bf16_matmul", "int8_matmul")


@torch.no_grad()
def cast_inference_params(model: nn.Module, dtype: str | None) -> nn.Module:
    """Convert the model's weights, in place, to the storage ``dtype`` (one
    of PARAMS_DTYPES; None or "f32" leaves them f32)."""
    if dtype is None or dtype == "f32":
        return model
    if dtype not in PARAMS_DTYPES:
        raise ValueError(f"params dtype {dtype!r}: expected one of "
                         f"{PARAMS_DTYPES}")
    for m in model.modules():
        if not isinstance(m, (Linear, DistanceEmbedding)):
            continue
        if m.weight_scale is not None or m.weight.dtype != torch.float32:
            raise ValueError("weights are already cast")
        if dtype == "int8_matmul":
            stored, m.weight_scale = quantize_int8(m.weight, m.QUANT_AXIS)
        else:
            stored = m.weight.to(torch.bfloat16)
        m.weight = nn.Parameter(stored, requires_grad=False)
    if dtype == "bf16":
        # the 1-D leaves: parameters and the Fourier W buffer
        for m in model.modules():
            for name, p in list(m.named_parameters(recurse=False)):
                if p.dtype == torch.float32:
                    setattr(m, name, nn.Parameter(p.to(torch.bfloat16),
                                                  requires_grad=False))
            for name, b in list(m.named_buffers(recurse=False)):
                if b is not None and b.dtype == torch.float32:
                    setattr(m, name, b.to(torch.bfloat16))
    return model


def load_structure_checkpoint(path: str, model: nn.Module) -> nn.Module:
    """Load a reference-layout ``.pt`` state_dict (the reference's own
    checkpoints, or the JAX package's torch export) into ``model``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(sd, strict=True)
    return model


# keys of a reference PeptideDiff state_dict that the port does not carry:
# the never-called receptor_feature_emb SELayer (quirk Q7) and the D3PM
# schedule's betas buffer, which the port recomputes
DEAD_SEQUENCE_PREFIX = "receptor_feature_emb."
SEQUENCE_BETAS_KEY = "discrete_noise_schedule.betas"


def load_sequence_checkpoint(path: str, model: nn.Module,
                             timesteps: int = 50) -> nn.Module:
    """Load a reference-layout PeptideDiff ``.pt`` state_dict (the
    reference's checkpoints, or the JAX package's export) into a
    SequenceDenoiser. The dead ``receptor_feature_emb.*`` keys and the
    schedule's betas are dropped, the betas only after they are checked
    against the port's own ``timesteps``-step schedule; the rest loads
    with ``strict=True``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if SEQUENCE_BETAS_KEY in sd:
        betas = sd.pop(SEQUENCE_BETAS_KEY).numpy()
        want = DiscreteNoiseSchedule.cosine(timesteps).betas
        if betas.shape != want.shape or not np.array_equal(betas, want):
            raise ValueError(
                f"{path}: {SEQUENCE_BETAS_KEY} is not the {timesteps}-step "
                "cosine schedule")
    sd = {k: v for k, v in sd.items()
          if not k.startswith(DEAD_SEQUENCE_PREFIX)}
    model.load_state_dict(sd, strict=True)
    return model
