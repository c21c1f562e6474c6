"""Inference weight storage and checkpoint loading (counterpart of
e3diff_tpu/utils/params_io.py).

Storage modes of the >=2-D weights (Linear weights and distance tables);
1-D leaves (biases, LayerNorm affines, the Fourier W) stay f32 in all of
them:

* ``f32``: as trained;
* ``bf16_matmul``: stored bf16;
* ``int8_matmul``: int8 plus a per-output-channel bf16 scale
  (utils/quant.py), dequantized where each weight is used.
"""

from __future__ import annotations

import torch
from torch import nn

from e3diff_tpu_torch.models.blocks import DistanceEmbedding, Linear
from e3diff_tpu_torch.utils.quant import quantize_int8

PARAMS_DTYPES = ("f32", "bf16_matmul", "int8_matmul")


@torch.no_grad()
def cast_inference_params(model: nn.Module, dtype: str | None) -> nn.Module:
    """Convert the model's >=2-D weights, in place, to the storage
    ``dtype`` (one of PARAMS_DTYPES; None or "f32" leaves them f32)."""
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
        if dtype == "bf16_matmul":
            stored = m.weight.to(torch.bfloat16)
        else:
            stored, m.weight_scale = quantize_int8(m.weight, m.QUANT_AXIS)
        m.weight = nn.Parameter(stored, requires_grad=False)
    return model


def load_structure_checkpoint(path: str, model: nn.Module) -> nn.Module:
    """Load a reference-layout ``.pt`` state_dict (the reference's own
    checkpoints, or the JAX package's torch export) into ``model``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(sd, strict=True)
    return model
