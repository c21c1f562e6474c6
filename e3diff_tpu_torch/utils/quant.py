"""Int8 weight-only storage (counterpart of e3diff_tpu/utils/quant.py).

Per-output-channel symmetric quantization: the scale is amax over the
contraction axis / 127, q = round(w / scale) clipped to [-127, 127] and
stored int8, the scale stored bf16. Weights are dequantized as q * scale
(in bf16) where they are used, inside every decode step, so the resident
weights stay int8.

The JAX package takes amax over flax axis -2 of every >=2-D leaf. For a
Linear's (in, out) kernel that is the input axis, which in torch's
(out, in) weight layout is axis -1. The relative-position tables
(2*max_pos-1, D) are 2-D leaves too and are quantized as well; their layout
is the same in both packages, so their axis stays -2.
"""

from __future__ import annotations

import torch


def quantize_int8(w: torch.Tensor, axis: int,
                  scale_dtype: torch.dtype = torch.bfloat16):
    """-> (int8 values, scale) with the scale kept along ``axis``."""
    w32 = w.float()
    amax = w32.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale.to(scale_dtype)


def dequantize(weight: torch.Tensor, scale: torch.Tensor | None):
    """The stored weight in its compute form: q * scale in the scale's
    dtype for int8 storage, the weight itself otherwise."""
    if scale is None:
        return weight
    return weight.to(scale.dtype) * scale
