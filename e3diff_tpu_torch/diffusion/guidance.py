"""Classifier-free guidance (counterpart of e3diff_tpu/diffusion/guidance.py).

The null conditioning is a zeroed pocket behind a one-token attention mask.
The guided sampler runs both branches as one forward over a 2B batch
(conditional half first) and combines pred = uncond + w (cond - uncond).
"""

from __future__ import annotations

import torch


def null_receptor(receptor_seq, receptor_angles, receptor_mask):
    """The canonical unconditional pocket: zero features, one valid key."""
    nmask = torch.zeros_like(receptor_mask)
    nmask[:, 0] = 1
    return torch.zeros_like(receptor_seq), torch.zeros_like(receptor_angles), nmask


def guided_combine(pred_2b, guidance_scale):
    """Split a 2B prediction (conditional half first) and combine.

    ``guidance_scale``: a scalar or a per-example (B,) vector, as a number
    or a tensor. As in the JAX package, w is float32 and the difference is
    taken in the prediction's dtype before it is scaled."""
    cond, uncond = pred_2b.chunk(2, dim=0)
    w = torch.as_tensor(guidance_scale, dtype=torch.float32,
                        device=pred_2b.device)
    if w.ndim:
        w = w.reshape((-1,) + (1,) * (cond.ndim - 1))
    # float() first: a 0-d f32 tensor would not promote a bf16 operand
    return uncond.float() + w * (cond - uncond).float()
