"""Wrapped-angle arithmetic and the radian losses (counterpart of
e3diff_tpu/ops/angles.py; structure_model/utils.py:20-109).

The losses take an optional ``mask``: the reference's boolean-index-then-
mean becomes a masked mean over positions where the mask is true, with the
denominator held at 1 or more.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def wrap_angle(vals, range_min: float = -math.pi, range_max: float = math.pi):
    """Modulo with wrapped range, e.g. wrap to [-pi, pi).

    Matches modulo_with_wrapped_range (structure_model/utils.py:20-40);
    torch's ``%`` is the floored remainder, as jnp's is."""
    if not (range_min <= 0.0 and range_min < range_max):
        raise ValueError(f"bad range [{range_min}, {range_max})")
    top_end = range_max - range_min
    return (vals - range_min) % top_end + range_min


def masked_mean(vals, mask=None):
    """mean(vals) or, with ``mask``, sum(vals * mask) / max(sum(mask), 1)."""
    if mask is None:
        return vals.mean()
    mask = mask.to(vals.dtype)
    return (vals * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def radian_l1_loss(input, target, mask=None):
    """Mean absolute wrapped angular difference (radian_l1_loss,
    structure_model/utils.py:61-76)."""
    d = target % (2 * math.pi) - input % (2 * math.pi)
    d = (d + math.pi) % (2 * math.pi) - math.pi
    return masked_mean(d.abs(), mask)


def radian_smooth_l1_loss(input, target, beta: float = 1.0,
                          circle_penalty: float = 0.0, mask=None):
    """Huber loss on the wrapped angular difference
    (radian_smooth_l1_loss, structure_model/utils.py:78-109), with the
    circle_penalty regulariser on whole turns, penalty *
    mean(trunc(|input| / pi)), which the reference's training config never
    enables. With ``mask`` both terms average over the masked positions."""
    if beta <= 0:
        raise ValueError(f"beta must be positive, got {beta}")
    d = wrap_angle(target - input)
    abs_d = d.abs()
    per_elem = torch.where(abs_d < beta, 0.5 * d ** 2 / beta,
                           abs_d - 0.5 * beta)
    loss = masked_mean(per_elem, mask)
    if circle_penalty > 0:
        turns = torch.trunc(input.abs() / math.pi)
        loss = loss + circle_penalty * masked_mean(turns, mask)
    return loss


def tolerant_comparison_check(values, cmp: str, v) -> bool:
    """Whether every value is >= (or <=) ``v`` up to an absolute 1e-5, NaNs
    ignored (tolerant_comparison_check, structure_model/utils.py:111-131;
    a host-side check on numpy arrays or tensors)."""
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    values = np.asarray(values)
    if cmp == ">=":
        diff = np.nanmin(values) - v
        return bool(np.isclose(diff, 0, atol=1e-5) or diff > 0)
    if cmp == "<=":
        diff = np.nanmax(values) - v
        return bool(np.isclose(diff, 0, atol=1e-5) or diff < 0)
    raise ValueError(f"Illegal comparator: {cmp}")
