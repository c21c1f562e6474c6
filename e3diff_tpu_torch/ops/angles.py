"""Wrapped-angle arithmetic (counterpart of e3diff_tpu/ops/angles.py;
the training losses come with the training slice)."""

from __future__ import annotations

import math


def wrap_angle(vals, range_min: float = -math.pi, range_max: float = math.pi):
    """Modulo with wrapped range, e.g. wrap to [-pi, pi).

    Matches modulo_with_wrapped_range (structure_model/utils.py:20-40);
    torch's ``%`` is the floored remainder, as jnp's is."""
    if not (range_min <= 0.0 and range_min < range_max):
        raise ValueError(f"bad range [{range_min}, {range_max})")
    top_end = range_max - range_min
    return (vals - range_min) % top_end + range_min
