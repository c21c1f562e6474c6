"""The attention-dropout bits of the training step, in torch integer ops:
Philox4x32-10 keyed by a 2-int64 seed, as the program documents its
training attention to draw them (a frozen copy of the arithmetic of
e3diff_tpu_torch/ops/kernels.py::philox4x32_10 and dropout_keep_plain,
one device, no blocks).

Element n of the flattened (B, H, Lq, Lk) probabilities is kept iff the
16-bit half n mod 2 (0: low) of word (n mod 8) // 2 of Philox4x32-10 at
counter (n // 8 mod 2^32, n // 2^35, 0, 0), key = the seed's low 32 bits,
is >= round(p 2^16).
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF
_M = (0xD2511F53, 0xCD9E8D57)
_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo32(a, m: int):
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    p0 = a_lo * m_lo
    mid = a_hi * m_lo + a_lo * m_hi + (p0 >> 16)
    return a_hi * m_hi + (mid >> 16), ((mid & 0xFFFF) << 16) | (p0 & 0xFFFF)


def philox4x32_10(counter, key):
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo32(c0, _M[0])
        hi1, lo1 = _mulhilo32(c2, _M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W[0]) & _U32, (k1 + _W[1]) & _U32
    return c0, c1, c2, c3


def threshold(p: float) -> int:
    return min(round(p * 2.0 ** 16), 0xFFFF)


def attention_keep(seed: torch.Tensor, shape, p: float) -> torch.Tensor:
    """Bool keep mask of ``shape`` = (B, H, Lq, Lk) for ``seed``."""
    total = 1
    for s in shape:
        total *= int(s)
    if total % 8:
        raise ValueError("the bits come in groups of 8 elements")
    key = seed.to(torch.int64) & _U32
    keep = torch.empty(total, dtype=torch.bool, device=seed.device)
    chunk = 1 << 22     # counters per pass, to bound the int64 temporaries
    for start in range(0, total // 8, chunk):
        c = torch.arange(start, min(start + chunk, total // 8),
                         dtype=torch.int64, device=seed.device)
        zero = torch.zeros_like(c)
        words = torch.stack(philox4x32_10((c & _U32, c >> 32, zero, zero),
                                          (key[0], key[1])), dim=-1)
        halves = torch.stack((words & 0xFFFF, words >> 16), dim=-1)
        keep[8 * start:8 * start + 8 * len(c)] = (
            halves.reshape(-1) >= threshold(p))
    return keep.reshape(shape)
