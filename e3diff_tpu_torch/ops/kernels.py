"""The denoiser's two hand-written CUDA kernels, their plain versions and
their launch counters.

* ``fused_attention`` (``csrc/attention.cu``) replaces the Pallas kernel
  ``e3diff_tpu/ops/pallas_kernels.py::fused_attention``: the multi-head
  attention core in the flat (B, L, H*D) layout, with the HF relative_key
  bias gathered from the per-layer distance table inside the kernel.
* ``fused_layernorm`` (``csrc/layernorm.cu``) replaces
  ``e3diff_tpu/ops/pallas_kernels.py::fused_layernorm``: residual add +
  LayerNorm with f32 statistics and an optional affine.

Both are bound by bytes on the H100, not by flops; each source file says
what its design does about that. A wrapper given CUDA tensors launches its
kernel (and adds one to its ``launches`` count) or raises; given CPU
tensors it runs the plain PyTorch version beside it, which follows the
Pallas body step by step and is the kernel's oracle on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from e3diff_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIM = 64
KERNEL_MAX_LEN = 128


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input {tuple(t.shape)}")


def _check_aligned16(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: input {tuple(t.shape)} is not 16-byte "
                             "aligned; the bf16 kernel copies 16 bytes at a "
                             "time")


def _raise_on_error(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {code}")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention_plain(q, k, v, mask_add, rel_table=None, *, num_heads: int,
                    max_pos: int):
    """Plain PyTorch version of ``fused_attention``: per head, f32 scores
    (+ the relative bias), (scores + bias) / sqrt(D) + mask, f32 softmax,
    P rounded to v's type, P V; output in q's type."""
    b, lq, f = q.shape
    lk = k.shape[1]
    d = f // num_heads
    q4 = q.reshape(b, lq, num_heads, d).float()
    k4 = k.reshape(b, lk, num_heads, d).float()
    v4 = v.reshape(b, lk, num_heads, d).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q4, k4)
    if rel_table is not None:
        idx = (torch.arange(lq, device=q.device)[:, None]
               - torch.arange(lk, device=q.device)[None, :] + max_pos - 1)
        pe = rel_table.float()[idx]                       # (Lq, Lk, D)
        s = s + torch.einsum("bqhd,qkd->bhqk", q4, pe)
    s = s * (1.0 / math.sqrt(d)) + mask_add.float()[:, None, None, :]
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(dim=-1, keepdim=True)
    p = p.to(v.dtype).float()
    o = torch.einsum("bhqk,bkhd->bqhd", p, v4)
    return o.reshape(b, lq, f).to(q.dtype)


def fused_attention(q, k, v, mask_add, rel_table=None, *, num_heads: int,
                    max_pos: int):
    """Multi-head attention core in the flat head layout.

    q: (B, Lq, H*D); k, v: (B, Lk, H*D); mask_add: (B, Lk) additive
    (0 keep, -10000 drop), float32; rel_table: optional (2*max_pos-1, D)
    HF relative_key distance table in q's dtype, row l - r + max_pos - 1
    biasing query l against key r (shared by all heads). Returns
    (B, Lq, H*D) in q.dtype. On the card, bf16 q, k, v and the table must
    start at 16-byte aligned addresses (any fresh tensor does; a view at
    an odd offset raises).
    """
    b, lq, f = q.shape
    lk = k.shape[1]
    if k.shape != (b, lk, f) or v.shape != (b, lk, f):
        raise ValueError(f"fused_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if mask_add.shape != (b, lk):
        raise ValueError(f"fused_attention: mask {tuple(mask_add.shape)} "
                         f"!= {(b, lk)}")
    if f % num_heads:
        raise ValueError(f"fused_attention: {f} not divisible by "
                         f"{num_heads} heads")
    if lq > max_pos or lk > max_pos:
        raise ValueError(f"fused_attention: Lq={lq}, Lk={lk} exceed "
                         f"max_pos={max_pos}")
    if rel_table is not None and rel_table.shape != (2 * max_pos - 1,
                                                     f // num_heads):
        raise ValueError(f"fused_attention: table {tuple(rel_table.shape)}")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask_add, rel_table,
                               num_heads=num_heads, max_pos=max_pos)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: no kernel for {q.device}")
    if f // num_heads != KERNEL_HEAD_DIM:
        raise ValueError(f"fused_attention: head dim {f // num_heads}, "
                         f"the kernel takes {KERNEL_HEAD_DIM}")
    if lk > KERNEL_MAX_LEN or lq > KERNEL_MAX_LEN:
        raise ValueError(f"fused_attention: length above {KERNEL_MAX_LEN}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"fused_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if mask_add.dtype != torch.float32:
        raise ValueError("fused_attention: mask must be float32")
    if rel_table is not None and rel_table.dtype != q.dtype:
        raise ValueError(f"fused_attention: table {rel_table.dtype} != "
                         f"{q.dtype}")
    tensors = [q, k, v, mask_add] + ([rel_table] if rel_table is not None
                                     else [])
    _check_cuda("fused_attention", *tensors)
    if q.dtype == torch.bfloat16:
        _check_aligned16("fused_attention", q, k, v,
                         *([rel_table] if rel_table is not None else []))
    out = torch.empty_like(q)
    lib = _build.load_library()
    code = lib.e3d_attention(_ptr(q), _ptr(k), _ptr(v), _ptr(mask_add),
                             _ptr(rel_table), _ptr(out), b, lq, lk, num_heads,
                             max_pos, _DTYPE_CODE[q.dtype], _stream())
    _raise_on_error("fused_attention", code)
    fused_attention.launches += 1
    return out


fused_attention.launches = 0


# ---------------------------------------------------------------------------
# layernorm
# ---------------------------------------------------------------------------

def layernorm_plain(x, weight=None, bias=None, residual=None, *, eps: float):
    """Plain PyTorch version of ``fused_layernorm``: residual added in f32,
    f32 mean and biased variance, optional affine, output in x's type."""
    y = x.float()
    if residual is not None:
        y = y + residual.float()
    mean = y.mean(dim=-1, keepdim=True)
    var = ((y - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (y - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def fused_layernorm(x, weight=None, bias=None, residual=None, *,
                    eps: float):
    """LN(x [+ residual]) [* weight] [+ bias] over the last dim; leading
    dims are rows. weight, bias: (F,) or None (affine-free norm)."""
    f = x.shape[-1]
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"fused_layernorm: residual {tuple(residual.shape)}"
                         f" != x {tuple(x.shape)}")
    for name, p in (("weight", weight), ("bias", bias)):
        if p is not None and p.shape != (f,):
            raise ValueError(f"fused_layernorm: {name} {tuple(p.shape)}")
    if x.device.type == "cpu":
        return layernorm_plain(x, weight, bias, residual, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layernorm: no kernel for {x.device}")
    if f % 32 or f > 1024:
        raise ValueError(f"fused_layernorm: F={f}, the kernel takes "
                         "multiples of 32 up to 1024")
    if x.dtype not in _DTYPE_CODE or (residual is not None
                                      and residual.dtype != x.dtype):
        raise ValueError(f"fused_layernorm: dtype {x.dtype}")
    weight = None if weight is None else weight.float()
    bias = None if bias is None else bias.float()
    _check_cuda("fused_layernorm",
                *[t for t in (x, residual, weight, bias) if t is not None])
    out = torch.empty_like(x)
    lib = _build.load_library()
    code = lib.e3d_layernorm(_ptr(x), _ptr(residual), _ptr(weight),
                             _ptr(bias), _ptr(out), x.numel() // f, f,
                             float(eps), _DTYPE_CODE[x.dtype], _stream())
    _raise_on_error("fused_layernorm", code)
    fused_layernorm.launches += 1
    return out


fused_layernorm.launches = 0

KERNELS = (fused_attention, fused_layernorm)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
