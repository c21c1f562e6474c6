"""The denoisers' hand-written CUDA kernels, their plain versions, their
launch counters and the autograd functions that train through them.

* ``fused_attention`` (``csrc/attention.cu``) replaces the Pallas kernel
  ``e3diff_tpu/ops/pallas_kernels.py::fused_attention``: the multi-head
  attention core in the flat (B, L, H*D) layout, with the HF relative_key
  bias gathered from the per-layer distance table inside the kernel.
* ``fused_layernorm`` (``csrc/layernorm.cu``) replaces
  ``e3diff_tpu/ops/pallas_kernels.py::fused_layernorm``: residual add +
  LayerNorm with f32 statistics and an optional affine.
* ``fused_attention_train`` (``csrc/attention.cu``, the kernels' training
  variant): the same core, with the attention-probability dropout of
  ``e3diff_tpu/models/blocks.py:162`` drawn inside the kernel from a seed
  (Philox4x32-10, ``csrc/philox.cuh``; ``dropout_keep_plain`` is the same
  function in torch integer ops), and each query row's log-sum-exp written
  for the backward, which redraws the same bits.
* ``attention_backward`` (``csrc/attention_backward.cu``) and
  ``layernorm_backward`` (``csrc/layernorm_backward.cu``): the gradients
  that XLA's autodiff computes for the JAX package's einsum attention and
  ``nn.LayerNorm`` (the Pallas kernels are forward-only).

A wrapper given CUDA tensors launches its kernel (and adds one to its
``launches`` count) or raises; given CPU tensors it runs the plain PyTorch
version beside it, which follows the Pallas body, or the gradient's
formulas, step by step and is the kernel's oracle on the card.

The models call ``attention`` and ``layernorm``: without a gradient to
compute they take the inference kernels; when an input needs a gradient
(or attention dropout is on) they go through ``attention_autograd`` /
``layernorm_autograd``, whose CUDA path is ``FusedAttentionFn`` /
``FusedLayerNormFn`` and whose CPU path is the plain version, which
autograd differentiates.

Attention dropout is keyed by a seed: a 2-element int64 tensor on q's
device that ``attention`` draws from the caller's generator per call. The
kernels read it through its pointer (the host never waits for it), and
``FusedAttentionFn`` saves its 16 bytes for the backward where a keep mask
of (B, H, Lq, Lk) bytes was saved before. The plain versions take the keep
mask itself (``keep``); on the CPU the wrappers build it from the seed with
``dropout_keep_plain``, so one seed drops the same probabilities on the
CPU and on the card.
"""

from __future__ import annotations

import ctypes
import functools
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

def _rel_index(lq: int, lk: int, max_pos: int, device):
    """(Lq, Lk) table row of each (query, key) pair: l - r + max_pos - 1."""
    return (torch.arange(lq, device=device)[:, None]
            - torch.arange(lk, device=device)[None, :] + max_pos - 1)


def _heads(t, num_heads: int):
    """(B, L, H*D) -> (B, L, H, D) in f32."""
    b, n, f = t.shape
    return t.reshape(b, n, num_heads, f // num_heads).float()


def _attention_logits(q, k, mask_add, rel_table, num_heads: int,
                      max_pos: int):
    """f32 (B, H, Lq, Lk) logits: (q k^T [+ q . table]) / sqrt(D) + mask."""
    lq, lk = q.shape[1], k.shape[1]
    q4, k4 = _heads(q, num_heads), _heads(k, num_heads)
    s = torch.einsum("bqhd,bkhd->bhqk", q4, k4)
    if rel_table is not None:
        pe = rel_table.float()[_rel_index(lq, lk, max_pos, q.device)]
        s = s + torch.einsum("bqhd,qkd->bhqk", q4, pe)      # (Lq, Lk, D) pe
    return (s * (1.0 / math.sqrt(q4.shape[-1]))
            + mask_add.float()[:, None, None, :])


def _softmax_pv(x, v, num_heads: int, keep=None, dropout_p: float = 0.0):
    """f32 softmax of the logits x, dropped by ``keep`` (P keep / (1 - p)),
    rounded to v's type, times V: the (B, Lq, H*D) output in f32, and the
    rows' log-sum-exp (B, H, Lq)."""
    m = x.amax(dim=-1, keepdim=True)
    p = torch.exp(x - m)
    total = p.sum(dim=-1, keepdim=True)
    p = p / total
    if keep is not None:
        p = p * keep.to(p.dtype) * drop_scale(dropout_p)
    p = p.to(v.dtype).float()
    o = torch.einsum("bhqk,bkhd->bqhd", p, _heads(v, num_heads))
    b, lq = o.shape[:2]
    return o.reshape(b, lq, -1), (m + torch.log(total)).squeeze(-1)


def drop_scale(dropout_p: float) -> float:
    """1 / (1 - p) as the kernels take it, an f32 number."""
    return float(torch.tensor(1.0 / (1.0 - dropout_p), dtype=torch.float32))


# ---------------------------------------------------------------------------
# dropout bits: Philox4x32-10 (csrc/philox.cuh has the mapping)
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def dropout_threshold(dropout_p: float) -> int:
    """The kernels' integer threshold: an element is kept iff its 16-bit
    Philox draw is >= round(p 2^16) (at most 2^16 - 1), which keeps it
    with a probability within 2^-17 of 1 - p."""
    return min(round(dropout_p * 2.0 ** 16), 0xFFFF)


def _mulhilo32(a, m: int):
    """(high, low) 32-bit halves of a * m for u32 values a (an int64
    tensor) and m: through 16-bit limbs, since the int64 product of two
    u32 values overflows."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    p0 = a_lo * m_lo
    mid = a_hi * m_lo + a_lo * m_hi + (p0 >> 16)
    return a_hi * m_hi + (mid >> 16), ((mid & 0xFFFF) << 16) | (p0 & 0xFFFF)


def philox4x32_10(counter, key):
    """Philox4x32-10 of four u32 counter words and two u32 key words, each
    an int64 tensor (broadcast together) or int; returns the four u32 output
    words as int64 tensors."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo32(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo32(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
    return c0, c1, c2, c3


def dropout_keep_plain(seed, shape, dropout_p: float):
    """The keep mask (bool, ``shape`` = (B, H, Lq, Lk)) that the training
    kernels draw for ``seed`` (2 int64; their low 32 bits are the Philox
    key): element n of the flattened shape is kept iff the 16-bit half
    n mod 2 (0: low) of word (n mod 8) // 2 of Philox4x32-10 at counter
    (n // 8 mod 2^32, n // 2^35, 0, 0) is >= ``dropout_threshold``.
    Torch integer ops on seed's device."""
    numel = math.prod(shape)
    c = torch.arange((numel + 7) // 8, dtype=torch.int64, device=seed.device)
    zero = torch.zeros_like(c)
    key = seed.to(torch.int64) & _U32
    words = torch.stack(philox4x32_10((c & _U32, c >> 32, zero, zero),
                                      (key[0], key[1])), dim=-1)
    halves = torch.stack((words & 0xFFFF, words >> 16), dim=-1)
    keep = halves.reshape(-1)[:numel] >= dropout_threshold(dropout_p)
    return keep.reshape(shape)


def attention_plain(q, k, v, mask_add, rel_table=None, *, num_heads: int,
                    max_pos: int):
    """Plain PyTorch version of ``fused_attention``: per head, f32 scores
    (+ the relative bias), (scores + bias) / sqrt(D) + mask, f32 softmax,
    P rounded to v's type, P V; output in q's type."""
    x = _attention_logits(q, k, mask_add, rel_table, num_heads, max_pos)
    return _softmax_pv(x, v, num_heads)[0].to(q.dtype)


def attention_train_plain(q, k, v, mask_add, rel_table=None, keep=None,
                          dropout_p: float = 0.0, *, num_heads: int,
                          max_pos: int):
    """Plain PyTorch version of ``fused_attention_train``: as
    ``attention_plain``, the f32 softmax multiplied by keep / (1 - p)
    before it is rounded to v's type (keep None: no dropout). Returns the
    output in q's type and the rows' f32 log-sum-exp (B, H, Lq)."""
    x = _attention_logits(q, k, mask_add, rel_table, num_heads, max_pos)
    out, lse = _softmax_pv(x, v, num_heads, keep, dropout_p)
    return out.to(q.dtype), lse


def attention_autograd_plain(q, k, v, mask_add, rel_table, keep,
                             dropout_p: float, *, num_heads: int,
                             max_pos: int):
    """``attention_train_plain``'s output alone: what autograd
    differentiates on the CPU (and under ``chip_smoke.py``'s
    ``plain_versions``)."""
    return attention_train_plain(q, k, v, mask_add, rel_table, keep,
                                 dropout_p, num_heads=num_heads,
                                 max_pos=max_pos)[0]


def attention_backward_plain(dout, q, k, v, lse, mask_add, rel_table=None,
                             keep=None, dropout_p: float = 0.0, *,
                             num_heads: int, max_pos: int):
    """Plain PyTorch version of ``attention_backward``, the formulas step
    by step (scale = 1/sqrt(D), f = keep / (1 - p) or 1):
    P = exp(x - lse); dV = (P f rounded to v's type)^T dO;
    dP = (dO V^T) f; delta = rowsum(P dP); dS = P (dP - delta) scale;
    dQ = dS K + the table term; dK = dS^T Q;
    dtable[l - r + max_pos - 1] += dS q. delta equals rowsum(dO O) for the
    exact output O = (P f) V; summed from P and dP it does not carry the
    rounding of a bf16 O, as autograd's softmax gradient does not.
    dS is rounded to q's type before the dQ, dK and table products (a
    no-op in f32): the bf16 kernel's ``mma`` operands are bf16, and JAX's
    bf16 autodiff of the einsum attention rounds dS too.
    Returns dq, dk, dv in q's type and the f32 table gradient (None
    without a table)."""
    lq, lk = q.shape[1], k.shape[1]
    q4, k4, v4 = (_heads(t, num_heads) for t in (q, k, v))
    g4 = _heads(dout, num_heads)
    scale = 1.0 / math.sqrt(q4.shape[-1])
    x = _attention_logits(q, k, mask_add, rel_table, num_heads, max_pos)
    p = torch.exp(x - lse[..., None])
    f = (keep.to(p.dtype) * drop_scale(dropout_p) if keep is not None
         else None)
    pd = (p if f is None else p * f).to(v.dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", pd, g4)
    dp = torch.einsum("bqhd,bkhd->bhqk", g4, v4)
    if f is not None:
        dp = dp * f
    delta = (p * dp).sum(-1, keepdim=True)                 # (B, H, Lq, 1)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k4)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q4)
    dtable = None
    if rel_table is not None:
        idx = _rel_index(lq, lk, max_pos, q.device)
        pe = rel_table.float()[idx]
        dq = dq + torch.einsum("bhqk,qkd->bqhd", ds, pe)
        dpe = torch.einsum("bhqk,bqhd->qkd", ds, q4)
        dtable = torch.zeros(rel_table.shape, dtype=torch.float32,
                             device=q.device).index_add_(
            0, idx.reshape(-1), dpe.reshape(-1, dpe.shape[-1]))
    b, f_ = q.shape[0], q.shape[2]
    return (dq.reshape(b, lq, f_).to(q.dtype), dk.reshape(b, lk, f_).to(q.dtype),
            dv.reshape(b, lk, f_).to(q.dtype), dtable)


def _check_attention(name, q, k, v, mask_add, rel_table, num_heads,
                     max_pos):
    """Shapes on every device; on the card also the kernels' contract.
    Returns True for a CPU call (the plain version), False for the card."""
    b, lq, f = q.shape
    lk = k.shape[1]
    if k.shape != (b, lk, f) or v.shape != (b, lk, f):
        raise ValueError(f"{name}: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if mask_add.shape != (b, lk):
        raise ValueError(f"{name}: mask {tuple(mask_add.shape)} != {(b, lk)}")
    if f % num_heads:
        raise ValueError(f"{name}: {f} not divisible by {num_heads} heads")
    if lq > max_pos or lk > max_pos:
        raise ValueError(f"{name}: Lq={lq}, Lk={lk} exceed max_pos={max_pos}")
    if rel_table is not None and rel_table.shape != (2 * max_pos - 1,
                                                     f // num_heads):
        raise ValueError(f"{name}: table {tuple(rel_table.shape)}")
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {q.device}")
    if f // num_heads != KERNEL_HEAD_DIM:
        raise ValueError(f"{name}: head dim {f // num_heads}, the kernel "
                         f"takes {KERNEL_HEAD_DIM}")
    if lk > KERNEL_MAX_LEN or lq > KERNEL_MAX_LEN:
        raise ValueError(f"{name}: length above {KERNEL_MAX_LEN}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if mask_add.dtype != torch.float32:
        raise ValueError(f"{name}: mask must be float32")
    if rel_table is not None and rel_table.dtype != q.dtype:
        raise ValueError(f"{name}: table {rel_table.dtype} != {q.dtype}")
    _check_cuda(name, q, k, v, mask_add,
                *([rel_table] if rel_table is not None else []))
    return False


def _check_seed(name, seed, q, dropout_p):
    """A dropout seed: None, or 2 int64 on q's device with 0 <= p < 1."""
    if seed is None:
        return
    if (tuple(seed.shape) != (2,) or seed.dtype != torch.int64
            or not seed.is_contiguous()):
        raise ValueError(f"{name}: seed {tuple(seed.shape)} {seed.dtype}, "
                         "expected a contiguous (2,) int64 tensor")
    if seed.device != q.device:
        raise ValueError(f"{name}: seed on {seed.device}, q on {q.device}")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"{name}: dropout_p {dropout_p} not in [0, 1)")


def _keep_from_seed(seed, q, k, num_heads: int, dropout_p: float):
    """The plain versions' keep mask for a seed (None without one)."""
    if seed is None:
        return None
    return dropout_keep_plain(seed, (q.shape[0], num_heads, q.shape[1],
                                     k.shape[1]), dropout_p)


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
    if _check_attention("fused_attention", q, k, v, mask_add, rel_table,
                        num_heads, max_pos):
        return attention_plain(q, k, v, mask_add, rel_table,
                               num_heads=num_heads, max_pos=max_pos)
    b, lq, _ = q.shape
    lk = k.shape[1]
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


def fused_attention_train(q, k, v, mask_add, rel_table=None, seed=None,
                          dropout_p: float = 0.0, *, num_heads: int,
                          max_pos: int):
    """The training forward of the attention core: ``fused_attention``'s
    output with the probabilities dropped where
    ``dropout_keep_plain(seed, (B, H, Lq, Lk), dropout_p)`` is False and
    scaled by 1 / (1 - dropout_p) where it is True (seed None: no
    dropout), and each query row's f32 log-sum-exp (B, H, Lq) for the
    backward. The kernel draws the bits itself from the seed's device
    memory."""
    b, lq, _ = q.shape
    lk = k.shape[1]
    _check_seed("fused_attention_train", seed, q, dropout_p)
    if _check_attention("fused_attention_train", q, k, v, mask_add,
                        rel_table, num_heads, max_pos):
        return attention_train_plain(
            q, k, v, mask_add, rel_table,
            _keep_from_seed(seed, q, k, num_heads, dropout_p), dropout_p,
            num_heads=num_heads, max_pos=max_pos)
    if q.dtype == torch.bfloat16:
        _check_aligned16("fused_attention_train", q, k, v,
                         *([rel_table] if rel_table is not None else []))
    out = torch.empty_like(q)
    lse = torch.empty((b, num_heads, lq), dtype=torch.float32,
                      device=q.device)
    lib = _build.load_library()
    code = lib.e3d_attention_train(
        _ptr(q), _ptr(k), _ptr(v), _ptr(mask_add), _ptr(rel_table),
        _ptr(seed), _ptr(out), _ptr(lse), b, lq, lk, num_heads, max_pos,
        dropout_threshold(dropout_p), drop_scale(dropout_p),
        _DTYPE_CODE[q.dtype], _stream())
    _raise_on_error("fused_attention_train", code)
    fused_attention_train.launches += 1
    return out, lse


fused_attention_train.launches = 0


def attention_backward(dout, q, k, v, lse, mask_add, rel_table=None,
                       seed=None, dropout_p: float = 0.0, *, num_heads: int,
                       max_pos: int):
    """Gradients of ``fused_attention_train`` with respect to q, k, v (in
    q's type) and the distance table (f32, None without a table), given
    the output's gradient ``dout``, the forward's row log-sum-exp and its
    dropout seed (the kernel redraws the same keep bits). On the card the
    table gradient is summed over (b, h) with atomics: its last bits
    change from run to run."""
    b, lq, _ = q.shape
    lk = k.shape[1]
    name = "attention_backward"
    _check_seed(name, seed, q, dropout_p)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"{name}: dout {tuple(dout.shape)} {dout.dtype} "
                         f"against q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, num_heads, lq):
        raise ValueError(f"{name}: lse {tuple(lse.shape)}")
    if _check_attention(name, q, k, v, mask_add, rel_table, num_heads,
                        max_pos):
        return attention_backward_plain(
            dout, q, k, v, lse, mask_add, rel_table,
            _keep_from_seed(seed, q, k, num_heads, dropout_p), dropout_p,
            num_heads=num_heads, max_pos=max_pos)
    if lse.dtype != torch.float32:
        raise ValueError(f"{name}: lse must be float32")
    _check_cuda(name, q, dout, lse)
    if q.dtype == torch.bfloat16:
        _check_aligned16(name, q, k, v, dout,
                         *([rel_table] if rel_table is not None else []))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dtable = (None if rel_table is None else
              torch.zeros(rel_table.shape, dtype=torch.float32,
                          device=q.device))
    delta = torch.empty((b, num_heads, lq), dtype=torch.float32,
                        device=q.device)
    lib = _build.load_library()
    code = lib.e3d_attention_backward(
        _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(mask_add),
        _ptr(rel_table), _ptr(seed), _ptr(lse), _ptr(delta), _ptr(dq),
        _ptr(dk), _ptr(dv), _ptr(dtable), b, lq, lk, num_heads, max_pos,
        dropout_threshold(dropout_p), drop_scale(dropout_p),
        _DTYPE_CODE[q.dtype], _stream())
    _raise_on_error(name, code)
    attention_backward.launches += 1
    return dq, dk, dv, dtable


attention_backward.launches = 0


class FusedAttentionFn(torch.autograd.Function):
    """The attention core on the card, differentiable: the forward is
    ``fused_attention_train``, the backward ``attention_backward``; the
    dropout seed (16 bytes) is saved, not a keep mask."""

    @staticmethod
    def forward(ctx, q, k, v, mask_add, rel_table, seed, dropout_p,
                num_heads, max_pos):
        out, lse = fused_attention_train(q, k, v, mask_add, rel_table, seed,
                                         dropout_p, num_heads=num_heads,
                                         max_pos=max_pos)
        ctx.save_for_backward(q, k, v, lse, mask_add, rel_table, seed)
        ctx.dropout_p, ctx.num_heads, ctx.max_pos = (dropout_p, num_heads,
                                                      max_pos)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse, mask_add, rel_table, seed = ctx.saved_tensors
        dq, dk, dv, dtable = attention_backward(
            dout.contiguous(), q, k, v, lse, mask_add, rel_table, seed,
            ctx.dropout_p, num_heads=ctx.num_heads, max_pos=ctx.max_pos)
        if dtable is not None:
            dtable = dtable.to(rel_table.dtype)
        return dq, dk, dv, None, dtable, None, None, None, None


def attention_autograd(q, k, v, mask_add, rel_table, seed, dropout_p: float,
                       *, num_heads: int, max_pos: int):
    """The differentiable attention core: ``FusedAttentionFn`` on the card,
    the plain version (through autograd, given the seed's keep mask) on
    the CPU."""
    if q.device.type == "cpu":
        return attention_autograd_plain(
            q, k, v, mask_add, rel_table,
            _keep_from_seed(seed, q, k, num_heads, dropout_p), dropout_p,
            num_heads=num_heads, max_pos=max_pos)
    return FusedAttentionFn.apply(q, k, v, mask_add, rel_table, seed,
                                  dropout_p, num_heads, max_pos)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def attention(q, k, v, mask_add, rel_table=None, *, num_heads: int,
              max_pos: int, dropout_p: float = 0.0,
              generator: torch.Generator | None = None):
    """The models' attention core. With dropout_p > 0 a dropout seed is
    drawn here, 2 int64 in [0, 2^32) from ``generator`` on q's device
    (the kernels draw the keep bits from it, keeping a probability with
    probability 1 - p as flax's Dropout does); with dropout or an input
    that needs a gradient the core goes through ``attention_autograd``,
    else through the inference kernel."""
    if dropout_p > 0.0 or _needs_grad(q, k, v, rel_table):
        seed = None
        if dropout_p > 0.0:
            seed = torch.randint(0, 2 ** 32, (2,), dtype=torch.int64,
                                 generator=generator, device=q.device)
        return attention_autograd(q, k, v, mask_add, rel_table, seed,
                                  dropout_p, num_heads=num_heads,
                                  max_pos=max_pos)
    return fused_attention(q, k, v, mask_add, rel_table, num_heads=num_heads,
                           max_pos=max_pos)


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


def layernorm_backward_plain(dy, x, weight=None, bias=None, residual=None, *,
                             eps: float):
    """Plain PyTorch version of ``layernorm_backward``: v = x [+ residual]
    in f32, x_hat = (v - mean) rstd, g = dy [* weight];
    dx = rstd (g - mean(g) - x_hat mean(g x_hat)) in x's type (also the
    residual's gradient); dw = sum_rows dy x_hat, db = sum_rows dy in f32
    (None without weight / bias)."""
    f = x.shape[-1]
    v = x.float().reshape(-1, f)
    if residual is not None:
        v = v + residual.float().reshape(-1, f)
    mean = v.mean(dim=-1, keepdim=True)
    var = ((v - mean) ** 2).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (v - mean) * rstd
    d = dy.float().reshape(-1, f)
    g = d * weight.float() if weight is not None else d
    dx = rstd * (g - g.mean(dim=-1, keepdim=True)
                 - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    dw = (d * xhat).sum(0) if weight is not None else None
    db = d.sum(0) if bias is not None else None
    return dx.reshape(x.shape).to(x.dtype), dw, db


# csrc/layernorm_backward.cu's first kernel runs 8 rows at a time per block,
# with as many blocks as the card holds at once (one partial row of dw and
# db each): resident blocks per SM (the occupancy API) times the SMs
_LN_BWD_ROWS_PER_BLOCK = 8


@functools.cache
def _ln_bwd_blocks(device, f: int, dtype) -> int:
    per_sm = ctypes.c_int(0)
    code = _build.load_library().e3d_layernorm_backward_occupancy(
        f, _DTYPE_CODE[dtype], ctypes.byref(per_sm))
    _raise_on_error("layernorm_backward", code)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(per_sm.value, 1) * sms


def layernorm_backward(dy, x, weight=None, bias=None, residual=None, *,
                       eps: float):
    """Gradients of ``fused_layernorm``: dx in x's type (the residual's
    gradient is the same tensor) and the f32 weight and bias gradients
    (None for an affine-free norm)."""
    f = x.shape[-1]
    name = "layernorm_backward"
    if dy.shape != x.shape or (residual is not None
                               and residual.shape != x.shape):
        raise ValueError(f"{name}: dy {tuple(dy.shape)}, x {tuple(x.shape)}")
    if bias is not None and weight is None:
        raise ValueError(f"{name}: a bias without a weight")
    for pname, p in (("weight", weight), ("bias", bias)):
        if p is not None and p.shape != (f,):
            raise ValueError(f"{name}: {pname} {tuple(p.shape)}")
    if x.device.type == "cpu":
        return layernorm_backward_plain(dy, x, weight, bias, residual, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    if f % 32 or f > 1024:
        raise ValueError(f"{name}: F={f}, the kernel takes multiples of 32 "
                         "up to 1024")
    if x.dtype not in _DTYPE_CODE or dy.dtype != x.dtype or (
            residual is not None and residual.dtype != x.dtype):
        raise ValueError(f"{name}: dtypes {x.dtype}, {dy.dtype}")
    weight = None if weight is None else weight.float()
    _check_cuda(name, *[t for t in (dy, x, residual, weight)
                        if t is not None])
    rows = x.numel() // f
    nparts = min(-(-rows // _LN_BWD_ROWS_PER_BLOCK),
                 _ln_bwd_blocks(x.device, f, x.dtype))
    dx = torch.empty_like(x)

    def f32(n):
        return torch.empty(n, dtype=torch.float32, device=x.device)

    dw = db = dw_part = db_part = None
    if weight is not None:
        dw, dw_part = f32(f), f32((nparts, f))
    if bias is not None:
        db, db_part = f32(f), f32((nparts, f))
    lib = _build.load_library()
    code = lib.e3d_layernorm_backward(
        _ptr(x), _ptr(residual), _ptr(weight), _ptr(dy), _ptr(dx),
        _ptr(dw_part), _ptr(db_part), _ptr(dw), _ptr(db), rows, f,
        float(eps), nparts, _DTYPE_CODE[x.dtype], _stream())
    _raise_on_error(name, code)
    layernorm_backward.launches += 1
    return dx, dw, db


layernorm_backward.launches = 0


class FusedLayerNormFn(torch.autograd.Function):
    """Residual + LayerNorm on the card, differentiable: the forward is
    ``fused_layernorm``, the backward ``layernorm_backward``."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, eps):
        ctx.save_for_backward(x, weight, bias, residual)
        ctx.eps = eps
        return fused_layernorm(x, weight, bias, residual, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, residual = ctx.saved_tensors
        dx, dw, db = layernorm_backward(dy.contiguous(), x, weight, bias,
                                        residual, eps=ctx.eps)
        return dx, dw, db, (dx if residual is not None else None), None


def layernorm_autograd(x, weight=None, bias=None, residual=None, *,
                       eps: float):
    """The differentiable LayerNorm: ``FusedLayerNormFn`` on the card, the
    plain version (through autograd) on the CPU."""
    if x.device.type == "cpu":
        return layernorm_plain(x, weight, bias, residual, eps=eps)
    return FusedLayerNormFn.apply(x, weight, bias, residual, eps)


def layernorm(x, weight=None, bias=None, residual=None, *, eps: float):
    """The models' LayerNorm: ``layernorm_autograd`` when an input needs a
    gradient, else the inference kernel."""
    if _needs_grad(x, weight, bias, residual):
        return layernorm_autograd(x, weight, bias, residual, eps=eps)
    return fused_layernorm(x, weight, bias, residual, eps=eps)


KERNELS = (fused_attention, fused_layernorm, fused_attention_train,
           attention_backward, layernorm_backward)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
