"""The port's kernel module (e3diff_tpu_torch/ops/kernels.py) against the
JAX package's Pallas kernels in interpret mode, on the CPU.

On the CPU the wrappers run their plain versions; these tests hold those
to the Pallas bodies (f32, atol 2e-5 / rtol 1e-4 as
tests/test_pallas_kernels.py does), check the wrappers' argument checks,
and that a wrapper never falls back to the plain version for a tensor
that is not on the CPU. The CUDA kernels themselves are held against the
plain versions on the card by chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from e3diff_tpu.ops import pallas_kernels as pk
from e3diff_tpu_torch.ops import kernels

B, LQ, LK, H, D = 8, 16, 32, 4, 64
F = H * D
MAX_POS = 32


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions run on one CPU thread in this file. Several test
    processes share the host's cores, and torch's threaded CPU kernels
    may then split a reduction differently from one call to the next; on
    one thread every call sums in one order, so the comparisons below
    hold the plain versions' arithmetic, not the thread pool's."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed=0, b=B, lq=LQ, lk=LK, h=H, max_pos=MAX_POS, ragged=False):
    """Seeded q, k, v, mask and table. The mask drops keys 20.. or, when
    ragged, keeps a random prefix of 1..Lk keys and a single key in batch
    row 0."""
    rng = np.random.default_rng(seed)
    f = h * D
    q = rng.normal(size=(b, lq, f)).astype(np.float32)
    k = rng.normal(size=(b, lk, f)).astype(np.float32)
    v = rng.normal(size=(b, lk, f)).astype(np.float32)
    if ragged:
        lengths = rng.integers(1, lk + 1, size=b)
        lengths[0] = 1
        mask = np.where(np.arange(lk)[None, :] < lengths[:, None], 0.0,
                        -10000.0).astype(np.float32)
    else:
        mask = np.zeros((b, lk), np.float32)
        mask[:, 20:] = -10000.0
    table = rng.normal(size=(2 * max_pos - 1, D)).astype(np.float32)
    return q, k, v, mask, table


def _pe(table, lq, lk, max_pos=MAX_POS):
    idx = np.arange(lq)[:, None] - np.arange(lk)[None, :] + max_pos - 1
    return table[idx]                       # (Lq, Lk, D), as blocks.py builds it


# (b, lq, lk, h, max_pos, ragged): the shape above, then the kernel's
# contract at its edges with ragged masks -- one query and one key,
# lengths off the 16-row tiles, Lq != Lk, and the 128 limit
ATTN_CASES = [pytest.param((B, LQ, LK, H, MAX_POS, False), t, id=str(t))
              for t in (False, True)] + [
    pytest.param((3, lq, lk, 2, 128, True), t, id=f"{lq}x{lk}-{t}")
    for lq, lk in [(1, 1), (5, 13), (17, 64), (128, 128)]
    for t in (False, True)]


@pytest.mark.parametrize("case,with_table", ATTN_CASES)
def test_attention_plain_matches_pallas(case, with_table):
    b, lq, lk, h, max_pos, ragged = case
    seed = lq * 1000 + lk if ragged else 0
    q, k, v, mask, table = _inputs(seed, b, lq, lk, h, max_pos, ragged)
    want = np.asarray(pk.fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        jnp.asarray(_pe(table, lq, lk, max_pos)) if with_table else None,
        num_heads=h, block_b=4, interpret=True))
    before = kernels.fused_attention.launches
    got = kernels.fused_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), torch.from_numpy(table) if with_table else None,
        num_heads=h, max_pos=max_pos)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)
    assert kernels.fused_attention.launches == before  # CPU: plain version


@pytest.mark.parametrize("with_table", [False, True])
def test_attention_all_masked_rows_match_pallas(with_table):
    """A dead batch slot (the engine pads a partial batch with all-zero
    attention masks): every key of a row at -10000, in f32 and at the
    compute-dtype value -9984 that a bf16 mask rounds to. The softmax then
    sees all keys shifted alike and stays finite, as in the Pallas body."""
    q, k, v, mask, table = _inputs(seed=2)
    mask[0] = -10000.0
    mask[1] = -9984.0
    mask[2, 1:] = -10000.0
    want = np.asarray(pk.fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        jnp.asarray(_pe(table, LQ, LK)) if with_table else None,
        num_heads=H, block_b=4, interpret=True))
    got = kernels.fused_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), torch.from_numpy(table) if with_table else None,
        num_heads=H, max_pos=MAX_POS)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


def test_attention_masked_columns_ignored():
    q, k, v, mask, table = _inputs(seed=1)
    args = dict(num_heads=H, max_pos=MAX_POS)
    t = torch.from_numpy
    out1 = kernels.fused_attention(t(q), t(k), t(v), t(mask), t(table), **args)
    k2, v2 = k.copy(), v.copy()
    k2[:, 20:] = 99.0
    v2[:, 20:] = -99.0
    out2 = kernels.fused_attention(t(q), t(k2), t(v2), t(mask), t(table),
                                   **args)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-5)


def _layernorm_plain_vs_pallas(shape, residual, affine, seed):
    rng = np.random.default_rng(seed)
    width = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    res = rng.normal(size=shape).astype(np.float32)
    scale = rng.normal(size=(width,)).astype(np.float32)
    bias = rng.normal(size=(width,)).astype(np.float32)
    eps = 1e-12 if affine else 1e-5
    # the Pallas kernel always applies an affine: identity for affine-free
    p_scale = scale if affine else np.ones(width, np.float32)
    p_bias = bias if affine else np.zeros(width, np.float32)
    want = np.asarray(pk.fused_layernorm(
        jnp.asarray(x), jnp.asarray(p_scale), jnp.asarray(p_bias),
        residual=jnp.asarray(res) if residual else None, eps=eps,
        interpret=True))
    got = kernels.fused_layernorm(
        torch.from_numpy(x),
        torch.from_numpy(scale) if affine else None,
        torch.from_numpy(bias) if affine else None,
        torch.from_numpy(res) if residual else None, eps=eps)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("affine", [False, True])
def test_layernorm_plain_matches_pallas(residual, affine):
    _layernorm_plain_vs_pallas((B, LQ, F), residual, affine, seed=2)


@pytest.mark.parametrize("width", [96, 768])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("affine", [False, True])
def test_layernorm_plain_matches_pallas_at_widths(width, residual, affine):
    """The model width (the kernel's 16-byte path) and a width of the
    second kernel, at 15 rows: not a multiple of the rows a block holds."""
    _layernorm_plain_vs_pallas((3, 5, width), residual, affine, seed=width)


def test_attention_rejects_lengths_beyond_max_pos():
    q, k, v, mask, table = _inputs()
    t = torch.from_numpy
    with pytest.raises(ValueError, match="max_pos"):
        kernels.fused_attention(t(q), t(k), t(v), t(mask), None,
                                num_heads=H, max_pos=LK - 1)
    with pytest.raises(ValueError, match="table"):
        kernels.fused_attention(t(q), t(k), t(v), t(mask), t(table[:-1]),
                                num_heads=H, max_pos=MAX_POS)


def test_attention_names_a_misaligned_input():
    """The bf16 kernel copies 16 bytes at a time: a view that starts off a
    16-byte boundary is refused with a ValueError that says so."""
    flat = torch.zeros(8 + 2 * 4 * F, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels._check_aligned16("fused_attention",
                                 flat[1:-7].view(2, 4, F))
    kernels._check_aligned16("fused_attention", flat[8:].view(2, 4, F))


def test_wrappers_do_not_fall_back_off_the_cpu():
    """A tensor that is not on the CPU gets the kernel or an error, never
    the plain version (meta tensors stand in for a device here)."""
    q = torch.empty(2, 4, F, device="meta")
    mask = torch.empty(2, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kernels.fused_attention(q, q, q, mask, num_heads=H, max_pos=8)
    with pytest.raises(ValueError, match="no kernel"):
        kernels.fused_layernorm(q, eps=1e-5)

