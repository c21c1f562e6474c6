"""The port's kernel module (e3diff_tpu_torch/ops/kernels.py) against the
JAX package's Pallas kernels in interpret mode, on the CPU.

On the CPU the wrappers run their plain versions; these tests hold those
to the Pallas bodies (f32, atol 2e-5 / rtol 1e-4 as
tests/test_pallas_kernels.py does), check the wrappers' argument checks,
and that a wrapper never falls back to the plain version for a tensor
that is not on the CPU. The CUDA kernels themselves are held against the
plain versions on the card by chip_smoke.py. The training kernels' plain
versions (the training forward, both backwards) are held to jax.vjp of
the JAX package's training path below.
"""

import flax.linen as jnn
import jax
import jax.numpy as jnp
import numpy as np
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


# ---------------------------------------------------------------------------
# training: the training forward and both backwards against jax.vjp of the
# JAX package's training path (its einsum attention, blocks.py:154-165, and
# flax nn.LayerNorm), in f32: atol 2e-5 / rtol 1e-4 for outputs, 1e-4 /
# 1e-4 for gradients (sums over up to 32 keys, 8 batch rows and 4 heads
# taken in another order)
# ---------------------------------------------------------------------------


def _jax_attention(q, k, v, mask, table, keep, rate, h, max_pos):
    """blocks.py:154-165 on flat inputs: einsum scores + relative bias,
    / sqrt(D), + mask, softmax, flax's dropout given the keep mask."""
    b, lq, f = q.shape
    lk = k.shape[1]
    d = f // h
    q4, k4, v4 = (x.reshape(b, -1, h, d) for x in (q, k, v))
    scores = jnp.einsum("bqhd,bkhd->bhqk", q4, k4)
    if table is not None:
        idx = np.arange(lq)[:, None] - np.arange(lk)[None, :] + max_pos - 1
        scores = scores + jnp.einsum("blhd,lrd->bhlr", q4, table[idx])
    scores = scores / np.sqrt(d) + mask[:, None, None, :]
    probs = jax.nn.softmax(scores, axis=-1)
    if keep is not None:
        probs = jnp.where(keep, probs / (1.0 - rate), 0.0)
    return jnp.einsum("bhqk,bkhd->bqhd", probs, v4).reshape(b, lq, f)


@pytest.mark.parametrize("with_table", [False, True])
@pytest.mark.parametrize("rate,seeded", [(0.0, False), (0.25, False),
                                         (0.1, True)],
                         ids=["0.0", "0.25", "seed-0.1"])
def test_attention_training_plain_matches_jax_vjp(with_table, rate, seeded):
    """attention_train_plain (given JAX's keep mask) and
    attention_backward_plain against jax.vjp of the einsum attention:
    the output, and the gradients of q, k, v and the distance table. In
    the seeded case the wrappers take a dropout seed and JAX the mask
    that dropout_keep_plain draws from it."""
    q, k, v, mask, table = _inputs(seed=3, ragged=True)
    rng = np.random.default_rng(4)
    keep = rng.random((B, H, LQ, LK)) >= rate if rate else None
    seed = None
    if seeded:
        seed = torch.tensor([0x9E3779B9, 12345], dtype=torch.int64)
        keep = kernels.dropout_keep_plain(seed, (B, H, LQ, LK), rate).numpy()
    dout = rng.normal(size=q.shape).astype(np.float32)
    tab = table if with_table else None

    def f(q_, k_, v_, t_):
        return _jax_attention(q_, k_, v_, jnp.asarray(mask), t_,
                              None if keep is None else jnp.asarray(keep),
                              rate, H, MAX_POS)

    want, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)),
                        None if tab is None else jnp.asarray(tab))
    grads = vjp(jnp.asarray(dout))
    t = torch.from_numpy
    kw = dict(num_heads=H, max_pos=MAX_POS)
    tkeep = None if keep is None else t(keep)
    args = (t(q), t(k), t(v), t(mask), None if tab is None else t(tab))
    if seeded:
        before = kernels.fused_attention_train.launches
        out, lse = kernels.fused_attention_train(*args, seed, rate, **kw)
        assert kernels.fused_attention_train.launches == before  # CPU: plain
        got = kernels.attention_backward(t(dout), *args[:3], lse, *args[3:],
                                         seed, rate, **kw)
    else:
        out, lse = kernels.attention_train_plain(*args, tkeep, rate, **kw)
        got = kernels.attention_backward_plain(t(dout), *args[:3], lse,
                                               *args[3:], tkeep, rate, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)
    assert (got[3] is None) == (tab is None)
    for g, w in zip(got, grads):
        if w is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                       rtol=1e-4)


@pytest.mark.parametrize("with_table", [False, True])
def test_attention_backward_plain_matches_the_jax_module(with_table):
    """attention_backward_plain against jax.vjp of the JAX package's own
    MultiHeadAttention (blocks.py:107-165) at dropout 0, its projections
    made the identity: the query Dense takes q, and the key and value
    Denses pick k and v out of the memory [k | v]."""
    from e3diff_tpu.models.blocks import MultiHeadAttention
    from e3diff_tpu.models.config import TransformerConfig

    q, k, v, mask, table = _inputs(seed=7, ragged=True)
    dout = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)
    eye, zero = np.eye(F, dtype=np.float32), np.zeros((F, F), np.float32)
    params = {"query": {"kernel": eye, "bias": np.zeros(F, np.float32)},
              "key": {"kernel": np.concatenate([eye, zero]),
                      "bias": np.zeros(F, np.float32)},
              "value": {"kernel": np.concatenate([zero, eye]),
                        "bias": np.zeros(F, np.float32)}}
    cfg = TransformerConfig(hidden_size=F, num_heads=H, num_layers=1,
                            intermediate_size=F,
                            max_position_embeddings=MAX_POS,
                            attention_dropout=0.0)
    mha = MultiHeadAttention(cfg, relative=with_table)

    def f(x, kv, tab):
        p = dict(params)
        if with_table:
            p["distance_embedding"] = {"embedding": tab}
        return mha.apply({"params": p}, x, kv,
                         jnp.asarray(mask)[:, None, None, :])

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(np.concatenate([k, v], -1)),
                     jnp.asarray(table))
    dq, dkv, dtab = vjp(jnp.asarray(dout))
    t = torch.from_numpy
    tab = t(table) if with_table else None
    kw = dict(num_heads=H, max_pos=MAX_POS)
    _, lse = kernels.attention_train_plain(t(q), t(k), t(v), t(mask), tab, **kw)
    got = kernels.attention_backward_plain(t(dout), t(q), t(k), t(v), lse,
                                           t(mask), tab, **kw)
    want = (dq, dkv[..., :F], dkv[..., F:], dtab if with_table else None)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                       rtol=1e-4)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("affine", [False, True])
def test_layernorm_backward_plain_matches_jax_vjp(residual, affine):
    """layernorm_backward_plain against jax.vjp of flax nn.LayerNorm on
    x (+ residual): dx (= d residual), d scale, d bias."""
    rng = np.random.default_rng(5)
    x, res, dy = (rng.normal(size=(3, 5, 96)).astype(np.float32)
                  for _ in range(3))
    scale = (1 + 0.1 * rng.normal(size=96)).astype(np.float32)
    bias = (0.1 * rng.normal(size=96)).astype(np.float32)
    eps = 1e-12 if affine else 1e-5
    ln = jnn.LayerNorm(epsilon=eps, use_scale=affine, use_bias=affine)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)}} if affine else {}

    def f(x_, r_, variables_):
        return ln.apply(variables_, x_ + r_ if residual else x_)

    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(res), variables)
    dx_j, dres_j, dvars = vjp(jnp.asarray(dy))
    t = torch.from_numpy
    dx, dw, db = kernels.layernorm_backward(
        t(dy), t(x), t(scale) if affine else None,
        t(bias) if affine else None, t(res) if residual else None, eps=eps)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), atol=1e-4,
                               rtol=1e-4)
    if residual:
        np.testing.assert_allclose(dx.numpy(), np.asarray(dres_j), atol=1e-4,
                                   rtol=1e-4)
    assert (dw is None) == (db is None) == (not affine)
    if affine:
        np.testing.assert_allclose(dw.numpy(), np.asarray(
            dvars["params"]["scale"]), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(db.numpy(), np.asarray(
            dvars["params"]["bias"]), atol=1e-4, rtol=1e-4)


def test_autograd_paths_match_backward_plain_versions():
    """On the CPU the models' differentiable paths are the plain versions
    under autograd; their gradients equal the backward plain versions,
    which the CUDA backward kernels are held to on the card."""
    q, k, v, mask, table = _inputs(seed=6)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, table)]
    kw = dict(num_heads=H, max_pos=MAX_POS)
    out = kernels.attention(leaves[0], leaves[1], leaves[2],
                            torch.from_numpy(mask), leaves[3], **kw)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    out.backward(dout)
    want_out, lse = kernels.attention_train_plain(
        *(x.detach() for x in leaves[:3]), torch.from_numpy(mask),
        leaves[3].detach(), **kw)
    torch.testing.assert_close(out.detach(), want_out, atol=0, rtol=0)
    want = kernels.attention_backward_plain(
        dout, *(x.detach() for x in leaves[:3]), lse,
        torch.from_numpy(mask), leaves[3].detach(), **kw)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, atol=1e-5, rtol=1e-4)
    # dropout draws its seed inside attention(); the keep mask of the same
    # draw given to the plain version reproduces the output
    gen = torch.Generator().manual_seed(2)
    dropped = kernels.attention(*(x.detach() for x in leaves[:3]),
                                torch.from_numpy(mask), leaves[3].detach(),
                                dropout_p=0.1, generator=gen, **kw)
    seed = torch.randint(0, 2 ** 32, (2,), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(2))
    redraw = kernels.dropout_keep_plain(seed, (B, H, LQ, LK), 0.1)
    torch.testing.assert_close(dropped, kernels.attention_train_plain(
        *(x.detach() for x in leaves[:3]), torch.from_numpy(mask),
        leaves[3].detach(), redraw, 0.1, **kw)[0], atol=0, rtol=0)


def test_training_wrappers_do_not_fall_back_off_the_cpu():
    q = torch.empty(2, 4, F, device="meta")
    mask = torch.empty(2, 4, device="meta")
    lse = torch.empty(2, H, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kernels.fused_attention_train(q, q, q, mask, num_heads=H, max_pos=8)
    with pytest.raises(ValueError, match="no kernel"):
        kernels.attention_backward(q, q, q, q, lse, mask, num_heads=H,
                                   max_pos=8)
    with pytest.raises(ValueError, match="no kernel"):
        kernels.layernorm_backward(q, q, eps=1e-5)


# ---------------------------------------------------------------------------
# the bf16 backward: the plain version rounds dS to bf16 before the dQ, dK
# and table products, as the tensor-core kernel does (its mma operands are
# bf16) and as JAX's bf16 autodiff of the einsum attention does
# ---------------------------------------------------------------------------


def _bf16_inputs(seed, rate):
    """bf16 q, k, v, dO and table from seeded f32 draws, the f32 mask and
    a seeded keep mask (None at rate 0)."""
    q, k, v, mask, table = _inputs(seed=seed, ragged=True)
    rng = np.random.default_rng(seed + 1)
    dout = rng.normal(size=q.shape).astype(np.float32)
    keep = rng.random((B, H, LQ, LK)) >= rate if rate else None
    bf = [torch.from_numpy(x).bfloat16() for x in (q, k, v, dout, table)]
    return bf, torch.from_numpy(mask), (None if keep is None
                                        else torch.from_numpy(keep))


def _backward_f64(dout, q, k, v, lse, mask, table, keep, rate):
    """The backward's formulas in float64 from the same bf16 values, P f
    and dS rounded to bf16 where the plain version rounds them."""
    d = lambda t: t.double()                      # noqa: E731
    q4, k4, v4, g4 = (d(t).reshape(B, -1, H, D) for t in (q, k, v, dout))
    idx = torch.from_numpy(np.arange(LQ)[:, None] - np.arange(LK)[None, :]
                           + MAX_POS - 1)
    s = torch.einsum("bqhd,bkhd->bhqk", q4, k4)
    if table is not None:
        s = s + torch.einsum("bqhd,qkd->bhqk", q4, d(table)[idx])
    x = s / np.sqrt(D) + d(mask)[:, None, None, :]
    p = torch.exp(x - d(lse)[..., None])
    f = (torch.ones_like(p) if keep is None
         else d(keep) * kernels.drop_scale(rate))
    pd = (p * f).bfloat16().double()
    dp = torch.einsum("bqhd,bkhd->bhqk", g4, v4) * f
    delta = (p * dp).sum(-1, keepdim=True)
    ds = (p * (dp - delta) / np.sqrt(D)).bfloat16().double()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k4)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q4)
    dv = torch.einsum("bhqk,bqhd->bkhd", pd, g4)
    dtable = None
    if table is not None:
        dq = dq + torch.einsum("bhqk,qkd->bqhd", ds, d(table)[idx])
        dpe = torch.einsum("bhqk,bqhd->qkd", ds, q4)
        dtable = torch.zeros(table.shape, dtype=torch.float64).index_add_(
            0, idx.reshape(-1), dpe.reshape(-1, D))
    return (dq.reshape(B, LQ, F), dk.reshape(B, LK, F), dv.reshape(B, LK, F),
            dtable)


@pytest.mark.parametrize("with_table", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_attention_backward_plain_bf16_matches_float64_formula(with_table,
                                                               rate):
    """In bf16 the plain backward is the formulas with dS rounded to bf16:
    dQ, dK and dV (bf16) within their own rounding, 2^-8 of each value,
    plus 1e-3 of the largest (a dS or P f value next to a rounding
    boundary may round the other way after f32 sums); the f32 table
    gradient within 1e-4 of its largest value. Without the rounding of
    dS the table gradient would lie ~1e-3 away."""
    (q, k, v, dout, table), mask, keep = _bf16_inputs(11, rate)
    tab = table if with_table else None
    kw = dict(num_heads=H, max_pos=MAX_POS)
    _, lse = kernels.attention_train_plain(q, k, v, mask, tab, keep, rate,
                                           **kw)
    got = kernels.attention_backward_plain(dout, q, k, v, lse, mask, tab,
                                           keep, rate, **kw)
    want = _backward_f64(dout, q, k, v, lse, mask, tab, keep, rate)
    assert (got[3] is None) == (tab is None)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.bfloat16
        err = (g.double() - w).abs()
        assert (err <= 2.0 ** -8 * w.abs() + 1e-3 * w.abs().max()).all()
    if with_table:
        err = (got[3].double() - want[3]).abs().max()
        assert err <= 1e-4 * want[3].abs().max()


@pytest.mark.parametrize("with_table", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_attention_backward_plain_bf16_near_jax_vjp(with_table, rate):
    """The bf16 plain backward against jax.vjp's f32 gradients of the
    einsum attention on the same bf16-rounded inputs: within 1e-2
    relative L2 (bf16 rounding of P f, dS and the outputs, each a 2^-9
    relative step)."""
    (q, k, v, dout, table), mask, keep = _bf16_inputs(13, rate)
    tab = table if with_table else None
    f32 = lambda t: None if t is None else t.float().numpy()  # noqa: E731

    def f(q_, k_, v_, t_):
        return _jax_attention(q_, k_, v_, jnp.asarray(mask.numpy()), t_,
                              None if keep is None else jnp.asarray(
                                  keep.numpy()), rate, H, MAX_POS)

    _, vjp = jax.vjp(f, *(jnp.asarray(f32(x)) for x in (q, k, v)),
                     None if tab is None else jnp.asarray(f32(tab)))
    want = vjp(jnp.asarray(f32(dout)))
    kw = dict(num_heads=H, max_pos=MAX_POS)
    _, lse = kernels.attention_train_plain(q, k, v, mask, tab, keep, rate,
                                           **kw)
    got = kernels.attention_backward_plain(dout, q, k, v, lse, mask, tab,
                                           keep, rate, **kw)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            w = np.asarray(w, np.float64)
            dist = np.linalg.norm(g.double().numpy() - w) / np.linalg.norm(w)
            assert dist <= 1e-2


# ---------------------------------------------------------------------------
# dropout from a seed: Philox4x32-10 (csrc/philox.cuh), the one mapping of
# the training kernels and of dropout_keep_plain; the card's bits are held
# to dropout_keep_plain bit for bit by chip_smoke.py
# ---------------------------------------------------------------------------

_M0, _M1, _W0, _W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _philox_py(counter, key):
    """Philox4x32-10 in Python integers (Salmon et al., SC 2011)."""
    c, (k0, k1) = list(counter), key
    for _ in range(10):
        p0, p1 = _M0 * c[0], _M1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & _U32, (p0 >> 32) ^ c[3] ^ k1,
             p0 & _U32]
        k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
    return c


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((_U32,) * 4, (_U32, _U32),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
], ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    """The published known answers of Philox4x32-10, through the port's
    torch version and the Python one below."""
    t = lambda x: torch.tensor([x], dtype=torch.int64)  # noqa: E731
    got = kernels.philox4x32_10(tuple(map(t, counter)), tuple(map(t, key)))
    assert tuple(int(w) for w in got) == want
    assert tuple(_philox_py(counter, key)) == want


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (2, 3, 17, 5)])
@pytest.mark.parametrize("rate", [0.1, 0.25])
def test_dropout_keep_plain_matches_python_philox(shape, rate):
    """Element n keeps iff the 16-bit half n mod 2 of word (n mod 8) // 2
    of Philox(n // 8) is >= round(p 2^16), the key the seed's low 32 bits
    (a seed word above 2^32 is cut)."""
    seed = torch.tensor([2 ** 32 + 0x1234, 0xFEDCBA98], dtype=torch.int64)
    got = kernels.dropout_keep_plain(seed, shape, rate)
    assert got.shape == shape and got.dtype == torch.bool
    thr = round(rate * 2 ** 16)
    assert kernels.dropout_threshold(rate) == thr
    want = []
    for n in range(int(np.prod(shape))):
        word = _philox_py(((n // 8) & _U32, n // 8 >> 32, 0, 0),
                          (0x1234, 0xFEDCBA98))[n % 8 // 2]
        want.append((word >> 16 * (n % 2)) & 0xFFFF >= thr)
    assert got.reshape(-1).tolist() == want


# a mesh rank's block of the one-device bits: (row_offset, total_rows,
# head_offset, total_heads) inside a (total_rows, total_heads, Lq, Lk) draw;
# runs of Lq Lk divisible by 8 take the one-call-per-8-bits path, others
# one call per element
@pytest.mark.parametrize("shape,block", [
    ((2, 3, 16, 8), (4, 8, 3, 6)), ((1, 2, 17, 5), (3, 4, 1, 4)),
    ((3, 6, 8, 16), (0, 3, 6, 12)), ((2, 1, 1, 1), (1, 3, 2, 3))])
def test_dropout_keep_block_is_the_full_draws_block(shape, block):
    seed = torch.tensor([2 ** 32 + 0x1234, 0xFEDCBA98], dtype=torch.int64)
    b, h, lq, lk = shape
    r0, rows, h0, heads = block
    whole = kernels.dropout_keep_plain(seed, (rows, heads, lq, lk), 0.25)
    got = kernels.dropout_keep_plain(seed, shape, 0.25, block)
    assert torch.equal(got, whole[r0:r0 + b, h0:h0 + h])


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (2, 3, 17, 5),
                                   (4, 4, 16, 16)])
def test_dropout_keep_default_block_keeps_every_bit(shape):
    """The default block, (0, B, 0, H), is the draw as it always was."""
    seed = torch.tensor([7, 11])
    want = kernels.dropout_keep_plain(seed, shape, 0.1)
    got = kernels.dropout_keep_plain(seed, shape, 0.1,
                                     (0, shape[0], 0, shape[1]))
    assert torch.equal(got, want)


def test_dropout_block_is_checked():
    seed = torch.tensor([7, 11])
    for block in ((1, 2, 0, 4), (0, 2, 3, 4), (-1, 4, 0, 4)):
        with pytest.raises(ValueError, match="does not hold"):
            kernels.dropout_keep_plain(seed, (2, 2, 4, 4), 0.1, block)


def test_attention_train_draws_its_block():
    """A rank's training forward and backward with a dropout block: the
    plain versions given the matching block of the full draw."""
    q, k, v, mask, table = _inputs(seed=4, ragged=True)
    q, k, v, mask, table = (torch.from_numpy(x) for x in (q, k, v, mask,
                                                          table))
    seed = torch.tensor([3, 9])
    kw = dict(num_heads=H, max_pos=MAX_POS)
    block = (B, 3 * B, H, 3 * H)   # rows B..2B-1, heads H..2H-1
    keep = kernels.dropout_keep_plain(seed, (3 * B, 3 * H, LQ, LK), 0.25)[
        B:2 * B, H:2 * H]
    out, lse = kernels.fused_attention_train(q, k, v, mask, table, seed, 0.25,
                                             dropout_block=block, **kw)
    want, want_lse = kernels.attention_train_plain(q, k, v, mask, table,
                                                   keep, 0.25, **kw)
    torch.testing.assert_close(out, want, atol=0, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=0, rtol=0)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    got = kernels.attention_backward(dout, q, k, v, lse, mask, table, seed,
                                     0.25, dropout_block=block, **kw)
    grads = kernels.attention_backward_plain(dout, q, k, v, lse, mask, table,
                                             keep, 0.25, **kw)
    for g, w in zip(got, grads):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.parametrize("rate", [0.1, 0.25])
def test_dropout_keep_rate_within_five_sigma(rate):
    """At 2^20 elements the kept share is within 5 sigma of 1 - p."""
    n = 2 ** 20
    keep = kernels.dropout_keep_plain(torch.tensor([7, 11]), (4, 4, 256, 256),
                                      rate)
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(keep.float().mean().item() - (1 - rate)) <= 5 * sigma
    assert kernels.dropout_threshold(0.0) == 0
    assert kernels.dropout_threshold(1 - 2 ** -40) == 0xFFFF
    assert abs(kernels.dropout_threshold(rate) / 2 ** 16 - rate) <= 2 ** -17


def test_attention_dropout_from_a_seeded_generator():
    """attention() under a gradient draws one seed from the generator; its
    output and gradients equal the plain versions given
    dropout_keep_plain of the same draw (the CPU and the card draw one
    mask for one seed)."""
    q, k, v, mask, table = _inputs(seed=9, ragged=True)
    kw = dict(num_heads=H, max_pos=MAX_POS)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, table)]
    out = kernels.attention(*leaves[:3], torch.from_numpy(mask), leaves[3],
                            dropout_p=0.25,
                            generator=torch.Generator().manual_seed(5), **kw)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(6))
    out.backward(dout)
    seed = torch.randint(0, 2 ** 32, (2,), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(5))
    keep = kernels.dropout_keep_plain(seed, (B, H, LQ, LK), 0.25)
    assert 0.6 < keep.float().mean().item() < 0.9
    plain = [x.detach() for x in leaves]
    want, lse = kernels.attention_train_plain(
        *plain[:3], torch.from_numpy(mask), plain[3], keep, 0.25, **kw)
    torch.testing.assert_close(out.detach(), want, atol=0, rtol=0)
    grads = kernels.attention_backward_plain(
        dout, *plain[:3], lse, torch.from_numpy(mask), plain[3], keep, 0.25,
        **kw)
    for leaf, w in zip(leaves, grads):
        torch.testing.assert_close(leaf.grad, w, atol=1e-5, rtol=1e-4)


def test_dropout_seed_is_checked():
    q = torch.zeros(2, 4, F)
    mask = torch.zeros(2, 4)
    kw = dict(num_heads=H, max_pos=8)
    for bad in (torch.zeros(2, dtype=torch.int32), torch.zeros(3,
                                                              dtype=torch.int64)):
        with pytest.raises(ValueError, match="seed"):
            kernels.fused_attention_train(q, q, q, mask, None, bad, 0.1, **kw)
    with pytest.raises(ValueError, match="dropout_p"):
        kernels.fused_attention_train(q, q, q, mask, None,
                                      torch.zeros(2, dtype=torch.int64), 1.0,
                                      **kw)
