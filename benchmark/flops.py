"""Operations and bytes of the denoisers' work, counted from the
configuration's shapes, and the H100's published peaks.

Model FLOPs count every multiply-add of the Linears and of the attention
cores (QK^T, the relative-position product, PV) as 2 operations, at the
padded shapes the step computes; elementwise work is not counted. A
training step is 3 forwards (the backward twice the forward), nothing
recomputed.

A kernel family's least time is max(operations / peak, bytes / bandwidth)
per call, summed over the calls of a step or batch: each input read once
and each output written once, in the compute dtype (bf16, 2 bytes), the
additive masks and row statistics in float32.
"""

from __future__ import annotations

import dataclasses

PEAK_BF16_FLOPS = 989e12     # H100 SXM, dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12         # HBM3, bytes/s
ACT = 2                      # bytes of a bf16 activation


@dataclasses.dataclass
class Shape:
    hidden: int
    heads: int
    inter: int
    enc_layers: int
    dec_layers: int
    max_pos: int


def shape_of(cfg: dict, layers_key: str = "num_hidden_layers") -> Shape:
    return Shape(cfg["hidden_size"], cfg["num_heads"],
                 cfg["intermediate_size"], cfg[layers_key], cfg[layers_key],
                 cfg["max_seq_len"])


@dataclasses.dataclass
class Attn:
    """One attention call: batch, query and key lengths, relative table."""
    b: int
    lq: int
    lk: int
    table: bool


@dataclasses.dataclass
class Norm:
    """One residual + LayerNorm call over rows x hidden."""
    rows: int
    residual: bool


def _lin(tokens, n_in, n_out):
    return 2.0 * tokens * n_in * n_out


def _attn_core_flops(a: Attn, hidden: int) -> float:
    return 2.0 * a.b * a.lq * a.lk * hidden * (3 if a.table else 2)


def _se_flops(s: Shape, tokens, cond_tokens, b, l):
    h = s.hidden
    return (_lin(cond_tokens, h, h) + _lin(cond_tokens, h, 6 * h)
            + 4 * _lin(tokens, h, h) + _lin(tokens, h, 4 * h)
            + _lin(tokens, 4 * h, h) + _attn_core_flops(Attn(b, l, l, True), h))


def _bert_flops(s: Shape, b, lq, lk=None, cross_kv=True):
    h, tok = s.hidden, b * lq
    f = 4 * _lin(tok, h, h) + _lin(tok, h, s.inter) + _lin(tok, s.inter, h)
    f += _attn_core_flops(Attn(b, lq, lq, True), h)
    if lk is not None:
        f += 2 * _lin(tok, h, h) + _attn_core_flops(Attn(b, lq, lk, False), h)
        if cross_kv:
            f += 2 * _lin(b * lk, h, h)
    return f


def structure_encode_flops(s: Shape, b, lr) -> float:
    h, tok = s.hidden, b * lr
    f = _lin(tok, 8, h) + _lin(tok, 20, h) + _se_flops(s, tok, tok, b, lr)
    return f + s.enc_layers * _bert_flops(s, b, lr)


def cross_kv_flops(s: Shape, b, lr) -> float:
    return s.dec_layers * 2 * _lin(b * lr, s.hidden, s.hidden)


def structure_decode_flops(s: Shape, b, ll, lr, cross_kv=True) -> float:
    h, tok = s.hidden, b * ll
    f = _lin(tok, 8, h) + _se_flops(s, tok, b, b, ll)
    f += s.dec_layers * _bert_flops(s, b, ll, lr, cross_kv)
    return f + _lin(tok, h, h) + _lin(tok, h, 8)


def structure_forward_flops(s: Shape, b, ll, lr) -> float:
    return (structure_encode_flops(s, b, lr)
            + structure_decode_flops(s, b, ll, lr, cross_kv=True))


def train_step_flops(s: Shape, b, ll, lr) -> float:
    return 3.0 * structure_forward_flops(s, b, ll, lr)


def sample_batch_flops(s: Shape, b, ll, lr, steps) -> float:
    """One batch: the pocket encoding and cross K/V once, then ``steps``
    decodes reading the cached K/V."""
    return (structure_encode_flops(s, b, lr) + cross_kv_flops(s, b, lr)
            + steps * structure_decode_flops(s, b, ll, lr, cross_kv=False))


# -- the kernels' calls ----------------------------------------------------

def encode_calls(s: Shape, b, lr):
    attn = [Attn(b, lr, lr, True)] * (1 + s.enc_layers)
    rows = b * lr
    norms = ([Norm(rows, False)] * 2                       # embeddings
             + [Norm(rows, True), Norm(rows, False), Norm(rows, False)]
             + [Norm(rows, True)] * (2 * s.enc_layers))
    return attn, norms


def decode_calls(s: Shape, b, ll, lr):
    attn = [Attn(b, ll, ll, True)]
    for _ in range(s.dec_layers):
        attn += [Attn(b, ll, ll, True), Attn(b, ll, lr, False)]
    rows = b * ll
    norms = ([Norm(rows, False)]
             + [Norm(rows, True), Norm(rows, False), Norm(rows, False)]
             + [Norm(rows, True)] * (3 * s.dec_layers)
             + [Norm(rows, False)])
    return attn, norms


def attention_least_s(a: Attn, s: Shape, backward: bool) -> float:
    """Least seconds of one attention call: forward (Q, K, V and the mask
    read, O and the row statistics written), or, with ``backward``, the
    forward and its backward (Q, K, V, O, dO, the statistics and the mask
    read; dQ, dK, dV written; the table's gradient beside it)."""
    h = s.hidden
    d = h // s.heads
    unit = 2.0 * a.b * a.lq * a.lk * h
    table = (2 * s.max_pos - 1) * d * ACT if a.table else 0
    q, kv = a.b * a.lq * h * ACT, a.b * a.lk * h * ACT
    fwd_flops = unit * (3 if a.table else 2)
    fwd_bytes = q + 2 * kv + 4 * a.b * a.lk + table + q + 4 * a.b * s.heads * a.lq
    t = max(fwd_flops / PEAK_BF16_FLOPS, fwd_bytes / PEAK_BYTES)
    if backward:
        bwd_flops = unit * (8 if a.table else 5)
        bwd_bytes = (3 * q + 2 * kv + 4 * a.b * a.lk
                     + 4 * a.b * s.heads * a.lq + table    # reads
                     + q + 2 * kv + table * 2)             # writes
        t += max(bwd_flops / PEAK_BF16_FLOPS, bwd_bytes / PEAK_BYTES)
    return t


def layernorm_least_s(n: Norm, s: Shape, backward: bool) -> float:
    """Least seconds of one residual + LayerNorm call: x (and the
    residual) read, y written; with ``backward``, also dy and x (and the
    residual) read and dx written. Bound by bytes."""
    per = (3 if n.residual else 2) * ACT
    t = n.rows * s.hidden * per / PEAK_BYTES
    if backward:
        t += n.rows * s.hidden * (4 if n.residual else 3) * ACT / PEAK_BYTES
    return t


def family_least_s(family: str, calls, s: Shape, backward: bool) -> float:
    fn = attention_least_s if family == "attention" else layernorm_least_s
    return sum(fn(c, s, backward) for c in calls)


# -- the per-layer readers' arithmetic -------------------------------------

def _config_shape(part: dict) -> Shape:
    return shape_of(part | {"num_heads": part["num_attention_heads"]})


def train_roofline(run, family: str):
    """A kernel family's share of its roofline in the traced train steps,
    in %: the least time of every call of those steps, forward and
    backward, over the family's device time in the trace; None where the
    run traced no step or the trace holds none of the family's kernels."""
    from benchmark import tracing

    p, f = run.profile, run.facts
    if not p or not f.get("traced_steps"):
        return None
    took = tracing.family_seconds(p["ops"], family)
    if took <= 0:
        return None
    s = _config_shape(run.config["structure"])
    b, n = f["batch"], f["length"]
    (ea, en), (da, dn) = encode_calls(s, b, n), decode_calls(s, b, n, n)
    calls = ea + da if family == "attention" else en + dn
    least = family_least_s(family, calls, s, backward=True)
    return 100.0 * least * f["traced_steps"] / took


def sample_roofline(run, family: str):
    """The same for the traced sampling batches: the pocket encoding once
    and one decode a step, forward only."""
    from benchmark import tracing

    p, f = run.profile, run.facts
    if not p or not f.get("traced_batches"):
        return None
    took = tracing.family_seconds(p["ops"], family)
    if took <= 0:
        return None
    s = _config_shape({**run.config["structure"], **run.config["sample"]})
    b, ll, lr = f["batch"], f["ligand_len"], f["receptor_len"]
    (ea, en), (da, dn) = encode_calls(s, b, lr), decode_calls(s, b, ll, lr)
    enc, dec = (ea, da) if family == "attention" else (en, dn)
    least = (family_least_s(family, enc, s, False)
             + f["steps"] * family_least_s(family, dec, s, False))
    return 100.0 * least * f["traced_batches"] / took
