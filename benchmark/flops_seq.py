"""Operations and bytes of the sequence denoiser's train step, counted as
benchmark/flops.py counts the structure denoiser's: every multiply-add of
the Linears and of the attention cores as 2 operations at the padded
shapes, a step as 3 forwards, and each kernel family's least time from
its calls' shapes (flops.family_least_s).

The model (models/sequence.py): the ligand's and the receptor's sequence
and angle embeddings, one SELayer run on both branches (conditioned on
the angle embedding plus the timestep's), the cross-attention decoder
(ligand queries, receptor memory, recomputed every forward), an SELayer
conditioned on the timestep alone, and the 20-class head.
"""

from __future__ import annotations

from benchmark import flops
from benchmark.flops import Attn, Norm, Shape, _bert_flops, _lin, _se_flops


def shape_of(part: dict) -> Shape:
    """The configuration's ``sequence`` group as a Shape (no encoder)."""
    return Shape(part["hidden_size"], part["num_attention_heads"],
                 part["intermediate_size"], 0, part["num_hidden_layers"],
                 part["max_seq_len"])


def forward_flops(s: Shape, b, ll, lr) -> float:
    h, tl, tr = s.hidden, b * ll, b * lr
    f = _lin(tl, 20, h) + _lin(tl, 8, h) + _se_flops(s, tl, tl, b, ll)
    f += _lin(tr, 20, h) + _lin(tr, 8, h) + _se_flops(s, tr, tr, b, lr)
    f += s.dec_layers * _bert_flops(s, b, ll, lr, cross_kv=True)
    f += _se_flops(s, tl, b, b, ll)
    return f + _lin(tl, h, h) + _lin(tl, h, 20)


def train_step_flops(s: Shape, b, ll, lr) -> float:
    return 3.0 * forward_flops(s, b, ll, lr)


def forward_calls(s: Shape, b, ll, lr):
    """The attention and LayerNorm calls of one forward, in order."""
    rl, rr = b * ll, b * lr
    se = [True, False, False]      # its block's residual LayerNorm, norm1, 2
    attn = [Attn(b, ll, ll, True), Attn(b, lr, lr, True)]
    norms = ([Norm(rl, False)] * 2 + [Norm(rl, r) for r in se]
             + [Norm(rr, False)] * 2 + [Norm(rr, r) for r in se])
    for _ in range(s.dec_layers):
        attn += [Attn(b, ll, ll, True), Attn(b, ll, lr, False)]
        norms += [Norm(rl, True)] * 3
    attn.append(Attn(b, ll, ll, True))
    norms += [Norm(rl, r) for r in se] + [Norm(rl, False)]
    return attn, norms


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
    s = shape_of(run.config["sequence"])
    attn, norms = forward_calls(s, f["batch"], f["length"], f["length"])
    least = flops.family_least_s(
        family, attn if family == "attention" else norms, s, backward=True)
    return 100.0 * least * f["traced_steps"] / took
