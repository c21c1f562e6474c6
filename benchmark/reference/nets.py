"""Plain PyTorch reference of the two denoisers of E3-invariant diffusion
(LabJunBMI/E3-invaraint-diffusion-model: structure_model/model.py and
sequence_model/model.py, HF BertConfig with relative_key positions).

Written from the published description, in float32 on whatever device the
weights live on, with no kernel, cache or batching trick: every attention
is the textbook softmax(Q K^T / sqrt(D) + relative scores + mask) V, every
LayerNorm two means. It imports nothing of the program and nothing of JAX.

Weights are a dict of tensors under the reference's HF-BERT state_dict
names (``structure_shapes`` / ``sequence_shapes`` list them), made by the
benchmark and handed to the program as well.

``Ctx`` carries what changes between uses:
* ``matmul``: how a Linear computes (float32 by default;
  ``bf16_weight_matmul`` rounds the weight to bfloat16, as a bf16-compute
  train step over float32 master weights computes with their bf16 copy;
  ``int8_matmul`` rounds weights to per-output-channel int8 and inputs to
  bf16, the control of the training cell);
* ``t_dtype``: the dtype the timestep enters in. The model casts the
  timestep to its compute dtype before the Fourier features (bf16: 999
  becomes 1000), as the configuration states; that is an input of the
  model, not the precision of its arithmetic, so the reference does it too;
* ``generator`` and ``dropout``: in training, every dropout site draws its
  uniforms and every attention its 2-int64 Philox seed from the generator,
  in the order the forward reaches them, as the program's train step does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from benchmark.reference.philox import attention_keep


def set_exact_float32() -> None:
    """No TF32 anywhere: a float32 product is a float32 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def f32_matmul(x, w, b):
    return F.linear(x, w, b)


def bf16_weight_matmul(x, w, b):
    """The weight rounded to bfloat16, float32 arithmetic; gradients passed
    straight through to the float32 weight."""
    wq = w.detach().to(torch.bfloat16).float()
    return F.linear(x, w + (wq - w.detach()), b)


def int8_matmul(x, w, b):
    """Per-output-channel symmetric int8 weights (amax / 127) and bf16
    inputs, gradients passed straight through to the float32 weights."""
    amax = w.detach().abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    wq = torch.clamp(torch.round(w.detach() / scale), -127, 127) * scale
    xq = x.detach().to(torch.bfloat16).float()
    return F.linear(x + (xq - x.detach()), w + (wq - w.detach()), b)


@dataclasses.dataclass
class Ctx:
    w: dict
    heads: int
    max_pos: int
    matmul: Callable = f32_matmul
    t_dtype: torch.dtype = torch.float32
    generator: torch.Generator | None = None
    dropout: float = 0.0

    def linear(self, name, x):
        return self.matmul(x, self.w[name + ".weight"], self.w[name + ".bias"])

    def drop(self, x):
        if self.generator is None or self.dropout == 0.0:
            return x
        u = torch.rand(x.shape, generator=self.generator, device=x.device)
        return torch.where(u >= self.dropout, x / (1.0 - self.dropout),
                           torch.zeros_like(x))


def mask_add(mask):
    """(B, L) 0/1 -> additive (B, L): 0 kept, -10000 padding."""
    return (1.0 - mask.float()) * -10000.0


def layernorm(x, weight=None, bias=None, eps=1e-12, residual=None):
    y = x if residual is None else x + residual
    mean = y.mean(-1, keepdim=True)
    var = ((y - mean) ** 2).mean(-1, keepdim=True)
    y = (y - mean) / torch.sqrt(var + eps)
    if weight is not None:
        y = y * weight + bias
    return y


def attention(ctx: Ctx, prefix, x, kv, madd, relative):
    b, lq, hid = x.shape
    src = x if kv is None else kv
    lk = src.shape[1]
    h, d = ctx.heads, hid // ctx.heads
    q = ctx.linear(prefix + ".query", x).reshape(b, lq, h, d)
    k = ctx.linear(prefix + ".key", src).reshape(b, lk, h, d)
    v = ctx.linear(prefix + ".value", src).reshape(b, lk, h, d)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if relative:
        table = ctx.w[prefix + ".distance_embedding.weight"]
        idx = (torch.arange(lq, device=x.device)[:, None]
               - torch.arange(lk, device=x.device)[None, :] + ctx.max_pos - 1)
        s = s + torch.einsum("bqhd,qkd->bhqk", q, table[idx])
    s = s / math.sqrt(d) + madd[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    if ctx.generator is not None and ctx.dropout > 0.0:
        seed = torch.randint(0, 2 ** 32, (2,), dtype=torch.int64,
                             generator=ctx.generator, device=x.device)
        keep = attention_keep(seed, (b, h, lq, lk), ctx.dropout)
        p = p * keep * (1.0 / (1.0 - ctx.dropout))
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, lq, hid)


def attention_block(ctx, prefix, x, kv, madd, relative):
    out = attention(ctx, prefix + ".self", x, kv, madd, relative)
    out = ctx.drop(ctx.linear(prefix + ".output.dense", out))
    return layernorm(out, ctx.w[prefix + ".output.LayerNorm.weight"],
                     ctx.w[prefix + ".output.LayerNorm.bias"], residual=x)


def bert_layer(ctx, prefix, x, madd, enc=None, enc_madd=None):
    x = attention_block(ctx, prefix + ".attention", x, None, madd, True)
    if enc is not None:
        x = attention_block(ctx, prefix + ".crossattention", x, enc,
                            enc_madd, False)
    y = F.gelu(ctx.linear(prefix + ".intermediate.dense", x))
    y = ctx.drop(ctx.linear(prefix + ".output.dense", y))
    return layernorm(y, ctx.w[prefix + ".output.LayerNorm.weight"],
                     ctx.w[prefix + ".output.LayerNorm.bias"], residual=x)


def se_layer(ctx, prefix, x, c, madd):
    """DiT adaLN block: attention and a 4x MLP, each through an
    affine-free LayerNorm (eps 1e-5), shifted, scaled and gated by c."""
    mod = ctx.linear(prefix + ".adaLN_modulation.2",
                     F.silu(ctx.linear(prefix + ".adaLN_modulation.0", c)))
    sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
    a = attention_block(ctx, prefix + ".attn", x, None, madd, True)
    x = x + g1 * (layernorm(a, eps=1e-5) * (1 + sc1) + sh1)
    y = ctx.drop(F.gelu(ctx.linear(prefix + ".mlp.0", x)))
    y = ctx.drop(ctx.linear(prefix + ".mlp.3", y))
    return x + g2 * (layernorm(y, eps=1e-5) * (1 + sc2) + sh2)


def feature_embedding(ctx, prefix, x):
    y = ctx.linear(prefix + ".linear", x)
    return ctx.drop(layernorm(y, ctx.w[prefix + ".LayerNorm.weight"],
                              ctx.w[prefix + ".LayerNorm.bias"]))


def fourier(ctx, prefix, t):
    t = t.reshape(-1).to(ctx.t_dtype).float()
    proj = t[:, None] * ctx.w[prefix + ".W"][None, :] * 2 * math.pi
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def mlp_head(ctx, prefix, x):
    y = F.gelu(ctx.linear(prefix + ".dense1", x))
    y = layernorm(y, ctx.w[prefix + ".layer_norm.weight"],
                  ctx.w[prefix + ".layer_norm.bias"])
    return ctx.linear(prefix + ".dense2", y)


def n_layers(w: dict, stack: str) -> int:
    return len({k.split(".")[2] for k in w if k.startswith(stack + ".layer.")})


# -- the structure denoiser ----------------------------------------------

def structure_encode(ctx, rec_seq, rec_angles, rec_mask):
    madd = mask_add(rec_mask)
    a = feature_embedding(ctx, "receptor_angle_emb", rec_angles.float())
    s = feature_embedding(ctx, "receptor_seq_emb", rec_seq.float())
    x = se_layer(ctx, "receptor_emb", a, s, madd)
    for i in range(n_layers(ctx.w, "encoder")):
        x = bert_layer(ctx, f"encoder.layer.{i}", x, madd)
    return x


def structure_decode(ctx, t, x_t, lig_mask, enc, rec_mask):
    lmadd, rmadd = mask_add(lig_mask), mask_add(rec_mask)
    x = feature_embedding(ctx, "ligand_angle_emb", x_t.float())
    temb = fourier(ctx, "timestep_projector", t)[:, None, :]
    x = se_layer(ctx, "timestep_emb", x, temb, lmadd)
    for i in range(n_layers(ctx.w, "decoder")):
        x = bert_layer(ctx, f"decoder.layer.{i}", x, lmadd, enc, rmadd)
    return mlp_head(ctx, "angles_predictor", x)


def structure_forward(ctx, t, x_t, lig_mask, rec_seq, rec_angles, rec_mask):
    enc = structure_encode(ctx, rec_seq, rec_angles, rec_mask)
    return structure_decode(ctx, t, x_t, lig_mask, enc, rec_mask)


# -- the sequence denoiser -----------------------------------------------

def sequence_forward(ctx, s, x_onehot, lig_angles, lig_mask, rec_seq,
                     rec_angles, rec_mask):
    """Logits (B, L, 20). One SELayer fuses both branches; the receptor
    memory depends on the step, so nothing is computed once."""
    lmadd, rmadd = mask_add(lig_mask), mask_add(rec_mask)
    temb = fourier(ctx, "timestep_projector", s)[:, None, :]
    lig = se_layer(
        ctx, "ligand_feature_emb",
        feature_embedding(ctx, "ligand_seq_embedding", x_onehot.float()),
        feature_embedding(ctx, "ligand_angle_embedding", lig_angles.float())
        + temb, lmadd)
    rec = se_layer(
        ctx, "ligand_feature_emb",
        feature_embedding(ctx, "receptor_seq_embedding", rec_seq.float()),
        feature_embedding(ctx, "receptor_angle_embedding", rec_angles.float())
        + temb, rmadd)
    for i in range(n_layers(ctx.w, "decoder")):
        lig = bert_layer(ctx, f"decoder.layer.{i}", lig, lmadd, rec, rmadd)
    lig = se_layer(ctx, "decoder_normalize", lig, temb, lmadd)
    return mlp_head(ctx, "amino_acid_predictor", lig)


# -- parameter names and shapes -------------------------------------------

def _linear(out, name, n_in, n_out):
    out[name + ".weight"] = (n_out, n_in)
    out[name + ".bias"] = (n_out,)


def _ln(out, name):
    out[name + ".weight"] = (name, "ln")
    out[name + ".bias"] = (name, "ln")


def _attention(out, prefix, hid, rel_rows, head_dim):
    for p in ("query", "key", "value"):
        _linear(out, f"{prefix}.self.{p}", hid, hid)
    if rel_rows:
        out[prefix + ".self.distance_embedding.weight"] = (rel_rows, head_dim)
    _linear(out, prefix + ".output.dense", hid, hid)
    _ln(out, prefix + ".output.LayerNorm")


def _bert(out, prefix, cfg, cross):
    hid, rel, hd = cfg["hidden_size"], 2 * cfg["max_seq_len"] - 1, (
        cfg["hidden_size"] // cfg["num_heads"])
    _attention(out, prefix + ".attention", hid, rel, hd)
    if cross:
        _attention(out, prefix + ".crossattention", hid, 0, hd)
    _linear(out, prefix + ".intermediate.dense", hid, cfg["intermediate_size"])
    _linear(out, prefix + ".output.dense", cfg["intermediate_size"], hid)
    _ln(out, prefix + ".output.LayerNorm")


def _se(out, prefix, cfg):
    hid = cfg["hidden_size"]
    _linear(out, prefix + ".adaLN_modulation.0", hid, hid)
    _linear(out, prefix + ".adaLN_modulation.2", hid, 6 * hid)
    _attention(out, prefix + ".attn", hid, 2 * cfg["max_seq_len"] - 1,
               hid // cfg["num_heads"])
    _linear(out, prefix + ".mlp.0", hid, 4 * hid)
    _linear(out, prefix + ".mlp.3", 4 * hid, hid)


def _embedding(out, prefix, n_in, hid):
    _linear(out, prefix + ".linear", n_in, hid)
    _ln(out, prefix + ".LayerNorm")


def _head(out, prefix, hid, n_out):
    _linear(out, prefix + ".dense1", hid, hid)
    _ln(out, prefix + ".layer_norm")
    _linear(out, prefix + ".dense2", hid, n_out)


def _resolve(out, hid):
    return {k: ((hid,) if isinstance(v[0], str) else v)
            for k, v in out.items()}


def structure_shapes(cfg: dict) -> dict:
    """{name: shape} of the structure denoiser's state_dict; LayerNorm
    vectors are marked by ``is_layernorm``."""
    hid, out = cfg["hidden_size"], {}
    _embedding(out, "receptor_angle_emb", 8, hid)
    _embedding(out, "receptor_seq_emb", 20, hid)
    _se(out, "receptor_emb", cfg)
    for i in range(cfg["num_hidden_layers"]):
        _bert(out, f"encoder.layer.{i}", cfg, cross=False)
    _embedding(out, "ligand_angle_emb", 8, hid)
    out["timestep_projector.W"] = (hid // 2,)
    _se(out, "timestep_emb", cfg)
    for i in range(cfg["num_hidden_layers"]):
        _bert(out, f"decoder.layer.{i}", cfg, cross=True)
    _head(out, "angles_predictor", hid, 8)
    return _resolve(out, hid)


def sequence_shapes(cfg: dict) -> dict:
    hid, out = cfg["hidden_size"], {}
    out["timestep_projector.W"] = (hid // 2,)
    _embedding(out, "ligand_seq_embedding", 20, hid)
    _embedding(out, "ligand_angle_embedding", 8, hid)
    _se(out, "ligand_feature_emb", cfg)
    _embedding(out, "receptor_seq_embedding", 20, hid)
    _embedding(out, "receptor_angle_embedding", 8, hid)
    for i in range(cfg["num_hidden_layers"]):
        _bert(out, f"decoder.layer.{i}", cfg, cross=True)
    _se(out, "decoder_normalize", cfg)
    _head(out, "amino_acid_predictor", hid, 20)
    return _resolve(out, hid)


def is_layernorm(name: str) -> bool:
    return ".LayerNorm." in name or ".layer_norm." in name


def make_weights(shapes: dict, seed: int, device) -> dict:
    """Seeded weights on ``device``, drawn in a few large calls: matrices
    and distance tables with the heavy tails of trained transformer
    weights (Student's t with 4 degrees of freedom, scaled to variance
    1/fan_in for a Linear and 1 for a table), biases N(0, 1/fan_in),
    LayerNorm gains 1 + 0.1 N(0, 1) and shifts 0.1 N(0, 1), the Fourier W
    N(0, (2 pi)^2); every value rounded to one that bfloat16 holds
    exactly, so that a bf16 copy of a weight is the weight itself."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.empty(total, device=device)
    chunk = 1 << 24
    for at in range(0, total, chunk):
        n = min(chunk, total - at)
        z = torch.randn((5, n), generator=gen, device=device)
        chi = z[1:].pow(2).mean(0)           # chi-square(4) / 4
        flat[at:at + n] = z[0] / chi.sqrt() / math.sqrt(2.0)
    normal = torch.randn(total, generator=gen, device=device)
    fan_in = {}
    for name, shape in shapes.items():
        if len(shape) == 2 and not name.endswith("distance_embedding.weight"):
            fan_in[name.rsplit(".", 1)[0]] = shape[1]
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        heavy = flat[at:at + n].reshape(shape)
        v = normal[at:at + n].reshape(shape)
        at += n
        base = name.rsplit(".", 1)[0]
        if name.endswith("distance_embedding.weight"):
            v = heavy
        elif name.endswith(".W"):
            v = v * (2 * math.pi)
        elif is_layernorm(name):
            v = v * 0.1 + (1.0 if name.endswith(".weight") else 0.0)
        elif len(shape) == 2:
            v = heavy / math.sqrt(fan_in[base])
        else:
            v = v / math.sqrt(fan_in[base])
        out[name] = v.to(torch.bfloat16).float()
    return out
