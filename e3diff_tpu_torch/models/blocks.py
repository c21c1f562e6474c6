"""Neural blocks of the denoisers (counterpart of
e3diff_tpu/models/blocks.py).

Submodule names follow the reference HF-BERT state_dict layout (the one
e3diff_tpu/utils/torch_port.py reads and writes), so
``load_state_dict(strict=True)`` takes both the JAX export and the
reference's published checkpoints.

Every attention core goes through ``kernels.attention`` and every
LayerNorm through ``kernels.layernorm``: the inference kernels when no
gradient is needed, the training kernels (forward and backward) when one
is; the Linears, GELU (exact erf) and SiLU stay plain torch, as the JAX
package leaves them to XLA.

Numerics that differ from the JAX path, in the compute dtype bf16 only:
JAX adds each residual in bf16 before ``nn.LayerNorm`` and takes the
attention softmax in bf16, while the kernels (like the Pallas kernels)
add the residual and take the softmax in f32. In f32 the two agree to
rounding.

Dropout sits where the JAX package has it (blocks.py:162, :229, :262,
:393, :397, :435) and is active only under ``model.train()``: on the
attention probabilities inside the kernel, and on the attention output,
the MLP outputs and the embeddings as ``Dropout`` modules. Its keep masks
come from the generator ``set_dropout_generator`` hands every dropout
site. Training keeps f32 master weights and computes in the config's
dtype, as the JAX ``bf16`` preset does; a Linear stored in bf16 or int8
refuses to train.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from e3diff_tpu_torch.models.config import TransformerConfig
from e3diff_tpu_torch.ops import kernels
from e3diff_tpu_torch.utils.quant import dequantize


def extend_attention_mask(mask: torch.Tensor, dtype=torch.float32):
    """(B, L) 0/1 mask -> (B, L) additive mask, -10000 at padding, in
    ``dtype`` (the JAX version returns the same values as (B, 1, 1, L);
    the kernel takes them flat)."""
    return (1.0 - mask.to(dtype)) * -10000.0


def kernel_mask(mask: torch.Tensor, cfg: TransformerConfig):
    """The additive mask as the attention kernel takes it: built in the
    compute dtype as the JAX package builds it (-9984 in bf16), read as
    f32."""
    return extend_attention_mask(mask, cfg.dtype).float()


class Dropout(nn.Module):
    """flax's Dropout: under ``train()``, x / (1 - p) where a uniform draw
    from ``generator`` is >= p, else 0; the identity in eval mode. No
    parameters, so the state_dict keys around it do not change."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: torch.Generator | None = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


def set_dropout_generator(model: nn.Module, generator: torch.Generator):
    """Every dropout site of ``model`` (the Dropout modules and the
    attention cores) draws its keep masks from ``generator``."""
    for m in model.modules():
        if isinstance(m, (Dropout, MultiHeadAttention)):
            m.generator = generator


class Linear(nn.Module):
    """y = x W^T + b in the compute dtype. ``weight`` is (out, in) and is
    stored f32, bf16, or int8 beside a per-output-channel ``weight_scale``
    (utils/params_io.py::cast_inference_params)."""

    QUANT_AXIS = -1  # the input axis of torch's (out, in) layout

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))
        self.register_buffer("weight_scale", None)

    def forward(self, x):
        if self.training and (self.weight_scale is not None
                              or self.weight.dtype != torch.float32):
            raise RuntimeError(
                f"Linear({self.in_features}, {self.out_features}): weights "
                f"stored as {self.weight.dtype} for inference do not train; "
                "train f32 weights")
        w = dequantize(self.weight, self.weight_scale).to(self.dtype)
        return F.linear(x.to(self.dtype), w, self.bias.to(self.dtype))


class DistanceEmbedding(nn.Module):
    """HF relative_key distance table, (2*max_pos-1, head_dim)."""

    QUANT_AXIS = -2  # the JAX package's axis for this 2-D leaf

    def __init__(self, max_pos: int, head_dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(2 * max_pos - 1, head_dim, device=device))
        self.register_buffer("weight_scale", None)

    def table(self, dtype):
        return dequantize(self.weight, self.weight_scale).to(dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last dim through ``kernels.fused_layernorm``,
    with the residual add folded in. ``affine=False`` is the SELayer's
    norm1/norm2 (torch LayerNorm(elementwise_affine=False))."""

    def __init__(self, features: int, eps: float, affine: bool = True,
                 device=None):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.empty(features, device=device))
            self.bias = nn.Parameter(torch.empty(features, device=device))
        else:
            self.weight = self.bias = None

    def forward(self, x, residual=None):
        return kernels.layernorm(x, self.weight, self.bias, residual,
                                 eps=self.eps)


class MultiHeadAttention(nn.Module):
    """Q/K/V projections and the attention core (HF BertSelfAttention):
    relative scores are added to the raw logits before the 1/sqrt(D)."""

    def __init__(self, cfg: TransformerConfig, relative: bool, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.query = Linear(h, h, cfg.dtype, device)
        self.key = Linear(h, h, cfg.dtype, device)
        self.value = Linear(h, h, cfg.dtype, device)
        if relative and cfg.position_embedding_type == "relative_key":
            self.distance_embedding = DistanceEmbedding(
                cfg.max_position_embeddings, cfg.head_dim, device)
        else:
            self.distance_embedding = None
        self.generator: torch.Generator | None = None

    def project_kv(self, kv):
        """K and V of a memory, flat (B, Lk, H*D) each."""
        return self.key(kv), self.value(kv)

    def forward(self, x, kv, mask_add, cached_kv=None):
        k, v = cached_kv if cached_kv is not None else self.project_kv(kv)
        table = (None if self.distance_embedding is None
                 else self.distance_embedding.table(self.cfg.dtype))
        return kernels.attention(
            self.query(x), k, v, mask_add, table,
            num_heads=self.cfg.num_heads,
            max_pos=self.cfg.max_position_embeddings,
            dropout_p=self.cfg.attention_dropout if self.training else 0.0,
            generator=self.generator)


class AttentionBlock(nn.Module):
    """BertAttention: attention + output dense + residual LayerNorm.
    Cross-attention never takes relative scores (HF builds it absolute)."""

    def __init__(self, cfg: TransformerConfig, cross: bool, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.self = MultiHeadAttention(cfg, relative=not cross, device=device)
        self.output = nn.ModuleDict({
            "dense": Linear(h, h, cfg.dtype, device),
            "LayerNorm": LayerNorm(h, cfg.layer_norm_eps, device=device),
        })
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, kv, mask_add, cached_kv=None):
        ctx = self.self(x, x if kv is None and cached_kv is None else kv,
                        mask_add, cached_kv)
        return self.output["LayerNorm"](
            self.dropout(self.output["dense"](ctx)), residual=x)


class TransformerLayer(nn.Module):
    """BertLayer: self-attention [+ cross-attention] + GELU MLP, each closed
    by residual + LayerNorm."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.attention = AttentionBlock(cfg, cross=False, device=device)
        self.crossattention = (AttentionBlock(cfg, cross=True, device=device)
                               if cfg.add_cross_attention else None)
        self.intermediate = nn.ModuleDict({
            "dense": Linear(h, cfg.intermediate_size, cfg.dtype, device)})
        self.output = nn.ModuleDict({
            "dense": Linear(cfg.intermediate_size, h, cfg.dtype, device),
            "LayerNorm": LayerNorm(h, cfg.layer_norm_eps, device=device),
        })
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, mask_add, enc_out=None, enc_mask_add=None,
                cross_kv=None):
        x = self.attention(x, None, mask_add)
        if self.crossattention is not None and (enc_out is not None
                                                or cross_kv is not None):
            x = self.crossattention(x, enc_out, enc_mask_add, cross_kv)
        y = F.gelu(self.intermediate["dense"](x))
        return self.output["LayerNorm"](
            self.dropout(self.output["dense"](y)), residual=x)


class TransformerStack(nn.Module):
    """BertEncoder: ``layer.{i}``."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.layer = nn.ModuleList(TransformerLayer(cfg, device)
                                   for _ in range(cfg.num_layers))

    def precompute_cross_kv(self, enc_out):
        """Each layer's cross-attention (K, V) over a memory, flat
        (B, Lk, H*D): samplers compute them once per batch."""
        return [layer.crossattention.self.project_kv(enc_out)
                for layer in self.layer]

    def forward(self, x, mask_add, enc_out=None, enc_mask_add=None,
                cross_kv=None):
        for i, layer in enumerate(self.layer):
            x = layer(x, mask_add, enc_out, enc_mask_add,
                      None if cross_kv is None else cross_kv[i])
        return x


class SELayer(nn.Module):
    """DiT-style adaLN block (reference SELayer). The FIRST adaLN Linear
    (``adaLN_modulation.0``) is the zero-initialised one; norm1/norm2 are
    affine-free with eps 1e-5; the MLP is mlp_ratio * hidden = 3072 wide,
    not intermediate_size."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        h = cfg.hidden_size
        mlp_dim = int(h * cfg.mlp_ratio)
        self.adaLN_modulation = nn.Sequential(
            Linear(h, h, cfg.dtype, device), nn.SiLU(),
            Linear(h, 6 * h, cfg.dtype, device))
        self.attn = AttentionBlock(cfg, cross=False, device=device)
        self.norm1 = LayerNorm(h, 1e-5, affine=False)
        # Linears at indices 0 and 3 as in the reference (1: GELU, 2 and
        # 4: dropout, JAX blocks.py:393, :395)
        self.mlp = nn.Sequential(
            Linear(h, mlp_dim, cfg.dtype, device), nn.GELU(),
            Dropout(cfg.dropout), Linear(mlp_dim, h, cfg.dtype, device),
            Dropout(cfg.dropout))
        self.norm2 = LayerNorm(h, 1e-5, affine=False)

    def forward(self, x, c, mask_add):
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
         gate_mlp) = self.adaLN_modulation(c).chunk(6, dim=-1)
        attn_out = self.attn(x, None, mask_add)
        x = x + gate_msa * (self.norm1(attn_out) * (1 + scale_msa) + shift_msa)
        y = self.mlp(x)
        return x + gate_mlp * (self.norm2(y) * (1 + scale_mlp) + shift_mlp)


class GaussianFourierProjection(nn.Module):
    """Fixed random Fourier features of the timestep; W ~ N(0, (2 pi)^2).

    The timestep is cast to the compute dtype first, as in the JAX package
    (blocks.py:416): in bf16, t = 999 becomes 1000. W stays f32 in every
    storage mode, so t * W * 2 pi and sin/cos are then f32 by promotion, in
    both packages."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.dtype = cfg.dtype
        self.register_buffer("W", torch.empty(cfg.hidden_size // 2,
                                               device=device))

    def forward(self, t):
        t = t.reshape(-1).to(self.dtype)
        proj = t[:, None] * self.W[None, :] * 2 * math.pi
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class FeatureEmbedding(nn.Module):
    """Linear -> LayerNorm -> Dropout input embedding (reference
    BertEmbeddings)."""

    def __init__(self, cfg: TransformerConfig, in_features: int, device=None):
        super().__init__()
        self.linear = Linear(in_features, cfg.hidden_size, cfg.dtype, device)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                   device=device)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x):
        return self.dropout(self.LayerNorm(self.linear(x)))


class MLPHead(nn.Module):
    """dense -> GELU -> LayerNorm(eps 1e-12) -> dense prediction head."""

    def __init__(self, cfg: TransformerConfig, d_out: int, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.dense1 = Linear(h, h, cfg.dtype, device)
        self.layer_norm = LayerNorm(h, 1e-12, device=device)
        self.dense2 = Linear(h, d_out, cfg.dtype, device)

    def forward(self, x):
        return self.dense2(self.layer_norm(F.gelu(self.dense1(x))))


def _init_(model: nn.Module, generator: torch.Generator, init_linear,
           zero_adaln):
    """Distance tables N(0, 1), LayerNorm ones/zeros, Fourier W ~
    N(0, (2 pi)^2), every Linear through ``init_linear``; then the first
    adaLN Linear of each SELayer in ``zero_adaln`` zeroed."""
    for m in model.modules():
        if isinstance(m, Linear):
            init_linear(m)
        elif isinstance(m, DistanceEmbedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, LayerNorm) and m.weight is not None:
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, GaussianFourierProjection):
            m.W.normal_(0.0, 2 * math.pi, generator=generator)
    for m in zero_adaln:
        m.adaLN_modulation[0].weight.zero_()
        m.adaLN_modulation[0].bias.zero_()
    return model


@torch.no_grad()
def init_torch_default_(model: nn.Module, generator: torch.Generator):
    """Random weights as the reference's bare torch modules draw them:
    Linear U(+-1/sqrt(fan_in)) for weight and bias, and every SELayer's
    first adaLN Linear zeroed (the structure model)."""
    def linear(m):
        bound = 1.0 / math.sqrt(m.in_features)
        m.weight.uniform_(-bound, bound, generator=generator)
        m.bias.uniform_(-bound, bound, generator=generator)

    return _init_(model, generator, linear,
                  [m for m in model.modules() if isinstance(m, SELayer)])


@torch.no_grad()
def init_xavier_all_(model: nn.Module, generator: torch.Generator,
                     zero_adaln=()):
    """The sequence model's initialize_weights
    (sequence_model/model.py:183-198): xavier-uniform Linear weights,
    U(+-sqrt(6 / (fan_in + fan_out))), and zero biases everywhere; only
    the SELayers in ``zero_adaln`` get their first adaLN Linear re-zeroed
    (``decoder_normalize``; the shared fuse keeps its xavier adaLN)."""
    def linear(m):
        bound = math.sqrt(6.0 / (m.in_features + m.out_features))
        m.weight.uniform_(-bound, bound, generator=generator)
        m.bias.zero_()

    return _init_(model, generator, linear, zero_adaln)
