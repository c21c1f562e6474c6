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

Each Linear and distance table reads its stored weights in the compute
dtype (``_StoredWeights``): cast, or int8 dequantized, in every call; a
sampler, whose weights stay as they are while it runs, keeps a
``WeightImage``: inside its ``frozen()`` the f32 weights of a bf16 model
are read from a compute image cast once, so that a captured decode step
casts no weight.

Built with a ``mesh`` (parallel/mesh.py), the blocks are Megatron-style
tensor parallel over its tp ranks: an attention block whose heads divide
by tp runs ``num_heads / tp`` heads per rank (column-parallel Q/K/V, a
row-parallel output dense, the distance table replicated and entered
through ``copy_to_tp`` so that its gradient is summed over the heads),
and an MLP whose width divides by tp is column- then row-parallel; a
block that does not split is replicated. Every dropout site draws the
mask of the one-device batch (the global rows, the whole width) from the
generator, which every rank seeds alike, and keeps its own block, so a
mesh step drops what the one-process step drops.
"""

from __future__ import annotations

import contextlib
import functools
import math
import operator
import threading
import weakref

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from e3diff_tpu_torch.models.config import TransformerConfig
from e3diff_tpu_torch.ops import kernels
from e3diff_tpu_torch.parallel.mesh import (
    copy_to_tp,
    reduce_from_tp,
    splits,
)
from e3diff_tpu_torch.utils import telemetry
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
    parameters, so the state_dict keys around it do not change.

    Under a ``mesh`` the uniforms are drawn at the one-device shape, the
    rows times dp (and, with ``split_cols``, the last axis times tp: the
    site sits on a column-parallel activation), and the rank keeps its
    block: dp (times tp) the draws, for the same bits."""

    def __init__(self, p: float, mesh=None, split_cols: bool = False):
        super().__init__()
        self.p = p
        self.mesh, self.split_cols = mesh, split_cols
        self.generator: torch.Generator | None = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.mesh is None:
            u = torch.rand(x.shape, generator=self.generator,
                           device=x.device)
        else:
            n, c = x.shape[0], x.shape[-1]
            r0, rows = self.mesh.rows(n)
            c0, cols = ((self.mesh.tp_rank * c, self.mesh.tp * c)
                        if self.split_cols else (0, c))
            u = torch.rand((rows,) + tuple(x.shape[1:-1]) + (cols,),
                           generator=self.generator, device=x.device)
            u = u[r0:r0 + n, ..., c0:c0 + c]
        keep = u >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


def set_dropout_generator(model: nn.Module, generator: torch.Generator):
    """Every dropout site of ``model`` (the Dropout modules and the
    attention cores) draws its keep masks from ``generator``."""
    for m in model.modules():
        if isinstance(m, (Dropout, MultiHeadAttention)):
            m.generator = generator


class _ThreadState(threading.local):
    """This thread's sampling mode (``WeightImage.frozen``) and its
    counts (``weight_reads``)."""

    frozen = False
    image_reads = 0
    weight_casts = 0


_THREAD = _ThreadState()


def weight_reads() -> tuple[int, int]:
    """This thread's counts so far: the calls of Linears and distance
    tables that read their compute image, and those that converted their
    stored weight (cast, or int8 dequantized). ``CapturedCall`` records
    what its capture adds."""
    return _THREAD.image_reads, _THREAD.weight_casts


class _StoredWeights(nn.Module):
    """The stored weights of a Linear or a distance table, read in the
    compute dtype ``dtype``.

    A call converts them from what is stored (int8 dequantized, then
    cast), as flax's Dense promotes its params. Where the weight is stored
    f32 and the compute dtype is bf16, a sampled model also keeps a
    compute image: the tensors named in ``IMAGED`` cast once by
    ``WeightImage.refresh`` (the same casts, so the same bits), held in a
    plain attribute (no parameter, buffer or state_dict key), and read
    inside ``WeightImage.frozen`` in place of the cast. bf16 storage needs
    none (its weight's cast is none), int8 storage keeps the resident
    weights int8 and dequantizes in every call, f32 compute casts
    nothing."""

    IMAGED: tuple[str, ...] = ("weight",)
    _image: tuple | None = None

    def _convert(self, mesh=None) -> tuple:
        """The compute form, converted from the stored tensors now."""
        raise NotImplementedError

    def _weights(self, mesh=None) -> tuple:
        """The compute form: the image inside ``WeightImage.frozen``, else
        ``_convert``."""
        if _THREAD.frozen and self._image is not None:
            _THREAD.image_reads += 1
            return self._image
        if self.weight_scale is not None or self.weight.dtype != self.dtype:
            _THREAD.weight_casts += 1
        return self._convert(mesh)

    def _wants_image(self) -> bool:
        return (self.dtype == torch.bfloat16 and self.weight_scale is None
                and self.weight.dtype == torch.float32)

    def _write_image(self) -> tuple:
        """Make the image anew and return its tensors (none, and the image
        dropped, where none is wanted): into the old image's storage where
        the shapes allow, so that programs captured over it read the new
        values."""
        if not self._wants_image():
            self._image = None
            return ()
        fresh, old = self._convert(), self._image
        if old is not None and all(o.shape == f.shape and o.device == f.device
                                   for o, f in zip(old, fresh)):
            for o, f in zip(old, fresh):
                o.copy_(f)
            fresh = old
        self._image = fresh
        return fresh


class WeightImage:
    """The compute images of a model's Linears and distance tables (found
    when this is made), as a sampler keeps them: ``frozen()`` around its
    captures and eager loops. Each sampler makes one
    (sampling/structure.py, sampling/sequence.py); the trainer's train and
    eval steps make none, and keep casting the f32 weights that AdamW
    updates."""

    def __init__(self, model: nn.Module):
        self.modules = [m for m in model.modules()
                        if isinstance(m, _StoredWeights)]
        # the tensors the images were last made from: weak references,
        # and their versions and addresses
        self._refs: list = []
        self._marks: list | None = None

    def refresh(self) -> None:
        """Bring the images up to date with the stored weights. Where
        none of the tensors they copy has been replaced or written in
        place (its version counter) since the last refresh, this is host
        reads alone; else every image is made again (``load_state_dict``,
        an optimizer step), into its old storage, and those no longer
        wanted (weights stored bf16 or int8 since) are dropped, inside a
        ``weights.image`` span (tensors, bytes)."""
        sources = [m._parameters[n] for m in self.modules for n in m.IMAGED]
        marks = [(t._version, t.data_ptr()) for t in sources]
        if marks == self._marks and all(
                map(operator.is_, (r() for r in self._refs), sources)):
            return
        if any(m._wants_image() or m._image is not None
               for m in self.modules):
            with torch.no_grad(), telemetry.span("weights.image") as span:
                written = [t for m in self.modules for t in m._write_image()]
                span.attrs.update(tensors=len(written),
                                  bytes=sum(t.nbytes for t in written))
        self._refs = [weakref.ref(t) for t in sources]
        self._marks = marks

    @contextlib.contextmanager
    def frozen(self):
        """Calls whose weights stay as they are, as a sampler's:
        ``refresh``, then, on this thread, each Linear and distance table
        with a compute image reads it in place of casting its weights. A
        caller that replays a sampler's captured program itself, after
        the weights changed, takes it from ``run.program(batch)`` again
        first, which refreshes."""
        self.refresh()
        was, _THREAD.frozen = _THREAD.frozen, True
        try:
            yield
        finally:
            _THREAD.frozen = was


class Linear(_StoredWeights):
    """y = x W^T + b in the compute dtype. ``weight`` is (out, in) and is
    stored f32, bf16, or int8 beside a per-output-channel ``weight_scale``;
    ``bias`` is stored f32, or bf16 in the full ``bf16`` mode
    (utils/params_io.py::cast_inference_params). Both are read in the
    compute dtype (``_StoredWeights``): cast in each call, or, inside a
    sampler's ``WeightImage.frozen``, from the compute image."""

    QUANT_AXIS = -1  # the input axis of torch's (out, in) layout
    IMAGED = ("weight", "bias")

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))
        self.register_buffer("weight_scale", None)

    def _convert(self, mesh=None):
        return (dequantize(self.weight, self.weight_scale).to(self.dtype),
                self.bias.to(self.dtype))

    def _check_trainable(self):
        if self.training and (self.weight_scale is not None
                              or self.weight.dtype != torch.float32):
            raise RuntimeError(
                f"{type(self).__name__}({self.in_features}, "
                f"{self.out_features}): weights stored as "
                f"{self.weight.dtype} for inference do not train; train f32 "
                "weights")

    def forward(self, x):
        self._check_trainable()
        w, b = self._weights()
        return F.linear(x.to(self.dtype), w, b)


class ColumnParallelLinear(Linear):
    """A Linear whose output features are split over the mesh's tp ranks:
    this rank holds ``out / tp`` rows of the weight and the bias. Its input
    must already be in the tp region (``copy_to_tp``, once per block)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, device, mesh):
        super().__init__(in_features, out_features // mesh.tp, dtype, device)


class RowParallelLinear(Linear):
    """A Linear whose input features are split over the mesh's tp ranks:
    this rank holds ``in / tp`` columns of the weight and the whole bias;
    the partial products are summed over ``tp_group`` in f32
    (``reduce_from_tp``) and the f32 bias is added once, after the sum."""

    IMAGED = ("weight",)

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, device, mesh):
        super().__init__(in_features // mesh.tp, out_features, dtype, device)
        self.mesh = mesh

    def _convert(self, mesh=None):
        return (dequantize(self.weight, self.weight_scale).to(self.dtype),)

    def forward(self, x):
        self._check_trainable()
        w, = self._weights()
        part = F.linear(x.to(self.dtype), w).float()
        y = reduce_from_tp(part, self.mesh) + self.bias.float()
        return y.to(self.dtype)


def _linear(in_features, out_features, dtype, device, mesh=None,
            parallel=None):
    """A Linear, or its column- / row-parallel form on a mesh."""
    if parallel == "col":
        return ColumnParallelLinear(in_features, out_features, dtype, device,
                                    mesh)
    if parallel == "row":
        return RowParallelLinear(in_features, out_features, dtype, device,
                                 mesh)
    return Linear(in_features, out_features, dtype, device)


class DistanceEmbedding(_StoredWeights):
    """HF relative_key distance table, (2*max_pos-1, head_dim), read in
    the compute dtype ``dtype``."""

    QUANT_AXIS = -2  # the JAX package's axis for this 2-D leaf

    def __init__(self, max_pos: int, head_dim: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(2 * max_pos - 1, head_dim, device=device))
        self.register_buffer("weight_scale", None)

    def _convert(self, mesh=None):
        w = dequantize(self.weight, self.weight_scale)
        if mesh is not None:
            w = copy_to_tp(w, mesh)
        return (w.to(self.dtype),)

    def table(self, mesh=None):
        """The table in the compute dtype; with a ``mesh``, entered into
        the tp region before the cast, so that the heads' partial
        gradients are summed over tp in f32."""
        return self._weights(mesh)[0]


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
    relative scores are added to the raw logits before the 1/sqrt(D).
    ``split``: the heads are split over the mesh's tp ranks (column-
    parallel Q/K/V, ``num_heads / tp`` heads here)."""

    def __init__(self, cfg: TransformerConfig, relative: bool, device=None,
                 mesh=None, split: bool = False):
        super().__init__()
        self.cfg, self.mesh, self.split = cfg, mesh, split
        h = cfg.hidden_size
        par = "col" if split else None
        self.query = _linear(h, h, cfg.dtype, device, mesh, par)
        self.key = _linear(h, h, cfg.dtype, device, mesh, par)
        self.value = _linear(h, h, cfg.dtype, device, mesh, par)
        self.num_heads = cfg.num_heads // mesh.tp if split else cfg.num_heads
        if relative and cfg.position_embedding_type == "relative_key":
            self.distance_embedding = DistanceEmbedding(
                cfg.max_position_embeddings, cfg.head_dim, cfg.dtype, device)
        else:
            self.distance_embedding = None
        self.generator: torch.Generator | None = None

    def _in(self, x):
        return copy_to_tp(x, self.mesh) if self.split else x

    def project_kv(self, kv):
        """K and V of a memory, flat (B, Lk, H*D) each (this rank's heads
        under a split)."""
        kv = self._in(kv)
        return self.key(kv), self.value(kv)

    def _dropout_block(self, b: int):
        if self.mesh is None:
            return None
        r0, rows = self.mesh.rows(b)
        if self.split:
            return (r0, rows, self.mesh.tp_rank * self.num_heads,
                    self.cfg.num_heads)
        return r0, rows, 0, self.num_heads

    def forward(self, x, kv, mask_add, cached_kv=None):
        xin = self._in(x)
        if cached_kv is not None:
            k, v = cached_kv
        elif kv is x:
            k, v = self.key(xin), self.value(xin)
        else:
            k, v = self.project_kv(kv)
        table = None
        if self.distance_embedding is not None:
            table = self.distance_embedding.table(
                self.mesh if self.split else None)
        return kernels.attention(
            self.query(xin), k, v, mask_add, table,
            num_heads=self.num_heads,
            max_pos=self.cfg.max_position_embeddings,
            dropout_p=self.cfg.attention_dropout if self.training else 0.0,
            generator=self.generator,
            dropout_block=self._dropout_block(x.shape[0]))


class AttentionBlock(nn.Module):
    """BertAttention: attention + output dense + residual LayerNorm.
    Cross-attention never takes relative scores (HF builds it absolute).
    On a mesh whose tp divides num_heads the heads are split and the
    output dense is row-parallel."""

    def __init__(self, cfg: TransformerConfig, cross: bool, device=None,
                 mesh=None):
        super().__init__()
        h = cfg.hidden_size
        split = mesh is not None and splits(cfg.num_heads, mesh.tp)
        self.self = MultiHeadAttention(cfg, relative=not cross, device=device,
                                       mesh=mesh, split=split)
        self.output = nn.ModuleDict({
            "dense": _linear(h, h, cfg.dtype, device, mesh,
                             "row" if split else None),
            "LayerNorm": LayerNorm(h, cfg.layer_norm_eps, device=device),
        })
        self.dropout = Dropout(cfg.dropout, mesh)

    def forward(self, x, kv, mask_add, cached_kv=None):
        ctx = self.self(x, x if kv is None and cached_kv is None else kv,
                        mask_add, cached_kv)
        return self.output["LayerNorm"](
            self.dropout(self.output["dense"](ctx)), residual=x)


class TransformerLayer(nn.Module):
    """BertLayer: self-attention [+ cross-attention] + GELU MLP, each closed
    by residual + LayerNorm. On a mesh whose tp divides the MLP's width
    the MLP is column- then row-parallel."""

    def __init__(self, cfg: TransformerConfig, device=None, mesh=None):
        super().__init__()
        h = cfg.hidden_size
        self.attention = AttentionBlock(cfg, cross=False, device=device,
                                        mesh=mesh)
        self.crossattention = (AttentionBlock(cfg, cross=True, device=device,
                                              mesh=mesh)
                               if cfg.add_cross_attention else None)
        self.mesh = mesh
        self.split = mesh is not None and splits(cfg.intermediate_size,
                                                 mesh.tp)
        self.intermediate = nn.ModuleDict({
            "dense": _linear(h, cfg.intermediate_size, cfg.dtype, device,
                             mesh, "col" if self.split else None)})
        self.output = nn.ModuleDict({
            "dense": _linear(cfg.intermediate_size, h, cfg.dtype, device,
                             mesh, "row" if self.split else None),
            "LayerNorm": LayerNorm(h, cfg.layer_norm_eps, device=device),
        })
        self.dropout = Dropout(cfg.dropout, mesh)

    def forward(self, x, mask_add, enc_out=None, enc_mask_add=None,
                cross_kv=None):
        x = self.attention(x, None, mask_add)
        if self.crossattention is not None and (enc_out is not None
                                                or cross_kv is not None):
            x = self.crossattention(x, enc_out, enc_mask_add, cross_kv)
        y = F.gelu(self.intermediate["dense"](
            copy_to_tp(x, self.mesh) if self.split else x))
        return self.output["LayerNorm"](
            self.dropout(self.output["dense"](y)), residual=x)


# the GEMMs whose outputs ``remat="dots"`` saves (F.linear dispatches to
# mm / addmm, the CPU plain attention's einsums to bmm)
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default)
REMAT_POLICIES = ("none", "layer", "dots")


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _layer_generators(layer: nn.Module) -> list[torch.Generator]:
    """The generators that ``layer``'s dropout sites draw from: the ones
    ``set_dropout_generator`` handed them, or the default generator of the
    layer's device where a site has none."""
    device = next(layer.parameters()).device
    default = (torch.cuda.default_generators[
        device.index if device.index is not None
        else torch.cuda.current_device()]
        if device.type == "cuda" else torch.default_generator)
    gens = []
    for m in layer.modules():
        if isinstance(m, (Dropout, MultiHeadAttention)):
            g = default if m.generator is None else m.generator
            if all(g is not h for h in gens):
                gens.append(g)
    return gens


def _remat_contexts(layer: nn.Module, policy: str):
    """The (forward, recompute) contexts of one checkpointed layer call.
    The forward's saves the state of every generator the layer draws from;
    the recompute's sets each back to it, so that the recomputed layer
    draws the dropout uniforms and attention seeds its forward drew, and
    then returns each generator to where the backward found it, so that
    the rest of the step draws what it draws without remat.
    torch.utils.checkpoint's own ``preserve_rng_state`` covers only the
    default generators, and the trainer's is not one of them. On the card
    ``get_state`` / ``set_state`` of a CUDA generator registered with a
    CUDA graph being captured read and set its position inside the graph
    (``clone_state`` cannot run during a capture). ``dots`` adds
    torch's selective-checkpoint contexts, which keep the GEMM outputs."""
    gens = _layer_generators(layer)
    saved: list[torch.Tensor] = []

    @contextlib.contextmanager
    def forward():
        saved[:] = [g.get_state() for g in gens]
        yield

    @contextlib.contextmanager
    def recompute():
        now = [g.get_state() for g in gens]
        for g, state in zip(gens, saved):
            g.set_state(state)
        try:
            yield
        finally:
            for g, state in zip(gens, now):
                g.set_state(state)

    if policy == "layer":
        return forward(), recompute()
    sac_forward, sac_recompute = create_selective_checkpoint_contexts(
        _save_dots)
    return (_both(forward(), sac_forward), _both(recompute(), sac_recompute))


@contextlib.contextmanager
def _both(a, b):
    with a, b:
        yield


class TransformerStack(nn.Module):
    """BertEncoder: ``layer.{i}``.

    With ``cfg.remat`` other than "none", each layer of a training
    forward (train mode, grad enabled) is checkpointed, as the JAX
    package wraps it in ``nn.remat`` (e3diff_tpu/models/blocks.py:267-337):
    the backward runs the layer's forward again (its attention and
    LayerNorm kernels launched a second time) with the dropout draws its
    first forward made (``_remat_contexts``). "layer" keeps the layer's
    inputs alone; "dots" keeps the GEMM outputs too, through a
    selective-checkpoint policy on aten mm / addmm / bmm. The port's
    attention and LayerNorm kernels launch through ctypes inside
    autograd Functions, where the dispatcher sees only their output
    allocations, so "dots" recomputes them; the JAX package's shipped
    attention is XLA einsums, whose products ``checkpoint_dots`` keeps.
    The numbers are the same either way. Samplers, eval and serving run
    without grad, where remat changes nothing. On a mesh, a recomputed
    tp layer issues its forward all-reduces again, as Megatron's
    recompute does."""

    def __init__(self, cfg: TransformerConfig, device=None, mesh=None):
        super().__init__()
        if cfg.remat not in REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {cfg.remat!r}: one of "
                             f"{REMAT_POLICIES}")
        self.remat = cfg.remat
        self.layer = nn.ModuleList(TransformerLayer(cfg, device, mesh)
                                   for _ in range(cfg.num_layers))

    def precompute_cross_kv(self, enc_out):
        """Each layer's cross-attention (K, V) over a memory, flat
        (B, Lk, H*D) (this rank's heads under a split): samplers compute
        them once per batch."""
        return [layer.crossattention.self.project_kv(enc_out)
                for layer in self.layer]

    def forward(self, x, mask_add, enc_out=None, enc_mask_add=None,
                cross_kv=None):
        remat = (self.remat if self.training and torch.is_grad_enabled()
                 else "none")
        for i, layer in enumerate(self.layer):
            kv = None if cross_kv is None else cross_kv[i]
            if remat == "none":
                x = layer(x, mask_add, enc_out, enc_mask_add, kv)
            else:
                x = checkpoint(
                    layer, x, mask_add, enc_out, enc_mask_add, kv,
                    use_reentrant=False, preserve_rng_state=False,
                    context_fn=functools.partial(_remat_contexts, layer,
                                                 remat))
        return x


class SELayer(nn.Module):
    """DiT-style adaLN block (reference SELayer). The FIRST adaLN Linear
    (``adaLN_modulation.0``) is the zero-initialised one; norm1/norm2 are
    affine-free with eps 1e-5; the MLP is mlp_ratio * hidden = 3072 wide,
    not intermediate_size."""

    def __init__(self, cfg: TransformerConfig, device=None, mesh=None):
        super().__init__()
        h = cfg.hidden_size
        mlp_dim = int(h * cfg.mlp_ratio)
        self.adaLN_modulation = nn.Sequential(
            Linear(h, h, cfg.dtype, device), nn.SiLU(),
            Linear(h, 6 * h, cfg.dtype, device))
        self.attn = AttentionBlock(cfg, cross=False, device=device, mesh=mesh)
        self.norm1 = LayerNorm(h, 1e-5, affine=False)
        self.mesh = mesh
        self.split = mesh is not None and splits(mlp_dim, mesh.tp)
        # Linears at indices 0 and 3 as in the reference (1: GELU, 2 and
        # 4: dropout, JAX blocks.py:393, :395); on a mesh the first
        # dropout sits on the column-parallel activation
        self.mlp = nn.Sequential(
            _linear(h, mlp_dim, cfg.dtype, device, mesh,
                    "col" if self.split else None), nn.GELU(),
            Dropout(cfg.dropout, mesh, split_cols=self.split),
            _linear(mlp_dim, h, cfg.dtype, device, mesh,
                    "row" if self.split else None),
            Dropout(cfg.dropout, mesh))
        self.norm2 = LayerNorm(h, 1e-5, affine=False)

    def forward(self, x, c, mask_add):
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
         gate_mlp) = self.adaLN_modulation(c).chunk(6, dim=-1)
        attn_out = self.attn(x, None, mask_add)
        x = x + gate_msa * (self.norm1(attn_out) * (1 + scale_msa) + shift_msa)
        y = self.mlp(copy_to_tp(x, self.mesh) if self.split else x)
        return x + gate_mlp * (self.norm2(y) * (1 + scale_mlp) + shift_mlp)


class GaussianFourierProjection(nn.Module):
    """Fixed random Fourier features of the timestep; W ~ N(0, (2 pi)^2).

    The timestep is cast to the compute dtype first, as in the JAX package
    (blocks.py:416): in bf16, t = 999 becomes 1000. W is f32 in every
    storage mode but full ``bf16``, so t * W * 2 pi and sin/cos are then f32
    by promotion; with W stored bf16 and bf16 compute they are bf16, in
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

    def __init__(self, cfg: TransformerConfig, in_features: int, device=None,
                 mesh=None):
        super().__init__()
        self.linear = Linear(in_features, cfg.hidden_size, cfg.dtype, device)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                   device=device)
        self.dropout = Dropout(cfg.dropout, mesh)

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
def shard_init(model: nn.Module, mesh, build, seed: int | None):
    """For a model built on a ``mesh``: its sharding rules (the
    ``param_sharding_rules`` of the one-device model's state_dict, read
    off ``build("meta", None)``), and, with a ``seed``, the one-device
    model's seeded weights (``build(device, seed)``) cut to this rank's
    shard and loaded. None without a mesh."""
    if mesh is None:
        return None
    from e3diff_tpu_torch.parallel.mesh import (
        load_shard,
        param_sharding_rules,
        shard_params,
    )

    full = build("meta", None)
    rules = param_sharding_rules(full.state_dict(), mesh,
                                 full.encoder_config.num_heads)
    if seed is not None:
        full = build(mesh.device, seed)
        load_shard(model, shard_params(full.state_dict(), mesh, rules=rules))
    return rules


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
