"""A (dp, tp) device mesh on ``torch.distributed`` and the Megatron-style
sharding rules of the denoisers (counterpart of
e3diff_tpu/parallel/mesh.py).

The JAX package annotates its arrays and lets XLA's SPMD partitioner
insert the collectives. Here every collective is explicit:

  dp -- data parallel: each rank holds a contiguous block of the global
        batch's rows; the trainers divide every masked mean by the GLOBAL
        count and sum the gradients over ``dp_group``;
  tp -- tensor parallel: the attention Q/K/V and the MLP up-projections
        are column-parallel (each rank holds ``out / tp`` output rows of
        the weight, so ``num_heads / tp`` heads), the projections after
        them row-parallel (``in / tp`` input columns, the partial outputs
        summed over ``tp_group``, the bias added once after the sum). The
        two autograd functions ``copy_to_tp`` (identity forward, all-reduce
        backward) and ``reduce_from_tp`` (all-reduce forward, identity
        backward) carry the gradients across.

Ranks are laid out tp-inner, as JAX's (dp, tp) device mesh is: global rank
``dp_rank * tp + tp_rank``. Each rank owns one device.

The port cannot split a head, so where JAX replicates a leaf whose
dimension does not divide by tp (mesh.py:59-60), the port replicates the
whole block (an attention block when num_heads % tp != 0, an MLP when its
width % tp != 0).
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np
import torch
import torch.distributed as dist

COL, ROW, REPLICATED = "col", "row", "replicated"

# attention blocks: HF BertAttention (attention, crossattention) and the
# SELayer's (attn); each block's Q/K/V are column-parallel, its output
# dense row-parallel (JAX: query/key/value, output_dense)
_ATTN = r"(?:\.|^)(?:attention|crossattention|attn)\."
_QKV = re.compile(_ATTN + r"self\.(?:query|key|value)\.(weight|bias|"
                  r"weight_scale)$")
_ATTN_OUT = re.compile(_ATTN + r"output\.dense\.(weight|bias|weight_scale)$")
# the BERT layer's MLP (JAX: intermediate_dense, output_dense) and the
# SELayer's (JAX: mlp_dense1, mlp_dense2)
_LAYER_MLP = re.compile(r"(.*\.layer\.\d+)\.(intermediate|output)\.dense\."
                        r"(weight|bias|weight_scale)$")
_SE_MLP = re.compile(r"((?:.*\.)?mlp)\.(0|3)\.(weight|bias|weight_scale)$")
_TABLE = re.compile(r"distance_embedding\.weight$")


def splits(n: int, tp: int) -> bool:
    """Whether a block of ``n`` heads (or an MLP ``n`` wide) is split over
    tp ranks: tp > 1 and n divisible by tp; else the block is replicated."""
    return tp > 1 and n % tp == 0


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in a (dp, tp) mesh: its coordinates, its two
    process groups (the ranks that share its tp_rank, and those that share
    its dp_rank), a gloo group over every rank for host objects
    (``cpu_group``), its device and the backend of ``dp_group`` and
    ``tp_group``."""

    dp: int
    tp: int
    dp_rank: int
    tp_rank: int
    dp_group: object
    tp_group: object
    cpu_group: object
    device: torch.device
    backend: str

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def rank(self) -> int:
        return self.dp_rank * self.tp + self.tp_rank

    @property
    def world_size(self) -> int:
        return self.dp * self.tp

    @property
    def can_capture(self) -> bool:
        """Whether the collectives can be captured in a CUDA graph: NCCL's
        can, gloo's (which stage through the host) cannot."""
        return self.backend == "nccl"

    def global_rank(self, dp_rank: int, tp_rank: int) -> int:
        return dp_rank * self.tp + tp_rank

    def rows(self, n: int) -> tuple[int, int]:
        """(offset, total) of this rank's ``n`` rows in the global batch."""
        return self.dp_rank * n, self.dp * n

    def all_reduce_dp(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Sum each tensor over ``dp_group`` (one collective over their
        concatenation); returns the sums, views of one flat buffer, in the
        tensors' shapes and dtypes (all one dtype)."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.dp_group)
        return [v.view(t.shape) for v, t in
                zip(flat.split([t.numel() for t in tensors]), tensors)]

    def all_reduce_tp_(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, group=self.tp_group)
        return t

    def gather_tp(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The tp ranks' shards of a tensor joined along ``dim``: each rank
        broadcasts its shard in turn (gloo on CUDA tensors has no
        all_gather)."""
        parts = []
        for r in range(self.tp):
            buf = t.contiguous() if r == self.tp_rank else torch.empty_like(t)
            dist.broadcast(buf, src=self.global_rank(self.dp_rank, r),
                           group=self.tp_group)
            parts.append(buf)
        return torch.cat(parts, dim=dim)

    def broadcast_object(self, obj=None):
        """Rank 0's ``obj`` on every rank (pickled, over ``cpu_group``)."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.cpu_group)
        return box[0]

    def gather_objects(self, obj) -> list | None:
        """Every rank's ``obj`` in rank order on rank 0; None elsewhere."""
        out = [None] * self.world_size if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.cpu_group)
        return out


def default_device() -> torch.device:
    """This rank's card, ``cuda:{LOCAL_RANK % device_count}``."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available; pass device='cpu' "
                           "to run the plain versions on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(dp: int | None = None, tp: int = 1, *,
              backend: str | None = None, device=None) -> Mesh:
    """The (dp, tp) mesh over the initialised default process group
    (``initialize_multihost`` or ``torch.distributed.init_process_group``
    first). dp defaults to world_size / tp, and dp * tp must equal the
    world size. ``backend``: NCCL on the card and gloo on the CPU unless
    given (several ranks on one card need "gloo": NCCL refuses them).
    ``device``: this rank's card, ``cuda:{LOCAL_RANK % device_count}``,
    unless given. Every rank must call it, in the same order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(initialize_multihost)")
    n = dist.get_world_size()
    if dp is None:
        if n % tp:
            raise ValueError(f"{n} ranks not divisible by tp={tp}")
        dp = n // tp
    if dp < 1 or tp < 1 or dp * tp != n:
        raise ValueError(f"dp*tp={dp * tp} != {n} ranks")
    device = default_device() if device is None else torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    rank = dist.get_rank()
    dp_rank, tp_rank = divmod(rank, tp)
    dp_group = tp_group = None
    # every rank creates every group, in the same order
    for t in range(tp):
        g = dist.new_group([d * tp + t for d in range(dp)], backend=backend)
        if t == tp_rank:
            dp_group = g
    for d in range(dp):
        g = dist.new_group([d * tp + t for t in range(tp)], backend=backend)
        if d == dp_rank:
            tp_group = g
    cpu_group = dist.new_group(backend="gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(dp, tp, dp_rank, tp_rank, dp_group, tp_group, cpu_group,
                device, backend)


# ---------------------------------------------------------------------------
# the tensor-parallel autograd functions
# ---------------------------------------------------------------------------

class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over the tp group in f32 (a
    bf16 partial is rounded once, as the one-device gradient is, and the
    sum adds no rounding of its own)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        total = grad.float().contiguous().clone()
        dist.all_reduce(total, group=ctx.group)
        return total.to(grad.dtype), None


class _ReduceFromTP(torch.autograd.Function):
    """The partial sums of the tp group added up; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Where a replicated tensor enters a tp-split block (before the
    column-parallel layers, and the relative-position table the split
    heads read): its gradient, a partial sum on each rank, is summed over
    ``tp_group``."""
    return _CopyToTP.apply(x, mesh.tp_group)


def reduce_from_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A row-parallel layer's partial output summed over ``tp_group``."""
    return _ReduceFromTP.apply(x, mesh.tp_group)


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

def _num_heads(state_dict: dict, num_heads: int | None) -> int | None:
    if num_heads is not None:
        return num_heads
    for k, v in state_dict.items():
        if _TABLE.search(k):
            hidden = next(state_dict[q].shape[-1] for q in state_dict
                          if _QKV.search(q) and q.endswith("query.weight"))
            return hidden // v.shape[-1]
    return None


def param_sharding_rules(state_dict: dict, mesh: Mesh,
                         num_heads: int | None = None) -> dict[str, str]:
    """Each key of a denoiser's full state_dict (or of a dict keyed by its
    parameter names) -> "col", "row" or "replicated" (the counterpart of
    JAX's PartitionSpec rules, mesh.py:49-75, on the port's HF-BERT names):

    * an attention block's ``self.{query,key,value}`` weight, bias and
      int8 ``weight_scale``: "col"; its ``output.dense.weight``: "row"
      (its bias, and an int8 scale, stay whole: "replicated");
    * a layer's ``intermediate.dense`` and an SELayer's ``mlp.0``: "col";
      the ``output.dense.weight`` after it and ``mlp.3.weight``: "row";
    * everything else (embeddings, LayerNorms, adaLN, heads, the
      distance tables, the Fourier W): "replicated".

    An attention block is split only when ``num_heads`` (inferred from a
    distance table when None) divides by tp, an MLP only when its width
    does; a block that is not split is replicated whole."""
    tp = mesh.tp
    heads = _num_heads(state_dict, num_heads) if tp > 1 else None
    if tp > 1 and heads is None:
        raise ValueError("param_sharding_rules: pass num_heads (the "
                         "state_dict has no distance table to infer it)")

    # each MLP's width, from its column layer's weight
    widths = {}
    for k, v in state_dict.items():
        part = _mlp_part(k)
        if part is not None and part[1:] == ("in", "weight"):
            widths[part[0]] = v.shape[0]

    rules = {}
    for k in state_dict:
        rule = REPLICATED
        part = _mlp_part(k)
        if tp <= 1:
            pass
        elif _QKV.search(k):
            rule = COL if splits(heads, tp) else REPLICATED
        elif (m := _ATTN_OUT.search(k)) is not None:
            rule = ROW if m.group(1) == "weight" and splits(heads, tp) \
                else REPLICATED
        elif part is not None and splits(widths[part[0]], tp):
            blk, side, leaf = part
            rule = COL if side == "in" else (ROW if leaf == "weight"
                                             else REPLICATED)
        rules[k] = rule
    return rules


def _mlp_part(key: str):
    """(block, "in" or "out", leaf) of an MLP key, else None."""
    m = _LAYER_MLP.match(key)
    if m:
        return (m.group(1), "in" if m.group(2) == "intermediate" else "out",
                m.group(3))
    m = _SE_MLP.match(key)
    if m:
        return m.group(1), "in" if m.group(2) == "0" else "out", m.group(3)
    return None


SHARD_DIM = {COL: 0, ROW: 1}   # the split axis of torch's (out, in) layout


def _rule(rules: dict[str, str], key: str) -> str:
    """A key's rule; an int8 ``weight_scale`` that the rules (of an f32
    state_dict) lack follows its weight: split with a column layer's,
    whole beside a row layer's."""
    if key in rules or not key.endswith(".weight_scale"):
        return rules[key]
    return COL if rules[key[:-len("_scale")]] == COL else REPLICATED


def shard_params(state_dict: dict, mesh: Mesh,
                 num_heads: int | None = None,
                 rules: dict[str, str] | None = None) -> dict:
    """This rank's shard of a full state_dict (the carried-across weights
    of utils/weights.py, int8 storage included: a column layer's
    ``weight_scale`` is split along the output axis with its weight, a row
    layer's kept whole), as contiguous copies on the tensors' device.
    ``rules``: the full dict's rules when known (else computed here)."""
    if rules is None:
        rules = param_sharding_rules(state_dict, mesh, num_heads)
    out = {}
    for k, v in state_dict.items():
        rule = _rule(rules, k)
        if rule == REPLICATED:
            out[k] = v
            continue
        dim = SHARD_DIM[rule]
        if v.shape[dim] % mesh.tp:
            raise ValueError(f"{k}: {tuple(v.shape)} does not split over "
                             f"tp={mesh.tp} along axis {dim}")
        out[k] = v.chunk(mesh.tp, dim=dim)[mesh.tp_rank].contiguous()
    return out


def gather_params(shard: dict, mesh: Mesh, rules: dict[str, str]) -> dict:
    """The full state_dict from every tp rank's shard, the inverse of
    ``shard_params`` (for saves). ``rules``: ``param_sharding_rules`` of
    the full dict (a model built for a mesh keeps them as
    ``sharding_rules``; a shard's own shapes cannot tell a split MLP from
    a replicated one). Every rank of the tp group must call it, and each
    gets the whole dict on its device."""
    return {k: v if _rule(rules, k) == REPLICATED
            else mesh.gather_tp(v, SHARD_DIM[_rule(rules, k)])
            for k, v in shard.items()}


@torch.no_grad()
def load_shard(model: torch.nn.Module, shard: dict) -> torch.nn.Module:
    """Load ``shard`` (this rank's, from ``shard_params``) into a model
    built for the mesh, strictly: each tensor is copied into the model's
    own, and a tensor stored in another dtype (bf16, or int8 beside its
    ``weight_scale``) replaces it, frozen, as
    utils/params_io.py::cast_inference_params stores it."""
    device = next(model.parameters()).device
    have = set(model.state_dict())
    extra = {k for k in shard if k.endswith("weight_scale")} - have
    missing = have - set(shard)
    unexpected = set(shard) - have - extra
    if missing or unexpected:
        raise KeyError(f"load_shard: missing {sorted(missing)}, unexpected "
                       f"{sorted(unexpected)}")
    for k, v in shard.items():
        mod_name, _, attr = k.rpartition(".")
        m = model.get_submodule(mod_name)
        cur = getattr(m, attr)
        v = v.to(device)
        if cur is not None and cur.dtype == v.dtype and attr != "weight_scale":
            if cur.shape != v.shape:
                raise ValueError(f"load_shard: {k} {tuple(v.shape)} into "
                                 f"{tuple(cur.shape)}")
            cur.copy_(v)
        elif attr in m._parameters:
            setattr(m, attr, torch.nn.Parameter(v.clone(),
                                                requires_grad=False))
        else:
            setattr(m, attr, v.clone())
    return model


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's contiguous dp rows of a global batch (numpy arrays or
    tensors; the host-only keys dropped) as tensors on its device. The
    rows must divide by dp."""
    from e3diff_tpu_torch.data.dataset import strip_meta

    out = {}
    for k, v in strip_meta(batch).items():
        n = v.shape[0]
        if n % mesh.dp:
            raise ValueError(f"{k}: {n} rows not divisible by dp={mesh.dp}")
        per = n // mesh.dp
        part = v[mesh.dp_rank * per:(mesh.dp_rank + 1) * per]
        if not isinstance(part, torch.Tensor):
            part = torch.from_numpy(np.ascontiguousarray(part))
        out[k] = part.to(mesh.device)
    return out
