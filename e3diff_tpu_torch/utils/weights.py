"""JAX parameter trees -> the port's state_dict (the port's own copy of
e3diff_tpu/utils/torch_port.py::export_structure_state_dict and the live
part of ::export_sequence_state_dict).

Input: a StructureDenoiser or SequenceDenoiser flax parameter tree with
numpy (or array-like) leaves, its transformer stacks in the per-layer
layout (``layer_{i}``) or the scan layout (``layers/layer`` with a leading
layer axis, which is unstacked here as
e3diff_tpu/models/restack.py::params_from_scan does). Output: a
state_dict in the reference HF-BERT layout, which the port's modules carry,
for ``load_state_dict(strict=True)``. flax Dense kernels are (in, out) and
become torch (out, in) weights; LayerNorm ``scale`` becomes ``weight``;
Embed ``embedding`` becomes ``weight``.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    # a copy: a JAX array's numpy view is read-only
    return torch.from_numpy(np.array(x, np.float32, order="C"))


def _lin(tree, p, out):
    out[f"{p}.weight"] = _t(np.asarray(tree["kernel"], np.float32).T)
    out[f"{p}.bias"] = _t(tree["bias"])


def _ln(tree, p, out):
    out[f"{p}.weight"] = _t(tree["scale"])
    out[f"{p}.bias"] = _t(tree["bias"])


def _feature_embedding(tree, p, out):
    _lin(tree["linear"], f"{p}.linear", out)
    _ln(tree["norm"], f"{p}.LayerNorm", out)


def _attention_block(tree, p, out):
    for name in ("query", "key", "value"):
        _lin(tree["self"][name], f"{p}.self.{name}", out)
    if "distance_embedding" in tree["self"]:
        out[f"{p}.self.distance_embedding.weight"] = _t(
            tree["self"]["distance_embedding"]["embedding"])
    _lin(tree["output_dense"], f"{p}.output.dense", out)
    _ln(tree["output_norm"], f"{p}.output.LayerNorm", out)


def _selayer(tree, p, out):
    _lin(tree["adaln_0"], f"{p}.adaLN_modulation.0", out)
    _lin(tree["adaln_1"], f"{p}.adaLN_modulation.2", out)
    _attention_block(tree["attn"], f"{p}.attn", out)
    _lin(tree["mlp_dense1"], f"{p}.mlp.0", out)
    _lin(tree["mlp_dense2"], f"{p}.mlp.3", out)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layers(tree) -> dict:
    """A stack's layer subtrees by index, from either layout."""
    if set(tree) == {"layers"}:
        stacked = tree["layers"]["layer"]
        leaf = stacked
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        return {i: _map(lambda x, i=i: np.asarray(x)[i], stacked)
                for i in range(np.shape(leaf)[0])}
    return {int(name.rsplit("_", 1)[1]): layer for name, layer in tree.items()}


def _transformer_stack(tree, p, out):
    for i, layer in sorted(_layers(tree).items()):
        base = f"{p}.layer.{i}"
        _attention_block(layer["attention"], f"{base}.attention", out)
        if "crossattention" in layer:
            _attention_block(layer["crossattention"],
                             f"{base}.crossattention", out)
        _lin(layer["intermediate_dense"], f"{base}.intermediate.dense", out)
        _lin(layer["output_dense"], f"{base}.output.dense", out)
        _ln(layer["output_norm"], f"{base}.output.LayerNorm", out)


def _mlp_head(tree, p, out):
    _lin(tree["dense1"], f"{p}.dense1", out)
    _ln(tree["norm"], f"{p}.layer_norm", out)
    _lin(tree["dense2"], f"{p}.dense2", out)


def structure_state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """StructureDenoiser flax params -> the port's (reference-layout)
    state_dict of CPU float32 tensors."""
    out: dict[str, torch.Tensor] = {}
    _feature_embedding(params["receptor_seq_emb"], "receptor_seq_emb", out)
    _feature_embedding(params["receptor_angle_emb"], "receptor_angle_emb", out)
    _selayer(params["receptor_emb"], "receptor_emb", out)
    _transformer_stack(params["encoder"], "encoder", out)
    _feature_embedding(params["ligand_angle_emb"], "ligand_angle_emb", out)
    out["timestep_projector.W"] = _t(params["timestep_projector"]["W"])
    _selayer(params["timestep_emb"], "timestep_emb", out)
    _transformer_stack(params["decoder"], "decoder", out)
    _mlp_head(params["angles_predictor"], "angles_predictor", out)
    return out


def sequence_state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """SequenceDenoiser flax params -> the port's (reference PeptideDiff
    layout) state_dict of CPU float32 tensors: the live weights only, not
    the dead ``receptor_feature_emb`` (Q7) nor the schedule's betas
    buffer that a reference checkpoint also carries."""
    out: dict[str, torch.Tensor] = {}
    out["timestep_projector.W"] = _t(params["timestep_projector"]["W"])
    for name in ("ligand_seq_embedding", "ligand_angle_embedding",
                 "receptor_seq_embedding", "receptor_angle_embedding"):
        _feature_embedding(params[name], name, out)
    _selayer(params["ligand_feature_emb"], "ligand_feature_emb", out)
    _transformer_stack(params["decoder"], "decoder", out)
    _selayer(params["decoder_normalize"], "decoder_normalize", out)
    _mlp_head(params["amino_acid_predictor"], "amino_acid_predictor", out)
    return out
