"""The program's models built from a configuration file, holding the
weights that the benchmark makes from the seed
(benchmark/reference/nets.py::make_weights), so that the program and the
reference compute with the same values; the drivers build the rest of
the system under test around them."""

from __future__ import annotations

import torch

from benchmark.reference import nets


def reference_cfg(conf: dict, part: str) -> dict:
    """The sizes of one model of a configuration file (``part``: the
    top-level group, "structure" or "sequence")."""
    return {**conf[part], "num_heads": conf[part]["num_attention_heads"]}


def experiment(conf: dict, part: str):
    from e3diff_tpu_torch.utils.presets import ExperimentConfig

    m = conf[part]
    return ExperimentConfig(
        pocket_ext=m["pocket_ext"], max_seq_len=m["max_seq_len"],
        timesteps=m["timesteps"], num_heads=m["num_attention_heads"],
        hidden_size=m["hidden_size"],
        num_hidden_layers=m["num_hidden_layers"],
        intermediate_size=m["intermediate_size"],
        position_embedding_type=m["position_embedding_type"],
        dropout_p=m["dropout_p"], bf16=conf["compute_dtype"] == "bf16")


def weights(conf: dict, part: str, seed: int, device) -> dict:
    cfg = reference_cfg(conf, part)
    shapes = (nets.structure_shapes(cfg) if part == "structure"
              else nets.sequence_shapes(cfg))
    return nets.make_weights(shapes, seed, device)


def structure_model(cfg, w: dict, device):
    from e3diff_tpu_torch.utils import builders

    model = builders.build_structure_model(cfg, device=device, seed=None)
    model.load_state_dict(w, strict=True)
    return model


def sequence_model(cfg, w: dict, device):
    from e3diff_tpu_torch.utils import builders

    model = builders.build_sequence_model(cfg, device=device, seed=None)
    model.load_state_dict(w, strict=True)
    return model


def store(model, params_dtype: str) -> None:
    """The program's weight storage (its int8 path is the control)."""
    from e3diff_tpu_torch.utils.params_io import cast_inference_params

    cast_inference_params(model, params_dtype)


def free() -> None:
    """Release the program's device memory before the reference runs."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
