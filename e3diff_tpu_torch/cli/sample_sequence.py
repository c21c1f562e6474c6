"""Inverse-fold test complexes with the sequence D3PM on the card
(counterpart of scripts/sample_sequence.py; sequence_model/sample.py:
BLOSUM transition, native backbone angles). Writes the results dict
(structure_ids, true_sequence, predict_sequence, recovery_rate) as a
pickle.

Example:
    python -m e3diff_tpu_torch.cli.sample_sequence --synthetic \\
        --params_dtype int8_matmul --output data/seq_output.pkl
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from e3diff_tpu_torch.utils.params_io import PARAMS_DTYPES


def add_common_flags(p: argparse.ArgumentParser, *, max_seq_len: int,
                    timesteps: int, num_hidden_layers: int) -> None:
    """The flags the sampling CLIs take: data, model widths, storage,
    device and seed. A checkpoint's config.json sidecar overrides the
    data, width and diffusion flags that are not on the command line
    (``sampling_config``)."""
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--max_seq_len", type=int, default=max_seq_len)
    p.add_argument("--ligand_max_len", type=int, default=None)
    p.add_argument("--pocket_ext", type=int, default=0)
    p.add_argument("--timesteps", type=int, default=timesteps)
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--num_heads", type=int, default=12)
    p.add_argument("--num_hidden_layers", type=int, default=num_hidden_layers)
    p.add_argument("--intermediate_size", type=int, default=1024)
    p.add_argument("--position_embedding_type", default="relative_key",
                   choices=["relative_key", "absolute"])
    p.add_argument("--bf16", type=int, choices=[0, 1], default=1,
                   help="bf16 compute (1) or f32 (0)")
    p.add_argument("--params_dtype", default="f32", choices=PARAMS_DTYPES,
                   help="weight storage (utils/params_io.py)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true",
                   help="use 32 synthetic complexes")
    p.add_argument("--data_file", default=None,
                   help="complex file (.pt or .pkl); optional with --synthetic")


def load_test_data(args, cfg):
    """The test split of --data_file or of the synthetic complexes, at
    cfg's data shapes."""
    from e3diff_tpu_torch.data import (
        LigandBindingSiteData,
        load_complexes,
        synthetic_complexes,
    )

    complexes = (synthetic_complexes(n=32) if args.synthetic
                 else load_complexes(args.data_file))
    test_ds = LigandBindingSiteData(complexes, "test", cfg.max_seq_len,
                                    cfg.pocket_ext, cfg.ligand_max_len)
    print(f"test={len(test_ds)} complexes")
    return test_ds


def sampling_config(args, parser, ckpt_path, argv):
    """The flags' ExperimentConfig, with the fields of ``ckpt_path``'s
    config.json sidecar adopted where their flag is not in ``argv``
    (``adopt_ckpt_config``, as the JAX package's sampling scripts do)."""
    from e3diff_tpu_torch.utils.presets import (
        ExperimentConfig,
        adopt_ckpt_config,
    )

    fields = ("pocket_ext", "max_seq_len", "ligand_max_len", "timesteps",
              "num_heads", "hidden_size", "num_hidden_layers",
              "intermediate_size", "position_embedding_type", "batch_size",
              "seed")
    cfg = ExperimentConfig(**{k: getattr(args, k) for k in fields},
                           bf16=bool(args.bf16))
    return adopt_ckpt_config(cfg, parser, ckpt_path, argv=argv)[0]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--ckpt", default=None,
                   help="reference-layout PeptideDiff .pt state_dict; "
                        "random weights from --seed when absent")
    p.add_argument("--output", default="./data/seq_output.pkl")
    p.add_argument("--transition", default="blosum",
                   choices=["blosum", "uniform"])
    p.add_argument("--greedy", action="store_true",
                   help="argmax instead of categorical (diverse) draws")
    p.add_argument("--skip_steps", type=int, default=None,
                   help="run the reverse loop over N evenly spaced steps "
                        "instead of all T (not in the reference)")
    p.add_argument("--guidance_scale", type=float, default=1.0,
                   help="classifier-free guidance on the logits (1 = off)")
    # the reference's sampling config (sequence_model/sample.py:28-50)
    add_common_flags(p, max_seq_len=64, timesteps=50, num_hidden_layers=6)
    return p


def main(argv=None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.synthetic and not args.data_file:
        raise SystemExit("--data_file is required unless --synthetic")

    from e3diff_tpu_torch.sampling import sample_sequence_batches
    from e3diff_tpu_torch.utils.builders import (
        build_sequence_diffusion,
        build_sequence_model,
    )
    from e3diff_tpu_torch.utils.device import resolve_device
    from e3diff_tpu_torch.utils.params_io import (
        cast_inference_params,
        load_sequence_checkpoint,
    )

    device = resolve_device(args.device)
    cfg = sampling_config(args, parser, args.ckpt, argv)
    test_ds = load_test_data(args, cfg)
    model = build_sequence_model(cfg, device=device,
                                 seed=None if args.ckpt else cfg.seed)
    if args.ckpt:
        load_sequence_checkpoint(args.ckpt, model, cfg.timesteps)
    cast_inference_params(model, args.params_dtype)
    d3pm = build_sequence_diffusion(cfg, args.transition, device=device)

    results = sample_sequence_batches(
        model, d3pm, test_ds.batches(cfg.batch_size), device=device,
        seed=cfg.seed, diverse=not args.greedy, n_steps=args.skip_steps,
        guidance_scale=args.guidance_scale)
    print(f"mean recovery rate: {np.mean(results['recovery_rate']):.4f}")

    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "wb") as f:
        pickle.dump(results, f)
    print(f"wrote {len(results['recovery_rate'])} results to {args.output}")
    return results


if __name__ == "__main__":
    main()
