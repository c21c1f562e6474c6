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
from e3diff_tpu_torch.utils.presets import (
    ExperimentConfig,
    add_config_flags,
    adopt_ckpt_config,
    config_from_args,
    sequence_sample_config,
)


def add_common_flags(p: argparse.ArgumentParser,
                     defaults: ExperimentConfig) -> None:
    """The flags the sampling CLIs take: one per ExperimentConfig field
    (``add_config_flags``, defaulting to the CLI's sampling preset), as
    the JAX package's sampling scripts take them, so that their command
    lines run here unchanged (the fields that do not bear on sampling, the
    training ones, are parsed and have no effect, as in JAX); then
    storage, device and data. A checkpoint's config.json sidecar overrides
    the data, width and diffusion flags that are not on the command line
    (``sampling_config``)."""
    add_config_flags(p, defaults)
    p.add_argument("--params_dtype", default="f32", choices=PARAMS_DTYPES,
                   help="weight storage (utils/params_io.py)")
    p.add_argument("--device", default="cuda")
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
    return adopt_ckpt_config(config_from_args(args), parser, ckpt_path,
                             argv=argv)[0]


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
    add_common_flags(p, sequence_sample_config())
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
