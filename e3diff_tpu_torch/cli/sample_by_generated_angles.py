"""Inverse-fold on GENERATED backbone angles with the sequence D3PM on the
card (counterpart of scripts/sample_by_generated_angles.py;
sequence_model/sample_by_generated_angles.py in the reference): the tail
of the end-to-end flow, with the uniform transition and the ligand angles
of cli/sample_structure.py's output in place of the native ones. Writes
the results dict (structure_ids, true_sequence, predict_sequence,
recovery_rate) as a pickle.

The checkpoint's config.json sidecar sets every width, data and diffusion
flag not given on the command line. With fewer generated samples than
test complexes, only the batches the supply covers run, the last one's
valid rows clamped to the remainder.

Example:
    python -m e3diff_tpu_torch.cli.sample_by_generated_angles \\
        --data_file data/biolip.pkl --ckpt runs/sequence/final.pt \\
        --generated data/output.pkl
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from e3diff_tpu_torch.utils.params_io import PARAMS_DTYPES
from e3diff_tpu_torch.utils.presets import (
    add_config_flags,
    adopt_ckpt_config,
    config_from_args,
    sequence_sample_config,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data_file", default=None,
                   help="complex file (.pt or .pkl); optional with "
                        "--synthetic")
    p.add_argument("--ckpt", required=True,
                   help="reference-layout PeptideDiff .pt state_dict")
    p.add_argument("--generated", default="./data/output.pkl")
    p.add_argument("--output",
                   default="./data/from_generated_angles/output.pkl")
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--params_dtype", choices=PARAMS_DTYPES, default="f32",
                   help="weight storage (utils/params_io.py)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda")
    add_config_flags(p, sequence_sample_config())
    return p


def generated_batches(test_ds, generated: list, batch_size: int):
    """(batches, generated angle batches) for a supply of generated
    samples: every batch of ``test_ds``, or, when the supply is short, the
    batches it covers with the last one's ``num_valid`` clamped to the
    remainder (its uncovered rows get zero angles and drop out of the
    results like padded rows)."""
    from e3diff_tpu_torch.sampling.pipeline import _pad_generated

    batches = list(test_ds.batches(batch_size))
    n_needed = sum(int(b["num_valid"]) for b in batches)
    if len(generated) < n_needed:
        keep = max(1, -(-len(generated) // batch_size))
        batches = batches[:keep]
        covered = 0
        for b in batches:
            valid = min(int(b["num_valid"]), len(generated) - covered)
            b["num_valid"] = np.int32(valid)
            covered += valid
        print(f"only {len(generated)} generated samples; restricting to "
              f"{len(batches)} batches ({covered} designs)")
    return batches, _pad_generated(generated, test_ds.ligand_max_len,
                                   batches)


def main(argv=None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.synthetic and not args.data_file:
        parser.error("--data_file is required unless --synthetic")
    cfg = config_from_args(args)
    cfg, _ = adopt_ckpt_config(cfg, parser, args.ckpt, argv=argv)

    from e3diff_tpu_torch.cli.sample_sequence import load_test_data
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
    test_ds = load_test_data(args, cfg)
    with open(args.generated, "rb") as f:
        generated = pickle.load(f)
    # trajectory-shaped samples -> their final step
    generated = [np.asarray(g)[-1] if np.asarray(g).ndim == 3
                 else np.asarray(g) for g in generated]
    batches, gen_batches = generated_batches(test_ds, generated,
                                             cfg.batch_size)

    model = build_sequence_model(cfg, device=device)
    load_sequence_checkpoint(args.ckpt, model, cfg.timesteps)
    cast_inference_params(model, args.params_dtype)
    d3pm = build_sequence_diffusion(cfg, "uniform", device=device)
    results = sample_sequence_batches(
        model, d3pm, batches, device=device, seed=cfg.seed,
        diverse=not args.greedy, generated_angles=gen_batches)
    print(f"mean recovery rate: {np.mean(results['recovery_rate']):.4f}")

    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "wb") as f:
        pickle.dump(results, f)
    print(f"wrote {len(results['recovery_rate'])} results to {args.output}")
    return results


if __name__ == "__main__":
    main()
