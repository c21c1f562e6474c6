"""Sample backbone angles with the structure DDPM on the card (counterpart
of scripts/sample_structure.py). Writes the trajectory pickle layout of
the reference's output.pkl: a list of per-peptide arrays, (T, len_i, 8)
or, with --no_trajectory, (len_i, 8).

Example:
    python -m e3diff_tpu_torch.cli.sample_structure --synthetic \\
        --sampler ddim --ddim_steps 25 --params_dtype int8_matmul \\
        --output data/output.pkl
"""

from __future__ import annotations

import argparse
import os
import pickle

from e3diff_tpu_torch.cli.sample_sequence import (
    add_common_flags,
    load_test_data,
    sampling_config,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--ckpt", default=None,
                   help="reference-layout .pt state_dict; random weights "
                        "from --seed when absent. Its config.json sidecar, "
                        "where there is one, sets every width, data and "
                        "diffusion flag not given here")
    p.add_argument("--output", default="./data/output.pkl")
    p.add_argument("--sampler", choices=["ddpm", "ddim"], default="ddpm")
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--ddim_eta", type=float, default=1.0)
    p.add_argument("--step", type=int, default=1,
                   help="DDPM stride through the timesteps (a lossy skip)")
    p.add_argument("--guidance_scale", type=float, default=1.0)
    p.add_argument("--all_batches", action="store_true",
                   help="disable the reference's first-batch-only quirk (Q5)")
    p.add_argument("--no_trajectory", action="store_true")
    # the reference's sampling config (structure_model/sample.py:20-41)
    add_common_flags(p, max_seq_len=64, timesteps=1000, num_hidden_layers=12)
    return p


def main(argv=None) -> list:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.synthetic and not args.data_file:
        raise SystemExit("--data_file is required unless --synthetic")

    from e3diff_tpu_torch.diffusion import GaussianAngleDiffusion
    from e3diff_tpu_torch.models import StructureDenoiser
    from e3diff_tpu_torch.sampling import sample_structure_batches
    from e3diff_tpu_torch.utils.device import resolve_device
    from e3diff_tpu_torch.utils.params_io import (
        cast_inference_params,
        load_structure_checkpoint,
    )
    from e3diff_tpu_torch.utils.presets import transformer_configs

    device = resolve_device(args.device)
    cfg = sampling_config(args, parser, args.ckpt, argv)
    test_ds = load_test_data(args, cfg)
    model = StructureDenoiser(*transformer_configs(cfg, "torch_default"),
                              device=device,
                              seed=None if args.ckpt else cfg.seed)
    if args.ckpt:
        load_structure_checkpoint(args.ckpt, model)
    cast_inference_params(model, args.params_dtype)
    diffusion = GaussianAngleDiffusion.cosine(cfg.timesteps, device=device)

    results = sample_structure_batches(
        model, diffusion, test_ds.batches(cfg.batch_size), device=device,
        seed=cfg.seed, step=args.step, first_batch_only=not args.all_batches,
        return_trajectory=not args.no_trajectory, sampler=args.sampler,
        ddim_steps=args.ddim_steps, ddim_eta=args.ddim_eta,
        guidance_scale=args.guidance_scale)

    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "wb") as f:
        pickle.dump(results, f)
    print(f"wrote {len(results)} samples to {args.output}")
    return results


if __name__ == "__main__":
    main()
