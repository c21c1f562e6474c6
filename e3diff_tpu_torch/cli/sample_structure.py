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

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data_file", default=None,
                   help="complex file (.pt or .pkl); optional with --synthetic")
    p.add_argument("--synthetic", action="store_true",
                   help="sample 32 synthetic complexes instead")
    p.add_argument("--ckpt", default=None,
                   help="reference-layout .pt state_dict; random weights "
                        "from --seed when absent")
    p.add_argument("--output", default="./data/output.pkl")
    p.add_argument("--sampler", choices=["ddpm", "ddim"], default="ddpm")
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--ddim_eta", type=float, default=1.0)
    p.add_argument("--step", type=int, default=1,
                   help="DDPM stride through the timesteps (a lossy skip)")
    p.add_argument("--guidance_scale", type=float, default=1.0)
    p.add_argument("--params_dtype", default="f32",
                   choices=["f32", "bf16_matmul", "int8_matmul"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--all_batches", action="store_true",
                   help="disable the reference's first-batch-only quirk (Q5)")
    p.add_argument("--no_trajectory", action="store_true")
    # the reference's sampling config (structure_model/sample.py:20-41)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--max_seq_len", type=int, default=64)
    p.add_argument("--ligand_max_len", type=int, default=None)
    p.add_argument("--pocket_ext", type=int, default=0)
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--num_heads", type=int, default=12)
    p.add_argument("--num_hidden_layers", type=int, default=12)
    p.add_argument("--intermediate_size", type=int, default=1024)
    p.add_argument("--bf16", type=int, choices=[0, 1], default=1,
                   help="bf16 compute (1) or f32 (0)")
    return p


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    if not args.synthetic and not args.data_file:
        raise SystemExit("--data_file is required unless --synthetic")

    from e3diff_tpu_torch.data import (
        LigandBindingSiteData,
        load_complexes,
        synthetic_complexes,
    )
    from e3diff_tpu_torch.diffusion import GaussianAngleDiffusion
    from e3diff_tpu_torch.models import StructureDenoiser, TransformerConfig
    from e3diff_tpu_torch.sampling import sample_structure_batches
    from e3diff_tpu_torch.utils.device import resolve_device
    from e3diff_tpu_torch.utils.params_io import (
        cast_inference_params,
        load_structure_checkpoint,
    )

    device = resolve_device(args.device)
    complexes = (synthetic_complexes(n=32) if args.synthetic
                 else load_complexes(args.data_file))
    test_ds = LigandBindingSiteData(complexes, "test", args.max_seq_len,
                                    args.pocket_ext, args.ligand_max_len)
    print(f"test={len(test_ds)} complexes")

    base = dict(hidden_size=args.hidden_size, num_heads=args.num_heads,
                num_layers=args.num_hidden_layers,
                intermediate_size=args.intermediate_size,
                max_position_embeddings=args.max_seq_len,
                dtype=torch.bfloat16 if args.bf16 else torch.float32)
    model = StructureDenoiser(
        TransformerConfig(**base),
        TransformerConfig(**base, add_cross_attention=True),
        device=device, seed=None if args.ckpt else args.seed)
    if args.ckpt:
        load_structure_checkpoint(args.ckpt, model)
    cast_inference_params(model, args.params_dtype)
    diffusion = GaussianAngleDiffusion.cosine(args.timesteps, device=device)

    results = sample_structure_batches(
        model, diffusion, test_ds.batches(args.batch_size), device=device,
        seed=args.seed, step=args.step, first_batch_only=not args.all_batches,
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
