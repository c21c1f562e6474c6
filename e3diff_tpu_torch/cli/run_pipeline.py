"""End-to-end pipeline on the card: sample angles -> NERF PDBs -> inverse
fold (counterpart of scripts/run_pipeline.py; the reference's structure
sample -> create_pdb -> sample_by_generated_angles flow as one command).
Writes ``OUTDIR/pdbs/generated_{i}.pdb`` and ``OUTDIR/results.pkl``.

Example:
    python -m e3diff_tpu_torch.cli.run_pipeline --synthetic \\
        --sampler ddim --ddim_steps 25 --params_dtype int8_matmul \\
        --outdir data/pipeline
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys

import numpy as np

from e3diff_tpu_torch.cli.sample_sequence import (
    add_common_flags,
    load_test_data,
    sampling_config,
)
from e3diff_tpu_torch.utils.presets import structure_sample_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--structure_ckpt", default=None,
                   help="reference-layout structure .pt state_dict; random "
                        "weights from --seed when absent. Its config.json "
                        "sidecar sets the width, data and diffusion flags "
                        "not given here")
    p.add_argument("--sequence_ckpt", default=None,
                   help="reference-layout PeptideDiff .pt state_dict; "
                        "random weights from --seed when absent. Its "
                        "sidecar sets --sequence_timesteps and "
                        "--sequence_layers when not given, and must agree "
                        "with the structure one on the shared fields")
    p.add_argument("--outdir", default="./data/pipeline")
    p.add_argument("--sampler", choices=["ddpm", "ddim"], default="ddpm",
                   help="structure sampler: ddpm = the faithful T-step "
                        "loop; ddim = --ddim_steps forwards")
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--ddim_eta", type=float, default=1.0)
    p.add_argument("--guidance_scale", type=float, default=1.0,
                   help="CFG scale of the structure sampler (1 = off)")
    p.add_argument("--sequence_guidance_scale", type=float, default=1.0,
                   help="CFG scale of the inverse-folding sampler")
    p.add_argument("--sequence_timesteps", type=int, default=50)
    p.add_argument("--sequence_layers", type=int, default=6)
    # the reference's structure sampling config (sample.py:20-41)
    add_common_flags(p, structure_sample_config())
    return p


def main(argv=None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.synthetic and not args.data_file:
        raise SystemExit("--data_file is required unless --synthetic")

    from e3diff_tpu_torch.sampling import run_pipeline
    from e3diff_tpu_torch.utils.builders import (
        build_sequence_model,
        build_structure_model,
    )
    from e3diff_tpu_torch.utils.device import resolve_device
    from e3diff_tpu_torch.utils.params_io import (
        cast_inference_params,
        load_sequence_checkpoint,
        load_structure_checkpoint,
    )
    from e3diff_tpu_torch.utils.presets import (
        _flag_on_command_line,
        _parser_flag_names,
        check_shared_fields,
        load_ckpt_config,
    )

    # the shared and structure fields follow the structure checkpoint's
    # sidecar, the sequence model's depth and timesteps its own
    cfg = sampling_config(args, parser, args.structure_ckpt, argv)
    qside = (load_ckpt_config(args.sequence_ckpt) or {}
             if args.sequence_ckpt else {})
    known = _parser_flag_names(parser)
    given = sys.argv[1:] if argv is None else argv
    for flag, field in (("sequence_timesteps", "timesteps"),
                        ("sequence_layers", "num_hidden_layers")):
        if field in qside and not _flag_on_command_line(flag, given, known):
            setattr(args, flag, qside[field])
    try:
        check_shared_fields(cfg, qside)
    except ValueError as e:
        parser.error(f"{e}: retrain, or pass the flags explicitly")

    device = resolve_device(args.device)
    test_ds = load_test_data(args, cfg)
    qcfg = dataclasses.replace(cfg, timesteps=args.sequence_timesteps,
                               num_hidden_layers=args.sequence_layers)
    smodel = build_structure_model(
        cfg, device=device, seed=None if args.structure_ckpt else cfg.seed)
    if args.structure_ckpt:
        load_structure_checkpoint(args.structure_ckpt, smodel)
    qmodel = build_sequence_model(
        qcfg, device=device,
        seed=None if args.sequence_ckpt else cfg.seed + 1)
    if args.sequence_ckpt:
        load_sequence_checkpoint(args.sequence_ckpt, qmodel,
                                 args.sequence_timesteps)
    for m in (smodel, qmodel):
        cast_inference_params(m, args.params_dtype)

    results = run_pipeline(
        smodel, qmodel, test_ds, device=device, seed=cfg.seed,
        batch_size=cfg.batch_size, structure_timesteps=cfg.timesteps,
        sequence_timesteps=args.sequence_timesteps, sampler=args.sampler,
        ddim_steps=args.ddim_steps, ddim_eta=args.ddim_eta,
        guidance_scale=args.guidance_scale,
        sequence_guidance_scale=args.sequence_guidance_scale,
        pdb_outdir=os.path.join(args.outdir, "pdbs"))

    print(f"mean recovery rate: {np.mean(results['recovery_rate']):.4f}")
    os.makedirs(args.outdir, exist_ok=True)
    with open(os.path.join(args.outdir, "results.pkl"), "wb") as f:
        pickle.dump({k: v for k, v in results.items() if k != "pdb_paths"},
                    f)
    print(f"pipeline outputs in {args.outdir}")
    return results


if __name__ == "__main__":
    main()
