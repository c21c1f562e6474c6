"""The body of the two training CLIs (cli/train_structure.py,
cli/train_sequence.py; counterparts of scripts/train_{structure,
sequence}.py): flags from the preset, the run directory's config.json
sidecar (reconciled on a resume), the data, the model with seeded random
weights on the device, AdamW, the trainer and the epoch loop, and
history.json."""

from __future__ import annotations

import argparse
import json
import os

import torch

from e3diff_tpu_torch.utils.presets import (
    add_config_flags,
    config_from_args,
    reconcile_run_config,
    save_config,
    sequence_train_config,
    structure_train_config,
    transformer_configs,
)

PRESETS = {"structure": structure_train_config,
           "sequence": sequence_train_config}


def build_parser(kind: str, description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_file", default=None,
                   help="complex file (.pt or .pkl); optional with "
                        "--synthetic")
    p.add_argument("--ckpt_dir", default=f"./runs/{kind}")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic complexes (no BioLiP needed)")
    p.add_argument("--synthetic_n", type=int, default=64)
    p.add_argument("--device", default="cuda")
    add_config_flags(p, PRESETS[kind]())
    return p


def build_trainer(kind: str, cfg, device, steps_per_epoch: int):
    """The ``kind`` ("structure" or "sequence") model with seeded random
    weights on ``device``, its diffusion (the sequence model's with the
    BLOSUM transition), AdamW and the trainer, from ``cfg``."""
    from e3diff_tpu_torch.diffusion import D3PMDiffusion, GaussianAngleDiffusion
    from e3diff_tpu_torch.models import SequenceDenoiser, StructureDenoiser
    from e3diff_tpu_torch.ops.transitions import BlosumTransition
    from e3diff_tpu_torch.training import (
        AdamW,
        SequenceTrainer,
        StructureTrainer,
    )

    if kind == "structure":
        model = StructureDenoiser(*transformer_configs(cfg, "torch_default"),
                                  device=device, seed=cfg.seed)
        diffusion = GaussianAngleDiffusion.cosine(cfg.timesteps, device=device)
        trainer_cls = StructureTrainer
    else:
        model = SequenceDenoiser(*transformer_configs(cfg, "xavier_all"),
                                 device=device, seed=cfg.seed)
        # the BLOSUM transition, as scripts/train_sequence.py:81 builds it
        diffusion = D3PMDiffusion.create(BlosumTransition(device=device),
                                         timesteps=cfg.timesteps,
                                         device=device)
        trainer_cls = SequenceTrainer
    optimizer = AdamW(dict(model.named_parameters()), base_lr=cfg.lr,
                      weight_decay=cfg.l2_norm, max_epochs=cfg.max_epochs,
                      steps_per_epoch=steps_per_epoch,
                      grad_clip=cfg.gradient_clip, mu_dtype=cfg.mu_dtype)
    return trainer_cls(model, diffusion, optimizer, ema_decay=cfg.ema_decay,
                       accum_steps=cfg.accum_steps,
                       cond_dropout=cfg.cond_dropout,
                       generator=torch.Generator(device=device).manual_seed(
                           cfg.seed))


def run(kind: str, argv=None, description: str = "") -> list[dict]:
    """Parse ``argv``, train, write history.json; returns the history."""
    from e3diff_tpu_torch.data import (
        LigandBindingSiteData,
        load_complexes,
        synthetic_complexes,
    )
    from e3diff_tpu_torch.training.loop import train_loop
    from e3diff_tpu_torch.utils.device import resolve_device

    parser = build_parser(kind, description)
    args = parser.parse_args(argv)
    if not args.synthetic and not args.data_file:
        parser.error("--data_file is required unless --synthetic")
    cfg = config_from_args(args)
    if cfg.accum_steps < 1 or cfg.batch_size % cfg.accum_steps:
        parser.error(f"--batch_size {cfg.batch_size} must be divisible by "
                     f"--accum_steps {cfg.accum_steps}")
    device = resolve_device(args.device)
    # a resume without the original flags adopts the run's
    # checkpoint-bound fields; explicit mismatches fail
    cfg, _ = reconcile_run_config(cfg, args.ckpt_dir, parser, argv)
    save_config(cfg, args.ckpt_dir)

    complexes = (synthetic_complexes(n=args.synthetic_n) if args.synthetic
                 else load_complexes(args.data_file))
    train_ds, val_ds = (LigandBindingSiteData(
        complexes, split, cfg.max_seq_len, cfg.pocket_ext, cfg.ligand_max_len)
        for split in ("train", "validation"))
    print(f"train={len(train_ds)} val={len(val_ds)} complexes")
    trainer = build_trainer(kind, cfg, device,
                     max(1, len(train_ds) // cfg.batch_size))
    n_params = sum(p.numel() for p in trainer.optimizer.params)
    print(f"Model has {n_params} trainable parameters")

    def train_batches(epoch):
        return train_ds.batches(cfg.batch_size, shuffle=True,
                                seed=cfg.seed + epoch, drop_last=True)

    history = train_loop(
        trainer, train_batches, lambda: val_ds.batches(cfg.batch_size),
        max_epochs=cfg.max_epochs, device=device, ckpt_dir=args.ckpt_dir,
        ckpt_mode=cfg.ckpt_mode, ckpt_every=cfg.ckpt_every)
    if not history:
        print("done; no epochs to run (already trained to max_epochs)")
        return history
    with open(os.path.join(args.ckpt_dir, "history.json"), "w") as f:
        json.dump(history, f, indent=1)
    print(f"done; final val_loss={history[-1].get('val_loss', float('nan'))}")
    return history
