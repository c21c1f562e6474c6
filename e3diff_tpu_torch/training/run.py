"""The body of the two training CLIs (cli/train_structure.py,
cli/train_sequence.py; counterparts of scripts/train_{structure,
sequence}.py): flags from the preset, the run directory's config.json
sidecar (reconciled on a resume), the data, the model with seeded random
weights on the device, AdamW, the trainer and the epoch loop, and
history.json.

Multi-device (``--multihost``, under ``python -m torch.distributed.run``):
each rank joins the job (parallel/multihost.py), the ranks form a
(``--dp``, ``--tp``) mesh (dp defaults to the world size over tp), every
rank reads each global batch of ``--batch_size`` rows and trains on its
dp rows, and rank 0 writes config.json, the checkpoints and
history.json. ``--dist_backend gloo`` puts several ranks on one card
(NCCL refuses two ranks on one GPU); gloo's collectives cannot be
captured, so its steps run eagerly."""

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
    p.add_argument("--device", default="cuda",
                   help="the card (or 'cpu'); on a mesh each rank's card is "
                        "cuda:{LOCAL_RANK %% device_count}")
    p.add_argument("--multihost", action="store_true",
                   help="join the torch.distributed job that "
                        "torch.distributed.run started (MASTER_ADDR, "
                        "MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK) before "
                        "anything touches the card")
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel extent (default: the world size "
                        "over --tp)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel extent")
    p.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                   help="the mesh's collectives (default: nccl on the "
                        "card, gloo on the CPU); gloo puts several ranks on "
                        "one card and runs the steps eagerly")
    p.add_argument("--profile_dir", default=None,
                   help="profile the train steps of one epoch (the second "
                        "of the run, or its only one) with torch.profiler, "
                        "write DIR/trace.json and print its digest")
    add_config_flags(p, PRESETS[kind]())
    return p


def build_trainer(kind: str, cfg, device, steps_per_epoch: int, mesh=None):
    """The ``kind`` ("structure" or "sequence") model with seeded random
    weights on ``device``, its diffusion (the sequence model's with the
    BLOSUM transition), AdamW and the trainer, from ``cfg``; on ``mesh``,
    the rank's shard of the same weights."""
    from e3diff_tpu_torch.training import (
        AdamW,
        SequenceTrainer,
        StructureTrainer,
    )
    from e3diff_tpu_torch.utils import builders

    if kind == "structure":
        model = builders.build_structure_model(cfg, device=device,
                                               seed=cfg.seed, mesh=mesh)
        diffusion = builders.build_structure_diffusion(cfg, device=device)
        trainer_cls = StructureTrainer
    else:
        model = builders.build_sequence_model(cfg, device=device,
                                              seed=cfg.seed, mesh=mesh)
        # the BLOSUM transition, as scripts/train_sequence.py:81 builds it
        diffusion = builders.build_sequence_diffusion(cfg, "blosum",
                                                      device=device)
        trainer_cls = SequenceTrainer
    optimizer = AdamW(dict(model.named_parameters()), base_lr=cfg.lr,
                      weight_decay=cfg.l2_norm, max_epochs=cfg.max_epochs,
                      steps_per_epoch=steps_per_epoch,
                      grad_clip=cfg.gradient_clip, mu_dtype=cfg.mu_dtype,
                      mesh=mesh, sharding_rules=model.sharding_rules)
    return trainer_cls(model, diffusion, optimizer, ema_decay=cfg.ema_decay,
                       accum_steps=cfg.accum_steps,
                       cond_dropout=cfg.cond_dropout,
                       generator=torch.Generator(device=device).manual_seed(
                           cfg.seed), mesh=mesh)


def run(kind: str, argv=None, description: str = "") -> list[dict]:
    """Parse ``argv``, train, write history.json; returns the history."""
    from e3diff_tpu_torch.data import (
        LigandBindingSiteData,
        load_complexes,
        synthetic_complexes,
    )
    from e3diff_tpu_torch.parallel import (
        initialize_multihost,
        make_mesh,
        shard_batch,
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
    mesh, rank = None, 0
    if args.multihost:
        # before anything touches the card
        rank, world = initialize_multihost(backend=args.dist_backend)
        print(f"multihost: rank {rank}/{world}")
        if world > 1 or args.dp is not None or args.tp > 1:
            mesh = make_mesh(args.dp, args.tp, backend=args.dist_backend,
                             device=None if args.device == "cuda"
                             else args.device)
            rows = mesh.dp * cfg.accum_steps
            if cfg.batch_size % rows:
                parser.error(f"--batch_size {cfg.batch_size} must be "
                             f"divisible by dp x accum_steps = {rows}")
            print(f"mesh: {mesh.shape} on {mesh.device}, "
                  f"{mesh.backend}" + ("" if mesh.can_capture else
                                       " (steps run eagerly)"))
    elif args.dp is not None or args.tp > 1:
        parser.error("--dp / --tp need --multihost (launch with python -m "
                     "torch.distributed.run)")
    device = resolve_device(args.device) if mesh is None else mesh.device
    # a resume without the original flags adopts the run's
    # checkpoint-bound fields; explicit mismatches fail
    cfg, _ = reconcile_run_config(cfg, args.ckpt_dir, parser, argv)
    if rank == 0:   # one writer
        save_config(cfg, args.ckpt_dir)

    complexes = (synthetic_complexes(n=args.synthetic_n) if args.synthetic
                 else load_complexes(args.data_file))
    train_ds, val_ds = (LigandBindingSiteData(
        complexes, split, cfg.max_seq_len, cfg.pocket_ext, cfg.ligand_max_len)
        for split in ("train", "validation"))
    print(f"train={len(train_ds)} val={len(val_ds)} complexes")
    trainer = build_trainer(kind, cfg, device,
                            max(1, len(train_ds) // cfg.batch_size), mesh)
    n_params = sum(p.numel() for p in trainer.optimizer.params)
    print(f"Model has {n_params} trainable parameters")

    def train_batches(epoch):
        batches = train_ds.batches(cfg.batch_size, shuffle=True,
                                   seed=cfg.seed + epoch, drop_last=True)
        if mesh is None:
            return batches
        return (shard_batch(b, mesh) for b in batches)

    history = train_loop(
        trainer, train_batches, lambda: val_ds.batches(cfg.batch_size),
        max_epochs=cfg.max_epochs, device=device, ckpt_dir=args.ckpt_dir,
        ckpt_mode=cfg.ckpt_mode, ckpt_every=cfg.ckpt_every,
        profile_dir=args.profile_dir)
    if not history:
        print("done; no epochs to run (already trained to max_epochs)")
        return history
    if rank == 0:
        with open(os.path.join(args.ckpt_dir, "history.json"), "w") as f:
            json.dump(history, f, indent=1)
    print(f"done; final val_loss={history[-1].get('val_loss', float('nan'))}")
    return history
