"""Train the sequence D3PM (inverse folding) on the card through the
port's kernels, with the BLOSUM transition (counterpart of
scripts/train_sequence.py; sequence_model/train_model.py). Writes
<ckpt_dir>/config.json, last.pt, best_val_model.pt, final.pt (and
final_ema.pt with --ema_decay) and history.json.

On the card each train step is a replay of the step captured as one CUDA
graph; --profile_dir DIR profiles one epoch, writes DIR/trace.json and
prints its digest.

Example:
    python -m e3diff_tpu_torch.cli.train_sequence --synthetic \\
        --ckpt_dir runs/sequence --max_epochs 2

Over several cards, one process per card (rank 0 writes the files; each
rank trains on its dp rows of every batch of --batch_size):
    python -m torch.distributed.run --nproc_per_node 2 \\
        -m e3diff_tpu_torch.cli.train_sequence --multihost --dp 2 --synthetic
(--dist_backend gloo puts several ranks on one card; their steps then run
eagerly.)
"""

from __future__ import annotations

from e3diff_tpu_torch.training.run import run


def main(argv=None) -> list[dict]:
    return run("sequence", argv, __doc__)


if __name__ == "__main__":
    main()
