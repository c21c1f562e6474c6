"""Train the sequence D3PM (inverse folding) on the card through the
port's kernels, with the BLOSUM transition (counterpart of
scripts/train_sequence.py; sequence_model/train_model.py). Writes
<ckpt_dir>/config.json, last.pt, best_val_model.pt, final.pt (and
final_ema.pt with --ema_decay) and history.json.

Example:
    python -m e3diff_tpu_torch.cli.train_sequence --synthetic \\
        --ckpt_dir runs/sequence --max_epochs 2
"""

from __future__ import annotations

from e3diff_tpu_torch.training.run import run


def main(argv=None) -> list[dict]:
    return run("sequence", argv, __doc__)


if __name__ == "__main__":
    main()
