"""Train the structure (angle) DDPM on the card through the port's kernels
(counterpart of scripts/train_structure.py; structure_model/
train_model.py). Writes <ckpt_dir>/config.json, last.pt (resume),
best_val_model.pt, final.pt (and final_ema.pt with --ema_decay) and
history.json; final.pt serves with DesignEngine.from_checkpoints.

Example:
    python -m e3diff_tpu_torch.cli.train_structure --synthetic \\
        --ckpt_dir runs/structure --max_epochs 2
"""

from __future__ import annotations

from e3diff_tpu_torch.training.run import run


def main(argv=None) -> list[dict]:
    return run("structure", argv, __doc__)


if __name__ == "__main__":
    main()
