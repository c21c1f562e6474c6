"""Remove the heavyweight checkpoint files of a finished run directory
(counterpart of scripts/prune_ckpt.py, on the port's layout).

A run directory of the port's trainers (training/checkpoint.py) holds
``<name>.pt`` files: ``last`` (the whole train state: weights, AdamW
moments, EMA; about three times the weights), which only a resume needs,
and the weights-only inference artifacts ``final``, ``best_val_model`` and
``final_ema``, which the sampling CLIs and DesignEngine read. This removes
``last.pt`` and the ``.<name>.*.tmp`` files an interrupted save leaves,
keeps the --keep artifacts, and never touches config.json or history.json.
It refuses to run when none of --keep exists.

Example:
    python -m e3diff_tpu_torch.cli.prune_ckpt runs/structure
    python -m e3diff_tpu_torch.cli.prune_ckpt runs/structure --keep final
"""

from __future__ import annotations

import argparse
import os
import re

INFERENCE_ARTIFACTS = ("final", "best_val_model", "final_ema")
CHECKPOINT_NAMES = ("last",) + INFERENCE_ARTIFACTS
# CheckpointManager.save's temporary files: tempfile.mkstemp(prefix=
# f".{name}.", suffix=".tmp")
_TMP = re.compile(r"\.[A-Za-z_]+\..+\.tmp")


def prune(run_dir: str, keep: tuple, dry_run: bool = False) -> int:
    """Remove the checkpoint files of ``run_dir`` not named in ``keep``;
    returns the bytes freed (or that would be, with ``dry_run``)."""
    freed = 0
    for fname in sorted(os.listdir(run_dir)):
        path = os.path.join(run_dir, fname)
        if not os.path.isfile(path):
            continue
        name = fname[:-3] if fname.endswith(".pt") else None
        if not (name in CHECKPOINT_NAMES and name not in keep
                or _TMP.fullmatch(fname)):
            continue  # config.json, history.json, kept artifacts
        size = os.path.getsize(path)
        print(f"{'would remove' if dry_run else 'removing'} "
              f"{path} ({size / 1e6:.1f} MB)")
        if not dry_run:
            os.unlink(path)
        freed += size
    return freed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("run_dir")
    p.add_argument("--keep", default=",".join(INFERENCE_ARTIFACTS),
                   help="comma list of checkpoint names to keep (default: "
                        "the weights-only inference artifacts)")
    p.add_argument("--dry_run", action="store_true")
    args = p.parse_args(argv)
    keep = tuple(k for k in args.keep.split(",") if k)
    kept = [k for k in keep
            if os.path.isfile(os.path.join(args.run_dir, f"{k}.pt"))]
    if not kept:
        raise SystemExit(
            f"refusing to prune {args.run_dir}: none of {keep} exists "
            "there -- pruning would leave NO usable weights")
    freed = prune(args.run_dir, keep, dry_run=args.dry_run)
    print(f"{'would free' if args.dry_run else 'freed'} "
          f"{freed / 1e6:.1f} MB; kept {kept} + config/history")
    return freed


if __name__ == "__main__":
    main()
