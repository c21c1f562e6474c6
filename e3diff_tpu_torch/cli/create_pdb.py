"""Sampled angles -> one PDB file per peptide (counterpart of
scripts/create_pdb.py; structure_model/create_pdb.py in the reference).

Reads the pickle cli/sample_structure.py writes. A trajectory-shaped
sample (T, len, 8) gives its FINAL step unless --traj_index says another;
--reference_indexing replays the reference's load_sampled_angle_seq, which
takes result[0] of the list as if it were trajectory-major
(create_pdb.py:423-427). Host-side numpy NERF, float64; no card needed.

Example:
    python -m e3diff_tpu_torch.cli.create_pdb --input data/output.pkl \\
        --outdir data/output
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--input", default="./data/output.pkl")
    p.add_argument("--outdir", default="./data/output")
    p.add_argument("--traj_index", type=int, default=-1,
                   help="which trajectory step to reconstruct")
    p.add_argument("--reference_indexing", action="store_true",
                   help="replicate load_sampled_angle_seq's result[0] "
                        "indexing (create_pdb.py:423-427)")
    return p


def main(argv=None) -> list[str]:
    args = build_parser().parse_args(argv)

    from e3diff_tpu_torch.geometry.chain import write_pdb_folder

    with open(args.input, "rb") as f:
        sampled = pickle.load(f)
    if args.reference_indexing:
        sampled = sampled[0]
    frames = []
    for s in sampled:
        s = np.asarray(s)
        frames.append(s[args.traj_index] if s.ndim == 3 else s)

    written = write_pdb_folder(frames, args.outdir)
    ok = [w for w in written if w]
    print(f"wrote {len(ok)}/{len(written)} PDBs to {args.outdir}")
    return written


if __name__ == "__main__":
    main()
