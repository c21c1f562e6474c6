"""Score sampled outputs against the dataset's ground truth (counterpart
of scripts/evaluate.py): the per-feature TV distance of the sampled angle
distribution to the test split's, the joint (phi, psi) TV, the mean
wrapped-angle error of length-matched pairs, with --geometry the clash
fraction and radius of gyration of the NERF-rebuilt backbones, and the
recovery rates of inverse-folded sequences. Host-side float64 numpy
(utils/evaluation.py); no card needed.

Inputs: the angle pickle of cli/sample_structure.py and/or the results
pickle of cli/sample_sequence.py or cli/sample_by_generated_angles.py.

Example:
    python -m e3diff_tpu_torch.cli.evaluate --data_file data/biolip.pkl \\
        --angles data/output.pkl --sequences data/seq_output.pkl --geometry
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np

from e3diff_tpu_torch.utils.presets import (
    add_config_flags,
    adopt_ckpt_config,
    config_from_args,
    structure_sample_config,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data_file", default=None,
                   help="complex file (.pt or .pkl); optional with "
                        "--synthetic")
    p.add_argument("--angles", help="sampled angles pickle")
    p.add_argument("--sequences", help="sequence results pickle")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_n", type=int, default=32)
    p.add_argument("--geometry", action="store_true",
                   help="also NERF-reconstruct each sample and report 3D "
                        "validity: steric clash fraction, clash-free "
                        "share, radius of gyration")
    p.add_argument("--config", default=None,
                   help="run dir (or its config.json) whose data fields to "
                        "adopt, so ground truth is built with the same "
                        "pocket_ext/max_seq_len the samples came from")
    add_config_flags(p, structure_sample_config())
    return p


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.angles and not args.sequences:
        parser.error("pass --angles and/or --sequences")
    # sequences alone never read ground truth: the results pickle carries
    # each sample's recovery rate
    if args.angles and not args.synthetic and not args.data_file:
        parser.error("--data_file is required unless --synthetic")
    cfg = config_from_args(args)
    if args.config:
        cfg, _ = adopt_ckpt_config(cfg, parser, args.config, argv=argv)

    from e3diff_tpu_torch.data import (
        LigandBindingSiteData,
        load_complexes,
        synthetic_complexes,
    )
    from e3diff_tpu_torch.utils.evaluation import (
        geometry_summary,
        mean_wrapped_angle_error,
        summarize_samples,
    )

    if args.angles:
        complexes = (synthetic_complexes(n=args.synthetic_n)
                     if args.synthetic else load_complexes(args.data_file))
        test_ds = LigandBindingSiteData(complexes, "test", cfg.max_seq_len,
                                        cfg.pocket_ext, cfg.ligand_max_len)
        examples = [test_ds[i] for i in range(len(test_ds))]
        truth = [ex["ligand_angles"][:ex["ligand_length"]]
                 for ex in examples]
        with open(args.angles, "rb") as f:
            sampled = pickle.load(f)
        sampled = [np.asarray(s)[-1] if np.asarray(s).ndim == 3
                   else np.asarray(s) for s in sampled]
        summary = summarize_samples(sampled, truth[:len(sampled)])
        print("angle distribution TV distance per feature:")
        for k, v in summary["tv_distance"].items():
            print(f"  {k:10s} {v:.4f}")
        print(f"mean TV distance: {summary['tv_distance_mean']:.4f}")
        print(f"joint (phi,psi) TV distance: "
              f"{summary['joint_tv_phi_psi']:.4f}")
        if args.geometry:
            for label, sets in (("sampled", sampled),
                                ("reference", truth[:len(sampled)])):
                g = geometry_summary(sets)
                print(f"{label} backbone geometry (NERF-reconstructed): "
                      f"clash_fraction={g['clash_fraction_mean']:.4f} "
                      f"clash_free={g['clash_free_structures']:.2%} "
                      f"Rg={g['rg_mean']:.2f}±{g['rg_std']:.2f} Å "
                      f"nan={g['n_nan_reconstructions']}"
                      f"/{g['n_structures']}")
        paired = [(s, t) for s, t in zip(sampled, truth) if len(s) == len(t)]
        if paired:
            errs = np.stack([mean_wrapped_angle_error(t, s)
                             for s, t in paired])
            print("mean wrapped-angle error (fraction of turn) per feature:")
            print("  " + " ".join(f"{e:.4f}" for e in errs.mean(0)))

    if args.sequences:
        with open(args.sequences, "rb") as f:
            res = pickle.load(f)
        rates = np.asarray(res["recovery_rate"])
        print(f"sequences: n={len(rates)} recovery mean={rates.mean():.4f} "
              f"median={np.median(rates):.4f} max={rates.max():.4f}")


if __name__ == "__main__":
    main()
