"""BioLiP preprocessing: structure files and the BioLiP metadata TSV ->
the complex pickle every other CLI reads with --data_file (counterpart of
scripts/preprocess.py; clean_data/data_preprocessing.py in the reference).

Two engines, both on the host:
* native -- the built-in PDB/mmCIF readers and Kabsch-Sander DSSP
  (data/native_structure.py, data/dssp.py), whose hot loops run in C++
  compiled with g++ at first use (native/dssp_core.cpp; E3DIFF_NATIVE=0
  runs them in numpy instead);
* biopython -- Biopython with the external mkdssp binary, the reference's
  pipeline exactly.
--engine auto (the default) takes biopython when both it and mkdssp are
installed, else native. The TSV is read with the csv module: pandas is
not needed.

Example:
    python -m e3diff_tpu_torch.cli.preprocess --meta_file BioLiP.txt \\
        --structure_folder pdbs/ --output data/biolip.pkl --engine native
"""

from __future__ import annotations

import argparse
import time


def check_env() -> int:
    """Probe the host for each engine's needs and report the engine
    ``resolve_engine('auto')`` will run; returns a shell exit code (0:
    preprocessing can run, 1: it cannot)."""
    from e3diff_tpu_torch import native
    from e3diff_tpu_torch.data.preprocessing import (
        find_dssp_binary,
        has_biopython,
        resolve_engine,
    )

    probes = []
    if has_biopython():
        import Bio
        probes.append(("biopython", True, getattr(Bio, "__version__", "?")))
    else:
        probes.append(("biopython", False, "No module named 'Bio'"))
    dssp = find_dssp_binary()
    probes.append(("dssp binary", bool(dssp), dssp or "not on PATH"))
    if not native.native_enabled():
        probes.append(("native C++ library", True,
                       "off (E3DIFF_NATIVE=0): the numpy engine runs"))
    else:
        try:
            native.load_native_lib()
            probes.append(("native C++ library", True,
                           native.BUILD_INFO["path"]))
        except RuntimeError as e:
            probes.append(("native C++ library", False, str(e)))
    probes.append(("pandas", True, "not needed (the TSV is read with csv)"))

    for name, present, detail in probes:
        print(f"{'ok  ' if present else 'MISS'} {name}: {detail}")
    engine = resolve_engine("auto")
    if engine == "biopython":
        print("\nengine=auto will use biopython + the external dssp "
              "binary (reference-exact, .pdb + .cif).")
        return 0
    print("\nengine=auto will use the built-in native engine "
          "(PDB/mmCIF readers + Kabsch-Sander DSSP with C++ hot loops; "
          "see e3diff_tpu_torch/data/dssp.py for its documented "
          "deviations from the external dssp binary).")
    return 0 if all(ok for _, ok, _ in probes[2:]) else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--check-env", action="store_true",
                   help="probe deps, report the engine, and exit")
    p.add_argument("--meta_file", help="BioLiP metadata TSV (BioLiP.txt)")
    p.add_argument("--structure_folder",
                   help="folder of {pdb_id}.pdb / {pdb_id}.cif files")
    p.add_argument("--output", default="./data/biolip.pkl")
    p.add_argument("--workers", type=int, default=16)
    p.add_argument("--engine", default="auto",
                   choices=["auto", "biopython", "native"])
    return p


def main(argv=None) -> list[dict]:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.check_env:
        raise SystemExit(check_env())
    if not args.meta_file or not args.structure_folder:
        parser.error("--meta_file and --structure_folder are required "
                     "(or use --check-env)")

    from e3diff_tpu_torch.data.preprocessing import run_preprocessing

    t0 = time.perf_counter()
    records = run_preprocessing(args.meta_file, args.structure_folder,
                                args.output, workers=args.workers,
                                engine=args.engine)
    secs = time.perf_counter() - t0
    print(f"wrote {len(records)} complexes to {args.output} in {secs:.2f} s")
    return records


if __name__ == "__main__":
    main()
