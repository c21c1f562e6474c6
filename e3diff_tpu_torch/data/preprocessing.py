"""BioLiP -> dataset preprocessing (the port's copy of
e3diff_tpu/data/preprocessing.py; clean_data/data_preprocessing.py in the
reference): read the BioLiP metadata TSV, parse each complex (PDB/mmCIF),
compute per-residue DSSP features and the 8 backbone angles, locate the
pocket residues, and write the list-of-dict complex schema that
LigandBindingSiteData reads.

Two engines: ``native``, the readers of data/native_structure.py and the
DSSP of data/dssp.py (its hot loops in native/dssp_core.cpp), and
``biopython``, Biopython with the external mkdssp binary, exactly the
reference's pipeline, imported only when asked for.

The TSV is read with the ``csv`` module, not pandas: ``read_biolip_meta``
gives each row the values and types pandas' type inference would give it
(numpy int64 / float64 / bool columns, str otherwise, NaN for the NA
spellings), so ``parse_record`` sees what the JAX package's does.

Angle dict insertion order (quirk Q1 feeds off it): omega, phi, psi,
dihedral_o, theta1 (N:CA:C), theta2 (CA:C:1N), theta3 (-1C:N:CA), theta_o
(CA:C:O), in DEGREES, converted with deg2rad when the record is assembled
(reference :720-730, :886).
"""

from __future__ import annotations

import collections
import csv
import itertools
import math
import os
import re
from typing import Sequence

import numpy as np

BIOLIP_META_HEADER = [
    "pdb_id", "receptor_chain", "resolution", "binding_site",
    "ligand_ccd_id", "ligand_chain", "ligand_serial_num",
    "binding_site_pdb", "binding_site_reorder", "catalyst_site_pdb",
    "catalyst_site_reorder", "enzyme_class_id", "go_term_id",
    "binding_affinity_literature", "binding_affinity_binding_moad",
    "binding_affinity_pdbind_cn", "binding_affinity_binding_db",
    "uniprot_db", "pubmed_id", "ligand_res_num", "receptor_seq",
]


# ---------------------------------------------------------------------------
# Pure geometry (parity with reference :621-661)
# ---------------------------------------------------------------------------

def calc_angle(p1, p2, p3) -> float:
    """Planar angle at p2, in degrees."""
    v1 = np.asarray(p2) - np.asarray(p1)
    v2 = np.asarray(p2) - np.asarray(p3)
    mag = np.linalg.norm(v1) * np.linalg.norm(v2)
    if mag == 0:
        raise ValueError(
            "One of the vectors has zero magnitude, leading to an "
            "undefined angle.")
    cos_theta = np.clip(np.dot(v1, v2) / mag, -1.0, 1.0)
    return float(np.degrees(np.arccos(cos_theta)))


def calc_dihedral(p1, p2, p3, p4) -> float:
    """Signed dihedral (degrees), sign via scalar triple product with the
    middle bond vector — reference formula (:637-661)."""
    p1, p2, p3, p4 = (np.asarray(p) for p in (p1, p2, p3, p4))
    v1, v2, v3 = p2 - p1, p3 - p2, p4 - p3
    n1 = np.cross(v1, v2)
    n2 = np.cross(v2, v3)
    n1 = n1 / np.linalg.norm(n1)
    n2 = n2 / np.linalg.norm(n2)
    cos_theta = np.clip(np.dot(n1, n2), -1.0, 1.0)
    sign = np.sign(np.dot(np.cross(n1, n2), v2))
    return float(np.degrees(np.arccos(cos_theta) * sign))


def extract_angle_dihedrals(residue_coords: Sequence[dict]) -> list[dict]:
    """8 angles for residues 1..n-2. Each input dict needs keys
    'N','CA','C','O' mapping to xyz triples (reference :688-731)."""
    out = []
    for i in range(1, len(residue_coords) - 1):
        prev_r = residue_coords[i - 1]
        r = residue_coords[i]
        next_r = residue_coords[i + 1]
        prev_C, prev_CA = prev_r["C"], prev_r["CA"]
        N, CA, C, O = r["N"], r["CA"], r["C"], r["O"]
        next_N = next_r["N"]
        out.append({
            "omega": calc_dihedral(prev_CA, prev_C, N, CA),
            "phi": calc_dihedral(prev_C, N, CA, C),
            "psi": calc_dihedral(N, CA, C, next_N),
            "dihedral_o": calc_dihedral(N, CA, C, O),
            "theta1": calc_angle(N, CA, C),
            "theta2": calc_angle(CA, C, next_N),
            "theta3": calc_angle(prev_C, N, CA),
            "theta_o": calc_angle(CA, C, O),
        })
    return out


# ---------------------------------------------------------------------------
# Record assembly (parity with reference create_data :838-893)
# ---------------------------------------------------------------------------

def build_complex_record(structure_ids: dict, receptor: list[dict],
                         ligand: list[dict], pocket_idx: list[int]) -> dict:
    """Assemble one dataset record from per-residue feature dicts.

    Each residue dict carries the DSSP features + the 8 angle keys in the
    Q1 insertion order; the first/last residue of each chain is dropped
    (they lack angles). `pocket_idx` indexes the UNTRIMMED receptor list,
    exactly like the reference (so trimming shifts pocket indices by -1 —
    replicated: the reference sets pocket_mask[pocket_idx] on the trimmed
    arrays without adjusting)."""
    receptor = receptor[1:-1]
    ligand = ligand[1:-1]

    def seq(rs, key):
        return [r[key] for r in rs]

    amino_acid = seq(receptor, "amino_acid") + seq(ligand, "amino_acid")
    secondary = seq(receptor, "secondary_structure") + seq(
        ligand, "secondary_structure")
    secondary = ["-" if c == "P" else c for c in secondary]

    def numerical(r):
        # rel ASA + the 4 H-bond energies: stride-2 slice over the dict's
        # value order (reference :862-866)
        return list(r.values())[3:-8:2]

    numerical_features = [numerical(r) for r in receptor] + [
        numerical(r) for r in ligand]
    angle_features = [list(r.values())[-8:] for r in receptor] + [
        list(r.values())[-8:] for r in ligand]
    pos = seq(receptor, "alpha_carbon_coord") + seq(
        ligand, "alpha_carbon_coord")

    n_rec, n_lig = len(receptor), len(ligand)
    ligand_idx = list(range(n_rec, n_rec + n_lig))
    pocket_mask = np.zeros(n_rec + n_lig, dtype=bool)
    pocket_mask[pocket_idx] = True
    edge_idx = np.array(
        list(itertools.product(ligand_idx, pocket_idx)), dtype=np.int64)

    return {
        "structure_ids": structure_ids,
        "coors": np.asarray(pos, np.float32),
        "amino_acid": amino_acid,
        "secondary_structure": secondary,
        "numerical_features": np.asarray(numerical_features, np.float32),
        "angle_features": np.deg2rad(
            np.asarray(angle_features, np.float32)).astype(np.float32),
        "edge_index": edge_idx.T.reshape(2, -1),
        "ligand_mask": np.concatenate(
            [np.zeros(n_rec, bool), np.ones(n_lig, bool)]),
        "ligand_idx": np.asarray(ligand_idx, np.int32),
        "pocket_mask": pocket_mask,
        "pocket_idx": np.asarray(pocket_idx, np.int32),
    }


def filter_records(parsed: list) -> list[dict]:
    """res_to_dataset (:895-907): drop failures, complexes containing 'X',
    and ligands shorter than 5 residues; assemble records."""
    data = [r for r in parsed if not r[1]["msg"]]
    keep = []
    for r in data:
        rec_seq = [res["amino_acid"] for res in r[1]["receptor"]]
        lig_seq = [res["amino_acid"] for res in r[1]["ligand"]]
        if "X" in rec_seq or "X" in lig_seq:
            continue
        if len(r[1]["ligand"]) < 5:
            continue
        keep.append(r)
    return [build_complex_record(r[0], r[1]["receptor"], r[1]["ligand"],
                                 r[1]["pocket_idx"]) for r in keep]


# ---------------------------------------------------------------------------
# Biopython/DSSP-dependent parsing (import-gated)
# ---------------------------------------------------------------------------

def has_biopython() -> bool:
    try:
        import Bio  # noqa: F401
        return True
    except ImportError:
        return False


def find_dssp_binary() -> str | None:
    """Path of the external mkdssp/dssp executable Biopython's DSSP class
    shells out to, or None. The biopython engine needs BOTH."""
    import shutil
    return shutil.which("mkdssp") or shutil.which("dssp")


def requires_biopython():
    if not has_biopython():
        raise ImportError(
            "This path needs biopython (+ a dssp binary on PATH). Use "
            "engine='native' (dependency-free PDB/mmCIF parser + "
            "Kabsch-Sander DSSP, data/native_structure.py + data/dssp.py), "
            "or run preprocessing once in an environment that has "
            "biopython and load the cached biolip.pt / native pickle.")


def resolve_engine(engine: str = "auto") -> str:
    """'auto' prefers biopython (external-DSSP parity) only when BOTH
    biopython and the dssp binary are usable — Bio.PDB.DSSP shells out to
    mkdssp, so biopython alone would fail on every record — else the
    built-in native engine."""
    if engine == "auto":
        full = has_biopython() and find_dssp_binary() is not None
        return "biopython" if full else "native"
    if engine not in ("biopython", "native"):
        raise ValueError(f"unknown engine {engine!r}")
    return engine


def _residue_coord_dicts(residues) -> list[dict]:
    return [{a: res[a].get_coord() for a in ("N", "CA", "C", "O")}
            for res in residues]


def create_res_id_map(chain):
    """Residue-id map handling insertion codes (reference :734-744)."""
    id_map = {}
    for res in chain.get_residues():
        res_id = str(res.get_id()[1])
        full_id = (res_id + res.get_id()[2]).strip()
        id_map[full_id] = res
        if res_id != full_id and res_id not in id_map:
            id_map[res_id] = res
    return id_map


def extract_dssp_features(structure, file_path) -> dict:
    """Per-chain DSSP features (reference :746-769). Keeps the Biopython
    residue object under 'res' for downstream angle/pocket lookup."""
    from Bio.PDB.DSSP import DSSP

    dssp = DSSP(structure, file_path)
    chain_id_map, features = {}, {}
    for k in dssp.keys():
        chain_id = k[0]
        residue_id = (str(k[1][1]) + str(k[1][2])).strip()
        if chain_id not in chain_id_map:
            chain_id_map[chain_id] = create_res_id_map(structure[chain_id])
        res = chain_id_map[chain_id][residue_id]
        features.setdefault(chain_id, []).append({
            "res": res,
            "alpha_carbon_coord": list(res["CA"].get_coord().astype(float)),
            "amino_acid": dssp[k][1],
            "secondary_structure": dssp[k][2],
            "relative_ASA": dssp[k][3],
            "NH_O_1_relidx": dssp[k][6], "NH_O_1_energy": dssp[k][7],
            "O_NH_1_relidx": dssp[k][8], "O_NH_1_energy": dssp[k][9],
            "NH_O_2_relidx": dssp[k][10], "NH_O_2_energy": dssp[k][11],
            "O_NH_2_relidx": dssp[k][12], "O_NH_2_energy": dssp[k][13],
        })
    return features


def parse_record(record, structure_folder: str, engine: str = "auto"):
    """Parse one BioLiP row -> [structure_ids, features-or-error]
    (reference parse_by_record :776-831).

    engine='biopython' reproduces the reference exactly (external dssp);
    engine='native' uses the dependency-free PDB parser + Kabsch-Sander
    DSSP (.pdb and mmCIF); 'auto' picks biopython when available."""
    structure_ids = {
        "pdb_id": record.pdb_id,
        "receptor_chain": record.receptor_chain,
        "ligand_chain": record.ligand_chain,
    }
    try:
        engine = resolve_engine(engine)
        pdb_path = os.path.join(structure_folder, f"{record.pdb_id}.pdb")
        cif_path = os.path.join(structure_folder, f"{record.pdb_id}.cif")

        if engine == "native":
            from e3diff_tpu_torch.data.dssp import native_dssp_features
            from e3diff_tpu_torch.data.native_structure import (
                parse_structure_chains)

            if os.path.exists(pdb_path):
                file_path = pdb_path
            elif os.path.exists(cif_path):
                file_path = cif_path
            else:
                raise FileNotFoundError(f"no structure for {record.pdb_id}")
            features = native_dssp_features(parse_structure_chains(file_path))
        else:
            requires_biopython()
            from Bio.PDB import MMCIFParser, PDBParser

            if os.path.exists(pdb_path):
                file_path, parser = pdb_path, PDBParser(QUIET=True)
            elif os.path.exists(cif_path):
                file_path, parser = cif_path, MMCIFParser(QUIET=True)
            else:
                raise FileNotFoundError(f"no structure for {record.pdb_id}")
            structure = parser.get_structure("87", file_path)[0]
            features = extract_dssp_features(structure, file_path)
        for chain_id in [record.receptor_chain, record.ligand_chain]:
            chain = features[chain_id]
            coords = _residue_coord_dicts([r["res"] for r in chain])
            for idx, angles in enumerate(extract_angle_dihedrals(coords)):
                chain[idx + 1].update(angles)

        # pocket lookup: exact full-id (with insertion code) first, then
        # bare residue number (reference :802-822)
        pocket_ids = [rid[1:] for rid in record.binding_site_pdb.split()]
        receptor_feats = features[record.receptor_chain]
        msg = False
        pocket_idx = []
        for rid in pocket_ids:
            idx = -1
            for i, r in enumerate(receptor_feats):
                full_id = (str(r["res"].get_id()[1]) +
                           r["res"].get_id()[2]).strip()
                if rid == full_id:
                    idx = i
            if idx == -1:
                for i, r in enumerate(receptor_feats):
                    if rid == str(r["res"].get_id()[1]).strip():
                        idx = i
            if idx != -1:
                pocket_idx.append(idx)
            else:
                msg = f"{rid} not found."

        def drop_res(feats):
            for r in feats:
                r.pop("res", None)
            return feats

        return [structure_ids, {
            "receptor": drop_res(features[record.receptor_chain]),
            "ligand": drop_res(features[record.ligand_chain]),
            "pocket_idx": pocket_idx,
            "msg": msg,
        }]
    except Exception as e:  # per-record fault isolation (reference :830-831)
        return [structure_ids, {"msg": str(e)}]


# ---------------------------------------------------------------------------
# The metadata TSV, typed as pandas.read_csv types it
# ---------------------------------------------------------------------------

BiolipRow = collections.namedtuple("BiolipRow", BIOLIP_META_HEADER)

# pandas' default NA spellings (read_csv keep_default_na=True)
_NA_VALUES = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"])
_INT = re.compile(r"\s*[+-]?\d+\s*")
_FLOAT = re.compile(r"\s*[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?"
                    r"|[iI][nN][fF]([iI][nN][iI][tT][yY])?)\s*")
_BOOL = {"True": True, "TRUE": True, "true": True,
         "False": False, "FALSE": False, "false": False}


def _typed_column(values: list[str]) -> tuple[str, list]:
    """(kind, values) of one column as pandas infers it: "int" (numpy
    int64, or uint64 past int64) when every field is an integer, "float"
    (float64, NaN for NA) when every non-NA field is a number, "bool"
    (numpy bool without NA; Python bool beside NaN otherwise), else "str"
    (the fields as read, NaN for NA)."""
    present = [v for v in values if v not in _NA_VALUES]
    has_na = len(present) < len(values)
    if present and not has_na and all(_INT.fullmatch(v) for v in present):
        ints = [int(v) for v in present]
        if all(-2 ** 63 <= x < 2 ** 63 for x in ints):
            return "int", [np.int64(x) for x in ints]
        if all(0 <= x < 2 ** 64 for x in ints):
            return "int", [np.uint64(x) for x in ints]
    if all(_FLOAT.fullmatch(v) for v in present):
        return "float", [np.float64(math.nan) if v in _NA_VALUES
                         else np.float64(float(v)) for v in values]
    if all(v in _BOOL for v in present):
        if not has_na:
            return "bool", [np.bool_(_BOOL[v]) for v in values]
        return "bool", [math.nan if v in _NA_VALUES else _BOOL[v]
                        for v in values]
    return "str", [math.nan if v in _NA_VALUES else v for v in values]


def _same_key(v):
    """drop_duplicates' key: NaNs are equal to each other."""
    return ("nan",) if isinstance(v, float) and math.isnan(v) else v


def read_biolip_meta(meta_file: str) -> list[BiolipRow]:
    """The rows ``run_preprocessing`` parses, as the JAX package's
    ``pd.read_csv(sep="\t", names=BIOLIP_META_HEADER)``, then
    ``drop_duplicates(subset="pdb_id")`` (the first row of a pdb_id kept)
    and ``resolution < 5`` (a missing resolution dropped) give them, in
    file order, each field typed as pandas types its column. Blank lines
    are skipped; a short row is padded with NA; a row with more fields
    than the header raises."""
    with open(meta_file, newline="") as f:
        lines = [r for r in csv.reader(f, delimiter="\t") if r]
    n_cols = len(BIOLIP_META_HEADER)
    for i, r in enumerate(lines):
        if len(r) > n_cols:
            raise ValueError(f"{meta_file}: row {i + 1} has {len(r)} "
                             f"fields, the header {n_cols}")
    rows = [r + [""] * (n_cols - len(r)) for r in lines]
    kinds, cols = zip(*(_typed_column([r[j] for r in rows])
                        for j in range(n_cols))) if rows else ((), ())
    typed = [BiolipRow(*(col[i] for col in cols)) for i in range(len(rows))]

    seen, unique = set(), []
    for row in typed:
        key = _same_key(row.pdb_id)
        if key not in seen:
            seen.add(key)
            unique.append(row)
    if unique and kinds[BIOLIP_META_HEADER.index("resolution")] == "str":
        raise TypeError("Invalid comparison between dtype=str and int: the "
                        "resolution column holds text")
    return [row for row in unique if row.resolution < 5]


def run_preprocessing(meta_file: str, structure_folder: str,
                      output_file: str, workers: int = 16,
                      engine: str = "auto") -> list[dict]:
    """Full pipeline: TSV -> parallel parse -> filter -> save (reference
    __main__ :909-921). The native engine's C++ library is built (or
    loaded) here, once, before the workers start."""
    import multiprocessing as mp

    from e3diff_tpu_torch.data.dataset import save_complexes

    engine = resolve_engine(engine)
    print(f"preprocessing engine: {engine}"
          + ("" if engine == "biopython" else
             " (native DSSP deviates from mkdssp on beta-bulge edge "
             "cases and uses Shrake-Rupley ASA — see data/dssp.py)"))
    if engine == "native":
        from e3diff_tpu_torch import native

        if native.load_native_lib() is None:
            print("native DSSP library: off (E3DIFF_NATIVE=0), numpy engine")
        else:
            secs = native.BUILD_INFO["build_seconds"]
            print(f"native DSSP library: {native.BUILD_INFO['path']} ("
                  + ("loaded, already built" if secs is None
                     else f"built by g++ in {secs:.2f} s") + ")")
    rows = read_biolip_meta(meta_file)

    if workers > 1:
        # spawned workers: the caller may hold threads (torch, a server)
        # that a forked child would inherit mid-lock
        with mp.get_context("spawn").Pool(workers) as pool:
            parsed = pool.starmap(
                parse_record, [(r, structure_folder, engine) for r in rows])
    else:
        parsed = [parse_record(r, structure_folder, engine) for r in rows]

    records = filter_records(parsed)
    for r in records:
        # which DSSP engine produced the features: native and mkdssp
        # differ on documented edge cases, and LigandBindingSiteData warns
        # on a corpus that mixes them
        r["preprocess_engine"] = engine
    save_complexes(records, output_file)
    return records
