"""Dependency-free PDB and mmCIF readers for the preprocessing pipeline
(the port's copy of e3diff_tpu/data/native_structure.py).

The reference parses structures with Biopython's PDBParser / MMCIFParser
(clean_data/data_preprocessing.py:776-791). These readers build duck-typed
residues with the surface the pipeline uses (``res.get_id()``,
``res["CA"].get_coord()``, ``"O" in res``), so data/preprocessing.py runs
without Biopython.

Scope: PDB and mmCIF, either gzip-compressed, first MODEL only, the first
altloc of an atom kept, ATOM records plus HETATM MSE (selenomethionine,
read as MET). The mmCIF reader covers the ``_atom_site`` loop with auth_*
numbering (the identifiers Biopython's MMCIFParser exposes), not the whole
CIF grammar (no save frames; multi-line ``;`` values only outside the atom
loop, where they are skipped).
"""

from __future__ import annotations

import dataclasses
import gzip
import warnings

import numpy as np

THREE_TO_ONE = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C",
    "GLN": "Q", "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I",
    "LEU": "L", "LYS": "K", "MET": "M", "PHE": "F", "PRO": "P",
    "SER": "S", "THR": "T", "TRP": "W", "TYR": "Y", "VAL": "V",
    "MSE": "M",
}


@dataclasses.dataclass
class NativeAtom:
    name: str
    coord: np.ndarray
    element: str
    altloc: str

    def get_coord(self) -> np.ndarray:
        return self.coord


@dataclasses.dataclass
class NativeResidue:
    """Duck-types the Biopython Residue surface used by preprocessing."""

    resname: str
    seq_num: int
    icode: str
    atoms: dict  # name -> NativeAtom

    def get_id(self):
        # Biopython id tuple (hetflag, resseq, icode); icode ' ' when empty
        return (" ", self.seq_num, self.icode if self.icode else " ")

    def __getitem__(self, atom_name: str) -> NativeAtom:
        return self.atoms[atom_name]

    def __contains__(self, atom_name: str) -> bool:
        return atom_name in self.atoms

    @property
    def one_letter(self) -> str:
        return THREE_TO_ONE.get(self.resname, "X")

    @property
    def full_id_str(self) -> str:
        return (str(self.seq_num) + self.icode).strip()


def parse_pdb_chains(path: str) -> dict:
    """Parse a .pdb (or .pdb.gz) file -> {chain_id: [NativeResidue]} in
    file order. First MODEL only; for duplicate (atom, residue) entries
    the first altloc wins (Biopython's default keeps 'A'/blank, which
    comes first in well-formed files).

    Coordinates are converted in one bulk numpy parse over the fixed
    8-char columns (~2.5x faster than per-line float()); a token-count
    guard falls back to per-line parsing for malformed files so blank
    fields raise instead of silently misaligning."""
    opener = gzip.open if path.endswith(".gz") else open
    rows, coord_parts = [], []
    with opener(path, "rt") as f:
        for line in f:
            rec = line[:6]
            if rec == "ENDMDL":
                break  # first model only
            is_atom = rec == "ATOM  "
            is_mse = rec == "HETATM" and line[17:20] == "MSE"
            if not (is_atom or is_mse):
                continue
            name = line[12:16].strip()
            element = line[76:78].strip() if len(line) >= 78 else ""
            if not element:
                # first alphabetic char: hydrogen names like '1HB2' must
                # read as H (ASA excludes hydrogens), not as element '1'
                element = next((c for c in name if c.isalpha()), "")
            rows.append((line[21], line[17:20].strip(), int(line[22:26]),
                         line[26].strip(), name, line[16].strip(), element))
            coord_parts += (line[30:38], line[38:46], line[46:54])

    if rows:
        tokens = " ".join(coord_parts).split()
        if len(tokens) == 3 * len(rows):
            coords = np.array(tokens, dtype=np.float64).reshape(-1, 3)
        else:  # blank/fused fields: slow path surfaces the ValueError
            coords = np.array(
                [[float(coord_parts[3 * i]), float(coord_parts[3 * i + 1]),
                  float(coord_parts[3 * i + 2])] for i in range(len(rows))])
    chains: dict = {}
    index: dict = {}
    for i, (chain_id, resname, seq_num, icode, name, altloc,
            element) in enumerate(rows):
        key = (chain_id, seq_num, icode, resname)
        res = index.get(key)
        if res is None:
            res = NativeResidue(resname, seq_num, icode, {})
            index[key] = res
            chains.setdefault(chain_id, []).append(res)
        if name not in res.atoms:  # first altloc wins
            res.atoms[name] = NativeAtom(name, coords[i], element, altloc)
    return chains


# ---------------------------------------------------------------------------
# mmCIF (_atom_site loop)
# ---------------------------------------------------------------------------

def _cif_tokens(line: str) -> list[str]:
    """Whitespace-split honoring CIF single/double quoting. A quote ends a
    quoted value only when followed by whitespace/EOL (CIF rule, so values
    like O5' survive)."""
    tokens, i, n = [], 0, len(line)
    while i < n:
        while i < n and line[i] in " \t":
            i += 1
        if i >= n or line[i] == "#":
            break
        if line[i] in "'\"":
            q, j = line[i], i + 1
            while j < n and not (line[j] == q
                                 and (j + 1 >= n or line[j + 1] in " \t")):
                j += 1
            tokens.append(line[i + 1:j])
            i = j + 1
        else:
            j = i
            while j < n and line[j] not in " \t":
                j += 1
            tokens.append(line[i:j])
            i = j
    return tokens


def parse_cif_chains(path: str) -> dict:
    """Parse an mmCIF (or .cif.gz) `_atom_site` loop ->
    {auth chain_id: [NativeResidue]} in file order, matching
    parse_pdb_chains' semantics (first model, first altloc, ATOM +
    HETATM MSE)."""
    opener = gzip.open if path.endswith(".gz") else open
    chains: dict = {}
    index: dict = {}
    fields: list[str] = []
    in_atom_loop = False
    first_model: str | None = None
    with opener(path, "rt") as f:
        for raw in f:
            line = raw.rstrip("\n")
            if not in_atom_loop:
                stripped = line.strip()
                if stripped.startswith("_atom_site."):
                    fields.append(stripped.split()[0][len("_atom_site."):])
                elif fields:
                    in_atom_loop = True  # first data row reached
                else:
                    continue
            if in_atom_loop:
                stripped = line.strip()
                if not stripped or stripped.startswith("#"):
                    continue  # blank/comment lines are insignificant in CIF
                if stripped.startswith(("loop_", "_", "data_")):
                    break  # a new tag/loop/data block ends the atom loop
                tok = _cif_tokens(line)
                if len(tok) < len(fields):
                    warnings.warn(
                        f"{path}: _atom_site row with {len(tok)} values "
                        f"(expected {len(fields)}) skipped — wrapped or "
                        "malformed row?", stacklevel=2)
                    continue
                row = dict(zip(fields, tok))

                model = row.get("pdbx_PDB_model_num", "1")
                if first_model is None:
                    first_model = model
                elif model != first_model:
                    break
                group = row.get("group_PDB", "ATOM")
                resname = row.get("auth_comp_id",
                                  row.get("label_comp_id", ""))
                if group != "ATOM" and not (group == "HETATM"
                                            and resname == "MSE"):
                    continue
                chain_id = row.get("auth_asym_id",
                                   row.get("label_asym_id", "A"))
                try:
                    seq_num = int(row.get("auth_seq_id",
                                          row.get("label_seq_id", "0")))
                except ValueError:
                    continue
                icode = row.get("pdbx_PDB_ins_code", "?")
                icode = "" if icode in ("?", ".") else icode
                name = row.get("auth_atom_id", row.get("label_atom_id", ""))
                altloc = row.get("label_alt_id", ".")
                altloc = "" if altloc == "." else altloc
                element = row.get("type_symbol", "") or name[:1]
                try:
                    coord = np.array([float(row["Cartn_x"]),
                                      float(row["Cartn_y"]),
                                      float(row["Cartn_z"])],
                                     dtype=np.float64)
                except (KeyError, ValueError):
                    continue

                key = (chain_id, seq_num, icode, resname)
                res = index.get(key)
                if res is None:
                    res = NativeResidue(resname, seq_num, icode, {})
                    index[key] = res
                    chains.setdefault(chain_id, []).append(res)
                if name not in res.atoms:  # first altloc wins
                    res.atoms[name] = NativeAtom(name, coord, element,
                                                 altloc)
    return chains


def parse_structure_chains(path: str) -> dict:
    """Dispatch on extension: .pdb/.ent -> PDB reader, .cif -> mmCIF
    reader (either may be .gz-compressed)."""
    base = path[:-3] if path.endswith(".gz") else path
    if base.endswith(".cif"):
        return parse_cif_chains(path)
    return parse_pdb_chains(path)
