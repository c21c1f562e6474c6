"""Minimal PDB writer for reconstructed backbones (the port's copy of
e3diff_tpu/geometry/pdb.py, whose text it reproduces byte for byte).

Every residue is written as GLY with N/CA/C/O atoms (occupancy 1.0,
B-factor 5.0, chain A), and the backbone bonds (C -> N peptide bonds,
N-CA, CA-C, C=O) as CONECT records, as the reference's biotite BondList
has them (structure_model/create_pdb.py:236-324).
"""

from __future__ import annotations

import numpy as np

_ATOM_NAMES = ["N", "CA", "C", "O"]
_ELEMENTS = ["N", "C", "C", "O"]


def _atom_line(serial: int, name: str, res_id: int, xyz, element: str) -> str:
    # PDB fixed-column ATOM record
    name_field = f" {name:<3s}" if len(name) < 4 else name
    return (f"ATOM  {serial:5d} {name_field:<4s} GLY A{res_id:4d}    "
            f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}{1.0:6.2f}{5.0:6.2f}"
            f"          {element:>2s}")


def backbone_pdb_text(coords: np.ndarray) -> str:
    """(4n, 3) N/CA/C/O coords -> PDB text (ATOM, CONECT, END)."""
    coords = np.asarray(coords)
    if len(coords) % 4:
        raise ValueError(f"expected 4n coordinates, got {len(coords)}")
    n_res = len(coords) // 4

    lines = []
    for i in range(n_res):
        for j in range(4):
            serial = i * 4 + j + 1
            lines.append(_atom_line(serial, _ATOM_NAMES[j], i + 1,
                                    coords[i * 4 + j], _ELEMENTS[j]))

    # bonds: within each residue N-CA, CA-C, C=O; peptide C(i-1) -> N(i)
    bonds: dict[int, list[int]] = {}

    def add_bond(a, b):
        bonds.setdefault(a, []).append(b)
        bonds.setdefault(b, []).append(a)

    prev_c = None
    for i in range(n_res):
        n_, ca, c, o = (i * 4 + 1, i * 4 + 2, i * 4 + 3, i * 4 + 4)
        if prev_c is not None:
            add_bond(prev_c, n_)
        add_bond(n_, ca)
        add_bond(ca, c)
        add_bond(c, o)
        prev_c = c

    for serial in sorted(bonds):
        partners = bonds[serial]
        for start in range(0, len(partners), 4):
            chunk = partners[start:start + 4]
            lines.append("CONECT" + f"{serial:5d}" +
                         "".join(f"{p:5d}" for p in chunk))
    lines.append("END")
    return "\n".join(lines) + "\n"


def write_backbone_pdb(coords: np.ndarray, out_fname: str) -> str:
    """coords: (4n, 3) in N, CA, C, O residue order. Returns out_fname."""
    with open(out_fname, "w") as f:
        f.write(backbone_pdb_text(coords))
    return out_fname


def read_backbone_pdb(fname: str) -> np.ndarray:
    """The ATOM coordinates of a PDB file, (n_atoms, 3)."""
    coords = []
    with open(fname) as f:
        for line in f:
            if line.startswith("ATOM"):
                coords.append([float(line[30:38]), float(line[38:46]),
                               float(line[46:54])])
    return np.asarray(coords)
