"""Plain reference of the backbone a design answer carries: NERF from the
8 generated angles (float64 NumPy) and the coordinates of PDB ATOM
records. Bond lengths, the first three atoms (1CRN's N, CA, C) and the
column roles follow the reference's NERF (structure_model/nerf.py, with
the angle-to-bond mapping of its sample.py): phi, psi, omega,
dihedral_o, then tau -> the CA-C bond angle, CA:C:1N -> C-N, 1C:N:CA ->
N-CA, CA:C:O -> C-O. Imports nothing of the program.
"""

from __future__ import annotations

import functools

import numpy as np

N_CA, CA_C, C_N, C_O = 1.46, 1.54, 1.34, 1.22
INIT = np.array([[17.047, 14.099, 3.625], [16.967, 12.784, 4.338],
                 [15.685, 12.755, 5.133]])


def _round(x, bf16):
    """Every intermediate rounded to bfloat16 in the control."""
    if not bf16:
        return x
    import torch

    return torch.as_tensor(np.asarray(x, np.float64)).to(
        torch.bfloat16).double().numpy()


def _place(a, b, c, bond_angle, length, torsion, bf16=False):
    r = functools.partial(_round, bf16=bf16)
    d = r(np.array([-length * np.cos(bond_angle),
                    length * np.cos(torsion) * np.sin(bond_angle),
                    length * np.sin(torsion) * np.sin(bond_angle)]))
    bc = r(r(c - b) / r(np.linalg.norm(c - b)))
    n = r(np.cross(b - a, bc))
    n = r(n / r(np.linalg.norm(n)))
    m = r(np.cross(n, bc))
    return r(bc * d[0] + m * d[1] + n * d[2] + c)


def backbone(angles: np.ndarray, bf16: bool = False) -> np.ndarray:
    """(L, 8) angles -> (4L, 3) N, CA, C, O coordinates, centred; with
    ``bf16``, every step rounded to bfloat16 (the control)."""
    a = np.asarray(angles, np.float64)
    atoms = [INIT[0], INIT[1], INIT[2]]
    for i in range(len(a) - 1):
        atoms.append(_place(atoms[-3], atoms[-2], atoms[-1], a[i, 5], C_N,
                            a[i, 1], bf16))
        atoms.append(_place(atoms[-3], atoms[-2], atoms[-1], a[i, 6], N_CA,
                            a[i, 2], bf16))
        atoms.append(_place(atoms[-3], atoms[-2], atoms[-1], a[i, 4], CA_C,
                            a[i + 1, 0], bf16))
    bb = np.stack(atoms).reshape(len(a), 3, 3)
    o = np.stack([_place(bb[i, 0], bb[i, 1], bb[i, 2], a[i, 7], C_O, a[i, 3],
                         bf16) for i in range(len(a))])
    xyz = np.concatenate([bb, o[:, None]], axis=1).reshape(-1, 3)
    return xyz - xyz.mean(0)


def pdb_coordinates(text: str) -> np.ndarray:
    """The (n, 3) coordinates of a PDB text's ATOM records, in order."""
    rows = [(float(ln[30:38]), float(ln[38:46]), float(ln[46:54]))
            for ln in text.splitlines() if ln.startswith("ATOM")]
    return np.asarray(rows, np.float64).reshape(-1, 3)


def pdb_names(text: str) -> list[str]:
    return [ln[12:16].strip() for ln in text.splitlines()
            if ln.startswith("ATOM")]
