"""Sampled angles -> PDB chains (the port's copy of
e3diff_tpu/geometry/chain.py; create_new_chain_nerf /
write_preds_pdb_folder, structure_model/create_pdb.py:326-421).

Column semantics (quirk Q1, create_pdb.py:38): of FEATURE_NAMES
["phi", "psi", "omega", "dihedral_o", "tau", "CA:C:1N", "1C:N:CA",
"CA:C:O"], tau -> the CA-C bond angle, CA:C:1N -> C-N, 1C:N:CA -> N-CA,
CA:C:O -> C-O. The names do not match the physical angles preprocessing
stores, but the whole pipeline is consistent under them; kept as is.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from e3diff_tpu_torch.data.dataset import FEATURE_NAMES
from e3diff_tpu_torch.geometry.nerf import nerf_build_backbone_np
from e3diff_tpu_torch.geometry.pdb import write_backbone_pdb
from e3diff_tpu_torch.ops.angles import wrap_angle

REQUIRED_DIHEDRALS = ["phi", "psi", "omega", "dihedral_o"]
_ANGLE_TO_KWARG = {
    "tau": "bond_angle_ca_c",
    "N:CA:C": "bond_angle_ca_c",
    "CA:C:1N": "bond_angle_c_n",
    "1C:N:CA": "bond_angle_n_ca",
    "CA:C:O": "bond_angle_c_o",
}
_DIST_TO_KWARG = {
    "0C:1N": "bond_len_c_n",
    "N:CA": "bond_len_n_ca",
    "CA:C": "bond_len_ca_c",
}


def backbone_coords_from_angles(
    angles: np.ndarray,
    feature_names: Sequence[str] = tuple(FEATURE_NAMES),
    center_coords: bool = True,
) -> np.ndarray | None:
    """(n_res, n_feat) angles -> (4 n_res, 3) float64 coords by the NumPy
    NERF under the Q1 mapping, or None where the coordinates hold a NaN
    (the reference's guard, create_pdb.py:393-395)."""
    angles = np.asarray(angles)
    cols = {n: angles[:, i] for i, n in enumerate(feature_names)}
    # distances have exactly one ':' in the name; angles otherwise
    dists = {n: v for n, v in cols.items() if n.count(":") == 1}
    angles_named = {n: v for n, v in cols.items() if n.count(":") != 1}
    missing = [d for d in REQUIRED_DIHEDRALS if d not in angles_named]
    if missing:
        raise ValueError(f"missing dihedrals {missing} in {list(cols)}")
    kwargs = {name: angles_named[name] for name in REQUIRED_DIHEDRALS}
    for name, val in angles_named.items():
        if name not in REQUIRED_DIHEDRALS:
            kwargs[_ANGLE_TO_KWARG[name]] = val
    for name, val in dists.items():
        kwargs[_DIST_TO_KWARG[name]] = val
    coords = nerf_build_backbone_np(center=center_coords, **kwargs)
    if np.any(np.isnan(coords)):
        return None
    return coords


def create_chain_from_angles(
    angles: np.ndarray,
    out_fname: str,
    feature_names: Sequence[str] = tuple(FEATURE_NAMES),
    center_coords: bool = True,
) -> str:
    """Write one chain's PDB; returns its path, or "" where the
    coordinates hold a NaN (nothing is written)."""
    coords = backbone_coords_from_angles(angles, feature_names,
                                         center_coords)
    if coords is None:
        return ""
    return write_backbone_pdb(coords, out_fname)


def write_pdb_folder(
    sampled: Sequence[np.ndarray],
    outdir: str,
    basename_prefix: str = "generated_",
    feature_names: Sequence[str] = tuple(FEATURE_NAMES),
) -> list[str]:
    """One PDB per sampled angle matrix, ``{prefix}{i}.pdb``
    (write_preds_pdb_folder, create_pdb.py:403-421)."""
    os.makedirs(outdir, exist_ok=True)
    return [create_chain_from_angles(
                np.asarray(sample),
                os.path.join(outdir, f"{basename_prefix}{i}.pdb"),
                feature_names=feature_names)
            for i, sample in enumerate(sampled)]


def angle_error_rate(true_angles: np.ndarray, generated: np.ndarray) -> np.ndarray:
    """Mean wrapped-angle error per feature as a fraction of a full turn,
    the reference's recipe (create_pdb.py:450-453):
    abs(wrap(d).mean(axis=0) / pi * 180) / 360."""
    wrapped = wrap_angle(np.asarray(true_angles) - np.asarray(generated))
    return np.abs(wrapped.mean(axis=0) / np.pi * 180) / 360
