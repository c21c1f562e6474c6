"""NERF (Natural Extension Reference Frame) backbone reconstruction
(counterpart of e3diff_tpu/geometry/nerf.py; structure_model/
create_pdb.py:40-234): N/CA/C atoms are placed in turn from the dihedral
triples (psi_i, omega_i, phi_{i+1}) and per-residue bond angles, then each
carbonyl O from its residue's (N, CA, C) frame, dihedral_o and the CA:C:O
angle.

Two implementations with one semantics:
* ``nerf_build_backbone_np``: NumPy float64, the oracle (the port's copy);
* ``nerf_build_backbone_batch``: float32 torch on the sampler's device, a
  batch at once, the counterpart of the JAX engine's
  ``jit(vmap(nerf_build_backbone))``. The N/CA/C recurrence is a loop over
  residues whose every step places one atom of every chain in the batch;
  the O pass is one vectorised placement. Nothing leaves the device.

Constants (create_pdb.py:23-32, 55-58): bond lengths N-CA 1.46, CA-C 1.54,
C-N 1.34, C-O 1.22 A; default bond angles 121/109/115/115 degrees; the
first three atoms are 1CRN's N, CA and C.
"""

from __future__ import annotations

import numpy as np
import torch

N_CA_LENGTH = 1.46
CA_C_LENGTH = 1.54
C_N_LENGTH = 1.34
C_O_LENGTH = 1.22

N_INIT = np.array([17.047, 14.099, 3.625])
CA_INIT = np.array([16.967, 12.784, 4.338])
C_INIT = np.array([15.685, 12.755, 5.133])

NERF_DEFAULTS = {
    "bond_len_n_ca": N_CA_LENGTH,
    "bond_len_ca_c": CA_C_LENGTH,
    "bond_len_c_n": C_N_LENGTH,
    "bond_len_c_o": C_O_LENGTH,
    "bond_angle_n_ca": 121 / 180 * np.pi,
    "bond_angle_ca_c": 109 / 180 * np.pi,   # tau
    "bond_angle_c_n": 115 / 180 * np.pi,
    "bond_angle_c_o": 115 / 180 * np.pi,
}


def place_dihedral(a, b, c, bond_angle, bond_length, torsion_angle):
    """Place d after a -> b -> c at the given internal coordinates
    (create_pdb.py:175-234). NumPy, single points (the oracle)."""
    ab = b - a
    bc = c - b
    bc = bc / np.linalg.norm(bc)
    n = np.cross(ab, bc)
    n = n / np.linalg.norm(n)
    nbc = np.cross(n, bc)
    m = np.stack([bc, nbc, n], axis=-1)
    d = np.array([
        -bond_length * np.cos(bond_angle),
        bond_length * np.cos(torsion_angle) * np.sin(bond_angle),
        bond_length * np.sin(torsion_angle) * np.sin(bond_angle),
    ])
    return m.dot(d) + c


def _as_per_residue(v, n):
    v = np.asarray(v, dtype=np.float64)
    return np.full(n, float(v)) if v.ndim == 0 else v.astype(np.float64)


def nerf_build_backbone_np(
    phi, psi, omega, dihedral_o,
    bond_angle_n_ca=NERF_DEFAULTS["bond_angle_n_ca"],
    bond_angle_ca_c=NERF_DEFAULTS["bond_angle_ca_c"],
    bond_angle_c_n=NERF_DEFAULTS["bond_angle_c_n"],
    bond_angle_c_o=NERF_DEFAULTS["bond_angle_c_o"],
    bond_len_n_ca=N_CA_LENGTH, bond_len_ca_c=CA_C_LENGTH,
    bond_len_c_n=C_N_LENGTH, bond_len_c_o=C_O_LENGTH,
    center: bool = True,
) -> np.ndarray:
    """NumPy oracle: (4n, 3) float64 coords, N, CA, C, O per residue."""
    phi = np.asarray(phi, np.float64)
    n = phi.shape[0]
    dih = np.stack([np.asarray(psi, np.float64)[:-1],
                    np.asarray(omega, np.float64)[:-1],
                    phi[1:]], axis=1)                       # (n-1, 3)
    ang_cn = _as_per_residue(bond_angle_c_n, n)
    ang_nca = _as_per_residue(bond_angle_n_ca, n)
    ang_cac = _as_per_residue(bond_angle_ca_c, n)
    ang_co = _as_per_residue(bond_angle_c_o, n)
    len_seq = [bond_len_c_n, bond_len_n_ca, bond_len_ca_c]

    coords = [N_INIT.copy(), CA_INIT.copy(), C_INIT.copy()]
    for i in range(n - 1):
        angles_i = [ang_cn[i], ang_nca[i], ang_cac[i]]
        for j in range(3):
            coords.append(place_dihedral(
                coords[-3], coords[-2], coords[-1],
                bond_angle=angles_i[j], bond_length=len_seq[j],
                torsion_angle=dih[i, j]))
    bb = np.asarray(coords).reshape(n, 3, 3)
    dih_o = np.asarray(dihedral_o, np.float64)
    o = np.stack([
        place_dihedral(bb[i, 0], bb[i, 1], bb[i, 2],
                       bond_angle=ang_co[i], bond_length=float(bond_len_c_o),
                       torsion_angle=dih_o[i])
        for i in range(n)])
    out = np.concatenate([bb, o[:, None]], axis=1).reshape(n * 4, 3)
    if center:
        out = out - out.mean(axis=0)
    return out


def _offset(bond_angle, bond_length, torsion):
    """The placement's local offset (-l cos a, l cos t sin a, l sin t sin
    a), (..., 3), for tensors of angles."""
    return torch.stack([-bond_length * torch.cos(bond_angle),
                        bond_length * torch.cos(torsion) * torch.sin(bond_angle),
                        bond_length * torch.sin(torsion) * torch.sin(bond_angle)],
                       dim=-1)


def _place(a, b, c, d):
    """d (..., 3) local offsets placed after a -> b -> c (..., 3)."""
    bc = c - b
    bc = bc / torch.linalg.vector_norm(bc, dim=-1, keepdim=True)
    nrm = torch.linalg.cross(b - a, bc, dim=-1)
    nrm = nrm / torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
    nbc = torch.linalg.cross(nrm, bc, dim=-1)
    return (bc * d[..., 0:1] + nbc * d[..., 1:2] + nrm * d[..., 2:3]) + c


def nerf_build_backbone_batch(angles: torch.Tensor) -> torch.Tensor:
    """(B, L, 8) sampled angles -> (B, 4L, 3) float32 N/CA/C/O coords on
    the same device, uncentred.

    Columns follow the Q1 mapping of geometry/chain.py: phi, psi, omega,
    dihedral_o, then tau -> the CA-C bond angle, CA:C:1N -> C-N, 1C:N:CA
    -> N-CA, CA:C:O -> C-O. Residue i's atoms depend only on residues
    <= i, so on a padded batch the valid prefix of each chain equals that
    chain's reconstruction alone; the caller trims and centres."""
    a = angles.float()
    bsz, n, _ = a.shape
    lengths = torch.tensor([C_N_LENGTH, N_CA_LENGTH, CA_C_LENGTH],
                           dtype=torch.float32, device=a.device)
    # every recurrence offset at once: (B, n-1, 3 placements, 3)
    dih = torch.stack([a[:, :-1, 1], a[:, :-1, 2], a[:, 1:, 0]], dim=-1)
    bond = torch.stack([a[:, :-1, 5], a[:, :-1, 6], a[:, :-1, 4]], dim=-1)
    offsets = _offset(bond, lengths, dih)
    init = torch.tensor(np.stack([N_INIT, CA_INIT, C_INIT]),
                        dtype=torch.float32, device=a.device)
    atoms = list(init[:, None, :].expand(3, bsz, 3).unbind(0))
    for i in range(n - 1):
        for j in range(3):
            atoms.append(_place(atoms[-3], atoms[-2], atoms[-1],
                                offsets[:, i, j]))
    bb = torch.stack(atoms, dim=1).reshape(bsz, n, 3, 3)
    o = _place(bb[:, :, 0], bb[:, :, 1], bb[:, :, 2],
               _offset(a[..., 7], C_O_LENGTH, a[..., 3]))
    return torch.cat([bb, o[:, :, None]], dim=2).reshape(bsz, 4 * n, 3)
