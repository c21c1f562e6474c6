"""Synthetic complexes in the biolip.pt schema, for tests and benchmarks
(copy of e3diff_tpu/data/synthetic.py).

Generates records shaped exactly like the output of
clean_data/data_preprocessing.py:838-893 (create_data): per-residue angle
features in radians, amino-acid / secondary-structure strings, CA coords,
pocket/ligand masks, and the (unused downstream) bipartite edge_index —
so the whole pipeline can run end-to-end without BioLiP/DSSP.
"""

from __future__ import annotations

import itertools

import numpy as np

from e3diff_tpu_torch.data.dataset import AA_VOCAB, SS_VOCAB


def synthetic_complexes(
    n: int = 8,
    seed: int = 0,
    receptor_len_range: tuple[int, int] = (18, 40),
    ligand_len_range: tuple[int, int] = (5, 15),
    pocket_frac: float = 0.4,
) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        n_rec = int(rng.integers(*receptor_len_range))
        n_lig = int(rng.integers(*ligand_len_range))
        total = n_rec + n_lig

        # dihedrals in [-pi, pi); bond angles clustered like real backbones
        dihedrals = rng.uniform(-np.pi, np.pi, (total, 4))
        bond_angles = rng.normal(
            [1.94, 2.03, 2.13, 2.1], 0.05, (total, 4))
        angle_features = np.concatenate(
            [dihedrals, bond_angles], axis=1).astype(np.float32)

        aa = "".join(rng.choice(list(AA_VOCAB), total))
        ss = "".join(rng.choice(list(SS_VOCAB), total))

        n_pocket = max(1, int(n_rec * pocket_frac))
        pocket_idx = np.sort(rng.choice(n_rec, n_pocket, replace=False))
        pocket_mask = np.zeros(total, bool)
        pocket_mask[pocket_idx] = True
        ligand_idx = list(range(n_rec, total))
        ligand_mask = np.zeros(total, bool)
        ligand_mask[n_rec:] = True

        out.append({
            "structure_ids": {"pdb_id": f"syn{i:04d}", "receptor_chain": "A",
                              "ligand_chain": "B"},
            "coors": rng.normal(size=(total, 3)).astype(np.float32),
            "amino_acid": list(aa),
            "secondary_structure": list(ss),
            "numerical_features": rng.random((total, 5)).astype(np.float32),
            "angle_features": angle_features,
            "edge_index": np.array(
                list(itertools.product(ligand_idx, pocket_idx.tolist())),
                dtype=np.int64).T.reshape(2, -1),
            "ligand_mask": ligand_mask,
            "ligand_idx": np.asarray(ligand_idx, np.int32),
            "pocket_mask": pocket_mask,
            "pocket_idx": pocket_idx.astype(np.int32),
        })
    return out
