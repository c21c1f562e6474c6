"""The one traffic generator: every mix under ``benchmark/traffic/`` is a
JSON file of parameters that these functions read.

Work is fixed per mix, and the seed orders it: the sizes of the requests
or complexes and the gaps between arrivals are drawn from the mix's own
``base_seed``, so every run of a mix does the same work; ``--seed``
shuffles their order and draws the residues and angles.
"""

from __future__ import annotations

import itertools
import random

import numpy as np

AA = "ACDEFGHIKLMNPQRSTVWY"          # the 20-letter vocabulary, in order
SS = "HBEGITSL"                      # secondary-structure letters


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) & (2 ** 63 - 1))


def angles_like_backbones(rng, n: int) -> np.ndarray:
    """(n, 8) float32: 4 dihedrals uniform in [-pi, pi), 4 bond angles
    near their means (1.94, 2.03, 2.13, 2.1 rad, sd 0.05)."""
    return np.concatenate(
        [rng.uniform(-np.pi, np.pi, (n, 4)),
         rng.normal([1.94, 2.03, 2.13, 2.1], 0.05, (n, 4))],
        axis=1).astype(np.float32)


def sizes(mix: dict, n: int) -> list[tuple]:
    """n request sizes (pocket length, peptide length, designs) from the
    mix's base seed; bounds inclusive."""
    rng = _rng(mix["base_seed"])
    p, q, d = mix["pocket_len"], mix["peptide_len"], mix.get("designs",
                                                             [1, 1])
    return [(int(rng.integers(p[0], p[1] + 1)),
             int(rng.integers(q[0], q[1] + 1)),
             int(rng.integers(d[0], d[1] + 1))) for _ in range(n)]


def pocket_requests(mix: dict, n: int, seed: int,
                    rotate: bool = False) -> list[dict]:
    """n pocket requests: the mix's sizes in an order drawn from ``seed``
    (shuffled, or, with ``rotate``, the base sequence started at the
    seed's offset, as ``arrivals`` does, so that each size keeps its gap),
    each with random residues and backbone-like angles (after
    chip_smoke.py::pocket_requests: pockets of 16..64, peptides of 5..16)."""
    rng = _rng(seed)
    order = (np.roll(np.arange(n), -offset(seed, n)) if rotate
             else rng.permutation(n))
    all_sizes = sizes(mix, n)
    out = []
    for i in order:
        n_pocket, n_pep, n_designs = all_sizes[i]
        out.append({"sequence": "".join(rng.choice(list(AA), n_pocket)),
                    "angles": angles_like_backbones(rng, n_pocket),
                    "peptide_length": n_pep, "n_designs": n_designs})
    return out


def offset(seed: int, n: int) -> int:
    return int(_rng(seed).integers(n))


def arrivals(mix: dict, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the start) of the open loop's requests in a
    window of ``seconds``: round(rate x seconds) exponential gaps (Poisson
    arrivals at ``mix['rate_rps']``) drawn from the base seed and scaled
    to fill the window exactly, the sequence started at an offset drawn
    from ``seed``. Every seed offers the same requests at the same gaps
    and bursts, shifted in the window: a shuffle would make a burst of
    another size for every seed, and the tail with it."""
    n = max(1, round(mix["rate_rps"] * seconds))
    gaps = _rng(mix["base_seed"] + 1).exponential(1.0, n)
    gaps *= seconds / (gaps.sum() + gaps.mean())
    return np.cumsum(np.roll(gaps, -offset(seed, n)))


def synthetic_complexes(mix: dict, n: int, seed: int) -> list[dict]:
    """n complexes in the preprocessing schema (a frozen copy of
    e3diff_tpu_torch/data/synthetic.py::synthetic_complexes): receptor
    and ligand lengths from the base seed, in an order and with contents
    drawn from ``seed``."""
    size_rng = _rng(mix["base_seed"])
    r, q = mix["receptor_len"], mix["peptide_len"]
    lens = [(int(size_rng.integers(r[0], r[1] + 1)),
             int(size_rng.integers(q[0], q[1] + 1))) for _ in range(n)]
    rng = _rng(seed)
    out = []
    for j, i in enumerate(rng.permutation(n)):
        n_rec, n_lig = lens[i]
        total = n_rec + n_lig
        angle_features = angles_like_backbones(rng, total)
        n_pocket = max(1, int(n_rec * mix["pocket_frac"]))
        pocket_idx = np.sort(rng.choice(n_rec, n_pocket, replace=False))
        pocket_mask = np.zeros(total, bool)
        pocket_mask[pocket_idx] = True
        ligand_idx = list(range(n_rec, total))
        ligand_mask = np.zeros(total, bool)
        ligand_mask[n_rec:] = True
        out.append({
            "structure_ids": {"pdb_id": f"syn{j:05d}", "receptor_chain": "A",
                              "ligand_chain": "B"},
            "coors": rng.normal(size=(total, 3)).astype(np.float32),
            "amino_acid": list("".join(rng.choice(list(AA), total))),
            "secondary_structure": list("".join(rng.choice(list(SS), total))),
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


def pocket_extend_mask(pocket_mask: np.ndarray, ext: int) -> np.ndarray:
    """The reference's pocket extension (structure_model/dataset.py:
    104-109): the mask OR itself rolled by +ext and by -ext, with only the
    first (last) element of each roll cleared."""
    mask = np.asarray(pocket_mask, bool)
    left = np.roll(mask, ext)
    left[0] = False
    right = np.roll(mask, -ext)
    right[-1] = False
    return mask | left | right


def one_hot(seq, n: int = 20) -> np.ndarray:
    idx = np.asarray([AA.index(c) for c in seq], np.int64)
    return np.eye(n, dtype=np.float32)[idx]


def complex_arrays(rec: dict, max_len: int, ext: int,
                   ligand_max_len: int | None = None) -> dict:
    """One complex as the fixed-shape arrays a batch stacks: the ligand
    padded to ``ligand_max_len`` (default max_len), the pocket grown by
    ``ext`` and padded to max_len."""
    lig_len = ligand_max_len or max_len
    aa = one_hot(rec["amino_acid"])
    ang = np.asarray(rec["angle_features"], np.float32)
    lig = np.asarray(rec["ligand_mask"], bool)
    poc = pocket_extend_mask(rec["pocket_mask"], ext)

    def pad(x, n):
        if len(x) > n:
            raise ValueError(f"length {len(x)} exceeds {n}")
        return np.pad(x, [(0, n - len(x))] + [(0, 0)] * (x.ndim - 1))

    lm = np.zeros(lig_len, np.float32)
    lm[:lig.sum()] = 1.0
    pm = np.zeros(max_len, np.float32)
    pm[:poc.sum()] = 1.0
    return {"ligand_angles": pad(ang[lig], lig_len), "ligand_attn_mask": lm,
            "ligand_seq": pad(aa[lig], lig_len),
            "receptor_angles": pad(ang[poc], max_len),
            "receptor_attn_mask": pm, "receptor_seq": pad(aa[poc], max_len)}


def dataset_order(records: list) -> list:
    """The order the reference's dataset puts complexes in
    (structure_model/dataset.py:60-70: random.seed(0), then a shuffle)."""
    out = list(records)
    random.Random(0).shuffle(out)
    return out


def stack(rows: list[dict]) -> dict:
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}
