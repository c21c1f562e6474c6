"""Ligand/binding-site dataset: loading, splits, pocket extension, padding
(numpy copy of e3diff_tpu/data/dataset.py, kept here so the port never
imports the JAX package).

Behaviour-defining details kept exactly:
* split: ``random.seed(0); random.shuffle(data)`` with Python's RNG over
  the stored complex order, then 80/10/10 contiguous slices: the
  reference's split identity;
* pocket extension (quirk Q2): mask | roll(mask, +ext) | roll(mask, -ext)
  with only element [0] / [-1] of the rolled copies cleared, including the
  reference's wraparound leak for ext > 1;
* one-hot vocabularies AA_VOCAB / SS_VOCAB, zero-padding, prefix attention
  masks.
"""

from __future__ import annotations

import pickle
import random
from typing import Iterator

import numpy as np

AA_VOCAB = "ACDEFGHIKLMNPQRSTVWY"
SS_VOCAB = "HBEGITS-"
FEATURE_NAMES = ["phi", "psi", "omega", "dihedral_o",
                 "tau", "CA:C:1N", "1C:N:CA", "CA:C:O"]

# non-array bookkeeping keys carried by LigandBindingSiteData.batches()
# that must never reach a device transfer
BATCH_META_KEYS = ("num_valid", "structure_ids")


def strip_meta(batch: dict) -> dict:
    """Drop the host-only bookkeeping keys from a batch dict."""
    return {k: v for k, v in batch.items() if k not in BATCH_META_KEYS}


def one_hot_encode(sequence: str, vocab: str) -> np.ndarray:
    idx = np.array([vocab.index(c) for c in sequence], dtype=np.int64)
    return np.eye(len(vocab), dtype=np.float32)[idx]


def load_complexes(path: str) -> list[dict]:
    """Load a complex list from biolip.pt (torch) or native pickle/npz."""
    if str(path).endswith(".pt"):
        import torch

        data = torch.load(path, map_location="cpu", weights_only=False)
        out = []
        for d in data:
            c = {}
            for k, v in d.items():
                c[k] = v.numpy() if hasattr(v, "numpy") else v
            out.append(c)
        return out
    with open(path, "rb") as f:
        return pickle.load(f)


def save_complexes(data: list[dict], path: str) -> None:
    """Write a complex list as the native pickle ``load_complexes`` reads."""
    with open(path, "wb") as f:
        pickle.dump(data, f)


def split_complexes(data: list, split: str | None):
    """Reference split: seeded Python shuffle then 80/10/10 slices
    (structure_model/dataset.py:60-70). Mutates a copy."""
    data = list(data)
    random.seed(0)
    random.shuffle(data)
    if split is None:
        return data
    split_idx = int(len(data) * 0.8)
    val_len = int(len(data) * 0.1)
    if split == "train":
        return data[:split_idx]
    if split == "validation":
        return data[split_idx:split_idx + val_len]
    if split == "test":
        return data[split_idx + val_len:]
    raise ValueError(f"unknown split {split}")


def pocket_extend_mask(pocket_mask: np.ndarray, ext: int) -> np.ndarray:
    """Quirk-Q2-faithful pocket extension
    (structure_model/dataset.py:104-109)."""
    pocket_mask = pocket_mask.astype(bool)
    left = np.roll(pocket_mask, ext)
    left[0] = False
    right = np.roll(pocket_mask, -ext)
    right[-1] = False
    return pocket_mask | left | right


def suggest_buckets(complexes: list[dict], pocket_ext: int,
                    multiple: int = 8) -> tuple[int, int]:
    """The smallest (ligand_max_len, receptor_max_len) covering every
    complex, each rounded up to ``multiple``: peptides are short (5..16
    residues) while extended pockets need 64 or 128, so separate buckets
    cut the decoder's tokens about 4x."""
    lig_max = poc_max = 1
    for d in complexes:
        lig_max = max(lig_max, int(np.asarray(d["ligand_mask"]).sum()))
        poc = pocket_extend_mask(np.asarray(d["pocket_mask"]), pocket_ext)
        poc_max = max(poc_max, int(poc.sum()))

    def round_up(x):
        return ((x + multiple - 1) // multiple) * multiple

    return round_up(lig_max), round_up(poc_max)


def _pad_to(x: np.ndarray, max_len: int) -> np.ndarray:
    if x.shape[0] > max_len:
        raise RuntimeError(
            f"Length exceed: {x.shape[0]} > {max_len}")
    pad = [(0, max_len - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad)


class LigandBindingSiteData:
    """One split of the dataset as stacked fixed-shape arrays.

    Fields (numpy, N = number of complexes):
      ligand_angles   (N, max_len, 8)    ligand_attn_mask (N, max_len)
      ligand_seq      (N, max_len, 20)   receptor_angles  (N, max_len, 8)
      receptor_attn_mask (N, max_len)    receptor_seq     (N, max_len, 20)
      ligand_length / receptor_length (N,)   structure_ids: list of dicts
    """

    feature_names = FEATURE_NAMES

    def __init__(self, complexes: list[dict], split: str | None,
                 max_len: int = 64, pocket_ext: int = 1,
                 ligand_max_len: int | None = None):
        """ligand_max_len enables bucketed ligand padding: peptides are
        short (>=5, typically <=16 residues) while pockets need the full
        max_len, so padding the ligand to its own bucket cuts decoder
        tokens ~4x at sampling time. None = max_len (reference-faithful:
        both sides padded identically)."""
        self.max_len = max_len
        self.ligand_max_len = ligand_max_len or max_len
        self.pocket_ext = pocket_ext
        engines = {d.get("preprocess_engine") for d in complexes} - {None}
        if len(engines) > 1:
            import warnings

            warnings.warn(
                f"complex list mixes preprocessing engines {sorted(engines)}"
                " — native and mkdssp DSSP features differ on documented "
                "edge cases; regenerate with one engine.", stacklevel=2)
        complexes = split_complexes(complexes, split)

        fields = {k: [] for k in [
            "ligand_angles", "ligand_attn_mask", "ligand_seq",
            "receptor_angles", "receptor_attn_mask", "receptor_seq",
            "ligand_length", "receptor_length"]}
        self.structure_ids = []

        for d in complexes:
            aa = d["amino_acid"]
            if isinstance(aa, (list, np.ndarray)) and not (
                    isinstance(aa, np.ndarray) and aa.ndim == 2):
                aa = one_hot_encode("".join(aa), AA_VOCAB)
            angles = np.asarray(d["angle_features"], dtype=np.float32)
            lig_mask = np.asarray(d["ligand_mask"], dtype=bool)
            pocket = pocket_extend_mask(np.asarray(d["pocket_mask"]),
                                        self.pocket_ext)

            lig_angles = angles[lig_mask]
            lig_seq = np.asarray(aa, dtype=np.float32)[lig_mask]
            poc_angles = angles[pocket]
            poc_seq = np.asarray(aa, dtype=np.float32)[pocket]

            lam = np.zeros(self.ligand_max_len, np.float32)
            lam[:lig_mask.sum()] = 1.0
            pam = np.zeros(max_len, np.float32)
            pam[:pocket.sum()] = 1.0

            fields["ligand_angles"].append(
                _pad_to(lig_angles, self.ligand_max_len))
            fields["ligand_attn_mask"].append(lam)
            fields["ligand_seq"].append(_pad_to(lig_seq, self.ligand_max_len))
            fields["receptor_angles"].append(_pad_to(poc_angles, max_len))
            fields["receptor_attn_mask"].append(pam)
            fields["receptor_seq"].append(_pad_to(poc_seq, max_len))
            fields["ligand_length"].append(int(lig_mask.sum()))
            fields["receptor_length"].append(int(pocket.sum()))
            self.structure_ids.append(d.get("structure_ids", {}))

        self.arrays = {k: np.stack(v).astype(np.float32)
                       if k not in ("ligand_length", "receptor_length")
                       else np.asarray(v, np.int32)
                       for k, v in fields.items()}

    def __len__(self) -> int:
        return len(self.structure_ids)

    def __getitem__(self, i) -> dict:
        return {k: v[i] for k, v in self.arrays.items()}

    def batches(self, batch_size: int, *, shuffle: bool = False,
                seed: int = 0, drop_last: bool = False,
                pad_final: bool = True) -> Iterator[dict]:
        """Yield fixed-shape batches. The final partial batch is zero-padded
        to batch_size (padded examples have all-zero attention masks and
        drop out of every masked loss/metric) unless pad_final=False."""
        n = len(self)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for start in range(0, n, batch_size):
            idx = order[start:start + batch_size]
            ids = [self.structure_ids[j] for j in idx]
            if len(idx) < batch_size:
                if drop_last:
                    return
                if pad_final:
                    batch = {}
                    for k, v in self.arrays.items():
                        pad_shape = (batch_size - len(idx),) + v.shape[1:]
                        batch[k] = np.concatenate(
                            [v[idx], np.zeros(pad_shape, v.dtype)])
                    batch["num_valid"] = np.int32(len(idx))
                    batch["structure_ids"] = ids
                    yield batch
                    return
            batch = {k: v[idx] for k, v in self.arrays.items()}
            batch["num_valid"] = np.int32(len(idx))
            batch["structure_ids"] = ids
            yield batch
