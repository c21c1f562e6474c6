"""Sample-quality evaluation (counterpart of e3diff_tpu/utils/evaluation.py).

The reference scores designs by per-sample amino-acid recovery
(sequence_model/sample.py:216-228) and leaves a wrapped-angle error recipe
as a comment (create_pdb.py:450-453); both are here, with distribution-level
comparisons of pooled angle sets and the geometry of the backbones NERF
rebuilds from them. Everything runs on the host in float64 numpy; the
functions take numpy arrays or tensors on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from e3diff_tpu_torch.data.dataset import FEATURE_NAMES
from e3diff_tpu_torch.geometry.chain import backbone_coords_from_angles
from e3diff_tpu_torch.ops.angles import wrap_angle


def _np(x) -> np.ndarray:
    """A numpy array of ``x``, copied off the device where it is a tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def recovery_rate(pred_idx, true_idx, mask) -> float:
    m = _np(mask).astype(bool)
    denom = max(m.sum(), 1)
    return float((_np(pred_idx)[m] == _np(true_idx)[m]).sum() / denom)


def mean_wrapped_angle_error(true_angles, generated) -> np.ndarray:
    """Per-feature mean wrapped error as a fraction of a full turn, the
    reference's recipe: abs(wrap(d).mean(0) / pi * 180) / 360."""
    d = _np(true_angles) - _np(generated)
    wrapped = wrap_angle(d)
    return np.abs(wrapped.mean(axis=0) / np.pi * 180) / 360


def angle_histograms(angles, bins: int = 36) -> np.ndarray:
    """Per-feature probability mass in ``bins`` bins over [-pi, pi).
    angles: (N, F) pooled valid residues. Returns (F, bins)."""
    angles = _np(angles)
    out = []
    for i in range(angles.shape[1]):
        h, _ = np.histogram(angles[:, i], bins=bins, range=(-np.pi, np.pi),
                            density=True)
        out.append(h * (2 * np.pi / bins))   # probability mass per bin
    return np.stack(out)


def histogram_distance(a, b, bins: int = 36) -> np.ndarray:
    """Per-feature total-variation distance between two pooled angle sets
    (0 = identical distributions, 1 = disjoint)."""
    ha = angle_histograms(a, bins)
    hb = angle_histograms(b, bins)
    return 0.5 * np.abs(ha - hb).sum(axis=1)


def joint_histogram_distance(a, b, i: int = 0, j: int = 1,
                             bins: int = 24) -> float:
    """Total-variation distance between two pooled 2-D angle-pair
    distributions (by default the first two columns, the dataset's 'phi'
    and 'psi', physically omega and phi under quirk Q1): the marginals can
    agree while the joint basins real backbones occupy are wrong."""
    a, b = _np(a), _np(b)
    rng = ((-np.pi, np.pi), (-np.pi, np.pi))
    ha, _, _ = np.histogram2d(a[:, i], a[:, j], bins=bins, range=rng)
    hb, _, _ = np.histogram2d(b[:, i], b[:, j], bins=bins, range=rng)
    ha = ha / max(ha.sum(), 1)
    hb = hb / max(hb.sum(), 1)
    return float(0.5 * np.abs(ha - hb).sum())


def backbone_clash_fraction(coords, threshold: float = 2.0) -> float:
    """Fraction of non-bonded backbone atom pairs closer than ``threshold``
    A in a (4N, 3) N/CA/C/O backbone. Pairs within a residue or between
    adjacent residues are bonded at NERF's ideal geometry and left out;
    anything else under 2 A is a steric clash. NaN below 3 residues or
    with a non-finite coordinate."""
    coords = _np(coords).astype(np.float64)
    m = coords.shape[0]
    if m < 12 or not np.isfinite(coords).all():
        return float("nan")
    res = np.arange(m) // 4                  # residue index per atom
    d = np.linalg.norm(coords[:, None] - coords[None, :], axis=-1)
    sep = np.abs(res[:, None] - res[None, :])
    nonbonded = sep >= 2                     # >= 2 residues apart
    iu = np.triu_indices(m, 1)
    mask = nonbonded[iu]
    if not mask.any():
        return float("nan")
    return float((d[iu][mask] < threshold).mean())


def radius_of_gyration(coords) -> float:
    """Rg of a backbone coordinate set (A)."""
    coords = _np(coords).astype(np.float64)
    c = coords - coords.mean(0)
    return float(np.sqrt((c ** 2).sum(axis=1).mean()))


def summarize_samples(sampled, reference,
                      feature_names=tuple(FEATURE_NAMES)) -> dict:
    """Pool per-sample (len_i, F) angle matrices and compare their
    distributions: per-feature and mean TV, the joint (phi, psi) TV."""
    pooled_s = np.concatenate([_np(s).reshape(-1, len(feature_names))
                               for s in sampled])
    pooled_r = np.concatenate([_np(r).reshape(-1, len(feature_names))
                               for r in reference])
    tv = histogram_distance(pooled_s, pooled_r)
    return {
        "tv_distance": dict(zip(feature_names, tv.round(4).tolist())),
        "tv_distance_mean": float(tv.mean()),
        "joint_tv_phi_psi": round(
            joint_histogram_distance(pooled_s, pooled_r, 0, 1), 4),
        "n_sampled_residues": int(pooled_s.shape[0]),
        "n_reference_residues": int(pooled_r.shape[0]),
    }


def geometry_summary(angle_sets) -> dict:
    """Rebuild each (len_i, 8) angle matrix into a backbone with the
    float64 NERF (geometry/chain.py) and summarise clashes and
    compactness. NaN reconstructions are counted, as the reference's
    create_pdb guards and skips them (create_pdb.py:393-395)."""
    clashes, rgs, n_nan = [], [], 0
    for s in angle_sets:
        s = _np(s).astype(np.float64)
        if s.shape[0] < 3:
            continue
        coords = backbone_coords_from_angles(s)
        if coords is None:
            n_nan += 1
            continue
        clashes.append(backbone_clash_fraction(coords))
        rgs.append(radius_of_gyration(coords))
    clash = np.asarray([c for c in clashes if np.isfinite(c)])
    return {
        "n_structures": len(angle_sets),
        "n_nan_reconstructions": n_nan,
        "clash_fraction_mean": (float(clash.mean()) if clash.size
                                else float("nan")),
        "clash_free_structures": (float((clash == 0).mean()) if clash.size
                                  else float("nan")),
        "rg_mean": float(np.mean(rgs)) if rgs else float("nan"),
        "rg_std": float(np.std(rgs)) if rgs else float("nan"),
    }
