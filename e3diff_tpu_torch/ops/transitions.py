"""D3PM transition kernels, uniform and BLOSUM-tempered softmax
(counterpart of e3diff_tpu/ops/transitions.py; sequence_model/utils.py:
235-314).

The BLOSUM kernel reads the repository's converted asset
``assets/blosum_substitute.npz`` in place (the 20x20 substitution scores
and two 500-entry temperature ladders) and checks its SHA-256 first.

Quirk Q3 (kept on purpose): every caller passes alpha_bar(t), not t/T, as
``t_normal`` to ``get_Qt_bar``. alpha_bar falls with t while the
temperature ladder rises with its index, so small t maps to a
near-uniform transition and t = T to a near-identity one. The classes keep
the reference's call signature, so the quirk lives at the call sites.

Matrices are float32 tensors of shape (B, K, K) on the device of the
argument (the BLOSUM tables live on the device given at construction).
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import torch

from e3diff_tpu_torch.utils.device import resolve_device

ASSET_PATH = (Path(__file__).resolve().parent.parent.parent / "assets"
              / "blosum_substitute.npz")
ASSET_SHA256 = ("71b0a77ea9b2f388457e3346b31c3c01"
                "83cb9b6b7a3f9852a500e70fd69e5121")


def load_blosum_asset(path=None) -> dict[str, np.ndarray]:
    """original_score (20, 20), Qtb_temperature (500,), Qt_temperature
    (500,), all float32. The repository's own asset is checked against its
    SHA-256; a caller's ``path`` is read as given."""
    if path is None:
        path = ASSET_PATH
        digest = hashlib.sha256(path.read_bytes()).hexdigest()
        if digest != ASSET_SHA256:
            raise ValueError(f"{path}: SHA-256 {digest}, expected "
                             f"{ASSET_SHA256}")
    with np.load(path) as z:
        return {k: z[k].astype(np.float32) for k in z.files}


def interpolate_linear_align_corners(v: np.ndarray, out_size: int) -> np.ndarray:
    """1-D linear interpolation as torch F.interpolate(align_corners=True)
    computes it, in float64: output j reads input coordinate
    j (in - 1) / (out - 1). The reference stretches the 500-entry ladders
    to T + 1 = 501 entries with it (sequence_model/utils.py:286-290)."""
    v = np.asarray(v, dtype=np.float64)
    in_size = v.shape[0]
    if out_size == in_size:
        return v.astype(np.float32)
    pos = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, in_size - 2)
    frac = pos - i0
    out = v[i0] * (1 - frac) + v[i0 + 1] * frac
    return out.astype(np.float32)


def _column(x) -> torch.Tensor:
    """(B,) or (B, 1) values -> (B, 1, 1) float32."""
    return torch.as_tensor(x).to(torch.float32).reshape(-1, 1, 1)


class UniformTransition:
    """Qt_bar = ab I + (1 - ab) / K (DiscreteUniformTransition,
    sequence_model/utils.py:235-271)."""

    def __init__(self, num_classes: int = 20):
        self.num_classes = num_classes

    def _eye_and_uniform(self, device):
        k = self.num_classes
        eye = torch.eye(k, dtype=torch.float32, device=device)[None]
        return eye, torch.full((1, k, k), 1.0 / k, device=device)

    def get_Qt(self, beta_t):
        beta_t = _column(beta_t)
        eye, u = self._eye_and_uniform(beta_t.device)
        return beta_t * u + (1 - beta_t) * eye

    def get_Qt_bar(self, alpha_bar_t):
        alpha_bar_t = _column(alpha_bar_t)
        eye, u = self._eye_and_uniform(alpha_bar_t.device)
        return alpha_bar_t * eye + (1 - alpha_bar_t) * u


class BlosumTransition:
    """BLOSUM-tempered softmax transition (BlosumTransition,
    sequence_model/utils.py:273-314). Its internal ``timestep`` stays 500
    even when the diffusion has T = 50, as in the reference, so the lookup
    index is round(t_normal * 500) into the 501-entry ladder. Qt_bar rows
    are softmax(score / temperature) floored at 1e-6 after the softmax,
    without renormalising."""

    def __init__(self, asset: dict[str, np.ndarray] | None = None,
                 num_classes: int = 20, timestep: int = 500, device="cuda"):
        device = resolve_device(device)
        asset = asset or load_blosum_asset()
        self.num_classes = num_classes
        self.timestep = timestep
        self.original_score = torch.as_tensor(
            np.asarray(asset["original_score"], np.float32), device=device)
        self.qtb_temperature, self.qt_temperature = (
            torch.from_numpy(interpolate_linear_align_corners(
                asset[name], timestep + 1)).to(device)
            for name in ("Qtb_temperature", "Qt_temperature"))

    def _idx(self, t_normal):
        t = torch.as_tensor(t_normal).to(torch.float32).reshape(-1)
        return torch.clamp(torch.round(t * self.timestep).long(), 0,
                           self.timestep)

    def _softmax(self, temperature, t_normal):
        temp = temperature[self._idx(t_normal).to(temperature.device)]
        return torch.softmax(self.original_score[None] / temp[:, None, None],
                             dim=2)

    def get_Qt_bar(self, t_normal):
        return torch.clamp(self._softmax(self.qtb_temperature, t_normal),
                           min=1e-6)

    def get_Qt(self, t_normal):
        return self._softmax(self.qt_temperature, t_normal)
