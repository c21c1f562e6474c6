"""Plain reference of the sequence D3PM's BLOSUM transition (LabJunBMI/
E3-invaraint-diffusion-model sequence_model/utils.py:273-314) and of its
forward noising (sequence_model/model.py:291-311). Float32; imports
nothing of the program.

Q_bar(t) = clamp(softmax(score / tau_b[round(alpha_bar(t) * 500)], over
each row), 1e-6): ``score`` is the asset's 20 x 20 ``original_score``,
``tau_b`` its 500-entry ``Qtb_temperature`` ladder stretched to 501
entries by linear interpolation with aligned corners. The transition's
own timestep is 500 whatever the diffusion's T (50 here), and it is
indexed by alpha_bar(t), not by t / T (the source's quirk Q3), so t = 0
is near uniform and t = T near the identity.

Departures from the source:
* the asset is the repository's ``assets/blosum_substitute.npz``, the
  source's ``blosum_substitute.pt`` converted to NumPy;
* the ladder is interpolated in float64 and rounded to float32 once;
* the noised class is argmax(log p + Gumbel noise), which draws from the
  same categorical distribution as the source's per-token
  ``prob.multinomial(1)`` loop, with the Gumbel noise handed in;
* a padding row (an all-zero one-hot) becomes class 0, where the source
  would draw from an all-zero distribution.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.diffusion import discrete_alphas_bar

ASSET = (Path(__file__).resolve().parents[2] / "assets"
         / "blosum_substitute.npz")
TRANSITION_STEPS = 500


def q_bar_table(timesteps: int, device) -> torch.Tensor:
    """(T + 1, 20, 20) float32: Q_bar at every integer step 0..T, row i
    the distribution (over j) that the source's softmax(dim=2) gives."""
    with np.load(ASSET) as z:
        score = torch.from_numpy(z["original_score"].astype(np.float32))
        ladder = torch.from_numpy(z["Qtb_temperature"].astype(np.float64))
    tau = F.interpolate(ladder[None, None], size=TRANSITION_STEPS + 1,
                        mode="linear", align_corners=True)[0, 0].float()
    ab = torch.from_numpy(discrete_alphas_bar(timesteps))
    idx = torch.round(ab * TRANSITION_STEPS).long().clamp(
        0, TRANSITION_STEPS)
    q = torch.softmax(score[None] / tau[idx][:, None, None], dim=2)
    return q.clamp(min=1e-6).to(device)


def noise(q_bar_t: torch.Tensor, x0: torch.Tensor,
          gumbel: torch.Tensor) -> torch.Tensor:
    """Noised classes (B, L) int64 of one-hots ``x0`` (B, L, 20) under
    ``q_bar_t`` (B, 20, 20): p[b, l, i] = Q_bar[b, i, class(b, l)], the
    column of the token's class (the source's Q_bar @ x, quirk Q8), then
    argmax(log p + gumbel); padding rows give class 0."""
    b, length, k = x0.shape
    cls = x0.argmax(-1)
    p = torch.gather(q_bar_t, 2, cls[:, None, :].expand(b, k, length))
    p = p.transpose(1, 2)                                      # (B, L, K)
    draw = torch.argmax(torch.log(p) + gumbel, dim=-1)
    return torch.where(x0.sum(-1) > 0, draw, torch.zeros_like(draw))
