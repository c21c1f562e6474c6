"""The comparisons that decide ``correct``: the program's outputs against
the plain reference (benchmark/reference/), each reduced to one number
that is held to its limit in the cell's file.

Structure steps: the gap between the program's state after a step and
the reference's step from the program's state before it, wrapped to
(-pi, pi] and divided by the step's gain |dx'/d eps|, is the error of the
program's noise prediction; its root mean square over the live ligand
positions, over that of the reference's prediction, is the step's
reading, and the number compared is the largest over the followed steps.
Only steps whose gain is at most ``max_gain`` are read: where the gain is
larger (the first steps from pure noise) a rounding of eps moves x by more
than a turn.

Sequence steps: the program's draw at each live position is the argmax of
log p + Gumbel; the reading is how far the drawn class's score lies below
the best score under the reference's posterior from the same state, the
widest gap over positions and steps. The final call's tokens (the served
sequence) are read the same way against the reference's logits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import nets
from benchmark.reference.diffusion import D3PM, Gaussian, wrap


def exact_gap(a, b) -> float:
    """0 when the tensors are equal bit for bit, else their largest
    absolute difference (inf where shapes differ or a value is NaN)."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    if a.shape != b.shape:
        return math.inf
    if torch.equal(a, b):
        return 0.0
    d = (a - b).abs()
    return math.inf if torch.isnan(d).any() else float(d.max())


def _dev(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


@torch.no_grad()
def structure_steps(ctx, diff: Gaussian, batch, states, table, z_all, *,
                    ddim, eta, max_gain, device):
    """Over the followed steps whose gain is at most ``max_gain``: the
    summed squared eps errors and squared reference predictions (their
    ratio's root is the relative error, pooled), the worst single step's
    relative error, and how many steps were read."""
    b = _dev(batch, device)
    enc = nets.structure_encode(ctx, b["receptor_seq"], b["receptor_angles"],
                                b["receptor_attn_mask"])
    mask = b["ligand_attn_mask"].float()[..., None].expand(
        -1, -1, 8).bool()
    worst, read, err2, ref2 = 0.0, 0, 0.0, 0.0
    ts, tps = table
    for k, (before, after) in sorted(states.items()):
        t, tp = int(ts[k]), int(tps[k])
        gain = (diff.ddim_gain(t, tp, eta) if ddim else diff.ddpm_gain(t))
        if gain > max_gain:
            continue
        x = before.to(device).float()
        tv = torch.full((x.shape[0],), t, device=device, dtype=torch.long)
        eps = nets.structure_decode(ctx, tv, x, b["ligand_attn_mask"], enc,
                                    b["receptor_attn_mask"])
        z = z_all[k].to(device).float()
        if ddim:
            ref = diff.ddim(x, eps, tv, torch.full_like(tv, tp), eta, z)
        else:
            ref = diff.ddpm(x, eps, tv, z)
        err = wrap(after.to(device).float() - ref)[mask] / gain
        e2, r2 = float(err.pow(2).sum()), float(eps[mask].pow(2).sum())
        worst = max(worst, math.sqrt(e2 / r2))
        err2, ref2, read = err2 + e2, ref2 + r2, read + 1
    return err2, ref2, worst, read


@torch.no_grad()
def sequence_steps(ctx, d3pm: D3PM, batch, states, pairs, gumbel, final_x,
                   final_logits, device):
    """Over live positions: the count of (position, step) draws whose
    class is not the best under the reference's posterior and the count
    of draws, the widest gap of a drawn class, the widest gap of a served
    token under the final call, and the final logits' summed squared
    error and summed squared reference logits."""
    b = _dev(batch, device)
    live = b["ligand_attn_mask"].bool()
    args = (b["ligand_angles"], b["ligand_attn_mask"], b["receptor_seq"],
            b["receptor_angles"], b["receptor_attn_mask"])
    n = live.shape[0]
    step_gap, missed, seen = 0.0, 0, 0
    for k, (before, after) in sorted(states.items()):
        s, t = pairs[k]
        x = before.to(device).float()
        sv = torch.full((n, 1), float(s), device=device)
        logits = nets.sequence_forward(ctx, sv, x, *args)
        probs = d3pm.posterior(x, logits, s, t)
        score = torch.log(probs) + gumbel[k].to(device).float()
        drawn = after.to(device).float().argmax(-1)
        gap = score.amax(-1) - score.gather(-1, drawn[..., None])[..., 0]
        if live.any():
            step_gap = max(step_gap, float(gap[live].max()))
            missed += int((score.argmax(-1) != drawn)[live].sum())
            seen += int(live.sum())
    x = final_x.to(device).float()
    logits = nets.sequence_forward(ctx, torch.zeros((n, 1), device=device),
                                   x, *args)
    prog = final_logits.to(device).float()
    served = prog.argmax(-1)
    gap = logits.amax(-1) - logits.gather(-1, served[..., None])[..., 0]
    if not live.any():
        return missed, seen, step_gap, 0.0, 0.0, 0.0
    return (missed, seen, step_gap, float(gap[live].max()),
            float((prog - logits)[live].pow(2).sum()),
            float(logits[live].pow(2).sum()))


def pdb_gap(answer_pdb: str, angles, control: bool = False) -> float:
    """Largest coordinate difference (Å) between a served PDB and the
    reference NERF of the served angles; inf when the atoms differ. With
    ``control``, the reference NERF in bfloat16 stands in the program's
    place: its coordinates are read instead of the PDB's."""
    from benchmark.reference.geometry import backbone, pdb_coordinates, \
        pdb_names

    ref = backbone(np.asarray(angles, np.float64))
    got = (backbone(np.asarray(angles, np.float64), bf16=True) if control
           else pdb_coordinates(answer_pdb))
    names = pdb_names(answer_pdb)
    if got.shape != ref.shape or names != ["N", "CA", "C", "O"] * (
            len(ref) // 4):
        return math.inf
    return float(np.abs(got - ref).max())
