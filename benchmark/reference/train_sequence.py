"""Plain reference of the sequence model's train step (LabJunBMI/
E3-invaraint-diffusion-model sequence_model/model.py:291-367 and
utils.py:132-161, train_model.py:17-39): D3PM noising with the BLOSUM
transition (blosum.py), the forward in train mode (nets.py), CE over the
noised positions plus the ELBO, autograd, clipping by the global norm and
AdamW (train.py). Float32; imports nothing of the program.

One step, in the source's order:
* t uniform in {0..T}, T inclusive (the source's quirk Q10);
* Q_bar(t) through alpha_bar(t) (Q3), applied by column (Q8), and the
  noised class drawn (blosum.noise);
* the model conditioned on t / T (Q9: sampling conditions on the raw
  step);
* the noised positions are those whose noised class differs from the
  original one; the loss is the mean cross-entropy over them plus the
  ELBO over them (Q11): the one-hot target is softmaxed, the NLL term is
  the entropy of the prediction, the KL is torch's kl_div(log_softmax(
  pred + 1e-6), softmax(target), 'batchmean') over the noised rows.

The step draws, from one generator and in this order, what the program's
step draws: t, the (B, L, 20) Gumbel noise -log(-log(u)) (u uniform,
floored at float32's smallest normal), then the forward's dropout
uniforms and attention seeds (nets.py).

Departures from the source:
* the draws: the source draws t and each token's class from torch's
  global generator, its dropout from cuDNN's and torch's; here all come
  from one generator, the classes by the Gumbel argmax (blosum.py), the
  attention dropout as the Philox bits of philox.py;
* a masked mean over an empty set is 0, not NaN: every denominator is
  held at 1 or more;
* a padded batch (128 + 128) with masks, the noised mask over the whole
  padded length (padding stays class 0 on both sides, so it is never
  noised);
* optax's clip_by_global_norm and adamw with the epoch-wise linear
  warm-up (train.py), where the source runs torch's AdamW under
  Lightning's clipping;
* bf16 compute is modelled as train.py models it: each forward computes
  in float32 with the weights' bf16 copy (``matmul``) and the timestep
  entering in ``t_dtype``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import blosum, nets
from benchmark.reference.train import AdamW


def gumbel(shape, generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def loss_of(pred, noised_cls, x0):
    """CE over the noised positions + the ELBO over them."""
    pred = pred.float()
    target = x0.argmax(-1)
    sel = noised_cls != target
    n = max(int(sel.sum()), 1)
    logits = pred[sel]
    ce = F.cross_entropy(logits, target[sel], reduction="sum") / n
    onehot = x0[sel].float()
    probs2 = torch.softmax(onehot, dim=-1)
    log_probs1 = torch.log_softmax(logits + 1e-6, dim=-1)
    kl = F.kl_div(log_probs1, probs2, reduction="sum") / n
    nll = -(torch.softmax(logits, dim=-1) * log_probs1).sum() / n
    return ce + kl + nll


def train_steps(weights: dict, batches: list[dict], job: dict, cfg: dict,
                gen_seed: int, device, matmul=nets.f32_matmul,
                t_dtype=torch.float32, t_fixed=None):
    """Run len(batches) steps from ``weights`` (copied). Returns the
    losses, the first step's clipped gradients, the parameters after the
    last step and each step's noised classes (B, L). ``t_fixed``: each
    step's (B,) t in place of the draw (the draw is then not made)."""
    buffers = {k: v for k, v in weights.items() if k.endswith(".W")}
    params = {k: v.clone().requires_grad_(True) for k, v in weights.items()
              if k not in buffers}
    gen = torch.Generator(device=device).manual_seed(int(gen_seed))
    T = cfg["timesteps"]
    q_bar = blosum.q_bar_table(T, device)
    opt = AdamW(params, job)
    losses, first_grads, noised = [], None, []
    for batch in batches:
        x0 = batch["ligand_seq"].float()
        n = x0.shape[0]
        t = (torch.randint(0, T + 1, (n,), generator=gen, device=device)
             if t_fixed is None else t_fixed.to(device))
        cls = blosum.noise(q_bar[t], x0, gumbel(x0.shape, gen, device))
        x_t = F.one_hot(cls, x0.shape[-1]).float()
        ctx = nets.Ctx({**params, **buffers}, cfg["num_heads"],
                       cfg["max_seq_len"], matmul=matmul, t_dtype=t_dtype,
                       generator=gen, dropout=cfg["dropout_p"])
        pred = nets.sequence_forward(
            ctx, (t.float() / T)[:, None], x_t, batch["ligand_angles"],
            batch["ligand_attn_mask"], batch["receptor_seq"],
            batch["receptor_angles"], batch["receptor_attn_mask"])
        loss = loss_of(pred, cls, x0)
        grads = torch.autograd.grad(loss, list(params.values()))
        clipped = opt.step(params, dict(zip(params, grads)))
        if first_grads is None:
            first_grads = {k: g.detach() for k, g in clipped.items()}
        losses.append(float(loss.detach()))
        noised.append(cls)
    return (losses, first_grads, {k: v.detach() for k, v in params.items()},
            noised)
