"""Discrete D3PM over the 20 amino-acid classes (counterpart of
e3diff_tpu/diffusion/d3pm.py): the forward noising of training (reference
PeptideDiff.apply_aa_noise, sequence_model/model.py:291-311) and the
reverse process (sequence_model/sample.py:112-229).

Quirks kept exactly (SURVEY.md):
  Q3 - the transition is indexed by alpha_bar(t), not t/T;
  Q8 - the transition is applied column-wise, prob_i = Q_bar[i, j] for a
       one-hot x of class j;
  Q9 - the model is conditioned on the raw integer step s while sampling.

The one-step transition is approximated as row-normalise(Qsb / Qtb), as in
the reference, with its guards (a zero denominator becomes 1e-6, a row of
zero mass becomes 1e-5 everywhere before it is normalised); at the last
step (s = 0) the model's raw logits are the output. A categorical draw is
argmax(log p + Gumbel noise), the draw jax.random.categorical makes; the
Gumbel noise comes from a ``torch.Generator`` on the device, or is
injected so that tests can hand both packages the same draws.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from e3diff_tpu_torch.ops.schedules import DiscreteNoiseSchedule
from e3diff_tpu_torch.utils.device import resolve_device


def sample_gumbel(shape, *, generator: torch.Generator, device):
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1), as
    jax.random.gumbel draws it (from other random bits)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class D3PMDiffusion:
    """alphas_bar: the (T+1,) float32 schedule on the sampler's device;
    transition: a UniformTransition or BlosumTransition."""

    def __init__(self, timesteps: int, alphas_bar: torch.Tensor, transition,
                 num_classes: int = 20):
        self.timesteps = timesteps
        self.alphas_bar = alphas_bar
        self.transition = transition
        self.num_classes = num_classes

    @classmethod
    def create(cls, transition, timesteps: int = 50, num_classes: int = 20,
               device="cuda"):
        device = resolve_device(device)
        sched = DiscreteNoiseSchedule.cosine(timesteps)
        return cls(timesteps, torch.from_numpy(sched.alphas_bar).to(device),
                   transition, num_classes)

    def _qt_bar(self, b: int, step: int):
        """(B, K, K) Q_bar at an integer step, through alpha_bar (Q3)."""
        idx = torch.full((b,), step, dtype=torch.long,
                         device=self.alphas_bar.device)
        return self.transition.get_Qt_bar(self.alphas_bar[idx])

    def qt_bar_from_t_int(self, t_int):
        """(B, K, K) Q_bar at per-example integer steps, indexed by
        alpha_bar(t) (Q3): the transition maps alpha_bar through its own
        ladder."""
        idx = torch.as_tensor(t_int).to(torch.long).reshape(-1)
        return self.transition.get_Qt_bar(
            self.alphas_bar[idx.to(self.alphas_bar.device)])

    def aa_noise_probs(self, ligand_seq, t_int):
        """Per-token unnormalised substitution probabilities (B, L, K):
        prob[b, l, i] = sum_j Q_bar[b, i, j] x[b, l, j], the column
        orientation of Q8. ligand_seq: (B, L, K) one-hot, all-zero rows at
        padding; t_int: (B,) steps in 0..T inclusive."""
        return torch.einsum("bij,blj->bli", self.qt_bar_from_t_int(t_int),
                            ligand_seq.float())

    def apply_aa_noise(self, ligand_seq, t_int, *,
                       generator: torch.Generator | None = None,
                       gumbel=None):
        """Noised one-hots in ligand_seq's dtype: argmax(log p + Gumbel)
        per token (jax.random.categorical's draw), ``gumbel`` (B, L, K)
        replacing the draw from ``generator``; a token of zero probability
        (padding) becomes class 0."""
        probs = self.aa_noise_probs(ligand_seq, t_int)
        logits = torch.log(torch.clamp(probs, min=1e-30))
        if gumbel is None:
            gumbel = sample_gumbel(probs.shape, generator=generator,
                                   device=probs.device)
        draws = torch.argmax(logits + gumbel, dim=-1)
        draws = torch.where(probs.sum(-1) > 0, draws, 0)
        return F.one_hot(draws, self.num_classes).to(ligand_seq.dtype)

    def posterior_probs(self, x_t, pred_logits, s_int: int,
                        t_int: int | None = None):
        """p(x_s | x_t, model) for every token, (B, L, K) normalised; the
        whole batch shares the step s. t defaults to s + 1 (the
        reference's adjacent step); a larger t takes the same ratio
        approximation over a jump s <- t (skip sampling, not in the
        reference).

        The softmax of the logits is taken in their dtype, as the JAX
        package does (in bf16 under bf16 compute); every product after it
        is float32."""
        b = x_t.shape[0]
        qtb = self._qt_bar(b, s_int + 1 if t_int is None else t_int)
        qsb = self._qt_bar(b, s_int)
        ratio = qsb / qtb
        qt = ratio / ratio.sum(-1, keepdim=True)                 # (B,K,K)
        pred = torch.softmax(pred_logits, dim=-1).float()        # (B,L,K)
        x_t = x_t.float()
        left = torch.einsum("blj,bkj->blk", x_t, qt)             # (B,L,Ks)
        numerator = left[:, :, None, :] * qsb[:, None, :, :]     # (B,L,K0,Ks)
        denom = torch.einsum("bij,blj->bli", qtb, x_t)           # (B,L,K0)
        denom = torch.where(denom == 0, 1e-6, denom)
        posterior = numerator / denom[..., None]
        unnorm = (pred[..., None] * posterior).sum(dim=2)        # (B,L,Ks)
        rowsum = unnorm.sum(-1, keepdim=True)
        unnorm = torch.where(rowsum == 0, 1e-5, unnorm)
        return unnorm / unnorm.sum(-1, keepdim=True)

    def posterior_sample(self, x_t, pred_logits, s_int: int,
                         diverse: bool = True, t_int: int | None = None, *,
                         generator: torch.Generator | None = None,
                         gumbel=None):
        """One-hot x_s in x_t's dtype: a categorical draw from the
        posterior (``diverse``; ``gumbel`` (B, L, K) replaces the draw from
        ``generator``) or its argmax."""
        probs = self.posterior_probs(x_t, pred_logits, s_int, t_int)
        if diverse:
            if gumbel is None:
                gumbel = sample_gumbel(probs.shape, generator=generator,
                                       device=probs.device)
            draws = torch.argmax(torch.log(probs) + gumbel, dim=-1)
        else:
            draws = torch.argmax(probs, dim=-1)
        return F.one_hot(draws, self.num_classes).to(x_t.dtype)

    def init_noise(self, batch_size: int, length: int, *,
                   generator: torch.Generator, device, dtype=torch.float32):
        """Uniform random one-hots (generate_discrete_noise,
        sequence_model/sample.py:112-116)."""
        idx = torch.randint(0, self.num_classes, (batch_size, length),
                            generator=generator, device=device)
        return F.one_hot(idx, self.num_classes).to(dtype)

    def step_pairs(self, n_steps: int | None = None) -> list[tuple[int, int]]:
        """The reverse loop's (s, t) pairs: s = T-1 .. 1 with t = s + 1, or,
        for n_steps < T - 1, an evenly spaced descending ladder from T-1 to
        1 whose first jump starts at t = T (x_init is the marginal at
        T - 1) and each later one at the previous entry."""
        T = self.timesteps
        if n_steps is None or n_steps >= T - 1:
            s = np.arange(T - 1, 0, -1)
            return list(zip(s.tolist(), (s + 1).tolist()))
        ladder = np.round(np.linspace(T - 1, 1, max(n_steps, 1))).astype(
            np.int64)
        t = np.concatenate([[T], ladder[:-1]])
        return list(zip(ladder.tolist(), t.tolist()))

    def sample_loop(self, denoise_fn: Callable, x_init, *,
                    generator: torch.Generator | None = None, gumbel=None,
                    diverse: bool = True, n_steps: int | None = None):
        """Reverse loop over ``step_pairs(n_steps)``, one model call per
        pair, then the final call at s = 0 whose raw logits are returned
        (argmax downstream): len(step_pairs) + 1 forwards in all.

        denoise_fn: (s (B, 1) in x's dtype, x one-hot) -> logits; the
        model sees the raw integer step (Q9). gumbel: optional
        (n_pairs, B, L, K) draws in place of ``generator``'s."""
        x = x_init
        b = x.shape[0]
        for i, (s, t) in enumerate(self.step_pairs(n_steps)):
            s_arr = torch.full((b, 1), float(s), dtype=x.dtype,
                               device=x.device)
            logits = denoise_fn(s_arr, x)
            x = self.posterior_sample(
                x, logits, s, diverse, t_int=t, generator=generator,
                gumbel=None if gumbel is None else gumbel[i])
        return denoise_fn(torch.zeros((b, 1), dtype=x.dtype,
                                      device=x.device), x)
