"""Plain reference of the two diffusion processes: the wrapped-Gaussian
DDPM over backbone angles (ancestral and DDIM steps) and the D3PM over
the 20 amino acids with the uniform transition (its posterior, indexed
through alpha_bar as the reference sampler does). Float32 tables from
float64 NumPy, written after LabJunBMI/E3-invaraint-diffusion-model
structure_model/utils.py:42-59 and sequence_model/utils.py:99-271;
imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def wrap(x):
    """To [-pi, pi)."""
    return (x + math.pi) % (2 * math.pi) - math.pi


def cosine_terms(timesteps: int, s: float = 8e-3) -> dict:
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    ac = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = np.clip(1 - ac[1:] / ac[:-1], 0.0001, 0.9999).astype(np.float32)
    betas = betas.astype(np.float64)
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    acp_prev = np.concatenate([[1.0], acp[:-1]])
    post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
    out = {"betas": betas, "alphas_cumprod": acp,
           "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - acp),
           "sqrt_alphas_cumprod": np.sqrt(acp),
           "sqrt_recip_alphas": 1.0 / np.sqrt(alphas),
           "sqrt_posterior_variance": np.sqrt(post_var)}
    return {k: v.astype(np.float32) for k, v in out.items()}


class Gaussian:
    def __init__(self, timesteps: int, device):
        self.T = timesteps
        self.terms = {k: torch.from_numpy(v).to(device)
                      for k, v in cosine_terms(timesteps).items()}

    def at(self, name, t):
        return self.terms[name][t][:, None, None]

    def q_sample(self, x0, t, noise):
        return wrap(self.at("sqrt_alphas_cumprod", t) * x0
                    + self.at("sqrt_one_minus_alphas_cumprod", t) * noise)

    def ddpm(self, x, eps, t, z):
        """x_{t-1}: the posterior mean plus its deviation times z (none at
        t = 0), wrapped."""
        mean = self.at("sqrt_recip_alphas", t) * (
            x - self.at("betas", t) * eps
            / self.at("sqrt_one_minus_alphas_cumprod", t))
        keep = (t > 0).float()[:, None, None]
        return wrap(mean + keep * self.at("sqrt_posterior_variance", t) * z)

    def ddpm_gain(self, t: int) -> float:
        """|d x_{t-1} / d eps| of one ancestral step."""
        tt = torch.tensor([t], device=self.terms["betas"].device)
        return float(self.at("sqrt_recip_alphas", tt) * self.at("betas", tt)
                     / self.at("sqrt_one_minus_alphas_cumprod", tt))

    def _ddim_coeffs(self, t, t_prev, eta):
        ac = self.terms["alphas_cumprod"]
        a_t = ac[t][:, None, None]
        a_prev = torch.where(t_prev >= 0, ac[t_prev.clamp(min=0)],
                             torch.ones_like(ac[t]))[:, None, None]
        sigma = (eta * torch.sqrt((1.0 - a_prev) / (1.0 - a_t))
                 * torch.sqrt(torch.clamp(1.0 - a_t / a_prev, min=0.0)))
        return a_t, a_prev, sigma

    def ddim(self, x, eps, t, t_prev, eta, z):
        """DDIM x_t -> x_{t_prev} (Song et al. 2020, eq. 12); t_prev < 0
        means to x0."""
        a_t, a_prev, sigma = self._ddim_coeffs(t, t_prev, eta)
        x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        direction = torch.sqrt(torch.clamp(1.0 - a_prev - sigma ** 2,
                                           min=0.0)) * eps
        keep = (t_prev >= 0).float()[:, None, None]
        return wrap(torch.sqrt(a_prev) * x0 + direction + keep * sigma * z)

    def ddim_gain(self, t: int, t_prev: int, eta: float) -> float:
        dev = self.terms["betas"].device
        a_t, a_prev, sigma = self._ddim_coeffs(
            torch.tensor([t], device=dev), torch.tensor([t_prev], device=dev),
            eta)
        g = (-torch.sqrt(a_prev) * torch.sqrt(1.0 - a_t) / torch.sqrt(a_t)
             + torch.sqrt(torch.clamp(1.0 - a_prev - sigma ** 2, min=0.0)))
        return float(g.abs())


def discrete_alphas_bar(timesteps: int, s: float = 8e-3) -> np.ndarray:
    """The D3PM's (T + 1,) alpha_bar: T + 2 cosine points over [0, T + 2],
    betas clamped to 0.9999, exp(cumsum(log alpha)) in float32."""
    steps = timesteps + 2
    x = np.linspace(0, steps, steps, dtype=np.float64)
    ac = np.cos(0.5 * np.pi * ((x / steps) + s) / (1 + s)) ** 2
    ac = ac / ac[0]
    betas = (1 - ac[1:] / ac[:-1]).astype(np.float32)
    alphas = (1.0 - np.clip(betas, 0.0, 0.9999)).astype(np.float32)
    return np.exp(np.cumsum(np.log(alphas))).astype(np.float32)


class D3PM:
    """Uniform transition: Q_bar(t) = ab(t) I + (1 - ab(t)) / K."""

    def __init__(self, timesteps: int, device, k: int = 20):
        ab = torch.from_numpy(discrete_alphas_bar(timesteps)).to(device)
        eye = torch.eye(k, device=device)[None]
        self.q_bar = ab[:, None, None] * eye + (1 - ab[:, None, None]) / k
        self.k = k

    def posterior(self, x_t, logits, s: int, t: int):
        """p(x_s | x_t, model) per token, (B, L, K), normalised: the
        one-step transition approximated as row-normalised
        Q_bar(s) / Q_bar(t), with the reference's guards."""
        qtb = self.q_bar[t][None].expand(x_t.shape[0], -1, -1)
        qsb = self.q_bar[s][None].expand(x_t.shape[0], -1, -1)
        ratio = qsb / qtb
        qt = ratio / ratio.sum(-1, keepdim=True)
        pred = torch.softmax(logits.float(), dim=-1)
        x_t = x_t.float()
        left = torch.einsum("blj,bkj->blk", x_t, qt)
        numerator = left[:, :, None, :] * qsb[:, None, :, :]
        denom = torch.einsum("bij,blj->bli", qtb, x_t)
        denom = torch.where(denom == 0, torch.full_like(denom, 1e-6), denom)
        post = numerator / denom[..., None]
        unnorm = (pred[..., None] * post).sum(dim=2)
        rowsum = unnorm.sum(-1, keepdim=True)
        unnorm = torch.where(rowsum == 0, torch.full_like(unnorm, 1e-5),
                             unnorm)
        return unnorm / unnorm.sum(-1, keepdim=True)
