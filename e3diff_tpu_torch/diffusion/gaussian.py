"""Continuous wrapped-Gaussian DDPM over backbone angles (counterpart of
e3diff_tpu/diffusion/gaussian.py): the reverse process, ancestral (DDPM)
and DDIM.

The schedule terms are float32 tensors on the sampler's device. Each
reverse loop is a Python loop over the timestep ladder; its noise comes
from a ``torch.Generator`` on the device, or is injected (``noise=``) so
that tests can hand both packages the same draws.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from e3diff_tpu_torch.ops.angles import wrap_angle
from e3diff_tpu_torch.ops.schedules import compute_alphas, cosine_beta_schedule
from e3diff_tpu_torch.utils.device import resolve_device


def sample_wrapped_noise(shape, *, generator: torch.Generator, device,
                         dtype=torch.float32):
    """N(0, I) wrapped to [-pi, pi) (reference sample_noise)."""
    return wrap_angle(torch.randn(shape, generator=generator, device=device,
                                  dtype=dtype))


def ddim_timesteps(timesteps: int, n_steps: int):
    """DDIM's descending ladder round(linspace(0, T-1, n))[::-1] and each
    step's target; t_prev = -1 means "to x0" (alpha_bar = 1)."""
    if n_steps <= 1:
        # a one-shot x0 prediction starts from the noise end
        ts = np.array([timesteps - 1], dtype=np.int64)
    else:
        ts = np.round(np.linspace(0, timesteps - 1, n_steps)).astype(
            np.int64)[::-1]
    t_prev = np.concatenate([ts[1:], [-1]]).astype(np.int64)
    return ts.copy(), t_prev


class GaussianAngleDiffusion:
    """Schedule-carrying continuous diffusion process; ``terms`` maps each
    name of ops.schedules.compute_alphas to a (T,) float32 tensor."""

    def __init__(self, timesteps: int, terms: dict):
        self.timesteps = timesteps
        self.terms = terms

    @classmethod
    def cosine(cls, timesteps: int = 1000, device="cuda"):
        device = resolve_device(device)
        terms = compute_alphas(cosine_beta_schedule(timesteps))
        return cls(timesteps, {k: torch.from_numpy(v).to(device)
                               for k, v in terms.items()})

    def _at(self, name, t):
        return self.terms[name][t][:, None, None]

    def p_mean(self, x_t, eps_hat, t):
        """DDPM posterior mean for eps-prediction; t: (B,) ints."""
        sra = self._at("sqrt_recip_alphas", t)
        beta = self._at("betas", t)
        somac = self._at("sqrt_one_minus_alphas_cumprod", t)
        return sra * (x_t - beta * eps_hat / somac)

    def p_step(self, x_t, eps_hat, t, z):
        """One ancestral step: mean + sqrt(posterior variance) z, the noise
        dropped at t == 0, wrapped to [-pi, pi)."""
        mean = self.p_mean(x_t, eps_hat, t)
        spv = self._at("sqrt_posterior_variance", t)
        keep_noise = (t > 0).to(x_t.dtype)[:, None, None]
        return wrap_angle(mean + keep_noise * spv * z)

    def ddim_step(self, x_t, eps_hat, t, t_prev, eta: float, z):
        """One DDIM update x_t -> x_{t_prev} (Song et al. 2020, eq. 12);
        t_prev < 0 means a_bar_prev = 1."""
        ac = self.terms["alphas_cumprod"]
        a_t = ac[t][:, None, None]
        a_prev = torch.where(t_prev >= 0, ac[t_prev.clamp(min=0)],
                             1.0)[:, None, None]
        x0_pred = (x_t - torch.sqrt(1.0 - a_t) * eps_hat) / torch.sqrt(a_t)
        sigma = (eta * torch.sqrt((1.0 - a_prev) / (1.0 - a_t))
                 * torch.sqrt(torch.clamp(1.0 - a_t / a_prev, min=0.0)))
        dir_term = torch.sqrt(
            torch.clamp(1.0 - a_prev - sigma ** 2, min=0.0)) * eps_hat
        keep = (t_prev >= 0).to(x_t.dtype)[:, None, None]
        return wrap_angle(torch.sqrt(a_prev) * x0_pred + dir_term
                          + keep * sigma * z)

    def _loop(self, steps, denoise_fn, x_init, generator, noise,
              return_trajectory, update):
        x = x_init
        b = x.shape[0]
        traj = (torch.empty((len(steps),) + tuple(x.shape), dtype=x.dtype,
                            device=x.device) if return_trajectory else None)
        for i, step in enumerate(steps):
            t_vec = torch.full((b,), int(step[0]), dtype=torch.long,
                               device=x.device)
            eps_hat = denoise_fn(t_vec, x)
            z = (noise[i] if noise is not None else
                 torch.randn(x.shape, generator=generator, device=x.device,
                             dtype=x.dtype))
            x = update(x, eps_hat, t_vec, step, z)
            if traj is not None:
                traj[i] = x
        return x, traj

    def sample_loop(self, denoise_fn: Callable, x_init, *,
                    generator: torch.Generator | None = None, noise=None,
                    step: int = 1, return_trajectory: bool = True):
        """Ancestral sampling over reversed(range(0, T, step)).

        denoise_fn: (t_vec, x_t) -> eps_hat. noise: optional (n, B, L, F)
        per-step z's in place of draws from ``generator``. Returns the
        final sample and, if asked, the (n, B, L, F) trajectory (index 0 is
        t = T-1)."""
        steps = [(t,) for t in reversed(range(0, self.timesteps, step))]
        return self._loop(steps, denoise_fn, x_init, generator, noise,
                          return_trajectory,
                          lambda x, eps, t, _, z: self.p_step(x, eps, t, z))

    def sample_loop_ddim(self, denoise_fn: Callable, x_init, *,
                         generator: torch.Generator | None = None,
                         noise=None, n_steps: int = 50, eta: float = 1.0,
                         return_trajectory: bool = False):
        """DDIM over ``ddim_timesteps(T, n_steps)`` (n_steps forwards)."""
        ts, t_prev = ddim_timesteps(self.timesteps, n_steps)
        steps = list(zip(ts.tolist(), t_prev.tolist()))

        def update(x, eps, t_vec, pair, z):
            tp_vec = torch.full_like(t_vec, pair[1])
            return self.ddim_step(x, eps, t_vec, tp_vec, eta, z)

        return self._loop(steps, denoise_fn, x_init, generator, noise,
                          return_trajectory, update)
