"""Continuous wrapped-Gaussian DDPM over backbone angles (counterpart of
e3diff_tpu/diffusion/gaussian.py): the forward noising of training and the
reverse process, ancestral (DDPM) and DDIM.

The schedule terms are float32 tensors on the sampler's device. A reverse
run is ``n`` calls of ``reverse_step`` over the device buffers of a
``ReverseState``: the step reads its index from a device tensor, gathers
its timestep and noise from device tables, updates the sample in place and
advances the index, so the same call can be captured once as a CUDA graph
and replayed (sampling/structure.py) or looped eagerly, as here. All of a
run's noise is drawn before its first step (x_init, then every step's z at
once) from a ``torch.Generator`` on the device, or is injected
(``noise=``, ``t=``) so that tests can hand both packages the same draws.
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass
class ReverseState:
    """The device buffers one reverse run reads and writes: ``x`` (B, L, F)
    the current sample, updated in place; ``z`` (n, B, L, F) each step's
    noise; ``i`` (1,) int64 the next step's index; ``t`` and ``t_prev``
    (n,) int64 each step's timestep and target (t_prev < 0: to x0);
    ``traj`` (n, B, L, F) every step's output, or None."""

    x: torch.Tensor
    z: torch.Tensor
    i: torch.Tensor
    t: torch.Tensor
    t_prev: torch.Tensor
    traj: torch.Tensor | None = None


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

    def q_sample(self, x0, t, noise):
        """x_t = wrap(sqrt(a_bar_t) x0 + sqrt(1 - a_bar_t) eps); t: (B,)
        ints (_add_noise_by_timestep, structure_model/dataset.py:214-229)."""
        return wrap_angle(self._at("sqrt_alphas_cumprod", t) * x0
                          + self._at("sqrt_one_minus_alphas_cumprod", t)
                          * noise)

    def noise_batch(self, x0, *, generator: torch.Generator | None = None,
                    t=None, noise=None):
        """(t, eps, x_t) for a training batch: t uniform in [0, T) and eps
        wrapped N(0, I), drawn from ``generator`` in that order unless
        injected."""
        if t is None:
            t = torch.randint(0, self.timesteps, (x0.shape[0],),
                              generator=generator, device=x0.device)
        if noise is None:
            noise = sample_wrapped_noise(x0.shape, generator=generator,
                                         device=x0.device, dtype=x0.dtype)
        return t, noise, self.q_sample(x0, t, noise)

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

    def ladder(self, sampler: str, *, step: int = 1, n_steps: int = 50):
        """(t, t_prev) int64 arrays of a reverse run: DDPM over
        reversed(range(0, T, step)) (t_prev = t - step), DDIM over
        ``ddim_timesteps(T, n_steps)``."""
        if sampler == "ddim":
            return ddim_timesteps(self.timesteps, n_steps)
        if sampler != "ddpm":
            raise ValueError(f"unknown sampler {sampler!r}")
        ts = np.arange(0, self.timesteps, step, dtype=np.int64)[::-1].copy()
        return ts, ts - step

    def reverse_step(self, denoise_fn: Callable, st: ReverseState, *,
                     ddim: bool, eta: float = 1.0) -> None:
        """One reverse step at index ``st.i``: eps_hat = denoise_fn(t_vec,
        x), then ``p_step`` (or ``ddim_step``) with that step's noise,
        written into ``st.x`` (and ``st.traj[i]``); ``st.i`` advances by
        one. Nothing here reads a value back to the host, so the call can
        be captured as a CUDA graph."""
        b = st.x.shape[0]
        t_vec = st.t.index_select(0, st.i).expand(b)
        eps_hat = denoise_fn(t_vec, st.x)
        z = st.z.index_select(0, st.i)[0]
        if ddim:
            x = self.ddim_step(st.x, eps_hat, t_vec,
                               st.t_prev.index_select(0, st.i).expand(b),
                               eta, z)
        else:
            x = self.p_step(st.x, eps_hat, t_vec, z)
        st.x.copy_(x)
        if st.traj is not None:
            st.traj.index_copy_(0, st.i, x[None].to(st.traj.dtype))
        st.i += 1

    def reverse_state(self, x_init, z, ts, t_prev,
                      return_trajectory: bool,
                      trajectory_dtype: torch.dtype | None = None
                      ) -> ReverseState:
        """A ReverseState on x_init's device holding a copy of x_init, the
        noise and the ladder, at step 0. ``trajectory_dtype`` (bf16, say):
        the stored trajectory's type, x's when None; the carried x keeps
        x_init's (the JAX package's ``trajectory_dtype``,
        e3diff_tpu/diffusion/gaussian.py:106-129)."""
        dev = x_init.device

        def table(v):
            return torch.as_tensor(np.asarray(v, np.int64), device=dev)

        return ReverseState(
            x=x_init.clone(), z=z.to(device=dev, dtype=x_init.dtype),
            i=torch.zeros(1, dtype=torch.long, device=dev), t=table(ts),
            t_prev=table(t_prev),
            traj=(torch.empty((len(ts),) + tuple(x_init.shape),
                              dtype=trajectory_dtype or x_init.dtype,
                              device=dev)
                  if return_trajectory else None))

    def draw_noise(self, shape, n_steps: int, *, generator, device,
                   dtype=torch.float32):
        """A run's draws from ``generator``, in this order: the wrapped
        x_init (B, L, F), then every step's z (n_steps, B, L, F)."""
        x_init = sample_wrapped_noise(shape, generator=generator,
                                      device=device, dtype=dtype)
        z = torch.randn((n_steps,) + tuple(shape), generator=generator,
                        device=device, dtype=dtype)
        return x_init, z

    def _run(self, denoise_fn, x_init, ts, t_prev, generator, noise,
             return_trajectory, trajectory_dtype, ddim, eta=1.0):
        if noise is None:
            noise = torch.randn((len(ts),) + tuple(x_init.shape),
                                generator=generator, device=x_init.device,
                                dtype=x_init.dtype)
        st = self.reverse_state(x_init, noise, ts, t_prev, return_trajectory,
                                trajectory_dtype)
        for _ in range(len(ts)):
            self.reverse_step(denoise_fn, st, ddim=ddim, eta=eta)
        return st.x, st.traj

    def sample_loop(self, denoise_fn: Callable, x_init, *,
                    generator: torch.Generator | None = None, noise=None,
                    step: int = 1, return_trajectory: bool = True,
                    trajectory_dtype: torch.dtype | None = None):
        """Ancestral sampling over reversed(range(0, T, step)).

        denoise_fn: (t_vec, x_t) -> eps_hat. noise: optional (n, B, L, F)
        per-step z's in place of draws from ``generator`` (all n drawn
        before the first step). Returns the final sample and, if asked,
        the (n, B, L, F) trajectory (index 0 is t = T-1), stored in
        ``trajectory_dtype`` (x's type when None)."""
        ts, t_prev = self.ladder("ddpm", step=step)
        return self._run(denoise_fn, x_init, ts, t_prev, generator, noise,
                         return_trajectory, trajectory_dtype, ddim=False)

    def sample_loop_ddim(self, denoise_fn: Callable, x_init, *,
                         generator: torch.Generator | None = None,
                         noise=None, n_steps: int = 50, eta: float = 1.0,
                         return_trajectory: bool = False,
                         trajectory_dtype: torch.dtype | None = None):
        """DDIM over ``ddim_timesteps(T, n_steps)`` (n_steps forwards)."""
        ts, t_prev = self.ladder("ddim", n_steps=n_steps)
        return self._run(denoise_fn, x_init, ts, t_prev, generator, noise,
                         return_trajectory, trajectory_dtype, ddim=True,
                         eta=eta)
