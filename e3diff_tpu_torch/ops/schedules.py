"""Diffusion noise schedules of the structure DDPM and the sequence D3PM
(counterpart of e3diff_tpu/ops/schedules.py). Computed host-side in NumPy
exactly as the JAX package does; callers move the terms to their device."""

from __future__ import annotations

import dataclasses

import numpy as np


def cosine_beta_schedule(timesteps: int, s: float = 8e-3) -> np.ndarray:
    """Nichol-Dhariwal cosine schedule, clipped to [1e-4, 0.9999].
    Returns betas of shape (timesteps,), float32."""
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0.0001, 0.9999).astype(np.float32)


def compute_alphas(betas: np.ndarray) -> dict[str, np.ndarray]:
    """Derived alpha terms for the DDPM forward/reverse processes
    (structure_model/utils.py:42-59). All outputs float32, shape (T,)."""
    betas = np.asarray(betas, dtype=np.float64)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    out = {
        "betas": betas,
        "alphas": alphas,
        "alphas_cumprod": alphas_cumprod,
        "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod),
        "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - alphas_cumprod),
        "posterior_variance": posterior_variance,
        "sqrt_recip_alphas": 1.0 / np.sqrt(alphas),
        "sqrt_posterior_variance": np.sqrt(posterior_variance),
    }
    return {k: v.astype(np.float32) for k, v in out.items()}


def cosine_beta_schedule_discrete(timesteps: int, s: float = 8e-3) -> np.ndarray:
    """Discrete cosine schedule of **timesteps + 1** betas
    (sequence_model/utils.py:99-108): T + 2 points spanning [0, T + 2], so
    the spacing is (T+2)/(T+1); the last beta is 1.0. float32."""
    steps = timesteps + 2
    x = np.linspace(0, steps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(0.5 * np.pi * ((x / steps) + s) / (1 + s)) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    alphas = alphas_cumprod[1:] / alphas_cumprod[:-1]
    betas = 1 - alphas
    return betas.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class DiscreteNoiseSchedule:
    """The sequence D3PM's lookup-table schedule
    (PredefinedNoiseScheduleDiscrete, sequence_model/utils.py:206-233):
    betas clamped to <= 0.9999 before the cumulative product, alpha_bar as
    exp(cumsum(log(alpha))) in float32, the reference's bit pattern. Each
    array has T + 1 entries, indexed by the integer step 0..T."""

    timesteps: int
    betas: np.ndarray
    alphas: np.ndarray
    alphas_bar: np.ndarray

    @classmethod
    def cosine(cls, timesteps: int) -> "DiscreteNoiseSchedule":
        betas = cosine_beta_schedule_discrete(timesteps)
        alphas = (1.0 - np.clip(betas, 0.0, 0.9999)).astype(np.float32)
        log_alpha_bar = np.cumsum(np.log(alphas.astype(np.float32)))
        alphas_bar = np.exp(log_alpha_bar).astype(np.float32)
        return cls(timesteps=timesteps, betas=betas, alphas=alphas,
                   alphas_bar=alphas_bar)


def cosine_alpha_bar_schedule(timesteps: int, s: float = 8e-3,
                              raise_to_power: float = 1.0) -> np.ndarray:
    """Continuous cosine schedule returning alphas_cumprod of shape
    (timesteps + 1,), betas clipped to [0, 0.999]
    (sequence_model/utils.py:80-97, named ``cosine_beta_schedule`` there
    though it returns cumulative alphas). No sampler or trainer uses it;
    ``GammaNoiseSchedule`` is built on it. float32."""
    steps = timesteps + 2
    x = np.linspace(0, steps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = np.clip(1 - alphas_cumprod[1:] / alphas_cumprod[:-1], 0, 0.999)
    alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    if raise_to_power != 1:
        alphas_cumprod = np.power(alphas_cumprod, raise_to_power)
    return alphas_cumprod.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class GammaNoiseSchedule:
    """Continuous-gamma lookup schedule, gamma(t) = -log(alpha^2 / sigma^2)
    (the reference's unused PredefinedNoiseSchedule,
    sequence_model/utils.py:180-204), indexed by t in [0, 1] rounded to
    the nearest of its timesteps + 1 entries."""

    timesteps: int
    gamma: np.ndarray

    @classmethod
    def cosine(cls, timesteps: int) -> "GammaNoiseSchedule":
        alphas2 = cosine_alpha_bar_schedule(timesteps).astype(np.float64)
        sigmas2 = 1.0 - alphas2
        gamma = -(np.log(alphas2) - np.log(sigmas2))
        return cls(timesteps=timesteps, gamma=gamma.astype(np.float32))

    def __call__(self, t_normalized):
        idx = np.round(
            np.asarray(t_normalized) * self.timesteps).astype(np.int64)
        return self.gamma[idx]


def custom_beta_schedule_discrete(timesteps: int, average_num_nodes: int = 50,
                                  s: float = 8e-3) -> np.ndarray:
    """The discrete cosine schedule with a floor on its small betas
    (sequence_model/utils.py:110-130, a graph-diffusion leftover with no
    caller in the reference: the floor is sized by the expected edge count
    of a graph of ``average_num_nodes``). float32."""
    if timesteps < 100:
        raise ValueError(f"timesteps must be >= 100, got {timesteps}")
    betas = cosine_beta_schedule_discrete(timesteps, s).astype(np.float64)
    p = 4 / 5  # 1 - 1 / num_edge_classes
    num_edges = average_num_nodes * (average_num_nodes - 1) / 2
    beta_first = 1.2 / (p * num_edges)
    betas[betas < beta_first] = beta_first
    return betas.astype(np.float32)
