"""Diffusion noise schedules of the structure DDPM (counterpart of
e3diff_tpu/ops/schedules.py). Computed host-side in NumPy float64 and cast
to float32, exactly as the JAX package does; callers move the terms to
their device."""

from __future__ import annotations

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
