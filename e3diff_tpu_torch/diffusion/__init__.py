"""The continuous angle diffusion and classifier-free guidance."""

from e3diff_tpu_torch.diffusion.gaussian import GaussianAngleDiffusion  # noqa: F401
