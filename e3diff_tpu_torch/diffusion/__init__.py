"""The continuous angle diffusion, the discrete sequence D3PM and
classifier-free guidance."""

from e3diff_tpu_torch.diffusion.d3pm import D3PMDiffusion  # noqa: F401
from e3diff_tpu_torch.diffusion.gaussian import GaussianAngleDiffusion  # noqa: F401
