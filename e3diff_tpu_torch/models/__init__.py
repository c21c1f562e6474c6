"""The structure denoiser and its blocks."""

from e3diff_tpu_torch.models.config import (  # noqa: F401
    TransformerConfig,
    structure_model_configs,
)
from e3diff_tpu_torch.models.structure import StructureDenoiser  # noqa: F401
