"""The structure and sequence denoisers and their blocks."""

from e3diff_tpu_torch.models.config import (  # noqa: F401
    TransformerConfig,
    sequence_model_configs,
    structure_model_configs,
)
from e3diff_tpu_torch.models.sequence import SequenceDenoiser  # noqa: F401
from e3diff_tpu_torch.models.structure import StructureDenoiser  # noqa: F401
