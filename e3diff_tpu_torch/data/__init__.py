"""Host-side numpy data: complexes, splits, padding, synthetic fixtures."""

from e3diff_tpu_torch.data.dataset import (  # noqa: F401
    LigandBindingSiteData,
    load_complexes,
    strip_meta,
)
from e3diff_tpu_torch.data.synthetic import synthetic_complexes  # noqa: F401
