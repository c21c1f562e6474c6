"""Batched structure and sequence sampling, and the end-to-end pipeline."""

from e3diff_tpu_torch.sampling.pipeline import run_pipeline  # noqa: F401
from e3diff_tpu_torch.sampling.sequence import (  # noqa: F401
    make_sequence_sampler,
    sample_sequence_batches,
)
from e3diff_tpu_torch.sampling.structure import (  # noqa: F401
    make_structure_sampler,
    sample_structure_batches,
)
