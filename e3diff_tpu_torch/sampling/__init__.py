"""Batched structure sampling."""

from e3diff_tpu_torch.sampling.structure import (  # noqa: F401
    make_structure_sampler,
    sample_structure_batches,
)
