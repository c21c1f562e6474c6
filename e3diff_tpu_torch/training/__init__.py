"""Training of both denoisers through the kernels: losses, AdamW, the
trainers, checkpoints and the epoch loop."""

from e3diff_tpu_torch.training.optim import AdamW  # noqa: F401
from e3diff_tpu_torch.training.sequence import SequenceTrainer  # noqa: F401
from e3diff_tpu_torch.training.structure import StructureTrainer  # noqa: F401
