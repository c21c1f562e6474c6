"""The design engine, its micro-batcher and its HTTP server."""

from e3diff_tpu_torch.serving.batcher import (  # noqa: F401
    MicroBatcher,
    QueueFullError,
)
from e3diff_tpu_torch.serving.engine import (  # noqa: F401
    DesignEngine,
    DesignResult,
    pocket_record,
)
from e3diff_tpu_torch.serving.server import DesignServer  # noqa: F401
