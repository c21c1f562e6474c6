"""The design engine (the HTTP server and batcher come with the serving
slice)."""

from e3diff_tpu_torch.serving.engine import (  # noqa: F401
    DesignEngine,
    DesignResult,
    pocket_record,
)
