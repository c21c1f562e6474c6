"""Multi-device training and sampling: a (dp, tp) mesh on
``torch.distributed``, the denoisers' sharding rules, and multi-process
start-up and input distribution."""

from e3diff_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    copy_to_tp,
    gather_params,
    load_shard,
    make_mesh,
    param_sharding_rules,
    reduce_from_tp,
    shard_batch,
    shard_params,
)
from e3diff_tpu_torch.parallel.multihost import (  # noqa: F401
    distribute_batch,
    host_batch_rows,
    host_local_slice,
    initialize_multihost,
    pad_local_batch,
)
