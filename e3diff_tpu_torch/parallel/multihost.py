"""Multi-process start-up and input distribution (counterpart of
e3diff_tpu/parallel/multihost.py).

One process per card. ``initialize_multihost`` joins the processes that
``python -m torch.distributed.run`` (torchrun) started into one
``torch.distributed`` job, reading its ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``; each rank's card is
``cuda:{LOCAL_RANK % device_count}`` (parallel/mesh.py::default_device).

``host_local_slice``, ``host_batch_rows``, ``pad_local_batch`` and
``distribute_batch`` keep the JAX package's arithmetic for a job in which
each process loads only its own rows of the data: the rows it needs, padded
to a common count, as tensors of its block of the global batch. The port's
own path does not call them: every rank of the train CLIs reads the whole
batch and keeps its dp rows (parallel/mesh.py::shard_batch).
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

from e3diff_tpu_torch.data.dataset import BATCH_META_KEYS, strip_meta


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *,
                         backend: str | None = None,
                         init_method: str | None = None) -> tuple[int, int]:
    """Join this process to a ``torch.distributed`` job; returns
    (rank, world_size).

    ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id`` default to torchrun's MASTER_ADDR:MASTER_PORT,
    WORLD_SIZE and RANK; ``init_method`` (e.g. "file:///shared/path")
    replaces the address. ``backend``: NCCL when a card is visible, else
    gloo (several ranks on one card need "gloo"). As in the JAX package:
    an initialised job, or num_processes == 1, is left alone;
    initialisation is always attempted otherwise; when it fails, a caller
    who configured anything gets the error, and one who configured nothing
    is warned and continues as a single process."""
    explicit = coordinator_address is not None
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])

    if not dist.is_initialized() and num_processes != 1:
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if init_method is None:
            # env:// reads torchrun's variables (and joins its agent's
            # store); an address given here is dialled directly
            init_method = (f"tcp://{coordinator_address}" if explicit
                           else "env://")
        try:
            dist.init_process_group(backend=backend, init_method=init_method,
                                    world_size=num_processes,
                                    rank=process_id)
        except Exception as e:
            # anything configured means the caller expected a job: a
            # silent downgrade would let one rank train alone
            if (coordinator_address is not None or num_processes is not None
                    or process_id is not None):
                raise
            warnings.warn(
                f"initialize_multihost: no cluster detected ({e!r}); "
                "continuing single-process.", stacklevel=2)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _index_count(process_index, process_count) -> tuple[int, int]:
    if process_index is None or process_count is None:
        on = dist.is_initialized()
        if process_index is None:
            process_index = dist.get_rank() if on else 0
        if process_count is None:
            process_count = dist.get_world_size() if on else 1
    return process_index, process_count


def host_local_slice(n_examples: int, process_index: int | None = None,
                     process_count: int | None = None) -> slice:
    """The contiguous row range this process should load.

    Covers ALL rows, no silent remainder drop: with r = n % pc, the first
    r processes take per+1 rows, the rest per. When r != 0 the local sizes
    differ by one; pad every process to ``host_batch_rows(n)`` with
    ``pad_local_batch`` (the ranks' collectives need one row count)."""
    pi, pc = _index_count(process_index, process_count)
    per, rem = divmod(n_examples, pc)
    start = pi * per + min(pi, rem)
    return slice(start, start + per + (1 if pi < rem else 0))


def host_batch_rows(n_examples: int, process_count: int | None = None) -> int:
    """Per-process row count after padding: ceil(n / process_count)."""
    _, pc = _index_count(0, process_count)
    return -(-n_examples // pc)


def pad_local_batch(local_batch: dict, target_rows: int) -> dict:
    """Zero-pad every array in a process-local batch to ``target_rows``
    rows.

    Padded rows have all-zero attention masks, so they contribute nothing
    to the masked losses and metrics; the true row count is recorded in
    ``num_valid``. Raises if the batch already exceeds ``target_rows``."""
    out = {}
    rows = None
    for k, v in local_batch.items():
        if k in BATCH_META_KEYS:
            if k == "structure_ids":
                out[k] = v
            continue
        v = np.asarray(v)
        if rows is None:
            rows = v.shape[0]
        if v.shape[0] > target_rows:
            raise ValueError(
                f"batch has {v.shape[0]} rows > target {target_rows}")
        pad = ((0, target_rows - v.shape[0]),) + ((0, 0),) * (v.ndim - 1)
        out[k] = np.pad(v, pad)
    out["num_valid"] = min(int(local_batch.get("num_valid", rows)), rows)
    return out


def distribute_batch(local_batch: dict, mesh,
                     global_rows: int | None = None) -> dict:
    """A process-local numpy batch -> tensors on this rank's device: the
    rank's block of the global batch, which the trainers and samplers of a
    mesh take.

    Every process MUST hold the same local row count (``host_local_slice``
    sizes differ by one when n % process_count != 0: pad with
    ``pad_local_batch(batch, host_batch_rows(n))`` first); pass
    ``global_rows=n`` (the pre-slice total) to have that checked here
    instead of failing in a collective."""
    pc = dist.get_world_size() if dist.is_initialized() else 1
    rows = {np.asarray(v).shape[0] for v in strip_meta(local_batch).values()}
    if len(rows) > 1:
        raise ValueError(f"inconsistent row counts across batch keys: {rows}")
    if pc > 1 and global_rows is not None and rows:
        expected = host_batch_rows(global_rows, pc)
        if next(iter(rows)) != expected:
            raise ValueError(
                f"local batch has {next(iter(rows))} rows but "
                f"host_batch_rows({global_rows}) = {expected}; pad with "
                f"pad_local_batch before distribute_batch")
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(mesh.device)
            for k, v in strip_meta(local_batch).items()}
