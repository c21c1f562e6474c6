"""Timing and profiling scopes (counterpart of e3diff_tpu/utils/timing.py).

PyTorch returns from a CUDA call before the card has finished it, so a
host clock measures the card's work only up to a ``torch.cuda.synchronize``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

TRACE_NAME = "trace.json"


def synchronize() -> None:
    """Wait for the card's queued work, where a card is in use."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_timer(label: str, results: dict | None = None, log_fn=print):
    """Wall-clock a block, synchronising the card before the clock starts
    and before it stops; the seconds go to ``results[label]`` and, unless
    ``log_fn`` is None, to ``log_fn``."""
    synchronize()
    start = time.perf_counter()
    try:
        yield
    finally:
        synchronize()
        elapsed = time.perf_counter() - start
        if results is not None:
            results[label] = elapsed
        if log_fn is not None:
            log_fn(f"[{label}] {elapsed * 1e3:.1f} ms")


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """A torch.profiler scope over the host and, where a card is in use,
    the card (GEMM shapes recorded for utils/profiling.py::gemm_flops),
    that writes ``<logdir>/trace.json`` in the Chrome-trace format at its
    end and yields that path; a no-op yielding None for ``logdir`` None."""
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, TRACE_NAME)
    with profile(activities=activities, record_shapes=True) as prof:
        try:
            yield path
        finally:
            synchronize()
    prof.export_chrome_trace(path)
