"""Input prefetch (counterpart of e3diff_tpu/data/prefetch.py): one
background thread assembles the next batches and copies them to the card
while it computes the current step.

The host work left is numpy batch assembly (data/dataset.py::batches)
and the host-to-device copy: each array goes to pinned memory and then to
the device with ``non_blocking=True``, so the copy runs on the card's copy
engine, ordered before the step that reads it on the same stream.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from e3diff_tpu_torch.data.dataset import strip_meta

_END = object()


def to_device(batch: dict, device) -> dict:
    """A numpy batch (meta keys dropped) as tensors on ``device``; through
    pinned memory and non-blocking copies to a CUDA device."""
    device = torch.device(device)
    out = {}
    for k, v in strip_meta(batch).items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def prefetch_to_device(iterator: Iterable[dict], device, size: int = 2
                       ) -> Iterator[dict]:
    """Yield ``to_device`` of each batch of ``iterator``, staged up to
    ``size`` batches ahead on a background thread. An exception of the
    source re-raises at the consumer's next pull; abandoning the generator
    stops the thread."""
    q: queue.Queue = queue.Queue(maxsize=max(1, int(size)))
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            for batch in iterator:
                if stop.is_set() or not put(to_device(batch, device)):
                    return
            put(_END)
        except BaseException as e:  # re-raised by the consumer
            put(e)

    threading.Thread(target=producer, name="input-prefetch",
                     daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
