"""Bounded identity-keyed cache of captured sampler programs (counterpart
of e3diff_tpu/utils/jit_cache.py).

A captured program (sampling/graphs.py) holds CUDA graphs and the static
device buffers they read and write, one program per (model, diffusion,
flags, bucket shape). A serving engine sees a handful of buckets and a
sweep may build many models, so the cache is a small LRU: the least
recently used program is evicted, and an evicted program releases its
graphs and buffers at once. Every graph of one cache is captured into one
shared memory pool: programs run one at a time (the caller serialises
them, as the design engine's device lock does), and each program writes
every buffer it reads back before it reads it, so one program's
temporaries may reuse what another's capture freed.
"""

from __future__ import annotations

import threading
from collections import OrderedDict


class GraphCache:
    """LRU keyed by (id(obj)..., static flags..., shapes...). Identity keys
    are revalidated with ``is`` on lookup, so a recycled id never
    aliases. A value with a ``close()`` method is closed when it is
    evicted or replaced."""

    def __init__(self, maxsize: int = 8):
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        self.maxsize = maxsize
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()
        self._pool = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def values(self) -> list:
        """The cached values, least recently used first."""
        with self._lock:
            return [v for _, v in self._entries.values()]

    def pool(self):
        """The memory pool every graph of this cache is captured into
        (``torch.cuda.graph_pool_handle()``, made at first use)."""
        with self._lock:
            if self._pool is None:
                import torch

                self._pool = torch.cuda.graph_pool_handle()
            return self._pool

    def get(self, key, *pinned):
        """The cached value if key matches AND every pinned object is
        identical to the one stored with it (else None)."""
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                return None
            stored_pinned, value = hit
            if len(stored_pinned) != len(pinned) or any(
                    a is not b for a, b in zip(stored_pinned, pinned)):
                return None
            self._entries.move_to_end(key)
            return value

    def put(self, key, value, *pinned):
        dropped = []
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None and old[1] is not value:
                dropped.append(old[1])
            self._entries[key] = (pinned, value)
            while len(self._entries) > self.maxsize:
                dropped.append(self._entries.popitem(last=False)[1][1])
        for v in dropped:
            close = getattr(v, "close", None)
            if close is not None:
                close()
