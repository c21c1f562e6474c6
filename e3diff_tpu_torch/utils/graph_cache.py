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
temporaries may reuse what another's capture freed. ``stats()`` counts
the lookups that hit, those that missed (each a capture by the caller)
and the programs closed to make room or replaced.
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
        self._stats = {"hits": 0, "misses": 0, "evictions": 0}

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)

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
            if hit is None or len(hit[0]) != len(pinned) or any(
                    a is not b for a, b in zip(hit[0], pinned)):
                self._stats["misses"] += 1
                return None
            self._stats["hits"] += 1
            self._entries.move_to_end(key)
            return hit[1]

    def put(self, key, value, *pinned):
        dropped = []
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None and old[1] is not value:
                dropped.append(old[1])
            self._entries[key] = (pinned, value)
            while len(self._entries) > self.maxsize:
                dropped.append(self._entries.popitem(last=False)[1][1])
            self._stats["evictions"] += len(dropped)
        for v in dropped:
            close = getattr(v, "close", None)
            if close is not None:
                close()
