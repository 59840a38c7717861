"""A bounded LRU cache for process-lifetime registries (port of
``segtpu/core/caching.py``).

The JAX package bounds its compiled-program caches with it. Here it holds
the fused training run's runners (``segtpu_torch/train/fused_run.py``):
each owns a model, its optimizer state and the CUDA graphs captured for
one set of shapes, with their memory pool. A long sweep (a grid of
configurations, the folds of a CV) touches one runner per shape; a small
cap keeps the hot set (the folds of the configuration being swept share
one entry) and lets the card free retired graphs.

Eviction drops only the cache's reference: whatever still holds the value
keeps it alive, so eviction never breaks a run in flight; it only forces
a new capture on a later revisit.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Hashable


class LRUCache:
    """Minimal LRU mapping: dict-style access, recency on read and write,
    oldest-out beyond ``cap``. Not thread-safe (its users are the
    single-threaded training control path)."""

    def __init__(self, cap: int):
        if cap < 1:
            raise ValueError(f"cap must be >= 1, got {cap}")
        self.cap = int(cap)
        self._d: OrderedDict = OrderedDict()

    def get(self, key: Hashable, default: Any = None) -> Any:
        if key in self._d:
            self._d.move_to_end(key)
            return self._d[key]
        return default

    def __getitem__(self, key: Hashable) -> Any:
        self._d.move_to_end(key)
        return self._d[key]

    def __setitem__(self, key: Hashable, value: Any) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.cap:
            self._d.popitem(last=False)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)

    def keys(self) -> list:
        """The keys, least recently used first."""
        return list(self._d)

    def clear(self) -> None:
        self._d.clear()
