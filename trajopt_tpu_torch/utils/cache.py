"""Fixed-capacity LRU cache + trajectory hashing (trajopt_common analog).

A copy of ``trajopt_tpu/utils/cache.py`` (that module imports no JAX; the
port keeps its own copy so that it imports nothing of the JAX package).
Mirrors ``trajopt_common::Cache<K,V>`` (``cache.h:32-329``: fixed-capacity
pooled LRU with ``get`` / ``put`` / ``getOrAcquire``) and the joint-value
hashing used to key collision-result caches (``collision_utils.h:38-96``:
``getHash`` / ``cantorHash``).

The batched solver recomputes rather than caches, so this cache serves
the *host-side* paths: the reference SQP driver's repeated exact evaluations
(the same role the LRU plays in ``CollisionEvaluator::GetContactResultCached``,
``collision_terms.cpp:440-459``), parsed-URDF/scene memoization, and any
user code that wants the reference's caching semantics.
"""

from __future__ import annotations

import collections
import hashlib
from typing import Any, Callable, Hashable

import numpy as np
import torch


class LRUCache:
    """Fixed-capacity LRU: get() refreshes recency, put() evicts the least
    recently used entry once capacity is reached."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._d: "collections.OrderedDict[Hashable, Any]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._d

    def get(self, key: Hashable, default: Any = None) -> Any:
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        return default

    def put(self, key: Hashable, value: Any) -> None:
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = value
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def get_or_acquire(self, key: Hashable, acquire: Callable[[], Any]) -> Any:
        """Cached value, or acquire(), store, and return it
        (Cache::getOrAcquire, cache.h)."""
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        value = acquire()
        self.put(key, value)
        return value

    def clear(self) -> None:
        self._d.clear()


def joint_hash(x, digits: int = 10) -> bytes:
    """Stable hash of a joint-value vector (the getHash(dof_vals) analog).

    Rounds to ``digits`` decimals first so that bitwise-adjacent host
    round-trips key identically, then hashes the raw bytes (blake2b) —
    collision-resistant where the reference's cantor pairing is merely
    fast."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    a = np.round(np.asarray(x, np.float64), digits)
    h = hashlib.blake2b(digest_size=16)
    h.update(a.tobytes())
    h.update(str(a.shape).encode())
    return h.digest()
