"""Bounded TTL micro-cache for serving-hot-path storage reads.

The port's own copy of incubator_predictionio_tpu/speed/cache.py, its
imports rewritten to this package.

A ``predict()`` that does a synchronous EventStore round trip per query
(the ecommerce recent-events / constraint reads) pays the storage layer
on the serving hot path — the `serve-blocking-io` pio-lint hazard. This
cache bounds that cost: reads are served from a (maxsize, TTL)-bounded
LRU map, and entries carry an optional VERSION (the speed layer's
per-key event cursor) so a key whose entity received newer events misses
immediately instead of waiting out the TTL.

Clock discipline: all expiry decisions read the injectable clock
(``utils/times.monotonic`` by default) so tests advance a FakeClock
instead of sleeping.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable, Optional, Tuple

from incubator_predictionio_tpu_torch.utils import times


def serve_cache_ttl(default: float = 5.0) -> float:
    """THE micro-cache TTL knob (``PIO_SERVE_CACHE_TTL_S``,
    docs/production.md) — every serve-time micro-cache resolves its TTL
    through here so one knob tunes them all."""
    import os

    try:
        return float(os.environ.get("PIO_SERVE_CACHE_TTL_S", str(default)))
    except ValueError:
        return default


def store_version(app_name, channel_name=None):
    """Cache-invalidation version for serve-time micro-caches: the
    store's monotonic write cursor (the speed layer's anchor). ANY write
    bumps it, so e.g. a ``$set`` constraint flip still lands on the very
    next query, while queries between writes stop paying the storage
    scan. None (no app / backend without tail support / storage error)
    degrades to pure TTL."""
    from incubator_predictionio_tpu_torch.data.store import EventStore

    if app_name is None:
        return None
    try:
        cur = EventStore.tail_cursor(app_name, channel_name)
    except Exception:
        return None
    return cur if cur >= 0 else None


class TTLCache:
    """Thread-safe bounded TTL+version cache.

    ``get_or_load(key, loader, version=...)`` is the serving-path entry
    point: one loader call per (key, version, TTL window), concurrent
    misses may race the loader (benign — last writer wins, both get a
    correct value). ``version=None`` means pure-TTL semantics.
    """

    def __init__(self, maxsize: int = 1024, ttl_s: float = 5.0,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.maxsize = max(int(maxsize), 1)
        self.ttl_s = float(ttl_s)
        self._clock = clock if clock is not None else times.monotonic
        self._lock = threading.Lock()
        #: key -> (value, expires_at, version)
        self._data: "OrderedDict[Hashable, Tuple[Any, float, Any]]" = \
            OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: Hashable, version: Any = None) -> Any:
        """→ ``(True, value)`` on hit, ``(False, None)`` on miss.

        The hit flag exists because cached values may legitimately be
        None/empty (an empty recent-events list is a valid cached read).
        A stored version differing from ``version`` is a miss — the
        speed-layer cursor invalidation."""
        now = self._clock()
        with self._lock:
            entry = self._data.get(key)
            if entry is not None:
                value, expires, ver = entry
                if now < expires and ver == version:
                    self._data.move_to_end(key)
                    self.hits += 1
                    return True, value
                del self._data[key]
            self.misses += 1
            return False, None

    def put(self, key: Hashable, value: Any, version: Any = None) -> None:
        now = self._clock()
        with self._lock:
            self._data[key] = (value, now + self.ttl_s, version)
            self._data.move_to_end(key)
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)

    def get_or_load(self, key: Hashable, loader: Callable[[], Any],
                    version: Any = None) -> Any:
        hit, value = self.get(key, version=version)
        if hit:
            return value
        value = loader()
        self.put(key, value, version=version)
        return value

    def invalidate(self, key: Hashable) -> None:
        with self._lock:
            self._data.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)
