"""UTC time helpers.

The port's own copy of incubator_predictionio_tpu/utils/times.py, its
imports rewritten to this package.

The reference uses joda-time ``DateTime`` with a default zone of UTC
(reference: data/.../storage/Event.scala:70 ``defaultTimeZone = DateTimeZone.UTC``)
and ISO-8601 wire format for ``eventTime`` in the REST API. Here the canonical
in-memory representation is a timezone-aware ``datetime.datetime``.
"""

from __future__ import annotations

import time as _time
from datetime import datetime, timezone
from typing import Callable


def now_utc() -> datetime:
    """Current time as a timezone-aware UTC datetime."""
    return datetime.now(timezone.utc)


# ---------------------------------------------------------------------------
# Clock seam — TTL/staleness decisions route through here so tests can
# inject a fake clock instead of sleeping (speed-layer overlay TTLs, the
# serving micro-caches, /status staleness). Production code calls
# :func:`monotonic`; tests swap the source with :func:`set_monotonic`
# (restoring the previous source in a finally block) or use
# :class:`FakeClock` directly.
# ---------------------------------------------------------------------------

_monotonic_source: Callable[[], float] = _time.monotonic


def monotonic() -> float:
    """Seconds from an arbitrary epoch, never going backwards — the ONE
    clock every TTL/staleness decision reads (time.monotonic by default).
    """
    return _monotonic_source()


def set_monotonic(source: Callable[[], float]) -> Callable[[], float]:
    """Swap the monotonic source (tests inject a FakeClock); returns the
    previous source so callers can restore it in a finally block."""
    global _monotonic_source
    prev = _monotonic_source
    _monotonic_source = source
    return prev


class FakeClock:
    """Deterministic clock for TTL tests: ``advance`` instead of sleep.

    Install with ``prev = set_monotonic(clock)`` and restore with
    ``set_monotonic(prev)``; or pass the instance directly to components
    that take a ``clock=`` callable.
    """

    def __init__(self, start: float = 0.0) -> None:
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    def advance(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError("a monotonic clock cannot go backwards")
        self._now += float(seconds)


# ---------------------------------------------------------------------------
# Wall-clock seam — epoch-millisecond reads that cross process boundaries
# (event append stamps, freshness spans) route through here so tests can
# plant deterministic append times instead of sleeping. Unlike the
# monotonic seam this clock is comparable across processes: an event
# appended by the event server and served by the prediction server share
# the same epoch.
# ---------------------------------------------------------------------------

_wall_millis_source: Callable[[], int] = lambda: int(_time.time() * 1000)


def wall_millis() -> int:
    """Current wall time in epoch milliseconds — the ONE clock append
    stamps and freshness measurements read (time.time by default)."""
    return _wall_millis_source()


def set_wall_millis(source: Callable[[], int]) -> Callable[[], int]:
    """Swap the wall-millis source (tests plant append times); returns
    the previous source so callers can restore it in a finally block."""
    global _wall_millis_source
    prev = _wall_millis_source
    _wall_millis_source = source
    return prev


def ensure_aware(dt: datetime) -> datetime:
    """Interpret naive datetimes as UTC (the reference's default zone)."""
    if dt.tzinfo is None:
        return dt.replace(tzinfo=timezone.utc)
    return dt


def parse_iso8601(s: str) -> datetime:
    """Parse an ISO-8601 timestamp, accepting the trailing-``Z`` form.

    joda's ISO8601 parser (used by the reference event API) accepts
    ``2004-12-13T21:39:45.618-07:00`` and ``...Z`` forms; ``fromisoformat``
    in Python >= 3.11 covers both once ``Z`` is normalized.
    """
    if not isinstance(s, str):
        raise ValueError(f"Cannot convert {s!r} to a datetime.")
    dt = datetime.fromisoformat(s.replace("Z", "+00:00"))
    return ensure_aware(dt)


def format_iso8601(dt: datetime) -> str:
    """Format with milliseconds, matching the reference's wire format."""
    dt = ensure_aware(dt)
    return dt.isoformat(timespec="milliseconds")


def to_millis(dt: datetime) -> int:
    """Epoch milliseconds (joda ``DateTime.getMillis`` equivalent)."""
    return int(ensure_aware(dt).timestamp() * 1000)


def from_millis(ms: int) -> datetime:
    return datetime.fromtimestamp(ms / 1000.0, tz=timezone.utc)
