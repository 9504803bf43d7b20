"""In-memory ingest statistics.

The port's own copy of incubator_predictionio_tpu/servers/stats.py,
its imports pointed at this package.

Parity: data/.../api/{Stats,StatsActor}.scala — per-app counters keyed by
(status, event name), kept for the previous and current hour (hourly
cutoff, Stats.scala:51-80), served by ``GET /stats.json``.
"""

from __future__ import annotations

import threading
from datetime import datetime, timedelta, timezone
from typing import Dict, Tuple

from incubator_predictionio_tpu_torch.utils.times import format_iso8601, now_utc

KPI = Dict[Tuple[int, str], int]  # (status, event-name) -> count


def _hour_start(dt: datetime) -> datetime:
    return dt.replace(minute=0, second=0, microsecond=0)


class Stats:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hour = _hour_start(now_utc())
        self._current: Dict[int, KPI] = {}
        self._previous: Dict[int, KPI] = {}

    def _rotate(self) -> None:
        """Hourly cutoff — must run on reads too, so a quiet server doesn't
        report stale hours as the current window (Stats.scala:51-80)."""
        now = _hour_start(now_utc())
        if now == self._hour:
            return
        # counts from exactly the last hour become "previous"; older ones drop
        self._previous = (
            self._current if now - self._hour == timedelta(hours=1) else {}
        )
        self._current = {}
        self._hour = now

    def update(self, app_id: int, status: int, event_name: str) -> None:
        with self._lock:
            self._rotate()
            kpi = self._current.setdefault(app_id, {})
            key = (status, event_name)
            kpi[key] = kpi.get(key, 0) + 1

    def get(self, app_id: int) -> dict:
        """Previous + current hour counts for an app (Stats.get)."""
        with self._lock:
            self._rotate()
            merged: KPI = {}
            for source in (self._previous, self._current):
                for key, n in source.get(app_id, {}).items():
                    merged[key] = merged.get(key, 0) + n
            return {
                "startTime": format_iso8601(self._hour - timedelta(hours=1)),
                "until": format_iso8601(now_utc()),
                "appId": app_id,
                "status": [
                    {"status": status, "event": event, "count": n}
                    for (status, event), n in sorted(merged.items())
                ],
            }
