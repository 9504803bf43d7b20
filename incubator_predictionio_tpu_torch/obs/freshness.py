"""End-to-end freshness tracing: event append → first serve.

The port's own copy of incubator_predictionio_tpu/obs/freshness.py, its
imports pointed at this package (``obs/metrics.py``, ``obs/trace.py``,
``utils/times.py``); the metric families keep their names and buckets.

The speed layer's promise is "an event influences served scores within
seconds", but until now that figure was only *inferred* from
``modelStalenessSec`` plus the cursor-lag gauge. This module measures
the promise directly: the storage tail read carries each event's
**append wall stamp** (``read_interactions_since`` fifth column), the
overlay threads the oldest unserved stamp through dirty-marking and
fold-in, and the first overlay HIT that serves the folded vector closes
the loop — one ``pio_freshness_seconds{engine}`` observation of
*event-appended → visible-in-a-prediction*.

Per-stage decomposition (gauges, last-batch values) localizes a
regression without a log dive:

- ``pio_freshness_poll_lag_seconds{engine}`` — append → tail-poll
  pickup (storage lag + poll interval),
- ``pio_freshness_fold_seconds{engine}`` — the batched fold-in wall the
  key rode (history read + device solve),
- ``pio_freshness_serve_pickup_seconds{engine}`` — vector published →
  first query that used it (traffic-dependent: an unqueried key sits).

One sampled journey per poll cycle additionally emits a linked span
chain (``speed.poll`` → ``speed.foldin`` → ``speed.serve``) on the
``pio.trace`` logger under a single generated trace ID — the same span
machinery the HTTP layer uses, so an operator can join an event's whole
path on one key.

Hot-path contract: :meth:`FreshnessTracker.on_serve_hit` runs on
serving threads — it is a dict pop + one histogram observe when the key
has a pending journey, and a single dict probe otherwise. Everything
else runs on the overlay's poller thread. The ``engine`` label comes
from the algorithm's declared engine name — a BOUNDED set, never a key
or entity id.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
from incubator_predictionio_tpu_torch.obs import trace as obs_trace
from incubator_predictionio_tpu_torch.utils import times

#: freshness spans milliseconds (hot poll loop) to HOURS (wedged poller
#: — exactly the regime an SLO must resolve), so this histogram gets its
#: own ladder instead of the serving-latency default, whose ~13.1 s cap
#: would saturate the headline metric precisely when freshness goes bad:
#: 10 ms doubling to ~23 h.
FRESHNESS_BUCKETS = tuple(0.01 * (2.0 ** i) for i in range(24))

#: the end-to-end promise: event append wall → first serve that used
#: the folded vector (docs/observability.md; the freshness_p95 SLO and
#: the bench's obs_freshness_p95_s both read this family)
FRESHNESS_SECONDS = obs_metrics.REGISTRY.histogram(
    "pio_freshness_seconds",
    "end-to-end freshness: event appended to the log -> first "
    "prediction served from the folded-in vector", labels=("engine",),
    buckets=FRESHNESS_BUCKETS)
POLL_LAG_SECONDS = obs_metrics.REGISTRY.gauge(
    "pio_freshness_poll_lag_seconds",
    "freshness stage 1 (last poll batch): event append -> tail-poll "
    "pickup", labels=("engine",))
FOLD_SECONDS = obs_metrics.REGISTRY.gauge(
    "pio_freshness_fold_seconds",
    "freshness stage 2 (last fold): batched fold-in wall the dirty "
    "keys rode", labels=("engine",))
SERVE_PICKUP_SECONDS = obs_metrics.REGISTRY.gauge(
    "pio_freshness_serve_pickup_seconds",
    "freshness stage 3 (last served key): vector published -> first "
    "query that used it", labels=("engine",))

#: append stamps older than this are treated as a historical backfill,
#: not live traffic, and skipped — a bulk import of last year's events
#: must not report year-long freshness (docs/observability.md)
MAX_PLAUSIBLE_AGE_S = 6 * 3600.0


class FreshnessTracker:
    """Per-overlay freshness bookkeeping. One instance per
    :class:`~incubator_predictionio_tpu_torch.speed.overlay.SpeedOverlay`;
    the metric families are shared process-wide (label = engine)."""

    def __init__(self, engine: str = "default",
                 max_pending: int = 1 << 16) -> None:
        self.engine = str(engine)
        self._lock = threading.Lock()
        #: key -> oldest append wall (ms) among its not-yet-served events
        self._pending_append: Dict[str, int] = {}
        #: key -> (append_ms, publish_wall_ms, fold_wall_s) for folded
        #: keys whose first serve has not happened yet
        self._await_serve: Dict[str, Tuple[int, int, float]] = {}
        self._max_pending = int(max_pending)
        #: at most ONE sampled journey in flight: (key, trace_id,
        #: append_ms, poll_lag_s) set at poll time, extended at fold
        self._journey: Optional[Tuple[str, str, int, float]] = None
        self._journey_spans: Dict[str, float] = {}
        self._hist = FRESHNESS_SECONDS.labels(engine=self.engine)
        self._poll_lag = POLL_LAG_SECONDS.labels(engine=self.engine)
        self._fold = FOLD_SECONDS.labels(engine=self.engine)
        self._pickup = SERVE_PICKUP_SECONDS.labels(engine=self.engine)

    # -- poller-thread side -------------------------------------------------
    def on_poll_batch(self, append_ms_by_key: Dict[str, int]) -> None:
        """A tail poll dirtied ``keys`` with their oldest append stamps
        (epoch ms; stamps <= 0 mean the backend could not attribute an
        append wall and the key is skipped). Books the poll-lag stage
        and opens the sampled journey for this cycle."""
        if not append_ms_by_key:
            return
        now_ms = times.wall_millis()
        worst_lag = 0.0
        sample: Optional[Tuple[str, int]] = None
        with self._lock:
            # reclaim a stale sampled journey (its key was discarded or
            # evicted without ever serving) so sampling never wedges
            j = self._journey
            if j is not None and j[0] not in self._pending_append \
                    and j[0] not in self._await_serve:
                self._journey = None
                self._journey_spans = {}
            for key, append_ms in append_ms_by_key.items():
                if append_ms <= 0:
                    continue
                age_s = (now_ms - append_ms) / 1e3
                if not 0.0 <= age_s <= MAX_PLAUSIBLE_AGE_S:
                    continue  # historical backfill or clock skew
                prev = self._pending_append.get(key)
                if prev is None and len(self._pending_append) \
                        >= self._max_pending:
                    continue  # bounded: drop tracking, never memory
                self._pending_append[key] = (
                    append_ms if prev is None else min(prev, append_ms))
                worst_lag = max(worst_lag, age_s)
                if sample is None:
                    sample = (key, append_ms)
            if sample is not None and self._journey is None:
                key, append_ms = sample
                self._journey = (key, obs_trace.new_trace_id(), append_ms,
                                 (now_ms - append_ms) / 1e3)
        if worst_lag > 0.0:
            self._poll_lag.set(worst_lag)

    def on_folded(self, keys, fold_wall_s: float) -> None:
        """``keys`` were just published by one batched fold-in that took
        ``fold_wall_s``. Moves their pending stamps into the
        awaiting-first-serve set."""
        now_ms = times.wall_millis()
        published = 0
        with self._lock:
            for key in keys:
                append_ms = self._pending_append.pop(key, None)
                if append_ms is None:
                    continue
                if len(self._await_serve) >= self._max_pending:
                    continue
                self._await_serve[key] = (append_ms, now_ms, fold_wall_s)
                published += 1
            j = self._journey
            if j is not None and j[0] in self._await_serve:
                self._journey_spans = {"pollLagS": j[3],
                                       "foldS": fold_wall_s}
        if published:
            self._fold.set(fold_wall_s)

    def discard(self, keys) -> None:
        """Stop tracing ``keys`` (folded with nothing publishable — no
        vector can ever serve their events before the next retrain)."""
        if not keys:
            return
        with self._lock:
            for key in keys:
                self._pending_append.pop(key, None)

    def invalidate(self) -> None:
        """Cursor reset / overlay teardown: in-flight journeys are no
        longer measurable (their vectors are gone)."""
        with self._lock:
            self._pending_append.clear()
            self._await_serve.clear()
            self._journey = None
            self._journey_spans = {}

    # -- serving-thread side ------------------------------------------------
    def on_serve_hit(self, key: str) -> None:
        """An overlay lookup HIT served ``key``'s folded vector. First
        hit after a fold closes the end-to-end loop; later hits are one
        dict probe and return."""
        with self._lock:
            entry = self._await_serve.pop(key, None)
            if entry is None:
                return
            journey = self._journey
            spans = self._journey_spans
            if journey is not None and journey[0] == key:
                self._journey = None
                self._journey_spans = {}
            else:
                journey = None
        append_ms, publish_ms, fold_wall_s = entry
        now_ms = times.wall_millis()
        freshness_s = max((now_ms - append_ms) / 1e3, 0.0)
        pickup_s = max((now_ms - publish_ms) / 1e3, 0.0)
        self._hist.observe(freshness_s)
        self._pickup.set(pickup_s)
        if journey is not None:
            _key, trace_id, _append, poll_lag_s = journey
            obs_trace.log_stage_span(
                "speed.poll", trace_id, spans.get("pollLagS", poll_lag_s),
                engine=self.engine)
            obs_trace.log_stage_span(
                "speed.foldin", trace_id, spans.get("foldS", fold_wall_s),
                engine=self.engine)
            obs_trace.log_stage_span(
                "speed.serve", trace_id, pickup_s, engine=self.engine,
                freshnessS=round(freshness_s, 3))

    # -- introspection ------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"pendingAppend": len(self._pending_append),
                    "awaitingServe": len(self._await_serve)}
