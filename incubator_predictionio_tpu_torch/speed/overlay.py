"""The real-time overlay: log-tail subscriber + fold-in cache.

One :class:`SpeedOverlay` serves one deployed algorithm. A poll cycle:

1. ``read_interactions_since(cursor)`` — the O(delta) tail read — yields
   every interaction written since the last poll.
2. Every key (user for recommendation/ecommerce, item for
   similarproduct) seen in the tail is marked DIRTY with the new cursor,
   its overlay entry dropped (per-key invalidation on newer events) and
   its version bumped (the serving micro-caches key on this).
3. Dirty keys are folded in as ONE batched device solve
   (:class:`~.foldin.FoldInSolver`): the key's full event history is
   read from the store (hash-pushdown ``find`` on the entity side) and
   solved against the frozen other-side factors. Solved vectors land in
   the overlay keyed ``(key, cursor)`` with a TTL.

Serving threads call :meth:`lookup` — a dict probe under a lock, no
storage or device work ever happens on the query path. The prediction
server invalidates the whole overlay on hot model swap (a second
``load_models()``) and rebuilds it against the new model's factors.

The port's own copy of incubator_predictionio_tpu/speed/overlay.py, its
imports pointed at this package. The solver is the port's
:class:`~.foldin.FoldInSolver`, which keeps the frozen table on its
device: the engines pass the deployed model's item table as the device
tensor, with no host round trip. Left out: the rebuild-daemon nudge
after an ``index_sink`` publish (``ops/mips_daemon``, ROADMAP.md Queue 1
item 5) and a mesh-sharded frozen table (item 9;
:meth:`SpeedOverlay.stats` has no ``shardedTable``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
from incubator_predictionio_tpu_torch.obs.freshness import FreshnessTracker
from incubator_predictionio_tpu_torch.speed.foldin import FoldInSolver
from incubator_predictionio_tpu_torch.utils import times

logger = logging.getLogger(__name__)

#: process-wide speed-layer telemetry (docs/observability.md). Shared by
#: every overlay in the process — the scrape wants totals, and multiple
#: deployed algorithms booking into one family keeps cardinality flat.
_HITS = obs_metrics.REGISTRY.counter(
    "pio_speed_hits_total", "overlay lookups served a folded-in vector")
_MISSES = obs_metrics.REGISTRY.counter(
    "pio_speed_misses_total",
    "overlay lookups that fell through to the base model")
_FOLDIN_SECONDS = obs_metrics.REGISTRY.histogram(
    "pio_speed_foldin_seconds",
    "wall of one batched fold-in solve (history read + device solve)")
_FOLDIN_ROWS = obs_metrics.REGISTRY.counter(
    "pio_speed_foldin_rows_total", "keys folded in by the speed layer")
_OVERLAY_SIZE = obs_metrics.REGISTRY.gauge(
    "pio_speed_overlay_size", "folded-in vectors currently cached "
    "(all overlays in this process; summed at scrape time)")
#: live overlays, for the scrape-time size collector (weak: a dropped
#: overlay must never be pinned by telemetry)
_LIVE_OVERLAYS: "weakref.WeakSet" = weakref.WeakSet()


def _collect_overlay_size() -> None:
    _OVERLAY_SIZE.set(sum(len(ov._vectors) for ov in list(_LIVE_OVERLAYS)))


obs_metrics.REGISTRY.register_collector("speed_overlay_size",
                                        _collect_overlay_size)
_CURSOR_LAG = obs_metrics.REGISTRY.gauge(
    "pio_speed_cursor_lag_events",
    "events written but not yet seen by the overlay poll (last poll)")


@dataclasses.dataclass
class SpeedOverlayConfig:
    """Everything one overlay needs: where the events are, which side is
    being folded in, and the training hyperparameters the solve must
    match."""

    app_name: str
    channel_name: Optional[str] = None
    #: engine name for the per-engine freshness series (BOUNDED label
    #: set: one value per deployed engine template, never a key/id)
    engine: str = "default"
    entity_type: str = "user"
    target_entity_type: str = "item"
    event_names: Tuple[str, ...] = ("rate",)
    value_prop: Optional[str] = None
    event_values: Optional[Dict[str, float]] = None
    default_value: float = 1.0
    #: which side of the interaction stream is folded in: "entity"
    #: (users — recommendation/ecommerce) or "target" (items —
    #: similarproduct's new-item fold-in)
    key_side: str = "entity"
    #: fold-in hyperparameters — MUST match the deployed model's training
    l2: float = 0.1
    reg_nnz: bool = True
    implicit: bool = False
    alpha: float = 1.0
    #: post-solve transform (similarproduct normalizes to unit vectors)
    transform: Optional[Callable[[np.ndarray], np.ndarray]] = None
    #: history cap per key (newest kept) and per-poll fold-in budget.
    #: ``max_keys_per_poll`` is the budget LADDER BASE, not a fixed
    #: cap: under dirty backlog the overlay doubles its per-poll budget
    #: up to ``max_keys_per_poll × max_keys_growth`` and collapses back
    #: when the backlog drains — the fold-in plane's twin of the
    #: serving scheduler's queue-depth-adaptive batching
    #: (serving/scheduler.py; docs/production.md "Serving fleet")
    max_history: int = 512
    max_keys_per_poll: int = 256
    #: backlog growth headroom: the adaptive budget's cap as a multiple
    #: of the base (16 → a 256 base may reach 4096 keys/poll)
    max_keys_growth: int = 16
    ttl_s: float = 300.0


class SpeedOverlay:
    """TTL'd overlay of fold-in vectors over one frozen factor table."""

    def __init__(
        self,
        config: SpeedOverlayConfig,
        other_factors: Any,            # frozen [M, K] factors (other side)
        other_index,                   # id -> column index (BiMap/dict)
        key_index=None,                # id -> row index of the KEY side
        clock: Optional[Callable[[], float]] = None,
        index_sink: Optional[
            Callable[[List[str], List[np.ndarray]], None]] = None,
    ) -> None:
        self.config = config
        #: publish hook for KEY-side serving indexes (the two-stage
        #: MIPS seam, ops/mips.publish_rows): called with every batch
        #: of (keys, solved vectors) the moment they publish, so a
        #: fold-in row is findable as a RESULT — exactly scored and
        #: merged — before the index's next rebuild. Telemetry-grade:
        #: a sink failure never fails the fold-in.
        self.index_sink = index_sink
        # the frozen table stays where it lies (the deployed model's
        # device tensor); only the [K] fold-in vectors reach this host
        self.solver = FoldInSolver(
            other_factors, l2=config.l2, reg_nnz=config.reg_nnz,
            implicit=config.implicit, alpha=config.alpha)
        self.other_index = other_index
        #: the base model's key-side index: keys IN it have pre-deploy
        #: history the tail never saw (their fold-in reads the store);
        #: keys NOT in it are new since training and their accumulated
        #: tail history is complete — no storage read per cold key, the
        #: property that keeps a cold-start flood O(delta)
        self.key_index = key_index if key_index is not None else {}
        self._clock = clock if clock is not None else times.monotonic
        self._lock = threading.Lock()
        from collections import OrderedDict

        #: key id -> (vector, cursor_at_solve, expires_at). LRU-bounded
        #: (publish order ≈ expiry order at a constant TTL) and swept of
        #: expired entries every poll — lookups alone must not be the
        #: only reclaim path, or never-again-queried keys leak forever.
        self._vectors: "OrderedDict[str, Tuple[np.ndarray, int, float]]" \
            = OrderedDict()
        self._max_vectors = 1 << 17
        #: key id -> cursor of the newest event seen for it
        self._dirty: Dict[str, int] = {}
        #: key id -> monotonically increasing event-batch version (the
        #: serving micro-caches validate against this). LRU-bounded: an
        #: evicted key restarting at version 1 still MISSES any cached
        #: entry (validation is equality, not ordering), so eviction is
        #: always safe, never stale.
        self._versions: "OrderedDict[str, int]" = OrderedDict()
        self._max_versions = 1 << 18
        #: model-unknown keys' accumulated (cols, vals) history from the
        #: tail — LRU-bounded; per-key length capped at max_history
        self._tail_hist: "OrderedDict[str, Tuple[list, list]]" = \
            OrderedDict()
        self._tail_hist_max_keys = 65536
        #: end-to-end freshness trace (obs/freshness.py): append stamps
        #: ride the tail read in, fold-in publishes hand them over, and
        #: the first serving HIT closes the pio_freshness_seconds loop
        self.freshness = FreshnessTracker(engine=config.engine)
        #: queue-depth-adaptive per-poll fold-in budget: doubles from
        #: the configured base while dirty keys outpace it, collapses
        #: when the backlog drains (see SpeedOverlayConfig)
        self._budget_rung = max(int(config.max_keys_per_poll), 1)
        self.cursor = self._initial_cursor()
        _LIVE_OVERLAYS.add(self)
        self.hits = 0
        self.misses = 0
        self.foldins = 0
        self.last_lag = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _initial_cursor(self) -> int:
        from incubator_predictionio_tpu_torch.data.store import EventStore

        try:
            return EventStore.tail_cursor(
                self.config.app_name, self.config.channel_name)
        except Exception:
            logger.exception("speed overlay: tail cursor unavailable")
            return -1

    @property
    def enabled(self) -> bool:
        with self._lock:
            return self.cursor >= 0

    # -- serving-side API (hot path: dict probes only) ----------------------
    def lookup(self, key_id: str) -> Optional[np.ndarray]:
        """Folded-in vector for ``key_id``, or None (miss). A key dirtied
        by events newer than its solve, or past its TTL, misses — the
        base model (or its fallback) serves until the next poll re-folds.
        """
        now = self._clock()
        with self._lock:
            entry = self._vectors.get(key_id)
            if entry is not None:
                vec, at_cursor, expires = entry
                if now < expires and self._dirty.get(key_id, -1) <= at_cursor:
                    self.hits += 1
                    _HITS.inc()
                else:
                    del self._vectors[key_id]
                    vec = None
            else:
                vec = None
            if vec is None:
                self.misses += 1
                _MISSES.inc()
        if vec is not None:
            # outside the overlay lock: first hit after a fold closes
            # the end-to-end freshness loop (dict pop + one observe;
            # later hits are a single probe)
            self.freshness.on_serve_hit(key_id)
        return vec

    def covers(self, key_id: str) -> bool:
        """True when :meth:`lookup` would hit — batched serving fast
        paths use this to route overlay keys through the per-query path
        WITHOUT booking a hit/miss."""
        now = self._clock()
        with self._lock:
            entry = self._vectors.get(key_id)
            return (entry is not None and now < entry[2]
                    and self._dirty.get(key_id, -1) <= entry[1])

    def key_version(self, key_id: str) -> int:
        """Monotonic per-key event version — bumps every time a poll sees
        new events for the key. The serving micro-caches (speed/cache.py)
        pass this as their entry version so a key's cached storage reads
        invalidate the moment the speed layer sees newer events."""
        with self._lock:
            return self._versions.get(key_id, 0)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "size": len(self._vectors),
                "dirty": len(self._dirty),
                "hits": self.hits,
                "misses": self.misses,
                "foldins": self.foldins,
                "cursor": self.cursor,
                "cursorLagEvents": self.last_lag,
                "foldinBudget": self._budget_rung,
            }

    # -- lifecycle ----------------------------------------------------------
    def invalidate_all(self) -> None:
        """Wholesale invalidation — hot model swap. The dirty set stays:
        those keys still have events newer than ANY model. In-flight
        freshness journeys die with their vectors (the successor overlay
        re-solves and restarts the trace)."""
        with self._lock:
            self._vectors.clear()
        self.freshness.invalidate()

    def known_keys(self) -> List[str]:
        """Every key this overlay has state for (solved, dirty, or
        tail-tracked) — what a successor overlay adopts on hot swap."""
        with self._lock:
            return list({*self._vectors, *self._dirty, *self._tail_hist})

    def adopt_keys(self, keys: Sequence[str]) -> int:
        """Hot-swap continuity: mark the predecessor overlay's keys
        dirty so the next polls RE-SOLVE them against the NEW factors
        (their events predate this overlay's cursor, so the tail alone
        would never surface them). Keys the new model trained on are
        skipped — the batch leg already covers them. Returns the number
        adopted."""
        n = 0
        with self._lock:
            for key in keys:
                if key in self.key_index:
                    continue
                self._dirty.setdefault(key, self.cursor)
                n += 1
        return n

    def start(self, interval_s: Optional[float] = None) -> None:
        """Spawn the background poller (daemon). No-op when the backend
        has no tail support."""
        if not self.enabled or self._thread is not None:
            return
        if interval_s is None:
            try:
                interval_s = float(os.environ.get("PIO_SPEED_POLL_S", "1.0"))
            except ValueError:
                interval_s = 1.0

        def run() -> None:
            while not self._stop.wait(interval_s):
                try:
                    self.poll()
                except Exception:
                    logger.exception("speed overlay poll failed")

        self._thread = threading.Thread(
            target=run, daemon=True, name="pio-speed-overlay")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    # -- the poll cycle -----------------------------------------------------
    def poll(self, max_keys: Optional[int] = None) -> Dict[str, Any]:
        """One subscriber cycle: tail read → dirty marking → batched
        fold-in. Returns a stats dict (tests and the bench read it)."""
        from incubator_predictionio_tpu_torch.data.store import EventStore

        cfg = self.config
        # snapshot the cursor once: it is written under the lock by the
        # reset branch below and by _fold_chunks, and read by stats()
        # scrapes on other threads
        with self._lock:
            cursor = self.cursor
        if cursor < 0:
            return {"enabled": False}
        inter, _times, append_ms, new_cursor, reset = \
            EventStore.read_interactions_since(
                cursor, cfg.app_name, cfg.channel_name,
                entity_type=cfg.entity_type,
                target_entity_type=cfg.target_entity_type,
                event_names=cfg.event_names,
                value_prop=cfg.value_prop,
                event_values=cfg.event_values,
                default_value=cfg.default_value,
            )
        if reset or new_cursor < cursor:
            # log rewrite (compaction/drop): every derived fact is
            # suspect — invalidate and resynchronize
            logger.warning(
                "speed overlay: cursor reset (%d -> %d); invalidating",
                cursor, new_cursor)
            with self._lock:
                self._vectors.clear()
                self._dirty.clear()
                self._tail_hist.clear()
                self.cursor = new_cursor
            self.freshness.invalidate()
            return {"reset": True, "cursor": new_cursor}
        if cfg.key_side == "entity":
            tail_keys = inter.user_ids
            key_idx, other_ids, other_idx = (
                inter.user_idx, inter.item_ids, inter.item_idx)
        else:
            tail_keys = inter.item_ids
            key_idx, other_ids, other_idx = (
                inter.item_idx, inter.user_ids, inter.user_idx)
        # resolve ids/columns OUTSIDE the lock — a bulk import can put
        # millions of rows in one delta, and the overlay lock is on the
        # serving hot path (lookup); only the dict writes hold it, in
        # bounded chunks so lookups interleave
        keys = list(tail_keys)
        rows: List[Tuple[str, Optional[int], float]] = []
        #: key -> oldest append wall (ms) in this delta — the freshness
        #: trace's stage-0 anchor (all dirtied keys, model-known too)
        append_by_key: Dict[str, int] = {}
        for row in range(len(inter)):
            key = keys[int(key_idx[row])]
            if len(append_ms):
                a = int(append_ms[row])
                if a > 0:
                    prev = append_by_key.get(key)
                    append_by_key[key] = a if prev is None else min(prev, a)
            if key in self.key_index:
                continue
            col = self.other_index.get(other_ids[int(other_idx[row])])
            if col is None:
                continue
            rows.append((key, int(col), float(inter.values[row])))
        self.freshness.on_poll_batch(append_by_key)
        chunk = 8192
        for s in range(0, max(len(keys), 1), chunk):
            with self._lock:
                for key in keys[s:s + chunk]:
                    self._dirty[key] = new_cursor
                    self._versions[key] = self._versions.pop(key, 0) + 1
                    self._vectors.pop(key, None)  # newer events: drop
                while len(self._versions) > self._max_versions:
                    self._versions.popitem(last=False)
        # accumulate model-UNKNOWN keys' history from the tail itself:
        # complete for keys born after the overlay started, so their
        # fold-in never pays a per-key storage read
        for s in range(0, len(rows), chunk):
            with self._lock:
                for key, col, val in rows[s:s + chunk]:
                    hist = self._tail_hist.get(key)
                    if hist is None:
                        hist = ([], [])
                        self._tail_hist[key] = hist
                        while (len(self._tail_hist)
                               > self._tail_hist_max_keys):
                            self._tail_hist.popitem(last=False)
                    else:
                        self._tail_hist.move_to_end(key)
                    hist[0].append(col)
                    hist[1].append(val)
                    if len(hist[0]) > cfg.max_history:
                        del hist[0][0]
                        del hist[1][0]
        now = self._clock()
        with self._lock:
            self.cursor = new_cursor
            # sweep expired vectors (lookups only reclaim keys that get
            # queried again; idle keys must not pin their vectors)
            expired = [k for k, (_v, _c, exp) in self._vectors.items()
                       if now >= exp]
            for k in expired:
                del self._vectors[k]
            budget = (self._budget_rung if max_keys is None
                      else int(max_keys))
            backlog = len(self._dirty)
            pending = list(self._dirty.items())[:budget]
        solved = self._fold_in(pending, new_cursor) if pending else 0
        # adapt the per-poll budget to the observed backlog: grow one
        # rung while dirty keys outpace it (a cold-start flood folds in
        # O(log) polls instead of O(backlog/base)), collapse one rung
        # when the backlog sits at half the budget or less — the same
        # grow/collapse hysteresis as the serving scheduler's rung.
        # GROWN rungs round up to full fold-in dispatch buckets
        # (foldin.max_batch) so a grown budget never ends on a padded
        # partial batch; the configured base (the idle/collapse floor)
        # and the cap are never exceeded by the rounding. Explicit
        # max_keys overrides (tests, operators) bypassed the rung, so
        # they must not train it either.
        if max_keys is None:
            from incubator_predictionio_tpu_torch.speed import (
                foldin as _foldin,
            )

            bucket = max(_foldin.max_batch(), 1)
            base = max(int(cfg.max_keys_per_poll), 1)
            cap = base * max(int(cfg.max_keys_growth), 1)
            # the rung is read by stats() scrapes and the budget slice
            # above, both under the lock
            with self._lock:
                if backlog > self._budget_rung:
                    grown = min(self._budget_rung * 2, cap)
                    if grown > base:
                        grown = min(-(-grown // bucket) * bucket, cap)
                    self._budget_rung = grown
                elif 2 * backlog <= self._budget_rung:
                    self._budget_rung = max(self._budget_rung // 2, base)
        with self._lock:
            size = len(self._vectors)
            still_dirty = len(self._dirty)
        try:
            end_cursor = EventStore.tail_cursor(cfg.app_name,
                                                cfg.channel_name)
        except Exception:
            end_cursor = new_cursor
        lag = int(end_cursor) - int(new_cursor)
        if not 0 <= lag < (1 << 40):
            lag = 0  # log generation changed mid-poll; next poll resets
        with self._lock:
            self.last_lag = lag
        _CURSOR_LAG.set(lag)
        return {"tail_rows": int(len(inter)), "solved": solved,
                "size": size, "dirty": still_dirty,
                "cursor": new_cursor, "lag": lag}

    # -- history + solve ----------------------------------------------------
    def _history(self, key_id: str) -> Tuple[np.ndarray, np.ndarray]:
        """Full interaction history of one key → (cols, vals), oldest
        first, indexed into the other side's factor table. Runs on the
        POLLER thread — never on a serving thread.

        Model-unknown keys solve from their tail-accumulated history
        (no storage read — the cold-start flood path); model-known keys
        have pre-deploy interactions the tail never saw, so they pay one
        hash-pushdown store read per fold-in."""
        if key_id not in self.key_index:
            with self._lock:
                hist = self._tail_hist.get(key_id)
                if hist is not None:
                    return (np.asarray(hist[0], np.int32),
                            np.asarray(hist[1], np.float32))
        from incubator_predictionio_tpu_torch.data.store import EventStore

        cfg = self.config
        kwargs: Dict[str, Any] = dict(
            app_name=cfg.app_name, channel_name=cfg.channel_name,
            entity_type=cfg.entity_type,
            target_entity_type=cfg.target_entity_type,
            event_names=list(cfg.event_names),
            limit=cfg.max_history, reversed=True)
        if cfg.key_side == "entity":
            kwargs["entity_id"] = key_id
        else:
            kwargs["target_entity_id"] = key_id
        fixed = cfg.event_values or {}
        cols: List[int] = []
        vals: List[float] = []
        for e in EventStore.find(**kwargs):
            other_id = (e.target_entity_id if cfg.key_side == "entity"
                        else e.entity_id)
            if other_id is None:
                continue
            col = self.other_index.get(other_id)
            if col is None:
                continue  # the other entity is unknown to the model
            if e.event in fixed:
                v = fixed[e.event]
            elif cfg.value_prop is not None:
                raw = e.properties.to_jsonable().get(cfg.value_prop)
                if not isinstance(raw, (int, float)) or isinstance(raw, bool):
                    continue
                v = float(raw)
            else:
                v = cfg.default_value
            cols.append(int(col))
            vals.append(float(v))
        # the find was newest-first (limit keeps the newest); restore
        # oldest-first so the solver's history-cap keeps the newest
        cols.reverse()
        vals.reverse()
        return np.asarray(cols, np.int32), np.asarray(vals, np.float32)

    def _fold_in(self, pending: Sequence[Tuple[str, int]],
                 cursor: int) -> int:
        """Batched fold-in of the pending dirty keys; returns the number
        of vectors published."""
        import time as _time

        cfg = self.config
        t0 = _time.perf_counter()
        keys = [k for k, _c in pending]
        rows = []
        for key in keys:
            try:
                rows.append(self._history(key))
            except Exception:
                logger.exception(
                    "speed overlay: history read failed for %r", key)
                rows.append((np.empty(0, np.int32), np.empty(0, np.float32)))
        vectors = self.solver.solve(rows)
        expires = self._clock() + cfg.ttl_s
        solved = 0
        published: List[str] = []
        published_vecs: List[np.ndarray] = []
        unpublished: List[str] = []
        with self._lock:
            for key, (cols, _vals), vec in zip(keys, rows, vectors):
                # only retire the dirty mark if no NEWER event arrived
                # while we solved (its cursor would exceed ours)
                if self._dirty.get(key, -1) <= cursor:
                    self._dirty.pop(key, None)
                if len(cols) == 0:
                    # nothing the model knows about: no vector
                    unpublished.append(key)
                    continue
                if cfg.transform is not None:
                    vec = cfg.transform(vec)
                vec32 = np.asarray(vec, np.float32)
                self._vectors[key] = (vec32, cursor, expires)
                self._vectors.move_to_end(key)
                published.append(key)
                published_vecs.append(vec32)
                solved += 1
            while len(self._vectors) > self._max_vectors:
                self._vectors.popitem(last=False)
            self.foldins += solved
        dt = _time.perf_counter() - t0
        if self.index_sink is not None and published:
            # outside the lock: the sink re-quantizes serving-index
            # rows / extends the exact tail (ops/mips.publish_rows)
            # (the JAX package then nudges its MIPS rebuild daemon,
            # which is not ported: ROADMAP.md Queue 1 item 5)
            try:
                self.index_sink(published, published_vecs)
            except Exception:
                logger.exception("speed overlay: index sink failed")
        # freshness stage 2: published keys now await their first serve;
        # keys with nothing foldable stop being traced (no vector can
        # ever serve their events until the next retrain)
        self.freshness.on_folded(published, dt)
        self.freshness.discard(unpublished)
        _FOLDIN_SECONDS.observe(dt)
        _FOLDIN_ROWS.inc(len(keys))
        return solved
