"""Background MIPS index rebuild daemon.

The port's copy of incubator_predictionio_tpu/ops/mips_daemon.py (whole), its
imports pointed at this package. One process-wide thread (hosted by the
prediction server next to the overlay poller, refcounted) that
watches every registered index and re-clusters OFF the serving path
when a trigger fires:

* ``tail``    — virtual-id tail entries (overlay-published new keys
                served by exact host scan) passed
                ``PIO_MIPS_REBUILD_TAIL`` (default 4096): the exact
                tail is O(tail·K) per query, so it must stay bounded.
* ``age``     — the index is older than ``PIO_MIPS_REBUILD_AGE_S``
                (default 900 s) AND has something to fold (a tail,
                churned rows, or cold-tier pressure). A quiet index
                never rebuilds on age alone.
* ``churn``   — rows published/delta-updated since the last build
                passed ``PIO_MIPS_REBUILD_CHURN`` (default 65536):
                accumulated in-place requantization drifts bucket
                geometry even when the tail stays small.
* ``promote`` — probe pressure on host-tiered cold buckets passed
                ``PIO_MIPS_TIER_PROMOTE_HITS`` (default 64): the
                working set shifted, bring those rows back to device.

Every rebuild is booked under its own trace ID via
:func:`obs.trace.log_stage_span` (span ``mips_rebuild``) like every
other actuation in this repo, counted in
``pio_mips_rebuilds_total{trigger}``, and swapped in atomically by
:func:`ops.mips.rebuild_index` — the overlay ``adopt_keys``
choreography means published ids survive and a publish that races the
swap re-routes to the successor. Serving never blocks: queries on the
old index object finish on the old arrays.

The daemon only ever READS its knob envs.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

from incubator_predictionio_tpu_torch import runtime

logger = logging.getLogger(__name__)

_POLL_S_DEFAULT = 5.0
_STATS_RING = 8


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def tail_trigger_rows() -> int:
    return max(_env_int("PIO_MIPS_REBUILD_TAIL", 4096), 1)


def age_trigger_s() -> float:
    return max(_env_float("PIO_MIPS_REBUILD_AGE_S", 900.0), 1.0)


def churn_trigger_rows() -> int:
    return max(_env_int("PIO_MIPS_REBUILD_CHURN", 65536), 1)


def promote_trigger_hits() -> int:
    return max(_env_int("PIO_MIPS_TIER_PROMOTE_HITS", 64), 1)


def _poll_s() -> float:
    return max(_env_float("PIO_MIPS_REBUILD_POLL_S", _POLL_S_DEFAULT),
               0.05)


def check_trigger(index: Any) -> Optional[str]:
    """Which trigger (if any) fires for ``index`` right now — pure
    read, shared by the daemon loop and tests."""
    from incubator_predictionio_tpu_torch.ops import mips

    tail = index.tail_virtual_size()
    if tail >= tail_trigger_rows():
        return "tail"
    if index.churn_rows >= churn_trigger_rows():
        return "churn"
    if (index.cold is not None
            and int(index.cold.hits.sum()) >= promote_trigger_hits()):
        return "promote"
    age = mips._now() - index.built_at
    if age >= age_trigger_s() and (
            tail or index.churn_rows or index.cold is not None):
        return "age"
    return None


class _RebuildDaemon:
    def __init__(self) -> None:
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._refs = 0
        self.rebuilds = 0
        self.failures = 0
        self.last: List[Dict[str, Any]] = []

    # -- lifecycle ----------------------------------------------------------
    def acquire(self) -> None:
        with self._lock:
            self._refs += 1
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, name="mips-rebuild-daemon",
                    daemon=True)
                self._thread.start()
                logger.info("mips rebuild daemon started")

    def release(self) -> None:
        with self._lock:
            self._refs = max(self._refs - 1, 0)
            if self._refs:
                return
            self._stop.set()
            self._wake.set()
            thread = self._thread
            self._thread = None
        if thread is not None:
            thread.join(timeout=5.0)
            logger.info("mips rebuild daemon stopped")

    def running(self) -> bool:
        thread = self._thread
        return thread is not None and thread.is_alive()

    def notify(self) -> None:
        """Publish-side nudge (overlay fold-in) — the daemon re-checks
        triggers now instead of at the next poll tick."""
        self._wake.set()

    # -- the loop -----------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=_poll_s())
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.sweep()
            except Exception:
                # the daemon must survive anything a rebuild throws —
                # a dead daemon is exactly the runbook's "tail climbs
                # forever" failure mode
                with self._lock:
                    self.failures += 1
                logger.exception("mips rebuild sweep failed")

    def sweep(self, honor_stop: bool = True) -> int:
        """One pass over every registered index; returns rebuilds.

        ``honor_stop=False`` is the synchronous entry (``sweep_now``):
        ``_stop`` stays set after the last ``release()``, and a caller
        sweeping on its own thread must not be silenced by a daemon
        that merely isn't running.
        """
        from incubator_predictionio_tpu_torch.ops import mips

        done = 0
        for table, index in mips.registered_tables():
            if honor_stop and self._stop.is_set():
                break
            trigger = check_trigger(index)
            if trigger is None:
                continue
            done += int(self._rebuild_one(table, index, trigger))
        return done

    def _rebuild_one(self, table: Any, index: Any,
                     trigger: str) -> bool:
        from incubator_predictionio_tpu_torch.obs.trace import (
            log_stage_span,
            new_trace_id,
        )
        from incubator_predictionio_tpu_torch.ops import mips

        trace_id = new_trace_id()
        t0 = time.perf_counter()
        try:
            # the daemon's own stream: a rebuild never queues ahead of a
            # dispatcher's query; the build finishes its work on it
            # before the swap (ops/mips.py ``_sync``)
            with runtime.own_stream(getattr(table, "device", None)):
                new = mips.rebuild_index(table, trigger=trigger)
        except Exception:
            with self._lock:
                self.failures += 1
            logger.exception("mips rebuild (%s) failed", trigger)
            return False
        dur = time.perf_counter() - t0
        if new is None:       # sharded / unregistered — not daemon work
            return False
        record = {
            "traceId": trace_id,
            "trigger": trigger,
            "engine": new.engine,
            "durationSec": round(dur, 3),
            "ext": new.n_ext,
            "deviceRows": new.tier_rows()[0],
            "hostRows": new.tier_rows()[1],
        }
        with self._lock:
            self.rebuilds += 1
            self.last.append(record)
            del self.last[:-_STATS_RING]
        log_stage_span("mips_rebuild", trace_id, dur, trigger=trigger,
                       engine=new.engine, ext=new.n_ext,
                       host_rows=new.tier_rows()[1])
        return True

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            rebuilds, failures = self.rebuilds, self.failures
            last = list(self.last)
        return {
            "running": self.running(),
            "rebuilds": rebuilds,
            "failures": failures,
            "tailTrigger": tail_trigger_rows(),
            "ageTriggerSec": age_trigger_s(),
            "churnTrigger": churn_trigger_rows(),
            "last": last,
        }


_DAEMON = _RebuildDaemon()


def acquire() -> None:
    """Refcounted start (prediction server load path)."""
    _DAEMON.acquire()


def release() -> None:
    """Refcounted stop (prediction server shutdown)."""
    _DAEMON.release()


def notify_publish() -> None:
    """Overlay fold-in handoff: published rows may have pushed the tail
    past its trigger — wake the daemon without waiting a poll tick."""
    _DAEMON.notify()


def running() -> bool:
    return _DAEMON.running()


def stats() -> Dict[str, Any]:
    """The ``mipsDaemon`` block of the prediction server's /status."""
    return _DAEMON.stats()


def sweep_now() -> int:
    """Synchronous trigger check + rebuilds (tests, bench): same code
    path as the daemon loop, caller's thread — works whether or not
    the background daemon is running."""
    return _DAEMON.sweep(honor_stop=False)
