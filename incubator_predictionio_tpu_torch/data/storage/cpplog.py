"""``cpplog`` event backend — the native append-only event-store engine.

The high-throughput event store, playing the HBase driver's role in the
reference (data/.../storage/hbase/HB{L,P}Events.scala: hashed row keys, one
table per app/channel, server-side scan filters). Storage engine is
``native/src/eventlog.cc`` (C++, ctypes-bound): one framed append-only log
file per (namespace, app, channel); record headers carry event time and
FNV-1a hashes of the filterable fields so time-range / entity / event-name
scans are pushed down to C++ without parsing JSON; deletes are tombstones.
The DAO re-checks every predicate on the JSON payload, so hash collisions
cannot produce wrong results — only wasted candidate reads.

Events only (``PIO_STORAGE_REPOSITORIES_EVENTDATA_{NAME,SOURCE}`` →
``TYPE=cpplog``); metadata/models stay on sqlite/memory/localfs, mirroring
how the reference mixes HBase event data with JDBC/ES metadata.

Like the localfs model store, a log directory is owned by one server
process at a time.

The port's own copy of incubator_predictionio_tpu/data/storage/cpplog.py,
its imports rewritten to this package and ``native/src/eventlog.cc``
copied beside the port's other native sources; the log files are the same
bytes, so a log written by either package reads in the other. One
difference: where the native library cannot be built or loaded, opening
the store raises a StorageError carrying the build's error (the port's
``native.load`` raises; the JAX package's returns None). The cache-served
scan, the group commit, the writer and scan shards, the tail read and the
replication verbs are the JAX module's, one for one.
"""

from __future__ import annotations

import ctypes
import json
import logging
import threading
from collections import deque
from datetime import datetime
from pathlib import Path
from typing import Any, Iterator, Optional, Sequence

from incubator_predictionio_tpu_torch import native
from incubator_predictionio_tpu_torch.data.event import (
    Event,
    new_event_id,
    validate_event,
)
from incubator_predictionio_tpu_torch.data.storage import base
from incubator_predictionio_tpu_torch.data.storage.base import UNSET
from incubator_predictionio_tpu_torch.utils.times import to_millis

logger = logging.getLogger(__name__)

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1

#: auto shard-count floor: below this many entries per shard the thread
#: spawn + table-merge overhead outweighs the parallel scan (an explicit
#: PIO_SCAN_SHARDS bypasses the floor — the differential tests exercise
#: shard counts on tiny logs)
_MIN_SCAN_ENTRIES_PER_SHARD = 200_000


def _h(s: Optional[str]) -> int:
    return 0 if s is None else native.fnv1a64(s.encode("utf-8"))


#: group-commit outcome sentinel: the merged append hit the sidecar
#: limits, so the caller must retry its own batch alone (see
#: CppLogEvents.insert_interactions)
_RETRY_SOLO = object()


class _PendingInsert:
    """One caller's prepped columnar batch, waiting in the group-commit
    queue. ``key`` is the scalar field tuple (app, channel, entity types,
    event name, value prop) — only identical keys merge."""

    __slots__ = ("key", "n", "times", "uidx", "iidx", "vals", "utab",
                 "itab", "done", "ids", "error")

    def __init__(self, key, n, times, uidx, iidx, vals, utab, itab):
        self.key = key
        self.n = n
        self.times = times
        self.uidx = uidx
        self.iidx = iidx
        self.vals = vals
        self.utab = utab
        self.itab = itab
        self.done = threading.Event()
        self.ids = None
        self.error = None


class StorageClient(base.BaseStorageClient):
    """Holds the log directory and open native handles."""

    def __init__(self, config: base.StorageClientConfig):
        super().__init__(config)
        try:
            lib = native.load()
        except (RuntimeError, OSError) as exc:
            raise base.StorageError(
                "cpplog backend requires the native library (g++ "
                f"toolchain): {exc}") from exc
        self.lib = lib
        from incubator_predictionio_tpu_torch.data.storage import pio_home
        path = config.properties.get("PATH") or str(
            Path(pio_home()) / "cpplog")
        self.dir = Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.lock = threading.RLock()
        self._handles: dict[str, int] = {}
        # handle read-pins: a lock-narrowed scan (CppLogEvents.
        # scan_interactions) runs its native calls WITHOUT holding
        # self.lock, so drop/close/compact — which free or swap the
        # native handle — must wait until in-flight readers drain.
        # Condition(self.lock) releases the (R)Lock while waiting, so a
        # pinned reader can still take the lock briefly (revalidation,
        # cache writes) without deadlocking the waiter.
        self._pins: dict[str, int] = {}
        self._pins_cv = threading.Condition(self.lock)
        # process-local log generations: bumped whenever a log's entry
        # numbering is rewritten (compact/drop), so tail cursors from
        # before the rewrite are detectable even after the entry count
        # grows past its old value (speed-layer resync contract)
        self._generations: dict[str, int] = {}
        # multi-writer layout state (all guarded by self.lock): resolved
        # shard counts per meta file,
        # per-shard append locks, and the cold-tier existence cache
        self._shard_counts: dict[str, int] = {}  # guarded by lock
        self._shard_locks: dict[str, threading.Lock] = {}  # guarded by lock
        self._has_cold: dict[str, bool] = {}  # guarded by lock
        # per-shard REWRITE epochs (replication): bumped only when a
        # segment file's existing bytes are rewritten (roll/compact/
        # drop) — append-only growth (including tombstone markers) does
        # NOT bump it, so a follower tailing the file byte-level keeps
        # its prefix valid across deletes and resyncs only on rewrites.
        # In-memory only: a leader restart reads as an epoch change,
        # which conservatively triggers a follower resync.
        self._repl_epochs: dict[str, int] = {}  # guarded by lock
        # per-log COUNT OBSERVATIONS: (entry_count, wall_ms) snapshots —
        # "at wall w this process saw the log hold c entries". Pushed by
        # appends (exact: the count just before/after the write) AND by
        # every tail read / tail_cursor call, so a pure READER process
        # (the split-deployment prediction server polling a log the
        # event server writes) still bounds append times by its own poll
        # cadence. The freshness trace stamps a tail [lo, hi) with the
        # NEWEST observation whose count <= lo: every entry past lo was
        # appended after that wall, so age is only ever OVERSTATED —
        # exactly (base.py contract) — by at most one append batch
        # in-process and one poll interval cross-process. No covering
        # observation -> -1 (unattributable, dropped from the trace).
        # Cleared on generation bump (entries renumber).
        self._count_marks: dict[str, "deque"] = {}

    def generation(self, ns: str, app_id: int,
                   channel_id: Optional[int]) -> int:
        key = str(self._file(ns, app_id, channel_id))
        with self.lock:
            return self._generations.get(key, 0)

    def bump_generation_locked(self, path) -> None:
        key = str(path)
        self._generations[key] = self._generations.get(key, 0) + 1
        # entries renumber: every count observation is now meaningless
        self._count_marks.pop(key, None)

    def bump_epoch_locked(self, hot_path) -> None:
        """Mark a shard's segment files as REWRITTEN (roll/compact/
        drop): replication followers discard their byte-level prefix
        and resync the shard."""
        key = str(hot_path)
        self._repl_epochs[key] = self._repl_epochs.get(key, 0) + 1

    def epoch_locked(self, hot_path) -> int:
        return self._repl_epochs.get(str(hot_path), 0)

    def note_count_locked(self, path, count: int) -> None:
        """Record one count observation ("the log held ``count`` entries
        now") — the freshness trace's append-stamp source. Appends push
        their before/after counts (exact stamps); tail reads and
        tail_cursor push what they saw (the cross-process bound). Caller
        holds the client lock."""
        from incubator_predictionio_tpu_torch.utils.times import wall_millis

        marks = self._count_marks.get(str(path))
        if marks is None:
            marks = self._count_marks[str(path)] = deque(maxlen=4096)
        count = int(count)
        if marks and marks[-1][0] == count:
            # same count seen later: the newer wall is the TIGHTER lower
            # bound for entries appended past it
            marks[-1] = (count, wall_millis())
            return
        marks.append((count, wall_millis()))

    def append_wall_since_locked(self, path, lo: int) -> int:
        """Append-wall lower bound (epoch ms) for entries at/after
        position ``lo``: the NEWEST count observation with count <= lo —
        every entry past ``lo`` was appended after that wall, so the
        batch's age can only be OVERSTATED (base.py contract), never
        fabricated fresh. -1 when no observation covers ``lo`` (the
        entries predate everything this process has seen — e.g. a log
        written before the first poll). Caller holds the client lock."""
        marks = self._count_marks.get(str(path))
        if marks:
            for count, wall in reversed(marks):
                if count <= lo:
                    return wall
        return -1

    def pin(self, ns: str, app_id: int, channel_id: Optional[int]) -> str:
        """Mark the (ns, app, channel) handle as read-busy; returns the
        key for :meth:`unpin`. Caller must unpin in a finally block."""
        key = str(self._file(ns, app_id, channel_id))
        with self.lock:
            self._pins[key] = self._pins.get(key, 0) + 1
        return key

    def unpin(self, key: str) -> None:
        with self.lock:
            n = self._pins.get(key, 0) - 1
            if n > 0:
                self._pins[key] = n
            else:
                self._pins.pop(key, None)
            self._pins_cv.notify_all()

    def _wait_unpinned_locked(self, key: Optional[str] = None) -> None:
        """Block (lock released while waiting) until no reader pins the
        key — or, with key=None, until no reader pins anything. Scans are
        finite, so this always terminates."""
        if key is None:
            while any(self._pins.values()):
                self._pins_cv.wait()
        else:
            while self._pins.get(key, 0) > 0:
                self._pins_cv.wait()

    def _file(self, ns: str, app_id: int, channel_id: Optional[int],
              shard: int = 0) -> Path:
        """Hot segment of writer shard ``shard``. Shard 0 keeps the
        legacy single-writer name, so existing logs ARE shard 0 of a
        1-shard layout — no migration."""
        chan = 0 if channel_id is None else channel_id
        stem = f"{ns}app{app_id}_ch{chan}"
        if shard:
            return self.dir / f"{stem}.w{shard}.log"
        return self.dir / f"{stem}.log"

    def _meta_file(self, ns: str, app_id: int,
                   channel_id: Optional[int]) -> Path:
        chan = 0 if channel_id is None else channel_id
        return self.dir / f"{ns}app{app_id}_ch{chan}.shards"

    @staticmethod
    def _cold(path: Path) -> Path:
        """Cold-tier segment of a hot file (sealed rolls accumulate
        here; background compaction only ever rewrites this file)."""
        return path.with_name(path.name + ".cold")

    def shards(self, ns: str, app_id: int,
               channel_id: Optional[int]) -> int:
        """Writer-shard count for this (ns, app, channel) log. Fixed at
        log creation: a ``<stem>.shards`` meta file pins it; a NEW log
        (no meta, no legacy file) takes ``PIO_LOG_SHARDS`` and persists
        it, so readers and writers of an existing log can never disagree
        with the layout on disk."""
        import os

        mkey = str(self._meta_file(ns, app_id, channel_id))
        with self.lock:
            n = self._shard_counts.get(mkey)
            if n is not None:
                return n
            meta = Path(mkey)
            if meta.exists():
                try:
                    n = max(int(json.loads(meta.read_text())["shards"]), 1)
                except (ValueError, KeyError, OSError):
                    n = 1
            elif self._file(ns, app_id, channel_id).exists():
                n = 1  # legacy single-writer log predating the meta
            else:
                try:
                    n = max(int(os.environ.get("PIO_LOG_SHARDS", "1")), 1)
                except ValueError:
                    n = 1
                if n > 1:
                    meta.write_text(json.dumps({"shards": n}))
            self._shard_counts[mkey] = n
            return n

    def set_shards(self, ns: str, app_id: int, channel_id: Optional[int],
                   n: int) -> None:
        """Pin the shard count (replication followers mirror the
        leader's layout before the first apply). Refuses to change the
        layout of a log that already has data."""
        n = max(int(n), 1)
        with self.lock:
            cur = self.shards(ns, app_id, channel_id)
            if cur == n:
                return
            # only DATA pins the layout: a status probe on a follower
            # that hasn't been configured yet materializes empty
            # segment files (handle_path creates on open), and those
            # must not wedge the follower on its first configure
            empties = []
            for k in range(cur):
                hot = self._file(ns, app_id, channel_id, k)
                for path in (self._cold(hot), hot):
                    if not path.exists():
                        continue
                    h = self.handle_path(path)
                    if int(self.lib.pio_evlog_entry_count(h)) > 0:
                        raise base.StorageError(
                            f"cannot reshape an existing log from {cur} "
                            f"to {n} writer shards")
                    empties.append((hot, path))
            for hot, path in empties:
                key = str(path)
                self._wait_unpinned_locked(key)
                h = self._handles.pop(key, None)
                if h is not None:
                    self.lib.pio_evlog_close(h)
                path.unlink(missing_ok=True)
                self._has_cold.pop(str(hot), None)
            meta = self._meta_file(ns, app_id, channel_id)
            if n > 1:
                meta.write_text(json.dumps({"shards": n}))
            else:
                meta.unlink(missing_ok=True)
            self._shard_counts[str(meta)] = n

    def has_cold(self, path: Path) -> bool:
        key = str(path)
        with self.lock:
            v = self._has_cold.get(key)
            if v is None:
                v = self._has_cold[key] = self._cold(path).exists()
            return v

    def shard_lock(self, path) -> threading.Lock:
        """Per-shard append lock: writers to DIFFERENT shards never
        contend on it, which is the whole multi-writer point (the native
        per-handle mutex is the last line of defense, not the
        serialization point)."""
        key = str(path)
        with self.lock:
            lk = self._shard_locks.get(key)
            if lk is None:
                lk = self._shard_locks[key] = threading.Lock()
            return lk

    def handle_path(self, path) -> int:
        """Open (or return the cached) native handle for an explicit
        segment file — shard hots and cold tiers share one handle
        table."""
        key = str(path)
        with self.lock:
            h = self._handles.get(key)
            if h is None:
                h = self.lib.pio_evlog_open(key.encode())
                if not h:
                    raise base.StorageError(f"cannot open event log {key}")
                self._handles[key] = h
            return h

    def handle(self, ns: str, app_id: int, channel_id: Optional[int]) -> int:
        # resolve (and persist) the shard count BEFORE the open creates
        # the shard-0 file: a bare legacy .log with no meta pins the log
        # to one writer forever, so the meta must hit disk first
        self.shards(ns, app_id, channel_id)
        return self.handle_path(self._file(ns, app_id, channel_id))

    def close_path_locked(self, path) -> None:
        """Close one segment's cached handle (caller holds the lock and
        has waited out pins) — the reload/roll seam."""
        h = self._handles.pop(str(path), None)
        if h is not None:
            self.lib.pio_evlog_close(h)

    def drop(self, ns: str, app_id: int, channel_id: Optional[int]) -> bool:
        nsh = self.shards(ns, app_id, channel_id)
        with self.lock:
            for k in range(nsh):
                hot = self._file(ns, app_id, channel_id, k)
                for path in (self._cold(hot), hot):
                    key = str(path)
                    self._wait_unpinned_locked(key)
                    h = self._handles.pop(key, None)
                    if h is not None:
                        self.lib.pio_evlog_close(h)
                    path.unlink(missing_ok=True)
                    self._has_cold.pop(str(hot), None)
                from incubator_predictionio_tpu_torch.data.storage import (
                    traincache,
                )
                traincache.invalidate(hot)
                self.bump_generation_locked(hot)
                self.bump_epoch_locked(hot)
            meta = self._meta_file(ns, app_id, channel_id)
            meta.unlink(missing_ok=True)
            self._shard_counts.pop(str(meta), None)
        return True

    def sync(self) -> None:
        """fdatasync every open log (durability point; appends only fflush —
        torn tails are dropped by the reopen scan in eventlog.cc)."""
        with self.lock:
            for key, h in self._handles.items():
                if self.lib.pio_evlog_sync(h) != 0:
                    raise base.StorageError(
                        f"fdatasync failed on event log {key}")

    def close(self) -> None:
        import logging
        with self.lock:
            self._wait_unpinned_locked()
            for key, h in self._handles.items():
                if self.lib.pio_evlog_sync(h) != 0:
                    logging.getLogger(__name__).warning(
                        "fdatasync failed on event log %s at close; recent "
                        "appends may not be durable", key)
                self.lib.pio_evlog_close(h)
            self._handles.clear()


class CppLogEvents(base.Events):
    """Events DAO over the native log (contract: LEvents.scala:40-492)."""

    FAST_LOCAL = True  # native append, no fsync per op: ingest inline
    #: insert_interactions coalesces concurrent callers into one native
    #: append (see __init__) — the EventServer keys its dispatch policy
    #: on this declared capability, not on private method names
    GROUP_COMMIT = True

    def __init__(self, client: StorageClient,
                 config: base.StorageClientConfig, prefix: str = ""):
        self.client = client
        self.ns = prefix
        # group-commit state for insert_interactions (the REST batch hot
        # path): concurrent wire batches coalesce into ONE native append
        # under the client lock. The per-append fixed cost (the ctypes
        # crossing + the C++ buffered-write epilogue) otherwise caps small
        # wire batches however many clients post concurrently, because
        # the client lock serializes appends.
        self._gc_mu = threading.Lock()
        self._gc_pending: list = []
        # persistent fan-out pool for sharded appends (spawning threads
        # per append costs more than a small native append itself);
        # created lazily under the client lock  # guarded by client.lock
        self._fanout_pool = None
        # observability (served under /stats.json "groupCommit"): how
        # well concurrent callers coalesce — appends vs caller batches
        # is the amortization factor operators tune client counts by
        self._gc_appends = 0       # native appends performed
        self._gc_caller_batches = 0  # caller batches those appends carried
        self._gc_events = 0        # events written through group commit
        self._gc_max_merge = 0     # largest events-per-append seen
        # events landed per writer shard (sharded layouts only) — the
        # skew signal behind pio_ingest_shard_events{shard}
        self._shard_events: dict[int, int] = {}  # guarded by _gc_mu
        # sub-metrics of the last full sharded scan (shard count, native
        # lock-held wall, merge/total walls — _merge_shards fills the
        # same dict the bench reads), exported as gauges at scrape time
        self._last_scan_stats: dict = {}
        # scrape-time bridge into the process registry: group-commit and
        # scan counters show up on every server's GET /metrics. Named
        # registration (replaces the previous backend's hook) + weakref
        # (a dropped Events object must be collectable) keep
        # Storage.reset()/re-configure cycles from accumulating hooks.
        import weakref

        from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics

        ref = weakref.ref(self)

        def collect() -> None:
            ev = ref()
            if ev is not None:
                ev._export_native_metrics()

        obs_metrics.REGISTRY.register_collector("cpplog_native", collect)

    def _export_native_metrics(self) -> None:
        """Snapshot the native-side counters into registry gauges
        (gauges, not counters: the registry mirrors a snapshot owned by
        the storage layer; process restarts and backend swaps reset it).
        Runs only at scrape time — zero cost on the ingest hot path."""
        from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics

        reg = obs_metrics.REGISTRY
        gc = self.group_commit_stats()
        reg.gauge("pio_group_commit_appends",
                  "native appends performed by the group commit"
                  ).set(gc["appends"])
        reg.gauge("pio_group_commit_caller_batches",
                  "caller batches carried by those appends"
                  ).set(gc["callerBatches"])
        reg.gauge("pio_group_commit_events",
                  "events written through the group commit"
                  ).set(gc["events"])
        reg.gauge("pio_group_commit_mean_events_per_append",
                  "achieved coalescing: events per native append"
                  ).set(gc["meanEventsPerAppend"])
        scan = self._last_scan_stats
        if scan:
            reg.gauge("pio_scan_shards",
                      "shard count of the last full event-log scan"
                      ).set(scan.get("scan_shards", 0))
            reg.gauge("pio_scan_lock_held_seconds",
                      "native log-mutex wall held by the last scan's "
                      "snapshots (writers stalled at most this long)"
                      ).set(scan.get("scan_lock_held_s", 0.0))
            reg.gauge("pio_scan_wall_seconds",
                      "total wall of the last full scan"
                      ).set(scan.get("scan_wall_s", 0.0))
            reg.gauge("pio_scan_rows",
                      "interaction rows the last full scan returned"
                      ).set(scan.get("scan_rows", 0))
        with self._gc_mu:
            shard_events = dict(self._shard_events)
        if shard_events:
            g = reg.gauge(
                "pio_ingest_shard_events",
                "events landed per writer shard since server start "
                "(watch the spread for writer-shard skew)",
                labels=("shard",))
            for k, v in shard_events.items():
                g.labels(shard=str(k)).set(v)

    def _export_retrain_delta(self, tail_rows: int) -> None:
        """pio_retrain_delta_rows — the event delta the last cache-served
        scan actually re-scanned (the O(delta) steady-state figure).
        Booked once per scan on the host path; never inside a trace."""
        try:
            from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics

            obs_metrics.REGISTRY.gauge(
                "pio_retrain_delta_rows",
                "event rows appended since the previous training scan "
                "(the tail the cache fold re-scanned)",
            ).set(tail_rows)
        except Exception:
            logger.exception("retrain-delta gauge export failed")

    def _handle(self, app_id: int, channel_id: Optional[int]) -> int:
        return self.client.handle(self.ns, app_id, channel_id)

    # -- multi-writer layout ----------------------------------------------
    def _nshards(self, app_id: int, channel_id: Optional[int]) -> int:
        return self.client.shards(self.ns, app_id, channel_id)

    def _is_plain(self, app_id: int, channel_id: Optional[int]) -> bool:
        """True for the legacy layout (one writer, no cold tier) —
        every method keeps its original single-file code path then,
        byte-for-byte."""
        if self._nshards(app_id, channel_id) != 1:
            return False
        return not self.client.has_cold(
            self.client._file(self.ns, app_id, channel_id))

    def _hot_path(self, app_id, channel_id, shard: int) -> Path:
        return self.client._file(self.ns, app_id, channel_id, shard)

    def _unit_paths(self, app_id, channel_id) -> list:
        """Segment files in merge order: for each shard, cold tier first
        (entries there precede every hot entry of the shard), then hot.
        → [(shard, path, is_hot)]."""
        out = []
        for k in range(self._nshards(app_id, channel_id)):
            hot = self._hot_path(app_id, channel_id, k)
            if self.client.has_cold(hot):
                out.append((k, self.client._cold(hot), False))
            out.append((k, hot, True))
        return out

    def _snapshot_shards_locked(self, app_id, channel_id) -> list:
        """Under the client lock: per-shard layout snapshot →
        [(shard, hot_path, gen, [(path, handle, count)], total)]."""
        lib = self.client.lib
        shards: dict[int, list] = {}
        order: list[int] = []
        for k, path, _hot in self._unit_paths(app_id, channel_id):
            h = self.client.handle_path(path)
            cnt = int(lib.pio_evlog_entry_count(h))
            if k not in shards:
                shards[k] = []
                order.append(k)
            shards[k].append((path, h, cnt))
        out = []
        for k in order:
            hot = self._hot_path(app_id, channel_id, k)
            gen = self.client._generations.get(str(hot), 0)
            units = shards[k]
            out.append((k, hot, gen, units, sum(c for _, _, c in units)))
        return out

    def _pin_units_locked(self, snap) -> list:
        pins = []
        for _k, _hot, _gen, units, _tot in snap:
            for path, _h, _cnt in units:
                key = str(path)
                self.client._pins[key] = self.client._pins.get(key, 0) + 1
                pins.append(key)
        return pins

    def _spray(self, uidx, utab, nshards: int):
        """Per-row writer shard from the FNV-1a hash of the user entity
        id — an entity's whole history lands in one shard, so per-entity
        event order survives sharding."""
        import numpy as np

        hashes = native.fnv1a64_table(utab.blob, utab.offsets)
        tab_shard = (hashes % np.uint64(nshards)).astype(np.int64)
        return tab_shard[uidx]

    def _scan_units(self, units, start_time, until_time, entity_type,
                    target_entity_type, names, fixed, value_prop,
                    default_value, stats=None, shard_sink=None):
        """Fan the native scan out over SEGMENT FILES (shard hots and
        cold tiers) instead of entry ranges of one file — the
        multi-writer generalization of :meth:`_scan_sharded`. ``units``
        is [(handle, lo, hi)] in merge order; the merge itself is the
        same TableMerger discipline (global first-seen interning in unit
        order, one stable time sort when an inversion exists), so the
        result is byte-identical to a single-writer scan of the same
        events whenever event times are distinct. Caller must have
        pinned every unit's path."""
        import time as _time
        from concurrent.futures import ThreadPoolExecutor

        t_all0 = _time.perf_counter()

        def run(u):
            h, lo, hi = u
            t0 = _time.perf_counter()
            out = self._scan_native(
                h, start_time, until_time, entity_type,
                target_entity_type, names, fixed, value_prop,
                default_value, min_entry_idx=lo, max_entry_idx=hi,
                with_times=True, n_threads=1 if len(units) > 1 else 0)
            return out, _time.perf_counter() - t0

        if len(units) == 1:
            return self._merge_shards(iter([run(units[0])]), 1, t_all0,
                                      stats, shard_sink)
        with ThreadPoolExecutor(max_workers=len(units)) as pool:
            futs = [pool.submit(run, u) for u in units]
            return self._merge_shards(
                iter(f.result() for f in futs), len(units), t_all0,
                stats, shard_sink)

    # -- lifecycle ---------------------------------------------------------
    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        self._handle(app_id, channel_id)
        return True

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        return self.client.drop(self.ns, app_id, channel_id)

    def close(self) -> None:  # client-owned handles stay for other DAOs
        with self.client.lock:
            pool, self._fanout_pool = self._fanout_pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    # -- record io ---------------------------------------------------------
    def _read_raw(self, h: int, index: int) -> Optional[bytes]:
        cap = 4096
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self.client.lib.pio_evlog_read(h, index, buf, cap)
            if n < 0:
                return None
            if n <= cap:
                return buf.raw[:n]
            cap = n

    def _read(self, h: int, index: int) -> Optional[dict]:
        payload = self._read_raw(h, index)
        if payload is None:
            return None
        return json.loads(payload.decode("utf-8"))

    def _candidates_by_id(self, h: int, event_id: str) -> list[int]:
        cap = 64
        out = (ctypes.c_int64 * cap)()
        n = self.client.lib.pio_evlog_find_id(h, _h(event_id), out, cap)
        return list(out[:n])

    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        # one code path: a single insert is a batch of one (gets the same
        # upsert semantics and the sidecar fast-scan block)
        return self.insert_batch([event], app_id, channel_id)[0]

    @staticmethod
    def _derive_event_ids(seed: int, n: int) -> list:
        """The 32-hex event ids pio_evlog_append_interactions generates for
        ``id_seed=seed`` — byte-identical to eventlog.cc (splitmix64 over
        seed^k and seed+golden+k), so a caller routing a batch through the
        columnar import can report the stored ids without reading back."""
        import numpy as np

        def mix(x):
            x = x + np.uint64(0x9E3779B97F4A7C15)
            x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
            return x ^ (x >> np.uint64(31))

        with np.errstate(over="ignore"):
            k = np.arange(n, dtype=np.uint64)
            s = np.uint64(seed)
            ida = mix(s ^ k)
            idb = mix(s + np.uint64(0x9E3779B97F4A7C15) + k)
        # render all n ids with ONE hexlify over a packed big-endian
        # buffer: per-id f-string formatting would be the ingest hot
        # path's largest single Python cost, well above the native
        # append's per-row cost at batch scale
        import binascii

        buf = np.empty((n, 2), dtype=">u8")
        buf[:, 0] = ida
        buf[:, 1] = idb
        hexstr = binascii.hexlify(buf.tobytes()).decode("ascii")
        return [hexstr[i:i + 32] for i in range(0, 32 * n, 32)]

    def _uniform_batch(self, events: Sequence[Event]):
        """events → (Interactions, etype, tetype, name, vprop, times_ms)
        when the whole batch can take the columnar import, else None.

        The equivalence conditions live in ONE place —
        ``base.uniform_interactions`` — shared with the CLI import gate
        (cli/commands.py), so the two paths cannot drift. The gate's
        screens imply full ``validate_event`` validity for every batch it
        ACCEPTS (see its docstring), so no per-event re-validation here —
        rejected batches fall to the generic path, which validates. NOTE
        the one observable delta, documented in docs/data-collection.md:
        columnar records report creationTime == eventTime (the compact
        sidecar stores one timestamp)."""
        return base.uniform_interactions(events)

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> list:
        """Bulk fast path: one framed batch write (pio_evlog_append_bulk).

        Hashing, sidecar construction, and framing happen in C++; Python
        serializes the JSON document and packs the numeric properties. Each
        record gets a binary sidecar block (the columnar-scan fast path)
        unless a field exceeds the sidecar's length limits.

        Uniform id-less interaction batches (the REST batch endpoint's hot
        shape) route through the fully-native columnar import instead —
        compact records, C++ rendering, and training-projection
        maintenance — with the generated ids derived in Python from the
        same seed formula."""
        import secrets
        import struct

        import numpy as np

        n = len(events)
        if n == 0:
            return []
        if n >= 8:
            fast = self._uniform_batch(events)
            if fast is not None:
                inter, etype, tetype, name, vprop, times = fast
                seed = int.from_bytes(secrets.token_bytes(8), "little")
                key = (app_id, channel_id, etype, tetype, name, vprop)
                try:
                    prep = self._prep_columnar(inter, times)
                    with self.client.lock:
                        rc, ids = self._append_columnar_any(
                            key, n, *prep, seed=seed)
                except base.StorageError:
                    # safe to fall through to the generic path: the -2
                    # (sidecar-limits) case rejects BEFORE any write, and a
                    # write failure truncates the log back to the batch
                    # start (eventlog.cc append_interactions is
                    # all-or-nothing), so nothing partial remains
                    rc, ids = 0, None
                if rc == n:
                    return ids
        # last-wins for duplicate explicit ids WITHIN the batch too (sqlite
        # INSERT OR REPLACE parity): earlier occurrences are dropped from
        # the write set, since the per-event tombstone scan below can only
        # see records already in the log
        last_pos: dict[str, int] = {
            e.event_id: k for k, e in enumerate(events) if e.event_id
        }
        if not self._is_plain(app_id, channel_id):
            return self._insert_batch_sharded(events, app_id, channel_id,
                                              last_pos)
        with self.client.lock:
            h = self._handle(app_id, channel_id)
            ids: list[str] = []
            times = np.empty(n, np.int64)
            offs = np.empty(7 * n + 1, np.int64)
            meta = bytearray(8 * n)
            chunks: list[bytes] = []
            skipped = 0
            pos = 0
            offs[0] = 0
            j = 0
            for k, event in enumerate(events):
                validate_event(event)
                if event.event_id:
                    eid = event.event_id
                    if last_pos[eid] != k:  # superseded later in this batch
                        ids.append(eid)
                        skipped += 1
                        continue
                    # upsert parity with insert(): tombstone existing record
                    for idx in self._candidates_by_id(h, eid):
                        obj = self._read(h, idx)
                        if obj is not None and obj.get("eventId") == eid:
                            self.client.lib.pio_evlog_tombstone(h, idx)
                else:
                    eid = new_event_id()
                ids.append(eid)
                w = k - skipped  # position in the write set
                payload = json.dumps(
                    event.with_id(eid).to_jsonable(), separators=(",", ":")
                ).encode("utf-8")
                times[w] = to_millis(event.event_time)
                etype_b = event.entity_type.encode("utf-8")
                ent_b = event.entity_id.encode("utf-8")
                name_b = event.event.encode("utf-8")
                tet_b = (event.target_entity_type or "").encode("utf-8")
                tei_b = (event.target_entity_id or "").encode("utf-8")
                has_target = event.target_entity_id is not None
                # numeric properties for the sidecar's value lookup
                props_blob = b""
                n_props = 0
                sidecar_ok = max(
                    len(etype_b), len(ent_b), len(name_b),
                    len(tet_b), len(tei_b)) < 0xFFFF
                if sidecar_ok:
                    parts = []
                    for key, v in event.properties.to_jsonable().items():
                        if isinstance(v, bool) or \
                                not isinstance(v, (int, float)):
                            continue
                        kb = key.encode("utf-8")
                        if len(kb) > 255 or n_props == 255:
                            # a numeric prop the sidecar cannot carry: the
                            # sidecar would disagree with the JSON, so this
                            # record must use the JSON path
                            sidecar_ok = False
                            break
                        parts.append(struct.pack("<B", len(kb)) + kb
                                     + struct.pack("<d", float(v)))
                        n_props += 1
                    if sidecar_ok:
                        props_blob = b"".join(parts)
                    else:
                        n_props = 0
                struct.pack_into("<BBBBI", meta, 8 * w,
                                 1 if has_target else 0,
                                 1 if sidecar_ok else 0,
                                 n_props, 0, len(props_blob))
                for field in (etype_b, ent_b, name_b, eid.encode("utf-8"),
                              tet_b, tei_b, props_blob + payload):
                    chunks.append(field)
                    pos += len(field)
                    j += 1
                    offs[j] = pos
            n_write = n - skipped
            buf = b"".join(chunks)
            rc = self.client.lib.pio_evlog_append_bulk(
                h, n_write,
                times.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                buf,
                offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                bytes(meta),
            )
            if rc != n_write:
                raise base.StorageError("bulk event append failed")
            if n_write:
                end = self.client.lib.pio_evlog_entry_count(h)
                path = self.client._file(self.ns, app_id, channel_id)
                self.client.note_count_locked(path, end - n_write)
                self.client.note_count_locked(path, end)
        return ids

    def _insert_batch_sharded(self, events: Sequence[Event], app_id: int,
                              channel_id: Optional[int],
                              last_pos: dict) -> list:
        """Generic (per-Event) insert for sharded/tiered layouts:
        events spray to writer shards by entity-id hash (the same
        policy as the columnar path, so an entity's history stays in
        one shard) and each shard takes ONE bulk append. Explicit-id
        upserts probe EVERY segment of every shard — the prior record
        may live anywhere when the entity id changed between writes —
        and a tombstone landing in a COLD segment bumps that shard's
        generation (the marker shifts the shard's merged entry
        numbering, so tail cursors must resync)."""
        import struct

        import numpy as np

        nsh = self._nshards(app_id, channel_id)
        n = len(events)
        ids: list = [None] * n
        with self.client.lock:
            units = [(k, path, self.client.handle_path(path), is_hot)
                     for k, path, is_hot in
                     self._unit_paths(app_id, channel_id)]

            def probe_tombstone(eid: str) -> None:
                for uk, _upath, uh, u_hot in units:
                    for idx in self._candidates_by_id(uh, eid):
                        obj = self._read(uh, idx)
                        if obj is not None and obj.get("eventId") == eid:
                            self.client.lib.pio_evlog_tombstone(uh, idx)
                            if not u_hot:
                                self.client.bump_generation_locked(
                                    self._hot_path(app_id, channel_id,
                                                   uk))

            write_rows: dict[int, list] = {}  # shard -> [(event, eid)]
            for i, event in enumerate(events):
                validate_event(event)
                if event.event_id:
                    eid = event.event_id
                    ids[i] = eid
                    if last_pos[eid] != i:  # superseded later in batch
                        continue
                    probe_tombstone(eid)
                else:
                    eid = new_event_id()
                    ids[i] = eid
                shard = native.fnv1a64(
                    event.entity_id.encode("utf-8")) % nsh
                write_rows.setdefault(shard, []).append((event, eid))
            for shard in sorted(write_rows):
                rows = write_rows[shard]
                path = self._hot_path(app_id, channel_id, shard)
                h = self.client.handle_path(path)
                m = len(rows)
                times = np.empty(m, np.int64)
                offs = np.empty(7 * m + 1, np.int64)
                meta = bytearray(8 * m)
                chunks: list[bytes] = []
                pos = 0
                offs[0] = 0
                j = 0
                for w, (event, eid) in enumerate(rows):
                    payload = json.dumps(
                        event.with_id(eid).to_jsonable(),
                        separators=(",", ":")).encode("utf-8")
                    times[w] = to_millis(event.event_time)
                    etype_b = event.entity_type.encode("utf-8")
                    ent_b = event.entity_id.encode("utf-8")
                    name_b = event.event.encode("utf-8")
                    tet_b = (event.target_entity_type or ""
                             ).encode("utf-8")
                    tei_b = (event.target_entity_id or ""
                             ).encode("utf-8")
                    has_target = event.target_entity_id is not None
                    props_blob = b""
                    n_props = 0
                    sidecar_ok = max(
                        len(etype_b), len(ent_b), len(name_b),
                        len(tet_b), len(tei_b)) < 0xFFFF
                    if sidecar_ok:
                        parts = []
                        for pkey, v in \
                                event.properties.to_jsonable().items():
                            if isinstance(v, bool) or \
                                    not isinstance(v, (int, float)):
                                continue
                            kb = pkey.encode("utf-8")
                            if len(kb) > 255 or n_props == 255:
                                sidecar_ok = False
                                break
                            parts.append(
                                struct.pack("<B", len(kb)) + kb
                                + struct.pack("<d", float(v)))
                            n_props += 1
                        if sidecar_ok:
                            props_blob = b"".join(parts)
                        else:
                            n_props = 0
                    struct.pack_into("<BBBBI", meta, 8 * w,
                                     1 if has_target else 0,
                                     1 if sidecar_ok else 0,
                                     n_props, 0, len(props_blob))
                    for field in (etype_b, ent_b, name_b,
                                  eid.encode("utf-8"), tet_b, tei_b,
                                  props_blob + payload):
                        chunks.append(field)
                        pos += len(field)
                        j += 1
                        offs[j] = pos
                buf = b"".join(chunks)
                rc = self.client.lib.pio_evlog_append_bulk(
                    h, m,
                    times.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    buf,
                    offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    bytes(meta))
                if rc != m:
                    raise base.StorageError("bulk event append failed")
                end = self.client.lib.pio_evlog_entry_count(h)
                self.client.note_count_locked(path, end - m)
                self.client.note_count_locked(path, end)
        return ids

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        with self.client.lock:
            if self._is_plain(app_id, channel_id):
                handles = [self._handle(app_id, channel_id)]
            else:
                handles = [self.client.handle_path(p) for _k, p, _hot
                           in self._unit_paths(app_id, channel_id)]
            for h in handles:
                for idx in self._candidates_by_id(h, event_id):
                    obj = self._read(h, idx)
                    if obj is not None and obj.get("eventId") == event_id:
                        return Event.from_jsonable(obj)
            return None

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        with self.client.lock:
            if self._is_plain(app_id, channel_id):
                h = self._handle(app_id, channel_id)
                for idx in self._candidates_by_id(h, event_id):
                    obj = self._read(h, idx)
                    if obj is not None and obj.get("eventId") == event_id:
                        return self.client.lib.pio_evlog_tombstone(
                            h, idx) == 0
                return False
            for k, path, is_hot in self._unit_paths(app_id, channel_id):
                h = self.client.handle_path(path)
                for idx in self._candidates_by_id(h, event_id):
                    obj = self._read(h, idx)
                    if obj is not None and obj.get("eventId") == event_id:
                        ok = self.client.lib.pio_evlog_tombstone(
                            h, idx) == 0
                        if ok and not is_hot:
                            # the marker appended to the COLD tier sits
                            # between cold and hot in merge order, so
                            # the shard's merged entry numbering shifts:
                            # tail cursors must resync
                            self.client.bump_generation_locked(
                                self._hot_path(app_id, channel_id, k))
                        return ok
            return False

    # -- query -------------------------------------------------------------
    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Any = UNSET,
        target_entity_id: Any = UNSET,
        limit: Optional[int] = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        names = None if event_names is None else list(event_names)
        if names is not None and not names:
            return iter(())  # IN () matches nothing (sqlite parity)
        want = -1 if limit is None or limit < 0 else limit
        if want == 0:
            return iter(())
        if not self._is_plain(app_id, channel_id):
            return self._find_units(
                app_id, channel_id, start_time, until_time, entity_type,
                entity_id, names, target_entity_type, target_entity_id,
                want, reversed)
        n_names = 0 if names is None else len(names)
        name_arr = ((ctypes.c_uint64 * n_names)(*map(_h, names))
                    if n_names else None)
        # the target-entity predicates are not in the native header, so the
        # C-side limit can only apply when they are absent
        post_filter = target_entity_type is not UNSET or \
            target_entity_id is not UNSET
        c_limit = -1 if post_filter else want

        # hold the client lock only across the native query and the raw
        # payload copies (memcpy): remove()/close() take the same lock
        # before freeing the handle, so the handle stays alive, while the
        # expensive JSON parsing below never blocks other DAO operations.
        # The returned iterator (plain list) never touches native state.
        raw: list[bytes] = []
        with self.client.lock:
            h = self._handle(app_id, channel_id)
            lib = self.client.lib
            total = lib.pio_evlog_count(h)
            cap = total if c_limit < 0 else min(total, c_limit)
            out = (ctypes.c_int64 * max(cap, 1))()
            n = lib.pio_evlog_query(
                h,
                _I64_MIN if start_time is None else to_millis(start_time),
                _I64_MAX if until_time is None else to_millis(until_time),
                _h(entity_type) if entity_type is not None else 0,
                _h(entity_id) if entity_id is not None else 0,
                name_arr, n_names, 1 if reversed else 0, c_limit, out, cap,
            )
            if post_filter and want >= 0:
                # limited query whose predicates live only in Python: parse
                # and filter IN-lock so reading stops at `want` matches —
                # copying all candidates first would be O(log size)
                results = self._filter_parsed(
                    (self._read_raw(h, out[i]) for i in range(n)),
                    entity_type, entity_id, names,
                    target_entity_type, target_entity_id, want)
                return iter(results)
            for i in range(n):
                payload = self._read_raw(h, out[i])
                if payload is not None:
                    raw.append(payload)

        # unlimited (or natively limited) queries: the expensive JSON
        # parsing runs outside the lock so other DAO ops are not stalled
        results = self._filter_parsed(
            iter(raw), entity_type, entity_id, names,
            target_entity_type, target_entity_id, want)
        return iter(results)

    def _find_units(self, app_id, channel_id, start_time, until_time,
                    entity_type, entity_id, names, target_entity_type,
                    target_entity_id, want: int, rev: bool):
        """find() over a sharded/tiered layout: one native query per
        segment file, per-unit parse, then a merge on (time, unit
        order). Within a unit the native query's (time, append) order
        is preserved; across units, equal timestamps order by unit
        index — cross-shard append-order ties were never defined (the
        writers race on the wire too)."""
        n_names = 0 if names is None else len(names)
        name_arr = ((ctypes.c_uint64 * n_names)(*map(_h, names))
                    if n_names else None)
        parsed: list = []  # (time_ms, unit_idx, seq, Event)
        with self.client.lock:
            lib = self.client.lib
            for u, (_k, path, _hot) in enumerate(
                    self._unit_paths(app_id, channel_id)):
                h = self.client.handle_path(path)
                total = lib.pio_evlog_count(h)
                out = (ctypes.c_int64 * max(total, 1))()
                m = lib.pio_evlog_query(
                    h,
                    _I64_MIN if start_time is None
                    else to_millis(start_time),
                    _I64_MAX if until_time is None
                    else to_millis(until_time),
                    _h(entity_type) if entity_type is not None else 0,
                    _h(entity_id) if entity_id is not None else 0,
                    name_arr, n_names, 1 if rev else 0, -1, out, total,
                )
                evs = self._filter_parsed(
                    (self._read_raw(h, out[i]) for i in range(m)),
                    entity_type, entity_id, names,
                    target_entity_type, target_entity_id, -1)
                for seq, ev in enumerate(evs):
                    parsed.append((to_millis(ev.event_time), u, seq, ev))
        parsed.sort(key=(lambda t: (-t[0], t[1], t[2])) if rev
                    else (lambda t: (t[0], t[1], t[2])))
        results = [t[3] for t in parsed]
        if want >= 0:
            results = results[:want]
        return iter(results)

    def scan_interactions(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        entity_type: str = "user",
        target_entity_type: str = "item",
        event_names: Sequence[str] = ("rate",),
        value_prop: Optional[str] = None,
        event_values: Optional[dict] = None,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None,
        default_value: float = 1.0,
        use_cache: bool = True,
        seed_cache: bool = True,
        stats: Optional[dict] = None,
        shard_sink=None,
    ) -> base.Interactions:
        """Columnar scan, sharded across ``PIO_SCAN_SHARDS`` threads over
        disjoint entry ranges (ctypes releases the GIL; each shard interns
        into a private id table, merged deterministically in shard order —
        the result is byte-identical to a sequential scan for every shard
        count, including ids and row order).

        Locking: the client lock is held only to snapshot the log's
        entry/dead counts and pin the handle; the scan runs with the lock
        RELEASED (the native side holds its own mutex only for a header
        snapshot — eventlog.cc), so concurrent event writes proceed while
        a training scan is in flight. The snapshot end bound keeps rows
        appended mid-scan out of the result, and the snapshot is
        revalidated (dead count unchanged) before it may seed the
        projection cache.

        Stored-value queries (one event name, a ``value_prop``, no fixed
        override) are served from the training-projection cache when one is
        valid (traincache.py): only the log *tail* appended since the cache
        was written is re-scanned, and the merged result is folded back.
        Everything else — and any shape the fold cannot prove equivalent —
        takes the full sharded scan, which then (re)seeds the cache at
        training scale.

        cpplog-specific extras (the bench and the pipelined ingest path;
        other backends ignore them): ``use_cache``/``seed_cache`` bypass
        the projection cache's read/write legs, ``stats`` (a dict) is
        filled with the scan sub-metrics (shard count, per-shard walls,
        native-lock-held wall), and ``shard_sink(k, uidx, iidx, vals,
        times)`` receives each completed shard in shard order — indices
        already remapped into the global id tables — while later shards
        are still scanning (ops/sparse.StreamingPrep consumes this)."""
        from incubator_predictionio_tpu_torch.data.storage import traincache

        names = [str(n) for n in event_names]
        fixed = event_values or {}
        if not self._is_plain(app_id, channel_id):
            return self._scan_interactions_units(
                app_id, channel_id, entity_type, target_entity_type,
                names, fixed, value_prop, default_value, start_time,
                until_time, stats, shard_sink)
        servable = (
            len(names) == 1 and value_prop is not None
            and names[0] not in fixed
        )
        with self.client.lock:
            h = self._handle(app_id, channel_id)
            lib = self.client.lib
            cpath = traincache.path_for(
                self.client._file(self.ns, app_id, channel_id))
            raw = lib.pio_evlog_entry_count(h)
            dead = lib.pio_evlog_dead_count(h)
            pin = self.client.pin(self.ns, app_id, channel_id)
        try:
            if servable and use_cache:
                cache = traincache.load(cpath)
                if cache is not None and (
                        cache.spec.entity_type == entity_type
                        and cache.spec.target_entity_type
                        == target_entity_type
                        and cache.spec.event_name == names[0]
                        and cache.spec.value_prop == value_prop
                        and cache.dead_count == dead
                        and cache.raw_count <= raw):
                    inter = self._serve_from_cache(
                        h, cache, cpath, raw, dead, entity_type,
                        target_entity_type, names[0], value_prop,
                        start_time, until_time, stats=stats)
                    if inter is not None:
                        return inter
            unbounded = start_time is None and until_time is None
            seed = servable and unbounded and seed_cache
            # stats always collect into a dict (the caller's, or our
            # own) so the last full scan's sub-metrics stay readable by
            # the /metrics bridge even for callers that pass none
            stats = {} if stats is None else stats
            inter, times = self._scan_sharded(
                h, raw, start_time, until_time, entity_type,
                target_entity_type, names, fixed, value_prop,
                default_value, stats=stats, shard_sink=shard_sink)
            self._last_scan_stats = stats
            stats.setdefault("scan_source", "scan")
            # times are always non-decreasing here: _merge_shards restores
            # global time order whenever the log held an inversion
            if seed and len(inter) >= traincache.MIN_NNZ:
                self._seed_cache_revalidated(
                    h, cpath, traincache.TrainCache(
                        spec=traincache.Spec(
                            entity_type, target_entity_type,
                            names[0], value_prop),
                        uidx=inter.user_idx, iidx=inter.item_idx,
                        vals=inter.values, times=times,
                        user_tab=inter.user_ids, item_tab=inter.item_ids,
                        raw_count=raw, dead_count=dead),
                    dead,
                    plan=(traincache.plan_path_for(
                        str(cpath)[: -len(".traincache")]), None))
            return inter
        finally:
            self.client.unpin(pin)

    def _scan_interactions_units(self, app_id, channel_id, entity_type,
                                 target_entity_type, names, fixed,
                                 value_prop, default_value, start_time,
                                 until_time, stats, shard_sink):
        """Training scan over a sharded/tiered layout: every segment
        (cold tier before hot, shard order) scans CONCURRENTLY and the
        results merge under the TableMerger discipline — byte-identical
        to the single-writer scan of the same events whenever event
        times are distinct (_merge_shards restores global time order;
        equal-time ties across writer shards order by segment, an order
        a single writer never defined either). The projection cache
        stays plain-layout-only: a sharded training scan always runs
        the full fan-out, which IS the parallel fast path."""
        with self.client.lock:
            snap = self._snapshot_shards_locked(app_id, channel_id)
            pins = self._pin_units_locked(snap)
        try:
            units = []
            for _k, _hot, _gen, segs, _tot in snap:
                for _path, h, cnt in segs:
                    units.append((h, 0, cnt))
            stats = {} if stats is None else stats
            inter, _times = self._scan_units(
                units, start_time, until_time, entity_type,
                target_entity_type, names, fixed, value_prop,
                default_value, stats=stats, shard_sink=shard_sink)
            self._last_scan_stats = stats
            stats.setdefault("scan_source", "scan")
            return inter
        finally:
            for key in pins:
                self.client.unpin(key)

    # -- speed-layer tail cursor -------------------------------------------
    def tail_cursor(self, app_id: int,
                    channel_id: Optional[int] = None) -> int:
        """Monotonic write cursor = (log generation << TAIL_GEN_SHIFT) |
        raw entry count. Compaction/drop renumber entries and bump the
        generation, which read_interactions_since surfaces as a RESET —
        a bare count comparison would miss "compacted, then appended
        past the old count before the next poll".

        Sharded/tiered layouts return a :class:`base.VectorCursor` —
        one component per writer shard, each (generation <<
        TAIL_GEN_SHIFT) | merged (cold + hot) count — whose comparison
        semantics make every overlay/controller predicate behave: any
        component behind reads as "behind", any generation mismatch
        resets."""
        with self.client.lock:
            if self._is_plain(app_id, channel_id):
                h = self._handle(app_id, channel_id)
                path = self.client._file(self.ns, app_id, channel_id)
                gen = self.client._generations.get(str(path), 0)
                count = int(self.client.lib.pio_evlog_entry_count(h))
                # count observation: anchors the freshness bound for a
                # pure READER process (the subscriber calls this at
                # startup)
                self.client.note_count_locked(path, count)
                return (gen << self.TAIL_GEN_SHIFT) | count
            snap = self._snapshot_shards_locked(app_id, channel_id)
            comps = []
            for _k, hot, gen, _segs, total in snap:
                self.client.note_count_locked(hot, total)
                comps.append((gen << self.TAIL_GEN_SHIFT) | total)
            return base.VectorCursor(comps)

    def read_interactions_since(
        self,
        cursor: int,
        app_id: int,
        channel_id: Optional[int] = None,
        entity_type: str = "user",
        target_entity_type: str = "item",
        event_names: Sequence[str] = ("rate",),
        value_prop: Optional[str] = None,
        event_values: Optional[dict] = None,
        default_value: float = 1.0,
    ):
        """Tail scan over entries [cursor_pos, entry_count) →
        (Interactions, times, append_ms, new_cursor, reset). Rides the
        bounded-range sharded scan (entry order, lock-free on a pinned
        handle) — the same O(delta) machinery the traincache fold uses,
        so polling the tail costs the tail, not the log. A cursor minted
        before a compaction/drop (generation mismatch) returns an EMPTY
        tail with ``reset=True`` — the subscriber resynchronizes.

        Append stamps resolve from the client's python-side COUNT
        observations at BATCH granularity (the native record has no
        append-wall column): every row in this tail read carries the
        newest observed wall at which the log still held <= cursor
        entries, so a row's age is conservatively OVERSTATED — by at
        most one append batch when this process wrote the events, and by
        at most one poll interval when another process did (each tail
        read records its own observation, so a pure reader bounds the
        next delta by its poll cadence). Entries that predate every
        observation (a log written before the subscriber's first look)
        report -1 and drop out of the freshness trace."""
        import numpy as np

        names = [str(n) for n in event_names]
        fixed = event_values or {}
        if not self._is_plain(app_id, channel_id):
            return self._read_tail_units(
                cursor, app_id, channel_id, entity_type,
                target_entity_type, names, fixed, value_prop,
                default_value)
        gen_mask = (1 << self.TAIL_GEN_SHIFT) - 1
        with self.client.lock:
            h = self._handle(app_id, channel_id)
            path = self.client._file(self.ns, app_id, channel_id)
            gen = self.client._generations.get(str(path), 0)
            raw = int(self.client.lib.pio_evlog_entry_count(h))
            pin = self.client.pin(self.ns, app_id, channel_id)
        try:
            new_cursor = (gen << self.TAIL_GEN_SHIFT) | raw
            cur = max(int(cursor), 0)
            cur_gen, lo = cur >> self.TAIL_GEN_SHIFT, cur & gen_mask
            reset = cur_gen != gen or lo > raw
            if reset or raw <= lo:
                with self.client.lock:
                    if not reset:
                        self.client.note_count_locked(path, raw)
                empty = base.Interactions(
                    user_idx=np.empty(0, np.int32),
                    item_idx=np.empty(0, np.int32),
                    values=np.empty(0, np.float32),
                    user_ids=base.IdTable(b"", np.zeros(1, np.int64)),
                    item_ids=base.IdTable(b"", np.zeros(1, np.int64)))
                return (empty, np.empty(0, np.int64),
                        np.empty(0, np.int64), new_cursor, reset)
            with self.client.lock:
                append_wall = self.client.append_wall_since_locked(
                    path, lo)
                # this read's own observation bounds the NEXT delta
                self.client.note_count_locked(path, raw)
            # tail reads book their scan sub-metrics too (scan_source
            # "tail"): between retrains the controller's staleness
            # inputs come from exactly these polls, so /metrics must
            # not freeze at the last FULL scan's numbers
            stats: dict = {}
            inter, times = self._scan_sharded(
                h, raw, None, None, entity_type, target_entity_type,
                names, fixed, value_prop, default_value,
                min_entry_idx=lo, stats=stats)
            stats["scan_source"] = "tail"
            self._last_scan_stats = stats
            append_ms = np.full(len(inter), append_wall, np.int64)
            return inter, times, append_ms, new_cursor, False
        finally:
            self.client.unpin(pin)

    def _read_tail_units(self, cursor, app_id, channel_id, entity_type,
                         target_entity_type, names, fixed, value_prop,
                         default_value):
        """Vector-cursor tail read for sharded/tiered layouts: one
        cursor component per writer shard, each (gen << SHIFT) | merged
        (cold + hot) count. Any component's generation mismatch — or a
        scalar/mis-shaped cursor, e.g. one minted before the layout
        changed — resets the WHOLE tail (the merged stream renumbers).
        Append stamps take the MIN over the contributing shards'
        observations: ages stay conservatively overstated, exactly the
        base.py contract."""
        import numpy as np

        gen_mask = (1 << self.TAIL_GEN_SHIFT) - 1
        with self.client.lock:
            snap = self._snapshot_shards_locked(app_id, channel_id)
            pins = self._pin_units_locked(snap)
        try:
            new_cursor = base.VectorCursor(
                (gen << self.TAIL_GEN_SHIFT) | total
                for _k, _hot, gen, _segs, total in snap)
            comps = None
            if isinstance(cursor, (tuple, list)) \
                    and len(cursor) == len(snap):
                comps = [max(int(c), 0) for c in cursor]
            reset = comps is None
            units = []
            if not reset:
                for (_k, _hot, gen, segs, total), comp in zip(snap,
                                                              comps):
                    cgen = comp >> self.TAIL_GEN_SHIFT
                    lo = comp & gen_mask
                    if cgen != gen or lo > total:
                        reset = True
                        break
                    # map the shard-merged lo across its cold/hot split
                    off = 0
                    for _path, h, cnt in segs:
                        seg_lo = min(max(lo - off, 0), cnt)
                        if seg_lo < cnt:
                            units.append((h, seg_lo, cnt))
                        off += cnt
            if reset or not units:
                with self.client.lock:
                    if not reset:
                        for _k, hot, _gen, _segs, total in snap:
                            self.client.note_count_locked(hot, total)
                empty = base.Interactions(
                    user_idx=np.empty(0, np.int32),
                    item_idx=np.empty(0, np.int32),
                    values=np.empty(0, np.float32),
                    user_ids=base.IdTable(b"", np.zeros(1, np.int64)),
                    item_ids=base.IdTable(b"", np.zeros(1, np.int64)))
                return (empty, np.empty(0, np.int64),
                        np.empty(0, np.int64), new_cursor, reset)
            with self.client.lock:
                walls = []
                for (_k, hot, _gen, _segs, total), comp in zip(snap,
                                                               comps):
                    lo = comp & gen_mask
                    if total > lo:  # this shard contributes rows
                        walls.append(
                            self.client.append_wall_since_locked(hot,
                                                                 lo))
                    self.client.note_count_locked(hot, total)
                append_wall = (-1 if not walls or min(walls) < 0
                               else min(walls))
            stats: dict = {}
            inter, times = self._scan_units(
                units, None, None, entity_type, target_entity_type,
                names, fixed, value_prop, default_value, stats=stats)
            stats["scan_source"] = "tail"
            self._last_scan_stats = stats
            append_ms = np.full(len(inter), append_wall, np.int64)
            return inter, times, append_ms, new_cursor, False
        finally:
            for key in pins:
                self.client.unpin(key)

    def _seed_cache_revalidated(self, h, cpath, cache, dead: int,
                                plan=None) -> None:
        """Publish a projection cache built from a lock-free scan: the
        (potentially hundreds-of-MB) file is serialized OUTSIDE the
        client lock; only the snapshot revalidation + atomic rename run
        under it. Commits only while the dead count still matches the
        scan's snapshot — a delete that landed during the scan may have
        killed rows the result still carries, and a cache seeded from it
        would serve stale rows later.

        ``plan``: optional ``(plan_path, (user_degrees, item_degrees) |
        None)`` — the prep-plan sidecar published (or recomputed) next to
        the cache, keyed to the same snapshot, so the next training prep
        skips its degree pass (O(delta) steady-state retrain)."""
        import numpy as np

        from incubator_predictionio_tpu_torch.data.storage import traincache

        staged = traincache.stage(cpath, cache)
        committed = False
        try:
            with self.client.lock:
                if self.client.lib.pio_evlog_dead_count(h) == dead:
                    staged.commit()
                    committed = True
        finally:
            if not committed:
                staged.abort()
        if committed and plan is not None:
            ppath, degrees = plan
            if degrees is None:
                degrees = (
                    np.bincount(cache.uidx, minlength=len(cache.user_tab)
                                ).astype(np.int64),
                    np.bincount(cache.iidx, minlength=len(cache.item_tab)
                                ).astype(np.int64))
            try:
                traincache.save_plan(ppath, cache.spec, cache.raw_count,
                                     cache.dead_count, *degrees)
            except OSError:
                logger.exception("prep-plan sidecar write failed")

    @staticmethod
    def _resolve_shards(span: int) -> int:
        """Shard count for a scan over ``span`` entries. PIO_SCAN_SHARDS
        is read per call (tests and operators override at runtime): an
        explicit positive value is honored exactly; unset/0 = auto —
        min(usable cores, 8), with no sharding below
        _MIN_SCAN_ENTRIES_PER_SHARD entries per shard (thread spawn and
        merge overhead dwarfs tiny scans)."""
        import os

        if span <= 1:
            return 1
        try:
            n = int(os.environ.get("PIO_SCAN_SHARDS", "0"))
        except ValueError:
            n = 0
        if n <= 0:
            try:
                cores = len(os.sched_getaffinity(0))
            except (AttributeError, OSError):
                cores = os.cpu_count() or 1
            n = min(max(cores, 1), 8,
                    max(span // _MIN_SCAN_ENTRIES_PER_SHARD, 1))
        return max(1, min(n, span))

    def _scan_sharded(self, h, hi_entry, start_time, until_time,
                      entity_type, target_entity_type, names, fixed,
                      value_prop, default_value, min_entry_idx: int = 0,
                      stats: Optional[dict] = None, shard_sink=None):
        """Fan the native scan out over disjoint entry ranges of
        [min_entry_idx, hi_entry) → (Interactions, times).

        Each shard scans in ENTRY order with a private id table; shards
        are merged in shard order (traincache.TableMerger — global
        first-seen interning), then global time order is restored with
        one stable sort, which reproduces the sequential scan's
        (time, append-order) output exactly; already-ordered logs (every
        bulk import) skip the sort. Caller must hold the client lock or
        have pinned the handle; the native calls themselves hold the log
        mutex only for their header snapshots, so shards really run in
        parallel and writers are never stalled."""
        import time as _time

        from concurrent.futures import ThreadPoolExecutor

        lo = max(int(min_entry_idx), 0)
        span = max(int(hi_entry) - lo, 0)
        shards = self._resolve_shards(span)
        bounds = [lo + (span * k) // shards for k in range(shards + 1)]
        bounds[-1] = int(hi_entry)
        t_all0 = _time.perf_counter()

        def run(k: int):
            t0 = _time.perf_counter()
            out = self._scan_native(
                h, start_time, until_time, entity_type,
                target_entity_type, names, fixed, value_prop,
                default_value, min_entry_idx=bounds[k],
                max_entry_idx=bounds[k + 1], with_times=True,
                n_threads=1 if shards > 1 else 0)
            return out, _time.perf_counter() - t0

        if shards == 1:
            shard_results = [run(0)]
        else:
            with ThreadPoolExecutor(max_workers=shards) as pool:
                futs = [pool.submit(run, k) for k in range(shards)]
                # in-order merge: shard k's table merge must follow
                # shards 0..k-1 (first-seen determinism), so results are
                # consumed in shard order — completed early shards merge
                # on this thread while later shards are still scanning
                shard_results = iter(f.result() for f in futs)
                return self._merge_shards(
                    shard_results, shards, t_all0, stats, shard_sink)
        return self._merge_shards(iter(shard_results), shards, t_all0,
                                  stats, shard_sink)

    def _merge_shards(self, shard_results, shards, t_all0, stats,
                      shard_sink):
        import time as _time

        import numpy as np

        from incubator_predictionio_tpu_torch.data.storage import traincache

        umerge, imerge = traincache.TableMerger(), traincache.TableMerger()
        u_parts, i_parts, v_parts, t_parts = [], [], [], []
        first_tabs = None
        walls: list = []
        merge_wall = 0.0
        lock_ns = 0
        k = 0
        for (s_inter, s_times, s_lock_ns), wall in shard_results:
            t0 = _time.perf_counter()
            uremap = umerge.add(s_inter.user_ids)
            iremap = imerge.add(s_inter.item_ids)
            uidx, iidx = s_inter.user_idx, s_inter.item_idx
            if k > 0:  # shard 0's remap is the identity by construction
                uidx, iidx = uremap[uidx], iremap[iidx]
            else:
                first_tabs = (s_inter.user_ids, s_inter.item_ids)
            u_parts.append(uidx)
            i_parts.append(iidx)
            v_parts.append(s_inter.values)
            t_parts.append(s_times)
            if shard_sink is not None:
                shard_sink(k, uidx, iidx, s_inter.values, s_times)
            merge_wall += _time.perf_counter() - t0
            walls.append(wall)
            lock_ns += s_lock_ns
            k += 1
        if len(u_parts) == 1:
            uidx, iidx = u_parts[0], i_parts[0]
            vals, times = v_parts[0], t_parts[0]
            utab, itab = first_tabs
        else:
            uidx = np.concatenate(u_parts)
            iidx = np.concatenate(i_parts)
            vals = np.concatenate(v_parts)
            times = np.concatenate(t_parts)
            utab, itab = umerge.table(), imerge.table()
        reordered = False
        if len(times) > 1 and np.any(np.diff(times) < 0):
            order = np.argsort(times, kind="stable")
            uidx, iidx = uidx[order], iidx[order]
            vals, times = vals[order], times[order]
            # first-seen interning must follow the REORDERED row sequence
            uidx, utab = traincache.first_seen_reindex(uidx, utab)
            iidx, itab = traincache.first_seen_reindex(iidx, itab)
            reordered = True
        if stats is not None:
            stats.update({
                "scan_shards": shards,
                "scan_shard_walls_s": [round(w, 3) for w in walls],
                "scan_lock_held_s": round(lock_ns / 1e9, 6),
                "scan_merge_wall_s": round(merge_wall, 3),
                "scan_wall_s": round(_time.perf_counter() - t_all0, 3),
                "scan_reordered": reordered,
                "scan_rows": int(len(vals)),
            })
        inter = base.Interactions(
            user_idx=uidx, item_idx=iidx, values=vals,
            user_ids=utab, item_ids=itab,
        )
        return inter, times

    def _scan_native(self, h, start_time, until_time, entity_type,
                     target_entity_type, names, fixed, value_prop,
                     default_value, min_entry_idx: int = 0,
                     max_entry_idx: int = -1, with_times: bool = False,
                     n_threads: int = 0):
        """One native scan call → (Interactions, times|None, lock_ns).
        Caller must hold the client lock or have pinned the handle (the
        native call itself locks the log mutex only for its snapshot).
        ``max_entry_idx >= 0`` bounds the entry range and switches the
        output to ENTRY order (see eventlog.cc); -1 keeps the historical
        time order through the end of the log."""
        import numpy as np

        lib = self.client.lib
        c_names = (ctypes.c_char_p * max(len(names), 1))(
            *[n.encode("utf-8") for n in names] or [None])
        c_fixed = (ctypes.c_double * max(len(names), 1))(
            *[float(fixed.get(n, float("nan"))) for n in names] or [0.0])
        res = lib.pio_evlog_scan_interactions(
            h,
            _I64_MIN if start_time is None else to_millis(start_time),
            _I64_MAX if until_time is None else to_millis(until_time),
            min_entry_idx, max_entry_idx,
            entity_type.encode("utf-8"),
            target_entity_type.encode("utf-8"),
            c_names, c_fixed, len(names),
            None if value_prop is None else value_prop.encode("utf-8"),
            float(default_value), n_threads,
        )
        try:
            nnz = lib.pio_scan_nnz(res)
            lock_ns = int(lib.pio_scan_lock_held_ns(res))
            uidx = np.empty(nnz, np.int32)
            iidx = np.empty(nnz, np.int32)
            vals = np.empty(nnz, np.float32)
            times = np.empty(nnz, np.int64) if with_times else None
            if nnz:
                lib.pio_scan_fill(
                    res,
                    uidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    iidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                )
                if with_times:
                    lib.pio_scan_fill_times(
                        res,
                        times.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            user_ids = self._scan_ids(res, 0)
            item_ids = self._scan_ids(res, 1)
        finally:
            lib.pio_scan_free(res)
        inter = base.Interactions(
            user_idx=uidx, item_idx=iidx, values=vals,
            user_ids=user_ids, item_ids=item_ids,
        )
        return inter, times, lock_ns

    def _serve_from_cache(self, h, cache, cpath, raw, dead, entity_type,
                          target_entity_type, name, value_prop,
                          start_time, until_time, stats=None):
        """Tail-scan + merge + time-filter; None → caller full-scans.
        Caller has validated the cache and PINNED the handle (the client
        lock is NOT held — the tail scan runs lock-free; the fold write
        revalidates the snapshot under the lock).

        ``stats`` gains the continuation-retrain telemetry:
        ``scan_source`` ("cache"), ``scan_tail_rows`` (the event delta —
        also exported as the ``pio_retrain_delta_rows`` gauge) and the
        per-side degree histograms (``plan_user_degrees`` /
        ``plan_item_degrees``) maintained O(delta) through the prep-plan
        sidecar so training prep can skip its degree pass."""
        import dataclasses

        import numpy as np

        from incubator_predictionio_tpu_torch.data.storage import traincache

        # the plan sidecar sits next to the cache: <log>.prepplan. Only
        # unbounded scans can use (or maintain) it — a time-filtered
        # query's degrees would describe the wrong row set, so it must
        # not pay the sidecar read at all
        unbounded = start_time is None and until_time is None
        ppath = traincache.plan_path_for(
            str(cpath)[: -len(".traincache")])
        plan = (traincache.load_plan(
            ppath, cache.spec, cache.raw_count, cache.dead_count)
            if unbounded else None)
        tail_rows = 0
        if raw > cache.raw_count:
            # records appended since the cache was written: scan just
            # them — bounded at the snapshot count so rows appended
            # mid-scan stay in the tail for the next fold
            tail, tail_times = self._scan_sharded(
                h, raw, None, None, entity_type, target_entity_type,
                [name], {}, value_prop, 1.0,
                min_entry_idx=cache.raw_count)
            if len(tail):
                if len(cache) and tail_times[0] < cache.times[-1]:
                    return None  # out-of-order tail: merge would reorder
                utab, uremap = traincache.merge_tables(
                    cache.user_tab, tail.user_ids)
                itab, iremap = traincache.merge_tables(
                    cache.item_tab, tail.item_ids)
                tail_u, tail_i = uremap[tail.user_idx], iremap[tail.item_idx]
                tail_rows = len(tail)
                cache = dataclasses.replace(
                    cache,
                    uidx=np.concatenate([cache.uidx, tail_u]),
                    iidx=np.concatenate([cache.iidx, tail_i]),
                    vals=np.concatenate([cache.vals, tail.values]),
                    times=np.concatenate([cache.times, tail_times]),
                    user_tab=utab, item_tab=itab,
                    raw_count=raw, dead_count=dead)
                if plan is not None:
                    # O(delta) plan maintenance: pad the histograms to
                    # the merged table sizes, add the tail's counts
                    ud = np.zeros(len(utab), np.int64)
                    ud[:len(plan[0])] = plan[0]
                    id_ = np.zeros(len(itab), np.int64)
                    id_[:len(plan[1])] = plan[1]
                    ud += np.bincount(tail_u, minlength=len(utab))
                    id_ += np.bincount(tail_i, minlength=len(itab))
                    plan = (ud, id_)
                if len(tail) * 100 >= len(cache):
                    # persist the fold only when the tail is ≥1% of the
                    # cache: smaller tails re-scan in microseconds, while
                    # the rewrite is O(cache) disk traffic per train.
                    # A missing plan bootstraps HERE (one O(n) bincount)
                    # so the sidecar write happens exactly once
                    if plan is None and unbounded:
                        plan = (np.bincount(
                                    cache.uidx,
                                    minlength=len(cache.user_tab)
                                ).astype(np.int64),
                                np.bincount(
                                    cache.iidx,
                                    minlength=len(cache.item_tab)
                                ).astype(np.int64))
                    self._seed_cache_revalidated(h, cpath, cache, dead,
                                                 plan=(ppath, plan))
            # empty tail: skip the rewrite — re-checking the tail is a
            # cheap header walk, rewriting the cache is not
        if stats is not None and unbounded:
            stats["scan_source"] = "cache"
            stats["scan_tail_rows"] = int(tail_rows)
            stats["scan_rows"] = int(len(cache))
            if plan is None:
                # bootstrap: one O(n) bincount now buys O(delta) forever
                plan = (np.bincount(cache.uidx,
                                    minlength=len(cache.user_tab)
                                    ).astype(np.int64),
                        np.bincount(cache.iidx,
                                    minlength=len(cache.item_tab)
                                    ).astype(np.int64))
                if tail_rows == 0:
                    # only key the sidecar to a snapshot that is actually
                    # on disk — an unpersisted fold's key would never
                    # match the next scan's cache load (the persisted
                    # fold saved its plan above)
                    try:
                        traincache.save_plan(ppath, cache.spec,
                                             cache.raw_count,
                                             cache.dead_count, *plan)
                    except OSError:
                        logger.exception(
                            "prep-plan bootstrap write failed")
            stats["plan_user_degrees"] = plan[0]
            stats["plan_item_degrees"] = plan[1]
            self._export_retrain_delta(tail_rows)
        if start_time is None and until_time is None:
            return base.Interactions(
                user_idx=cache.uidx, item_idx=cache.iidx, values=cache.vals,
                user_ids=cache.user_tab, item_ids=cache.item_tab)
        lo = _I64_MIN if start_time is None else to_millis(start_time)
        hi = _I64_MAX if until_time is None else to_millis(until_time)
        keep = (cache.times >= lo) & (cache.times < hi)
        uidx, utab = traincache.first_seen_reindex(
            cache.uidx[keep], cache.user_tab)
        iidx, itab = traincache.first_seen_reindex(
            cache.iidx[keep], cache.item_tab)
        return base.Interactions(
            user_idx=uidx, item_idx=iidx, values=cache.vals[keep],
            user_ids=utab, item_ids=itab)

    def _scan_ids(self, res: int, which: int) -> base.IdTable:
        """Copy the C++ id table out as an arrow-style IdTable — offsets +
        byte blob flow through as numpy/bytes, no per-id Python strings
        until serving translation (eventlog.cc pio_scan_copy_ids)."""
        import numpy as np

        lib = self.client.lib
        n = lib.pio_scan_n_ids(res, which)
        nbytes = int(lib.pio_scan_ids_bytes(res, which))
        buf = ctypes.create_string_buffer(max(nbytes, 1))
        offs = np.empty(n + 1, np.int64)
        lib.pio_scan_copy_ids(
            res, which, buf,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return base.IdTable(buf.raw[:nbytes], offs)

    def insert_interactions(
        self,
        inter: base.Interactions,
        app_id: int,
        channel_id: Optional[int] = None,
        entity_type: str = "user",
        target_entity_type: str = "item",
        event_name: str = "rate",
        value_prop: str = "rating",
        times: Optional[Any] = None,
    ) -> list:
        """Columnar insert that RETURNS the stored event ids — the REST
        batch route's doc-level fast path (no per-event Python objects
        anywhere between the wire and the log). Ids come from the shared
        seed formula (:meth:`_derive_event_ids`).

        Group-committed: concurrent callers enqueue their prepped batch,
        and whichever thread holds the client lock drains the queue and
        appends every compatible pending batch as one native call (ids
        sliced per caller from one seed run). Within a caller's batch,
        log order is preserved; across concurrent callers, order was
        never defined (they race on the wire too)."""
        n = len(inter)
        if n == 0:
            return []
        prep = self._prep_columnar(inter, times)
        key = (app_id, channel_id, entity_type, target_entity_type,
               event_name, value_prop)
        item = _PendingInsert(key, n, *prep)
        with self._gc_mu:
            self._gc_pending.append(item)
        if not item.done.is_set():
            with self.client.lock:
                with self._gc_mu:
                    batch, self._gc_pending = self._gc_pending, []
                if batch:
                    self._commit_pending_locked(batch)
        item.done.wait()
        if item.error is _RETRY_SOLO:
            # a merged append hit the sidecar limits (rc=-2, nothing
            # written): one oversized sub-batch poisons the whole merge,
            # so each caller retries alone — clean batches land, the
            # offending one raises (and the server falls back to the
            # generic per-event path, exactly the un-merged semantics)
            return self._insert_interactions_direct(key, n, *prep)
        if item.error is not None:
            raise item.error
        return item.ids

    def group_commit_stats(self) -> dict:
        """Coalescing counters for /stats.json: events-per-append is the
        amortization the group commit actually achieved."""
        with self._gc_mu:
            appends = self._gc_appends
            return {
                # counters are backend-global and never rotate — NOT the
                # per-app hourly window the surrounding stats use
                "scope": "all apps/channels, since server start",
                "appends": appends,
                "callerBatches": self._gc_caller_batches,
                "events": self._gc_events,
                "maxMergedEvents": self._gc_max_merge,
                "meanEventsPerAppend": (
                    round(self._gc_events / appends, 1) if appends else 0.0),
            }

    def _insert_interactions_direct(self, key, n, times_arr, uidx, iidx,
                                    vals, utab, itab) -> list:
        """Single un-grouped columnar insert (the group-commit retry
        leg). Same observable behavior as a lone insert_interactions."""
        import secrets

        seed = int.from_bytes(secrets.token_bytes(8), "little")
        with self.client.lock:
            rc, ids = self._append_columnar_any(
                key, n, times_arr, uidx, iidx, vals, utab, itab, seed)
        if rc == -2:
            raise base.StorageError(
                "batch exceeds the native sidecar limits (id/field too "
                "long or non-finite value)")
        if rc != n:
            raise base.StorageError("columnar interaction import failed")
        return ids

    def _commit_pending_locked(self, batch: list) -> None:
        """Leader leg of the group commit: append every drained batch,
        merging batches that share the scalar field tuple. Caller holds
        the client lock. Every item's ``done`` event is set on every
        path — a stranded waiter would hang a server thread forever."""
        import secrets

        groups: dict = {}
        for it in batch:
            groups.setdefault(it.key, []).append(it)
        for key, items in groups.items():
            try:
                if len(items) == 1:
                    it = items[0]
                    n, merged = it.n, (it.times, it.uidx, it.iidx,
                                       it.vals, it.utab, it.itab)
                else:
                    n, merged = self._merge_pending(items)
                seed = int.from_bytes(secrets.token_bytes(8), "little")
                rc, ids = self._append_columnar_any(key, n, *merged,
                                                    seed=seed)
                if rc == n:
                    with self._gc_mu:
                        self._gc_appends += 1
                        self._gc_caller_batches += len(items)
                        self._gc_events += n
                        self._gc_max_merge = max(self._gc_max_merge, n)
                    off = 0
                    for it in items:
                        it.ids = ids[off:off + it.n]
                        off += it.n
                elif rc == -2:
                    if len(items) == 1:
                        items[0].error = base.StorageError(
                            "batch exceeds the native sidecar limits "
                            "(id/field too long or non-finite value)")
                    else:
                        for it in items:
                            it.error = _RETRY_SOLO
                else:
                    err = base.StorageError(
                        "columnar interaction import failed")
                    for it in items:
                        it.error = err
            except Exception as e:  # noqa: BLE001 — must reach waiters
                for it in items:
                    if it.ids is None and it.error is None:
                        it.error = e
            finally:
                for it in items:
                    it.done.set()

    @staticmethod
    def _merge_pending(items: list):
        """Concatenate pending batches into one columnar append: id
        tables are concatenated (duplicates across sub-batches are fine —
        the table is a lookup blob, not a unique index) and each
        sub-batch's dense indices are shifted by the entries before it."""
        import numpy as np

        from incubator_predictionio_tpu_torch.utils.times import now_utc

        times_parts, uidx_parts, iidx_parts, vals_parts = [], [], [], []
        ublobs, iblobs = [], []
        uoffs_parts = [np.zeros(1, np.int64)]
        ioffs_parts = [np.zeros(1, np.int64)]
        u_entries = u_bytes = i_entries = i_bytes = 0
        # one shared 'now' + a running offset for implicit-time sub-batches:
        # per-sub-batch now() stamps can repeat within a millisecond, and a
        # backward jump at a merge seam would dirty the native sorted index
        # and defeat incremental projection maintenance — under exactly the
        # concurrent load group commit exists for
        now_ms = None
        impl_off = 0
        for it in items:
            t = it.times
            if t is None:
                if now_ms is None:
                    now_ms = to_millis(now_utc())
                t = now_ms + impl_off + np.arange(it.n, dtype=np.int64)
                impl_off += it.n
            times_parts.append(t)
            uidx_parts.append(it.uidx + np.int32(u_entries))
            iidx_parts.append(it.iidx + np.int32(i_entries))
            vals_parts.append(it.vals)
            uoffs_parts.append(it.utab.offsets[1:] + u_bytes)
            ioffs_parts.append(it.itab.offsets[1:] + i_bytes)
            ublobs.append(it.utab.blob)
            iblobs.append(it.itab.blob)
            u_entries += len(it.utab)
            u_bytes += len(it.utab.blob)
            i_entries += len(it.itab)
            i_bytes += len(it.itab.blob)
        n = sum(it.n for it in items)
        return n, (
            np.concatenate(times_parts),
            np.concatenate(uidx_parts),
            np.concatenate(iidx_parts),
            np.concatenate(vals_parts),
            base.IdTable(b"".join(ublobs), np.concatenate(uoffs_parts)),
            base.IdTable(b"".join(iblobs), np.concatenate(ioffs_parts)),
        )

    def _prep_columnar(self, inter: base.Interactions, times,
                       base_time: Optional[datetime] = None):
        """Validate + coerce one columnar batch to the native append's
        array layout. ``times_arr`` stays None when neither explicit
        times nor a base_time were given — the commit leg stamps 'now'
        then, so a batch queued behind a slow group commit is stamped at
        write time, not enqueue time."""
        import numpy as np

        n = len(inter)
        if times is None:
            if base_time is None:
                times_arr = None
            else:
                times_arr = to_millis(base_time) + np.arange(n,
                                                             dtype=np.int64)
        else:
            times_arr = np.ascontiguousarray(times, np.int64)
            if times_arr.shape != (n,):
                raise ValueError(
                    f"times must have shape ({n},), got {times_arr.shape}")
        uidx = np.ascontiguousarray(inter.user_idx, np.int32)
        iidx = np.ascontiguousarray(inter.item_idx, np.int32)
        vals = np.ascontiguousarray(inter.values, np.float32)
        if iidx.shape != (n,) or vals.shape != (n,):
            raise ValueError(
                "user_idx/item_idx/values must all have shape "
                f"({n},), got {iidx.shape} / {vals.shape}")
        utab = (inter.user_ids if isinstance(inter.user_ids, base.IdTable)
                else base.IdTable.from_list(inter.user_ids))
        itab = (inter.item_ids if isinstance(inter.item_ids, base.IdTable)
                else base.IdTable.from_list(inter.item_ids))
        return times_arr, uidx, iidx, vals, utab, itab

    def _append_columnar_locked(self, key, n, times_arr, uidx, iidx, vals,
                                utab, itab, seed: int) -> int:
        """One native columnar append + training-projection maintenance.
        Caller holds the client lock. Returns the native rc (n on
        success, -2 when the sidecar limits reject the batch — nothing
        written in that case; eventlog.cc append_interactions is
        all-or-nothing)."""
        import numpy as np

        from incubator_predictionio_tpu_torch.utils.times import now_utc

        (app_id, channel_id, entity_type, target_entity_type,
         event_name, value_prop) = key
        if times_arr is None:
            times_arr = to_millis(now_utc()) + np.arange(n, dtype=np.int64)
        uoffs = np.ascontiguousarray(utab.offsets, np.int64)
        ioffs = np.ascontiguousarray(itab.offsets, np.int64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        h = self._handle(app_id, channel_id)
        raw_before = self.client.lib.pio_evlog_entry_count(h)
        dead_before = self.client.lib.pio_evlog_dead_count(h)
        rc = self.client.lib.pio_evlog_append_interactions(
            h, n,
            times_arr.ctypes.data_as(i64p),
            uidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            iidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            utab.blob, uoffs.ctypes.data_as(i64p), len(utab),
            itab.blob, ioffs.ctypes.data_as(i64p), len(itab),
            entity_type.encode("utf-8"),
            target_entity_type.encode("utf-8"),
            event_name.encode("utf-8"),
            value_prop.encode("utf-8"),
            # the seed makes the generated event ids (and so the log
            # bytes) reproducible — for deterministic re-imports and
            # the thread-count byte-identity test
            seed,
        )
        if rc == n:
            path = self.client._file(self.ns, app_id, channel_id)
            self.client.note_count_locked(path, raw_before)
            self.client.note_count_locked(path, raw_before + n)
            try:
                self._maintain_cache_after_import(
                    h, app_id, channel_id, raw_before, dead_before,
                    uidx, iidx, vals, times_arr, utab, itab,
                    entity_type, target_entity_type, event_name,
                    value_prop)
            except Exception:
                # the append already succeeded durably; the projection
                # is an optimization the next scan rebuilds — raising
                # here would make callers believe nothing was written
                # (and retry-writers would then DUPLICATE the batch)
                logger.exception(
                    "training-projection maintenance failed after a "
                    "successful import (next scan rebuilds it)")
        return rc

    @staticmethod
    def _columnar_rejected(key, n, uidx, iidx, vals, utab, itab) -> bool:
        """True when the native columnar append would return -2 —
        mirrors the exact reject conditions of eventlog.cc
        pio_evlog_append_interactions (scalar field lengths, id
        lengths, finite values, index ranges), evaluated BEFORE any
        write so a sharded fan-out stays all-or-nothing across shards
        (a single-file append is natively all-or-nothing; N per-shard
        appends are not, unless nothing can reject mid-flight)."""
        import numpy as np

        (_a, _c, etype, tetype, name, vprop) = key
        if (len(etype.encode("utf-8")) >= 0xFFFF
                or len(tetype.encode("utf-8")) >= 0xFFFF
                or len(name.encode("utf-8")) >= 0xFFFF
                or len(vprop.encode("utf-8")) > 255):
            return True
        for tab in (utab, itab):
            if len(tab) and int(np.diff(tab.offsets).max()) >= 0xFFFF:
                return True
        if n and not np.isfinite(vals).all():
            return True
        if n and (int(uidx.min()) < 0 or int(uidx.max()) >= len(utab)
                  or int(iidx.min()) < 0 or int(iidx.max()) >= len(itab)):
            return True
        return False

    def _append_columnar_any(self, key, n, times_arr, uidx, iidx, vals,
                             utab, itab, seed: int):
        """Columnar append dispatch → (rc, ids | None). Caller holds
        the client lock. The plain layout takes the original
        single-writer path (ids from the shared seed formula); sharded
        layouts spray rows by user-id hash and append to every target
        shard concurrently."""
        app_id, channel_id = key[0], key[1]
        if self._is_plain(app_id, channel_id):
            rc = self._append_columnar_locked(
                key, n, times_arr, uidx, iidx, vals, utab, itab, seed)
            return rc, (self._derive_event_ids(seed, n) if rc == n
                        else None)
        return self._append_columnar_sharded(
            key, n, times_arr, uidx, iidx, vals, utab, itab, seed)

    def _append_columnar_sharded(self, key, n, times_arr, uidx, iidx,
                                 vals, utab, itab, seed: int):
        """Spray one columnar batch across the writer shards and append
        to each target shard CONCURRENTLY — ctypes releases the GIL, so
        the per-shard native appends (hashing + record rendering + the
        buffered write, all in C++) really overlap; this fan-out is the
        multi-writer throughput win the bench measures. Returns
        (rc, ids) with ids in CALLER order (derived per shard from a
        shard-mixed seed). Caller holds the client lock; workers touch
        only pre-resolved handles and per-shard locks (lock order:
        client lock → shard lock, same as replication_apply).

        All-or-nothing: the -2 screen runs up front (mirroring the
        native conditions), so per-shard appends cannot reject
        mid-fan-out; a residual IO failure raises StorageError loudly
        rather than reporting a partial write."""
        from concurrent.futures import ThreadPoolExecutor

        import numpy as np

        from incubator_predictionio_tpu_torch.utils.times import now_utc

        app_id, channel_id = key[0], key[1]
        (_a, _c, etype, tetype, name, vprop) = key
        if self._columnar_rejected(key, n, uidx, iidx, vals, utab, itab):
            return -2, None
        if times_arr is None:
            times_arr = to_millis(now_utc()) + np.arange(n,
                                                         dtype=np.int64)
        nsh = self._nshards(app_id, channel_id)
        row_shard = self._spray(uidx, utab, nsh)
        golden = 0x9E3779B97F4A7C15
        plan = []
        for k in range(nsh):
            rows = np.nonzero(row_shard == k)[0]
            if not len(rows):
                continue
            path = self._hot_path(app_id, channel_id, k)
            seed_k = (seed ^ (golden * (k + 1))) & 0xFFFFFFFFFFFFFFFF
            # handles, locks, and counts resolve HERE, under the client
            # lock — the workers must never take it (they'd deadlock
            # against this thread waiting on their results)
            plan.append((k, rows, path,
                         self.client.handle_path(path),
                         self.client.shard_lock(path), seed_k,
                         (np.ascontiguousarray(times_arr[rows]),
                          np.ascontiguousarray(uidx[rows]),
                          np.ascontiguousarray(iidx[rows]),
                          np.ascontiguousarray(vals[rows]))))
        uoffs = np.ascontiguousarray(utab.offsets, np.int64)
        ioffs = np.ascontiguousarray(itab.offsets, np.int64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        etype_b = etype.encode("utf-8")
        tetype_b = tetype.encode("utf-8")
        name_b = name.encode("utf-8")
        vprop_b = vprop.encode("utf-8")
        lib = self.client.lib

        def commit(entry):
            _k, rows, _path, h, lk, seed_k, arrs = entry
            t_arr, s_uidx, s_iidx, s_vals = arrs
            with lk:
                return lib.pio_evlog_append_interactions(
                    h, len(rows), t_arr.ctypes.data_as(i64p),
                    s_uidx.ctypes.data_as(i32p),
                    s_iidx.ctypes.data_as(i32p),
                    s_vals.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_float)),
                    utab.blob, uoffs.ctypes.data_as(i64p), len(utab),
                    itab.blob, ioffs.ctypes.data_as(i64p), len(itab),
                    etype_b, tetype_b, name_b, vprop_b, seed_k)

        import os as _os

        if len(plan) == 1 or (_os.cpu_count() or 1) == 1:
            # one target shard — or one core, where fan-out threads can
            # only add scheduling overhead to CPU-bound native renders
            rcs = [commit(entry) for entry in plan]
        else:
            with self.client.lock:  # reentrant: the append path holds it
                pool = self._fanout_pool
                if pool is None or pool._max_workers < len(plan):
                    if pool is not None:
                        pool.shutdown(wait=False)
                    pool = self._fanout_pool = ThreadPoolExecutor(
                        max_workers=max(len(plan), 4),
                        thread_name_prefix="cpplog-fanout")
            rcs = list(pool.map(commit, plan))
        failed = [entry[0] for entry, rc in zip(plan, rcs)
                  if rc != len(entry[1])]
        if failed:
            raise base.StorageError(
                f"sharded columnar append failed on shard(s) {failed} "
                "(pre-screened batch: IO error, not a reject)")
        ids_arr = np.empty(n, dtype=object)
        for (k, rows, path, h, _lk, seed_k, _arrs), rc in zip(plan, rcs):
            end = int(lib.pio_evlog_entry_count(h))
            self.client.note_count_locked(path, end - len(rows))
            self.client.note_count_locked(path, end)
            ids_arr[rows] = self._derive_event_ids(seed_k, len(rows))
        self._book_shard_events(plan)
        self.maybe_roll(app_id, channel_id)
        return n, ids_arr.tolist()

    def _book_shard_events(self, plan) -> None:
        """Per-shard ingest accounting for /metrics
        (pio_ingest_shard_events{shard}): operators watch the spread
        for writer-shard skew (observability.md runbook)."""
        with self._gc_mu:
            for k, rows, *_rest in plan:
                self._shard_events[k] = (
                    self._shard_events.get(k, 0) + len(rows))

    def import_interactions(
        self,
        inter: base.Interactions,
        app_id: int,
        channel_id: Optional[int] = None,
        entity_type: str = "user",
        target_entity_type: str = "item",
        event_name: str = "rate",
        value_prop: str = "rating",
        times: Optional[Any] = None,
        base_time: Optional[datetime] = None,
        chunk: int = 20_000,
        id_seed: Optional[int] = None,
    ) -> int:
        """Fully-native columnar bulk import (pio_evlog_append_interactions):
        record rendering (JSON + sidecar + framed headers), hashing, and the
        single buffered write all happen in C++ — no per-event Python
        objects. Falls back to the generic per-Event path when a field
        exceeds the sidecar limits (rc=-2)."""
        import secrets

        n = len(inter)
        if n == 0:
            return 0
        times_arr, uidx, iidx, vals, utab, itab = self._prep_columnar(
            inter, times, base_time)
        key = (app_id, channel_id, entity_type, target_entity_type,
               event_name, value_prop)
        seed = (int.from_bytes(secrets.token_bytes(8), "little")
                if id_seed is None else (id_seed & 0xFFFFFFFFFFFFFFFF))
        with self.client.lock:
            rc, _ids = self._append_columnar_any(
                key, n, times_arr, uidx, iidx, vals, utab, itab, seed)
        if rc == -2:  # sidecar limits exceeded: generic per-Event path
            if id_seed is not None:
                # the generic path generates random event ids — honoring
                # the caller's byte-reproducibility request is impossible,
                # so fail loudly instead of silently losing determinism
                raise base.StorageError(
                    "id_seed requested but the data exceeds the native "
                    "sidecar limits (id/field too long or non-finite "
                    "value); the per-Event fallback cannot produce "
                    "deterministic ids")
            return super().import_interactions(
                inter, app_id, channel_id, entity_type, target_entity_type,
                event_name, value_prop, times, base_time, chunk)
        if rc != n:
            raise base.StorageError("columnar interaction import failed")
        return n

    def _maintain_cache_after_import(self, h, app_id, channel_id,
                                     raw_before, dead_before, uidx, iidx,
                                     vals, times_arr, utab, itab,
                                     entity_type, target_entity_type,
                                     event_name, value_prop) -> None:
        """Create or extend the training projection from the batch's own
        columnar arrays — the import has them in hand, so maintaining the
        projection here is nearly free vs. rebuilding it from a full scan
        (traincache.py rationale). Covered cases: a fresh log at training
        scale (create), or an up-to-date cache with an in-order batch
        (append). Anything else leaves the batch in the log tail, which the
        next scan folds. Caller holds the client lock; the native append
        has already succeeded (raw count is now raw_before + n)."""
        import dataclasses

        import numpy as np

        from incubator_predictionio_tpu_torch.data.storage import traincache

        n = len(uidx)
        if value_prop is None:
            return
        monotone = n < 2 or not np.any(np.diff(times_arr) < 0)
        if not monotone:
            return
        cpath = traincache.path_for(
            self.client._file(self.ns, app_id, channel_id))
        spec = traincache.Spec(entity_type, target_entity_type, event_name,
                               value_prop)
        # re-intern in first-seen order: the batch's tables may hold
        # unreferenced or differently-ordered ids, and the cache must be
        # indistinguishable from a fresh native scan (the cross-backend
        # first-seen contract, tests/test_storage_conformance.py)
        if raw_before == 0 and n >= traincache.MIN_NNZ:
            new_u, new_utab = traincache.first_seen_reindex(uidx, utab)
            new_i, new_itab = traincache.first_seen_reindex(iidx, itab)
            traincache.write(cpath, traincache.TrainCache(
                spec=spec, uidx=new_u, iidx=new_i,
                vals=np.asarray(vals, np.float32),
                times=np.asarray(times_arr, np.int64),
                user_tab=new_utab, item_tab=new_itab,
                raw_count=raw_before + n, dead_count=dead_before))
            return
        cache = traincache.load(cpath)
        if cache is None or cache.spec != spec:
            return
        if cache.raw_count != raw_before or cache.dead_count != dead_before:
            return  # gap or deletes: the next scan's fold handles it
        if n * 20 < len(cache):
            # appending rewrites the whole projection file: a batch below
            # 5% of the cache isn't worth O(cache) disk traffic per
            # import — it stays in the log tail, which scans fold cheaply
            return
        if len(cache) and n and times_arr[0] < cache.times[-1]:
            return  # out-of-order batch: appending would break time order
        new_u, new_utab = traincache.first_seen_reindex(uidx, utab)
        new_i, new_itab = traincache.first_seen_reindex(iidx, itab)
        m_utab, uremap = traincache.merge_tables(cache.user_tab, new_utab)
        m_itab, iremap = traincache.merge_tables(cache.item_tab, new_itab)
        traincache.write(cpath, dataclasses.replace(
            cache,
            uidx=np.concatenate([cache.uidx, uremap[new_u]]),
            iidx=np.concatenate([cache.iidx, iremap[new_i]]),
            vals=np.concatenate([cache.vals, np.asarray(vals, np.float32)]),
            times=np.concatenate([cache.times,
                                  np.asarray(times_arr, np.int64)]),
            user_tab=m_utab, item_tab=m_itab,
            raw_count=raw_before + n, dead_count=dead_before))

    def compact(self, app_id: int,
                channel_id: Optional[int] = None) -> dict:
        """Rewrite the log in the CURRENT on-disk format, keeping only
        live records — the store-migration verb behind ``pio upgrade``
        (the reference migrates HBase schemas via its upgrade tool,
        data/.../storage/hbase/upgrade/Upgrade.scala; here the format
        deltas that have accrued are tombstoned records occupying space
        and pre-sidecar bare-JSON records that every scan must
        JSON-parse).

        Fully native (pio_evlog_compact_copy): live records that already
        carry a sidecar — including compact bulk-imported records —
        byte-copy unchanged, bare-JSON records gain a sidecar built in
        C++ from the span parser, and the copy lands in a temp file that
        atomically replaces the original. No Python Event objects exist
        on this path, ids/times/bytes are preserved exactly, and log
        (append) order survives — the equal-time tie-break contract. The
        training projection is invalidated (entry numbering changes).

        Sharded/tiered layouts compact PER SEGMENT — each cold tier and
        each hot segment rewrites independently (small files, bounded
        pause), with one generation bump per shard so pinned readers
        and speed-overlay cursors resync exactly as on the plain
        layout. Returns ``{"events", "bytes_before", "bytes_after"}``
        aggregated over every segment."""
        import os

        from incubator_predictionio_tpu_torch.data.storage import traincache

        events = bytes_before = bytes_after = 0
        with self.client.lock:
            by_shard: dict[int, list] = {}
            for k, path, _hot in self._unit_paths(app_id, channel_id):
                by_shard.setdefault(k, []).append(path)
            for k, paths in by_shard.items():
                hot = self._hot_path(app_id, channel_id, k)
                for path in paths:
                    # compaction renumbers entries and swaps the handle:
                    # wait out any lock-narrowed scan still reading it
                    self.client._wait_unpinned_locked(str(path))
                    h = self.client.handle_path(path)
                    bytes_before += (path.stat().st_size
                                     if path.exists() else 0)
                    tmp_path = path.with_name(path.name + ".compact")
                    live = self.client.lib.pio_evlog_compact_copy(
                        h, str(tmp_path).encode("utf-8"))
                    if live < 0:
                        tmp_path.unlink(missing_ok=True)
                        raise base.StorageError(
                            f"compaction failed for {path.name}")
                    self.client.close_path_locked(path)
                    os.replace(tmp_path, path)
                    events += int(live)
                    bytes_after += (path.stat().st_size
                                    if path.exists() else 0)
                traincache.invalidate(hot)
                # entry numbering may have changed (tombstones
                # dropped): tail cursors minted before this compaction
                # are now invalid, and replication followers must
                # resync the rewritten segment bytes
                self.client.bump_generation_locked(hot)
                self.client.bump_epoch_locked(hot)
        return {"events": events, "bytes_before": bytes_before,
                "bytes_after": bytes_after}

    def maybe_roll(self, app_id: int, channel_id: Optional[int] = None,
                   limit_bytes: Optional[int] = None) -> int:
        """Segment tiering: seal every hot segment that outgrew the
        limit by folding its LIVE records onto the shard's cold tier
        (via the native compact copy, which also resolves hot-internal
        tombstones — a raw byte concat would carry tombstone target
        indices local to the old hot file) and truncating the hot file
        to empty. The hot segment stays small, so appends and tail
        polls touch a small file and compaction rewrites bounded
        segments instead of one monolith. The cold file is the
        concatenation of sealed hots in seal order, so the shard's
        merged (cold-then-hot) stream keeps its order; the roll still
        BUMPS the shard's generation and rewrite epoch — entry
        numbering changed, cursors resync exactly as on compaction and
        followers resync the shard.

        ``limit_bytes``: explicit threshold; default reads
        ``PIO_LOG_HOT_BYTES`` per call (unset/0 = tiering off — the
        opportunistic call on every sharded append is then a single
        getenv). Returns the number of shards rolled."""
        import os

        from incubator_predictionio_tpu_torch.data.storage import traincache

        if limit_bytes is None:
            try:
                limit_bytes = int(
                    os.environ.get("PIO_LOG_HOT_BYTES", "0"))
            except ValueError:
                limit_bytes = 0
        if limit_bytes <= 0:
            return 0
        rolled = 0
        with self.client.lock:
            for k in range(self._nshards(app_id, channel_id)):
                hot = self._hot_path(app_id, channel_id, k)
                try:
                    if (not hot.exists()
                            or hot.stat().st_size < limit_bytes):
                        continue
                except OSError:
                    continue
                cold = self.client._cold(hot)
                if (self.client._pins.get(str(hot), 0)
                        or self.client._pins.get(str(cold), 0)):
                    # a lock-narrowed scan is reading this shard: the
                    # roll is opportunistic (appends call it inline),
                    # so SKIP rather than stall the append path behind
                    # a training scan — the next append retries
                    continue
                h = self.client.handle_path(hot)
                tmp = hot.with_name(hot.name + ".roll")
                live = self.client.lib.pio_evlog_compact_copy(
                    h, str(tmp).encode("utf-8"))
                if live < 0:
                    tmp.unlink(missing_ok=True)
                    raise base.StorageError(
                        f"segment roll failed for {hot.name}")
                self.client.close_path_locked(hot)
                self.client.close_path_locked(cold)
                with open(cold, "ab") as dst, open(tmp, "rb") as src:
                    import shutil

                    shutil.copyfileobj(src, dst)
                    dst.flush()
                    os.fsync(dst.fileno())
                tmp.unlink(missing_ok=True)
                with open(hot, "r+b") as f:
                    f.truncate(0)
                self.client._has_cold[str(hot)] = True
                traincache.invalidate(hot)
                self.client.bump_generation_locked(hot)
                self.client.bump_epoch_locked(hot)
                rolled += 1
        return rolled

    # -- async replication (leader side + follower apply) -----------------
    def replication_status(self, app_id: int,
                           channel_id: Optional[int] = None) -> dict:
        """Leader-side layout snapshot for a follower's tail loop:
        per-shard generation, rewrite epoch, and per-tier entry counts.
        The epoch is the follower's resync signal — it moves only when
        segment bytes were REWRITTEN (roll/compact/drop/restart), never
        on append-only growth, so deletes replicate as plain frames."""
        with self.client.lock:
            snap = self._snapshot_shards_locked(app_id, channel_id)
            out = []
            for k, hot, gen, segs, total in snap:
                cold_cnt = hot_cnt = 0
                for path, _h, cnt in segs:
                    if str(path) == str(hot):
                        hot_cnt = cnt
                    else:
                        cold_cnt = cnt
                out.append({
                    "shard": k, "gen": gen,
                    "epoch": self.client.epoch_locked(hot),
                    "cold": cold_cnt, "hot": hot_cnt, "total": total,
                })
            return {"shards": len(snap), "status": out}

    def replication_read(self, app_id: int,
                         channel_id: Optional[int] = None,
                         shard: int = 0, tier: str = "hot",
                         from_entry: int = 0, epoch: int = 0,
                         max_bytes: int = 4 << 20) -> dict:
        """Read whole record frames from one segment file for byte-level
        log shipping: the follower's copy stays bit-identical to the
        leader's prefix, so tombstone target indices, sidecars, and
        hashes all carry over. Raises when the segment's rewrite epoch
        moved past the follower's view (stale frames must not land)."""
        with self.client.lock:
            hot = self._hot_path(app_id, channel_id, shard)
            if int(epoch) != self.client.epoch_locked(hot):
                raise base.StorageError(
                    f"replication epoch moved for shard {shard} "
                    "(segment rewritten); resync required")
            path = hot if tier == "hot" else self.client._cold(hot)
            h = self.client.handle_path(path)
            lib = self.client.lib
            cap = max(int(max_bytes), 1 << 16)
            n_out = ctypes.c_int64(0)
            for _attempt in range(2):
                buf = ctypes.create_string_buffer(cap)
                got = lib.pio_evlog_read_frames(
                    h, int(from_entry), cap, buf,
                    ctypes.byref(n_out))
                if got >= 0:
                    return {"epoch": int(epoch),
                            "from_entry": int(from_entry),
                            "n_entries": int(n_out.value),
                            "frames": buf.raw[:got]}
                if got == -1:
                    raise base.StorageError(
                        f"replication read failed for {path.name} at "
                        f"entry {from_entry}")
                cap = -got  # one frame alone exceeds the budget
            raise base.StorageError(
                f"replication frame exceeds retry budget on {path.name}")

    def replication_apply(self, app_id: int,
                          channel_id: Optional[int] = None,
                          shard: int = 0, tier: str = "hot",
                          from_entry: int = 0,
                          frames: bytes = b"") -> int:
        """Follower-side apply: append shipped frames to the local
        segment at exactly ``from_entry``. Idempotent on replay (local
        count already past from_entry → no-op), loud on gaps. Returns
        the local entry count after the apply."""
        with self.client.lock:
            hot = self._hot_path(app_id, channel_id, shard)
            path = hot if tier == "hot" else self.client._cold(hot)
            lk = self.client.shard_lock(path)
            h = self.client.handle_path(path)
            lib = self.client.lib
            with lk:
                local = int(lib.pio_evlog_entry_count(h))
                if local > int(from_entry):
                    return local  # replayed frames: already applied
                if local < int(from_entry):
                    raise base.StorageError(
                        f"replication gap on shard {shard} ({tier}): "
                        f"local count {local} < leader from_entry "
                        f"{from_entry}")
                if not frames:
                    return local
                new_count = lib.pio_evlog_append_frames(
                    h, frames, len(frames))
                if new_count < 0:
                    raise base.StorageError(
                        f"replication apply failed on {path.name}")
            if tier == "cold":
                self.client._has_cold[str(hot)] = True
            else:
                self.client.note_count_locked(hot, int(new_count))
            return int(new_count)

    def replication_configure(self, app_id: int,
                              channel_id: Optional[int] = None,
                              shards: int = 1) -> int:
        """Mirror the leader's writer-shard layout on a follower before
        the first apply."""
        self.client.set_shards(self.ns, app_id, channel_id, int(shards))
        return self._nshards(app_id, channel_id)

    def replication_reset(self, app_id: int,
                          channel_id: Optional[int] = None,
                          shard: int = 0) -> bool:
        """Drop one local shard's segment files (follower resync after
        a leader rewrite-epoch change): cursors minted from this
        follower bump exactly as on a local compaction."""
        from incubator_predictionio_tpu_torch.data.storage import traincache

        with self.client.lock:
            hot = self._hot_path(app_id, channel_id, shard)
            for path in (self.client._cold(hot), hot):
                key = str(path)
                self.client._wait_unpinned_locked(key)
                self.client.close_path_locked(path)
                path.unlink(missing_ok=True)
            self.client._has_cold.pop(str(hot), None)
            traincache.invalidate(hot)
            self.client.bump_generation_locked(hot)
        return True

    @staticmethod
    def _filter_parsed(payloads, entity_type, entity_id, names,
                       target_entity_type, target_entity_id,
                       want: int) -> list[Event]:
        results: list[Event] = []
        for payload in payloads:
            if payload is None:
                continue
            ev = Event.from_jsonable(json.loads(payload.decode("utf-8")))
            # exact re-checks: hashes prune, Python decides
            if entity_type is not None and ev.entity_type != entity_type:
                continue
            if entity_id is not None and ev.entity_id != entity_id:
                continue
            if names is not None and ev.event not in names:
                continue
            if target_entity_type is not UNSET and \
                    ev.target_entity_type != target_entity_type:
                continue
            if target_entity_id is not UNSET and \
                    ev.target_entity_id != target_entity_id:
                continue
            results.append(ev)
            if want >= 0 and len(results) >= want:
                break  # stop reading/parsing as soon as the limit is met
        return results


DATA_OBJECTS = {"Events": CppLogEvents}
