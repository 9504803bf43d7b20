"""Flight recorder — bounded metric history + automatic incident capture.

The port's own copy of incubator_predictionio_tpu/obs/recorder.py, its
imports pointed at this package. A bundle's ``decisions`` and ``knobs``
blocks are the freshness and knob controllers' rings (obs/controller.py,
obs/knobs.py), peeked without creating a controller, or the admin
server's hosted controllers' rings (servers/admin.py ``_wire_capture``).

A ``/metrics`` scrape is a point-in-time truth: when a fleet SLO
breaches, nothing on any server can answer "what did p99, queue depth
and shed rate look like in the 60 s *before* the breach, and which
queries were the p99". The controller's decision ring (obs/controller)
proved the shape that fixes this — bounded in-memory history plus trace
linkage — and this module generalizes it to the whole observability
plane:

- :class:`FlightRecorder` — an always-on background sampler snapshots
  every registry metric at ``PIO_RECORDER_HZ`` (default 1 Hz) into a
  fixed-size **delta-encoded ring** covering ``PIO_RECORDER_WINDOW_S``
  (default 600 s). A tick costs one ``Registry.run_collectors()`` plus
  a lock-free ring append (single-writer slot store under the GIL;
  readers validate the per-entry sample index instead of taking a lock
  the serving path could ever contend on). ``GET /recorder`` on every
  server serves the reconstructed window as JSON.

- **Incident capture** — :class:`IncidentCapture` hooks the SLO
  burn-rate engine's fast-burn crossing (the same signal the freshness
  controller consumes — ``SLOEngine.add_breach_listener``) and
  ``POST /incident``, and freezes one self-contained JSON bundle under
  ``PIO_INCIDENT_DIR``: the fleet-merged recorder window (the admin
  pulls each worker's ``/recorder``, instance-labeled like
  ``/federate``), the breaching SLO's exemplar trace IDs (the
  histogram exemplars obs/metrics.py reservoir-samples), each worker's
  scheduler state block, and the in-window controller decisions.
  Dedup + cooldown (``PIO_INCIDENT_COOLDOWN_S``) make a sustained burn
  yield ONE bundle, not hundreds; ``GET /incidents`` lists them.

Serve-path contract (the ``recorder-in-serve-path`` pio-lint rule):
snapshot/capture entry points (``sample_now``/``dump``/``window``/
``capture_now``) run only on this module's own threads and the
admin/debug HTTP handlers — never anywhere a ``predict``/
``batch_predict``/scheduler dispatch can reach. The serving hot path's
total exposure to this module is the one histogram-exemplar reservoir
write it already pays in ``observe()``.

Exported series (docs/observability.md):

- ``pio_recorder_samples_total``
- ``pio_recorder_ring_bytes`` (rough in-memory estimate)
- ``pio_incidents_total{trigger}``
"""

from __future__ import annotations

import json
import logging
import math
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
from incubator_predictionio_tpu_torch.utils import times

logger = logging.getLogger(__name__)

#: keyframe cadence: every K-th sample stores the FULL flat snapshot so
#: any retained window start is reachable from a keyframe at most K-1
#: deltas back (the ring over-allocates by K slots to guarantee it)
KEYFRAME_EVERY = 60


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def recorder_enabled() -> bool:
    """``PIO_RECORDER`` kill switch, default on. Off means NO sampler
    thread exists and ``/recorder`` answers 503 — zero overhead, pinned
    by tests/test_recorder.py."""
    return os.environ.get("PIO_RECORDER", "1").strip().lower() not in (
        "0", "off", "false")


def recorder_hz() -> float:
    hz = _env_float("PIO_RECORDER_HZ", 1.0)
    return hz if hz > 0 else 1.0


def recorder_window_s() -> float:
    w = _env_float("PIO_RECORDER_WINDOW_S", 600.0)
    return w if w > 0 else 600.0


def incident_dir() -> Optional[str]:
    """Capture destination; unset/empty disables incident capture (the
    recorder itself stays on — history without capture is still
    diagnosis)."""
    return os.environ.get("PIO_INCIDENT_DIR", "").strip() or None


def incident_cooldown_s() -> float:
    return _env_float("PIO_INCIDENT_COOLDOWN_S", 300.0)


# ---------------------------------------------------------------------------
# state providers — subsystems publish a snapshot callable (the
# scheduler's queue/rung/shed state) that rides the recorder dump and
# every incident bundle. Named replace semantics like registry
# collectors, so re-created subsystems never accumulate dead hooks.
# ---------------------------------------------------------------------------

_state_providers: Dict[str, Callable[[], Any]] = {}
_state_lock = threading.Lock()


def register_state_provider(name: str, fn: Callable[[], Any]) -> None:
    with _state_lock:
        _state_providers[name] = fn


def unregister_state_provider(name: str) -> None:
    with _state_lock:
        _state_providers.pop(name, None)


def collect_state() -> Dict[str, Any]:
    """Every registered provider's snapshot; a failing (or garbage-
    collected) provider reports its error string instead of failing
    the dump."""
    with _state_lock:
        providers = list(_state_providers.items())
    out: Dict[str, Any] = {}
    for name, fn in providers:
        try:
            value = fn()
        except Exception as e:  # noqa: BLE001 — per-provider degradation
            out[name] = {"error": str(e)}
            continue
        if value is not None:
            out[name] = value
    return out


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------

#: flat snapshot key: (metric name, sorted label items tuple)
_SeriesKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def _quantile_from_buckets(bounds: Sequence[float],
                           counts: Sequence[float],
                           q: float) -> Optional[float]:
    """Quantile by linear interpolation over per-bucket counts (the
    registry's own rule; ``counts`` aligned with ``bounds`` + overflow).
    None when empty; overflow clamps to the last finite bound."""
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if cum + c >= rank:
            if i >= len(bounds):
                return float(bounds[-1]) if bounds else None
            lo = float(bounds[i - 1]) if i > 0 else 0.0
            hi = float(bounds[i])
            return lo + (hi - lo) * max(rank - cum, 0.0) / c
        cum += c
    return float(bounds[-1]) if bounds else None


class FlightRecorder:
    """Bounded delta-encoded metric history over one registry.

    Single-writer: only the sampler thread (or a test driving
    :meth:`sample_now`) appends. The ring is a plain slot list — the
    writer stores an immutable entry tuple and bumps the head index;
    readers validate each entry's embedded sample index against the
    position they expected, so a concurrently overwritten slot is
    detected and skipped rather than guarded by a lock the hot path
    could contend on.
    """

    def __init__(self, registry: Optional[obs_metrics.Registry] = None,
                 hz: Optional[float] = None,
                 window_s: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None,
                 wall: Optional[Callable[[], float]] = None,
                 keyframe_every: int = KEYFRAME_EVERY) -> None:
        self.registry = registry if registry is not None \
            else obs_metrics.REGISTRY
        self.hz = float(hz) if hz is not None else recorder_hz()
        self.window_s = (float(window_s) if window_s is not None
                         else recorder_window_s())
        self._clock = clock if clock is not None else times.monotonic
        self._wall = wall if wall is not None else time.time
        self._keyframe_every = max(int(keyframe_every), 1)
        #: retained samples the window needs, + keyframe slack so a
        #: reachable keyframe always precedes the oldest window sample
        self.slots = int(self.window_s * self.hz) + self._keyframe_every + 1
        #: ring entries: (idx, wall_ts, kind, data, byte_est) — kind
        #: "key" (full snapshot) or "delta" (changed series only).
        #: All four ring fields below are single-writer (the sampler
        #: loop) immutable-publishes read lock-free by window()/index();
        #: the annotations are VERIFIED by pio-lint's
        #: unguarded-shared-state pass (docs/lint.md).
        self._ring: List[Optional[tuple]] = [None] * self.slots  # pio-lint: publish-only
        self._head = 0  # pio-lint: publish-only — next sample index (monotonic)
        self._ring_bytes = 0  # pio-lint: publish-only
        self._last: Dict[_SeriesKey, Any] = {}
        #: family meta discovered at snapshot time: name → (kind, bounds)
        # pio-lint: publish-only
        self._meta: Dict[str, Tuple[str, Optional[Tuple[float, ...]]]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._samples_total = self.registry.counter(
            "pio_recorder_samples_total",
            "flight-recorder ring samples appended")
        self._ring_bytes_g = self.registry.gauge(
            "pio_recorder_ring_bytes",
            "rough in-memory size of the flight-recorder ring "
            "(delta-encoded; climbing steadily = label-cardinality "
            "audit time, see the runbook)")

    # -- snapshotting -------------------------------------------------------
    def _flat_snapshot(self) -> Dict[_SeriesKey, Any]:
        """Every registry series as a flat {(name, labels): value} map.
        Counter/gauge values are floats; histogram children are
        ``(counts tuple incl. overflow, sum, count)``."""
        out: Dict[_SeriesKey, Any] = {}
        with self.registry._lock:
            metrics_list = list(self.registry._metrics.values())
        for m in metrics_list:
            with m._lock:
                children = list(m._children.items())
            if m.kind == "histogram":
                self._meta[m.name] = (m.kind, m._buckets)
                for key, child in children:
                    counts, csum, count = child.snapshot()
                    out[(m.name, tuple(zip(m.labelnames, key)))] = (
                        tuple(counts), csum, count)
            else:
                self._meta[m.name] = (m.kind, None)
                for key, child in children:
                    out[(m.name, tuple(zip(m.labelnames, key)))] = \
                        child.value
        return out

    @staticmethod
    def _entry_bytes(data: Dict[_SeriesKey, Any]) -> int:
        """Rough per-entry footprint for pio_recorder_ring_bytes: key
        strings + 8 bytes per scalar, 8 per histogram bucket count."""
        est = 64
        for (name, labels), v in data.items():
            est += len(name) + 16 * (len(labels) + 1)
            est += 8 * (len(v[0]) + 2) if isinstance(v, tuple) else 8
        return est

    def sample_now(self) -> int:
        """Append one sample (the sampler tick; tests drive it with a
        FakeClock). Returns the sample's index."""
        self.registry.run_collectors()
        snap = self._flat_snapshot()
        idx = self._head
        keyframe = idx % self._keyframe_every == 0
        if keyframe:
            data: Dict[_SeriesKey, Any] = snap
        else:
            last = self._last
            data = {k: v for k, v in snap.items()
                    if last.get(k) != v}
        est = self._entry_bytes(data)
        entry = (idx, self._wall(), "key" if keyframe else "delta",
                 data, est)
        slot = idx % self.slots
        evicted = self._ring[slot]
        # single-writer slot store: entry tuples are immutable, the
        # head bump is a plain int assignment — readers validate the
        # embedded idx instead of locking
        self._ring[slot] = entry
        self._head = idx + 1
        self._last = snap
        self._ring_bytes += est - (evicted[4] if evicted else 0)
        self._ring_bytes_g.set(float(self._ring_bytes))
        self._samples_total.inc()
        return idx

    # -- reading ------------------------------------------------------------
    def _live_entries(self) -> List[tuple]:
        """Consistent ascending entry list: each slot's entry is kept
        only if its embedded index matches the position implied by the
        head snapshot (an entry overwritten mid-read self-identifies
        and is dropped)."""
        head = self._head
        lo = max(head - self.slots, 0)
        out: List[tuple] = []
        for idx in range(lo, head):
            e = self._ring[idx % self.slots]
            if e is not None and e[0] == idx:
                out.append(e)
        return out

    def window(self, series: Optional[Sequence[str]] = None,
               window_s: Optional[float] = None) -> Dict[str, Any]:
        """Reconstruct the trailing window → JSON-ready dict.

        ``series=None`` returns every recorded family. Histogram points
        carry per-interval quantiles (the "what did p99 look like"
        answer): each point's p50/p99 is computed over the bucket
        DELTAS since the previous sample, so the series shows the tail
        of that second's observations, not the cumulative-forever
        distribution."""
        want_s = min(window_s if window_s is not None else self.window_s,
                     self.window_s)
        n_want = int(want_s * self.hz) + 1
        entries = self._live_entries()
        out: Dict[str, Any] = {
            "hz": self.hz,
            "windowS": want_s,
            "samples": 0,
            "series": {},
        }
        if not entries:
            return out
        # the sampler overwrites the OLDEST slots while we read, so the
        # entry list can have holes at its old end — anything before a
        # gap is unreplayable (a delta chain with a missing link would
        # reconstruct silently-wrong values). Keep only the longest
        # contiguous suffix.
        suffix = len(entries) - 1
        while suffix > 0 and entries[suffix - 1][0] == \
                entries[suffix][0] - 1:
            suffix -= 1
        entries = entries[suffix:]
        head = entries[-1][0] + 1
        start_idx = max(head - n_want, 0)
        # newest KEYFRAME at/before the window start (ring slack makes
        # one exist among the retained entries in steady state); when a
        # concurrent wrap ate it, fall forward to the first retained
        # keyframe — an honestly narrower window, never a broken chain.
        # No keyframe in the suffix at all (a young or heavily-raced
        # ring) = nothing reconstructable: return empty, not wrong.
        key_pos = None
        for i, e in enumerate(entries):
            if e[2] != "key":
                continue
            if e[0] <= start_idx or key_pos is None:
                key_pos = i
            if e[0] > start_idx:
                break
        if key_pos is None:
            return out
        state: Dict[_SeriesKey, Any] = {}
        selected = set(series) if series else None
        points: Dict[_SeriesKey, List[list]] = {}
        prev_hist: Dict[_SeriesKey, tuple] = {}
        emitted = 0
        for e in entries[key_pos:]:
            idx, ts, kind, data, _est = e
            if kind == "key":
                state = dict(data)
            else:
                state.update(data)
            if idx < start_idx:
                # pre-window replay still tracks histogram state so the
                # FIRST in-window point's interval delta has a base
                for k, v in state.items():
                    if isinstance(v, tuple):
                        prev_hist[k] = v
                continue
            emitted += 1
            for k, v in state.items():
                name = k[0]
                if selected is not None and name not in selected:
                    continue
                pts = points.setdefault(k, [])
                if isinstance(v, tuple):
                    counts, csum, count = v
                    prev = prev_hist.get(k)
                    if prev is not None:
                        dcounts = [a - b for a, b in
                                   zip(counts, prev[0])]
                        dcount = count - prev[2]
                    else:
                        dcounts, dcount = list(counts), count
                    bounds = self._meta.get(name, ("", None))[1] or ()
                    pts.append([
                        round(ts, 3), count, round(csum, 6), dcount,
                        _quantile_from_buckets(bounds, dcounts, 0.5),
                        _quantile_from_buckets(bounds, dcounts, 0.99),
                    ])
                    prev_hist[k] = v
                else:
                    pts.append([round(ts, 3), v])
        for (name, labels), pts in points.items():
            kind, _bounds = self._meta.get(name, ("gauge", None))
            fam = out["series"].setdefault(name, {
                "kind": kind, "children": []})
            fam["children"].append({"labels": dict(labels),
                                    "points": pts})
        out["samples"] = emitted
        return out

    def index(self) -> Dict[str, Any]:
        """The cheap no-args ``GET /recorder`` answer: what is recorded,
        at what cadence, how big."""
        entries = self._live_entries()
        return {
            "hz": self.hz,
            "windowS": self.window_s,
            "samples": len(entries),
            "ringBytes": self._ring_bytes,
            "series": sorted(self._meta),
        }

    def exemplars(self) -> List[Dict[str, Any]]:
        """Current exemplars of every histogram family on the registry
        (live state, not ring history — exemplar windows are shorter
        than the ring)."""
        with self.registry._lock:
            metrics_list = list(self.registry._metrics.values())
        out: List[Dict[str, Any]] = []
        for m in metrics_list:
            if m.kind != "histogram":
                continue
            for ex in m.exemplars():
                ex["metric"] = m.name
                out.append(ex)
        return out

    def dump(self, window_s: Optional[float] = None) -> Dict[str, Any]:
        """The full self-describing snapshot an incident bundle (or
        ``GET /recorder?all=1``) freezes: the whole-series window plus
        current exemplars and every registered state-provider block."""
        out = self.window(series=None, window_s=window_s)
        out["wallTs"] = round(self._wall(), 3)
        out["exemplars"] = self.exemplars()
        out["state"] = collect_state()
        return out

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        """Start the background sampler (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, args=(self._stop,),
            # not the JAX package's thread name: a process that runs
            # both packages (their tests) tells the two samplers apart
            name="pio-torch-flight-recorder", daemon=True)
        self._thread.start()

    def _loop(self, stop: threading.Event) -> None:
        period = 1.0 / self.hz
        while not stop.is_set():
            try:
                self.sample_now()
            except Exception:
                logger.exception("flight-recorder sample failed")
            stop.wait(period)

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        self._thread = None


# ---------------------------------------------------------------------------
# incident capture
# ---------------------------------------------------------------------------

def _peek_controller_decisions(limit: int = 256) -> List[Dict[str, Any]]:
    """The controller ring WITHOUT creating a controller: an incident
    bundle on a process that never ran one records an empty audit
    trail, not a fresh controller as a side effect."""
    from incubator_predictionio_tpu_torch.obs import controller as obs_controller

    return obs_controller.peek_decisions(limit=limit)


def _peek_knob_decisions(limit: int = 256) -> List[Dict[str, Any]]:
    """Same contract for the knob controller's ring (obs/knobs.py):
    peek, never instantiate."""
    from incubator_predictionio_tpu_torch.obs import knobs as obs_knobs

    return obs_knobs.peek_knob_decisions(limit=limit)


def _peek_tenants() -> Optional[Dict[str, Any]]:
    """The tenant block WITHOUT side effects: None in single-tenant
    mode (the bundle key stays absent-by-value, pre-tenancy bundles
    unchanged in spirit)."""
    from incubator_predictionio_tpu_torch.serving import tenancy

    return tenancy.export_tenants_fn()()


def _recorder_url(metrics_url: str) -> str:
    """A federation target's ``/metrics`` URL → its ``/recorder`` full
    dump (same host/port; the route rides every server)."""
    scheme, _, rest = metrics_url.partition("://")
    authority = rest.split("/", 1)[0]
    return f"{scheme}://{authority}/recorder?all=1"


class IncidentCapture:
    """Breach-triggered bundle freezer. Triggers are non-blocking —
    they enqueue onto this engine's own worker thread, so the SLO
    evaluation (and anything that runs it: scrapes, the controller
    loop, the recorder tick) never waits on bundle I/O."""

    #: non-SLO trigger label values (SLO triggers use the bounded
    #: declared-objective names)
    MANUAL_TRIGGER = "manual"

    def __init__(self,
                 directory: Optional[str] = None,
                 recorder: Optional[FlightRecorder] = None,
                 cooldown_s: Optional[float] = None,
                 window_s: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None,
                 wall: Optional[Callable[[], float]] = None,
                 targets_fn: Optional[Callable[[], Sequence[Any]]] = None,
                 decisions_fn: Optional[
                     Callable[[], List[Dict[str, Any]]]] = None,
                 knobs_fn: Optional[
                     Callable[[], List[Dict[str, Any]]]] = None,
                 tenants_fn: Optional[
                     Callable[[], Optional[Dict[str, Any]]]] = None,
                 registry: Optional[obs_metrics.Registry] = None) -> None:
        d = directory if directory is not None else incident_dir()
        if not d:
            raise ValueError(
                "incident capture needs a directory: set PIO_INCIDENT_DIR")
        self.directory = d
        # created eagerly: an unwritable destination must fail HERE
        # (loudly, at install time), not at the first breach — the
        # "breach with no bundle" runbook row's first check
        os.makedirs(self.directory, exist_ok=True)
        self._recorder = recorder
        self.cooldown_s = (float(cooldown_s) if cooldown_s is not None
                           else incident_cooldown_s())
        self.window_s = (float(window_s) if window_s is not None
                         else recorder_window_s())
        self._clock = clock if clock is not None else times.monotonic
        self._wall = wall if wall is not None else time.time
        if targets_fn is None:
            from incubator_predictionio_tpu_torch.obs import federate

            targets_fn = federate.fleet_targets
        self._targets_fn = targets_fn
        self.decisions_fn = (decisions_fn if decisions_fn is not None
                             else _peek_controller_decisions)
        #: the knob controller's ring (obs/knobs.py) — a second audit
        #: trail the bundle freezes; the admin server rebinds it to its
        #: hosted instance exactly like decisions_fn
        self.knobs_fn = (knobs_fn if knobs_fn is not None
                         else _peek_knob_decisions)
        #: the tenant block seam (serving/tenancy.export_tenants_fn):
        #: registry policy + per-tenant SLO entries frozen into the
        #: bundle so it answers "which tenant breached, and was the
        #: fleet healthy" offline. Rebound by the admin like
        #: decisions_fn; the default peeks the process registry.
        self.tenants_fn = (tenants_fn if tenants_fn is not None
                           else _peek_tenants)
        reg = registry if registry is not None else obs_metrics.REGISTRY
        self._incidents_total = reg.counter(
            "pio_incidents_total",
            "incident bundles captured, by trigger (declared SLO names "
            "+ manual)", labels=("trigger",))
        self._lock = threading.Lock()
        #: trigger key → last capture wall (the dedup/cooldown state)
        self._last_capture: Dict[str, float] = {}
        self._pending: "queue.Queue[Tuple[str, Optional[Dict]]]" = \
            queue.Queue()
        self._queued: set = set()
        self._thread: Optional[threading.Thread] = None

    # -- triggering ---------------------------------------------------------
    def install(self, *engines: Any) -> None:
        """Register the breach hook on SLO engines (process and/or
        fleet) and start the worker thread."""
        for engine in engines:
            engine.add_breach_listener(self.on_breach)
        self._ensure_worker()

    def on_breach(self, entry: Dict[str, Any]) -> None:
        """SLOEngine breach listener: fast-burn crossed 1 for this
        objective. Never blocks — dedup/cooldown decide inline, the
        bundle is built on the worker thread."""
        self.trigger(entry["name"], entry)

    def trigger(self, reason: str,
                slo_entry: Optional[Dict[str, Any]] = None) -> bool:
        """Enqueue one capture unless the reason is cooling down or
        already queued. Returns whether a capture was enqueued."""
        now = self._clock()
        with self._lock:
            last = self._last_capture.get(reason)
            if last is not None and now - last < self.cooldown_s:
                return False
            if reason in self._queued:
                return False
            # cooldown stamped at TRIGGER time: a sustained burn fires
            # the listener on every evaluation, and the dedup must hold
            # even while the first bundle is still being written
            self._last_capture[reason] = now
            self._queued.add(reason)
        self._ensure_worker()
        self._pending.put((reason, slo_entry))
        return True

    def _ensure_worker(self) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._thread = threading.Thread(
                target=self._worker, name="pio-incident-capture",
                daemon=True)
            self._thread.start()

    def _worker(self) -> None:
        while True:
            reason, slo_entry = self._pending.get()
            if reason is None:  # stop sentinel
                return
            try:
                self.capture_now(reason, slo_entry)
            except Exception:
                logger.exception("incident capture failed (trigger=%s)",
                                 reason)
                # a FAILED capture must not consume the cooldown: the
                # stamp was taken at trigger time (dedup while this
                # bundle was in flight), but a transient write failure
                # (disk full, dir deleted) would otherwise blind the
                # capture plane for the whole cooldown while the
                # incident's ring evidence ages out — roll it back so
                # the next breached evaluation retries
                with self._lock:
                    self._last_capture.pop(reason, None)
            finally:
                with self._lock:
                    self._queued.discard(reason)

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the worker thread (pending captures drain first)."""
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None and t.is_alive():
            self._pending.put((None, None))
            t.join(timeout=timeout)

    # -- bundle building ----------------------------------------------------
    def _pull_instance(self, url: str) -> Dict[str, Any]:
        import urllib.request

        from incubator_predictionio_tpu_torch.obs import trace as obs_trace

        req = urllib.request.Request(
            url, headers=dict(obs_trace.client_headers()))
        with urllib.request.urlopen(req, timeout=10.0) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def _instances(self) -> Tuple[str, Dict[str, Any]]:
        """(scope, {instance: recorder dump | {"error": ...}}) —
        fleet-first like /federate, per-instance degradation, local
        recorder otherwise. Pulls fan out concurrently: the capture
        wall is bounded by the SLOWEST worker, not the sum — during an
        incident (when workers ARE slow or down) a sequential walk
        would freeze the last instances' windows tens of seconds
        staler than the first."""
        targets = list(self._targets_fn() or ())
        if targets:
            import concurrent.futures

            out: Dict[str, Any] = {}
            with concurrent.futures.ThreadPoolExecutor(
                    max_workers=min(len(targets), 8),
                    thread_name_prefix="pio-incident-pull") as pool:
                futs = {t.instance: pool.submit(
                    self._pull_instance, _recorder_url(t.url))
                    for t in targets}
                for instance, fut in futs.items():
                    try:
                        out[instance] = fut.result()
                    except Exception as e:  # noqa: BLE001 — per worker
                        out[instance] = {"error": str(e)}
            return "fleet", out
        rec = self._recorder if self._recorder is not None \
            else get_recorder()
        if rec is None:
            return "process", {"local": {
                "error": "recorder disabled (PIO_RECORDER=0)"}}
        return "process", {"local": rec.dump(window_s=self.window_s)}

    @staticmethod
    def _breach_exemplars(instances: Dict[str, Any],
                          metric: Optional[str],
                          threshold: Optional[float]) -> Dict[str, Any]:
        """The breaching histogram's exemplar trace IDs across the
        pulled instances: above-threshold buckets first (those ARE the
        p99 queries), everything else as context."""
        above: List[Dict[str, Any]] = []
        below: List[Dict[str, Any]] = []
        for inst, dump in instances.items():
            for ex in (dump.get("exemplars") or []):
                if metric is not None and ex.get("metric") != metric:
                    continue
                rec = dict(ex)
                rec["instance"] = inst
                le = rec.get("le")
                le_f = math.inf if le == "+Inf" else float(le)
                if threshold is not None and le_f > threshold:
                    above.append(rec)
                else:
                    below.append(rec)
        return {
            "metric": metric,
            "traceIds": sorted({e["traceId"] for e in above}
                               or {e["traceId"] for e in below}),
            "aboveThreshold": above,
            "others": below,
        }

    def capture_now(self, reason: str,
                    slo_entry: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
        """Build + write one bundle synchronously (the worker thread's
        body; also ``POST /incident``'s). Returns ``{"id", "path"}``."""
        wall = self._wall()
        scope, instances = self._instances()
        metric = threshold = None
        if slo_entry is not None:
            metric = slo_entry.get("objective", {}).get("metric")
            threshold = slo_entry.get("objective", {}).get(
                "thresholdSeconds")
        decisions = []
        try:
            decisions = list(self.decisions_fn() or [])
        except Exception:
            logger.exception("incident capture: decision ring "
                             "unavailable")
        in_window = [d for d in decisions
                     if isinstance(d.get("ts"), (int, float))
                     and d["ts"] >= wall - self.window_s]
        knob_decisions = []
        try:
            knob_decisions = list(self.knobs_fn() or [])
        except Exception:
            logger.exception("incident capture: knob ring unavailable")
        knobs_in_window = [d for d in knob_decisions
                           if isinstance(d.get("ts"), (int, float))
                           and d["ts"] >= wall - self.window_s]
        tenants_block = None
        try:
            tenants_block = self.tenants_fn()
        except Exception:
            logger.exception("incident capture: tenant block "
                             "unavailable")
        stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(wall))
        inc_id = f"inc-{stamp}-{reason}"
        # the stamp has second resolution: two captures of one trigger
        # inside a second (double-POSTed /incident) must land as TWO
        # artifacts, never a silent os.replace clobber of the first
        os.makedirs(self.directory, exist_ok=True)
        n = 2
        while os.path.exists(os.path.join(self.directory,
                                          f"{inc_id}.json")):
            inc_id = f"inc-{stamp}-{reason}-{n}"
            n += 1
        bundle = {
            "schema": "pio-incident-v1",
            "id": inc_id,
            "ts": round(wall, 3),
            "trigger": reason,
            "scope": scope,
            "windowS": self.window_s,
            "slo": slo_entry,
            "recorder": {"instances": instances},
            "exemplars": self._breach_exemplars(
                {k: v for k, v in instances.items()
                 if isinstance(v, dict) and "error" not in v},
                metric, threshold),
            "decisions": in_window,
            "decisionsTotal": len(decisions),
            # the knob controller's audit trail (obs/knobs.py): what
            # the self-tuner did in the pre-breach window — the first
            # thing to read when a rollback fired
            "knobs": knobs_in_window,
            "knobsTotal": len(knob_decisions),
            # per-tenant registry policy + SLO entries at capture time
            # (serving/tenancy.py) — None in single-tenant mode
            "tenants": tenants_block,
        }
        path = os.path.join(self.directory, f"{inc_id}.json")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(bundle, f, separators=(",", ":"))
        os.replace(tmp, path)  # readers never see a torn bundle
        self._incidents_total.labels(trigger=reason).inc()
        logger.warning("incident bundle captured: %s (trigger=%s, "
                       "scope=%s)", path, reason, scope)
        return {"id": inc_id, "path": path}

    # -- listing ------------------------------------------------------------
    def list_incidents(self) -> List[Dict[str, Any]]:
        """Newest-first bundle summaries from the incident directory."""
        out: List[Dict[str, Any]] = []
        try:
            names = sorted(os.listdir(self.directory), reverse=True)
        except OSError:
            return out
        for name in names:
            if not (name.startswith("inc-") and name.endswith(".json")):
                continue
            path = os.path.join(self.directory, name)
            entry: Dict[str, Any] = {"id": name[:-5], "file": name}
            try:
                entry["bytes"] = os.path.getsize(path)
                with open(path, encoding="utf-8") as f:
                    meta = json.load(f)
                entry.update({
                    "ts": meta.get("ts"),
                    "trigger": meta.get("trigger"),
                    "scope": meta.get("scope"),
                    "instances": sorted(
                        (meta.get("recorder") or {})
                        .get("instances", {})),
                    "exemplarTraceIds": (meta.get("exemplars") or {})
                    .get("traceIds", []),
                })
            except Exception as e:  # noqa: BLE001 — a corrupt bundle lists
                entry["error"] = str(e)
            out.append(entry)
        return out

    def read_incident(self, inc_id: str) -> Optional[Dict[str, Any]]:
        if "/" in inc_id or "\\" in inc_id or ".." in inc_id:
            return None
        path = os.path.join(self.directory, f"{inc_id}.json")
        try:
            with open(path, encoding="utf-8") as f:
                return json.load(f)
        except OSError:
            return None


# ---------------------------------------------------------------------------
# process-wide singletons (every server shares one recorder; capture
# engages only when PIO_INCIDENT_DIR names a destination)
# ---------------------------------------------------------------------------

_recorder: Optional[FlightRecorder] = None
_capture: Optional[IncidentCapture] = None
_singleton_lock = threading.Lock()


def get_recorder() -> Optional[FlightRecorder]:
    """The process recorder, started on first use; None when
    ``PIO_RECORDER=0`` (no thread exists — the off position is free)."""
    global _recorder
    if not recorder_enabled():
        return None
    with _singleton_lock:
        if _recorder is None:
            _recorder = FlightRecorder()
            _recorder.start()
        return _recorder


def get_capture() -> Optional[IncidentCapture]:
    """The process capture engine, breach-hooked to the SLO plane on
    first use; None when ``PIO_INCIDENT_DIR`` is unset. Fleet-first
    like the controller: with ``PIO_FLEET_TARGETS`` configured the
    fleet burn engine's breaches trigger (and the bundle pulls every
    worker's ``/recorder``); the process engine's breaches always
    trigger, so a lone worker still captures its own incidents."""
    global _capture
    if incident_dir() is None:
        return None
    # resolved BEFORE taking the singleton lock (get_recorder takes it
    # too, and the lock is deliberately not reentrant)
    rec = get_recorder()
    with _singleton_lock:
        if _capture is None:
            from incubator_predictionio_tpu_torch.obs import slo as obs_slo

            capture = IncidentCapture(recorder=rec)
            engines = [obs_slo.get_engine()]
            if os.environ.get("PIO_FLEET_TARGETS", "").strip():
                from incubator_predictionio_tpu_torch.obs import federate

                engines.append(federate.fleet_slo_engine())
            capture.install(*engines)
            _capture = capture
        return _capture


def reset_recorder() -> None:
    """Drop (and stop) the process recorder + capture — tests re-read
    the PIO_RECORDER*/PIO_INCIDENT_* env on next use."""
    global _recorder, _capture
    with _singleton_lock:
        if _recorder is not None:
            _recorder.stop(timeout=2.0)
        if _capture is not None:
            _capture.stop(timeout=2.0)
        _recorder = None
        _capture = None


__all__ = [
    "FlightRecorder", "IncidentCapture", "collect_state", "get_capture",
    "get_recorder", "incident_cooldown_s", "incident_dir",
    "recorder_enabled", "recorder_hz", "recorder_window_s",
    "register_state_provider", "reset_recorder",
    "unregister_state_provider",
]
