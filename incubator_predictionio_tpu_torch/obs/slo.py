"""SLO burn-rate engine over the process-wide histogram state.

The port's own copy of incubator_predictionio_tpu/obs/slo.py, its imports
pointed at this package. In the port the serving scheduler reads its shed
threshold here (``serving/scheduler.serve_objective_s``) and the scrape
collector refreshes the gauges; the ``GET /slo`` route lives on the admin
server and the dashboard, which are not ported yet (ROADMAP.md Queue 1
item 8).

The system makes three quantitative promises — serving p99 latency,
end-to-end freshness p95, and a model-staleness bound — and this module
evaluates them **as promises**: each declared objective splits its
metric's observations into good/bad against a threshold, and the engine
computes multi-window **burn rates** (how fast the error budget is
being consumed relative to the rate the target allows) the way the SRE
workbook prescribes: a fast window that pages quickly on a hard breach
and a slow window that confirms a sustained one.

Mechanics: the registry's histograms are *cumulative*, so the engine
keeps a bounded ring of timestamped ``(good, bad)`` snapshots (one per
``tick()``, rate-limited) and derives a window's bad fraction from the
snapshot nearest the window start. Burn rate = bad_fraction /
(1 − target); burn 1.0 means "consuming budget exactly as fast as the
objective allows", >1 is a breach in that window. Error budget
remaining is ``1 − burn(slow window)``, clamped at 0.

Objectives default in code and are overridable via ``PIO_SLO_*`` env
knobs (see :func:`default_specs`). Evaluation happens lazily — at
``GET /slo`` and at scrape time via the registry collector — so an idle
process pays nothing. Exported series:

- ``pio_slo_burn_rate{slo,window="fast"|"slow"}``
- ``pio_slo_error_budget_remaining{slo}``

This is exactly the signal the ROADMAP-3 autonomous retrain controller
consumes next: *trigger when the staleness/freshness burn rate exceeds
1 in the fast window*.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
from incubator_predictionio_tpu_torch.utils import times

logger = logging.getLogger(__name__)

BURN_RATE = obs_metrics.REGISTRY.gauge(
    "pio_slo_burn_rate",
    "error-budget burn rate (bad fraction / allowed bad fraction) over "
    "the window; >1 = consuming budget faster than the objective "
    "allows", labels=("slo", "window"))
BUDGET_REMAINING = obs_metrics.REGISTRY.gauge(
    "pio_slo_error_budget_remaining",
    "fraction of the error budget left over the slow window "
    "(1 - slow burn rate, clamped at 0)", labels=("slo",))


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declared objective.

    ``kind="histogram"``: good = observations ≤ ``threshold`` of the
    named histogram family (children summed — cross-engine objectives
    collapse their label). ``kind="gauge"``: the engine synthesizes one
    observation per tick, good when the gauge ≤ ``threshold`` (the
    staleness bound has no per-event stream to count).

    ``labels`` (a frozen tuple of (name, value) pairs, so the spec
    stays hashable) SLICES a labeled family to the matching children —
    the per-tenant burn engines (:func:`tenant_specs`) are the serve
    objective with ``labels=(("tenant", <id>),)``: a tenant can burn
    its own budget while the fleet-wide objective stays green."""

    name: str
    metric: str
    threshold: float          # seconds
    target: float             # required good fraction, e.g. 0.99
    kind: str = "histogram"   # "histogram" | "gauge"
    description: str = ""
    labels: Tuple[Tuple[str, str], ...] = ()


def tenant_specs() -> Tuple[SLOSpec, ...]:
    """One serve_p99 objective per registered tenant (empty registry →
    none). Spec names are ``serve_p99@<tenant>`` — the ``@`` grammar is
    what tenant-labels incident-capture trigger dedup for free (the
    capture engine dedups on entry name) and what the bundle's tenant
    block parses back out. Each spec slices the shared latency family
    to the tenant's own child, so one tenant's burn never reads a
    neighbor's traffic."""
    from incubator_predictionio_tpu_torch.serving import tenancy

    serve_threshold = _env_float("PIO_SLO_SERVE_P99_S", 0.25)
    serve_target = min(max(
        _env_float("PIO_SLO_SERVE_P99_TARGET", 0.99), 0.0), 0.9999)
    return tuple(
        SLOSpec(
            name=f"serve_p99@{tid}",
            metric="pio_query_latency_seconds",
            threshold=serve_threshold,
            target=serve_target,
            description=f"tenant {tid} per-query serving wall under "
                        "the bound",
            labels=(("tenant", tid),),
        )
        for tid in tenancy.get_registry().tenant_ids()
    )


def default_specs() -> Tuple[SLOSpec, ...]:
    """The shipped objectives; every number has a PIO_SLO_* override so
    operators declare THEIR promise without a code change. With a
    tenant registry configured (PIO_TENANTS), the per-tenant serve
    objectives (:func:`tenant_specs`) ride along — same burn engine,
    same breach-listener seam, tenant-named entries."""
    fleet = _fleet_specs()
    tenants = tenant_specs()
    return fleet + tenants


def _fleet_specs() -> Tuple[SLOSpec, ...]:
    return (
        SLOSpec(
            name="serve_p99",
            metric="pio_query_latency_seconds",
            threshold=_env_float("PIO_SLO_SERVE_P99_S", 0.25),
            target=min(max(
                _env_float("PIO_SLO_SERVE_P99_TARGET", 0.99), 0.0),
                0.9999),
            description="per-query serving wall under the bound"),
        SLOSpec(
            name="freshness_p95",
            metric="pio_freshness_seconds",
            threshold=_env_float("PIO_SLO_FRESHNESS_P95_S", 10.0),
            target=min(max(
                _env_float("PIO_SLO_FRESHNESS_TARGET", 0.95), 0.0),
                0.9999),
            description="event append -> first folded serve under the "
                        "bound"),
        SLOSpec(
            name="staleness",
            metric="pio_model_staleness_seconds",
            threshold=_env_float("PIO_SLO_STALENESS_S", 3600.0),
            target=min(max(
                _env_float("PIO_SLO_STALENESS_TARGET", 0.99), 0.0),
                0.9999),
            kind="gauge",
            description="deployed model age under the retrain bound"),
        SLOSpec(
            name="repl_lag",
            metric="pio_replication_lag_events",
            # threshold is in EVENTS, not seconds: the worst follower
            # of any shard may trail the primary by at most this many
            # acked events before the promise is breached
            threshold=_env_float("PIO_SLO_REPL_LAG", 10000.0),
            target=min(max(
                _env_float("PIO_SLO_REPL_LAG_TARGET", 0.99), 0.0),
                0.9999),
            kind="gauge",
            description="worst-of-shard follower replication lag "
                        "under the bound"),
    )


class SLOEngine:
    """Burn-rate evaluation over one registry. Thread-safe; cheap when
    idle (ticks are rate-limited, nothing runs between evaluations)."""

    def __init__(self, specs: Optional[Tuple[SLOSpec, ...]] = None,
                 registry: Optional[obs_metrics.Registry] = None,
                 clock: Optional[Callable[[], float]] = None,
                 fast_window_s: Optional[float] = None,
                 slow_window_s: Optional[float] = None,
                 min_tick_interval_s: float = 1.0,
                 max_snapshots: int = 8192,
                 export_gauges: bool = True) -> None:
        self.specs = tuple(specs if specs is not None else default_specs())
        self.registry = registry if registry is not None \
            else obs_metrics.REGISTRY
        self._clock = clock if clock is not None else times.monotonic
        self.fast_window_s = (fast_window_s if fast_window_s is not None
                              else _env_float("PIO_SLO_FAST_WINDOW_S",
                                              300.0))
        self.slow_window_s = (slow_window_s if slow_window_s is not None
                              else _env_float("PIO_SLO_SLOW_WINDOW_S",
                                              3600.0))
        #: whether evaluate() refreshes the process-registry burn/budget
        #: gauges. The FLEET engine (obs/federate.py) passes False: it
        #: evaluates a different population over the same gauge names,
        #: and letting it write pio_slo_burn_rate{slo,window} would make
        #: the exported series flip meaning between fleet and process
        #: depending on which endpoint ran last
        self._export_gauges = bool(export_gauges)
        self._min_tick = float(min_tick_interval_s)
        self._lock = threading.Lock()
        #: ring of (t, {slo_name: (good, bad)}) CUMULATIVE counts
        self._snaps: "deque[Tuple[float, Dict[str, Tuple[int, int]]]]" = \
            deque(maxlen=int(max_snapshots))
        #: gauge SLOs have no native event stream — the engine counts
        #: its own per-tick good/bad observations here
        self._gauge_counts: Dict[str, Tuple[int, int]] = {}
        #: fast-burn-crossing hooks (the incident-capture seam,
        #: obs/recorder.py): called with the breaching objective's
        #: evaluation entry on EVERY breached evaluation — listeners own
        #: their own dedup/cooldown, and they must never block (the
        #: capture engine enqueues to its own thread)
        self._breach_listeners: List[Callable[[Dict], None]] = []

    def add_breach_listener(self, fn: Callable[[Dict], None]) -> None:
        """Register a fast-burn-breach hook (idempotent per callable).
        This is the same signal the freshness controller consumes —
        ``breached`` = fast-window burn rate > 1."""
        with self._lock:
            if fn not in self._breach_listeners:
                self._breach_listeners.append(fn)

    def remove_breach_listener(self, fn: Callable[[Dict], None]) -> None:
        with self._lock:
            if fn in self._breach_listeners:
                self._breach_listeners.remove(fn)

    # -- sampling -----------------------------------------------------------
    def _counts_now(self) -> Dict[str, Tuple[int, int]]:
        out: Dict[str, Tuple[int, int]] = {}
        for spec in self.specs:
            metric = self.registry.get(spec.metric)
            if spec.kind == "histogram":
                if metric is None or metric.kind != "histogram":
                    continue  # not registered yet: no data, not a breach
                below, total = metric.cumulative_below(
                    spec.threshold,
                    labels=dict(spec.labels) if spec.labels else None)
                out[spec.name] = (below, total - below)
            else:
                if metric is None or metric.kind != "gauge" \
                        or not metric.has_samples():
                    # registered-but-never-set gauges are NO DATA, not
                    # health: a server whose deploy failed must not
                    # report a green staleness budget
                    continue
                good, bad = self._gauge_counts.get(spec.name, (0, 0))
                # worst-of, not sum-of: a gauge objective holds only
                # when EVERY child (and, on a federated registry, every
                # instance) is under the bound — the stalest worker
                # governs the fleet's staleness SLO
                if metric.max_value() <= spec.threshold:
                    good += 1
                else:
                    bad += 1
                self._gauge_counts[spec.name] = (good, bad)
                out[spec.name] = (good, bad)
        return out

    def tick(self, force: bool = False) -> None:
        """Append one cumulative snapshot (rate-limited to one per
        ``min_tick_interval_s`` unless forced)."""
        now = self._clock()
        with self._lock:
            if (not force and self._snaps
                    and now - self._snaps[-1][0] < self._min_tick):
                return
            self._snaps.append((now, self._counts_now()))

    def _window_delta(self, name: str, window_s: float,
                      now: float) -> Tuple[int, int, float]:
        """(good_delta, bad_delta, covered_seconds) for the trailing
        window, from the newest snapshot at/before the window start (or
        the oldest available — a young engine reports over what it has,
        honestly labeled by covered_seconds). Caller holds the lock."""
        if not self._snaps:
            return 0, 0, 0.0
        cutoff = now - window_s
        base = self._snaps[0]
        for snap in reversed(self._snaps):
            if snap[0] <= cutoff:
                base = snap
                break
        head = self._snaps[-1]
        g0, b0 = base[1].get(name, (0, 0))
        g1, b1 = head[1].get(name, (0, 0))
        return max(g1 - g0, 0), max(b1 - b0, 0), max(now - base[0], 0.0)

    # -- evaluation ---------------------------------------------------------
    def evaluate(self) -> List[Dict]:
        """Tick, then evaluate every objective → list of JSON-ready
        dicts (the /slo payload). Also refreshes the exported burn-rate
        and budget gauges."""
        self.tick()
        now = self._clock()
        out: List[Dict] = []
        with self._lock:
            snaps = bool(self._snaps)
            latest = self._snaps[-1][1] if snaps else {}
            windows = {}
            for spec in self.specs:
                windows[spec.name] = {
                    "fast": self._window_delta(spec.name,
                                               self.fast_window_s, now),
                    "slow": self._window_delta(spec.name,
                                               self.slow_window_s, now),
                }
        for spec in self.specs:
            allowed = max(1.0 - spec.target, 1e-9)
            totals = latest.get(spec.name)
            entry: Dict = {
                "name": spec.name,
                "objective": {
                    "metric": spec.metric,
                    "kind": spec.kind,
                    "thresholdSeconds": spec.threshold,
                    "target": spec.target,
                    "description": spec.description,
                    "labels": dict(spec.labels),
                },
                "noData": totals is None,
                "totalObservations": (None if totals is None
                                      else totals[0] + totals[1]),
                "windows": {},
            }
            burns = {}
            for wname, wsecs in (("fast", self.fast_window_s),
                                 ("slow", self.slow_window_s)):
                good, bad, covered = windows[spec.name][wname]
                seen = good + bad
                bad_frac = bad / seen if seen else 0.0
                burn = bad_frac / allowed
                burns[wname] = burn
                entry["windows"][wname] = {
                    "seconds": wsecs,
                    "coveredSeconds": round(covered, 3),
                    "observations": seen,
                    "badFraction": round(bad_frac, 6),
                    "burnRate": round(burn, 4),
                }
                if self._export_gauges:
                    BURN_RATE.labels(slo=spec.name, window=wname).set(burn)
            remaining = max(1.0 - burns["slow"], 0.0)
            entry["errorBudgetRemaining"] = round(remaining, 4)
            # page-worthy breach: budget burning faster than allowed in
            # the fast window (the slow window confirms sustained burns
            # via errorBudgetRemaining)
            entry["breached"] = bool(burns["fast"] > 1.0)
            if self._export_gauges:
                BUDGET_REMAINING.labels(slo=spec.name).set(remaining)
            out.append(entry)
        with self._lock:
            listeners = list(self._breach_listeners)
        if listeners:
            for entry in out:
                if not entry["breached"]:
                    continue
                for fn in listeners:
                    try:
                        fn(entry)
                    except Exception:
                        logger.exception(
                            "SLO breach listener failed for %s",
                            entry["name"])
        return out


# ---------------------------------------------------------------------------
# process-wide engine (lazy: env knobs are read at first use, and tests
# can reset to pick up monkeypatched objectives)
# ---------------------------------------------------------------------------

_engine: Optional[SLOEngine] = None
_engine_lock = threading.Lock()


def get_engine() -> SLOEngine:
    global _engine
    with _engine_lock:
        if _engine is None:
            _engine = SLOEngine()
            obs_metrics.REGISTRY.register_collector("slo", _collect)
        return _engine


def reset_engine() -> None:
    """Drop the process engine (tests re-read PIO_SLO_* on next use)."""
    global _engine
    with _engine_lock:
        _engine = None


def _collect() -> None:
    """Scrape-time hook: every /metrics scrape refreshes the burn-rate
    and budget gauges (and advances the snapshot ring)."""
    engine = _engine
    if engine is not None:
        engine.evaluate()
