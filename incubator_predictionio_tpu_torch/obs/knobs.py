"""Self-tuning serving — the recorder-driven knob controller.

The port's own copy of incubator_predictionio_tpu/obs/knobs.py, its
imports pointed at this package, with the same ten knobs. On the port the
scheduler knobs set the width of each score+top-k launch (the rung cap),
``PIO_SPEED_MAX_BATCH`` the width of each fold-in launch on the fused
ALS kernel, and the MIPS knobs are read at call time by ops/mips.py and
ops/mips_daemon.py. The capacity guard (:func:`capacity_caps_fn`) fits
only records measured on an NVIDIA card (obs/capacity.py
``card_records``). Like the JAX package, the controller reads THIS
process's flight recorder: on an admin process that is the series of
whatever it hosts (a front door books the client-observed
``pio_query_latency_seconds{tenant}``), not the workers' registries.

The reference PredictionIO leaves every serving parameter to a human
editing ``engine.json``; this stack's serving knobs are env vars an
operator tunes by hand and forgets. This module closes the second
control loop: a declarative registry over the four
serving knob families —

- MIPS search effort: ``PIO_SERVE_MIPS_NPROBE`` /
  ``PIO_SERVE_MIPS_CANDIDATES`` (ops/mips.py, call-time env reads);
- scheduler ladder: ``PIO_SERVE_MAX_BATCH`` cap +
  ``PIO_SERVE_MAX_WAIT_MS`` (serving/scheduler.py);
- shed projection: ``PIO_SERVE_SHED`` (serving/scheduler.py);
- overlay fold-in budget base: ``PIO_SPEED_MAX_BATCH``
  (speed/foldin.py → speed/overlay.py's adaptive rungs)

— driven by a bounded per-knob hill-climb. Every evaluation reads
**flight-recorder history windows** (obs/recorder.py — the trailing
p99 / queue-wait / shed-rate / recall series, not an instantaneous
scrape a single hiccup can spoof), decides at most ONE signed step per
pass, and gates it behind **hysteresis** (consecutive same-direction
desires), a per-knob **post-change cooldown**, the registry **bounds**,
and an ALX-style **capacity guard** (obs/capacity.py's fit says how far
a knob may move before capacity, not tuning, becomes binding —
arxiv 2112.02194's sizing argument).

Actuation happens through ONE sanctioned seam, exactly like
``FreshnessController._actuate``: :meth:`KnobController._apply` emits a
structured decision record (inputs snapshot, per-knob gate map, step,
outcome, rejection reason) into a bounded ring under its own trace ID
(``knb-``) and pushes the full knob vector through the fleet front
door's ``POST /knobs`` (serving/frontdoor.py fans each worker's
``POST /knobs`` under the rolling-reload serialization; the knobs are
call-time env reads, so they take effect without restart or drain).
``scripts/trace_stitch.py --decisions`` stitches ``knob.decision`` →
``knob.apply`` → the fleet's ``/knobs`` HTTP hops into one tree, and
the ``unaudited-knob-write`` lint rule pins that no other code path
mutates a registered knob.

Incident capture is the safety net: an SLO breach (obs/slo.py burn
engine — the same listener seam IncidentCapture rides) arriving while
the last adjustment is still inside its cooldown window schedules an
automatic **rollback to the last-known-good vector**, itself a normal
audited decision (``action="rollback"``, ``reason="incident"``), and
the knob decision ring lands in incident bundles via the capture's
``knobs_fn`` seam.

Exported series (docs/observability.md):

- ``pio_knob_evaluations_total``
- ``pio_knob_adjustments_total{knob}``
- ``pio_knob_rollbacks_total``
- ``pio_knob_value{knob}`` (the vector the controller believes is live)
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import secrets
import threading
import time
import urllib.request
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
from incubator_predictionio_tpu_torch.obs import trace as obs_trace
from incubator_predictionio_tpu_torch.utils import times

logger = logging.getLogger(__name__)

#: kill-switch modes, in escalation order (shared with the freshness
#: controller so one operator mental model covers both loops)
MODES = ("off", "observe", "act")

#: every env var the registry owns. The ``unaudited-knob-write`` lint
#: rule (analysis/rules.py) carries a literal copy of this set — a
#: rule must not import the runtime it audits — and tests pin the two
#: sets equal so a knob added here cannot silently escape the audit.
KNOB_ENV_VARS = frozenset((
    "PIO_SERVE_MIPS_NPROBE",
    "PIO_SERVE_MIPS_CANDIDATES",
    "PIO_SERVE_MAX_BATCH",
    "PIO_SERVE_MAX_WAIT_MS",
    "PIO_SERVE_SHED",
    "PIO_SPEED_MAX_BATCH",
    "PIO_SERVE_MIPS_PQ_M",
    "PIO_SERVE_MIPS_PQ_CANDIDATES",
    "PIO_MIPS_REBUILD_TAIL",
    "PIO_MIPS_REBUILD_AGE_S",
))

#: bounded reason enums — decision records and docs draw from these
#: sets only (metric-label-cardinality contract)
SKIP_REASONS = ("off", "observe", "healthy", "no_data", "hysteresis",
                "cooldown", "capacity", "bound", "no_actuator",
                "inputs_error")
ACTION_REASONS = ("recall_low", "latency_high", "queue_high",
                  "latency_headroom", "shed_active", "fold_lag",
                  "incident", "tail_high", "index_stale")

_EVALUATIONS = obs_metrics.REGISTRY.counter(
    "pio_knob_evaluations_total",
    "knob-controller evaluation passes (off-mode ticks excluded)")
_ADJUSTMENTS = obs_metrics.REGISTRY.counter(
    "pio_knob_adjustments_total",
    "autonomous knob steps actually applied, by knob name",
    labels=("knob",))
_ROLLBACKS = obs_metrics.REGISTRY.counter(
    "pio_knob_rollbacks_total",
    "incident-triggered rollbacks to the last-known-good knob vector")
_VALUE = obs_metrics.REGISTRY.gauge(
    "pio_knob_value",
    "current registry value per knob (the vector the controller "
    "believes the fleet is serving with)",
    labels=("knob",))

#: recorder series one evaluation consumes (window reads, not scrapes)
INPUT_SERIES = (
    "pio_query_latency_seconds",
    "pio_serve_queue_wait_seconds",
    "pio_serve_shed_total",
    "pio_serve_mips_recall",
    "pio_freshness_fold_seconds",
    "pio_mips_tail_size",
    "pio_mips_index_age_seconds",
)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def knobs_mode() -> str:
    """The env-declared kill-switch position (``PIO_KNOBS``), re-read
    per call; ``POST /knobs`` on the admin server overrides it
    in-process."""
    raw = os.environ.get("PIO_KNOBS", "off").strip().lower()
    return raw if raw in MODES else "off"


@dataclasses.dataclass
class KnobConfig:
    """Loop cadence + step policy. Every number has a ``PIO_KNOBS_*``
    env default so the CLI admin server is configurable without code."""

    #: evaluation period — also the kill switch's reaction bound
    interval_s: float = 10.0
    #: consecutive SAME-DIRECTION desires required before stepping (the
    #: hysteresis band — one noisy window must never move the fleet)
    hysteresis_evals: int = 2
    #: per-knob wall after a step during which it holds still; also the
    #: incident-rollback arming window — a breach landing inside it
    #: indicts the step
    cooldown_s: float = 120.0
    #: recorder window each evaluation reads
    window_s: float = 30.0
    #: decision-record ring bound
    ring: int = 256
    #: recall@k floor the MIPS knobs defend
    recall_target: float = 0.95
    #: recall slack required before latency may trade recall away
    recall_margin: float = 0.02
    #: fold-in wall the overlay budget knob defends
    fold_objective_s: float = 2.0

    @staticmethod
    def from_env() -> "KnobConfig":
        return KnobConfig(
            interval_s=_env_float("PIO_KNOBS_INTERVAL_S", 10.0),
            hysteresis_evals=int(_env_float("PIO_KNOBS_HYSTERESIS", 2)),
            cooldown_s=_env_float("PIO_KNOBS_COOLDOWN_S", 120.0),
            window_s=_env_float("PIO_KNOBS_WINDOW_S", 30.0),
            ring=int(_env_float("PIO_KNOBS_RING", 256)),
            recall_target=_env_float("PIO_KNOBS_RECALL_TARGET", 0.95),
            recall_margin=_env_float("PIO_KNOBS_RECALL_MARGIN", 0.02),
            fold_objective_s=_env_float(
                "PIO_KNOBS_FOLD_OBJECTIVE_S", 2.0),
        )


# ---------------------------------------------------------------------------
# the knob registry
# ---------------------------------------------------------------------------

#: decide(value, inputs, ctx) → (direction −1/0/+1, ACTION_REASONS
#: member or None). Pure functions of the inputs snapshot: the
#: machinery (hysteresis, cooldown, bounds, capacity, actuation, audit)
#: lives in the controller, the POLICY lives here.
DecideFn = Callable[[int, Dict[str, Any], Dict[str, float]],
                    Tuple[int, Optional[str]]]


@dataclasses.dataclass(frozen=True)
class KnobSpec:
    """One registry entry: where the knob lives (env var), where it may
    go (bounds + step scale), and what it optimizes (decide rule)."""

    name: str
    env: str
    default: int
    lo: int
    hi: int
    decide: DecideFn
    #: "pow2" doubles/halves (clamped); "binary" toggles 0/1
    scale: str = "pow2"

    def read_env(self) -> int:
        """Current live value: the env var when parseable, the registry
        default otherwise (a knob left on its auto heuristic starts the
        climb from the default, never from a sentinel)."""
        try:
            v = int(os.environ.get(self.env, "") or self.default)
        except ValueError:
            v = self.default
        if v <= 0 and self.scale == "pow2":
            v = self.default
        return min(max(v, self.lo), self.hi)

    def step(self, value: int, direction: int) -> int:
        """One bounded step. Returns ``value`` unchanged at a bound —
        the controller records that as gate="bound", it never saturates
        silently."""
        if direction == 0:
            return value
        if self.scale == "binary":
            return self.hi if direction > 0 else self.lo
        nxt = value * 2 if direction > 0 else value // 2
        return min(max(nxt, self.lo), self.hi)


def _decide_mips(value: int, inputs: Dict[str, Any],
                 ctx: Dict[str, float]) -> Tuple[int, Optional[str]]:
    """Shared MIPS effort rule (nprobe and the candidate pool): defend
    the recall floor first; spend recall SLACK on latency only when the
    serve objective is actually breached."""
    recall = inputs.get("recall")
    p99 = inputs.get("p99S")
    if recall is not None and recall < ctx["recallTarget"]:
        return 1, "recall_low"
    if p99 is not None and p99 > ctx["p99ObjectiveS"] \
            and recall is not None \
            and recall >= ctx["recallTarget"] + ctx["recallMargin"]:
        return -1, "latency_high"
    return 0, None


def _decide_cap(value: int, inputs: Dict[str, Any],
                ctx: Dict[str, float]) -> Tuple[int, Optional[str]]:
    """Ladder cap: grow when the queue (not the compute) dominates the
    latency budget; shrink when per-dispatch latency breaches with an
    empty queue (the batch itself is the wall)."""
    p99 = inputs.get("p99S")
    queue = inputs.get("queueP99S")
    obj = ctx["p99ObjectiveS"]
    if queue is not None and p99 is not None \
            and queue > 0.5 * obj and p99 <= obj:
        return 1, "queue_high"
    if p99 is not None and p99 > obj \
            and (queue is None or queue < 0.25 * obj):
        return -1, "latency_high"
    return 0, None


def _decide_wait(value: int, inputs: Dict[str, Any],
                 ctx: Dict[str, float]) -> Tuple[int, Optional[str]]:
    """Batch-formation wait: cut it under breach (waiting is latency it
    volunteered for); raise it only inside a wide healthy deadband so a
    doubled wait cannot jump the objective and oscillate."""
    p99 = inputs.get("p99S")
    queue = inputs.get("queueP99S")
    obj = ctx["p99ObjectiveS"]
    if p99 is not None and p99 > obj:
        return -1, "latency_high"
    if p99 is not None and p99 < 0.25 * obj \
            and (queue is None or queue < 0.1 * obj):
        return 1, "latency_headroom"
    return 0, None


def _decide_shed(value: int, inputs: Dict[str, Any],
                 ctx: Dict[str, float]) -> Tuple[int, Optional[str]]:
    """Shed projection toggle: arm it under sustained breach; disarm
    only when it is actively shedding WHILE the fleet is comfortably
    healthy (a misfiring projection turning away good traffic)."""
    p99 = inputs.get("p99S")
    shed_rate = inputs.get("shedPerS")
    obj = ctx["p99ObjectiveS"]
    if value < 1 and p99 is not None and p99 > obj:
        return 1, "latency_high"
    if value >= 1 and shed_rate is not None and shed_rate > 0.0 \
            and p99 is not None and p99 < 0.5 * obj:
        return -1, "shed_active"
    return 0, None


def _decide_foldin(value: int, inputs: Dict[str, Any],
                   ctx: Dict[str, float]) -> Tuple[int, Optional[str]]:
    """Overlay fold-in budget base: grow when the fold wall lags its
    objective and serving has headroom to pay for it; shrink when
    serving breaches while folds are cheap (the overlay is stealing
    compute the queries need)."""
    p99 = inputs.get("p99S")
    fold = inputs.get("foldP99S")
    obj = ctx["p99ObjectiveS"]
    if fold is not None and fold > ctx["foldObjectiveS"] \
            and (p99 is None or p99 <= obj):
        return 1, "fold_lag"
    if p99 is not None and p99 > obj \
            and fold is not None and fold <= 0.5 * ctx["foldObjectiveS"]:
        return -1, "latency_high"
    return 0, None


def _decide_pq_m(value: int, inputs: Dict[str, Any],
                 ctx: Dict[str, float]) -> Tuple[int, Optional[str]]:
    """PQ subquantizer count: more subspaces = finer residual codes =
    better coarse ranking, at M bytes/item. Defend the recall floor
    only — M is a BUILD-time knob (takes effect at the next daemon
    rebuild), so it never trades recall away autonomously; shrinking M
    for memory is the capacity guard's veto territory, not a climb."""
    recall = inputs.get("recall")
    if recall is not None and recall < ctx["recallTarget"]:
        return 1, "recall_low"
    return 0, None


def _decide_rebuild_tail(value: int, inputs: Dict[str, Any],
                         ctx: Dict[str, float]
                         ) -> Tuple[int, Optional[str]]:
    """Rebuild tail trigger: the exact tail is an O(tail·K) host scan
    on EVERY query, so a tail sustained above the trigger means fold-in
    outruns the rebuild cadence — tighten the trigger. Relax it only
    when serving breaches while the tail is nearly empty (rebuild
    clustering competes with serving for the same cores)."""
    tail = inputs.get("tailRows")
    p99 = inputs.get("p99S")
    if tail is not None and tail > value:
        return -1, "tail_high"
    if p99 is not None and p99 > ctx["p99ObjectiveS"] \
            and tail is not None and tail < value // 8:
        return 1, "latency_high"
    return 0, None


def _decide_rebuild_age(value: int, inputs: Dict[str, Any],
                        ctx: Dict[str, float]
                        ) -> Tuple[int, Optional[str]]:
    """Rebuild age trigger: an index aging past its own trigger while
    churn keeps arriving means the cadence is too loose (or the daemon
    is drowning) — tighten. Relax when serving breaches and the index
    is comfortably fresh."""
    age = inputs.get("indexAgeS")
    tail = inputs.get("tailRows")
    p99 = inputs.get("p99S")
    if age is not None and age > value and tail is not None and tail > 0:
        return -1, "index_stale"
    if p99 is not None and p99 > ctx["p99ObjectiveS"] \
            and age is not None and age < value // 4:
        return 1, "latency_high"
    return 0, None


def default_knobs() -> Tuple[KnobSpec, ...]:
    """The knob families, in adjustment priority order (one step
    per evaluation: quality defense first, then scheduler relief, then
    background-work budget, then the MIPS lifecycle knobs added with
    the PQ/rebuild-daemon work — appended last so the established
    priority order is unchanged)."""
    return (
        KnobSpec("mips_nprobe", "PIO_SERVE_MIPS_NPROBE",
                 default=64, lo=4, hi=4096, decide=_decide_mips),
        KnobSpec("mips_candidates", "PIO_SERVE_MIPS_CANDIDATES",
                 default=1024, lo=128, hi=16384, decide=_decide_mips),
        KnobSpec("max_batch", "PIO_SERVE_MAX_BATCH",
                 default=512, lo=32, hi=4096, decide=_decide_cap),
        KnobSpec("max_wait_ms", "PIO_SERVE_MAX_WAIT_MS",
                 default=250, lo=10, hi=1000, decide=_decide_wait),
        KnobSpec("shed", "PIO_SERVE_SHED",
                 default=1, lo=0, hi=1, decide=_decide_shed,
                 scale="binary"),
        KnobSpec("foldin_budget", "PIO_SPEED_MAX_BATCH",
                 default=64, lo=8, hi=1024, decide=_decide_foldin),
        KnobSpec("mips_pq_candidates", "PIO_SERVE_MIPS_PQ_CANDIDATES",
                 default=2048, lo=256, hi=32768, decide=_decide_mips),
        KnobSpec("mips_pq_m", "PIO_SERVE_MIPS_PQ_M",
                 default=16, lo=4, hi=64, decide=_decide_pq_m),
        KnobSpec("mips_rebuild_tail", "PIO_MIPS_REBUILD_TAIL",
                 default=4096, lo=256, hi=65536,
                 decide=_decide_rebuild_tail),
        KnobSpec("mips_rebuild_age_s", "PIO_MIPS_REBUILD_AGE_S",
                 default=900, lo=60, hi=14400,
                 decide=_decide_rebuild_age),
    )


# ---------------------------------------------------------------------------
# recorder-window input extraction
# ---------------------------------------------------------------------------

def _hist_window_p99(fam: Optional[Dict[str, Any]]) -> Optional[float]:
    """Count-weighted mean of the per-interval p99s across every child
    in the window — the recorder already computed each interval's tail
    from bucket deltas; weighting by interval count keeps one idle
    second from diluting a busy one."""
    if not fam:
        return None
    num = den = 0.0
    for child in fam.get("children", ()):
        for pt in child.get("points", ()):
            if len(pt) >= 6 and pt[3] and pt[5] is not None:
                num += float(pt[5]) * float(pt[3])
                den += float(pt[3])
    return num / den if den > 0 else None


def _counter_window_rate(fam: Optional[Dict[str, Any]]) -> Optional[float]:
    """Summed per-second rate over the window across children (shed
    reasons, worker instances). None when the window is too short to
    hold a rate."""
    if not fam:
        return None
    total = 0.0
    span = 0.0
    saw = False
    for child in fam.get("children", ()):
        pts = child.get("points", ())
        if len(pts) < 2:
            continue
        saw = True
        total += float(pts[-1][1]) - float(pts[0][1])
        span = max(span, float(pts[-1][0]) - float(pts[0][0]))
    if not saw or span <= 0:
        return None
    return max(total, 0.0) / span


def _gauge_window_last(fam: Optional[Dict[str, Any]],
                       worst: Callable[..., float] = min
                       ) -> Optional[float]:
    """Newest reading per child, reduced by ``worst`` across children
    (min for recall: the weakest index is the fleet's recall)."""
    if not fam:
        return None
    vals = [float(child["points"][-1][1])
            for child in fam.get("children", ())
            if child.get("points")]
    return worst(vals) if vals else None


# ---------------------------------------------------------------------------
# actuator factories
# ---------------------------------------------------------------------------
#
# Like the freshness controller's retrain/reload pair, the knob
# controller never hard-codes HOW a vector reaches the fleet — it takes
# one callable. The closures below run only from inside the decision-
# record emitter (_apply); the unaudited-knob-write lint rule documents
# the *_fn naming convention as the sanctioned construction site.

def http_knobs_fn(url: str, server_key: Optional[str] = None,
                  timeout_s: float = 60.0
                  ) -> Callable[[Dict[str, int]], Dict]:
    """Actuator that POSTs the front door's fleet ``/knobs`` (which
    fans each worker's ``POST /knobs`` under the rolling-reload
    serialization, serving/frontdoor.py). The request carries the
    ambient trace headers, so every worker hop lands under the
    decision's trace."""
    if "://" not in url:
        url = f"http://{url}"
    if server_key:
        from urllib.parse import quote

        url = f"{url}?accessKey={quote(server_key, safe='')}"

    def apply(vector: Dict[str, int]) -> Dict:
        body = json.dumps(
            {"values": {k: int(v) for k, v in sorted(vector.items())}},
        ).encode("utf-8")
        req = urllib.request.Request(
            url, data=body, method="POST",
            headers={**obs_trace.client_headers(),
                     "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return json.loads(resp.read().decode("utf-8"))

    return apply


def local_knobs_fn() -> Callable[[Dict[str, int]], Dict]:
    """Actuator for a single-process deployment (or tests): writes the
    knob env vars directly — every registered knob is a call-time env
    read, so the very next dispatch sees the new vector."""

    def apply(vector: Dict[str, int]) -> Dict:
        applied = {}
        for env, v in sorted(vector.items()):
            os.environ[env] = str(int(v))
            applied[env] = int(v)
        return {"local": True, "applied": applied}

    return apply


def _fanout_failures(result: Any) -> List[str]:
    """Per-worker failures hidden inside a "successful" actuator call.
    The front door's fleet ``/knobs`` answers HTTP 200 even when some
    (or all) workers fail or reject the vector — the real outcome
    lives in the body's ``failed`` list and ``applied`` count
    (serving/frontdoor.py knobs_fanout_async). Any failed entry means
    part of the fleet still serves the OLD vector, so the apply did
    NOT succeed and the controller's belief must not advance."""
    if not isinstance(result, dict):
        return []
    failed = result.get("failed")
    if isinstance(failed, (list, tuple)) and failed:
        return [str(w) for w in failed]
    workers, applied = result.get("workers"), result.get("applied")
    # local_knobs_fn reports ``applied`` as a dict — only the fleet
    # door's int/int pair is a coverage count worth comparing
    if isinstance(workers, int) and isinstance(applied, int) \
            and applied < workers:
        return [f"{workers - applied} worker(s) unapplied"]
    return []


def capacity_caps_fn(repo_dir: str = ".") -> Callable[
        [], Optional[Dict[str, int]]]:
    """Capacity guard from the measured fit (obs/capacity.py): the
    newest non-degraded card records bound how far the effort knobs
    may climb before capacity — not tuning — becomes binding. The fit
    is computed once at factory time; returns None (no guard) when no
    usable fit exists, because a fabricated ceiling would veto real
    steps."""
    caps: Optional[Dict[str, int]] = None
    try:
        from incubator_predictionio_tpu_torch.obs import capacity

        fit = capacity.fit_capacity(capacity.card_records(
            capacity.load_trajectory(repo_dir)))
        block = fit.get("knobs")
        if block:
            caps = {k: int(v) for k, v in block.items()
                    if isinstance(v, (int, float)) and v > 0}
    except Exception:
        logger.exception("capacity fit unavailable; knob capacity "
                         "guard disabled")

    def estimate() -> Optional[Dict[str, int]]:
        return dict(caps) if caps else None

    return estimate


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

class KnobController:
    """The recorder-driven serving-knob loop. One instance per admin
    process, hosted next to the freshness controller; every evaluation
    appends a decision record, every actuation runs inside the
    decision's trace context, and an SLO breach inside the newest
    step's cooldown rolls the whole vector back."""

    def __init__(self,
                 specs: Optional[Tuple[KnobSpec, ...]] = None,
                 apply_fn: Optional[Callable[[Dict[str, int]], Any]]
                 = None,
                 capacity_fn: Optional[Callable[
                     [], Optional[Dict[str, int]]]] = None,
                 recorder_fn: Optional[Callable[[], Any]] = None,
                 config: Optional[KnobConfig] = None,
                 clock: Optional[Callable[[], float]] = None,
                 mode: Optional[str] = None,
                 apply_scope: Optional[str] = None) -> None:
        self.specs = tuple(specs) if specs is not None \
            else default_knobs()
        self.config = config or KnobConfig.from_env()
        self._clock = clock if clock is not None else times.monotonic
        self._apply_fn = apply_fn
        #: "fleet" | "local" | None — how far the actuator reaches
        #: (stats() surfaces it so one status call shows whether
        #: adjustments leave this process)
        self._apply_scope = apply_scope
        self._capacity_fn = capacity_fn
        self._recorder_fn = recorder_fn
        self._mode_override: Optional[str] = mode
        self._lock = threading.Lock()
        self._ring: "deque[Dict[str, Any]]" = deque(
            maxlen=max(int(self.config.ring), 1))
        #: signed per-knob desire streaks (hysteresis state)
        self._streaks: Dict[str, int] = {}
        #: per-knob cooldown deadlines (monotonic)
        self._cooldowns: Dict[str, float] = {}
        #: the vector the controller believes is live
        self._vector: Dict[str, int] = {
            s.env: s.read_env() for s in self.specs}
        #: vector before the newest applied step — the rollback target
        self._last_good: Optional[Dict[str, int]] = None
        #: the newest applied step while its cooldown arms the rollback
        self._last_change: Optional[Dict[str, Any]] = None
        self._rollback_pending: Optional[Dict[str, Any]] = None
        self._seq = 0
        self._adjustments = 0
        self._rollbacks = 0
        self._last_action: Optional[Dict[str, Any]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        for s in self.specs:
            _VALUE.labels(knob=s.name).set(float(self._vector[s.env]))

    # -- mode (the kill switch) ---------------------------------------------
    @property
    def mode(self) -> str:
        with self._lock:
            return self._mode_override or knobs_mode()

    def set_mode(self, mode: str) -> str:
        """Live flip (POST /knobs on the admin server). The flip lands
        in the decision ring — same contract as the freshness
        controller's kill switch."""
        mode = (mode or "").strip().lower()
        if mode not in MODES:
            raise ValueError(
                f"mode must be one of {MODES}, got {mode!r}")
        with self._lock:
            # inline (not the property): self._lock is not reentrant
            prev = self._mode_override or knobs_mode()
            self._mode_override = mode
            self._seq += 1
            self._ring.append({
                "id": self._seq,
                "ts": round(time.time(), 3),
                "kind": "mode_change",
                "from": prev,
                "to": mode,
            })
        logger.info("knob controller mode: %s -> %s", prev, mode)
        return mode

    # -- breach listener (the rollback trigger) -----------------------------
    def install(self, *engines: Any) -> None:
        """Ride the same breach-listener seam IncidentCapture uses
        (obs/slo.py ``add_breach_listener``): a breach inside the
        newest step's cooldown window indicts that step."""
        for engine in engines:
            engine.add_breach_listener(self.on_breach)

    def on_breach(self, entry: Dict[str, Any]) -> None:
        """Arm a rollback when a breach lands inside the cooldown of
        the newest applied step. Non-blocking — the actual (audited)
        rollback runs on the controller's own loop, never on the SLO
        engine's evaluation thread."""
        now = self._clock()
        with self._lock:
            lc = self._last_change
            if lc is None or self._rollback_pending is not None:
                return
            if now >= lc["cooldownUntil"] or self._last_good is None:
                return
            self._rollback_pending = {
                "slo": entry.get("name"),
                "knob": lc["knob"],
                "decisionId": lc["decisionId"],
                "ts": round(time.time(), 3),
            }
        logger.warning(
            "knob controller: SLO %r breached inside cooldown of "
            "knob %r step (decision #%s) — rollback armed",
            entry.get("name"), lc["knob"], lc["decisionId"])

    # -- signal resolution --------------------------------------------------
    def _resolve_recorder(self) -> Any:
        if self._recorder_fn is not None:
            return self._recorder_fn()
        from incubator_predictionio_tpu_torch.obs import recorder as obs_rec

        return obs_rec.get_recorder()

    def _ctx(self) -> Dict[str, float]:
        """Objectives the decide rules climb against. The serve p99
        objective is the serve_p99 SLO threshold (obs/slo.py), so the
        knob loop and the burn engine defend the SAME number."""
        from incubator_predictionio_tpu_torch.obs import slo as obs_slo

        p99_objective = 0.25
        for spec in obs_slo.default_specs():
            if spec.name == "serve_p99":
                p99_objective = float(spec.threshold)
        return {
            "p99ObjectiveS": p99_objective,
            "recallTarget": self.config.recall_target,
            "recallMargin": self.config.recall_margin,
            "foldObjectiveS": self.config.fold_objective_s,
        }

    def _read_inputs(self) -> Optional[Dict[str, Any]]:
        """One inputs snapshot from the flight recorder's trailing
        window. None = nothing recorded yet (reason="no_data")."""
        rec = self._resolve_recorder()
        if rec is None:
            return None
        win = rec.window(series=INPUT_SERIES,
                         window_s=self.config.window_s)
        if win.get("samples", 0) < 2:
            return None
        ser = win.get("series", {})
        inputs = {
            "p99S": _hist_window_p99(
                ser.get("pio_query_latency_seconds")),
            "queueP99S": _hist_window_p99(
                ser.get("pio_serve_queue_wait_seconds")),
            "shedPerS": _counter_window_rate(
                ser.get("pio_serve_shed_total")),
            "recall": _gauge_window_last(
                ser.get("pio_serve_mips_recall"), worst=min),
            "foldP99S": _hist_window_p99(
                ser.get("pio_freshness_fold_seconds")),
            # MIPS lifecycle gauges (worst = max: the most-lagged
            # engine/index is what the rebuild knobs defend)
            "tailRows": _gauge_window_last(
                ser.get("pio_mips_tail_size"), worst=max),
            "indexAgeS": _gauge_window_last(
                ser.get("pio_mips_index_age_seconds"), worst=max),
            "samples": win.get("samples", 0),
            "windowS": win.get("windowS"),
        }
        if all(inputs[k] is None for k in
               ("p99S", "queueP99S", "shedPerS", "recall")):
            return None
        return inputs

    # -- one evaluation -----------------------------------------------------
    def evaluate_once(self) -> Optional[Dict[str, Any]]:
        """One controller pass: read the window, run every knob's
        decide rule, gate, and step AT MOST ONE knob (coordinate
        descent keeps every decision attributable to one cause).
        Returns the appended decision record (None only in off mode)."""
        mode = self.mode
        if mode == "off":
            return None
        _EVALUATIONS.inc()
        now = self._clock()
        with self._lock:
            self._seq += 1
            decision: Dict[str, Any] = {
                "id": self._seq,
                "traceId": f"knb-{secrets.token_hex(6)}",
                "ts": round(time.time(), 3),
                "kind": "evaluation",
                "mode": mode,
                "inputs": None,
                "knobs": {},
                "knob": None,
                "action": "none",
                "reason": None,
                "outcome": None,
                # pre-seeded so _apply's fill-in replaces values
                # without resizing a dict a concurrent GET /knobs may
                # be rendering
                "spanId": None,
            }
            pending = self._rollback_pending

        if pending is not None:
            return self._rollback(decision, pending, mode)

        try:
            inputs = self._read_inputs()
        except Exception as e:  # recorder race ≠ controller crash
            logger.warning("knob controller inputs read failed: %s", e)
            decision["reason"] = "inputs_error"
            decision["error"] = str(e)
            # a blind evaluation breaks every consecutive-desire chain:
            # hysteresis must never count across a gap it could not see
            with self._lock:
                self._streaks.clear()
            self._append(decision)
            return decision
        if inputs is None:
            decision["reason"] = "no_data"
            with self._lock:
                self._streaks.clear()
            self._append(decision)
            return decision
        decision["inputs"] = inputs
        ctx = self._ctx()

        caps: Optional[Dict[str, int]] = None
        if self._capacity_fn is not None:
            try:
                caps = self._capacity_fn()
            except Exception:
                logger.exception("knob capacity guard failed "
                                 "(treated as no guard)")

        picked: Optional[Tuple[KnobSpec, int, int, int, str]] = None
        gates: List[str] = []
        with self._lock:
            believed = dict(self._vector)
        for spec in self.specs:
            value = believed[spec.env]
            try:
                desire, why = spec.decide(value, inputs, ctx)
            except Exception:
                logger.exception("knob %s decide rule failed",
                                 spec.name)
                desire, why = 0, None
            with self._lock:
                s = self._streaks.get(spec.name, 0)
                if desire == 0:
                    s = 0
                elif s == 0 or (s > 0) == (desire > 0):
                    s += desire
                else:
                    s = desire
                self._streaks[spec.name] = s
                cooldown_until = self._cooldowns.get(spec.name, 0.0)
            entry: Dict[str, Any] = {
                "value": value, "desire": desire, "why": why,
                "streak": s,
            }
            decision["knobs"][spec.name] = entry
            if desire == 0:
                continue
            if abs(s) < self.config.hysteresis_evals:
                entry["gate"] = "hysteresis"
                gates.append("hysteresis")
                continue
            if now < cooldown_until:
                entry["gate"] = "cooldown"
                entry["cooldownRemainingS"] = round(
                    cooldown_until - now, 3)
                gates.append("cooldown")
                continue
            proposed = spec.step(value, desire)
            if proposed == value:
                entry["gate"] = "bound"
                gates.append("bound")
                continue
            cap = caps.get(spec.name) if caps else None
            if desire > 0 and cap is not None and proposed > cap:
                # the measured fit says this step overruns capacity:
                # capacity, not tuning, is the binding constraint
                # (runbook: add chips, the knob cannot climb its way
                # out)
                entry["gate"] = "capacity"
                entry["capacityMax"] = cap
                gates.append("capacity")
                continue
            if picked is None:
                entry["gate"] = "selected"
                picked = (spec, value, proposed, desire, why or "")
            else:
                # one step per evaluation; this knob keeps its streak
                # and goes first next pass if still desiring
                entry["gate"] = "queued"

        if picked is None:
            for reason in ("capacity", "cooldown", "hysteresis",
                           "bound"):
                if reason in gates:
                    decision["reason"] = reason
                    break
            else:
                decision["reason"] = "healthy"
            self._append(decision)
            return decision

        spec, value, proposed, desire, why = picked
        decision["knob"] = spec.name
        decision["action"] = "step_up" if desire > 0 else "step_down"
        decision["from"] = value
        decision["to"] = proposed
        decision["reason"] = why
        if mode == "observe":
            decision["outcome"] = {"actuated": False, "dryRun": True}
            self._append(decision)
            return decision
        if self._apply_fn is None:
            decision["reason"] = "no_actuator"
            self._append(decision)
            return decision

        # -- act ------------------------------------------------------------
        # the record lands in the ring BEFORE actuation (marked
        # in-flight) and is updated in place on completion, same
        # contract as the freshness controller's ring
        decision["outcome"] = {"actuated": True, "inFlight": True}
        with self._lock:
            self._last_action = decision
            previous = dict(self._vector)
        vector = dict(previous)
        vector[spec.env] = proposed
        self._append(decision)
        self._apply(decision, vector)
        if decision["outcome"].get("actuated"):
            # counted AFTER the fan-out: the metric means steps that
            # actually landed, never attempts
            _ADJUSTMENTS.labels(knob=spec.name).inc()
        with self._lock:
            if decision["outcome"].get("actuated"):
                self._adjustments += 1
                # cooldown counts from actuation COMPLETION; the
                # rollback arming window is the same wall, so a breach
                # during the fan-out itself already indicts this step
                self._streaks[spec.name] = 0
                self._cooldowns[spec.name] = \
                    self._clock() + self.config.cooldown_s
                self._last_good = previous
                self._last_change = {
                    "knob": spec.name,
                    "decisionId": decision["id"],
                    "cooldownUntil": self._cooldowns[spec.name],
                }
            # a FAILED apply leaves streak and cooldown untouched:
            # the knob stays eligible and the next evaluation
            # re-proposes the same step instead of freezing for a
            # cooldown the fleet never earned
        return decision

    def _rollback(self, decision: Dict[str, Any],
                  pending: Dict[str, Any],
                  mode: str) -> Dict[str, Any]:
        """The incident path: restore the last-known-good vector as a
        normal audited decision, then re-arm (streaks cleared, every
        knob cooled down) so the climb restarts from scratch."""
        decision["action"] = "rollback"
        decision["reason"] = "incident"
        decision["knob"] = pending.get("knob")
        decision["incident"] = {
            "slo": pending.get("slo"),
            "steppedBy": pending.get("decisionId"),
        }
        with self._lock:
            target = (dict(self._last_good)
                      if self._last_good is not None else None)
            decision["fromVector"] = dict(self._vector)
            decision["toVector"] = target
        if mode != "act" or target is None or self._apply_fn is None:
            decision["outcome"] = {"actuated": False, "dryRun": True}
            with self._lock:
                self._rollback_pending = None
                self._last_change = None
            self._append(decision)
            return decision
        decision["outcome"] = {"actuated": True, "inFlight": True}
        with self._lock:
            self._last_action = decision
        self._append(decision)
        self._apply(decision, target)
        if decision["outcome"].get("actuated"):
            # counted on completion only — a pending rollback retried
            # across ticks is ONE rollback, not one per attempt
            _ROLLBACKS.inc()
        with self._lock:
            if decision["outcome"].get("actuated"):
                self._rollbacks += 1
                self._rollback_pending = None
                self._last_change = None
                self._last_good = None
                self._streaks.clear()
                cooled = self._clock() + self.config.cooldown_s
                for spec in self.specs:
                    self._cooldowns[spec.name] = cooled
            # a failed fan-out leaves the rollback PENDING: the next
            # tick retries rather than abandoning a known-bad vector
        return decision

    # -- the decision-record emitter (the ONE sanctioned actuation site) ----
    def _apply(self, decision: Dict[str, Any],
               vector: Dict[str, int]) -> None:
        """Push ``vector`` through the actuator inside the decision's
        trace context and write the outcome into the record. The
        fleet's ``/knobs`` HTTP hops forward the decision's trace ID,
        so the stitcher joins the whole fan-out under this decision
        span. The unaudited-knob-write lint rule pins that knob
        mutations happen here (or in the ``/knobs`` routes the fan-out
        lands on) and nowhere else."""
        span_id = obs_trace.new_span_id()
        decision["spanId"] = span_id
        token = obs_trace.set_current(decision["traceId"])
        span_token = obs_trace.set_current_span(span_id)
        t0 = time.perf_counter()
        outcome: Dict[str, Any] = {"actuated": True}
        try:
            t_a = time.perf_counter()
            try:
                result = self._apply_fn(dict(vector))
                failed = _fanout_failures(result)
                if failed:
                    # a 200 from the door with workers in its
                    # ``failed`` list is a split fleet, not a success:
                    # keep the old belief exactly as if the call had
                    # raised, so the next evaluation re-proposes
                    logger.warning(
                        "knob apply rejected by part of the fleet "
                        "(%s) — belief held", ", ".join(failed))
                    outcome["actuated"] = False
                    outcome["apply"] = {
                        "ok": False,
                        "failed": failed,
                        "result": result,
                        "wallS": round(time.perf_counter() - t_a, 3),
                    }
                else:
                    outcome["apply"] = {
                        "ok": True,
                        "result": result,
                        "wallS": round(time.perf_counter() - t_a, 3),
                    }
                    obs_trace.log_stage_span(
                        "knob.apply", decision["traceId"],
                        time.perf_counter() - t_a,
                        spanId=obs_trace.new_span_id(),
                        parentSpanId=span_id,
                        decisionId=decision["id"],
                        knob=decision.get("knob"))
                    with self._lock:
                        self._vector = dict(vector)
                    for spec in self.specs:
                        if spec.env in vector:
                            _VALUE.labels(knob=spec.name).set(
                                float(vector[spec.env]))
            except Exception as e:
                logger.exception("knob apply failed")
                # a failed fan-out leaves the OLD vector authoritative:
                # the controller's belief only moves on success, so the
                # next evaluation re-proposes rather than drifting
                outcome["actuated"] = False
                outcome["apply"] = {
                    "ok": False,
                    "error": str(e),
                    "wallS": round(time.perf_counter() - t_a, 3),
                }
        finally:
            outcome["wallS"] = round(time.perf_counter() - t0, 3)
            decision["outcome"] = outcome
            # the decision ROOT span, emitted after actuation so its
            # duration covers the whole fan-out
            obs_trace.log_stage_span(
                "knob.decision", decision["traceId"],
                time.perf_counter() - t0,
                spanId=span_id,
                decisionId=decision["id"],
                action=decision["action"],
                reason=decision["reason"],
                knob=decision.get("knob"))
            obs_trace.reset_current_span(span_token)
            obs_trace.reset_current(token)

    # -- ring / introspection -----------------------------------------------
    def _append(self, decision: Dict[str, Any]) -> None:
        with self._lock:
            self._ring.append(decision)

    def decisions(self, limit: int = 50) -> List[Dict[str, Any]]:
        """Newest-first slice of the decision ring."""
        with self._lock:
            out = list(self._ring)
        out.reverse()
        return out[:max(int(limit), 0)]

    def values(self) -> Dict[str, int]:
        """The live vector, keyed by env var."""
        with self._lock:
            return dict(self._vector)

    def stats(self) -> Dict[str, Any]:
        now = self._clock()
        with self._lock:
            lc = self._last_change
            return {
                # inline (not the property): self._lock is not reentrant
                "mode": self._mode_override or knobs_mode(),
                "running": self._thread is not None
                and self._thread.is_alive(),
                "intervalS": self.config.interval_s,
                "hysteresisEvals": self.config.hysteresis_evals,
                "cooldownS": self.config.cooldown_s,
                "windowS": self.config.window_s,
                "knobs": {
                    s.name: {
                        "env": s.env,
                        "value": self._vector[s.env],
                        "lo": s.lo,
                        "hi": s.hi,
                        "streak": self._streaks.get(s.name, 0),
                        "cooldownRemainingS": round(max(
                            self._cooldowns.get(s.name, 0.0) - now,
                            0.0), 3),
                    } for s in self.specs
                },
                "adjustments": self._adjustments,
                "rollbacks": self._rollbacks,
                "rollbackArmed": lc is not None
                and now < lc["cooldownUntil"],
                "rollbackPending": self._rollback_pending is not None,
                "decisionsRecorded": self._seq,
                "lastAction": self._last_action,
                "actuators": {
                    "apply": self._apply_fn is not None,
                    "scope": self._apply_scope,
                    "capacityGuard": self._capacity_fn is not None,
                },
            }

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        """Start the background loop (idempotent; same per-generation
        stop-event discipline as the freshness controller, so a timed-
        out stop can never leave two live loops)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive() \
                    and not self._stop.is_set():
                return
            stop = threading.Event()
            self._stop = stop
            self._thread = threading.Thread(
                target=self._loop, args=(stop,),
                # not the JAX package's thread name, as in the
                # freshness controller
                name="pio-torch-knob-controller", daemon=True)
            self._thread.start()

    def _loop(self, stop: threading.Event) -> None:
        while not stop.is_set():
            try:
                self.evaluate_once()
            except Exception:
                logger.exception("knob evaluation failed")
            stop.wait(self.config.interval_s)

    def stop(self, timeout: float = 10.0) -> None:
        with self._lock:
            stop = self._stop
            t = self._thread
        stop.set()
        if t is not None:
            t.join(timeout=timeout)
            if t.is_alive():
                return
        with self._lock:
            if self._thread is t:
                self._thread = None


# ---------------------------------------------------------------------------
# process-wide controller (the admin server's instance; tests reset)
# ---------------------------------------------------------------------------

_knob_controller: Optional[KnobController] = None
_knob_lock = threading.Lock()


def get_knob_controller() -> KnobController:
    """The process knob controller, wired from the environment: the
    actuator POSTs the front door's fleet ``/knobs`` when
    ``PIO_KNOBS_URL`` names it (``PIO_KNOBS_KEY`` authes it), else
    writes this process's own env (single-process deployments); the
    capacity guard engages when the measured fit exposes knob
    ceilings."""
    global _knob_controller
    with _knob_lock:
        if _knob_controller is None:
            url = os.environ.get("PIO_KNOBS_URL", "").strip()
            if not url and knobs_mode() == "act":
                # a forgotten URL in act mode silently tunes ONE
                # process while the fleet serves the old vector —
                # loud here, and visible in stats() actuators.scope
                logger.warning(
                    "PIO_KNOBS=act with PIO_KNOBS_URL unset: the "
                    "knob actuator writes only THIS process's env; "
                    "no fleet worker will see adjustments. Set "
                    "PIO_KNOBS_URL to the front door's /knobs for "
                    "multi-worker deployments.")
            cap_fn = capacity_caps_fn()
            if cap_fn() is None:
                # inert guard reported honestly as absent (stats()'
                # actuators.capacityGuard must mean "can veto")
                cap_fn = None
            _knob_controller = KnobController(
                apply_fn=(http_knobs_fn(
                    url, os.environ.get("PIO_KNOBS_KEY") or None)
                    if url else local_knobs_fn()),
                capacity_fn=cap_fn,
                apply_scope="fleet" if url else "local",
            )
        return _knob_controller


def reset_knob_controller() -> None:
    """Drop (and stop) the process knob controller — tests re-read the
    PIO_KNOBS_* env on next use."""
    global _knob_controller
    with _knob_lock:
        if _knob_controller is not None:
            _knob_controller.stop(timeout=2.0)
        _knob_controller = None


def peek_knob_decisions(limit: int = 256) -> List[Dict[str, Any]]:
    """The knob decision ring WITHOUT creating a controller — the
    incident capture's ``knobs_fn`` default (obs/recorder.py): a bundle
    frozen on a process that never ran the knob loop records an empty
    audit trail rather than instantiating one as a side effect."""
    with _knob_lock:
        c = _knob_controller
    return c.decisions(limit=limit) if c is not None else []


__all__ = [
    "ACTION_REASONS", "INPUT_SERIES", "KNOB_ENV_VARS", "KnobConfig",
    "KnobController", "KnobSpec", "MODES", "SKIP_REASONS",
    "capacity_caps_fn", "default_knobs", "get_knob_controller",
    "http_knobs_fn", "knobs_mode", "local_knobs_fn",
    "peek_knob_decisions", "reset_knob_controller",
]
