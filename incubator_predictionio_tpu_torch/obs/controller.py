"""Self-driving freshness — the SLO-burn-driven retrain/reload controller.

The port's own copy of incubator_predictionio_tpu/obs/controller.py, its
imports pointed at this package. Its retrain actuator
(:func:`workflow_retrain_fn`) runs the port's ``CoreWorkflow.run_train``,
which launches the fused and R-row ALS kernels on the card; its reload
actuator (:func:`http_reload_fn`) drives the front door's rolling
``POST /reload``, where each worker warms the new model on its card
(score+top-k) before the swap. Its capacity guard
(:func:`capacity_budget_fn`) fits only records measured on an NVIDIA
card (obs/capacity.py ``card_records``).

The reference PredictionIO makes model freshness a human operation: an
operator watches predictions go stale, re-runs ``pio train``, re-runs
``pio deploy``. This stack already measures everything that operator
looks at — the SLO burn-rate engine (obs/slo.py), fleet federation
(obs/federate.py), the staleness gauge, the speed layer's cursor lag —
and the front door (serving/frontdoor.py) already choreographs a
zero-downtime rolling hot swap. This module closes the loop:

- a background loop (hosted by the admin server) consumes the fleet (or
  process) ``/slo`` evaluation plus the raw ``pio_model_staleness_
  seconds`` / ``pio_speed_cursor_lag_events`` gauges through the same
  Registry-shaped protocol the burn engine uses;
- it **projects error-budget exhaustion**: burn-based time-to-empty
  from the fast/slow windows, plus the staleness gauge's direct
  headroom (staleness grows one second per second, so
  ``threshold − max_staleness`` IS the time left before the bound);
- on a projected (or actual) breach it triggers a continuation retrain
  (``CoreWorkflow.run_train`` — the ``prev_models`` continuation seam)
  followed by a rolling fleet hot swap through the front door's
  ``POST /reload`` choreography — with **hysteresis** (consecutive
  breached evaluations required), a **cooldown** after every action so
  it never flaps, a capacity **budget guard** (obs/capacity.py's
  measured rows/chip/s fit says whether a retrain can even finish
  inside the projected budget — when it can't, capacity, not
  freshness, is the binding constraint), a **dry-run mode** and a
  **kill switch** (``PIO_CONTROLLER=off|observe|act``, flippable live
  via ``POST /controller`` on the admin server).

The observability core: every evaluation emits a structured **decision
record** — inputs snapshot, projection math, action, outcome,
rejection reason — under its **own trace ID**. Actuation runs inside
that trace context, so the in-repo HTTP hops it causes (the front
door's ``/reload``, each worker's reload behind it, any storage RPCs
the retrain makes) forward ``X-PIO-Trace-Id``/``X-PIO-Parent-Span``
and ``scripts/trace_stitch.py --decisions`` reconstructs "burn spike →
decision → retrain → rolling swap → staleness recovered" as one tree.
``GET /controller`` serves the bounded decision ring + current state.

Exported series (docs/observability.md):

- ``pio_controller_evaluations_total``
- ``pio_controller_actions_total{reason}`` (reason = the trigger)
- ``pio_controller_skips_total{reason}`` (reason = why it held fire)
- ``pio_controller_state`` (0 off, 1 observe, 2 act)
- ``pio_controller_budget_projection_seconds`` (projected seconds to
  error-budget exhaustion; the staleness headroom when nothing burns)

Lint contract (``unaudited-actuation``): every call into the retrain /
reload actuators from this module must happen inside the decision-
record emitter (:meth:`FreshnessController._actuate`) — an actuation
without a decision record is an unauditable mutation of the fleet.
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
from typing import Any, Callable, Dict, List, Optional

from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
from incubator_predictionio_tpu_torch.obs import trace as obs_trace
from incubator_predictionio_tpu_torch.utils import times

logger = logging.getLogger(__name__)

#: kill-switch modes, in escalation order
MODES = ("off", "observe", "act")

#: bounded reason enums — metric label values come from these sets only
#: (metric-label-cardinality contract)
SKIP_REASONS = ("off", "observe", "healthy", "no_data", "hysteresis",
                "cooldown", "budget", "no_actuator", "slo_error")
ACTION_REASONS = ("freshness_p95_burn", "staleness_burn",
                  "staleness_projection", "budget_projection")

_EVALUATIONS = obs_metrics.REGISTRY.counter(
    "pio_controller_evaluations_total",
    "freshness-controller evaluation passes (off-mode ticks excluded)")
_ACTIONS = obs_metrics.REGISTRY.counter(
    "pio_controller_actions_total",
    "autonomous retrain+reload actions by trigger reason",
    labels=("reason",))
_SKIPS = obs_metrics.REGISTRY.counter(
    "pio_controller_skips_total",
    "evaluations that did NOT actuate, by rejection reason",
    labels=("reason",))
_STATE = obs_metrics.REGISTRY.gauge(
    "pio_controller_state",
    "controller kill-switch state (0 off, 1 observe, 2 act)")
_PROJECTION = obs_metrics.REGISTRY.gauge(
    "pio_controller_budget_projection_seconds",
    "projected seconds until SLO error-budget exhaustion (min across "
    "the freshness/staleness drivers; staleness headroom when nothing "
    "is burning)")

#: the SLOs whose burn can justify a retrain. serve_p99 is consumed
#: into the inputs snapshot but never triggers: a retrain does not fix
#: serving latency, and acting on it would thrash the fleet for nothing
DRIVING_SLOS = ("freshness_p95", "staleness")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def controller_mode() -> str:
    """The env-declared kill-switch position (``PIO_CONTROLLER``),
    re-read per call so an operator can flip a live admin process via
    the environment too; POST /controller overrides it in-process."""
    raw = os.environ.get("PIO_CONTROLLER", "off").strip().lower()
    return raw if raw in MODES else "off"


@dataclasses.dataclass
class ControllerConfig:
    """Loop cadence + trigger policy. Every number has a
    ``PIO_CONTROLLER_*`` env default so the CLI admin server is
    configurable without code."""

    #: evaluation period — also the kill switch's reaction bound: a
    #: mode flip takes effect within one period
    interval_s: float = 30.0
    #: consecutive triggering evaluations required before acting (the
    #: hysteresis band — one noisy window must never retrain the fleet)
    breach_evals: int = 2
    #: wall after a completed action during which new triggers are
    #: skipped (reason="cooldown") — the anti-flap floor; it must
    #: comfortably exceed a retrain+swap wall
    cooldown_s: float = 600.0
    #: act when the projected budget-exhaustion / staleness headroom
    #: falls under this horizon (acting at zero headroom means the
    #: bound was already broken while the retrain runs)
    horizon_s: float = 900.0
    #: decision-record ring bound
    ring: int = 256

    @staticmethod
    def from_env() -> "ControllerConfig":
        return ControllerConfig(
            interval_s=_env_float("PIO_CONTROLLER_INTERVAL_S", 30.0),
            breach_evals=int(_env_float("PIO_CONTROLLER_HYSTERESIS", 2)),
            cooldown_s=_env_float("PIO_CONTROLLER_COOLDOWN_S", 600.0),
            horizon_s=_env_float("PIO_CONTROLLER_HORIZON_S", 900.0),
            ring=int(_env_float("PIO_CONTROLLER_RING", 256)),
        )


# ---------------------------------------------------------------------------
# actuator factories
# ---------------------------------------------------------------------------
#
# The controller never hard-codes HOW to retrain or reload — it takes
# two callables. These factories build the production pair. Their
# closures run only from inside the decision-record emitter
# (_actuate); the unaudited-actuation lint rule documents the *_fn
# naming convention as the sanctioned construction site.

def workflow_retrain_fn(engine: Any, engine_params: Any,
                        **run_train_kwargs: Any) -> Callable[[], str]:
    """Actuator that runs a CONTINUATION retrain through the core
    workflow: ``CoreWorkflow.run_train`` loads the previous COMPLETED
    instance's models as the ``prev_models`` seed (O(delta) splice +
    early-stop — ops/retrain.py), so the autonomous retrain pays the
    steady-state wall, not the cold one. Returns the new engine
    instance id."""

    def retrain() -> str:
        from incubator_predictionio_tpu_torch.workflow.workflow import (
            CoreWorkflow,
        )

        return CoreWorkflow.run_train(engine, engine_params,
                                      **run_train_kwargs)

    return retrain


def http_reload_fn(url: str, server_key: Optional[str] = None,
                   timeout_s: float = 600.0) -> Callable[[], Dict]:
    """Actuator that POSTs the front door's ``/reload`` (the rolling
    drain → warm-before-swap → re-admit choreography,
    serving/frontdoor.py). The request carries the ambient trace
    headers, so the rolling swap's spans — front door and every worker
    behind it — land under the controller's decision trace."""
    if "://" not in url:
        url = f"http://{url}"
    if server_key:
        from urllib.parse import quote

        url = f"{url}?accessKey={quote(server_key, safe='')}"

    def reload() -> Dict:
        req = urllib.request.Request(
            url, data=b"", method="POST",
            headers=dict(obs_trace.client_headers()))
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return json.loads(resp.read().decode("utf-8"))

    return reload


def capacity_budget_fn(rows: Optional[float] = None,
                       repo_dir: str = ".") -> Callable[
                           [], Optional[float]]:
    """Budget guard from the measured capacity fit (obs/capacity.py,
    ALX-style sizing): estimated continuation-retrain wall =
    rows / rows_per_chip_per_s over the newest non-degraded record
    measured on an NVIDIA card (``capacity.card_records``: the repo's
    TPU records never size the card). The fit is computed once at factory time (the trajectory is
    static per process); returns None — no guard — when the row count
    or the fit is unknown, because a fabricated wall would veto real
    retrains."""
    if rows is None:
        rows = _env_float("PIO_CONTROLLER_ROWS", 0.0) or None
    rate: Optional[float] = None
    if rows:
        try:
            from incubator_predictionio_tpu_torch.obs import capacity

            fit = capacity.fit_capacity(capacity.card_records(
                capacity.load_trajectory(repo_dir)))
            rate = fit.get("rows_per_chip_per_s")
        except Exception:
            logger.exception("capacity fit unavailable; controller "
                             "budget guard disabled")

    def estimate() -> Optional[float]:
        if rows and rate:
            return float(rows) / float(rate)
        return None

    return estimate


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

class FreshnessController:
    """The burn-driven freshness loop. One instance per admin process;
    every evaluation appends a decision record, every actuation runs
    inside the decision's trace context."""

    def __init__(self,
                 engine: Optional[Any] = None,
                 retrain_fn: Optional[Callable[[], Any]] = None,
                 reload_fn: Optional[Callable[[], Any]] = None,
                 capacity_fn: Optional[Callable[[], Optional[float]]]
                 = None,
                 config: Optional[ControllerConfig] = None,
                 clock: Optional[Callable[[], float]] = None,
                 mode: Optional[str] = None) -> None:
        self.config = config or ControllerConfig.from_env()
        self._clock = clock if clock is not None else times.monotonic
        self._engine = engine          # lazy-resolved when None
        self._retrain_fn = retrain_fn
        self._reload_fn = reload_fn
        self._capacity_fn = capacity_fn
        self._mode_override: Optional[str] = mode
        self._lock = threading.Lock()
        self._ring: "deque[Dict[str, Any]]" = deque(
            maxlen=max(int(self.config.ring), 1))
        self._streak = 0               # consecutive triggering evals
        self._cooldown_until = 0.0
        self._seq = 0
        self._actions = 0
        self._last_action: Optional[Dict[str, Any]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- mode (the kill switch) ---------------------------------------------
    @property
    def mode(self) -> str:
        with self._lock:
            return self._mode_override or controller_mode()

    def set_mode(self, mode: str) -> str:
        """Live flip (POST /controller). Takes effect at the next
        evaluation — within one ``interval_s`` for the running loop.
        The flip itself lands in the decision ring: a kill switch whose
        use leaves no audit trail is half a kill switch."""
        mode = (mode or "").strip().lower()
        if mode not in MODES:
            raise ValueError(
                f"mode must be one of {MODES}, got {mode!r}")
        with self._lock:
            # inline (not the property): self._lock is not reentrant
            prev = self._mode_override or controller_mode()
            self._mode_override = mode
            self._seq += 1
            self._ring.append({
                "id": self._seq,
                "ts": round(time.time(), 3),
                "kind": "mode_change",
                "from": prev,
                "to": mode,
            })
        _STATE.set(float(MODES.index(mode)))
        logger.info("freshness controller mode: %s -> %s", prev, mode)
        return mode

    # -- signal resolution --------------------------------------------------
    def _resolve_engine(self) -> Any:
        """Default signal source: the fleet SLO engine when
        ``PIO_FLEET_TARGETS`` names a fleet, else this process's own
        burn engine — same objectives, same math either way."""
        if self._engine is None:
            from incubator_predictionio_tpu_torch.obs import federate
            from incubator_predictionio_tpu_torch.obs import slo as obs_slo

            if os.environ.get("PIO_FLEET_TARGETS", "").strip():
                self._engine = federate.fleet_slo_engine()
            else:
                self._engine = obs_slo.get_engine()
        return self._engine

    def _gauge_reading(self, registry: Any, name: str) -> Optional[float]:
        """Worst-of (max) reading of a gauge family — over children in
        process mode, over instances AND children through the federated
        registry. None = no data."""
        try:
            m = registry.get(name)
        except Exception:
            return None
        if m is None or m.kind != "gauge" or not m.has_samples():
            return None
        return float(m.max_value())

    # -- projection math ----------------------------------------------------
    def _project(self, engine: Any, slos: List[Dict],
                 staleness_max: Optional[float]) -> Dict[str, Any]:
        """Error-budget exhaustion projection.

        Burn-based: a budget with fraction R remaining over the slow
        window W, burning at the FAST window's rate B, empties in
        ``W · R / B`` seconds (B ≤ 0 means it is refilling — no
        exhaustion). Staleness additionally projects directly: the
        gauge grows one second per second, so ``threshold − value`` is
        the exact headroom before the bound — this is what lets the
        controller act BEFORE the gauge SLO ever records a bad tick."""
        slow_w = float(getattr(engine, "slow_window_s", 3600.0))
        burn_exhaust: Optional[float] = None
        for s in slos:
            if s["name"] not in DRIVING_SLOS or s["noData"]:
                continue
            fast = float(s["windows"]["fast"]["burnRate"])
            remaining = float(s["errorBudgetRemaining"])
            if fast > 0.0:
                t = slow_w * remaining / fast
                if burn_exhaust is None or t < burn_exhaust:
                    burn_exhaust = t
        headroom: Optional[float] = None
        threshold = None
        for s in slos:
            if s["name"] == "staleness":
                threshold = float(s["objective"]["thresholdSeconds"])
        if threshold is not None and staleness_max is not None:
            headroom = max(threshold - staleness_max, 0.0)
        candidates = [t for t in (burn_exhaust, headroom)
                      if t is not None]
        projection = min(candidates) if candidates else None
        return {
            "slowWindowS": slow_w,
            "burnExhaustS": (round(burn_exhaust, 3)
                             if burn_exhaust is not None else None),
            "stalenessHeadroomS": (round(headroom, 3)
                                   if headroom is not None else None),
            "stalenessThresholdS": threshold,
            "projectionS": (round(projection, 3)
                            if projection is not None else None),
            "horizonS": self.config.horizon_s,
        }

    # -- one evaluation -----------------------------------------------------
    def evaluate_once(self) -> Optional[Dict[str, Any]]:
        """One controller pass: consume signals, project, decide,
        possibly actuate. Returns the appended decision record (None
        only in off mode — the kill switch halts evaluation entirely,
        so a disabled controller costs the fleet zero scrapes)."""
        mode = self.mode
        _STATE.set(float(MODES.index(mode)))
        if mode == "off":
            return None
        _EVALUATIONS.inc()
        now = self._clock()
        with self._lock:
            self._seq += 1
            decision: Dict[str, Any] = {
                "id": self._seq,
                "traceId": f"ctl-{secrets.token_hex(6)}",
                "ts": round(time.time(), 3),
                "kind": "evaluation",
                "mode": mode,
                "inputs": None,
                "projection": None,
                "action": "none",
                "reason": None,
                "outcome": None,
                # pre-seeded so _actuate's fill-in replaces values
                # without resizing a dict a concurrent GET /controller
                # may be rendering
                "spanId": None,
            }

        try:
            engine = self._resolve_engine()
            registry = engine.registry
            if hasattr(registry, "run_collectors"):
                # collector-fed gauges (model staleness, queue depth)
                # are normally refreshed at scrape time; the controller
                # reads BETWEEN scrapes, so refresh them itself (the
                # federated registry refreshes by re-scraping instead)
                registry.run_collectors()
            slos = engine.evaluate()
        except Exception as e:  # fleet down ≠ controller crash
            logger.warning("controller signal read failed: %s", e)
            decision["reason"] = "slo_error"
            decision["error"] = str(e)
            _SKIPS.labels(reason="slo_error").inc()
            # a blind evaluation breaks the CONSECUTIVE-breach chain
            # (hysteresis must never count across a gap it could not
            # see), and the projection gauge goes honestly no-data
            # instead of freezing at its last pre-outage value
            with self._lock:
                self._streak = 0
            _PROJECTION.set(float("nan"))
            self._append(decision)
            return decision

        staleness_max = self._gauge_reading(
            registry, "pio_model_staleness_seconds")
        cursor_lag = self._gauge_reading(
            registry, "pio_speed_cursor_lag_events")
        decision["inputs"] = {
            "slos": {
                s["name"]: {
                    "noData": s["noData"],
                    "fastBurn": s["windows"]["fast"]["burnRate"],
                    "slowBurn": s["windows"]["slow"]["burnRate"],
                    "budgetRemaining": s["errorBudgetRemaining"],
                } for s in slos
            },
            "stalenessMaxS": staleness_max,
            "cursorLagEvents": cursor_lag,
        }
        projection = self._project(engine, slos, staleness_max)
        decision["projection"] = projection
        # NaN when nothing projects (no driving signal): a frozen
        # last-known headroom on a dashboard would read as live health
        _PROJECTION.set(projection["projectionS"]
                        if projection["projectionS"] is not None
                        else float("nan"))

        # -- trigger rule ---------------------------------------------------
        trigger: Optional[str] = None
        driving = [s for s in slos if s["name"] in DRIVING_SLOS]
        for s in driving:
            if not s["noData"] and \
                    float(s["windows"]["fast"]["burnRate"]) > 1.0:
                trigger = f"{s['name']}_burn"
                break
        if trigger is None and projection["projectionS"] is not None \
                and projection["projectionS"] <= self.config.horizon_s:
            trigger = ("staleness_projection"
                       if projection["stalenessHeadroomS"] is not None
                       and projection["stalenessHeadroomS"]
                       == projection["projectionS"]
                       else "budget_projection")
        if all(s["noData"] for s in driving) and trigger is None:
            decision["reason"] = "no_data"
            _SKIPS.labels(reason="no_data").inc()
            with self._lock:
                self._streak = 0
            self._append(decision)
            return decision
        if trigger is None:
            decision["reason"] = "healthy"
            _SKIPS.labels(reason="healthy").inc()
            with self._lock:
                self._streak = 0
            self._append(decision)
            return decision

        # -- hysteresis / cooldown / budget / mode gates --------------------
        decision["trigger"] = trigger
        with self._lock:
            self._streak += 1
            streak = self._streak
        decision["streak"] = streak
        if streak < self.config.breach_evals:
            decision["reason"] = "hysteresis"
            _SKIPS.labels(reason="hysteresis").inc()
            self._append(decision)
            return decision
        with self._lock:
            cooldown_until = self._cooldown_until
        if now < cooldown_until:
            decision["reason"] = "cooldown"
            decision["cooldownRemainingS"] = round(
                cooldown_until - now, 3)
            _SKIPS.labels(reason="cooldown").inc()
            self._append(decision)
            return decision
        retrain_wall = None
        if self._capacity_fn is not None:
            try:
                retrain_wall = self._capacity_fn()
            except Exception:
                logger.exception("controller capacity guard failed "
                                 "(treated as no guard)")
        projection["retrainWallEstS"] = (
            round(retrain_wall, 3) if retrain_wall is not None else None)
        if retrain_wall is not None \
                and projection["projectionS"] is not None \
                and retrain_wall > projection["projectionS"]:
            # the measured capacity fit says a retrain cannot complete
            # before the budget empties: capacity, not freshness, is
            # the binding constraint (runbook: add chips, the
            # controller cannot retrain its way out)
            decision["reason"] = "budget"
            _SKIPS.labels(reason="budget").inc()
            self._append(decision)
            return decision
        if mode == "observe":
            decision["action"] = "retrain+reload"
            decision["reason"] = "observe"
            decision["outcome"] = {"actuated": False,
                                   "dryRun": True}
            _SKIPS.labels(reason="observe").inc()
            self._append(decision)
            return decision
        if self._retrain_fn is None and self._reload_fn is None:
            decision["reason"] = "no_actuator"
            _SKIPS.labels(reason="no_actuator").inc()
            self._append(decision)
            return decision

        # -- act ------------------------------------------------------------
        decision["action"] = "retrain+reload"
        decision["reason"] = trigger
        # the record lands in the ring BEFORE actuation (marked
        # in-flight) and is updated in place on completion: a retrain
        # takes minutes, and the runbook's "the ring IS the answer"
        # promise must hold for the operator watching GET /controller
        # exactly while the action runs
        decision["outcome"] = {"actuated": True, "inFlight": True}
        _ACTIONS.labels(reason=trigger).inc()
        with self._lock:
            self._actions += 1
            self._last_action = decision
        self._append(decision)
        self._actuate(decision)
        # cooldown counts from actuation COMPLETION: a long retrain
        # must not eat its own cooldown
        with self._lock:
            self._streak = 0
            self._cooldown_until = self._clock() + self.config.cooldown_s
        return decision

    # -- the decision-record emitter (the ONE sanctioned actuation site) ----
    def _actuate(self, decision: Dict[str, Any]) -> None:
        """Run retrain → rolling reload inside the decision's trace
        context and write the outcome into the record. Every in-repo
        HTTP hop below (front-door /reload, worker reloads, storage
        RPCs) forwards the decision's trace ID, so the stitcher joins
        the whole actuation under this decision span. The
        unaudited-actuation lint rule pins that actuator calls happen
        here and nowhere else in this module."""
        span_id = obs_trace.new_span_id()
        decision["spanId"] = span_id
        token = obs_trace.set_current(decision["traceId"])
        span_token = obs_trace.set_current_span(span_id)
        t0 = time.perf_counter()
        outcome: Dict[str, Any] = {"actuated": True}
        try:
            if self._retrain_fn is not None:
                t_r = time.perf_counter()
                try:
                    instance = self._retrain_fn()
                    outcome["retrain"] = {
                        "ok": True,
                        "instance": (str(instance)
                                     if instance is not None else None),
                        "wallS": round(time.perf_counter() - t_r, 3),
                    }
                    obs_trace.log_stage_span(
                        "controller.retrain", decision["traceId"],
                        time.perf_counter() - t_r,
                        spanId=obs_trace.new_span_id(),
                        parentSpanId=span_id,
                        decisionId=decision["id"],
                        instance=outcome["retrain"]["instance"])
                except Exception as e:
                    logger.exception("controller retrain failed")
                    outcome["retrain"] = {
                        "ok": False,
                        "error": str(e),
                        "wallS": round(time.perf_counter() - t_r, 3),
                    }
                    # a failed retrain leaves the OLD model serving —
                    # swapping nothing is the safe degradation, so the
                    # reload is skipped rather than hot-swapping a
                    # model that never materialized
                    outcome["reload"] = {"ok": False,
                                         "skipped": "retrain_failed"}
                    return
            if self._reload_fn is not None:
                t_w = time.perf_counter()
                try:
                    result = self._reload_fn()
                    outcome["reload"] = {
                        "ok": True,
                        "result": result,
                        "wallS": round(time.perf_counter() - t_w, 3),
                    }
                    obs_trace.log_stage_span(
                        "controller.reload", decision["traceId"],
                        time.perf_counter() - t_w,
                        spanId=obs_trace.new_span_id(),
                        parentSpanId=span_id,
                        decisionId=decision["id"])
                except Exception as e:
                    logger.exception("controller rolling reload failed")
                    outcome["reload"] = {
                        "ok": False,
                        "error": str(e),
                        "wallS": round(time.perf_counter() - t_w, 3),
                    }
        finally:
            outcome["wallS"] = round(time.perf_counter() - t0, 3)
            decision["outcome"] = outcome
            # the decision ROOT span, emitted after actuation so its
            # duration covers the whole retrain+swap
            obs_trace.log_stage_span(
                "controller.decision", decision["traceId"],
                time.perf_counter() - t0,
                spanId=span_id,
                decisionId=decision["id"],
                action=decision["action"],
                reason=decision["reason"])
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

    def stats(self) -> Dict[str, Any]:
        now = self._clock()
        with self._lock:
            return {
                # inline (not the property): self._lock is not reentrant
                "mode": self._mode_override or controller_mode(),
                "running": self._thread is not None
                and self._thread.is_alive(),
                "intervalS": self.config.interval_s,
                "breachEvals": self.config.breach_evals,
                "cooldownS": self.config.cooldown_s,
                "horizonS": self.config.horizon_s,
                "streak": self._streak,
                "cooldownRemainingS": round(
                    max(self._cooldown_until - now, 0.0), 3),
                "actions": self._actions,
                "decisionsRecorded": self._seq,
                "lastAction": self._last_action,
                "actuators": {
                    "retrain": self._retrain_fn is not None,
                    "reload": self._reload_fn is not None,
                    "capacityGuard": self._capacity_fn is not None,
                },
            }

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        """Start the background loop (idempotent). The loop runs in
        EVERY mode — an off controller just idles its tick — so a live
        ``POST /controller`` flip to act resumes actuation within one
        interval, no restart required.

        Each loop generation owns its OWN stop event (captured at
        spawn): a stop() whose join timed out on a long in-flight
        actuation leaves the old thread holding a permanently-set
        event, so a later start() can never resurrect it into a second
        concurrent loop — the old thread exits the moment its
        actuation returns."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive() \
                    and not self._stop.is_set():
                return
            stop = threading.Event()
            self._stop = stop
            self._thread = threading.Thread(
                target=self._loop, args=(stop,),
                # not the JAX package's thread name: a process that
                # runs both packages (their tests) tells the loops apart
                name="pio-torch-freshness-controller", daemon=True)
            self._thread.start()

    def _loop(self, stop: threading.Event) -> None:
        while not stop.is_set():
            try:
                self.evaluate_once()
            except Exception:
                logger.exception("controller evaluation failed")
            stop.wait(self.config.interval_s)

    def stop(self, timeout: float = 10.0) -> None:
        with self._lock:
            stop = self._stop
            t = self._thread
        stop.set()
        if t is not None:
            t.join(timeout=timeout)
            if t.is_alive():
                # mid-actuation past the join budget: its set event
                # ends it after the in-flight action; leave the handle
                # so start() spawns a FRESH generation rather than
                # clearing this one's event back to life
                return
        with self._lock:
            if self._thread is t:
                self._thread = None


# ---------------------------------------------------------------------------
# process-wide controller (the admin server's instance; tests reset)
# ---------------------------------------------------------------------------

_controller: Optional[FreshnessController] = None
_controller_lock = threading.Lock()


def get_controller() -> FreshnessController:
    """The process controller, wired from the environment: signals
    resolve fleet-first (``PIO_FLEET_TARGETS``), the reload actuator
    comes from ``PIO_CONTROLLER_RELOAD_URL`` (the front door's
    ``/reload``; ``PIO_CONTROLLER_RELOAD_KEY`` authes it), and the
    budget guard engages when ``PIO_CONTROLLER_ROWS`` names the
    training-set scale the capacity fit should project. A retrain
    actuator needs an engine object, so the CLI admin process runs
    reload-only unless an embedder wires :func:`workflow_retrain_fn`
    in programmatically."""
    global _controller
    with _controller_lock:
        if _controller is None:
            reload_url = os.environ.get(
                "PIO_CONTROLLER_RELOAD_URL", "").strip()
            # an inert guard (no rows declared / no usable fit — the
            # closure is deterministic, so one probe decides) is passed
            # as None: GET /controller's actuators.capacityGuard must
            # report whether the guard can actually veto, not whether
            # a callable exists
            cap_fn = capacity_budget_fn()
            if cap_fn() is None:
                cap_fn = None
            _controller = FreshnessController(
                reload_fn=(http_reload_fn(
                    reload_url,
                    os.environ.get("PIO_CONTROLLER_RELOAD_KEY")
                    or None) if reload_url else None),
                capacity_fn=cap_fn,
            )
        return _controller


def reset_controller() -> None:
    """Drop (and stop) the process controller — tests re-read the
    PIO_CONTROLLER_* env on next use."""
    global _controller
    with _controller_lock:
        if _controller is not None:
            _controller.stop(timeout=2.0)
        _controller = None


def peek_decisions(limit: int = 256) -> List[Dict[str, Any]]:
    """The decision ring WITHOUT creating a controller — the incident
    capture's export seam (obs/recorder.py): a bundle frozen on a
    process that never ran a controller records an empty audit trail
    rather than instantiating one as a side effect. An embedder that
    wired a custom controller (the admin server's injected instance)
    points the capture at it via :func:`export_ring_fn`."""
    with _controller_lock:
        c = _controller
    return c.decisions(limit=limit) if c is not None else []


def export_ring_fn(controller: "FreshnessController",
                   limit: int = 256) -> Callable[[], List[Dict[str, Any]]]:
    """Bind one controller's decision ring as an incident-capture
    ``decisions_fn`` (the admin server wires its hosted — possibly
    injected — controller through this). Duck-typed on
    ``decisions(limit=)``, so the same binder also exports the knob
    controller's ring (obs/knobs.KnobController) as the capture's
    ``knobs_fn`` — the two control loops share one audit machinery."""

    def export() -> List[Dict[str, Any]]:
        return controller.decisions(limit=limit)

    return export


__all__ = [
    "ACTION_REASONS", "ControllerConfig", "DRIVING_SLOS",
    "FreshnessController", "MODES", "SKIP_REASONS",
    "capacity_budget_fn", "controller_mode", "export_ring_fn",
    "get_controller", "http_reload_fn", "peek_decisions",
    "reset_controller", "workflow_retrain_fn",
]
