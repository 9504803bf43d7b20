"""Continuous-batching serving scheduler — the socket→kernel request plane.

The port's own copy of incubator_predictionio_tpu/serving/scheduler.py,
its imports pointed at this package. Concurrent ``POST /queries.json``
traffic lands here, and each dispatch is ONE ``handle_batch`` call: on
the ALS template, one ``ops/topk.batch_score_top_k`` call, one launch of
the hand-written score+top-k kernel (``csrc/score_topk.cu``) for the
whole batch padded to the next power of two. The JAX package's XLA
compile cache has no counterpart (a CUDA kernel takes any B);
``pio_serve_compile_cache_size`` reads the count of distinct padded
``(B, k)`` dispatch shapes that ``ops/topk`` keeps, which a warm ladder
holds flat. ``apply_knobs`` is called by the prediction server's
``POST /knobs``, where the knob controller's fan-out lands (obs/knobs.py):
the new rung cap sets the width of the next score+top-k launch. The
flight recorder
reads :meth:`BatchScheduler.snapshot` through
``obs/recorder.register_state_provider`` into its dumps and incident
bundles, and each dispatch re-installs one member's trace id, so the
latency histogram's exemplars name a real query of the batch.

- **Admission queues, per engine.** Every in-flight query lands in its
  engine's FIFO queue (one engine's burst never pads another's
  batches), and dispatcher threads drain whole batches into ONE
  ``handle_batch`` call, which pads to the pow2 ladder the deploy-time
  warm-up walked.

- **Queue-depth-adaptive batch width.** Each queue carries a pow2
  *rung*: the batch width the next dispatch drains. Deeper queue than
  the rung → grow to the next ladder rung (up to :func:`ladder_cap`);
  queue at half the rung or less → collapse one rung. Idle traffic
  serves at rung 1 with zero added latency; a burst walks up the ladder
  in log2 steps and walks back down when it passes
  (:func:`plan_dispatch` is the pure decision rule the tests drive).

- **Age bound** (``PIO_SERVE_MAX_WAIT_MS``): a query must never wait
  past the bound just because the rung is small — when the oldest
  queued request's age crosses it, the dispatch takes the whole backlog
  (up to the cap) regardless of the rung. This is the starvation fix
  for the old batcher, where a request arriving behind a full batch
  could wait multiple full dispatch cycles.

- **Load shedding** against the declared ``serve_p99`` objective
  (obs/slo.py): at admission, the projected completion time — queue
  depth over the rung, times the EWMA dispatch wall, plus the live p99
  estimate from ``pio_query_latency_seconds`` — is compared to the SLO
  threshold. A request that cannot make it sheds with 503 +
  ``Retry-After`` (:class:`ShedError`) instead of poisoning the p99 for
  everyone admitted behind it; a higher-priority arrival evicts the
  lowest-priority queued request rather than shedding itself. Sheds
  book ``pio_serve_shed_total{tenant,reason}``.

- **Tenant isolation** (serving/tenancy.py). Queues
  are keyed ``(tenant, engine)``; dispatch is WEIGHTED-FAIR across
  tenants (lowest virtual service — dispatched queries over weight —
  goes next, FIFO within a tenant), replacing oldest-head-across-
  queues, which a flooding tenant would monopolize. Per-tenant
  admission QUOTAS bound a tenant's total backlog (shed reason
  ``quota``); the shed projection reads the TENANT's own queue and the
  TENANT's own live p99, so a noisy neighbor's backlog never sheds a
  victim's traffic; and priority eviction is cross-tenant but
  restricted to tenants AT OR OVER their weighted fair share of the
  backlog — an under-share (victim) tenant's queued requests are never
  evicted on an aggressor's behalf.

Exported series: ``pio_serve_batch_size`` (pow2 buckets — the fused
width distribution, the fleet bench's ``fleet_batch_p50`` source),
``pio_serve_queue_wait_seconds``,
``pio_serve_shed_total{tenant,reason}`` (tenant values come from the
bounded registry — the ``unscoped-tenant-metric`` lint contract).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import inspect
import math
import os
import threading
import weakref
from collections import OrderedDict, deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
from incubator_predictionio_tpu_torch.obs import recorder as obs_recorder
from incubator_predictionio_tpu_torch.obs import trace as obs_trace
from incubator_predictionio_tpu_torch.serving import tenancy
from incubator_predictionio_tpu_torch.utils import times
from incubator_predictionio_tpu_torch.utils.http import HttpError

#: fused batch width per dispatch, on pow2 buckets matching the ladder
#: the padded dispatches use (1..8192 covers any sane cap)
_BATCH_SIZE = obs_metrics.REGISTRY.histogram(
    "pio_serve_batch_size",
    "queries fused into one scheduler dispatch (pow2 ladder buckets)",
    buckets=tuple(float(1 << i) for i in range(14)))
_QUEUE_WAIT = obs_metrics.REGISTRY.histogram(
    "pio_serve_queue_wait_seconds",
    "admission-queue wait before a query's batch dispatched")
_SHED = obs_metrics.REGISTRY.counter(
    "pio_serve_shed_total",
    "requests shed by the scheduler, by tenant and reason (overload = "
    "projected past the serve_p99 objective; quota = the tenant's "
    "admission quota was full; evicted = displaced by a higher-"
    "priority arrival; shutdown = scheduler stopping)",
    labels=("tenant", "reason"))
_COMPILE_CACHE = obs_metrics.REGISTRY.gauge(
    "pio_serve_compile_cache_size",
    "distinct padded serving-dispatch shapes seen (ops/topk ladder) — "
    "flat in steady state, the warm-ladder contract's counter")


def _collect_compile_cache() -> None:
    # scrape-time: only report when the serving ops were actually
    # imported — never drag torch into a process that scrapes but does
    # not serve (the event server shares this registry module)
    import sys as _sys

    mod = _sys.modules.get("incubator_predictionio_tpu_torch.ops.topk")
    if mod is not None:
        _COMPILE_CACHE.set(float(mod.serve_compile_cache_size()))


obs_metrics.REGISTRY.register_collector("serve_compile_cache",
                                        _collect_compile_cache)


def next_pow2(n: int) -> int:
    """Smallest power of two ≥ n (≥1) — the ladder's rung spacing, the
    same policy ``ops/topk.next_pow2`` pads dispatch shapes with."""
    return 1 << max(int(n) - 1, 0).bit_length()


def ladder_cap() -> int:
    """Largest batch width the scheduler may fuse (pow2-rounded).

    ``PIO_SERVE_MAX_BATCH`` is the LADDER CAP, not a fixed batch size:
    dispatches use the adaptive rung and only reach the cap under
    sustained queue pressure (docs/production.md "Serving fleet")."""
    try:
        n = int(os.environ.get("PIO_SERVE_MAX_BATCH", "512"))
    except ValueError:
        n = 512
    return next_pow2(max(n, 1))


def max_wait_s() -> float:
    """Age bound: no admitted query waits longer than this for its
    dispatch just because the rung is small (``PIO_SERVE_MAX_WAIT_MS``,
    default 250 ms; ≤0 disables the bound)."""
    try:
        ms = float(os.environ.get("PIO_SERVE_MAX_WAIT_MS", "250"))
    except ValueError:
        ms = 250.0
    return ms / 1000.0


def serve_objective_s() -> float:
    """The serve_p99 SLO threshold the shed projection tests against —
    read from the SAME declared objective the burn-rate engine
    evaluates (obs/slo.py, ``PIO_SLO_SERVE_P99_S``), so shedding and
    the SLO can never disagree about the promise."""
    from incubator_predictionio_tpu_torch.obs import slo as obs_slo

    for spec in obs_slo.default_specs():
        if spec.name == "serve_p99":
            return float(spec.threshold)
    return 0.25


def shed_enabled() -> bool:
    return os.environ.get("PIO_SERVE_SHED", "1").lower() not in (
        "0", "off", "false")


class ShedError(HttpError):
    """503 with a Retry-After contract: the scheduler projected this
    request past the serve_p99 objective. Clients back off for
    ``retry_after_s`` and retry; the header rides the error response
    (utils/http.py forwards ``HttpError.headers``)."""

    def __init__(self, retry_after_s: float, reason: str = "overload"):
        retry = max(int(math.ceil(retry_after_s)), 1)
        super().__init__(
            503,
            "Serving overloaded: request projected past the latency "
            f"objective; retry after {retry}s.")
        self.headers = {"Retry-After": str(retry)}
        self.reason = reason
        self.retry_after_s = retry


def plan_dispatch(depth: int, rung: int, oldest_age_s: float,
                  cap: int, wait_bound_s: float) -> Tuple[int, int]:
    """The pure dispatch decision: ``(take, next_rung)``.

    - take ``min(depth, rung)`` normally; the WHOLE backlog (up to
      ``cap``) when the oldest waiter's age crossed the bound — the
      scheduler never holds a query past ``PIO_SERVE_MAX_WAIT_MS``.
    - grow the rung one ladder step when the queue outran it, collapse
      one step when the queue sits at half the rung or less; steady
      traffic keeps its rung (hysteresis band (rung/2, rung]).
    """
    depth = max(int(depth), 0)
    rung = min(max(int(rung), 1), cap)
    if depth == 0:
        return 0, rung
    if wait_bound_s > 0 and oldest_age_s >= wait_bound_s:
        take = min(depth, cap)
    else:
        take = min(depth, rung)
    if depth > rung:
        rung = min(rung * 2, cap)
    elif 2 * depth <= rung:
        rung = max(rung // 2, 1)
    return take, rung


@dataclasses.dataclass
class _Pending:
    body: Any
    fut: "concurrent.futures.Future"
    t_enq: float
    priority: int
    #: the submitting request's ambient trace ID (None outside a
    #: request) — the dispatch loop re-installs ONE member's trace
    #: around handle_batch so the latency histogram's exemplar
    #: reservoir (obs/metrics.py) can name a concrete query for the
    #: batch's shared wall
    trace_id: Optional[str] = None


class _EngineQueue:
    """One engine's admission queue + its ladder/latency state."""

    __slots__ = ("items", "rung", "ewma_wall", "in_flight")

    def __init__(self) -> None:
        self.items: Deque[_Pending] = deque()
        self.rung = 1
        #: EWMA of one dispatch's wall — the shed projection's cycle
        #: cost. 0.0 until the first dispatch lands (never shed on a
        #: cold queue: there is no evidence of overload yet).
        self.ewma_wall = 0.0
        self.in_flight = 0

    def note_wall(self, wall: float) -> None:
        self.ewma_wall = (wall if self.ewma_wall == 0.0
                          else 0.7 * self.ewma_wall + 0.3 * wall)

    def projected_wait_s(self, cap: int) -> float:
        """Queue wait a NEW arrival would see: full dispatch cycles
        ahead of it plus the in-flight dispatch, each at the EWMA wall.

        The cycle width is the rung THIS depth will drive the ladder
        to — not the current rung: a burst against a cold (rung-1)
        queue is exactly what adaptive batching absorbs, and
        projecting it as depth-many singleton dispatches would shed
        the load the ladder was about to fuse (a metastable shed
        spiral: shedding holds the queue short, the rung never grows,
        the projection never recovers)."""
        if self.ewma_wall <= 0.0:
            return 0.0
        depth = len(self.items) + 1
        width = min(max(self.rung, next_pow2(depth)), cap)
        cycles = math.ceil(depth / width)
        return (cycles + (1 if self.in_flight else 0)) * self.ewma_wall


class BatchScheduler:
    """Continuous-batching scheduler over one ``handle_batch`` callable.

    ``handle_batch(bodies) -> results`` serves a whole batch in one
    device dispatch (results list aligned with bodies; an Exception
    entry fails just that member). A two-parameter handler —
    ``handle_batch(bodies, engine)`` — additionally receives the queue
    key, for multi-engine hosts; a three-parameter handler —
    ``handle_batch(bodies, engine, tenant)`` — also receives the
    tenant, for multi-deploy hosts (servers/prediction_server.py routes
    each tenant's batch to its own deploy). Construction-time signature
    stays compatible with the old ``_MicroBatcher(handle, max_batch,
    workers=…)``; ``max_batch`` is now the LADDER CAP the adaptive rung
    grows toward, not the fixed fuse width.
    """

    def __init__(
        self,
        handle_batch: Callable[..., List[Any]],
        max_batch: Optional[int] = None,
        workers: int = 1,
        *,
        clock: Optional[Callable[[], float]] = None,
        wait_bound_s: Optional[float] = None,
        slo_s: Optional[float] = None,
        p99_fn: Optional[Callable[..., Optional[float]]] = None,
        shed: Optional[bool] = None,
        tenant_weights: Optional[Dict[str, int]] = None,
        tenant_quotas: Optional[Dict[str, Optional[int]]] = None,
    ) -> None:
        self._handle_batch = handle_batch
        try:
            params = [
                p for p in inspect.signature(handle_batch).parameters
                .values()
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                and p.default is p.empty  # a defaulted slot is NOT an
                # engine parameter (closure-style wrappers default-bind)
            ]
            self._pass_engine = len(params) >= 2
            self._pass_tenant = len(params) >= 3
        except (TypeError, ValueError):
            self._pass_engine = False
            self._pass_tenant = False
        self.cap = (ladder_cap() if max_batch is None
                    else next_pow2(max(int(max_batch), 1)))
        #: compat: old callers read ``max_batch`` as the fuse bound
        self.max_batch = self.cap
        self._clock = clock if clock is not None else times.monotonic
        self.wait_bound_s = (max_wait_s() if wait_bound_s is None
                             else float(wait_bound_s))
        self.slo_s = serve_objective_s() if slo_s is None else float(slo_s)
        self._p99_fn = p99_fn
        # a one-parameter p99 feed is per-tenant (the live latency
        # estimate must slice the tenant's own child — a flooding
        # neighbor's fat tail must not shed a healthy tenant's traffic)
        self._p99_per_tenant = False
        if p99_fn is not None:
            try:
                p99_params = [
                    p for p in inspect.signature(p99_fn).parameters
                    .values()
                    if p.kind in (p.POSITIONAL_ONLY,
                                  p.POSITIONAL_OR_KEYWORD)
                    and p.default is p.empty
                ]
                self._p99_per_tenant = len(p99_params) >= 1
            except (TypeError, ValueError):
                self._p99_per_tenant = False
        self._shed = shed_enabled() if shed is None else bool(shed)
        self._cv = threading.Condition()
        #: queues keyed (tenant, engine) — one tenant's engines fuse
        #: independently AND one tenant's flood stays its own problem
        self._queues: "OrderedDict[Tuple[str, str], _EngineQueue]" = \
            OrderedDict()
        #: weighted-fair dispatch state: per-tenant NORMALIZED virtual
        #: service (queries dispatched / weight) — the non-empty tenant
        #: with the lowest value goes next
        self._service: Dict[str, float] = {}
        self._tenant_weights: Dict[str, int] = dict(tenant_weights or {})
        self._tenant_quotas: Dict[str, Optional[int]] = dict(
            tenant_quotas or {})
        #: per-tenant last-admission clock — a tenant that submitted
        #: within CONTEND_WINDOW_S is "contending" and the weighted
        #: dispatch-slot caps bind (see _slot_caps_locked)
        self._t_last_submit: Dict[str, float] = {}
        self._stopped = False
        self.shed_count = 0
        self.shed_by_tenant: Dict[str, int] = {}
        self._n_workers = max(int(workers), 1)
        self._threads = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"pio-serve-sched-{i}")
            for i in range(self._n_workers)
        ]
        for t in self._threads:
            t.start()
        # the flight recorder's state-snapshot seam: incident bundles
        # freeze this scheduler's queue/rung/shed state alongside the
        # metric window. Weakref-bound with named replace semantics so
        # a hot-swapped server's new scheduler takes over the slot and
        # the old one can be collected (the registry-collector idiom).
        ref = weakref.ref(self)

        def _snapshot_provider():
            sched = ref()
            return sched.snapshot() if sched is not None else None

        obs_recorder.register_state_provider("scheduler",
                                             _snapshot_provider)

    # -- tenant helpers (call under self._cv) -------------------------------
    def _weight(self, tenant: str) -> int:
        return max(int(self._tenant_weights.get(tenant, 1)), 1)

    def _tenant_depth_locked(self, tenant: str) -> int:
        return sum(len(q.items) for (t, _e), q in self._queues.items()
                   if t == tenant)

    def _fair_share_tenants_locked(self) -> "set":
        """Tenants AT OR OVER their weighted fair share of the queued
        backlog — the only legal eviction victims. With one active
        tenant the share test is an equality, so single-tenant priority
        eviction behaves exactly as before tenancy existed."""
        queued: Dict[str, int] = {}
        for (t, _e), q in self._queues.items():
            if q.items:
                queued[t] = queued.get(t, 0) + len(q.items)
        total = sum(queued.values())
        total_weight = sum(self._weight(t) for t in queued)
        return {
            t for t, n in queued.items()
            if n * total_weight >= self._weight(t) * total
        }

    def _tenant_inflight_locked(self, tenant: str) -> int:
        return sum(q.in_flight for (t, _e), q in self._queues.items()
                   if t == tenant)

    #: a tenant that admitted a query this recently still counts as
    #: contending for dispatch slots even if its queue is momentarily
    #: empty — the whole point of the slot reservation is the NEXT
    #: arrival of a light tenant, which by definition is not queued yet
    CONTEND_WINDOW_S = 5.0

    def _slot_caps_locked(self, now: float) -> Optional[Dict[str, int]]:
        """Per-tenant caps on CONCURRENT dispatch slots, or None (no
        caps). When ≥2 tenants are contending (submitted within
        CONTEND_WINDOW_S, or still backlogged) and the scheduler runs
        ≥2 dispatcher threads, each tenant's slots are bounded by its
        weighted share ``ceil(workers * w / total_w)`` of the thread
        pool: a low-weight flooder that would otherwise keep EVERY
        thread inside its own floor-length dispatches is pinned below
        the wall, so a light tenant's arrival never waits a full
        in-flight dispatch. The caps are deliberately NOT
        work-conserving while contention lasts — the reserved slot is
        the isolation — but a tenant alone on the scheduler (no recent
        traffic from anyone else) is never capped, so single-tenant
        throughput is untouched."""
        if self._n_workers < 2:
            return None
        contending = {t for t, ts in self._t_last_submit.items()
                      if now - ts <= self.CONTEND_WINDOW_S}
        contending |= {t for (t, _e), q in self._queues.items()
                      if q.items}
        if len(contending) < 2:
            return None
        total_w = sum(self._weight(t) for t in contending)
        return {
            t: max(1, math.ceil(
                self._n_workers * self._weight(t) / total_w))
            for t in contending
        }

    def set_tenant_policy(
            self, weights: Optional[Dict[str, int]] = None,
            quotas: Optional[Dict[str, Optional[int]]] = None) -> None:
        """Adopt a tenant registry's isolation policy live (the server
        calls this after a registry (re)parse — weights steer the
        weighted-fair pick, quotas bound admissions)."""
        with self._cv:
            if weights is not None:
                self._tenant_weights = dict(weights)
            if quotas is not None:
                self._tenant_quotas = dict(quotas)

    # -- admission ----------------------------------------------------------
    def submit(self, body: Any, priority: int = 0,
               engine: str = "default",
               tenant: str = tenancy.DEFAULT_TENANT,
               ) -> "concurrent.futures.Future":
        """Enqueue one query body → Future of its result. ``priority``
        orders only the SHED decision (higher survives longer), never
        dispatch order — admitted requests stay FIFO so no admitted
        query starves behind a later high-priority one. The shed
        projection reads only THIS tenant's queue and p99, and eviction
        victims come only from at-or-over-fair-share tenants: a noisy
        neighbor sheds its own traffic, never a victim's."""
        fut: "concurrent.futures.Future" = concurrent.futures.Future()
        now = self._clock()
        shed_exc: Optional[ShedError] = None
        victim: Optional[_Pending] = None
        victim_tenant = tenant
        with self._cv:
            if self._stopped:
                fut.set_exception(
                    HttpError(503, "Server is shutting down."))
                return fut
            key = (tenant, engine)
            self._t_last_submit[tenant] = now
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = _EngineQueue()
            tenant_depth = self._tenant_depth_locked(tenant)
            quota = self._tenant_quotas.get(tenant)
            if quota is not None and tenant_depth >= int(quota):
                # the tenant's OWN admission bound — enforced even with
                # SLO shedding off, and never answered by eviction: a
                # quota is the tenant displacing itself, not others
                shed_exc = ShedError(
                    max(q.projected_wait_s(self.cap), 1.0),
                    reason="quota")
            elif self._shed and q.items:
                projected = q.projected_wait_s(self.cap)
                if self._p99_fn is None:
                    p99 = None
                elif self._p99_per_tenant:
                    p99 = self._p99_fn(tenant)
                else:
                    p99 = self._p99_fn()
                if projected > 0 and \
                        projected + float(p99 or 0.0) > self.slo_s:
                    eligible = self._fair_share_tenants_locked()
                    lowest: Optional[_Pending] = None
                    lowest_key: Optional[Tuple[str, str]] = None
                    for (t, e), cand in self._queues.items():
                        if t not in eligible or not cand.items:
                            continue
                        head = min(cand.items, key=lambda p: p.priority)
                        if lowest is None or \
                                (head.priority, head.t_enq) < \
                                (lowest.priority, lowest.t_enq):
                            lowest, lowest_key = head, (t, e)
                    if lowest is not None and lowest.priority < priority:
                        # evict the lowest-priority waiter in favor of
                        # this higher-priority arrival — fleet QoS: paid
                        # traffic rides through an overload
                        self._queues[lowest_key].items.remove(lowest)
                        victim = lowest
                        victim_tenant = lowest_key[0]
                    else:
                        shed_exc = ShedError(projected, reason="overload")
            if shed_exc is None:
                if tenant_depth == 0:
                    # empty→non-empty catch-up: an idle tenant must not
                    # bank service credit and then burst ahead of
                    # steadily-queued tenants
                    active = [self._service.get(t, 0.0)
                              for (t, _e), aq in self._queues.items()
                              if aq.items and t != tenant]
                    floor = min(active) if active else 0.0
                    self._service[tenant] = max(
                        self._service.get(tenant, 0.0), floor)
                q.items.append(_Pending(body, fut, now, int(priority),
                                        obs_trace.current_trace_id()))
                self._cv.notify()
            retry_hint = q.projected_wait_s(self.cap)
            # counted under the lock: submit runs on the HTTP thread
            # pool, and a bare += from two shedding threads can lose
            # an increment (the /status figure must track the counter)
            if victim is not None or shed_exc is not None:
                self.shed_count += 1
                shed_t = victim_tenant if victim is not None else tenant
                self.shed_by_tenant[shed_t] = \
                    self.shed_by_tenant.get(shed_t, 0) + 1
        if victim is not None:
            _SHED.labels(tenant=tenancy.get_registry().label(victim_tenant),
                         reason="evicted").inc()
            victim.fut.set_exception(
                ShedError(retry_hint, reason="evicted"))
        if shed_exc is not None:
            _SHED.labels(tenant=tenancy.get_registry().label(tenant),
                         reason=shed_exc.reason).inc()
            fut.set_exception(shed_exc)
        return fut

    # -- introspection ------------------------------------------------------
    @staticmethod
    def _engine_key(tenant: str, engine: str) -> str:
        """Status/snapshot queue name: bare ``engine`` for the default
        tenant (pre-tenancy readers keep their key), ``tenant/engine``
        otherwise."""
        return (engine if tenant == tenancy.DEFAULT_TENANT
                else f"{tenant}/{engine}")

    def depth(self, engine: Optional[str] = None,
              tenant: Optional[str] = None) -> int:
        with self._cv:
            return sum(
                len(q.items) for (t, e), q in self._queues.items()
                if (engine is None or e == engine)
                and (tenant is None or t == tenant))

    def depths_by_tenant(self) -> Dict[str, int]:
        """Queued admissions per tenant — the tenant-labeled
        ``pio_serve_queue_depth`` collector's feed.

        Deliberately lock-free: the flight recorder runs registry
        collectors at sampling Hz off its own thread, and taking the
        dispatch cv for an advisory depth snapshot contends with the
        serving hot path (it measurably moved the recorder-overhead
        p99 pin). ``len(deque)`` is GIL-atomic, a racy read only
        mis-states a depth by the in-flight delta, and the walk
        retries if an admission resizes the queue registry mid-walk.
        """
        while True:
            out: Dict[str, int] = {}
            try:
                # advisory scrape-time snapshot, racy by contract
                # (see docstring for why no lock)
                # pio-lint: disable=unguarded-shared-state
                for (t, _e), q in list(self._queues.items()):
                    out[t] = out.get(t, 0) + len(q.items)
                return out
            except RuntimeError:
                continue

    def rung(self, engine: str = "default",
             tenant: str = tenancy.DEFAULT_TENANT) -> int:
        with self._cv:
            q = self._queues.get((tenant, engine))
            return q.rung if q is not None else 1

    def stats(self) -> Dict[str, Any]:
        """Per-engine scheduler state for /status and the tests. The
        ``knobs`` block is the worker's announcement that it honors
        ``POST /knobs`` live refreshes (obs/knobs.py): the knob
        controller's front-door fan-out reads it to confirm support,
        and it carries the values currently in force. The ``tenants``
        block answers "which tenant is hurting" in one read."""
        with self._cv:
            return {
                "cap": self.cap,
                "shed": self.shed_count,
                "knobs": {
                    "supported": True,
                    "waitBoundS": self.wait_bound_s,
                    "sloS": self.slo_s,
                    "shedEnabled": self._shed,
                },
                "engines": {
                    self._engine_key(t, e): {
                        "depth": len(q.items), "rung": q.rung,
                        "ewmaWallS": round(q.ewma_wall, 6)}
                    for (t, e), q in self._queues.items()
                },
                "tenants": self._tenants_block_locked(),
            }

    def _tenants_block_locked(self) -> Dict[str, Any]:
        tenants = set(self._tenant_weights) | set(self._tenant_quotas) \
            | {t for (t, _e) in self._queues} | set(self.shed_by_tenant)
        block: Dict[str, Any] = {}
        for t in sorted(tenants):
            block[t] = {
                "depth": self._tenant_depth_locked(t),
                "shed": self.shed_by_tenant.get(t, 0),
                "weight": self._weight(t),
                "quota": self._tenant_quotas.get(t),
            }
        return block

    def snapshot(self) -> Dict[str, Any]:
        """The incident-capture state block: :meth:`stats` plus the
        admission policy and each queue's oldest-waiter age — what an
        operator needs to read a frozen bundle without the process."""
        now = self._clock()
        with self._cv:
            out: Dict[str, Any] = {
                "cap": self.cap,
                "shed": self.shed_count,
                "waitBoundS": self.wait_bound_s,
                "sloS": self.slo_s,
                "shedEnabled": self._shed,
                "stopped": self._stopped,
                "engines": {},
                "tenants": self._tenants_block_locked(),
            }
            for (t, e), q in self._queues.items():
                out["engines"][self._engine_key(t, e)] = {
                    "depth": len(q.items),
                    "rung": q.rung,
                    "ewmaWallS": round(q.ewma_wall, 6),
                    "inFlight": q.in_flight,
                    "oldestAgeS": (round(now - q.items[0].t_enq, 4)
                                   if q.items else None),
                }
            return out

    def apply_knobs(self) -> Dict[str, Any]:
        """Re-read the env-declared knobs captured at construction —
        the ladder cap, the wait bound, the serve objective, the shed
        toggle — and adopt them live. This is the worker-side half of
        the audited knob seam: only the ``POST /knobs`` route
        (servers/prediction_server.py) calls it, right after the knob
        controller's fan-out rewrites the env, so a running scheduler
        takes a new vector without restart. Rungs are clamped into the
        new cap; a shrunken cap therefore takes effect on the very next
        dispatch plan."""
        with self._cv:
            self.cap = ladder_cap()
            self.max_batch = self.cap
            self.wait_bound_s = max_wait_s()
            self.slo_s = serve_objective_s()
            self._shed = shed_enabled()
            for q in self._queues.values():
                q.rung = min(max(q.rung, 1), self.cap)
            return {
                "cap": self.cap,
                "waitBoundS": self.wait_bound_s,
                "sloS": self.slo_s,
                "shedEnabled": self._shed,
            }

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()

    # -- dispatch loop ------------------------------------------------------
    def _pick_locked(self) -> Optional[Tuple[Tuple[str, str],
                                             _EngineQueue]]:
        """Weighted-fair across tenants, FIFO within one.

        Pick the non-empty tenant with the LOWEST virtual FINISH time
        for its head (normalized service — queries dispatched over
        weight — plus one head's worth of service, 1/weight), then that
        tenant's oldest head across its engines — so a flooding tenant
        advances its own service counter and yields the device back at
        its weight share, instead of monopolizing oldest-head order.
        The finish-time term breaks the post-catch-up tie in favor of
        the heavier tenant: a light high-weight tenant whose service
        was just floored to a flooder's pays one in-flight dispatch,
        not a full extra turn behind the flood. AGE BOUND OVERRIDE: a
        head that has waited past the wait bound is served first
        regardless of fairness — the no-query-waits-past-the-bound
        promise outranks the share schedule. SLOT CAPS: while ≥2
        tenants are contending, a tenant already holding its weighted
        share of dispatch slots is skipped entirely (even from the
        overdue override) so one thread stays free for the others —
        see _slot_caps_locked."""
        best: Optional[Tuple[Tuple[str, str], _EngineQueue]] = None
        overdue: Optional[Tuple[Tuple[str, str], _EngineQueue]] = None
        best_finish = 0.0
        now = self._clock()
        caps = self._slot_caps_locked(now)
        for key, q in self._queues.items():
            if not q.items:
                continue
            if caps is not None:
                cap = caps.get(key[0])
                if cap is not None and \
                        self._tenant_inflight_locked(key[0]) >= cap:
                    continue
            head_t = q.items[0].t_enq
            if self.wait_bound_s > 0 and now - head_t >= self.wait_bound_s:
                if overdue is None or head_t < overdue[1].items[0].t_enq:
                    overdue = (key, q)
            finish = (self._service.get(key[0], 0.0)
                      + 1.0 / self._weight(key[0]))
            if best is None or (finish, head_t) < \
                    (best_finish, best[1].items[0].t_enq):
                best = (key, q)
                best_finish = finish
        return overdue if overdue is not None else best

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._stopped and self._pick_locked() is None:
                    self._cv.wait(0.5)
                picked = self._pick_locked()
                if picked is None:
                    if self._stopped:
                        return
                    continue
                (tenant, engine), q = picked
                now = self._clock()
                oldest_age = now - q.items[0].t_enq
                take, q.rung = plan_dispatch(
                    len(q.items), q.rung, oldest_age, self.cap,
                    self.wait_bound_s)
                batch = [q.items.popleft() for _ in range(take)]
                q.in_flight += 1
                self._service[tenant] = self._service.get(tenant, 0.0) \
                    + take / self._weight(tenant)
            t0 = self._clock()
            for p in batch:
                _QUEUE_WAIT.observe(max(t0 - p.t_enq, 0.0))
            _BATCH_SIZE.observe(float(len(batch)))
            # exemplar seam: the dispatcher thread has no request
            # context, so re-install the OLDEST traced member's trace
            # ID for the duration of the dispatch — every histogram
            # observation the batch handler books (the per-query
            # latency histogram above all) can then carry a concrete
            # trace exemplar naming one real query of this batch
            ex_trace = next((p.trace_id for p in batch
                             if p.trace_id is not None), None)
            token = (obs_trace.set_current(ex_trace)
                     if ex_trace is not None else None)
            try:
                if self._pass_tenant:
                    results = self._handle_batch(
                        [p.body for p in batch], engine, tenant)
                elif self._pass_engine:
                    results = self._handle_batch(
                        [p.body for p in batch], engine)
                else:
                    results = self._handle_batch([p.body for p in batch])
            except Exception as exc:  # catastrophic: fail the whole batch
                results = [exc] * len(batch)
            finally:
                if token is not None:
                    obs_trace.reset_current(token)
            wall = self._clock() - t0
            with self._cv:
                q.note_wall(wall)
                q.in_flight -= 1
                # a slot-capped tenant just freed a slot: wake the idle
                # dispatcher the cap reserved, or it stalls a cv.wait
                self._cv.notify()
            for p, res in zip(batch, results):
                if isinstance(res, Exception):
                    p.fut.set_exception(res)
                else:
                    p.fut.set_result(res)
