"""Fleet front door — one address, health-checked routing, zero-downtime
rolling reload.

The port's own copy of incubator_predictionio_tpu/serving/frontdoor.py,
its imports pointed at this package. One part differs: :meth:`FrontDoor.stop`
closes the door's pooled keep-alive connections to the workers, which the
JAX package's leaves open, so that a worker stopped after the door (``pio
undeploy``) is not held by them. The door itself touches no device:
every query it places runs the worker's score+top-k kernel, and every
worker reload it choreographs warms the new model on the worker's card
before the swap. This module is the serving control plane in front of N
prediction workers (``pio deploy`` processes):

- **Queue-depth-aware placement.** Each worker's score is the front
  door's own in-flight count plus the worker's last reported scheduler
  backlog — piggybacked on every ``/queries.json`` response as
  ``X-PIO-Queue-Depth`` (servers/prediction_server.py) and refreshed by
  the probe loop from ``GET /`` between requests. Ties break
  least-recently-picked, so an idle fleet round-robins.

- **Per-worker health state machine.** Passive failure counting
  (transport errors and timeouts — never HTTP responses: a worker that
  ANSWERS is alive) plus active probes. ``eject_failures`` consecutive
  failures open the circuit; after a cooldown the prober sends a
  half-open trial and re-admits on success, doubling the cooldown on
  failure. A shedding worker is NOT ejected — its 503 + ``Retry-After``
  is the scheduler's overload contract (serving/scheduler.py ShedError)
  and passes through to the client verbatim; ejecting it would shift
  the same overload onto its peers (shed ≠ unhealthy).

- **Bounded single retry, hedging budgeted.** An idempotent query that
  dies in transport retries ONCE on a different worker, inside the
  request's overall deadline, and only while the retry token bucket —
  refilled by a fraction of successful requests — has budget. The
  budget caps retry amplification: when the whole fleet is failing,
  retries stop instead of doubling the offered load the scheduler is
  already shedding.

- **Rolling fleet-wide reload with connection draining.** One worker at
  a time: placement stops (DRAINING), in-flight requests finish,
  ``POST /reload`` runs the worker's own double-buffered warm-before-
  swap (the overlay's ``adopt_keys`` mechanism rides it), and the
  worker is re-admitted only after a live probe confirms it answers —
  so a fleet-wide model swap drops zero queries. Draining never starts
  while no OTHER healthy worker exists (bounded wait), so a
  degraded fleet reloads serially rather than going dark.

- **Elastic join.** Workers announce their port only after every
  algorithm's warm-up ran at each ladder rung (``pio deploy`` prints
  ``deployed on`` once bound and warm), so ``POST /fleet/join``
  admits a worker that can serve its first placement at once.

Exported series: ``pio_frontdoor_requests_total{worker,outcome}``
(``outcome="unauthorized"`` = accessKey rejected at the door),
``pio_frontdoor_retries_total``, ``pio_frontdoor_worker_healthy{worker}``,
``pio_frontdoor_drain_seconds``, plus the client-observed
``pio_query_latency_seconds{tenant}`` — list the front door in
``PIO_FLEET_TARGETS`` and the fleet ``/slo`` serve_p99 objective
evaluates what clients actually saw through the door, not just
per-worker dispatch walls (docs/observability.md;
docs/production.md "Fleet front door").
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import threading
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple
from urllib.parse import quote, urlencode

from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
from incubator_predictionio_tpu_torch.obs import trace as obs_trace
from incubator_predictionio_tpu_torch.serving import tenancy
from incubator_predictionio_tpu_torch.utils import times
from incubator_predictionio_tpu_torch.utils.http import (
    HttpServer,
    Request,
    Response,
    Router,
)

logger = logging.getLogger(__name__)

#: per-worker outcome accounting. `worker` is BOUNDED: one label value
#: per fleet member (w0, w1, …, join-ordered), `outcome` is the enum
#: below — never a status code from the wire.
_REQUESTS = obs_metrics.REGISTRY.counter(
    "pio_frontdoor_requests_total",
    "front-door requests by worker and outcome (ok = 2xx/4xx "
    "passthrough; shed = worker 503 passthrough; upstream_error = "
    "worker 5xx passthrough; failed = transport failure not recovered; "
    "no_worker = no healthy worker to place on; unauthorized = query "
    "rejected at the door: unknown/disabled/missing accessKey while a "
    "tenant registry is configured)",
    labels=("worker", "outcome"))
_RETRIES = obs_metrics.REGISTRY.counter(
    "pio_frontdoor_retries_total",
    "transport-failed idempotent queries re-placed on another worker")
_HEALTHY = obs_metrics.REGISTRY.gauge(
    "pio_frontdoor_worker_healthy",
    "1 while the worker takes placements, 0 while ejected/draining",
    labels=("worker",))
_DRAIN_SECONDS = obs_metrics.REGISTRY.histogram(
    "pio_frontdoor_drain_seconds",
    "wall from placement stop to in-flight zero during a rolling reload")
#: the CLIENT-OBSERVED per-query wall: placement + worker roundtrip +
#: any retry, booked into the same family the workers book their batch
#: walls into — so a front door listed in PIO_FLEET_TARGETS makes the
#: fleet /slo serve_p99 objective evaluate what clients actually saw
#: (queueing at the door included), not just per-worker dispatch walls
#: TENANT-LABELED in lockstep with the workers' declaration of the same
#: family (servers/prediction_server.py — the shared registry raises on
#: a labelnames mismatch); values come only from the bounded registry
_FD_LATENCY = obs_metrics.REGISTRY.histogram(
    "pio_query_latency_seconds",
    "per-query serving wall (micro-batch members share the batch wall)",
    labels=("tenant",))

#: health states (module constants, not enum — they serialize into
#: /status JSON and tests compare strings)
HEALTHY = "healthy"
OPEN = "open"          # circuit open: ejected, cooling down
HALF_OPEN = "half_open"  # cooldown elapsed: probe decides
DRAINING = "draining"  # rolling reload: no new placements


@dataclasses.dataclass
class FrontDoorConfig:
    host: str = "127.0.0.1"
    port: int = 0
    #: consecutive TRANSPORT failures that open a worker's circuit
    eject_failures: int = 3
    #: first circuit-open cooldown; doubles per failed half-open probe
    open_cooldown_s: float = 2.0
    max_cooldown_s: float = 30.0
    #: active probe / depth-refresh cadence
    probe_interval_s: float = 1.0
    probe_timeout_s: float = 2.0
    #: overall per-request deadline (placement + attempts + the retry)
    request_timeout_s: float = 10.0
    #: per-attempt cap inside the deadline
    attempt_timeout_s: float = 5.0
    #: hedging budget: a retry costs one token; every successful
    #: request refills retry_refill tokens up to retry_budget tokens.
    #: At refill 0.1 the front door can amplify offered load by at most
    #: ~10% — bounded by construction, not by hope.
    retry_budget: float = 16.0
    retry_refill: float = 0.1
    #: rolling-reload choreography bounds
    drain_timeout_s: float = 30.0
    drain_capacity_wait_s: float = 30.0
    reload_timeout_s: float = 300.0
    #: idle keep-alive connections retained per worker (beyond the cap
    #: connections close after use instead of pooling)
    pool_size: int = 32
    #: authes the front door's own /reload + /fleet/* verbs AND is
    #: forwarded to each worker's /reload
    server_key: Optional[str] = None


class Worker:
    """One fleet member's routing state. All mutation happens on the
    front door's event loop (handlers + probe loop share it), so no
    lock; cross-thread readers (stats from the bench) see GIL-atomic
    snapshots of scalars."""

    __slots__ = ("name", "host", "port", "state", "fails", "open_until",
                 "cooldown_s", "in_flight", "depth", "requests",
                 "last_picked", "conns", "mips_tail", "mips_age_s")

    def __init__(self, name: str, host: str, port: int):
        self.name = name
        self.host = host
        self.port = port
        self.state = HEALTHY
        self.fails = 0
        self.open_until = 0.0
        self.cooldown_s = 0.0
        self.in_flight = 0
        self.depth = 0.0          # last reported pio_serve_queue_depth
        self.requests = 0         # successful placements (any response)
        self.last_picked = 0      # placement tie-break: LRU wins
        #: worker's MIPS lifecycle as of the last probe: virtual-id
        #: tail rows awaiting a daemon rebuild + oldest index age —
        #: the fleet-level "is churn outrunning the rebuild cadence"
        #: signal (docs/observability.md runbook)
        self.mips_tail = 0
        self.mips_age_s = 0.0
        #: idle keep-alive connections (reader, writer)
        self.conns: Deque[Tuple[asyncio.StreamReader,
                                asyncio.StreamWriter]] = deque()

    def load(self) -> float:
        return self.in_flight + max(self.depth, 0.0)

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "host": self.host, "port": self.port,
                "state": self.state, "inFlight": self.in_flight,
                "depth": self.depth, "requests": self.requests,
                "consecutiveFails": self.fails,
                "mipsTailVirtual": self.mips_tail,
                "mipsIndexAgeSec": self.mips_age_s}


class FrontDoor:
    """Async front-door router fanning one address across N workers."""

    def __init__(self, workers: Optional[List[Tuple[str, int]]] = None,
                 config: Optional[FrontDoorConfig] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.config = config or FrontDoorConfig()
        self._clock = clock if clock is not None else times.monotonic
        self.workers: List[Worker] = []
        self._next_worker_id = 0
        #: names freed by removals, reused by later joins — the metric
        #: `worker` label set stays bounded by the PEAK fleet size even
        #: under elastic kill-and-replace churn (the registry has no
        #: series removal; an ever-incrementing name would mint a new
        #: series per replacement — the cardinality class pio-lint's
        #: metric-label-cardinality rule exists to prevent)
        self._free_names: List[str] = []
        self._pick_seq = 0
        self._retry_tokens = self.config.retry_budget
        self.counts: Dict[str, int] = {
            "ok": 0, "shed": 0, "upstream_error": 0, "failed": 0,
            "no_worker": 0, "retries": 0, "unauthorized": 0}
        self._reload_lock = asyncio.Lock()
        self._stopping = False
        self.http = HttpServer(self._build_router(), self.config.host,
                               self.config.port, name="frontdoor")
        for host, port in workers or []:
            self._add_worker_locked(host, port)

    # -- membership ---------------------------------------------------------
    def _add_worker_locked(self, host: str, port: int) -> Worker:
        if self._free_names:
            name = self._free_names.pop()
        else:
            name = f"w{self._next_worker_id}"
            self._next_worker_id += 1
        w = Worker(name, host, port)
        self.workers.append(w)
        _HEALTHY.labels(worker=w.name).set(1.0)
        logger.info("front door: worker %s joined at %s:%d", w.name,
                    host, port)
        return w

    def add_worker(self, host: str, port: int) -> str:
        """Thread-safe join: membership mutates on the event loop when
        one is running (the serving path reads it there); before
        startup it mutates directly. The worker is admitted HEALTHY —
        fleet workers announce their port only after ladder warmup —
        and the probe loop ejects it if that promise was a lie."""
        loop = self.http._loop
        if loop is None or not loop.is_running():
            return self._add_worker_locked(host, port).name
        fut = asyncio.run_coroutine_threadsafe(
            self._add_worker_async(host, port), loop)
        return fut.result(timeout=10)

    async def _add_worker_async(self, host: str, port: int) -> str:
        return self._add_worker_locked(host, port).name

    def remove_worker(self, name: str) -> bool:
        loop = self.http._loop
        if loop is None or not loop.is_running():
            return self._remove_worker_locked(name)
        return asyncio.run_coroutine_threadsafe(
            self._remove_worker_async(name), loop).result(timeout=60)

    async def _remove_worker_async(self, name: str) -> bool:
        w = self._worker(name)
        if w is None:
            return False
        await self._drain(w)
        return self._remove_worker_locked(name)

    def _remove_worker_locked(self, name: str) -> bool:
        w = self._worker(name)
        if w is None:
            return False
        self.workers.remove(w)
        _HEALTHY.labels(worker=w.name).set(0.0)
        self._free_names.append(w.name)
        for reader, writer in w.conns:
            try:
                writer.close()
            except Exception:
                pass
        w.conns.clear()
        return True

    def _worker(self, name: str) -> Optional[Worker]:
        for w in self.workers:
            if w.name == name:
                return w
        return None

    # -- health state machine ----------------------------------------------
    def _note_success(self, w: Worker) -> None:
        w.fails = 0
        w.requests += 1
        self._retry_tokens = min(
            self._retry_tokens + self.config.retry_refill,
            self.config.retry_budget)

    def _note_failure(self, w: Worker) -> None:
        """Passive transport failure. Only movement HEALTHY → OPEN
        happens here; recovery is the prober's job."""
        w.fails += 1
        if w.state == HEALTHY and w.fails >= self.config.eject_failures:
            self._open_circuit(w)

    def _open_circuit(self, w: Worker) -> None:
        w.state = OPEN
        w.cooldown_s = (min(w.cooldown_s * 2, self.config.max_cooldown_s)
                        if w.cooldown_s > 0 else self.config.open_cooldown_s)
        w.open_until = self._clock() + w.cooldown_s
        _HEALTHY.labels(worker=w.name).set(0.0)
        # a dead worker's pooled connections are dead too
        for reader, writer in w.conns:
            try:
                writer.close()
            except Exception:
                pass
        w.conns.clear()
        logger.warning("front door: circuit OPEN for %s (%d consecutive "
                       "failures; retry in %.1fs)", w.name, w.fails,
                       w.cooldown_s)

    def _readmit(self, w: Worker) -> None:
        w.state = HEALTHY
        w.fails = 0
        w.cooldown_s = 0.0
        _HEALTHY.labels(worker=w.name).set(1.0)
        logger.info("front door: worker %s re-admitted", w.name)

    async def _probe_pass(self) -> None:
        """One probe cycle: half-open trials for cooled-down OPEN
        circuits, depth refresh for healthy-but-idle workers. Probes
        run CONCURRENTLY — serial probing would let one unreachable
        worker's timeout delay every peer's half-open re-admission by
        a whole probe_timeout_s per dead worker."""
        now = self._clock()

        async def one(w: Worker) -> None:
            if w.state == OPEN and now >= w.open_until:
                w.state = HALF_OPEN
            if w.state == HALF_OPEN:
                ok = await self._probe(w)
                if w.state != HALF_OPEN:
                    # a drain/remove raced the probe await — the reload
                    # choreography owns the state now; re-admitting
                    # here would resume placements mid-drain
                    return
                if ok:
                    self._readmit(w)
                else:
                    self._open_circuit(w)
            elif w.state == HEALTHY and w.in_flight == 0:
                # idle workers never piggyback a depth — refresh it
                # actively, and count a probe failure like a passive
                # one so a worker that died QUIETLY still ejects
                # instead of eating the next burst's first queries.
                # A probe SUCCESS clears the counter like a served
                # query does — the eject contract is CONSECUTIVE
                # failures, and isolated timeouts hours apart must
                # never accumulate into a spurious ejection.
                if await self._probe(w):
                    w.fails = 0
                else:
                    self._note_failure(w)

        await asyncio.gather(*(one(w) for w in list(self.workers)))

    async def _probe(self, w: Worker) -> bool:
        """GET / on the worker; refreshes the reported queue depth from
        the status page's scheduler block. True = the worker answers."""
        try:
            status, _hdrs, body = await self._roundtrip(
                w, "GET", "/", {}, b"", self.config.probe_timeout_s)
        except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError):
            return False
        if status != 200:
            return False
        try:
            info = json.loads(body)
            sched = info.get("scheduler") or {}
            w.depth = float(sum(
                e.get("depth", 0) for e in
                (sched.get("engines") or {}).values()))
        except (ValueError, AttributeError, TypeError):
            w.depth = 0.0
            return True
        try:
            indexes = (info.get("mips") or {}).get("indexes") or []
            w.mips_tail = int(sum(
                i.get("tailVirtual", 0) for i in indexes))
            w.mips_age_s = float(max(
                (i.get("ageSec", 0.0) for i in indexes), default=0.0))
        except (ValueError, AttributeError, TypeError):
            w.mips_tail, w.mips_age_s = 0, 0.0
        return True

    async def _probe_loop(self) -> None:
        while not self._stopping:
            try:
                await self._probe_pass()
            except Exception:
                logger.exception("front door probe pass failed")
            await asyncio.sleep(self.config.probe_interval_s)

    # -- placement ----------------------------------------------------------
    def _pick(self, exclude: Tuple[str, ...] = ()) -> Optional[Worker]:
        """Least-loaded healthy worker (front-door in-flight + reported
        scheduler backlog), ties to the least recently picked."""
        best: Optional[Worker] = None
        for w in self.workers:
            if w.state != HEALTHY or w.name in exclude:
                continue
            if best is None or (w.load(), w.last_picked) < (
                    best.load(), best.last_picked):
                best = w
        if best is not None:
            self._pick_seq += 1
            best.last_picked = self._pick_seq
        return best

    # -- transport ----------------------------------------------------------
    async def _checkout(self, w: Worker, timeout: float):
        while w.conns:
            reader, writer = w.conns.popleft()
            if not writer.is_closing():
                return reader, writer
            writer.close()
        return await asyncio.wait_for(
            asyncio.open_connection(w.host, w.port),
            min(self.config.probe_timeout_s, timeout))

    async def _roundtrip(self, w: Worker, method: str, path: str,
                         headers: Dict[str, str], body: bytes,
                         timeout: float
                         ) -> Tuple[int, Dict[str, str], bytes]:
        """One HTTP/1.1 request on a pooled keep-alive connection.
        ``timeout`` bounds the WHOLE roundtrip — connect, send, headers
        and body share one budget, so a worker that drips its response
        cannot stretch an attempt to a multiple of the cap. Transport
        failures close the connection and propagate — the caller
        classifies them (health, retry)."""
        t_end = self._clock() + timeout

        def remaining() -> float:
            return max(t_end - self._clock(), 0.01)

        reader, writer = await self._checkout(w, remaining())
        try:
            lines = [f"{method} {path} HTTP/1.1", f"Host: {w.host}"]
            for k, v in headers.items():
                lines.append(f"{k}: {v}")
            lines.append(f"Content-Length: {len(body)}")
            writer.write(("\r\n".join(lines) + "\r\n\r\n")
                         .encode("latin-1") + body)
            await asyncio.wait_for(writer.drain(), remaining())
            head = await asyncio.wait_for(
                reader.readuntil(b"\r\n\r\n"), remaining())
            head_lines = head.decode("latin-1").split("\r\n")
            try:
                status = int(head_lines[0].split(" ", 2)[1])
            except (IndexError, ValueError) as e:
                # not HTTP (a recycled port, a garbled banner): classify
                # as a TRANSPORT failure so the caller's health/retry
                # machinery engages instead of a raw exception leaking
                # a nonshed 500 to the client
                raise OSError(
                    f"malformed HTTP response from {w.name}: "
                    f"{head_lines[0]!r}") from e
            resp_headers: Dict[str, str] = {}
            for line in head_lines[1:]:
                name, _, value = line.partition(":")
                if _:
                    resp_headers[name.strip().lower()] = value.strip()
            try:
                clen = int(resp_headers.get("content-length", "0") or "0")
            except ValueError as e:
                raise OSError(
                    f"malformed Content-Length from {w.name}") from e
            resp_body = (await asyncio.wait_for(
                reader.readexactly(clen), remaining()) if clen else b"")
        except BaseException:
            writer.close()
            raise
        if resp_headers.get("connection", "keep-alive").lower() == "close" \
                or len(w.conns) >= self.config.pool_size:
            # bounded idle pool: a concurrency burst must not pin its
            # peak's worth of sockets per worker forever
            writer.close()
        else:
            w.conns.append((reader, writer))
        return status, resp_headers, resp_body

    # -- the request path ---------------------------------------------------
    async def handle_query(self, request: Request) -> Response:
        """Place /queries.json on a worker; bounded single retry to a
        DIFFERENT worker on transport failure (idempotent — a query
        reads model state), under the overall request deadline.

        Tenancy: the door authenticates the accessKey against the same
        bounded registry the workers read (serving/tenancy.py) and
        ROUTES by tenant only in its bookkeeping — placement and
        circuit state stay transport-scoped (a worker is healthy or
        not; which tenant a query belongs to never changes where it can
        run). The query string travels verbatim, so the worker re-
        authenticates the same key."""
        try:
            tenant = tenancy.get_registry().authenticate(request)
        except tenancy.TenantAuthError as e:
            self.counts["unauthorized"] += 1
            _REQUESTS.labels(worker="none", outcome="unauthorized").inc()
            return Response(401, {"message": e.message})
        return await self.forward(request, "/queries.json",
                                  tenant=tenant)

    async def forward(self, request: Request,
                      upstream_path: Optional[str] = None,
                      tenant: Optional[str] = None) -> Response:
        """Place one request on a worker under the full door
        discipline — least-loaded pick, circuit breaker, bounded
        token-bucket retry to a DIFFERENT worker, overall deadline.
        The client's query string travels verbatim (accessKey auth at
        the workers depends on it)."""
        t_start = self._clock()
        deadline = t_start + self.config.request_timeout_s
        path = upstream_path if upstream_path is not None else request.path
        if request.query:
            path += "?" + urlencode(request.query)
        fwd_headers = {"Content-Type": request.headers.get(
            "content-type", "application/json")}
        auth = request.headers.get("authorization")
        if auth is not None:
            # a tenant key sent via HTTP Basic lives in this header,
            # not the query string — the worker re-authenticates it
            fwd_headers["Authorization"] = auth
        prio = request.headers.get("x-pio-priority")
        if prio is not None:
            fwd_headers["X-PIO-Priority"] = prio
        # trace contract: the ambient trace ID (accepted or minted by
        # our own HTTP layer) plus THIS hop's span as the parent, so
        # worker span lines link under the front door's
        fwd_headers.update(obs_trace.client_headers())
        tried: Tuple[str, ...] = ()
        while True:
            w = self._pick(exclude=tried)
            if w is None:
                self.counts["no_worker"] += 1
                _REQUESTS.labels(worker="none", outcome="no_worker").inc()
                # no healthy capacity is an overload-class condition:
                # same 503 + Retry-After contract as a scheduler shed,
                # so well-behaved clients back off instead of hammering
                return Response(
                    503, {"message": "No healthy serving worker."},
                    headers={"Retry-After": "1"})
            timeout = min(self.config.attempt_timeout_s,
                          max(deadline - self._clock(), 0.05))
            w.in_flight += 1
            try:
                status, hdrs, body = await self._roundtrip(
                    w, request.method, path, fwd_headers,
                    request.body, timeout)
            except (OSError, asyncio.TimeoutError,
                    asyncio.IncompleteReadError) as e:
                self._note_failure(w)
                peer_exists = any(
                    o.state == HEALTHY and o.name != w.name
                    for o in self.workers)
                if (not tried and peer_exists
                        and self._retry_tokens >= 1.0
                        and self._clock() < deadline
                        and not self._stopping):
                    tried = (w.name,)
                    self._retry_tokens -= 1.0
                    self.counts["retries"] += 1
                    _RETRIES.inc()
                    logger.info("front door: retrying query on another "
                                "worker after %s failed (%r)", w.name, e)
                    continue
                self.counts["failed"] += 1
                _REQUESTS.labels(worker=w.name, outcome="failed").inc()
                return Response(
                    504 if isinstance(e, asyncio.TimeoutError) else 502,
                    {"message": f"upstream worker failed ({e!r})"})
            finally:
                w.in_flight -= 1
            # any HTTP response means the worker is alive
            self._note_success(w)
            depth = hdrs.get("x-pio-queue-depth")
            if depth is not None:
                try:
                    w.depth = float(depth)
                except ValueError:
                    pass
            if status == 503:
                # the scheduler's shed contract passes through verbatim
                # and is NOT a health event (shed ≠ unhealthy) — and
                # never retried: re-offering shed load to a peer would
                # amplify the very overload the fleet is shedding
                self.counts["shed"] += 1
                _REQUESTS.labels(worker=w.name, outcome="shed").inc()
            elif status >= 500:
                self.counts["upstream_error"] += 1
                _REQUESTS.labels(worker=w.name,
                                 outcome="upstream_error").inc()
            else:
                self.counts["ok"] += 1
                _REQUESTS.labels(worker=w.name, outcome="ok").inc()
                # served queries only: a shed answers in microseconds
                # and booking it would deflate the very p99 the shed
                # exists to protect (same rule as the workers, whose
                # scheduler books served batches only). The tenant
                # child comes from the bounded registry (lint contract)
                _FD_LATENCY.labels(
                    tenant=tenancy.get_registry().label(tenant)
                ).observe(max(self._clock() - t_start, 0.0))
            out_headers = {}
            for h in ("retry-after", "x-pio-queue-depth"):
                if h in hdrs:
                    out_headers[h.title()] = hdrs[h]
            return Response(
                status, body=body,
                content_type=hdrs.get("content-type",
                                      "application/json; charset=UTF-8"),
                headers=out_headers)

    # -- rolling reload -----------------------------------------------------
    async def _drain(self, w: Worker) -> int:
        """Stop placement, wait for in-flight zero → stuck count (0 on
        every healthy drain; >0 only past drain_timeout_s)."""
        t0 = self._clock()
        w.state = DRAINING
        _HEALTHY.labels(worker=w.name).set(0.0)
        while w.in_flight > 0 and \
                self._clock() - t0 < self.config.drain_timeout_s:
            await asyncio.sleep(0.02)
        _DRAIN_SECONDS.observe(max(self._clock() - t0, 0.0))
        return w.in_flight

    async def rolling_reload_async(
            self, tenant: Optional[str] = None) -> Dict[str, Any]:
        """Drain → /reload → verify-warm → re-admit, one worker at a
        time. The per-worker /reload is the existing double-buffered
        warm-before-swap (prediction_server.load_models) — the old
        model serves its drained peers' traffic until the new one is
        query-ready, so the fleet-wide swap drops zero queries.

        ``tenant`` scopes each worker's reload to ONE co-resident
        deploy (``/reload?tenant=X``): the other tenants' serving state
        is never swapped, and the drain/readmit choreography is the
        only cross-tenant effect (transport-scoped, as placement always
        is)."""
        async with self._reload_lock:
            out: Dict[str, Any] = {"workers": len(self.workers),
                                   "reloaded": 0, "dropped": 0,
                                   "failed": [], "drainS": [],
                                   "tenant": tenant}
            key = self.config.server_key
            qs = []
            if key:
                qs.append(f"accessKey={quote(key, safe='')}")
            if tenant:
                qs.append(f"tenant={quote(tenant, safe='')}")
            path = "/reload" + ("?" + "&".join(qs) if qs else "")
            # trace contract: a reload triggered by a traced request
            # (the freshness controller's POST /reload, an operator's
            # curl with a trace header) forwards its trace ID + this
            # hop's span to every worker reload — the decision →
            # rolling-swap tree scripts/trace_stitch.py --decisions
            # reconstructs. Captured once here: every worker's swap
            # belongs to the ONE choreography that caused it.
            reload_headers = dict(obs_trace.client_headers())
            for name in [w.name for w in list(self.workers)]:
                w = self._worker(name)
                if w is None or w.state not in (HEALTHY, HALF_OPEN):
                    out["failed"].append(name)
                    continue
                # never drain the LAST healthy worker: wait (bounded)
                # for a peer, and if none appears SKIP this worker —
                # a reload must degrade to "one worker still on the old
                # model" (re-run it later), never to a dark fleet
                t_wait = self._clock()
                while not any(o.state == HEALTHY for o in self.workers
                              if o is not w) and \
                        self._clock() - t_wait < \
                        self.config.drain_capacity_wait_s:
                    await asyncio.sleep(0.1)
                if not any(o.state == HEALTHY for o in self.workers
                           if o is not w):
                    logger.warning(
                        "front door: skipping reload of %s — no other "
                        "healthy worker to carry traffic", name)
                    out["failed"].append(name)
                    continue
                t0 = self._clock()
                stuck = await self._drain(w)
                out["dropped"] += stuck
                try:
                    status, _hdrs, _body = await self._roundtrip(
                        w, "POST", path, reload_headers, b"",
                        self.config.reload_timeout_s)
                except (OSError, asyncio.TimeoutError,
                        asyncio.IncompleteReadError) as e:
                    logger.warning("front door: reload of %s failed (%r)",
                                   name, e)
                    status = None
                # re-admit only when warm: /reload returns after the
                # new model's ladder warmed (warm-before-swap), and a
                # live probe confirms the serving plane answers
                if status == 200 and await self._probe(w):
                    self._readmit(w)
                    out["reloaded"] += 1
                    out["drainS"].append(round(self._clock() - t0, 3))
                else:
                    self._open_circuit(w)
                    out["failed"].append(name)
            return out

    # -- fleet knob fan-out -------------------------------------------------
    async def knobs_fanout_async(self, body: bytes) -> Dict[str, Any]:
        """Fan the knob controller's vector (obs/knobs.py) to every
        worker's ``POST /knobs``, one at a time under the rolling-
        reload serialization (the same ``_reload_lock`` — a vector
        landing mid-swap would leave half the fleet on each setting).
        Unlike a reload, no drain is needed: every registered knob is a
        call-time env read, so a worker applies the vector between two
        dispatches without dropping a query. Trace headers are captured
        once so every worker hop lands under the ONE decision span that
        caused the fan-out."""
        async with self._reload_lock:
            out: Dict[str, Any] = {"workers": len(self.workers),
                                   "applied": 0, "failed": []}
            key = self.config.server_key
            path = "/knobs" + (
                f"?accessKey={quote(key, safe='')}" if key else "")
            knob_headers = {**obs_trace.client_headers(),
                            "Content-Type": "application/json"}
            results: Dict[str, Any] = {}
            for name in [w.name for w in list(self.workers)]:
                w = self._worker(name)
                if w is None:
                    out["failed"].append(name)
                    continue
                try:
                    status, _hdrs, resp = await self._roundtrip(
                        w, "POST", path, knob_headers, body,
                        self.config.attempt_timeout_s)
                except (OSError, asyncio.TimeoutError,
                        asyncio.IncompleteReadError) as e:
                    logger.warning(
                        "front door: knob apply on %s failed (%r)",
                        name, e)
                    out["failed"].append(name)
                    continue
                if status == 200:
                    out["applied"] += 1
                    try:
                        results[name] = json.loads(
                            resp.decode("utf-8"))
                    except ValueError:
                        results[name] = None
                else:
                    # a worker that rejects the vector (bad key,
                    # unregistered env) fails the fan-out entry but
                    # never the door: the controller reads the outcome
                    # and keeps its old belief
                    logger.warning(
                        "front door: knob apply on %s rejected "
                        "(HTTP %s)", name, status)
                    out["failed"].append(name)
            out["results"] = results
            return out

    def rolling_reload(self, timeout: Optional[float] = None,
                       tenant: Optional[str] = None) -> Dict[str, Any]:
        """Synchronous wrapper for callers off the loop (bench, CLI)."""
        loop = self.http._loop
        if loop is None or not loop.is_running():
            raise RuntimeError("front door is not running")
        fut = asyncio.run_coroutine_threadsafe(
            self.rolling_reload_async(tenant=tenant), loop)
        return fut.result(timeout=timeout)

    # -- introspection ------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        return {
            "workers": [w.to_json() for w in self.workers],
            "counts": dict(self.counts),
            "retryTokens": round(self._retry_tokens, 2),
        }

    def _check_key(self, request: Request) -> Optional[Response]:
        key = self.config.server_key
        if key is not None and request.query.get("accessKey") != key:
            return Response(401, {"message": "Invalid accessKey."})
        return None

    # -- routes -------------------------------------------------------------
    def _build_router(self) -> Router:
        from incubator_predictionio_tpu_torch.obs.http import (
            add_metrics_route,
            add_recorder_route,
        )

        r = Router()
        r.add("POST", "/queries.json", self.handle_query)

        @r.get("/")
        def status(request: Request) -> Response:
            return Response(200, {"status": "frontdoor", **self.stats()})

        @r.post("/reload")
        async def reload_route(request: Request) -> Response:
            denied = self._check_key(request)
            if denied is not None:
                return denied
            return Response(200, await self.rolling_reload_async(
                tenant=request.query.get("tenant") or None))

        @r.post("/knobs")
        async def post_knobs(request: Request) -> Response:
            denied = self._check_key(request)
            if denied is not None:
                return denied
            return Response(
                200, await self.knobs_fanout_async(request.body or b""))

        @r.post("/fleet/join")
        async def join(request: Request) -> Response:
            denied = self._check_key(request)
            if denied is not None:
                return denied
            spec = request.json()
            name = self._add_worker_locked(spec["host"],
                                           int(spec["port"])).name
            return Response(200, {"worker": name})

        @r.post("/fleet/remove")
        async def remove(request: Request) -> Response:
            denied = self._check_key(request)
            if denied is not None:
                return denied
            name = request.json().get("worker", "")
            ok = await self._remove_worker_async(name)
            return Response(200 if ok else 404, {"removed": bool(ok)})

        add_metrics_route(r)
        # GET /recorder: the door's own pre-breach history (its client-
        # observed latency histogram is the fleet serve_p99 signal)
        add_recorder_route(r)
        return r

    # -- lifecycle ----------------------------------------------------------
    def start_background(self) -> int:
        port = self.http.start_background()
        loop = self.http._loop
        assert loop is not None

        def _spawn_probe() -> None:
            asyncio.ensure_future(self._probe_loop())

        loop.call_soon_threadsafe(_spawn_probe)
        logger.info("front door listening on %s:%d over %d workers",
                    self.config.host, port, len(self.workers))
        return port

    def stop(self) -> None:
        self._stopping = True
        loop = self.http._loop
        if loop is not None and loop.is_running():
            asyncio.run_coroutine_threadsafe(
                self._close_pools(), loop).result(timeout=10)
        self.http.stop()

    async def _close_pools(self) -> None:
        """Close every pooled keep-alive connection on the loop that owns
        it: a worker's graceful shutdown waits until its open connections
        close (asyncio's ``Server.wait_closed``), so a stopped door must
        not leave idle ones behind."""
        for w in self.workers:
            for _reader, writer in w.conns:
                writer.close()
            w.conns.clear()


class IngestFrontDoor(FrontDoor):
    """The WRITE-side front door: one address spraying event POSTs
    across N event-server writer processes (each with its own writer
    shards in the shared log) under the exact same door discipline the
    query door gives the read path — health-checked least-loaded
    placement, circuit breaker, token-bucket-bounded single retry, and
    zero-downtime rolling writer reload (``POST /reload`` drains one
    writer at a time while its peers absorb the stream, the planet-
    scale-ingest soak's zero-dropped-events leg).

    Delivery is AT-LEAST-ONCE under retry: a transport failure after
    the request body went out may retry an event that the dead writer
    already committed. That is the standard ingest-pipeline contract —
    a duplicate interaction row nudges a count, a dropped one silently
    loses signal — and the retry budget bounds the amplification.
    Clients that need exactly-once send their own event ids and
    deduplicate downstream."""

    #: event-ingest routes forwarded verbatim (path + query string —
    #: accessKey auth happens at the workers). ``/batches/events.json``
    #: is the reference's batch alias; both spellings land on the same
    #: native one-parse-per-batch path at the event server.
    INGEST_PATHS = ("/events.json", "/batch/events.json",
                    "/batches/events.json")

    def _build_router(self) -> Router:
        r = super()._build_router()
        for p in self.INGEST_PATHS:
            r.add("POST", p, self._ingest_handler(p))
        return r

    def _ingest_handler(self, upstream_path: str):
        async def handle(request: Request) -> Response:
            return await self.forward(request, upstream_path)

        return handle
