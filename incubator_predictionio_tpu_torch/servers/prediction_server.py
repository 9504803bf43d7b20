"""PredictionServer — query serving from device-resident model state.

Port of incubator_predictionio_tpu/servers/prediction_server.py
(:78-142, 258-1213; reference core/.../workflow/CreateServer.scala), on
the port's own HTTP layer (``utils/http.HttpServer`` + ``Router``,
asyncio, as the event server):

- ``GET  /``             → status JSON: engine instance, algorithms, device,
  request count, average and last serving seconds and p50/p95/p99 from
  ``pio_query_latency_seconds``, ``maxBatchServed``, this process's kernel
  launches by kernel (``runtime.launch_counts``), the speed overlays'
  counts summed (``speedOverlay``), the seconds since the served instance
  finished training (``modelStalenessSec``), the scheduler's state
  (``scheduler``: per-queue depth, rung and dispatch wall, sheds, the
  tenants' weights and quotas), the MIPS indexes and their rebuild
  daemon (``mips``: ``ops/mips.status_snapshot``, ``ops/mips_daemon.stats``;
  the daemon runs while the server serves) and the per-tenant block
  (``tenants``; null without ``PIO_TENANTS``);
- ``POST /queries.json`` → the tenant from the access key
  (``serving/tenancy.py``; 401 for an unknown or disabled key once
  ``PIO_TENANTS`` names tenants), then the continuous-batching scheduler
  (``serving/scheduler.py``): concurrent queries fuse into one
  :meth:`_handle_batch` call, which puts them through one batched
  dispatch (on the ALS template one launch of the score+top-k kernel);
  a 400 for a body that does not parse or extract (its batchmates are
  answered), a 503 with ``Retry-After`` when the scheduler sheds, and
  ``X-PIO-Queue-Depth`` on every answer;
- ``POST /reload``       → the hot swap while serving: the latest COMPLETED
  instance (or ``?tenant=X``: that tenant's own deploy, 404 for an
  unknown tenant) restored and warmed before it replaces the served one;
- ``POST /stop``         → shut down;
- ``GET  /plugins.json`` → the output plugins, ``GET /plugins/...`` → a
  plugin's own REST handler (JAX :1082-1111);
- ``GET  /metrics``      → Prometheus text (``obs/http.add_metrics_route``);
- ``GET  /recorder``     → the flight recorder's window
  (``obs/http.add_recorder_route``: its sampler starts with the router,
  and with ``PIO_INCIDENT_DIR`` set the server captures its own breaches
  into incident bundles).

``/reload``, ``/knobs`` and ``/stop`` take ``accessKey`` = the server key, else
server.conf's key when it enforces one (401 otherwise).

Queries are served in batches by :meth:`_handle_batch`, which keeps the
reference's split between the rendered-bytes fast path
(``batch_serve_json``) and the object path. The output plugins
(``plugin_context``: explicit, or ``PIO_PLUGINS``) run on the object
path: each blocker may rewrite or veto an answer, each sniffer sees it;
the fast path is taken only when there are none (JAX :589-712).
``ServerConfig.micro_batch`` is the scheduler's ladder cap
(``PIO_SERVE_MAX_BATCH``, default 512); 0
turns the scheduler off, and each query is then one call of
:meth:`_handle_batch` on the HTTP layer's thread pool.
``PIO_SERVE_WORKERS`` dispatcher threads (default 1) drain the queues;
``PIO_SERVE_MAX_WAIT_MS``, ``PIO_SERVE_SHED`` and ``PIO_SLO_SERVE_P99_S``
set the age bound and the shed.

Two ways to build one: from models in hand (``PredictionServer(engine,
engine_params, models)``), or as ``pio deploy`` does, from a
:class:`ServerConfig` (``PredictionServer(engine, config=...)``): the
explicit engine instance or the latest COMPLETED one of the engine id,
version and variant (:meth:`_resolve_instance`), its params read back
(``Engine.engine_params_from_instance``) and its models restored on the
device (``CoreWorkflow.load_models`` → ``Engine.prepare_deploy``) when the
server starts. Before it binds, the server runs every algorithm's
``warmup`` at each ladder rung up to ``micro_batch``; unlike the JAX
package (JAX :1159-1175, which logs a failed warm-up and serves on), an
error of a kernel's build or launch there raises. :meth:`undeploy_existing`
first stops a server at the same address, and :func:`undeploy` is ``pio
undeploy``.

:meth:`load_models` also builds the speed layer: one overlay per
algorithm that offers one (``PIO_SPEED_LAYER``, default on), polling the
event log's tail on a thread of its own (``PIO_SPEED_POLL_S``). Calling
:meth:`load_models` again (``POST /reload``) is the hot swap: the new
overlays adopt the old ones' keys, and the old ones are emptied and
stopped. A tenant's own deploy serves its model of record, with no
overlay, as in the JAX package. The overlay reads the log's tail
through the event store, so its writer may be another process: over a
``remote`` store (``pio storageserver`` owning the log) a separate ``pio
eventserver`` writes and ``pio deploy`` folds the new events in; on a
local cpplog log the writer is an ``EventServer`` in this process, since
one log is never opened by two live processes.

``POST /knobs`` applies the knob controller's vector (obs/knobs.py)
through the front door's fan-out: the env is written and the scheduler
re-reads its knobs (``BatchScheduler.apply_knobs``); a vector naming a
variable outside ``KNOB_ENV_VARS`` is refused whole with 400.

The feedback loop (``ServerConfig.feedback``, ``pio deploy --feedback``;
JAX :147-256, :718-803, CreateServer.scala:449-460, 534-604): every
answer on the object path is posted back to the event server at
``event_server_ip:event_server_port`` as a ``predict`` event of
entityType ``pio_pr`` (properties ``engineInstanceId``, ``query`` and
``prediction``) under ``access_key``, by a bounded poster of its own;
feedback turns the rendered-bytes fast path off, since it needs each
answer as an object. ``log_url`` ships every query error that is not an
:class:`HttpError`, prefixed with ``log_prefix``, through a second, small
poster. Neither poster ever blocks a dispatcher: a post that finds its
queue full is dropped and counted (``feedbackEventsDropped`` on ``GET
/``). A refused connection and a 503 are retried (honouring
``Retry-After``); anything else is tried once, so no event is applied
twice.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import json
import logging
import os
import queue
import secrets
import threading
import time
import traceback
import urllib.error
import urllib.parse
import urllib.request
import weakref
from typing import Any, Dict, List, Optional

from incubator_predictionio_tpu_torch import runtime
from incubator_predictionio_tpu_torch.core.base import Serving
from incubator_predictionio_tpu_torch.core.engine import Engine
from incubator_predictionio_tpu_torch.core.params import EngineParams
from incubator_predictionio_tpu_torch.data.storage import (
    EngineInstance,
    Storage,
)
from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
from incubator_predictionio_tpu_torch.obs import trace as obs_trace
from incubator_predictionio_tpu_torch.obs.http import (
    add_metrics_route,
    add_recorder_route,
)
from incubator_predictionio_tpu_torch.ops import mips, mips_daemon
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext
from incubator_predictionio_tpu_torch.servers.plugins import PluginContext
from incubator_predictionio_tpu_torch.serving import tenancy
from incubator_predictionio_tpu_torch.serving.scheduler import (
    BatchScheduler,
    ladder_cap,
)
from incubator_predictionio_tpu_torch.utils import json_codec
from incubator_predictionio_tpu_torch.utils.http import (
    HttpError,
    HttpServer,
    Request,
    Response,
    RetryableError,
    RetryPolicy,
    Router,
    parse_retry_after,
    sync,
)
from incubator_predictionio_tpu_torch.utils.times import (
    ensure_aware,
    format_iso8601,
    now_utc,
)
from incubator_predictionio_tpu_torch.workflow.workflow import CoreWorkflow

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def _collector_paused():
    """The cyclic garbage collector off while a model set loads, and what
    the load made frozen out of its reach afterwards (``gc.freeze``). A
    model's hundreds of thousands of small objects (seen lists, id maps)
    would otherwise trigger full collections that hold the interpreter lock
    for hundreds of milliseconds; on ``POST /reload`` that stalls the
    dispatcher serving the old models, and the shed projection turns the
    stall into 503s. Models hold no reference cycles, so reference counting
    still frees one that is swapped out."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        gc.freeze()
        if enabled:
            gc.enable()

#: per-QUERY serving latency (every query in a fused batch took the
#: batch wall — CreateServer.scala:611-618 per-query semantics, at one
#: histogram observe per BATCH), booked on the dispatcher thread after
#: the batch's answers are fetched. Tenant-labeled: label values come
#: only from the bounded registry (serving/tenancy.py); unlabeled reads
#: (quantile/count) aggregate the children. The scheduler's shed
#: projection reads the tenant's own p99 here.
_QUERY_LATENCY = obs_metrics.REGISTRY.histogram(
    "pio_query_latency_seconds",
    "per-query serving wall (fused batch members share the batch wall)",
    labels=("tenant",))
#: the scheduler's backlog per tenant, read at scrape time
_QUEUE_DEPTH = obs_metrics.REGISTRY.gauge(
    "pio_serve_queue_depth",
    "queries waiting in the scheduler's queues (scrape-time snapshot, "
    "per tenant)",
    labels=("tenant",))
#: age of the deployed instance, read at scrape time (the staleness
#: SLO's gauge, obs/slo.py); GET /'s modelStalenessSec is the same figure
_STALENESS = obs_metrics.REGISTRY.gauge(
    "pio_model_staleness_seconds",
    "seconds since the served engine instance finished training "
    "(scrape-time snapshot)")


@dataclasses.dataclass
class ServerConfig:
    """What ``pio deploy`` passes (CreateServer.scala:89-113 ServerConfig;
    JAX :110-136)."""

    ip: str = "0.0.0.0"
    port: int = 8000
    engine_instance_id: Optional[str] = None  # default: latest COMPLETED
    engine_id: str = "default"
    engine_version: str = "NOT_VERSIONED"
    engine_variant: str = "default"
    #: where the feedback loop posts its predict events, and the app's key
    event_server_ip: str = "0.0.0.0"
    event_server_port: int = 7070
    access_key: Optional[str] = None
    feedback: bool = False
    server_key: Optional[str] = None  # auth for /stop and /reload
    #: ship query errors to a remote collector, each line prefixed with
    #: ``log_prefix`` (CreateServer.scala:449-460)
    log_url: Optional[str] = None
    log_prefix: str = ""
    #: LADDER CAP of the continuous-batching scheduler (0 turns it off:
    #: one query a call, as the reference serves them,
    #: CreateServer.scala:523). The scheduler picks each dispatch's width
    #: from the live queue depth on the pow2 rung ladder and reaches the
    #: cap only under sustained pressure. Default ``PIO_SERVE_MAX_BATCH``
    #: (512)
    micro_batch: int = dataclasses.field(default_factory=ladder_cap)
    #: the scheduler's dispatcher threads (``PIO_SERVE_WORKERS``, default
    #: 1): a second one can overlap one batch's host parse and render
    #: with another's dispatch
    serve_workers: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get("PIO_SERVE_WORKERS",
                                                   "1")))


#: retries of the fire-and-forget posters (feedback events, ``log_url``
#: shipping): jittered exponential backoff under a deadline, honouring
#: ``Retry-After`` on a 503 (JAX :147-153)
_POST_RETRY = RetryPolicy(attempts=3, base_delay_s=0.5, max_delay_s=5.0,
                          deadline_s=20.0)


def _post_with_retries(url: str, payload: bytes,
                       headers: Dict[str, str], what: str,
                       expect_status: Optional[int] = None) -> None:
    """One JSON POST under :data:`_POST_RETRY`, on a poster's worker
    thread (JAX :156-191). Only a refused connection (the body never left)
    and a 503 (the receiver shed it unprocessed, and says when to come
    back) are retried; a 4xx, another 5xx or a timeout mid-flight is
    tried once, since the event may have been applied and a poster must
    never apply training data twice. Failures are logged, never
    raised."""
    def attempt() -> None:
        req = urllib.request.Request(url, data=payload, headers=headers,
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                if expect_status is not None and resp.status != expect_status:
                    logger.error("%s POST returned status %d", what,
                                 resp.status)
        except urllib.error.HTTPError as e:
            if e.code == 503:
                raise RetryableError(
                    e, retry_after_s=parse_retry_after(
                        e.headers.get("Retry-After"))) from e
            raise
        except urllib.error.URLError as e:
            if isinstance(e.reason, ConnectionRefusedError):
                raise RetryableError(e) from e
            raise

    try:
        _POST_RETRY.call(attempt)
    except Exception as e:
        logger.error("%s failed: %s", what, e)


class _AsyncPoster:
    """A bounded pool of worker threads for fire-and-forget posts (JAX
    :194-256), named ``pio-torch-poster-<name>-<i>``. A post that finds
    the queue full is dropped and counted instead of waited on, so an
    outage of the receiver never stalls a dispatcher. Feedback and log
    shipping get posters of their own, so a hung log collector never
    starves feedback, which is training data."""

    def __init__(self, name: str, workers: int = 2, maxsize: int = 1024):
        self._queue: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self.dropped = 0  # read by GET / (feedback is data)
        self._dropped_lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"pio-torch-poster-{name}-{i}")
            for i in range(max(workers, 1))
        ]
        for t in self._threads:
            t.start()

    def submit(self, fn, what: str) -> None:
        """Queue ``fn``; never blocks (it runs on a dispatcher thread)."""
        try:
            self._queue.put_nowait(fn)
        except queue.Full:
            with self._dropped_lock:
                self.dropped += 1
                n = self.dropped
            logger.error("async post queue full; dropping %s (%d dropped "
                         "total)", what, n)

    def stop(self) -> None:
        """One sentinel per worker, after the posts already queued; a
        queue still full after 5 s leaves a worker draining on its own."""
        for _ in self._threads:
            try:
                self._queue.put(None, timeout=5)
            except queue.Full:
                logger.warning(
                    "async post queue still full at stop; a worker may "
                    "keep draining in the background")

    def _run(self) -> None:
        while True:
            fn = self._queue.get()
            if fn is None:
                return
            try:
                fn()
            except Exception:
                logger.exception("async post failed")


class PredictionServer:
    """Serves one model per algorithm of an engine's params on ``device``
    (CUDA unless told otherwise): ``models`` in hand, moved to the device
    here, or, with ``models`` None, the stored engine instance that
    ``config`` names, restored when the server starts. With a ``config``
    the server binds to its ``ip`` and ``port``, else to ``host`` and
    ``port``. ``plugin_context`` holds the output plugins (default: those
    ``PIO_PLUGINS`` names)."""

    def __init__(self, engine: Engine,
                 engine_params: Optional[EngineParams] = None,
                 models: Optional[List[Any]] = None, device=None,
                 host: str = "127.0.0.1", port: int = 0, *,
                 config: Optional[ServerConfig] = None,
                 plugin_context: Optional[PluginContext] = None):
        self.engine = engine
        self.config = config or ServerConfig(ip=host, port=port)
        self.plugin_context = plugin_context or PluginContext()
        self.ctx = RuntimeContext(device=device)
        self.engine_instance: Optional[EngineInstance] = None
        self.engine_params = engine_params
        self.algorithms: List[Any] = []
        self.serving: Any = None
        self.models: List[Any] = []
        #: algorithm-aligned speed overlays (None where an algorithm has
        #: none), built by :meth:`load_models`
        self._speed_overlays: List[Any] = []
        #: whether this server holds a reference on the MIPS rebuild daemon
        self._mips_daemon_held = False
        #: per-tenant deploys beyond the default one (tenant id →
        #: {engine_instance, engine_params, algorithms, serving, models});
        #: a registered tenant with no entry here shares the default
        #: deploy. One appears when a tenant's /reload loads its own
        #: engine id or variant (``PIO_TENANTS`` ``engine=`` /
        #: ``variant=``)
        self._deploys: Dict[str, Dict[str, Any]] = {}
        if models is not None:
            if engine_params is None:
                raise ValueError("models without their engine_params")
            self.algorithms, self.serving = engine.components(engine_params)
            if len(models) != len(self.algorithms):
                raise ValueError(f"{len(models)} models for "
                                 f"{len(self.algorithms)} algorithms")
            self.models = [a.prepare_model(self.ctx, m)
                           for a, m in zip(self.algorithms, models)]
        self._lock = threading.Lock()
        #: serializes /reload end to end: with the warm-up before the
        #: swap the resolve → swap window is long, and two unserialized
        #: reloads could swap an older instance back in
        self._reload_lock = threading.Lock()
        self.start_time = time.time()
        self.request_count = 0
        self.avg_serving_sec = 0.0
        self.last_serving_sec = 0.0
        self.max_batch_served = 0  # largest batch served so far
        self._stopped = threading.Event()
        self.http = HttpServer.from_conf(self._build_router(),
                                         self.config.ip, self.config.port,
                                         bind_retries=3, name="prediction")
        self._batcher: Optional[BatchScheduler] = (
            # the p99 feed takes the tenant (non-defaulted: the scheduler
            # detects per-tenant feeds by arity), so the shed projection
            # reads the tenant's own tail, never a noisy neighbour's
            BatchScheduler(self._handle_batch, self.config.micro_batch,
                           workers=self.config.serve_workers,
                           p99_fn=lambda tenant: _QUERY_LATENCY.labels(
                               tenant=tenancy.get_registry().label(tenant)
                           ).quantile(0.99))
            if self.config.micro_batch > 0 else None)
        self._sync_tenant_policy()
        if self._batcher is not None:
            self.register_queue_collector()
        # scrape-time staleness gauge; a weakref, so telemetry never pins
        # a stopped server's models
        server_ref = weakref.ref(self)

        def _collect_staleness() -> None:
            s = server_ref()
            if s is None:
                return
            with s._lock:
                instance = s.engine_instance
            if instance is None:
                return
            _STALENESS.set(max(
                (now_utc() - ensure_aware(instance.end_time))
                .total_seconds(), 0.0))

        obs_metrics.REGISTRY.register_collector(
            "prediction_model_staleness", _collect_staleness)
        # feedback is training data: a deep queue, so only a sustained
        # outage of the event server drops (counted on GET /); the log
        # shipper's diagnostics stay shallow and lossy (JAX :339-344)
        self._feedback_poster = _AsyncPoster("feedback", maxsize=16384)
        self._log_poster = _AsyncPoster("log", workers=1, maxsize=256)

    # -- tenancy ------------------------------------------------------------
    def register_queue_collector(self) -> None:
        """Register the scrape-time ``pio_serve_queue_depth`` collector.
        Named, so a later server's hook replaces this one's; it weakrefs
        the server (not the batcher) so a stopped server stays
        collectable."""
        server_ref = weakref.ref(self)

        def _collect_queue_depth() -> None:
            s = server_ref()
            b = s._batcher if s is not None else None
            if b is None:
                return
            depths = b.depths_by_tenant()
            depths.setdefault(tenancy.DEFAULT_TENANT, 0)
            reg = tenancy.get_registry()
            for t in reg.tenant_ids():
                depths.setdefault(t, 0)
            for t, d in depths.items():
                _QUEUE_DEPTH.labels(tenant=reg.label(t)).set(float(d))

        obs_metrics.REGISTRY.register_collector(
            "prediction_queue_depth", _collect_queue_depth)

    def _sync_tenant_policy(self) -> None:
        """Push the tenant registry's weights and quotas into the
        scheduler: at construction and after every /reload, so a registry
        change lands without a restart."""
        if self._batcher is None:
            return
        reg = tenancy.get_registry()
        self._batcher.set_tenant_policy(reg.weights(), reg.quotas())

    # -- deploy lifecycle (CreateServer.scala:207-308) ---------------------
    def _resolve_instance(self, engine_id: Optional[str] = None,
                          engine_variant: Optional[str] = None
                          ) -> EngineInstance:
        """The explicit engine instance, else the latest COMPLETED one of
        the config's engine id, version and variant (or of the
        ``engine_id`` / ``engine_variant`` given: a tenant's deploy)."""
        instances = Storage.get_meta_data_engine_instances()
        c = self.config
        if engine_id is None and engine_variant is None \
                and c.engine_instance_id:
            instance = instances.get(c.engine_instance_id)
            if instance is None:
                raise ValueError(
                    f"Invalid engine instance ID {c.engine_instance_id}.")
            return instance
        engine_id = engine_id or c.engine_id
        engine_variant = engine_variant or c.engine_variant
        instance = instances.get_latest_completed(
            engine_id, c.engine_version, engine_variant)
        if instance is None:
            raise ValueError(
                "No valid engine instance found for engine "
                f"{engine_id} {c.engine_version} {engine_variant}. The "
                "engine id is derived from the engine directory's absolute "
                "path: if the engine was trained from a different path, "
                "its instances are keyed under a different id; deploy from "
                "the training path or pass --engine-instance-id.")
        return instance

    def load_models(self, warm_before_swap: bool = False,
                    tenant: Optional[str] = None) -> None:
        """Resolve the instance, read its params back and restore its
        models on the device (``CoreWorkflow.load_models`` →
        ``Engine.prepare_deploy``), build their speed overlays, then serve
        them. Called again, it is the hot swap (JAX :422-541): the new
        overlays adopt the old ones' keys, which they re-solve against
        the new factors, and the old overlays are emptied and stopped.

        ``warm_before_swap`` (``POST /reload``) runs the new models'
        warm-up before the swap, so the old ones serve every query until
        the new ones are ready. ``tenant`` refreshes that tenant's own
        deploy only (``/reload?tenant=X``); every other tenant, the
        default deploy included, serves on untouched."""
        if tenant is not None and tenant != tenancy.DEFAULT_TENANT:
            self._load_tenant_models(tenant, warm_before_swap)
            return
        instance = self._resolve_instance()
        engine_params = self.engine.engine_params_from_instance(instance)
        with _collector_paused():
            models = CoreWorkflow.load_models(instance.id, self.engine,
                                              engine_params, ctx=self.ctx)
        algorithms, serving = self.engine.components(engine_params)
        if warm_before_swap:
            self._warm_models(algorithms, models)
        overlays = self._build_speed_overlays(engine_params, algorithms,
                                              models)
        # the dispatchers read the new tables on streams of their own:
        # everything queued on them here is finished before the swap
        runtime.finish_current_stream(self.ctx.device)
        with self._lock:
            self.engine_instance = instance
            self.engine_params = engine_params
            self.algorithms, self.serving = algorithms, serving
            self.models = models
            old_overlays = self._speed_overlays
            self._speed_overlays = overlays
        # both lists are algorithm-aligned, so adoption never pairs
        # overlays of two algorithms
        for old, ov in zip(old_overlays, overlays):
            if old is not None and ov is not None:
                ov.adopt_keys(old.known_keys())
        for ov in old_overlays:
            if ov is not None:
                ov.invalidate_all()
                ov.stop()
        for ov in overlays:
            if ov is not None:
                ov.start()
        logger.info("Deployed engine instance %s on %s (%d speed overlays)",
                    instance.id, self.ctx.device,
                    sum(ov is not None for ov in overlays))

    def _load_tenant_models(self, tenant_id: str,
                            warm_before_swap: bool) -> None:
        """Load or refresh one tenant's own deploy (JAX :508-541): the
        instance of the tenant's ``engine=`` / ``variant=`` (else the
        config's), warmed before the swap when asked; the swap touches
        only ``self._deploys[tenant_id]``. A tenant's deploy serves its
        model of record (no speed overlay), as in the JAX package."""
        t = tenancy.get_registry().get(tenant_id)
        if t is None:
            raise HttpError(404, f"Unknown tenant {tenant_id!r}.")
        instance = self._resolve_instance(
            engine_id=t.engine_id or self.config.engine_id,
            engine_variant=t.engine_variant or self.config.engine_variant)
        engine_params = self.engine.engine_params_from_instance(instance)
        with _collector_paused():
            models = CoreWorkflow.load_models(instance.id, self.engine,
                                              engine_params, ctx=self.ctx)
        algorithms, serving = self.engine.components(engine_params)
        if warm_before_swap:
            self._warm_models(algorithms, models)
        runtime.finish_current_stream(self.ctx.device)
        with self._lock:
            self._deploys[tenant_id] = {
                "engine_instance": instance,
                "engine_params": engine_params,
                "algorithms": algorithms,
                "serving": serving,
                "models": models,
            }
        logger.info("Tenant %s deployed engine instance %s (%d algorithms)",
                    tenant_id, instance.id, len(algorithms))

    def _warm_models(self, algorithms, models) -> None:
        """Every algorithm's ``warmup`` at each ladder rung up to
        ``micro_batch`` (the batched dispatch only when the scheduler is
        on: without it, live traffic never reaches a batch). Unlike the
        JAX package, which logs a failed warm-up and serves on, an error
        here raises: on the card it comes from a kernel's build or
        launch, and serving past it would hide it."""
        max_batch = self.config.micro_batch if self._batcher is not None \
            else 0
        for algo, model in zip(algorithms, models):
            algo.warmup(model, max_batch=max_batch)

    def _build_speed_overlays(self, engine_params, algorithms,
                              models) -> List[Any]:
        """One overlay per algorithm that offers one
        (``Algorithm.make_speed_overlay``), attached to the algorithm;
        the list is algorithm-aligned (None where there is none).
        ``PIO_SPEED_LAYER=0`` turns them off. A store without a tail
        read (SQLite, localfs: ``enabled`` False) gives no overlay, as in
        the JAX package; unlike it (JAX :567-571), any other error of the
        construction raises instead of being logged away — on the card
        it comes from the kernel or the device, and serving without the
        overlay would hide it."""
        dsp = engine_params.data_source_params[1]
        app_name = getattr(dsp, "app_name", None)
        channel_name = getattr(dsp, "channel_name", None)
        disabled = os.environ.get("PIO_SPEED_LAYER", "1").lower() in (
            "0", "off", "false")
        overlays: List[Any] = []
        for algo, model in zip(algorithms, models):
            overlay = None
            if not disabled:
                overlay = algo.make_speed_overlay(
                    model, app_name, channel_name, data_source_params=dsp)
                if overlay is not None and not overlay.enabled:
                    overlay = None  # a store without a tail read
                if overlay is not None:
                    # the kernels are built here, at deploy, never by
                    # the poller's first fold-in
                    overlay.solver.warmup()
            algo.attach_speed_overlay(overlay)
            overlays.append(overlay)
        return overlays

    def _speed_status_locked(self) -> Dict[str, Any]:
        """The overlays' counts for ``GET /`` (the caller holds the
        lock): size, hits, misses and fold-ins summed, the worst cursor
        lag (JAX :809-829)."""
        overlays = [ov for ov in self._speed_overlays if ov is not None]
        out = {"overlays": len(overlays), "size": 0,
               "hits": 0, "misses": 0, "foldins": 0, "cursorLagEvents": 0}
        for ov in overlays:
            s = ov.stats()
            out["size"] += s["size"]
            out["hits"] += s["hits"]
            out["misses"] += s["misses"]
            out["foldins"] += s["foldins"]
            out["cursorLagEvents"] = max(out["cursorLagEvents"],
                                         s["cursorLagEvents"])
        return out

    def _server_key(self) -> Optional[str]:
        """The key ``/stop`` takes: the config's, else server.conf's when
        it enforces one (KeyAuthentication.scala:39)."""
        if self.config.server_key is not None:
            return self.config.server_key
        from incubator_predictionio_tpu_torch.utils.ssl_config import (
            load_server_key,
        )

        conf = load_server_key()
        return conf.key if conf.auth_enforced else None

    def undeploy_existing(self) -> None:
        """Stop an engine server already deployed at this address before
        binding (MasterActor.undeploy, CreateServer.scala:283-308): 200 →
        stopped; connection refused → nothing there; any other answer → a
        foreign process holds the port, and the bind will say so. The
        scheme follows this server's own TLS config (server.conf)."""
        if self.config.port == 0:
            return  # an ephemeral port: nothing can hold it
        ip = self.config.ip if self.config.ip != "0.0.0.0" else "127.0.0.1"
        scheme = "https" if self.http.ssl_context is not None else "http"
        try:
            status = _stop_request(ip, self.config.port, self._server_key(),
                                   scheme=scheme)
        except (ConnectionRefusedError, urllib.error.URLError) as e:
            reason = getattr(e, "reason", e)
            if isinstance(reason, ConnectionRefusedError):
                logger.debug("Nothing at %s:%d", ip, self.config.port)
            else:
                logger.warning("A process at %s:%d did not answer /stop "
                               "(%s); unable to undeploy.", ip,
                               self.config.port, reason)
            return
        if status == 200:
            logger.info("Undeployed the engine server at %s:%d", ip,
                        self.config.port)
            time.sleep(0.5)  # the old process unbinds
        else:
            logger.error("Another process is using %s:%d (HTTP %d on "
                         "/stop). Unable to undeploy.", ip,
                         self.config.port, status)

    # -- query pipeline -----------------------------------------------------
    def _handle_query(self, body: bytes,
                      tenant: str = tenancy.DEFAULT_TENANT) -> Any:
        """One query without the scheduler (``micro_batch=0``)."""
        res = self._handle_batch([body], self.config.engine_id, tenant)[0]
        if isinstance(res, Exception):
            raise res
        return res

    def _handle_batch(self, bodies: List[bytes], engine: str,
                      tenant: str) -> List[Any]:
        """Serve a batch of query bodies in one pass: parse, the fast path
        or supplement, ONE ``batch_predict`` per algorithm (one batched
        dispatch), then serve. Each entry of the result is response bytes
        (fast path), a jsonable result (object path) or the exception
        that query raised; one bad query never fails its batchmates.

        ``engine`` and ``tenant`` have no defaults, so the scheduler's
        arity detection passes each batch's queue key (JAX :584-600): a
        batch is one tenant's, and serves from that tenant's own deploy
        when it has one.

        The calling thread (a scheduler dispatcher, or a request thread
        with ``micro_batch=0``) runs the batch's device work on its own
        serving stream (``runtime.own_stream``): the batch never waits
        behind the speed layer's fold-ins or another dispatcher's work,
        and its booked ``pio_device_seconds`` are its own."""
        with runtime.own_stream(self.ctx.device, serving=True):
            return self._serve_batch(bodies, engine, tenant)

    def _serve_batch(self, bodies: List[bytes], engine: str,
                     tenant: str) -> List[Any]:
        t0 = time.perf_counter()
        with self._lock:
            dep = (self._deploys.get(tenant)
                   if tenant != tenancy.DEFAULT_TENANT else None)
            if dep is not None:
                algorithms, serving = dep["algorithms"], dep["serving"]
                models, instance = dep["models"], dep["engine_instance"]
            else:
                algorithms, serving = self.algorithms, self.serving
                models, instance = self.models, self.engine_instance
        n = len(bodies)
        if not algorithms:
            return [HttpError(503, "No engine instance deployed.")] * n
        query_class = algorithms[0].query_class
        results: List[Any] = [None] * n
        raws: List[Any] = [None] * n
        for idx, body in enumerate(bodies):
            try:
                raws[idx] = json.loads(body.decode("utf-8"))
            except ValueError as e:  # JSONDecodeError, UnicodeDecodeError
                results[idx] = e
        # rendered-bytes fast path: only where the bytes equal the object
        # path's — one algorithm, first-prediction serving declared on the
        # serving's own class, the identity supplement, and nothing that
        # needs the answer as an object (the feedback loop, an output
        # plugin)
        blockers = self.plugin_context.output_blockers
        sniffers = self.plugin_context.output_sniffers
        if (len(algorithms) == 1
                and type(serving).__dict__.get("FIRST_PREDICTION_ONLY", False)
                and type(serving).supplement is Serving.supplement
                and not self.config.feedback
                and not blockers and not sniffers):
            try:
                fast = algorithms[0].batch_serve_json(
                    models[0],
                    [r if results[i] is None else None
                     for i, r in enumerate(raws)])
            except Exception:
                logger.exception(
                    "batch_serve_json failed; using the object path")
                fast = None
            for idx, payload in enumerate(fast or ()):
                if payload is not None and results[idx] is None:
                    results[idx] = payload
        parsed: List[Any] = []  # [idx, raw, query, supplemented]
        for idx in range(n):
            if results[idx] is not None:
                continue
            try:
                query = (json_codec.extract(query_class, raws[idx])
                         if query_class is not None else raws[idx])
                parsed.append((idx, raws[idx], query,
                               serving.supplement(query)))
            except Exception as e:
                results[idx] = e
        # one prediction per algorithm per live query; a batch of more
        # than one goes through the algorithm's batched path
        preds = {idx: [] for idx, _r, _q, _s in parsed}
        for a, m in zip(algorithms, models):
            live = [(idx, supp) for idx, _r, _q, supp in parsed
                    if results[idx] is None]
            if not live:
                break
            if len(live) > 1:
                try:
                    got = dict(a.batch_predict(m, live))
                    # all-or-nothing, so a partial result cannot leave
                    # duplicate appends behind the per-query retry
                    vals = [got[idx] for idx, _supp in live]
                    for (idx, _supp), v in zip(live, vals):
                        preds[idx].append(v)
                    continue
                except Exception:
                    logger.exception(
                        "batch_predict failed; serving the batch per query")
            for idx, supp in live:
                try:
                    preds[idx].append(a.predict(m, supp))
                except Exception as e:
                    results[idx] = e
        variant = (instance.engine_variant if instance is not None
                   else self.config.engine_variant)
        for idx, raw, query, _supp in parsed:
            if results[idx] is not None:
                continue
            try:
                # serve sees the ORIGINAL query (CreateServer.scala:526)
                result = json_codec.to_jsonable(
                    serving.serve(query, preds[idx]))
                if self.config.feedback:
                    result = self._feedback(instance, raw, result)
                for blocker in blockers.values():
                    result = blocker.process(variant, raw, result,
                                             self.plugin_context)
                for sniffer in sniffers.values():
                    try:
                        sniffer.process(variant, raw, result,
                                        self.plugin_context)
                    except Exception:
                        logger.exception("output sniffer failed")
                results[idx] = result
            except Exception as e:
                results[idx] = e
        if self.config.log_url:
            for idx, res in enumerate(results):
                if isinstance(res, Exception) and not isinstance(
                        res, HttpError):
                    self._remote_log(
                        f"Query:\n{bodies[idx][:2048]!r}\n\nStack Trace:\n"
                        + "".join(traceback.format_exception(res)))
        dt = time.perf_counter() - t0
        with self._lock:
            self.request_count += n
            self.avg_serving_sec += (dt - self.avg_serving_sec) * n \
                / self.request_count
            self.last_serving_sec = dt
            self.max_batch_served = max(self.max_batch_served, n)
        # n equal observations in one add: per-query tail latency at one
        # observation a batch; the tenant label from the bounded registry
        _QUERY_LATENCY.labels(
            tenant=tenancy.get_registry().label(tenant)).observe(dt, n)
        return results

    def _remote_log(self, message: str) -> None:
        """POST a query error to ``log_url``, prefixed with ``log_prefix``
        (remoteLog, CreateServer.scala:449-460; JAX :743-767), through the
        log poster; a collector's failure is only logged here."""
        with self._lock:
            instance = self.engine_instance
        payload = (self.config.log_prefix or "") + json.dumps({
            "engineInstance": {
                "id": instance.id if instance else None,
                "engineId": instance.engine_id if instance else None,
                "engineVariant": (
                    instance.engine_variant if instance else None),
            },
            "message": message,
        })
        # captured here: the poster's thread has none of the request's
        # context variables
        trace_headers = obs_trace.client_headers()
        self._log_poster.submit(
            lambda: _post_with_retries(
                self.config.log_url, payload.encode(),
                {"Content-Type": "application/json", **trace_headers},
                "remote log"),
            "remote log")

    def _feedback(self, instance: Optional[EngineInstance],
                  query_json: Any, prediction_json: Any) -> Any:
        """Post the answer back to the event server as a ``predict`` event
        of entityType ``pio_pr`` (CreateServer.scala:534-604; JAX
        :769-803). Its entity id is the prediction's ``prId``, else a
        fresh one; a query's ``prId`` rides as the event's. The answer
        carries the id only when the prediction has a ``prId`` field."""
        pr_id = prediction_json.get("prId") if isinstance(
            prediction_json, dict) else None
        if not pr_id:
            pr_id = secrets.token_hex(32)
        data = {
            "event": "predict",
            "eventTime": format_iso8601(now_utc()),
            "entityType": "pio_pr",
            "entityId": pr_id,
            "properties": {
                "engineInstanceId": instance.id if instance else None,
                "query": query_json,
                "prediction": prediction_json,
            },
        }
        if isinstance(query_json, dict) and query_json.get("prId"):
            data["prId"] = query_json["prId"]
        url = (f"http://{self.config.event_server_ip}:"
               f"{self.config.event_server_port}/events.json"
               f"?accessKey={self.config.access_key or ''}")
        # captured before the hop to the poster's thread (see _remote_log)
        trace_headers = obs_trace.client_headers()
        self._feedback_poster.submit(
            lambda: _post_with_retries(
                url, json.dumps(data).encode(),
                {"Content-Type": "application/json", **trace_headers},
                "feedback event", expect_status=201),
            "feedback event")
        if isinstance(prediction_json, dict) and "prId" in prediction_json:
            prediction_json = dict(prediction_json, prId=pr_id)
        return prediction_json

    def _tenant_status_locked(self) -> Optional[Dict[str, Any]]:
        """``GET /``'s per-tenant block (the caller holds the lock; JAX
        :846-879): the registry's policy, which deploy each tenant serves
        from, its queue depth, sheds, staleness and p99. None in
        single-tenant mode."""
        reg = tenancy.get_registry()
        if not reg and not self._deploys:
            return None
        sched = (self._batcher.stats()["tenants"]
                 if self._batcher is not None else {})
        out: Dict[str, Any] = {}
        for tid, desc in reg.describe().items():
            dep = self._deploys.get(tid)
            instance = (dep["engine_instance"] if dep is not None
                        else self.engine_instance)
            srow = sched.get(tid, {})
            out[tid] = {
                **desc,
                "engineInstanceId": instance.id if instance else None,
                "sharedDeploy": dep is None,
                "modelStalenessSec": (
                    max((now_utc() - ensure_aware(instance.end_time))
                        .total_seconds(), 0.0)
                    if instance is not None else None),
                "queueDepth": srow.get("depth", 0),
                "shed": srow.get("shed", 0),
                "servingSecP99": _QUERY_LATENCY.labels(
                    tenant=reg.label(tid)).quantile(0.99) or 0.0,
            }
        return out

    def status(self) -> dict:
        with self._lock:
            instance = self.engine_instance
            return {
                "status": "alive",
                "engineInstanceId": instance.id if instance else None,
                "engineFactory": instance.engine_factory if instance
                else None,
                "engineVariant": instance.engine_variant if instance
                else None,
                "algorithms": [type(a).__name__ for a in self.algorithms],
                "device": str(self.ctx.device),
                "startTime": self.start_time,
                "requestCount": self.request_count,
                "avgServingSec": self.avg_serving_sec,
                "lastServingSec": self.last_serving_sec,
                # the tail from the query histogram (process-wide, every
                # tenant); 0.0 before the first query
                "servingSecP50": _QUERY_LATENCY.quantile(0.50) or 0.0,
                "servingSecP95": _QUERY_LATENCY.quantile(0.95) or 0.0,
                "servingSecP99": _QUERY_LATENCY.quantile(0.99) or 0.0,
                "maxBatchServed": self.max_batch_served,
                # feedback events lost to a full poster queue
                "feedbackEventsDropped": self._feedback_poster.dropped,
                # this process's kernel launches by kernel (a deployed
                # server is its own process: its counts are read here)
                "kernelLaunches": runtime.launch_counts(),
                # seconds since the served instance finished training:
                # what the speed layer makes tolerable
                "modelStalenessSec": (
                    max((now_utc() - ensure_aware(instance.end_time))
                        .total_seconds(), 0.0)
                    if instance is not None else None),
                "speedOverlay": self._speed_status_locked(),
                # per-index MIPS state (tail, ext block, tiers, age) and
                # the rebuild daemon's triggers and recent swaps
                "mips": {"indexes": mips.status_snapshot(),
                         "daemon": mips_daemon.stats()},
                # per-queue depth, rung and dispatch wall, sheds, tenants
                "scheduler": (self._batcher.stats()
                              if self._batcher is not None else None),
                "tenants": self._tenant_status_locked(),
            }

    # -- HTTP ---------------------------------------------------------------
    def _check_server_key(self, request: Request) -> None:
        """``/stop`` and ``/reload`` take the server key
        (KeyAuthentication.scala:34-39)."""
        key = self._server_key()
        if key is not None and request.query.get("accessKey") != key:
            raise HttpError(401, "Invalid accessKey.")

    def _build_router(self) -> Router:
        r = Router()

        @r.get("/")
        def status(request: Request) -> Response:
            return Response(200, self.status())

        @r.post("/queries.json")
        async def queries(request: Request) -> Response:
            batcher = self._batcher
            try:
                # the event server's accessKey grammar mapped to a tenant;
                # without PIO_TENANTS every query is the default tenant's
                tenant = tenancy.get_registry().authenticate(request)
                if batcher is not None:
                    # priority orders only the shed decision (a higher one
                    # survives an overload longer); a malformed value is 0
                    try:
                        prio = int(request.headers.get("x-pio-priority",
                                                       "0"))
                    except ValueError:
                        prio = 0
                    result = await asyncio.wrap_future(batcher.submit(
                        request.body, priority=prio,
                        engine=self.config.engine_id, tenant=tenant))
                else:
                    result = await sync(self._handle_query, request.body,
                                        tenant)
            except HttpError as e:
                # the depth matters most on a shed: it tells a client
                # (or a front door) how deep the queue it hit was
                if batcher is not None:
                    e.headers.setdefault("X-PIO-Queue-Depth",
                                         str(batcher.depth()))
                raise
            except (ValueError, KeyError) as e:
                # malformed JSON or a query that does not extract
                return Response(400, {"message": str(e)})
            headers = ({"X-PIO-Queue-Depth": str(batcher.depth())}
                       if batcher is not None else {})
            if isinstance(result, (bytes, bytearray)):
                # the fast path rendered the body already
                return Response(200, body=bytes(result), headers=headers)
            return Response(200, result, headers=headers)

        @r.post("/reload")
        def reload(request: Request) -> Response:
            self._check_server_key(request)
            # the new models warm before the swap while the old ones
            # serve; serialized, so two reloads cannot swap out of order;
            # ?tenant=X refreshes that tenant's deploy alone
            tenant = request.query.get("tenant") or None
            with self._reload_lock:
                self.load_models(warm_before_swap=True, tenant=tenant)
            self._sync_tenant_policy()
            return Response(200, {
                "message": (f"Reloaded tenant {tenant}." if tenant
                            else "Reloaded.")})

        @r.post("/stop")
        def stop_route(request: Request) -> Response:
            self._check_server_key(request)
            # after the answer is on its way; daemonized, so a process
            # torn down first is not held by the timer
            timer = threading.Timer(0.2, self.stop)
            timer.daemon = True
            timer.start()
            return Response(200, {"message": "Shutting down."})

        @r.post("/knobs")
        def post_knobs(request: Request) -> Response:
            # the worker half of the audited knob seam (obs/knobs.py):
            # the knob controller's front-door fan-out lands here with
            # the decision's trace headers. Every registered knob is a
            # call-time env read, so writing the env + one scheduler
            # refresh applies the vector without restart or drain: the
            # next dispatch plans its score+top-k launch under the new
            # rung cap, and the next fold-in batches to the new budget.
            self._check_server_key(request)
            from incubator_predictionio_tpu_torch.obs import knobs as obs_knobs

            try:
                payload = json.loads(request.body or b"{}")
                values = payload.get("values") or {}
                items = {str(k): int(v) for k, v in values.items()}
            except (ValueError, TypeError, AttributeError) as e:
                return Response(400, {"message": f"bad knob body: {e}"})
            unknown = sorted(set(items) - obs_knobs.KNOB_ENV_VARS)
            if unknown:
                # reject the WHOLE vector: a partial apply would leave
                # the fleet on a vector no decision record describes
                return Response(400, {
                    "message": "unregistered knob env vars",
                    "unknown": unknown,
                })
            applied = {}
            for env, v in sorted(items.items()):
                os.environ[env] = str(v)
                applied[env] = v
            scheduler = (self._batcher.apply_knobs()
                         if self._batcher is not None else None)
            return Response(200, {"applied": applied,
                                  "scheduler": scheduler})

        @r.get("/plugins.json")
        def plugins_list(request: Request) -> Response:
            ctx = self.plugin_context
            return Response(200, {"plugins": {
                "outputblockers": {n: {"name": n}
                                   for n in ctx.output_blockers},
                "outputsniffers": {n: {"name": n}
                                   for n in ctx.output_sniffers},
            }})

        @r.get("/plugins/{tail...}")
        def plugins_rest(request: Request) -> Response:
            parts = request.path_params["tail"].split("/")
            plugin = self.plugin_context.plugin(parts[0])
            if plugin is None:
                return Response(404, {"message": "Not Found"})
            return Response(200, plugin.handle_rest("/".join(parts[1:]),
                                                    dict(request.query)))

        add_metrics_route(r)
        # the worker's own metric history, which an incident capture pulls
        add_recorder_route(r)
        return r

    def _prepare(self) -> None:
        """Restore the instance's models when there are none yet, warm
        them at every ladder rung (raising on a kernel's error), stop a
        server deployed at the same address, and take this server's
        reference on the MIPS rebuild daemon (released by :meth:`stop`)."""
        if self.engine_params is None:
            self.load_models()
        self._warm_models(self.algorithms, self.models)
        self.undeploy_existing()
        # host the MIPS rebuild daemon next to the overlay pollers while
        # the server serves (JAX :487-501), one reference per server
        with self._lock:
            want_daemon = not self._mips_daemon_held
            self._mips_daemon_held = True
        if want_daemon:
            mips_daemon.acquire()

    def start_background(self) -> int:
        """Warm, bind and serve on a daemon thread; returns the bound
        port."""
        self._prepare()
        port = self.http.start_background()
        logger.info("PredictionServer started on %s:%d", self.config.ip,
                    port)
        return port

    def serve_forever(self, on_started=None) -> None:
        """Warm, bind and serve on this thread until :meth:`stop` (``POST
        /stop``); ``on_started(port)`` is called once bound."""
        self._prepare()
        try:
            asyncio.run(self.http.serve_forever(on_started))
        except asyncio.CancelledError:
            pass  # stop() closed the listener
        self._stopped.wait()  # stop() has stopped the rest

    def stop(self) -> None:
        """Stop the scheduler (queued queries get a 503), then the speed
        overlays' pollers, the feedback and log posters (after what they
        hold) and the HTTP server."""
        if self._batcher is not None:
            self._batcher.stop()
        with self._lock:
            held, self._mips_daemon_held = self._mips_daemon_held, False
            overlays = list(self._speed_overlays)
        if held:
            mips_daemon.release()
        # stopped outside the lock: a poller's stop joins its thread
        for ov in overlays:
            if ov is not None:
                ov.stop()
        self._feedback_poster.stop()
        self._log_poster.stop()
        self.http.stop()
        self._stopped.set()


def _stop_request(ip: str, port: int, server_key: Optional[str],
                  scheme: str = "http", timeout: float = 5.0) -> int:
    """POST /stop → HTTP status (shared by ``pio undeploy`` and
    :meth:`PredictionServer.undeploy_existing`). Raises when nothing
    answers. https takes an unverified context (the reference's
    allowUnsafeSSL: self-signed server.conf material is the norm)."""
    import ssl

    url = f"{scheme}://{ip}:{port}/stop"
    if server_key:
        url += f"?accessKey={urllib.parse.quote(server_key, safe='')}"
    ctx = ssl._create_unverified_context() if scheme == "https" else None
    req = urllib.request.Request(url, method="POST", data=b"")
    try:
        with urllib.request.urlopen(req, timeout=timeout,
                                    context=ctx) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def undeploy(ip: str, port: int, server_key: Optional[str] = None,
             scheme: str = "http") -> bool:
    """POST /stop to a running server (commands/Engine.undeploy:341):
    True when it answered 200."""
    try:
        return _stop_request(ip, port, server_key, scheme=scheme) == 200
    except Exception:
        return False
