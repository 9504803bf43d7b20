"""PredictionServer — query serving from device-resident model state.

Port of incubator_predictionio_tpu/servers/prediction_server.py
(:258-1213; reference core/.../workflow/CreateServer.scala):

- ``GET  /``             → status JSON: engine instance, algorithms, device,
  request count, average and last serving seconds, this process's
  kernel launches by kernel (``runtime.launch_counts``), the speed
  overlays' counts summed (``speedOverlay``) and the seconds since the
  served instance finished training (``modelStalenessSec``);
- ``POST /queries.json`` → parse → supplement → predict (every algorithm)
  → serve with the original query; 400 on a malformed body;
- ``POST /stop``         → shut down (``accessKey`` = the server key, else
  server.conf's key when it enforces one; 401 otherwise).

Queries are served in a batch when :meth:`_handle_batch` is given several
bodies; it keeps the reference's split between the rendered-bytes fast
path (``batch_serve_json``) and the object path. The HTTP front end is the
standard library's ``ThreadingHTTPServer``: one thread per connection, each
query one call of ``_handle_batch``.

Two ways to build one: from models in hand (``PredictionServer(engine,
engine_params, models)``), or as ``pio deploy`` does, from a
:class:`ServerConfig` (``PredictionServer(engine, config=...)``): the
explicit engine instance or the latest COMPLETED one of the engine id,
version and variant (:meth:`_resolve_instance`), its params read back
(``Engine.engine_params_from_instance``) and its models restored on the
device (``CoreWorkflow.load_models`` → ``Engine.prepare_deploy``) when the
server starts; :meth:`undeploy_existing` first stops a server at the same
address, and :func:`undeploy` is ``pio undeploy``.

:meth:`load_models` also builds the speed layer: one overlay per
algorithm that offers one (``PIO_SPEED_LAYER``, default on), polling the
event log's tail on a thread of its own (``PIO_SPEED_POLL_S``). Calling
:meth:`load_models` again is the hot swap: the new overlays adopt the
old ones' keys, and the old ones are emptied and stopped. The writer of
the log must be this process (an ``EventServer`` on the same store):
one cpplog log is never opened by two live processes, and the remote
backend that lets ``pio deploy`` read another process's log is not
ported (ROADMAP.md Queue 1 item 1.6b).

Not ported yet: the continuous-batching scheduler (ROADMAP.md Queue 1
item 3), tenancy, ``/reload``, plugins, the feedback loop and
``--log-url`` (item 8; given either, :class:`PredictionServer` raises
``NotImplementedError``).
"""

from __future__ import annotations

import dataclasses
import http.server
import json
import logging
import os
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, List, Optional

from incubator_predictionio_tpu_torch import runtime
from incubator_predictionio_tpu_torch.core.base import Serving
from incubator_predictionio_tpu_torch.core.engine import Engine
from incubator_predictionio_tpu_torch.core.params import EngineParams
from incubator_predictionio_tpu_torch.data.storage import (
    EngineInstance,
    Storage,
)
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext
from incubator_predictionio_tpu_torch.utils import json_codec
from incubator_predictionio_tpu_torch.utils.times import (
    ensure_aware,
    now_utc,
)
from incubator_predictionio_tpu_torch.workflow.workflow import CoreWorkflow

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ServerConfig:
    """What ``pio deploy`` passes (CreateServer.scala:89-113 ServerConfig;
    the JAX package's, without its scheduler's ``micro_batch`` and
    ``serve_workers``, ROADMAP.md Queue 1 item 3, and without the
    feedback loop's event-server address and access key and the log
    shipper's prefix, item 8)."""

    ip: str = "0.0.0.0"
    port: int = 8000
    engine_instance_id: Optional[str] = None  # default: latest COMPLETED
    engine_id: str = "default"
    engine_version: str = "NOT_VERSIONED"
    engine_variant: str = "default"
    feedback: bool = False
    server_key: Optional[str] = None  # auth for /stop
    log_url: Optional[str] = None


class PredictionServer:
    """Serves one model per algorithm of an engine's params on ``device``
    (CUDA unless told otherwise): ``models`` in hand, moved to the device
    here, or, with ``models`` None, the stored engine instance that
    ``config`` names, restored when the server starts. With a ``config``
    the server binds to its ``ip`` and ``port``, else to ``host`` and
    ``port``."""

    def __init__(self, engine: Engine,
                 engine_params: Optional[EngineParams] = None,
                 models: Optional[List[Any]] = None, device=None,
                 host: str = "127.0.0.1", port: int = 0, *,
                 config: Optional[ServerConfig] = None):
        if config is not None and config.feedback:
            raise NotImplementedError(
                "deploy --feedback (the feedback loop) is not ported yet: "
                "ROADMAP.md Queue 1 item 8")
        if config is not None and config.log_url:
            raise NotImplementedError(
                "deploy --log-url (query-error shipping) is not ported "
                "yet: ROADMAP.md Queue 1 item 8")
        self.engine = engine
        self.config = config or ServerConfig(ip=host, port=port)
        self.ctx = RuntimeContext(device=device)
        self.engine_instance: Optional[EngineInstance] = None
        self.engine_params = engine_params
        self.algorithms: List[Any] = []
        self.serving: Any = None
        self.models: List[Any] = []
        #: algorithm-aligned speed overlays (None where an algorithm has
        #: none), built by :meth:`load_models`
        self._speed_overlays: List[Any] = []
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
        self.start_time = time.time()
        self.request_count = 0
        self.avg_serving_sec = 0.0
        self.last_serving_sec = 0.0
        self._httpd: Optional[http.server.ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()

    # -- deploy lifecycle (CreateServer.scala:207-308) ---------------------
    def _resolve_instance(self) -> EngineInstance:
        """The explicit engine instance, else the latest COMPLETED one of
        the config's engine id, version and variant."""
        instances = Storage.get_meta_data_engine_instances()
        c = self.config
        if c.engine_instance_id:
            instance = instances.get(c.engine_instance_id)
            if instance is None:
                raise ValueError(
                    f"Invalid engine instance ID {c.engine_instance_id}.")
            return instance
        instance = instances.get_latest_completed(
            c.engine_id, c.engine_version, c.engine_variant)
        if instance is None:
            raise ValueError(
                "No valid engine instance found for engine "
                f"{c.engine_id} {c.engine_version} {c.engine_variant}. The "
                "engine id is derived from the engine directory's absolute "
                "path: if the engine was trained from a different path, "
                "its instances are keyed under a different id; deploy from "
                "the training path or pass --engine-instance-id.")
        return instance

    def load_models(self) -> None:
        """Resolve the instance, read its params back and restore its
        models on the device (``CoreWorkflow.load_models`` →
        ``Engine.prepare_deploy``), build their speed overlays, then serve
        them. Called again, it is the hot swap (JAX :448-505): the new
        overlays adopt the old ones' keys, which they re-solve against
        the new factors, and the old overlays are emptied and stopped."""
        instance = self._resolve_instance()
        engine_params = self.engine.engine_params_from_instance(instance)
        models = CoreWorkflow.load_models(instance.id, self.engine,
                                          engine_params, ctx=self.ctx)
        algorithms, serving = self.engine.components(engine_params)
        overlays = self._build_speed_overlays(engine_params, algorithms,
                                              models)
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
        foreign process holds the port, and the bind will say so."""
        if self.config.port == 0:
            return  # an ephemeral port: nothing can hold it
        ip = self.config.ip if self.config.ip != "0.0.0.0" else "127.0.0.1"
        try:
            status = _stop_request(ip, self.config.port, self._server_key())
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
    def _handle_batch(self, bodies: List[bytes]) -> List[Any]:
        """Serve a batch of query bodies in one pass. Each entry of the
        result is response bytes (fast path), a jsonable result (object
        path) or the exception that query raised; one bad query never
        fails its batchmates."""
        t0 = time.perf_counter()
        algorithms, serving, models = self.algorithms, self.serving, self.models
        n = len(bodies)
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
        # serving's own class, and the identity supplement
        if (len(algorithms) == 1
                and type(serving).__dict__.get("FIRST_PREDICTION_ONLY", False)
                and type(serving).supplement is Serving.supplement):
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
        parsed: List[Any] = []  # [idx, query, supplemented]
        for idx in range(n):
            if results[idx] is not None:
                continue
            try:
                query = (json_codec.extract(query_class, raws[idx])
                         if query_class is not None else raws[idx])
                parsed.append((idx, query, serving.supplement(query)))
            except Exception as e:
                results[idx] = e
        # one prediction per algorithm per live query; a batch of more
        # than one goes through the algorithm's batched path
        preds = {idx: [] for idx, _q, _s in parsed}
        for a, m in zip(algorithms, models):
            live = [(idx, supp) for idx, _q, supp in parsed
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
        for idx, query, _supp in parsed:
            if results[idx] is not None:
                continue
            try:
                # serve sees the ORIGINAL query (CreateServer.scala:526)
                results[idx] = json_codec.to_jsonable(
                    serving.serve(query, preds[idx]))
            except Exception as e:
                results[idx] = e
        dt = time.perf_counter() - t0
        with self._lock:
            self.request_count += n
            self.avg_serving_sec += (dt - self.avg_serving_sec) * n \
                / self.request_count
            self.last_serving_sec = dt
        return results

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
            }

    # -- HTTP ---------------------------------------------------------------
    def _make_handler(self):
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _send(self, code: int, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type",
                                 "application/json; charset=UTF-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, obj: Any) -> None:
                self._send(code, json.dumps(obj).encode("utf-8"))

            def do_GET(self):  # noqa: N802 (http.server's naming)
                if self.path.split("?", 1)[0] != "/":
                    return self._json(404, {"message": "Not Found"})
                self._json(200, server.status())

            def do_POST(self):  # noqa: N802
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length)
                path, _, query = self.path.partition("?")
                if path == "/stop":
                    key = server._server_key()
                    given = urllib.parse.parse_qs(query).get("accessKey")
                    if key is not None and (given or [None])[0] != key:
                        return self._json(401,
                                          {"message": "Invalid accessKey."})
                    # after the answer is on its way; daemonized, so a
                    # process torn down first is not held by the timer
                    timer = threading.Timer(0.2, server.stop)
                    timer.daemon = True
                    timer.start()
                    return self._json(200, {"message": "Shutting down."})
                if path != "/queries.json":
                    return self._json(404, {"message": "Not Found"})
                res = server._handle_batch([body])[0]
                if isinstance(res, (bytes, bytearray)):
                    return self._send(200, bytes(res))
                if isinstance(res, (ValueError, KeyError)):
                    # malformed JSON or a query that does not extract
                    return self._json(400, {"message": str(res)})
                if isinstance(res, Exception):
                    logger.error("query failed", exc_info=res)
                    return self._json(500, {"message": str(res)})
                self._json(200, res)

            def log_message(self, fmt, *args):
                logger.debug("%s " + fmt, self.address_string(), *args)

        return Handler

    def _bind(self) -> None:
        """Restore the instance's models when there are none yet, stop a
        server deployed at the same address, then bind."""
        if self.engine_params is None:
            self.load_models()
        self.undeploy_existing()
        self._httpd = http.server.ThreadingHTTPServer(
            (self.config.ip, self.config.port), self._make_handler())
        self._httpd.daemon_threads = True

    def start_background(self) -> int:
        """Bind and serve on a daemon thread; returns the bound port."""
        self._bind()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pio-prediction-server",
            daemon=True)
        self._thread.start()
        logger.info("PredictionServer started on %s:%d", self.config.ip,
                    self._httpd.server_address[1])
        return self._httpd.server_address[1]

    def serve_forever(self, on_started=None) -> None:
        """Bind and serve on this thread until :meth:`stop` (``POST
        /stop``); ``on_started(port)`` is called once bound."""
        self._bind()
        if on_started is not None:
            on_started(self._httpd.server_address[1])
        self._httpd.serve_forever()
        self._stopped.wait()  # stop() closes the socket after the loop

    def stop(self) -> None:
        """Stop serving, the speed overlays' pollers with it, and close
        the socket."""
        for ov in self._speed_overlays:
            if ov is not None:
                ov.stop()
        httpd = self._httpd
        if httpd is not None:
            self._httpd = None
            httpd.shutdown()
            httpd.server_close()
            if self._thread is not None:
                self._thread.join(timeout=10)
        self._stopped.set()


def _stop_request(ip: str, port: int, server_key: Optional[str],
                  timeout: float = 5.0) -> int:
    """POST /stop → HTTP status (shared by ``pio undeploy`` and
    :meth:`PredictionServer.undeploy_existing`). Raises when nothing
    answers."""
    url = f"http://{ip}:{port}/stop"
    if server_key:
        url += f"?accessKey={urllib.parse.quote(server_key, safe='')}"
    req = urllib.request.Request(url, method="POST", data=b"")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def undeploy(ip: str, port: int, server_key: Optional[str] = None) -> bool:
    """POST /stop to a running server (commands/Engine.undeploy:341):
    True when it answered 200."""
    try:
        return _stop_request(ip, port, server_key) == 200
    except Exception:
        return False
