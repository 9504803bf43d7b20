"""PredictionServer — query serving from device-resident model state.

Port of incubator_predictionio_tpu/servers/prediction_server.py
(:258-1213; reference core/.../workflow/CreateServer.scala):

- ``GET  /``             → status JSON: engine, algorithms, device, request
  count, average and last serving seconds;
- ``POST /queries.json`` → parse → supplement → predict (every algorithm)
  → serve with the original query; 400 on a malformed body.

Queries are served in a batch when :meth:`_handle_batch` is given several
bodies; it keeps the reference's split between the rendered-bytes fast
path (``batch_serve_json``) and the object path. The HTTP front end is the
standard library's ``ThreadingHTTPServer``: one thread per connection, each
query one call of ``_handle_batch``. A deployed engine's models come from
``workflow.CoreWorkflow.load_models`` (the checkpoint of a stored engine
instance). Not ported yet: the continuous-batching scheduler, tenancy, the
feedback loop, plugins and ``/reload``.
"""

from __future__ import annotations

import http.server
import json
import logging
import threading
import time
from typing import Any, List, Optional

from incubator_predictionio_tpu_torch.core.base import Serving
from incubator_predictionio_tpu_torch.core.engine import Engine
from incubator_predictionio_tpu_torch.core.params import EngineParams
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext
from incubator_predictionio_tpu_torch.utils import json_codec

logger = logging.getLogger(__name__)


class PredictionServer:
    """Serves ``models`` (one per algorithm of ``engine_params``) after
    moving them to ``device`` (CUDA unless told otherwise)."""

    def __init__(self, engine: Engine, engine_params: EngineParams,
                 models: List[Any], device=None, host: str = "127.0.0.1",
                 port: int = 0):
        self.ctx = RuntimeContext(device=device)
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
        self._address = (host, port)
        self._httpd: Optional[http.server.ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

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
            return {
                "status": "alive",
                "algorithms": [type(a).__name__ for a in self.algorithms],
                "device": str(self.ctx.device),
                "startTime": self.start_time,
                "requestCount": self.request_count,
                "avgServingSec": self.avg_serving_sec,
                "lastServingSec": self.last_serving_sec,
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
                if self.path.split("?", 1)[0] != "/queries.json":
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

    def start_background(self) -> int:
        """Bind and serve on a daemon thread; returns the bound port."""
        self._httpd = http.server.ThreadingHTTPServer(
            self._address, self._make_handler())
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pio-prediction-server",
            daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        """Stop serving and close the socket."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=10)
            self._httpd = None
