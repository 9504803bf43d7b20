"""Asyncio HTTP/1.1 micro-framework — the spray/akka replacement.

The port's own copy of incubator_predictionio_tpu/utils/http.py,
its imports pointed at this package.

The reference runs four spray-can servers (EventServer :7070, PredictionServer
:8000, Dashboard :9000, AdminAPI :7071) on akka actors. Here one small
dependency-free asyncio server underlies all of them: routed handlers, JSON
helpers, keep-alive, and a thread-pool bridge for the synchronous storage
DAOs (the moral equivalent of the reference's ``Future { ... }`` blocks
around blocking storage calls, e.g. EventServer.scala:97).

Deliberately minimal: Content-Length bodies (no chunked uploads), HTTP/1.1
keep-alive. TLS termination is available by passing an ``ssl_context``
(built from server.conf by utils/ssl_config.py — the reference's
SSLConfiguration keystore equivalent); otherwise run behind a terminating
proxy.
"""

from __future__ import annotations

import asyncio
import contextvars
import dataclasses
import errno
import inspect
import json
import logging
import random
import re
import socket
import ssl
import threading
import time
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qsl, unquote, urlsplit

from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
from incubator_predictionio_tpu_torch.obs import trace as obs_trace

logger = logging.getLogger(__name__)

#: request telemetry every server shares (docs/observability.md). The
#: route label is the ROUTE PATTERN (bounded set), never the raw path —
#: `/events/{event_id}.json` stays one series no matter how many ids
#: pass through it; unrouted paths collapse into one `<unmatched>`.
_HTTP_REQUESTS = obs_metrics.REGISTRY.counter(
    "pio_http_requests_total",
    "HTTP requests served, by server/method/route pattern/status",
    labels=("server", "method", "route", "status"))
_HTTP_LATENCY = obs_metrics.REGISTRY.histogram(
    "pio_http_request_seconds",
    "HTTP request wall (dispatch to response), by server/route pattern",
    labels=("server", "route"))
_UNMATCHED_ROUTE = "<unmatched>"

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 64 * 1024 * 1024

STATUS_TEXT = {
    200: "OK", 201: "Created", 202: "Accepted", 204: "No Content",
    301: "Moved Permanently", 302: "Found", 400: "Bad Request",
    401: "Unauthorized", 403: "Forbidden", 404: "Not Found",
    405: "Method Not Allowed", 413: "Payload Too Large",
    500: "Internal Server Error", 502: "Bad Gateway",
    503: "Service Unavailable", 504: "Gateway Timeout",
}


class HttpError(Exception):
    """Raise from a handler to produce a JSON error response.

    ``headers`` (an attribute, default empty) ride the error response —
    the scheduler's 503 shed carries its ``Retry-After`` contract this
    way (serving/scheduler.py ShedError)."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message
        # per-instance, never a class-level dict: an in-place mutation
        # must not leak the header onto every other error response
        self.headers: Dict[str, str] = {}


class RetryableError(Exception):
    """Wraps a failure that is safe to retry under a :class:`RetryPolicy`.

    The CALLER decides retryability (it knows whether the request body
    ever reached the wire, whether the verb is idempotent, whether a 503
    shed said come back later) and wraps only those failures; everything
    else propagates immediately. ``retry_after_s`` carries a
    server-directed minimum delay (the ``Retry-After`` contract the
    scheduler's shed responses ride)."""

    def __init__(self, cause: BaseException,
                 retry_after_s: Optional[float] = None):
        super().__init__(str(cause))
        self.cause = cause
        self.retry_after_s = retry_after_s


def parse_retry_after(value: Optional[str]) -> Optional[float]:
    """``Retry-After`` header → seconds (delta-seconds form only; the
    HTTP-date form is ignored — nothing in this repo emits it)."""
    if not value:
        return None
    try:
        return max(float(value.strip()), 0.0)
    except ValueError:
        return None


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """THE one copy of HTTP-client retry choreography: jittered
    exponential backoff under an overall deadline, honoring a
    server-directed ``Retry-After``, idempotent-only by default.

    Before this existed every client grew its own loop (the remote
    storage RPC channel, the GCS driver, the prediction server's
    feedback POSTs) and they drifted — fixed delays, no deadline, no
    Retry-After. The ``unbounded-retry`` pio-lint rule now flags new
    ad-hoc loops outside this module; adopters call :meth:`call` with a
    closure that wraps retry-SAFE failures in :class:`RetryableError`
    (see data/storage/remote.py for the sent/idempotent discipline).
    """

    #: total tries (1 = no retry)
    attempts: int = 3
    base_delay_s: float = 0.2
    multiplier: float = 2.0
    max_delay_s: float = 5.0
    #: overall budget across every attempt AND backoff sleep — a retry
    #: that cannot finish before the deadline is not attempted
    deadline_s: float = 30.0
    #: fraction of each delay randomized away (decorrelates a thundering
    #: herd of clients retrying the same outage in lockstep)
    jitter_frac: float = 0.5

    def backoff_s(self, attempt: int,
                  retry_after_s: Optional[float] = None,
                  rand: Callable[[], float] = random.random) -> float:
        """Delay before retry number ``attempt+1`` (attempt is 0-based).
        A server-directed ``Retry-After`` sets the floor — backing off
        LESS than the server asked would re-offer load it just shed."""
        delay = min(self.base_delay_s * (self.multiplier ** attempt),
                    self.max_delay_s)
        delay *= 1.0 - self.jitter_frac * rand()
        if retry_after_s is not None:
            delay = max(delay, retry_after_s)
        return delay

    def call(self, fn: Callable[[], Any], *, idempotent: bool = True,
             clock: Callable[[], float] = time.monotonic,
             sleep: Callable[[float], None] = time.sleep) -> Any:
        """Run ``fn()`` under this policy.

        ``fn`` raises :class:`RetryableError` around failures it judged
        safe to re-send; any other exception propagates unretried. With
        ``idempotent=False`` nothing retries (the wrap is ignored) —
        the policy is idempotent-only by default, because a lost
        RESPONSE never proves the request was not applied. On
        exhaustion the ORIGINAL cause is re-raised, so callers keep
        their typed errors."""
        deadline = clock() + self.deadline_s
        attempt = 0
        while True:
            try:
                return fn()
            except RetryableError as e:
                delay = self.backoff_s(attempt, e.retry_after_s)
                attempt += 1
                if (not idempotent or attempt >= self.attempts
                        or clock() + delay > deadline):
                    raise e.cause
                sleep(delay)


class Request:
    def __init__(
        self,
        method: str,
        path: str,
        query: Dict[str, str],
        headers: Dict[str, str],
        body: bytes,
        path_params: Optional[Dict[str, str]] = None,
    ):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body
        self.path_params = path_params or {}

    def json(self) -> Any:
        if not self.body:
            raise ValueError("Empty request body")
        try:
            return json.loads(self.body.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"Invalid JSON body: {e}") from e

    def form(self) -> Dict[str, str]:
        return dict(parse_qsl(self.body.decode("utf-8", "replace")))


class Response:
    def __init__(
        self,
        status: int = 200,
        json_body: Any = None,
        body: Optional[bytes] = None,
        content_type: str = "application/json; charset=UTF-8",
        headers: Optional[Dict[str, str]] = None,
    ):
        self.status = status
        if json_body is not None:
            body = json.dumps(json_body).encode("utf-8")
        self.body = body or b""
        self.content_type = content_type
        self.headers = headers or {}

    def encode(self, keep_alive: bool) -> bytes:
        reason = STATUS_TEXT.get(self.status, "Unknown")
        lines = [
            f"HTTP/1.1 {self.status} {reason}",
            f"Content-Type: {self.content_type}",
            f"Content-Length: {len(self.body)}",
            "Connection: " + ("keep-alive" if keep_alive else "close"),
            "Server: pio-tpu",
        ]
        for k, v in self.headers.items():
            lines.append(f"{k}: {v}")
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + self.body


Handler = Callable[[Request], "Response | Awaitable[Response]"]


#: headers a CORS-enabled router grants on OPTIONS preflight
#: (CorsSupport.scala:34-45 — AllOrigins + the standard request headers)
CORS_ALLOW_HEADERS = (
    "Origin, X-Requested-With, Content-Type, Accept, Accept-Encoding, "
    "Accept-Language, Host, Referer, User-Agent"
)


class Router:
    """Method + path routing with ``{param}`` segments and a catch-all
    ``{tail...}`` form. ``cors=True`` adds ``Access-Control-Allow-Origin: *``
    to every response and answers OPTIONS preflights with the allowed
    methods (the dashboard's CorsSupport trait,
    tools/.../dashboard/CorsSupport.scala:30-66)."""

    def __init__(self, cors: bool = False) -> None:
        self._routes: List[Tuple[str, re.Pattern, Handler, str]] = []
        self.cors = cors

    def allowed_methods(self, path: str) -> List[str]:
        return sorted({
            m for m, pattern, _h, _p in self._routes if pattern.match(path)
        })

    _PARAM_RE = re.compile(r"\{([a-zA-Z_][a-zA-Z0-9_]*)(\.\.\.)?\}")

    def add(self, method: str, pattern: str, handler: Handler) -> None:
        regex = ["^"]
        for part in pattern.split("/"):
            if not part:
                continue
            regex.append("/")
            # a segment may embed params: "{event_id}.json", "{name}.form"
            pos = 0
            for m in self._PARAM_RE.finditer(part):
                regex.append(re.escape(part[pos:m.start()]))
                if m.group(2):  # {tail...} catch-all
                    regex.append(f"(?P<{m.group(1)}>.*)")
                else:
                    regex.append(f"(?P<{m.group(1)}>[^/]+?)")
                pos = m.end()
            regex.append(re.escape(part[pos:]))
        if pattern.endswith("/") or pattern == "/":
            regex.append("/?")
        regex.append("$")
        self._routes.append(
            (method.upper(), re.compile("".join(regex)), handler, pattern))

    def get(self, pattern: str):
        return lambda h: (self.add("GET", pattern, h), h)[1]

    def post(self, pattern: str):
        return lambda h: (self.add("POST", pattern, h), h)[1]

    def delete(self, pattern: str):
        return lambda h: (self.add("DELETE", pattern, h), h)[1]

    def resolve(
        self, method: str, path: str
    ) -> Tuple[Optional[Handler], Dict[str, str], bool, Optional[str]]:
        """(handler, params, path_exists, route_pattern). The pattern
        comes back even on a method mismatch, so 405s and CORS
        preflights book under the real route label — `<unmatched>` is
        reserved for paths no route knows at all."""
        path_matched = False
        matched_route: Optional[str] = None
        for m, pattern, handler, route in self._routes:
            match = pattern.match(path)
            if match:
                path_matched = True
                if matched_route is None:
                    matched_route = route
                if m == method:
                    return handler, {
                        k: unquote(v) for k, v in match.groupdict().items()
                    }, True, route
        return None, {}, path_matched, matched_route


class ClientConnectionPool:
    """Thread-local keep-alive HTTP(S) connections to one host.

    The single copy of client connection lifecycle shared by the
    remote-storage RPC channel (data/storage/remote.py) and the GCS
    driver (data/storage/gcs.py) — retry choreography layers on top via
    :class:`RetryPolicy` (the callers still own retryABILITY: only they
    know whether a given failure left the request unsent).
    ``get()`` returns this thread's connection (created on first
    use; ``http.client`` transparently reconnects a closed one on the
    next request), ``drop()`` discards this thread's connection so the
    next ``get()`` builds a fresh object, ``close_all()`` closes every
    connection the pool ever handed out."""

    def __init__(self, host: str, port: int, timeout: float,
                 tls: bool = False):
        import http.client as _hc

        self._cls = _hc.HTTPSConnection if tls else _hc.HTTPConnection
        self.host = host
        self.port = port
        self.timeout = timeout
        self._local = threading.local()
        self._lock = threading.Lock()
        self._conns: list = []

    def get(self):
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._cls(self.host, self.port, timeout=self.timeout)
            self._local.conn = conn
            with self._lock:
                self._conns.append(conn)
        return conn

    def drop(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def close_all(self) -> None:
        with self._lock:
            for conn in self._conns:
                try:
                    conn.close()
                except Exception:
                    pass
            self._conns.clear()
        self._local = threading.local()


class HttpServer:
    """One listening socket + a router. Synchronous handlers and the
    ``sync()`` helper run on the default thread pool so blocking DAO work
    never stalls the event loop."""

    def __init__(self, router: Router, host: str = "0.0.0.0", port: int = 0,
                 ssl_context: Optional["ssl.SSLContext"] = None,
                 bind_retries: int = 0, bind_retry_delay: float = 1.0,
                 name: str = "http"):
        self.router = router
        self.host = host
        # written once by the loop thread (the bound port) before the
        # `_started` Event publishes it to waiters; verified by
        # pio-lint's unguarded-shared-state pass (docs/lint.md)
        self.port = port  # pio-lint: publish-only
        #: `server` label on the shared request metrics + span logs
        self.name = name
        self.ssl_context = ssl_context
        #: extra bind attempts after a failed bind (occupied port), each
        #: after ``bind_retry_delay`` seconds — MasterActor retries 3×/1 s
        #: (CreateServer.scala:371-381)
        self.bind_retries = bind_retries
        self.bind_retry_delay = bind_retry_delay
        # single-writer (the loop thread), `_started`-Event-sequenced
        self._server: Optional[asyncio.AbstractServer] = None  # pio-lint: publish-only
        self._loop: Optional[asyncio.AbstractEventLoop] = None  # pio-lint: publish-only
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()

    @classmethod
    def from_conf(cls, router: Router, host: str = "0.0.0.0",
                  port: int = 0, bind_retries: int = 0,
                  name: str = "http") -> "HttpServer":
        """Server with TLS material from server.conf when configured
        (the reference mixes SSLConfiguration into every server)."""
        from incubator_predictionio_tpu_torch.utils.ssl_config import load_ssl_config

        return cls(router, host, port,
                   ssl_context=load_ssl_config().ssl_context(),
                   bind_retries=bind_retries, name=name)

    # -- request cycle -----------------------------------------------------
    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            while True:
                try:
                    head = await reader.readuntil(b"\r\n\r\n")
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    return
                except asyncio.LimitOverrunError:
                    writer.write(Response(413, {"message": "headers too large"})
                                 .encode(False))
                    await writer.drain()
                    return
                if len(head) > MAX_HEADER_BYTES:
                    writer.write(Response(413, {"message": "headers too large"})
                                 .encode(False))
                    await writer.drain()
                    return
                request, keep_alive = await self._read_request(reader, head)
                if request is None:
                    writer.write(Response(400, {"message": "bad request"})
                                 .encode(False))
                    await writer.drain()
                    return
                response = await self._dispatch(request)
                writer.write(response.encode(keep_alive))
                await writer.drain()
                if not keep_alive:
                    return
        except Exception:
            logger.exception("connection handler error")
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _read_request(
        self, reader: asyncio.StreamReader, head: bytes
    ) -> Tuple[Optional[Request], bool]:
        try:
            text = head.decode("latin-1")
            lines = text.split("\r\n")
            method, target, _version = lines[0].split(" ", 2)
            headers: Dict[str, str] = {}
            for line in lines[1:]:
                if not line:
                    continue
                name, _, value = line.partition(":")
                headers[name.strip().lower()] = value.strip()
            length = int(headers.get("content-length", "0") or "0")
            if length < 0 or length > MAX_BODY_BYTES:
                return None, False
            body = await reader.readexactly(length) if length else b""
            parts = urlsplit(target)
            query = dict(parse_qsl(parts.query, keep_blank_values=True))
            keep_alive = headers.get("connection", "keep-alive").lower() != "close"
            return (
                Request(method.upper(), parts.path or "/", query, headers, body),
                keep_alive,
            )
        except (ValueError, asyncio.IncompleteReadError):
            return None, False

    async def _dispatch(self, request: Request) -> Response:
        """Route + run the handler, wrapped in the shared request
        telemetry (docs/observability.md): trace-ID stamping, the
        per-route counter + latency histogram, and the JSON span log.
        All of it is host-side bookkeeping on the event loop — one
        counter add, one histogram add, one header — never a device
        touch."""
        t0 = time.perf_counter()
        trace_id = obs_trace.accept_trace_id(
            request.headers.get("x-pio-trace-id"))
        # cross-process parenting: an in-repo client hop stamps its own
        # span ID in X-PIO-Parent-Span (obs_trace.client_headers), so
        # this request's span line links under the upstream span
        parent_span = obs_trace.accept_parent_span(
            request.headers.get("x-pio-parent-span"))
        span_id = obs_trace.new_span_id()
        token = obs_trace.set_current(trace_id)
        span_token = obs_trace.set_current_span(span_id)
        try:
            response, route = await self._dispatch_routed(request)
        finally:
            obs_trace.reset_current_span(span_token)
            obs_trace.reset_current(token)
        dt = time.perf_counter() - t0
        route_label = route or _UNMATCHED_ROUTE
        _HTTP_REQUESTS.labels(
            server=self.name, method=request.method, route=route_label,
            status=str(response.status)).inc()
        _HTTP_LATENCY.labels(server=self.name, route=route_label).observe(dt)
        # the propagation contract is unconditional and status-blind:
        # error responses (4xx/5xx) echo the trace ID and emit their
        # span line exactly like the happy path — a failing hop is the
        # one an operator most needs to find in the tree
        response.headers.setdefault(obs_trace.TRACE_HEADER, trace_id)
        response.headers.setdefault(obs_trace.SPAN_HEADER, span_id)
        # span sampling (PIO_TRACE_SAMPLE): the JSON line is the one
        # per-request cost that scales with QPS; sampled-out requests
        # still got their trace ID stamped and echoed above
        if obs_trace.span_sampled():
            obs_trace.log_span(self.name, request.method, route_label,
                               response.status, dt, trace_id,
                               span_id=span_id,
                               parent_span_id=parent_span)
        return response

    async def _dispatch_routed(
        self, request: Request
    ) -> Tuple[Response, Optional[str]]:
        """(response, matched route pattern or None)."""
        handler, params, path_exists, route = self.router.resolve(
            request.method, request.path
        )
        if handler is None:
            if self.router.cors and path_exists \
                    and request.method == "OPTIONS":
                # CORS preflight for a resource that answers other methods
                # (CorsSupport.scala:49-62)
                methods = self.router.allowed_methods(request.path)
                return self._with_cors(Response(200, headers={
                    "Access-Control-Allow-Methods":
                        ", ".join(["OPTIONS"] + methods),
                    "Access-Control-Allow-Headers": CORS_ALLOW_HEADERS,
                    "Access-Control-Max-Age": "1728000",
                })), route
            if path_exists:
                return self._with_cors(
                    Response(405, {"message": "Method Not Allowed"})), route
            return self._with_cors(
                Response(404, {"message": "Not Found"})), route
        request.path_params = params
        try:
            if inspect.iscoroutinefunction(handler):
                result = await handler(request)
            else:
                loop = asyncio.get_running_loop()
                # copy_context: run_in_executor does not propagate
                # contextvars by itself, and sync handlers must see the
                # ambient trace ID (obs_trace.current_trace_id)
                ctx = contextvars.copy_context()
                result = await loop.run_in_executor(
                    None, ctx.run, handler, request)
                if inspect.isawaitable(result):
                    result = await result
            return self._with_cors(result), route
        except HttpError as e:
            return self._with_cors(
                Response(e.status, {"message": e.message},
                         headers=dict(e.headers))), route
        except Exception as e:
            logger.exception("handler error for %s %s", request.method,
                             request.path)
            return self._with_cors(
                Response(500, {"message": str(e)})), route

    def _with_cors(self, response: Response) -> Response:
        if self.router.cors:
            response.headers.setdefault("Access-Control-Allow-Origin", "*")
        return response

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        attempt = self.bind_retries
        while True:
            try:
                self._server = await asyncio.start_server(
                    self._handle_conn, self.host, self.port,
                    limit=MAX_HEADER_BYTES, ssl=self.ssl_context,
                )
                break
            except OSError as e:
                # only an occupied port is transient; EACCES, gaierror
                # etc. can never clear, so fail fast on those
                if attempt <= 0 or e.errno != errno.EADDRINUSE:
                    raise
                attempt -= 1
                logger.error(
                    "Bind to %s:%d failed (%s). Retrying... "
                    "(%d more trial(s))", self.host, self.port, e, attempt + 1)
                await asyncio.sleep(self.bind_retry_delay)
        self.port = self._server.sockets[0].getsockname()[1]
        self._started.set()
        logger.info("http%s server listening on %s:%d",
                    "s" if self.ssl_context else "", self.host, self.port)

    async def serve_forever(
        self, on_started: Optional[Callable[[int], None]] = None
    ) -> None:
        """Bind, then serve until cancelled. ``on_started`` (if given)
        runs once with the KERNEL-assigned port after the bind — the
        ephemeral-bind (`port=0`) announcement hook: a parent that
        pre-picks a "free" port instead is racing every other process
        on the box for it."""
        await self.start()
        assert self._server is not None
        if on_started is not None:
            on_started(self.port)
        async with self._server:
            await self._server.serve_forever()

    def wait_started(self, timeout: Optional[float] = None) -> bool:
        """True once the server has bound (or False on timeout / when the
        startup errored — callers gating work on a live listener should
        treat False as "not serving")."""
        if not self._started.wait(timeout):
            return False
        return getattr(self, "_start_error", None) is None

    def start_background(self) -> int:
        """Run the server on a daemon thread; returns the bound port."""
        # loop-thread writes sequenced by the `_started` Event
        self._start_error: Optional[BaseException] = None  # pio-lint: publish-only

        def _run() -> None:
            try:
                asyncio.run(self.serve_forever())
            except asyncio.CancelledError:
                pass  # normal stop() path
            except BaseException as e:
                if self._started.is_set():
                    # post-startup crash: the waiter is long gone — make
                    # the dead listener loud instead of vanishing silently
                    logger.exception("http server died after startup")
                self._start_error = e
                self._started.set()  # unblock the waiter; error checked there

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name=f"pio-http-{self.name}")
        self._thread.start()
        timeout = 10 + self.bind_retries * self.bind_retry_delay
        if not self._started.wait(timeout):
            raise RuntimeError("http server failed to start")
        if self._start_error is not None:
            raise RuntimeError(
                f"http server failed to start: {self._start_error}")
        return self.port

    def stop(self) -> None:
        loop, server = self._loop, self._server
        if loop is not None and server is not None:
            try:
                loop.call_soon_threadsafe(server.close)
            except RuntimeError:
                pass  # loop already closed (server stopped itself)


async def sync(fn: Callable[..., Any], *args: Any) -> Any:
    """Run a blocking callable on the thread pool (spray's detach())."""
    return await asyncio.get_running_loop().run_in_executor(None, fn, *args)
