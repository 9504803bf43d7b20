"""``remote`` storage backend — client for the StorageServer.

The multi-box topology enabler: every DAO call is one
``POST /rpc`` round trip to a shared :class:`~.server.StorageServer`, so
an eventserver on box A, a trainer on box B, and N prediction servers all
see one store — the role PostgreSQL/HBase play for the reference
(data/.../storage/jdbc/StorageClient.scala:35-60). There is no SQL client library
in the loop: the protocol is the framework's own msgpack wire format
(storage/wire.py), and columnar training scans arrive as raw array
buffers.

Config::

    PIO_STORAGE_SOURCES_REMOTE_TYPE=remote
    PIO_STORAGE_SOURCES_REMOTE_URL=http://store-box:7077
    PIO_STORAGE_SOURCES_REMOTE_AUTHKEY=...   # optional shared key

Connections are persistent (HTTP/1.1 keep-alive) and per-thread.

The port's copy of incubator_predictionio_tpu/data/storage/remote.py. There
is no fallback: an unreachable storage server is a ``StorageError``, never a
local store. A request body is capped at ``utils/http.MAX_BODY_BYTES`` (64
MiB) by the server, so a model blob above it (a rank-128 ML-20M model is
~84.6 MB of factors) cannot be stored through ``Models.insert`` here: keep
MODELDATA on a shared filesystem (``localfs``) or on ``gcs`` for such models.
"""

from __future__ import annotations

import http.client
from typing import Any, Dict, Iterator, Tuple
from urllib.parse import urlsplit

from incubator_predictionio_tpu_torch.data.event import EventValidationError
from incubator_predictionio_tpu_torch.data.storage import base, wire
from incubator_predictionio_tpu_torch.data.storage.base import StorageClientConfig
from incubator_predictionio_tpu_torch.obs import trace as obs_trace

#: typed errors re-raised client-side; anything else maps to StorageError
_ERROR_TYPES: Dict[str, type] = {
    "ValueError": ValueError,
    "KeyError": KeyError,
    "EventValidationError": EventValidationError,
}


def _storage_error() -> type:
    from incubator_predictionio_tpu_torch.data.storage import StorageError

    return StorageError


def _ambiguous_error() -> type:
    from incubator_predictionio_tpu_torch.data.storage import AmbiguousWriteError

    return AmbiguousWriteError


def _unsupported_error() -> type:
    from incubator_predictionio_tpu_torch.data.storage import (
        UnsupportedMethodError,
    )

    return UnsupportedMethodError


class StorageClient(base.BaseStorageClient):
    """Keep-alive RPC channel to one StorageServer."""

    def __init__(self, config: StorageClientConfig):
        super().__init__(config)
        url = config.properties.get("URL")
        if not url:
            host = config.properties.get("HOST", "127.0.0.1")
            port = config.properties.get("PORT", "7077")
            url = f"http://{host}:{port}"
        parts = urlsplit(url)
        if parts.scheme not in ("http",):
            raise _storage_error()(
                f"remote storage URL must be http:// (got {url!r}); for TLS "
                "terminate at a proxy in front of the storage server")
        self.host = parts.hostname or "127.0.0.1"
        self.port = parts.port or 7077
        self.auth_key = config.properties.get("AUTHKEY")
        self.timeout = float(config.properties.get("TIMEOUT", "60"))
        from incubator_predictionio_tpu_torch.utils.http import (
            ClientConnectionPool,
            RetryPolicy,
        )

        self._pool = ClientConnectionPool(self.host, self.port,
                                          self.timeout)
        # the shared client retry choreography (utils/http.RetryPolicy):
        # one re-send over a fresh connection after a short jittered
        # backoff, bounded by the channel timeout as the overall
        # deadline. WHICH failures are safe to re-send stays decided in
        # rpc() below — only it knows whether the body reached the wire.
        self._retry = RetryPolicy(attempts=2, base_delay_s=0.05,
                                  max_delay_s=0.5,
                                  deadline_s=self.timeout)

    def _conn(self) -> http.client.HTTPConnection:
        return self._pool.get()

    def rpc(self, iface: str, prefix: str, method: str,
            args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> Any:
        body = wire.pack({
            "iface": iface, "prefix": prefix, "method": method,
            "args": list(args), "kwargs": kwargs,
        })
        headers = {"Content-Type": "application/x-msgpack"}
        # cross-process trace propagation: a storage RPC issued while
        # serving a request forwards the ambient trace ID + this hop's
        # parent span, so the storage server's span line joins the tree
        headers.update(obs_trace.client_headers())
        if self.auth_key:
            headers["X-Pio-Storage-Key"] = self.auth_key
        from incubator_predictionio_tpu_torch.utils.http import RetryableError

        # Retryability after a connection failure. Failures BEFORE the
        # request body went out (sent=False: connect error, send error on a
        # stale keep-alive) provably never executed server-side, so any
        # method retries once. After the body was sent, only idempotent
        # methods retry — a write like insert/import may already have
        # executed when the response is lost, and silently re-sending it
        # would commit the payload twice. A timeout after send is never
        # retried even for reads: the server is likely still executing the
        # call, and re-sending would run the same work twice concurrently.
        # The backoff/deadline choreography itself is the shared
        # RetryPolicy (utils/http.py); this closure only CLASSIFIES.
        def attempt() -> bytes:
            conn = self._conn()
            sent = False
            try:
                conn.request("POST", "/rpc", body=body, headers=headers)
                sent = True
                resp = conn.getresponse()
                return resp.read()
            except (http.client.HTTPException, ConnectionError, OSError) as e:
                conn.close()
                retryable = (not sent) or (
                    method in _IDEMPOTENT
                    and not isinstance(e, TimeoutError))
                ambiguous = sent and method not in _IDEMPOTENT
                if not sent:
                    state = "; the request was never sent — it was NOT applied"
                elif method in _IDEMPOTENT:
                    state = ""
                else:
                    state = ("; the call is not idempotent — it may or "
                             "may not have been applied")
                err_cls = (_ambiguous_error() if ambiguous
                           else _storage_error())
                err = err_cls(
                    f"storage server {self.host}:{self.port} failed "
                    f"during {iface}.{method} ({e!r})" + state)
                if retryable:
                    raise RetryableError(err) from e
                raise err from e

        payload = self._retry.call(attempt)
        msg = wire.unpack(payload)
        if msg.get("ok"):
            return msg.get("value")
        ename = msg.get("etype")
        if ename == "UnsupportedMethodError":
            raise _unsupported_error()(msg.get("error", ""))
        etype = _ERROR_TYPES.get(ename) or _storage_error()
        raise etype(msg.get("error", "remote storage error"))

    def close(self) -> None:
        self._pool.close_all()


#: methods safe to re-send after a lost response (reads, and writes whose
#: re-execution is a no-op: init/remove/delete/update are last-wins or
#: existence-keyed; insert/insert_batch/import_interactions are NOT)
_IDEMPOTENT = frozenset({
    "init", "remove", "get", "get_by_name", "get_all", "get_by_appid",
    "get_latest_completed", "get_completed", "find", "aggregate_properties",
    "scan_interactions", "delete", "update",
})


class _RemoteDAO:
    iface = ""

    def __init__(self, client: StorageClient, config: StorageClientConfig,
                 prefix: str = ""):
        self.client = client
        self.prefix = prefix

    def _call(self, method: str, *args: Any, **kwargs: Any) -> Any:
        return self.client.rpc(self.iface, self.prefix, method, args, kwargs)


def _forward(name: str):
    def method(self, *args: Any, **kwargs: Any) -> Any:
        return self._call(name, *args, **kwargs)

    method.__name__ = name
    return method


def _proxy(iface: str, base_cls: type, methods: Tuple[str, ...],
           extra: Dict[str, Any] | None = None) -> type:
    ns: Dict[str, Any] = {m: _forward(m) for m in methods}
    ns["iface"] = iface
    ns.update(extra or {})
    return type(f"Remote{iface}", (_RemoteDAO, base_cls), ns)


def _events_find(self, *args: Any, **kwargs: Any) -> Iterator:
    """Lazy, chunked find: the server streams FIND_CHUNK-sized pages
    through a cursor (server.py _find_rpc), so the wire and the CLIENT
    hold at most one chunk of Event objects at a time. (The server's peak
    depends on the backing backend's own ``find`` — sqlite pre-fetches its
    row set — but row tuples are far lighter than wire-encoded Events, and
    the multi-GB single response this replaces is gone.)"""
    def gen() -> Iterator:
        msg = self._call("find_open", *args, **kwargs)
        cursor = msg["cursor"]
        try:
            while True:
                for event in msg["events"]:
                    yield event
                if msg["done"]:
                    cursor = ""
                    return
                msg = self._call("find_next", cursor)
        finally:
            if cursor:  # abandoned mid-iteration: free the server cursor
                try:
                    self._call("find_close", cursor)
                except Exception:
                    pass

    return gen()


def _events_close(self) -> None:  # connection is client-owned
    return None


def _events_tail_cursor(self, *args: Any, **kwargs: Any) -> Any:
    """Sharded backends return a VectorCursor (a tuple subclass); msgpack
    flattens it to a plain list, so rewrap sequences client-side — the
    freshness controller's ``cursor < last`` reset trigger depends on the
    vector comparison semantics, not just the int() sum."""
    cur = self._call("tail_cursor", *args, **kwargs)
    if isinstance(cur, (list, tuple)):
        return base.VectorCursor(cur)
    return cur


def _events_read_interactions_since(self, cursor, *args: Any,
                                    **kwargs: Any) -> Any:
    if isinstance(cursor, tuple):  # VectorCursor → wire-safe list
        cursor = list(cursor)
    inter, times, append_ms, new_cursor, reset = self._call(
        "read_interactions_since", cursor, *args, **kwargs)
    if isinstance(new_cursor, (list, tuple)):
        new_cursor = base.VectorCursor(new_cursor)
    return inter, times, append_ms, new_cursor, reset


def _events_insert_interactions(self, *args: Any, **kwargs: Any) -> Any:
    """Columnar id-returning insert over the wire, with the capability
    answer cached: a box backed by a store without a columnar write path
    answers UnsupportedMethodError ONCE, and every later call fails
    locally (no per-batch round trip; the EventServer's fast path then
    stays off for the process)."""
    if getattr(self, "_columnar_insert_unsupported", False):
        raise _unsupported_error()(
            "remote backend has no columnar insert (cached answer)")
    try:
        return self._call("insert_interactions", *args, **kwargs)
    except Exception as e:
        if isinstance(e, _unsupported_error()):
            self._columnar_insert_unsupported = True
        raise


RemoteEvents = _proxy(
    "Events", base.Events,
    ("init", "remove", "insert", "insert_batch", "get", "delete",
     "aggregate_properties", "scan_interactions", "import_interactions",
     "replication_status", "replication_read", "replication_apply",
     "replication_configure", "replication_reset"),
    extra={"find": _events_find, "close": _events_close,
           "insert_interactions": _events_insert_interactions,
           "tail_cursor": _events_tail_cursor,
           "read_interactions_since": _events_read_interactions_since},
)
#: find_close retries safely (popping a cursor twice is a no-op). find_open
#: retries too: a stale keep-alive connection otherwise fails the *first*
#: find after an idle period even though the request usually never reached
#: the server, and the worst case — a lost response orphaning one server
#: cursor — is already bounded by the server's idle-age cursor eviction.
#: find_next is stateful by design — a lost pull loses its chunk.
#: Replication verbs are position-keyed: replication_apply carries its
#: from_entry, so a replayed apply whose first send landed is a server-side
#: no-op (local count already past from_entry) — safe to re-send. The rest
#: are reads or idempotent configuration.
_IDEMPOTENT = _IDEMPOTENT | {
    "find_close", "find_open", "tail_cursor", "read_interactions_since",
    "replication_status", "replication_read", "replication_apply",
    "replication_configure", "replication_reset",
}
RemoteApps = _proxy(
    "Apps", base.Apps,
    ("insert", "get", "get_by_name", "get_all", "update", "delete"))
RemoteAccessKeys = _proxy(
    "AccessKeys", base.AccessKeys,
    ("insert", "get", "get_all", "get_by_appid", "update", "delete"))
RemoteChannels = _proxy(
    "Channels", base.Channels,
    ("insert", "get", "get_by_appid", "delete"))
RemoteEngineInstances = _proxy(
    "EngineInstances", base.EngineInstances,
    ("insert", "get", "get_all", "get_latest_completed", "get_completed",
     "update", "delete"))
RemoteEvaluationInstances = _proxy(
    "EvaluationInstances", base.EvaluationInstances,
    ("insert", "get", "get_all", "get_completed", "update", "delete"))
RemoteEngineManifests = _proxy(
    "EngineManifests", base.EngineManifests,
    ("insert", "get", "get_all", "update", "delete"))
RemoteModels = _proxy(
    "Models", base.Models, ("insert", "get", "delete"))


DATA_OBJECTS = {
    "Events": RemoteEvents,
    "Apps": RemoteApps,
    "AccessKeys": RemoteAccessKeys,
    "Channels": RemoteChannels,
    "EngineInstances": RemoteEngineInstances,
    "EngineManifests": RemoteEngineManifests,
    "EvaluationInstances": RemoteEvaluationInstances,
    "Models": RemoteModels,
}
