"""StorageServer — the shared-store network service.

Closes the reference's multi-box deployment topology: there, N event /
prediction servers share state through external services (PostgreSQL via
jdbc/StorageClient.scala:35-60, HBase, Elasticsearch). Here the same role
is played by ONE process owning a local backend (sqlite / cpplog / memory)
and exporting the complete DAO surface over HTTP: any number of
eventservers, prediction servers, and trainers on other boxes point their
``PIO_STORAGE_SOURCES_<N>_TYPE=remote`` at it and see one store.

Protocol: ``POST /rpc`` with a msgpack body
``{iface, prefix, method, args, kwargs}`` (storage/wire.py codec) →
msgpack ``{ok, value}`` / ``{ok: false, etype, error}``. Columnar scans
(``scan_interactions``) travel as raw array buffers, so remote training
ingest stays columnar end-to-end. Optional shared-key auth via the
``X-Pio-Storage-Key`` header (KeyAuthentication.scala's role).

Start via ``pio storageserver`` (cli) or embed :class:`StorageServer`.

The port's copy of incubator_predictionio_tpu/data/storage/server.py, on
the port's storage, HTTP layer and metrics. The router serves ``POST
/rpc``, ``GET /``, ``GET /metrics`` and ``GET /recorder`` (the flight
recorder's window, obs/recorder.py). One part differs:
:meth:`StorageServer.stop` also closes the connections its clients keep
alive (the JAX package's keeps answering on them from its closed
backend), so a stopped leader is gone for a follower as a killed one is.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, Optional, Tuple

from incubator_predictionio_tpu_torch.data.event import EventValidationError
from incubator_predictionio_tpu_torch.data.storage import (
    StorageError,
    UnsupportedMethodError,
    base,
    wire,
)
from incubator_predictionio_tpu_torch.utils.http import (
    HttpServer,
    Request,
    Response,
    Router,
)

logger = logging.getLogger(__name__)

#: iface → methods callable over RPC (the full DAO surface; everything
#: else 404s, so the server's attack surface is exactly this table).
#: ``find`` is served through the cursor protocol (find_open / find_next /
#: find_close): the response, the wire, and the client stay bounded at one
#: FIND_CHUNK of encoded Events per round trip (the backend's own ``find``
#: sets the server's peak — sqlite pre-fetches row tuples).
_ALLOWED: Dict[str, Tuple[str, ...]] = {
    "Events": (
        "init", "remove", "insert", "insert_batch", "get", "delete",
        "find_open", "find_next", "find_close",
        "aggregate_properties", "scan_interactions",
        "import_interactions", "insert_interactions",
        # speed-layer tail (vector cursors cross the wire as arrays)
        "tail_cursor", "read_interactions_since",
        # async replication verbs (leader: status/read; follower:
        # configure/apply/reset — see cpplog.py and ReplicationTail)
        "replication_status", "replication_read", "replication_apply",
        "replication_configure", "replication_reset",
    ),
    "Apps": ("insert", "get", "get_by_name", "get_all", "update", "delete"),
    "AccessKeys": ("insert", "get", "get_all", "get_by_appid", "update",
                   "delete"),
    "Channels": ("insert", "get", "get_by_appid", "delete"),
    "EngineInstances": ("insert", "get", "get_all", "get_latest_completed",
                        "get_completed", "update", "delete"),
    "EvaluationInstances": ("insert", "get", "get_all", "get_completed",
                            "update", "delete"),
    "EngineManifests": ("insert", "get", "get_all", "update", "delete"),
    "Models": ("insert", "get", "delete"),
}

#: exception types that cross the wire by name (client re-raises them)
_ERROR_TYPES = {
    "StorageError": StorageError,
    "UnsupportedMethodError": UnsupportedMethodError,
    "ValueError": ValueError,
    "KeyError": KeyError,
    "EventValidationError": EventValidationError,
}


#: events per find_next chunk — bounds both sides' memory per round trip
FIND_CHUNK = 5000
#: open cursors kept server-side before idle-age eviction kicks in (a
#: client that abandons iteration mid-way cannot pin server memory forever)
MAX_CURSORS = 64
#: a cursor pulled within this window is presumed live and is not evicted
#: at the soft cap — >MAX_CURSORS genuinely concurrent scans grow the table
#: instead of killing an active iteration mid-find
CURSOR_MIN_IDLE_S = 30.0
#: any cursor idle this long is evicted regardless of table size — bounds
#: the memory an orphaned cursor (e.g. from a retried find_open whose first
#: request did land) can pin on a low-traffic server
CURSOR_TTL_S = 600.0
#: absolute ceiling; beyond this the least-recently-pulled cursor goes even
#: if recently active (logged as possibly live). 2× the soft cap keeps the
#: worst-case memory pin near the old fixed-64 bound while still letting a
#: burst of genuinely concurrent scans complete.
MAX_CURSORS_HARD = MAX_CURSORS * 2


#: which repository kind serves each RPC interface in routed mode —
#: Events → EVENTDATA, Models → MODELDATA, every metadata DAO → METADATA
#: (the same mapping Storage's typed accessors use)
_IFACE_REPOSITORY: Dict[str, str] = {
    "Events": "EVENTDATA",
    "Models": "MODELDATA",
}


class ReplicationTail:
    """Follower-side async replication loop (the read scale-out /
    failover leg of the planet-scale ingest path, docs/production.md).

    Tails a leader StorageServer per (app, writer shard) with
    byte-level frame shipping — the cpplog ``replication_*`` verbs —
    so the follower's segment files stay bit-identical prefixes of the
    leader's: tombstone target indices, sidecars, and hashes all carry
    over, and a training scan on the follower returns exactly what the
    leader's would (read parity). The leader's per-shard REWRITE EPOCH
    is the resync signal: it moves only when segment bytes were
    rewritten (roll/compact/drop/leader restart after a rewrite), never
    on append-only growth, so deletes replicate as ordinary frames and
    a follower resyncs only when it must. Leader-unreachable polls log
    and retry — catch-up after a leader restart is the normal path, not
    an error. Exposes ``pio_replication_lag_events{shard}``."""

    def __init__(self, leader_url: str, local_events: Any, apps,
                 interval_s: float = 0.5, auth_key: Optional[str] = None,
                 prefix: str = "", max_bytes: int = 4 << 20):
        from incubator_predictionio_tpu_torch.data.storage import (
            remote as remote_mod,
        )

        props = {"URL": leader_url}
        if auth_key:
            props["AUTHKEY"] = auth_key
        cfg = base.StorageClientConfig(parallel=False, test=False,
                                       properties=props)
        self._rclient = remote_mod.StorageClient(cfg)
        self.remote = remote_mod.RemoteEvents(self._rclient, cfg,
                                              prefix=prefix)
        self.local = local_events
        self.apps = list(apps)
        self.interval_s = float(interval_s)
        self.max_bytes = int(max_bytes)
        # leader epochs as of the last successful sync, keyed
        # (app, shard); written by the tail thread, read by
        # wait_caught_up callers judging divergence
        self._epochs_mu = threading.Lock()
        self._epochs: Dict[Tuple[int, int], int] = {}  # pio-lint: guarded-by(_epochs_mu)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="pio-replication-tail", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        self._rclient.close()

    def wait_caught_up(self, timeout_s: float = 30.0) -> bool:
        """Block until every app's follower counts match the leader's
        (tests and failover drills); False on timeout or unreachable
        leader."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                if all(self._lag_total(a) == 0 for a in self.apps):
                    return True
            except Exception:
                pass
            if self._stop.wait(0.05):
                return False
        return False

    def _lag_total(self, app_id: int) -> int:
        st = self.remote.replication_status(app_id)
        lst = {s["shard"]: s
               for s in self.local.replication_status(app_id)["status"]}
        lag = 0
        with self._epochs_mu:
            epochs = dict(self._epochs)
        for rs in st["status"]:
            k = rs["shard"]
            ls = lst.get(k, {"cold": 0, "hot": 0, "total": 0})
            if (epochs.get((app_id, k)) != rs["epoch"]
                    or int(ls["cold"]) > int(rs["cold"])
                    or int(ls["hot"]) > int(rs["hot"])):
                # divergent prefix (leader compacted/restarted under
                # us): counts can COINCIDE while the bytes differ, so
                # the shard is behind until the next pass resets and
                # re-pulls it — never report 0 here
                lag += max(int(rs["total"]), 1)
                continue
            lag += max(int(rs["total"]) - int(ls["total"]), 0)
        return lag

    def _run(self) -> None:
        while not self._stop.is_set():
            for app_id in self.apps:
                if self._stop.is_set():
                    break
                try:
                    self._sync_app(app_id)
                except Exception:
                    # leader down / restarting: catch-up is the normal
                    # path — keep polling
                    logger.warning(
                        "replication poll failed for app %s (leader "
                        "unreachable? retrying)", app_id, exc_info=True)
            self._stop.wait(self.interval_s)

    def _sync_app(self, app_id: int) -> None:
        from incubator_predictionio_tpu_torch.data.storage import StorageError
        from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics

        st = self.remote.replication_status(app_id)
        self.local.replication_configure(app_id, shards=st["shards"])
        lst = {s["shard"]: s
               for s in self.local.replication_status(app_id)["status"]}
        gauge = obs_metrics.REGISTRY.gauge(
            "pio_replication_lag_events",
            "events the follower trails the leader by, per writer shard",
            labels=("shard",))
        for rs in st["status"]:
            k = rs["shard"]
            ls = lst.get(k, {"cold": 0, "hot": 0})
            key = (app_id, k)
            # resync on a rewrite-epoch move, or when the leader's file
            # went BACKWARDS past our prefix (restart with a torn tail)
            with self._epochs_mu:
                epoch_seen = self._epochs.get(key)
            if (epoch_seen != rs["epoch"]
                    or int(ls["cold"]) > int(rs["cold"])
                    or int(ls["hot"]) > int(rs["hot"])):
                self.local.replication_reset(app_id, shard=k)
                with self._epochs_mu:
                    self._epochs[key] = rs["epoch"]
                ls = {"cold": 0, "hot": 0}
            applied = 0
            try:
                for tier in ("cold", "hot"):
                    at = int(ls[tier])
                    want = int(rs[tier])
                    while at < want and not self._stop.is_set():
                        chunk = self.remote.replication_read(
                            app_id, shard=k, tier=tier, from_entry=at,
                            epoch=rs["epoch"],
                            max_bytes=self.max_bytes)
                        if not chunk["n_entries"]:
                            break
                        at = int(self.local.replication_apply(
                            app_id, shard=k, tier=tier, from_entry=at,
                            frames=chunk["frames"]))
                    applied += at
            except StorageError:
                # epoch moved mid-pull: next poll resyncs cleanly
                logger.info("replication epoch moved mid-pull "
                            "(app %s shard %d)", app_id, k)
                continue
            gauge.labels(shard=str(k)).set(
                max(int(rs["total"]) - applied, 0))


class StorageServer:
    """A storage source exported over HTTP.

    Two modes: a single backing backend (module, client, config), or —
    with ``module=None`` — REPOSITORY-ROUTED: each RPC interface resolves
    through this process's own `PIO_STORAGE_REPOSITORIES_*` env the way
    local Storage accessors do (Events to the EVENTDATA source, Models to
    MODELDATA, metadata DAOs to METADATA). Routed mode is what `pio
    storageserver` runs by default, so ONE box A process can own
    sqlite metadata + a cpplog event store + model blobs at once (the
    production 3-box topology, docs/production.md)."""

    def __init__(
        self,
        module: Any,
        client: Any,
        config: Optional[base.StorageClientConfig],
        host: str = "0.0.0.0",
        port: int = 0,
        auth_key: Optional[str] = None,
    ):
        self.module = module
        self.client = client
        self.config = config
        self.auth_key = auth_key
        self.replication: Optional[ReplicationTail] = None
        self._daos: Dict[Tuple[str, str], Any] = {}
        self._lock = threading.Lock()
        self._cursors: Dict[str, Any] = {}   # insertion-ordered
        self._cursor_seq = 0
        self.http = HttpServer.from_conf(self._router(), host, port,
                                         name="storage")

    @classmethod
    def from_env(cls, source: Optional[str] = None, host: str = "0.0.0.0",
                 port: int = 0, auth_key: Optional[str] = None
                 ) -> "StorageServer":
        """Back the server from the environment: with ``source`` set,
        export that one PIO_STORAGE_SOURCES_<NAME>; with ``source=None``
        (the `pio storageserver` default) run repository-routed."""
        from incubator_predictionio_tpu_torch.data.storage import Storage

        if source:
            client, module, config = Storage._get_client(source)
            srv = cls(module, client, config, host, port, auth_key)
            srv.maybe_start_replication()
            return srv
        # routed mode: resolve every repository's source NOW so a
        # misconfigured box refuses to start instead of failing
        # per-request after printing a healthy banner
        for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
            _ns, source_name = Storage.repository(repo)
            Storage._get_client(source_name)
        srv = cls(None, None, None, host, port, auth_key)
        srv.maybe_start_replication()
        return srv

    def maybe_start_replication(self) -> None:
        """``PIO_REPLICATE_FROM=<leader url>`` turns this storage
        server into an async replication FOLLOWER of that leader:
        a daemon tail thread ships frames for the apps listed in
        ``PIO_REPLICATE_APPS`` (comma-separated, default "1") every
        ``PIO_REPLICATE_INTERVAL_S`` (default 0.5s), and this server
        keeps serving reads — the scale-out/failover replica."""
        import os

        leader = os.environ.get("PIO_REPLICATE_FROM")
        if not leader:
            return
        try:
            apps = [int(a) for a in
                    os.environ.get("PIO_REPLICATE_APPS", "1").split(",")
                    if a.strip()]
        except ValueError:
            logger.error("bad PIO_REPLICATE_APPS; replication disabled")
            return
        try:
            interval = float(
                os.environ.get("PIO_REPLICATE_INTERVAL_S", "0.5"))
        except ValueError:
            interval = 0.5
        # the DAO table-name prefix of the event namespace being
        # replicated — must match the leader's EVENTDATA repository
        # name + "_" (the default mirrors the standard repository
        # config, PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME=pio_event)
        prefix = os.environ.get("PIO_REPLICATE_PREFIX", "pio_event_")
        self.replication = ReplicationTail(
            leader, self._dao("Events", prefix), apps,
            interval_s=interval, prefix=prefix,
            auth_key=os.environ.get("PIO_REPLICATE_AUTHKEY"))
        self.replication.start()
        logger.info("replication follower: tailing %s for apps %s",
                    leader, apps)

    def _dao(self, iface: str, prefix: str) -> Any:
        with self._lock:
            dao = self._daos.get((iface, prefix))
            if dao is None:
                if self.module is not None:
                    module, client, config = (self.module, self.client,
                                              self.config)
                else:  # repository-routed: resolve via this box's env
                    from incubator_predictionio_tpu_torch.data.storage import (
                        Storage,
                    )

                    repo = _IFACE_REPOSITORY.get(iface, "METADATA")
                    _ns, source_name = Storage.repository(repo)
                    client, module, config = Storage._get_client(source_name)
                cls = module.DATA_OBJECTS.get(iface)
                if cls is None:
                    raise StorageError(
                        f"backend {module.__name__} does not implement "
                        f"{iface}")
                dao = cls(client, config, prefix=prefix)
                self._daos[(iface, prefix)] = dao
            return dao

    def _router(self) -> Router:
        r = Router()

        @r.get("/")
        def status(request: Request) -> Response:
            if self.module is None:
                from incubator_predictionio_tpu_torch.data.storage import Storage

                repos = {}
                for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
                    try:
                        _ns, src = Storage.repository(repo)
                        repos[repo] = src
                    except Exception:
                        # can't normally happen: from_env validated the
                        # repos at startup — so an env drift is news
                        logger.exception("repository %s unresolvable", repo)
                        repos[repo] = None
                return Response(200, {
                    "status": "alive",
                    "backend": "repository-routed",
                    "repositories": repos,
                })
            return Response(200, {
                "status": "alive",
                "backend": self.module.__name__.rsplit(".", 1)[-1],
                "interfaces": sorted(self.module.DATA_OBJECTS),
            })

        @r.post("/rpc")
        def rpc(request: Request) -> Response:
            if self.auth_key is not None and \
                    request.headers.get("x-pio-storage-key") != self.auth_key:
                return _packed({"ok": False, "etype": "StorageError",
                                "error": "invalid storage key"}, 401)
            # sweep on EVERY rpc, not just find traffic: an orphaned cursor
            # (lost-response find_open retry, crashed client) on an
            # otherwise-quiet server must still age out past the TTL
            with self._lock:
                self._evict_cursors_locked()
            try:
                msg = wire.unpack(request.body)
                iface = msg["iface"]
                method = msg["method"]
                if method not in _ALLOWED.get(iface, ()):
                    raise StorageError(
                        f"method {iface}.{method} is not exported")
                dao = self._dao(iface, msg.get("prefix", ""))
                if method.startswith("find_"):
                    value = self._find_rpc(dao, method, msg)
                else:
                    impl = getattr(dao, method, None)
                    if impl is None:
                        # optional capability (e.g. columnar
                        # insert_interactions on a backend without a
                        # columnar write path) — typed so clients cache
                        # the answer instead of retrying per request
                        raise UnsupportedMethodError(
                            f"{iface}.{method} is not supported by the "
                            f"{type(dao).__name__} backend")
                    value = impl(
                        *msg.get("args", ()), **msg.get("kwargs", {}))
                return _packed({"ok": True, "value": value})
            except Exception as e:  # error crosses the wire, typed
                etype = type(e).__name__
                if etype not in _ERROR_TYPES:
                    logger.exception("storage rpc failed")
                    etype = "StorageError"
                return _packed({"ok": False, "etype": etype,
                                "error": str(e)})

        from incubator_predictionio_tpu_torch.obs.http import (
            add_metrics_route,
            add_recorder_route,
        )

        add_metrics_route(r)
        # the flight recorder's window: every server records
        add_recorder_route(r)
        return r

    # -- find cursor protocol ---------------------------------------------
    def _find_rpc(self, dao: Any, method: str, msg: Dict[str, Any]) -> Any:
        """Streamed Events.find: open runs the backend query and returns the
        first chunk + a cursor; next pulls more; close releases early."""
        import itertools

        if method == "find_open":
            it = iter(dao.find(*msg.get("args", ()), **msg.get("kwargs", {})))
            events = list(itertools.islice(it, FIND_CHUNK))
            done = len(events) < FIND_CHUNK
            cursor = ""
            if not done:
                with self._lock:
                    self._cursor_seq += 1
                    cursor = f"c{self._cursor_seq}"
                    self._cursors[cursor] = (it, time.monotonic())
                    self._evict_cursors_locked()
            return {"cursor": cursor, "events": events, "done": done}
        cursor = msg.get("args", [""])[0]
        if method == "find_close":
            with self._lock:
                self._cursors.pop(cursor, None)
            return None
        # pop while pulling: backend iterators are not thread-safe, so a
        # concurrent find_next on the same cursor sees "unknown cursor"
        # instead of a torn read
        with self._lock:
            entry = self._cursors.pop(cursor, None)
        if entry is None:
            raise StorageError(
                f"unknown find cursor {cursor!r} (expired, evicted, or "
                "pulled concurrently); re-issue the find")
        it = entry[0]
        events = list(itertools.islice(it, FIND_CHUNK))
        done = len(events) < FIND_CHUNK
        if not done:
            with self._lock:
                # re-insert moves the cursor to the tail, so dict order is
                # least-recently-pulled first — what eviction walks
                self._cursors[cursor] = (it, time.monotonic())
                self._evict_cursors_locked()
        return {"cursor": cursor, "events": events, "done": done}

    def _evict_cursors_locked(self) -> None:
        """Free abandoned cursors by idle age, not raw count: at the soft
        cap only cursors idle ≥ CURSOR_MIN_IDLE_S go (an active slow scan
        among >MAX_CURSORS concurrent finds survives); the hard cap evicts
        the least-recently-pulled regardless, honestly logged."""
        now = time.monotonic()
        # TTL sweep first: orphans (lost-response retries, crashed clients)
        # must not pin backend row sets forever even when the table is small
        while self._cursors:
            oldest = next(iter(self._cursors))
            if now - self._cursors[oldest][1] < CURSOR_TTL_S:
                break
            del self._cursors[oldest]
            logger.warning("evicted find cursor %s past %.0fs TTL",
                           oldest, CURSOR_TTL_S)
        while len(self._cursors) > MAX_CURSORS:
            oldest = next(iter(self._cursors))
            idle = now - self._cursors[oldest][1]
            if idle >= CURSOR_MIN_IDLE_S:
                del self._cursors[oldest]
                logger.warning(
                    "evicted find cursor %s idle %.0fs (abandoned?)",
                    oldest, idle)
            elif len(self._cursors) > MAX_CURSORS_HARD:
                del self._cursors[oldest]
                logger.warning(
                    "evicted find cursor %s at hard cap %d — it was pulled "
                    "%.0fs ago and may have been LIVE; that client's find "
                    "will fail mid-iteration", oldest, MAX_CURSORS_HARD,
                    idle)
            else:
                break  # all remaining cursors recently active; let it grow

    # -- lifecycle ---------------------------------------------------------
    def start_background(self) -> int:
        port = self.http.start_background()
        logger.info("StorageServer listening on :%d (backend %s)",
                    port,
                    self.module.__name__ if self.module is not None
                    else "repository-routed")
        return port

    async def serve_forever(self, on_started=None) -> None:
        """``on_started(port)`` fires after the bind — the ephemeral-
        bind announcement hook the CLI uses with ``--port 0``."""
        await self.http.serve_forever(on_started=on_started)

    def stop(self) -> None:
        # a stopped storage server answers nothing more: a client's
        # kept-alive connection must not reach a closed backend (a
        # follower would read a stopped leader's stale counts)
        self.http.stop(drop_connections=True)
        if self.replication is not None:
            self.replication.stop()
            self.replication = None
        if self.client is not None:
            self.client.close()
        # routed-mode backend clients belong to the process-global
        # Storage registry (Storage._get_client cache) — closing them
        # here would break this process's own accessors; Storage.reset
        # owns their lifecycle
        with self._lock:
            self._daos.clear()


def _packed(payload: Dict[str, Any], status: int = 200) -> Response:
    return Response(status, body=wire.pack(payload),
                    content_type="application/x-msgpack")
