"""EventServer — REST event collection.

Route/contract parity with data/.../api/EventServer.scala:148-530 on :7070:

- ``GET  /``                        → ``{"status": "alive"}``
- ``POST /events.json``             → 201 ``{"eventId": ...}``
- ``GET  /events/<id>.json``        → 200 event | 404
- ``DELETE /events/<id>.json``      → 200 ``{"message": "Found"}`` | 404
- ``GET  /events.json``             → query (startTime/untilTime/entityType/
  entityId/event/targetEntityType/targetEntityId/limit/reversed)
- ``POST /batch/events.json``       → ≤50 events, per-event status list
- ``GET  /stats.json``              → ingest counters (with ``--stats``)
- ``POST /webhooks/<name>.json``    → JSON connector ingest (+ GET probe)
- ``POST /webhooks/<name>.form``    → form connector ingest (+ GET probe)
- ``GET  /plugins.json`` and ``/plugins/...`` plugin passthrough
- ``POST /reload``                  → sync the store (ingest front door)
- ``GET  /metrics``                 → Prometheus exposition
- ``GET  /recorder``                → the flight recorder's window
  (obs/recorder.py)

The port's copy of incubator_predictionio_tpu/servers/event_server.py, on
the port's storage, HTTP layer and native body parser. A batch of
8 or more uniform interactions takes the native body parse
(``uniform_interactions_from_body``) and one columnar insert where the
event store has one (the port's SQLite and cpplog stores have; a missing
native library raises); a body the parser declines takes the doc-level
gate, then the generic per-event path. The dispatch reads the store's
declared flags as the JAX server does: ``FAST_LOCAL`` (memory) ingests on
the event loop, ``GROUP_COMMIT`` (cpplog) sends every ingest route to the
pool so concurrent batches merge into one native append, whose counters
``GET /stats.json`` shows as ``groupCommit``; ``POST /reload`` syncs a
store whose client can (cpplog's fdatasync). Over a ``remote`` store the
two answers of the JAX server hold: a storage server whose backend has no
columnar insert answers ``UnsupportedMethodError`` once and the columnar
legs stay off for the process; an ``AmbiguousWriteError`` (the response of
a write lost after the request was sent) is a 500 with its message, never a
retry on another path, so a batch is stored at most once.

Auth (EventServer.scala:93-131): ``accessKey`` query param (with optional
``channel``), or HTTP Basic where the username is the access key. 401
missing/invalid key; 401 invalid channel. Per-event allowed-names check
(:275) → 403.
"""

from __future__ import annotations

import base64
import dataclasses
import logging
from typing import Any, Optional, Tuple

from incubator_predictionio_tpu_torch.data import webhooks
from incubator_predictionio_tpu_torch.data.event import Event, EventValidationError
from incubator_predictionio_tpu_torch.data.storage import (
    AmbiguousWriteError,
    Storage,
    UnsupportedMethodError,
)
from incubator_predictionio_tpu_torch.data.webhooks import ConnectorError
from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
from incubator_predictionio_tpu_torch.obs.http import (
    add_metrics_route,
    add_recorder_route,
)
from incubator_predictionio_tpu_torch.servers.plugins import EventInfo, PluginContext
from incubator_predictionio_tpu_torch.servers.stats import Stats
from incubator_predictionio_tpu_torch.data.storage.base import UNSET as _UNSET_Q
from incubator_predictionio_tpu_torch.utils.http import (
    HttpError,
    HttpServer,
    Request,
    Response,
    Router,
)
from incubator_predictionio_tpu_torch.utils.times import parse_iso8601

logger = logging.getLogger(__name__)

#: EventServer.scala:71
MAX_EVENTS_PER_BATCH = 50

#: per-EVENT ingest outcomes (the request-level counters live in the
#: shared HTTP layer): every booked event — accepted or rejected — adds
#: one here, labeled by route pattern and status, FEEDING the
#: reference-parity per-app hourly window in /stats.json, not
#: replacing it (these never rotate; scope = process lifetime)
_INGEST_EVENTS = obs_metrics.REGISTRY.counter(
    "pio_ingest_events_total",
    "events booked by the event server, by route pattern and status",
    labels=("route", "status"))
#: batch-request shape: how many events each /batch/events.json request
#: carried (the group-commit/columnar amortization depends on it)
_INGEST_BATCH_SIZE = obs_metrics.REGISTRY.histogram(
    "pio_ingest_batch_size",
    "events per POST /batch/events.json request",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))


@dataclasses.dataclass
class EventServerConfig:
    ip: str = "0.0.0.0"
    port: int = 7070
    stats: bool = False
    #: batch-route size cap. The default is the reference's wire contract
    #: (EventServer.scala:71 — 50 events per request); bulk loaders
    #: pointing at the columnar fast path can raise it (`pio eventserver
    #: --batch-cap N`) — a 500-event uniform batch amortizes the HTTP +
    #: JSON framing 10× further. Raising it changes the REST contract for
    #: THIS server only; SDK clients built against the reference keep
    #: working either way.
    max_batch: int = MAX_EVENTS_PER_BATCH


@dataclasses.dataclass(frozen=True)
class AuthData:
    """EventServer.scala:83 AuthData."""

    app_id: int
    channel_id: Optional[int]
    events: Tuple[str, ...]


class AuthError(HttpError):
    """401/403 rejection, converted to a JSON response by the http layer."""


class EventServer:
    def __init__(
        self,
        config: Optional[EventServerConfig] = None,
        plugin_context: Optional[PluginContext] = None,
    ):
        self.config = config or EventServerConfig()
        config = self.config
        self.events = Storage.get_events()
        self.access_keys = Storage.get_meta_data_access_keys()
        self.channels = Storage.get_meta_data_channels()
        self.stats = Stats()
        self.plugin_context = plugin_context or PluginContext()
        # set once a remote store answers UnsupportedMethodError to a
        # columnar insert: the batch fast paths stay off for the process
        self._columnar_unsupported = False
        self.router = self._build_router()
        self.http = HttpServer.from_conf(self.router, config.ip, config.port,
                                         name="event")

    # -- auth (EventServer.scala:93-131) ------------------------------------
    def _authenticate(self, request: Request) -> AuthData:
        key = request.query.get("accessKey")
        channel = request.query.get("channel")
        if key is None:
            auth = request.headers.get("authorization", "")
            if auth.startswith("Basic "):
                try:
                    decoded = base64.b64decode(auth[6:]).decode("utf-8")
                    key = decoded.strip().split(":")[0]
                except Exception:
                    raise AuthError(401, "Invalid accessKey.")
        if not key:
            raise AuthError(401, "Missing accessKey.")
        k = self.access_keys.get(key)
        if k is None:
            raise AuthError(401, "Invalid accessKey.")
        channel_id = None
        if channel is not None:
            channel_map = {
                c.name: c.id for c in self.channels.get_by_appid(k.appid)
            }
            if channel not in channel_map:
                raise AuthError(401, f"Invalid channel '{channel}'.")
            channel_id = channel_map[channel]
        return AuthData(k.appid, channel_id, tuple(k.events))

    def _check_allowed(self, auth: AuthData, event_name: str) -> None:
        if auth.events and event_name not in auth.events:
            raise AuthError(403, f"{event_name} events are not allowed")

    def _batch_fast_path(self, auth: AuthData, items) -> Optional[Response]:
        """Uniform batch → columnar insert, straight from the JSON docs.

        Returns None to hand the batch to the generic per-event path
        (non-uniform shape, or a storage failure — the generic path's
        bulk-then-retry semantics then apply from scratch). Per-event
        response isolation is preserved trivially: the gate guarantees a
        uniform event name, so the allowed-names check has one answer
        for every slot."""
        from incubator_predictionio_tpu_torch.data.storage.base import (
            uniform_interactions_from_docs,
        )

        fast = uniform_interactions_from_docs(items)
        if fast is None:
            return None
        return self._columnar_fast_response(auth, fast, len(items))

    _BATCH_ROUTE = "/batch/events.json"

    def _columnar_fast_response(self, auth: AuthData, fast,
                                n: int) -> Optional[Response]:
        """Post-gate leg shared by the doc-level and native-body fast
        paths: allowed-names check, one columnar insert, booking, and
        direct response rendering. Returns None to hand the batch to the
        generic path (storage failure — its bulk-then-retry semantics
        then apply from scratch)."""
        inter, etype, tetype, name, vprop, times = fast
        try:
            self._check_allowed(auth, name)
        except AuthError as e:
            for _ in range(n):
                self._book(auth, e.status, name, route=self._BATCH_ROUTE)
            return Response(200, [
                {"status": e.status, "message": e.message}] * n)
        try:
            ids = self.events.insert_interactions(
                inter, auth.app_id, auth.channel_id, entity_type=etype,
                target_entity_type=tetype, event_name=name,
                value_prop=vprop, times=times)
        except UnsupportedMethodError:
            # a remote box without a columnar write path answers this
            # (once — the proxy caches it); stay on the generic path for
            # the rest of the process, quietly
            self._columnar_unsupported = True
            logger.info(
                "event store has no columnar insert; batch fast path off")
            return None
        except AmbiguousWriteError as e:
            # the remote write MAY have been applied (response lost after
            # the request hit the wire) — re-inserting via the generic
            # path would duplicate the whole batch, so surface the
            # ambiguity instead; the client decides whether to re-POST
            logger.warning("columnar batch insert ambiguous: %s", e)
            return Response(500, {"message": str(e)})
        except Exception:
            logger.exception(
                "columnar batch insert failed; using the generic path")
            return None
        for _ in range(n):
            self._book(auth, 201, name, route=self._BATCH_ROUTE)
        # ids are our own 32-hex strings: render the uniform-status body
        # directly (no json.dumps tree walk on the hot path)
        body = ('[' + ",".join(
            '{"status":201,"eventId":"%s"}' % i for i in ids) + ']')
        return Response(200, body=body.encode("ascii"))

    # -- single-event insert pipeline ---------------------------------------
    def _sniff(self, info: "EventInfo") -> None:
        for sniffer in self.plugin_context.input_sniffers.values():
            try:
                sniffer.process(info, self.plugin_context)
            except Exception:
                logger.exception("input sniffer failed")

    def _insert(self, auth: AuthData, event: Event) -> str:
        """Allowed-names check + blocker veto + insert + sniffers.

        Validation errors surface as 400 from the *parse* step before this is
        called; exceptions here (blocker vetoes, storage failures) are server
        errors — 500, matching the reference's recover path
        (EventServer.scala:409-412).
        """
        self._check_allowed(auth, event.event)
        info = EventInfo(auth.app_id, auth.channel_id, event)
        for blocker in self.plugin_context.input_blockers.values():
            blocker.process(info, self.plugin_context)  # may raise to veto
        event_id = self.events.insert(event, auth.app_id, auth.channel_id)
        self._sniff(info)
        return event_id

    def _ingest(self, auth: AuthData, event: Event,
                route: str = "/events.json") -> Response:
        """Guarded insert shared by /events.json and the webhook routes so
        403/500 outcomes get identical responses and stats booking."""
        try:
            event_id = self._insert(auth, event)
        except AuthError as e:
            self._book(auth, e.status, event.event, route=route)
            raise
        except Exception as e:
            self._book(auth, 500, event.event, route=route)
            return Response(500, {"message": str(e)})
        self._book(auth, 201, event.event, route=route)
        return Response(201, {"eventId": event_id})

    @staticmethod
    def _parse_event(item: Any) -> Event:
        """JSON → validated Event; any failure here is a 400."""
        from incubator_predictionio_tpu_torch.data.event import validate_event

        event = Event.from_jsonable(item)
        validate_event(event)
        return event

    def _book(self, auth: AuthData, status: int, event_name: str,
              route: str = "/events.json") -> None:
        # registry counter always (process-wide, label-bounded by route
        # pattern + status); the per-app/per-event-name hourly window
        # stays behind --stats, exactly the reference contract
        _INGEST_EVENTS.labels(route=route, status=str(status)).inc()
        if self.config.stats:
            self.stats.update(auth.app_id, status, event_name)

    # -- routes -------------------------------------------------------------
    def _build_router(self) -> Router:
        r = Router()

        @r.get("/")
        def alive(request: Request) -> Response:
            return Response(200, {"status": "alive"})

        def _register_post(pattern: str, handler, *,
                           prefer_pool: bool = False) -> None:
            """Ingest hot-path dispatch policy: FAST_LOCAL backends
            (in-process index + native append, sub-ms inserts — memory,
            cpplog) run INLINE on the event loop; the executor round trip
            a sync handler pays (submit → pool thread → self-pipe wakeup)
            costs more than the insert itself and halves single-box REST
            throughput. Networked/disk-fsync backends keep the thread
            pool so a slow insert never stalls every connection — and so
            do requests while input plugins are registered (a blocker/
            sniffer may do arbitrary I/O; decided per REQUEST, since
            plugins can be present at startup only).

            Over a GROUP_COMMIT backend, EVERY ingest route goes to the
            pool (``prefer_pool``): pool threads let N in-flight batches
            merge into one native append, and the native call drops the
            GIL so the next request's Python runs under the previous
            request's C++ write. Crucially this must cover the
            single-event and generic-batch legs too, not just the batch
            fast path — those take the same storage lock, and an inline
            handler blocking the event loop on a lock a pool thread
            holds across a merged append would freeze every connection."""
            if getattr(self.events, "FAST_LOCAL", False) and not prefer_pool:
                async def dispatch(request, _h=handler):
                    ctx = self.plugin_context
                    if ctx.input_blockers or ctx.input_sniffers:
                        import asyncio

                        loop = asyncio.get_running_loop()
                        return await loop.run_in_executor(None, _h, request)
                    return _h(request)

                r.add("POST", pattern, dispatch)
            else:
                r.add("POST", pattern, handler)

        def create_event(request: Request) -> Response:
            auth = self._authenticate(request)
            try:
                event = self._parse_event(request.json())
            except (ValueError, EventValidationError) as e:
                self._book(auth, 400, "<error>")
                return Response(400, {"message": str(e)})
            return self._ingest(auth, event)

        # one policy for every ingest route: a group-committing backend
        # moves them ALL to the pool (see _register_post docstring)
        pool_ingest = getattr(self.events, "GROUP_COMMIT", False)

        _register_post("/events.json", create_event, prefer_pool=pool_ingest)

        @r.get("/events/{event_id}.json")
        def get_event(request: Request) -> Response:
            auth = self._authenticate(request)
            event = self.events.get(
                request.path_params["event_id"], auth.app_id, auth.channel_id
            )
            if event is None:
                return Response(404, {"message": "Not Found"})
            return Response(200, event.to_jsonable())

        @r.delete("/events/{event_id}.json")
        def delete_event(request: Request) -> Response:
            auth = self._authenticate(request)
            found = self.events.delete(
                request.path_params["event_id"], auth.app_id, auth.channel_id
            )
            if not found:
                return Response(404, {"message": "Not Found"})
            return Response(200, {"message": "Found"})

        @r.get("/events.json")
        def find_events(request: Request) -> Response:
            auth = self._authenticate(request)
            q = request.query
            try:
                def time(name: str):
                    return parse_iso8601(q[name]) if name in q else None

                limit = int(q["limit"]) if "limit" in q else 20
                reversed_ = q.get("reversed", "false").lower() == "true"
                events = list(self.events.find(
                    app_id=auth.app_id,
                    channel_id=auth.channel_id,
                    start_time=time("startTime"),
                    until_time=time("untilTime"),
                    entity_type=q.get("entityType"),
                    entity_id=q.get("entityId"),
                    event_names=[q["event"]] if "event" in q else None,
                    target_entity_type=q.get("targetEntityType", _UNSET_Q),
                    target_entity_id=q.get("targetEntityId", _UNSET_Q),
                    limit=limit,
                    reversed=reversed_,
                ))
            except ValueError as e:
                return Response(400, {"message": str(e)})
            if not events:
                return Response(404, {"message": "Not Found"})
            return Response(200, [e.to_jsonable() for e in events])

        def batch_events(request: Request) -> Response:
            auth = self._authenticate(request)
            # native-body fast path: raw bytes → columnar arrays in C++
            # (GIL-released; native/src/jsonparse.cc), skipping even
            # json.loads. Anything the strict-subset parser declines —
            # and any storage failure — falls through to the doc path
            # below, unchanged. The same ≥8 threshold as the doc gate
            # keeps small-batch storage behavior identical.
            if (not self.plugin_context.input_blockers
                    and not self.plugin_context.input_sniffers
                    and not self._columnar_unsupported
                    and hasattr(self.events, "insert_interactions")):
                from incubator_predictionio_tpu_torch.data.storage.base import (
                    uniform_interactions_from_body,
                )

                fast = uniform_interactions_from_body(
                    request.body, self.config.max_batch)
                if fast is not None and len(fast[0]) >= 8:
                    resp = self._columnar_fast_response(
                        auth, fast, len(fast[0]))
                    if resp is not None:
                        # the size histogram books exactly once per
                        # batch request, at whichever leg answers it
                        _INGEST_BATCH_SIZE.observe(len(fast[0]))
                        return resp
            try:
                items = request.json()
            except ValueError as e:
                return Response(400, {"message": str(e)})
            if not isinstance(items, list):
                return Response(400, {"message": "request body must be a JSON array"})
            if len(items) > self.config.max_batch:
                return Response(400, {
                    "message": (
                        "Batch request must have less than or equal to "
                        f"{self.config.max_batch} events"
                    )
                })
            _INGEST_BATCH_SIZE.observe(len(items))
            # doc-level columnar fast path: the uniform interaction shape
            # goes wire → native log without ever constructing Event
            # objects (parse+validate of 50 Events costs more than the
            # write). Only when no plugin needs per-Event visibility and
            # the backend can return ids for a columnar insert; anything
            # the gate rejects — and any storage failure — falls through
            # to the generic per-event path below, unchanged.
            if (len(items) >= 8
                    and not self.plugin_context.input_blockers
                    and not self.plugin_context.input_sniffers
                    and hasattr(self.events, "insert_interactions")
                    and not self._columnar_unsupported):
                resp = self._batch_fast_path(auth, items)
                if resp is not None:
                    return resp
            # gate per event (parse / allowed-names / blocker veto keep
            # per-event isolation, scala :409), then land every survivor
            # in ONE framed bulk write — the storage hot path the
            # reference pays per-event HBase puts for. If the bulk write
            # fails, fall back to per-event inserts so storage-error
            # isolation semantics stay identical to the reference.
            # Plugin visibility note: within ONE batch request, input
            # blockers observe storage as of the request start (events of
            # the same batch are not yet visible to later blockers) —
            # same as the reference's concurrent per-event futures, whose
            # within-batch write visibility was never ordered either.
            results: list = [None] * len(items)
            pending: list = []  # (index, event, info)
            for idx, item in enumerate(items):
                try:
                    event = self._parse_event(item)
                except (ValueError, EventValidationError) as e:
                    results[idx] = {"status": 400, "message": str(e)}
                    self._book(auth, 400, "<error>",
                               route=self._BATCH_ROUTE)
                    continue
                try:
                    self._check_allowed(auth, event.event)
                    info = EventInfo(auth.app_id, auth.channel_id, event)
                    for blocker in \
                            self.plugin_context.input_blockers.values():
                        blocker.process(info, self.plugin_context)
                except AuthError as e:
                    results[idx] = {"status": e.status, "message": e.message}
                    self._book(auth, e.status, event.event,
                               route=self._BATCH_ROUTE)
                    continue
                except Exception as e:
                    results[idx] = {"status": 500, "message": str(e)}
                    self._book(auth, 500, event.event,
                               route=self._BATCH_ROUTE)
                    continue
                pending.append((idx, event, info))
            ids: Optional[list] = None
            if pending:
                try:
                    ids = self.events.insert_batch(
                        [e for _, e, _ in pending], auth.app_id,
                        auth.channel_id)
                except AmbiguousWriteError as e:
                    # the remote write MAY have been applied — a per-event
                    # retry would duplicate the whole batch; fail the
                    # pending slots honestly and let the client decide
                    logger.warning("bulk insert ambiguous: %s", e)
                    for idx, event, _info in pending:
                        results[idx] = {"status": 500, "message": str(e)}
                        self._book(auth, 500, event.event,
                                   route=self._BATCH_ROUTE)
                    pending = []
                except Exception:
                    # Best-effort recovery window (documented): the failed
                    # bulk attempt rolls back its auto-id inserts, but a
                    # rollback-delete that itself fails (logged at warning
                    # by base.Events.insert_batch) leaves an event the
                    # per-event retry will DUPLICATE; and explicit-id
                    # events that landed before the failure are re-upserted
                    # here, which moves them to the end of their
                    # timestamp tie-break group relative to a clean single
                    # attempt. Operators reconciling after a 500-mixed
                    # batch response should check for both.
                    logger.exception(
                        "bulk insert failed; retrying per event")
            if ids is not None:
                for (idx, event, info), event_id in zip(pending, ids):
                    results[idx] = {"status": 201, "eventId": event_id}
                    self._book(auth, 201, event.event,
                               route=self._BATCH_ROUTE)
                    self._sniff(info)
            else:
                for idx, event, info in pending:
                    try:
                        event_id = self.events.insert(
                            event, auth.app_id, auth.channel_id)
                        results[idx] = {"status": 201, "eventId": event_id}
                        self._book(auth, 201, event.event,
                                   route=self._BATCH_ROUTE)
                        self._sniff(info)
                    except Exception as e:
                        results[idx] = {"status": 500, "message": str(e)}
                        self._book(auth, 500, event.event,
                                   route=self._BATCH_ROUTE)
            return Response(200, results)

        _register_post("/batch/events.json", batch_events,
                       prefer_pool=pool_ingest)
        # the SDKs' pluralized spelling of the batch route — the SAME
        # handler, so both spellings ride the native one-parse-per-batch
        # fast path and book pio_ingest_batch_size identically
        _register_post("/batches/events.json", batch_events,
                       prefer_pool=pool_ingest)

        @r.post("/reload")
        def reload_route(request: Request) -> Response:
            # the rolling-writer-reload seam (serving/frontdoor.py
            # IngestFrontDoor drains this writer, POSTs here, probes,
            # re-admits): push every buffered append to a durability
            # point so the reloaded writer rejoins with nothing only it
            # knows about. Safe under concurrent traffic — sync takes
            # the storage client's own lock.
            self._authenticate(request)
            client = getattr(self.events, "client", None)
            sync = getattr(client, "sync", None)
            if sync is None:
                # sqlite, memory and remote (durability is the storage
                # server's concern): no buffered appends to push; the
                # drain itself was the reload
                return Response(200, {"message": "Reloaded",
                                      "synced": False})
            try:
                sync()
            except Exception as e:
                return Response(500, {"message": f"sync failed: {e}"})
            return Response(200, {"message": "Reloaded", "synced": True})

        @r.get("/stats.json")
        def stats_route(request: Request) -> Response:
            auth = self._authenticate(request)
            if not self.config.stats:
                return Response(404, {
                    "message": "To see stats, launch Event Server with --stats argument."
                })
            body = self.stats.get(auth.app_id)
            gc_stats = getattr(self.events, "group_commit_stats", None)
            if gc_stats is not None:
                # additive key beyond the reference's Stats shape: how
                # well concurrent wire batches coalesced into appends.
                # Scope differs from the per-app hourly counters above —
                # the payload says so explicitly ("scope" field)
                body["groupCommit"] = gc_stats()
            return Response(200, body)

        # -- webhooks (EventServer.scala webhooks routes + Webhooks.scala) --
        @r.post("/webhooks/{name}.json")
        def webhook_json(request: Request) -> Response:
            auth = self._authenticate(request)
            connector = webhooks.json_connector(request.path_params["name"])
            if connector is None:
                return Response(404, {
                    "message": f"webhooks connection for {request.path_params['name']} is not supported."
                })
            try:
                event_json = connector.to_event_json(request.json())
                event = self._parse_event(event_json)
            except (ConnectorError, ValueError, EventValidationError) as e:
                self._book(auth, 400, "<error>",
                           route="/webhooks/{name}.json")
                return Response(400, {"message": str(e)})
            return self._ingest(auth, event, route="/webhooks/{name}.json")

        @r.get("/webhooks/{name}.json")
        def webhook_json_probe(request: Request) -> Response:
            self._authenticate(request)
            if webhooks.json_connector(request.path_params["name"]) is None:
                return Response(404, {"message": "Not Found"})
            return Response(200, {"message": "Ok"})

        @r.post("/webhooks/{name}.form")
        def webhook_form(request: Request) -> Response:
            auth = self._authenticate(request)
            connector = webhooks.form_connector(request.path_params["name"])
            if connector is None:
                return Response(404, {
                    "message": f"webhooks connection for {request.path_params['name']} is not supported."
                })
            try:
                event_json = connector.to_event_json(request.form())
                event = self._parse_event(event_json)
            except (ConnectorError, ValueError, EventValidationError) as e:
                self._book(auth, 400, "<error>",
                           route="/webhooks/{name}.form")
                return Response(400, {"message": str(e)})
            return self._ingest(auth, event, route="/webhooks/{name}.form")

        @r.get("/webhooks/{name}.form")
        def webhook_form_probe(request: Request) -> Response:
            self._authenticate(request)
            if webhooks.form_connector(request.path_params["name"]) is None:
                return Response(404, {"message": "Not Found"})
            return Response(200, {"message": "Ok"})

        @r.get("/plugins.json")
        def plugins_list(request: Request) -> Response:
            return Response(200, {
                "plugins": {
                    "inputblockers": {
                        n: {"name": n} for n in self.plugin_context.input_blockers
                    },
                    "inputsniffers": {
                        n: {"name": n} for n in self.plugin_context.input_sniffers
                    },
                }
            })

        @r.get("/plugins/{tail...}")
        def plugins_rest(request: Request) -> Response:
            parts = request.path_params["tail"].split("/")
            plugin = self.plugin_context.plugin(parts[0])
            if plugin is None:
                return Response(404, {"message": "Not Found"})
            return Response(
                200,
                plugin.handle_rest("/".join(parts[1:]), dict(request.query)),
            )

        add_metrics_route(r)
        add_recorder_route(r)
        return r

    # -- lifecycle ----------------------------------------------------------
    def start_background(self) -> int:
        port = self.http.start_background()
        logger.info("EventServer started on %s:%d", self.config.ip, port)
        return port

    async def serve_forever(self) -> None:
        await self.http.serve_forever()

    def stop(self) -> None:
        self.http.stop()


def create_event_server(
    config: Optional[EventServerConfig] = None,
) -> EventServer:
    """EventServer.createEventServer:614."""
    return EventServer(config)
