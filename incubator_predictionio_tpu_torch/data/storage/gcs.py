"""GCS object-store model blob backend (``TYPE=gcs``).

Parity: the reference stores model blobs on a distributed filesystem
(data/src/main/scala/org/apache/predictionio/data/storage/hdfs/
HDFSModels.scala); on a TPU pod deployment the shared store is a GCS
bucket, not a POSIX directory. This client speaks the **GCS JSON API
directly over HTTPS** — no SDK dependency (none is baked into the image),
and nothing the runtime needs beyond stdlib ``http.client``:

- **auth**: OAuth2 bearer token resolved in order from the ``TOKEN``
  source property, the ``GOOGLE_OAUTH_ACCESS_TOKEN`` env var, or the
  GCE/TPU-VM **metadata server** (the standard ambient identity on TPU
  pods — ``metadata.google.internal``), cached until shortly before
  expiry. No key-file crypto: on the hardware this targets, the metadata
  server is always there.
- **emulator**: the ``EMULATOR_HOST`` source property or the standard
  ``STORAGE_EMULATOR_HOST`` env var points the client at a plain-HTTP
  endpoint with auth disabled. The test suite runs the Models conformance
  suite against :class:`EmulatorServer` (below) so the real wire path —
  media upload, ``alt=media`` download, delete, 404 mapping, retry —
  is exercised end to end in-process.

Storage env shape (registry: ``data/storage/__init__.py``)::

    PIO_STORAGE_SOURCES_GCS_TYPE=gcs
    PIO_STORAGE_SOURCES_GCS_BUCKET=my-models-bucket
    PIO_STORAGE_SOURCES_GCS_BASE_PATH=pio/models        # optional prefix
    PIO_STORAGE_REPOSITORIES_MODELDATA_NAME=pio_model
    PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE=GCS

Only the ``Models`` interface is provided, exactly like the reference's
HDFS backend (metadata/events belong on sqlite/remote/cpplog).

The port's copy of incubator_predictionio_tpu/data/storage/gcs.py. It does
no device work.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import time
from typing import Dict, Optional
from urllib.parse import quote

from incubator_predictionio_tpu_torch.data.storage import base


def _storage_error() -> type:
    from incubator_predictionio_tpu_torch.data.storage import StorageError

    return StorageError


#: the GCE/TPU-VM metadata endpoint serving ambient service-account tokens
_METADATA_HOST = os.environ.get(
    "GCE_METADATA_HOST", "metadata.google.internal")
_TOKEN_PATH = ("/computeMetadata/v1/instance/service-accounts/"
               "default/token")


class StorageClient(base.BaseStorageClient):
    """Keep-alive JSON-API channel to one bucket.

    Connections are thread-local (the prediction/event servers call DAOs
    from worker threads); a connection-level failure closes and retries
    once — every operation here is idempotent (full-object PUT semantics,
    GET, DELETE), so the blind retry is safe."""

    def __init__(self, config: base.StorageClientConfig):
        super().__init__(config)
        props = config.properties
        self.bucket = props.get("BUCKET")
        if not self.bucket:
            raise _storage_error()(
                "gcs storage source needs PIO_STORAGE_SOURCES_<NAME>_BUCKET")
        self.base_path = props.get("BASE_PATH", "").strip("/")
        self.timeout = float(props.get("TIMEOUT", "60"))
        emulator = (props.get("EMULATOR_HOST")
                    or os.environ.get("STORAGE_EMULATOR_HOST"))
        if emulator:
            # accept the forms the ecosystem actually sets: bare
            # host:port, http(s)://host:port, optional trailing slash
            # (fake-gcs-server defaults to https://…:4443)
            from urllib.parse import urlsplit

            raw = emulator
            if "//" not in emulator:
                emulator = "http://" + emulator
            parts = urlsplit(emulator)
            try:
                port = parts.port  # lazily parsed; bad ports raise here
                host = parts.hostname
            except ValueError:
                port = host = None
            if not host or parts.scheme not in ("http", "https"):
                raise _storage_error()(
                    "unparseable GCS emulator address "
                    f"{raw!r} (from EMULATOR_HOST / STORAGE_EMULATOR_HOST)"
                    " — expected [http[s]://]host:port")
            self.tls = parts.scheme == "https"
            self.host = host
            self.port = port or (443 if self.tls else 80)
            self._fixed_token: Optional[str] = None
            self._auth = False
        else:
            self.host, self.port, self.tls = "storage.googleapis.com", 443, True
            self._fixed_token = (props.get("TOKEN")
                                 or os.environ.get(
                                     "GOOGLE_OAUTH_ACCESS_TOKEN"))
            self._auth = True
        from incubator_predictionio_tpu_torch.utils.http import (
            ClientConnectionPool,
        )

        self._pool = ClientConnectionPool(self.host, self.port,
                                          self.timeout, tls=self.tls)
        self._token: Optional[str] = None
        self._token_exp = 0.0
        self._token_lock = threading.Lock()

    # -- connection management ---------------------------------------------
    def _conn(self) -> http.client.HTTPConnection:
        return self._pool.get()

    def _drop_conn(self) -> None:
        self._pool.drop()

    def close(self) -> None:
        self._pool.close_all()

    # -- auth ---------------------------------------------------------------
    def _bearer(self) -> Optional[str]:
        if not self._auth:
            return None
        if self._fixed_token:
            return self._fixed_token
        with self._token_lock:
            if self._token and time.time() < self._token_exp:
                return self._token
            conn = http.client.HTTPConnection(_METADATA_HOST, timeout=10)
            try:
                conn.request("GET", _TOKEN_PATH,
                             headers={"Metadata-Flavor": "Google"})
                resp = conn.getresponse()
                payload = resp.read()
                if resp.status != 200:
                    raise _storage_error()(
                        f"metadata token fetch failed: HTTP {resp.status}")
                doc = json.loads(payload)
                self._token = doc["access_token"]
                # refresh a minute early so in-flight requests never carry
                # a token that expires mid-transfer
                self._token_exp = time.time() + float(
                    doc.get("expires_in", 300)) - 60.0
                return self._token
            except OSError as e:
                raise _storage_error()(
                    "no GCS credentials: set PIO_STORAGE_SOURCES_<N>_TOKEN "
                    "or GOOGLE_OAUTH_ACCESS_TOKEN, or run where the GCE "
                    f"metadata server is reachable ({e})") from e
            finally:
                conn.close()

    #: transient statuses Google's client guidance mandates retrying with
    #: exponential backoff — every operation this client issues is
    #: idempotent (full-object upload, GET, DELETE), so blind re-send is
    #: safe
    _RETRY_STATUSES = (429, 500, 502, 503, 504)
    _MAX_ATTEMPTS = int(os.environ.get("PIO_GCS_RETRIES", "4"))

    def request(self, method: str, path: str,
                body: Optional[bytes] = None,
                content_type: str = "application/octet-stream"):
        headers: Dict[str, str] = {}
        if body is not None:
            headers["Content-Type"] = content_type
        token = self._bearer()
        if token:
            headers["Authorization"] = f"Bearer {token}"
        last = "no attempt made"
        for attempt in range(self._MAX_ATTEMPTS):
            if attempt:
                # 0.5, 1, 2, … seconds; the emulator never hits this
                time.sleep(0.5 * (1 << (attempt - 1)))
            conn = self._conn()
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                payload = resp.read()
            except (http.client.HTTPException, ConnectionError,
                    OSError) as e:
                last = repr(e)
                self._drop_conn()
                continue
            if resp.status in self._RETRY_STATUSES:
                last = f"HTTP {resp.status} {payload[:200]!r}"
                continue
            return resp.status, payload
        raise _storage_error()(
            f"gcs request {method} {path} failed after "
            f"{self._MAX_ATTEMPTS} attempts: {last}")

    # -- object operations ---------------------------------------------------
    def _object_name(self, name: str) -> str:
        return f"{self.base_path}/{name}" if self.base_path else name

    def put_object(self, name: str, data: bytes) -> None:
        obj = quote(self._object_name(name), safe="")
        status, payload = self.request(
            "POST",
            f"/upload/storage/v1/b/{self.bucket}/o"
            f"?uploadType=media&name={obj}",
            body=data)
        if status not in (200, 201):
            raise _storage_error()(
                f"gcs upload of {name!r} failed: HTTP {status} "
                f"{payload[:200]!r}")

    def get_object(self, name: str) -> Optional[bytes]:
        obj = quote(self._object_name(name), safe="")
        status, payload = self.request(
            "GET", f"/storage/v1/b/{self.bucket}/o/{obj}?alt=media")
        if status == 404:
            # GCS reports a missing/inaccessible BUCKET as 404 too — a
            # typo'd bucket would otherwise read as "every model absent"
            # and deploys would silently fall back instead of surfacing
            # the config error. Probe the bucket once per process.
            self._check_bucket_once()
            return None
        if status != 200:
            raise _storage_error()(
                f"gcs download of {name!r} failed: HTTP {status} "
                f"{payload[:200]!r}")
        return payload

    _bucket_ok: Optional[bool] = None

    def _check_bucket_once(self) -> None:
        if self._bucket_ok:
            return
        status, payload = self.request(
            "GET", f"/storage/v1/b/{self.bucket}")
        if status == 404 and self._auth:
            # the bucket itself does not exist — a typo'd BUCKET, the one
            # misconfig that reads as "every model absent". Gate on
            # _auth (real GCS), not TLS: an https emulator
            # (fake-gcs-server's default) may lack bucket metadata or
            # auto-create buckets lazily, so its 404s are inconclusive.
            raise _storage_error()(
                f"gcs bucket {self.bucket!r} does not exist (HTTP 404 on "
                f"bucket metadata; {payload[:200]!r}) — check "
                "PIO_STORAGE_SOURCES_<N>_BUCKET; object reads were "
                "returning 404 for every id")
        # 200 = bucket readable. 403 is NOT a misconfig signal: a
        # least-privilege service account (roles/storage.objectAdmin —
        # objects only, no storage.buckets.get) legitimately cannot read
        # bucket metadata, and failing here would make Models.get() → None
        # unreachable on correctly-scoped credentials. Anything
        # inconclusive: accept and never re-probe.
        self._bucket_ok = True

    def delete_object(self, name: str) -> bool:
        obj = quote(self._object_name(name), safe="")
        status, payload = self.request(
            "DELETE", f"/storage/v1/b/{self.bucket}/o/{obj}")
        if status in (204, 200):
            return True
        if status == 404:
            return False
        raise _storage_error()(
            f"gcs delete of {name!r} failed: HTTP {status} "
            f"{payload[:200]!r}")


class GCSModels(base.Models):
    """Models DAO on a bucket (HDFSModels.scala role: one blob per
    engine-instance id)."""

    def __init__(self, client: StorageClient,
                 config: base.StorageClientConfig, prefix: str = ""):
        self.client = client
        self.prefix = prefix

    def _name(self, model_id: str) -> str:
        return f"{self.prefix}{model_id}"

    def insert(self, model: base.Model) -> None:
        self.client.put_object(self._name(model.id), model.models)

    def get(self, model_id: str) -> Optional[base.Model]:
        data = self.client.get_object(self._name(model_id))
        if data is None:
            return None
        return base.Model(model_id, data)

    def delete(self, model_id: str) -> None:
        self.client.delete_object(self._name(model_id))


DATA_OBJECTS = {"Models": GCSModels}


# ---------------------------------------------------------------------------
# In-process emulator (tests / local development)
# ---------------------------------------------------------------------------

class EmulatorServer:
    """Minimal GCS JSON-API emulator covering the subset this client
    speaks: media upload, ``alt=media`` download, delete, 404 mapping.
    Auth-free plain HTTP, like the official emulators — point the client
    at it via ``EMULATOR_HOST`` / ``STORAGE_EMULATOR_HOST``.

    Test/dev utility only; the conformance suite runs the real client
    through it so the wire path is what gets tested, not a file fake."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        from incubator_predictionio_tpu_torch.utils.http import (
            HttpServer,
            Response,
            Router,
        )

        self.objects: Dict[str, Dict[str, bytes]] = {}
        self._lock = threading.Lock()
        r = Router()

        @r.post("/upload/storage/v1/b/{bucket}/o")
        def upload(request):
            name = request.query.get("name", "")
            if not name or request.query.get("uploadType") != "media":
                return Response(400, {"error": "media upload only"})
            with self._lock:
                self.objects.setdefault(
                    request.path_params["bucket"], {})[name] = request.body
            return Response(200, {"name": name,
                                  "size": str(len(request.body))})

        @r.get("/storage/v1/b/{bucket}")
        def bucket_meta(request):
            # emulators auto-create buckets on first write; report every
            # bucket readable so the client's misconfig probe passes
            return Response(200, {"name": request.path_params["bucket"]})

        @r.get("/storage/v1/b/{bucket}/o/{obj}")
        def download(request):
            bucket = request.path_params["bucket"]
            name = request.path_params["obj"]  # router unquotes
            with self._lock:
                data = self.objects.get(bucket, {}).get(name)
            if data is None:
                return Response(404, {"error": "notFound"})
            if request.query.get("alt") == "media":
                return Response(200, body=data,
                                content_type="application/octet-stream")
            return Response(200, {"name": name, "size": str(len(data))})

        @r.delete("/storage/v1/b/{bucket}/o/{obj}")
        def delete(request):
            bucket = request.path_params["bucket"]
            name = request.path_params["obj"]
            with self._lock:
                existed = self.objects.get(bucket, {}).pop(name, None)
            if existed is None:
                return Response(404, {"error": "notFound"})
            return Response(204, body=b"")

        self.http = HttpServer(r, host, port)

    def start_background(self) -> int:
        return self.http.start_background()

    def stop(self) -> None:
        self.http.stop()
