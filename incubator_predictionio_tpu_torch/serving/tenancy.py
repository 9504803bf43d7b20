"""Tenant registry — access key → tenant id → deploy.

The port's own copy of incubator_predictionio_tpu/serving/tenancy.py, its
imports pointed at this package. Of the planes named below, the port has
all: the prediction server's, the scheduler's, the metric labels and the
per-tenant SLO specs, and the incident bundles, whose tenant block
:func:`export_tenants_fn` fills (obs/recorder.py), the front door's
query-path auth (serving/frontdoor.py) and the admin server's bundle
wiring (servers/admin.py).

The reference PredictionIO is a multi-app server: app ids + access keys
multiplex event ingest AND engine deployments through one address. Our
ingest side already speaks that grammar (``servers/event_server.py``
authenticates ``accessKey`` query param / HTTP Basic against the
``AccessKey`` DAO); this module brings the SERVING side to parity and
is the single source of truth every tenant-aware plane reads:

- the prediction server's per-tenant deploys and tenant-scoped
  ``/reload`` (servers/prediction_server.py),
- the front door's query-path auth + tenant routing
  (serving/frontdoor.py — placement/circuits stay transport-scoped),
- the scheduler's per-(tenant, engine) queues, weights and admission
  quotas (serving/scheduler.py),
- the ``tenant`` label on ``pio_query_latency_seconds`` /
  ``pio_serve_shed_total`` / ``pio_serve_queue_depth`` — label values
  come ONLY from this registry (the bounded-cardinality contract the
  ``unscoped-tenant-metric`` lint rule enforces),
- per-tenant SLO specs (obs/slo.py ``tenant_specs``) and the tenant
  block incident capture freezes into bundles (obs/recorder.py).

Registry grammar (``PIO_TENANTS``, documented in docs/production.md
"Multi-tenant platform"): ``;``-separated entries, each

    <tenant_id>:<access_key>[:opt=val[,opt=val...]]

with options ``weight`` (weighted-fair dispatch share, default 1),
``quota`` (max queued admissions across the tenant's queues; absent =
unlimited), ``engine`` / ``variant`` (the deploy this tenant's queries
route to; absent = the worker's default deploy), and ``disabled``
(key rejected with 401 while the entry keeps its registry slot).

The registry is BOUNDED (``MAX_TENANTS``) and tenant ids are validated
against a closed grammar — both are what make ``tenant`` a legal
metric label. An empty registry (no ``PIO_TENANTS``) is the
single-tenant compatibility mode: ``/queries.json`` stays
unauthenticated and everything books under the ``default`` tenant.
"""

from __future__ import annotations

import base64
import dataclasses
import os
import re
import threading
from typing import Any, Dict, Optional, Tuple

from incubator_predictionio_tpu_torch.utils.http import HttpError

#: the single-tenant compatibility label — every unconfigured process
#: books its traffic here, so dashboards read identically before and
#: after a fleet turns tenancy on
DEFAULT_TENANT = "default"

#: registry bound: the tenant label's worst-case cardinality (and the
#: per-worker deploy count ceiling — co-resident deploys share one
#: device)
MAX_TENANTS = 64

_TENANT_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_-]{0,63}$")


class TenantAuthError(HttpError):
    """401 on the query path: unknown, disabled, or missing access key
    while tenancy is configured — the serving twin of the event
    server's ``AuthError``."""

    def __init__(self, message: str = "Invalid accessKey.") -> None:
        super().__init__(401, message)


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One registry entry: the key→tenant→deploy mapping plus the
    isolation policy the scheduler enforces."""

    tenant_id: str
    access_key: str
    weight: int = 1
    quota: Optional[int] = None
    engine_id: Optional[str] = None
    engine_variant: Optional[str] = None
    enabled: bool = True


class TenantRegistry:
    """Bounded, immutable-after-construction tenant table."""

    def __init__(self, tenants: Tuple[Tenant, ...] = ()) -> None:
        if len(tenants) > MAX_TENANTS:
            raise ValueError(
                f"tenant registry bounded at {MAX_TENANTS} entries "
                f"(got {len(tenants)})")
        by_id: Dict[str, Tenant] = {}
        by_key: Dict[str, Tenant] = {}
        for t in tenants:
            if not _TENANT_ID_RE.match(t.tenant_id):
                raise ValueError(
                    f"invalid tenant id {t.tenant_id!r}: must match "
                    f"{_TENANT_ID_RE.pattern}")
            if t.tenant_id in by_id:
                raise ValueError(f"duplicate tenant id {t.tenant_id!r}")
            if not t.access_key:
                raise ValueError(
                    f"tenant {t.tenant_id!r} needs an access key")
            if t.access_key in by_key:
                raise ValueError(
                    f"duplicate access key for tenant {t.tenant_id!r}")
            if t.weight < 1:
                raise ValueError(
                    f"tenant {t.tenant_id!r}: weight must be >= 1")
            by_id[t.tenant_id] = t
            by_key[t.access_key] = t
        self._by_id = by_id
        self._by_key = by_key

    # -- parsing ------------------------------------------------------------
    @classmethod
    def from_env(cls, value: Optional[str] = None) -> "TenantRegistry":
        """Parse the ``PIO_TENANTS`` grammar (see module docstring).
        An unset/empty value is the empty registry — single-tenant
        compatibility mode."""
        raw = os.environ.get("PIO_TENANTS", "") if value is None else value
        tenants = []
        for entry in raw.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            parts = entry.split(":", 2)
            if len(parts) < 2:
                raise ValueError(
                    f"PIO_TENANTS entry {entry!r}: expected "
                    "<tenant_id>:<access_key>[:opt=val,...]")
            tenant_id, access_key = parts[0].strip(), parts[1].strip()
            kwargs: Dict[str, Any] = {}
            if len(parts) == 3:
                for opt in parts[2].split(","):
                    opt = opt.strip()
                    if not opt:
                        continue
                    name, _, val = opt.partition("=")
                    name = name.strip()
                    val = val.strip()
                    if name == "weight":
                        kwargs["weight"] = int(val)
                    elif name == "quota":
                        kwargs["quota"] = int(val)
                    elif name == "engine":
                        kwargs["engine_id"] = val
                    elif name == "variant":
                        kwargs["engine_variant"] = val
                    elif name == "disabled":
                        kwargs["enabled"] = val.lower() in (
                            "", "0", "off", "false")
                    else:
                        raise ValueError(
                            f"PIO_TENANTS entry {entry!r}: unknown "
                            f"option {name!r}")
            tenants.append(Tenant(tenant_id, access_key, **kwargs))
        return cls(tuple(tenants))

    # -- lookups ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._by_id)

    def __bool__(self) -> bool:
        return bool(self._by_id)

    def tenants(self) -> Tuple[Tenant, ...]:
        return tuple(self._by_id.values())

    def tenant_ids(self) -> Tuple[str, ...]:
        return tuple(self._by_id)

    def get(self, tenant_id: str) -> Optional[Tenant]:
        return self._by_id.get(tenant_id)

    def by_key(self, access_key: str) -> Optional[Tenant]:
        return self._by_key.get(access_key)

    def label(self, tenant_id: Optional[str]) -> str:
        """A METRIC-SAFE tenant label: the id when registered, the
        default label otherwise — so a label value can never come from
        the wire unvalidated."""
        if tenant_id is not None and tenant_id in self._by_id:
            return tenant_id
        return DEFAULT_TENANT

    def weights(self) -> Dict[str, int]:
        return {t.tenant_id: t.weight for t in self._by_id.values()}

    def quotas(self) -> Dict[str, Optional[int]]:
        return {t.tenant_id: t.quota for t in self._by_id.values()}

    # -- auth (EventServer.scala:93-131 grammar, serving edition) -----------
    def authenticate(self, request: Any) -> str:
        """Map a query-path request to its tenant id.

        Empty registry → :data:`DEFAULT_TENANT`, no auth (the
        single-deploy compatibility mode). Configured registry → the
        ``accessKey`` query param or HTTP Basic username (the event
        server's exact grammar) must name an enabled tenant; missing,
        unknown, or disabled keys raise :class:`TenantAuthError`
        (401)."""
        if not self._by_id:
            return DEFAULT_TENANT
        key = extract_access_key(request)
        if not key:
            raise TenantAuthError("Missing accessKey.")
        tenant = self._by_key.get(key)
        if tenant is None:
            raise TenantAuthError("Invalid accessKey.")
        if not tenant.enabled:
            raise TenantAuthError("Access key disabled.")
        return tenant.tenant_id

    def describe(self) -> Dict[str, Dict[str, Any]]:
        """The registry table for /status blocks and incident bundles
        (keys redacted — bundles and status pages are shareable)."""
        return {
            t.tenant_id: {
                "weight": t.weight,
                "quota": t.quota,
                "engine": t.engine_id,
                "variant": t.engine_variant,
                "enabled": t.enabled,
            }
            for t in self._by_id.values()
        }


def extract_access_key(request: Any) -> Optional[str]:
    """The event server's auth grammar (EventServer.scala:93-131):
    ``accessKey`` query param, else HTTP Basic where the username is
    the key."""
    key = request.query.get("accessKey")
    if key:
        return key
    auth = request.headers.get("authorization", "")
    if auth.startswith("Basic "):
        try:
            decoded = base64.b64decode(auth[6:]).decode("utf-8")
            return decoded.strip().split(":")[0]
        except Exception:  # noqa: BLE001 — malformed header = no key
            return None
    return None


# ---------------------------------------------------------------------------
# process-wide singleton (parsed once per PIO_TENANTS value — workers,
# the front door and the admin all read the same table)
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_registry: Optional[TenantRegistry] = None
_registry_env: Optional[str] = None


def get_registry() -> TenantRegistry:
    """The process registry, re-parsed whenever ``PIO_TENANTS``
    changes (tests monkeypatch the env; servers read it at request
    time through this seam)."""
    global _registry, _registry_env
    raw = os.environ.get("PIO_TENANTS", "")
    with _lock:
        if _registry is None or raw != _registry_env:
            _registry = TenantRegistry.from_env(raw)
            _registry_env = raw
        return _registry


def set_registry(registry: Optional[TenantRegistry]) -> None:
    """Inject a registry (tests); ``None`` reverts to env parsing."""
    global _registry, _registry_env
    with _lock:
        _registry = registry
        _registry_env = (os.environ.get("PIO_TENANTS", "")
                         if registry is not None else None)


def reset_registry() -> None:
    set_registry(None)


def export_tenants_fn() -> Any:
    """The incident-capture seam (obs/recorder.py ``tenants_fn``,
    wired in servers/admin.py and the prediction server): a callable
    freezing the tenant block into bundles — the registry table plus
    every per-tenant SLO entry (spec names ``<slo>@<tenant>``), so a
    bundle answers "which tenant breached, and was the fleet healthy"
    without the live process."""

    def tenants_block() -> Optional[Dict[str, Any]]:
        registry = get_registry()
        if not registry:
            return None
        from incubator_predictionio_tpu_torch.obs import slo as obs_slo

        per_tenant: Dict[str, Any] = {
            tid: {"policy": desc, "slo": []}
            for tid, desc in registry.describe().items()
        }
        try:
            for entry in obs_slo.get_engine().evaluate():
                _, _, tid = entry["name"].partition("@")
                if tid in per_tenant:
                    per_tenant[tid]["slo"].append(entry)
        except Exception:  # noqa: BLE001 — the table alone still lands
            pass
        return per_tenant

    return tenants_block


__all__ = [
    "DEFAULT_TENANT", "MAX_TENANTS", "Tenant", "TenantAuthError",
    "TenantRegistry", "export_tenants_fn", "extract_access_key",
    "get_registry", "reset_registry", "set_registry",
]
