"""HTTP-side observability: the shared routes and the status-page panels.

The port's copy of incubator_predictionio_tpu/obs/http.py, its imports
pointed at this package. Every server's router calls
:func:`add_metrics_route`, so ``GET /metrics`` answers Prometheus text
exposition from the process-wide registry (event, prediction, storage and
dashboard servers). The routes are unauthenticated by design, like the
reference's status pages: they expose operational state, never event
data.

- ``GET /slo`` (:func:`add_slo_route`, on the dashboard) — the SLO
  burn-rate engine's JSON evaluation (obs/slo.py); ``?fleet=1`` over the
  federated registry (obs/federate.py).
- ``GET /recorder`` (:func:`add_recorder_route`, on every server) — the
  flight recorder's window (obs/recorder.py).
- ``GET /federate``, ``GET /incidents``, ``GET /incidents/{id}``,
  ``POST /incident`` and ``POST /profile?seconds=N``
  (:func:`add_federate_route`, :func:`add_incident_routes`,
  :func:`add_profile_route`) — mounted on the admin server
  (servers/admin.py). ``POST /profile`` captures a ``torch.profiler``
  Chrome trace (obs/profile.py) where the JAX package took a
  ``jax.profiler`` xplane capture.
- :func:`render_latency_panels`, :func:`render_slo_panel` and
  :func:`render_tenant_panel` — the HTML the dashboard's index renders.

The request-level instrumentation itself (per-route counters, latency
histogram, trace ids) lives in ``utils/http.py``.
"""

from __future__ import annotations

from incubator_predictionio_tpu_torch.obs import metrics


def _set_build_info() -> None:
    """Register the constant ``pio_build_info{version,torch_version,
    device}`` gauge (value always 1: the labels are the data). ``device``
    is what the process was told to use (``PIO_DEVICE``, else ``cuda``):
    a scrape never initialises CUDA to find out."""
    import torch

    from incubator_predictionio_tpu_torch import __version__, runtime

    metrics.REGISTRY.gauge(
        "pio_build_info",
        "constant build/runtime identity gauge (always 1; the labels "
        "are the data)",
        labels=("version", "torch_version", "device"),
    ).labels(
        version=__version__, torch_version=torch.__version__,
        device=runtime.requested_device() or "cuda",
    ).set(1)


def add_metrics_route(router) -> None:
    """Register ``GET /metrics`` (Prometheus text exposition) on a
    Router. Imports the http module lazily: obs stays importable below
    utils/http.py, which imports obs for its instrumentation."""
    from incubator_predictionio_tpu_torch.utils.http import Request, Response

    _set_build_info()

    def metrics_route(request: Request) -> Response:
        return Response(
            200,
            body=metrics.REGISTRY.expose().encode("utf-8"),
            content_type=metrics.CONTENT_TYPE,
        )

    router.add("GET", "/metrics", metrics_route)


def add_slo_route(router) -> None:
    """Register ``GET /slo`` — the burn-rate engine's JSON evaluation.
    Unauthenticated like /metrics (operational state only).
    ``?fleet=1`` evaluates the SAME objectives over the federated
    registry (obs/federate.py) instead of this process's — the fleet
    p99 promise, not one worker's."""
    from incubator_predictionio_tpu_torch.obs import slo as obs_slo
    from incubator_predictionio_tpu_torch.utils.http import Request, Response

    def slo_route(request: Request) -> Response:
        fleet = request.query.get("fleet", "") not in ("", "0", "false")
        if fleet:
            from incubator_predictionio_tpu_torch.obs import federate

            engine = federate.fleet_slo_engine()
            try:
                slos = engine.evaluate()
            except ValueError as e:  # no PIO_FLEET_TARGETS configured
                return Response(400, {"message": str(e)})
        else:
            engine = obs_slo.get_engine()
            slos = engine.evaluate()
        return Response(200, {
            "scope": "fleet" if fleet else "process",
            "slos": slos,
            "windows": {"fastSeconds": engine.fast_window_s,
                        "slowSeconds": engine.slow_window_s},
        })

    router.add("GET", "/slo", slo_route)


def add_federate_route(router) -> None:
    """Register ``GET /federate`` — scrape every ``PIO_FLEET_TARGETS``
    worker's ``/metrics``, merge the families under an ``instance``
    label and re-expose the fleet as ONE text exposition
    (obs/federate.py). The handler is synchronous, so the HTTP layer
    runs it on the executor: N worker scrapes never block the admin's
    event loop. 503 when no targets are configured — an empty
    federation is a misconfiguration, not an empty healthy fleet."""
    from incubator_predictionio_tpu_torch.obs import federate
    from incubator_predictionio_tpu_torch.utils.http import Request, Response

    def federate_route(request: Request) -> Response:
        try:
            snapshot = federate.federate()
        except ValueError as e:
            return Response(503, {"message": str(e)})
        return Response(
            200,
            body=snapshot.expose().encode("utf-8"),
            content_type=metrics.CONTENT_TYPE,
        )

    router.add("GET", "/federate", federate_route)


def add_recorder_route(router) -> None:
    """Register ``GET /recorder`` — the flight recorder's reconstructed
    metric-history window (obs/recorder.py). Starts the background
    sampler as a side effect (the route IS the "this server records"
    declaration); with ``PIO_RECORDER=0`` no thread exists and the
    route answers 503. Query params:

    - ``series=<name>[,<name>...]`` — those families' windows;
    - ``window=<seconds>`` — trailing window (≤ the ring bound);
    - ``all=1`` — the full self-describing dump (every series +
      current exemplars + state-provider blocks) an incident bundle
      freezes;
    - none of the above — the cheap index (series list, cadence, ring
      size).

    Handlers are synchronous, so the HTTP layer runs them on the
    executor — a window reconstruction never blocks the event loop
    (and never touches the serving path: the ``recorder-in-serve-path``
    lint rule pins that direction too)."""
    from incubator_predictionio_tpu_torch.obs import recorder as obs_recorder
    from incubator_predictionio_tpu_torch.utils.http import Request, Response

    # starting the sampler at route-registration time (not first
    # request) makes the window already warm when an operator first
    # looks — an incident's pre-breach history must predate the breach.
    # The capture engine arms alongside it when PIO_INCIDENT_DIR names
    # a destination (no-op otherwise), so a lone worker captures its
    # own breaches without an admin in the loop.
    obs_recorder.get_recorder()
    obs_recorder.get_capture()

    def recorder_route(request: Request) -> Response:
        rec = obs_recorder.get_recorder()
        if rec is None:
            return Response(503, {
                "message": "flight recorder disabled (PIO_RECORDER=0)"})
        window = None
        raw_window = request.query.get("window", "")
        if raw_window:
            try:
                window = float(raw_window)
            except ValueError:
                return Response(400,
                                {"message": "window must be seconds"})
        if request.query.get("all", "") not in ("", "0", "false"):
            return Response(200, rec.dump(window_s=window))
        series = [s for s in request.query.get("series", "").split(",")
                  if s.strip()]
        if series:
            return Response(200, rec.window(series=series,
                                            window_s=window))
        return Response(200, rec.index())

    router.add("GET", "/recorder", recorder_route)


def add_incident_routes(router) -> None:
    """Register the incident-capture endpoints (admin server):

    - ``GET /incidents`` — newest-first bundle summaries from
      ``PIO_INCIDENT_DIR``;
    - ``GET /incidents/{id}`` — one full bundle;
    - ``POST /incident`` — manual capture (trigger="manual"), answers
      the new bundle's id + path.

    503 when ``PIO_INCIDENT_DIR`` is unset — like ``/federate``, a
    capture plane with no destination is a misconfiguration, not an
    empty healthy state."""
    from incubator_predictionio_tpu_torch.obs import recorder as obs_recorder
    from incubator_predictionio_tpu_torch.utils.http import Request, Response

    def _capture_or_503():
        cap = obs_recorder.get_capture()
        if cap is None:
            return None, Response(503, {
                "message": "incident capture disabled: set "
                           "PIO_INCIDENT_DIR"})
        return cap, None

    def list_incidents(request: Request) -> Response:
        cap, err = _capture_or_503()
        if err is not None:
            return err
        return Response(200, {"incidents": cap.list_incidents(),
                              "directory": cap.directory,
                              "cooldownS": cap.cooldown_s})

    def get_incident(request: Request) -> Response:
        cap, err = _capture_or_503()
        if err is not None:
            return err
        bundle = cap.read_incident(request.path_params["inc_id"])
        if bundle is None:
            return Response(404, {"message": "no such incident"})
        return Response(200, bundle)

    def post_incident(request: Request) -> Response:
        cap, err = _capture_or_503()
        if err is not None:
            return err
        # manual captures bypass the breach cooldown (an operator
        # asking for a bundle NOW is the authority) but still run on
        # this handler synchronously — it's the admin's executor, not
        # a serving path
        out = cap.capture_now(cap.MANUAL_TRIGGER)
        return Response(200, out)

    router.add("GET", "/incidents", list_incidents)
    router.add("GET", "/incidents/{inc_id}", get_incident)
    router.add("POST", "/incident", post_incident)


def add_profile_route(router) -> None:
    """Register ``POST /profile?seconds=N`` — on-demand
    ``torch.profiler`` capture into a Chrome trace (obs/profile.py). The
    handler is synchronous, so the HTTP layer runs it on the executor:
    the capture window never blocks the event loop. 409 while another
    capture runs, 400 on a bad window, 500 when the capture itself
    fails, a trace that lost the card's kernels included."""
    from incubator_predictionio_tpu_torch.obs import profile as obs_profile
    from incubator_predictionio_tpu_torch.utils.http import Request, Response

    def profile_route(request: Request) -> Response:
        try:
            seconds = float(request.query.get("seconds", "1"))
        except ValueError:
            return Response(400, {"message": "seconds must be a number"})
        try:
            out = obs_profile.capture_trace(seconds)
        except ValueError as e:
            return Response(400, {"message": str(e)})
        except obs_profile.CaptureBusy as e:
            return Response(409, {"message": str(e)})
        except Exception as e:  # noqa: BLE001 — the capture failed
            return Response(500, {"message": f"profiler capture "
                                             f"failed: {e}"})
        return Response(200, out)

    router.add("POST", "/profile", profile_route)


def render_latency_panels() -> str:
    """HTML panel rows for the dashboard: p50/p95/p99 serving latency
    and the freshness histogram's quantiles, derived from the process
    registry (this replaces the old average-only serving figure — a
    running average hides tail regressions entirely)."""
    reg = metrics.REGISTRY

    def quantiles(name, qs, scale, unit):
        m = reg.get(name)
        cells = []
        for q in qs:
            v = (m.quantile_over_children(q)
                 if m is not None and m.kind == "histogram" else None)
            cells.append("&mdash;" if v is None
                         else f"{v * scale:.2f}{unit}")
        return cells

    p50, p95, p99 = quantiles(
        "pio_query_latency_seconds", (0.50, 0.95, 0.99), 1e3, "ms")
    f50, f95, f99 = quantiles(
        "pio_freshness_seconds", (0.50, 0.95, 0.99), 1.0, "s")
    return (
        "<h2>Serving latency</h2>"
        "<table border=1><tr><th>p50</th><th>p95</th><th>p99</th></tr>"
        f"<tr><td>{p50}</td><td>{p95}</td><td>{p99}</td></tr></table>"
        "<h2>Freshness (event append &rarr; served)</h2>"
        "<table border=1><tr><th>p50</th><th>p95</th><th>p99</th></tr>"
        f"<tr><td>{f50}</td><td>{f95}</td><td>{f99}</td></tr></table>"
        "<p><a href='/slo'>SLO budget / burn rates (JSON)</a> &middot; "
        "<a href='/metrics'>raw metrics</a></p>"
    )


def render_slo_panel() -> str:
    """HTML summary table of the SLO engine's current evaluation."""
    from incubator_predictionio_tpu_torch.obs import slo as obs_slo

    rows = []
    for s in obs_slo.get_engine().evaluate():
        fast = s["windows"]["fast"]["burnRate"]
        slow = s["windows"]["slow"]["burnRate"]
        state = ("no data" if s["noData"]
                 else "BREACH" if s["breached"] else "ok")
        rows.append(
            "<tr>"
            f"<td>{s['name']}</td>"
            f"<td>&le; {s['objective']['thresholdSeconds']}s @ "
            f"{s['objective']['target']:.2%}</td>"
            f"<td>{fast}</td><td>{slow}</td>"
            f"<td>{s['errorBudgetRemaining']:.2%}</td>"
            f"<td>{state}</td></tr>")
    return (
        "<h2>SLOs</h2>"
        "<table border=1><tr><th>SLO</th><th>Objective</th>"
        "<th>Burn (fast)</th><th>Burn (slow)</th>"
        "<th>Budget left</th><th>State</th></tr>"
        + "".join(rows) + "</table>"
    )


def render_tenant_panel() -> str:
    """HTML per-tenant table for the dashboard: policy (weight/quota),
    queue depth + shed totals from the scheduler, and the tenant's
    own p99 read from the tenant-labeled latency family. Returns ""
    in single-tenant mode (empty registry) so the index stays clean."""
    from incubator_predictionio_tpu_torch.serving import tenancy

    reg = tenancy.get_registry()
    if not reg:
        return ""
    m = metrics.REGISTRY.get("pio_query_latency_seconds")
    shed = metrics.REGISTRY.get("pio_serve_shed_total")
    depth = metrics.REGISTRY.get("pio_serve_queue_depth")
    rows = []
    for t in reg.tenants():
        label = reg.label(t.tenant_id)
        p99 = None
        if m is not None and m.kind == "histogram":
            try:
                p99 = m.labels(tenant=label).quantile(0.99)
            except Exception:
                p99 = None
        shed_n = 0.0
        if shed is not None and "tenant" in shed.labelnames:
            ti = shed.labelnames.index("tenant")
            for key, child in getattr(shed, "_children", {}).items():
                if len(key) > ti and key[ti] == label:
                    shed_n += child.value
        d = None
        if depth is not None:
            try:
                d = depth.labels(tenant=label).value
            except Exception:
                d = None
        rows.append(
            "<tr>"
            f"<td>{t.tenant_id}</td>"
            f"<td>{t.weight}</td>"
            f"<td>{'&mdash;' if t.quota is None else t.quota}</td>"
            f"<td>{'&mdash;' if d is None else int(d)}</td>"
            f"<td>{int(shed_n)}</td>"
            f"<td>{'&mdash;' if p99 is None else f'{p99 * 1e3:.2f}ms'}"
            f"</td>"
            f"<td>{'enabled' if t.enabled else 'disabled'}</td></tr>")
    return (
        "<h2>Tenants</h2>"
        "<table border=1><tr><th>Tenant</th><th>Weight</th>"
        "<th>Quota</th><th>Queue depth</th><th>Shed</th>"
        "<th>p99</th><th>State</th></tr>"
        + "".join(rows) + "</table>"
    )


__all__ = [
    "add_federate_route", "add_incident_routes", "add_metrics_route",
    "add_recorder_route", "add_slo_route", "add_profile_route",
    "render_latency_panels", "render_slo_panel", "render_tenant_panel",
]
