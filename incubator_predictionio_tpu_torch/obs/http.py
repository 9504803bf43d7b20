"""The shared ``GET /metrics`` route (the port's copy of
:func:`add_metrics_route` from incubator_predictionio_tpu/obs/http.py).

The event server's and the prediction server's routers call
:func:`add_metrics_route`, so ``GET /metrics`` answers Prometheus text
exposition from the process-wide registry: on the prediction server that
includes the scheduler's ``pio_serve_*`` families and the tenant-labeled
``pio_query_latency_seconds``. The route is unauthenticated by design,
like the reference's status pages: it exposes operational counters, never
event data. The request-level instrumentation itself (per-route counters,
latency histogram, trace ids) lives in ``utils/http.py``. The JAX
package's ``/slo``, ``/profile``, ``/recorder`` and ``/federate`` routes
are not ported yet (ROADMAP.md Queue 1 item 8).
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
