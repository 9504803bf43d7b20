"""Dashboard — evaluation results UI + live serving/SLO panels.

The port's own copy of incubator_predictionio_tpu/servers/dashboard.py,
its imports pointed at this package (``pio dashboard``).

Parity: tools/.../dashboard/Dashboard.scala:46-162 on :9000 — lists
completed EvaluationInstances newest-first with links to each instance's
stored HTML results, with CORS enabled (CorsSupport.scala:30-66) so
external dashboards can fetch the JSON results cross-origin.

On top of parity, the index renders live panels from the process
registry: p50/p95/p99 serving latency, the end-to-end freshness
histogram's quantiles, the SLO burn-rate summary and, with
``PIO_TENANTS``, the per-tenant table. ``GET /slo`` serves the same
evaluation as JSON, ``GET /recorder`` the flight recorder's window and
``GET /metrics`` the exposition. The panels read THIS process's registry
(a co-hosted stack sees everything; a split deployment points Grafana at
the per-process /metrics instead).
"""

from __future__ import annotations

import html
import logging

from incubator_predictionio_tpu_torch.data.storage import Storage
from incubator_predictionio_tpu_torch.obs.http import (
    add_metrics_route,
    add_recorder_route,
    add_slo_route,
    render_latency_panels,
    render_slo_panel,
    render_tenant_panel,
)
from incubator_predictionio_tpu_torch.utils.http import (
    HttpServer,
    Request,
    Response,
    Router,
)
from incubator_predictionio_tpu_torch.utils.times import format_iso8601

logger = logging.getLogger(__name__)


class DashboardServer:
    def __init__(self, ip: str = "127.0.0.1", port: int = 9000):
        self.evaluation_instances = Storage.get_meta_data_evaluation_instances()
        self.http = HttpServer.from_conf(self._build_router(), ip, port,
                                         name="dashboard")

    def _build_router(self) -> Router:
        r = Router(cors=True)

        @r.get("/")
        def index(request: Request) -> Response:
            rows = []
            for i in self.evaluation_instances.get_completed():
                rows.append(
                    "<tr>"
                    f"<td><a href='/engine_instances/{i.id}'>{i.id}</a></td>"
                    f"<td>{html.escape(i.evaluation_class)}</td>"
                    f"<td>{html.escape(i.engine_params_generator_class)}</td>"
                    f"<td>{format_iso8601(i.start_time)}</td>"
                    f"<td>{format_iso8601(i.end_time)}</td>"
                    f"<td>{html.escape(i.evaluator_results)}</td>"
                    "</tr>"
                )
            try:
                panels = (render_latency_panels() + render_slo_panel()
                          + render_tenant_panel())
            except Exception:
                logger.exception("dashboard panels failed to render")
                panels = "<p>panels unavailable</p>"
            body = (
                "<html><head><title>PredictionIO Dashboard</title></head>"
                "<body><h1>Completed Evaluations</h1>"
                "<table border=1><tr><th>ID</th><th>Evaluation</th>"
                "<th>Params Generator</th><th>Start</th><th>End</th>"
                f"<th>Result</th></tr>{''.join(rows)}</table>"
                f"{panels}</body></html>"
            )
            return Response(200, body=body.encode(),
                            content_type="text/html; charset=UTF-8")

        @r.get("/engine_instances/{instance_id}")
        def detail(request: Request) -> Response:
            i = self.evaluation_instances.get(request.path_params["instance_id"])
            if i is None or not i.evaluator_results_html:
                return Response(404, {"message": "Not Found"})
            return Response(200, body=i.evaluator_results_html.encode(),
                            content_type="text/html; charset=UTF-8")

        @r.get("/engine_instances/{instance_id}/evaluator_results.json")
        def detail_json(request: Request) -> Response:
            i = self.evaluation_instances.get(request.path_params["instance_id"])
            if i is None:
                return Response(404, {"message": "Not Found"})
            return Response(
                200,
                body=(i.evaluator_results_json or "{}").encode(),
            )

        add_metrics_route(r)
        # GET /recorder: flight-recorder window (obs/recorder.py)
        add_recorder_route(r)
        add_slo_route(r)
        return r

    def start_background(self) -> int:
        return self.http.start_background()

    async def serve_forever(self) -> None:
        await self.http.serve_forever()

    def stop(self) -> None:
        self.http.stop()
