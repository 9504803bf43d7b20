"""AdminAPI — REST admin mirroring the CLI app commands.

The port's own copy of incubator_predictionio_tpu/servers/admin.py, its
imports pointed at this package (``pio adminserver``).

Parity: tools/.../admin/AdminAPI.scala:38-160 + CommandClient.scala on
:7071 — ``GET /`` status, ``GET /cmd/app`` list, ``POST /cmd/app`` create
(generates a default access key like the CLI), ``DELETE /cmd/app/{name}``,
``DELETE /cmd/app/{name}/data``.

Beyond parity, the admin process is the fleet's control-plane brain: it
hosts the self-driving freshness controller (obs/controller.py) —
``GET /controller`` serves the decision audit trail, ``POST
/controller`` is the live kill switch — and the self-tuning knob
controller (obs/knobs.py) behind the same pair on ``/knobs``, alongside
``/federate``, ``/slo`` and ``/profile``. Both GET responses carry the
``recorder``/``incident`` armed-state, so one status call shows the
whole control plane.
"""

from __future__ import annotations

import logging
from typing import Optional

from typing import TYPE_CHECKING

from incubator_predictionio_tpu_torch.data.storage import AccessKey, App, Storage
from incubator_predictionio_tpu_torch.obs.http import (
    add_federate_route,
    add_incident_routes,
    add_metrics_route,
    add_profile_route,
    add_recorder_route,
    add_slo_route,
)

if TYPE_CHECKING:  # pragma: no cover
    from incubator_predictionio_tpu_torch.obs.controller import (
        FreshnessController,
    )
    from incubator_predictionio_tpu_torch.obs.knobs import KnobController
from incubator_predictionio_tpu_torch.utils.annotations import experimental
from incubator_predictionio_tpu_torch.utils.http import (
    HttpServer,
    Request,
    Response,
    Router,
)

logger = logging.getLogger(__name__)


@experimental
class AdminServer:
    def __init__(self, ip: str = "127.0.0.1", port: int = 7071,
                 controller: "FreshnessController" = None,
                 knobs: "KnobController" = None):
        self.apps = Storage.get_meta_data_apps()
        self.access_keys = Storage.get_meta_data_access_keys()
        self.channels = Storage.get_meta_data_channels()
        self.events = Storage.get_events()
        # the self-driving freshness controller (obs/controller.py):
        # the admin process hosts its evaluation loop and exposes its
        # decision audit trail. A custom-wired instance (retrain/reload
        # actuators, bench harnesses) can be injected; the default is
        # the env-wired process controller.
        if controller is None:
            from incubator_predictionio_tpu_torch.obs.controller import (
                get_controller,
            )

            controller = get_controller()
        self.controller = controller
        # the self-tuning knob controller (obs/knobs.py): same hosting
        # contract — injectable for bench harnesses, env-wired default
        if knobs is None:
            from incubator_predictionio_tpu_torch.obs.knobs import (
                get_knob_controller,
            )

            knobs = get_knob_controller()
        self.knobs = knobs
        self.http = HttpServer.from_conf(self._build_router(), ip, port,
                                         name="admin")

    @staticmethod
    def _armed_state() -> dict:
        """The rest of the control plane, in one glance: is the flight
        recorder sampling, is incident capture armed? Folded into both
        controllers' GET responses so an operator never has to infer
        "would a breach actually freeze a bundle?" from env vars."""
        from incubator_predictionio_tpu_torch.obs.recorder import (
            get_capture,
            get_recorder,
        )

        recorder = get_recorder()
        capture = get_capture()
        return {
            "recorder": {
                "armed": recorder is not None,
                "samples": (recorder.index()["samples"]
                            if recorder is not None else None),
            },
            "incident": {
                "armed": capture is not None,
                "directory": (capture.directory
                              if capture is not None else None),
            },
        }

    def _build_router(self) -> Router:
        r = Router()

        @r.get("/")
        def index(request: Request) -> Response:
            return Response(200, {
                "status": "alive",
                "description": "PredictionIO-TPU Admin API",
            })

        @r.get("/cmd/app")
        def list_apps(request: Request) -> Response:
            out = []
            for app in self.apps.get_all():
                keys = self.access_keys.get_by_appid(app.id)
                out.append({
                    "name": app.name, "id": app.id,
                    "description": app.description,
                    "accessKeys": [k.key for k in keys],
                })
            return Response(200, out)

        @r.post("/cmd/app")
        def new_app(request: Request) -> Response:
            try:
                body = request.json()
            except ValueError as e:
                return Response(400, {"message": str(e)})
            name = body.get("name")
            if not name:
                return Response(400, {"message": "app name is required"})
            if self.apps.get_by_name(name) is not None:
                return Response(400, {
                    "message": f"App {name} already exists. Aborting."
                })
            app_id = self.apps.insert(App(
                int(body.get("id", 0)), name, body.get("description")
            ))
            if app_id is None:
                return Response(400, {"message": f"Unable to create app {name}."})
            key = self.access_keys.insert(AccessKey("", app_id, ()))
            self.events.init(app_id)
            return Response(200, {
                "name": name, "id": app_id, "accessKey": key,
            })

        @r.delete("/cmd/app/{name}")
        def delete_app(request: Request) -> Response:
            app = self.apps.get_by_name(request.path_params["name"])
            if app is None:
                return Response(404, {"message": "App not found."})
            for channel in self.channels.get_by_appid(app.id):
                self.events.remove(app.id, channel.id)
                self.channels.delete(channel.id)
            self.events.remove(app.id)
            for key in self.access_keys.get_by_appid(app.id):
                self.access_keys.delete(key.key)
            self.apps.delete(app.id)
            return Response(200, {"message": f"App {app.name} deleted."})

        @r.delete("/cmd/app/{name}/data")
        def delete_app_data(request: Request) -> Response:
            app = self.apps.get_by_name(request.path_params["name"])
            if app is None:
                return Response(404, {"message": "App not found."})
            self.events.remove(app.id)
            self.events.init(app.id)
            return Response(200, {"message": f"App {app.name} data deleted."})

        @r.get("/controller")
        def controller_state(request: Request) -> Response:
            # the decision audit trail: current state + the bounded
            # ring, newest first (?limit=N, default 50)
            try:
                limit = int(request.query.get("limit", "50"))
            except ValueError:
                return Response(400,
                                {"message": "limit must be an integer"})
            return Response(200, {
                **self.controller.stats(),
                **self._armed_state(),
                "decisions": self.controller.decisions(limit=limit),
            })

        @r.post("/controller")
        def controller_mode(request: Request) -> Response:
            # the LIVE kill switch: {"mode": "off"|"observe"|"act"}
            # takes effect within one evaluation interval
            try:
                body = request.json()
            except ValueError as e:
                return Response(400, {"message": str(e)})
            if not isinstance(body, dict):
                return Response(400, {
                    "message": 'body must be a JSON object like '
                               '{"mode": "off"|"observe"|"act"}'})
            try:
                mode = self.controller.set_mode(body.get("mode", ""))
            except ValueError as e:
                return Response(400, {"message": str(e)})
            return Response(200, {"mode": mode,
                                  **self.controller.stats()})

        @r.get("/knobs")
        def knobs_state(request: Request) -> Response:
            # the knob audit trail: registry state + live vector + the
            # bounded decision ring, newest first (?limit=N)
            try:
                limit = int(request.query.get("limit", "50"))
            except ValueError:
                return Response(400,
                                {"message": "limit must be an integer"})
            return Response(200, {
                **self.knobs.stats(),
                **self._armed_state(),
                "values": self.knobs.values(),
                "decisions": self.knobs.decisions(limit=limit),
            })

        @r.post("/knobs")
        def knobs_mode_route(request: Request) -> Response:
            # the LIVE kill switch for the knob loop: {"mode": ...}
            try:
                body = request.json()
            except ValueError as e:
                return Response(400, {"message": str(e)})
            if not isinstance(body, dict):
                return Response(400, {
                    "message": 'body must be a JSON object like '
                               '{"mode": "off"|"observe"|"act"}'})
            try:
                mode = self.knobs.set_mode(body.get("mode", ""))
            except ValueError as e:
                return Response(400, {"message": str(e)})
            return Response(200, {"mode": mode, **self.knobs.stats()})

        add_metrics_route(r)
        # GET /recorder: the admin's own flight-recorder window
        # (obs/recorder.py); the fleet-merged pre-breach history lives
        # in the incident bundles, which pull every WORKER's /recorder
        add_recorder_route(r)
        # GET /incidents + POST /incident: SLO-breach-frozen bundles
        # under PIO_INCIDENT_DIR (docs/observability.md "Flight
        # recorder & incidents")
        add_incident_routes(r)
        # GET /federate: scrape the PIO_FLEET_TARGETS workers' /metrics
        # and re-expose the merged fleet series under an `instance`
        # label — the one-scrape fleet truth the load-shedder and the
        # freshness controller consume (docs/observability.md "Fleet")
        add_federate_route(r)
        # GET /slo: the burn-rate engine's JSON evaluation — the signal
        # the autonomous retrain controller consumes;
        # ?fleet=1 evaluates the same objectives over the federation
        add_slo_route(r)
        # POST /profile?seconds=N: on-demand torch.profiler Chrome-trace
        # capture (obs/profile.py) of the card's kernels; runs on the
        # executor so the capture window never blocks other admin
        # requests
        add_profile_route(r)
        return r

    def _wire_breach_listeners(self) -> None:
        """Arm the knob controller's incident rollback on the same
        burn engine(s) the incident capture rides: a breach inside the
        newest knob step's cooldown rolls the vector back."""
        from incubator_predictionio_tpu_torch.obs import slo as obs_slo

        try:
            self.knobs.install(obs_slo.get_engine())
        except Exception:
            logger.exception("knob breach listener wiring failed")

    def _wire_capture(self) -> None:
        """Point the incident-capture engine (if PIO_INCIDENT_DIR
        enables one) at THIS admin's hosted controller ring — an
        injected controller's decisions must land in the bundles, not
        the env-wired singleton's empty ring."""
        from incubator_predictionio_tpu_torch.obs.controller import (
            export_ring_fn,
        )
        from incubator_predictionio_tpu_torch.obs.recorder import get_capture

        capture = get_capture()
        if capture is not None:
            capture.decisions_fn = export_ring_fn(self.controller)
            # the knob ring rides the same duck-typed export seam: the
            # bundle's "knobs" block must show the hosted controller's
            # decisions (obs/recorder.py capture_now)
            capture.knobs_fn = export_ring_fn(self.knobs)
            # tenant block: freeze the registry's policy + per-tenant
            # SLO state into bundles so a noisy-neighbor incident shows
            # who shed and who was protected
            from incubator_predictionio_tpu_torch.serving import tenancy

            capture.tenants_fn = tenancy.export_tenants_fn()

    def start_background(self) -> int:
        port = self.http.start_background()
        # the loops run in every mode (an off controller idles its
        # tick), so a live POST /controller or /knobs flip to act
        # resumes actuation within one interval with no restart
        self.controller.start()
        self.knobs.start()
        self._wire_capture()
        self._wire_breach_listeners()
        return port

    async def serve_forever(self) -> None:
        self.controller.start()
        self.knobs.start()
        self._wire_capture()
        self._wire_breach_listeners()
        await self.http.serve_forever()

    def stop(self) -> None:
        self.controller.stop()
        self.knobs.stop()
        self.http.stop()
