"""The port's admin server (``servers/admin.py``) against the JAX
package's, on the CPU.

Both packages' admin servers run on memory stores of their own and take
the same requests: the app CRUD of ``AdminAPI.scala`` (the twin of
tests/test_admin_dashboard.py::test_admin_api_app_crud) answers alike,
access keys masked; ``GET/POST /controller`` and ``GET/POST /knobs``
serve the same state blocks, armed-state included, with the env-wired
controllers of each package; the observing routes (``/federate``,
``/slo``, ``/incident(s)``, ``/recorder``, ``/metrics``, ``POST
/profile``) are mounted; and the admin wires its hosted controllers'
rings into the incident bundles and the knob controller's rollback onto
the process SLO engine.
"""

import json
import re
import urllib.error
import urllib.request

import pytest

from incubator_predictionio_tpu.data.storage import Storage as JStorage
from incubator_predictionio_tpu.obs import controller as jcontroller
from incubator_predictionio_tpu.obs import knobs as jknobs
from incubator_predictionio_tpu.obs import recorder as jrecorder
from incubator_predictionio_tpu.servers.admin import AdminServer as JAdmin
from incubator_predictionio_tpu_torch.data.storage import Storage
from incubator_predictionio_tpu_torch.obs import controller, knobs, recorder
from incubator_predictionio_tpu_torch.obs import slo as obs_slo
from incubator_predictionio_tpu_torch.servers.admin import AdminServer

MEMORY = {
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "m",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "e",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "d",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
}
ENV = ("PIO_CONTROLLER", "PIO_KNOBS", "PIO_CONTROLLER_RELOAD_URL",
       "PIO_KNOBS_URL", "PIO_FLEET_TARGETS", "PIO_INCIDENT_DIR",
       "PIO_CONTROLLER_ROWS", "PIO_RECORDER")


def _reset_all():
    for mod in (controller, jcontroller):
        mod.reset_controller()
    for mod in (knobs, jknobs):
        mod.reset_knob_controller()
    for mod in (recorder, jrecorder):
        mod.reset_recorder()


@pytest.fixture
def admins(monkeypatch):
    """Both packages' admin servers, env-wired, loops off."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PIO_RECORDER", "0")
    _reset_all()
    Storage.reset()
    JStorage.reset()
    Storage.configure(dict(MEMORY))
    JStorage.configure(dict(MEMORY))
    servers = {"jax": JAdmin(ip="127.0.0.1", port=0),
               "port": AdminServer(ip="127.0.0.1", port=0)}
    try:
        yield {k: s.start_background() for k, s in servers.items()}, servers
    finally:
        for s in servers.values():
            s.stop()
        _reset_all()
        Storage.reset()
        JStorage.reset()


def call(port, method, path, body=None):
    data = (body if isinstance(body, bytes) else
            json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            ct = resp.headers.get("Content-Type", "")
            raw = resp.read()
            return resp.status, (json.loads(raw) if "json" in ct else raw)
    except urllib.error.HTTPError as e:
        raw = e.read()
        try:
            return e.code, json.loads(raw or b"null")
        except ValueError:
            return e.code, raw


def masked(x):
    """An answer with access keys, trace ids and timestamps masked."""
    x = json.loads(json.dumps(x))
    for d in (x if isinstance(x, list) else
              x.get("decisions", ()) if isinstance(x, dict) else ()):
        if isinstance(d, dict):
            d.pop("ts", None)
    text = json.dumps(x, sort_keys=True)
    text = re.sub(r'"[A-Za-z0-9_-]{40,}"', '"<key>"', text)
    return json.loads(re.sub(r'"(ctl|knb)-[0-9a-f]{12}"', '"<trace>"', text))


def both(ports, method, path, body=None):
    got = call(ports["port"], method, path, body)
    ref = call(ports["jax"], method, path, body)
    assert got[0] == ref[0], (path, got, ref)
    return got, ref


CRUD = [
    ("GET", "/", None),
    ("POST", "/cmd/app", {"name": "AdminApp"}),
    ("POST", "/cmd/app", {"name": "AdminApp"}),
    ("POST", "/cmd/app", {}),
    ("POST", "/cmd/app", {"name": "Second", "id": 7,
                          "description": "the second app"}),
    ("GET", "/cmd/app", None),
    ("DELETE", "/cmd/app/AdminApp/data", None),
    ("DELETE", "/cmd/app/AdminApp", None),
    ("DELETE", "/cmd/app/AdminApp", None),
    ("DELETE", "/cmd/app/Nope/data", None),
    ("GET", "/cmd/app", None),
]


def test_admin_api_app_crud_equals_the_jax_package(admins):
    ports, _servers = admins
    answers = []
    for method, path, body in CRUD:
        got, ref = both(ports, method, path, body)
        assert masked(got[1]) == masked(ref[1]), (method, path)
        answers.append(got)
    assert answers[0][1]["status"] == "alive"
    assert answers[1][0] == 200 and answers[1][1]["accessKey"]
    assert answers[2][0] == 400 and "already exists" in \
        answers[2][1]["message"]
    assert answers[3][0] == 400
    assert answers[4][1]["id"] == 7
    assert [a["name"] for a in answers[5][1]] == ["AdminApp", "Second"]
    assert [a[0] for a in answers[6:10]] == [200, 200, 404, 404]
    assert [a["name"] for a in answers[10][1]] == ["Second"]
    # the app's events are gone with it; the second's store remains
    assert Storage.get_meta_data_apps().get_by_name("AdminApp") is None
    assert Storage.get_meta_data_access_keys().get_by_appid(7)


STATE_KEYS = {"mode", "running", "intervalS", "cooldownS", "decisions",
              "recorder", "incident", "actuators", "decisionsRecorded",
              "lastAction"}


def _shape(x):
    """The keys of an answer, nested, values dropped."""
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_shape(v) for v in x[:1]]
    return type(x).__name__


@pytest.mark.parametrize("route", ["/controller", "/knobs"])
def test_control_state_routes_equal_the_jax_package(admins, route):
    ports, _servers = admins
    got, ref = both(ports, "GET", route)
    assert got[0] == 200
    assert STATE_KEYS <= set(got[1])
    assert _shape(got[1]) == _shape(ref[1])
    body, jbody = dict(got[1]), dict(ref[1])
    for b in (body, jbody):
        b.pop("running")
    assert masked(body) == masked(jbody)
    assert body["mode"] == "off"
    assert body["recorder"] == {"armed": False, "samples": None}
    assert body["incident"] == {"armed": False, "directory": None}
    # the capacity guard: the JAX package's fit of the repo's TPU records
    # engages none here either (no rows declared, no knob ceilings)
    assert body["actuators"]["capacityGuard"] is False


@pytest.mark.parametrize("route", ["/controller", "/knobs"])
def test_kill_switch_routes_equal_the_jax_package(admins, route):
    ports, _servers = admins
    for body in ({"mode": "observe"}, {"mode": "act"}, {"mode": "off"},
                 {"mode": "sideways"}, ["act"], {}):
        got, ref = both(ports, "POST", route, body)
        if got[0] == 200:
            assert got[1]["mode"] == ref[1]["mode"] == body["mode"]
        else:
            assert got[0] == 400
    assert call(ports["port"], "POST", route, b"not json")[0] == 400
    got, ref = both(ports, "GET", f"{route}?limit=2")
    assert [d["to"] for d in got[1]["decisions"]] == ["off", "act"]
    assert masked(got[1]["decisions"]) == masked(ref[1]["decisions"])
    assert call(ports["port"], "GET", f"{route}?limit=x")[0] == 400


def test_observing_routes_are_mounted(admins, tmp_path, monkeypatch):
    ports, _servers = admins
    port = ports["port"]
    status, text = call(port, "GET", "/metrics")
    assert status == 200
    for name in ("pio_controller_state", "pio_knob_value",
                 "pio_build_info"):
        assert name.encode() in text
    # no fleet targets: /federate and the fleet /slo refuse, as in the
    # JAX package
    assert both(ports, "GET", "/federate")[0][0] == 503
    assert both(ports, "GET", "/slo?fleet=1")[0][0] == 400
    status, slo = call(port, "GET", "/slo")
    assert status == 200 and slo["scope"] == "process"
    # no incident directory: the capture plane answers 503
    assert both(ports, "GET", "/incidents")[0][0] == 503
    assert both(ports, "POST", "/incident", {})[0][0] == 503
    status, rec = call(port, "GET", "/recorder")
    assert status in (200, 503)
    assert call(port, "POST", "/profile?seconds=0")[0] == 400
    status, out = call(port, "POST", "/profile?seconds=0.05")
    assert status == 200 and out["seconds"] == 0.05


def test_hosted_rings_land_in_incident_bundles(tmp_path, monkeypatch):
    """The admin points the incident capture at ITS hosted controllers
    (``_wire_capture``) and arms the knob rollback on the process SLO
    engine (``_wire_breach_listeners``)."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PIO_INCIDENT_DIR", str(tmp_path))
    monkeypatch.setenv("PIO_RECORDER", "0")
    _reset_all()
    obs_slo.reset_engine()
    Storage.reset()
    Storage.configure(dict(MEMORY))
    ctl = controller.FreshnessController(
        engine=obs_slo.get_engine(), mode="observe",
        config=controller.ControllerConfig(interval_s=60.0))
    knb = knobs.KnobController(apply_fn=knobs.local_knobs_fn(),
                               mode="observe",
                               config=knobs.KnobConfig(interval_s=60.0))
    ad = AdminServer(ip="127.0.0.1", port=0, controller=ctl, knobs=knb)
    port = ad.start_background()
    try:
        ctl.set_mode("off")
        knb.set_mode("act")
        assert knb.on_breach in obs_slo.get_engine()._breach_listeners
        status, body = call(port, "GET", "/controller")
        assert body["incident"] == {"armed": True,
                                    "directory": str(tmp_path)}
        status, out = call(port, "POST", "/incident", {})
        assert status == 200
        with open(out["path"]) as f:
            bundle = json.load(f)
        assert "off" in [d.get("to") for d in bundle["decisions"]]
        assert "act" in [d.get("to") for d in bundle["knobs"]]
        status, listing = call(port, "GET", "/incidents")
        assert status == 200 and listing["incidents"]
        status, one = call(port, "GET", f"/incidents/{out['id']}")
        assert status == 200 and one["id"] == out["id"]
    finally:
        ad.stop()
        _reset_all()
        obs_slo.reset_engine()
        Storage.reset()


def test_start_and_stop_run_both_loops():
    Storage.reset()
    Storage.configure(dict(MEMORY))
    ctl = controller.FreshnessController(
        engine=obs_slo.SLOEngine(specs=()), mode="off",
        config=controller.ControllerConfig(interval_s=60.0))
    knb = knobs.KnobController(mode="off",
                               config=knobs.KnobConfig(interval_s=60.0))
    ad = AdminServer(ip="127.0.0.1", port=0, controller=ctl, knobs=knb)
    try:
        ad.start_background()
        assert ctl.stats()["running"] and knb.stats()["running"]
    finally:
        ad.stop()
        Storage.reset()
    assert not ctl.stats()["running"] and not knb.stats()["running"]


# -- GET /slo on the admin server (tests/test_slo.py's admin halves) ---------

@pytest.fixture
def slo_stack(monkeypatch):
    from incubator_predictionio_tpu_torch.servers.dashboard import (
        DashboardServer,
    )
    from incubator_predictionio_tpu_torch.utils import times
    from incubator_predictionio_tpu_torch.utils.times import FakeClock

    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PIO_RECORDER", "0")
    _reset_all()
    Storage.reset()
    Storage.configure(dict(MEMORY))
    clock = FakeClock(1000.0)
    prev = times.set_monotonic(clock)
    obs_slo.reset_engine()
    ad = AdminServer(ip="127.0.0.1", port=0)
    db = DashboardServer(ip="127.0.0.1", port=0)
    try:
        yield {"admin": ad.start_background(),
               "dashboard": db.start_background(), "clock": clock}
    finally:
        ad.stop()
        db.stop()
        times.set_monotonic(prev)
        obs_slo.reset_engine()
        _reset_all()
        Storage.reset()


def get_json(port, path):
    status, body = call(port, "GET", path)
    assert status == 200, (path, body)
    return body


def test_slo_route_on_admin_and_dashboard(slo_stack):
    for name in ("admin", "dashboard"):
        body = get_json(slo_stack[name], "/slo")
        assert {"serve_p99", "freshness_p95", "staleness"} <= {
            s["name"] for s in body["slos"]}
        for s in body["slos"]:
            assert "errorBudgetRemaining" in s
            assert set(s["windows"]) == {"fast", "slow"}
            assert "burnRate" in s["windows"]["fast"]
        assert body["windows"]["fastSeconds"] > 0


def test_slo_e2e_planted_breach_flips_burn_rate(slo_stack):
    from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics

    clock = slo_stack["clock"]
    qlat = obs_metrics.REGISTRY.histogram(
        "pio_query_latency_seconds",
        "per-query serving wall (micro-batch members share the batch "
        "wall)", labels=("tenant",)).labels(tenant="default")
    qlat.observe(0.001, 200)
    get_json(slo_stack["admin"], "/slo")
    clock.advance(5)
    serve = [s for s in get_json(slo_stack["admin"], "/slo")["slos"]
             if s["name"] == "serve_p99"][0]
    assert serve["breached"] is False
    qlat.observe(10.0, 500)
    clock.advance(5)
    serve = [s for s in get_json(slo_stack["admin"], "/slo")["slos"]
             if s["name"] == "serve_p99"][0]
    assert serve["windows"]["fast"]["burnRate"] > 1.0
    assert serve["breached"] is True
    assert serve["errorBudgetRemaining"] < 1.0
    assert obs_slo.BURN_RATE.labels(slo="serve_p99",
                                    window="fast").value > 1.0


def test_slo_scrape_collector_refreshes_gauges(slo_stack):
    status, text = call(slo_stack["admin"], "GET", "/metrics")
    assert status == 200
    assert b"pio_slo_burn_rate" in text
    assert b"pio_slo_error_budget_remaining" in text


def test_profile_route_validation_on_admin(admins):
    from incubator_predictionio_tpu_torch.obs import profile as obs_profile

    ports, _servers = admins
    for path in ("/profile?seconds=abc", "/profile?seconds=0",
                 "/profile?seconds=9999"):
        got, _ref = both(ports, "POST", path, b"")
        assert got[0] == 400
    assert obs_profile._capture_lock.acquire(blocking=False)
    try:
        assert call(ports["port"], "POST", "/profile?seconds=1", b"")[0] \
            == 409
    finally:
        obs_profile._capture_lock.release()


def test_frontdoor_joins_the_observability_fleet():
    """The front door is a federation target: its ``/metrics`` carries
    the ``pio_frontdoor_*`` series and the client-observed
    ``pio_query_latency_seconds`` it books per served query (the twin of
    tests/test_federation.py's case)."""
    from incubator_predictionio_tpu_torch.obs import federate
    from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
    from incubator_predictionio_tpu_torch.serving.frontdoor import (
        FrontDoor,
        FrontDoorConfig,
    )
    from incubator_predictionio_tpu_torch.utils.http import (
        HttpServer,
        Request,
        Response,
        Router,
    )

    r = Router()

    @r.post("/queries.json")
    def queries(request: Request) -> Response:
        return Response(200, {"itemScores": []})

    @r.get("/")
    def status_route(request: Request) -> Response:
        return Response(200, {"status": "alive"})

    worker = HttpServer(r, "127.0.0.1", 0, name="miniworker")
    wport = worker.start_background()
    fd = FrontDoor([("127.0.0.1", wport)],
                   FrontDoorConfig(probe_interval_s=5.0))
    fport = fd.start_background()
    lat = obs_metrics.REGISTRY.get("pio_query_latency_seconds")
    before = lat.count if lat is not None else 0
    try:
        for _ in range(5):
            assert call(fport, "POST", "/queries.json",
                        {"user": "u1", "num": 1})[0] == 200
        assert obs_metrics.REGISTRY.get(
            "pio_query_latency_seconds").count >= before + 5
        snap = federate.FederatedSnapshot([federate.scrape_target(
            federate.Target(instance="door",
                            url=f"http://127.0.0.1:{fport}/metrics"))])
        assert snap.up_instances() == ["door"]
        reqs = snap.get("pio_frontdoor_requests_total")
        assert reqs is not None and reqs.total() >= 5
        below, total = snap.get("pio_query_latency_seconds") \
            .cumulative_below(0.25)
        assert total >= 5 and below >= 5
    finally:
        fd.stop()
        worker.stop()
