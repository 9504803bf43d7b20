"""The port's fleet front door (``serving/frontdoor.py``) against the JAX
package's, on the CPU.

The scripted-transport layer drives both packages' ``FrontDoor`` with the
same script on their ``FakeClock``s (no sockets): retries, circuits,
half-open probes, the shed passthrough, placement, the retry budget and
the rolling reload that will not darken the fleet give equal answers,
counts and worker states in both (twins of tests/test_frontdoor.py). The
socket layer runs the port's door over the port's own servers: stand-in
workers on ``utils/http`` for the header hop and the drain; the port's
prediction servers, in process on the CPU over a model trained on a
memory store, for a rolling ``POST /reload`` under concurrent queries
that drops none and carries ``X-PIO-Trace-Id`` to every worker, and for
``POST /knobs``; two ``tests/torch_fleet_worker.py`` children for a real
kill, held on the circuit state the door reports rather than on wall
time. The ingest door's twins (tests/test_ingest_frontdoor.py) run over
the port's event servers on a two-shard cpplog store.
"""

import asyncio
import importlib
import json
import logging
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from incubator_predictionio_tpu_torch.serving.frontdoor import (
    DRAINING,
    HALF_OPEN,
    HEALTHY,
    OPEN,
    FrontDoor,
    FrontDoorConfig,
)
from incubator_predictionio_tpu_torch.utils.http import (
    HttpServer,
    Request,
    Response,
    Router,
)

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)
WORKER = os.path.join(TESTS_DIR, "torch_fleet_worker.py")


class Pkg:
    def __init__(self, root: str):
        self.fd = importlib.import_module(f"{root}.serving.frontdoor")
        self.http = importlib.import_module(f"{root}.utils.http")
        self.times = importlib.import_module(f"{root}.utils.times")


JAX = Pkg("incubator_predictionio_tpu")
PORT = Pkg("incubator_predictionio_tpu_torch")

_STATUS_BODY = json.dumps({
    "status": "alive",
    "scheduler": {"engines": {"default": {"depth": 0}}}}).encode()


def make_fd(P, n_workers, clock, script, **cfg_kw):
    """A door with a scripted transport: ``script(worker, method, path,
    headers)`` returns ``(status, headers, body)`` or raises."""
    fd = P.fd.FrontDoor([("127.0.0.1", 10000 + i) for i in range(n_workers)],
                        P.fd.FrontDoorConfig(**cfg_kw), clock=clock)

    async def roundtrip(w, method, path, headers, body, timeout):
        return script(w, method, path, headers)

    fd._roundtrip = roundtrip
    return fd


def query(P, fd, headers=None):
    req = P.http.Request("POST", "/queries.json", {}, headers or {}, b"{}")
    r = asyncio.run(fd.handle_query(req))
    return r.status, r.body, dict(r.headers or {})


def states(fd):
    return {w.name: (w.state, w.fails, w.cooldown_s, w.depth)
            for w in fd.workers}


def both(scenario):
    got, ref = scenario(PORT), scenario(JAX)
    assert got == ref
    return got


# -- scripted-transport layer ------------------------------------------------

def test_midflight_kill_retries_once_to_healthy_peer():
    def scenario(P):
        seen = []

        def script(w, method, path, headers):
            seen.append((w.name, path))
            if w.name == "w0":
                raise ConnectionResetError("worker died mid-flight")
            return 200, {"x-pio-queue-depth": "1"}, b'{"who": "w1"}'

        fd = make_fd(P, 2, P.times.FakeClock(), script)
        return query(P, fd), dict(fd.counts), seen, states(fd)

    (status, body, _h), counts, seen, st = both(scenario)
    assert status == 200 and body == b'{"who": "w1"}'
    assert counts["retries"] == 1 and counts["ok"] == 1
    assert [s for s in seen if s[1] == "/queries.json"] == [
        ("w0", "/queries.json"), ("w1", "/queries.json")]
    assert st["w0"][:2] == (HEALTHY, 1)


def test_no_retry_when_no_healthy_peer_exists():
    def scenario(P):
        def script(w, method, path, headers):
            raise ConnectionResetError("down")

        fd = make_fd(P, 1, P.times.FakeClock(), script)
        return query(P, fd)[0], dict(fd.counts)

    status, counts = both(scenario)
    assert status == 502
    assert counts["retries"] == 0 and counts["failed"] == 1


def test_circuit_opens_after_n_failures_and_half_open_readmits():
    def scenario(P):
        clock = P.times.FakeClock()
        probe_answer = {"ok": False}

        def script(w, method, path, headers):
            if method == "GET":
                if not probe_answer["ok"]:
                    raise ConnectionRefusedError("still down")
                return 200, {}, _STATUS_BODY
            raise ConnectionResetError("down")

        fd = make_fd(P, 1, clock, script, eject_failures=3,
                     open_cooldown_s=2.0)
        trail = [query(P, fd)[0] for _ in range(3)]
        trail.append(states(fd))
        trail.append(query(P, fd))
        for dt, ok in ((1.0, False), (1.5, False), (4.5, True)):
            probe_answer["ok"] = ok
            clock.advance(dt)
            asyncio.run(fd._probe_pass())
            trail.append(states(fd))
        return trail

    trail = both(scenario)
    assert trail[:3] == [502, 502, 502]
    assert trail[3]["w0"][0] == OPEN and trail[3]["w0"][2] == 2.0
    assert trail[4][0] == 503 and trail[4][2]["Retry-After"]
    assert trail[5]["w0"][0] == OPEN
    assert trail[6]["w0"][0] == OPEN and trail[6]["w0"][2] == 4.0
    assert trail[7]["w0"] == (HEALTHY, 0, 0.0, 0.0)


def test_shedding_worker_is_not_ejected():
    def scenario(P):
        def script(w, method, path, headers):
            return 503, {"retry-after": "2", "x-pio-queue-depth": "7"}, \
                b'{"message": "Serving overloaded"}'

        fd = make_fd(P, 1, P.times.FakeClock(), script, eject_failures=3)
        answers = [query(P, fd) for _ in range(5)]
        return answers, dict(fd.counts), states(fd)

    answers, counts, st = both(scenario)
    assert all(s == 503 and h["Retry-After"] == "2"
               for s, _b, h in answers)
    assert st["w0"] == (HEALTHY, 0, 0.0, 7.0)
    assert counts["shed"] == 5 and counts["retries"] == 0


def test_placement_follows_reported_queue_depth():
    def scenario(P):
        fd = make_fd(P, 3, P.times.FakeClock(),
                     lambda w, m, p, h: (200, {}, b"{}"))
        fd._worker("w0").depth = 5.0
        fd._worker("w2").depth = 2.0
        picks = [fd._pick().name]
        fd._worker("w1").in_flight = 9
        picks.append(fd._pick().name)
        fd._worker("w2").state = P.fd.DRAINING
        fd._worker("w0").state = P.fd.OPEN
        picks.append(fd._pick().name)
        fd._worker("w1").state = P.fd.OPEN
        picks.append(fd._pick())
        return picks

    assert both(scenario) == ["w1", "w2", "w1", None]


def test_idle_fleet_round_robins_by_least_recent_pick():
    def scenario(P):
        fd = make_fd(P, 3, P.times.FakeClock(),
                     lambda w, m, p, h: (200, {}, b"{}"))
        return [fd._pick().name for _ in range(6)]

    assert both(scenario) == ["w0", "w1", "w2", "w0", "w1", "w2"]


def test_retry_budget_bounds_amplification():
    def scenario(P):
        def script(w, method, path, headers):
            raise ConnectionResetError("down")

        fd = make_fd(P, 2, P.times.FakeClock(), script, eject_failures=100,
                     retry_budget=1.0)
        return [query(P, fd)[0] for _ in range(2)], dict(fd.counts)

    statuses, counts = both(scenario)
    assert statuses == [502, 502] and counts["retries"] == 1


def test_rolling_reload_skips_rather_than_darkening_the_fleet():
    def scenario(P):
        sent = []

        def script(w, method, path, headers):
            sent.append((w.name, method, path))
            return 200, {}, _STATUS_BODY

        fd = make_fd(P, 2, None, script, drain_capacity_wait_s=0.2)
        fd._worker("w1").state = P.fd.OPEN
        out = asyncio.run(fd.rolling_reload_async())
        return out, fd._worker("w0").state, ("w0", "POST", "/reload") in sent

    out, w0_state, reloaded_w0 = both(scenario)
    assert out["reloaded"] == 0 and out["failed"] == ["w0", "w1"]
    assert w0_state == HEALTHY and not reloaded_w0


def test_rolling_reload_reloads_each_worker_with_key_and_tenant():
    def scenario(P):
        sent = []

        def script(w, method, path, headers):
            sent.append((w.name, method, path))
            return 200, {}, _STATUS_BODY

        fd = make_fd(P, 2, None, script, server_key="k y")
        out = asyncio.run(fd.rolling_reload_async(tenant="acme"))
        out.pop("drainS")
        return out, [s for s in sent if s[1] == "POST"], \
            [w.state for w in fd.workers]

    out, posts, st = both(scenario)
    assert out == {"workers": 2, "reloaded": 2, "dropped": 0, "failed": [],
                   "tenant": "acme"}
    assert posts == [("w0", "POST", "/reload?accessKey=k%20y&tenant=acme"),
                     ("w1", "POST", "/reload?accessKey=k%20y&tenant=acme")]
    assert st == [HEALTHY, HEALTHY]


def test_knobs_fanout_counts_rejections():
    def scenario(P):
        def script(w, method, path, headers):
            if w.name == "w1":
                return 400, {}, b'{"message": "unregistered"}'
            return 200, {}, b'{"applied": {"PIO_SERVE_MAX_BATCH": 64}}'

        fd = make_fd(P, 2, None, script)
        return asyncio.run(fd.knobs_fanout_async(b'{"values": {}}'))

    out = both(scenario)
    assert out["workers"] == 2 and out["applied"] == 1
    assert out["failed"] == ["w1"]
    assert out["results"] == {"w0": {"applied": {"PIO_SERVE_MAX_BATCH": 64}}}


def test_worker_names_are_reused_after_removal():
    def scenario(P):
        fd = make_fd(P, 3, None, lambda w, m, p, h: (200, {}, _STATUS_BODY))
        fd.remove_worker("w1")
        name = fd.add_worker("127.0.0.1", 10009)
        return name, [w.name for w in fd.workers]

    assert both(scenario) == ("w1", ["w0", "w2", "w1"])


def test_importing_serving_package_registers_no_frontdoor_metrics():
    code = (
        "import incubator_predictionio_tpu_torch.serving as s\n"
        "from incubator_predictionio_tpu_torch.obs.metrics import REGISTRY\n"
        "assert 'pio_frontdoor' not in REGISTRY.expose()\n"
        "assert s.FrontDoorConfig().eject_failures == 3\n"
        "assert 'pio_frontdoor' in REGISTRY.expose()\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


# -- sockets: stand-in workers ----------------------------------------------

def _fake_worker(tag, serve_delay_s=0.0):
    r = Router()
    state = {"reloads": 0, "served": 0, "reload_headers": []}

    @r.post("/queries.json")
    def q(req: Request) -> Response:
        if serve_delay_s:
            time.sleep(serve_delay_s)
        state["served"] += 1
        return Response(200, {
            "who": tag,
            "sawPriority": req.headers.get("x-pio-priority"),
            "sawTrace": req.headers.get("x-pio-trace-id"),
        }, headers={"X-PIO-Queue-Depth": "0"})

    @r.get("/")
    def status(req: Request) -> Response:
        return Response(200, {"status": "alive", "scheduler": {
            "engines": {"default": {"depth": 0}}}})

    @r.post("/reload")
    def reload_route(req: Request) -> Response:
        time.sleep(0.05)
        state["reloads"] += 1
        state["reload_headers"].append(dict(req.headers))
        return Response(200, {"message": "Reloaded."})

    srv = HttpServer(r, "127.0.0.1", 0, name=f"fake-{tag}")
    return srv, srv.start_background(), state


@pytest.fixture
def fleet():
    made = []

    def build(n, serve_delay_s=0.0, **cfg):
        workers = [_fake_worker(f"t{i}", serve_delay_s) for i in range(n)]
        fd = FrontDoor([("127.0.0.1", p) for _s, p, _st in workers],
                       FrontDoorConfig(probe_interval_s=0.2, **cfg))
        fd.start_background()
        made.append((fd, workers))
        return fd, workers

    yield build
    for fd, workers in made:
        fd.stop()
        for srv, _p, _st in workers:
            srv.stop()


def _ask(port, path="/queries.json", data=b"{}", headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read() or b"null"), \
                resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null"), e.headers


def test_priority_and_trace_headers_survive_the_hop(fleet):
    fd, _workers = fleet(1)
    status, out, headers = _ask(fd.http.port, headers={
        "X-PIO-Priority": "7", "X-PIO-Trace-Id": "trace-pin"})
    assert status == 200
    assert out["sawPriority"] == "7" and out["sawTrace"] == "trace-pin"
    assert headers.get("X-PIO-Trace-Id") == "trace-pin"


def test_rolling_reload_drains_with_zero_dropped_queries(fleet):
    fd, workers = fleet(2, serve_delay_s=0.01)
    port = fd.http.port
    statuses, stop = [], threading.Event()

    def client():
        while not stop.is_set():
            statuses.append(_ask(port)[0])

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        while len(statuses) < 8:   # traffic established before the swap
            time.sleep(0.01)
        out = fd.rolling_reload(timeout=60)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert out["reloaded"] == 2 and out["dropped"] == 0
    assert not out["failed"] and len(out["drainS"]) == 2
    assert all(st["reloads"] == 1 for _s, _p, st in workers)
    assert statuses and all(s == 200 for s in statuses)
    assert all(w["state"] == HEALTHY for w in fd.stats()["workers"])


def test_door_routes_key_join_remove_metrics_and_status(fleet):
    fd, workers = fleet(1, server_key="sekrit")
    port = fd.http.port
    assert _ask(port, "/reload", b"")[0] == 401
    assert _ask(port, "/knobs", b"{}")[0] == 401
    assert _ask(port, "/fleet/join", b"{}")[0] == 401
    extra = _fake_worker("t9")
    try:
        status, out, _h = _ask(port, "/fleet/join?accessKey=sekrit",
                               json.dumps({"host": "127.0.0.1",
                                           "port": extra[1]}).encode())
        assert status == 200 and out == {"worker": "w1"}
        status, out, _h = _ask(port, "/reload?accessKey=sekrit", b"")
        assert status == 200 and out["reloaded"] == 2
        assert extra[2]["reloads"] == 1
        status, out, _h = _ask(port, "/fleet/remove?accessKey=sekrit",
                               json.dumps({"worker": "w1"}).encode())
        assert status == 200 and out == {"removed": True}
        assert _ask(port, "/fleet/remove?accessKey=sekrit",
                    json.dumps({"worker": "w7"}).encode())[0] == 404
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                    timeout=30) as resp:
            info = json.loads(resp.read())
        assert info["status"] == "frontdoor"
        assert [w["name"] for w in info["workers"]] == ["w0"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as resp:
            text = resp.read().decode()
        for name in ("pio_frontdoor_requests_total",
                     "pio_frontdoor_worker_healthy",
                     "pio_frontdoor_drain_seconds"):
            assert name in text
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/recorder",
                                    timeout=30) as resp:
            assert resp.status == 200
    finally:
        extra[0].stop()


def test_stop_closes_the_pooled_connections(fleet):
    """A stopped door leaves no idle keep-alive connection to a worker:
    a worker stopped after it (``pio undeploy``) finishes its own
    graceful shutdown."""
    fd, workers = fleet(2)
    for _ in range(6):
        assert _ask(fd.http.port)[0] == 200
    assert sum(len(w.conns) for w in fd.workers) > 0
    fd.stop()
    assert all(not w.conns for w in fd.workers)


# -- sockets: the port's prediction servers ---------------------------------

MEMORY = {
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "m",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "e",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "d",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
}


@pytest.fixture
def served(monkeypatch):
    """Two of the port's prediction servers over one instance trained on
    a memory store (300 users × 200 items), behind the port's door."""
    from incubator_predictionio_tpu_torch.core.params import EngineParams
    from incubator_predictionio_tpu_torch.data.datamap import DataMap
    from incubator_predictionio_tpu_torch.data.event import Event
    from incubator_predictionio_tpu_torch.data.storage import App, Storage
    from incubator_predictionio_tpu_torch.models.recommendation import (
        engine as eng_mod,
    )
    from incubator_predictionio_tpu_torch.servers.prediction_server import (
        PredictionServer,
        ServerConfig,
    )
    from incubator_predictionio_tpu_torch.workflow.workflow import (
        CoreWorkflow,
    )

    monkeypatch.setenv("PIO_RETRAIN_CONTINUE", "0")
    monkeypatch.setenv("PIO_SPEED_LAYER", "0")
    monkeypatch.setenv("PIO_SERVE_SHED", "0")
    Storage.reset()
    Storage.configure(dict(MEMORY))
    app_id = Storage.get_meta_data_apps().insert(App(0, "doorapp"))
    events = Storage.get_events()
    events.init(app_id)
    rng = np.random.default_rng(11)
    for u in range(300):
        for i in rng.choice(200, 6, replace=False):
            events.insert(Event(
                event="rate", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{i}",
                properties=DataMap({"rating": float(rng.integers(1, 6))})),
                app_id)
    engine = eng_mod.RecommendationEngine().apply()
    params = EngineParams(
        data_source_params=("", eng_mod.DataSourceParams(app_name="doorapp")),
        algorithm_params_list=[("als", eng_mod.ALSAlgorithmParams(
            rank=4, num_iterations=3, lambda_=0.05, seed=7))])

    def train():
        return CoreWorkflow.run_train(engine, params, engine_variant="door",
                                      device="cpu")

    first = train()
    servers = [PredictionServer(engine, device="cpu", config=ServerConfig(
        ip="127.0.0.1", port=0, engine_variant="door", micro_batch=16))
        for _ in range(2)]
    ports = [s.start_background() for s in servers]
    fd = FrontDoor([("127.0.0.1", p) for p in ports],
                   FrontDoorConfig(probe_interval_s=0.2))
    fd.start_background()
    try:
        yield {"door": fd, "servers": servers, "ports": ports,
               "first": first, "train": train}
    finally:
        fd.stop()
        for s in servers:
            s.stop()
        Storage.reset()


def test_rolling_reload_of_prediction_servers_drops_no_query(served, caplog):
    fd = served["door"]
    port = fd.http.port
    second = served["train"]()
    answers, stop = [], threading.Event()

    def client(seed):
        r = np.random.default_rng(seed)
        while not stop.is_set():
            body = json.dumps({"user": f"u{int(r.integers(300))}",
                               "num": 5}).encode()
            status, out, _h = _ask(port, data=body)
            answers.append((status, len((out or {}).get("itemScores", ()))))

    threads = [threading.Thread(target=client, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    try:
        while len(answers) < 20:
            time.sleep(0.01)
        with caplog.at_level(logging.INFO, logger="pio.trace"):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/reload", data=b"", method="POST",
                headers={"X-PIO-Trace-Id": "ctl-door-0001"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                out = json.loads(resp.read())
        n_during = len(answers)
        while len(answers) < n_during + 20:
            time.sleep(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert out["reloaded"] == 2 and out["dropped"] == 0 and not out["failed"]
    assert answers and all(a == (200, 5) for a in answers)
    for s in served["servers"]:
        assert s.engine_instance.id == second != served["first"]
    spans = [json.loads(r.getMessage()) for r in caplog.records
             if r.name == "pio.trace"]
    reloads = [s for s in spans if s.get("route") == "/reload"
               and s.get("traceId") == "ctl-door-0001"]
    assert {s.get("server") for s in reloads} >= {"frontdoor", "prediction"}
    assert sum(s.get("server") == "prediction" for s in reloads) == 2
    assert fd.counts["failed"] == 0 and fd.counts["ok"] == len(answers)


def test_knobs_through_the_door_reach_both_prediction_servers(
        served, monkeypatch):
    for env in ("PIO_SERVE_MAX_BATCH", "PIO_SERVE_MAX_WAIT_MS"):
        monkeypatch.setenv(env, os.environ.get(env, "") or "0")
        monkeypatch.delenv(env)
    port = served["door"].http.port
    body = json.dumps({"values": {"PIO_SERVE_MAX_BATCH": 8,
                                  "PIO_SERVE_MAX_WAIT_MS": 20}}).encode()
    status, out, _h = _ask(port, "/knobs", body)
    assert status == 200 and out["applied"] == 2 and out["failed"] == []
    for name in ("w0", "w1"):
        assert out["results"][name]["scheduler"]["cap"] == 8
        assert out["results"][name]["scheduler"]["waitBoundS"] == \
            pytest.approx(0.02)
    for s in served["servers"]:
        assert s._batcher.cap == 8
    status, out, _h = _ask(port, "/knobs", json.dumps(
        {"values": {"PIO_SERVE_MAX_BATCH": 4, "PIO_BOGUS": 1}}).encode())
    assert status == 200 and out["applied"] == 0
    assert sorted(out["failed"]) == ["w0", "w1"]
    assert [s._batcher.cap for s in served["servers"]] == [8, 8]
    status, answer, _h = _ask(port, data=b'{"user": "u3", "num": 4}')
    assert status == 200 and len(answer["itemScores"]) == 4


# -- a real kill: worker processes of the port ------------------------------

def _spawn_worker(seed):
    env = dict(os.environ, PIO_DEVICE="cpu", PIO_TRACE_LOG="off")
    proc = subprocess.Popen(
        [sys.executable, WORKER, "--mode", "serve", "--seed", str(seed),
         "--users", "60", "--items", "40"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    line = proc.stdout.readline()
    assert line.startswith("PORT "), line
    return proc, int(line.split()[1])


def test_real_kill_fails_over_and_circuit_recovers():
    procs = [_spawn_worker(s) for s in (0, 1)]
    fd = FrontDoor([("127.0.0.1", p) for _proc, p in procs],
                   FrontDoorConfig(probe_interval_s=0.2, eject_failures=2))
    port = fd.start_background()
    body = b'{"user": "u3", "num": 3}'
    try:
        assert _ask(port, data=body)[0] == 200
        procs[0][0].kill()                # every socket of w0 dies with it
        procs[0][0].wait()
        # every query still answers 200 (the retry path) until the door
        # reports the dead worker's circuit open: held on that state
        seen = 0
        while fd._worker("w0").state == HEALTHY:
            assert _ask(port, data=body)[0] == 200
            seen += 1
            assert seen < 500, "the dead worker's circuit never opened"
        assert fd._worker("w0").state in (OPEN, HALF_OPEN)
        for _ in range(8):
            assert _ask(port, data=body)[0] == 200
        assert fd.counts["failed"] == 0
        assert fd._worker("w1").state == HEALTHY
    finally:
        fd.stop()
        for proc, _p in procs:
            if proc.poll() is None:
                proc.stdin.close()
                proc.wait(timeout=30)


def test_ephemeral_bind_reports_kernel_assigned_port():
    r = Router()
    a, b = HttpServer(r, "127.0.0.1", 0), HttpServer(r, "127.0.0.1", 0)
    pa, pb = a.start_background(), b.start_background()
    try:
        assert pa != 0 and pb != 0 and pa != pb
        assert (a.port, b.port) == (pa, pb)
    finally:
        a.stop()
        b.stop()


# -- the ingest door: the port's event servers on cpplog --------------------

@pytest.fixture
def door(tmp_path, monkeypatch):
    from incubator_predictionio_tpu_torch.data.storage import (
        AccessKey,
        App,
        Storage,
    )
    from incubator_predictionio_tpu_torch.servers.event_server import (
        EventServer,
        EventServerConfig,
    )
    from incubator_predictionio_tpu_torch.serving.frontdoor import (
        IngestFrontDoor,
    )

    monkeypatch.setenv("PIO_LOG_SHARDS", "2")
    Storage.reset()
    Storage.configure({
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_SOURCES_LOG_TYPE": "cpplog",
        "PIO_STORAGE_SOURCES_LOG_PATH": str(tmp_path),
        "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "m",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "e",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "d",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
    })
    app_id = Storage.get_meta_data_apps().insert(App(id=0, name="DoorApp"))
    Storage.get_meta_data_access_keys().insert(
        AccessKey(key="k123", appid=app_id, events=[]))
    Storage.get_events().init(app_id)
    writers = [EventServer(EventServerConfig(ip="127.0.0.1", port=0))
               for _ in range(2)]
    ports = [w.start_background() for w in writers]
    fd = IngestFrontDoor([("127.0.0.1", p) for p in ports],
                         FrontDoorConfig(server_key="k123"))
    dport = fd.start_background()
    try:
        yield fd, f"http://127.0.0.1:{dport}", app_id
    finally:
        fd.stop()
        for w in writers:
            w.stop()
        Storage.reset()


def _post(base, path, body):
    req = urllib.request.Request(
        f"{base}{path}", json.dumps(body).encode(),
        {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read() or b"null")


def _mk(i):
    return {"event": "rate", "entityType": "user", "entityId": f"u{i}",
            "targetEntityType": "item", "targetEntityId": f"i{i % 7}",
            "properties": {"rating": float(i % 5) + 0.5}}


def _count(app_id):
    from incubator_predictionio_tpu_torch.data.storage import Storage

    return len(Storage.get_events().scan_interactions(
        app_id=app_id, entity_type="user", target_entity_type="item",
        event_names=("rate",), value_prop="rating"))


def test_ingest_paths_equal_the_jax_package():
    assert PORT.fd.IngestFrontDoor.INGEST_PATHS == \
        JAX.fd.IngestFrontDoor.INGEST_PATHS


def test_event_routes_and_batches_alias(door):
    _fd, base, app_id = door
    st, body = _post(base, "/events.json?accessKey=k123", _mk(0))
    assert st == 201 and "eventId" in body
    for path, lo in (("/batch/events.json", 1), ("/batches/events.json", 21)):
        st, res = _post(base, f"{path}?accessKey=k123",
                        [_mk(i) for i in range(lo, lo + 20)])
        assert st == 200 and all(r["status"] == 201 for r in res)
    assert _count(app_id) == 41


def test_bad_access_key_rejected_through_door(door):
    _fd, base, _app_id = door
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(base, "/events.json?accessKey=WRONG", _mk(0))
    assert exc.value.code == 401


def test_rolling_reload_drops_zero_events(door):
    fd, base, app_id = door
    sent, errors = [], []
    started = threading.Barrier(4)

    def pump(tid):
        started.wait()
        for j in range(8):
            batch = [_mk(1000 + tid * 100 + j * 10 + x) for x in range(10)]
            try:
                st, res = _post(base, "/batch/events.json?accessKey=k123",
                                batch)
                assert st == 200, st
                ok = sum(1 for r in res if r["status"] == 201)
                assert ok == len(batch), res
                sent.append(ok)
            except Exception as e:  # a drop fails the test below
                errors.append(repr(e))

    threads = [threading.Thread(target=pump, args=(t,)) for t in range(3)]
    for t in threads:
        t.start()
    started.wait()
    out = fd.rolling_reload(timeout=60)
    for t in threads:
        t.join()
    assert not errors, errors[:3]
    assert out["reloaded"] == 2 and out["dropped"] == 0, out
    assert _count(app_id) == sum(sent) == 240
    assert sum(fd.stats()["counts"].values()) > 0
