"""The port's dashboard (``servers/dashboard.py``, ``pio dashboard``)
against the JAX package's, on the CPU.

Twins of tests/test_admin_dashboard.py's two dashboard tests: each
package runs the same evaluation (tests/test_torch_evaluation.py's fake
engine, on its own memory store) and its dashboard lists it, serves its
HTML and JSON results and a 404 for an unknown instance, with the same
statuses; CORS answers and the OPTIONS preflight. The status-page panels
render the same HTML in both packages for the same tenant registry. ``pio
dashboard`` runs through the port's CLI as a child process: it prints
its address once bound, serves, and exits 0 on SIGTERM. The admin-API
twin is tests/test_torch_admin.py's app CRUD case.
"""

import json
import os
import signal
import subprocess
import sys
import urllib.error
import urllib.request

import pytest

from incubator_predictionio_tpu.obs import http as jhttp
from incubator_predictionio_tpu.servers.dashboard import (
    DashboardServer as JDashboardServer,
)
from incubator_predictionio_tpu.serving import tenancy as jtenancy
from incubator_predictionio_tpu_torch.obs import http as obs_http
from incubator_predictionio_tpu_torch.servers.dashboard import (
    DashboardServer,
)
from incubator_predictionio_tpu_torch.serving import tenancy
from test_torch_evaluation import JAX, MEM_CONF, PORT, fake

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"port": (PORT, DashboardServer), "jax": (JAX, JDashboardServer)}


@pytest.fixture(autouse=True)
def mem_storage():
    for p in (PORT, JAX):
        p.Storage.configure(dict(MEM_CONF))
    yield
    for p in (PORT, JAX):
        p.Storage.reset()


def call(port, method, path):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _listed(side):
    """Run the fake engine's evaluation on ``side``'s package, then read
    its dashboard: the statuses and bodies of each route."""
    p, server_cls = SIDES[side]
    f = fake(p)
    evaluation = p.evaluation.Evaluation()
    evaluation.engine_metric = (f.make_engine(), f.QxMetric())
    iid, _result = p.run_evaluation(
        evaluation, [f.params(algos=[("algo0", f.AP(2))])],
        evaluation_class="tests.Eval")
    srv = server_cls(ip="127.0.0.1", port=0)
    port = srv.start_background()
    try:
        out = {"iid": iid}
        for route in ("/", f"/engine_instances/{iid}",
                      f"/engine_instances/{iid}/evaluator_results.json",
                      "/engine_instances/nope",
                      "/engine_instances/nope/evaluator_results.json"):
            out[route.replace(iid, "IID")] = call(port, "GET", route)
        return out
    finally:
        srv.stop()


def test_dashboard_lists_evaluations():
    got, ref = _listed("port"), _listed("jax")
    iid = got["iid"]
    status, headers, body = got["/"]
    assert status == 200 and headers["Content-Type"].startswith("text/html")
    html = body.decode()
    assert iid in html and "tests.Eval" in html
    status, _h, detail = got["/engine_instances/IID"]
    assert status == 200 and b"<table" in detail
    status, _h, js = got["/engine_instances/IID/evaluator_results.json"]
    assert status == 200
    assert json.loads(js) == json.loads(
        ref["/engine_instances/IID/evaluator_results.json"][2])
    for route, answer in got.items():
        if route != "iid":
            assert answer[0] == ref[route][0], route
    assert got["/engine_instances/nope"][0] == 404


def test_dashboard_cors():
    srv = DashboardServer(ip="127.0.0.1", port=0)
    port = srv.start_background()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/") as resp:
            assert resp.headers["Access-Control-Allow-Origin"] == "*"
        req = urllib.request.Request(f"http://127.0.0.1:{port}/",
                                     method="OPTIONS")
        with urllib.request.urlopen(req) as resp:
            assert resp.status == 200
            methods = resp.headers["Access-Control-Allow-Methods"]
            assert "GET" in methods and "OPTIONS" in methods
            assert resp.headers["Access-Control-Max-Age"] == "1728000"
            assert "Content-Type" in \
                resp.headers["Access-Control-Allow-Headers"]
    finally:
        srv.stop()


def test_tenant_panel_renders_as_the_jax_packages(monkeypatch):
    """The same registry renders the same tenant table in both packages
    (these tenants have no observations in either process registry)."""
    monkeypatch.setenv("PIO_TENANTS", "pnl-a:pnl-a-key:weight=3;"
                       "pnl-b:pnl-b-key:quota=5;pnl-c:pnl-c-key:disabled=1")
    tenancy.reset_registry()
    jtenancy.reset_registry()
    try:
        got, ref = obs_http.render_tenant_panel(), jhttp.render_tenant_panel()
        assert got == ref
        assert "<h2>Tenants</h2>" in got and "pnl-a-key" not in got
        for row in ("<td>pnl-a</td><td>3</td>", "<td>pnl-b</td><td>1</td>"
                    "<td>5</td>", "disabled"):
            assert row in got
    finally:
        monkeypatch.delenv("PIO_TENANTS")
        tenancy.reset_registry()
        jtenancy.reset_registry()
    assert obs_http.render_tenant_panel() == ""


def test_pio_dashboard_through_the_cli(tmp_path):
    """``pio dashboard`` on the port: bound on ``--port 0``, it names its
    address, serves the index and ``/metrics``, and stops with exit 0 on
    SIGTERM, without the card."""
    env = {**os.environ, **MEM_CONF, "PIO_HOME": str(tmp_path),
           "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    env.pop("PIO_DEVICE", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "incubator_predictionio_tpu_torch.cli.main",
         "dashboard", "--ip", "127.0.0.1", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(tmp_path), env=env)
    try:
        line = proc.stdout.readline()
        assert line.startswith("Dashboard running on http://127.0.0.1:"), \
            (line, proc.stderr.read() if proc.poll() is not None else "")
        port = int(line.rsplit(":", 1)[1])
        status, _h, body = call(port, "GET", "/")
        assert status == 200 and b"Completed Evaluations" in body
        status, _h, body = call(port, "GET", "/metrics")
        assert status == 200 and b"pio_build_info" in body
        status, _h, body = call(port, "GET", "/recorder")
        assert status == 200 and "series" in json.loads(body)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err[-2000:]
        assert "Dashboard stopped." in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)


# -- GET /slo on the dashboard (tests/test_slo.py's dashboard halves) --------

@pytest.fixture
def slo_dashboard():
    from incubator_predictionio_tpu_torch.obs import slo as obs_slo
    from incubator_predictionio_tpu_torch.utils import times
    from incubator_predictionio_tpu_torch.utils.times import FakeClock

    clock = FakeClock(1000.0)
    prev = times.set_monotonic(clock)
    obs_slo.reset_engine()
    srv = DashboardServer(ip="127.0.0.1", port=0)
    port = srv.start_background()
    try:
        yield port, clock
    finally:
        srv.stop()
        times.set_monotonic(prev)
        obs_slo.reset_engine()


def _slo(port):
    status, _h, body = call(port, "GET", "/slo")
    assert status == 200
    return json.loads(body)


def test_slo_route_on_the_dashboard(slo_dashboard):
    port, _clock = slo_dashboard
    body = _slo(port)
    assert {"serve_p99", "freshness_p95", "staleness"} <= {
        s["name"] for s in body["slos"]}
    for s in body["slos"]:
        assert "errorBudgetRemaining" in s
        assert set(s["windows"]) == {"fast", "slow"}
        assert "burnRate" in s["windows"]["fast"]
    assert body["windows"]["fastSeconds"] > 0


def test_slo_planted_breach_flips_burn_rate_on_the_dashboard(
        slo_dashboard):
    """A planted breach flips ``serve_p99`` through ``GET /slo``. The
    observations go to a tenant label of this test's own: the objective
    reads every child of the family, the scheduler's shed only its
    tenant's."""
    from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
    from incubator_predictionio_tpu_torch.obs import slo as obs_slo

    port, clock = slo_dashboard
    qlat = obs_metrics.REGISTRY.histogram(
        "pio_query_latency_seconds",
        "per-query serving wall (fused batch members share the batch "
        "wall)", labels=("tenant",)).labels(tenant="t-dashboard-slo")
    qlat.observe(0.001, 200)
    _slo(port)
    clock.advance(5)
    serve = [s for s in _slo(port)["slos"] if s["name"] == "serve_p99"][0]
    assert serve["breached"] is False
    qlat.observe(10.0, 500)
    clock.advance(5)
    serve = [s for s in _slo(port)["slos"] if s["name"] == "serve_p99"][0]
    assert serve["windows"]["fast"]["burnRate"] > 1.0
    assert serve["breached"] is True
    assert serve["errorBudgetRemaining"] < 1.0
    assert obs_slo.BURN_RATE.labels(slo="serve_p99",
                                    window="fast").value > 1.0
    status, _h, text = call(port, "GET", "/metrics")
    assert b"pio_slo_burn_rate" in text
    assert b"pio_slo_error_budget_remaining" in text
