"""The port's fleet federation (``obs/federate.py``) against the JAX
package's, on the CPU.

Twins of tests/test_federation.py on the port: the ``PIO_FLEET_TARGETS``
grammar, the planted two-registry merge against hand-merged bucket
sums, the federated exposition's round trip under ``instance`` labels,
per-instance degradation (``pio_federate_up``), and the two-process end
to end: two worker processes of the port (tests/torch_fleet_worker.py)
scraped through ``GET /federate`` and ``GET /slo?fleet=1`` mounted on a
bare ``Router`` (tests/test_torch_admin.py holds them on the port's
admin server, and the front door as a federation target), and one trace
id across the
port's event server and a storage server in a child process. Parity: both
packages' ``federate`` merge of the same two scraped texts gives
byte-equal expositions.
"""

import json
import logging
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import pytest

from incubator_predictionio_tpu.obs import expofmt as jexpofmt
from incubator_predictionio_tpu.obs import federate as jfederate
from incubator_predictionio_tpu.obs import metrics as jmetrics
from incubator_predictionio_tpu.obs import trace as jtrace
from incubator_predictionio_tpu_torch.data.storage import (
    AccessKey,
    App,
    Storage,
)
from incubator_predictionio_tpu_torch.obs import expofmt, federate
from incubator_predictionio_tpu_torch.obs import trace as obs_trace
from incubator_predictionio_tpu_torch.obs.http import (
    add_federate_route,
    add_slo_route,
)
from incubator_predictionio_tpu_torch.obs.metrics import Registry
from incubator_predictionio_tpu_torch.utils.http import HttpServer, Router

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)
WORKER = os.path.join(TESTS_DIR, "torch_fleet_worker.py")
sys.path.insert(0, os.path.join(REPO, "scripts"))

import trace_stitch  # noqa: E402


def test_parse_targets_grammar():
    spec = "10.0.0.1:8000, b=10.0.0.2:8000 ,http://h:9/custom,"
    ts = federate.parse_targets(spec)
    assert [(t.instance, t.url) for t in ts] == [
        ("10.0.0.1:8000", "http://10.0.0.1:8000/metrics"),
        ("b", "http://10.0.0.2:8000/metrics"),
        ("h:9", "http://h:9/custom"),
    ]
    assert [(t.instance, t.url) for t in ts] == [
        (t.instance, t.url) for t in jfederate.parse_targets(spec)]
    assert federate.parse_targets("") == []


def _snapshot(fed, xfmt, named_texts):
    return fed.FederatedSnapshot([
        fed.ScrapeResult(target=fed.Target(inst, f"http://{inst}"),
                         ok=True, wall_s=0.0,
                         families=xfmt.parse_families(text))
        for inst, text in named_texts])


def test_planted_merge_quantiles_match_hand_bucket_math():
    r1, r2 = Registry(), Registry()
    h1 = r1.histogram("pio_query_latency_seconds", "lat",
                      buckets=(0.1, 1.0))
    for _ in range(4):
        h1.observe(0.05)
    h2 = r2.histogram("pio_query_latency_seconds", "lat",
                      buckets=(0.1, 1.0))
    for v in (0.5, 0.5, 5.0, 5.0):
        h2.observe(v)
    r1.gauge("pio_serve_queue_depth", "d").set(3)
    r2.gauge("pio_serve_queue_depth", "d").set(7)
    r1.counter("pio_http_requests_total", "r").inc(5)
    r2.counter("pio_http_requests_total", "r").inc(5)
    snap = _snapshot(federate, expofmt,
                     (("w1", r1.expose()), ("w2", r2.expose())))
    m = snap.get("pio_query_latency_seconds")
    assert m.count == 8
    assert m.cumulative_below(0.1) == (4, 8)
    assert m.cumulative_below(1.0) == (6, 8)
    assert m.quantile(0.50) == pytest.approx(0.1)
    assert m.quantile(0.75) == pytest.approx(1.0)
    assert m.quantile(0.99) == pytest.approx(1.0)
    depth = snap.get("pio_serve_queue_depth")
    assert depth.total() == 10 and depth.max_value() == 7
    assert snap.get("pio_http_requests_total").total() == 10


def test_federated_exposition_round_trips_and_labels_instances():
    r1, r2 = Registry(), Registry()
    for reg, val in ((r1, 1), (r2, 2)):
        reg.counter("t_reqs_total", "x", labels=("route",)).labels(
            route="/a").inc(val)
        reg.histogram("t_lat_seconds", "x", buckets=(1.0,)).observe(0.5)
    snap = _snapshot(federate, expofmt,
                     (("w1", r1.expose()), ("w2", r2.expose())))
    types, samples = expofmt.parse_exposition(snap.expose())
    assert types["t_reqs_total"] == "counter"
    assert samples[("t_reqs_total", frozenset(
        {("instance", "w1"), ("route", "/a")}))] == 1
    assert samples[("t_reqs_total", frozenset(
        {("instance", "w2"), ("route", "/a")}))] == 2
    assert samples[("pio_federate_up", frozenset(
        {("instance", "w1")}))] == 1
    _b, s, tot = expofmt.histogram_series(
        samples, "t_lat_seconds", frozenset({("instance", "w2")}))
    assert tot == 1 and s == pytest.approx(0.5)


def test_down_instance_degrades_per_instance_not_per_fleet():
    res_ok = federate.ScrapeResult(
        target=federate.Target("up", "http://up"), ok=True, wall_s=0.0,
        families=expofmt.parse_families(Registry().expose()))
    res_down = federate.ScrapeResult(
        target=federate.Target("down", "http://down"), ok=False,
        wall_s=0.1, families={}, error="connection refused")
    snap = federate.FederatedSnapshot([res_ok, res_down])
    _types, samples = expofmt.parse_exposition(snap.expose())
    assert samples[("pio_federate_up", frozenset(
        {("instance", "up")}))] == 1
    assert samples[("pio_federate_up", frozenset(
        {("instance", "down")}))] == 0


def _planted_texts(reg_cls, trace_mod):
    """Two workers' scrapes, each registry of ``reg_cls``: every family
    kind, a labeled histogram with exemplars, a gauge only one has."""
    texts = []
    for inst, (fast, slow, depth) in (("w1", (6, 1, 3)),
                                      ("w2", (2, 4, 9))):
        reg = reg_cls()
        h = reg.histogram("pio_query_latency_seconds", "lat",
                          labels=("tenant",), buckets=(0.01, 0.1, 1.0))
        tok = trace_mod.set_current(f"{inst}-trace")
        try:
            for _ in range(fast):
                h.labels(tenant="default").observe(0.005)
            for _ in range(slow):
                h.labels(tenant="default").observe(0.5)
        finally:
            trace_mod.reset_current(tok)
        reg.gauge("pio_serve_queue_depth", "d").set(depth)
        reg.counter("pio_http_requests_total", "r",
                    labels=("route",)).labels(route="/q").inc(fast + slow)
        if inst == "w2":
            reg.gauge("pio_model_staleness_seconds", "s").set(120.0)
        texts.append((inst, reg.expose()))
    return texts


@pytest.mark.parametrize("source", ["port", "jax"])
def test_both_packages_merge_to_byte_equal_expositions(source):
    """The parity pin: the same two scraped texts (from either package's
    registry) merged by both packages' ``FederatedSnapshot`` expose the
    same bytes, and the merged quantiles agree."""
    texts = (_planted_texts(Registry, obs_trace) if source == "port"
             else _planted_texts(jmetrics.Registry, jtrace))
    got = _snapshot(federate, expofmt, texts)
    ref = _snapshot(jfederate, jexpofmt, texts)
    assert got.expose() == ref.expose()
    m, jm = (s.get("pio_query_latency_seconds") for s in (got, ref))
    for q in (0.5, 0.9, 0.99):
        assert m.quantile(q) == jm.quantile(q)
    assert sorted(m.exemplar_trace_ids()) == sorted(
        jm.exemplar_trace_ids())


# -- two-process /federate e2e ----------------------------------------------

def spawn_worker(*args, stderr=subprocess.PIPE):
    """A worker process of the port, and the port it bound."""
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", ""), "PIO_DEVICE": "cpu"}
    env.pop("PIO_INCIDENT_DIR", None)
    proc = subprocess.Popen(
        [sys.executable, WORKER, *args], stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=stderr, text=True, cwd=TESTS_DIR,
        env=env)
    line = first_line(proc)
    if not line.startswith("PORT "):
        proc.kill()
        _out, err = proc.communicate(timeout=30)
        raise RuntimeError(f"worker never bound: {(err or '')[-2000:]}")
    return proc, int(line.split()[1])


def first_line(proc, timeout=120.0):
    """The worker's first stdout line (``PORT <n>``), or "" when it died
    or said nothing within ``timeout``."""
    got = []
    t = threading.Thread(target=lambda: got.append(proc.stdout.readline()),
                         daemon=True)
    t.start()
    t.join(timeout)
    return got[0] if got else ""


def stop_worker(proc):
    """Close the worker's stdin (its exit signal) and drain it."""
    try:
        return proc.communicate(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.communicate(timeout=30)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return resp.status, dict(resp.headers), resp.read()


def _admin_like():
    """``GET /federate`` and ``GET /slo`` on a bare router."""
    r = Router()
    add_federate_route(r)
    add_slo_route(r)
    return HttpServer(r, "127.0.0.1", 0, name="admin")


def test_federate_e2e_two_worker_processes(monkeypatch):
    w1, p1 = spawn_worker("--mode", "metrics",
                          "--observe", "0.004,0.004,0.004",
                          "--depth", "3", "--staleness", "100")
    w2, p2 = spawn_worker("--mode", "metrics", "--observe", "0.1,3.0",
                          "--depth", "5", "--staleness", "9000")
    srv = None
    try:
        monkeypatch.setenv("PIO_FLEET_TARGETS",
                           f"w1=127.0.0.1:{p1},w2=127.0.0.1:{p2}")
        federate.reset_fleet_engine()
        srv = _admin_like()
        port = srv.start_background()
        status, headers, body = _get(port, "/federate")
        assert status == 200
        assert headers["Content-Type"].startswith("text/plain")
        text = body.decode()
        types, samples = expofmt.parse_exposition(text)
        assert (types, samples) == jexpofmt.parse_exposition(text)
        for inst in ("w1", "w2"):
            assert samples[("pio_federate_up", frozenset(
                {("instance", inst)}))] == 1
        b1, _s1, t1 = expofmt.histogram_series(
            samples, "pio_query_latency_seconds",
            frozenset({("instance", "w1")}))
        b2, _s2, t2 = expofmt.histogram_series(
            samples, "pio_query_latency_seconds",
            frozenset({("instance", "w2")}))
        assert t1 == 3 and t2 == 2
        merged = {}
        for buckets in (b1, b2):
            prev = 0.0
            for le, cum in buckets:
                if le == float("inf"):
                    continue
                merged[le] = merged.get(le, 0.0) + (cum - prev)
                prev = cum
        total = t1 + t2

        def hand_quantile(q):
            rank = q * total
            cum, prev_le = 0.0, 0.0
            for le, c in sorted(merged.items()):
                if c > 0 and cum + c >= rank:
                    return prev_le + (le - prev_le) * (rank - cum) / c
                cum += c
                prev_le = le
            return max(merged)

        snap = federate.federate()
        m = snap.get("pio_query_latency_seconds")
        for q in (0.5, 0.95, 0.99):
            assert m.quantile(q) == pytest.approx(hand_quantile(q)), q
        assert m.count == total
        assert snap.get("pio_serve_queue_depth").total() == 8

        status, _h, body = _get(port, "/slo?fleet=1")
        payload = json.loads(body)
        assert status == 200 and payload["scope"] == "fleet"
        by_name = {s["name"]: s for s in payload["slos"]}
        assert by_name["serve_p99"]["totalObservations"] == total
        assert not by_name["staleness"]["noData"]
        assert federate.fleet_slo_engine().registry.get(
            "pio_model_staleness_seconds").max_value() == 9000
    finally:
        if srv is not None:
            srv.stop()
        federate.reset_fleet_engine()
        stop_worker(w1)
        stop_worker(w2)


def test_federate_unconfigured_is_explicit(monkeypatch):
    monkeypatch.delenv("PIO_FLEET_TARGETS", raising=False)
    federate.reset_fleet_engine()
    srv = _admin_like()
    port = srv.start_background()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(port, "/federate")
        assert ei.value.code == 503
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(port, "/slo?fleet=1")
        assert ei.value.code == 400
        status, _h, body = _get(port, "/slo")
        assert status == 200 and json.loads(body)["scope"] == "process"
    finally:
        srv.stop()
        federate.reset_fleet_engine()


def test_cross_process_trace_links_span_lines(caplog):
    """One trace id through two processes of the port: the event server
    here, the storage server in a child. The storage span's
    ``parentSpanId`` is the event span's ``spanId``."""
    from incubator_predictionio_tpu_torch.servers.event_server import (
        EventServer,
        EventServerConfig,
    )

    worker, sport = spawn_worker("--mode", "storage")
    es = None
    try:
        Storage.reset()
        Storage.configure({
            "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
            "PIO_STORAGE_SOURCES_REM_TYPE": "remote",
            "PIO_STORAGE_SOURCES_REM_URL": f"http://127.0.0.1:{sport}",
            "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "m",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "e",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "REM",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "d",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
        })
        app_id = Storage.get_meta_data_apps().insert(App(0, "fleet-app"))
        Storage.get_meta_data_access_keys().insert(
            AccessKey("fleetkey", app_id))
        Storage.get_events().init(app_id)
        es = EventServer(EventServerConfig(ip="127.0.0.1", port=0))
        eport = es.start_background()
        tid = "torch-fleet-trace-0001"
        req = urllib.request.Request(
            f"http://127.0.0.1:{eport}/events.json?accessKey=fleetkey",
            data=json.dumps({
                "event": "rate", "entityType": "user", "entityId": "u1",
                "targetEntityType": "item", "targetEntityId": "i1",
                "properties": {"rating": 5}}).encode(), method="POST",
            headers={"Content-Type": "application/json",
                     "X-PIO-Trace-Id": tid})
        with caplog.at_level(logging.INFO, logger="pio.trace"):
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.status == 201
                assert resp.headers["X-PIO-Trace-Id"] == tid
    finally:
        if es is not None:
            es.stop()
        Storage.reset()
        _out, worker_err = stop_worker(worker)
    local = trace_stitch.parse_span_lines(
        [r.getMessage() for r in caplog.records if r.name == "pio.trace"])
    remote = trace_stitch.parse_span_lines(worker_err.splitlines())
    event_spans = [s for s in local
                   if s["traceId"] == tid and s.get("server") == "event"]
    assert event_spans, local
    storage_spans = [s for s in remote if s["traceId"] == tid]
    assert storage_spans, worker_err[-2000:]
    for s in storage_spans:
        assert s["server"] == "storage" and s["route"] == "/rpc"
        assert s["parentSpanId"] == event_spans[0]["spanId"], s
    roots = trace_stitch.build_tree(event_spans + storage_spans)
    assert len(roots) == 1 and roots[0] is event_spans[0]
    rendered = trace_stitch.render_trace(tid, event_spans + storage_spans)
    assert "event POST /events.json" in rendered
    assert "storage POST /rpc" in rendered


def test_scrape_of_a_live_worker_counts_it_up():
    """``FleetRegistry`` over one live worker and one dead address: the
    live one's families land, the dead one is ``up`` 0, and the fleet
    view never fails for it."""
    w, p = spawn_worker("--mode", "metrics", "--observe", "0.02",
                        "--depth", "2")
    try:
        targets = [federate.Target("live", f"http://127.0.0.1:{p}/metrics"),
                   federate.Target("dead", "http://127.0.0.1:9/metrics")]
        reg = federate.FleetRegistry(targets_fn=lambda: targets,
                                     max_age_s=0.0)
        assert reg.get("pio_serve_queue_depth").total() == 2
        snap = federate.federate(targets=targets)
        _types, samples = expofmt.parse_exposition(snap.expose())
        assert samples[("pio_federate_up", frozenset(
            {("instance", "live")}))] == 1
        assert samples[("pio_federate_up", frozenset(
            {("instance", "dead")}))] == 0
    finally:
        stop_worker(w)

