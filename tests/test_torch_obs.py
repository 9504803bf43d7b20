"""The port's exposition layer (``obs/metrics.py``, ``obs/expofmt.py``,
``obs/http.py``) against the JAX package's, on the CPU.

Twins of tests/test_obs.py's parser and exposition tests, run on the
port's registry and parser: the strict grammar rejects the same malformed
lines, an exposition round-trips to the values planted, names are
validated, histograms keep their bucket math. Parity: the port's
registry exposition, parsed by both packages' ``expofmt.parse_families``,
gives equal structures, and both parsers read the same flat samples and
raise on the same malformed inputs. Then ``GET /metrics`` and ``GET
/recorder`` on every server of the port that mounts them: the event,
prediction and storage servers and the dashboard; the recorder is sampled
by hand before it is read, so no case waits on the clock.
"""

import dataclasses
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from incubator_predictionio_tpu.obs import expofmt as jexpofmt
from incubator_predictionio_tpu_torch.core.params import EngineParams
from incubator_predictionio_tpu_torch.data.storage import (
    AccessKey,
    App,
    Storage,
    StorageClientConfig,
)
from incubator_predictionio_tpu_torch.data.storage import (
    memory as memory_backend,
)
from incubator_predictionio_tpu_torch.data.storage.server import (
    StorageServer,
)
from incubator_predictionio_tpu_torch.models.recommendation import (
    engine as teng,
)
from incubator_predictionio_tpu_torch.models.recommendation.convert import (
    als_model_from_numpy,
)
from incubator_predictionio_tpu_torch.obs import expofmt
from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
from incubator_predictionio_tpu_torch.obs import recorder as obs_recorder
from incubator_predictionio_tpu_torch.obs import trace as obs_trace
from incubator_predictionio_tpu_torch.obs.expofmt import (
    MalformedExposition,
    histogram_series,
    parse_exposition,
)
from incubator_predictionio_tpu_torch.obs.metrics import Registry
from incubator_predictionio_tpu_torch.servers.dashboard import (
    DashboardServer,
)
from incubator_predictionio_tpu_torch.servers.event_server import (
    EventServer,
    EventServerConfig,
)
from incubator_predictionio_tpu_torch.servers.prediction_server import (
    PredictionServer,
)

MALFORMED = ["no_type_declared 1",
             "# TYPE t gauge\nt{bad 1",
             "# TYPE t nonsense\nt 1",
             "# TYPE t gauge\n# unknown comment\nt 1",
             "# TYPE t gauge\nt one"]


# -- the parser -------------------------------------------------------------

@pytest.mark.parametrize("text", MALFORMED)
def test_promoted_parser_rejects_malformed_lines(text):
    """Both packages' parsers refuse the same line, with the same
    exception class (an ``AssertionError`` subclass in both)."""
    with pytest.raises(MalformedExposition):
        parse_exposition(text)
    with pytest.raises(jexpofmt.MalformedExposition):
        jexpofmt.parse_exposition(text)


def test_exposition_format_conformance():
    reg = Registry()
    c = reg.counter("t_requests_total", "requests", labels=("route",))
    c.labels(route="/a").inc(3)
    c.labels(route='/with"quote').inc()
    g = reg.gauge("t_depth", "queue depth")
    g.set(7.5)
    h = reg.histogram("t_lat_seconds", "latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(5.0)
    types, samples = parse_exposition(reg.expose())
    assert types["t_requests_total"] == "counter"
    assert types["t_depth"] == "gauge"
    assert types["t_lat_seconds"] == "histogram"
    assert samples[("t_requests_total",
                    frozenset({("route", "/a")}))] == 3
    assert samples[("t_depth", frozenset())] == 7.5
    buckets, s, total = histogram_series(samples, "t_lat_seconds")
    assert total == 2 and s == pytest.approx(5.05)
    assert [b for b, _ in buckets] == [0.1, 1.0, float("inf")]
    assert [v for _, v in buckets] == [1, 1, 2]


def test_metric_and_label_name_validation():
    reg = Registry()
    with pytest.raises(ValueError):
        reg.counter("bad-name", "x")
    with pytest.raises(ValueError):
        reg.counter("ok_name", "x", labels=("bad-label",))


def test_get_or_create_and_kind_mismatch():
    reg = Registry()
    a = reg.counter("t_total", "x")
    assert reg.counter("t_total", "x") is a
    with pytest.raises(ValueError):
        reg.gauge("t_total", "x")
    with pytest.raises(ValueError):
        reg.counter("t_total", "x", labels=("l",))
    h = reg.histogram("t_b_seconds", "x", buckets=(1.0, 2.0))
    assert reg.histogram("t_b_seconds", "x") is h
    assert reg.histogram("t_b_seconds", "x", buckets=(1.0, 2.0)) is h
    with pytest.raises(ValueError):
        reg.histogram("t_b_seconds", "x", buckets=(1.0, 4.0))


def test_counter_rejects_negative_and_labels_mismatch():
    reg = Registry()
    with pytest.raises(ValueError):
        reg.counter("t_n_total", "x").inc(-1)
    with pytest.raises(ValueError):
        reg.counter("t_l_total", "x", labels=("a",)).labels(b="1")


def test_histogram_bucket_math_and_quantiles():
    reg = Registry()
    h = reg.histogram("t_h_seconds", "x", buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.5, 3.0, 10.0):
        h.observe(v)
    _types, samples = parse_exposition(reg.expose())
    buckets, s, total = histogram_series(samples, "t_h_seconds")
    assert [v for _, v in buckets] == [1, 2, 3, 4]
    assert total == 4 and s == pytest.approx(15.0)
    h2 = reg.histogram("t_h2_seconds", "x", buckets=(1.0, 2.0))
    h2.observe(1.0)
    assert h2._solo().snapshot()[0] == [1, 0, 0]
    assert h.quantile(0.5) == pytest.approx(2.0)
    assert h.quantile(1.0) == pytest.approx(4.0)
    assert reg.histogram("t_empty_seconds", "x").quantile(0.5) is None


def test_weighted_observe_counts_n():
    reg = Registry()
    h = reg.histogram("t_w_seconds", "x", buckets=(1.0,))
    h.observe(0.5, 64)
    assert h.count == 64 and h.sum == pytest.approx(32.0)
    assert h.quantile(0.99) <= 1.0


def test_concurrent_increment_correctness():
    reg = Registry()
    c = reg.counter("t_conc_total", "x")
    h = reg.histogram("t_conc_seconds", "x", buckets=(1.0,))
    n_threads, per_thread = 8, 2000

    def work():
        for _ in range(per_thread):
            c.inc()
            h.observe(0.5)

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert c.value == n_threads * per_thread
    assert h.count == n_threads * per_thread


def test_collector_runs_at_scrape_and_replaces_by_name():
    reg = Registry()
    g = reg.gauge("t_coll", "x")
    reg.register_collector("k", lambda: g.set(1))
    reg.register_collector("k", lambda: g.set(2))
    reg.expose()
    assert g.value == 2
    reg.register_collector("boom", lambda: 1 / 0)
    assert "t_coll" in reg.expose()


def test_latency_buckets_resolve_sub_millisecond():
    bounds = obs_metrics.DEFAULT_LATENCY_BUCKETS
    assert bounds[0] < 1e-4 and 1e-4 in bounds and max(bounds) > 10.0
    h = Registry().histogram("t_subms_seconds", "x")
    h.observe(20e-6)
    h.observe(300e-6)
    counts = h._solo().snapshot()[0]
    assert len([i for i, c in enumerate(counts) if c]) == 2


def _planted_registry() -> Registry:
    """Every family kind, labels with escapes, and histogram exemplars."""
    reg = Registry()
    c = reg.counter("t_reqs_total", "requests", labels=("route", "status"))
    c.labels(route="/a", status="200").inc(3)
    c.labels(route='/q"uote\\d', status="500").inc()
    reg.gauge("t_depth", "depth").set(-2.5)
    reg.gauge("t_lab", "labeled", labels=("tenant",)).labels(
        tenant="acme").set(4)
    h = reg.histogram("t_lat_seconds", "lat", labels=("tenant",),
                      buckets=(0.001, 0.1, 1.0))
    tok = obs_trace.set_current("parity-trace")
    try:
        for v in (0.0005, 0.05, 0.05, 0.7, 3.0):
            h.labels(tenant="acme").observe(v)
    finally:
        obs_trace.reset_current(tok)
    h.labels(tenant="beta").observe(0.2, 7)
    return reg


def _families_dict(fams) -> dict:
    return {name: dataclasses.asdict(f) for name, f in fams.items()}


def test_both_parsers_read_the_ports_exposition_equally():
    """The parity pin: the port's registry exposition, parsed by both
    packages' ``parse_families`` (and ``parse_exposition``), gives equal
    structures, exemplar annotations included."""
    text = _planted_registry().expose()
    assert "# {" in text  # the exemplar annotations are on the wire
    got = _families_dict(expofmt.parse_families(text))
    ref = _families_dict(jexpofmt.parse_families(text))
    assert got == ref
    assert set(got) == {"t_reqs_total", "t_depth", "t_lab",
                        "t_lat_seconds"}
    assert expofmt.parse_exposition(text) == \
        jexpofmt.parse_exposition(text)
    child = [c for ls, c in expofmt.parse_families(text)[
        "t_lat_seconds"].histograms.items()
        if dict(ls) == {"tenant": "acme"}][0]
    assert {tid for _le, tid in child.exemplar_trace_ids()} == \
        {"parity-trace"}


# -- /metrics and /recorder on every server of the port ---------------------

MEMORY = {
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "m",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "e",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "d",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
}


@pytest.fixture(scope="module")
def stack():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PIO_RECORDER", "1")
        mp.delenv("PIO_INCIDENT_DIR", raising=False)
        obs_recorder.reset_recorder()
        Storage.reset()
        Storage.configure(dict(MEMORY))
        app_id = Storage.get_meta_data_apps().insert(App(0, "obs-app"))
        Storage.get_events().init(app_id)
        Storage.get_meta_data_access_keys().insert(
            AccessKey("obskey", app_id))
        rng = np.random.default_rng(0)
        model = als_model_from_numpy(
            rng.normal(0, 0.3, (20, 4)).astype(np.float32),
            rng.normal(0, 0.3, (12, 4)).astype(np.float32),
            [f"u{i}" for i in range(20)], [f"i{i}" for i in range(12)],
            device="cpu")
        es = EventServer(EventServerConfig(ip="127.0.0.1", port=0,
                                           stats=True))
        ps = PredictionServer(
            teng.RecommendationEngine().apply(),
            EngineParams(algorithm_params_list=[
                ("als", teng.ALSAlgorithmParams(rank=4))]),
            [model], device="cpu")
        db = DashboardServer(ip="127.0.0.1", port=0)
        st_config = StorageClientConfig(test=True, properties={})
        st = StorageServer(memory_backend,
                           memory_backend.StorageClient(st_config),
                           st_config, host="127.0.0.1", port=0)
        servers = {"event": es, "prediction": ps, "dashboard": db,
                   "storage": st}
        try:
            yield {name: srv.start_background()
                   for name, srv in servers.items()}
        finally:
            for srv in servers.values():
                srv.stop()
            Storage.reset()
            obs_recorder.reset_recorder()


def _call(port, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


EV = {"event": "rate", "entityType": "user", "entityId": "u1",
      "targetEntityType": "item", "targetEntityId": "i1",
      "properties": {"rating": 5}}


def test_metrics_route_on_every_server(stack):
    assert _call(stack["event"], "POST", "/events.json?accessKey=obskey",
                 EV)[0] == 201
    status, _h, body = _call(stack["prediction"], "POST", "/queries.json",
                             {"user": "u3", "num": 4})
    assert status == 200 and len(json.loads(body)["itemScores"]) == 4
    for name, port in stack.items():
        status, headers, body = _call(port, "GET", "/metrics")
        assert status == 200, name
        assert headers["Content-Type"].startswith("text/plain"), name
        text = body.decode()
        types, samples = parse_exposition(text)
        # the JAX parser reads every server's scrape the same way
        assert (types, samples) == jexpofmt.parse_exposition(text), name
        assert types["pio_http_requests_total"] == "counter", name
        assert types["pio_http_request_seconds"] == "histogram", name
        hits = [ls for (n, ls), v in samples.items()
                if n == "pio_build_info" and v == 1]
        assert hits and {k for k, _v in hits[0]} == {
            "version", "torch_version", "device"}, name
    _types, samples = parse_exposition(
        _call(stack["prediction"], "GET", "/metrics")[2].decode())
    _b, lat_sum, lat_count = histogram_series(
        samples, "pio_query_latency_seconds",
        frozenset({("tenant", "default")}))
    assert lat_count >= 1 and lat_sum > 0


def test_recorder_route_on_every_server(stack):
    """Every server shares the process recorder: sampled by hand, its
    index, a series window and the full dump answer on each."""
    rec = obs_recorder.get_recorder()
    assert rec is not None
    rec.stop()  # the ring has one writer: from here on, this test
    _call(stack["prediction"], "POST", "/queries.json",
          {"user": "u5", "num": 3})
    rec.sample_now()
    rec.sample_now()
    for name, port in stack.items():
        status, _h, body = _call(port, "GET", "/recorder")
        assert status == 200, name
        idx = json.loads(body)
        assert idx["samples"] >= 2, name
        assert "pio_http_requests_total" in idx["series"], name
        status, _h, body = _call(
            port, "GET", "/recorder?series=pio_query_latency_seconds"
                         "&window=60")
        assert status == 200, name
        win = json.loads(body)
        pts = win["series"]["pio_query_latency_seconds"]["children"][0][
            "points"]
        assert pts and pts[-1][1] >= 1, name
        status, _h, body = _call(port, "GET", "/recorder?all=1")
        full = json.loads(body)
        assert status == 200 and "state" in full and "wallTs" in full
        assert "scheduler" in full["state"], name
        assert _call(port, "GET", "/recorder?window=abc")[0] == 400


def test_dashboard_panels_and_slo(stack):
    status, headers, body = _call(stack["dashboard"], "GET", "/")
    assert status == 200 and headers["Content-Type"].startswith(
        "text/html")
    html = body.decode()
    for panel in ("Completed Evaluations", "Serving latency", "SLOs"):
        assert panel in html
    status, _h, body = _call(stack["dashboard"], "GET", "/slo")
    payload = json.loads(body)
    assert status == 200 and payload["scope"] == "process"
    assert {s["name"] for s in payload["slos"]} >= {"serve_p99"}
    # no PIO_FLEET_TARGETS: the fleet view is a 400, not an empty fleet
    assert _call(stack["dashboard"], "GET", "/slo?fleet=1")[0] == 400


def test_prediction_server_applies_a_knob_vector_and_refuses_an_unknown_one(
        stack, monkeypatch):
    """``POST /knobs``: a vector of registered variables is written to
    the env and the scheduler re-reads its knobs (the answer names both);
    a vector naming one unknown variable is refused whole with 400 and
    changes nothing."""
    for env in ("PIO_SERVE_MAX_BATCH", "PIO_SERVE_MAX_WAIT_MS",
                "PIO_SPEED_MAX_BATCH"):
        monkeypatch.setenv(env, os.environ.get(env, ""))
    # the scheduler's defaults, so the module's later cases see no change
    vector = {"PIO_SERVE_MAX_BATCH": 512, "PIO_SERVE_MAX_WAIT_MS": 250,
              "PIO_SPEED_MAX_BATCH": 32}
    status, _h, body = _call(stack["prediction"], "POST", "/knobs",
                             {"values": vector})
    out = json.loads(body)
    assert status == 200 and out["applied"] == vector
    assert out["scheduler"]["cap"] == 512
    assert out["scheduler"]["waitBoundS"] == pytest.approx(0.25)
    assert os.environ["PIO_SPEED_MAX_BATCH"] == "32"
    status, _h, body = _call(stack["prediction"], "POST", "/knobs", {
        "values": {"PIO_SPEED_MAX_BATCH": 8, "PIO_NOT_A_KNOB": 1}})
    assert status == 400
    assert json.loads(body)["unknown"] == ["PIO_NOT_A_KNOB"]
    assert os.environ["PIO_SPEED_MAX_BATCH"] == "32"
    assert _call(stack["prediction"], "POST", "/knobs",
                 {"values": {"PIO_SPEED_MAX_BATCH": "many"}})[0] == 400
