"""The port's flight recorder, exemplars and incident capture
(``obs/recorder.py``) against the JAX package's, on the CPU.

Twins of the 21 tests of tests/test_recorder.py, on the port: ring
retention and eviction math, delta-encode/decode identity, interval
quantiles, the sampler thread and the off switch, the observe path with
the recorder on, the exemplar reservoir, its window and off switch, the
exemplar round trip through federation, the scheduler's exemplar seam,
one bundle per sustained breach with the cooldown, the report tool's
check, the manual trigger, a failed capture that re-arms, the routes
(``/recorder``, ``/incidents``, ``POST /incident``) and their 503s, and
the two-worker fleet breach with two worker processes of the port
(tests/torch_fleet_worker.py). Parity: the same planted series through
both packages' recorders give equal rings and equal windows.

No case waits on the wall clock: rings advance on ``FakeClock``s, a
sampler thread or a capture worker is waited for on an event or a
condition with a deadline, and where the JAX twin sleeps for a worker's
recorder to tick, this one polls that worker's ``/recorder`` until the
queries show. The route test samples the process recorder by hand (its
thread stopped) and keeps its exemplar on a histogram of its own, so the
rest of the process cannot change what it reads.
"""

import json
import os
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from incubator_predictionio_tpu.obs import metrics as jmetrics
from incubator_predictionio_tpu.obs import recorder as jrecorder
from incubator_predictionio_tpu.utils.times import FakeClock as JFakeClock
from incubator_predictionio_tpu_torch.obs import expofmt, federate
from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
from incubator_predictionio_tpu_torch.obs import recorder as obs_recorder
from incubator_predictionio_tpu_torch.obs import slo as obs_slo
from incubator_predictionio_tpu_torch.obs import trace as obs_trace
from incubator_predictionio_tpu_torch.obs.metrics import Registry
from incubator_predictionio_tpu_torch.obs.recorder import (
    FlightRecorder,
    IncidentCapture,
)
from incubator_predictionio_tpu_torch.utils.times import FakeClock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(TESTS_DIR, "torch_fleet_worker.py")
REPORT = os.path.join(REPO, "scripts", "incident_report.py")


@pytest.fixture
def clean_singletons():
    obs_recorder.reset_recorder()
    obs_slo.reset_engine()
    yield
    obs_recorder.reset_recorder()
    obs_slo.reset_engine()


def _recorder(reg, clock, wall, hz=1.0, window_s=10.0, keyframe_every=4,
              cls=FlightRecorder):
    return cls(registry=reg, hz=hz, window_s=window_s, clock=clock,
               wall=wall, keyframe_every=keyframe_every)


def _until(cond, timeout=10.0):
    """Wait for ``cond()`` on a condition, up to ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    done = threading.Event()
    while not cond():
        if time.monotonic() > deadline:
            return False
        done.wait(0.01)
    return True


# -- ring math ----------------------------------------------------------------

def test_ring_retention_and_eviction_math():
    reg = Registry()
    g = reg.gauge("t_gauge", "g")
    clock = FakeClock(100.0)
    rec = _recorder(reg, clock, clock)
    assert rec.slots == 15
    for i in range(40):
        g.set(float(i))
        rec.sample_now()
        clock.advance(1.0)
    assert rec.index()["samples"] == rec.slots
    pts = rec.window(series=["t_gauge"], window_s=10.0)[
        "series"]["t_gauge"]["children"][0]["points"]
    assert len(pts) == 11
    assert [p[1] for p in pts] == [float(i) for i in range(29, 40)]
    win3 = rec.window(series=["t_gauge"], window_s=3.0)
    assert [p[1] for p in
            win3["series"]["t_gauge"]["children"][0]["points"]] == \
        [36.0, 37.0, 38.0, 39.0]
    assert 0 < rec._ring_bytes < 10_000_000


def _plant(reg, rec, clock, ticks=60, seed=7):
    """Seeded random mutations of a labeled counter, a gauge and a
    histogram, one sample a tick → the truth per tick."""
    import random

    rng = random.Random(seed)
    c = reg.counter("t_total", "c", labels=("route",))
    g = reg.gauge("t_depth", "g")
    h = reg.histogram("t_lat_seconds", "h", buckets=(0.1, 1.0, 10.0))
    truth = []
    for _ in range(ticks):
        if rng.random() < 0.7:
            c.labels(route="/a").inc(rng.randint(1, 3))
        if rng.random() < 0.4:
            c.labels(route="/b").inc()
        if rng.random() < 0.8:
            g.set(rng.uniform(0, 50))
        for _ in range(rng.randint(0, 3)):
            h.observe(rng.choice([0.05, 0.5, 5.0, 50.0]))
        rec.sample_now()
        truth.append((c.labels(route="/a").value,
                      c.labels(route="/b").value, g.value, h.count, h.sum))
        clock.advance(1.0)
    return truth


def test_delta_encode_decode_identity():
    reg = Registry()
    clock = FakeClock(0.0)
    rec = _recorder(reg, clock, clock, window_s=20.0, keyframe_every=5)
    truth = _plant(reg, rec, clock)
    win = rec.window(window_s=20.0)
    n = len(win["series"]["t_depth"]["children"][0]["points"])
    assert n == 21
    by_route = {json.dumps(ch["labels"], sort_keys=True): ch["points"]
                for ch in win["series"]["t_total"]["children"]}
    pts_a, pts_b = by_route['{"route": "/a"}'], by_route['{"route": "/b"}']
    pts_g = win["series"]["t_depth"]["children"][0]["points"]
    pts_h = win["series"]["t_lat_seconds"]["children"][0]["points"]
    for i, (va, vb, vg, hc, hs) in enumerate(truth[-n:]):
        assert pts_a[i][1] == va and pts_b[i][1] == vb
        assert pts_g[i][1] == pytest.approx(vg)
        assert pts_h[i][1] == hc
        assert pts_h[i][2] == pytest.approx(hs, abs=1e-6)
    assert sum(p[3] for p in pts_h[1:]) == pts_h[-1][1] - pts_h[0][1]


def test_both_packages_delta_encode_to_equal_rings():
    """The parity pin: the same planted series through both packages'
    recorders (each on its own registry and ``FakeClock``) leave equal
    ring entries, keyframes and deltas alike, and reconstruct equal
    windows and indexes."""
    rings = {}
    for name, (reg_cls, rec_cls, clock_cls) in {
            "port": (Registry, FlightRecorder, FakeClock),
            "jax": (jmetrics.Registry, jrecorder.FlightRecorder,
                    JFakeClock)}.items():
        reg, clock = reg_cls(), clock_cls(0.0)
        rec = _recorder(reg, clock, clock, window_s=20.0,
                        keyframe_every=5, cls=rec_cls)
        truth = _plant(reg, rec, clock, ticks=47)
        rings[name] = (list(rec._ring), rec._head, rec._ring_bytes,
                       rec.window(window_s=20.0), rec.index(), truth)
    assert rings["port"] == rings["jax"]
    ring = rings["port"][0]
    assert {e[2] for e in ring if e is not None} == {"key", "delta"}


def test_histogram_interval_quantiles_reflect_that_second():
    reg = Registry()
    h = reg.histogram("t_q_seconds", "h", buckets=(0.01, 0.1, 1.0))
    clock = FakeClock(0.0)
    rec = _recorder(reg, clock, clock)
    for _ in range(100):
        h.observe(0.005)
    rec.sample_now()
    clock.advance(1.0)
    for _ in range(100):
        h.observe(0.5)
    rec.sample_now()
    pts = rec.window(series=["t_q_seconds"], window_s=10.0)[
        "series"]["t_q_seconds"]["children"][0]["points"]
    assert pts[0][5] <= 0.01
    assert 0.1 < pts[1][5] <= 1.0


def _samplers():
    """Live sampler threads of the port's recorders."""
    return [t for t in threading.enumerate()
            if t.name == "pio-torch-flight-recorder"]


def test_recorder_sampler_thread_and_off_mode(monkeypatch,
                                              clean_singletons):
    monkeypatch.setenv("PIO_RECORDER", "0")
    assert obs_recorder.get_recorder() is None
    assert not _samplers()
    monkeypatch.setenv("PIO_RECORDER", "1")
    monkeypatch.setenv("PIO_RECORDER_HZ", "50")
    rec = obs_recorder.get_recorder()
    assert rec is not None and _samplers()
    # the sampler's own ticks, counted on an event (the loop calls the
    # instance attribute each tick)
    ticked, seen = threading.Event(), []
    real = rec.sample_now

    def counting():
        out = real()
        seen.append(out)
        if len(seen) >= 3:
            ticked.set()
        return out

    monkeypatch.setattr(rec, "sample_now", counting)
    assert ticked.wait(10.0)
    assert rec.index()["samples"] >= 3
    assert rec.registry.get("pio_recorder_samples_total").value >= 3
    assert rec.registry.get("pio_recorder_ring_bytes").value > 0
    obs_recorder.reset_recorder()
    assert _until(lambda: not _samplers())


def test_observe_p99_unchanged_with_recorder_on():
    reg = Registry()
    h = reg.histogram("t_hot_seconds", "h")
    rec = FlightRecorder(registry=reg, hz=100.0, window_s=5.0,
                         clock=time.monotonic, wall=time.time)
    rec.start()
    try:
        assert _until(lambda: rec.index()["samples"] >= 1)
        walls = []
        tok = obs_trace.set_current("hot-trace")
        try:
            for i in range(20000):
                t0 = time.perf_counter()
                h.observe(0.001 * (i % 7))
                walls.append(time.perf_counter() - t0)
        finally:
            obs_trace.reset_current(tok)
        walls.sort()
        assert walls[int(len(walls) * 0.99)] < 0.005
        assert rec.index()["samples"] >= 2
    finally:
        rec.stop()


# -- exemplars ----------------------------------------------------------------

def _traced(trace_id, fn):
    tok = obs_trace.set_current(trace_id)
    try:
        fn()
    finally:
        obs_trace.reset_current(tok)


def test_exemplar_reservoir_determinism_under_seeded_load():
    def run():
        obs_metrics.seed_exemplar_rng(42)
        h = Registry().histogram("t_ex_seconds", "h", buckets=(0.1, 1.0))
        for i in range(200):
            _traced(f"trace-{i}",
                    lambda: h.observe(0.05 if i % 2 == 0 else 0.5))
        return [(e["le"], e["traceId"], e["value"])
                for e in h.exemplars()]

    a, b = run(), run()
    assert a == b and len(a) == 2
    assert all(tid.startswith("trace-") for _le, tid, _v in a)


def test_exemplar_window_reset_and_untraced_observations(monkeypatch):
    """The window runs on the registry's wall clock, planted here."""
    monkeypatch.setenv("PIO_EXEMPLAR_WINDOW_S", "0.05")
    now = [1000.0]
    monkeypatch.setattr(obs_metrics, "time", types.SimpleNamespace(
        time=lambda: now[0], monotonic=time.monotonic,
        perf_counter=time.perf_counter))
    h = Registry().histogram("t_w_seconds", "h", buckets=(1.0,))
    h.observe(0.5)
    assert h.exemplars() == []
    _traced("first-window", lambda: h.observe(0.5))
    now[0] += 0.1  # the window expires
    _traced("second-window", lambda: h.observe(0.5))
    ex = h.exemplars()
    assert len(ex) == 1 and ex[0]["traceId"] == "second-window"


def test_exemplars_off_switch(monkeypatch):
    monkeypatch.setenv("PIO_EXEMPLARS", "0")
    reg = Registry()
    h = reg.histogram("t_off_seconds", "h", buckets=(1.0,))
    _traced("should-not-appear", lambda: h.observe(0.5))
    assert h.exemplars() == []
    assert "# {" not in reg.expose()


def _scrape_result(instance, text, ok=True):
    return federate.ScrapeResult(
        target=federate.Target(instance, f"http://{instance}"),
        ok=ok, wall_s=0.0,
        families=expofmt.parse_families(text) if ok else {})


def test_exemplar_emit_parse_reemit_byte_stable():
    reg = Registry()
    h = reg.histogram("t_rt_seconds", "h", buckets=(0.1, 1.0))
    _traced("rt-trace", lambda: (h.observe(0.05), h.observe(0.7)))
    text = reg.expose()
    raw = sorted(line.split(" # ", 1)[1] for line in text.splitlines()
                 if " # {" in line)
    assert len(raw) == 2
    fleet_text = federate.FederatedSnapshot(
        [_scrape_result("w1", text)]).expose()
    assert sorted(line.split(" # ", 1)[1]
                  for line in fleet_text.splitlines()
                  if " # {" in line) == raw
    child = list(expofmt.parse_families(fleet_text)[
        "t_rt_seconds"].histograms.values())[0]
    assert [tid for _le, tid in child.exemplar_trace_ids()] == \
        ["rt-trace", "rt-trace"]


def test_unknown_exemplar_annotation_passes_through():
    weird = ('# TYPE t_f_seconds histogram\n'
             't_f_seconds_bucket{le="1"} 3 '
             '# {span_id="zz",weird="yes"} 0.5 not-a-ts extra\n'
             't_f_seconds_bucket{le="+Inf"} 3\n'
             't_f_seconds_sum 1.5\n'
             't_f_seconds_count 3\n'
             '# TYPE t_c_total counter\n'
             't_c_total 5 # {foo="bar"} 1\n')
    child = list(expofmt.parse_families(weird)[
        "t_f_seconds"].histograms.values())[0]
    raw = child.exemplars[1.0]
    assert raw == '# {span_id="zz",weird="yes"} 0.5 not-a-ts extra'
    assert expofmt.parse_exemplar(raw) is None
    assert child.exemplar_trace_ids() == []
    fleet_text = federate.FederatedSnapshot(
        [_scrape_result("w1", weird)]).expose()
    assert '# {span_id="zz",weird="yes"} 0.5 not-a-ts extra' in fleet_text
    assert '# {foo="bar"} 1' in fleet_text
    expofmt.parse_families(fleet_text)


def test_federation_kind_mismatch_drop_with_exemplars_present():
    reg = Registry()
    h = reg.histogram("t_km_seconds", "h", buckets=(1.0,))
    _traced("keep-me", lambda: h.observe(0.5))
    bad = '# TYPE t_km_seconds counter\nt_km_seconds 7\n'
    m = federate.FederatedSnapshot([
        _scrape_result("new", reg.expose()),
        _scrape_result("old", bad)]).get("t_km_seconds")
    assert m.kind == "histogram"
    assert [(inst, tid) for inst, _le, tid in m.exemplar_trace_ids()] == \
        [("new", "keep-me")]
    assert not [k for k in m.values if k[0] == "old"]


def test_exemplar_free_old_worker_federates_cleanly():
    reg_new = Registry()
    h = reg_new.histogram("t_mix_seconds", "h", buckets=(1.0,))
    _traced("new-only", lambda: h.observe(0.5))
    reg_old = Registry()
    reg_old.histogram("t_mix_seconds", "h", buckets=(1.0,)).observe(0.5)
    snap = federate.FederatedSnapshot([
        _scrape_result("new", reg_new.expose()),
        _scrape_result("old", reg_old.expose())])
    m = snap.get("t_mix_seconds")
    assert m.count == 2
    assert [(inst, tid) for inst, _le, tid in m.exemplar_trace_ids()] == \
        [("new", "new-only")]
    expofmt.parse_families(snap.expose())


def test_scheduler_dispatch_carries_exemplar_trace():
    """The port's scheduler re-installs the submitter's trace id around
    ``handle_batch`` on its dispatcher thread."""
    from incubator_predictionio_tpu_torch.serving.scheduler import (
        BatchScheduler,
    )

    h = Registry().histogram("t_sched_seconds", "h", buckets=(1.0,))
    seen_trace = []

    def handle(bodies):
        seen_trace.append(obs_trace.current_trace_id())
        h.observe(0.5, len(bodies))
        return bodies

    sched = BatchScheduler(handle, 8, shed=False)
    try:
        tok = obs_trace.set_current("sched-trace-1")
        try:
            fut = sched.submit({"q": 1})
        finally:
            obs_trace.reset_current(tok)
        # the future resolves after handle_batch has observed
        assert fut.result(timeout=10) == {"q": 1}
        ex = h.exemplars()
        assert ex and ex[0]["traceId"] == "sched-trace-1"
        assert seen_trace == ["sched-trace-1"]
    finally:
        sched.stop()


# -- incident capture -----------------------------------------------------------

def _serve_spec(threshold=0.001):
    return (obs_slo.SLOSpec(
        name="serve_p99", metric="pio_query_latency_seconds",
        threshold=threshold, target=0.99, description="test objective"),)


def _bundles(path):
    return sorted(p.name for p in path.glob("inc-*.json"))


def _report_check(path):
    return subprocess.run([sys.executable, REPORT, str(path), "--check"],
                          capture_output=True, text=True, timeout=60)


def test_planted_breach_exactly_one_bundle_cooldown_pinned(tmp_path,
                                                          monkeypatch):
    from incubator_predictionio_tpu_torch.obs import knobs as obs_knobs

    # the process knob controller, which the capture's default knobs_fn
    # peeks: one mode change, then one evaluation (no recorder: no_data)
    monkeypatch.setenv("PIO_RECORDER", "0")
    obs_knobs.reset_knob_controller()
    knb = obs_knobs.get_knob_controller()
    knb.set_mode("observe")
    assert knb.evaluate_once()["reason"] == "no_data"
    try:
        _planted_breach_bundles(tmp_path)
    finally:
        obs_knobs.reset_knob_controller()


def _planted_breach_bundles(tmp_path):
    reg = Registry()
    h = reg.histogram("pio_query_latency_seconds", "q")
    clock = FakeClock(1000.0)
    engine = obs_slo.SLOEngine(specs=_serve_spec(), registry=reg,
                               clock=clock, export_gauges=False,
                               min_tick_interval_s=0.0)
    rec = _recorder(reg, clock, clock, window_s=30.0)
    cap = IncidentCapture(directory=str(tmp_path), recorder=rec,
                          cooldown_s=120.0, clock=clock, wall=clock,
                          targets_fn=lambda: [],
                          decisions_fn=lambda: [
                              {"id": 1, "kind": "evaluation",
                               "ts": 995.0, "action": "none"}])
    cap.install(engine)
    engine.evaluate()
    assert _bundles(tmp_path) == []
    for step in range(5):
        clock.advance(2.0)
        for _ in range(20):
            _traced(f"bad-{step}", lambda: h.observe(0.5))
        rec.sample_now()
        engine.evaluate()
    # stop() drains every queued capture before it returns
    cap.stop()
    assert len(_bundles(tmp_path)) == 1, _bundles(tmp_path)
    bundle = json.loads((tmp_path / _bundles(tmp_path)[0]).read_text())
    assert bundle["trigger"] == "serve_p99" and bundle["scope"] == "process"
    assert bundle["slo"]["windows"]["fast"]["burnRate"] > 1.0
    assert "pio_query_latency_seconds" in \
        bundle["recorder"]["instances"]["local"]["series"]
    assert bundle["exemplars"]["traceIds"]
    assert bundle["decisions"] == [{"id": 1, "kind": "evaluation",
                                    "ts": 995.0, "action": "none"}]
    # the knob ring through the recorder's peek (the capture's default
    # knobs_fn): the process knob controller's decisions, one evaluation
    assert [d["kind"] for d in bundle["knobs"]] == ["evaluation",
                                                    "mode_change"]
    assert bundle["knobsTotal"] == 2
    clock.advance(200.0)
    for _ in range(20):
        h.observe(0.5)
    engine.evaluate()
    cap.stop()
    assert len(_bundles(tmp_path)) == 2, _bundles(tmp_path)
    proc = _report_check(tmp_path / _bundles(tmp_path)[0])
    assert proc.returncode == 0, proc.stderr


def test_incident_report_check_rejects_malformed(tmp_path):
    """The report tool refuses what the port's bundles must never be."""
    bad = tmp_path / "inc-bad.json"
    bad.write_text(json.dumps({"schema": "pio-incident-v1",
                               "id": "inc-bad"}))
    proc = _report_check(bad)
    assert proc.returncode == 1 and "MALFORMED" in proc.stderr
    notjson = tmp_path / "inc-notjson.json"
    notjson.write_text("{truncated")
    assert _report_check(notjson).returncode == 1
    # and accepts a manual bundle of the port
    rec = _recorder(Registry(), FakeClock(0.0), FakeClock(0.0))
    cap = IncidentCapture(directory=str(tmp_path / "ok"), recorder=rec,
                          targets_fn=lambda: [])
    out = cap.capture_now(cap.MANUAL_TRIGGER)
    assert _report_check(out["path"]).returncode == 0


def test_manual_trigger_bypasses_cooldown(tmp_path):
    clock = FakeClock(0.0)
    rec = _recorder(Registry(), clock, clock)
    cap = IncidentCapture(directory=str(tmp_path), recorder=rec,
                          cooldown_s=3600.0, clock=clock, wall=clock,
                          targets_fn=lambda: [], decisions_fn=lambda: [])
    out1 = cap.capture_now(cap.MANUAL_TRIGGER)
    out2 = cap.capture_now(cap.MANUAL_TRIGGER)
    assert out1["id"] != out2["id"]
    assert len(_bundles(tmp_path)) == 2
    assert cap.trigger("serve_p99") is True
    assert cap.trigger("serve_p99") is False
    cap.stop()


def test_failed_capture_does_not_consume_cooldown(tmp_path):
    clock = FakeClock(0.0)
    rec = _recorder(Registry(), clock, clock)
    cap = IncidentCapture(directory=str(tmp_path), recorder=rec,
                          cooldown_s=3600.0, clock=clock, wall=clock,
                          targets_fn=lambda: [], decisions_fn=lambda: [])
    boom = {"fail": True}
    real_capture = cap.capture_now
    attempts = threading.Semaphore(0)

    def flaky(reason, slo_entry=None):
        try:
            if boom["fail"]:
                raise OSError("disk full")
            return real_capture(reason, slo_entry)
        finally:
            attempts.release()

    cap.capture_now = flaky
    assert cap.trigger("serve_p99") is True
    assert attempts.acquire(timeout=10)
    assert _until(lambda: "serve_p99" not in cap._queued)
    assert _bundles(tmp_path) == []
    boom["fail"] = False
    assert cap.trigger("serve_p99") is True
    assert attempts.acquire(timeout=10)
    cap.stop()
    assert len(_bundles(tmp_path)) == 1


# -- the routes -----------------------------------------------------------------

def _get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return json.loads(resp.read().decode())


def _router_server(*adders):
    from incubator_predictionio_tpu_torch.utils.http import (
        HttpServer,
        Router,
    )

    r = Router()
    for add in adders:
        add(r)
    return HttpServer(r, "127.0.0.1", 0, name="admin")


def test_recorder_and_incident_routes_e2e(monkeypatch, tmp_path,
                                          clean_singletons):
    from incubator_predictionio_tpu_torch.obs.http import (
        add_incident_routes,
        add_metrics_route,
        add_recorder_route,
    )

    monkeypatch.setenv("PIO_RECORDER", "1")
    monkeypatch.setenv("PIO_INCIDENT_DIR", str(tmp_path))
    # a family of this test's own: nothing else in the process observes
    # it, so its exemplar and its counts are the ones planted here
    h = obs_metrics.REGISTRY.histogram(
        "t_routes_e2e_seconds", "the route test's own histogram",
        labels=("tenant",))
    srv = _router_server(add_metrics_route, add_recorder_route,
                         add_incident_routes)
    port = srv.start_background()
    try:
        rec = obs_recorder.get_recorder()
        rec.stop()  # one writer: the samples below are this test's
        _traced("e2e-trace", lambda: [
            h.labels(tenant="default").observe(0.02) for _ in range(10)])
        for _ in range(3):
            rec.sample_now()
        idx = _get_json(port, "/recorder")
        assert idx["samples"] >= 3
        assert "t_routes_e2e_seconds" in idx["series"]
        win = _get_json(port,
                        "/recorder?series=t_routes_e2e_seconds&window=60")
        pts = win["series"]["t_routes_e2e_seconds"]["children"][0][
            "points"]
        assert pts and pts[-1][1] == 10
        full = _get_json(port, "/recorder?all=1")
        assert any(e["traceId"] == "e2e-trace" and
                   e["metric"] == "t_routes_e2e_seconds"
                   for e in full["exemplars"])
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as resp:
            assert '# {trace_id="e2e-trace"}' in resp.read().decode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/incident",
                                     data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            created = json.loads(resp.read().decode())
        assert created["id"].startswith("inc-")
        listing = _get_json(port, "/incidents")
        assert created["id"] in [i["id"] for i in listing["incidents"]]
        bundle = _get_json(port, f"/incidents/{created['id']}")
        assert bundle["trigger"] == "manual"
        assert "local" in bundle["recorder"]["instances"]
        assert bundle["decisions"] == [] and bundle["knobs"] == []
        with pytest.raises(urllib.error.HTTPError) as err:
            _get_json(port, "/incidents/inc-nope")
        assert err.value.code == 404
    finally:
        srv.stop()


def test_recorder_route_503_when_disabled(monkeypatch, clean_singletons):
    from incubator_predictionio_tpu_torch.obs.http import add_recorder_route

    monkeypatch.setenv("PIO_RECORDER", "0")
    srv = _router_server(add_recorder_route)
    port = srv.start_background()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _get_json(port, "/recorder")
        assert err.value.code == 503
        assert not _samplers()
    finally:
        srv.stop()


def test_incident_routes_503_without_dir(monkeypatch, clean_singletons):
    from incubator_predictionio_tpu_torch.obs.http import (
        add_incident_routes,
    )

    monkeypatch.delenv("PIO_INCIDENT_DIR", raising=False)
    srv = _router_server(add_incident_routes)
    port = srv.start_background()
    try:
        for path in ("/incidents", "/incidents/inc-x"):
            with pytest.raises(urllib.error.HTTPError) as err:
                _get_json(port, path)
            assert err.value.code == 503
    finally:
        srv.stop()


def test_bundle_freezes_the_tenant_block(tmp_path, monkeypatch):
    """The bundle's ``tenants`` block comes from
    ``tenancy.export_tenants_fn``: None in single-tenant mode, the
    registry's policy with keys redacted under ``PIO_TENANTS``."""
    from incubator_predictionio_tpu_torch.serving import tenancy

    rec = _recorder(Registry(), FakeClock(0.0), FakeClock(0.0))
    cap = IncidentCapture(directory=str(tmp_path), recorder=rec,
                          targets_fn=lambda: [])
    monkeypatch.delenv("PIO_TENANTS", raising=False)
    tenancy.reset_registry()
    try:
        out = cap.capture_now(cap.MANUAL_TRIGGER)
        assert json.loads(open(out["path"]).read())["tenants"] is None
        monkeypatch.setenv("PIO_TENANTS", "acme:acme-key:weight=3")
        tenancy.reset_registry()
        out = cap.capture_now(cap.MANUAL_TRIGGER)
        text = open(out["path"]).read()
        block = json.loads(text)["tenants"]
        assert block is not None and "acme" in json.dumps(block)
        assert "acme-key" not in text
    finally:
        monkeypatch.delenv("PIO_TENANTS", raising=False)
        tenancy.reset_registry()


# -- two worker processes of the port: one fleet breach, one bundle -------------

def _spawn_serve_worker(seed, sink):
    env = {**os.environ, "PIO_DEVICE": "cpu", "PIO_RECORDER": "1",
           "PIO_RECORDER_HZ": "10", "PIO_SPEED_LAYER": "0",
           "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    env.pop("PIO_INCIDENT_DIR", None)  # the workers record, the test
    proc = subprocess.Popen(            # captures
        [sys.executable, WORKER, "--mode", "serve", "--seed", str(seed),
         "--users", "60", "--items", "40", "--rank", "8",
         "--max-batch", "8"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=TESTS_DIR, env=env)
    # the span log drains live, so the pipe never fills
    proc.drain = threading.Thread(target=lambda: sink.extend(proc.stderr),
                                  daemon=True)
    proc.drain.start()
    return proc


def _worker_port(proc, sink):
    from test_torch_federation import first_line

    line = first_line(proc)
    if not line.startswith("PORT "):
        proc.kill()
        raise RuntimeError("worker never bound: " + "".join(sink)[-2000:])
    return int(line.split()[1])


def test_two_worker_fleet_breach_acceptance(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import trace_stitch

    spans0, spans1 = [], []
    p0 = _spawn_serve_worker(0, spans0)
    p1 = _spawn_serve_worker(1, spans1)
    sent = []
    try:
        port0, port1 = _worker_port(p0, spans0), _worker_port(p1, spans1)
        targets = [
            federate.Target("w0", f"http://127.0.0.1:{port0}/metrics"),
            federate.Target("w1", f"http://127.0.0.1:{port1}/metrics")]
        engine = obs_slo.SLOEngine(
            specs=_serve_spec(threshold=1e-6),
            registry=federate.FleetRegistry(targets_fn=lambda: targets,
                                            max_age_s=0.0),
            export_gauges=False, min_tick_interval_s=0.0)
        decisions = [{"id": 7, "kind": "evaluation", "mode": "act",
                      "ts": time.time(), "action": "retrain+reload",
                      "traceId": "ctl-deadbeef"}]
        cap = IncidentCapture(directory=str(tmp_path), cooldown_s=3600.0,
                              targets_fn=lambda: targets,
                              decisions_fn=lambda: decisions)
        cap.install(engine)

        def query(port, i):
            tid = f"fleet-q-{port}-{i}"
            sent.append(tid)
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/queries.json",
                data=json.dumps({"user": f"u{i % 60}", "num": 5}).encode(),
                headers={"Content-Type": "application/json",
                         "X-PIO-Trace-Id": tid,
                         "X-PIO-Parent-Span": "cafe0001"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                assert resp.status == 200
                assert len(json.loads(resp.read())["itemScores"]) == 5

        def recorded(port):
            win = _get_json(
                port, "/recorder?series=pio_query_latency_seconds")
            fam = win["series"].get("pio_query_latency_seconds")
            return fam is not None and sum(
                ch["points"][-1][1] for ch in fam["children"]) >= 25

        engine.evaluate()  # the baseline fleet snapshot
        for i in range(25):
            query(port0, i)
            query(port1, i)
        # each worker's recorder has ticked past the queries
        assert _until(lambda: recorded(port0) and recorded(port1), 30.0)
        engine.evaluate()  # burn > 1: the breach, one capture
        for i in range(25, 35):
            query(port0, i)
        engine.evaluate()  # still burning: inside the cooldown
        cap.stop()         # drains the capture worker
        bundles = sorted(tmp_path.glob("inc-*.json"))
        assert len(bundles) == 1, [b.name for b in bundles]
        bundle = json.loads(bundles[0].read_text())
        assert bundle["trigger"] == "serve_p99"
        assert bundle["scope"] == "fleet"
        insts = bundle["recorder"]["instances"]
        assert sorted(insts) == ["w0", "w1"]
        for name in ("w0", "w1"):
            dump = insts[name]
            assert "error" not in dump, dump.get("error")
            assert "pio_query_latency_seconds" in dump["series"]
            assert "engines" in dump["state"]["scheduler"]
        ex_ids = bundle["exemplars"]["traceIds"]
        assert ex_ids and set(ex_ids) <= set(sent)
        assert bundle["decisions"] == decisions
        proc = _report_check(bundles[0])
        assert proc.returncode == 0, proc.stderr
    finally:
        for p in (p0, p1):
            p.stdin.close()
        for p in (p0, p1):
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
            p.drain.join(timeout=30)
    traces = trace_stitch.group_by_trace(
        trace_stitch.parse_span_lines(spans0 + spans1))
    stitched = 0
    for tid in ex_ids:
        if tid in traces:
            rendered = trace_stitch.render_trace(tid, traces[tid])
            assert "prediction POST /queries.json" in rendered
            assert any(s.get("parentSpanId") == "cafe0001"
                       for s in traces[tid])
            stitched += 1
    assert stitched >= 1, (ex_ids, list(traces)[:5])
