"""The port's freshness controller (``obs/controller.py``) against the JAX
package's, on the CPU.

Every scenario of tests/test_controller.py runs through both packages on
the same planted signal: a staleness gauge SLO (or a freshness histogram)
on a fresh registry of each package, each package's ``FakeClock``, the
same gauge values, ticks and clock advances, planted retrain / reload
actuators. The decision records must be equal in both: action, reason,
trigger, streak, cooldown, outcome and the projection numbers (within
1e-9 relative); the trace ids, timestamps, span ids and walls, which are
minted per run, are left out of the comparison. The port's records are
then held to the JAX test's assertions. The loop tests (the kill switch,
a timed-out stop) wait on events the loop reaches, not on the clock; the
admin routes, the HTTP reload hop and the front door's trace forwarding
run on the port's own servers.
"""

import importlib
import json
import logging
import math
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import trace_stitch  # noqa: E402


class Pkg:
    """One package's modules, by its root name."""

    def __init__(self, root: str):
        self.root = root
        self.ctl = importlib.import_module(f"{root}.obs.controller")
        self.slo = importlib.import_module(f"{root}.obs.slo")
        self.metrics = importlib.import_module(f"{root}.obs.metrics")
        self.times = importlib.import_module(f"{root}.utils.times")


JAX = Pkg("incubator_predictionio_tpu")
PORT = Pkg("incubator_predictionio_tpu_torch")
MINTED = ("traceId", "ts", "spanId", "wallS")


def norm(x):
    """A decision record without what each run mints anew."""
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items() if k not in MINTED}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    return x


def assert_same(got, ref, path="record"):
    """Deep equality, floats within 1e-9 relative."""
    if isinstance(ref, float) and isinstance(got, (int, float)):
        if math.isnan(ref):
            assert math.isnan(got), path
        else:
            assert got == pytest.approx(ref, rel=1e-9, abs=1e-12), path
    elif isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), \
            f"{path}: {sorted(got)} != {sorted(ref)}"
        for k in ref:
            assert_same(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same(g, r, f"{path}[{i}]")
    else:
        assert got == ref, f"{path}: {got!r} != {ref!r}"


def planted_engine(P, clock, threshold=100.0):
    reg = P.metrics.Registry()
    gauge = reg.gauge("pio_model_staleness_seconds", "x")
    spec = P.slo.SLOSpec(name="staleness",
                         metric="pio_model_staleness_seconds",
                         threshold=threshold, target=0.99, kind="gauge")
    eng = P.slo.SLOEngine(specs=(spec,), registry=reg, clock=clock,
                          fast_window_s=60.0, slow_window_s=600.0,
                          min_tick_interval_s=0.0, export_gauges=False)
    return eng, gauge


def make_controller(P, clock, engine, horizon=10.0, breach_evals=1,
                    cooldown=0.0, interval=0.05, **kw):
    calls = {"retrain": 0, "reload": 0}

    def retrain():
        calls["retrain"] += 1
        return f"inst-{calls['retrain']}"

    def reload():
        calls["reload"] += 1
        return {"reloaded": 2}

    ctl = P.ctl.FreshnessController(
        engine=engine,
        retrain_fn=kw.pop("retrain_fn", retrain),
        reload_fn=kw.pop("reload_fn", reload),
        config=P.ctl.ControllerConfig(interval_s=interval,
                                      breach_evals=breach_evals,
                                      cooldown_s=cooldown,
                                      horizon_s=horizon, ring=64),
        clock=clock, mode=kw.pop("mode", "act"), **kw)
    return ctl, calls


def both(scenario):
    """Run ``scenario(P)`` through both packages; the records must be
    equal. Returns the port's result."""
    got, ref = scenario(PORT), scenario(JAX)
    assert_same(norm(got), norm(ref))
    return got


# ---------------------------------------------------------------------------
# trigger math
# ---------------------------------------------------------------------------

def test_module_surface_equals_the_jax_package():
    assert PORT.ctl.MODES == JAX.ctl.MODES
    assert PORT.ctl.SKIP_REASONS == JAX.ctl.SKIP_REASONS
    assert PORT.ctl.ACTION_REASONS == JAX.ctl.ACTION_REASONS
    assert PORT.ctl.DRIVING_SLOS == JAX.ctl.DRIVING_SLOS
    assert set(PORT.ctl.__all__) == set(JAX.ctl.__all__)


def test_config_from_env_equals_the_jax_package(monkeypatch):
    for k, v in {"PIO_CONTROLLER_INTERVAL_S": "0.5",
                 "PIO_CONTROLLER_HYSTERESIS": "3",
                 "PIO_CONTROLLER_COOLDOWN_S": "12",
                 "PIO_CONTROLLER_HORIZON_S": "40",
                 "PIO_CONTROLLER_RING": "9"}.items():
        monkeypatch.setenv(k, v)
    got = PORT.ctl.ControllerConfig.from_env()
    assert vars(got) == vars(JAX.ctl.ControllerConfig.from_env())
    assert (got.breach_evals, got.ring) == (3, 9)
    monkeypatch.setenv("PIO_CONTROLLER", "ACT ")
    assert PORT.ctl.controller_mode() == JAX.ctl.controller_mode() == "act"
    monkeypatch.setenv("PIO_CONTROLLER", "bogus")
    assert PORT.ctl.controller_mode() == "off"


def test_healthy_fleet_never_triggers():
    def scenario(P):
        clock = P.times.FakeClock(100.0)
        eng, gauge = planted_engine(P, clock)
        ctl, calls = make_controller(P, clock, eng)
        gauge.set(5.0)                 # headroom 95 >> horizon 10
        return ctl.evaluate_once(), calls

    d, calls = both(scenario)
    assert d["action"] == "none" and d["reason"] == "healthy"
    assert calls == {"retrain": 0, "reload": 0}
    assert d["projection"]["stalenessHeadroomS"] == pytest.approx(95.0)
    assert d["inputs"]["slos"]["staleness"]["fastBurn"] == 0.0


def test_no_data_is_a_skip_not_a_trigger():
    def scenario(P):
        clock = P.times.FakeClock(100.0)
        reg = P.metrics.Registry()     # gauge never registered/set
        spec = P.slo.SLOSpec(name="staleness",
                             metric="pio_model_staleness_seconds",
                             threshold=100.0, target=0.99, kind="gauge")
        eng = P.slo.SLOEngine(specs=(spec,), registry=reg, clock=clock,
                              min_tick_interval_s=0.0, export_gauges=False)
        ctl, calls = make_controller(P, clock, eng)
        return ctl.evaluate_once(), calls

    d, calls = both(scenario)
    assert d["reason"] == "no_data"
    assert calls == {"retrain": 0, "reload": 0}


def test_staleness_headroom_projection_acts_before_the_bound():
    def scenario(P):
        clock = P.times.FakeClock(100.0)
        eng, gauge = planted_engine(P, clock, threshold=100.0)
        ctl, calls = make_controller(P, clock, eng, horizon=10.0)
        gauge.set(95.0)                # still UNDER the bound
        return ctl.evaluate_once(), calls

    d, calls = both(scenario)
    assert d["trigger"] == "staleness_projection"
    assert d["action"] == "retrain+reload"
    assert d["outcome"]["actuated"] is True
    assert d["outcome"]["retrain"]["ok"] is True
    assert d["outcome"]["reload"]["ok"] is True
    assert calls == {"retrain": 1, "reload": 1}
    assert d["inputs"]["slos"]["staleness"]["fastBurn"] == 0.0
    assert d["projection"]["projectionS"] == pytest.approx(5.0)


def test_burn_breach_triggers():
    def scenario(P):
        clock = P.times.FakeClock(100.0)
        eng, gauge = planted_engine(P, clock, threshold=100.0)
        ctl, calls = make_controller(P, clock, eng, horizon=1.0)
        gauge.set(5000.0)              # far over the bound: bad ticks
        eng.tick(force=True)
        clock.advance(5)
        return ctl.evaluate_once(), calls

    d, calls = both(scenario)
    assert d["trigger"] == "staleness_burn"
    assert calls["retrain"] == 1


def test_projection_burn_math():
    def scenario(P):
        clock = P.times.FakeClock(100.0)
        reg = P.metrics.Registry()
        h = reg.histogram("t_fresh_seconds", "x", buckets=(1.0,))
        spec = P.slo.SLOSpec(name="freshness_p95", metric="t_fresh_seconds",
                             threshold=1.0, target=0.95)
        eng = P.slo.SLOEngine(specs=(spec,), registry=reg, clock=clock,
                              fast_window_s=60.0, slow_window_s=600.0,
                              min_tick_interval_s=0.0, export_gauges=False)
        ctl, _calls = make_controller(P, clock, eng, mode="observe")
        eng.tick(force=True)           # zero baseline snapshot
        h.observe(0.5, 98)
        h.observe(5.0, 2)              # 2% bad, allowed 5% -> burn 0.4
        clock.advance(10)
        return ctl.evaluate_once(), ctl.config.horizon_s

    d, horizon = both(scenario)
    assert d["reason"] == "healthy"
    proj = d["projection"]
    slos = d["inputs"]["slos"]["freshness_p95"]
    assert 0.0 < slos["fastBurn"] < 1.0
    expected = 600.0 * slos["budgetRemaining"] / slos["fastBurn"]
    assert proj["burnExhaustS"] == pytest.approx(expected, rel=1e-3)
    assert proj["burnExhaustS"] > horizon


# ---------------------------------------------------------------------------
# hysteresis / cooldown / budget / observe
# ---------------------------------------------------------------------------

def test_hysteresis_requires_consecutive_breaches():
    def scenario(P):
        clock = P.times.FakeClock(100.0)
        eng, gauge = planted_engine(P, clock)
        ctl, calls = make_controller(P, clock, eng, breach_evals=3)
        gauge.set(95.0)
        out = [ctl.evaluate_once() for _ in range(3)]
        gauge.set(1.0)                 # a healthy evaluation resets
        out.append(ctl.evaluate_once())
        gauge.set(95.0)
        out.append(ctl.evaluate_once())
        return out, calls

    ds, calls = both(scenario)
    assert [d["reason"] for d in ds] == [
        "hysteresis", "hysteresis", "staleness_projection", "healthy",
        "hysteresis"]
    assert ds[2]["outcome"]["actuated"] is True and ds[2]["streak"] == 3
    assert calls["retrain"] == 1


def test_cooldown_blocks_reflap():
    def scenario(P):
        clock = P.times.FakeClock(100.0)
        eng, gauge = planted_engine(P, clock)
        ctl, calls = make_controller(P, clock, eng, cooldown=60.0)
        gauge.set(95.0)
        out = [ctl.evaluate_once(), ctl.evaluate_once()]
        clock.advance(61.0)
        out.append(ctl.evaluate_once())
        return out, calls

    ds, calls = both(scenario)
    assert ds[0]["outcome"]["actuated"] is True
    assert ds[1]["reason"] == "cooldown"
    assert ds[1]["cooldownRemainingS"] == pytest.approx(60.0)
    assert ds[2]["outcome"]["actuated"] is True
    assert calls["retrain"] == 2


def test_budget_guard_skips_when_capacity_is_binding():
    def scenario(P):
        clock = P.times.FakeClock(100.0)
        eng, gauge = planted_engine(P, clock)
        ctl, calls = make_controller(P, clock, eng,
                                     capacity_fn=lambda: 1000.0)
        gauge.set(95.0)                # projection 5 s << 1000 s wall
        d = ctl.evaluate_once()
        ctl2, calls2 = make_controller(P, clock, eng,
                                       capacity_fn=lambda: 2.0)
        return d, calls, ctl2.evaluate_once(), calls2

    d, calls, d2, calls2 = both(scenario)
    assert d["reason"] == "budget"
    assert d["projection"]["retrainWallEstS"] == 1000.0
    assert calls == {"retrain": 0, "reload": 0}
    assert d2["outcome"]["actuated"] is True
    assert d2["projection"]["retrainWallEstS"] == 2.0
    assert calls2["retrain"] == 1


def test_observe_mode_is_a_dry_run():
    def scenario(P):
        clock = P.times.FakeClock(100.0)
        eng, gauge = planted_engine(P, clock)
        ctl, calls = make_controller(P, clock, eng, mode="observe")
        gauge.set(95.0)
        return ctl.evaluate_once(), calls

    d, calls = both(scenario)
    assert d["action"] == "retrain+reload" and d["reason"] == "observe"
    assert d["outcome"] == {"actuated": False, "dryRun": True}
    assert calls == {"retrain": 0, "reload": 0}


def test_failed_retrain_skips_the_reload():
    def scenario(P):
        clock = P.times.FakeClock(100.0)
        eng, gauge = planted_engine(P, clock)

        def bad_retrain():
            raise RuntimeError("train blew up")

        ctl, calls = make_controller(P, clock, eng, retrain_fn=bad_retrain)
        gauge.set(95.0)
        return ctl.evaluate_once(), calls

    d, calls = both(scenario)
    assert d["outcome"]["retrain"]["ok"] is False
    assert d["outcome"]["retrain"]["error"] == "train blew up"
    assert d["outcome"]["reload"] == {"ok": False,
                                      "skipped": "retrain_failed"}
    assert calls["reload"] == 0


def test_capacity_budget_fn_without_inputs_is_no_guard(monkeypatch):
    monkeypatch.delenv("PIO_CONTROLLER_ROWS", raising=False)
    assert PORT.ctl.capacity_budget_fn()() is None
    assert JAX.ctl.capacity_budget_fn()() is None
    PORT.ctl.reset_controller()
    try:
        ctl = PORT.ctl.get_controller()
        assert ctl.stats()["actuators"] == {
            "retrain": False, "reload": False, "capacityGuard": False}
        assert PORT.ctl.peek_decisions() == []
    finally:
        PORT.ctl.reset_controller()


def test_env_wired_controller_reloads_through_the_url(monkeypatch):
    monkeypatch.setenv("PIO_CONTROLLER_RELOAD_URL", "127.0.0.1:9/reload")
    monkeypatch.setenv("PIO_CONTROLLER_ROWS", "100000000")
    PORT.ctl.reset_controller()
    try:
        ctl = PORT.ctl.get_controller()
        assert ctl is PORT.ctl.get_controller()
        # the repo's records are TPU runs: no card fit, so no guard even
        # with the row count declared (the JAX package's guard engages)
        assert ctl.stats()["actuators"] == {
            "retrain": False, "reload": True, "capacityGuard": False}
    finally:
        PORT.ctl.reset_controller()


def test_slo_error_resets_hysteresis_and_projection_gauge():
    def scenario(P):
        clock = P.times.FakeClock(100.0)
        eng, gauge = planted_engine(P, clock)
        ctl, calls = make_controller(P, clock, eng, breach_evals=2)
        gauge.set(95.0)
        out = [ctl.evaluate_once()]
        real_eval = eng.evaluate
        eng.evaluate = lambda: (_ for _ in ()).throw(
            RuntimeError("fleet down"))
        out.append(ctl.evaluate_once())
        nan = math.isnan(P.ctl._PROJECTION.value)
        exposed = ("pio_controller_budget_projection_seconds NaN"
                   in P.metrics.REGISTRY.expose())
        eng.evaluate = real_eval
        out.append(ctl.evaluate_once())
        return out, calls, nan, exposed

    ds, calls, nan, exposed = both(scenario)
    assert [d["reason"] for d in ds] == ["hysteresis", "slo_error",
                                         "hysteresis"]
    assert ds[1]["error"] == "fleet down"
    assert nan and exposed
    assert ds[2]["streak"] == 1
    assert calls["retrain"] == 0


# ---------------------------------------------------------------------------
# the loop: the kill switch halts within one evaluation period
# ---------------------------------------------------------------------------

class _Counting:
    """Counts a controller's loop passes; :meth:`passes_after` waits for
    ``n`` more (an event the loop reaches, not a clock)."""

    def __init__(self, ctl):
        self.cv = threading.Condition()
        self.n = 0
        real = ctl.evaluate_once

        def counted():
            try:
                return real()
            finally:
                with self.cv:
                    self.n += 1
                    self.cv.notify_all()

        ctl.evaluate_once = counted

    def passes_after(self, n, timeout=10.0):
        with self.cv:
            target = self.n + n
            assert self.cv.wait_for(lambda: self.n >= target, timeout)


def test_kill_switch_halts_within_one_evaluation_period():
    clock = PORT.times.FakeClock(100.0)
    eng, gauge = planted_engine(PORT, clock)
    ctl, calls = make_controller(PORT, clock, eng)
    passes = _Counting(ctl)
    gauge.set(95.0)                    # permanent trigger
    ctl.start()
    try:
        passes.passes_after(2)
        assert calls["retrain"] >= 2, "controller loop never acted"
        ctl.set_mode("off")
        passes.passes_after(1)         # the pass that reads the flip
        frozen = calls["retrain"]
        passes.passes_after(5)
        assert calls["retrain"] == frozen, (
            "actuation continued after the kill switch")
        ctl.set_mode("act")
        passes.passes_after(2)
        assert calls["retrain"] > frozen
    finally:
        ctl.stop()
    kinds = [d for d in ctl.decisions(limit=64)
             if d.get("kind") == "mode_change"]
    assert [(d["from"], d["to"]) for d in kinds[::-1]] == [
        ("act", "off"), ("off", "act")]


def test_timed_out_stop_cannot_resurrect_the_old_loop():
    clock = PORT.times.FakeClock(100.0)
    eng, gauge = planted_engine(PORT, clock)
    release = threading.Event()
    entered = threading.Event()

    def slow_retrain():
        entered.set()
        release.wait(10)
        return "slow"

    ctl, _calls = make_controller(PORT, clock, eng, retrain_fn=slow_retrain,
                                  reload_fn=lambda: {"ok": True})
    gauge.set(95.0)
    ctl.start()
    assert entered.wait(5)
    inflight = [d for d in ctl.decisions(limit=8)
                if (d.get("outcome") or {}).get("inFlight")]
    assert inflight and inflight[0]["action"] == "retrain+reload"
    ctl.stop(timeout=0.05)     # join times out: actuation in flight
    entered.clear()
    ctl.start()                # a new generation while the old lives
    assert entered.wait(5)     # the new loop reached its actuation
    ctl.set_mode("off")
    release.set()
    name = "pio-torch-freshness-controller"
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        alive = [t for t in threading.enumerate() if t.name == name]
        if len(alive) == 1:
            break
        time.sleep(0.02)
    assert len(alive) == 1, (
        "old controller generation kept looping after its stop")
    ctl.stop()
    assert not any(t.name == name for t in threading.enumerate())


def test_off_mode_records_nothing_and_scrapes_nothing():
    def scenario(P):
        clock = P.times.FakeClock(100.0)
        calls = {"n": 0}

        class _Exploding:
            registry = None

            def evaluate(self):
                calls["n"] += 1
                raise AssertionError("off mode must not consume signals")

        ctl = P.ctl.FreshnessController(
            engine=_Exploding(), clock=clock, mode="off",
            config=P.ctl.ControllerConfig(ring=8))
        return ctl.evaluate_once(), calls["n"], ctl.decisions(limit=8)

    assert both(scenario) == (None, 0, [])


# ---------------------------------------------------------------------------
# the audit trail: trace-linked actuation + the stitcher
# ---------------------------------------------------------------------------

def _captured_spans(caplog):
    return [json.loads(r.getMessage()) for r in caplog.records
            if r.name == "pio.trace"]


def _acted_with_spans(P, caplog):
    clock = P.times.FakeClock(100.0)
    eng, gauge = planted_engine(P, clock)
    ctl, _calls = make_controller(P, clock, eng)
    gauge.set(95.0)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="pio.trace"):
        d = ctl.evaluate_once()
    spans = [s for s in _captured_spans(caplog)
             if str(s.get("span", "")).startswith("controller.")]
    return d, spans


def test_actuation_spans_land_under_the_decision_trace(caplog):
    d, spans = _acted_with_spans(PORT, caplog)
    _jd, jspans = _acted_with_spans(JAX, caplog)
    assert sorted(s["span"] for s in spans) == \
        sorted(s["span"] for s in jspans)
    by_name = {s["span"]: s for s in spans}
    assert set(by_name) == {"controller.decision", "controller.retrain",
                            "controller.reload"}
    root = by_name["controller.decision"]
    assert root["traceId"] == d["traceId"] and d["traceId"].startswith(
        "ctl-")
    assert root["spanId"] == d["spanId"]
    assert root["decisionId"] == d["id"]
    for child in ("controller.retrain", "controller.reload"):
        assert by_name[child]["traceId"] == d["traceId"]
        assert by_name[child]["parentSpanId"] == root["spanId"]


def test_trace_stitch_decisions_view(tmp_path, caplog, capsys):
    d, _spans = _acted_with_spans(PORT, caplog)
    log = tmp_path / "spans.log"
    log.write_text("noise line\n" + "\n".join(
        r.getMessage() for r in caplog.records if r.name == "pio.trace")
        + "\n")
    assert trace_stitch.main([str(log), "--decisions"]) == 0
    out = capsys.readouterr().out
    assert f"decision #{d['id']}" in out
    assert "controller.retrain" in out and "controller.reload" in out
    assert d["traceId"] in out


def test_http_reload_hop_carries_the_decision_trace():
    from incubator_predictionio_tpu_torch.utils.http import (
        HttpServer,
        Request,
        Response,
        Router,
    )

    seen = {}
    r = Router()

    @r.post("/reload")
    def reload_route(request: Request) -> Response:
        seen.update(request.headers)
        seen["query"] = dict(request.query)
        return Response(200, {"reloaded": 1})

    srv = HttpServer(r, "127.0.0.1", 0, name="fakedoor")
    port = srv.start_background()
    try:
        clock = PORT.times.FakeClock(100.0)
        eng, gauge = planted_engine(PORT, clock)
        ctl, _calls = make_controller(
            PORT, clock, eng, reload_fn=PORT.ctl.http_reload_fn(
                f"127.0.0.1:{port}/reload", server_key="k y"))
        gauge.set(95.0)
        d = ctl.evaluate_once()
        assert d["outcome"]["reload"] == {
            "ok": True, "result": {"reloaded": 1},
            "wallS": d["outcome"]["reload"]["wallS"]}
        assert seen.get("x-pio-trace-id") == d["traceId"]
        assert seen.get("x-pio-parent-span") == d["spanId"]
        assert seen["query"] == {"accessKey": "k y"}
    finally:
        srv.stop()


def test_frontdoor_rolling_reload_forwards_the_trace():
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

    worker_headers = []
    servers, ports = [], []
    for _i in range(2):
        r = Router()

        @r.post("/reload")
        def reload_route(request: Request) -> Response:
            worker_headers.append(dict(request.headers))
            return Response(200, {"ok": True})

        @r.get("/")
        def status(request: Request) -> Response:
            return Response(200, {"status": "alive"})

        srv = HttpServer(r, "127.0.0.1", 0, name="miniworker")
        servers.append(srv)
        ports.append(srv.start_background())
    fd = FrontDoor([("127.0.0.1", p) for p in ports],
                   FrontDoorConfig(probe_interval_s=0.2))
    fport = fd.start_background()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{fport}/reload", data=b"",
            method="POST", headers={"X-PIO-Trace-Id": "ctl-e2e-0001"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            out = json.loads(resp.read())
        assert out["reloaded"] == 2 and out["dropped"] == 0
        assert len(worker_headers) == 2
        for h in worker_headers:
            assert h.get("x-pio-trace-id") == "ctl-e2e-0001"
            assert h.get("x-pio-parent-span")
    finally:
        fd.stop()
        for srv in servers:
            srv.stop()


# ---------------------------------------------------------------------------
# admin server hosting: GET/POST /controller
# ---------------------------------------------------------------------------

@pytest.fixture
def admin_with_controller():
    from incubator_predictionio_tpu_torch.data.storage import Storage
    from incubator_predictionio_tpu_torch.servers.admin import AdminServer

    Storage.configure({
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "m",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "e",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "d",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
    })
    clock = PORT.times.FakeClock(100.0)
    eng, gauge = planted_engine(PORT, clock)
    ctl, calls = make_controller(PORT, clock, eng, mode="observe",
                                 interval=60.0)
    ad = AdminServer(ip="127.0.0.1", port=0, controller=ctl)
    port = ad.start_background()
    try:
        yield {"port": port, "gauge": gauge, "ctl": ctl, "calls": calls}
    finally:
        ad.stop()
        PORT.ctl.reset_controller()
        Storage.reset()


def _get(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_controller_routes_on_admin(admin_with_controller):
    port = admin_with_controller["port"]
    admin_with_controller["gauge"].set(95.0)
    admin_with_controller["ctl"].evaluate_once()
    status, body = _get(port, "/controller?limit=10")
    assert status == 200
    assert body["mode"] == "observe"
    assert body["running"] is True
    assert body["actuators"] == {"retrain": True, "reload": True,
                                 "capacityGuard": False}
    assert set(body["recorder"]) == {"armed", "samples"}
    assert set(body["incident"]) == {"armed", "directory"}
    decisions = body["decisions"]
    assert decisions and decisions[0]["kind"] == "evaluation"
    assert decisions[0]["reason"] == "observe"
    assert decisions[0]["traceId"].startswith("ctl-")
    status, body = _post(port, "/controller", {"mode": "act"})
    assert status == 200 and body["mode"] == "act"
    assert _post(port, "/controller", {"mode": "sideways"})[0] == 400
    assert _post(port, "/controller", "off")[0] == 400
    assert _get(port, "/controller?limit=x")[0] == 400
    status, body = _get(port, "/controller")
    assert body["mode"] == "act"
    assert any(d.get("kind") == "mode_change" and d["to"] == "act"
               for d in body["decisions"])


def test_controller_metrics_exported(admin_with_controller):
    gauge = admin_with_controller["gauge"]
    ctl = admin_with_controller["ctl"]
    gauge.set(95.0)
    before = PORT.ctl._SKIPS.labels(reason="observe").value
    ctl.evaluate_once()
    assert PORT.ctl._SKIPS.labels(reason="observe").value == before + 1
    assert PORT.ctl._STATE.value == 1.0
    assert PORT.ctl._PROJECTION.value == pytest.approx(5.0)
    status, text = None, None
    with urllib.request.urlopen(
            f"http://127.0.0.1:{admin_with_controller['port']}/metrics",
            timeout=30) as resp:
        status, text = resp.status, resp.read().decode()
    assert status == 200
    for name in ("pio_controller_evaluations_total",
                 "pio_controller_skips_total", "pio_controller_state",
                 "pio_controller_budget_projection_seconds"):
        assert name in text


def test_decision_ring_is_bounded():
    def scenario(P):
        clock = P.times.FakeClock(100.0)
        eng, gauge = planted_engine(P, clock)
        ctl, _calls = make_controller(P, clock, eng, mode="observe")
        gauge.set(1.0)
        for _ in range(200):
            ctl.evaluate_once()
        ds = ctl.decisions(limit=1000)
        return [len(ds), ds[0]["id"], ds[-1]["id"], ctl.decisions(limit=3)]

    n, newest, oldest, three = both(scenario)
    assert n == 64 and newest == 200 and oldest == 137
    assert [d["id"] for d in three] == [200, 199, 198]


def test_export_ring_fn_binds_one_controllers_ring():
    clock = PORT.times.FakeClock(100.0)
    eng, gauge = planted_engine(PORT, clock)
    ctl, _calls = make_controller(PORT, clock, eng, mode="observe")
    gauge.set(95.0)
    ctl.evaluate_once()
    ctl.evaluate_once()
    export = PORT.ctl.export_ring_fn(ctl, limit=1)
    assert export() == ctl.decisions(limit=1)
    assert export()[0]["id"] == 2


# ---------------------------------------------------------------------------
# lock discipline
# ---------------------------------------------------------------------------

def _audited_controller(clock, engine, cooldown=30.0):
    class _AuditedController(PORT.ctl.FreshnessController):
        _AUDITED = frozenset({"_mode_override", "_cooldown_until",
                              "_streak"})

        def __setattr__(self, name, value):
            if name in self._AUDITED and getattr(self, "_audit_on", False):
                assert self._lock.locked(), (
                    f"write of {name} without the controller lock")
            object.__setattr__(self, name, value)

    return _AuditedController(
        engine=engine,
        retrain_fn=lambda: "inst-1",
        reload_fn=lambda: {"reloaded": 1},
        config=PORT.ctl.ControllerConfig(interval_s=0.05, breach_evals=1,
                                         cooldown_s=cooldown,
                                         horizon_s=10.0, ring=64),
        clock=clock, mode="act")


def _join_or_fail(fn, timeout=10.0):
    out = {}

    def run():
        out["value"] = fn()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "deadlocked: lock-discipline regression"
    return out["value"]


def test_mode_property_and_stats_are_deadlock_free():
    clock = PORT.times.FakeClock(100.0)
    eng, _gauge = planted_engine(PORT, clock)
    ctl = _audited_controller(clock, eng)
    ctl._audit_on = True
    ctl.set_mode("observe")
    assert _join_or_fail(lambda: ctl.mode) == "observe"
    assert _join_or_fail(ctl.stats)["mode"] == "observe"
    ctl.set_mode("act")
    ds = ctl.decisions(limit=1)
    assert ds[0]["kind"] == "mode_change"
    assert ds[0]["from"] == "observe" and ds[0]["to"] == "act"
    with pytest.raises(ValueError):
        ctl.set_mode("sideways")


def test_cooldown_and_streak_writes_hold_the_lock():
    clock = PORT.times.FakeClock(100.0)
    eng, gauge = planted_engine(PORT, clock, threshold=100.0)
    ctl = _audited_controller(clock, eng, cooldown=60.0)
    ctl._audit_on = True
    gauge.set(95.0)
    assert ctl.evaluate_once()["action"] == "retrain+reload"
    d2 = ctl.evaluate_once()
    assert d2["reason"] == "cooldown"
    assert d2["cooldownRemainingS"] > 0


def test_the_recorders_peek_returns_the_process_controllers_ring(
        monkeypatch):
    """``obs/recorder._peek_controller_decisions`` (the incident
    capture's default ``decisions_fn``) is the process controller's ring
    once one exists, and ``[]`` (no controller made) before."""
    from incubator_predictionio_tpu_torch.obs import recorder

    monkeypatch.delenv("PIO_CONTROLLER_RELOAD_URL", raising=False)
    PORT.ctl.reset_controller()
    try:
        assert recorder._peek_controller_decisions() == []
        assert PORT.ctl._controller is None
        ctl = PORT.ctl.get_controller()
        ctl.set_mode("observe")
        got = recorder._peek_controller_decisions()
        assert got == ctl.decisions(limit=256)
        assert got[0]["kind"] == "mode_change" and got[0]["to"] == "observe"
    finally:
        PORT.ctl.reset_controller()
