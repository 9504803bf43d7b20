"""The port's knob controller (``obs/knobs.py``) against the JAX package's,
on the CPU.

Every scenario of tests/test_knobs.py runs through both packages on the
same planted recorder windows: each package's own ``Registry`` and
``FlightRecorder`` on its ``FakeClock``, the same observations, gauges
and samples, the same breaches, a spied local actuator. The decision
records must be equal in both (steps, gates, streaks, bounds, the
capacity veto, rollbacks; the recorder-window inputs within 1e-9
relative); the trace ids, timestamps, span ids and walls minted per run
are left out. The knob env each run writes is restored before the other
package runs. ``KNOB_ENV_VARS`` and the default registry equal the JAX
package's. The fleet seam runs on the port's own prediction servers
(in process, on the CPU, over a seeded 300 × 200 ALS model) behind the
port's front door, and the admin routes on the port's admin server.
"""

import importlib
import json
import logging
import os
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_torch_controller import assert_same, norm

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import trace_stitch  # noqa: E402


class Pkg:
    def __init__(self, root: str):
        self.root = root
        self.knobs = importlib.import_module(f"{root}.obs.knobs")
        self.metrics = importlib.import_module(f"{root}.obs.metrics")
        self.recorder = importlib.import_module(f"{root}.obs.recorder")
        self.controller = importlib.import_module(f"{root}.obs.controller")
        self.times = importlib.import_module(f"{root}.utils.times")


JAX = Pkg("incubator_predictionio_tpu")
PORT = Pkg("incubator_predictionio_tpu_torch")
WATCHED = tuple(sorted(PORT.knobs.KNOB_ENV_VARS)) + ("PIO_KNOBS",
                                                     "PIO_KNOBS_URL")


@pytest.fixture(autouse=True)
def _clean_knob_env():
    """The local actuator writes the real process env: restore every
    registered knob env afterwards."""
    saved = {e: os.environ.get(e) for e in WATCHED}
    yield
    _restore(saved)


def _restore(saved):
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def both(scenario):
    """``scenario(P)`` through both packages from the same knob env; the
    records must be equal. Returns the port's result."""
    saved = {e: os.environ.get(e) for e in WATCHED}
    got = scenario(PORT)
    _restore(saved)
    ref = scenario(JAX)
    _restore(saved)
    assert_same(norm(got), norm(ref))
    return got


def planted_recorder(P, clock):
    reg = P.metrics.Registry()
    met = {
        "lat": reg.histogram("pio_query_latency_seconds", "x",
                             buckets=(0.05, 0.1, 0.25, 0.5, 1.0)),
        "queue": reg.histogram("pio_serve_queue_wait_seconds", "x",
                               buckets=(0.01, 0.05, 0.1, 0.25)),
        "shed": reg.counter("pio_serve_shed_total", "x"),
        "recall": reg.gauge("pio_serve_mips_recall", "x"),
        "fold": reg.histogram("pio_freshness_fold_seconds", "x",
                              buckets=(0.5, 1.0, 2.0, 5.0)),
        "tail": reg.gauge("pio_mips_tail_size", "x", labels=("engine",)),
        "age": reg.gauge("pio_mips_index_age_seconds", "x"),
    }
    rec = P.recorder.FlightRecorder(registry=reg, hz=1.0, window_s=60.0,
                                    clock=clock, wall=clock)
    return rec, met


def plant(rec, clock, met, lat=0.2, recall=0.97, samples=3, queue=None,
          fold=None, shed=0):
    """A steady window: per-interval observations, one recorder sample
    per simulated second (``lat=0.2`` is the neutral point of the
    planted bucket grid, as in tests/test_knobs.py)."""
    if recall is not None:
        met["recall"].set(recall)
    for _ in range(samples):
        met["lat"].observe(lat, 50)
        if queue is not None:
            met["queue"].observe(queue, 50)
        if fold is not None:
            met["fold"].observe(fold, 5)
        if shed:
            met["shed"].inc(shed)
        rec.sample_now()
        clock.advance(1.0)


def make_knobs(P, clock, rec, hysteresis=2, cooldown=0.0, mode="act",
               ring=64, **kw):
    applies = []
    local = P.knobs.local_knobs_fn()

    def spy_apply(vector):
        applies.append(dict(vector))
        return local(vector)

    ctl = P.knobs.KnobController(
        specs=kw.pop("specs", None),
        apply_fn=kw.pop("apply_fn", spy_apply),
        capacity_fn=kw.pop("capacity_fn", None),
        recorder_fn=lambda: rec,
        config=P.knobs.KnobConfig(interval_s=0.05,
                                  hysteresis_evals=hysteresis,
                                  cooldown_s=cooldown, window_s=30.0,
                                  ring=ring),
        clock=clock, mode=mode, **kw)
    return ctl, applies


def _start(P):
    clock = P.times.FakeClock(100.0)
    rec, met = planted_recorder(P, clock)
    return clock, rec, met


# ---------------------------------------------------------------------------
# the registry itself
# ---------------------------------------------------------------------------

def test_knob_env_set_and_registry_equal_the_jax_package():
    from incubator_predictionio_tpu.analysis import rules

    assert PORT.knobs.KNOB_ENV_VARS == JAX.knobs.KNOB_ENV_VARS
    assert set(rules._KNOB_ENV_VARS) == set(PORT.knobs.KNOB_ENV_VARS)
    specs, jspecs = PORT.knobs.default_knobs(), JAX.knobs.default_knobs()
    assert [(s.name, s.env, s.default, s.lo, s.hi, s.scale)
            for s in specs] == [(s.name, s.env, s.default, s.lo, s.hi,
                                 s.scale) for s in jspecs]
    assert {s.env for s in specs} == set(PORT.knobs.KNOB_ENV_VARS)
    assert PORT.knobs.INPUT_SERIES == JAX.knobs.INPUT_SERIES
    assert PORT.knobs.SKIP_REASONS == JAX.knobs.SKIP_REASONS
    assert PORT.knobs.ACTION_REASONS == JAX.knobs.ACTION_REASONS
    assert set(PORT.knobs.__all__) == set(JAX.knobs.__all__)


def test_config_from_env_equals_the_jax_package(monkeypatch):
    for k, v in {"PIO_KNOBS_INTERVAL_S": "0.5", "PIO_KNOBS_HYSTERESIS": "3",
                 "PIO_KNOBS_COOLDOWN_S": "7", "PIO_KNOBS_WINDOW_S": "4",
                 "PIO_KNOBS_RECALL_TARGET": "0.9"}.items():
        monkeypatch.setenv(k, v)
    assert vars(PORT.knobs.KnobConfig.from_env()) == \
        vars(JAX.knobs.KnobConfig.from_env())
    assert PORT.knobs.KnobConfig.from_env().hysteresis_evals == 3


@pytest.mark.parametrize("value,direction", [
    (64, 1), (64, -1), (4096, 1), (4, -1), (0, 1), (1, -1), (1, 0)])
def test_spec_steps_equal_the_jax_package(value, direction):
    for spec, jspec in zip(PORT.knobs.default_knobs(),
                           JAX.knobs.default_knobs()):
        assert spec.step(value, direction) == jspec.step(value, direction)
    nprobe = PORT.knobs.default_knobs()[0]
    assert nprobe.step(nprobe.hi, 1) == nprobe.hi
    shed = [s for s in PORT.knobs.default_knobs() if s.scale == "binary"][0]
    assert (shed.step(0, 1), shed.step(1, -1)) == (1, 0)


@pytest.mark.parametrize("raw", [None, "", "junk", "-3", "0", "99999",
                                 "128"])
def test_read_env_equals_the_jax_package(monkeypatch, raw):
    for spec, jspec in zip(PORT.knobs.default_knobs(),
                           JAX.knobs.default_knobs()):
        if raw is None:
            monkeypatch.delenv(spec.env, raising=False)
        else:
            monkeypatch.setenv(spec.env, raw)
        assert spec.read_env() == jspec.read_env()


# ---------------------------------------------------------------------------
# the decide rules, one window each
# ---------------------------------------------------------------------------

#: (planted window, knobs to register) → the step the controller takes
WINDOWS = {
    "tail_high": (dict(recall=0.97, tail=9000.0), None),
    "index_stale": (dict(recall=0.97, age=3000.0, tail=10.0), None),
    "pq_m_recall": (dict(recall=0.80), ("mips_pq_m",)),
    "latency_scheduler": (dict(lat=0.6, recall=None),
                          ("max_batch", "max_wait_ms")),
    "queue_high": (dict(lat=0.2, queue=0.2, recall=None), ("max_batch",)),
    "wait_headroom": (dict(lat=0.02, recall=None), ("max_wait_ms",)),
    "shed_arm": (dict(lat=0.6, recall=None, env={"PIO_SERVE_SHED": "0"}),
                 ("shed",)),
    "shed_disarm": (dict(lat=0.02, recall=None, shed=3), ("shed",)),
    "fold_lag": (dict(lat=0.2, recall=None, fold=4.0), ("foldin_budget",)),
    "fold_costly": (dict(lat=0.6, recall=None, fold=0.4),
                    ("foldin_budget",)),
    "latency_recall_slack": (dict(lat=0.6, recall=0.99), None),
}


@pytest.mark.parametrize("case", sorted(WINDOWS))
def test_one_window_steps_as_the_jax_package(case, monkeypatch):
    planted, names = WINDOWS[case]
    planted = dict(planted)
    for k, v in planted.pop("env", {}).items():
        monkeypatch.setenv(k, v)

    def scenario(P):
        clock, rec, met = _start(P)
        specs = None if names is None else tuple(
            s for s in P.knobs.default_knobs() if s.name in names)
        ctl, applies = make_knobs(P, clock, rec, hysteresis=1, specs=specs)
        if "tail" in planted:
            met["tail"].labels(engine="recommendation").set(planted["tail"])
        if "age" in planted:
            met["age"].set(planted["age"])
        plant(rec, clock, met, **{k: v for k, v in planted.items()
                                   if k not in ("tail", "age")})
        return ctl.evaluate_once(), applies, ctl.values(), {
            e: os.environ.get(e) for e in sorted(P.knobs.KNOB_ENV_VARS)}

    d, applies, values, env = both(scenario)
    assert d["action"] in ("step_up", "step_down")
    assert d["outcome"]["actuated"] is True
    assert applies == [values]
    spec = next(s for s in PORT.knobs.default_knobs() if s.name == d["knob"])
    assert env[spec.env] == str(d["to"])
    expected = {
        "tail_high": ("mips_rebuild_tail", "step_down", "tail_high",
                      4096, 2048),
        "index_stale": ("mips_rebuild_age_s", "step_down", "index_stale",
                        900, 450),
        "pq_m_recall": ("mips_pq_m", "step_up", "recall_low", 16, 32),
        "latency_scheduler": ("max_batch", "step_down", "latency_high",
                              512, 256),
        "queue_high": ("max_batch", "step_up", "queue_high", 512, 1024),
        "wait_headroom": ("max_wait_ms", "step_up", "latency_headroom",
                          250, 500),
        "shed_arm": ("shed", "step_up", "latency_high", 0, 1),
        "shed_disarm": ("shed", "step_down", "shed_active", 1, 0),
        "fold_lag": ("foldin_budget", "step_up", "fold_lag", 64, 128),
        "fold_costly": ("foldin_budget", "step_down", "latency_high",
                        64, 32),
        "latency_recall_slack": ("mips_nprobe", "step_down",
                                 "latency_high", 64, 32),
    }[case]
    assert (d["knob"], d["action"], d["reason"], d["from"], d["to"]) == \
        expected


def test_tail_step_reaches_the_daemons_reader():
    clock, rec, met = _start(PORT)
    ctl, _applies = make_knobs(PORT, clock, rec, hysteresis=1)
    met["tail"].labels(engine="recommendation").set(9000.0)
    plant(rec, clock, met, recall=0.97)
    ctl.evaluate_once()
    from incubator_predictionio_tpu_torch.ops import mips_daemon

    assert mips_daemon.tail_trigger_rows() == 2048


def test_pq_m_never_shrinks_for_latency():
    def scenario(P):
        clock, rec, met = _start(P)
        pq_m = [s for s in P.knobs.default_knobs() if s.name == "mips_pq_m"]
        ctl, _ = make_knobs(P, clock, rec, hysteresis=1, specs=pq_m)
        plant(rec, clock, met, recall=0.80)
        first = ctl.evaluate_once()
        plant(rec, clock, met, lat=0.6, recall=0.97)
        return first, ctl.evaluate_once()

    first, second = both(scenario)
    assert (first["from"], first["to"]) == (16, 32)
    assert second["action"] == "none"


# ---------------------------------------------------------------------------
# convergence / hysteresis / cooldown / bounds / capacity
# ---------------------------------------------------------------------------

def test_healthy_window_never_steps():
    def scenario(P):
        clock, rec, met = _start(P)
        ctl, applies = make_knobs(P, clock, rec)
        plant(rec, clock, met, recall=0.97)
        return [ctl.evaluate_once() for _ in range(5)], applies, \
            ctl.stats()["adjustments"]

    ds, applies, adjustments = both(scenario)
    assert {(d["action"], d["reason"]) for d in ds} == {("none",
                                                         "healthy")}
    assert applies == [] and adjustments == 0


def test_no_data_is_a_skip_not_a_step():
    def scenario(P):
        clock, rec, _met = _start(P)   # zero samples
        ctl, applies = make_knobs(P, clock, rec)
        return ctl.evaluate_once(), applies

    d, applies = both(scenario)
    assert d["reason"] == "no_data" and applies == []


def test_recall_low_climbs_nprobe_behind_hysteresis():
    def scenario(P):
        clock, rec, met = _start(P)
        ctl, applies = make_knobs(P, clock, rec)
        plant(rec, clock, met, recall=0.80)
        d1, d2 = ctl.evaluate_once(), ctl.evaluate_once()
        values = ctl.values()
        plant(rec, clock, met, recall=0.97)
        return d1, d2, applies, values, ctl.evaluate_once(), \
            P.knobs._VALUE.labels(knob="mips_nprobe").value

    d1, d2, applies, values, d3, gauge = both(scenario)
    assert (d1["action"], d1["reason"]) == ("none", "hysteresis")
    assert d1["knobs"]["mips_nprobe"] == {
        "value": 64, "desire": 1, "why": "recall_low", "streak": 1,
        "gate": "hysteresis"}
    assert (d2["knob"], d2["action"], d2["reason"]) == (
        "mips_nprobe", "step_up", "recall_low")
    assert (d2["from"], d2["to"]) == (64, 128)
    assert applies == [values] and values["PIO_SERVE_MIPS_NPROBE"] == 128
    assert gauge == 128.0
    assert d3["reason"] == "healthy"


def test_cooldown_holds_a_stepped_knob_still():
    def scenario(P):
        clock, rec, met = _start(P)
        ctl, applies = make_knobs(P, clock, rec, cooldown=120.0,
                                  specs=P.knobs.default_knobs()[:1])
        plant(rec, clock, met, recall=0.80)
        out = [ctl.evaluate_once() for _ in range(4)]
        clock.advance(121.0)
        out.append(ctl.evaluate_once())
        return out, len(applies)

    ds, n = both(scenario)
    assert [d["action"] for d in ds] == ["none", "step_up", "none", "none",
                                         "step_up"]
    assert ds[3]["reason"] == "cooldown"
    assert ds[3]["knobs"]["mips_nprobe"]["gate"] == "cooldown"
    assert (ds[4]["from"], ds[4]["to"]) == (128, 256)
    assert n == 2


def test_bound_gate_never_saturates_silently(monkeypatch):
    monkeypatch.setenv("PIO_SERVE_MIPS_NPROBE", "4096")

    def scenario(P):
        clock, rec, met = _start(P)
        ctl, applies = make_knobs(P, clock, rec, hysteresis=1,
                                  specs=P.knobs.default_knobs()[:1])
        plant(rec, clock, met, recall=0.80)
        return ctl.evaluate_once(), applies

    d, applies = both(scenario)
    assert (d["action"], d["reason"]) == ("none", "bound")
    assert d["knobs"]["mips_nprobe"]["gate"] == "bound"
    assert applies == []


def test_capacity_guard_vetoes_per_knob():
    def scenario(P):
        clock, rec, met = _start(P)
        ctl, _ = make_knobs(P, clock, rec, hysteresis=1,
                            capacity_fn=lambda: {"mips_nprobe": 100})
        plant(rec, clock, met, recall=0.80)
        d = ctl.evaluate_once()
        ctl2, applies2 = make_knobs(
            P, clock, rec, hysteresis=1, specs=P.knobs.default_knobs()[:1],
            capacity_fn=lambda: {"mips_nprobe": 100})
        return d, ctl.stats()["actuators"], ctl2.evaluate_once(), applies2

    d, actuators, d2, applies2 = both(scenario)
    assert d["knobs"]["mips_nprobe"]["gate"] == "capacity"
    assert d["knobs"]["mips_nprobe"]["capacityMax"] == 100
    assert (d["knob"], d["action"]) == ("mips_candidates", "step_up")
    assert actuators["capacityGuard"] is True
    assert d2["reason"] == "capacity" and applies2 == []


def test_one_knob_steps_per_evaluation():
    def scenario(P):
        clock, rec, met = _start(P)
        ctl, applies = make_knobs(P, clock, rec, hysteresis=1)
        plant(rec, clock, met, recall=0.80)
        return ctl.evaluate_once(), len(applies)

    d, n = both(scenario)
    assert d["knob"] == "mips_nprobe"
    assert d["knobs"]["mips_nprobe"]["gate"] == "selected"
    assert d["knobs"]["mips_candidates"]["gate"] == "queued"
    assert n == 1


def test_observe_mode_is_a_dry_run_and_act_resumes():
    def scenario(P):
        clock, rec, met = _start(P)
        ctl, applies = make_knobs(P, clock, rec, mode="observe")
        plant(rec, clock, met, recall=0.80)
        out = [ctl.evaluate_once(), ctl.evaluate_once()]
        untouched = os.environ.get("PIO_SERVE_MIPS_NPROBE")
        ctl.set_mode("act")
        out.append(ctl.evaluate_once())
        return out, len(applies), untouched, \
            [r.get("kind") for r in ctl.decisions(limit=8)]

    ds, n, untouched, kinds = both(scenario)
    assert ds[1]["action"] == "step_up"
    assert ds[1]["outcome"] == {"actuated": False, "dryRun": True}
    assert untouched is None
    assert ds[2]["outcome"]["actuated"] is True and n == 1
    assert "mode_change" in kinds


def test_apply_failure_keeps_the_old_vector_authoritative():
    def scenario(P):
        clock, rec, met = _start(P)

        def bad_apply(vector):
            raise RuntimeError("fan-out died")

        ctl, _ = make_knobs(P, clock, rec, hysteresis=1, apply_fn=bad_apply)
        plant(rec, clock, met, recall=0.80)
        return ctl.evaluate_once(), ctl.values(), ctl.stats()[
            "rollbackArmed"]

    d, values, armed = both(scenario)
    assert d["outcome"]["actuated"] is False
    assert {k: v for k, v in d["outcome"]["apply"].items()
            if k != "wallS"} == {"ok": False, "error": "fan-out died"}
    assert values["PIO_SERVE_MIPS_NPROBE"] == 64 and armed is False


def test_fleet_200_with_failures_is_an_apply_failure():
    def scenario(P):
        clock, rec, met = _start(P)
        responses = [
            {"workers": 2, "applied": 1, "failed": ["w1"], "results": {}},
            {"workers": 2, "applied": 1, "failed": [], "results": {}},
            {"workers": 2, "applied": 2, "failed": [], "results": {}},
        ]
        applies = []

        def fleet_apply(vector):
            applies.append(dict(vector))
            return responses[len(applies) - 1]

        ctl, _ = make_knobs(P, clock, rec, hysteresis=1, cooldown=120.0,
                            apply_fn=fleet_apply)
        plant(rec, clock, met, recall=0.80)
        out = []
        for _ in range(3):
            out.append((ctl.evaluate_once(), ctl.values(), ctl.stats()[
                "adjustments"], ctl.stats()["rollbackArmed"]))
        return out

    (d1, v1, n1, a1), (d2, _v2, _n2, _a2), (d3, v3, n3, a3) = \
        both(scenario)
    assert d1["outcome"]["actuated"] is False
    assert d1["outcome"]["apply"]["failed"] == ["w1"]
    assert v1["PIO_SERVE_MIPS_NPROBE"] == 64 and n1 == 0 and a1 is False
    assert (d2["knob"], d2["to"]) == ("mips_nprobe", 128)
    assert d2["outcome"]["actuated"] is False
    assert d3["outcome"]["actuated"] is True
    assert v3["PIO_SERVE_MIPS_NPROBE"] == 128 and n3 == 1 and a3 is True


# ---------------------------------------------------------------------------
# incident rollback
# ---------------------------------------------------------------------------

def _climb_once(ctl, rec, clock, met):
    plant(rec, clock, met, recall=0.80)
    d = ctl.evaluate_once()
    assert d["outcome"]["actuated"] is True
    return d


def test_breach_inside_cooldown_rolls_back_and_rearms():
    def scenario(P):
        clock, rec, met = _start(P)
        ctl, applies = make_knobs(P, clock, rec, hysteresis=1,
                                  cooldown=120.0)
        step1 = _climb_once(ctl, rec, clock, met)
        armed = ctl.stats()["rollbackArmed"]
        before = P.knobs._ROLLBACKS.value
        ctl.on_breach({"name": "serve_p99", "objective": {}})
        pending = ctl.stats()["rollbackPending"]
        d = ctl.evaluate_once()
        after = (P.knobs._ROLLBACKS.value - before, ctl.stats()["rollbacks"],
                 ctl.stats()["rollbackPending"],
                 ctl.stats()["rollbackArmed"],
                 os.environ["PIO_SERVE_MIPS_NPROBE"])
        cooled = ctl.evaluate_once()
        clock.advance(121.0)
        step2 = _climb_once(ctl, rec, clock, met)
        ctl.on_breach({"name": "serve_p99"})
        d2 = ctl.evaluate_once()
        return (step1, armed, pending, d, after, cooled, step2, d2,
                ctl.stats()["rollbacks"], applies[-1])

    (step1, armed, pending, d, after, cooled, step2, d2, n,
     last) = both(scenario)
    assert armed is True and pending is True
    assert (d["action"], d["reason"]) == ("rollback", "incident")
    assert d["incident"] == {"slo": "serve_p99", "steppedBy": step1["id"]}
    assert d["toVector"]["PIO_SERVE_MIPS_NPROBE"] == 64
    assert after == (1, 1, False, False, "64")
    assert cooled["reason"] == "cooldown"
    assert (step2["from"], step2["to"]) == (64, 128)
    assert d2["action"] == "rollback" and n == 2
    assert last["PIO_SERVE_MIPS_NPROBE"] == 64


def test_breach_outside_cooldown_is_ignored():
    def scenario(P):
        clock, rec, met = _start(P)
        ctl, _ = make_knobs(P, clock, rec, hysteresis=1, cooldown=30.0)
        _climb_once(ctl, rec, clock, met)
        clock.advance(31.0)
        ctl.on_breach({"name": "serve_p99"})
        ctl2, _ = make_knobs(P, clock, rec, hysteresis=1)
        ctl2.on_breach({"name": "serve_p99"})
        return ctl.stats()["rollbackPending"], ctl2.stats()[
            "rollbackPending"]

    assert both(scenario) == (False, False)


def test_failed_rollback_stays_pending_and_counts_once():
    def scenario(P):
        clock, rec, met = _start(P)
        local = P.knobs.local_knobs_fn()
        failing = {"on": False}

        def flaky_apply(vector):
            if failing["on"]:
                raise RuntimeError("fan-out died")
            return local(vector)

        ctl, _ = make_knobs(P, clock, rec, hysteresis=1, cooldown=120.0,
                            apply_fn=flaky_apply)
        _climb_once(ctl, rec, clock, met)
        before = P.knobs._ROLLBACKS.value
        ctl.on_breach({"name": "serve_p99"})
        failing["on"] = True
        d1 = ctl.evaluate_once()
        s1 = (ctl.stats()["rollbackPending"], ctl.stats()["rollbacks"],
              P.knobs._ROLLBACKS.value - before)
        failing["on"] = False
        d2 = ctl.evaluate_once()
        s2 = (ctl.stats()["rollbackPending"], ctl.stats()["rollbacks"],
              P.knobs._ROLLBACKS.value - before,
              os.environ["PIO_SERVE_MIPS_NPROBE"])
        return d1, s1, d2, s2

    d1, s1, d2, s2 = both(scenario)
    assert d1["action"] == "rollback" and d1["outcome"]["actuated"] is False
    assert s1 == (True, 0, 0)
    assert d2["action"] == "rollback" and d2["outcome"]["actuated"] is True
    assert s2 == (False, 1, 1, "64")


def test_rollback_in_observe_mode_is_a_dry_run():
    def scenario(P):
        clock, rec, met = _start(P)
        ctl, applies = make_knobs(P, clock, rec, hysteresis=1,
                                  cooldown=120.0)
        _climb_once(ctl, rec, clock, met)
        ctl.on_breach({"name": "serve_p99"})
        ctl.set_mode("observe")
        return ctl.evaluate_once(), len(applies), ctl.stats()[
            "rollbackPending"]

    d, n, pending = both(scenario)
    assert d["action"] == "rollback"
    assert d["outcome"] == {"actuated": False, "dryRun": True}
    assert n == 1 and pending is False


def test_breach_through_the_slo_engine_rolls_back():
    """The breach arrives through the burn engine's listener seam
    (``install``), as the admin server wires it: an objective the
    planted window breaks, evaluated inside the step's cooldown."""
    def scenario(P):
        slo = importlib.import_module(f"{P.root}.obs.slo")
        clock, rec, met = _start(P)
        ctl, _ = make_knobs(P, clock, rec, hysteresis=1, cooldown=120.0)
        spec = slo.SLOSpec(name="serve_p99",
                           metric="pio_query_latency_seconds",
                           threshold=0.05, target=0.99)
        eng = slo.SLOEngine(specs=(spec,), registry=rec.registry,
                            clock=clock, min_tick_interval_s=0.0,
                            export_gauges=False)
        ctl.install(eng)
        eng.evaluate()                 # the baseline snapshot
        _climb_once(ctl, rec, clock, met)
        breached = [e["breached"] for e in eng.evaluate()]
        return breached, ctl.stats()["rollbackPending"], ctl.evaluate_once()

    breached, pending, d = both(scenario)
    assert breached == [True] and pending is True
    assert (d["action"], d["reason"]) == ("rollback", "incident")
    assert d["incident"]["slo"] == "serve_p99"


def test_incident_bundle_carries_the_knob_ring(tmp_path):
    clock, rec, met = _start(PORT)
    ctl, _ = make_knobs(PORT, clock, rec, hysteresis=1)
    _climb_once(ctl, rec, clock, met)
    cap = PORT.recorder.IncidentCapture(
        directory=str(tmp_path), recorder=rec, window_s=60.0, clock=clock,
        wall=clock, knobs_fn=PORT.controller.export_ring_fn(ctl))
    path = cap.capture_now("serve_p99")["path"]
    bundle = json.loads((tmp_path / os.path.basename(path)).read_text())
    assert bundle["knobsTotal"] >= 1
    assert "step_up" in [d["action"] for d in bundle["knobs"]]


def test_peek_never_creates_a_controller():
    PORT.knobs.reset_knob_controller()
    assert PORT.knobs.peek_knob_decisions() == []
    assert PORT.knobs._knob_controller is None


# ---------------------------------------------------------------------------
# the audit trail: spans + the stitcher
# ---------------------------------------------------------------------------

def _stepped_with_spans(P, caplog):
    clock, rec, met = _start(P)
    ctl, _ = make_knobs(P, clock, rec, hysteresis=1)
    plant(rec, clock, met, recall=0.80)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="pio.trace"):
        d = ctl.evaluate_once()
    spans = [json.loads(r.getMessage()) for r in caplog.records
             if r.name == "pio.trace"]
    return d, [s for s in spans if str(s.get("span", "")).startswith(
        "knob.")]


def test_apply_spans_land_under_the_decision_trace(caplog):
    d, spans = _stepped_with_spans(PORT, caplog)
    _jd, jspans = _stepped_with_spans(JAX, caplog)
    assert sorted(s["span"] for s in spans) == \
        sorted(s["span"] for s in jspans)
    assert d["outcome"]["actuated"] is True
    assert d["traceId"].startswith("knb-")
    by_name = {s["span"]: s for s in spans}
    assert set(by_name) == {"knob.decision", "knob.apply"}
    root = by_name["knob.decision"]
    assert (root["traceId"], root["spanId"], root["decisionId"],
            root["knob"]) == (d["traceId"], d["spanId"], d["id"],
                              "mips_nprobe")
    assert by_name["knob.apply"]["traceId"] == d["traceId"]
    assert by_name["knob.apply"]["parentSpanId"] == root["spanId"]


def test_trace_stitch_learns_knob_decision_roots(tmp_path, caplog, capsys):
    d, _spans = _stepped_with_spans(PORT, caplog)
    log = tmp_path / "spans.log"
    log.write_text("\n".join(
        r.getMessage() for r in caplog.records if r.name == "pio.trace")
        + "\n")
    assert trace_stitch.main([str(log), "--decisions"]) == 0
    out = capsys.readouterr().out
    assert f"decision #{d['id']}" in out
    assert "knob=mips_nprobe" in out and "knob.apply" in out
    assert d["traceId"] in out


# ---------------------------------------------------------------------------
# the ring + metrics
# ---------------------------------------------------------------------------

def test_decision_ring_is_bounded_and_newest_first():
    def scenario(P):
        clock, rec, met = _start(P)
        ctl, _ = make_knobs(P, clock, rec, ring=16)
        plant(rec, clock, met)
        for _ in range(40):
            ctl.evaluate_once()
        return [d["id"] for d in ctl.decisions(limit=1000)]

    ids = both(scenario)
    assert ids == list(range(40, 24, -1))


def test_knob_metrics_exported():
    clock, rec, met = _start(PORT)
    ctl, _ = make_knobs(PORT, clock, rec, hysteresis=1)
    before = PORT.knobs._EVALUATIONS.value
    adj = PORT.knobs._ADJUSTMENTS.labels(knob="mips_nprobe").value
    plant(rec, clock, met, recall=0.80)
    ctl.evaluate_once()
    assert PORT.knobs._EVALUATIONS.value == before + 1
    assert PORT.knobs._ADJUSTMENTS.labels(knob="mips_nprobe").value == \
        adj + 1
    text = PORT.metrics.REGISTRY.expose()
    for name in ("pio_knob_evaluations_total", "pio_knob_adjustments_total",
                 "pio_knob_rollbacks_total", "pio_knob_value"):
        assert name in text


# ---------------------------------------------------------------------------
# the fleet seam: the port's workers' POST /knobs, fanned by the door
# ---------------------------------------------------------------------------

def _serve_worker(seed):
    from incubator_predictionio_tpu_torch.core.params import EngineParams
    from incubator_predictionio_tpu_torch.models.recommendation import (
        engine,
    )
    from incubator_predictionio_tpu_torch.models.recommendation.convert import (  # noqa: E501
        als_model_from_numpy,
    )
    from incubator_predictionio_tpu_torch.servers.prediction_server import (
        PredictionServer,
        ServerConfig,
    )

    rng = np.random.default_rng(seed)
    users = rng.normal(0, 0.3, (300, 8)).astype(np.float32)
    items = rng.normal(0, 0.3, (200, 8)).astype(np.float32)
    model = als_model_from_numpy(users, items,
                                 [f"u{i}" for i in range(300)],
                                 [f"i{i}" for i in range(200)],
                                 device="cpu")
    return PredictionServer(
        engine.RecommendationEngine().apply(),
        EngineParams(algorithm_params_list=[
            ("als", engine.ALSAlgorithmParams(rank=8))]),
        [model], device="cpu",
        config=ServerConfig(ip="127.0.0.1", port=0, micro_batch=16))


@pytest.fixture
def served_workers():
    servers = [_serve_worker(s) for s in (0, 1)]
    ports = [s.start_background() for s in servers]
    yield servers, ports
    for s in servers:
        s.stop()


def _post_json(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get_json(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_worker_knobs_route_applies_without_restart(served_workers):
    _servers, ports = served_workers
    port = ports[0]
    status, info = _get_json(port, "/")
    assert info["scheduler"]["knobs"]["supported"] is True
    status, body = _post_json(port, "/knobs", {"values": {
        "PIO_SERVE_MAX_BATCH": 64, "PIO_SERVE_MAX_WAIT_MS": 50}})
    assert status == 200
    assert body["applied"] == {"PIO_SERVE_MAX_BATCH": 64,
                               "PIO_SERVE_MAX_WAIT_MS": 50}
    assert body["scheduler"]["cap"] == 64
    assert body["scheduler"]["waitBoundS"] == pytest.approx(0.05)
    assert os.environ["PIO_SERVE_MAX_BATCH"] == "64"
    assert _get_json(port, "/")[1]["scheduler"]["cap"] == 64
    status, body = _post_json(port, "/knobs", {"values": {
        "PIO_SERVE_MAX_BATCH": 32, "PIO_EVIL": 1}})
    assert status == 400 and body["unknown"] == ["PIO_EVIL"]
    assert os.environ["PIO_SERVE_MAX_BATCH"] == "64"
    assert _get_json(port, "/")[1]["scheduler"]["cap"] == 64
    assert _post_json(port, "/knobs",
                      {"values": {"PIO_SERVE_MAX_BATCH": "lots"}})[0] == 400
    # queries still answer at the new cap
    status, body = _post_json(port, "/queries.json",
                              {"user": "u3", "num": 5})
    assert status == 200 and len(body["itemScores"]) == 5


def test_worker_knobs_route_takes_the_server_key():
    from incubator_predictionio_tpu_torch.servers.prediction_server import (
        ServerConfig,
    )

    srv = _serve_worker(3)
    srv.config = ServerConfig(ip="127.0.0.1", port=0, micro_batch=16,
                              server_key="sekrit")
    port = srv.start_background()
    try:
        vector = {"values": {"PIO_SERVE_MAX_WAIT_MS": 40}}
        assert _post_json(port, "/knobs", vector)[0] == 401
        status, body = _post_json(port, "/knobs?accessKey=sekrit", vector)
        assert status == 200 and body["applied"] == {
            "PIO_SERVE_MAX_WAIT_MS": 40}
    finally:
        srv.stop()


def test_mips_lifecycle_knobs_roundtrip_the_worker_seam(served_workers):
    from incubator_predictionio_tpu_torch.ops import mips as mips_mod
    from incubator_predictionio_tpu_torch.ops import mips_daemon

    _servers, ports = served_workers
    vector = {"PIO_SERVE_MIPS_PQ_M": 8,
              "PIO_SERVE_MIPS_PQ_CANDIDATES": 4096,
              "PIO_MIPS_REBUILD_TAIL": 1024,
              "PIO_MIPS_REBUILD_AGE_S": 300}
    status, body = _post_json(ports[0], "/knobs", {"values": vector})
    assert status == 200 and body["applied"] == vector
    for env, want in vector.items():
        assert os.environ[env] == str(want)
    assert mips_daemon.tail_trigger_rows() == 1024
    assert mips_daemon.age_trigger_s() == 300.0
    assert mips_mod._pq_m(32) == 8


def test_frontdoor_fans_the_vector_to_both_workers(served_workers, caplog):
    from incubator_predictionio_tpu_torch.serving.frontdoor import (
        FrontDoor,
        FrontDoorConfig,
    )

    _servers, ports = served_workers
    fd = FrontDoor([("127.0.0.1", p) for p in ports],
                   FrontDoorConfig(probe_interval_s=0.2))
    fport = fd.start_background()
    try:
        clock, rec, met = _start(PORT)
        ctl, _ = make_knobs(
            PORT, clock, rec, hysteresis=1,
            apply_fn=PORT.knobs.http_knobs_fn(
                f"http://127.0.0.1:{fport}/knobs"))
        plant(rec, clock, met, recall=0.80)
        with caplog.at_level(logging.INFO, logger="pio.trace"):
            d = ctl.evaluate_once()
        assert d["outcome"]["actuated"] is True
        result = d["outcome"]["apply"]["result"]
        assert (result["workers"], result["applied"], result["failed"]) \
            == (2, 2, [])
        for res in result["results"].values():
            assert res["applied"]["PIO_SERVE_MIPS_NPROBE"] == 128
            assert res["scheduler"]["cap"] == 512
        hops = [json.loads(r.getMessage()) for r in caplog.records
                if r.name == "pio.trace"]
        hops = [s for s in hops if s.get("traceId") == d["traceId"]
                and s.get("route") == "/knobs"]
        assert "frontdoor" in {s.get("server") for s in hops}
        assert len(hops) >= 3
        # an unknown variable: each worker refuses it, none applies it
        status, out = _post_json(fport, "/knobs", {"values": {
            "PIO_SERVE_MAX_BATCH": 32, "PIO_NO_SUCH": 1}})
        assert status == 200 and out["applied"] == 0
        assert sorted(out["failed"]) == ["w0", "w1"]
        for p in ports:
            assert _get_json(p, "/")[1]["scheduler"]["cap"] == 512
    finally:
        fd.stop()


def test_local_fallback_in_act_mode_warns_and_names_its_scope(caplog):
    os.environ.pop("PIO_KNOBS_URL", None)
    PORT.knobs.reset_knob_controller()
    os.environ["PIO_KNOBS"] = "act"
    try:
        with caplog.at_level(logging.WARNING,
                             logger="incubator_predictionio_tpu_torch"
                                    ".obs.knobs"):
            ctl = PORT.knobs.get_knob_controller()
        assert ctl.stats()["actuators"]["scope"] == "local"
        assert ctl.stats()["actuators"]["capacityGuard"] is False
        assert any("PIO_KNOBS_URL" in r.getMessage()
                   for r in caplog.records)
        PORT.knobs.reset_knob_controller()
        caplog.clear()
        os.environ["PIO_KNOBS_URL"] = "http://127.0.0.1:1/knobs"
        ctl = PORT.knobs.get_knob_controller()
        assert ctl.stats()["actuators"]["scope"] == "fleet"
        assert not any("PIO_KNOBS_URL" in r.getMessage()
                       for r in caplog.records)
    finally:
        PORT.knobs.reset_knob_controller()


# ---------------------------------------------------------------------------
# admin hosting: GET/POST /knobs + armed-state
# ---------------------------------------------------------------------------

@pytest.fixture
def admin_with_knobs():
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
    clock, rec, met = _start(PORT)
    applies = []

    def spy(vector):
        applies.append(dict(vector))
        return {"ok": True}

    ctl = PORT.knobs.KnobController(
        apply_fn=spy, recorder_fn=lambda: rec,
        config=PORT.knobs.KnobConfig(interval_s=60.0, hysteresis_evals=2,
                                     cooldown_s=0.0, ring=64),
        clock=clock, mode="observe")
    from incubator_predictionio_tpu_torch.servers.admin import (
        AdminServer as _Admin,
    )

    assert _Admin is AdminServer
    ad = AdminServer(ip="127.0.0.1", port=0, knobs=ctl)
    port = ad.start_background()
    try:
        yield {"port": port, "ctl": ctl, "rec": rec, "met": met,
               "clock": clock, "applies": applies}
    finally:
        ad.stop()
        PORT.knobs.reset_knob_controller()
        PORT.controller.reset_controller()
        Storage.reset()


def test_knobs_routes_on_admin(admin_with_knobs):
    port = admin_with_knobs["port"]
    plant(admin_with_knobs["rec"], admin_with_knobs["clock"],
          admin_with_knobs["met"], recall=0.80)
    admin_with_knobs["ctl"].evaluate_once()
    status, body = _get_json(port, "/knobs?limit=10")
    assert status == 200
    assert body["mode"] == "observe" and body["running"] is True
    assert body["values"]["PIO_SERVE_MIPS_NPROBE"] == 64
    assert body["knobs"]["mips_nprobe"]["env"] == "PIO_SERVE_MIPS_NPROBE"
    assert set(body["recorder"]) == {"armed", "samples"}
    assert set(body["incident"]) == {"armed", "directory"}
    assert body["decisions"][0]["kind"] == "evaluation"
    assert body["decisions"][0]["traceId"].startswith("knb-")
    status, cbody = _get_json(port, "/controller")
    assert status == 200 and "recorder" in cbody and "incident" in cbody
    status, body = _post_json(port, "/knobs", {"mode": "act"})
    assert status == 200 and body["mode"] == "act"
    assert _post_json(port, "/knobs", {"mode": "sideways"})[0] == 400
    assert _post_json(port, "/knobs", ["act"])[0] == 400
    assert _get_json(port, "/knobs?limit=many")[0] == 400
    status, body = _get_json(port, "/knobs")
    assert body["mode"] == "act"
    assert any(d.get("kind") == "mode_change" and d["to"] == "act"
               for d in body["decisions"])
    assert admin_with_knobs["applies"] == []
