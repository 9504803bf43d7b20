"""The port's SLO burn-rate engine (``obs/slo.py``) against the JAX
package's, on the CPU.

Mirrors the cases of tests/test_slo.py that need neither ``obs/profile``
nor the admin server: each one plants the same observations in both
packages' registries, each under its own ``FakeClock``, and requires the
same evaluation (burn rates, budgets, breach flags, window coverage).
``tenant_specs`` and the scheduler's shed threshold
(``serve_objective_s``) read the same declared objective; the fleet-mode
reset clamp reads through both packages' federation shapes. The profiler
cases are in tests/test_torch_profile.py, ``GET /slo`` on the dashboard
in tests/test_torch_dashboard.py; its admin-server half is in
tests/test_torch_admin.py.
"""

import pytest

from incubator_predictionio_tpu.obs import metrics as jmetrics
from incubator_predictionio_tpu.obs import slo as jslo
from incubator_predictionio_tpu.serving import scheduler as jsched
from incubator_predictionio_tpu.serving import tenancy as jtenancy
from incubator_predictionio_tpu.utils.times import FakeClock as JFakeClock
from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
from incubator_predictionio_tpu_torch.obs import slo as obs_slo
from incubator_predictionio_tpu_torch.serving import scheduler, tenancy
from incubator_predictionio_tpu_torch.utils.times import FakeClock

PKGS = {
    "port": (obs_metrics.Registry, obs_slo, FakeClock),
    "jax": (jmetrics.Registry, jslo, JFakeClock),
}


def _engine(pkg, reg, clock, target=0.99, threshold=1.0, kind="histogram",
            metric="t_slo_seconds"):
    _reg_cls, slo, _clock = PKGS[pkg]
    spec = slo.SLOSpec(name="t", metric=metric, threshold=threshold,
                       target=target, kind=kind)
    return slo.SLOEngine(specs=(spec,), registry=reg, clock=clock,
                         fast_window_s=60.0, slow_window_s=600.0,
                         min_tick_interval_s=0.0)


def _both(scenario):
    """Run ``scenario(pkg)`` for each package; both returned the same."""
    got = {pkg: scenario(pkg) for pkg in PKGS}
    assert got["port"] == got["jax"]
    return got["port"]


def test_burn_rate_zero_when_healthy_then_flips_on_breach():
    def scenario(pkg):
        reg_cls, _slo, clock_cls = PKGS[pkg]
        reg, clock = reg_cls(), clock_cls()
        h = reg.histogram("t_slo_seconds", "x", buckets=(1.0, 2.0))
        eng = _engine(pkg, reg, clock)
        h.observe(0.5, 100)
        eng.tick(force=True)
        clock.advance(10)
        healthy = eng.evaluate()[0]
        h.observe(5.0, 50)
        clock.advance(10)
        return healthy, eng.evaluate()[0]

    healthy, breached = _both(scenario)
    assert healthy["noData"] is False and healthy["breached"] is False
    assert healthy["windows"]["fast"]["burnRate"] == 0.0
    assert healthy["errorBudgetRemaining"] == 1.0
    assert breached["windows"]["fast"]["burnRate"] > 1.0
    assert breached["breached"] is True
    assert breached["errorBudgetRemaining"] < 1.0


def test_threshold_rounds_down_to_bucket_bound():
    def scenario(pkg):
        reg = PKGS[pkg][0]()
        h = reg.histogram("t_r_seconds", "x", buckets=(1.0, 2.0, 4.0))
        h.observe(1.5)
        return h.cumulative_below(3.0), h.cumulative_below(1.2)

    between, below = _both(scenario)
    assert between == (1, 1)
    assert below[0] == 0  # the 1.5 observation is not granted


def test_gauge_slo_counts_one_observation_per_tick():
    def scenario(pkg):
        reg_cls, _slo, clock_cls = PKGS[pkg]
        reg, clock = reg_cls(), clock_cls()
        g = reg.gauge("t_stale_seconds", "x")
        eng = _engine(pkg, reg, clock, kind="gauge",
                      metric="t_stale_seconds", threshold=100.0)
        g.set(10.0)
        eng.tick(force=True)
        clock.advance(5)
        first = eng.evaluate()[0]
        g.set(5000.0)
        for _ in range(20):
            clock.advance(1)
            eng.tick(force=True)
        return first, eng.evaluate()[0]

    first, later = _both(scenario)
    assert first["windows"]["fast"]["burnRate"] == 0.0
    assert later["windows"]["fast"]["burnRate"] > 1.0
    assert later["breached"] is True


def test_missing_metric_reports_no_data_not_breach():
    def scenario(pkg):
        reg_cls, _slo, clock_cls = PKGS[pkg]
        return _engine(pkg, reg_cls(), clock_cls()).evaluate()[0]

    out = _both(scenario)
    assert out["noData"] is True and out["breached"] is False
    assert out["errorBudgetRemaining"] == 1.0


def test_registered_but_never_set_gauge_is_no_data():
    def scenario(pkg):
        reg_cls, _slo, clock_cls = PKGS[pkg]
        reg, clock = reg_cls(), clock_cls()
        g = reg.gauge("t_unset_seconds", "x")
        eng = _engine(pkg, reg, clock, kind="gauge",
                      metric="t_unset_seconds", threshold=100.0)
        eng.tick(force=True)
        clock.advance(5)
        unset = eng.evaluate()[0]
        g.set(0.0)  # a genuine zero is data
        clock.advance(5)
        return unset, eng.evaluate()[0]

    unset, zero = _both(scenario)
    assert unset["noData"] is True and unset["breached"] is False
    assert zero["noData"] is False


def test_slow_window_confirms_sustained_burn():
    def scenario(pkg):
        reg_cls, _slo, clock_cls = PKGS[pkg]
        reg, clock = reg_cls(), clock_cls()
        h = reg.histogram("t_slo_seconds", "x", buckets=(1.0,))
        eng = _engine(pkg, reg, clock)
        eng.tick(force=True)
        h.observe(5.0, 10)
        clock.advance(30)
        eng.tick(force=True)
        h.observe(0.5, 10_000)
        clock.advance(500)
        return eng.evaluate()[0]

    out = _both(scenario)
    assert out["windows"]["fast"]["burnRate"] == 0.0
    assert 0.0 < out["windows"]["slow"]["burnRate"] < 1.0


def test_exported_gauges_update_at_evaluate():
    def scenario(pkg):
        _reg_cls, slo, clock_cls = PKGS[pkg]
        reg = (obs_metrics if pkg == "port" else jmetrics).REGISTRY
        clock = clock_cls()
        h = reg.histogram("t_exp_seconds", "x", buckets=(1.0,))
        spec = slo.SLOSpec(name="t_exp", metric="t_exp_seconds",
                           threshold=1.0, target=0.9)
        eng = slo.SLOEngine(specs=(spec,), registry=reg, clock=clock,
                            min_tick_interval_s=0.0)
        h.observe(9.0, 10)
        eng.tick(force=True)
        clock.advance(10)
        h.observe(9.0, 10)
        eng.evaluate()
        return (slo.BURN_RATE.labels(slo="t_exp", window="fast").value,
                slo.BUDGET_REMAINING.labels(slo="t_exp").value)

    burn, budget = _both(scenario)
    assert burn > 1.0 and budget < 1.0


def test_counter_reset_clamps_process_mode():
    """A restart mid-window zeroes the cumulative counters: the window
    delta clamps at zero instead of going negative."""
    def scenario(pkg):
        reg_cls, _slo, clock_cls = PKGS[pkg]
        reg, clock = reg_cls(), clock_cls()
        h = reg.histogram("t_reset_seconds", "x", buckets=(1.0, 2.0))
        eng = _engine(pkg, reg, clock, metric="t_reset_seconds")
        eng.tick(force=True)
        h.observe(5.0, 100)
        clock.advance(10)
        before = eng.evaluate()[0]
        reg2 = reg_cls()
        reg2.histogram("t_reset_seconds", "x",
                       buckets=(1.0, 2.0)).observe(0.5, 10)
        eng.registry = reg2
        clock.advance(10)
        return before, eng.evaluate()[0]

    before, after = _both(scenario)
    assert before["windows"]["fast"]["burnRate"] > 1.0
    for w in ("fast", "slow"):
        assert after["windows"][w]["burnRate"] >= 0.0
        assert after["windows"][w]["badFraction"] >= 0.0
        assert after["windows"][w]["observations"] >= 0
    assert after["windows"]["fast"]["burnRate"] == 0.0
    assert 0.0 <= after["errorBudgetRemaining"] <= 1.0


def test_breach_listener_fires_on_a_fast_burn():
    def scenario(pkg):
        reg_cls, _slo, clock_cls = PKGS[pkg]
        reg, clock = reg_cls(), clock_cls()
        h = reg.histogram("t_slo_seconds", "x", buckets=(1.0,))
        eng = _engine(pkg, reg, clock)
        seen = []
        eng.add_breach_listener(lambda entry: seen.append(entry["name"]))
        eng.tick(force=True)
        h.observe(0.5, 10)
        clock.advance(5)
        eng.evaluate()
        h.observe(9.0, 10)
        clock.advance(5)
        eng.evaluate()
        return seen

    assert _both(scenario) == ["t"]


def test_tenant_specs_slice_the_latency_family(monkeypatch):
    monkeypatch.setenv("PIO_TENANTS", "alpha:k1;beta:k2")
    tenancy.reset_registry()
    jtenancy.reset_registry()
    try:
        specs = obs_slo.tenant_specs()
        assert specs == tuple(
            obs_slo.SLOSpec(**s.__dict__) for s in jslo.tenant_specs())
        assert [s.name for s in specs] == \
            ["serve_p99@alpha", "serve_p99@beta"]
        for s in specs:
            assert s.metric == "pio_query_latency_seconds"
            assert s.labels == (("tenant", s.name.split("@")[1]),)
        names = [s.name for s in obs_slo.default_specs()]
        assert names == [s.name for s in jslo.default_specs()]
        assert "serve_p99" in names and "serve_p99@alpha" in names
        monkeypatch.delenv("PIO_TENANTS")
        tenancy.reset_registry()
        assert obs_slo.tenant_specs() == ()
    finally:
        tenancy.reset_registry()
        jtenancy.reset_registry()


def test_a_tenant_spec_reads_its_own_child():
    """The per-tenant objective counts only its tenant's observations of
    the shared latency family."""
    def scenario(pkg):
        reg_cls, slo, clock_cls = PKGS[pkg]
        reg, clock = reg_cls(), clock_cls()
        h = reg.histogram("pio_query_latency_seconds", "x",
                          labels=("tenant",), buckets=(0.25, 1.0))
        specs = tuple(slo.SLOSpec(
            name=f"serve_p99@{t}", metric="pio_query_latency_seconds",
            threshold=0.25, target=0.99, labels=(("tenant", t),))
            for t in ("alpha", "beta"))
        eng = slo.SLOEngine(specs=specs, registry=reg, clock=clock,
                            fast_window_s=60.0, slow_window_s=600.0,
                            min_tick_interval_s=0.0)
        eng.tick(force=True)
        h.labels(tenant="alpha").observe(0.01, 100)
        h.labels(tenant="beta").observe(0.9, 100)
        clock.advance(5)
        return {e["name"]: (e["breached"], e["totalObservations"])
                for e in eng.evaluate()}

    assert _both(scenario) == {"serve_p99@alpha": (False, 100),
                               "serve_p99@beta": (True, 100)}


@pytest.mark.parametrize("raw", [None, "0.05", "2.5", "junk"])
def test_shed_threshold_is_the_declared_objective(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("PIO_SLO_SERVE_P99_S", raising=False)
    else:
        monkeypatch.setenv("PIO_SLO_SERVE_P99_S", raw)
    got = scheduler.serve_objective_s()
    assert got == jsched.serve_objective_s()
    assert got == {None: 0.25, "0.05": 0.05, "2.5": 2.5, "junk": 0.25}[raw]


class _ShrinkingFleet:
    """Registry-shaped fleet stub (tests/test_slo.py's) on package
    ``fed``'s federation: the histogram family RESETS between reads (a
    worker restarted between two ticks)."""

    def __init__(self, fed, xfmt):
        self.fed, self.xfmt, self.reads = fed, xfmt, 0

    def get(self, name):
        self.reads += 1
        m = self.fed.FederatedMetric(name, "histogram")
        if self.reads == 1:
            child = self.xfmt.HistogramChild(
                buckets=[(1.0, 50.0), (2.0, 50.0)], sum=500.0, count=150.0)
        else:
            child = self.xfmt.HistogramChild(
                buckets=[(1.0, 10.0), (2.0, 10.0)], sum=5.0, count=10.0)
        m.absorb("w0", self.xfmt.Family(name=name, kind="histogram",
                                        histograms={frozenset(): child}))
        return m


def test_counter_reset_clamps_fleet_mode():
    from incubator_predictionio_tpu.obs import expofmt as jexpofmt
    from incubator_predictionio_tpu.obs import federate as jfederate
    from incubator_predictionio_tpu_torch.obs import expofmt, federate

    mods = {"port": (federate, expofmt), "jax": (jfederate, jexpofmt)}

    def scenario(pkg):
        _reg_cls, slo, clock_cls = PKGS[pkg]
        clock = clock_cls()
        spec = slo.SLOSpec(name="t", metric="t_fleet_seconds",
                           threshold=1.0, target=0.99)
        eng = slo.SLOEngine(specs=(spec,), registry=_ShrinkingFleet(
            *mods[pkg]), clock=clock, fast_window_s=60.0,
            slow_window_s=600.0, min_tick_interval_s=0.0,
            export_gauges=False)
        eng.tick(force=True)
        clock.advance(10)
        return eng.evaluate()[0]

    out = _both(scenario)
    for w in ("fast", "slow"):
        win = out["windows"][w]
        assert win["burnRate"] >= 0.0 and win["badFraction"] >= 0.0
        assert win["observations"] >= 0
    assert out["windows"]["fast"]["burnRate"] == 0.0
    assert out["breached"] is False
    assert 0.0 <= out["errorBudgetRemaining"] <= 1.0
