"""The port's continuous-batching scheduler (``serving/scheduler.py``)
against the JAX package's, on the CPU.

Mirrors tests/test_scheduler.py's cases on the port: the ladder rule
(``plan_dispatch``), the walk-up of a prefilled queue, the age bound,
per-engine queues, the shed-then-recover flip, priority eviction, a cold
queue that never sheds, a warm ladder that adds no new padded shape
(``pio_serve_compile_cache_size`` flat), and the batch-size and
queue-wait histograms. Beyond them:

- ``plan_dispatch`` equals the JAX package's over a seeded grid of
  (depth, rung, age, cap, wait bound);
- one scripted submit sequence replayed through both packages'
  ``BatchScheduler``, each on its own ``FakeClock``, gives the same batch
  widths and members, shed reasons and eviction victims.

Fusing is made deterministic without wall-clock timing: the handler holds
each dispatch on a gate while the script queues the rest, and the script
moves on only once the scheduler has either entered the next dispatch or
gone idle (every queue empty, nothing in flight).
"""

import threading
import time

import numpy as np
import pytest
import torch

from incubator_predictionio_tpu.serving import scheduler as jsched
from incubator_predictionio_tpu.utils.times import FakeClock as JFakeClock
from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
from incubator_predictionio_tpu_torch.ops import topk
from incubator_predictionio_tpu_torch.serving.scheduler import (
    BatchScheduler,
    ShedError,
    ladder_cap,
    plan_dispatch,
)
from incubator_predictionio_tpu_torch.utils.times import FakeClock


# ---------------------------------------------------------------------------
# plan_dispatch: the pure ladder rule
# ---------------------------------------------------------------------------

def test_rung_grows_one_ladder_step_under_load():
    # queue deeper than the rung: take the rung now, grow for next time
    assert plan_dispatch(10, 4, 0.0, 512, 0.25) == (4, 8)
    assert plan_dispatch(100, 8, 0.0, 512, 0.25) == (8, 16)
    # growth saturates at the cap
    assert plan_dispatch(1000, 512, 0.0, 512, 0.25) == (512, 512)


def test_rung_collapses_when_idle():
    assert plan_dispatch(1, 8, 0.0, 512, 0.25) == (1, 4)
    assert plan_dispatch(0, 8, 0.0, 512, 0.25) == (0, 8)  # no dispatch
    # floor is rung 1
    assert plan_dispatch(1, 1, 0.0, 512, 0.25) == (1, 1)


def test_rung_hysteresis_band_holds_steady():
    # depth in (rung/2, rung]: no thrash
    assert plan_dispatch(3, 4, 0.0, 512, 0.25) == (3, 4)
    assert plan_dispatch(4, 4, 0.0, 512, 0.25) == (4, 4)


def test_age_breach_drains_whole_backlog():
    # the oldest waiter crossed the bound: take everything (up to cap),
    # the rung still steps one ladder rung
    assert plan_dispatch(100, 4, 0.3, 512, 0.25) == (100, 8)
    assert plan_dispatch(1000, 4, 0.3, 512, 0.25) == (512, 8)
    # bound disabled (<=0): never triggers
    assert plan_dispatch(100, 4, 99.0, 512, 0.0) == (4, 8)


def test_plan_dispatch_equals_jax_over_seeded_grid():
    rng = np.random.default_rng(13)
    n = 0
    for cap in (1, 2, 8, 64, 512):
        for _ in range(400):
            depth = int(rng.integers(0, 3 * cap + 3))
            rung = int(rng.choice([1, 2, 4, 8, 16, 64, 256, 512, 1024]))
            age = float(rng.choice([0.0, 0.1, 0.249, 0.25, 0.3, 5.0]))
            bound = float(rng.choice([-1.0, 0.0, 0.05, 0.25, 1.0]))
            got = plan_dispatch(depth, rung, age, cap, bound)
            assert got == jsched.plan_dispatch(depth, rung, age, cap,
                                               bound), (depth, rung, age,
                                                        cap, bound)
            n += 1
    assert n == 2000


def test_ladder_cap_is_pow2(monkeypatch):
    for raw, want in (("100", 128), ("512", 512), ("1", 1), ("0", 1),
                      ("junk", 512)):
        monkeypatch.setenv("PIO_SERVE_MAX_BATCH", raw)
        assert ladder_cap() == want == jsched.ladder_cap()


# ---------------------------------------------------------------------------
# threaded scheduler behaviour
# ---------------------------------------------------------------------------

def _drain(futs, timeout=10.0):
    return [f.result(timeout) for f in futs]


def test_ladder_walkup_batch_sizes():
    """A prefilled queue drains in pow2 ladder steps: 1 (the in-flight
    singleton), then 1, 2, 4, 8, ... — the fused width follows the queue
    depth, not a fixed cap."""
    gate = threading.Event()
    first_in = threading.Event()
    batches = []

    def handler(bodies):
        first_in.set()
        gate.wait(10)
        batches.append(len(bodies))
        return bodies

    s = BatchScheduler(handler, 64, shed=False, wait_bound_s=0.0)
    try:
        futs = [s.submit(b"0")]
        assert first_in.wait(5)           # singleton dispatch in flight
        futs += [s.submit(b"%d" % i) for i in range(1, 64)]
        gate.set()
        assert _drain(futs) == [b"%d" % i for i in range(64)]
        # the in-flight singleton, then one rung-1 dispatch (the rung
        # grows only after a dispatch saw the deep queue), then the walk
        assert batches == [1, 1, 2, 4, 8, 16, 32], batches
    finally:
        s.stop()


def test_age_bound_never_holds_a_query_past_it():
    """Requests arriving while a dispatch runs must not wait several
    rung-limited cycles: once their age crosses the bound, the next
    dispatch takes the whole backlog."""
    clock = FakeClock()
    gate = threading.Event()
    first_in = threading.Event()
    batches = []

    def handler(bodies):
        first_in.set()
        gate.wait(10)
        batches.append(len(bodies))
        return bodies

    s = BatchScheduler(handler, 64, clock=clock, shed=False,
                       wait_bound_s=0.25)
    try:
        futs = [s.submit(b"a")]
        assert first_in.wait(5)
        futs += [s.submit(b"%d" % i) for i in range(10)]
        clock.advance(1.0)                # all ten now exceed the bound
        gate.set()
        _drain(futs)
        assert batches == [1, 10], batches
    finally:
        s.stop()


def test_per_engine_queues_fuse_independently():
    """Batches never mix engines, and each engine's rung adapts to its
    own queue depth."""
    gate = threading.Event()
    first_in = threading.Event()
    batches = []

    def handler(bodies, engine):
        first_in.set()
        gate.wait(10)
        batches.append((engine, len(bodies)))
        return bodies

    s = BatchScheduler(handler, 64, shed=False, wait_bound_s=0.0)
    try:
        futs = [s.submit(b"x", engine="reco")]
        assert first_in.wait(5)
        futs += [s.submit(b"%d" % i, engine="reco") for i in range(32)]
        futs += [s.submit(b"e%d" % i, engine="ecom") for i in range(2)]
        gate.set()
        _drain(futs)
        assert {e for e, _n in batches} == {"reco", "ecom"}
        assert sum(n for e, n in batches if e == "reco") == 33
        assert sum(n for e, n in batches if e == "ecom") == 2
        assert s.rung("reco") > s.rung("ecom")
        assert s.rung("ecom") == 1
    finally:
        s.stop()


class _GatedHandler:
    """The first call advances the fake clock (planting the EWMA dispatch
    wall); later calls block on a gate."""

    def __init__(self, clock, wall_s):
        self.clock = clock
        self.wall_s = wall_s
        self.gate = threading.Event()
        self.in_handler = threading.Event()
        self.calls = 0

    def __call__(self, bodies):
        self.calls += 1
        if self.calls == 1:
            self.clock.advance(self.wall_s)
        else:
            self.in_handler.set()
            self.gate.wait(10)
        return bodies


def test_shed_then_recover_flip():
    clock = FakeClock()
    handler = _GatedHandler(clock, wall_s=0.2)
    s = BatchScheduler(handler, 4, clock=clock, shed=True, slo_s=0.5,
                       p99_fn=lambda: 0.1, wait_bound_s=0.0)
    try:
        s.submit(b"w").result(10)          # plants ewma_wall = 0.2
        inflight = s.submit(b"0")
        assert handler.in_handler.wait(5)
        # cap 4: depth 4 → (1 + 1)·0.2 + 0.1 = 0.5, not past the SLO;
        # depth 5 → 0.7: the fifth queued arrival sheds
        admitted = [s.submit(b"%d" % i) for i in range(4)]
        shed = s.submit(b"last")
        assert shed.done()
        with pytest.raises(ShedError) as ei:
            shed.result()
        assert ei.value.status == 503
        assert int(ei.value.headers["Retry-After"]) >= 1
        assert ei.value.reason == "overload"
        handler.gate.set()
        _drain([inflight] + admitted)
        assert s.submit(b"again").result(10) == b"again"
        assert s.shed_count == 1
    finally:
        s.stop()


def test_priority_evicts_lowest_not_highest():
    clock = FakeClock()
    handler = _GatedHandler(clock, wall_s=0.2)
    s = BatchScheduler(handler, 4, clock=clock, shed=True, slo_s=0.5,
                       p99_fn=lambda: 0.1, wait_bound_s=0.0)
    try:
        s.submit(b"w").result(10)
        inflight = s.submit(b"0")
        assert handler.in_handler.wait(5)
        low = [s.submit(b"%d" % i, priority=0) for i in range(4)]
        # at the overload point a higher-priority arrival evicts the
        # lowest-priority waiter instead of shedding itself
        vip = s.submit(b"vip", priority=5)
        assert not vip.done()
        evicted = [f for f in low if f.done()]
        assert len(evicted) == 1
        with pytest.raises(ShedError) as ei:
            evicted[0].result()
        assert ei.value.reason == "evicted"
        # an equal-priority arrival at the same depth sheds itself
        with pytest.raises(ShedError):
            s.submit(b"eq", priority=0).result()
        handler.gate.set()
        _drain([inflight, vip] + [f for f in low if f is not evicted[0]])
        assert s.shed_count == 2
    finally:
        s.stop()


def test_cold_queue_never_sheds():
    """No EWMA evidence (no dispatch yet) → no shedding, whatever the
    depth."""
    gate = threading.Event()

    def handler(bodies):
        gate.wait(10)
        return bodies

    s = BatchScheduler(handler, 4, shed=True, slo_s=0.01,
                       p99_fn=lambda: 10.0, wait_bound_s=0.0)
    try:
        futs = [s.submit(b"%d" % i) for i in range(20)]
        assert not any(f.done() and f.exception() for f in futs)
        gate.set()
        _drain(futs)
        assert s.shed_count == 0
    finally:
        s.stop()


def test_warm_ladder_serves_with_no_new_padded_shape():
    """Once every pow2 rung up to the cap has dispatched, any mixture of
    live batch widths pads onto a shape already seen: the port's
    counterpart of the reference's zero-recompile pin."""
    uf = torch.from_numpy(np.random.default_rng(0).normal(
        size=(64, 8)).astype(np.float32))
    itf = torch.from_numpy(np.random.default_rng(1).normal(
        size=(48, 8)).astype(np.float32))

    def handler(bodies):
        rows = [int(b) % 64 for b in bodies]
        out = topk.batch_score_top_k(uf, itf, rows, k=8)
        assert out.shape[1] >= len(bodies)
        return bodies

    cap = 16
    for rung in topk.ladder_rungs(cap):
        handler([b"%d" % i for i in range(rung)])
    warm = topk.serve_compile_cache_size()
    assert warm > 0
    s = BatchScheduler(handler, cap, shed=False, wait_bound_s=0.0)
    try:
        for width in (3, 7, 11, 16, 5, 13):
            _drain([s.submit(b"%d" % i) for i in range(width)])
        assert topk.serve_compile_cache_size() == warm
        # the gauge reads the same count at scrape time
        obs_metrics.REGISTRY.run_collectors()
        gauge = obs_metrics.REGISTRY.get("pio_serve_compile_cache_size")
        assert gauge.value == warm
    finally:
        s.stop()


def test_batch_size_and_queue_wait_booked():
    size_h = obs_metrics.REGISTRY.get("pio_serve_batch_size")
    wait_h = obs_metrics.REGISTRY.get("pio_serve_queue_wait_seconds")
    assert size_h is not None and wait_h is not None
    _n0, t0 = size_h.cumulative_below(float("inf"))
    _w0, w0 = wait_h.cumulative_below(float("inf"))
    s = BatchScheduler(lambda bodies: bodies, 8, shed=False)
    try:
        _drain([s.submit(b"x") for _ in range(5)])
    finally:
        s.stop()
    _n1, t1 = size_h.cumulative_below(float("inf"))
    _w1, w1 = wait_h.cumulative_below(float("inf"))
    assert t1 > t0          # at least one dispatch booked its width
    assert w1 - w0 == 5     # every query booked its queue wait


# ---------------------------------------------------------------------------
# one script through both packages' schedulers
# ---------------------------------------------------------------------------

class _Replay:
    """Runs a script against one ``BatchScheduler`` class with one
    dispatcher thread. The handler records each batch, advances the fake
    clock by ``wall_s`` (the dispatch's wall) and blocks until the script
    releases it; after each release the replay waits until the scheduler
    has entered its next dispatch or gone idle, so what the next step sees
    does not depend on thread timing."""

    def __init__(self, cls, clock, **kw):
        self.clock = clock
        self.batches = []
        self.entered = 0
        self.released = 0
        self.cv = threading.Condition()
        self.futs = {}
        self.sched = cls(self._handle, 8, clock=clock, **kw)

    def _handle(self, bodies, engine, tenant):
        with self.cv:
            self.batches.append((tenant, engine, list(bodies)))
            self.entered += 1
            n = self.entered
            self.cv.notify_all()
            self.cv.wait_for(lambda: self.released >= n, timeout=10)
        self.clock.advance(0.1)
        return list(bodies)

    def _in_flight(self) -> bool:
        with self.sched._cv:
            return any(q.in_flight for q in self.sched._queues.values())

    def _settle(self):
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with self.cv:
                if self.entered > self.released:
                    return
            with self.sched._cv:
                idle = all(not q.items and not q.in_flight
                           for q in self.sched._queues.values())
            if idle:
                return
            time.sleep(0.001)
        raise AssertionError("the scheduler did not settle")

    def submit(self, body, **kw):
        was_idle = not self._in_flight() and self.entered == self.released
        self.futs[body] = self.sched.submit(body, **kw)
        if was_idle and not self.futs[body].done():
            self._settle()

    def release(self):
        with self.cv:
            self.released += 1
            self.cv.notify_all()
        self._settle()

    def outcomes(self):
        out = {}
        for body, f in self.futs.items():
            exc = f.exception(10)
            out[body] = "ok" if exc is None else getattr(exc, "reason",
                                                         repr(exc))
        return out


def _script(d):
    """Two tenants (weights 3 and 1, b's quota 3), a quota shed, the
    weighted-fair pick, overload sheds, a priority eviction, the age
    bound, then the drain."""
    d.submit("a0", tenant="a")                       # in flight
    for i in range(1, 6):
        d.submit(f"a{i}", tenant="a")
    for i in range(4):
        d.submit(f"b{i}", tenant="b")                # b3: quota
    for _ in range(3):
        d.release()
    for i in range(6, 40):
        d.submit(f"a{i}", tenant="a")                # overload sheds
    d.submit("vip", tenant="a", priority=5)          # evicts a waiter
    d.submit("c0", tenant="c")
    d.clock.advance(0.3)                             # past the bound
    for _ in range(60):
        d.release()
    d.submit("z0", tenant="a")
    d.release()


def test_scripted_replay_equals_jax():
    kw = dict(shed=True, slo_s=0.5, p99_fn=lambda tenant: 0.1,
              wait_bound_s=0.25, tenant_weights={"a": 3, "b": 1},
              tenant_quotas={"b": 3})
    port = _Replay(BatchScheduler, FakeClock(), **kw)
    ref = _Replay(jsched.BatchScheduler, JFakeClock(), **kw)
    try:
        _script(port)
        _script(ref)
        assert port.batches == ref.batches
        assert port.outcomes() == ref.outcomes()
        assert port.sched.shed_by_tenant == ref.sched.shed_by_tenant
        assert port.sched.stats() == ref.sched.stats()
    finally:
        port.sched.stop()
        ref.sched.stop()
    widths = [len(b) for _t, _e, b in port.batches]
    reasons = set(port.outcomes().values())
    # the script reached every branch it was written for
    assert max(widths) > 1 and sum(widths) == sum(
        v == "ok" for v in port.outcomes().values())
    assert {"ok", "quota", "overload", "evicted"} <= reasons
