"""The port's speed layer (``speed/foldin.py``, ``speed/overlay.py``,
``obs/freshness.py``) against the JAX package's, on the CPU: the cases of
tests/test_speed_layer.py, of tests/test_fused_gram.py's
``TestFoldInFusedRouting`` and of tests/test_slo.py's freshness section,
each through both packages on the same seeded inputs.

- ``FoldInSolver``: the port (the fused entry's plain version on CPU
  tensors) against JAX's XLA route and its fused Pallas kernel in
  interpret mode, within 1e-4 · max|x|, and all of them against
  ``dense_reference_solve`` within the JAX tests' 1e-3 relative (2e-4
  absolute for the fused-routing cases); ladder truncation, implicit,
  empty rows exactly 0, the dispatched-shape counter, ``PIO_ALS_SOLVER``
  ignored as by the JAX kernel route; no CPU fallback.
- The overlay on ``memory`` and on ``cpplog``, each package on a store
  of its own with the same events: equal ``poll()`` dicts and vectors
  within 1e-4 · max|x|; per-user invalidation, TTL with ``FakeClock``,
  ``key_version``, the cursor reset after a log rewrite, the item-side
  fold-in and the audited guarded writes.
- The prediction server end to end on a memory store, a second
  ``load_models()`` as the hot swap; the cold-start recall claim on the
  port's ``als_train_implicit``; the freshness tracker.
"""

import importlib
import json
import logging
import urllib.request

import numpy as np
import pytest
import torch

CPU = "cpu"
MEM_CONF = {
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "m",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "e",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "d",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
}


class Pkg:
    """One package's speed-layer stack, reached by module path."""

    def __init__(self, name: str, pkg: str):
        self.name = name

        def mod(path):
            return importlib.import_module(f"{pkg}.{path}")

        self.foldin = mod("speed.foldin")
        self.overlay = mod("speed.overlay")
        self.cache = mod("speed.cache")
        self.freshness = mod("obs.freshness")
        self.storage = mod("data.storage")
        self.store = mod("data.store")
        self.Event = mod("data.event").Event
        self.DataMap = mod("data.datamap").DataMap
        self.times = mod("utils.times")
        self.App = self.storage.App
        self.Storage = self.storage.Storage

    def solver(self, other, **kw):
        if self.name == "port":
            kw.setdefault("device", CPU)
        return self.foldin.FoldInSolver(other, **kw)

    def rate(self, app, user, item, value, event="rate", prop="rating"):
        self.store.EventStore.write([self.Event(
            event=event, entity_type="user", entity_id=user,
            target_entity_type="item", target_entity_id=item,
            properties=self.DataMap({prop: float(value)} if prop else {}),
            event_time=self.times.now_utc())], app)

    def make_overlay(self, app, other, idx, clock, cls=None, **cfg_kw):
        kw = dict(app_name=app, event_names=("rate",), value_prop="rating",
                  l2=0.05, ttl_s=30.0)
        kw.update(cfg_kw)
        if self.name == "port" and not isinstance(other, torch.Tensor):
            other = torch.from_numpy(np.asarray(other, np.float32))
        return (cls or self.overlay.SpeedOverlay)(
            self.overlay.SpeedOverlayConfig(**kw), other, idx, clock=clock)


JAX = Pkg("jax", "incubator_predictionio_tpu")
PORT = Pkg("port", "incubator_predictionio_tpu_torch")
PKGS = (JAX, PORT)
BOTH = pytest.mark.parametrize("p", PKGS, ids=lambda p: p.name)


def _close(got, ref, what=""):
    """Port vs JAX: within 1e-4 · max|x|."""
    got, ref = np.asarray(got), np.asarray(ref)
    scale = max(float(np.max(np.abs(ref))), 1e-12)
    assert np.max(np.abs(got - ref)) <= 1e-4 * scale, what


def _rel_dense(got, ref):
    return float(np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-12))


@pytest.fixture
def mem_store():
    for p in PKGS:
        p.Storage.configure(MEM_CONF)
        p.Storage.get_meta_data_apps().insert(p.App(0, "speedapp"))
    yield "speedapp"
    for p in PKGS:
        p.Storage.reset()


# ---------------------------------------------------------------------------
# FoldInSolver against JAX's two routes and the dense reference
# ---------------------------------------------------------------------------

def _jax_solvers(other, **kw):
    """JAX's XLA route and its fused kernel (interpret mode on the CPU)."""
    return (JAX.solver(other, use_kernel=False, **kw),
            JAX.solver(other, use_kernel=True, **kw))


def test_foldin_matches_jax_and_dense_every_bucket():
    rng = np.random.default_rng(0)
    M, K = 300, 16
    other = rng.normal(0, 0.3, (M, K)).astype(np.float32)
    degrees = [1, 7, 8, 9, 31, 32, 33, 127, 128, 200, 511, 512]
    rows = [(rng.integers(0, M, d).astype(np.int32),
             rng.normal(3.5, 1.0, d).astype(np.float32)) for d in degrees]
    got = PORT.solver(other, l2=0.05).solve(rows)
    xla, kern = _jax_solvers(other, l2=0.05)
    assert kern.use_kernel and not xla.use_kernel
    ref_xla, ref_kern = xla.solve(rows), kern.solve(rows)
    for k, (cols, vals) in enumerate(rows):
        _close(got[k], ref_kern[k], ("kernel", degrees[k]))
        _close(got[k], ref_xla[k], ("xla", degrees[k]))
        dense = dense_solve(other, cols, vals, 0.05)
        assert _rel_dense(got[k], dense) < 1e-3, degrees[k]


def dense_solve(*a, **kw):
    out = PORT.foldin.dense_reference_solve(*a, **kw)
    np.testing.assert_array_equal(
        out, JAX.foldin.dense_reference_solve(*a, **kw))
    return out


@BOTH
def test_foldin_truncates_over_ladder_history_to_newest(p):
    rng = np.random.default_rng(1)
    M, K = 100, 8
    other = rng.normal(0, 0.3, (M, K)).astype(np.float32)
    cols = rng.integers(0, M, 700).astype(np.int32)
    vals = rng.normal(0, 1.0, 700).astype(np.float32)
    got = p.solver(other, l2=0.1).solve([(cols, vals)])[0]
    ref = dense_solve(other, cols[-512:], vals[-512:], 0.1)
    assert np.max(np.abs(got - ref)) < 1e-3
    if p is PORT:
        _close(got, JAX.solver(other, l2=0.1).solve([(cols, vals)])[0])


def test_foldin_implicit_matches_jax_and_dense():
    rng = np.random.default_rng(2)
    M, K = 150, 8
    other = rng.normal(0, 0.3, (M, K)).astype(np.float32)
    kw = dict(l2=0.05, implicit=True, alpha=2.0)
    port = PORT.solver(other, **kw)
    xla, kern = _jax_solvers(other, **kw)
    for d in (1, 8, 30, 128):
        cols = rng.integers(0, M, d).astype(np.int32)
        vals = np.abs(rng.normal(1.0, 0.5, d)).astype(np.float32)
        got = port.solve([(cols, vals)])[0]
        _close(got, kern.solve([(cols, vals)])[0], ("kernel", d))
        _close(got, xla.solve([(cols, vals)])[0], ("xla", d))
        ref = dense_solve(other, cols, vals, 0.05, implicit=True, alpha=2.0)
        assert _rel_dense(got, ref) < 1e-3, d


@BOTH
def test_foldin_empty_history_is_zero(p):
    other = np.ones((10, 4), np.float32)
    rows = [(np.empty(0, np.int32), np.empty(0, np.float32)),
            (np.asarray([1], np.int32), np.asarray([2.0], np.float32)),
            (np.empty(0, np.int32), np.empty(0, np.float32))]
    out = p.solver(other, l2=0.1).solve(rows)
    assert np.all(out[0] == 0.0) and np.all(out[2] == 0.0)
    assert np.any(out[1] != 0.0)
    if p is PORT:
        _close(out, JAX.solver(other, l2=0.1).solve(rows))


def test_foldin_padding_rows_and_results_in_input_order():
    """65 rows of one width take two dispatches (64 + a padded 1); rows of
    several widths interleaved come back in input order."""
    rng = np.random.default_rng(3)
    other = rng.normal(0, 0.3, (90, 8)).astype(np.float32)
    rows = []
    for k in range(65 + 9):
        d = 5 if k < 65 else int(rng.integers(9, 300))
        rows.append((rng.integers(0, 90, d).astype(np.int32),
                     rng.normal(3, 1, d).astype(np.float32)))
    order = rng.permutation(len(rows))
    rows = [rows[k] for k in order]
    got = PORT.solver(other, l2=0.1).solve(rows)
    ref = JAX.solver(other, l2=0.1, use_kernel=True).solve(rows)
    _close(got, ref)
    for (cols, vals), g in zip(rows, got):
        assert _rel_dense(g, dense_solve(other, cols, vals, 0.1)) < 1e-3


@BOTH
def test_foldin_steady_state_shapes_stay_on_the_ladder(p):
    """Once the ladder is warm (every width × every pow2 batch), arbitrary
    traffic adds no dispatched shape (JAX: no compiled variant)."""
    rng = np.random.default_rng(3)
    M, K = 80, 8
    other = rng.normal(0, 0.3, (M, K)).astype(np.float32)
    solver = p.solver(other, l2=0.1)
    solver.warmup()
    for width in p.foldin._width_ladder():
        b = 1
        while b <= p.foldin.max_batch():
            solver.solve([(np.arange(width, dtype=np.int32) % M,
                           np.ones(width, np.float32))] * b)
            b *= 2
    warm = p.foldin.foldin_compile_cache_size()
    for _ in range(30):
        rows = []
        for _ in range(int(rng.integers(1, 80))):
            d = int(rng.integers(1, 700))
            rows.append((rng.integers(0, M, d).astype(np.int32),
                         rng.normal(0, 1, d).astype(np.float32)))
        solver.solve(rows)
    assert p.foldin.foldin_compile_cache_size() == warm


def test_foldin_shape_counter_counts_width_batch_and_mode(monkeypatch):
    monkeypatch.setattr(PORT.foldin, "_SHAPES", set())
    other = np.random.default_rng(4).normal(size=(40, 8)).astype(np.float32)
    solver = PORT.solver(other, l2=0.1)
    solver.warmup()
    assert PORT.foldin.foldin_compile_cache_size() == 4   # 4 widths, B 1
    solver.solve([(np.arange(3, dtype=np.int32), np.ones(3, np.float32))]
                 * 3)                                    # width 8, B 4
    assert PORT.foldin.foldin_compile_cache_size() == 5
    PORT.solver(other, l2=0.1, implicit=True).warmup()
    assert PORT.foldin.foldin_compile_cache_size() == 9


@BOTH
def test_fused_routing_ladder_buckets_match_dense_reference(p):
    """tests/test_fused_gram.py ``TestFoldInFusedRouting``: every ladder
    width through the fused entry, atol 2e-4 to the dense solve."""
    rng = np.random.default_rng(12)
    other = rng.normal(0, 0.4, (60, 8)).astype(np.float32)
    kw = {"use_kernel": True} if p is JAX else {}
    solver = p.solver(other, l2=0.05, reg_nnz=True, **kw)
    rows = []
    for width in (8, 32, 128, 512):
        d = width - 1 if width > 8 else width
        rows.append((rng.integers(0, 60, d).astype(np.int32),
                     rng.normal(3.5, 1.0, d).astype(np.float32)))
    out = solver.solve(rows)
    for k, (cols, vals) in enumerate(rows):
        np.testing.assert_allclose(
            out[k], dense_solve(other, cols, vals, 0.05), atol=2e-4)


@BOTH
def test_fused_routing_implicit_ladder_matches_dense_reference(p):
    rng = np.random.default_rng(13)
    other = rng.normal(0, 0.4, (50, 8)).astype(np.float32)
    kw = {"use_kernel": True} if p is JAX else {}
    solver = p.solver(other, l2=0.05, implicit=True, alpha=2.0, **kw)
    for width in (8, 32):
        cols = rng.integers(0, 50, width).astype(np.int32)
        vals = np.abs(rng.normal(1, 1, width)).astype(np.float32)
        np.testing.assert_allclose(
            solver.solve([(cols, vals)])[0],
            dense_solve(other, cols, vals, 0.05, implicit=True, alpha=2.0),
            atol=2e-4)


def test_foldin_every_bucket_on_the_fused_entry(monkeypatch):
    """Each occupied (width, pow2 batch) bucket is one call of the fused
    entry, with the implicit path's YᵀY (computed once per solver) and
    twice the CG steps; padding rows are all-mask-0."""
    from incubator_predictionio_tpu_torch.ops import als, als_kernels

    calls = []
    real = als_kernels.als_fused_solve_cg

    def spy(table, cols, vals, mask, l2, **kw):
        calls.append((tuple(cols.shape), mask.sum(1).tolist(), kw))
        return real(table, cols, vals, mask, l2, **kw)

    monkeypatch.setattr(als_kernels, "als_fused_solve_cg", spy)
    gram_calls = []
    real_gram = als._gram_all
    monkeypatch.setattr(als, "_gram_all", lambda f: (
        gram_calls.append(1), real_gram(f))[1])
    rng = np.random.default_rng(5)
    other = rng.normal(size=(70, 8)).astype(np.float32)
    solver = PORT.solver(other, l2=0.1, implicit=True, alpha=1.5)
    rows = [(rng.integers(0, 70, d).astype(np.int32),
             np.ones(d, np.float32)) for d in (3, 3, 3, 40, 600)]
    solver.solve(rows)
    solver.solve(rows[:1])
    assert len(gram_calls) == 1
    assert [c[0] for c in calls] == [(4, 8), (1, 128), (1, 512), (1, 8)]
    assert calls[0][1] == [3.0, 3.0, 3.0, 0.0]      # the padding row
    assert calls[2][1] == [512.0]                   # the newest 512 kept
    assert all(c[2]["implicit"] and c[2]["iters"] == 2 * als.CG_ITERS
               and c[2]["yty"] is not None and c[2]["alpha"] == 1.5
               for c in calls)


def test_foldin_ignores_the_cholesky_setting_as_the_jax_kernel_route(
        monkeypatch):
    """``PIO_ALS_SOLVER=cholesky``: the fused entry runs its CG, as the
    JAX kernel route does (JAX's XLA route solves by Cholesky instead,
    nearer the dense solve)."""
    import incubator_predictionio_tpu.ops.als as jals

    rng = np.random.default_rng(6)
    other = rng.normal(0, 0.3, (80, 16)).astype(np.float32)
    rows = [(rng.integers(0, 80, d).astype(np.int32),
             rng.normal(3, 1, d).astype(np.float32)) for d in (4, 30, 200)]
    cg = PORT.solver(other, l2=0.05).solve(rows)
    monkeypatch.setenv("PIO_ALS_SOLVER", "cholesky")
    monkeypatch.setattr(jals, "_SOLVER", "cholesky")
    got = PORT.solver(other, l2=0.05).solve(rows)
    np.testing.assert_array_equal(got, cg)
    _close(got, JAX.solver(other, l2=0.05, use_kernel=True).solve(rows))
    chol = JAX.solver(other, l2=0.05, use_kernel=False).solve(rows)
    for (cols, vals), c in zip(rows, chol):
        assert _rel_dense(c, dense_solve(other, cols, vals, 0.05)) < 1e-4


def test_foldin_refuses_the_cpu_unless_asked(monkeypatch):
    """A host table goes to CUDA by default and raises without it; a
    table on a device the kernel cannot take raises at the solve, and no
    launch is counted."""
    from incubator_predictionio_tpu_torch import runtime

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    other = np.ones((10, 4), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PORT.foldin.FoldInSolver(other, l2=0.1)
    assert PORT.foldin.FoldInSolver(other, l2=0.1,
                                    device=CPU).device.type == "cpu"
    runtime.reset_launch_counts()
    meta = PORT.foldin.FoldInSolver(torch.empty((10, 4), device="meta"),
                                    l2=0.1)
    assert meta.device.type == "meta"
    with pytest.raises(ValueError, match="CUDA"):
        meta.solve([(np.asarray([1], np.int32),
                     np.asarray([1.0], np.float32))])
    assert sum(runtime.launch_counts().values()) == 0


def test_foldin_keeps_a_tensor_table_where_it_lies():
    t = torch.randn(12, 4)
    solver = PORT.foldin.FoldInSolver(t, l2=0.1)
    assert solver.other_factors.data_ptr() == t.data_ptr()
    assert PORT.foldin.foldin_flops([3, 5], 4, 16) == \
        JAX.foldin.foldin_flops([3, 5], 4, 16)


# ---------------------------------------------------------------------------
# overlay semantics, each package on its own memory store
# ---------------------------------------------------------------------------

def _vec(v):
    return None if v is None else np.asarray(v)


@BOTH
def test_overlay_fold_in_and_per_user_invalidation(mem_store, p):
    app = mem_store
    rng = np.random.default_rng(4)
    other = rng.normal(0, 0.3, (20, 8)).astype(np.float32)
    idx = {f"i{k}": k for k in range(20)}
    ov = p.make_overlay(app, other, idx, p.times.FakeClock())
    assert ov.enabled
    p.rate(app, "alice", "i3", 4.0)
    p.rate(app, "alice", "i7", 2.0)
    s = ov.poll()
    assert s["solved"] == 1 and s["tail_rows"] == 2
    vec = ov.lookup("alice")
    ref = dense_solve(other, [3, 7], [4.0, 2.0], 0.05)
    assert np.allclose(vec, ref, atol=1e-3)
    p.rate(app, "alice", "i1", 5.0)
    ov.poll(max_keys=0)
    assert ov.lookup("alice") is None
    assert not ov.covers("alice")
    ov.poll()
    ref2 = dense_solve(other, [3, 7, 1], [4.0, 2.0, 5.0], 0.05)
    assert np.allclose(ov.lookup("alice"), ref2, atol=1e-3)


def _twin_events(rng, n_users=12, n_items=20, n=60):
    return [(f"u{int(rng.integers(n_users))}",
             f"i{int(rng.integers(n_items))}",
             float(rng.integers(1, 6)), "buy" if k % 7 == 0 else "rate")
            for k in range(n)]


def _twin_overlays(app, other, known, **kw):
    idx = {f"i{k}": k for k in range(other.shape[0])}
    return [p.overlay.SpeedOverlay(
        p.overlay.SpeedOverlayConfig(
            app_name=app, event_names=("rate", "buy"), value_prop="rating",
            event_values={"buy": 4.0}, l2=0.05, ttl_s=30.0, **kw),
        torch.from_numpy(other) if p is PORT else other, idx,
        key_index=known, clock=p.times.FakeClock()) for p in PKGS]


def _same_polls(ovs, write, rounds, max_keys=None):
    """Poll both twins after each round of writes: equal poll dicts and
    equal vectors (1e-4 · max|x|) for every key either holds."""
    for r in range(rounds):
        for p in PKGS:
            write(p, r)
        j, t = (ov.poll(max_keys=max_keys) for ov in ovs)
        assert j.keys() == t.keys()
        for key in ("solved", "tail_rows", "cursor", "dirty", "size",
                    "lag", "reset"):
            assert j.get(key) == t.get(key), (r, key, j, t)
        keys = ovs[0].known_keys()
        assert sorted(keys) == sorted(ovs[1].known_keys())
        for k in keys:
            jv, tv = _vec(ovs[0].lookup(k)), _vec(ovs[1].lookup(k))
            assert (jv is None) == (tv is None), k
            if jv is not None:
                _close(tv, jv, k)
    return ovs


@pytest.mark.parametrize("implicit", [False, True],
                         ids=["explicit", "implicit"])
def test_overlay_twins_on_memory(mem_store, implicit):
    """The JAX overlay and the port's on twin memory stores: the same
    writes give equal poll dicts and vectors, known users' history read
    back from the store, cold users' from the tail."""
    app = mem_store
    rng = np.random.default_rng(8)
    other = rng.normal(0, 0.3, (20, 8)).astype(np.float32)
    known = {f"u{k}": k for k in range(0, 12, 3)}
    events = [_twin_events(np.random.default_rng(9 + r)) for r in range(4)]
    ovs = _twin_overlays(app, other, known, implicit=implicit, alpha=1.5)

    def write(p, r):
        for u, i, v, name in events[r]:
            p.rate(app, u, i, v, event=name)

    _same_polls(ovs, write, 4)
    _same_polls(ovs, lambda p, r: p.rate(app, "u3", "i2", 2.0), 1,
                max_keys=0)
    assert ovs[1].lookup("u3") is None
    _same_polls(ovs, lambda p, r: None, 1)
    assert ovs[1].lookup("u3") is not None


def test_overlay_twins_on_cpplog(tmp_path, monkeypatch):
    """The same on each package's native event log (metadata in SQLite,
    events in cpplog): equal poll dicts and vectors, and after a
    compaction both reset."""
    for p in PKGS:
        d = tmp_path / p.name
        p.Storage.configure({
            "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_SQL_PATH": str(d / "pio.db"),
            "PIO_STORAGE_SOURCES_LOG_TYPE": "cpplog",
            "PIO_STORAGE_SOURCES_LOG_PATH": str(d / "log"),
            "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "m",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "e",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "d",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "LOG"})
        app_id = p.Storage.get_meta_data_apps().insert(p.App(0, "logapp"))
        p.Storage.get_events().init(app_id)
    try:
        rng = np.random.default_rng(10)
        other = rng.normal(0, 0.3, (20, 8)).astype(np.float32)
        known = {f"u{k}": k for k in range(0, 12, 2)}
        events = [_twin_events(np.random.default_rng(20 + r))
                  for r in range(3)]
        ovs = _twin_overlays("logapp", other, known)
        assert all(ov.enabled for ov in ovs)

        def write(p, r):
            evs = [p.Event(event=name, entity_type="user", entity_id=u,
                           target_entity_type="item", target_entity_id=i,
                           properties=p.DataMap({"rating": v}),
                           event_time=p.times.now_utc())
                   for u, i, v, name in events[r]]
            p.store.EventStore.write(evs, "logapp")

        _same_polls(ovs, write, 3)
        assert ovs[1].stats()["foldins"] == ovs[0].stats()["foldins"] > 0
        # a compaction renumbers the log: both overlays reset and drop
        # every vector, then fold the next writes again
        for p in PKGS:
            p.Storage.get_events().delete(
                next(iter(p.Storage.get_events().find(
                    app_id=1, entity_id="u1"))).event_id, 1)
            p.Storage.get_events().compact(1)
        resets = [ov.poll() for ov in ovs]
        assert resets[0] == resets[1] and resets[0]["reset"] is True
        assert not any(ov.known_keys() for ov in ovs)
        _same_polls(ovs, lambda p, r: write(p, 0), 1)
    finally:
        for p in PKGS:
            p.Storage.reset()


@BOTH
def test_overlay_ttl_and_wholesale_invalidation(mem_store, p):
    app = mem_store
    other = np.eye(8, dtype=np.float32)
    idx = {f"i{k}": k for k in range(8)}
    clock = p.times.FakeClock()
    ov = p.make_overlay(app, other, idx, clock, ttl_s=10.0)
    p.rate(app, "bob", "i1", 4.0)
    ov.poll()
    assert ov.covers("bob")
    clock.advance(10.5)
    assert ov.lookup("bob") is None
    ov.poll()
    p.rate(app, "carol", "i2", 3.0)
    ov.poll()
    assert ov.covers("carol")
    ov.invalidate_all()
    assert not ov.covers("carol")
    assert ov.lookup("carol") is None


@BOTH
def test_overlay_key_version_bumps_on_new_events(mem_store, p):
    app = mem_store
    ov = p.make_overlay(app, np.eye(4, dtype=np.float32),
                        {f"i{k}": k for k in range(4)}, p.times.FakeClock())
    assert ov.key_version("dave") == 0
    p.rate(app, "dave", "i0", 1.0)
    ov.poll(max_keys=0)
    v1 = ov.key_version("dave")
    assert v1 >= 1
    p.rate(app, "dave", "i1", 1.0)
    ov.poll(max_keys=0)
    assert ov.key_version("dave") > v1


@BOTH
def test_overlay_cursor_reset_invalidates(mem_store, p):
    app = mem_store
    ov = p.make_overlay(app, np.eye(4, dtype=np.float32),
                        {f"i{k}": k for k in range(4)}, p.times.FakeClock())
    p.rate(app, "erin", "i0", 2.0)
    ov.poll()
    assert ov.covers("erin")
    app_id = p.Storage.get_meta_data_apps().get_by_name(app).id
    p.Storage.get_events().remove(app_id)
    p.Storage.get_events().init(app_id)
    s = ov.poll()
    assert s.get("reset") is True
    assert not ov.covers("erin")


@BOTH
def test_overlay_item_side_fold_in(mem_store, p):
    app = mem_store
    rng = np.random.default_rng(5)
    user_factors = rng.normal(0, 0.3, (10, 8)).astype(np.float32)
    ov = p.make_overlay(
        app, user_factors, {f"u{k}": k for k in range(10)},
        p.times.FakeClock(), event_names=("view",), value_prop=None,
        event_values={"view": 1.0}, key_side="target", implicit=True,
        alpha=1.0)
    for u in ("u1", "u4", "u7"):
        p.rate(app, u, "newitem", 0.0, event="view", prop=None)
    assert ov.poll()["solved"] == 1
    ref = dense_solve(user_factors, [1, 4, 7], [1.0, 1.0, 1.0], 0.05,
                      implicit=True, alpha=1.0)
    assert np.allclose(ov.lookup("newitem"), ref, atol=1e-3)


@BOTH
def test_ttl_cache_clock_and_version(p):
    clock = p.times.FakeClock()
    cache = p.cache.TTLCache(maxsize=2, ttl_s=5.0, clock=clock)
    loads = []

    def loader():
        loads.append(1)
        return "v"

    assert cache.get_or_load("k", loader, version=1) == "v"
    assert cache.get_or_load("k", loader, version=1) == "v"
    assert len(loads) == 1
    assert cache.get_or_load("k", loader, version=2) == "v"
    assert len(loads) == 2
    clock.advance(5.1)
    assert cache.get_or_load("k", loader, version=2) == "v"
    assert len(loads) == 3
    cache.put("a", 1)
    cache.put("b", 2)
    cache.put("c", 3)
    assert len(cache) == 2


def _audited(p):
    class Audited(p.overlay.SpeedOverlay):
        """Asserts the overlay lock is held for every post-init write of
        the attributes the JAX package's race fix moved under it."""

        _AUDITED = frozenset({"cursor", "last_lag", "_budget_rung"})

        def __setattr__(self, name, value):
            if name in self._AUDITED and getattr(self, "_audit_on", False):
                assert self._lock.locked(), (
                    f"write of {name} without the overlay lock")
            object.__setattr__(self, name, value)

    return Audited


@BOTH
def test_overlay_guarded_write_discipline(mem_store, p):
    app = mem_store
    ov = p.make_overlay(app, np.eye(4, dtype=np.float32),
                        {f"i{k}": k for k in range(4)}, p.times.FakeClock(),
                        cls=_audited(p))
    ov._audit_on = True
    assert ov.enabled
    p.rate(app, "zoe", "i1", 3.0)
    s = ov.poll()
    assert s["solved"] == 1
    st = ov.stats()
    assert st["cursor"] == s["cursor"]
    assert st["cursorLagEvents"] == s["lag"]
    assert st["foldinBudget"] >= 1
    app_id = p.Storage.get_meta_data_apps().get_by_name(app).id
    p.Storage.get_events().remove(app_id)
    p.Storage.get_events().init(app_id)
    s2 = ov.poll()
    assert s2.get("reset") is True
    assert ov.stats()["cursor"] == s2["cursor"]


def test_overlay_budget_rung_grows_and_collapses_as_jax(mem_store,
                                                        monkeypatch):
    """The adaptive per-poll budget: the same backlog moves both
    packages' rungs the same way."""
    app = mem_store
    other = np.random.default_rng(1).normal(size=(30, 4)).astype(np.float32)
    ovs = [p.make_overlay(app, other, {f"i{k}": k for k in range(30)},
                          p.times.FakeClock(), max_keys_per_poll=2,
                          max_keys_growth=8) for p in PKGS]
    monkeypatch.setenv("PIO_SPEED_MAX_BATCH", "4")
    rungs = []
    for r in range(5):
        for p in PKGS:
            for u in range(10 if r == 0 else 0):
                p.rate(app, f"b{u}", f"i{u}", 3.0)
        polls = [ov.poll() for ov in ovs]
        assert polls[0]["solved"] == polls[1]["solved"]
        rungs.append([ov.stats()["foldinBudget"] for ov in ovs])
    assert all(j == t for j, t in rungs), rungs
    assert max(j for j, _ in rungs) > 2 and rungs[-1][0] == 2


def test_overlay_index_sink_gets_every_publish(mem_store):
    app = mem_store
    got = []
    ov = PORT.overlay.SpeedOverlay(
        PORT.overlay.SpeedOverlayConfig(app_name=app, value_prop="rating",
                                        l2=0.05),
        torch.eye(4), {f"i{k}": k for k in range(4)},
        index_sink=lambda keys, vecs: got.append((keys, vecs)))
    PORT.rate(app, "sam", "i1", 3.0)
    PORT.rate(app, "sue", "nosuchitem", 3.0)
    assert ov.poll()["solved"] == 1
    assert [k for k, _v in got] == [["sam"]]
    np.testing.assert_array_equal(got[0][1][0], ov.lookup("sam"))


# ---------------------------------------------------------------------------
# serving integration: the port's prediction server end to end
# ---------------------------------------------------------------------------

def _call(port, method, path, body=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"} if data else {})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read() or b"null")


def _served(model, vec, num, exclude=()):
    """The plain top-k over the item table for a query vector."""
    from incubator_predictionio_tpu_torch.ops import kernels

    allowed = None
    if len(exclude):
        allowed = torch.ones(model.item_factors.shape[0], dtype=torch.bool)
        allowed[list(exclude)] = False
    s, i = kernels.score_topk_plain(
        torch.as_tensor(vec).reshape(1, -1), model.item_factors, allowed,
        num)
    inv = model.item_bimap.inverse
    return [(inv[int(k)], float(v)) for v, k in zip(s[0], i[0])
            if v > -1e37]


def test_prediction_server_speed_layer_e2e(mem_store, monkeypatch):
    """The recommendation engine trained on a memory store and deployed
    by ``PredictionServer(config=...)``: an unknown user gets nothing,
    then, after events and a poll, the plain top-k of the folded vector
    (through ``/queries.json``, ``_handle_batch`` beside base users, and
    with ``excludeSeen``); ``GET /`` reports the overlay and staleness; a
    second ``load_models()`` swaps the overlay, which re-solves the
    adopted user at its first poll."""
    from incubator_predictionio_tpu_torch.core.params import EngineParams
    from incubator_predictionio_tpu_torch.models.recommendation.engine import (
        ALSAlgorithmParams,
        DataSourceParams,
        RecommendationEngine,
    )
    from incubator_predictionio_tpu_torch.servers.prediction_server import (
        PredictionServer,
        ServerConfig,
    )
    from incubator_predictionio_tpu_torch.workflow.workflow import (
        CoreWorkflow,
    )

    app = mem_store
    rng = np.random.default_rng(7)
    for u in range(12):
        for i in rng.choice(20, 6, replace=False):
            PORT.rate(app, f"u{u}", f"i{i}", float(rng.integers(1, 6)))
    engine = RecommendationEngine().apply()
    ep = EngineParams(
        data_source_params=("", DataSourceParams(app_name=app)),
        algorithm_params_list=[("als", ALSAlgorithmParams(
            rank=4, num_iterations=5, lambda_=0.05, seed=1))])
    CoreWorkflow.run_train(engine, ep, engine_variant="speedtest",
                           device=CPU)
    monkeypatch.setenv("PIO_SPEED_POLL_S", "3600")  # poll by hand
    server = PredictionServer(engine, device=CPU, config=ServerConfig(
        ip="127.0.0.1", port=0, engine_variant="speedtest"))
    port = server.start_background()
    try:
        assert len(server._speed_overlays) == 1
        overlay = server._speed_overlays[0]
        assert overlay.solver.device.type == "cpu"
        assert overlay.solver.other_factors.data_ptr() == \
            server.models[0].item_factors.data_ptr()
        _st, r = _call(port, "POST", "/queries.json",
                       {"user": "newbie", "num": 3})
        assert r["itemScores"] == []
        for i in ("i1", "i2", "i3"):
            PORT.rate(app, "newbie", i, 5.0)
        PORT.rate(app, "u0", "i19", 1.0)          # a known user's new event
        assert overlay.poll()["solved"] == 2
        model = server.models[0]
        for user in ("newbie", "u0"):
            vec = overlay.lookup(user)
            _st, r2 = _call(port, "POST", "/queries.json",
                            {"user": user, "num": 3})
            want = _served(model, vec, 3)
            assert [x["item"] for x in r2["itemScores"]] == \
                [w[0] for w in want]
            np.testing.assert_allclose(
                [x["score"] for x in r2["itemScores"]],
                [w[1] for w in want], rtol=1e-5)
        # excludeSeen applies the model's seen set for a known user
        seen = model.user_seen[model.user_bimap["u0"]]
        _st, r3 = _call(port, "POST", "/queries.json",
                        {"user": "u0", "num": 5, "excludeSeen": True})
        assert [x["item"] for x in r3["itemScores"]] == [
            w[0] for w in _served(model, overlay.lookup("u0"), 5, seen)]
        # a batch: overlay users on the object path, base users fast
        bodies = [json.dumps({"user": u, "num": 2}).encode()
                  for u in ("newbie", "u1", "u0", "u2")]
        out = server._handle_batch(bodies, "default", "default")
        assert isinstance(out[1], bytes) and isinstance(out[3], bytes)
        assert isinstance(out[0], dict) and isinstance(out[2], dict)
        assert [x["item"] for x in out[0]["itemScores"]] == [
            w[0] for w in _served(model, overlay.lookup("newbie"), 2)]
        _st, info = _call(port, "GET", "/")
        assert info["modelStalenessSec"] >= 0
        so = info["speedOverlay"]
        st = overlay.stats()
        assert so["overlays"] == 1
        assert (so["size"], so["foldins"]) == (st["size"], st["foldins"])
        assert so["size"] >= 2 and so["foldins"] >= 2
        # the hot swap: a second load_models()
        server.load_models()
        assert not overlay.covers("newbie")       # old overlay: emptied
        assert overlay._thread is None
        new_overlay = server._speed_overlays[0]
        assert new_overlay is not overlay
        assert not new_overlay.covers("newbie")
        _st, r4 = _call(port, "POST", "/queries.json",
                        {"user": "newbie", "num": 3})
        assert r4["itemScores"] == []             # until the next poll
        assert new_overlay.poll()["solved"] == 1  # the adopted cold user
        _st, r5 = _call(port, "POST", "/queries.json",
                        {"user": "newbie", "num": 3})
        assert len(r5["itemScores"]) == 3
    finally:
        server.stop()
    assert server._speed_overlays[0]._thread is None


def test_prediction_server_no_overlay_without_a_tail(tmp_path, monkeypatch):
    """SQLite has no tail read: the server deploys with no overlay; a
    failing overlay construction raises instead of deploying without."""
    from incubator_predictionio_tpu_torch.core.params import EngineParams
    from incubator_predictionio_tpu_torch.models.recommendation import (
        engine as teng,
    )
    from incubator_predictionio_tpu_torch.servers.prediction_server import (
        PredictionServer,
        ServerConfig,
    )
    from incubator_predictionio_tpu_torch.workflow.workflow import (
        CoreWorkflow,
    )

    monkeypatch.setenv("PIO_HOME", str(tmp_path))
    for k in [k for k in __import__("os").environ
              if k.startswith("PIO_STORAGE_")]:
        monkeypatch.delenv(k)
    PORT.Storage.reset()
    try:
        PORT.Storage.get_meta_data_apps().insert(PORT.App(0, "sq"))
        app_id = PORT.Storage.get_meta_data_apps().get_by_name("sq").id
        PORT.Storage.get_events().init(app_id)
        for u in range(4):
            PORT.rate("sq", f"u{u}", f"i{u % 3}", 3.0)
        engine = teng.RecommendationEngine().apply()
        ep = EngineParams(
            data_source_params=("", teng.DataSourceParams(app_name="sq")),
            algorithm_params_list=[("als", teng.ALSAlgorithmParams(
                rank=2, num_iterations=2, seed=1))])
        CoreWorkflow.run_train(engine, ep, device=CPU)
        server = PredictionServer(engine, device=CPU,
                                  config=ServerConfig(port=0))
        server.load_models()
        assert server._speed_overlays == [None]
        assert server.status()["speedOverlay"]["overlays"] == 0

        def broken(self, *a, **kw):
            raise RuntimeError("the fold-in kernel failed")

        monkeypatch.setattr(teng.ALSAlgorithm, "make_speed_overlay", broken)
        with pytest.raises(RuntimeError, match="fold-in kernel"):
            server.load_models()
        monkeypatch.setenv("PIO_SPEED_LAYER", "0")
        server.load_models()
        assert server._speed_overlays == [None]
    finally:
        PORT.Storage.reset()


# ---------------------------------------------------------------------------
# planted cold-start workload: fold-in beats averaged recent views
# ---------------------------------------------------------------------------

def test_cold_start_recall_beats_averaged_recent_views():
    """For users the deployed model never saw, the port's implicit
    fold-in ranks strictly better than the averaged recent views it
    replaces, over the port's ``als_train_implicit`` factors."""
    from incubator_predictionio_tpu_torch.ops.als import als_train_implicit

    rng = np.random.default_rng(11)
    K0, n_items, n_train, n_cold = 4, 250, 80, 24
    u_true = rng.normal(0, 1.0, (n_train + n_cold, K0))
    v_true = rng.normal(0, 1.0, (n_items, K0))
    pref = u_true @ v_true.T

    def sample_views(u, n):
        w = np.exp(pref[u] / 1.5)
        return rng.choice(n_items, size=n, replace=False, p=w / w.sum())

    users, items = [], []
    for u in range(n_train):
        for i in sample_views(u, 25):
            users.append(u)
            items.append(i)
    state = als_train_implicit(
        np.asarray(users, np.int32), np.asarray(items, np.int32),
        np.ones(len(users), np.float32), n_users=n_train, n_items=n_items,
        rank=8, iterations=12, l2=0.05, alpha=2.0, seed=3, device=CPU)
    item_factors = state.item_factors.numpy()
    solver = PORT.foldin.FoldInSolver(state.item_factors, l2=0.05,
                                      implicit=True, alpha=2.0)
    k = 20
    fold_recall, avg_recall = [], []
    for cu in range(n_train, n_train + n_cold):
        viewed = sample_views(cu, 15)
        truth_top = [i for i in np.argsort(-pref[cu])
                     if i not in set(viewed)][:k]
        vec = solver.solve([(viewed.astype(np.int32),
                             np.ones(len(viewed), np.float32))])[0]
        for scores, acc in ((item_factors @ vec, fold_recall),
                            (item_factors @ item_factors[viewed].mean(0),
                             avg_recall)):
            s = scores.copy()
            s[viewed] = -np.inf
            acc.append(len(set(np.argsort(-s)[:k]) & set(truth_top)) / k)
    assert float(np.mean(fold_recall)) > float(np.mean(avg_recall))


# ---------------------------------------------------------------------------
# freshness (tests/test_slo.py:362-518)
# ---------------------------------------------------------------------------

@pytest.fixture
def wall():
    box = {"ms": 1_000_000}
    prevs = [p.times.set_wall_millis(lambda: box["ms"]) for p in PKGS]
    yield box
    for p, prev in zip(PKGS, prevs):
        p.times.set_wall_millis(prev)


@BOTH
def test_freshness_stages_and_histogram(wall, caplog, p):
    fr = p.freshness
    engine = f"t_fresh_{p.name}"
    tr = fr.FreshnessTracker(engine=engine)
    hist = fr.FRESHNESS_SECONDS.labels(engine=engine)
    before = hist.count
    with caplog.at_level(logging.INFO, logger="pio.trace"):
        tr.on_poll_batch({"u1": 1_000_000 - 2_000})
        tr.on_folded(["u1"], fold_wall_s=0.25)
        wall["ms"] += 500
        tr.on_serve_hit("u1")
    assert hist.count == before + 1
    assert hist.sum >= 2.4
    assert fr.POLL_LAG_SECONDS.labels(engine=engine).value == \
        pytest.approx(2.0)
    assert fr.FOLD_SECONDS.labels(engine=engine).value == \
        pytest.approx(0.25)
    assert fr.SERVE_PICKUP_SECONDS.labels(engine=engine).value == \
        pytest.approx(0.5)
    spans = [json.loads(r.getMessage()) for r in caplog.records
             if r.name == "pio.trace"]
    chain = [s for s in spans if s["span"].startswith("speed.")
             and s.get("engine") == engine]
    assert {s["span"] for s in chain} == {
        "speed.poll", "speed.foldin", "speed.serve"}
    assert len({s["traceId"] for s in chain}) == 1
    tr.on_serve_hit("u1")
    assert hist.count == before + 1


def test_freshness_families_and_buckets_match_jax():
    assert PORT.freshness.FRESHNESS_BUCKETS == JAX.freshness.FRESHNESS_BUCKETS
    assert PORT.freshness.MAX_PLAUSIBLE_AGE_S == \
        JAX.freshness.MAX_PLAUSIBLE_AGE_S
    for fam in ("FRESHNESS_SECONDS", "POLL_LAG_SECONDS", "FOLD_SECONDS",
                "SERVE_PICKUP_SECONDS"):
        a, b = getattr(PORT.freshness, fam), getattr(JAX.freshness, fam)
        assert (a.name, a.kind, a.labelnames, a._buckets) == \
            (b.name, b.kind, tuple(b.labelnames), tuple(b._buckets))
    from incubator_predictionio_tpu_torch.obs import metrics

    assert metrics.REGISTRY.get("pio_freshness_seconds") is \
        PORT.freshness.FRESHNESS_SECONDS
    h = PORT.freshness.FRESHNESS_SECONDS.labels(engine="t_buckets")
    h.observe(300.0)
    assert h.quantile(0.5) == pytest.approx(300.0, rel=0.7)
    assert h.quantile(0.5) > 13.2


def test_cpplog_count_marks_never_understate(tmp_path, wall):
    """The port's cpplog client stamps a tail by the newest count
    observation at or below its start, never a later one."""
    from incubator_predictionio_tpu_torch.data.storage import cpplog
    from incubator_predictionio_tpu_torch.data.storage.base import (
        StorageClientConfig,
    )

    client = cpplog.StorageClient(
        StorageClientConfig(properties={"PATH": str(tmp_path)}))
    try:
        path = tmp_path / "t.log"
        with client.lock:
            assert client.append_wall_since_locked(path, 0) == -1
            wall["ms"] = 1_000
            client.note_count_locked(path, 10)
            wall["ms"] = 2_000
            client.note_count_locked(path, 20)
            assert client.append_wall_since_locked(path, 10) == 1_000
            assert client.append_wall_since_locked(path, 15) == 1_000
            assert client.append_wall_since_locked(path, 20) == 2_000
            assert client.append_wall_since_locked(path, 25) == 2_000
            assert client.append_wall_since_locked(path, 0) == -1
            assert client.append_wall_since_locked(path, 9) == -1
            wall["ms"] = 3_000
            client.note_count_locked(path, 20)
            assert client.append_wall_since_locked(path, 25) == 3_000
    finally:
        client.close()


@BOTH
def test_freshness_skips_historical_backfill(wall, p):
    engine = f"t_backfill_{p.name}"
    tr = p.freshness.FreshnessTracker(engine=engine)
    hist = p.freshness.FRESHNESS_SECONDS.labels(engine=engine)
    year_ms = 365 * 24 * 3600 * 1000
    tr.on_poll_batch({"old": 1_000_000 - year_ms, "unknown": -1})
    tr.on_folded(["old", "unknown"], 0.1)
    tr.on_serve_hit("old")
    tr.on_serve_hit("unknown")
    assert hist.count == 0


@BOTH
def test_freshness_discard_and_invalidate(wall, p):
    tr = p.freshness.FreshnessTracker(engine=f"t_disc_{p.name}")
    tr.on_poll_batch({"u1": 999_000, "u2": 999_000})
    tr.discard(["u1"])
    assert tr.stats()["pendingAppend"] == 1
    tr.invalidate()
    assert tr.stats() == {"pendingAppend": 0, "awaitingServe": 0}


@BOTH
def test_overlay_freshness_end_to_end(wall, mem_store, p):
    """rate → poll → fold → lookup hit books one
    ``pio_freshness_seconds`` observation spanning the planted 4 s."""
    engine = f"t_e2e_{p.name}"
    other = np.random.default_rng(0).normal(0, 0.3, (5, 4)).astype(
        np.float32)
    overlay = p.make_overlay(mem_store, other,
                             {f"i{k}": k for k in range(5)}, None,
                             engine=engine, l2=0.1)
    hist = p.freshness.FRESHNESS_SECONDS.labels(engine=engine)
    before = hist.count
    p.rate(mem_store, "cold1", "i2", 4.0)
    wall["ms"] += 3_000
    overlay.poll()
    wall["ms"] += 1_000
    assert overlay.lookup("cold1") is not None
    assert hist.count == before + 1
    assert hist.sum >= 3.9
    assert overlay.freshness.stats() == {"pendingAppend": 0,
                                         "awaitingServe": 0}
