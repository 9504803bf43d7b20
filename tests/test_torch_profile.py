"""The port's ``PIO_PROFILE`` device profiler (``obs/profile.py``) against
the JAX package's, on the CPU.

Twins of tests/test_slo.py's five profiler tests and of its
``test_profile_route_validation``, the route mounted on a bare ``Router``
(tests/test_torch_admin.py holds the route on the port's admin
server). Then one test per op label of
this slice: the same workload, on the same inputs made from a seed with
numpy, through both packages with the profiler on, books the same
dispatches and the same ``pio_device_flops_total`` under the same label:
``serve_topk``, ``serve_topk_batch``, ``serve_topk_mips``,
``serve_topk_mips_batch``, ``als_fused`` and ``als_train``, ``als_fused``
and ``als_retrain`` for the retrain, ``foldin_solve``. The JAX kernel
paths run as its own tests run them on the CPU (``_ALS_KERNEL`` "on" and
``PIO_ALS_FUSED_GRAM=on``, Pallas in interpret mode). The FLOP counts are
the JAX package's formulas on shapes, so they agree exactly. The port's
implicit trainer books a dispatch the JAX package's does not; it is held
to ``train_flops`` alone. ``capture_trace`` writes a Chrome trace that
parses, on the CPU, with the CPU activity alone.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from incubator_predictionio_tpu.obs import profile as jprofile
from incubator_predictionio_tpu.ops import als as jals
from incubator_predictionio_tpu.ops import mips as jmips
from incubator_predictionio_tpu.ops import retrain as jretrain
from incubator_predictionio_tpu.ops import topk as jtopk
from incubator_predictionio_tpu.speed import foldin as jfoldin
from incubator_predictionio_tpu_torch.obs import profile as obs_profile
from incubator_predictionio_tpu_torch.obs.http import add_profile_route
from incubator_predictionio_tpu_torch.ops import als, mips, retrain, topk
from incubator_predictionio_tpu_torch.speed import foldin
from incubator_predictionio_tpu_torch.utils.http import HttpServer, Router


@pytest.fixture
def profiling(monkeypatch):
    monkeypatch.setenv("PIO_PROFILE", "1")


def booked(mod, op):
    """(dispatches, FLOPs) ``mod``'s profiler has booked under ``op``."""
    return (mod.DEVICE_DISPATCHES.labels(op=op).value,
            mod.DEVICE_FLOPS.labels(op=op).value)


def delta(op, run_port, run_jax):
    """Run each side once; each side's (dispatches, FLOPs) booked under
    ``op`` by that run."""
    out = []
    for mod, run in ((obs_profile, run_port), (jprofile, run_jax)):
        d0, f0 = booked(mod, op)
        run()
        d1, f1 = booked(mod, op)
        out.append((d1 - d0, f1 - f0))
    return out


# -- twins of tests/test_slo.py's profiler tests ------------------------------

def test_profiler_off_by_default(monkeypatch):
    monkeypatch.delenv("PIO_PROFILE", raising=False)
    assert obs_profile.enabled() is False
    assert obs_profile.t0() is None
    obs_profile.record(None, "train", "x", 1e9, object())
    monkeypatch.setenv("PIO_PROFILE", "off")
    assert obs_profile.t0() is None


def test_profiler_attribution_and_mfu(monkeypatch, profiling):
    monkeypatch.setenv("PIO_BENCH_PEAK_FLOPS", "1e12")
    t0 = obs_profile.t0()
    assert t0 is not None
    d0, f0 = booked(obs_profile, "t_op")
    obs_profile.record(t0, "t_phase", "t_op", 2e9)
    assert booked(obs_profile, "t_op") == (d0 + 1, f0 + 2e9)
    secs = obs_profile.DEVICE_SECONDS.labels(op="t_op").value
    assert secs > 0
    mfu = obs_profile.MFU.labels(phase="t_phase").value
    assert mfu > 0


def test_peak_flops_is_the_h100s(monkeypatch):
    """The MFU divisor is the H100's f32 rate (3xTF32), never the TPU's;
    ``PIO_BENCH_PEAK_FLOPS`` overrides it."""
    monkeypatch.delenv("PIO_BENCH_PEAK_FLOPS", raising=False)
    assert obs_profile.peak_flops() == obs_profile.H100_F32_PEAK_FLOPS
    assert obs_profile.H100_F32_PEAK_FLOPS == pytest.approx(165e12)
    assert obs_profile.peak_flops() != jprofile.peak_flops()
    monkeypatch.setenv("PIO_BENCH_PEAK_FLOPS", "2e12")
    assert obs_profile.peak_flops() == 2e12
    monkeypatch.setenv("PIO_BENCH_PEAK_FLOPS", "nonsense")
    assert obs_profile.peak_flops() == obs_profile.H100_F32_PEAK_FLOPS


def test_telemetry_never_fails_the_dispatch(profiling):
    def boom():
        raise RuntimeError("flops unavailable")

    d0, _f0 = booked(obs_profile, "t_boom")
    obs_profile.record(obs_profile.t0(), "t", "t_boom", flops_fn=boom)
    assert booked(obs_profile, "t_boom")[0] == d0  # logged, not booked
    # CPU results need no wait; nested containers are walked
    obs_profile.record(obs_profile.t0(), "t", "t_ok", 1.0,
                       result={"a": [torch.zeros(2), (torch.ones(1),)],
                               "b": als.ALSState(torch.zeros(1, 1),
                                                 torch.zeros(1, 1))})
    assert booked(obs_profile, "t_ok")[0] >= 1
    assert obs_profile._cuda_devices(
        [torch.zeros(1), {"x": torch.zeros(1)}], set()) == set()


def test_profiled_foldin_books_device_time(profiling):
    rng = np.random.default_rng(0)
    other = rng.normal(0, 0.3, (20, 4)).astype(np.float32)
    solver = foldin.FoldInSolver(other, l2=0.1, device="cpu")
    d0, _ = booked(obs_profile, "foldin_solve")
    solver.solve([(np.asarray([1, 2], np.int32),
                   np.asarray([1.0, 2.0], np.float32))])
    assert booked(obs_profile, "foldin_solve")[0] == d0 + 1
    assert obs_profile.MFU.labels(phase="foldin").value > 0


def test_train_flops_matches_bench_convention(monkeypatch):
    f = als.train_flops(1000, 50, 40, 8, 4, 0)
    assert f > 0
    assert als.train_flops(1000, 50, 40, 8, 8, 0) == pytest.approx(2 * f)
    assert als.train_flops(2000, 50, 40, 8, 4, 0) > f
    # the JAX package's formula, term for term, across the settings it
    # reads: each package's warm-start flag, bf16 budget and solver set
    # alike (the port reads PIO_ALS_SOLVER per call, JAX at import)
    for args, setting, kw in (
            ((1000, 50, 40, 8, 4, 0), {}, {}),
            ((12345, 70, 33, 16, 5, 2), {}, {}),
            ((500, 9, 9, 4, 3, 1), {"warmstart": False}, {}),
            ((500, 9, 9, 4, 3, 2), {"bf16_iters": 6}, {}),
            ((500, 9, 9, 4, 3, 1), {"solver": "cholesky"}, {}),
            ((500, 9, 9, 4, 3, 0), {}, {"cg_iters": 32})):
        with monkeypatch.context() as m:
            if "warmstart" in setting:
                m.setattr(als, "CG_WARMSTART", setting["warmstart"])
                m.setattr(jals, "_CG_WARMSTART", setting["warmstart"])
            if "bf16_iters" in setting:
                m.setattr(als, "CG_ITERS_BF16", setting["bf16_iters"])
                m.setattr(jals, "_CG_ITERS_BF16", setting["bf16_iters"])
            if "solver" in setting:
                m.setenv("PIO_ALS_SOLVER", setting["solver"])
                m.setattr(jals, "_SOLVER", setting["solver"])
            assert als.train_flops(*args, **kw) == \
                jals.train_flops(*args, **kw), (args, setting, kw)


def _coo(seed=3, n=400, n_users=24, n_items=16):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_users, n).astype(np.int32),
            rng.integers(0, n_items, n).astype(np.int32),
            rng.normal(3.5, 1.0, n).astype(np.float32))


def test_fused_train_books_under_its_own_op_label(profiling):
    """The kernel entries book ``als_fused``, the plain route
    ``als_train``, each one dispatch a run, at the same FLOPs."""
    users, items, ratings = _coo()
    trees = als.prepare_trees(users, items, ratings, 24, 16, device="cpu")
    u_tree, i_tree, u_hv, i_hv = trees
    state = als.als_init(torch.Generator().manual_seed(0), 24, 16, 4,
                         device="cpu")
    runs = {}
    for use_kernel, op in ((True, "als_fused"), (False, "als_train")):
        d0, f0 = booked(obs_profile, op)
        als._mixed_run(state, u_tree, i_tree, 0.1, 2, 1, True,
                       torch.float32, u_hv, i_hv, use_kernel=use_kernel)
        d1, f1 = booked(obs_profile, op)
        runs[op] = (d1 - d0, f1 - f0)
    assert runs["als_fused"] == runs["als_train"]
    assert runs["als_fused"][0] == 1
    assert runs["als_fused"][1] == als.train_flops(len(ratings), 24, 16, 4,
                                                   2, 1)


def _route_server():
    r = Router()
    add_profile_route(r)
    return HttpServer(r, "127.0.0.1", 0, name="admin")


def _post(port, path):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=b"", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def test_profile_route_validation():
    srv = _route_server()
    port = srv.start_background()
    try:
        assert _post(port, "/profile?seconds=abc")[0] == 400
        assert _post(port, "/profile?seconds=0")[0] == 400
        assert _post(port, "/profile?seconds=9999")[0] == 400
        # a capture in flight answers 409, never a second profiler
        assert obs_profile._capture_lock.acquire(blocking=False)
        try:
            assert _post(port, "/profile?seconds=1")[0] == 409
        finally:
            obs_profile._capture_lock.release()
    finally:
        srv.stop()


def test_profile_route_captures_and_a_failed_capture_is_500(
        tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_PROFILE_DIR", str(tmp_path / "cap"))
    srv = _route_server()
    port = srv.start_background()
    try:
        status, out = _post(port, "/profile?seconds=0.2")
        assert status == 200 and out["seconds"] == 0.2
        with open(os.path.join(out["traceDir"],
                               obs_profile.TRACE_FILE)) as f:
            assert "traceEvents" in json.load(f)

        def broken(seconds, out_dir=None):
            raise OSError("no room for the trace")

        monkeypatch.setattr(obs_profile, "capture_trace", broken)
        status, out = _post(port, "/profile?seconds=1")
        assert status == 500 and "no room" in out["message"]

        def profiler_failed(seconds, out_dir=None):
            raise RuntimeError("the profiler could not start")

        # torch's own RuntimeError is a failed capture, not a busy one
        monkeypatch.setattr(obs_profile, "capture_trace", profiler_failed)
        status, out = _post(port, "/profile?seconds=1")
        assert status == 500 and "could not start" in out["message"]
    finally:
        srv.stop()


def test_capture_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    """The window records the CPU operators another thread runs, into
    one Chrome trace JSON; the temp dir exists only once the capture is
    this caller's."""
    started, stop = threading.Event(), threading.Event()

    def work():
        a = torch.ones(64, 64)
        while not stop.is_set():
            a = torch.mm(a, a).clamp_(max=1.0)
            started.set()

    t = threading.Thread(target=work, daemon=True)
    t.start()
    try:
        assert started.wait(10)
        out = obs_profile.capture_trace(0.3, str(tmp_path / "t"))
    finally:
        stop.set()
        t.join(timeout=10)
    assert out == {"traceDir": str(tmp_path / "t"), "seconds": 0.3}
    with open(tmp_path / "t" / obs_profile.TRACE_FILE) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names
    with pytest.raises(ValueError):
        obs_profile.capture_trace(0)
    with pytest.raises(ValueError):
        obs_profile.capture_trace(121)
    assert obs_profile._capture_lock.acquire(blocking=False)
    try:
        before = set(os.listdir(tmp_path))
        with pytest.raises(RuntimeError):
            obs_profile.capture_trace(1)
        assert set(os.listdir(tmp_path)) == before
    finally:
        obs_profile._capture_lock.release()


def test_a_trace_that_lost_the_cards_kernels_fails_the_capture(
        tmp_path, monkeypatch):
    """A trace whose recorded kernel launches mostly lack their kernels
    fails the capture with a RuntimeError (the route's 500), never a
    trace handed back as if the card had been idle; a sound trace that
    misses the launches of its last instant passes."""

    def launch(c):
        return {"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "args": {"correlation": c}}

    def kernel(c):
        return {"cat": "kernel", "name": "tile_topk_kernel",
                "args": {"correlation": c}}

    # a sound trace: all but the last few launches have their kernels
    sound = [launch(c) for c in range(1000)] + [kernel(c)
                                                for c in range(975)]
    assert obs_profile.lost_kernels(sound) is None
    assert obs_profile.lost_kernels([{"cat": "cpu_op"}]) is None
    # one of two launching threads lost: half the kernels are missing
    half = [launch(c) for c in range(800)] + [kernel(c)
                                              for c in range(0, 800, 2)]
    assert "800 kernel launches, 400 of them" in \
        obs_profile.lost_kernels(half)
    lost = [launch(c) for c in range(10)] + [kernel(0)]
    assert "10 kernel launches, 9 of them" in obs_profile.lost_kernels(lost)
    monkeypatch.setattr(obs_profile, "lost_kernels",
                        lambda events: "every launch without its kernel")
    with pytest.raises(RuntimeError, match="without its kernel") as e:
        obs_profile.capture_trace(0.05, str(tmp_path / "lost"))
    assert not isinstance(e.value, obs_profile.CaptureBusy)


# -- one op label a test: the same workload books the same FLOPs in both ----

N_USERS, N_ITEMS, RANK = 40, 300, 8


@pytest.fixture(scope="module")
def factors():
    rng = np.random.default_rng(11)
    return (rng.normal(0, 0.3, (N_USERS, RANK)).astype(np.float32),
            rng.normal(0, 0.3, (N_ITEMS, RANK)).astype(np.float32))


def test_serve_topk_books_equal_flops(profiling, factors):
    uf, vf = factors
    tu, tv = torch.from_numpy(uf), torch.from_numpy(vf)
    ju, jv = jax.numpy.asarray(uf), jax.numpy.asarray(vf)

    def port():
        topk.score_user_and_top_k(tu, tv, 3, 10)
        topk.score_and_top_k(tu[5], tv, 7)

    def jax_side():
        np.asarray(jtopk.score_user_and_top_k(ju, jv, 3, 10))
        np.asarray(jtopk.score_and_top_k(ju[5], jv, 7))

    got, ref = delta("serve_topk", port, jax_side)
    assert got == ref == (2, 2 * 2.0 * N_ITEMS * RANK)


def test_serve_topk_batch_books_equal_flops(profiling, factors):
    uf, vf = factors
    rows = [1, 4, 9, 16, 25]
    got, ref = delta(
        "serve_topk_batch",
        lambda: topk.batch_score_top_k(torch.from_numpy(uf),
                                       torch.from_numpy(vf), rows, 10),
        lambda: np.asarray(jtopk.batch_score_top_k(
            jax.numpy.asarray(uf), jax.numpy.asarray(vf), rows, 10)))
    assert got == ref == (1, 2.0 * len(rows) * RANK * N_ITEMS)


@pytest.fixture
def jax_kernel_path(monkeypatch):
    """The JAX package's kernel path, as its own tests take it on the
    CPU (tests/test_slo.py)."""
    monkeypatch.setattr(jals, "_ALS_KERNEL", "on")
    monkeypatch.setattr(jals, "_KERNEL_MIN_D", 0)
    monkeypatch.setenv("PIO_ALS_FUSED_GRAM", "on")


def test_als_fused_books_equal_flops(profiling, jax_kernel_path):
    users, items, ratings = _coo()
    kw = dict(n_users=24, n_items=16, rank=4, iterations=2, l2=0.1)
    got, ref = delta(
        "als_fused",
        lambda: als.als_train(users, items, ratings, bf16_sweeps=1,
                              device="cpu", **kw),
        lambda: jals.als_train(users, items, ratings, bf16_sweeps=1, **kw))
    assert got == ref and got[0] == 1
    assert got[1] == als.train_flops(len(ratings), 24, 16, 4, 2, 1)


def test_als_train_plain_route_books_equal_flops(profiling, monkeypatch):
    monkeypatch.setattr(jals, "_ALS_KERNEL", "off")
    users, items, ratings = _coo(seed=5)
    port_trees = als.prepare_trees(users, items, ratings, 24, 16,
                                   device="cpu")
    state = als.als_init(torch.Generator().manual_seed(0), 24, 16, 4,
                         device="cpu")
    kw = dict(n_users=24, n_items=16, rank=4, iterations=3, l2=0.1)
    got, ref = delta(
        "als_train",
        lambda: als._mixed_run(state, port_trees[0], port_trees[1], 0.1, 3,
                               0, True, torch.float32, port_trees[2],
                               port_trees[3], use_kernel=False),
        lambda: jals.als_train(users, items, ratings, **kw))
    assert got == ref and got[0] == 1


@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_als_retrain_books_equal_flops(profiling, monkeypatch, route):
    """A fixed-schedule retrain (no previous state, ``tol`` 0) books one
    dispatch over the sweeps it ran: ``als_fused`` on the kernel entries,
    ``als_retrain`` on the plain route, in both packages."""
    monkeypatch.setenv("PIO_RETRAIN_PLAN", "0")
    if route == "kernel":
        monkeypatch.setattr(jals, "_ALS_KERNEL", "on")
        monkeypatch.setattr(jals, "_KERNEL_MIN_D", 0)
        monkeypatch.setenv("PIO_ALS_FUSED_GRAM", "on")
    else:
        monkeypatch.setattr(jals, "_ALS_KERNEL", "off")
    users, items, ratings = _coo(seed=9)
    kw = dict(n_users=24, n_items=16, rank=4, iterations=3, l2=0.1,
              bf16_sweeps=1, tol=0.0)
    op = "als_fused" if route == "kernel" else "als_retrain"
    got, ref = delta(
        op,
        lambda: retrain.als_retrain(users, items, ratings, device="cpu",
                                    use_kernel=route == "kernel", **kw),
        lambda: jretrain.als_retrain(users, items, ratings, **kw))
    assert got == ref and got[0] == 1
    assert got[1] == als.train_flops(len(ratings), 24, 16, 4, 3, 1)


def test_implicit_train_books_train_flops(profiling):
    """The port's implicit trainer books one ``als_fused`` dispatch at
    ``train_flops`` with the doubled CG budget its solves run (the JAX
    package's implicit trainer books none)."""
    users, items, _r = _coo(seed=4)
    weights = np.ones(len(users), np.float32)
    trees = als.prepare_trees(users, items, weights, 24, 16, device="cpu")
    nnz = als.tree_nnz(trees[0], trees[2])
    d0, f0 = booked(obs_profile, "als_fused")
    als.als_train_implicit(users, items, weights, 24, 16, rank=4,
                           iterations=2, device="cpu")
    d1, f1 = booked(obs_profile, "als_fused")
    assert d1 - d0 == 1
    assert f1 - f0 == als.train_flops(nnz, 24, 16, 4, 2,
                                      cg_iters=2 * als.CG_ITERS)


def test_foldin_solve_books_equal_flops(profiling):
    """One dispatch per (width, batch) bucket, at ``foldin_flops`` of
    its rows' degrees, in both packages."""
    rng = np.random.default_rng(2)
    other = rng.normal(0, 0.3, (50, RANK)).astype(np.float32)
    rows = [(rng.integers(0, 50, d).astype(np.int32),
             rng.normal(3, 1, d).astype(np.float32))
            for d in (1, 3, 8, 9, 20, 33, 40, 0, 5)]
    tsolver = foldin.FoldInSolver(other, l2=0.1, device="cpu")
    jsolver = jfoldin.FoldInSolver(other, l2=0.1)
    got, ref = delta("foldin_solve", lambda: tsolver.solve(rows),
                     lambda: jsolver.solve(rows))
    assert got == ref and got[0] == 3  # widths 8, 32 and 128


def test_serve_topk_mips_books_equal_flops(profiling, monkeypatch):
    """Both packages' two-stage entries on one index (the JAX package's
    build carried across, as tests/test_torch_mips.py carries it)."""
    from test_torch_mips import carry

    from incubator_predictionio_tpu_torch.utils.planted import (
        planted_item_factors,
    )

    monkeypatch.setenv("PIO_SERVE_MIPS", "on")
    vf = planted_item_factors(4096, 16, seed=3)
    uf = np.random.default_rng(4).normal(0, 1, (32, 16)).astype(np.float32)
    jtab = jax.device_put(vf.copy())
    ji = jmips.build_index(jtab, 4096, seed=3)
    ttab = torch.from_numpy(vf.copy())
    ti = carry(ji, ttab)
    tu, ju = torch.from_numpy(uf), jax.numpy.asarray(uf)
    try:
        got, ref = delta(
            "serve_topk_mips",
            lambda: (mips.mips_score_user_and_top_k(tu, ttab, ti, 3, 20),
                     mips.mips_score_and_top_k(tu[4], ttab, ti, 20)),
            lambda: (jmips.mips_score_user_and_top_k(ju, jtab, ji, 3, 20),
                     jmips.mips_score_and_top_k(ju[4], jtab, ji, 20)))
        assert got == ref and got[0] == 2 and got[1] > 0
        rows = np.arange(8)
        got, ref = delta(
            "serve_topk_mips_batch",
            lambda: mips.mips_batch_score_top_k(tu, ttab, ti, rows, 20),
            lambda: jmips.mips_batch_score_top_k(ju, jtab, ji, rows, 20))
        assert got == ref and got[0] == 1 and got[1] > 0
    finally:
        mips.unregister_index(ttab)
        jmips.unregister_index(jtab)
