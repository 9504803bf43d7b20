#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's recommendation serving on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run on any error or mismatch:

1. card   — requires CUDA; prints the card's name and power limit as
            ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
            gives them; turns TF32 off.
2. build  — compiles the port's CUDA sources (``runtime.build_kernels``).
3. kernel — the score+top-k kernel against its plain PyTorch version on the
            card: the reference's four kernel test cases, duplicate-row ties,
            the ML-20M width (26,744 items x rank 128) and a 1,048,576-item
            rank-64 catalogue. Ids must agree except among near-ties (plain
            scores within 1e-5 relative); scores to rtol 1e-5 and
            atol 1e-5 * max|score|.
4. path   — a planted ALSModel at ML-20M width (138,493 users x 26,744
            items x rank 128), served by the port's PredictionServer: 32 HTTP
            queries to /queries.json and one 64-body batch through
            ``_handle_batch``, every answer checked against the plain version
            on the same factors, and the kernel's launch count read.
5. report — kernel, plain-version and ``torch.topk`` times (CUDA events,
            median of 30 after warm-up) beside the bound, as one
            ``{"kernels": [...]}`` line; then the last line,
            ``{"ok": true, "device": {...}}``.

The bound is max(bytes / 3.35 TB/s, 2*B*I*K / 67 TFLOP/s): H100 SXM HBM3
and f32 without tensor cores (the TPU kernel computes in full f32), from
NVIDIA's data sheet at 700 W; bytes count each input read once and each
output written once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
ML20M = dict(users=138_493, items=26_744, rank=128)
MIPS_CATALOGUE = dict(items=1_048_576, rank=64)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# -- comparison with the plain version ---------------------------------------

def check_topk(got_s, got_i, ref_s, ref_i, k: int, what: str) -> float:
    """Kernel (got, [B, k]) against the plain version (ref, [B, >= k]; one
    extra column shows a near-tie at the cut). Returns the largest score
    error over live slots."""
    got_s, got_i = np.asarray(got_s, np.float64), np.asarray(got_i)
    ref_s, ref_i = np.asarray(ref_s, np.float64), np.asarray(ref_i)
    live = ref_s[:, :k] > -1e37
    if not np.array_equal(got_s > -1e37, live):
        raise AssertionError(f"{what}: filler slots differ")
    if (got_i[~live] != -1).any():
        raise AssertionError(f"{what}: a filler slot carries an id")
    if not live.any():
        return 0.0
    atol = 1e-5 * np.abs(ref_s[:, :k][live]).max()
    err = np.abs(got_s - ref_s[:, :k])[live]
    if (err > 1e-5 * np.abs(ref_s[:, :k][live]) + atol).any():
        raise AssertionError(f"{what}: scores differ by up to {err.max()}")
    for b, p in zip(*np.nonzero((got_i != ref_i[:, :k]) & live)):
        near = [q for q in (p - 1, p + 1) if 0 <= q < ref_s.shape[1]
                and abs(ref_s[b, q] - ref_s[b, p])
                <= 1e-5 * abs(ref_s[b, p]) + atol]
        if not near:
            raise AssertionError(
                f"{what}: row {b} slot {p}: id {got_i[b, p]} against "
                f"{ref_i[b, p]} with no near-tie")
    for b in range(got_i.shape[0]):
        ids = got_i[b][live[b]]
        if len(set(ids.tolist())) != len(ids):
            raise AssertionError(f"{what}: row {b} repeats an id")
    return float(err.max())


def _kernel_vs_plain(kernels, q, items, allowed, k, what) -> float:
    got_s, got_i = kernels.score_topk(q, items, allowed, k)
    ref_s, ref_i = kernels.score_topk_plain(
        q, items, allowed, min(k + 1, items.shape[0]))
    torch.cuda.synchronize()
    return check_topk(got_s.cpu(), got_i.cpu(), ref_s.cpu(), ref_i.cpu(), k,
                      what)


def kernel_phase(dev, kernels, planted, small: bool = False):
    """Every kernel-vs-plain case; returns (max error, #cases)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    rng = np.random.default_rng(0)
    cases = []
    # tests/test_pallas_kernels.py:27-78, exclusions folded into the mask
    items = rng.standard_normal((500, 24), np.float32)
    cases.append(("matches_reference", rng.standard_normal((1, 24),
                                                           np.float32),
                  items, None, 7))
    items = rng.standard_normal((300, 16), np.float32)
    mask = np.ones(300, bool)
    mask[:250] = False
    cases.append(("exclusions", rng.standard_normal((1, 16), np.float32),
                  items, mask, 5))
    items = rng.standard_normal((260, 8), np.float32)
    mask = np.ones(260, bool)
    mask[::3] = False
    mask[[7, 11]] = False
    cases.append(("mask_and_exclude", rng.standard_normal((1, 8), np.float32),
                  items, mask, 4))
    items = rng.standard_normal((40, 8), np.float32)
    mask = np.zeros(40, bool)
    mask[:3] = True
    cases.append(("k_exceeding_allowed",
                  rng.standard_normal((1, 8), np.float32), items, mask, 6))
    base = rng.integers(-3, 4, (700, 16)).astype(np.float32)
    items = np.concatenate([base, base, base])[rng.permutation(2100)]
    cases.append(("duplicate_row_ties",
                  rng.integers(-3, 4, (3, 16)).astype(np.float32), items,
                  None, 20))
    # a rank that is no multiple of 4 takes the kernel's scalar loads
    cases.append(("odd_rank", rng.standard_normal((5, 10), np.float32),
                  rng.standard_normal((3000, 10), np.float32), None, 50))
    n_items, rank = ML20M["items"], ML20M["rank"]
    if small:
        n_items = 3000
    items = planted.planted_item_factors(n_items, rank, seed=11)
    for b in (1, 64):
        q = planted.planted_queries(items, b, seed=12 + b)
        for k in (10, 100, 128):
            cases.append((f"ml20m_b{b}_k{k}", q, items, None, k))
    mask = rng.random(n_items) > 0.3
    cases.append(("ml20m_b64_k128_masked",
                  planted.planted_queries(items, 64, seed=20), items, mask,
                  128))
    n_items, rank = MIPS_CATALOGUE["items"], MIPS_CATALOGUE["rank"]
    if small:
        n_items = 5000
    items = planted.planted_item_factors(n_items, rank, seed=21)
    for b in (1, 64):
        cases.append((f"mips1m_b{b}_k128",
                      planted.planted_queries(items, b, seed=22 + b), items,
                      None, 128))
    err = 0.0
    for what, q, items, mask, k in cases:
        err = max(err, _kernel_vs_plain(
            kernels, t(q), t(items), None if mask is None else t(mask), k,
            what))
    return err, len(cases)


# -- the main path -------------------------------------------------------------

def build_model(planted, convert, dev, users: int, n_items: int, rank: int,
                seen_users: int = 1000, seen_len: int = 70):
    items = planted.planted_item_factors(n_items, rank, seed=1)
    uf = planted.planted_queries(items, users, seed=2)
    rng = np.random.default_rng(3)
    seen = {int(u): np.sort(rng.choice(n_items, seen_len, replace=False))
            for u in rng.choice(users, seen_users, replace=False)}
    years = {f"i{i}": int(y)
             for i, y in enumerate(rng.integers(1950, 2016, n_items))}
    model = convert.als_model_from_numpy(
        uf, items, [f"u{i}" for i in range(users)],
        [f"i{i}" for i in range(n_items)], item_years=years, user_seen=seen,
        device=dev)
    return model, uf, items, seen


def path_queries(rng, users: int, n_items: int, seen) -> list:
    """The 32 query bodies of the path phase: (doc, allowed-or-None)."""
    docs = []
    pick = rng.choice(users, 24, replace=False)
    for u in pick[:8]:
        docs.append(({"user": f"u{u}", "num": 10}, None))
    for u in pick[8:14]:
        docs.append(({"user": f"u{u}", "num": 100}, None))
    for u in list(seen)[:6]:
        mask = np.ones(n_items, bool)
        mask[seen[u]] = False
        docs.append(({"user": f"u{u}", "num": 20, "excludeSeen": True},
                     mask))
    for u in pick[14:18]:
        black = rng.choice(n_items, 50, replace=False)
        mask = np.ones(n_items, bool)
        mask[black] = False
        docs.append(({"user": f"u{u}", "num": 10,
                      "blacklist": [f"i{i}" for i in black] + ["nosuch"]},
                     mask))
    for u in pick[18:22]:
        white = rng.choice(n_items, 200, replace=False)
        mask = np.zeros(n_items, bool)
        mask[white] = True
        docs.append(({"user": f"u{u}", "num": 10,
                      "whitelist": [f"i{i}" for i in white]}, mask))
    docs += [({"user": "nosuch-1", "num": 10}, None),
             ({"user": "nosuch-2", "num": 5}, None)]
    for u in pick[22:24]:
        docs.append(({"user": f"u{u}", "num": 0}, None))
    return docs


def check_answer(kernels, dev, uf_t, items_t, doc, mask, body, what) -> float:
    """One served answer against the plain version on the same factors."""
    got = body["itemScores"]
    num = doc["num"]
    if doc["user"].startswith("nosuch") or num <= 0:
        if got:
            raise AssertionError(f"{what}: expected no items, got {len(got)}")
        return 0.0
    row = int(doc["user"][1:])
    allowed = None if mask is None else torch.from_numpy(mask).to(dev)
    n_live = num if mask is None else min(num, int(mask.sum()))
    ref_s, ref_i = kernels.score_topk_plain(
        uf_t[row:row + 1], items_t, allowed, min(num + 1, items_t.shape[0]))
    if len(got) != n_live:
        raise AssertionError(f"{what}: {len(got)} items, expected {n_live}")
    got_s = np.array([[x["score"] for x in got]])
    got_i = np.array([[int(x["item"][1:]) for x in got]])
    return check_topk(got_s, got_i, ref_s.cpu()[:, :n_live + 1],
                      ref_i.cpu()[:, :n_live + 1], n_live, what)


def post(port: int, doc) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(doc).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        if resp.status != 200:
            raise AssertionError(f"HTTP {resp.status} for {doc}")
        return json.loads(resp.read())


def path_phase(dev, runtime, kernels, planted, convert, engine, params_mod,
               server_mod, users, n_items, rank):
    """Serve the main path; returns (kernel launches, max error, stats)."""
    model, uf, items, seen = build_model(planted, convert, dev, users,
                                         n_items, rank)
    uf_t = torch.from_numpy(uf).to(dev)
    items_t = torch.from_numpy(items).to(dev)
    srv = server_mod.PredictionServer(
        engine.RecommendationEngine().apply(),
        params_mod.EngineParams(algorithm_params_list=[
            ("als", engine.ALSAlgorithmParams(rank=rank))]),
        [model], device=dev)
    port = srv.start_background()
    try:
        rng = np.random.default_rng(4)
        docs = path_queries(rng, users, n_items, seen)
        batch_rows = rng.choice(users, 64, replace=False)
        batch_docs = [{"user": f"u{u}", "num": 10} for u in batch_rows]
        runtime.reset_launch_counts()
        walls, answers = [], []
        for doc, _mask in docs:
            t0 = time.perf_counter()
            answers.append(post(port, doc))
            walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        batch_out = srv._handle_batch(
            [json.dumps(d).encode() for d in batch_docs])
        batch_wall = time.perf_counter() - t0
        counts = runtime.launch_counts()
    finally:
        srv.stop()
    err = 0.0
    for i, ((doc, mask), body) in enumerate(zip(docs, answers)):
        err = max(err, check_answer(kernels, dev, uf_t, items_t, doc, mask,
                                    body, f"http query {i} {list(doc)}"))
    for i, (doc, res) in enumerate(zip(batch_docs, batch_out)):
        if not isinstance(res, (bytes, bytearray)):
            raise AssertionError(f"batch body {i} left the fast path: {res!r}")
        err = max(err, check_answer(kernels, dev, uf_t, items_t, doc, None,
                                    json.loads(res), f"batch body {i}"))
    device_queries = sum(1 for d, _m in docs
                         if not d["user"].startswith("nosuch") and d["num"] > 0)
    if counts["score_topk"] < device_queries + 1:
        raise AssertionError(
            f"score_topk launched {counts['score_topk']} times on the path; "
            f"{device_queries} device queries and one batch need at least "
            f"{device_queries + 1}")
    stats = {"http_queries": len(docs), "device_queries": device_queries,
             "http_p50_ms": 1e3 * statistics.median(walls),
             "http_max_ms": 1e3 * max(walls),
             "batch64_ms": 1e3 * batch_wall, "counts": counts}
    return counts["score_topk"], err, stats


# -- timing --------------------------------------------------------------------

def median_ms(fn, reps: int = 30, warm: int = 5) -> float:
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(b: int, n_items: int, rank: int, k: int, masked: bool):
    nbytes = 4 * n_items * rank + 4 * b * rank + 8 * b * k \
        + (n_items if masked else 0)
    flops = 2.0 * b * n_items * rank
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_shape(kernels, planted, dev, b, n_items, rank, k) -> dict:
    items_np = planted.planted_item_factors(n_items, rank, seed=31)
    q = torch.from_numpy(planted.planted_queries(items_np, b, seed=32)).to(dev)
    items = torch.from_numpy(items_np).to(dev)
    bound_ms, bound_by = bound(b, n_items, rank, k, masked=False)
    return {
        "B": b, "I": n_items, "K": rank, "k": k,
        "ms": median_ms(lambda: kernels.score_topk(q, items, None, k)),
        "plain_ms": median_ms(
            lambda: kernels.score_topk_plain(q, items, None, k)),
        "library_ms": median_ms(lambda: torch.topk(items @ q.T, k, dim=0)),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from incubator_predictionio_tpu_torch import runtime
    from incubator_predictionio_tpu_torch.core import params as params_mod
    from incubator_predictionio_tpu_torch.models.recommendation import (
        convert,
        engine,
    )
    from incubator_predictionio_tpu_torch.ops import kernels
    from incubator_predictionio_tpu_torch.servers import (
        prediction_server as server_mod,
    )
    from incubator_predictionio_tpu_torch.utils import planted

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    runtime.build_kernels()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    err_k, n_cases = kernel_phase(dev, kernels, planted)
    print(f"kernel: {n_cases} cases agree with the plain version, max score "
          f"error {err_k:.3e}", flush=True)

    launches, err_p, stats = path_phase(
        dev, runtime, kernels, planted, convert, engine, params_mod,
        server_mod, ML20M["users"], ML20M["items"], ML20M["rank"])
    print(f"path: {json.dumps(stats)}", flush=True)

    shapes = [time_shape(kernels, planted, dev, b, n, r, k)
              for b, n, r, k in (
                  (64, ML20M["items"], ML20M["rank"], 16),  # 64-body batch
                  (1, ML20M["items"], ML20M["rank"], 10),   # one query
                  (1, ML20M["items"], ML20M["rank"], 128),
                  (64, ML20M["items"], ML20M["rank"], 128),
                  (1, MIPS_CATALOGUE["items"], MIPS_CATALOGUE["rank"], 128),
                  (64, MIPS_CATALOGUE["items"], MIPS_CATALOGUE["rank"], 128),
              )]
    for s in shapes:
        print(f"time: {json.dumps(s)}", flush=True)
    head = shapes[0]
    report = {"kernels": [{
        "name": "score_topk",
        "route": "cuda",
        "source": "incubator_predictionio_tpu_torch/csrc/score_topk.cu",
        "replaces": kernels.REPLACES,
        "launches": launches,
        "max_abs_err": max(err_k, err_p),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shapes": shapes,
    }]}
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
