#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's recommendation serving goes,
on one NVIDIA GPU.

    python3 -m incubator_predictionio_tpu_torch.profile_serving

Prints one JSON object per line:

- ``kernel``: for each main-path shape of the score+top-k kernel, the
  device time of its two passes (``tile_topk_kernel`` scores and selects
  per item tile, ``merge_topk_kernel`` merges the tiles' lists) per call,
  from ``torch.profiler`` over 20 calls after warm-up;
- ``http``: 64 sequential POSTs of ``{"user": ..., "num": 10}`` to the port's
  PredictionServer at ML-20M width (138,493 users x 26,744 items x rank
  128, planted factors), the host wall per query beside the device time
  per query, and the device's idle share of the window;
- ``batch``: the same for ten 64-body batches through ``_handle_batch``.

The first line is the card's name and power limit from nvidia-smi. Needs a
CUDA device; fails without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from incubator_predictionio_tpu_torch import runtime
from incubator_predictionio_tpu_torch.core.params import EngineParams
from incubator_predictionio_tpu_torch.models.recommendation import (
    convert,
    engine,
)
from incubator_predictionio_tpu_torch.ops import kernels
from incubator_predictionio_tpu_torch.servers.prediction_server import (
    PredictionServer,
)
from incubator_predictionio_tpu_torch.utils import planted

USERS, ITEMS, RANK = 138_493, 26_744, 128


def device_us(prof) -> dict:
    """Device microseconds by kernel or copy name over the profiled window."""
    out: dict = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and ev.self_device_time_total > 0:
            out[ev.key] = out.get(ev.key, 0.0) + ev.self_device_time_total
    return out


def _short(name: str) -> str:
    for tag in ("tile_topk_kernel", "merge_topk_kernel"):
        if tag in name:
            return tag
    return name[:60]


def profile_kernel(dev, b: int, n_items: int, rank: int, k: int,
                   calls: int = 20) -> dict:
    items_np = planted.planted_item_factors(n_items, rank, seed=31)
    q = torch.from_numpy(planted.planted_queries(items_np, b, seed=32)).to(dev)
    items = torch.from_numpy(items_np).to(dev)
    for _ in range(5):
        kernels.score_topk(q, items, None, k)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for _ in range(calls):
            kernels.score_topk(q, items, None, k)
        torch.cuda.synchronize()
    per_call: dict = {}
    for name, us in device_us(prof).items():
        key = _short(name)
        per_call[key] = per_call.get(key, 0.0) + us / calls / 1e3
    return {"B": b, "I": n_items, "K": rank, "k": k,
            "device_ms_per_call": per_call}


def _post(port: int, doc) -> None:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(doc).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        json.loads(resp.read())


def profile_path(dev) -> list:
    items = planted.planted_item_factors(ITEMS, RANK, seed=1)
    users = planted.planted_queries(items, USERS, seed=2)
    model = convert.als_model_from_numpy(
        users, items, [f"u{i}" for i in range(USERS)],
        [f"i{i}" for i in range(ITEMS)], device=dev)
    srv = PredictionServer(
        engine.RecommendationEngine().apply(),
        EngineParams(algorithm_params_list=[
            ("als", engine.ALSAlgorithmParams(rank=RANK))]),
        [model], device=dev)
    port = srv.start_background()
    rng = np.random.default_rng(5)
    out = []
    try:
        for u in rng.choice(USERS, 8):  # warm-up
            _post(port, {"user": f"u{u}", "num": 10})
        docs = [{"user": f"u{u}", "num": 10} for u in rng.choice(USERS, 64)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for d in docs:
                _post(port, d)
            wall = time.perf_counter() - t0
        out.append(_window("http", len(docs), wall, prof))
        bodies = [[json.dumps({"user": f"u{u}", "num": 10}).encode()
                   for u in rng.choice(USERS, 64)] for _ in range(10)]
        srv._handle_batch(bodies[0])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for bb in bodies:
                srv._handle_batch(bb)
            wall = time.perf_counter() - t0
        out.append(_window("batch", 64 * len(bodies), wall, prof))
    finally:
        srv.stop()
    return out


def _window(what: str, queries: int, wall: float, prof) -> dict:
    dev_us = device_us(prof)
    busy_ms = sum(dev_us.values()) / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
    return {"what": what, "queries": queries,
            "wall_ms_per_query": 1e3 * wall / queries,
            "device_ms_per_query": busy_ms / queries,
            "device_idle_share": 1.0 - busy_ms / (1e3 * wall),
            "device_ms_by_name": {_short(k): v / 1e3 for k, v in top}}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    runtime.build_kernels()
    for b, n, r, k in ((1, ITEMS, RANK, 10), (1, ITEMS, RANK, 128),
                       (64, ITEMS, RANK, 16), (64, ITEMS, RANK, 128),
                       (1, 1_048_576, 64, 128), (64, 1_048_576, 64, 128)):
        print(json.dumps({"kernel": profile_kernel(dev, b, n, r, k)}),
              flush=True)
    for row in profile_path(dev):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
