"""Worker program of the port's fleet tests (tests/test_torch_federation.py,
tests/test_torch_recorder.py), the twin of tests/fleet_worker.py.

Run as a separate process, with the port only (it imports nothing of JAX):

- ``--mode metrics``: an ``HttpServer`` with ``GET /metrics`` and ``GET
  /recorder`` over its own process registry, with planted
  ``pio_query_latency_seconds`` observations, a ``pio_serve_queue_depth``
  and a ``pio_model_staleness_seconds`` value — one worker for a
  ``/federate`` scrape.
- ``--mode storage``: a memory-backed ``StorageServer`` with span logging
  on, the downstream hop of the cross-process trace test.
- ``--mode serve``: a ``PredictionServer`` on the CPU over a planted ALS
  model (seeded random factors), serving ``/queries.json`` through the
  scheduler, with ``/metrics`` and ``/recorder``.

Prints ``PORT <n>`` on stdout once bound, then serves until stdin closes
(the parent owns the lifetime). Span lines go to stderr.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _serve_worker(args):
    import numpy as np

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

    rng = np.random.default_rng(args.seed)
    users = rng.normal(0, 0.3, (args.users, args.rank)).astype(np.float32)
    items = rng.normal(0, 0.3, (args.items, args.rank)).astype(np.float32)
    model = als_model_from_numpy(
        users, items, [f"u{i}" for i in range(args.users)],
        [f"i{i}" for i in range(args.items)], device="cpu")
    srv = PredictionServer(
        engine.RecommendationEngine().apply(),
        EngineParams(algorithm_params_list=[
            ("als", engine.ALSAlgorithmParams(rank=args.rank))]),
        [model], device="cpu",
        config=ServerConfig(ip="127.0.0.1", port=0,
                            micro_batch=args.max_batch))
    return srv, srv.start_background()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("metrics", "storage", "serve"),
                    required=True)
    ap.add_argument("--observe", default="",
                    help="comma-separated seconds planted into "
                         "pio_query_latency_seconds (metrics mode)")
    ap.add_argument("--depth", type=float, default=0.0)
    ap.add_argument("--staleness", type=float, default=None)
    ap.add_argument("--users", type=int, default=60)
    ap.add_argument("--items", type=int, default=40)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
    from incubator_predictionio_tpu_torch.obs import trace as obs_trace

    obs_trace.enable_span_logging()
    if args.mode == "metrics":
        from incubator_predictionio_tpu_torch.obs.http import (
            add_metrics_route,
            add_recorder_route,
        )
        from incubator_predictionio_tpu_torch.utils.http import (
            HttpServer,
            Router,
        )

        h = obs_metrics.REGISTRY.histogram("pio_query_latency_seconds",
                                           "per-query serving wall")
        for raw in args.observe.split(","):
            if raw.strip():
                h.observe(float(raw))
        obs_metrics.REGISTRY.gauge(
            "pio_serve_queue_depth", "scheduler backlog").set(args.depth)
        if args.staleness is not None:
            obs_metrics.REGISTRY.gauge(
                "pio_model_staleness_seconds",
                "age of the served engine instance").set(args.staleness)
        r = Router()
        add_metrics_route(r)
        add_recorder_route(r)
        srv = HttpServer(r, "127.0.0.1", 0, name="worker")
        port = srv.start_background()
    elif args.mode == "serve":
        srv, port = _serve_worker(args)
    else:
        from incubator_predictionio_tpu_torch.data.storage import (
            StorageClientConfig,
        )
        from incubator_predictionio_tpu_torch.data.storage import (
            memory as memory_backend,
        )
        from incubator_predictionio_tpu_torch.data.storage.server import (
            StorageServer,
        )

        config = StorageClientConfig(test=True, properties={})
        srv = StorageServer(memory_backend,
                            memory_backend.StorageClient(config), config,
                            host="127.0.0.1", port=0)
        port = srv.start_background()
    print(f"PORT {port}", flush=True)
    sys.stdin.read()  # until the parent closes our stdin
    srv.stop()


if __name__ == "__main__":
    main()
