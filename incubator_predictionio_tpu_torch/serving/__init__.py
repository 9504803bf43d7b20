"""Request plane between the HTTP servers and the device kernels.

The port's counterpart of incubator_predictionio_tpu/serving/__init__.py.
``serving.scheduler`` is the seam for query-path device dispatch: the
prediction server's ``/queries.json`` handler enqueues, the scheduler
coalesces (queue-depth-adaptive pow2 batching onto the score+top-k
kernel's ladder) and sheds (SLO-projected 503 + Retry-After).
``serving.tenancy`` maps access keys to tenants, and its tenant block
rides the flight recorder's incident bundles (obs/recorder.py).

``serving.frontdoor`` is the layer above: ONE address fanned across N
worker processes with queue-depth-aware placement, circuit-breaker
health, budgeted retry, rolling drain-reload choreography and the
fleet-wide ``POST /knobs`` fan-out.
"""

from incubator_predictionio_tpu_torch.serving.scheduler import (  # noqa: F401
    BatchScheduler,
    ShedError,
    ladder_cap,
    max_wait_s,
    plan_dispatch,
)


def __getattr__(name: str):
    """Lazy ``FrontDoor``/``FrontDoorConfig`` re-export: importing the
    frontdoor module registers the pio_frontdoor_* metric families, and
    a plain prediction WORKER (which imports serving.scheduler) must
    not grow empty front-door series on its /metrics."""
    if name in ("FrontDoor", "FrontDoorConfig"):
        from incubator_predictionio_tpu_torch.serving import frontdoor

        return getattr(frontdoor, name)
    raise AttributeError(name)
