"""Request plane between the HTTP servers and the device kernels.

The port's counterpart of incubator_predictionio_tpu/serving/__init__.py.
``serving.scheduler`` is the seam for query-path device dispatch: the
prediction server's ``/queries.json`` handler enqueues, the scheduler
coalesces (queue-depth-adaptive pow2 batching onto the score+top-k
kernel's ladder) and sheds (SLO-projected 503 + Retry-After).
``serving.tenancy`` maps access keys to tenants, and its tenant block
rides the flight recorder's incident bundles (obs/recorder.py). The
front door (``serving.frontdoor``: one address fanned across worker
processes) is not ported yet (ROADMAP.md Queue 1 item 8b).
"""

from incubator_predictionio_tpu_torch.serving.scheduler import (  # noqa: F401
    BatchScheduler,
    ShedError,
    ladder_cap,
    max_wait_s,
    plan_dispatch,
)
