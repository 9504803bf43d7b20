"""State providers: the seam through which subsystems publish a snapshot.

The port's copy of the state-provider part of
incubator_predictionio_tpu/obs/recorder.py (:116-150). The serving
scheduler registers its queue, rung and shed state here
(``serving/scheduler.BatchScheduler``), and :func:`collect_state` reads
every provider. The rest of that module, the ``FlightRecorder`` ring, the
``IncidentCapture`` bundles and the ``GET /recorder`` route that would
read these snapshots, is not ported yet (ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict

# ---------------------------------------------------------------------------
# state providers — subsystems publish a snapshot callable (the
# scheduler's queue/rung/shed state). Named replace semantics like
# registry collectors, so re-created subsystems never accumulate dead
# hooks.
# ---------------------------------------------------------------------------

_state_providers: Dict[str, Callable[[], Any]] = {}
_state_lock = threading.Lock()


def register_state_provider(name: str, fn: Callable[[], Any]) -> None:
    with _state_lock:
        _state_providers[name] = fn


def unregister_state_provider(name: str) -> None:
    with _state_lock:
        _state_providers.pop(name, None)


def collect_state() -> Dict[str, Any]:
    """Every registered provider's snapshot; a failing (or garbage-
    collected) provider reports its error string instead of failing
    the dump."""
    with _state_lock:
        providers = list(_state_providers.items())
    out: Dict[str, Any] = {}
    for name, fn in providers:
        try:
            value = fn()
        except Exception as e:  # noqa: BLE001 — per-provider degradation
            out[name] = {"error": str(e)}
            continue
        if value is not None:
            out[name] = value
    return out
