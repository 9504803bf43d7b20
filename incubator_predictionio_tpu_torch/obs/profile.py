"""Device-time / MFU attribution for the hot dispatch entry points.

The port of incubator_predictionio_tpu/obs/profile.py, rewritten for
CUDA. It wraps the training, retrain, fold-in and serving dispatches with
**wall deltas that wait for the device** plus known-FLOP counters, off
by default and enabled with ``PIO_PROFILE=1``:

- ``pio_device_seconds{op}`` — attributed device+dispatch wall,
- ``pio_device_dispatches_total{op}`` — dispatches attributed,
- ``pio_device_flops_total{op}`` — analytic useful FLOPs (padding waste
  is *not* counted — it shows up as lower MFU),
- ``pio_mfu{phase}`` — the LAST dispatch's model-FLOP utilization in
  that phase against the f32 peak (:func:`peak_flops`).

Op labels are a BOUNDED set chosen by the call sites, the JAX package's:
``als_train`` (training on the plain route), ``als_fused`` (training
whose buckets go to the kernel entries; ``als.train_flops`` stays the
ONE FLOP formula for both, so ``pio_mfu{phase="train"}`` is comparable
across the split), ``als_retrain`` (continuation retrain on the plain
route), ``foldin_solve`` (one speed-layer fold-in bucket launch),
``serve_topk`` / ``serve_topk_batch`` (the score+top-k entries) and
``serve_topk_mips`` / ``serve_topk_mips_batch`` (the two-stage route).

Where the JAX package calls ``jax.block_until_ready(result)``,
:func:`record` records a CUDA event on the current stream of each device
``result``'s tensors live on and waits for that event. Each long-lived
device thread of the port runs its work on a stream of its own
(``runtime.own_stream``: the serving dispatchers, the speed layer's
poller, the MIPS rebuild daemon), so the event waits for that thread's
work alone, never for another thread's queued fold-in or rebuild: under
concurrent device work ``pio_device_seconds{op}`` books the op's own
wall. The wall is read after the wait: dispatch plus device, as in the
JAX package. A result on the CPU (or a numpy array, already copied back)
needs no wait.

OFF is the contract: with ``PIO_PROFILE`` unset, a call site pays one
:func:`t0` env read returning None and one :func:`record` None-check —
no wait, no metrics. When ON, every attributed dispatch becomes
synchronous, which is exactly what a wall measurement means: leave it
off on latency-critical serving, use a canary.

:func:`capture_trace` is the on-demand ``torch.profiler`` capture behind
``POST /profile?seconds=N`` (obs/http.py): CPU and CUDA activities on a
machine with a card, the CPU alone without one, written as one Chrome
trace JSON. On an H100 (torch 2.11, CUDA 12.8) a session can record one
thread's kernel launches without their kernels, and every later session
of the process the same for that thread, whichever thread captures and
whether external correlation is on or off: a trace whose recorded
launches lack their kernels (:func:`lost_kernels`) fails the capture,
and is never handed back as if the card had been idle.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Any, Optional

from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics

logger = logging.getLogger(__name__)

DEVICE_SECONDS = obs_metrics.REGISTRY.counter(
    "pio_device_seconds",
    "device+dispatch wall attributed by the PIO_PROFILE=1 profiler, "
    "by op", labels=("op",))
DEVICE_DISPATCHES = obs_metrics.REGISTRY.counter(
    "pio_device_dispatches_total",
    "dispatches attributed by the profiler, by op", labels=("op",))
DEVICE_FLOPS = obs_metrics.REGISTRY.counter(
    "pio_device_flops_total",
    "analytic useful FLOPs attributed by the profiler, by op",
    labels=("op",))
MFU = obs_metrics.REGISTRY.gauge(
    "pio_mfu",
    "last attributed dispatch's model-FLOP utilization vs the f32 "
    "peak (PIO_BENCH_PEAK_FLOPS), by phase", labels=("phase",))

#: the f32 peak of one NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit:
#: 495 TFLOP/s of TF32 over the 3 passes of 3xTF32, the rate PERF.md §6
#: divides the kernels' f32 products by. The kernels' f32 work never runs
#: faster than that, so no route reads above 1.
H100_F32_PEAK_FLOPS = 495e12 / 3


def enabled() -> bool:
    """True when the dispatch profiler is on (``PIO_PROFILE=1``). Read
    per call — a live process can be toggled — and cheap enough for the
    serving hot path (one env dict lookup)."""
    return os.environ.get("PIO_PROFILE", "0").lower() not in (
        "0", "", "false", "off")


def peak_flops() -> float:
    """The f32 peak the MFU gauge divides by: ``PIO_BENCH_PEAK_FLOPS``
    when set, else :data:`H100_F32_PEAK_FLOPS` (an H100 80GB HBM3 at
    700 W, 3xTF32)."""
    try:
        return float(os.environ.get("PIO_BENCH_PEAK_FLOPS", "")
                     or H100_F32_PEAK_FLOPS)
    except ValueError:
        return H100_F32_PEAK_FLOPS


def t0() -> Optional[float]:
    """Dispatch-entry stamp: ``time.perf_counter()`` when profiling is
    on, None otherwise. The None is the whole off-path cost — callers
    hand it straight back to :func:`record`."""
    if not enabled():
        return None
    return time.perf_counter()


def _cuda_devices(result: Any, out: set) -> set:
    """The CUDA devices of every tensor in ``result`` (a tensor, or
    tuples, lists, dicts and dataclasses of them)."""
    import torch

    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            out.add(result.device)
    elif isinstance(result, (list, tuple)):
        for x in result:
            _cuda_devices(x, out)
    elif isinstance(result, dict):
        for x in result.values():
            _cuda_devices(x, out)
    elif dataclasses.is_dataclass(result):
        for f in dataclasses.fields(result):
            _cuda_devices(getattr(result, f.name), out)
    return out


def wait(result: Any) -> None:
    """Wait until the work that produced ``result`` is done on the
    device: one CUDA event on the current stream of each of its devices,
    and that event's ``synchronize()``. The current stream is the calling
    thread's own (``runtime.own_stream``), so the wait covers that
    thread's work only. Nothing for a CPU result."""
    devices = _cuda_devices(result, set())
    if not devices:
        return
    import torch

    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


def record(start: Optional[float], phase: str, op: str,
           flops: float = 0.0, result: Any = None,
           flops_fn: Any = None) -> None:
    """Close one attributed dispatch: wait until ``result`` is complete
    on the device (:func:`wait`), book the wall under ``op`` and refresh
    ``pio_mfu{phase}``. No-op when ``start`` is None (profiling was off
    at :func:`t0`).

    ``flops_fn`` (a zero-arg callable) defers a FLOP count whose
    computation itself touches the device (nnz from mask sums) until
    AFTER ``dt`` is read, so its launches and copies never enter the
    measured wall. Plain ``flops`` is for host-arithmetic counts.

    Telemetry never fails the dispatch: any error here logs and
    returns."""
    if start is None:
        return
    try:
        if result is not None:
            wait(result)
        dt = time.perf_counter() - start
        if flops_fn is not None:
            flops = float(flops_fn())
        DEVICE_SECONDS.labels(op=op).inc(dt)
        DEVICE_DISPATCHES.labels(op=op).inc()
        if flops > 0:
            DEVICE_FLOPS.labels(op=op).inc(flops)
            if dt > 0:
                MFU.labels(phase=phase).set(flops / dt / peak_flops())
    except Exception:
        logger.exception("dispatch profiler record failed (op=%s)", op)


# ---------------------------------------------------------------------------
# on-demand torch.profiler capture (POST /profile?seconds=N)
# ---------------------------------------------------------------------------

#: serializes captures: one profiler session per process, and a second
#: one started mid-capture would fail it
_capture_lock = threading.Lock()

MAX_CAPTURE_SECONDS = 120.0

#: the Chrome trace file a capture writes into its directory
TRACE_FILE = "trace.json"


class CaptureBusy(RuntimeError):
    """Raised by :func:`capture_trace` while another capture runs (the
    route's 409); any other error of a capture is the route's 500."""


def _all_threads_config():
    """The profiler's option to record the operators of every thread (the
    serving dispatcher's, the speed layer's poller's), not only the
    capturing one's; None where this torch has no such option, and then
    the CPU operators are the capturing thread's alone (the card's kernels
    are recorded from every thread either way)."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


def lost_kernels(events: list) -> Optional[str]:
    """Why a trace's device record cannot be trusted, or None: more than
    8 plus a twentieth of the kernel launches it recorded lack their
    kernel (a sound session misses a few launched at its very end: at
    most 26 of 6,278 on an H100)."""
    kernels = {e.get("args", {}).get("correlation") for e in events
               if e.get("cat") == "kernel"}
    launches = [e.get("args", {}).get("correlation") for e in events
                if e.get("cat") == "cuda_runtime"
                and "LaunchKernel" in e.get("name", "")]
    missing = sum(c not in kernels for c in launches)
    if missing > 8 + len(launches) // 20:
        return (f"the profiler recorded {len(launches)} kernel launches, "
                f"{missing} of them without their kernel")
    return None


def _capture(seconds: float, out_dir: Optional[str]) -> str:
    # dir created only once the capture is actually ours to run (a
    # rejected 409 must not leak an empty temp dir per request)
    if out_dir is None:
        import tempfile

        out_dir = tempfile.mkdtemp(prefix="pio_profile_")
    os.makedirs(out_dir, exist_ok=True)
    import json

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 experimental_config=_all_threads_config()) as prof:
        time.sleep(seconds)
    path = os.path.join(out_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    with open(path) as f:
        lost = lost_kernels(json.load(f).get("traceEvents", []))
    if lost:
        raise RuntimeError(f"{lost}; trace kept in {out_dir}")
    return out_dir


def capture_trace(seconds: float, out_dir: Optional[str] = None) -> dict:
    """Capture ``seconds`` of ``torch.profiler`` trace into ``out_dir``
    (default ``$PIO_PROFILE_DIR`` or a per-capture temp dir), as one
    Chrome trace JSON (:data:`TRACE_FILE`), and return ``{"traceDir",
    "seconds"}``. CPU and CUDA activities where a card is present, the
    CPU alone otherwise, the operators of every thread of the process
    (:func:`_all_threads_config`), so the serving threads' launches land
    in the trace. Blocks the caller for the capture window — the route
    runs it on the executor, so the server keeps serving. Raises
    :class:`CaptureBusy` when a capture is already running (the route
    maps it to 409), ValueError on a bad window, and RuntimeError when
    the trace lost the card's kernels (:func:`lost_kernels`)."""
    seconds = float(seconds)
    if not 0.0 < seconds <= MAX_CAPTURE_SECONDS:
        raise ValueError(
            f"seconds must be in (0, {MAX_CAPTURE_SECONDS:.0f}]")
    if out_dir is None:
        out_dir = os.environ.get("PIO_PROFILE_DIR")
    if not _capture_lock.acquire(blocking=False):
        raise CaptureBusy("a profiler capture is already running")
    try:
        out_dir = _capture(seconds, out_dir)
    finally:
        _capture_lock.release()
    return {"traceDir": out_dir, "seconds": seconds}
