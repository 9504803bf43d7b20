"""Telemetry: the process-wide metrics registry (:mod:`.metrics`), request
trace ids and span logs (:mod:`.trace`), the ``GET /metrics`` route
(:mod:`.http`), the SLO burn-rate engine whose ``serve_p99`` objective the
serving scheduler sheds against (:mod:`.slo`) and the state-provider seam
(:mod:`.recorder`). The port's copy of the part of incubator_predictionio_tpu/
obs/ that its servers use; the flight recorder itself, the ``/slo`` and
``/recorder`` routes, federation, capacity, the knobs and the device
profiler are still to be ported (ROADMAP.md Queue 1 item 8).
"""
