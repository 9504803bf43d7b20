"""Telemetry: the process-wide metrics registry (:mod:`.metrics`), request
trace ids and span logs (:mod:`.trace`) and the ``GET /metrics`` route
(:mod:`.http`). The port's copy of the part of incubator_predictionio_tpu/
obs/ that its servers use; the flight recorder, SLOs, federation and the
device profiler are still to be ported (ROADMAP.md Queue 1 item 8).
"""
