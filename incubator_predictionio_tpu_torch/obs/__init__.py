"""Telemetry: the process-wide metrics registry (:mod:`.metrics`), request
trace ids and span logs (:mod:`.trace`), the SLO burn-rate engine whose
``serve_p99`` objective the serving scheduler sheds against (:mod:`.slo`),
the exposition parser (:mod:`.expofmt`), fleet federation under an
``instance`` label (:mod:`.federate`), the flight recorder and its
incident bundles (:mod:`.recorder`), the ``PIO_PROFILE`` device profiler
on CUDA events with its ``torch.profiler`` capture (:mod:`.profile`), the
end-to-end freshness tracker (:mod:`.freshness`) and the HTTP routes and
status-page panels over all of them (:mod:`.http`), the capacity model
(:mod:`.capacity`), and the two control loops the admin server hosts:
the freshness controller (:mod:`.controller`) and the serving-knob
controller (:mod:`.knobs`). The port's copy of
incubator_predictionio_tpu/obs/.
"""
