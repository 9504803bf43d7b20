"""Request trace IDs + structured JSON span logs.

The port's own copy of incubator_predictionio_tpu/obs/trace.py,
its imports pointed at this package.

The propagation contract (docs/observability.md): every request to any
of the servers gets a trace ID — accepted from an incoming
``X-PIO-Trace-Id`` header when it is well-formed (1-128 chars of
``[A-Za-z0-9._:-]``), freshly generated otherwise — which is

- echoed back on the response in the same header,
- installed in a contextvar for the duration of the handler (the HTTP
  layer copies the context into the executor for sync handlers), and
- emitted in one structured JSON span line per request on the
  ``pio.trace`` logger (level INFO; silence it with
  ``logging.getLogger("pio.trace").setLevel(logging.WARNING)``).

A client that stamps its POST /events.json and POST /queries.json with
the same trace ID can therefore join the ingest span, the serving span
and any operator-side logs on one key — the distributed-tracing
contract at log-line cost, with no collector dependency.
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import random
import re
import secrets
import time
from typing import Any, Optional, Tuple

#: the propagation header, request and response side
TRACE_HEADER = "X-PIO-Trace-Id"
#: the cross-process PARENT link: an in-repo HTTP client stamps its own
#: span ID here so the downstream server's span line carries
#: ``parentSpanId`` and the two processes' spans join into one tree
#: (scripts/trace_stitch.py reconstructs the timeline)
PARENT_SPAN_HEADER = "X-PIO-Parent-Span"
#: response-side: the span ID the server assigned to THIS request, so
#: an external client can reference the server-side span in its own logs
SPAN_HEADER = "X-PIO-Span-Id"

_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9._:-]{1,128}$")
#: span IDs share the trace-ID charset (locally generated ones are 8
#: hex chars, but a foreign tracer's IDs must survive the hop too)
_SPAN_ID_RE = _TRACE_ID_RE

_current: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "pio_trace_id", default=None
)
_current_span: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("pio_span_id", default=None)

#: one JSON object per line; operators point this at their log shipper
span_logger = logging.getLogger("pio.trace")


def new_trace_id() -> str:
    """16 hex chars — collision-safe for log correlation windows."""
    return secrets.token_hex(8)


def accept_trace_id(incoming: Optional[str]) -> str:
    """The incoming header value when well-formed, else a fresh ID.
    Malformed values are REPLACED, not rejected: a trace header must
    never be able to fail a request (or smuggle log-breaking bytes)."""
    if incoming and _TRACE_ID_RE.match(incoming):
        return incoming
    return new_trace_id()


def current_trace_id() -> Optional[str]:
    """The ambient request's trace ID (None outside a request)."""
    return _current.get()


def set_current(trace_id: Optional[str]) -> contextvars.Token:
    return _current.set(trace_id)


def reset_current(token: contextvars.Token) -> None:
    _current.reset(token)


def new_span_id() -> str:
    """8 hex chars — unique within one trace's fan-out."""
    return secrets.token_hex(4)


def accept_parent_span(incoming: Optional[str]) -> Optional[str]:
    """The incoming parent-span header when well-formed, else None.
    Unlike trace IDs a malformed parent is DROPPED, not replaced: a
    fabricated parent would invent linkage that never happened."""
    if incoming and _SPAN_ID_RE.match(incoming):
        return incoming
    return None


def current_span_id() -> Optional[str]:
    """The ambient request's server-side span ID (None outside one)."""
    return _current_span.get()


def set_current_span(span_id: Optional[str]) -> contextvars.Token:
    return _current_span.set(span_id)


def reset_current_span(token: contextvars.Token) -> None:
    _current_span.reset(token)


def client_headers() -> dict:
    """Headers an in-repo HTTP client attaches to a downstream hop
    (prediction/event server → storage server, admin → workers,
    bench → servers): the ambient trace ID plus this request's span ID
    as the downstream parent. Empty outside a request — a client with
    no ambient trace forwards nothing and the server starts a fresh
    trace, exactly as before."""
    tid = _current.get()
    if tid is None:
        return {}
    out = {TRACE_HEADER: tid}
    sid = _current_span.get()
    if sid is not None:
        out[PARENT_SPAN_HEADER] = sid
    return out


def enable_span_logging() -> None:
    """Give the span logger a real sink: one bare-JSON line per request
    on stderr. The CLI server verbs call this so `pio eventserver` /
    `pio deploy` emit spans out of the box; library embedders configure
    logging themselves and never pay for it (an unconfigured logger
    fails the ``isEnabledFor`` gate). ``PIO_TRACE_LOG=off`` disables.
    Idempotent; propagation stays on so pytest caplog and operator root
    handlers keep seeing the records."""
    if os.environ.get("PIO_TRACE_LOG", "").lower() in (
            "off", "0", "false", "disable"):
        return
    if any(isinstance(h, logging.StreamHandler)
           for h in span_logger.handlers):
        return
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter("%(message)s"))
    span_logger.addHandler(handler)
    span_logger.setLevel(logging.INFO)


#: last parsed PIO_TRACE_SAMPLE value, keyed by the raw env string so a
#: runtime change re-parses but the steady state pays one dict-free
#: string compare per request (no float() on the hot path)
_sample_cache: Tuple[Optional[str], float] = (None, 1.0)


def sample_rate() -> float:
    """The span sampling rate from ``PIO_TRACE_SAMPLE`` (default 1.0 —
    every request emits its span line). Clamped to [0, 1]; read per call
    so operators can retune a live server, with the parse cached on the
    raw string value."""
    global _sample_cache
    raw = os.environ.get("PIO_TRACE_SAMPLE")
    cached_raw, cached = _sample_cache
    if raw == cached_raw:
        return cached
    try:
        rate = min(max(float(raw), 0.0), 1.0) if raw else 1.0
    except ValueError:
        rate = 1.0
    _sample_cache = (raw, rate)
    return rate


def span_sampled() -> bool:
    """Coin flip for THIS request's span line. Sampled-out requests
    still carry (and echo) their trace IDs — sampling drops only the
    JSON log line, which at bench QPS is the per-request hot-path cost;
    the propagation contract is unconditional."""
    rate = sample_rate()
    if rate >= 1.0:
        return True
    return rate > 0.0 and random.random() < rate


def log_span(server: str, method: str, route: str, status: int,
             duration_s: float, trace_id: str,
             span_id: Optional[str] = None,
             parent_span_id: Optional[str] = None,
             **extra: Any) -> None:
    """Emit the per-request JSON span line. Pre-gated on the logger
    level so a silenced logger costs one attribute read per request.
    ``span_id``/``parent_span_id`` carry the cross-process parenting
    contract: the downstream hop's line names the upstream span, so
    span lines from multiple processes link into one request tree."""
    if not span_logger.isEnabledFor(logging.INFO):
        return
    record = {
        "span": "http.request",
        "server": server,
        "method": method,
        "route": route,
        "status": status,
        # wall stamp (epoch s, ms precision): cross-PROCESS span lines
        # have no shared log stream, so the stitcher orders them by
        # wall clock — NTP-grade skew is fine at request granularity
        "ts": round(time.time(), 3),
        "durationMs": round(duration_s * 1e3, 3),
        "traceId": trace_id,
    }
    if span_id is not None:
        record["spanId"] = span_id
    if parent_span_id is not None:
        record["parentSpanId"] = parent_span_id
    if extra:
        record.update(extra)
    span_logger.info("%s", json.dumps(record, separators=(",", ":")))


def log_stage_span(span: str, trace_id: str, duration_s: float,
                   **extra: Any) -> None:
    """Emit a non-HTTP pipeline-stage span (the speed layer's freshness
    chain: ``speed.poll`` → ``speed.foldin`` → ``speed.serve``) on the
    same ``pio.trace`` logger and with the same shape as the request
    spans, so one trace ID joins an event's whole journey across log
    lines. Pre-gated like :func:`log_span`."""
    if not span_logger.isEnabledFor(logging.INFO):
        return
    record = {
        "span": span,
        "ts": round(time.time(), 3),
        "durationMs": round(duration_s * 1e3, 3),
        "traceId": trace_id,
    }
    if extra:
        record.update(extra)
    span_logger.info("%s", json.dumps(record, separators=(",", ":")))
