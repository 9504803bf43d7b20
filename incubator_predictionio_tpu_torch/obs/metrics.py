"""Process-wide metrics registry with Prometheus text exposition.

The port's own copy of incubator_predictionio_tpu/obs/metrics.py,
its imports pointed at this package.

Dependency-free (like the HTTP layer it rides on) and built for the
serving hot path: an observation is one uncontended ``threading.Lock``
acquire plus a few int adds — no allocation after the child exists, no
host syncs, no device interaction of any kind: an observation never
waits on the card.

The module-level :data:`REGISTRY` is the process-wide default every
server and subsystem registers into, so one ``GET /metrics`` scrape
sees the whole process. Fresh :class:`Registry` instances exist for
tests.

Label cardinality discipline: label values must come from BOUNDED sets
(route patterns, status codes, phase names) — never ids, entity names
or other wire-derived strings.
"""

from __future__ import annotations

import bisect
import logging
import math
import os
import random
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

#: exposition content type (Prometheus text format 0.0.4)
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: fixed exponential latency buckets: 6.25 µs doubling to ~13.1 s — wide
#: enough to hold a sub-millisecond device fold-in solve at the bottom
#: (the original 100 µs floor dumped every sub-ms solve into one bucket,
#: flattening their quantiles) and a cold kernel build on the first query
#: at the top, with p50/p95/p99 derivable anywhere in between. The
#: >=100 µs bounds are unchanged, so dashboards keyed on the old ladder
#: keep lining up. Shared by every latency histogram so panels align.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    1e-4 * (2.0 ** i) for i in range(-4, 18)
)


def _fmt(v: float) -> str:
    """Prometheus sample value: ints render bare, floats via repr."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        # Prometheus's explicit no-data sample value (the controller's
        # projection gauge goes NaN when no driving signal projects) —
        # int() on it would raise and take down the whole scrape
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


# ---------------------------------------------------------------------------
# trace exemplars (OpenMetrics-style) — the "WHICH query was the p99"
# link between a histogram bucket and the distributed-tracing plane.
# Each bucket keeps at most ONE reservoir-sampled exemplar per
# PIO_EXEMPLAR_WINDOW_S window: (ambient trace ID, observed value, wall
# ts), emitted as a `# {trace_id="..."} value ts` suffix on the bucket's
# exposition line. Hot-path cost when no ambient trace exists is one
# contextvar read; PIO_EXEMPLARS=0 turns even that off.
# ---------------------------------------------------------------------------

#: reservoir RNG — module-level and reseedable so tests can pin which
#: observation survives a window (tests/test_recorder.py determinism)
_exemplar_rng = random.Random()


def seed_exemplar_rng(seed: int) -> None:
    """Reseed the exemplar reservoir (tests only — determinism pins)."""
    _exemplar_rng.seed(seed)


#: parsed PIO_EXEMPLARS cache keyed on the raw env string (same idiom as
#: obs/trace.sample_rate: live-retunable, no per-observe dict churn)
_exemplar_cache: Tuple[Optional[str], bool] = ("\0unset", True)


def exemplars_enabled() -> bool:
    global _exemplar_cache
    raw = os.environ.get("PIO_EXEMPLARS")
    cached_raw, cached = _exemplar_cache
    if raw == cached_raw:
        return cached
    enabled = (raw or "1").strip().lower() not in ("0", "off", "false")
    _exemplar_cache = (raw, enabled)
    return enabled


#: parsed PIO_EXEMPLAR_WINDOW_S cache keyed on the raw env string —
#: observe() reads this under the histogram child lock, so the steady
#: state must pay one string compare, not an env parse
_exemplar_window_cache: Tuple[Optional[str], float] = ("\0unset", 60.0)


def exemplar_window_s() -> float:
    """Reservoir window: at most one exemplar survives per bucket per
    window, so a sustained burst cannot pin one early trace forever."""
    global _exemplar_window_cache
    raw = os.environ.get("PIO_EXEMPLAR_WINDOW_S")
    cached_raw, cached = _exemplar_window_cache
    if raw == cached_raw:
        return cached
    try:
        window = float(raw) if raw else 60.0
    except ValueError:
        window = 60.0
    _exemplar_window_cache = (raw, window)
    return window


def _ambient_trace_id() -> Optional[str]:
    """The ambient request's trace ID, imported lazily — obs.trace has
    no import back into this module, but the late bind keeps metrics
    importable absolutely first."""
    from incubator_predictionio_tpu_torch.obs import trace as obs_trace

    return obs_trace.current_trace_id()


def format_exemplar(trace_id: str, value: float, ts: float) -> str:
    """The OpenMetrics exemplar annotation this registry emits (and
    obs/expofmt.py parses back): ``# {trace_id="..."} value ts``."""
    return (f'# {{trace_id="{_escape_label(trace_id)}"}} '
            f"{_fmt(value)} {ts:.3f}")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


class _CounterChild:
    """One labeled time series of a Counter. ``inc`` is the hot path."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _GaugeChild:
    # _touched distinguishes "never written" from "set to 0.0" — the
    # SLO engine must not count a registered-but-unpopulated gauge as a
    # healthy observation (obs/slo.py gauge objectives)
    __slots__ = ("_lock", "_value", "_touched")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0
        self._touched = False

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)
            self._touched = True

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n
            self._touched = True

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n
            self._touched = True

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _HistogramChild:
    """Fixed-bucket histogram: per-bucket counts + sum + count.

    ``observe(v, n)`` records ``n`` observations of the same value in
    one lock acquire — the micro-batched serving path uses it to keep
    per-query semantics (every query in a fused batch took the batch
    wall) at per-BATCH bookkeeping cost.
    """

    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count",
                 "_ex", "_ex_seen", "_ex_win")

    def __init__(self, bounds: Sequence[float]) -> None:
        self._lock = threading.Lock()
        self._bounds = tuple(bounds)  # upper bounds, ascending
        self._counts = [0] * (len(self._bounds) + 1)  # + overflow
        self._sum = 0.0
        self._count = 0
        #: per-bucket exemplar (trace_id, value, wall_ts) or None
        self._ex: List[Optional[Tuple[str, float, float]]] = \
            [None] * (len(self._bounds) + 1)
        #: traced observations seen in the bucket's CURRENT window (the
        #: reservoir denominator) + that window's start wall
        self._ex_seen = [0] * (len(self._bounds) + 1)
        self._ex_win = [0.0] * (len(self._bounds) + 1)

    def observe(self, v: float, n: int = 1) -> None:
        i = bisect.bisect_left(self._bounds, v)
        trace_id = (_ambient_trace_id() if exemplars_enabled() else None)
        with self._lock:
            self._counts[i] += n
            self._sum += v * n
            self._count += n
            if trace_id is not None:
                # ≤1 exemplar per bucket per window, reservoir-sampled:
                # every traced observation in the window has an equal
                # chance of being THE exemplar, so the survivor is a
                # fair draw rather than first- or last-wins
                now = time.time()
                if now - self._ex_win[i] >= exemplar_window_s():
                    self._ex_win[i] = now
                    self._ex_seen[i] = 0
                self._ex_seen[i] += 1
                if (self._ex[i] is None
                        or self._ex[i][2] < self._ex_win[i]
                        or _exemplar_rng.random()
                        < 1.0 / self._ex_seen[i]):
                    self._ex[i] = (trace_id, v, now)

    def exemplars(self) -> List[Tuple[float, str, float, float]]:
        """``(le bound, trace_id, value, wall_ts)`` for every bucket
        holding an exemplar (+Inf rendered as math.inf) — the incident
        bundle's "which queries were the p99" payload."""
        with self._lock:
            snap = list(self._ex)
        out: List[Tuple[float, str, float, float]] = []
        for i, ex in enumerate(snap):
            if ex is None:
                continue
            le = (self._bounds[i] if i < len(self._bounds)
                  else float("inf"))
            out.append((le, ex[0], ex[1], ex[2]))
        return out

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(per-bucket counts incl. overflow, sum, count) — consistent."""
        with self._lock:
            return list(self._counts), self._sum, self._count

    def quantile(self, q: float) -> Optional[float]:
        """Derive a quantile from the buckets (linear interpolation
        within the bucket, Prometheus ``histogram_quantile`` style).
        None when empty; values past the last finite bound report that
        bound (the honest answer a fixed-bucket histogram can give)."""
        counts, _sum, total = self.snapshot()
        if total == 0:
            return None
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                if i >= len(self._bounds):  # overflow bucket
                    return self._bounds[-1]
                lo = self._bounds[i - 1] if i > 0 else 0.0
                hi = self._bounds[i]
                return lo + (hi - lo) * max(rank - cum, 0.0) / c
            cum += c
        return self._bounds[-1]


_KINDS = {
    "counter": _CounterChild,
    "gauge": _GaugeChild,
    "histogram": _HistogramChild,
}


class _Metric:
    """One named metric family: fixed label names, children per label
    value tuple. Unlabeled metrics have a single implicit child."""

    def __init__(self, name: str, help: str, kind: str,
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self._buckets = tuple(
            buckets if buckets is not None else DEFAULT_LATENCY_BUCKETS)
        if kind == "histogram" and list(self._buckets) != sorted(
                set(self._buckets)):
            raise ValueError("histogram buckets must be sorted and unique")
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            self._children[()] = self._make_child()

    def _make_child(self):
        if self.kind == "histogram":
            return _HistogramChild(self._buckets)
        return _KINDS[self.kind]()

    def labels(self, **labels: str):
        """Child for one label-value combination (created on first use,
        cached — the hot path pays one dict lookup)."""
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(labels)}")
        key = tuple(str(labels[ln]) for ln in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._make_child())
        return child

    # unlabeled convenience: metric.inc()/set()/observe() hit the child
    def _solo(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled; use .labels(...)")
        return self._children[()]

    def inc(self, n: float = 1.0) -> None:
        self._solo().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._solo().dec(n)

    def set(self, v: float) -> None:
        self._solo().set(v)

    def observe(self, v: float, n: int = 1) -> None:
        self._solo().observe(v, n)

    @property
    def value(self):
        return self._solo().value

    # Family-level histogram READS aggregate over children: when a
    # family gains a label (pio_query_latency_seconds grew ``tenant``
    # for the multi-tenant platform), every read-side consumer of the
    # whole family — /status quantiles, the scheduler's live-p99 shed
    # feed, cross-process count asserts — keeps meaning "the family",
    # not one child. WRITES on a labeled family still raise via
    # ``_solo``: an observation must always name its child.
    @property
    def sum(self):
        if self.labelnames and self.kind == "histogram":
            with self._lock:
                children = list(self._children.values())
            return sum(c.sum for c in children)
        return self._solo().sum

    @property
    def count(self):
        if self.labelnames and self.kind == "histogram":
            with self._lock:
                children = list(self._children.values())
            return sum(c.count for c in children)
        return self._solo().count

    def quantile(self, q: float):
        if self.labelnames and self.kind == "histogram":
            return self.quantile_over_children(q)
        return self._solo().quantile(q)

    def total(self) -> float:
        """Sum over every labeled child (counter/gauge families) — the
        bench's registry snapshot collapses label sets with this."""
        if self.kind == "histogram":
            raise ValueError("total() is for counter/gauge; use sum/count")
        with self._lock:
            children = list(self._children.values())
        return sum(c.value for c in children)

    def max_value(self) -> float:
        """Max over every labeled child (counter/gauge families) — the
        worst-of reading gauge SLOs evaluate (obs/slo.py): on a fleet-
        federated registry the stalest worker governs, and on the
        single-child process gauge this equals the value. Children
        never written don't vote (a registered-but-unset gauge must
        not read as a healthy 0)."""
        if self.kind == "histogram":
            raise ValueError("max_value() is for counter/gauge")
        with self._lock:
            children = list(self._children.values())
        written = [c.value for c in children
                   if getattr(c, "_touched", True)]
        return max(written) if written else 0.0

    def has_samples(self) -> bool:
        """Gauge families: True when any child was ever written.
        Registration alone creates a 0.0-valued child, and a consumer
        deciding health from the value (the staleness SLO) must be able
        to tell "never populated" from "genuinely zero"."""
        if self.kind != "gauge":
            raise ValueError("has_samples() is for gauges")
        with self._lock:
            children = list(self._children.values())
        return any(c._touched for c in children)

    def cumulative_below(
            self, bound: float,
            labels: Optional[Dict[str, str]] = None) -> Tuple[int, int]:
        """Histogram families only: ``(observations <= the largest bucket
        bound <= ``bound``, total observations)`` summed over every
        labeled child. The SLO engine's good/bad split reads this — a
        threshold between bucket bounds rounds DOWN to the next bound, so
        the good count is never overstated (an SLO can flag early, never
        late). ``labels`` restricts the sum to children matching every
        given label value — per-tenant SLO specs (obs/slo.py) evaluate
        ``{"tenant": <id>}`` slices of the shared latency family."""
        if self.kind != "histogram":
            raise ValueError("cumulative_below() is for histograms")
        # number of bucket counts at bounds <= bound (bisect_right: an
        # exact bound match includes its own le bucket)
        k = bisect.bisect_right(self._buckets, bound)
        with self._lock:
            if labels:
                if any(ln not in self.labelnames for ln in labels):
                    # an unlabeled (or differently-labeled) declaration
                    # of the family has no matching slice — report NO
                    # DATA (0, 0), never a crash: a per-tenant SLO spec
                    # must degrade cleanly on a pre-tenancy process
                    return 0, 0
                idx = [self.labelnames.index(ln) for ln in labels]
                want = [str(labels[ln]) for ln in labels]
                children = [
                    c for key, c in self._children.items()
                    if all(key[i] == w for i, w in zip(idx, want))
                ]
            else:
                children = list(self._children.values())
        below = total = 0
        for child in children:
            counts, _sum, count = child.snapshot()
            below += sum(counts[:k])
            total += count
        return below, total

    def quantile_over_children(self, q: float) -> Optional[float]:
        """Histogram families only: one quantile over the SUM of every
        labeled child's buckets (the dashboard's cross-engine panels
        collapse the ``engine`` label with this). None when empty."""
        if self.kind != "histogram":
            raise ValueError("quantile_over_children() is for histograms")
        with self._lock:
            children = list(self._children.values())
        if not children:
            return None
        merged = _HistogramChild(self._buckets)
        for child in children:
            counts, csum, count = child.snapshot()
            for i, c in enumerate(counts):
                merged._counts[i] += c
            merged._sum += csum
            merged._count += count
        return merged.quantile(q)

    def exemplars(self) -> List[Dict]:
        """Histogram families only: every child's current exemplars as
        JSON-ready dicts (the flight recorder's full-dump block and the
        incident bundle's trace links read this)."""
        if self.kind != "histogram":
            raise ValueError("exemplars() is for histograms")
        with self._lock:
            items = sorted(self._children.items())
        out: List[Dict] = []
        for key, child in items:
            for le, tid, v, ts in child.exemplars():
                out.append({
                    "labels": dict(zip(self.labelnames, key)),
                    "le": ("+Inf" if math.isinf(le) else le),
                    "traceId": tid,
                    "value": v,
                    "ts": round(ts, 3),
                })
        return out

    # -- exposition ---------------------------------------------------------
    def _label_str(self, key: Tuple[str, ...],
                   extra: str = "") -> str:
        parts = [f'{ln}="{_escape_label(lv)}"'
                 for ln, lv in zip(self.labelnames, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def expose_into(self, out: List[str]) -> None:
        out.append(f"# HELP {self.name} {_escape_help(self.help)}")
        out.append(f"# TYPE {self.name} {self.kind}")
        with self._lock:
            items = sorted(self._children.items())
        for key, child in items:
            if self.kind in ("counter", "gauge"):
                out.append(
                    f"{self.name}{self._label_str(key)} "
                    f"{_fmt(child.value)}")
            else:
                counts, total_sum, total = child.snapshot()
                # exemplar annotations ride the bucket lines they
                # belong to (OpenMetrics syntax; docs/observability.md)
                ex_by_le = {le: (tid, v, ts)
                            for le, tid, v, ts in child.exemplars()}
                cum = 0
                for bound, c in zip(self._buckets, counts):
                    cum += c
                    le = 'le="' + _fmt(bound) + '"'
                    line = (f"{self.name}_bucket"
                            f"{self._label_str(key, le)} {cum}")
                    ex = ex_by_le.get(bound)
                    if ex is not None:
                        line += " " + format_exemplar(*ex)
                    out.append(line)
                inf = 'le="+Inf"'
                line = (f"{self.name}_bucket"
                        f"{self._label_str(key, inf)} {total}")
                ex = ex_by_le.get(float("inf"))
                if ex is not None:
                    line += " " + format_exemplar(*ex)
                out.append(line)
                out.append(
                    f"{self.name}_sum{self._label_str(key)} "
                    f"{_fmt(total_sum)}")
                out.append(
                    f"{self.name}_count{self._label_str(key)} {total}")


Counter = Gauge = Histogram = _Metric  # type aliases for annotations


class Registry:
    """Named metrics + scrape-time collectors.

    ``counter``/``gauge``/``histogram`` are get-or-create: the second
    registration of a name returns the SAME metric (servers restart
    inside one test process), but a kind or label-set mismatch raises —
    two subsystems silently sharing a misdeclared series is how scrapes
    lie. Collectors are named callbacks run at scrape time, for state
    that lives elsewhere (native counters, queue depths): registering
    the same name again replaces the old callback, so re-created
    backends never accumulate dead hooks.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: Dict[str, Callable[[], None]] = {}

    def _get_or_create(self, name: str, help: str, kind: str,
                       labels: Sequence[str],
                       buckets: Optional[Sequence[float]] = None) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if existing.kind != kind or existing.labelnames != tuple(
                        labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}{existing.labelnames}")
                if (kind == "histogram" and buckets is not None
                        and tuple(buckets) != existing._buckets):
                    # two subsystems binning one series by different
                    # bounds would silently produce lying quantiles
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {existing._buckets}")
                return existing
            m = _Metric(name, help, kind, labels, buckets)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str,
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(name, help, "counter", labels)

    def gauge(self, name: str, help: str,
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(name, help, "gauge", labels)

    def histogram(self, name: str, help: str, labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(name, help, "histogram", labels, buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def register_collector(self, name: str,
                           fn: Callable[[], None]) -> None:
        with self._lock:
            self._collectors[name] = fn

    def unregister_collector(self, name: str) -> None:
        with self._lock:
            self._collectors.pop(name, None)

    def run_collectors(self) -> None:
        """Run the scrape-time collectors without rendering (the
        freshness controller reads collector-fed gauges — model
        staleness, queue depth — between scrapes; a failing collector
        logs and is skipped, same contract as ``expose``)."""
        with self._lock:
            collectors = list(self._collectors.items())
        for cname, fn in collectors:
            try:
                fn()
            except Exception:
                logger.exception("metrics collector %r failed", cname)

    def expose(self) -> str:
        """Prometheus text exposition of every metric, after running
        the collectors (a failing collector logs and is skipped — a
        broken bridge must never take down the scrape)."""
        self.run_collectors()
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        out: List[str] = []
        for m in metrics:
            m.expose_into(out)
        return "\n".join(out) + "\n"


#: the process-wide default registry — one scrape sees the whole system
REGISTRY = Registry()
