"""Metrics federation — one scrape for the whole serving fleet.

The port's own copy of incubator_predictionio_tpu/obs/federate.py,
its imports pointed at this package.

A multi-worker deployment (N prediction servers behind a balancer, a
storage box, an event server) has N registries and therefore N truths:
no single ``/metrics`` answer carries the fleet p99 or the summed queue
depth the load-shedder (ROADMAP-2) and the freshness controller
(ROADMAP-3) need. This module gives the admin server that one answer:

- ``PIO_FLEET_TARGETS`` names the worker ``/metrics`` endpoints
  (comma-separated ``host:port``, full URLs, or ``name=host:port`` to
  pick the instance label);
- :func:`federate` scrapes them all, parses each exposition with the
  promoted grammar parser (obs/expofmt.py) and merges the families
  under an added ``instance`` label;
- ``GET /federate`` on the admin server re-exposes the merged families
  as one exposition — ``pio_query_latency_seconds`` fleet p99 is then
  one bucket-sum away for any consumer, and this module's
  :class:`FederatedMetric` does that math directly for in-process
  consumers;
- :class:`FleetRegistry` is a Registry-shaped view over a (re-scraped,
  age-bounded) snapshot, so the SLO burn-rate engine evaluates its
  objectives over the FLEET exactly as it does over one process
  (``GET /slo?fleet=1``).

Instance label semantics: the value is the configured target (or its
``name=`` alias) — a BOUNDED, operator-declared set, one per worker.
Scrape failures never fail the federation: a down worker is reported as
``pio_federate_up{instance}`` 0 and its series are simply absent, which
is itself the signal.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
import urllib.request
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from incubator_predictionio_tpu_torch.obs import expofmt
from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
from incubator_predictionio_tpu_torch.obs import trace as obs_trace

logger = logging.getLogger(__name__)

#: the label federation adds to every merged series
INSTANCE_LABEL = "instance"

#: families the federator itself synthesizes about the scrape
_UP_NAME = "pio_federate_up"
_SCRAPE_SECONDS_NAME = "pio_federate_scrape_seconds"

#: the admin process's OWN record of scrape health over time (the
#: /federate output only shows the LAST pass; this counter accumulates,
#: so a flapping worker is visible from the admin's /metrics). The
#: instance label value comes from the operator's PIO_FLEET_TARGETS —
#: bounded by fleet size, not wire data (metric-label-cardinality
#: baseline entry records the justification).
_SCRAPES_TOTAL = obs_metrics.REGISTRY.counter(
    "pio_federate_scrapes_total",
    "federation scrapes by instance and outcome",
    labels=("instance", "outcome"))


@dataclasses.dataclass(frozen=True)
class Target:
    """One worker endpoint: the instance label value + scrape URL."""

    instance: str
    url: str


def parse_targets(spec: str) -> List[Target]:
    """``PIO_FLEET_TARGETS`` grammar: comma-separated entries, each a
    ``host:port``, a full ``http://...`` URL (path defaults to
    ``/metrics``), optionally prefixed ``name=`` to choose the instance
    label. Whitespace around entries is ignored."""
    out: List[Target] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name: Optional[str] = None
        # a "name=" prefix can only sit BEFORE any scheme or authority
        # (URLs never carry "=" before "://")
        eq = entry.find("=")
        scheme = entry.find("://")
        if eq != -1 and (scheme == -1 or eq < scheme):
            name, entry = entry.split("=", 1)
            name = name.strip()
            entry = entry.strip()
        if "://" not in entry:
            url = f"http://{entry}"
        else:
            url = entry
        # default path: the shared /metrics route
        scheme_rest = url.split("://", 1)
        if "/" not in scheme_rest[1]:
            url = url + "/metrics"
        out.append(Target(instance=name or scheme_rest[1].split("/")[0],
                          url=url))
    return out


def fleet_targets() -> List[Target]:
    """The configured fleet, re-read per call so a live admin can be
    retargeted without a restart."""
    return parse_targets(os.environ.get("PIO_FLEET_TARGETS", ""))


def scrape_timeout_s() -> float:
    try:
        return float(os.environ.get("PIO_FLEET_SCRAPE_TIMEOUT_S", "") or 5.0)
    except ValueError:
        return 5.0


@dataclasses.dataclass
class ScrapeResult:
    target: Target
    ok: bool
    wall_s: float
    families: Dict[str, expofmt.Family]
    error: Optional[str] = None


def scrape_target(target: Target,
                  timeout: Optional[float] = None) -> ScrapeResult:
    """One worker scrape → parsed families. Never raises: a down or
    malformed worker comes back ``ok=False`` with the error string (the
    federation must degrade per-instance, not per-fleet). The request
    forwards the ambient trace headers, so an operator's traced
    ``GET /federate`` shows up in every worker's span log as a child
    hop (admin → workers)."""
    t0 = time.perf_counter()
    try:
        req = urllib.request.Request(
            target.url, headers=dict(obs_trace.client_headers()))
        with urllib.request.urlopen(
                req, timeout=timeout if timeout is not None
                else scrape_timeout_s()) as resp:
            text = resp.read().decode("utf-8")
        families = expofmt.parse_families(text)
        _SCRAPES_TOTAL.labels(instance=target.instance,
                              outcome="ok").inc()
        return ScrapeResult(target=target, ok=True,
                            wall_s=time.perf_counter() - t0,
                            families=families)
    except Exception as e:  # noqa: BLE001 — per-instance degradation
        logger.warning("federate scrape of %s (%s) failed: %s",
                       target.instance, target.url, e)
        _SCRAPES_TOTAL.labels(instance=target.instance,
                              outcome="error").inc()
        return ScrapeResult(target=target, ok=False,
                            wall_s=time.perf_counter() - t0,
                            families={}, error=str(e))


class FederatedMetric:
    """One metric family merged across instances — Registry-metric-
    shaped (``kind``/``total``/``max_value``/``has_samples``/
    ``cumulative_below``/``quantile``), so the SLO engine and the
    dashboard helpers evaluate fleet state through the same protocol
    they use on the process registry."""

    def __init__(self, name: str, kind: str, help: str = "") -> None:
        self.name = name
        self.kind = kind
        self.help = help
        #: (instance, labelset) → value, counter/gauge families
        self.values: Dict[Tuple[str, expofmt.LabelSet], float] = {}
        #: (instance, labelset) → HistogramChild
        self.histograms: Dict[Tuple[str, expofmt.LabelSet],
                              expofmt.HistogramChild] = {}
        #: raw exemplar annotations on counter/gauge samples, carried
        #: for re-exposition (histogram exemplars ride their
        #: HistogramChild). Pass-through: never interpreted here.
        self.value_exemplars: Dict[Tuple[str, expofmt.LabelSet],
                                   str] = {}

    # -- merge ------------------------------------------------------------
    def absorb(self, instance: str, fam: expofmt.Family) -> None:
        for labels, v in fam.values.items():
            self.values[(instance, labels)] = v
        for labels, child in fam.histograms.items():
            self.histograms[(instance, labels)] = child
        for labels, raw in fam.exemplars.items():
            self.value_exemplars[(instance, labels)] = raw

    def exemplar_trace_ids(self) -> List[Tuple[str, float, str]]:
        """``(instance, le, trace_id)`` across every instance's
        histogram children — an exemplar-free old worker simply
        contributes nothing (clean degradation, pinned in tests)."""
        out: List[Tuple[str, float, str]] = []
        for (inst, _labels), child in sorted(self.histograms.items()):
            for le, tid in child.exemplar_trace_ids():
                out.append((inst, le, tid))
        return out

    # -- counter/gauge math ------------------------------------------------
    def total(self) -> float:
        """Sum over every instance and labelset (the fleet-summed
        reading: total queue depth, total requests)."""
        if self.kind == "histogram":
            raise ValueError("total() is for counter/gauge")
        return sum(self.values.values())

    def max_value(self) -> float:
        """Max over instances/labelsets — the worst-of reading gauge
        SLOs need (fleet staleness = the stalest worker, not the sum)."""
        if self.kind == "histogram":
            raise ValueError("max_value() is for counter/gauge")
        return max(self.values.values()) if self.values else 0.0

    def has_samples(self) -> bool:
        """Exposition shows no touched/untouched bit, so any exposed
        child counts as a sample — a worker that registered a gauge
        without writing it reads 0.0 here. Document, don't guess."""
        return bool(self.values)

    # -- histogram math ----------------------------------------------------
    def _merged_buckets(
            self, labels: Optional[Dict[str, str]] = None
    ) -> Tuple[List[Tuple[float, float]], float, float]:
        """(ascending per-bucket [(le, count)], overflow, total) summed
        over every instance/child — the fleet histogram. ``labels``
        restricts the merge to children carrying every given label
        pair (the per-tenant SLO slice; a pre-tenancy worker's
        unlabeled children simply don't match)."""
        want = frozenset((k, str(v)) for k, v in labels.items()) \
            if labels else None
        by_le: Dict[float, float] = {}
        overflow = 0.0
        total = 0.0
        for (_inst, ls), child in self.histograms.items():
            if want is not None and not want <= ls:
                continue
            for le, c in child.per_bucket():
                by_le[le] = by_le.get(le, 0.0) + c
            overflow += child.overflow()
            total += child.count
        return sorted(by_le.items()), overflow, total

    def cumulative_below(
            self, bound: float,
            labels: Optional[Dict[str, str]] = None) -> Tuple[int, int]:
        """(observations ≤ the largest bucket bound ≤ ``bound``, total)
        over the merged fleet buckets — same round-DOWN contract as
        ``obs.metrics._Metric.cumulative_below`` (never overstate the
        good count). ``labels`` slices to matching children."""
        if self.kind != "histogram":
            raise ValueError("cumulative_below() is for histograms")
        buckets, _overflow, total = self._merged_buckets(labels)
        below = 0.0
        for le, c in buckets:
            if le <= bound:
                below += c
        return int(below), int(total)

    def quantile(self, q: float) -> Optional[float]:
        """Fleet quantile from the merged buckets (linear interpolation
        within a bucket, Prometheus ``histogram_quantile`` style; the
        overflow clamps to the last finite bound). None when empty."""
        if self.kind != "histogram":
            raise ValueError("quantile() is for histograms")
        buckets, _overflow, total = self._merged_buckets()
        if total <= 0:
            return None
        rank = q * total
        cum = 0.0
        prev_le = 0.0
        for le, c in buckets:
            if c > 0 and cum + c >= rank:
                return prev_le + (le - prev_le) * max(
                    rank - cum, 0.0) / c
            cum += c
            prev_le = le
        return buckets[-1][0] if buckets else None

    # dashboard parity: the process registry's cross-child quantile
    quantile_over_children = quantile

    @property
    def count(self) -> float:
        if self.kind != "histogram":
            raise ValueError("count is for histograms")
        return sum(c.count for c in self.histograms.values())

    @property
    def sum(self) -> float:
        if self.kind != "histogram":
            raise ValueError("sum is for histograms")
        return sum(c.sum for c in self.histograms.values())


class FederatedSnapshot:
    """One federation pass: per-instance scrape outcomes + the merged
    metric families. ``get(name)`` is Registry-shaped."""

    def __init__(self, results: Sequence[ScrapeResult]) -> None:
        self.results = list(results)
        self.taken_at = time.monotonic()
        self._metrics: Dict[str, FederatedMetric] = {}
        for res in self.results:
            for name, fam in res.families.items():
                merged = self._metrics.get(name)
                if merged is None:
                    merged = FederatedMetric(name, fam.kind, fam.help)
                    self._metrics[name] = merged
                elif merged.kind != fam.kind:
                    # two workers disagree on a family's kind: merging
                    # would produce a lying series — keep the first
                    # kind, drop the dissenter's children, say so
                    logger.warning(
                        "federate: %s is %s on %s but %s elsewhere; "
                        "dropping the mismatched instance's series",
                        name, fam.kind, res.target.instance, merged.kind)
                    continue
                merged.absorb(res.target.instance, fam)

    def get(self, name: str) -> Optional[FederatedMetric]:
        return self._metrics.get(name)

    def up_instances(self) -> List[str]:
        return [r.target.instance for r in self.results if r.ok]

    # -- re-exposition -----------------------------------------------------
    def expose(self) -> str:
        """The fleet as ONE exposition: every merged series re-emitted
        with the ``instance`` label prepended, plus the federation's
        own ``pio_federate_up{instance}`` / scrape-wall series. The
        output round-trips through the same grammar parser that read
        the inputs (pinned in tests/test_federation.py)."""
        esc = obs_metrics._escape_label
        out: List[str] = []

        def label_str(instance: str, labels: expofmt.LabelSet,
                      extra: str = "") -> str:
            parts = [f'{INSTANCE_LABEL}="{esc(instance)}"']
            parts.extend(f'{k}="{esc(v)}"'
                         for k, v in sorted(labels))
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}"

        out.append(f"# HELP {_UP_NAME} 1 when the instance's /metrics "
                   "scrape succeeded, else 0")
        out.append(f"# TYPE {_UP_NAME} gauge")
        for res in self.results:
            out.append(
                f"{_UP_NAME}{label_str(res.target.instance, frozenset())} "
                f"{1 if res.ok else 0}")
        out.append(f"# HELP {_SCRAPE_SECONDS_NAME} wall of the "
                   "instance's /metrics scrape")
        out.append(f"# TYPE {_SCRAPE_SECONDS_NAME} gauge")
        for res in self.results:
            out.append(
                f"{_SCRAPE_SECONDS_NAME}"
                f"{label_str(res.target.instance, frozenset())} "
                f"{obs_metrics._fmt(round(res.wall_s, 6))}")

        for name in sorted(self._metrics):
            m = self._metrics[name]
            out.append(f"# HELP {name} "
                       f"{obs_metrics._escape_help(m.help)}")
            out.append(f"# TYPE {name} {m.kind}")
            if m.kind in ("counter", "gauge"):
                for (inst, labels), v in sorted(m.values.items()):
                    line = (f"{name}{label_str(inst, labels)} "
                            f"{obs_metrics._fmt(v)}")
                    raw_ex = m.value_exemplars.get((inst, labels))
                    if raw_ex is not None:
                        line += " " + raw_ex
                    out.append(line)
            else:
                for (inst, labels), child in sorted(m.histograms.items()):
                    for le, cum in child.buckets:
                        if le == float("inf"):
                            continue
                        le_s = 'le="' + obs_metrics._fmt(le) + '"'
                        line = (
                            f"{name}_bucket"
                            f"{label_str(inst, labels, le_s)} "
                            f"{obs_metrics._fmt(cum)}")
                        # exemplars ride federation VERBATIM — the raw
                        # annotation string, understood or not, so a
                        # fleet /federate scrape still names the
                        # breaching workers' trace IDs byte-stable
                        raw_ex = child.exemplars.get(le)
                        if raw_ex is not None:
                            line += " " + raw_ex
                        out.append(line)
                    inf_s = 'le="+Inf"'
                    line = (
                        f"{name}_bucket"
                        f"{label_str(inst, labels, inf_s)} "
                        f"{obs_metrics._fmt(child.count)}")
                    raw_ex = child.exemplars.get(float("inf"))
                    if raw_ex is not None:
                        line += " " + raw_ex
                    out.append(line)
                    out.append(f"{name}_sum{label_str(inst, labels)} "
                               f"{obs_metrics._fmt(child.sum)}")
                    out.append(f"{name}_count{label_str(inst, labels)} "
                               f"{obs_metrics._fmt(child.count)}")
        return "\n".join(out) + "\n"


def federate(targets: Optional[Sequence[Target]] = None,
             timeout: Optional[float] = None) -> FederatedSnapshot:
    """Scrape every target (sequentially — fleets this serves are tens
    of workers, and the admin's /federate handler already runs on the
    executor) and merge. Raises ValueError when no targets are
    configured: an empty federation is a misconfiguration, not a
    healthy empty fleet."""
    targets = list(targets if targets is not None else fleet_targets())
    if not targets:
        raise ValueError(
            "no federation targets: set PIO_FLEET_TARGETS "
            "(comma-separated host:port of worker /metrics endpoints)")
    return FederatedSnapshot(
        [scrape_target(t, timeout=timeout) for t in targets])


class FleetRegistry:
    """Registry-shaped view over an age-bounded federated snapshot.

    ``get(name)`` re-scrapes the fleet when the cached snapshot is
    older than ``max_age_s`` — the SLO engine's per-tick ``get`` calls
    then cost one fleet scrape per evaluation burst, not one per
    objective."""

    def __init__(self, targets_fn: Callable[[], Sequence[Target]]
                 = fleet_targets,
                 max_age_s: float = 5.0,
                 timeout: Optional[float] = None) -> None:
        self._targets_fn = targets_fn
        self.max_age_s = max_age_s
        self._timeout = timeout
        self._snapshot: Optional[FederatedSnapshot] = None

    def refresh(self, force: bool = False) -> FederatedSnapshot:
        snap = self._snapshot
        if (force or snap is None
                or time.monotonic() - snap.taken_at > self.max_age_s):
            snap = federate(self._targets_fn(), timeout=self._timeout)
            self._snapshot = snap
        return snap

    def get(self, name: str) -> Optional[FederatedMetric]:
        return self.refresh().get(name)


# ---------------------------------------------------------------------------
# fleet SLO engine (the "evaluate objectives over the federation" mode)
# ---------------------------------------------------------------------------

_fleet_engine = None
_fleet_engine_lock = threading.Lock()


def fleet_slo_engine():
    """Process-wide SLO engine whose registry IS the federation: same
    objectives, same burn-rate math, evaluated over the merged fleet
    series (``GET /slo?fleet=1`` on the admin server). Lazy — nothing
    scrapes until the first evaluation. Does NOT export to the admin's
    own ``pio_slo_burn_rate`` gauges (``export_gauges=False``): the
    fleet and process engines evaluate different populations, and
    sharing the series would let whichever ran last overwrite the
    other's meaning — fleet burn lives in the ``/slo?fleet=1`` JSON."""
    from incubator_predictionio_tpu_torch.obs import slo as obs_slo

    global _fleet_engine
    with _fleet_engine_lock:
        if _fleet_engine is None:
            _fleet_engine = obs_slo.SLOEngine(registry=FleetRegistry(),
                                              export_gauges=False)
        return _fleet_engine


def reset_fleet_engine() -> None:
    """Drop the fleet engine (tests re-read PIO_FLEET_TARGETS/PIO_SLO_*
    on next use)."""
    global _fleet_engine
    with _fleet_engine_lock:
        _fleet_engine = None


__all__ = [
    "FederatedMetric", "FederatedSnapshot", "FleetRegistry", "Target",
    "INSTANCE_LABEL", "federate", "fleet_slo_engine", "fleet_targets",
    "parse_targets", "reset_fleet_engine", "scrape_target",
]
