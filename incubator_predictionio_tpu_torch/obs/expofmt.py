"""Prometheus text-exposition parsing — the grammar the registry emits.

The port's own copy of incubator_predictionio_tpu/obs/expofmt.py.

Promoted from the ``tests/test_obs.py`` conformance oracle when the
federation layer (obs/federate.py) needed to *consume* worker
``/metrics`` scrapes, not just emit them: one strict mini-parser is now
both the test oracle and the production ingest path, so the emitter and
the parser can never drift apart silently — a malformed scrape fails
the federating admin exactly as loudly as it fails the test suite.

Two views of the same text:

- :func:`parse_exposition` — the flat oracle view ``(types, samples)``
  the conformance tests assert against;
- :func:`parse_families` — the structured view federation merges:
  per-family kind/help plus per-labelset values, with histogram
  children reassembled into (bounds, cumulative counts, sum, count).

Malformed input raises :class:`MalformedExposition` — an
``AssertionError`` subclass, so callers that treated the oracle's
``assert`` failures as the malformed-scrape signal keep working, while
the raise survives ``python -O``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, FrozenSet, List, Optional, Tuple

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
    # optional label set; quoted values may hold ANY escaped content,
    # including braces (route patterns like /cmd/app/{name})
    r'(\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*\})?'
    r" (-?(?:[0-9]*\.?[0-9]+(?:e[+-]?[0-9]+)?)|[+-]Inf|NaN)"
    # optional OpenMetrics-style exemplar annotation. Captured RAW and
    # passed through verbatim: a future emitter's richer annotation
    # must survive a federate round trip byte-stable even when this
    # parser cannot interpret it (docs/observability.md exemplars)
    r"(?: (# \{.*))?$")
_LABEL_ITEM_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

#: the annotation grammar THIS repo emits (obs/metrics.format_exemplar):
#: ``# {labels} value [timestamp]`` — anything else stays raw-only
_EXEMPLAR_RE = re.compile(
    r'^# (\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*\})'
    r" (-?(?:[0-9]*\.?[0-9]+(?:e[+-]?[0-9]+)?)|[+-]Inf|NaN)"
    r"(?: ([0-9]+(?:\.[0-9]+)?))?$")

_SUFFIX_RE = re.compile(r"_(bucket|sum|count)$")

#: one labeled sample: (name, frozenset of (label, value) items) → float
Samples = Dict[Tuple[str, FrozenSet[Tuple[str, str]]], float]


class MalformedExposition(AssertionError):
    """A line violated the text-format grammar (or a histogram lost an
    invariant). AssertionError subclass: the test oracle's callers
    catch AssertionError; production callers catch this by name."""


def _require(cond: bool, message: str) -> None:
    if not cond:
        raise MalformedExposition(message)


_ESCAPE_RE = re.compile(r"\\(.)")


def unescape_label_value(v: str) -> str:
    """Undo the exposition escaping (``\\\\``, ``\\"``, ``\\n``) so a
    re-exposed federated series does not double-escape. One
    left-to-right pass — sequential ``str.replace`` calls would corrupt
    a value like ``C:\\\\network`` (the unescaped backslash would feed
    the later ``\\n`` replacement)."""
    return _ESCAPE_RE.sub(
        lambda m: "\n" if m.group(1) == "n" else m.group(1), v)


def parse_exposition(text: str) -> Tuple[Dict[str, str], Samples]:
    """Validate + parse: returns ``(types, samples)`` where samples maps
    ``(name, frozenset(label items))`` → float. Raises
    :class:`MalformedExposition` on any line that violates the
    text-format grammar. Label values stay in their ESCAPED wire form
    (oracle compatibility); :func:`parse_families` unescapes. Exemplar
    annotations are accepted and dropped here (the flat oracle view);
    :func:`parse_families` carries them."""
    types, _helps, samples, _ex = _parse(text)
    return types, samples


#: raw exemplar annotations by sample: (name, ESCAPED labelset) → raw
RawExemplars = Dict[Tuple[str, FrozenSet[Tuple[str, str]]], str]


def _parse(text: str) -> Tuple[Dict[str, str], Dict[str, str], Samples,
                               RawExemplars]:
    """The one line-level pass: ``(types, helps, samples, exemplars)``."""
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    samples: Samples = {}
    exemplars: RawExemplars = {}
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, h = rest.partition(" ")
            helps[name] = h
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, t = rest.partition(" ")
            _require(t in ("counter", "gauge", "histogram"), line)
            types[name] = t
            continue
        _require(not line.startswith("#"), f"unknown comment: {line}")
        m = _SAMPLE_RE.match(line)
        _require(m is not None, f"malformed sample line: {line!r}")
        name, labelblob, value, raw_ex = m.groups()
        labels = frozenset(_LABEL_ITEM_RE.findall(labelblob or ""))
        v = float("inf") if value == "+Inf" else float(value)
        samples[(name, labels)] = v
        if raw_ex is not None:
            # stored RAW, understood or not — pass-through is the
            # contract (an exemplar this parser cannot interpret must
            # still survive re-exposition byte-stable)
            exemplars[(name, labels)] = raw_ex
    # every sample's family must be declared (histogram children map to
    # their family name)
    for (name, _), _v in samples.items():
        family = _SUFFIX_RE.sub("", name)
        _require(name in types or family in types, name)
    return types, helps, samples, exemplars


def parse_exemplar(raw: str) -> Optional[Tuple[Dict[str, str], float,
                                               Optional[float]]]:
    """Structured view of one raw exemplar annotation:
    ``({label: value}, exemplar value, wall ts or None)`` when it
    matches the grammar this repo emits, None otherwise (the caller
    keeps the raw string either way — pass-through survives)."""
    m = _EXEMPLAR_RE.match(raw)
    if m is None:
        return None
    labelblob, value, ts = m.groups()
    labels = {k: unescape_label_value(v)
              for k, v in _LABEL_ITEM_RE.findall(labelblob)}
    v = float("inf") if value == "+Inf" else float(value)
    return labels, v, (float(ts) if ts is not None else None)


def histogram_series(
    samples: Samples, name: str,
    labels: FrozenSet[Tuple[str, str]] = frozenset(),
) -> Tuple[List[Tuple[float, float]], float, float]:
    """``(sorted [(le, cumulative)], sum, count)`` for one histogram
    child (the oracle helper, unchanged semantics)."""
    buckets = []
    for (n, ls), v in samples.items():
        if n == f"{name}_bucket" and labels <= ls:
            le = dict(ls)["le"]
            buckets.append((float("inf") if le == "+Inf" else float(le), v))
    buckets.sort()
    total = samples[(f"{name}_count", labels)]
    s = samples[(f"{name}_sum", labels)]
    return buckets, s, total


# ---------------------------------------------------------------------------
# structured family view (the federation ingest shape)
# ---------------------------------------------------------------------------

#: a labelset with unescaped values, le stripped for histogram children
LabelSet = FrozenSet[Tuple[str, str]]


@dataclasses.dataclass
class HistogramChild:
    """One histogram time series: ascending ``(le, cumulative)`` pairs
    (the +Inf bucket implied by ``count``), plus sum and count.
    ``exemplars`` maps a bucket's ``le`` bound to the RAW annotation
    string that rode its exposition line (pass-through contract);
    :func:`parse_exemplar` gives the structured view of each."""

    buckets: List[Tuple[float, float]]
    sum: float
    count: float
    exemplars: Dict[float, str] = dataclasses.field(default_factory=dict)

    def exemplar_trace_ids(self) -> List[Tuple[float, str]]:
        """``(le, trace_id)`` for every exemplar whose annotation this
        repo's grammar understands — the incident bundle's "which
        queries were the p99" linkage."""
        out: List[Tuple[float, str]] = []
        for le, raw in sorted(self.exemplars.items()):
            parsed = parse_exemplar(raw)
            if parsed is not None and "trace_id" in parsed[0]:
                out.append((le, parsed[0]["trace_id"]))
        return out

    def per_bucket(self) -> List[Tuple[float, float]]:
        """De-cumulated ``(le, count-in-bucket)`` pairs, finite bounds
        only; the overflow bucket is ``count - cum(last bound)``."""
        out: List[Tuple[float, float]] = []
        prev = 0.0
        for le, cum in self.buckets:
            if le == float("inf"):
                continue
            out.append((le, cum - prev))
            prev = cum
        return out

    def overflow(self) -> float:
        finite = [c for le, c in self.buckets if le != float("inf")]
        return self.count - (finite[-1] if finite else 0.0)


@dataclasses.dataclass
class Family:
    """One parsed metric family."""

    name: str
    kind: str
    help: str = ""
    #: counter/gauge children: labelset → value
    values: Dict[LabelSet, float] = dataclasses.field(default_factory=dict)
    #: histogram children: labelset (without ``le``) → HistogramChild
    histograms: Dict[LabelSet, HistogramChild] = dataclasses.field(
        default_factory=dict)
    #: raw exemplar annotations on counter/gauge samples (labelset →
    #: raw) — nothing in-repo emits these today, but a foreign scrape's
    #: annotations must pass through, not crash the federation
    exemplars: Dict[LabelSet, str] = dataclasses.field(
        default_factory=dict)


def _unescaped(labels: FrozenSet[Tuple[str, str]]) -> LabelSet:
    return frozenset((k, unescape_label_value(v)) for k, v in labels)


def parse_families(text: str) -> Dict[str, Family]:
    """The structured view: families with kind/help and reassembled
    histogram children. Raises :class:`MalformedExposition` like
    :func:`parse_exposition`; additionally requires every histogram
    child to carry its ``_sum``/``_count`` series."""
    types, helps, samples, raw_ex = _parse(text)

    out: Dict[str, Family] = {}
    for name, kind in types.items():
        out[name] = Family(name=name, kind=kind, help=helps.get(name, ""))
    # histogram assembly state: family → child labelset → {le: cum}
    hist_buckets: Dict[str, Dict[LabelSet, Dict[float, float]]] = {}
    hist_sums: Dict[str, Dict[LabelSet, float]] = {}
    hist_counts: Dict[str, Dict[LabelSet, float]] = {}
    hist_ex: Dict[str, Dict[LabelSet, Dict[float, str]]] = {}
    for (name, labels), v in samples.items():
        if name in types:
            fam = out[name]
            if fam.kind == "histogram":
                # a bare sample under a histogram family name is not
                # part of the text format
                raise MalformedExposition(
                    f"bare sample {name!r} under histogram family")
            fam.values[_unescaped(labels)] = v
            ex = raw_ex.get((name, labels))
            if ex is not None:
                fam.exemplars[_unescaped(labels)] = ex
            continue
        family = _SUFFIX_RE.sub("", name)
        suffix = name[len(family) + 1:]
        _require(out.get(family) is not None
                 and out[family].kind == "histogram",
                 f"sample {name!r} without a histogram family")
        if suffix == "bucket":
            le_raw = dict(labels).get("le")
            _require(le_raw is not None, f"bucket without le: {name}")
            le = float("inf") if le_raw == "+Inf" else float(le_raw)
            child = _unescaped(frozenset(
                (k, v2) for k, v2 in labels if k != "le"))
            hist_buckets.setdefault(family, {}).setdefault(
                child, {})[le] = v
            ex = raw_ex.get((name, labels))
            if ex is not None:
                hist_ex.setdefault(family, {}).setdefault(
                    child, {})[le] = ex
        elif suffix == "sum":
            hist_sums.setdefault(family, {})[_unescaped(labels)] = v
        else:  # count
            hist_counts.setdefault(family, {})[_unescaped(labels)] = v
    for family, children in hist_buckets.items():
        for child, by_le in children.items():
            s = hist_sums.get(family, {}).get(child)
            c = hist_counts.get(family, {}).get(child)
            _require(s is not None and c is not None,
                     f"histogram {family!r} child missing _sum/_count")
            buckets = sorted(by_le.items())
            # cumulative monotonicity — a torn scrape must fail loudly
            cums = [cum for _le, cum in buckets]
            _require(all(a <= b for a, b in zip(cums, cums[1:])),
                     f"non-monotone buckets in {family!r}")
            out[family].histograms[child] = HistogramChild(
                buckets=buckets, sum=s, count=c,
                exemplars=hist_ex.get(family, {}).get(child, {}))
    return out


__all__ = [
    "Family", "HistogramChild", "MalformedExposition", "Samples",
    "histogram_series", "parse_exemplar", "parse_exposition",
    "parse_families", "unescape_label_value",
]
