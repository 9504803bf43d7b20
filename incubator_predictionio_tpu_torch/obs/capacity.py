"""Capacity + regression model over the repo's bench trajectory.

The port's own copy of incubator_predictionio_tpu/obs/capacity.py, its
imports pointed at this package. Normalizing, classifying and comparing
records are the JAX package's, so both packages read every record in the
repo alike. One part differs: the ``BENCH_rNN.json`` /
``MULTICHIP_rNN.json`` records at the repo root are TPU runs of the JAX
package, and a card must not be sized from them. So the fit that feeds
the controllers' guards (obs/controller.py ``capacity_budget_fn``,
obs/knobs.py ``capacity_caps_fn``) and :func:`capacity_report`'s
``capacity`` block take only :func:`card_records`: records whose payload
names an NVIDIA device. With no such record both guards are absent.

Those walls become a **capacity model** — rows/chip at fixed
staleness — and the serving numbers a sizing rule (QPS per worker), the way ALX (arxiv
2112.02194) sizes sharded-MF deployments from measured per-chip
throughput and the pjit/TPUv4 scaling work (arxiv 2204.06514) treats
continuously-measured MFU as the regression gate.

Three jobs, all offline and dependency-free:

1. **Normalize** the trajectory. Records come in three shapes (the
   harness wrapper ``{n, cmd, rc, tail, parsed}``, the flat record,
   the MULTICHIP ``{n_devices, rc, ok, skipped, tail}``); every
   one normalizes to a :class:`NormalizedRecord`, and a record with no
   parsed payload gets a STRUCTURED ``skipped_reason`` classified from
   its tail/rc (the BENCH_r04 "accelerator init still blocked" rc=3 and
   BENCH_r05 rc=124 timeout-kill classes) — no record in the trajectory
   is ever unexplainable.
2. **Fit capacity**: rows-per-chip-per-second from the newest
   non-degraded training wall, projected to
   rows-per-chip-at-fixed-staleness (the retrain bound from
   ``PIO_SLO_STALENESS_S``), plus QPS-per-worker from the measured
   concurrent serving rate — with worker/chip projections for target
   loads.
3. **Regression verdict**: key-by-key tolerance compare of the newest
   parsed record against the pinned baseline
   (``CAPACITY_BASELINE.json`` at the repo root), skipping keys whose
   record value is null; keys are classified lower-is-better
   (walls, latencies, RMSE) vs higher-is-better (QPS, MFU, rates), and
   shape keys (nnz/rank/sweeps) must match or the compare is honestly
   ``incomparable_shape`` rather than silently green.

The JAX package's ``scripts/capacity_report.py`` is the CLI over its
own copy.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: the pinned regression baseline at the repo root
BASELINE_FILENAME = "CAPACITY_BASELINE.json"

#: trajectory record globs, repo-root relative
RECORD_GLOBS = ("BENCH_*.json", "MULTICHIP_*.json")

#: keys that define the measured shape — a compare across different
#: shapes is not a regression signal, it is a different experiment
SHAPE_KEYS = ("nnz", "rank", "sweeps")

#: key-direction classification for the tolerance compare. First match
#: wins; keys matching neither class are informational and skipped.
_LOWER_IS_BETTER_RE = re.compile(
    r"(_wall_s$|_s$|_ms$|rmse|^value$|_ns$|staleness)")
_HIGHER_IS_BETTER_RE = re.compile(
    r"(qps|eps$|_eps_|mfu|precision|vs_baseline|hit_rate|speedup|"
    r"flops)")


def key_direction(key: str) -> Optional[str]:
    """"lower" | "higher" | None (informational)."""
    if key in SHAPE_KEYS:
        return None
    if _HIGHER_IS_BETTER_RE.search(key):
        return "higher"
    if _LOWER_IS_BETTER_RE.search(key):
        return "lower"
    return None


# ---------------------------------------------------------------------------
# record normalization + failure classification
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class NormalizedRecord:
    name: str                       # file stem, e.g. "BENCH_r04"
    kind: str                       # "bench" | "multichip"
    round: Optional[int]            # rNN from the filename when present
    rc: Optional[int]
    parsed: Optional[Dict[str, Any]]
    degraded: Optional[bool]
    bench_env: Optional[Dict[str, Any]]
    skipped_reason: Optional[Dict[str, Any]]
    ok: Optional[bool] = None       # multichip pass/fail
    path: Optional[str] = None

    def summary(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "kind": self.kind,
            "round": self.round,
            "rc": self.rc,
            "degraded": self.degraded,
            "parsed": self.parsed is not None,
            "bench_env": self.bench_env,
            "skipped_reason": self.skipped_reason,
        }


#: (regex over the tail, failure class, human detail) — first match that
#: survives the rc-priority rules below names the class
_TAIL_CLASSES: Tuple[Tuple[re.Pattern, str, str], ...] = (
    (re.compile(r"accelerator init still blocked|"
                r"accelerator unavailable|"
                r"did not claim|no accelerator claim"),
     "accelerator_unavailable",
     "the accelerator never became claimable (stale chip lease class)"),
    (re.compile(r"Traceback \(most recent call last\)"),
     "harness_exception",
     "the run died on an unhandled exception"),
)


def classify_failure(tail: str, rc: Optional[int]) -> Dict[str, Any]:
    """Structured reason for a record with no parsed payload. Never
    returns None: the whole point is that every unparsed record carries
    an explanation (the acceptance contract of this module)."""
    tail = tail or ""
    matched: List[str] = []
    cls: Optional[str] = None
    detail: Optional[str] = None
    for pattern, klass, why in _TAIL_CLASSES:
        m = pattern.search(tail)
        if m:
            matched.append(m.group(0))
            if cls is None:
                cls, detail = klass, why
    if rc == 124:
        # the harness's timeout kill pre-empts everything else: whatever
        # was going wrong, the record is null because the kill landed
        # before the emit point (the BENCH_r05 class)
        return {
            "class": "driver_deadline",
            "detail": "driver timeout (rc=124) killed the run before a "
                      "record was emitted"
                      + (f"; while: {detail}" if detail else ""),
            "rc": rc,
            "matched": matched,
        }
    if cls is not None:
        return {"class": cls, "detail": detail, "rc": rc,
                "matched": matched}
    if rc not in (0, None):
        last = next((ln for ln in reversed(tail.splitlines())
                     if ln.strip()), "")
        return {"class": "error_exit",
                "detail": f"nonzero exit ({rc}); last line: {last[-200:]}",
                "rc": rc, "matched": matched}
    return {"class": "no_record",
            "detail": "exited clean but emitted no parsed record",
            "rc": rc, "matched": matched}


_ROUND_RE = re.compile(r"_r(\d+)")


def normalize_record(path: str) -> NormalizedRecord:
    """One trajectory file → :class:`NormalizedRecord`, whatever its
    era's shape. Unreadable/unparseable files normalize to a
    ``skipped_reason`` of class ``unreadable`` — the trajectory walker
    must never die on one bad file."""
    name = os.path.splitext(os.path.basename(path))[0]
    kind = "multichip" if name.upper().startswith("MULTICHIP") else "bench"
    m = _ROUND_RE.search(name)
    rnd = int(m.group(1)) if m else None
    try:
        with open(path, encoding="utf-8") as f:
            raw = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return NormalizedRecord(
            name=name, kind=kind, round=rnd, rc=None, parsed=None,
            degraded=None, bench_env=None,
            skipped_reason={"class": "unreadable", "detail": str(e),
                            "rc": None, "matched": []},
            path=path)
    if not isinstance(raw, dict):
        return NormalizedRecord(
            name=name, kind=kind, round=rnd, rc=None, parsed=None,
            degraded=None, bench_env=None,
            skipped_reason={"class": "unreadable",
                            "detail": "not a JSON object", "rc": None,
                            "matched": []},
            path=path)

    if kind == "multichip":
        ok = raw.get("ok")
        rc = raw.get("rc")
        reason = None
        if not ok:
            reason = classify_failure(raw.get("tail", ""), rc)
        return NormalizedRecord(
            name=name, kind=kind, round=rnd, rc=rc, parsed=None,
            degraded=None, bench_env=raw.get("bench_env"),
            skipped_reason=reason, ok=bool(ok), path=path)

    if "parsed" in raw or "tail" in raw or "cmd" in raw:
        # harness wrapper shape
        parsed = raw.get("parsed")
        rc = raw.get("rc")
        reason = None
        if parsed is None:
            reason = classify_failure(raw.get("tail", ""), rc)
        elif isinstance(parsed, dict) and parsed.get("skipped_reason"):
            # the bench itself emitted a structured reason (degraded
            # rounds)
            reason = parsed["skipped_reason"]
        return NormalizedRecord(
            name=name, kind=kind, round=rnd, rc=rc,
            parsed=parsed if isinstance(parsed, dict) else None,
            degraded=(parsed or {}).get("degraded")
            if isinstance(parsed, dict) else None,
            bench_env=(parsed or {}).get("bench_env")
            if isinstance(parsed, dict) else None,
            skipped_reason=reason, path=path)

    # flat record: the parsed payload IS the file
    return NormalizedRecord(
        name=name, kind=kind, round=rnd, rc=raw.get("rc"),
        parsed=raw, degraded=raw.get("degraded"),
        bench_env=raw.get("bench_env"),
        skipped_reason=raw.get("skipped_reason"), path=path)


def load_trajectory(repo_dir: str) -> List[NormalizedRecord]:
    """Every trajectory record under ``repo_dir``, normalized, in
    (kind, round, name) order — benches first, oldest first."""
    paths: List[str] = []
    for pat in RECORD_GLOBS:
        paths.extend(glob.glob(os.path.join(repo_dir, pat)))
    records = [normalize_record(p) for p in sorted(set(paths))]
    records.sort(key=lambda r: (r.kind, r.round if r.round is not None
                                else -1, r.name))
    return records


def _device_names(raw: Any) -> List[str]:
    """The device names a payload's ``device`` / ``device_kind`` /
    ``kind`` field gives: a string, or the contract's ``{"platform",
    "kind"}`` object."""
    if isinstance(raw, str):
        return [raw]
    if isinstance(raw, dict):
        return [v for v in (raw.get("kind"), raw.get("name"))
                if isinstance(v, str)]
    return []


def names_nvidia_device(rec: NormalizedRecord) -> bool:
    """Whether the record says it was measured on an NVIDIA card: its
    payload (or its ``bench_env``) names a device whose name holds
    ``NVIDIA``. A record that names no device says nothing of the card."""
    names: List[str] = []
    for block in (rec.parsed, rec.bench_env):
        if isinstance(block, dict):
            for key in ("device", "device_kind", "kind"):
                names.extend(_device_names(block.get(key)))
    return any("nvidia" in n.lower() for n in names)


def card_records(records: Sequence[NormalizedRecord]
                 ) -> List[NormalizedRecord]:
    """The records a card may be sized from: those measured on an
    NVIDIA device (:func:`names_nvidia_device`). None of the JAX
    package's TPU records qualifies."""
    return [r for r in records if names_nvidia_device(r)]


# ---------------------------------------------------------------------------
# capacity fit
# ---------------------------------------------------------------------------

def staleness_bound_s() -> float:
    try:
        return float(os.environ.get("PIO_SLO_STALENESS_S", "") or 3600.0)
    except ValueError:
        return 3600.0


def _num(parsed: Optional[Dict], key: str) -> Optional[float]:
    v = (parsed or {}).get(key)
    return float(v) if isinstance(v, (int, float)) \
        and not isinstance(v, bool) else None


def parse_tenant_demands(spec: Optional[str] = None) -> Dict[str, float]:
    """``PIO_TENANT_DEMAND_QPS`` grammar: ``tenant=qps;tenant=qps``.
    Malformed entries are dropped, not fatal — a sizing report must
    never die on a typo'd env var."""
    raw = (spec if spec is not None
           else os.environ.get("PIO_TENANT_DEMAND_QPS", ""))
    demands: Dict[str, float] = {}
    for part in raw.split(";"):
        name, sep, val = part.strip().partition("=")
        if not sep:
            continue
        try:
            q = float(val)
        except ValueError:
            continue
        if name.strip() and q > 0:
            demands[name.strip()] = q
    return demands


def bin_pack_tenants(demands: Dict[str, float],
                     qps_per_worker: float) -> Dict[str, Any]:
    """First-fit pack of tenant QPS demands onto workers of capacity
    ``qps_per_worker``. A tenant bigger than one worker is split into
    worker-sized chunks; each chunk lands in the first worker with
    room (insertion order — deterministic). Returns the per-tenant
    worker assignment and the packed fleet size, which is ≥ the naive
    ``ceil(sum/qps)`` because co-residency never splits a chunk."""
    cap = float(qps_per_worker)
    if cap <= 0:
        return {"workers": 0, "assignment": {}}
    free: List[float] = []          # remaining capacity per worker
    assignment: Dict[str, List[int]] = {}
    for tenant, demand in demands.items():
        placed: List[int] = []
        remaining = float(demand)
        while remaining > 1e-9:
            chunk = min(remaining, cap)
            for i, room in enumerate(free):
                if room >= chunk - 1e-9:
                    free[i] = room - chunk
                    placed.append(i)
                    break
            else:
                free.append(cap - chunk)
                placed.append(len(free) - 1)
            remaining -= chunk
        assignment[tenant] = sorted(set(placed))
    return {"workers": len(free), "assignment": assignment}


def fit_capacity(records: Sequence[NormalizedRecord],
                 staleness_s: Optional[float] = None) -> Dict[str, Any]:
    """The rows/chip + QPS/worker model, fitted from the newest records
    that actually measured each quantity (degraded rounds measured a
    CPU fallback, not a chip — they never feed the chip-rate fit).
    Every estimate names its source record; absent inputs yield null
    estimates, never fabricated ones."""
    S = staleness_s if staleness_s is not None else staleness_bound_s()
    out: Dict[str, Any] = {
        "staleness_bound_s": S,
        "rows_per_chip_per_s": None,
        "rows_per_chip_at_staleness": None,
        "train_source_record": None,
        "qps_per_worker": None,
        "qps_source_record": None,
        "qps_source_key": None,
        "serve_p99_ms": None,
        "mfu": None,
        "shard": None,
        "fleet": None,
        "mips": None,
        "mips_big": None,
        "tenants": None,
        "projections": {},
    }
    benches = [r for r in records if r.kind == "bench"
               and r.parsed is not None]
    # newest-first for "the current capability"
    for rec in reversed(benches):
        if out["train_source_record"] is None and not rec.degraded:
            nnz = _num(rec.parsed, "nnz")
            wall = _num(rec.parsed, "value")
            if nnz and wall and wall > 0:
                rate = nnz / wall  # single-chip training leg
                out["rows_per_chip_per_s"] = round(rate, 1)
                out["rows_per_chip_at_staleness"] = round(rate * S)
                out["train_source_record"] = rec.name
                out["mfu"] = _num(rec.parsed, "mfu")
        # degraded rounds serve a reduced-nnz CPU fallback — their QPS
        # would size the fleet from a measurement no production worker
        # resembles (same guard as the train-rate fit above)
        if out["qps_source_record"] is None and not rec.degraded:
            # prefer the fleet leg's per-worker goodput (bench_fleet's
            # no-floor burst: real kernels through the scheduler across
            # N worker processes — the figure a fleet is actually sized
            # from); the single-process serve_qps_concurrent remains
            # the fallback for records predating the leg
            # measured goodput first (fleet leg, then the single-
            # process concurrent rate); the two-stage MIPS device
            # bound (1000 / per-query wall at the 256k planted
            # catalogue) is the projection of last resort — a device
            # ceiling, not a measured worker rate, and qps_source_key
            # says so
            fleet_qps = _num(rec.parsed, "fleet_qps_per_worker")
            qps = (fleet_qps
                   or _num(rec.parsed, "serve_qps_concurrent")
                   or _num(rec.parsed, "mips_serve_qps"))
            if qps and qps > 0:
                out["qps_per_worker"] = round(qps, 1)
                out["qps_source_record"] = rec.name
                out["qps_source_key"] = (
                    "fleet_qps_per_worker" if fleet_qps
                    else ("serve_qps_concurrent"
                          if _num(rec.parsed, "serve_qps_concurrent")
                          else "mips_serve_qps"))
                out["serve_p99_ms"] = _num(rec.parsed, "serve_p99_ms")
        if out.get("mips") is None and not rec.degraded:
            mq = _num(rec.parsed, "mips_two_stage_per_query_ms")
            if mq:
                out["mips"] = {
                    "source_record": rec.name,
                    "items": _num(rec.parsed, "mips_items"),
                    "two_stage_per_query_ms": mq,
                    "exhaustive_per_query_ms": _num(
                        rec.parsed, "mips_exhaustive_per_query_ms"),
                    "speedup": _num(rec.parsed, "mips_speedup"),
                    "candidates_frac": _num(
                        rec.parsed, "mips_candidates_frac"),
                    "recall_at_20": _num(
                        rec.parsed, "mips_recall_at_20"),
                    "serve_qps_bound": _num(
                        rec.parsed, "mips_serve_qps"),
                }
        # catalogue-at-scale leg (≥10M items under PQ + background
        # rebuild): the sizing figures a tens-of-millions catalogue is
        # planned from — device bytes/item and the flat-p99-through-
        # rebuild ratio (docs/performance.md "Catalogue at tens of
        # millions")
        if out.get("mips_big") is None and not rec.degraded:
            bi = _num(rec.parsed, "mips_big_items")
            if bi:
                out["mips_big"] = {
                    "source_record": rec.name,
                    "items": int(bi),
                    "recall_at_20": _num(
                        rec.parsed, "mips_big_recall_at_20"),
                    "two_stage_per_query_ms": _num(
                        rec.parsed, "mips_big_two_stage_p50_ms"),
                    "rebuild_p99_flat_x": _num(
                        rec.parsed, "mips_rebuild_p99_flat_x"),
                    "index_age_max_s": _num(
                        rec.parsed, "mips_index_age_max_s"),
                    "device_bytes_per_item": _num(
                        rec.parsed, "mips_device_bytes_per_item"),
                }
        # same degraded-round guard as the qps fit above: a degraded
        # round's fleet leg ran on a box no production worker resembles
        if out.get("fleet") is None and not rec.degraded:
            fw = _num(rec.parsed, "fleet_workers")
            if fw:
                out["fleet"] = {
                    "source_record": rec.name,
                    "workers": int(fw),
                    "qps": _num(rec.parsed, "fleet_qps"),
                    "p99_s": _num(rec.parsed, "fleet_p99_s"),
                    "batch_p50": _num(rec.parsed, "fleet_batch_p50"),
                    "shed_rate": _num(rec.parsed, "fleet_shed_rate"),
                    "p99_flat_x": _num(rec.parsed, "fleet_p99_flat_x"),
                    "dispatch_floor_ms": _num(
                        rec.parsed, "fleet_dispatch_floor_ms"),
                }
        if out["shard"] is None:
            devs = _num(rec.parsed, "shard_devices")
            if devs:
                out["shard"] = {
                    "source_record": rec.name,
                    "devices": int(devs),
                    "mesh_shape": rec.parsed.get("shard_mesh_shape"),
                    "train_wall_s": _num(rec.parsed,
                                         "shard_train_wall_s"),
                    "nnz": _num(rec.parsed, "shard_nnz"),
                    "mfu": _num(rec.parsed, "shard_mfu_train"),
                    "gather_modes": rec.parsed.get("shard_gather_modes"),
                }
    # measured ceilings for the self-tuning serving knobs
    # (obs/knobs.py capacity_caps_fn): how far the effort knobs may
    # climb before capacity — not tuning — becomes binding. Derived
    # only from real measurements, with the same honesty rule as every
    # other estimate: no usable input, no ceiling (an absent knob is
    # simply unguarded, never guarded by a fabricated number).
    knobs: Dict[str, int] = {}
    mips = out.get("mips")
    if mips and mips.get("items") and mips.get("candidates_frac") \
            and mips.get("two_stage_per_query_ms"):
        items = float(mips["items"])
        measured_cand = items * float(mips["candidates_frac"])
        per_ms = float(mips["two_stage_per_query_ms"])
        if measured_cand > 0 and per_ms > 0:
            # stage-2 wall scales ~linearly with the candidate count;
            # the ceiling is the count at which the measured per-query
            # wall would eat the whole serving objective, clamped to
            # the catalogue itself
            slo_ms = 1000.0 * float(
                os.environ.get("PIO_SLO_SERVE_P99_S", "") or 0.25)
            cap = measured_cand * (slo_ms / per_ms)
            knobs["mips_candidates"] = int(min(cap, items))
    big = out.get("mips_big")
    if big and big.get("items") and big.get("two_stage_per_query_ms"):
        # PQ exact-rerank width ceiling: the big leg measures the
        # per-query wall at the DEFAULT PQ width (2048), and the
        # stage-2 wall scales ~linearly with it — same model as
        # mips_candidates, but measured at catalogue scale under PQ
        per_ms = float(big["two_stage_per_query_ms"])
        if per_ms > 0:
            slo_ms = 1000.0 * float(
                os.environ.get("PIO_SLO_SERVE_P99_S", "") or 0.25)
            cap = 2048.0 * (slo_ms / per_ms)
            knobs["mips_pq_candidates"] = int(
                min(cap, float(big["items"])))
    fleet = out.get("fleet")
    if fleet and fleet.get("qps") and fleet.get("workers"):
        # Little's law: a batch larger than one worker's arrivals per
        # objective window can never fill before its deadline
        slo_s = float(os.environ.get("PIO_SLO_SERVE_P99_S", "") or 0.25)
        per_worker = float(fleet["qps"]) / max(int(fleet["workers"]), 1)
        cap = per_worker * slo_s
        if cap >= 1:
            knobs["max_batch"] = int(cap)
    out["knobs"] = knobs or None

    rate = out["rows_per_chip_per_s"]
    qps = out["qps_per_worker"]
    projections: Dict[str, Any] = {}
    if rate:
        projections["chips_for_rows_at_staleness"] = {
            str(rows): math.ceil(rows / (rate * S))
            for rows in (100_000_000, 1_000_000_000, 10_000_000_000)
        }
    if qps:
        projections["workers_for_qps"] = {
            str(q): math.ceil(q / qps)
            for q in (10_000, 100_000, 1_000_000)
        }
    out["projections"] = projections
    # multi-tenant sizing: per-tenant worker counts plus a first-fit
    # bin-pack of the declared tenant demands onto the fleet. Demands
    # come from PIO_TENANT_DEMAND_QPS ("tenant=qps;..."); no declared
    # demand or no measured per-worker rate → null block, same honesty
    # rule as every other estimate.
    demands = parse_tenant_demands()
    if demands and qps:
        out["tenants"] = {
            "source_record": out["qps_source_record"],
            "qps_per_worker": qps,
            "demand_qps": demands,
            "workers_for_qps": {
                t: math.ceil(d / qps) for t, d in demands.items()
            },
            "binpack": bin_pack_tenants(demands, qps),
        }
    return out


# ---------------------------------------------------------------------------
# regression verdicts
# ---------------------------------------------------------------------------

#: default relative tolerance for the key-by-key compare; walls on
#: shared CI boxes are noisy, so the gate is a tripwire for real
#: regressions (2x walls, halved QPS), not a 5% perf police
DEFAULT_TOLERANCE = 0.25


def load_baseline(repo_dir: str,
                  path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """The pinned baseline: ``{"record": name, "tolerance": float,
    "keys": {key: value}}``. None when the file is absent (the compare
    then pins against the OLDEST fully-parsed bench record, honestly
    labeled)."""
    p = path or os.path.join(repo_dir, BASELINE_FILENAME)
    try:
        with open(p, encoding="utf-8") as f:
            base = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return base if isinstance(base, dict) and "keys" in base else None


def compare_record(parsed: Dict[str, Any],
                   baseline_keys: Dict[str, Any],
                   tolerance: float = DEFAULT_TOLERANCE
                   ) -> Dict[str, Any]:
    """Key-by-key tolerance compare. Keys whose record value is null
    (or missing, or non-numeric) are SKIPPED — a degraded round's
    honest nulls are not regressions. Shape keys must agree or the
    whole compare is ``incomparable_shape``."""
    for k in SHAPE_KEYS:
        b, v = baseline_keys.get(k), parsed.get(k)
        if b is not None and v is not None and b != v:
            return {"status": "incomparable_shape",
                    "detail": f"{k}: baseline {b} vs record {v}",
                    "compared": 0, "skipped": [], "regressed": [],
                    "improved": []}
    regressed: List[Dict[str, Any]] = []
    improved: List[str] = []
    skipped: List[str] = []
    compared = 0
    for key, base_v in baseline_keys.items():
        direction = key_direction(key)
        if direction is None or not isinstance(
                base_v, (int, float)) or isinstance(base_v, bool):
            continue
        v = parsed.get(key)
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            skipped.append(key)
            continue
        compared += 1
        if base_v == 0:
            continue  # a zero baseline has no relative band
        ratio = v / base_v
        if direction == "lower":
            if ratio > 1.0 + tolerance:
                regressed.append({"key": key, "baseline": base_v,
                                  "value": v,
                                  "ratio": round(ratio, 3)})
            elif ratio < 1.0 - tolerance:
                improved.append(key)
        else:
            if ratio < 1.0 - tolerance:
                regressed.append({"key": key, "baseline": base_v,
                                  "value": v,
                                  "ratio": round(ratio, 3)})
            elif ratio > 1.0 + tolerance:
                improved.append(key)
    return {
        "status": "regressed" if regressed else "ok",
        "compared": compared,
        "skipped": skipped,
        "regressed": regressed,
        "improved": improved,
    }


def record_verdicts(records: Sequence[NormalizedRecord],
                    baseline: Optional[Dict[str, Any]],
                    tolerance: float = DEFAULT_TOLERANCE
                    ) -> List[Dict[str, Any]]:
    """One NON-NULL verdict per record: parsed bench records compare
    against the baseline, unparsed ones carry their structured
    ``skipped_reason``, MULTICHIP records report pass/fail."""
    base_keys = (baseline or {}).get("keys") or {}
    base_name = (baseline or {}).get("record")
    tol = float((baseline or {}).get("tolerance", tolerance))
    out: List[Dict[str, Any]] = []
    for rec in records:
        entry = rec.summary()
        if rec.kind == "multichip":
            if rec.ok:
                entry["verdict"] = {"status": "ok"}
            else:
                entry["verdict"] = {"status": "skipped",
                                    "reason": rec.skipped_reason}
        elif rec.parsed is None:
            entry["verdict"] = {"status": "skipped",
                                "reason": rec.skipped_reason}
        elif rec.name == base_name:
            entry["verdict"] = {"status": "baseline"}
        elif not base_keys:
            entry["verdict"] = {"status": "no_baseline"}
        else:
            v = compare_record(rec.parsed, base_keys, tol)
            v["baseline"] = base_name
            entry["verdict"] = v
        out.append(entry)
    return out


def capacity_report(repo_dir: str,
                    baseline_path: Optional[str] = None,
                    staleness_s: Optional[float] = None
                    ) -> Dict[str, Any]:
    """The whole ``capacity.json`` payload: normalized trajectory with
    per-record verdicts, the capacity model fitted from the card's
    records only (:func:`card_records`), and the newest record's
    regression compare."""
    records = load_trajectory(repo_dir)
    baseline = load_baseline(repo_dir, baseline_path)
    if baseline is None:
        # honest fallback: pin against the oldest fully-parsed bench
        oldest = next((r for r in records
                       if r.kind == "bench" and r.parsed is not None),
                      None)
        if oldest is not None:
            baseline = {"record": oldest.name,
                        "tolerance": DEFAULT_TOLERANCE,
                        "keys": oldest.parsed,
                        "provenance": "fallback:oldest_parsed"}
    verdicts = record_verdicts(records, baseline)
    newest = next((r for r in reversed(records)
                   if r.kind == "bench" and r.parsed is not None), None)
    regression: Dict[str, Any] = {
        "baseline": (baseline or {}).get("record"),
        "baseline_provenance": (baseline or {}).get(
            "provenance", "pinned"),
        "newest": newest.name if newest else None,
        "status": "no_data",
    }
    if newest is not None and baseline is not None:
        cmp = compare_record(
            newest.parsed, baseline.get("keys") or {},
            float(baseline.get("tolerance", DEFAULT_TOLERANCE)))
        regression.update(cmp)
        if newest.name == baseline.get("record"):
            regression["status"] = "baseline"
    return {
        "staleness_bound_s": (staleness_s if staleness_s is not None
                              else staleness_bound_s()),
        "records": verdicts,
        "capacity": fit_capacity(card_records(records), staleness_s),
        "regression": regression,
    }


__all__ = [
    "BASELINE_FILENAME", "DEFAULT_TOLERANCE", "NormalizedRecord",
    "RECORD_GLOBS", "capacity_report", "card_records", "classify_failure",
    "compare_record", "fit_capacity", "key_direction", "load_baseline",
    "load_trajectory", "normalize_record", "record_verdicts",
    "names_nvidia_device", "staleness_bound_s", "parse_tenant_demands",
    "bin_pack_tenants",
]
