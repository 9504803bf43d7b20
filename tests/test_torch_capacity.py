"""The port's capacity model (``obs/capacity.py``) against the JAX
package's, on the CPU.

Normalizing, classifying and comparing records are the JAX package's, so
both packages read every ``BENCH_*.json`` / ``MULTICHIP_*.json`` of the
repo alike: equal normalized records, equal verdicts against the pinned
baseline, equal failure classes, key directions and tenant bin-packs
(the twins of tests/test_capacity.py and of tests/test_tenancy.py's
capacity cases). The fit differs on purpose: the repo's records are TPU
runs of the JAX package, and the port sizes a card only from records that
name an NVIDIA device (``card_records``). None in the repo does, so both
of the port's guards (``obs/controller.capacity_budget_fn``,
``obs/knobs.capacity_caps_fn``) are absent on today's tree, while on a
planted NVIDIA record the port's fit equals the JAX package's fit of the
same record. Comparisons are exact (the same float arithmetic in both).
"""

import dataclasses
import glob
import json
import os

import pytest

from incubator_predictionio_tpu.obs import capacity as jcapacity
from incubator_predictionio_tpu_torch.obs import capacity, controller, knobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDS = sorted(os.path.basename(p) for pat in capacity.RECORD_GLOBS
                 for p in glob.glob(os.path.join(REPO, pat)))


def test_the_repo_has_records_of_both_kinds():
    assert capacity.RECORD_GLOBS == jcapacity.RECORD_GLOBS
    assert any(r.startswith("BENCH_") for r in RECORDS)
    assert any(r.startswith("MULTICHIP_") for r in RECORDS)


@pytest.mark.parametrize("name", RECORDS)
def test_normalize_record_equals_the_jax_package(name):
    path = os.path.join(REPO, name)
    got = dataclasses.asdict(capacity.normalize_record(path))
    ref = dataclasses.asdict(jcapacity.normalize_record(path))
    assert got == ref
    assert got["parsed"] is not None or got["skipped_reason"] is not None \
        or got["kind"] == "multichip"


@pytest.mark.parametrize("name", RECORDS)
def test_compare_record_against_the_baseline_equals_the_jax_package(name):
    base = capacity.load_baseline(REPO)
    assert base == jcapacity.load_baseline(REPO)
    rec = capacity.normalize_record(os.path.join(REPO, name))
    if rec.parsed is None:
        pytest.skip(f"{name} has no parsed payload to compare")
    for tol in (0.1, capacity.DEFAULT_TOLERANCE, 0.5):
        assert capacity.compare_record(rec.parsed, base["keys"], tol) == \
            jcapacity.compare_record(rec.parsed, base["keys"], tol)


def test_record_verdicts_of_the_trajectory_equal_the_jax_package():
    recs, jrecs = (m.load_trajectory(REPO) for m in (capacity, jcapacity))
    assert [dataclasses.asdict(r) for r in recs] == \
        [dataclasses.asdict(r) for r in jrecs]
    base = capacity.load_baseline(REPO)
    got = capacity.record_verdicts(recs, base)
    assert got == jcapacity.record_verdicts(jrecs, base)
    assert all(r["verdict"]["status"] for r in got)
    by_name = {r["name"]: r for r in got}
    assert by_name["BENCH_r04"]["skipped_reason"]["class"] == \
        "accelerator_unavailable"
    assert by_name["BENCH_r05"]["skipped_reason"]["class"] == \
        "driver_deadline"


@pytest.mark.parametrize("tail,rc", [
    ("accelerator init still blocked (attempt 9) - likely a stale chip "
     "lease; retrying\naccelerator unavailable after 1200s; aborting\n", 3),
    ("tpu child attempt 3 did not claim within 720s\n", 124),
    ("boom\nlast words", 7),
    ("", 0),
    ("Traceback (most recent call last):\n  File x\nValueError: y", 1),
    ("", None),
])
def test_classify_failure_equals_the_jax_package(tail, rc):
    got = capacity.classify_failure(tail, rc)
    assert got == jcapacity.classify_failure(tail, rc)
    assert got["class"]


@pytest.mark.parametrize("key", [
    "value", "serve_p99_ms", "heldout_rmse", "serve_qps_concurrent", "mfu",
    "ingest_http_eps", "nnz", "rank", "sweeps", "als_kernel",
    "fleet_p99_s", "mips_speedup", "precision_at_10_vs_truth",
])
def test_key_direction_equals_the_jax_package(key):
    assert capacity.key_direction(key) == jcapacity.key_direction(key)


BASE = {"value": 2.0, "serve_qps": 1000.0, "nnz": 100, "rank": 8,
        "sweeps": 4, "heldout_rmse": 0.6}


@pytest.mark.parametrize("rec", [
    dict(BASE, value=3.0, serve_qps=500.0),
    dict(BASE, value=2.2, serve_qps=None, heldout_rmse=0.65),
    dict(BASE, nnz=999),
    dict(BASE, value=1.0, serve_qps=2000.0),
])
def test_compare_record_cases_equal_the_jax_package(rec):
    got = capacity.compare_record(rec, BASE, tolerance=0.25)
    assert got == jcapacity.compare_record(rec, BASE, tolerance=0.25)


@pytest.mark.parametrize("spec", [
    "a=100; b=2000 ;typo;c=;d=-5;e=abc", "", "x=1.5", "a=1;a=2",
])
def test_parse_tenant_demands_equals_the_jax_package(spec):
    assert capacity.parse_tenant_demands(spec) == \
        jcapacity.parse_tenant_demands(spec)


@pytest.mark.parametrize("demands,qps", [
    ({"b": 2000, "a": 100}, 800.0),
    ({}, 800.0),
    ({"a": 10}, 0.0),
    ({"a": 799.9999999999, "b": 0.5, "c": 1600.0}, 800.0),
    ({"a": 300, "b": 300, "c": 300, "d": 300}, 500.0),
])
def test_bin_pack_tenants_equals_the_jax_package(demands, qps):
    got = capacity.bin_pack_tenants(demands, qps)
    assert got == jcapacity.bin_pack_tenants(demands, qps)
    if demands == {"b": 2000, "a": 100}:
        # b splits into 800+800+400; a's 100 first-fits into b's third
        # worker (400+100 <= 800): co-residency, not a fourth worker
        assert got == {"workers": 3,
                       "assignment": {"b": [0, 1, 2], "a": [2]}}


def test_no_record_of_the_repo_sizes_the_card():
    recs = capacity.load_trajectory(REPO)
    assert recs and capacity.card_records(recs) == []
    fit = capacity.fit_capacity(capacity.card_records(recs))
    assert fit["rows_per_chip_per_s"] is None
    assert fit["qps_per_worker"] is None and fit["knobs"] is None
    # the JAX package fits the same records (its TPU's rate)
    assert jcapacity.fit_capacity(
        jcapacity.load_trajectory(REPO))["rows_per_chip_per_s"]
    report = capacity.capacity_report(REPO)
    assert report["capacity"]["rows_per_chip_per_s"] is None
    assert report["records"] == jcapacity.capacity_report(REPO)["records"]


def test_both_guards_are_absent_on_the_repo(monkeypatch):
    monkeypatch.delenv("PIO_CONTROLLER_ROWS", raising=False)
    assert controller.capacity_budget_fn(rows=1e8, repo_dir=REPO)() is None
    assert knobs.capacity_caps_fn(REPO)() is None
    monkeypatch.setenv("PIO_CONTROLLER_ROWS", "100000000")
    assert controller.capacity_budget_fn(repo_dir=REPO)() is None


def _write(tmp_path, name, obj):
    (tmp_path / name).write_text(json.dumps(obj))


H100 = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}


@pytest.mark.parametrize("where", ["device", "device_kind", "bench_env"])
def test_a_card_record_feeds_the_fit_as_the_jax_package_fits_it(
        tmp_path, monkeypatch, where):
    monkeypatch.delenv("PIO_SLO_SERVE_P99_S", raising=False)
    parsed = {"value": 4.0, "nnz": 1000, "rank": 8, "sweeps": 4,
              "serve_qps_concurrent": 900.0, "fleet_workers": 2,
              "fleet_qps": 400.0, "mfu": 0.1}
    if where == "device":
        parsed["device"] = H100
    elif where == "device_kind":
        parsed["device_kind"] = H100["kind"]
    else:
        parsed["bench_env"] = {"device": H100["kind"]}
    _write(tmp_path, "BENCH_r01.json",
           {"n": 1, "rc": 0, "tail": "", "parsed": parsed})
    _write(tmp_path, "BENCH_r02.json", {"n": 2, "rc": 0, "tail": "",
                                        "parsed": {"value": 1.0,
                                                   "nnz": 1000}})
    recs = capacity.load_trajectory(str(tmp_path))
    card = capacity.card_records(recs)
    assert [r.name for r in card] == ["BENCH_r01"]
    got = capacity.fit_capacity(card, staleness_s=60.0)
    ref = jcapacity.fit_capacity(
        [r for r in jcapacity.load_trajectory(str(tmp_path))
         if r.name == "BENCH_r01"], staleness_s=60.0)
    assert got == ref
    assert got["rows_per_chip_per_s"] == pytest.approx(250.0)
    assert got["knobs"] == {"max_batch": 50}
    # the guards engage on it
    assert controller.capacity_budget_fn(
        rows=1e4, repo_dir=str(tmp_path))() == pytest.approx(40.0)
    assert knobs.capacity_caps_fn(str(tmp_path))() == {"max_batch": 50}


def test_degraded_card_records_never_feed_the_card_rate(tmp_path):
    for n, value, degraded in ((1, 10.0, False), (2, 300.0, True)):
        _write(tmp_path, f"BENCH_r0{n}.json", {
            "n": n, "rc": 0, "tail": "", "parsed": {
                "value": value, "nnz": 1000, "degraded": degraded,
                "device": H100}})
    cap = capacity.fit_capacity(capacity.card_records(
        capacity.load_trajectory(str(tmp_path))))
    assert cap["train_source_record"] == "BENCH_r01"
    assert cap["rows_per_chip_per_s"] == pytest.approx(100.0)


def test_a_record_naming_another_device_is_not_the_cards(tmp_path):
    _write(tmp_path, "BENCH_r01.json", {"n": 1, "rc": 0, "tail": "",
                                        "parsed": {"value": 1.0, "nnz": 9,
                                                   "device": "TPU v5 lite"}})
    recs = capacity.load_trajectory(str(tmp_path))
    assert capacity.card_records(recs) == []
    assert not capacity.names_nvidia_device(recs[0])
