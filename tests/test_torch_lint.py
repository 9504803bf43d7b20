"""The port's pio-lint (``incubator_predictionio_tpu_torch.analysis``)
against the JAX package's (``incubator_predictionio_tpu.analysis``).

Every rule's seeded violation and its hazard-free twin, taken from
``tests/test_lint.py``'s fixtures, give the same findings (rule, line,
severity, message) from both packages; on the port's side the sources
name the port's modules, as the port's own code does, so the re-pointed
``recorder-in-serve-path`` sees the port's recorder. Both packages' rule
sets and both packages' findings over the port's own tree agree (the
port's recorder calls are all off the serve path). The port's tree lints
clean under its own baseline, with no stale entry and a justification for
every entry, inside the JAX test's 90 s budget.
"""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from incubator_predictionio_tpu import analysis as jlint
from incubator_predictionio_tpu_torch import analysis as tlint
from incubator_predictionio_tpu_torch.analysis.engine import load_baseline
from test_lint import FIXTURES

PORT_PKG = "incubator_predictionio_tpu_torch"
_JAX_NAME = re.compile(r"\bincubator_predictionio_tpu\b(?!_torch)")


def _as_port(source: str) -> str:
    """A fixture's source with the JAX package's module names replaced by
    the port's (same lines, same columns but for the suffix)."""
    return _JAX_NAME.sub(PORT_PKG, source)


def _target(root: Path, rule: str) -> Path:
    """Where ``tests/test_lint.py`` puts a rule's fixture: some rules
    apply only under ``servers/``, ``serving/`` or to
    ``obs/controller.py``."""
    name = "fixture.py"
    if rule == "unaudited-actuation":
        target_dir, name = root / "obs", "controller.py"
    elif rule in ("server-state", "unbatched-dispatch", "exhaustive-scan"):
        target_dir = root / "servers"
    elif rule == "unscoped-tenant-metric":
        target_dir = root / "serving"
    else:
        target_dir = root
    target_dir.mkdir(parents=True, exist_ok=True)
    return target_dir / name


def _keys(findings):
    """(rule, line, severity, message); a message names resolved calls, so
    the JAX package's names are read as the port's."""
    return [(f.rule, f.line, f.severity, _as_port(f.message))
            for f in findings]


def _both(tmp_path, source, rule):
    """(JAX findings, port findings) of one rule on one source, each
    package's file in a tree of its own."""
    jfile = _target(tmp_path / "jax", rule)
    jfile.write_text(source, encoding="utf-8")
    tfile = _target(tmp_path / "port", rule)
    tfile.write_text(_as_port(source), encoding="utf-8")
    return (jlint.lint_paths([jfile], [jlint.RULES_BY_NAME[rule]]),
            tlint.lint_paths([tfile], [tlint.RULES_BY_NAME[rule]]))


def test_both_packages_run_the_same_rules():
    """The same 23 rules: names, severities and docs."""
    assert len(tlint.ALL_RULES) == 23
    assert [(r.name, r.severity, r.doc) for r in tlint.ALL_RULES] == \
        [(r.name, r.severity, r.doc) for r in jlint.ALL_RULES]
    assert set(FIXTURES) == set(tlint.RULES_BY_NAME)


@pytest.mark.parametrize("twin", ["violation", "hazard-free"])
@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_fixture_findings_equal_the_jax_packages(tmp_path, rule, twin):
    source = FIXTURES[rule][0 if twin == "violation" else 1]
    jfound, tfound = _both(tmp_path, source, rule)
    assert _keys(tfound) == _keys(jfound)
    if twin == "violation":
        assert tfound and all(f.rule == rule for f in tfound)
    else:
        assert not tfound, [f.format() for f in tfound]


@pytest.mark.parametrize("form", ["inline", "line-above", "file"])
def test_suppressions_equal_the_jax_packages(tmp_path, form):
    line = 'CHUNK = int(os.environ.get("PIO_CHUNK", "64"))'
    src = FIXTURES["env-import"][0]
    if form == "inline":
        src = src.replace(line, line + "  # pio-lint: disable=env-import")
    elif form == "line-above":
        src = src.replace(line, "# pio-lint: disable=env-import\n" + line)
    else:
        src = "# pio-lint: disable-file=env-import\n" + src
    jfound, tfound = _both(tmp_path, src, "env-import")
    assert tfound == [] and jfound == []


def test_recorder_rule_resolves_the_ports_recorder(tmp_path):
    """The port's copy flags a seeded
    ``incubator_predictionio_tpu_torch.obs.recorder.get_recorder()`` call
    on a serve path, which the JAX package's copy, resolving the JAX
    package's recorder, does not see; a call of the JAX package's
    recorder is the JAX copy's finding alone."""
    src = """
from {pkg}.obs import recorder as obs_recorder

class Server:
    def _handle_batch(self, bodies):
        rec = obs_recorder.get_recorder()
        return [rec.window() for _ in bodies]
"""
    rule = "recorder-in-serve-path"
    found = {}
    for pkg in ("incubator_predictionio_tpu", PORT_PKG):
        target = _target(tmp_path / pkg, rule)
        target.write_text(src.format(pkg=pkg), encoding="utf-8")
        found[pkg] = [
            [(f.rule, f.line, f.snippet) for f in lint.lint_paths(
                [target], [lint.RULES_BY_NAME[rule]])]
            for lint in (jlint, tlint)]
    seeded = [(rule, 6, "rec = obs_recorder.get_recorder()")]
    assert found[PORT_PKG] == [[], seeded]
    assert found["incubator_predictionio_tpu"] == [seeded, []]


def test_findings_over_the_port_equal_the_jax_lints():
    """Over the port's whole tree, without a baseline, both packages'
    lints report the same findings (the port's own recorder calls are
    off the serve path, so the re-pointed rule adds nothing)."""
    root = tlint.package_root()
    assert root.name == PORT_PKG
    jfound = jlint.lint_paths([root], list(jlint.ALL_RULES))
    tfound = tlint.lint_paths([root], list(tlint.ALL_RULES))
    assert [(f.path, *k) for f, k in zip(tfound, _keys(tfound))] == \
        [(f.path, *k) for f, k in zip(jfound, _keys(jfound))]
    assert all(f.path.startswith(PORT_PKG + "/") for f in tfound)


def test_port_tree_is_clean_modulo_its_baseline_within_budget():
    """The tier-1 gate of the port, as the JAX package's: ``python -m
    incubator_predictionio_tpu_torch.analysis --baseline`` exits 0 over
    the port's tree with no stale entry, reports every rule's timing and
    finishes within 90 s."""
    start = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "incubator_predictionio_tpu_torch.analysis",
         "--baseline", "--timings"],
        cwd=tlint.repo_root(), capture_output=True, text=True, timeout=180)
    elapsed = time.monotonic() - start
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "pio-lint: clean" in proc.stdout
    assert "stale baseline entry" not in proc.stderr, proc.stderr
    for rule in ("unguarded-shared-state", "thread-lifecycle"):
        assert rule in proc.stderr
    assert elapsed < 90.0, f"full-package lint took {elapsed:.1f}s"


def test_port_baseline_entries_all_have_real_justifications():
    path = tlint.default_baseline_path()
    assert path == (tlint.repo_root() / PORT_PKG / "analysis"
                    / "baseline.json")
    entries = load_baseline(path)
    assert entries
    for e in entries:
        assert e["path"].startswith(PORT_PKG + "/"), e
        assert e.get("justification", "").strip(), e
        assert "TODO" not in e["justification"], e
    # no entry of the two races the port fixed: the overlays are
    # snapshotted under the lock in PredictionServer.stop()
    assert not any(e["rule"] == "unguarded-shared-state"
                   and "_speed_overlays" in e["snippet"] for e in entries)


def test_cli_json_report_over_a_seeded_file(tmp_path):
    """``--format json`` from the port's CLI names the finding the JAX
    CLI names in the same document shape."""
    bad = tmp_path / "bad.py"
    bad.write_text(FIXTURES["env-import"][0], encoding="utf-8")
    docs = []
    for pkg in ("incubator_predictionio_tpu", PORT_PKG):
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}.analysis", str(bad),
             "--format", "json"],
            cwd=tlint.repo_root(), capture_output=True, text=True,
            timeout=120)
        assert proc.returncode == 1, proc.stderr
        doc = json.loads(proc.stdout)
        doc.pop("ruleTimingsMs")
        docs.append(doc)
    assert docs[1] == docs[0]
    assert any(f["rule"] == "env-import" for f in docs[1]["findings"])
