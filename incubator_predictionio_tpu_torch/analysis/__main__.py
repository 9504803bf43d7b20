"""CLI for the port's pio-lint: ``python -m
incubator_predictionio_tpu_torch.analysis``.

A copy of incubator_predictionio_tpu/analysis/__main__.py (:1-245); the
default scan is the ``incubator_predictionio_tpu_torch`` package and the
default baseline its ``analysis/baseline.json``.

Exit codes: 0 = clean (modulo inline suppressions and, with
``--baseline``, the baseline file), 1 = unsuppressed findings, 2 = a
scanned file failed to parse or the invocation was malformed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

from incubator_predictionio_tpu_torch.analysis.engine import (
    Finding,
    apply_baseline,
    default_baseline_path,
    lint_paths,
    load_baseline,
    package_root,
    save_baseline_entries,
    write_baseline,
)
from incubator_predictionio_tpu_torch.analysis.rules import ALL_RULES, RULES_BY_NAME


def _entry_in_scope(entry: dict, rules, paths: List[Path]) -> bool:
    """Whether this run could even SEE the entry's finding: its rule is
    selected and its file is under one of the scanned paths."""
    if entry["rule"] not in {r.name for r in rules}:
        return False
    from incubator_predictionio_tpu_torch.analysis.engine import _relpath
    for p in paths:
        rel = _relpath(p)
        if entry["path"] == rel or entry["path"].startswith(
                rel.rstrip("/") + "/"):
            return True
    return False


def _finding_json(f: Finding, suppressed: bool) -> dict:
    return {"rule": f.rule, "severity": f.severity, "path": f.path,
            "line": f.line, "message": f.message, "snippet": f.snippet,
            "suppressed": suppressed}


def _report_json(findings: List[Finding], suppressed: List[Finding],
                 stale: List[dict], parse_errors: List[str],
                 timings: Optional[Dict[str, float]]) -> dict:
    """The machine-readable report: every surviving finding plus the
    inline-suppressed ones (flagged, so CI can audit suppressions);
    baseline-matched findings are deliberate exceptions and excluded."""
    n_err = sum(1 for f in findings if f.severity == "error")
    doc = {
        "version": 1,
        "findings": ([_finding_json(f, False) for f in findings]
                     + [_finding_json(f, True) for f in suppressed]),
        "staleBaseline": [{"rule": e["rule"], "path": e["path"],
                           "snippet": e["snippet"]} for e in stale],
        "parseErrors": list(parse_errors),
        "summary": {"errors": n_err,
                    "warnings": len(findings) - n_err,
                    "suppressed": len(suppressed),
                    "clean": not findings and not parse_errors},
    }
    if timings is not None:
        doc["ruleTimingsMs"] = {
            name: round(sec * 1e3, 3)
            for name, sec in sorted(timings.items())}
    return doc


def main(argv: List[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m incubator_predictionio_tpu_torch.analysis",
        description="pio-lint for the PyTorch port: static analysis "
                    "(docs/lint.md)")
    parser.add_argument(
        "paths", nargs="*", type=Path,
        help="files/directories to scan (default: the "
             "incubator_predictionio_tpu_torch package)")
    parser.add_argument(
        "--baseline", action="store_true",
        help="subtract the checked-in analysis/baseline.json (this is "
             "also the default when it exists; the flag makes CI "
             "invocations explicit)")
    parser.add_argument(
        "--baseline-path", type=Path, default=None, metavar="PATH",
        help="subtract a specific baseline JSON instead of the "
             "checked-in one")
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="report baselined findings too (audit mode)")
    parser.add_argument(
        "--write-baseline", nargs="?", const=default_baseline_path(),
        type=Path, default=None, metavar="PATH",
        help="write the current findings as a fresh baseline and exit 0 "
             "(every entry then needs a hand-written justification)")
    parser.add_argument(
        "--prune-baseline", action="store_true",
        help="rewrite the active baseline without its stale entries "
             "(entries whose finding no longer occurs), keeping every "
             "surviving justification verbatim")
    parser.add_argument(
        "--select", default=None, metavar="RULES",
        help="comma-separated rule names to run (default: all)")
    parser.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="findings output format on stdout (json: one document "
             "with rule/severity/file/line/message/suppressed per "
             "finding)")
    parser.add_argument(
        "--json-out", type=Path, default=None, metavar="FILE",
        help="also write the JSON report to FILE (CI artifact) while "
             "stdout keeps the chosen --format")
    parser.add_argument(
        "--timings", action="store_true",
        help="report per-rule wall-clock to stderr (and in the JSON "
             "report) — the tier-1 budget test keeps the whole-program "
             "phase honest as the package grows")
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print every rule with its severity and hazard class")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.name} ({rule.severity}): {rule.doc}")
        return 0

    rules = list(ALL_RULES)
    if args.select:
        names = [n.strip() for n in args.select.split(",") if n.strip()]
        unknown = [n for n in names if n not in RULES_BY_NAME]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)} "
                  f"(known: {', '.join(RULES_BY_NAME)})", file=sys.stderr)
            return 2
        rules = [RULES_BY_NAME[n] for n in names]

    paths = args.paths or [package_root()]
    parse_errors: List[str] = []
    timings: Optional[Dict[str, float]] = {} if (
        args.timings or args.format == "json"
        or args.json_out is not None) else None
    suppressed: List[Finding] = []
    findings = lint_paths(paths, rules, on_parse_error=parse_errors,
                          timings=timings, suppressed_out=suppressed)
    for err in parse_errors:
        print(f"parse error: {err}", file=sys.stderr)

    if args.write_baseline is not None:
        # under --select / explicit paths this run cannot see every
        # entry's finding — carry out-of-scope entries over verbatim
        # instead of silently deleting their curated justifications
        keep: List[dict] = []
        if args.write_baseline.exists():
            try:
                keep = [e for e in load_baseline(args.write_baseline)
                        if not _entry_in_scope(e, rules, paths)]
            except (OSError, ValueError):
                keep = []
        write_baseline(args.write_baseline, findings, keep_entries=keep)
        print(f"wrote {len(findings) + len(keep)} baseline entries to "
              f"{args.write_baseline}"
              + (f" ({len(keep)} out-of-scope kept)" if keep else ""))
        return 0 if not parse_errors else 2

    baseline_path = args.baseline_path
    if (baseline_path is None and not args.no_baseline
            and (args.baseline or args.prune_baseline
                 or default_baseline_path().exists())):
        baseline_path = default_baseline_path()
    stale: List[dict] = []
    entries: List[dict] = []
    if baseline_path is not None and not args.no_baseline:
        try:
            entries = load_baseline(baseline_path)
        except (OSError, ValueError) as exc:
            print(f"cannot load baseline {baseline_path}: {exc}",
                  file=sys.stderr)
            return 2
        # a filtered run (--select / explicit paths) never produces
        # findings for out-of-scope entries — judging those "stale"
        # would tell the developer to prune entries the full run needs
        in_scope = [e for e in entries
                    if _entry_in_scope(e, rules, paths)]
        findings, stale = apply_baseline(findings, in_scope)
    elif args.prune_baseline:
        print("--prune-baseline needs an active baseline "
              "(it conflicts with --no-baseline)", file=sys.stderr)
        return 2

    if args.prune_baseline:
        stale_ids = {id(e) for e in stale}
        survivors = [e for e in entries if id(e) not in stale_ids]
        save_baseline_entries(baseline_path, survivors)
        print(f"pruned {len(stale)} stale entr"
              f"{'y' if len(stale) == 1 else 'ies'} from "
              f"{baseline_path} ({len(survivors)} kept)",
              file=sys.stderr)
        stale = []  # handled: the rewrite IS the prune

    report = _report_json(findings, suppressed, stale, parse_errors,
                          timings)
    if args.json_out is not None:
        args.json_out.parent.mkdir(parents=True, exist_ok=True)
        args.json_out.write_text(json.dumps(report, indent=2) + "\n",
                                 encoding="utf-8")

    if args.format == "json":
        print(json.dumps(report, indent=2))
    else:
        for f in findings:
            print(f.format())
    for e in stale:
        print(f"stale baseline entry (fixed or drifted — prune it): "
              f"{e['path']}: [{e['rule']}] {e['snippet']}",
              file=sys.stderr)
    if args.timings and timings is not None:
        total_ms = sum(timings.values()) * 1e3
        print(f"rule timings (total {total_ms:.1f} ms):",
              file=sys.stderr)
        for name, sec in sorted(timings.items(),
                                key=lambda kv: -kv[1]):
            print(f"  {sec * 1e3:8.1f} ms  {name}", file=sys.stderr)

    n_err = sum(1 for f in findings if f.severity == "error")
    n_warn = len(findings) - n_err
    if findings:
        if args.format != "json":
            print(f"pio-lint: {n_err} error(s), {n_warn} warning(s)")
        # parse errors outrank findings: part of the tree went unlinted
        return 2 if parse_errors else 1
    if args.format != "json":
        print("pio-lint: clean"
              + (f" ({len(stale)} stale baseline entries)" if stale
                 else ""))
    return 2 if parse_errors else 0


if __name__ == "__main__":
    sys.exit(main())
