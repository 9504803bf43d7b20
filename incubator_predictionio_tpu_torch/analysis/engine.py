"""pio-lint engine: AST walking, suppressions, baseline, reporting.

A copy of incubator_predictionio_tpu/analysis/engine.py (:1-513): pure
AST analysis (nothing is imported or executed), a small rule registry
(:mod:`.rules`), inline ``# pio-lint: disable=RULE`` suppressions and a
checked-in baseline for deliberate exceptions. :func:`package_root` is
this package's directory, so the default scan is the PyTorch port and
findings' paths start ``incubator_predictionio_tpu_torch/``.

Run it as ``python -m incubator_predictionio_tpu_torch.analysis`` (see
``docs/lint.md``); ``tests/test_torch_lint.py`` runs it against the
port's baseline and holds every rule's findings equal to the JAX
package's on the same sources.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import re
import tokenize
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: severity levels, in increasing order of concern
SEVERITIES = ("warning", "error")

_SUPPRESS_RE = re.compile(r"#\s*pio-lint:\s*disable=([\w,\- ]+)")
_SUPPRESS_FILE_RE = re.compile(r"#\s*pio-lint:\s*disable-file=([\w,\- ]+)")
#: concurrency-contract annotations (docs/lint.md "Concurrency
#: contract"): ``# pio-lint: guarded-by(<lock>)`` declares the lock
#: attribute that must be held for every write of the annotated
#: attribute; ``# pio-lint: publish-only`` declares a single-writer
#: immutable-publish attribute (the recorder ring idiom). Both are
#: VERIFIED by analysis/concur.py, not trusted.
_ANNOTATION_RE = re.compile(
    r"#\s*pio-lint:\s*(publish-only|guarded-by\(\s*[\w.]+\s*\))")

#: modules allowed to read os.environ at import time by name
CONFIG_MODULE_RE = re.compile(r"(config|settings|conftest)")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    severity: str      # member of SEVERITIES
    path: str          # repo-relative posix path
    line: int          # 1-based
    message: str
    snippet: str       # stripped source line — the baseline fingerprint

    def format(self) -> str:
        return (f"{self.path}:{self.line}: {self.severity} "
                f"[{self.rule}] {self.message}")

    def baseline_entry(self) -> dict:
        return {"rule": self.rule, "path": self.path,
                "snippet": self.snippet,
                "justification": "TODO: justify or fix"}


class Module:
    """One parsed source file plus the derived facts rules share."""

    def __init__(self, path: Path, relpath: str, source: str) -> None:
        self.path = path
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=str(path))
        self.aliases = _import_aliases(self.tree)
        self.traced_roots = _traced_roots(self.tree, self.aliases)
        (self.line_disables, self.file_disables,
         self.line_annotations) = _suppressions(source)

    # -- shared helpers -----------------------------------------------------

    def resolved(self, node: ast.AST) -> Optional[str]:
        """Dotted name of a Name/Attribute chain with the first segment
        resolved through this module's import aliases (``jnp.where`` →
        ``jax.numpy.where``)."""
        return _resolve_dotted(node, self.aliases)

    def snippet_at(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def finding(self, rule: "object", node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return self.finding_at(rule, line, message)

    def finding_at(self, rule: "object", line: int, message: str) -> Finding:
        """Finding anchored at a line number — package rules report from
        index records, not live AST nodes."""
        return Finding(rule=rule.name, severity=rule.severity,
                       path=self.relpath, line=line, message=message,
                       snippet=self.snippet_at(line))

    def annotations_at(self, line: int) -> Set[str]:
        """Concurrency-contract annotations attached to ``line``: a
        trailing ``# pio-lint: ...`` comment on the line itself, or one
        on its own comment line directly above (same attachment rule as
        suppressions)."""
        out = set(self.line_annotations.get(line, ()))
        if _is_comment_line(self.lines, line - 1):
            out |= self.line_annotations.get(line - 1, set())
        return out

    def is_suppressed(self, f: Finding) -> bool:
        for rules in (self.file_disables,
                      self.line_disables.get(f.line, set()),
                      # a directive on its own comment line suppresses
                      # the statement directly below it
                      self.line_disables.get(f.line - 1, set())
                      if _is_comment_line(self.lines, f.line - 1) else set()):
            if "all" in rules or f.rule in rules:
                return True
        return False


def _is_comment_line(lines: List[str], line: int) -> bool:
    return 1 <= line <= len(lines) and lines[line - 1].lstrip().startswith("#")


def _suppressions(
    source: str,
) -> Tuple[Dict[int, Set[str]], Set[str], Dict[int, Set[str]]]:
    """Directive parsing over COMMENT tokens only — a docstring that
    *documents* the ``# pio-lint: disable=...`` syntax must not disable
    anything (the module already parsed, so tokenize cannot fail on
    syntax; be permissive about anything else). Returns
    ``(line disables, file disables, line annotations)`` — annotations
    are the concurrency-contract directives (publish-only /
    guarded-by(<lock>)), normalized with whitespace stripped."""
    per_line: Dict[int, Set[str]] = {}
    whole_file: Set[str] = set()
    annotations: Dict[int, Set[str]] = {}
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError):
        return per_line, whole_file, annotations
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_FILE_RE.search(tok.string)
        if m:
            whole_file |= _split_rules(m.group(1))
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if m:
            per_line.setdefault(tok.start[0], set()).update(
                _split_rules(m.group(1)))
            continue
        for m in _ANNOTATION_RE.finditer(tok.string):
            annotations.setdefault(tok.start[0], set()).add(
                re.sub(r"\s+", "", m.group(1)))
    return per_line, whole_file, annotations


def _split_rules(raw: str) -> Set[str]:
    return {r.strip() for r in raw.split(",") if r.strip()}


def _resolve_dotted(node: ast.AST,
                    aliases: Dict[str, str]) -> Optional[str]:
    """THE single copy of alias-aware dotted-name resolution — rules
    (Module.resolved) and trace detection must see identical names."""
    dname = _dotted(node)
    if dname is None:
        return None
    head, _, rest = dname.partition(".")
    head = aliases.get(head, head)
    return f"{head}.{rest}" if rest else head


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _import_aliases(tree: ast.Module) -> Dict[str, str]:
    """local name → fully dotted origin, for imports anywhere in the file
    (the repo imports lazily inside functions too)."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.partition(".")[0]] = (
                    a.name if a.asname else a.name.partition(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


_TRACE_TAILS = ("jit", "pjit", "shard_map")


def _is_trace_wrapper(resolved_name: Optional[str]) -> bool:
    return bool(resolved_name) and (
        resolved_name.rsplit(".", 1)[-1] in _TRACE_TAILS)


def _traced_roots(
    tree: ast.Module, aliases: Dict[str, str]
) -> List[Tuple[ast.AST, Set[str]]]:
    """Functions whose body runs under a JAX trace: jit/pjit/shard_map
    decorated (directly or via functools.partial), wrapped at a call site
    (``fn = jax.jit(f)`` / ``shard_map(f, ...)``), or passed to
    ``pl.pallas_call`` as the kernel body. Paired with the function's
    static argnames (trace-time Python values, exempt from tracer rules).
    """

    def resolved(node: ast.AST) -> Optional[str]:
        return _resolve_dotted(node, aliases)

    def static_names(call: ast.Call) -> Set[str]:
        names: Set[str] = set()
        for kw in call.keywords:
            # donate_argnames are donated ARRAYS — still tracers
            if kw.arg == "static_argnames":
                for sub in ast.walk(kw.value):
                    if isinstance(sub, ast.Constant) and isinstance(
                            sub.value, str):
                        names.add(sub.value)
        return names

    # simple single-target assignments, so a kernel body bound through
    # an intermediate (`body = functools.partial(_kernel, ...)` then
    # `pl.pallas_call(body, ...)`) still resolves to `_kernel`
    assigned: Dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            assigned[node.targets[0].id] = node.value

    def unwrap(t: ast.AST, bound: Set[str]) -> Optional[str]:
        """Follow partial() wrappers and name assignments to the
        underlying function name, collecting partial-bound keyword
        names (plain Python values — trace-time constants)."""
        visited: Set[str] = set()
        for _hop in range(8):
            if isinstance(t, ast.Call):  # functools.partial(body, ...)
                bound |= {kw.arg for kw in t.keywords if kw.arg}
                if not t.args:
                    return None
                t = t.args[0]
            elif (isinstance(t, ast.Name) and t.id in assigned
                    and t.id not in visited):  # guard x = x cycles
                visited.add(t.id)
                t = assigned[t.id]
            else:
                break
        name = _dotted(t)
        return name.rsplit(".", 1)[-1] if name else None

    # names traced by call-site wrapping, e.g. jax.jit(step) or
    # pl.pallas_call(functools.partial(_kernel, ...), ...) — mapped to
    # the statically-bound parameter names
    wrapped: Dict[str, Set[str]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        rname = resolved(node.func) or ""
        targets: List[ast.AST] = []
        if _is_trace_wrapper(rname) and node.args:
            targets = [node.args[0]]
        elif rname.rsplit(".", 1)[-1] == "pallas_call" and node.args:
            targets = [node.args[0]]
        for t in targets:
            bound: Set[str] = static_names(node)
            short = unwrap(t, bound)
            if short:
                wrapped.setdefault(short, set()).update(bound)

    roots: List[Tuple[ast.AST, Set[str]]] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        statics: Set[str] = set(wrapped.get(node.name, ()))
        traced = node.name in wrapped
        for dec in node.decorator_list:
            if _is_trace_wrapper(resolved(dec)):
                traced = True
            elif isinstance(dec, ast.Call):
                rname = resolved(dec.func) or ""
                if _is_trace_wrapper(rname):
                    traced = True
                    statics |= static_names(dec)
                elif rname.rsplit(".", 1)[-1] == "partial" and dec.args:
                    if _is_trace_wrapper(resolved(dec.args[0])):
                        traced = True
                        statics |= static_names(dec)
        if traced:
            roots.append((node, statics))
    return roots


# ---------------------------------------------------------------------------
# running rules over files
# ---------------------------------------------------------------------------

EXCLUDED_DIR_NAMES = {"__pycache__", "_build", ".git"}


def package_root() -> Path:
    """The installed ``incubator_predictionio_tpu_torch`` package directory —
    the default scan target."""
    return Path(__file__).resolve().parents[1]


def repo_root() -> Path:
    """Directory findings/baseline paths are relative to (the checkout
    root when running from a working tree)."""
    return package_root().parent


def default_baseline_path() -> Path:
    return Path(__file__).resolve().parent / "baseline.json"


def iter_py_files(paths: Sequence[Path]) -> Iterable[Path]:
    for p in paths:
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not EXCLUDED_DIR_NAMES & set(f.parts):
                    yield f


def _relpath(path: Path) -> str:
    try:
        return path.resolve().relative_to(repo_root()).as_posix()
    except ValueError:
        return path.as_posix()


class Package:
    """Whole-program view handed to rule API v2 (``check_package``):
    every parsed :class:`Module` of the run, plus a shared scratch
    cache so several package rules can split one expensive index
    (analysis/concur.py builds its class/thread index once here)."""

    def __init__(self, modules: Sequence[Module]) -> None:
        self.modules = list(modules)
        self.by_relpath: Dict[str, Module] = {
            m.relpath: m for m in self.modules}
        #: shared per-run scratch space for package-rule indexes
        self.cache: Dict[str, object] = {}


def lint_paths(
    paths: Sequence[Path],
    rules: Sequence[object],
    on_parse_error: Optional[List[str]] = None,
    timings: Optional[Dict[str, float]] = None,
    suppressed_out: Optional[List[Finding]] = None,
) -> List[Finding]:
    """Run every rule over every file; inline suppressions applied,
    baseline NOT applied (see :func:`apply_baseline`).

    Two-phase protocol: per-file rules (``check(mod)``) run module by
    module exactly as before; whole-program rules (``whole_program =
    True`` + ``check_package(package)``) run once afterwards over the
    full :class:`Package`. ``timings`` (if given) is filled with
    per-rule wall-clock seconds — the ``--timings`` report and the
    tier-1 lint-budget test read it. ``suppressed_out`` (if given)
    collects findings silenced by inline directives instead of
    dropping them (the ``--format json`` report marks them)."""
    import time as _time

    findings: List[Finding] = []
    modules: List[Module] = []
    per_file = [r for r in rules
                if not getattr(r, "whole_program", False)]
    package_rules = [r for r in rules
                     if getattr(r, "whole_program", False)]

    def _book(rule: object, t0: float) -> None:
        if timings is not None:
            timings[rule.name] = (timings.get(rule.name, 0.0)
                                  + _time.perf_counter() - t0)

    def _emit(mod: Module, finding: Finding) -> None:
        if mod.is_suppressed(finding):
            if suppressed_out is not None:
                suppressed_out.append(finding)
        else:
            findings.append(finding)

    for f in iter_py_files(paths):
        try:
            mod = Module(f, _relpath(f), f.read_text(encoding="utf-8"))
        except (SyntaxError, UnicodeDecodeError) as exc:
            if on_parse_error is not None:
                on_parse_error.append(f"{f}: {exc}")
            continue
        modules.append(mod)
        for rule in per_file:
            t0 = _time.perf_counter()
            for finding in rule.check(mod):
                _emit(mod, finding)
            _book(rule, t0)
    if package_rules and modules:
        package = Package(modules)
        for rule in package_rules:
            t0 = _time.perf_counter()
            for finding in rule.check_package(package):
                mod = package.by_relpath.get(finding.path)
                if mod is None:
                    findings.append(finding)
                else:
                    _emit(mod, finding)
            _book(rule, t0)
    findings.sort(key=lambda x: (x.path, x.line, x.rule))
    if suppressed_out is not None:
        suppressed_out.sort(key=lambda x: (x.path, x.line, x.rule))
    return findings


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------


def load_baseline(path: Path) -> List[dict]:
    data = json.loads(path.read_text(encoding="utf-8"))
    entries = data.get("entries", [])
    for e in entries:
        for key in ("rule", "path", "snippet"):
            if key not in e:
                raise ValueError(
                    f"baseline entry missing {key!r}: {e}")
    return entries


def apply_baseline(
    findings: Sequence[Finding], entries: Sequence[dict]
) -> Tuple[List[Finding], List[dict]]:
    """→ (findings not covered by the baseline, stale unused entries).

    Matching is by (rule, path, stripped source line) — stable across
    pure line-number drift. Each entry absorbs ONE finding; duplicated
    violations need duplicated entries.
    """
    pool: Dict[Tuple[str, str, str], List[dict]] = {}
    for e in entries:
        pool.setdefault((e["rule"], e["path"], e["snippet"]), []).append(e)
    unmatched: List[Finding] = []
    for f in findings:
        bucket = pool.get((f.rule, f.path, f.snippet))
        if bucket:
            bucket.pop()
        else:
            unmatched.append(f)
    stale = [e for bucket in pool.values() for e in bucket]
    return unmatched, stale


def write_baseline(path: Path, findings: Sequence[Finding],
                   keep_entries: Sequence[dict] = ()) -> None:
    """Regenerate the baseline from ``findings``, preserving the
    hand-written justification of every entry that still matches —
    only genuinely new entries get the TODO placeholder.
    ``keep_entries`` (entries a filtered run could not even see, e.g.
    under --select or an explicit path) are carried over verbatim so a
    partial regeneration never wipes curated out-of-scope entries."""
    kept: Dict[Tuple[str, str, str], List[str]] = {}
    if path.exists():
        try:
            for e in load_baseline(path):
                kept.setdefault(
                    (e["rule"], e["path"], e["snippet"]), []
                ).append(e.get("justification", ""))
        except (ValueError, json.JSONDecodeError):
            pass  # malformed old baseline: regenerate from scratch
    entries = list(keep_entries)
    for f in findings:
        entry = f.baseline_entry()
        old = kept.get((f.rule, f.path, f.snippet))
        if old:
            entry["justification"] = old.pop(0)
        entries.append(entry)
    entries.sort(key=lambda e: (e["path"], e["rule"], e["snippet"]))
    save_baseline_entries(path, entries)


def save_baseline_entries(path: Path, entries: Sequence[dict]) -> None:
    """Write ``entries`` as the baseline file verbatim (sorted) — the
    --prune-baseline path, which must drop stale entries WITHOUT
    touching the surviving hand-written justifications."""
    entries = sorted(entries,
                     key=lambda e: (e["path"], e["rule"], e["snippet"]))
    payload = {
        "comment": ("pio-lint baseline: deliberate exceptions, one "
                    "justification each. Regenerate with --write-baseline "
                    "(see docs/lint.md) and re-justify every entry."),
        "entries": list(entries),
    }
    path.write_text(json.dumps(payload, indent=2) + "\n", encoding="utf-8")
